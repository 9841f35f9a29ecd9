"""The paper's DM/DC/DevMem trichotomy at model scale, on the PyTorch
port: stream a layer stack's weights from host memory with
one-layer-ahead prefetch (``core.offload.LayerStreamer``: one pinned
host row a layer, copied on a side stream) and compare the three
placement modes' traffic and wall time.  Each layer's two products run
through the streaming GEMM kernel on the card (its plain version on the
CPU); the outputs of the three modes are equal.

    PYTHONPATH=src python examples/offload_streaming_torch.py
    PYTHONPATH=src python examples/offload_streaming_torch.py \\
        --device cpu --layers 4 --width 64
"""
import argparse
import os
import sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch
import torch.nn.functional as F

from repro_torch.core.modes import MemoryMode
from repro_torch.core.offload import LayerStreamer
from repro_torch.device import resolve_device
from repro_torch.kernels import ops


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=24)
    ap.add_argument("--width", type=int, default=512)
    args = ap.parse_args()
    dev = resolve_device(args.device)
    L, d, b = args.layers, args.width, 8
    g = torch.Generator().manual_seed(0)
    stacked = {
        "wi": (torch.randn((L, d, 4 * d), generator=g) * 0.02).to(
            torch.bfloat16),
        "wo": (torch.randn((L, 4 * d, d), generator=g) * 0.02).to(
            torch.bfloat16),
    }
    x = torch.randn((b, d), generator=g).to(dev, torch.bfloat16)

    def layer(p, x):
        h = F.gelu(ops.streaming_gemm(x, p["wi"]), approximate="tanh")
        return x + ops.streaming_gemm(h, p["wo"])

    per_layer = sum(v[0].numel() for v in stacked.values())
    print(f"{L} layers x {per_layer / 1e6:.1f}M params/layer on {dev}")
    # one untimed pass first: the kernels' build and first launches
    LayerStreamer(stacked, L, MemoryMode.DEVMEM, device=dev).run(layer, x)
    outs = {}
    for mode in (MemoryMode.DEVMEM, MemoryMode.DM, MemoryMode.DC):
        streamer = LayerStreamer(stacked, L, mode, cache_layers=8,
                                 device=dev)
        out, rep = streamer.run(layer, x, prefetch=1)
        outs[mode] = out
        print(f"{mode.value:7s} wall={rep.wall_s*1e3:8.2f}ms "
              f"streamed={rep.bytes_streamed/1e6:7.1f}MB "
              f"hits={streamer.stats.cache_hits}")
    assert all(torch.equal(o, outs[MemoryMode.DEVMEM]) for o in outs.values())
    print("DevMem: resident; DM: every layer streamed; DC: the first "
          "layers kept on the device — the paper's Fig. 1 modes at layer "
          "granularity.")


if __name__ == "__main__":
    main()
