"""END-TO-END DRIVER of the PyTorch/CUDA port (the paper's kind is
inference): serve an LM under continuous batching with batched
requests; report throughput, time-to-first-token and per-request
latency, the serving analogue of the paper's end-to-end transformer
evaluation.  Weights are random; on the card the published config
serves and every projection, prefill and decode attention runs through
the hand-written kernels, on the CPU (``--device cpu``) the reduced
config through their plain versions.  ``--kv-cache-quant`` serves from
the INT8 KV cache.

    PYTHONPATH=src python examples/serve_batched_torch.py --arch qwen2-0.5b \\
        --requests 16 --slots 4 --new-tokens 12
    PYTHONPATH=src python examples/serve_batched_torch.py --device cpu
"""
import argparse
import os
import sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.device import resolve_device
from repro_torch.models import tuning as TU
from repro_torch.models.model import Model
from repro_torch.serving.engine import Request, ServingEngine


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=10)
    ap.add_argument("--max-seq", type=int, default=96)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--kv-cache-quant", action="store_true",
                    help="INT8 paged KV with per-token scales")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = get_config(args.arch) if dev.type == "cuda" \
        else get_reduced(args.arch)
    model = Model(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen)
    with TU.tuning_context(TU.Tuning(kv_cache_quant=args.kv_cache_quant)):
        eng = ServingEngine(cfg, params, slots=args.slots,
                            max_seq=args.max_seq, device=dev)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
        else "cpu"
    print(f"serving {cfg.name} on {where} with {args.slots} slots, "
          f"KV pool {eng.cache.k_pages.dtype}")
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(args.requests):
        r = Request(uid=i,
                    prompt=rng.integers(1, cfg.vocab_size - 1,
                                        int(rng.integers(4, 16))
                                        ).astype(np.int32),
                    max_new_tokens=args.new_tokens)
        reqs.append(r)
        eng.submit(r)
    stats = eng.run_until_drained()
    ttft = [r.first_token_s - r.submitted_s for r in reqs]
    lat = [r.done_s - r.submitted_s for r in reqs]
    print(f"throughput : {stats.tokens_per_s:8.1f} tok/s "
          f"({stats.tokens_out} tokens in {stats.wall_s:.2f}s)")
    print(f"TTFT       : p50={np.percentile(ttft, 50)*1e3:7.1f}ms "
          f"p95={np.percentile(ttft, 95)*1e3:7.1f}ms")
    print(f"latency    : p50={np.percentile(lat, 50)*1e3:7.1f}ms "
          f"p95={np.percentile(lat, 95)*1e3:7.1f}ms")
    print(f"decode steps={stats.decode_steps} prefills={stats.prefills}")


if __name__ == "__main__":
    main()
