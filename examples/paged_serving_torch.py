"""Paged-KV decode with the SMMU-style paged attention kernel of the
PyTorch/CUDA port: allocate a page pool, fill it from mixed-length
sequences, and decode through ``ops.paged_attention`` (the hand-written
CUDA kernel on the card, its plain PyTorch version on the CPU) —
verifying against contiguous attention.  ``--int8`` does the same over
the INT8 KV cache's pools: K/V quantized per (token, KV head) and
written by ``ops.kv_write`` (one quantize-and-append kernel on the
card), read back with their fp16 scales.

    PYTHONPATH=src python examples/paged_serving_torch.py [--int8]
    PYTHONPATH=src python examples/paged_serving_torch.py --device cpu
"""
import argparse
import os
import sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.layers import decode_attention
from repro_torch.serving.kv_cache import PagedCacheConfig, PagedKVCache


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--int8", action="store_true",
                    help="int8 pools with fp16 per-token scales")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    KH, D, H = 2, 32, 8
    cfg = PagedCacheConfig(n_pages=64, page_tokens=16, n_kv_heads=KH,
                           head_dim=D, max_pages_per_seq=8,
                           dtype="int8" if args.int8 else "bfloat16")
    cache = PagedKVCache(cfg, max_seqs=3, n_layers=1, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    lens = [23, 57, 100]
    for slot, T in enumerate(lens):
        assert cache.alloc_seq(slot, T)
        k = torch.randn((1, T, KH, D), generator=g, device=dev).to(
            torch.bfloat16)
        rows = cache.prompt_index([slot], T)
        ops.kv_write(cache.layer_pools(0), rows[0], k[0], k[0] * 0.5)
    print(f"pool: {cache.pages_in_use}/{cfg.n_pages} pages in use "
          f"({cfg.page_bytes} B per K page, {cfg.dtype})")

    slots = [0, 1, 2]
    q = torch.randn((3, H, D), generator=g, device=dev).to(torch.bfloat16)
    view = cache.read_view(slots)
    pools = cache.layer_pools(0)
    out = ops.paged_attention(q, pools[0], pools[1], view.table, view.lens,
                              pools[2], pools[3])

    # oracle: gather the pages into contiguous caches
    t = view.table.long()
    k = pools[0][t].reshape(3, -1, KH, D)
    v = pools[1][t].reshape(3, -1, KH, D)
    scales = {}
    if args.int8:
        for name, sc in (("k_scale", pools[2]), ("v_scale", pools[3])):
            scales[name] = sc[t].permute(0, 1, 3, 2).reshape(3, -1, KH)
    want = decode_attention(q, k, v, view.lens, **scales)
    err = float((out.float() - want.float()).abs().max())
    print(f"paged kernel vs contiguous attention on {dev}: max |err| = "
          f"{err:.2e}")
    # one bf16 ulp of O(1) outputs: the contiguous form rounds P to bf16
    assert err < 2e-2
    # append a decode step's K/V and grow across a page boundary
    step = cache.append_view(slots)
    kv = q[:, :KH]
    ops.kv_write(pools, step.write_index, kv, kv)
    print(f"after append: lens={cache.lens[:3].tolist()} "
          f"pages={cache.pages_in_use}")
    cache.validate()
    print("page-table indirection == the paper's SMMU, serving edition.")


if __name__ == "__main__":
    main()
