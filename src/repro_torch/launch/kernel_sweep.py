"""Sweep the launch plans of the bf16 kernels on the card.

    python -m repro_torch.launch.kernel_sweep [--out PATH] [--reps N]

For every main-path shape of qwen2-0.5b (GEMM at decode M = 8 and
prefill M = 256; causal prefill attention at 64-512 tokens) it runs the
kernel at every tile / split the kernel accepts, checks each result
against the plain version, and reports the device time of each from
``torch.profiler`` (the mean over ``--reps`` launches, the L2 flushed
before each), beside the plan that ``plan`` picks and the device time of
the library call (``torch.matmul``, SDPA) on the same inputs.

This is the tool that chose the rules of ``streaming_gemm.plan`` and
``flash_attention.plan``; it needs a card and exits without one.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import _build, ops, ref

SG = importlib.import_module("repro_torch.kernels.streaming_gemm")
FA = importlib.import_module("repro_torch.kernels.flash_attention")
GEMM_KN = ((896, 896), (896, 128), (896, 4864), (4864, 896), (896, 152064))


def _device_ms(fn, flush, reps):
    """Mean device time of ``fn``'s kernels (the flush excluded)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if "elementwise" in ev.key or "fill" in ev.key.lower():
            continue                               # the flush
        total += ev.self_device_time_total / 1e3
    return total / reps


def _gemm_lib(path):
    fn = ctypes.CDLL(str(path)).sg_gemm_bf16
    fn.argtypes, fn.restype = SG._MMA_ARGS, ctypes.c_int
    return fn


def _launch(fn, a, b, plan):
    kcontig, ldb = SG.mma_layout(a, b)
    M, K = a.shape
    N = b.shape[1]
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    _build.check(fn(_build.ptr(a), _build.ptr(b), _build.ptr(out), M, N, K,
                    a.stride(0), ldb, int(kcontig), N, *plan,
                    _build.stream(a.device)), "streaming_gemm")
    return out


def _gemm_plans(M, K):
    """Every plan the kernel takes at this shape: the chosen token tile
    (and, for prefill, 64 and 128 rows), any bn, any split that walks at
    least ``MIN_K_TILES`` k-tiles."""
    nk = -(-K // SG.BK)
    bms = (64, 128) if M > 16 else (SG.plan(M, 1, K)[0],)
    for bm in bms:
        for bn in (32, 64, 128):
            for s in range(1, SG.MAX_SPLITS + 1):
                if s == 1 or nk // s >= SG.MIN_K_TILES:
                    yield bm, bn, SG.BK, s


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/kernel_sweep.json")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("kernel_sweep: no CUDA device")
    import torch.nn.functional as F
    _build.build_all()
    main_fn = _gemm_lib(_build._target(_build.CSRC / "streaming_gemm.cu"))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale) \
            .to(torch.bfloat16)

    def dms(fn):
        return _device_ms(fn, flush, args.reps)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(f"[card] {card}", flush=True)
    result = {"card": card, "gemm": [], "flash": []}
    embed = randn(152064, 896, scale=0.02)
    for M in (8, 256):
        for K, N in GEMM_KN:
            if M == 256 and N == 152064:
                continue                    # not on the main path
            a = randn(M, K)
            b = embed.t() if N == 152064 else randn(K, N, scale=K ** -0.5)
            want = ref.gemm_ref(a, b).float()
            times = {}
            for plan in _gemm_plans(M, K):
                err = (_launch(main_fn, a, b, plan).float() - want).abs().max()
                if err.item() > 2e-2 + 2e-2 * want.abs().max().item():
                    raise AssertionError(f"gemm {M}x{K}x{N} {plan}: {err}")
                t = dms(lambda: _launch(main_fn, a, b, plan))
                if t > 0:         # a window the profiler dropped reads 0
                    times[plan] = t
            ranked = sorted(times, key=times.get)
            row = {"shape": [M, K, N], "plan": list(SG.plan(M, N, K)),
                   "plan_ms": times.get(SG.plan(M, N, K)),
                   "best": [[list(p), times[p]] for p in ranked[:6]],
                   "all": [[list(p), times[p]] for p in ranked],
                   "library_ms": dms(lambda: torch.matmul(a, b))}
            result["gemm"].append(row)
            print("[gemm] " + json.dumps({k: v for k, v in row.items()
                                          if k != "all"}), flush=True)
    for B, T in ((1, 64), (1, 256), (1, 512), (8, 256)):
        q, k, v = randn(B, T, 14, 64), randn(B, T, 2, 64), randn(B, T, 2, 64)
        want = ref.flash_gqa_ref(q, k, v, True).float()
        chosen = FA.plan(B, T, T, 14, 2, True)
        times, plan = {}, FA.plan
        try:
            for s in range(1, FA.MAX_SPLITS + 1):
                FA.plan = lambda *_, s=s: s
                out = ops.flash_attention(q, k, v, causal=True).float()
                err = (out - want).abs().max().item()
                if err > 2e-2 + 2e-2 * want.abs().max().item():
                    raise AssertionError(f"flash T={T} S={s}: {err}")
                t = dms(lambda: ops.flash_attention(q, k, v, causal=True))
                if t > 0:         # a window the profiler dropped reads 0
                    times[s] = t
        finally:
            FA.plan = plan
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        row = {"b": B, "t": T, "plan": chosen, "plan_ms": times.get(chosen),
               "splits_ms": times, "library_ms": dms(
                   lambda: F.scaled_dot_product_attention(
                       qt, kt, vt, is_causal=True, enable_gqa=True))}
        result["flash"].append(row)
        print("[flash] " + json.dumps(row), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
