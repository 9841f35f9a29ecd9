"""Sweep the launch plans of the bf16 kernels on the card.

    python -m repro_torch.launch.kernel_sweep [--only gemm|flash|paged]
        [--out PATH] [--reps N]

For every main-path shape of qwen2-0.5b (GEMM at decode M = 8 and
prefill M = 256; causal prefill attention at 64-512 tokens; paged decode
attention over a 64-page table at a ragged mix of lengths, 8 x 272,
8 x 1,024 and 1 x 1,024 tokens) it runs the kernel at every tile / split
the kernel accepts, checks each result against the plain version, and
reports the device time of each from ``torch.profiler`` (the mean over
``--reps`` launches, the L2 flushed before each), beside the plan that
``plan`` picks and the device time of the library call (``torch.matmul``,
SDPA) on the same inputs; for paged attention, where no library call
reads a page table, SDPA over the same K/V gathered into a contiguous
cache with a length mask.

This is the tool that chose the rules of ``streaming_gemm.plan``,
``flash_attention.plan`` and ``paged_attention.plan``; it needs a card
and exits without one.
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
PA = importlib.import_module("repro_torch.kernels.paged_attention")
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
        if "fill" in ev.key.lower():
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
    ap.add_argument("--only", choices=("gemm", "flash", "paged"),
                    help="sweep one kernel (default: all three)")
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
    result = {"card": card, "gemm": [], "flash": [], "paged": []}
    if args.only in (None, "gemm"):
        _sweep_gemm(result, randn, dms, main_fn)
    if args.only in (None, "flash"):
        _sweep_flash(result, randn, dms, F)
    if args.only in (None, "paged"):
        _sweep_paged(result, randn, dms, F, g, dev)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)


def _sweep_gemm(result, randn, dms, main_fn):
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


def _sweep_flash(result, randn, dms, F):
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


def _sweep_paged(result, randn, dms, F, g, dev):
    """Every cluster size S = 1..8 at ``chip_smoke.py``'s paged shapes
    (the ragged mix is a draw of its own: lengths 1-1,024, the first
    1,024)."""
    B, H, KH, D, page, mp = 8, 14, 2, 64, 16, 64
    P = B * mp + 16
    mixed = torch.randint(1, 1025, (B,), generator=g, device=dev)
    mixed[0] = 1024
    table = torch.randperm(P, generator=g, device=dev)[:B * mp] \
        .reshape(B, mp).to(torch.int32)
    q = randn(B, H, D)
    kp, vp = randn(P, page, KH, D), randn(P, page, KH, D)
    for what, lens in (("mixed", mixed.tolist()), ("8 x 272", [272] * B),
                       ("8 x 1024", [1024] * B), ("1 x 1024", [1024])):
        n = len(lens)
        ln = torch.tensor(lens, dtype=torch.int32, device=dev)
        qq, tt = q[:n].contiguous(), table[:n].contiguous()
        want = ref.paged_ref(qq, kp, vp, tt, ln).float()
        chosen = PA.plan(n, KH, mp)
        times, plan = {}, PA.plan
        try:
            for s in range(1, PA.MAX_SPLITS + 1):
                PA.plan = lambda *_, s=s: s
                out = ops.paged_attention(qq, kp, vp, tt, ln).float()
                err = (out - want).abs().max().item()
                if err > 2e-2 + 2e-2 * want.abs().max().item():
                    raise AssertionError(f"paged {what} S={s}: {err}")
                t = dms(lambda: ops.paged_attention(qq, kp, vp, tt, ln))
                if t > 0:         # a window the profiler dropped reads 0
                    times[s] = t
        finally:
            PA.plan = plan
        kc = kp[tt.long()].reshape(n, mp * page, KH, D).transpose(1, 2) \
            .contiguous()
        vc = vp[tt.long()].reshape(n, mp * page, KH, D).transpose(1, 2) \
            .contiguous()
        mask = (torch.arange(mp * page, device=dev)[None]
                < ln[:, None])[:, None, None, :]
        row = {"what": what, "b": n, "lens": lens, "plan": chosen,
               "plan_ms": times.get(chosen), "splits_ms": times,
               "contiguous_sdpa_ms": dms(
                   lambda: F.scaled_dot_product_attention(
                       qq[:, :, None], kc, vc, attn_mask=mask,
                       enable_gqa=True))}
        result["paged"].append(row)
        print("[paged] " + json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
