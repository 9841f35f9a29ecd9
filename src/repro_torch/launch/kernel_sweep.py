"""Sweep the launch plans of the kernels on the card.

    python -m repro_torch.launch.kernel_sweep
        [--only gemm|grouped|flash|paged] [--out PATH] [--reps N]

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
cache with a length mask.  granite-20b's shapes are swept beside them:
its GEMM widths (d 6,144: q/o 6,144 x 6,144, k/v 6,144 x 128, the
non-gated MLP 6,144 x 24,576 and back, the lm_head 6,144 x 49,152 at
decode) and its paged decode attention (48 query heads of 128 over one
KV head, 3 query-head groups) at 8 x 272 tokens and a ragged mix up to
1,024.  So are zamba2-7b's: its GEMM widths (d 3,584: ``in_proj`` 3,584
x 14,576, ``out_proj`` 7,168 x 3,584, the gated MLP 3,584 x 14,336 and
back, the shared block's q/k/v/o 3,584 x 3,584, the lm_head 3,584 x
32,000 at decode), its causal prefill attention (32 / 32 heads of 112)
at 64-512 tokens and its paged decode attention (32 / 32 heads of 112).
deepseek-v3-671b's MLA: its causal prefill attention (128 / 128 heads,
q/k dim 192, v dim 128) at 64-512 tokens, and the paged kernel's latent
form (128 query heads of 576 over one latent head, V its first 512
columns, scale 1/√192) at 8 x 272, a ragged mix up to 1,024 and 1 x
1,024, at every cluster size, beside SDPA over a contiguous copy of the
latent rows.  Each paged shape whose head dim the int8 form takes is
swept again over int8 pools (the same values quantized, with their fp16
scales; the INT8 KV cache), its yardstick SDPA over a contiguous
dequantized copy.
The expert-grouped GEMM runs at
qwen2-moe-a2.7b's (60 experts, 2,048 <-> 1,408) and deepseek-v3's (256
experts, 7,168 <-> 2,048) gate/up and down products, at decode (8
tokens) and prefill (512 / 256 tokens), and at deepseek-v3's absorbed
per-head products, each at every ring depth and at half or all of the
SMs, beside ``torch.bmm`` over the whole (E, C, K) buffer.

This is the tool that chose the rules of ``streaming_gemm.plan``,
``grouped_gemm.plan_grouped``, ``flash_attention.plan``,
``paged_attention.plan`` and ``paged_attention.latent_plan``; it needs a
card and exits without one.
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
GG = importlib.import_module("repro_torch.kernels.grouped_gemm")
FA = importlib.import_module("repro_torch.kernels.flash_attention")
PA = importlib.import_module("repro_torch.kernels.paged_attention")
GEMM_KN = ((896, 896), (896, 128), (896, 4864), (4864, 896), (896, 152064))
GRANITE_KN = ((6144, 6144), (6144, 128), (6144, 24576), (24576, 6144),
              (6144, 49152))
ZAMBA_KN = ((3584, 14576), (7168, 3584), (3584, 14336), (14336, 3584),
            (3584, 3584), (3584, 32000))
LM_HEAD_N = (152064, 49152, 32000)      # run at decode only


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
                    a.stride(0), ldb, 0, int(kcontig), N, *plan,
                    SG.copy_width(a, a.stride(0), K),
                    SG.copy_width(b, ldb, K if kcontig else N),
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
    ap.add_argument("--only", choices=("gemm", "grouped", "flash", "paged"),
                    help="sweep one kernel (default: all)")
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
    result = {"card": card, "gemm": [], "grouped": [], "flash": [],
              "paged": []}
    if args.only in (None, "gemm"):
        _sweep_gemm(result, randn, dms, main_fn)
    if args.only in (None, "grouped"):
        _sweep_grouped(result, randn, dms, g, dev)
    if args.only in (None, "flash"):
        _sweep_flash(result, randn, dms, F)
    if args.only in (None, "paged"):
        _sweep_paged(result, randn, dms, F, g, dev)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)


def _sweep_gemm(result, randn, dms, main_fn):
    embed = randn(152064, 896, scale=0.02)
    for M, K, N in [(M, K, N) for kn in (GEMM_KN, GRANITE_KN, ZAMBA_KN)
                    for M in (8, 256) for K, N in kn]:
        if M == 256 and N in LM_HEAD_N:
            continue
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


def _sweep_grouped(result, randn, dms, g, dev):
    """The grouped kernel's knobs, the ring's stages (3-6) and the grid
    (half or all of the SMs), at qwen2-moe-a2.7b's products (60 experts,
    2,048 <-> 1,408, top-4) and deepseek-v3's (256 experts, 7,168 <->
    2,048, top-8), each at decode (8 tokens) and prefill (512 / 256
    tokens), and at the absorbed decode's per-head products (128 heads,
    128 -> 512 and 512 -> 128, 8 rows, the heads of a token-major
    tensor)."""
    cases = []
    for E, k, d, f, n_pre in ((60, 4, 2048, 1408, 512),
                              (256, 8, 7168, 2048, 256)):
        for what, n in (("decode", 8), ("prefill", n_pre)):
            top_e = torch.rand((n, E), generator=g, device=dev).topk(k) \
                .indices
            counts = torch.bincount(top_e.reshape(-1), minlength=E) \
                .to(torch.int32)
            for prod, K, N in (("gate/up", d, f), ("down", f, d)):
                cases.append((f"E={E} {what} {prod}", E, n, K, N, counts,
                              False))
    heads = torch.full((128,), 8, dtype=torch.int32, device=dev)
    cases += [("absorbed q_nope W_uk", 128, 8, 128, 512, heads, True),
              ("absorbed o_lat W_uv", 128, 8, 512, 128, heads, True)]
    for what, E, C, K, N, counts, strided in cases:
        rows = torch.arange(C, device=dev)[None, :] < counts[:, None]
        if strided:
            a = randn(C, E, K).transpose(0, 1)
        else:
            a = randn(E, C, K)
            a[~rows] = 0
        b = randn(E, K, N, scale=K ** -0.5)
        want = ref.grouped_gemm_ref(a, b, counts)[rows].float()
        chosen = GG.plan_grouped(E, C, N, K)
        times, plan_grouped = {}, GG.plan_grouped
        try:
            for grid in (GG.SMS // 2, GG.SMS):
                for stages in range(GG.MIN_STAGES, GG.MAX_STAGES + 1):
                    plan = (min(grid, chosen[0]), stages, chosen[2])
                    if plan in times:
                        continue
                    GG.plan_grouped = lambda *_, p=plan: p
                    got = ops.grouped_streaming_gemm(a, b, counts)
                    err = (got[rows].float() - want).abs().max().item()
                    if err > 2e-2 + 2e-2 * want.abs().max().item():
                        raise AssertionError(f"grouped {what} {plan}: {err}")
                    t = dms(lambda: ops.grouped_streaming_gemm(a, b, counts))
                    if t > 0:  # a window the profiler dropped reads 0
                        times[plan] = t
        finally:
            GG.plan_grouped = plan_grouped
        ranked = sorted(times, key=times.get)
        row = {"what": what, "shape": [E, C, K, N],
               "rows": int(counts.sum()),
               "experts_touched": int((counts > 0).sum()),
               "plan": list(chosen), "plan_ms": times.get(chosen),
               "best": [[list(p), times[p]] for p in ranked[:6]],
               "library_ms": dms(lambda: torch.bmm(a, b))}
        result["grouped"].append(row)
        print("[grouped] " + json.dumps(row), flush=True)
        del a, b


def _sweep_flash(result, randn, dms, F):
    """qwen2-0.5b's heads (14 / 2 of 64), zamba2-7b's (32 / 32 of 112)
    and deepseek-v3's MLA prefill (128 / 128 of q/k 192, v 128)."""
    for H, KH, D, Dv, B, T in [(14, 2, 64, 64, B, T) for B, T in (
            (1, 64), (1, 256), (1, 512), (8, 256))] + [
            (32, 32, 112, 112, 1, T) for T in (64, 256, 512)] + [
            (128, 128, 192, 128, 1, T) for T in (64, 256, 512)]:
        q, k, v = randn(B, T, H, D), randn(B, T, KH, D), randn(B, T, KH, Dv)
        want = ref.flash_gqa_ref(q, k, v, True).float()
        chosen = FA.plan(B, T, T, H, KH, True)
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
        row = {"heads": [H, KH, D, Dv], "b": B, "t": T, "plan": chosen,
               "plan_ms": times.get(chosen),
               "splits_ms": times, "library_ms": dms(
                   lambda: F.scaled_dot_product_attention(
                       qt, kt, vt, is_causal=True, enable_gqa=True))}
        result["flash"].append(row)
        print("[flash] " + json.dumps(row), flush=True)


def _sweep_paged(result, randn, dms, F, g, dev):
    """Every cluster size S = 1..8 at ``chip_smoke.py``'s paged shapes,
    qwen2-0.5b's (14 / 2 heads of 64) and granite-20b's (48 / 1 heads of
    128, 3 query-head groups), beside one group's work alone (16 / 1
    heads of 128: what the second and third groups' CTAs and page reads
    add), zamba2-7b's (32 / 32 heads of 112) and qwen1.5-32b's (40 / 40
    heads of 128); each ragged mix is a draw of its own: lengths 1-1,024,
    the first 1,024.  bf16 and int8 pools."""
    for H, KH, D in ((14, 2, 64), (48, 1, 128), (16, 1, 128),
                     (32, 32, 112), (40, 40, 128)):
        _sweep_paged_heads(result, randn, dms, F, g, dev, H, KH, D)
    _sweep_latent(result, randn, dms, F, g, dev)


def _sweep_latent(result, randn, dms, F, g, dev, H=128, D=576, dv=512):
    """The latent form at every cluster size, deepseek-v3's decode
    shapes (its own ragged mix: lengths 64-1,024, the first 1,024)."""
    B, page, mp, scale = 8, 16, 64, 192 ** -0.5
    P = B * mp + 16
    mixed = torch.randint(64, 1025, (B,), generator=g, device=dev)
    mixed[0] = 1024
    table = torch.randperm(P, generator=g, device=dev)[:B * mp] \
        .reshape(B, mp).to(torch.int32)
    q, pool = randn(B, H, D), randn(P, page, 1, D)
    for what, lens in (("mixed", mixed.tolist()), ("8 x 272", [272] * B),
                       ("1 x 1024", [1024])):
        n = len(lens)
        ln = torch.tensor(lens, dtype=torch.int32, device=dev)
        qq, tt = q[:n].contiguous(), table[:n].contiguous()
        want = ref.paged_ref(qq, pool, pool, tt, ln, dv=dv,
                             scale=scale).float()
        chosen = PA.latent_plan(n, H, mp, page)
        times, plan = {}, PA.latent_plan
        try:
            for s in range(1, PA.MAX_SPLITS + 1):
                PA.latent_plan = lambda *_, s=s: s
                out = ops.paged_latent_attention(qq, pool, tt, ln, dv,
                                                 scale).float()
                err = (out - want).abs().max().item()
                if err > 2e-2 + 2e-2 * want.abs().max().item():
                    raise AssertionError(f"latent {what} S={s}: {err}")
                t = dms(lambda: ops.paged_latent_attention(
                    qq, pool, tt, ln, dv, scale))
                if t > 0:         # a window the profiler dropped reads 0
                    times[s] = t
        finally:
            PA.latent_plan = plan
        kc = pool[tt.long()].reshape(n, 1, mp * page, D)
        vc = kc[..., :dv].contiguous()
        mask = (torch.arange(mp * page, device=dev)[None]
                < ln[:, None])[:, None, None, :]
        row = {"what": what, "heads": [H, 1, D, dv], "latent": True,
               "b": n, "lens": lens, "plan": chosen,
               "plan_ms": times.get(chosen), "splits_ms": times,
               "contiguous_sdpa_ms": dms(
                   lambda: F.scaled_dot_product_attention(
                       qq[:, :, None], kc, vc, attn_mask=mask, scale=scale,
                       enable_gqa=True))}
        result["paged"].append(row)
        print("[paged_latent] " + json.dumps(row), flush=True)


def _sweep_paged_heads(result, randn, dms, F, g, dev, H, KH, D):
    """One head shape's paged entries over bf16 pools, then (where the
    int8 form takes the head dim) over the same values quantized into
    int8 pools with their fp16 scales, at the same lengths; the int8
    rows' yardstick is SDPA over a contiguous dequantized copy."""
    B, page, mp = 8, 16, 64
    P = B * mp + 16
    mixed = torch.randint(1, 1025, (B,), generator=g, device=dev)
    mixed[0] = 1024
    table = torch.randperm(P, generator=g, device=dev)[:B * mp] \
        .reshape(B, mp).to(torch.int32)
    q = randn(B, H, D)
    kp, vp = randn(P, page, KH, D), randn(P, page, KH, D)
    pools = {"bfloat16": (kp, vp)}
    if D in PA.INT8_HEAD_DIMS:
        (kc, ks), (vc, vs) = (ref.kv_quantize_ref(p) for p in (kp, vp))
        pools["int8"] = (kc, vc, ks.permute(0, 2, 1).contiguous(),
                         vs.permute(0, 2, 1).contiguous())
    for dtype, pl in pools.items():
        for what, lens in (("mixed", mixed.tolist()), ("8 x 272", [272] * B),
                           ("8 x 1024", [1024] * B), ("1 x 1024", [1024])):
            row = _paged_row(dms, F, dev, q, pl, table, what, lens)
            row["pool_dtype"] = dtype
            result["paged"].append(row)
            print("[paged] " + json.dumps(row), flush=True)


def _paged_row(dms, F, dev, q, pools, table, what, lens):
    """Every cluster size at one paged shape; ``pools`` is (k, v) or,
    int8, (k, v, k_scale, v_scale)."""
    kp, vp = pools[:2]
    H, D = q.shape[1:]
    page, KH = kp.shape[1:3]
    mp = table.shape[1]
    n = len(lens)
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
    qq, tt = q[:n].contiguous(), table[:n].contiguous()
    scales = dict(zip(("k_scale", "v_scale"), pools[2:]))
    want = ref.paged_ref(qq, kp, vp, tt, ln, **scales).float()
    groups, chosen = PA.launch_plan(n, H, KH, D, mp)
    times, plan = {}, PA.plan
    try:
        for s in range(1, PA.MAX_SPLITS + 1):
            PA.plan = lambda *_, s=s: s
            out = ops.paged_attention(qq, *pools[:2], tt, ln,
                                      *pools[2:]).float()
            err = (out - want).abs().max().item()
            if err > 2e-2 + 2e-2 * want.abs().max().item():
                raise AssertionError(f"paged {what} S={s}: {err}")
            t = dms(lambda: ops.paged_attention(qq, *pools[:2], tt, ln,
                                                *pools[2:]))
            if t > 0:         # a window the profiler dropped reads 0
                times[s] = t
    finally:
        PA.plan = plan

    def contiguous(pool, sc):
        x = pool[tt.long()]
        if sc is not None:        # dequantized: codes x their scales
            x = (x.float() * sc[tt.long()].permute(0, 1, 3, 2)[..., None]
                 .float()).to(torch.bfloat16)
        return x.reshape(n, mp * page, KH, D).transpose(1, 2).contiguous()

    kc = contiguous(kp, scales.get("k_scale"))
    vc = contiguous(vp, scales.get("v_scale"))
    mask = (torch.arange(mp * page, device=dev)[None]
            < ln[:, None])[:, None, None, :]
    return {"what": what, "heads": [H, KH, D], "groups": groups,
            "b": n, "lens": lens, "plan": chosen,
            "plan_ms": times.get(chosen), "splits_ms": times,
            "contiguous_sdpa_ms": dms(
                lambda: F.scaled_dot_product_attention(
                    qq[:, :, None], kc, vc, attn_mask=mask,
                    enable_gqa=True))}


if __name__ == "__main__":
    main()
