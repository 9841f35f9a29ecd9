#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure raises and exits non-zero:

1. Build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all at once) and print the card and its power
   limit.
2. Hold each kernel against its plain PyTorch version on the card at the
   main path's full-width shapes, with seeded inputs, and time the
   kernel, the plain version, a library call that computes the same
   function (a yardstick the port never calls), and the least time the
   card could take (bytes over 3.35 TB/s or operations over the bf16
   peak of 989 TFLOP/s, whichever is larger).  CUDA events, warm-up,
   the median of 10 runs, L2 flushed before each run.  GEMM at decode
   (M = 8) and prefill (M = 256) shapes, each marked ``on_path`` (the
   ``kernels`` line sums only those), flash at 64, 256 and 512 tokens,
   and ragged cases of both checked without timing; paged attention at
   a ragged mix of lengths up to 1,024, at 8 x 272 tokens (on the path),
   8 x 1,024 and 1 x 1,024, each beside SDPA over the same K/V gathered
   into a contiguous cache (what the page indirection costs; a
   yardstick the port never calls).
3. Serve qwen2-0.5b at full width (random weights from ``--seed``) with
   ``ServingEngine``: 8 slots, 16-token (4 KB) pages, 16 requests of
   64-512 prompt tokens and 32 new tokens each.  Launch counts are
   zeroed just before and read just after; every kernel must have run.
4. Profile five full-batch decode steps: device time by kernel beside
   the unprofiled wall time per step (the device's busy share); each
   GEMM and paged wrapper call must be exactly one device kernel.
5. Run one request (64-token prefill + 4 decode steps) on the card and
   again on the CPU, where every wrapper takes its plain version, and
   compare the logits.
6. Print the ``kernels`` JSON line, the card line, and last the result
   line ``{"ok": true, "device": {...}}``.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
BF16_FLOP_PER_S = 989e12        # H100 SXM dense bf16 tensor cores
BF16_TOL = 2e-2                 # one bf16 ulp of O(1) outputs, with margin
# card vs CPU, full width: bf16 activations through 24 layers rounded
# after sums in other orders, and flash probabilities rounded to bf16 on
# the card but not in the plain version
E2E_TOL = 5e-2
SPIN_CYCLES = 1_000_000         # ~0.5 ms at the H100's 1.98 GHz SM clock


def bound(nbytes, flops):
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Median CUDA-event time of ``fn`` in ms.  Before each run a 256 MB
    buffer is zeroed, which evicts the 50 MB L2 (the main path meets its
    weights cold), and the card then spins for ~0.5 ms
    (``torch.cuda._sleep``), so the host has enqueued the start event,
    the timed launch and the end event before the card reaches them:
    host overhead (~50 us per wrapper call) and host stalls are not
    counted, only the launch and the kernel on the card."""

    def __init__(self, torch, device):
        self.torch = torch
        self.flush = torch.empty(64 * 2**20, dtype=torch.float32,
                                 device=device)

    def __call__(self, fn, reps=10, warmup=3):
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(SPIN_CYCLES)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times)


def require(cond, msg):
    if not cond:
        raise AssertionError(msg)


def check_close(name, got, want, tol):
    err = (got.float() - want.float()).abs()
    lim = tol + tol * want.float().abs()
    bad = int((err > lim).sum())
    if bad or not bool(got.float().isfinite().all()):
        raise AssertionError(f"{name}: {bad} elements outside tol {tol}, "
                             f"max_abs_err {err.max().item()}")
    return err.max().item()


def phase_kernels(torch, args, dev, timer):
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.paged_attention import plan as paged_plan
    from repro_torch.kernels.streaming_gemm import plan as gemm_plan

    g = torch.Generator(device=dev).manual_seed(args.seed)
    bf16 = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(bf16)

    def summary(per_shape,
                keys=("ms", "plain_ms", "library_ms", "bound_ms")):
        """The kernel line's numbers: sums over the shapes the main path
        runs (``on_path``); the rest are printed and kept per shape."""
        on = [r for r in per_shape if r["on_path"]]
        return {**{k: sum(r[k] for r in on) for k in keys},
                "bound_by": "bytes" if sum(r["bound_by"] == "bytes"
                                           for r in on) * 2 >= len(on)
                else "operations",
                "timed_as": "sum over the on_path entries of per_shape"}

    rows = {}
    # ---- streaming GEMM: every projection, the MLP and the tied lm_head;
    # decode runs M = 8, prefill M = 64-512 (256 here) but never the
    # lm_head at M = 256 (only each prompt's last token reaches it)
    embed = randn(152064, 896, scale=0.02)
    per_shape = []
    for M in (8, 256):
        a = randn(M, 896)
        for K, N in ((896, 896), (896, 128), (896, 4864), (4864, 896),
                     (896, 152064)):
            if K == 896 and N == 152064:
                b, what = embed.t(), "lm_head embed.T"
            else:
                b, what = randn(K, N, scale=K ** -0.5), "weight"
            x = a if K == 896 else randn(M, K)
            err = check_close(f"gemm {M}x{K}x{N}", ops.streaming_gemm(x, b),
                              ref.gemm_ref(x, b), BF16_TOL)
            bms, by = bound(2 * (M * K + K * N + M * N), 2 * M * N * K)
            r = {"shape": [M, K, N], "b": what,
                 "on_path": not (M == 256 and N == 152064),
                 "plan": list(gemm_plan(M, N, K)), "max_abs_err": err,
                 "ms": timer(lambda: ops.streaming_gemm(x, b)),
                 "plain_ms": timer(lambda: ref.gemm_ref(x, b)),
                 "library_ms": timer(lambda: torch.matmul(x, b)),
                 "bound_ms": bms, "bound_by": by}
            per_shape.append(r)
            print(f"[gemm] M={M} K={K} N={N} ({what}, plan {r['plan']}, "
                  f"on_path {r['on_path']}): err {err:.3g} (tol {BF16_TOL}) "
                  f"kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms "
                  f"matmul {r['library_ms']:.4f} ms bound {bms:.4f} ms "
                  f"({by})", flush=True)
    # ragged edges through the split-K kernel: M, N and K off the tiles
    ragged = []
    for M, K, N, kcontig in ((5, 4824, 896, False), (37, 896, 1000, True),
                             (300, 4824, 136, False), (1, 896, 152000, True)):
        x = randn(M, K)
        b = randn(N, K, scale=K ** -0.5).t() if kcontig \
            else randn(K, N, scale=K ** -0.5)
        err = check_close(f"gemm ragged {M}x{K}x{N}",
                          ops.streaming_gemm(x, b), ref.gemm_ref(x, b),
                          BF16_TOL)
        ragged.append({"shape": [M, K, N], "b_kcontig": kcontig,
                       "plan": list(gemm_plan(M, N, K)), "max_abs_err": err})
        print(f"[gemm] ragged M={M} K={K} N={N} kcontig {kcontig}: err "
              f"{err:.3g} (tol {BF16_TOL})", flush=True)
    rows["streaming_gemm"] = {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/streaming_gemm.cu",
        "replaces": "src/repro/kernels/streaming_gemm.py:30",
        "tol": BF16_TOL,
        "max_abs_err": max(r["max_abs_err"] for r in per_shape + ragged),
        **summary(per_shape), "per_shape": per_shape, "ragged": ragged}

    # ---- flash attention: prefill of 64-, 256- and 512-token prompts
    B, H, KH, D = 1, 14, 2, 64
    per_shape = []
    for T in (64, 256, 512):
        q, k, v = randn(B, T, H, D), randn(B, T, KH, D), randn(B, T, KH, D)
        err = check_close(f"flash T={T}",
                          ops.flash_attention(q, k, v, causal=True),
                          ref.flash_gqa_ref(q, k, v, True), BF16_TOL)
        pairs = T * (T + 1) // 2
        bms, by = bound(2 * (2 * B * T * H * D + 2 * B * T * KH * D),
                        4 * B * H * D * pairs)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        r = {"shape": {"q": [B, T, H, D], "kv": [B, T, KH, D],
                       "causal": True}, "on_path": True,
             "max_abs_err": err,
             "ms": timer(lambda: ops.flash_attention(q, k, v, causal=True)),
             "plain_ms": timer(lambda: ref.flash_gqa_ref(q, k, v, True)),
             "library_ms": timer(lambda: F.scaled_dot_product_attention(
                 qt, kt, vt, is_causal=True, enable_gqa=True)),
             "bound_ms": bms, "bound_by": by}
        per_shape.append(r)
        print(f"[flash_attention] T={T}: err {err:.3g} (tol {BF16_TOL}) "
              f"kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms sdpa "
              f"{r['library_ms']:.4f} ms bound {bms:.4f} ms ({by})",
              flush=True)
    ragged = []
    for Tq, Tk, H_, KH_, D_, causal in ((100, 96, 14, 2, 64, True),
                                        (100, 96, 14, 2, 16, False),
                                        (96, 100, 7, 1, 128, True)):
        q = randn(2, Tq, H_, D_)
        k, v = randn(2, Tk, KH_, D_), randn(2, Tk, KH_, D_)
        err = check_close(f"flash ragged {Tq}/{Tk} D={D_}",
                          ops.flash_attention(q, k, v, causal=causal),
                          ref.flash_gqa_ref(q, k, v, causal), BF16_TOL)
        ragged.append({"tq_tk": [Tq, Tk], "heads": [H_, KH_], "d": D_,
                       "causal": causal, "max_abs_err": err})
        print(f"[flash_attention] ragged Tq={Tq} Tk={Tk} H={H_}/{KH_} "
              f"D={D_} causal {causal}: err {err:.3g} (tol {BF16_TOL})",
              flush=True)
    rows["flash_attention"] = {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:23",
        "tol": BF16_TOL,
        "max_abs_err": max(r["max_abs_err"] for r in per_shape + ragged),
        **summary(per_shape), "per_shape": per_shape, "ragged": ragged}

    # ---- paged attention: one decode step.  First PR 12's ragged mix
    # (lens 1-1,024, the first 1,024; kept first and unchanged), then
    # the decode profile's context, the longest context and a lone long
    # request.  Only shapes whose lengths the serving phase reaches
    # (prompts <= 512 plus 32 new tokens) are ``on_path``.
    B, H, KH, D, page, max_pages = 8, 14, 2, 64, 16, 64
    lens = torch.randint(1, 1025, (B,), generator=g, device=dev)
    lens[0] = 1024
    lens = lens.to(torch.int32)
    P = B * max_pages + 16
    table = torch.randperm(P, generator=g, device=dev)[:B * max_pages] \
        .reshape(B, max_pages).to(torch.int32)
    q = randn(B, H, D)
    kp, vp = randn(P, page, KH, D), randn(P, page, KH, D)

    def fixed(n, length):
        return torch.full((n,), length, dtype=torch.int32, device=dev)

    per_shape = []
    for what, ln in (("mixed", lens), ("8 x 272", fixed(B, 272)),
                     ("8 x 1024", fixed(B, 1024)),
                     ("1 x 1024", fixed(1, 1024))):
        n = ln.shape[0]
        qq, tt = q[:n].contiguous(), table[:n].contiguous()
        err = check_close(f"paged {what}",
                          ops.paged_attention(qq, kp, vp, tt, ln),
                          ref.paged_ref(qq, kp, vp, tt, ln), BF16_TOL)
        n_tok = int(ln.sum())
        bms, by = bound(2 * 2 * n * H * D + 4 * n * (max_pages + 1)
                        + 2 * 2 * n_tok * KH * D, 4 * H * D * n_tok)
        # yardstick, never called by the port: SDPA over the same K/V
        # already gathered into a contiguous (n, KH, 1024, D) cache with
        # a length mask, i.e. attention without the page indirection
        kc = kp[tt.long()].reshape(n, max_pages * page, KH, D) \
            .transpose(1, 2).contiguous()
        vc = vp[tt.long()].reshape(n, max_pages * page, KH, D) \
            .transpose(1, 2).contiguous()
        mask = (torch.arange(max_pages * page, device=dev)[None]
                < ln[:, None])[:, None, None, :]
        q4 = qq[:, :, None, :]

        def sdpa():
            return F.scaled_dot_product_attention(q4, kc, vc,
                                                  attn_mask=mask,
                                                  enable_gqa=True)

        check_close(f"paged {what} contiguous SDPA", sdpa()[:, :, 0],
                    ref.paged_ref(qq, kp, vp, tt, ln), BF16_TOL)
        r = {"shape": {"q": [n, H, D], "pool": [P, page, KH, D],
                       "lens": ln.tolist()}, "what": what,
             "on_path": int(ln.max()) <= 512 + 32,
             "plan": paged_plan(n, KH, max_pages), "max_abs_err": err,
             "ms": timer(lambda: ops.paged_attention(qq, kp, vp, tt, ln)),
             "plain_ms": timer(lambda: ref.paged_ref(qq, kp, vp, tt, ln)),
             "contiguous_sdpa_ms": timer(sdpa),
             "bound_ms": bms, "bound_by": by}
        per_shape.append(r)
        print(f"[paged_attention] {what} (plan S={r['plan']}, on_path "
              f"{r['on_path']}): err {err:.3g} (tol {BF16_TOL}) kernel "
              f"{r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms contiguous "
              f"SDPA {r['contiguous_sdpa_ms']:.4f} ms bound {bms:.4f} ms "
              f"({by})", flush=True)
    rows["paged_attention"] = {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:34",
        "tol": BF16_TOL,
        "max_abs_err": max(r["max_abs_err"] for r in per_shape),
        **summary(per_shape, ("ms", "plain_ms", "contiguous_sdpa_ms",
                              "bound_ms")),
        "library_ms": None, "per_shape": per_shape}
    return rows


def phase_serving(torch, args, cfg, params):
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import Request, ServingEngine

    def engine():
        return ServingEngine(cfg, params, slots=8, max_seq=1024,
                             kv_page_tokens=16, device="cuda")

    rng = np.random.default_rng(args.seed)
    warm = engine()                       # first-call set-up, not timed
    warm.submit(Request(uid=-1, prompt=rng.integers(
        1, cfg.vocab_size - 1, 64).astype(np.int32), max_new_tokens=2))
    warm.run_until_drained()
    del warm

    eng = engine()
    pool_mb = 2 * eng.cache.k_pages.numel() * 2 / 1e6
    reqs = [Request(uid=i, prompt=rng.integers(
        1, cfg.vocab_size - 1, int(rng.integers(64, 513))).astype(np.int32),
        max_new_tokens=32) for i in range(16)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    decode_ms = []
    while eng.queue or any(r is not None for r in eng.slot_req):
        n_prefills = eng.stats.prefills
        ts = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        if eng.stats.prefills == n_prefills:      # a decode-only step
            decode_ms.append((time.perf_counter() - ts) * 1e3)
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    eng.cache.validate()
    require(eng.cache.pages_in_use == 0, "pages leaked after the drain")
    for r in reqs:
        require(len(r.output) == 32 and all(
            0 <= t < cfg.vocab_size for t in r.output), (r.uid, r.output))
    missing = [k for k, n in launches.items() if n <= 0]
    require(not missing, f"main path never launched {missing}")
    ttft = sorted(r.first_token_s - r.submitted_s for r in reqs)
    tokens = sum(len(r.output) for r in reqs)
    res = {"requests": len(reqs), "tokens_out": tokens, "wall_s": wall,
           "tokens_per_s": tokens / wall,
           "ttft_p50_ms": float(np.percentile(ttft, 50)) * 1e3,
           "ttft_p95_ms": float(np.percentile(ttft, 95)) * 1e3,
           "decode_step_median_ms": statistics.median(decode_ms),
           "decode_steps": eng.stats.decode_steps,
           "decode_only_steps": len(decode_ms),
           "prefills": eng.stats.prefills, "launches": launches,
           "kv_pool_mb": pool_mb,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "validate": "ok"}
    print("[serving] " + json.dumps(res), flush=True)
    return res


def phase_card_vs_cpu(torch, args, cfg, params):
    import numpy as np
    from repro_torch.models.model import Model
    from repro_torch.models.params import params_to

    rng = np.random.default_rng(args.seed + 1)
    prompt = torch.as_tensor(rng.integers(1, cfg.vocab_size - 1, 64))
    forced = rng.integers(1, cfg.vocab_size - 1, 4)

    def run(device, p):
        m = Model(cfg, device=device)
        cache = m.init_cache(1, 128, page_tokens=16)
        cache.alloc_seq(0, 64)
        out = [m.prefill(p, prompt[None].to(m.device), cache, [0])]
        for t in forced:
            out.append(m.decode_step(p, cache, torch.tensor(
                [int(t)], device=m.device), [0]))
        return torch.cat(out).float().cpu()

    t0 = time.perf_counter()
    card = run("cuda", params)
    cpu = run("cpu", params_to(params, "cpu"))
    require(card.shape == (5, cfg.padded_vocab) and
            bool(card.isfinite().all()), "card logits malformed")
    err = (card - cpu).abs().max().item()
    scale = max(1.0, cpu.abs().max().item())
    res = {"max_abs_err": err, "max_abs_logit": cpu.abs().max().item(),
           "tol": E2E_TOL * scale,
           "argmax_agree": int((card.argmax(-1) == cpu.argmax(-1)).sum()),
           "seconds": time.perf_counter() - t0}
    print("[card_vs_cpu] " + json.dumps(res), flush=True)
    if err > E2E_TOL * scale:
        raise AssertionError(f"card vs CPU logits differ by {err}")
    return res


def _kernel_group(name):
    for key, group in (("gemm_bf16", "streaming_gemm"),
                       ("gemm_simt", "streaming_gemm"),
                       ("flash_bf16", "flash_attention"),
                       ("flash_f32", "flash_attention"),
                       ("paged_fwd", "paged_attention")):
        if key in name:
            return group
    return "other (torch ops)"


def phase_profile(torch, args, cfg, params, n_steps=5):
    """Where a full-batch decode step's time goes: ``torch.profiler``
    device time by kernel over ``n_steps`` decode steps of 8 slots
    (prompts of 256 tokens), beside the same steps' unprofiled wall
    time.  The profiler only reads the device's kernel times here; the
    wall time comes from the unprofiled steps before it."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import Request, ServingEngine

    rng = np.random.default_rng(args.seed + 2)
    eng = ServingEngine(cfg, params, slots=8, max_seq=1024,
                        kv_page_tokens=16, device="cuda")
    for i in range(8):
        eng.submit(Request(uid=i, prompt=rng.integers(
            1, cfg.vocab_size - 1, 256).astype(np.int32),
            max_new_tokens=4 * n_steps))
    eng.step()                          # admits all 8, one decode step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        eng.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    ops.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
    per_step = {k: n / n_steps for k, n in ops.LAUNCHES.items()}
    groups: dict = {}
    kernels: dict = {}
    from torch.autograd import DeviceType
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:   # host ops would double-count
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            g = _kernel_group(ev.key)
            groups[g] = groups.get(g, 0.0) + us / 1e3 / n_steps
            kernels[g] = kernels.get(g, 0) + ev.count / n_steps
    busy = sum(groups.values())
    res = {"slots": 8, "context": "256-276", "steps": n_steps,
           "wall_ms_per_step": wall_ms,
           "device_ms_per_step": groups or "not measured",
           "device_busy_share": busy / wall_ms if groups else
           "not measured", "launches_per_step": per_step,
           "device_kernels_per_step": kernels or "not measured"}
    print("[decode_profile] " + json.dumps(res), flush=True)
    # one device kernel per wrapper call: no hidden second pass
    for name in ("streaming_gemm", "paged_attention"):
        if kernels and kernels.get(name) != per_step[name]:
            raise AssertionError(f"{name}: {kernels.get(name)} device "
                                 f"kernels per step for {per_step[name]} "
                                 f"wrapper calls")
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script measures the "
                 "card and has no CPU mode")
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models.model import Model

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.build_all(verbose=True)
    print(f"[build] {time.perf_counter() - t0:.1f} s; torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)
    card = card_line()
    print(f"[card] {card}", flush=True)

    timer = Timer(torch, dev)
    rows = phase_kernels(torch, args, dev, timer)
    del timer

    cfg = get_config("qwen2-0.5b")
    g = torch.Generator(device=dev).manual_seed(args.seed)
    params = Model(cfg, device=dev).init(g)
    serving = phase_serving(torch, args, cfg, params)
    phase_profile(torch, args, cfg, params)
    phase_card_vs_cpu(torch, args, cfg, params)

    kernels = [{"name": name, **rows[name],
                "launches": serving["launches"][name]} for name in rows]
    print(json.dumps({"kernels": kernels, "card": card}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
