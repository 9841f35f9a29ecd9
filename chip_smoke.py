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
   ``kernels`` line sums only those), flash at 64, 256 and 512 tokens;
   the layer projections at M = 512 and 4,096 and flash at 1 x 8 and
   8 x 512 tokens, which phase 6c runs, as entries off the path; and
   ragged cases of both checked without timing; paged attention at
   a ragged mix of lengths up to 1,024, at 8 x 272 tokens (on the path),
   8 x 1,024 and 1 x 1,024, each beside SDPA over the same K/V gathered
   into a contiguous cache (what the page indirection costs; a
   yardstick the port never calls).
3. Serve qwen2-0.5b at full width (random weights from ``--seed``) with
   ``ServingEngine``: 8 slots, 16-token (4 KB) pages, 16 requests of
   64-512 prompt tokens and 32 new tokens each.  Launch counts are
   zeroed just before and read just after; every kernel of the dense
   path must have run.
4. Profile five full-batch decode steps: device time by kernel beside
   the unprofiled wall time per step (the device's busy share); each
   GEMM and paged wrapper call must be exactly one device kernel.  A
   window the profiler recorded empty is profiled again (3 at most).
5. Run one request (64-token prefill + 4 decode steps) on the card and
   again on the CPU, where every wrapper takes its plain version, and
   compare the logits.
6. Page streaming (``repro_torch.core``), printed as one
   ``{"streaming": {...}}`` line: (a) Algorithm 1 (``gemm_streamed``) on
   fp16 1024 x 1024 x 1024 in DevMem, DM and DC, twice each in turns,
   every DMA_IN one 4 KB copy from pinned memory, held against an
   fp32-accumulated product within 1e-2 and against the traffic a CPU
   store meters for the same plan; (b) the decode-step plan of 8
   prefilled slots (64-512 tokens, 16-token pages) over layer 0 of the
   live pool, in DM, against the plain paged attention in fp32 on the
   plan's fp16-cast inputs (rtol 1e-4, atol 1e-5) and against the paged
   kernel within 5e-3 x max|output| (its bf16 rounding), with 2 lookups
   per held page; (c) all 24 layers behind a ``LayerStreamer``
   (DM and DC weights packed one pinned row per layer, one copy per
   fetch on a side stream, DC caching 8 layers) at 1 x 8, 1 x 512 and
   8 x 512 tokens, three passes per mode in turns: outputs bitwise equal
   across modes, bytes per pass 24 (DM) and 16 (DC from pass 2) layers,
   beside a bare copy of the 24 layers from pinned memory; prints each
   mode's median pass, DM's GB/s, DevMem/DM, the overlap share (copy +
   compute - DM) / min(copy, compute), and a profiled DM pass (kernel
   and copy time on the device, the copy time under kernels).
7. The MoE path, after the dense weights are freed: qwen2-moe-a2.7b at
   full width and depth (24 layers, d 2,048, 60 routed experts of d_ff
   1,408, top-4, 4 shared; 28.6 GB of random bf16 weights from
   ``--seed``).  (a) The expert-grouped GEMM against its plain version
   and timed beside ``torch.bmm`` over the whole buffer, at decode (C =
   8) and 512-token prefill (C = 512) with counts from routing random
   tokens through layer 0's router, for gate/up and down over the
   model's expert weights; ragged cases (counts 0, C and mid-tile; N and
   K off the tiles); then the 2-D GEMM (q, the router, the shared
   experts, the untied lm_head), flash (16/16 heads of 128) and paged
   attention at the MoE path's shapes, kept as each row's ``moe_path``.
   (b) Serving as in phase 3 with 16 new tokens; all four wrappers
   must run.  (c) Three full-batch decode steps profiled as in phase 4;
   each grouped wrapper call one device kernel.  (d) Two full-width
   layers, a 256-token prefill and 4 decode steps on the card and on
   the CPU: each MoE call's router input on the card routed again on
   the CPU, at least 0.97 of the (layer, token) expert sets equal (the
   chained rate of the whole CPU run printed beside), and the logits
   within E2E_TOL x max(1, max|logit|) at the positions routed alike in
   every layer.
8. The dense variants, after the MoE weights are freed: internvl2-2b
   (vlm; 3.78 GB), chatglm3-6b (2-D RoPE, 32 / 2 heads of 128; 12.49 GB),
   granite-20b (layernorm, non-gated GELU MLP, MQA 48 / 1 heads of
   128: the paged kernel in 3 query-head groups; 40.63 GB) and
   qwen1.5-32b (64 layers, d 5,120, 40 / 40 heads of 128; 70.39 GB) in
   turn, each at full width and depth with random bf16 weights from
   ``--seed`` and freed before the next.  (a) Each kernel at the arch's
   shapes, kept as each row's ``<arch>_path``: the GEMM at M = 8 and 256
   over layer 0's q/k/v/o and MLP weights and the untied lm_head at M =
   8, flash at 256 tokens, paged at 8 x 272 and a ragged mix up to
   1,024, and an edge case (lens 0, 1, a page boundary, the full table)
   at the arch's group count.  (b) Serving as in phase 3 with 8 requests
   of 64-256 prompt tokens and 8 new tokens, over a KV pool sized from
   the memory the card has left beside the weights (less a stated
   margin, at most 8 x 1,024 tokens; printed); all three wrappers must
   run.  (c) Three full-batch decode steps profiled as in phase 4.  (d)
   The first two layers, a 64-token prefill and 4 decode steps on the
   card and on the CPU, logits within E2E_TOL x max(1, max|logit|);
   internvl2-2b also prefills from 256 seeded bf16 embeddings of width
   2,048 on both.  Each sub-phase's seconds are printed.
9. whisper-tiny (encoder-decoder: 4 + 4 layers, d 384, 6 / 6 heads of
   64; random bf16 weights from ``--seed``) through ``Model`` at full
   width and depth.  (a) Each kernel at its shapes, kept as each row's
   ``whisper-tiny_path``: the GEMM at the encoder's M = 12,000 and the
   decoder's M = 8 and the lm_head, flash non-causal over 1,500 frames
   (self-attention, and the 4-token prompt's cross-attention), paged
   attention over the 94-page cross table and the self table.  (b) A
   batched greedy loop: 8 clips of 1,500 seeded frames, the 4-token
   start-of-transcript prompt, 64 new tokens each; prints the encoder
   ms, TTFT, the median decode step, tokens/s and the peak memory; all
   three wrappers must run.  (c) Three decode steps profiled as in phase
   4.  (d) The whole model, 2 clips, a prefill and 4 decode steps on the
   card and on the CPU, logits within E2E_TOL x max(1, max|logit|).
10. rwkv6-7b (attention-free: 32 layers, d 4,096, 64 heads of 64,
   d_ff 14,336; 16.11 GB of random bf16 weights from ``--seed``), after
   whisper's weights are freed.  (a) The GEMM at M = 8 and 256 over
   layer 0's nine weights (time mix r, k, v, g, w, o; channel mix k, v,
   r) and the untied lm_head at M = 8, kept as the GEMM row's
   ``rwkv6-7b_path``; and the scan's two PyTorch ops (not kernels),
   printed as one ``{"scan_ops": [...]}`` line: ``linear_attention_step``
   at 8 slots of 64 heads of 64 and the chunked scan of a 256-token
   prompt, each timed, given its bound and held against the same op in
   fp32 on the CPU.  (b) Serving as in phase 8 over the per-slot
   recurrent state (no KV pool); the GEMM must run and flash and paged
   attention must not.  (c) Three full-batch decode steps profiled as in
   phase 4, after 64-token prompts.  (d) The first two layers, a
   64-token prefill and 4 decode steps on the card and on the CPU:
   logits and each layer's scan state within E2E_TOL x max(1, max|.|).
11. zamba2-7b (hybrid: 81 Mamba2 layers, d 3,584, d_ff 14,336, one
   shared attention block of 32 / 32 heads of 112 before every sixth
   layer, 14 invocations; 38.16 GB of random bf16 weights from
   ``--seed``), after rwkv's weights are freed.  (a) As phase 8a over
   layer 0's ``in_proj``, ``out_proj`` and MLP and the shared block's
   q/k/v/o (each row's ``zamba2-7b_path``): flash and paged attention at
   head dim 112; and the Mamba2 scan op (one decode step of 8 slots x
   112 heads of (64, 64), the chunked scan of a 256-token prompt) as a
   ``{"scan_ops": [...]}`` line.  (b) Serving as in phase 8 over a KV
   pool of 14 layers (one per invocation) and the per-slot state
   store; GEMM, flash and paged attention must run, the grouped GEMM
   must not.  (c) Three full-batch decode steps profiled as in phase 4,
   14 paged calls a step.  (d) The first 7 layers (the shared block at
   layers 0 and 6, two pool layers), a 64-token prefill and 4 decode
   steps on the card and on the CPU: logits and each layer's scan
   state within E2E_TOL x max(1, max|.|).
12. deepseek-v3-671b (multi-head latent attention and 256 routed
   experts, top-8) at full width cut in depth to its 3 dense and first 2
   MoE layers (``deepseek-v3-671b-5l``: d 7,168, 128 heads, q/k 128 +
   64 and v 128, latent 512 + 64, vocabulary 129,280; 51.8 GB of random
   bf16 weights from ``--seed``), after zamba2's weights are freed.  (a)
   As phase 8a over layer 0's MLA weights and MLP, layer 3's router and
   shared expert and the lm_head; the grouped GEMM at decode and a
   256-token prefill over 256 experts and at the absorbed decode's
   per-head products; flash at q/k dim 192, v dim 128; the latent paged
   kernel (128 heads of 576 over one latent head, V its first 512
   columns) at 8 x 272 and mixed 64-1,024 beside SDPA over a contiguous
   copy (each row's ``deepseek-v3-671b-5l_path``; the latent kernel's
   own row).  (b) Serving as in phase 8 over one latent pool a layer;
   GEMM, grouped GEMM, flash and the latent kernel must run, the GQA
   paged kernel must not.  (c) Three full-batch decode steps profiled as
   in phase 4, one latent call a layer.  (d) The 3 dense layers and the
   lm_head, a 64-token prefill and 4 decode steps on the card and on the
   CPU, logits within E2E_TOL x max(1, max|logit|); then layer 3's MoE
   alone on the card's hidden states of a 256-token prompt (a prefill
   and an 8-token decode batch): at least 0.97 of the expert sets equal
   (flips counted by experts changed), outputs of the tokens routed
   alike within E2E_TOL x max(1, max|y|).
13. Print the ``kernels`` JSON line (each kernel's launches from its own
   path's serving run, every path's counts beside), the card line, and
   last the result line ``{"ok": true, "device": {...}}``.
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
FP32_FLOP_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
BF16_TOL = 2e-2                 # one bf16 ulp of O(1) outputs, with margin
# card vs CPU, full width: bf16 activations through 24 layers rounded
# after sums in other orders, and flash probabilities rounded to bf16 on
# the card but not in the plain version
E2E_TOL = 5e-2
DENSE_KERNELS = ("streaming_gemm", "flash_attention", "paged_attention")
MOE_ARCH = "qwen2-moe-a2.7b"
MOE_PATH_KERNELS = ("streaming_gemm", "streaming_gemm_grouped",
                    "flash_attention", "paged_attention")
# card vs CPU expert choices: a 1-ulp difference in a bf16 router logit
# may flip one top-4 choice at a near-tie; wrong routing agrees far less
ROUTING_AGREEMENT_MIN = 0.97
SPIN_CYCLES = 1_000_000         # ~0.5 ms at the H100's 1.98 GHz SM clock


def bound(nbytes, flops, flop_rate=BF16_FLOP_PER_S):
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / flop_rate
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


def check_close(name, got, want, tol, rtol=None):
    """``|got - want| <= tol + rtol |want|`` elementwise (``rtol``
    defaults to ``tol``), in float64."""
    rtol = tol if rtol is None else rtol
    err = (got.double() - want.double()).abs()
    lim = tol + rtol * want.double().abs()
    bad = int((err > lim).sum())
    if bad or not bool(got.double().isfinite().all()):
        raise AssertionError(f"{name}: {bad} elements outside tol {tol} "
                             f"rtol {rtol}, max_abs_err {err.max().item()}")
    return err.max().item()


def summary(per_shape, keys=("ms", "plain_ms", "library_ms", "bound_ms")):
    """A kernel line's numbers: sums over the shapes the main path runs
    (``on_path``); the rest are printed and kept per shape."""
    on = [r for r in per_shape if r["on_path"]]
    return {**{k: sum(r[k] for r in on) for k in keys},
            "bound_by": "bytes" if sum(r["bound_by"] == "bytes"
                                       for r in on) * 2 >= len(on)
            else "operations",
            "timed_as": "sum over the on_path entries of per_shape"}


def gemm_entry(torch, timer, x, b, what, on_path):
    """The 2-D GEMM wrapper at one shape: checked against its plain
    version, then the kernel, the plain version, ``torch.matmul`` and
    the bound."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.streaming_gemm import plan as gemm_plan
    M, K = x.shape
    N = b.shape[1]
    err = check_close(f"gemm {M}x{K}x{N}", ops.streaming_gemm(x, b),
                      ref.gemm_ref(x, b), BF16_TOL)
    bms, by = bound(2 * (M * K + K * N + M * N), 2 * M * N * K)
    r = {"shape": [M, K, N], "b": what, "on_path": on_path,
         "plan": list(gemm_plan(M, N, K)), "max_abs_err": err,
         "ms": timer(lambda: ops.streaming_gemm(x, b)),
         "plain_ms": timer(lambda: ref.gemm_ref(x, b)),
         "library_ms": timer(lambda: torch.matmul(x, b)),
         "bound_ms": bms, "bound_by": by}
    print(f"[gemm] M={M} K={K} N={N} ({what}, plan {r['plan']}, "
          f"on_path {on_path}): err {err:.3g} (tol {BF16_TOL}) "
          f"kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms "
          f"matmul {r['library_ms']:.4f} ms bound {bms:.4f} ms ({by})",
          flush=True)
    return r


def flash_entry(torch, timer, q, k, v, on_path, causal=True):
    """Flash attention at one shape, causal or full (then with Tq != Tk
    allowed, called as the model calls it: ``bk = Tk``), as
    ``gemm_entry``; the library call is SDPA."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    B, Tq, H, D = q.shape
    Tk, KH, Dv = k.shape[1], k.shape[2], v.shape[3]

    def kernel():
        return ops.flash_attention(q, k, v, causal=causal, bk=Tk)

    dims = f"D={D}" if Dv == D else f"D={D}/{Dv}"
    err = check_close(f"flash B={B} Tq={Tq} Tk={Tk} H={H}/{KH} {dims} "
                      f"causal {causal}", kernel(),
                      ref.flash_gqa_ref(q, k, v, causal), BF16_TOL)
    pairs = Tq * (Tq + 1) // 2 if causal else Tq * Tk
    bms, by = bound(2 * (B * Tq * H * (D + Dv) + B * Tk * KH * (D + Dv)),
                    2 * B * H * (D + Dv) * pairs)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    r = {"shape": {"q": [B, Tq, H, D], "kv": [B, Tk, KH, D],
                   "causal": causal, **({"v": [B, Tk, KH, Dv]}
                                        if Dv != D else {})},
         "on_path": on_path, "max_abs_err": err,
         "ms": timer(kernel),
         "plain_ms": timer(lambda: ref.flash_gqa_ref(q, k, v, causal)),
         "library_ms": timer(lambda: F.scaled_dot_product_attention(
             qt, kt, vt, is_causal=causal, enable_gqa=True)),
         "bound_ms": bms, "bound_by": by}
    print(f"[flash_attention] B={B} Tq={Tq} Tk={Tk} H={H}/{KH} {dims} "
          f"causal {causal} (on_path {on_path}): err {err:.3g} (tol "
          f"{BF16_TOL}) kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} "
          f"ms sdpa {r['library_ms']:.4f} ms bound {bms:.4f} ms ({by})",
          flush=True)
    return r


def paged_entry(torch, timer, what, q, kp, vp, table, ln, on_path):
    """Paged decode attention at one shape, as ``gemm_entry``, beside
    SDPA over the same K/V gathered into a contiguous cache with a
    length mask (attention without the page indirection; a yardstick the
    port never calls)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.paged_attention import launch_plan
    n, H, D = q.shape
    P, page, KH, _ = kp.shape
    max_pages = table.shape[1]
    groups, splits = launch_plan(n, H, KH, D, max_pages)
    err = check_close(f"paged {what}", ops.paged_attention(q, kp, vp, table,
                                                           ln),
                      ref.paged_ref(q, kp, vp, table, ln), BF16_TOL)
    n_tok = int(ln.sum())
    bms, by = bound(2 * 2 * n * H * D + 4 * n * (max_pages + 1)
                    + 2 * 2 * n_tok * KH * D, 4 * H * D * n_tok)
    kc = kp[table.long()].reshape(n, max_pages * page, KH, D) \
        .transpose(1, 2).contiguous()
    vc = vp[table.long()].reshape(n, max_pages * page, KH, D) \
        .transpose(1, 2).contiguous()
    mask = (torch.arange(max_pages * page, device=q.device)[None]
            < ln[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]

    def sdpa():
        return F.scaled_dot_product_attention(q4, kc, vc, attn_mask=mask,
                                              enable_gqa=True)

    check_close(f"paged {what} contiguous SDPA", sdpa()[:, :, 0],
                ref.paged_ref(q, kp, vp, table, ln), BF16_TOL)
    r = {"shape": {"q": [n, H, D], "pool": [P, page, KH, D],
                   "lens": ln.tolist()}, "what": what, "on_path": on_path,
         "plan": splits,
         "head_groups": groups, "max_abs_err": err,
         "ms": timer(lambda: ops.paged_attention(q, kp, vp, table, ln)),
         "plain_ms": timer(lambda: ref.paged_ref(q, kp, vp, table, ln)),
         "contiguous_sdpa_ms": timer(sdpa), "bound_ms": bms, "bound_by": by}
    print(f"[paged_attention] {what} H={H}/{KH} D={D} (groups {groups}, "
          f"plan S={r['plan']}, on_path {on_path}): err {err:.3g} (tol "
          f"{BF16_TOL}) kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} "
          f"ms contiguous SDPA {r['contiguous_sdpa_ms']:.4f} ms bound "
          f"{bms:.4f} ms ({by})",
          flush=True)
    return r


PAGED_KEYS = ("ms", "plain_ms", "contiguous_sdpa_ms", "bound_ms")


def phase_kernels(torch, args, dev, timer):
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.streaming_gemm import plan as gemm_plan

    g = torch.Generator(device=dev).manual_seed(args.seed)
    bf16 = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(bf16)

    rows = {}
    # ---- streaming GEMM: every projection, the MLP and the tied lm_head;
    # decode runs M = 8, prefill M = 64-512 (256 here) but never the
    # lm_head at M = 256 (only each prompt's last token reaches it).
    # The layer streamer of phase 6c also runs the layer's projections
    # at M = 512 and 4,096 (1 x 512 and 8 x 512 tokens), off the
    # serving path.
    embed = randn(152064, 896, scale=0.02)
    layer_kn = ((896, 896), (896, 128), (896, 4864), (4864, 896))
    per_shape = []
    for M in (8, 256, 512, 4096):
        a = randn(M, 896)
        serving = M in (8, 256)
        for K, N in layer_kn + (((896, 152064),) if serving else ()):
            if K == 896 and N == 152064:
                b, what = embed.t(), "lm_head embed.T"
            else:
                b, what = randn(K, N, scale=K ** -0.5), "weight"
            x = a if K == 896 else randn(M, K)
            per_shape.append(gemm_entry(
                torch, timer, x, b, what,
                serving and not (M == 256 and N == 152064)))
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

    # ---- flash attention: prefill of 64-, 256- and 512-token prompts;
    # off the serving path, the layer streamer's 1 x 8 and 8 x 512
    H, KH, D = 14, 2, 64
    per_shape = []
    for B, T in ((1, 64), (1, 256), (1, 512), (1, 8), (8, 512)):
        q, k, v = randn(B, T, H, D), randn(B, T, KH, D), randn(B, T, KH, D)
        per_shape.append(flash_entry(torch, timer, q, k, v,
                                     B == 1 and T >= 64))
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
        per_shape.append(paged_entry(
            torch, timer, what, q[:n].contiguous(), kp, vp,
            table[:n].contiguous(), ln, int(ln.max()) <= 512 + 32))
    rows["paged_attention"] = {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:34",
        "tol": BF16_TOL,
        "max_abs_err": max(r["max_abs_err"] for r in per_shape),
        **summary(per_shape, PAGED_KEYS),
        "library_ms": None, "per_shape": per_shape}
    return rows


def phase_serving(torch, args, cfg, params, kernels, new_tokens=32,
                  tag="serving", n_requests=16, prompt_max=512,
                  pool_pages=None, absent=()):
    """Serve ``n_requests`` requests of 64-``prompt_max`` prompt tokens
    and ``new_tokens`` new tokens each on 8 slots of 16-token pages
    (``max_seq`` 1,024; a pool of ``pool_pages`` pages, by default room
    for every slot's 1,024; an ssm model's state store instead, a hybrid
    model's beside it), after
    an untimed warm-up request.  The launch counts are zeroed just
    before and read just after; each of ``kernels`` must have run, and
    none of ``absent``."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import Request, ServingEngine

    def engine():
        return ServingEngine(cfg, params, slots=8, max_seq=1024,
                             kv_page_tokens=16, kv_pool_pages=pool_pages,
                             device="cuda")

    rng = np.random.default_rng(args.seed)
    warm = engine()                       # first-call set-up, not timed
    warm.submit(Request(uid=-1, prompt=rng.integers(
        1, cfg.vocab_size - 1, 64).astype(np.int32), max_new_tokens=2))
    warm.run_until_drained()
    del warm

    eng = engine()
    store = {}
    if cfg.family != "ssm":
        pools = [p for p in (eng.cache.k_pages, eng.cache.v_pages)
                 if p is not None]
        store = {"kv_pool_mb": sum(p.numel() for p in pools) * 2 / 1e6,
                 "kv_pool_pages": eng.cache.cfg.n_pages}
    states = eng.cache if cfg.family == "ssm" else eng.cache.state
    if states is not None:
        store["state_mb"] = states.nbytes / 1e6
    reqs = [Request(uid=i, prompt=rng.integers(
        1, cfg.vocab_size - 1, int(rng.integers(64, prompt_max + 1)))
        .astype(np.int32), max_new_tokens=new_tokens)
        for i in range(n_requests)]
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
    require(not eng.cache.active.any(), "slots held after the drain")
    if cfg.family != "ssm":
        require(eng.cache.pages_in_use == 0, "pages leaked after the drain")
    for r in reqs:
        require(len(r.output) == new_tokens and all(
            0 <= t < cfg.vocab_size for t in r.output), (r.uid, r.output))
    missing = [k for k in kernels if launches[k] <= 0]
    require(not missing, f"main path never launched {missing}")
    stray = [k for k in absent if launches[k]]
    require(not stray, f"main path launched {stray}, which it must not")
    ttft = sorted(r.first_token_s - r.submitted_s for r in reqs)
    tokens = sum(len(r.output) for r in reqs)
    res = {"model": cfg.name, "requests": len(reqs), "tokens_out": tokens,
           "wall_s": wall, "tokens_per_s": tokens / wall,
           "ttft_p50_ms": float(np.percentile(ttft, 50)) * 1e3,
           "ttft_p95_ms": float(np.percentile(ttft, 95)) * 1e3,
           "decode_step_median_ms": statistics.median(decode_ms),
           "decode_steps": eng.stats.decode_steps,
           "decode_only_steps": len(decode_ms),
           "prefills": eng.stats.prefills, "launches": launches, **store,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "validate": "ok"}
    print(f"[{tag}] " + json.dumps(res), flush=True)
    return res


def phase_card_vs_cpu(torch, args, cfg, params, n_layers=None,
                      tag="card_vs_cpu"):
    """One request, a 64-token prefill and 4 decode steps, on the card and
    on the CPU (every wrapper's plain version), logits within E2E_TOL x
    max(1, max|logit|); with ``n_layers``, only the first ``n_layers``
    layers (full width).  For a config that takes embeddings, also a
    prefill from 256 seeded bf16 embeddings, held the same way; for an
    ssm or hybrid model, each layer's final scan state, held the same
    way."""
    import dataclasses

    import numpy as np
    from repro_torch.models.model import Model
    from repro_torch.models.params import params_to

    if n_layers:
        # the first n_layers of the dense_layers stack (if any), then
        # of layers
        nd = len(params.get("dense_layers", []))
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
        params = {**params, "layers": params["layers"][:max(
            0, n_layers - nd)]}
        if nd:
            params["dense_layers"] = params["dense_layers"][:n_layers]
    rng = np.random.default_rng(args.seed + 1)
    prompt = torch.as_tensor(rng.integers(1, cfg.vocab_size - 1, 64))
    forced = rng.integers(1, cfg.vocab_size - 1, 4)
    emb = torch.from_numpy(rng.standard_normal(
        (1, 256, cfg.d_model), np.float32) * 0.02).to(torch.bfloat16) \
        if cfg.embedding_inputs else None

    def run(device, p):
        m = Model(cfg, device=device)
        cache = m.init_cache(2, 256, page_tokens=16)
        cache.alloc_seq(0, 64)
        out = [m.prefill(p, prompt[None].to(m.device), cache, [0])]
        for t in forced:
            out.append(m.decode_step(p, cache, torch.tensor(
                [int(t)], device=m.device), [0]))
        if emb is not None:
            cache.alloc_seq(1, emb.shape[1])
            out.append(m.prefill(p, None, cache, [1],
                                 embeddings=emb.to(m.device)))
        states = cache if cfg.family == "ssm" else cache.state
        state = states.s[:, 0].cpu() if states is not None else None
        return torch.cat(out).float().cpu(), state

    t0 = time.perf_counter()
    card, card_s = run("cuda", params)
    cpu, cpu_s = run("cpu", params_to(params, "cpu"))
    rows = 5 + (emb is not None)
    require(card.shape == (rows, cfg.padded_vocab) and
            bool(card.isfinite().all()), "card logits malformed")
    res = {"layers": cfg.n_layers}
    # the token request's 5 rows, then the embedding prefill's row
    for what, sl in (("tokens", slice(0, 5)), ("embeddings", slice(5, 6))):
        if sl.start >= rows:
            continue
        err = (card[sl] - cpu[sl]).abs().max().item()
        top = cpu[sl].abs().max().item()
        res[what] = {"max_abs_err": err, "max_abs_logit": top,
                     "tol": E2E_TOL * max(1.0, top), "argmax_agree": int(
                         (card[sl].argmax(-1) == cpu[sl].argmax(-1)).sum())}
    for layer in range(cfg.n_layers if cpu_s is not None else 0):
        top = cpu_s[layer].abs().max().item()
        res[f"scan_state_{layer}"] = {
            "max_abs_err": (card_s[layer] - cpu_s[layer]).abs().max().item(),
            "max_abs": top, "tol": E2E_TOL * max(1.0, top)}
    res["seconds"] = time.perf_counter() - t0
    print(f"[{tag}] " + json.dumps(res), flush=True)
    for what, r in res.items():
        if isinstance(r, dict):
            require(r["max_abs_err"] <= r["tol"],
                    f"{tag} {what}: card and CPU differ by "
                    f"{r['max_abs_err']}")
    return res


def _kernel_group(name):
    for key, group in (("grouped_wgmma", "streaming_gemm_grouped"),
                       ("gemm_bf16", "streaming_gemm"),
                       ("gemm_simt", "streaming_gemm"),
                       ("flash_bf16", "flash_attention"),
                       ("flash_f32", "flash_attention"),
                       ("paged_fwd", "paged_attention"),
                       ("paged_latent", "paged_latent_attention")):
        if key in name:
            return group
    return "other (torch ops)"


def phase_profile(torch, args, cfg, params, n_steps=5, tag="decode_profile",
                  one_kernel=("streaming_gemm", "paged_attention"),
                  tries=3, pool_pages=None, prompt_len=256):
    """Where a full-batch decode step's time goes: ``profile_steps`` over
    the engine's decode steps of 8 slots (prompts of ``prompt_len``
    tokens)."""
    import numpy as np
    from repro_torch.serving.engine import Request, ServingEngine

    rng = np.random.default_rng(args.seed + 2)
    eng = ServingEngine(cfg, params, slots=8, max_seq=1024,
                        kv_page_tokens=16, kv_pool_pages=pool_pages,
                        device="cuda")
    for i in range(8):
        eng.submit(Request(uid=i, prompt=rng.integers(
            1, cfg.vocab_size - 1, prompt_len).astype(np.int32),
            max_new_tokens=(2 + tries) * n_steps + 2))
    eng.step()                          # admits all 8, one decode step
    return profile_steps(torch, eng.step, cfg.name, prompt_len, n_steps,
                         tag, one_kernel, tries)


def profile_steps(torch, step, model, context, n_steps, tag, one_kernel,
                  tries=3):
    """``torch.profiler`` device time by kernel over ``n_steps`` calls of
    ``step`` (one decode step of 8 slots whose context starts at
    ``context`` tokens), beside the same number of unprofiled steps'
    wall time before it.  The profiler only reads the device's kernel
    times here; the wall time comes from the unprofiled steps.  Each
    wrapper of ``one_kernel`` must make exactly one device kernel per
    call.  The profiler now and then drops a window or part of one: a
    window with no device kernel, or with fewer kernels of such a
    wrapper than its calls, is profiled again, up to ``tries`` windows;
    then the check fails on what the last window read."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for window in range(1, tries + 1):
        if window > 1:
            time.sleep(0.5)       # as the card tests' profiler helper does
        ops.reset_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n_steps):
                step()
            torch.cuda.synchronize()
        per_step = {k: n / n_steps for k, n in ops.LAUNCHES.items()}
        groups: dict = {}
        kernels: dict = {}
        odd = []      # kernels whose count is not a whole number a step
        for ev in prof.key_averages():
            if ev.device_type != DeviceType.CUDA:  # host ops double-count
                continue
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = getattr(ev, "self_cuda_time_total", 0)
            if us > 0:
                g = _kernel_group(ev.key)
                groups[g] = groups.get(g, 0.0) + us / 1e3 / n_steps
                kernels[g] = kernels.get(g, 0) + ev.count / n_steps
            if ev.count % n_steps:
                odd.append(f"{ev.key[:120]!r} x{ev.count} {us:.1f} us")
        short = [n for n in one_kernel if kernels.get(n, 0) < per_step[n]]
        if groups and not short:
            break
        print(f"[{tag}] window {window}: the profiler lost device kernels "
              f"({short or 'all'}); kernels of an odd count: {odd}",
              flush=True)
    require(groups, f"{tag}: {tries} profiler windows held no device kernel")
    busy = sum(groups.values())
    res = {"model": model, "slots": 8,
           "context": f"{context}-{context + (1 + window) * n_steps}",
           "steps": n_steps, "windows": window,
           "wall_ms_per_step": wall_ms, "device_ms_per_step": groups,
           "device_busy_share": busy / wall_ms,
           "launches_per_step": per_step,
           "device_kernels_per_step": kernels,
           "device_kernels_total_per_step": sum(kernels.values()),
           "peak_mem_gb": peak_gb}
    print(f"[{tag}] " + json.dumps(res), flush=True)
    # one device kernel per wrapper call: no hidden second pass
    for name in one_kernel:
        if kernels.get(name) != per_step[name]:
            raise AssertionError(f"{name}: {kernels.get(name)} device "
                                 f"kernels per step for {per_step[name]} "
                                 f"wrapper calls")
    return res


def _median_ms(seconds):
    return statistics.median(seconds) * 1e3


def _streaming_gemm(torch, args, dev):
    """(a) Algorithm 1 on the card: ``gemm_streamed`` on fp16 A, B of
    1024 x 1024 x 1024 in DevMem, DM and DC, against an fp32-accumulated
    product of the same inputs, with the traffic a CPU store meters for
    the same plan."""
    from repro_torch.core import plan as P
    from repro_torch.core import streaming as S
    from repro_torch.core.modes import MemoryMode, PageStore

    n = 1024
    g = torch.Generator(device=dev).manual_seed(args.seed + 10)
    a = torch.randn((n, n), generator=g, device=dev).half()
    b = torch.randn((n, n), generator=g, device=dev).half()
    want = (a.float() @ b.float()).double().cpu()
    plan = P.gemm_plan(n, n, n, torch.float16)
    counts = S.tile_counts(n, n, n, torch.float16)
    loads = counts["a_page_loads"] + counts["b_page_loads"]
    keys = [ev.page for ev in plan.events if ev.kind is P.EventKind.DMA_IN]
    page = torch.zeros((16, 128), dtype=torch.float16)
    res = {"shape": [n, n, n], "dtype": "float16", "events":
           len(plan.events), "dma_in": len(keys), "tol": 1e-2}
    modes = (MemoryMode.DEVMEM, MemoryMode.DM, MemoryMode.DC)
    walls = {m: [] for m in modes}
    for mode in modes + modes[::-1]:      # in turns: drift falls on all
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, store = S.gemm_streamed(a, b, mode, device=dev)
        walls[mode].append(time.perf_counter() - t0)
        err = check_close(f"gemm_streamed {mode.value}", out, want, 1e-2)
        # the same plan metered by a store on the CPU
        cpu = PageStore({k: page for k in set(keys)}, mode, device="cpu")
        for k in keys:
            cpu.get(k)
        require(vars(store.stats) == vars(cpu.stats),
                f"{mode.value}: card {store.stats} != CPU {cpu.stats}")
        require(store.stats.lookups == loads, (mode, store.stats, loads))
        wall = statistics.mean(walls[mode])
        h2d = store.stats.host_to_device_bytes
        res[mode.value] = {
            "wall_ms": wall * 1e3, "runs_ms": [w * 1e3 for w in walls[mode]],
            "max_abs_err": err, "lookups": store.stats.lookups,
            "pages_fetched_per_s": store.stats.lookups / wall,
            "h2d_bytes": h2d, "h2d_pages_per_s": h2d / 4096 / wall,
            "h2d_gb_per_s": h2d / wall / 1e9,
            "cache_hits": store.stats.cache_hits}
    require(res["DevMem"]["h2d_bytes"] == 0, "DevMem streamed bytes")
    require(res["DM"]["h2d_bytes"] == loads * 4096, "DM bytes")
    require(res["DM"]["h2d_bytes"] >= res["DC"]["h2d_bytes"], "DM < DC")
    return res


def _streaming_decode_plan(torch, args, cfg, params, dev):
    """(b) The decode-step plan of 8 freshly prefilled slots, executed
    in DM over layer 0 of the live full-width pool, against the paged
    kernel on the same q, pool, table and lens."""
    import numpy as np
    from repro_torch.core import streaming as S
    from repro_torch.core.modes import MemoryMode
    from repro_torch.kernels import ops, ref
    from repro_torch.models.model import Model

    rng = np.random.default_rng(args.seed + 11)
    model = Model(cfg, device=dev)
    cache = model.init_cache(8, 1024, page_tokens=16)
    slots = list(range(8))
    lens = [int(t) for t in rng.integers(64, 513, 8)]
    for slot, n in enumerate(lens):
        cache.alloc_seq(slot, n)
        model.prefill(params, torch.as_tensor(
            rng.integers(1, cfg.vocab_size - 1, n), device=dev)[None],
            cache, [slot])
    plan = cache.decode_step_plan(slots, n_q_heads=cfg.n_heads)
    kd, vd = cache.page_dicts(slots, 0)
    H, hd = cfg.n_heads, cfg.resolved_head_dim
    g = torch.Generator(device=dev).manual_seed(args.seed + 12)
    q = torch.randn((8, H * hd), generator=g, device=dev).to(torch.bfloat16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs, store = S.execute_plan(plan, {"q": q}, MemoryMode.DM,
                                 paged={"k": kd, "v": vd}, device=dev)
    wall = time.perf_counter() - t0
    got = outs["decode_out"].view(8, H, hd)
    table = torch.from_numpy(cache.tables[slots])
    lens_t = torch.from_numpy(cache.lens[slots].copy())
    # the plan pages its operands as fp16 (every 2-byte plan is fp16);
    # the plain version on those inputs, in fp32, as the CPU tests hold
    # it (rtol 1e-4, atol 1e-5): a wrong or missing page cannot pass
    oracle = ref.paged_ref(*(t.cpu().half().double() for t in (
        q.view(8, H, hd), cache.k_pages[0], cache.v_pages[0])),
        table, lens_t)
    err_plain = check_close("decode plan vs plain fp32", got, oracle,
                            1e-5, rtol=1e-4)
    # the hand kernel takes the bf16 values and rounds its output to
    # bf16: at most half an ulp, 2^-8 |x| = 3.9e-3 |x|
    want = ops.paged_attention(q.view(8, H, hd), cache.k_pages[0],
                               cache.v_pages[0], table.to(dev),
                               lens_t.to(dev)).cpu()
    max_want = want.float().abs().max().item()
    err = check_close("decode plan vs paged kernel", got, want,
                      5e-3 * max_want, rtol=0.0)
    held = int(cache.held[slots].sum())
    require(store.stats.lookups == 2 * held,
            f"decode plan lookups {store.stats.lookups} != 2 x {held}")
    return {"lens": lens, "pages_held": held, "events": len(plan.events),
            "lookups": store.stats.lookups,
            "h2d_bytes": store.stats.host_to_device_bytes,
            "wall_ms": wall * 1e3, "max_abs_out": max_want,
            "max_abs_err_vs_plain_fp32": err_plain,
            "tol_vs_plain_fp32": {"rtol": 1e-4, "atol": 1e-5},
            "max_abs_err": err, "tol": 5e-3 * max_want}


def _device_overlap(torch, prof):
    """Kernel and host-to-device copy time of a profiled window, on the
    device: busy ms of each, the copy time that ran under a kernel, and
    the window's span."""
    from torch.autograd import DeviceType

    ker, mem = [], []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        iv = (e.time_range.start, e.time_range.end)
        (mem if "memcpy" in e.name.lower() else ker).append(iv)
    if not ker:
        return "not measured"

    def merged(ivs):
        out = []
        for a, b in sorted(ivs):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    k, m = merged(ker), merged(mem)
    under, i = 0.0, 0
    for a, b in m:
        while i < len(k) and k[i][1] <= a:
            i += 1
        j = i
        while j < len(k) and k[j][0] < b:
            under += min(b, k[j][1]) - max(a, k[j][0])
            j += 1
    span = max(iv[1] for iv in ker + mem) - min(iv[0] for iv in ker + mem)
    ms = lambda ivs: sum(b - a for a, b in ivs) / 1e3  # noqa: E731
    return {"kernel_ms": ms(k), "h2d_copy_ms": ms(m),
            "copy_under_kernels_ms": under / 1e3, "span_ms": span / 1e3,
            "kernel_busy_share": ms(k) / (span / 1e3)}


def _streaming_layers(torch, args, cfg, params, dev, passes=3):
    """(c) All 24 decoder layers behind a ``LayerStreamer`` in DevMem, DM
    and DC (8 cached layers), at 8, 512 and 4,096 tokens per pass, beside
    a bare copy of the 24 layers from pinned memory.  The three modes'
    passes take turns (DevMem, DM, DC, then the reverse), so that drift
    in the host's speed falls on all three alike; then one DM pass is
    profiled for the device's view of copy and compute."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.modes import MemoryMode
    from repro_torch.core.offload import LayerStreamer, stack_layers
    from repro_torch.models import transformer as T
    from repro_torch.models.params import tree_map

    L = cfg.n_layers
    stacked = stack_layers(params["layers"])
    leaves = []
    tree_map(leaves.append, stacked)
    pinned = [a.cpu().pin_memory() for a in leaves]
    layer_bytes = sum(a.numel() * a.element_size() // L for a in leaves)

    def copy_all():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for a in pinned:
            a.to(dev, non_blocking=True)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    copy_all()
    copy_ms = _median_ms([copy_all() for _ in range(passes)])
    del pinned
    res = {"layers": L, "layer_bytes": layer_bytes,
           "model_bytes": L * layer_bytes, "dc_cache_layers": 8,
           "pinned_copy_ms": copy_ms,
           "pinned_h2d_gb_per_s": L * layer_bytes / copy_ms / 1e6,
           "sizes": {}}
    g = torch.Generator(device=dev).manual_seed(args.seed + 13)
    modes = ((MemoryMode.DEVMEM, 0), (MemoryMode.DM, 0), (MemoryMode.DC, 8))
    for B, Tn in ((1, 8), (1, 512), (8, 512)):
        x0 = torch.randn((B, Tn, cfg.d_model), generator=g,
                         device=dev).to(torch.bfloat16)
        pos = torch.arange(Tn, device=dev)[None].expand(B, Tn)

        def fn(lp, x):
            return T.dense_layer_fwd(lp, x, cfg, pos)[0]

        LayerStreamer(stacked, L, MemoryMode.DEVMEM, device=dev).run(fn, x0)
        streamers = {m: LayerStreamer(stacked, L, m, cache_layers=c,
                                      device=dev) for m, c in modes}
        walls = {m: [] for m in streamers}
        sent = {m: [] for m in streamers}
        outs = {}
        for r in range(passes):
            for m in (list(streamers) if r % 2 == 0
                      else list(streamers)[::-1]):
                before = streamers[m].stats.host_to_device_bytes
                y, rep = streamers[m].run(fn, x0)
                walls[m].append(rep.wall_s)
                sent[m].append(rep.bytes_streamed - before)
                outs.setdefault(m, y)
                require(torch.equal(y, outs[m]), f"{m.value} repeat")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            streamers[MemoryMode.DM].run(fn, x0)
        del streamers
        row = {m.value: {"pass_ms": [w * 1e3 for w in walls[m]],
                         "median_ms": _median_ms(walls[m]),
                         "bytes_per_pass": sent[m]} for m in walls}
        for m in (MemoryMode.DM, MemoryMode.DC):
            require(torch.equal(outs[m], outs[MemoryMode.DEVMEM]),
                    f"{m.value} output differs from DevMem at {B}x{Tn}")
        require(bool(outs[MemoryMode.DEVMEM].float().isfinite().all()),
                "streamed layers gave non-finite values")
        require(row["DevMem"]["bytes_per_pass"] == [0] * passes, "DevMem")
        require(row["DM"]["bytes_per_pass"] == [L * layer_bytes] * passes,
                f"DM bytes {row['DM']['bytes_per_pass']}")
        require(row["DC"]["bytes_per_pass"] == [L * layer_bytes] + [
            (L - min(8, L)) * layer_bytes] * (passes - 1),
            f"DC bytes {row['DC']['bytes_per_pass']}")
        dev_ms, dm_ms = row["DevMem"]["median_ms"], row["DM"]["median_ms"]
        row["dm_gb_per_s"] = L * layer_bytes / dm_ms / 1e6
        row["devmem_over_dm"] = dev_ms / dm_ms
        row["overlap_share"] = (copy_ms + dev_ms - dm_ms) / min(copy_ms,
                                                                dev_ms)
        row["dm_profiled_pass"] = _device_overlap(torch, prof)
        res["sizes"][f"{B}x{Tn}"] = row
    return res


def phase_streaming(torch, args, cfg, params):
    """The page-streaming layer on the card: (a) Algorithm 1 through the
    page store, (b) the decode-step plan over a live pool against the
    paged kernel, (c) layer-ahead weight streaming from pinned memory
    against resident weights.  Launch counts are zeroed before and read
    after; the phase must reach all three kernels."""
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    ops.reset_launches()
    res = {"gemm_streamed": _streaming_gemm(torch, args, dev),
           "decode_plan": _streaming_decode_plan(torch, args, cfg, params,
                                                 dev),
           "layer_streamer": _streaming_layers(torch, args, cfg, params,
                                               dev)}
    res["launches"] = dict(ops.LAUNCHES)
    res["seconds"] = time.perf_counter() - t0
    print(json.dumps({"streaming": res}), flush=True)
    missing = [k for k in DENSE_KERNELS if res["launches"][k] <= 0]
    require(not missing, f"streaming phase never launched {missing}")
    return res


def _grouped_entry(torch, timer, what, a, b, counts, on_path):
    """The expert-grouped GEMM at one shape: rows below each expert's
    count against the plain version; the kernel, the plain version and
    ``torch.bmm`` over the whole (E, C, K) buffer (a yardstick the port
    never calls); the bound counts only the experts and rows this
    routing touches."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.grouped_gemm import plan_grouped
    E, C, K = a.shape
    N = b.shape[2]
    got = ops.grouped_streaming_gemm(a, b, counts)
    rows = torch.arange(C, device=a.device)[None, :] < counts[:, None]
    err = check_close(f"grouped {what}", got[rows],
                      ref.grouped_gemm_ref(a, b, counts)[rows], BF16_TOL)
    kept = int(counts.sum())
    touched = int((counts > 0).sum())
    bms, by = bound(2 * (touched * K * N + kept * (K + N)),
                    2 * kept * K * N)
    r = {"what": what, "shape": {"a": [E, C, K], "b": [E, K, N]},
         "rows": kept, "experts_touched": touched, "on_path": on_path,
         "plan": list(plan_grouped(E, C, N, K)), "max_abs_err": err,
         "ms": timer(lambda: ops.grouped_streaming_gemm(a, b, counts)),
         "plain_ms": timer(lambda: ref.grouped_gemm_ref(a, b, counts)),
         "library_ms": timer(lambda: torch.bmm(a, b)),
         "bound_ms": bms, "bound_by": by}
    print(f"[grouped_gemm] {what} E={E} C={C} K={K} N={N} rows {kept} "
          f"experts {touched} (plan {r['plan']}): err {err:.3g} (tol "
          f"{BF16_TOL}) kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} "
          f"ms bmm {r['library_ms']:.4f} ms bound {bms:.4f} ms ({by})",
          flush=True)
    return r


def _moe_kernels(torch, args, cfg, params, dev, timer, rows):
    """(a) Every kernel at the shapes the MoE path gives it.  The grouped
    GEMM at decode (C = 8, counts from routing 8 tokens through layer
    0's router) and at a 512-token prefill (C = 512), for gate/up
    (2,048 -> 1,408) and down (1,408 -> 2,048) over the model's own
    expert weights, and ragged cases (counts 0, C and mid-tile; N and K
    off the tiles) checked without timing.  Then the 2-D GEMM, flash
    and paged attention at the MoE path's shapes, as entries of their
    rows' ``moe_path``."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models import moe as MOE

    g = torch.Generator(device=dev).manual_seed(args.seed + 20)
    bf16 = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(bf16)

    E, d, f = cfg.moe.n_routed_experts, cfg.d_model, cfg.moe.d_ff_expert
    lp = params["layers"][0]

    def buffer(counts, C, K):
        a = randn(E, C, K)
        a[torch.arange(C, device=dev)[None, :] >= counts[:, None]] = 0
        return a

    per_shape = []
    for what, n in (("decode", 8), ("prefill", 512)):
        _, top_e, _ = MOE._route(lp["moe"], randn(n, d), cfg)
        counts = torch.bincount(top_e.reshape(-1), minlength=E) \
            .to(torch.int32)
        C = MOE.routed_capacity(n * cfg.moe.top_k, E, n)
        for prod, K, w in (("gate/up", d, lp["moe"]["wi_gate"]),
                           ("down", f, lp["moe"]["wo"])):
            per_shape.append(_grouped_entry(
                torch, timer, f"{what} {prod}", buffer(counts, C, K), w,
                counts, True))
    ragged = []
    for E_, C, N, K in ((7, 40, 200, 136), (5, 300, 136, 264)):
        b = randn(E_, K, N, scale=K ** -0.5)
        for counts in ([0, C, 1, C - 3, 17, 2, 39][:E_], [0] * E_, [C] * E_):
            cnt = torch.tensor(counts, dtype=torch.int32, device=dev)
            a = randn(E_, C, K)
            a[torch.arange(C, device=dev)[None, :] >= cnt[:, None]] = 0
            got = ops.grouped_streaming_gemm(a, b, cnt)
            keep = torch.arange(C, device=dev)[None, :] < cnt[:, None]
            err = check_close(f"grouped ragged {E_}x{C}x{K}x{N} {counts}",
                              got[keep], ref.grouped_gemm_ref(a, b)[keep],
                              BF16_TOL) if any(counts) else 0.0
            ragged.append({"shape": [E_, C, K, N], "counts": counts,
                           "max_abs_err": err})
            print(f"[grouped_gemm] ragged E={E_} C={C} K={K} N={N} counts "
                  f"{counts}: err {err:.3g} (tol {BF16_TOL})", flush=True)
    torch.cuda.synchronize()
    rows["streaming_gemm_grouped"] = {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/grouped_gemm.cu",
        "replaces": "src/repro/kernels/streaming_gemm.py:30",
        "note": "the streaming GEMM per expert (a persistent TMA + wgmma "
                "walk over the touched experts); the reference computes "
                "these products as an XLA einsum (src/repro/models/"
                "moe.py:115-118)",
        "tol": BF16_TOL,
        "max_abs_err": max(r["max_abs_err"] for r in per_shape + ragged),
        **summary(per_shape), "per_shape": per_shape, "ragged": ragged}

    # ---- the 2-D GEMM: q/k/v/o (2,048 x 2,048), the router (2,048 x 60,
    # the scalar kernel: N % 8 != 0), the shared experts (2,048 x 5,632,
    # 5,632 x 2,048) at decode and prefill, the untied lm_head at decode
    attn, moe = lp["attn"], lp["moe"]
    per_shape = []
    for M in (8, 256):
        a = randn(M, d)
        for K, w, what in ((d, attn["wq"].reshape(d, -1), "wq"),
                           (d, moe["router"], "router"),
                           (d, moe["shared_wi_gate"], "shared_wi_gate"),
                           (moe["shared_wo"].shape[0], moe["shared_wo"],
                            "shared_wo")):
            per_shape.append(gemm_entry(
                torch, timer, a if K == d else randn(M, K), w, what, True))
    per_shape.append(gemm_entry(torch, timer, randn(8, d),
                                params["lm_head"], "lm_head", True))
    _add_path(rows["streaming_gemm"], per_shape, "moe_path")

    # ---- flash at head dim 128, 16 query heads over 16 KV heads (G = 1)
    H, KH, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    per_shape = [flash_entry(torch, timer, randn(1, T, H, D),
                             randn(1, T, KH, D), randn(1, T, KH, D), True)
                 for T in (64, 256, 512)]
    _add_path(rows["flash_attention"], per_shape, "moe_path")

    # ---- paged decode attention: 8 x (16, 128) queries over 16 KV heads
    B, page, max_pages = 8, 16, 64
    P = B * max_pages + 16
    table = torch.randperm(P, generator=g, device=dev)[:B * max_pages] \
        .reshape(B, max_pages).to(torch.int32)
    q = randn(B, H, D)
    kp, vp = randn(P, page, KH, D), randn(P, page, KH, D)
    mixed = torch.randint(64, 529, (B,), generator=g, device=dev) \
        .to(torch.int32)
    fixed = torch.full((B,), 272, dtype=torch.int32, device=dev)
    per_shape = [paged_entry(torch, timer, what, q, kp, vp, table, ln, True)
                 for what, ln in (("mixed 64-528", mixed), ("8 x 272", fixed))]
    _add_path(rows["paged_attention"], per_shape, "moe_path", PAGED_KEYS)


def _add_path(row, per_shape, key, keys=("ms", "plain_ms", "library_ms",
                                         "bound_ms")):
    """Keep one path's entries of a kernel as ``row[key]``, summed as the
    ``kernels`` line sums them."""
    row[key] = {**summary(per_shape, keys), "per_shape": per_shape}
    row["max_abs_err"] = max(row["max_abs_err"],
                             *(r["max_abs_err"] for r in per_shape))


def _record_routes(moe_module, log, inputs=None):
    """Wrap ``moe_module.apply_moe`` so that every call appends its
    tokens' sorted expert sets (n, k) to ``log`` (and, given ``inputs``,
    the router's input (n, d) to it); returns the original."""
    orig = moe_module.apply_moe

    def wrapped(p, x, cfg, *a, **kw):
        xt = x.reshape(-1, x.shape[-1])
        _, top_e, _ = moe_module._route(p, xt, cfg)
        log.append(top_e.sort(-1).values.cpu())
        if inputs is not None:
            inputs.append(xt.detach().cpu())
        return orig(p, x, cfg, *a, **kw)

    moe_module.apply_moe = wrapped
    return orig


def _first_flips(card, cpu):
    """{experts changed: tokens} over the tokens whose expert sets
    differ, for lists of (n, k) sorted sets."""
    flips = {}
    for a, b in zip(card, cpu):
        for i in (a != b).any(-1).nonzero().flatten().tolist():
            k = len(set(a[i].tolist()) ^ set(b[i].tolist())) // 2
            flips[k] = flips.get(k, 0) + 1
    return flips


def _moe_card_vs_cpu(torch, args, cfg, params, n_layers=2):
    """(d) Two full-width layers of the MoE model, a 256-token prefill
    and 4 decode steps, on the card and on the CPU (every wrapper's plain
    version).  Routing is compared on the same router input: each MoE
    call's input on the card is routed again on the CPU with the CPU's
    weights, so every flip counted is a token's first (none is caused by
    an earlier layer's); the share of (layer, token) expert sets that
    agree must reach ``ROUTING_AGREEMENT_MIN``.  The chained rate of the
    whole CPU run (each side routing its own hidden states) is printed
    beside it, and the logits at the positions whose chained routing
    agrees in every layer must be within E2E_TOL·max(1, max|logit|)."""
    import dataclasses

    import numpy as np
    from repro_torch.models import moe as MOE
    from repro_torch.models.model import Model
    from repro_torch.models.params import params_to

    cfg2 = dataclasses.replace(cfg, n_layers=n_layers)
    p2 = {**params, "layers": params["layers"][:n_layers]}
    n_prompt, n_decode = 256, 4
    rng = np.random.default_rng(args.seed + 3)
    prompt = torch.as_tensor(rng.integers(1, cfg.vocab_size - 1, n_prompt))
    forced = rng.integers(1, cfg.vocab_size - 1, n_decode)
    n_pos = 1 + n_decode

    def run(device, p, inputs=None):
        log = []
        orig = _record_routes(MOE, log, inputs)
        try:
            m = Model(cfg2, device=device)
            cache = m.init_cache(1, n_prompt + 16, page_tokens=16)
            cache.alloc_seq(0, n_prompt)
            out = [m.prefill(p, prompt[None].to(m.device), cache, [0])]
            for t in forced:
                out.append(m.decode_step(p, cache, torch.tensor(
                    [int(t)], device=m.device), [0]))
        finally:
            MOE.apply_moe = orig
        return torch.cat(out).float().cpu(), log

    t0 = time.perf_counter()
    card_inputs = []
    card, card_routes = run("cuda", p2, card_inputs)
    p_cpu = params_to(p2, "cpu")
    cpu, cpu_routes = run("cpu", p_cpu)
    require(card.shape == (n_pos, cfg.padded_vocab) and
            bool(card.isfinite().all()), "card logits malformed")
    require(len(card_routes) == len(cpu_routes) == n_pos * n_layers,
            "routing records")
    # the same router input: call i is layer i % n_layers
    same_input = [MOE._route(p_cpu["layers"][i % n_layers]["moe"], x,
                             cfg)[1].sort(-1).values
                  for i, x in enumerate(card_inputs)]
    same = [(a == b).all(-1) for a, b in zip(card_routes, same_input)]
    share = float(torch.cat(same).float().mean())
    chained = [(a == b).all(-1) for a, b in zip(card_routes, cpu_routes)]
    chained_share = float(torch.cat(chained).float().mean())
    # the position each output row reads: the prompt's last token, then
    # each decode token; it agrees if it does in every layer
    agree = [bool(all(s[-1] for s in
                      chained[i * n_layers:(i + 1) * n_layers]))
             for i in range(n_pos)]
    idx = [i for i, ok in enumerate(agree) if ok]
    scale = max(1.0, cpu.abs().max().item())
    err = (card[idx] - cpu[idx]).abs().max().item() if idx else None
    res = {"layers": n_layers, "prompt": n_prompt, "decode_steps": n_decode,
           "routing_agreement": share,
           "routing_agreement_min": ROUTING_AGREEMENT_MIN,
           "assignments": int(sum(s.numel() for s in same)),
           "first_flips_by_experts_changed": _first_flips(card_routes,
                                                          same_input),
           "chained_routing_agreement": chained_share,
           "positions_compared": len(idx), "positions": n_pos,
           "max_abs_err": err, "max_abs_logit": cpu.abs().max().item(),
           "tol": E2E_TOL * scale,
           "argmax_agree": int((card.argmax(-1) == cpu.argmax(-1)).sum()),
           "seconds": time.perf_counter() - t0}
    print("[moe_card_vs_cpu] " + json.dumps(res), flush=True)
    require(share >= ROUTING_AGREEMENT_MIN,
            f"card and CPU routing of the same inputs agree on {share:.3f} "
            "of the tokens")
    require(idx, "no position routed alike on the card and the CPU")
    require(err <= E2E_TOL * scale,
            f"MoE card vs CPU logits differ by {err}")
    return res


def phase_moe(torch, args, rows):
    """7. The MoE path: full-width qwen2-moe-a2.7b with random weights
    from ``--seed`` (24 layers, 60 routed experts of d_ff 1,408, top-4,
    4 shared; 28.6 GB in bf16).  (a) every kernel at the MoE path's
    shapes, (b) serving through ``ServingEngine`` (launch counts zeroed
    before; all four wrappers must run), (c) a profile of 3 full-batch
    decode steps (each grouped wrapper call one device kernel), (d) two
    layers on the card against the CPU, routing-aware."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model

    dev = torch.device("cuda")
    cfg = get_config(MOE_ARCH)
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(args.seed)
    params = Model(cfg, device=dev).init(g)
    torch.cuda.synchronize()
    res = {"init_s": time.perf_counter() - t0,
           "weights_gb": torch.cuda.memory_allocated() / 1e9}
    print(f"[moe] {cfg.name}: {res['weights_gb']:.2f} GB of weights on "
          f"the card in {res['init_s']:.1f} s", flush=True)
    timer = Timer(torch, dev)
    _moe_kernels(torch, args, cfg, params, dev, timer, rows)
    del timer
    res["serving"] = phase_serving(torch, args, cfg, params,
                                   MOE_PATH_KERNELS, new_tokens=16,
                                   tag="moe_serving")
    res["decode_profile"] = phase_profile(
        torch, args, cfg, params, n_steps=3, tag="moe_decode_profile",
        one_kernel=MOE_PATH_KERNELS[:2] + ("paged_attention",))
    res["card_vs_cpu"] = _moe_card_vs_cpu(torch, args, cfg, params)
    res["seconds"] = time.perf_counter() - t0
    return res


# ------------------------------------------------ 8. the dense variants
DENSE_ARCHS = ("internvl2-2b", "chatglm3-6b", "granite-20b", "qwen1.5-32b")
# room the KV pool leaves on the card beside the weights: prefill
# activations (a 256-token prompt's MLP at d_ff 27,392 is 42 MB), the
# lm_head's logits, the engines' small tensors and the caching
# allocator's rounding and holes
POOL_MARGIN_BYTES = 2 * 2**30


def kv_pool_pages(torch, cfg, slots=8, max_seq=1024, page_tokens=16):
    """The serving phases' KV pool in pages: what the card's free memory
    holds after the weights (``mem_get_info`` and the allocator's cached
    free bytes) less ``POOL_MARGIN_BYTES``, at most every slot's
    ``max_seq`` tokens.  Every dense variant but qwen1.5-32b (70.4 GB of
    weights) gets that cap."""
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info()
    free += torch.cuda.memory_reserved() - torch.cuda.memory_allocated()
    from repro_torch.models.transformer import kv_geometry, kv_layers
    heads, hd = kv_geometry(cfg)
    pools = 1 if cfg.mla else 2         # MLA: one latent pool, no V pool
    page_bytes = pools * kv_layers(cfg) * page_tokens * heads * hd * 2
    cap = slots * -(-max_seq // page_tokens)
    pages = min(cap, (free - POOL_MARGIN_BYTES) // page_bytes)
    print(f"[{cfg.name}] KV pool: {pages} pages of {page_tokens} tokens "
          f"({pages * page_tokens} tokens, {pages * page_bytes / 1e9:.2f} "
          f"GB) from {free / 1e9:.2f} GB free less "
          f"{POOL_MARGIN_BYTES / 1e9:.2f} GB, cap {cap} pages", flush=True)
    require(pages >= slots * -(-(256 + 17) // page_tokens),
            f"{cfg.name}: the card holds {pages} KV pages beside the "
            "weights, too few for 8 slots of 273 tokens")
    return int(pages)


def _attn_weights(attn, d, tag=""):
    """An attention block's q, k, v, o as the GEMM reads them, 2-D."""
    return [(attn[n].reshape(d, -1) if n != "wo" else attn[n].reshape(-1, d),
             f"{tag}{n}") for n in ("wq", "wk", "wv", "wo")]


def _dense_kernels(torch, args, cfg, params, dev, timer, rows,
                   weights=None):
    """(a) Every kernel at one arch's shapes, kept as each row's
    ``<arch>_path``.  The GEMM at M = 8 and 256 over ``weights`` (by
    default layer 0's own q, k, v, o and MLP weights), and the untied
    lm_head at M = 8; flash at T = 256 with the arch's heads; paged
    attention at 8 x 272 tokens (the decode profile's context, on the
    path) and at a ragged mix of 64-1,024 (beyond the serving phase's
    264, off the path), then one edge case checked without timing (lens
    0, 1, a page boundary and the full table) at the arch's query-head
    group count."""
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device=dev).manual_seed(args.seed + 30)
    bf16 = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(bf16)

    key = f"{cfg.name}_path"
    d, H, KH, D = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                   cfg.resolved_head_dim)
    if weights is None:
        mlp = params["layers"][0]["mlp"]
        weights = _attn_weights(params["layers"][0]["attn"], d)
        weights += [(mlp[n], f"mlp {n}") for n in
                    (("wi_gate", "wi_up", "wo") if cfg.glu else ("wi", "wo"))]
    per_shape = []
    for M in (8, 256):
        a = randn(M, d)
        for w, what in weights:
            x = a if w.shape[0] == d else randn(M, w.shape[0])
            per_shape.append(gemm_entry(torch, timer, x, w, what, True))
    per_shape.append(gemm_entry(torch, timer, randn(8, d),
                                params["lm_head"], "lm_head", True))
    _add_path(rows["streaming_gemm"], per_shape, key)

    T = 256
    per_shape = [flash_entry(torch, timer, randn(1, T, H, D),
                             randn(1, T, KH, D), randn(1, T, KH, D), True)]
    _add_path(rows["flash_attention"], per_shape, key)

    B, page, max_pages = 8, 16, 64
    P = B * max_pages + 16
    table = torch.randperm(P, generator=g, device=dev)[:B * max_pages] \
        .reshape(B, max_pages).to(torch.int32)
    q = randn(B, H, D)
    kp, vp = randn(P, page, KH, D), randn(P, page, KH, D)
    mixed = torch.randint(64, 1025, (B,), generator=g, device=dev) \
        .to(torch.int32)
    mixed[0] = 1024
    fixed = torch.full((B,), 272, dtype=torch.int32, device=dev)
    per_shape = [paged_entry(torch, timer, what, q, kp, vp, table, ln,
                             on_path)
                 for what, ln, on_path in (("8 x 272", fixed, True),
                                           ("mixed 64-1024", mixed, False))]
    groups = per_shape[0]["head_groups"]
    edge = torch.tensor([0, 1, page, page * max_pages], dtype=torch.int32,
                        device=dev)
    err = check_close(f"paged edge {cfg.name}", ops.paged_attention(
        q[:4].contiguous(), kp, vp, table[:4].contiguous(), edge),
        ref.paged_ref(q[:4], kp, vp, table[:4], edge), BF16_TOL)
    print(f"[paged_attention] edge H={H}/{KH} D={D} groups {groups} lens "
          f"{edge.tolist()}: err {err:.3g} (tol {BF16_TOL})", flush=True)
    _add_path(rows["paged_attention"], per_shape, key, PAGED_KEYS)
    rows["paged_attention"][key].update(
        {"head_groups": groups,
         "edge": {"lens": edge.tolist(), "max_abs_err": err}})
    rows["paged_attention"]["max_abs_err"] = max(
        rows["paged_attention"]["max_abs_err"], err)


def phase_dense_variants(torch, args, rows):
    """8. internvl2-2b (vlm), chatglm3-6b (2-D RoPE) and granite-20b
    (layernorm, non-gated GELU MLP, MQA: the paged kernel's query-head
    groups) in turn, each at full width and depth with random bf16
    weights from ``--seed``, freed before the next: (a) every kernel at
    its shapes, (b) serving 8 requests of 64-256 prompt tokens and 8 new
    tokens through ``ServingEngine`` (launch counts zeroed before; all
    three wrappers must run), (c) a profile of 3 full-batch decode steps
    (each GEMM and paged wrapper call one device kernel), (d) two layers
    on the card against the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model

    dev = torch.device("cuda")
    out = {}
    for arch in DENSE_ARCHS:
        cfg = get_config(arch)
        t0 = time.perf_counter()
        g = torch.Generator(device=dev).manual_seed(args.seed)
        params = Model(cfg, device=dev).init(g)
        torch.cuda.synchronize()
        res = {"init_s": time.perf_counter() - t0,
               "weights_gb": torch.cuda.memory_allocated() / 1e9}
        print(f"[{arch}] {res['weights_gb']:.2f} GB of weights on the card "
              f"in {res['init_s']:.1f} s", flush=True)
        t = time.perf_counter()
        timer = Timer(torch, dev)
        _dense_kernels(torch, args, cfg, params, dev, timer, rows)
        del timer
        res["kernels_s"] = time.perf_counter() - t
        pages = kv_pool_pages(torch, cfg)
        t = time.perf_counter()
        res["serving"] = phase_serving(
            torch, args, cfg, params, DENSE_KERNELS, new_tokens=8,
            tag=f"{arch} serving", n_requests=8, prompt_max=256,
            pool_pages=pages)
        res["serving_s"] = time.perf_counter() - t
        t = time.perf_counter()
        res["decode_profile"] = phase_profile(
            torch, args, cfg, params, n_steps=3,
            tag=f"{arch} decode_profile", pool_pages=pages)
        res["profile_s"] = time.perf_counter() - t
        res["card_vs_cpu"] = phase_card_vs_cpu(
            torch, args, cfg, params, n_layers=2,
            tag=f"{arch} card_vs_cpu")
        res["seconds"] = time.perf_counter() - t0
        print(f"[{arch}] seconds: init {res['init_s']:.1f} kernels "
              f"{res['kernels_s']:.1f} serving {res['serving_s']:.1f} "
              f"profile {res['profile_s']:.1f} card_vs_cpu "
              f"{res['card_vs_cpu']['seconds']:.1f} total "
              f"{res['seconds']:.1f}", flush=True)
        out[arch] = res
        del params
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------ 9. whisper-tiny
WHISPER_ARCH = "whisper-tiny"
WHISPER_CLIPS = 8
WHISPER_FRAMES = 1500   # 30 s of audio at 50 frames/s after the conv stem
# the start-of-transcript prompt: <|startoftranscript|> <|en|>
# <|transcribe|> <|notimestamps|> in Whisper's multilingual vocabulary
WHISPER_PROMPT = (50258, 50259, 50359, 50363)


def _whisper_kernels(torch, args, cfg, params, dev, timer, rows):
    """(a) Every kernel at whisper-tiny's shapes, kept as each row's
    ``whisper-tiny_path``: the GEMM at the encoder's M = 12,000 (8 clips
    of 1,500 frames) over encoder layer 0's q/k/v/o and MLP and decoder
    layer 0's cross K/V projections, and at the decoder's M = 8 over its
    self q/k/v/o, cross q/o and MLP, and the 384 x 51,968 lm_head; flash
    non-causal over 1,500 keys, self-attention (8, 1,500, 6, 64) and the
    prompt's cross-attention q (8, 4, 6, 64); paged attention over the
    cross table (8 x 1,500 tokens, 16-token pages, 94 pages) and over
    the self table at the greedy loop's middle context (8 x 36, 5
    pages)."""
    g = torch.Generator(device=dev).manual_seed(args.seed + 40)
    bf16 = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(bf16)

    key = f"{cfg.name}_path"
    d, H, KH, D = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                   cfg.resolved_head_dim)
    enc, dec = params["enc_layers"][0], params["layers"][0]

    def attn(p, names, tag):
        return [(p[n].reshape(d, -1) if n != "wo" else p[n].reshape(-1, d),
                 f"{tag} {n}") for n in names]

    def mlp(p, tag):
        return [(p["mlp"][n], f"{tag} mlp {n}") for n in ("wi", "wo")]

    B, Te = WHISPER_CLIPS, WHISPER_FRAMES
    encoder = (attn(enc["attn"], ("wq", "wk", "wv", "wo"), "enc")
               + mlp(enc, "enc") + attn(dec["xattn"], ("wk", "wv"), "cross"))
    decoder = (attn(dec["attn"], ("wq", "wk", "wv", "wo"), "self")
               + attn(dec["xattn"], ("wq", "wo"), "cross") + mlp(dec, "dec"))
    per_shape = []
    for M, weights in ((B * Te, encoder), (B, decoder)):
        a = randn(M, d)
        for w, what in weights:
            x = a if w.shape[0] == d else randn(M, w.shape[0])
            per_shape.append(gemm_entry(torch, timer, x, w, what, True))
    per_shape.append(gemm_entry(torch, timer, randn(B, d),
                                params["lm_head"], "lm_head", True))
    _add_path(rows["streaming_gemm"], per_shape, key)

    k, v = randn(B, Te, KH, D), randn(B, Te, KH, D)
    per_shape = [flash_entry(torch, timer, randn(B, Tq, H, D), k, v, True,
                             causal=False)
                 for Tq in (Te, len(WHISPER_PROMPT))]
    _add_path(rows["flash_attention"], per_shape, key)

    page = 16
    per_shape = []
    for what, length in (("cross 8 x 1500", Te), ("self 8 x 36", 36)):
        mp = -(-length // page)
        P = B * mp + 16
        table = torch.randperm(P, generator=g, device=dev)[:B * mp] \
            .reshape(B, mp).to(torch.int32)
        ln = torch.full((B,), length, dtype=torch.int32, device=dev)
        per_shape.append(paged_entry(
            torch, timer, what, randn(B, H, D), randn(P, page, KH, D),
            randn(P, page, KH, D), table, ln, True))
    _add_path(rows["paged_attention"], per_shape, key, PAGED_KEYS)


def _whisper_clips(torch, cfg, g, n):
    """``n`` clips of 1,500 seeded frames (x 0.02, as the reference's
    ``make_concrete_batch`` draws them) and the start-of-transcript
    prompt for each, on ``g``'s device."""
    frames = torch.randn((n, WHISPER_FRAMES, cfg.d_model), generator=g,
                         device=g.device) * 0.02
    prompt = torch.tensor(WHISPER_PROMPT, device=g.device).expand(n, -1)
    return frames, prompt


def _whisper_prefilled(model, params, frames, prompt, max_seq):
    """A cache whose slots 0..n-1 hold the prompt's self KV and the
    clips' encoder KV, and the prefill's logits."""
    n = frames.shape[0]
    cache = model.init_cache(n, max_seq, page_tokens=16,
                             enc_seq=frames.shape[1])
    for s in range(n):
        cache.alloc_seq(s, prompt.shape[1])
    logits = model.prefill(params, prompt, cache, list(range(n)),
                           audio_frames=frames)
    return cache, logits


def _whisper_greedy(torch, args, cfg, params, new_tokens=64):
    """(b) The batched greedy loop: 8 clips, the 4-token prompt, then
    ``new_tokens`` tokens each (the prefill's and ``new_tokens - 1``
    decode steps), after an untimed warm-up of 3.  Prints the encoder's
    time alone (the median of 3), TTFT (prefill, its encoder included,
    to the first tokens), the median decode step, tokens/s over the run
    and the peak device memory.  Launch counts are zeroed just before
    the run and read just after; all three wrappers must have run."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.models.model import Model

    dev = torch.device("cuda")
    m = Model(cfg, device=dev)
    g = torch.Generator(device=dev).manual_seed(args.seed + 41)
    frames, prompt = _whisper_clips(torch, cfg, g, WHISPER_CLIPS)
    slots = list(range(WHISPER_CLIPS))
    V = cfg.vocab_size

    def run(n_new):
        t0 = time.perf_counter()
        cache, logits = _whisper_prefilled(m, params, frames, prompt,
                                           prompt.shape[1] + new_tokens)
        out = [logits[:, :V].argmax(-1)]
        torch.cuda.synchronize()
        ttft = time.perf_counter() - t0
        steps = []
        for _ in range(n_new - 1):
            ts = time.perf_counter()
            out.append(m.decode_step(params, cache, out[-1], slots)[
                :, :V].argmax(-1))
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - ts)
        wall = time.perf_counter() - t0
        return cache, torch.stack(out, 1), ttft, steps, wall

    run(3)                                # first-call set-up, not timed
    enc_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        T.encode(params, cfg, frames)
        torch.cuda.synchronize()
        enc_s.append(time.perf_counter() - t)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    cache, toks, ttft, steps, wall = run(new_tokens)
    launches = dict(ops.LAUNCHES)
    require(tuple(toks.shape) == (WHISPER_CLIPS, new_tokens) and
            bool(((toks >= 0) & (toks < V)).all()), "greedy tokens")
    require(list(cache.lens[:WHISPER_CLIPS]) ==
            [prompt.shape[1] + new_tokens - 1] * WHISPER_CLIPS and
            list(cache.cross.lens[:WHISPER_CLIPS]) ==
            [WHISPER_FRAMES] * WHISPER_CLIPS, "cache lengths")
    cache.validate()
    for s in slots:
        cache.free_seq(s)
    cache.validate()
    require(cache.pages_in_use == cache.cross.pages_in_use == 0,
            "pages leaked after the loop")
    missing = [k for k in DENSE_KERNELS if launches[k] <= 0]
    require(not missing, f"whisper path never launched {missing}")
    n_out = int(toks.numel())
    res = {"model": cfg.name, "clips": WHISPER_CLIPS,
           "frames": WHISPER_FRAMES, "prompt": list(WHISPER_PROMPT),
           "tokens_out": n_out, "encoder_ms": _median_ms(enc_s),
           "ttft_ms": ttft * 1e3, "decode_step_median_ms": _median_ms(steps),
           "decode_steps": len(steps), "wall_s": wall,
           "tokens_per_s": n_out / wall,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches, "validate": "ok"}
    print(f"[{cfg.name} greedy] " + json.dumps(res), flush=True)
    return res


def _whisper_profile(torch, args, cfg, params):
    """(c) ``profile_steps`` over decode steps of the 8 clips, each GEMM
    and paged wrapper call one device kernel."""
    from repro_torch.models.model import Model

    dev = torch.device("cuda")
    m = Model(cfg, device=dev)
    g = torch.Generator(device=dev).manual_seed(args.seed + 42)
    frames, prompt = _whisper_clips(torch, cfg, g, WHISPER_CLIPS)
    cache, logits = _whisper_prefilled(m, params, frames, prompt, 64)
    slots = list(range(WHISPER_CLIPS))
    state = {"tok": logits[:, :cfg.vocab_size].argmax(-1)}

    def step():
        state["tok"] = m.decode_step(params, cache, state["tok"], slots)[
            :, :cfg.vocab_size].argmax(-1)

    step()
    return profile_steps(torch, step, cfg.name, prompt.shape[1] + 1, 3,
                         f"{cfg.name} decode_profile",
                         ("streaming_gemm", "paged_attention"))


def _whisper_card_vs_cpu(torch, args, cfg, params, n_clips=2):
    """(d) The whole model, ``n_clips`` clips of 1,500 seeded frames with
    the prompt, a prefill and 4 decode steps of seeded tokens, on the
    card and on the CPU (every wrapper's plain version): logits within
    E2E_TOL x max(1, max|logit|)."""
    import numpy as np
    from repro_torch.models.model import Model
    from repro_torch.models.params import params_to

    rng = np.random.default_rng(args.seed + 4)
    frames = torch.from_numpy(rng.standard_normal(
        (n_clips, WHISPER_FRAMES, cfg.d_model), np.float32) * 0.02)
    prompt = torch.tensor(WHISPER_PROMPT).expand(n_clips, -1)
    forced = torch.from_numpy(rng.integers(1, cfg.vocab_size - 1,
                                           (4, n_clips)))

    def run(device, p):
        m = Model(cfg, device=device)
        cache, logits = _whisper_prefilled(
            m, p, frames.to(m.device), prompt.to(m.device), 16)
        out = [logits]
        for t in forced:
            out.append(m.decode_step(p, cache, t.to(m.device),
                                     list(range(n_clips))))
        return torch.cat(out).float().cpu()

    t0 = time.perf_counter()
    card = run("cuda", params)
    cpu = run("cpu", params_to(params, "cpu"))
    require(card.shape == (5 * n_clips, cfg.padded_vocab) and
            bool(card.isfinite().all()), "card logits malformed")
    err = (card - cpu).abs().max().item()
    top = cpu.abs().max().item()
    res = {"clips": n_clips, "layers": [cfg.n_encoder_layers, cfg.n_layers],
           "max_abs_err": err, "max_abs_logit": top,
           "tol": E2E_TOL * max(1.0, top),
           "argmax_agree": int((card.argmax(-1) == cpu.argmax(-1)).sum()),
           "rows": int(card.shape[0]), "seconds": time.perf_counter() - t0}
    print(f"[{cfg.name} card_vs_cpu] " + json.dumps(res), flush=True)
    require(err <= res["tol"], f"whisper card vs CPU logits differ by {err}")
    return res


def phase_whisper(torch, args, rows):
    """9. whisper-tiny at full width and depth (4 + 4 layers, d 384, 6 / 6
    heads of 64, random bf16 weights from ``--seed``), through ``Model``
    (the engine prefills token ids only): (a) every kernel at its
    shapes, (b) the batched greedy loop over 8 clips of 1,500 frames,
    (c) a profile of 3 decode steps, (d) the whole model on the card
    against the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model

    dev = torch.device("cuda")
    cfg = get_config(WHISPER_ARCH)
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(args.seed)
    params = Model(cfg, device=dev).init(g)
    torch.cuda.synchronize()
    res = {"init_s": time.perf_counter() - t0,
           "weights_gb": torch.cuda.memory_allocated() / 1e9}
    print(f"[{cfg.name}] {res['weights_gb']:.3f} GB of weights on the "
          f"card in {res['init_s']:.1f} s", flush=True)
    t = time.perf_counter()
    timer = Timer(torch, dev)
    _whisper_kernels(torch, args, cfg, params, dev, timer, rows)
    del timer
    res["kernels_s"] = time.perf_counter() - t
    t = time.perf_counter()
    res["greedy"] = _whisper_greedy(torch, args, cfg, params)
    res["greedy_s"] = time.perf_counter() - t
    t = time.perf_counter()
    res["decode_profile"] = _whisper_profile(torch, args, cfg, params)
    res["profile_s"] = time.perf_counter() - t
    res["card_vs_cpu"] = _whisper_card_vs_cpu(torch, args, cfg, params)
    res["seconds"] = time.perf_counter() - t0
    print(f"[{cfg.name}] seconds: init {res['init_s']:.1f} kernels "
          f"{res['kernels_s']:.1f} greedy {res['greedy_s']:.1f} profile "
          f"{res['profile_s']:.1f} card_vs_cpu "
          f"{res['card_vs_cpu']['seconds']:.1f} total "
          f"{res['seconds']:.1f}", flush=True)
    return res

# ---------------------------------------------------------- 10. rwkv6-7b
RWKV_ARCH = "rwkv6-7b"
# the scan ops on the card against the same op on the CPU, of the
# largest |want|: the output is rounded to bf16 (one ulp is 2^-8 of it);
# the fp32 state sums in another order, through the chunk's midpoint
# factors of up to exp(+-40) (a float64 recurrence leaves 1e-6 on the CPU)
SCAN_TOL = {"out": 1e-2, "state": 1e-4}


def _rwkv_kernels(torch, args, cfg, params, dev, timer, rows):
    """(a) The GEMM at M = 8 and 256 over layer 0's nine weights and the
    untied lm_head at M = 8, kept as the GEMM row's ``rwkv6-7b_path``."""
    g = torch.Generator(device=dev).manual_seed(args.seed + 50)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    lp = params["layers"][0]
    weights = [(lp["time"][n], f"time {n}")
               for n in ("wr", "wk", "wv", "wg", "ww", "wo")]
    weights += [(lp["channel"][n], f"channel {n}") for n in ("wk", "wv", "wr")]
    per_shape = [gemm_entry(torch, timer, randn(M, w.shape[0]), w, what, True)
                 for M in (8, 256) for w, what in weights]
    per_shape.append(gemm_entry(torch, timer, randn(8, cfg.d_model),
                                params["lm_head"], "lm_head", True))
    _add_path(rows["streaming_gemm"], per_shape, f"{cfg.name}_path")


def _scan_op(torch, timer, name, fn, inputs, nbytes, flops):
    """One scan op: its output (bf16) and state (fp32) on the card held
    against the same op on the CPU (``SCAN_TOL`` of the largest |want|),
    its time and its bound (bytes, or fp32 operations outside the tensor
    cores)."""
    got = fn(*inputs)
    want = fn(*(t.cpu() for t in inputs))
    res = {"op": name}
    for part, a, b in zip(("out", "state"), got, want):
        top = b.abs().max().item()
        err = check_close(f"{name} {part}", a.float().cpu(), b.float(),
                          SCAN_TOL[part] * top, 0.0)
        res[f"{part}_max_abs_err"] = err
        res[f"{part}_max_abs"] = top
    bms, by = bound(nbytes, flops, FP32_FLOP_PER_S)
    res.update({"tol_of_max_abs": SCAN_TOL,
                "ms": timer(lambda: fn(*inputs)), "bound_ms": bms,
                "bound_by": by, "bytes": nbytes, "flops": flops})
    return res


def _scan_ops(torch, args, cfg, dev, timer):
    """(a) The scan's two PyTorch ops at the main path's shapes:
    ``linear_attention_step`` over 8 slots (decode) and the chunked scan
    of a 256-token prompt (prefill), on r, k, v in bf16, the decay as
    the time mix makes it (-exp of a normal draw, fp32, some of it below
    the clamp), a random fp32 state and bonus."""
    from repro_torch.models import ssm as SSM
    from repro_torch.models import tuning as TU

    g = torch.Generator(device=dev).manual_seed(args.seed + 51)
    H = cfg.n_heads
    N = cfg.d_model // H
    chunk = TU.get().ssm_chunk

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    u = randn(H, N) * 0.1
    out = []
    for what, lead in (("linear_attention_step", (8,)),
                       ("chunked_linear_attention", (1, 256))):
        B = lead[0]
        r, k, v = (randn(*lead, H, N, dtype=torch.bfloat16)
                   for _ in range(3))
        logw = -torch.exp(randn(*lead, H, N))
        state = randn(B, H, N, N) * 0.1
        io = 3 * r.numel() * 2 + logw.numel() * 4 + u.numel() * 4 + \
            2 * state.numel() * 4 + r.numel() * 2
        if what == "linear_attention_step":
            fn = SSM.linear_attention_step
            # kv, decay, bonus, read, update: ~6 flops per state element
            flops = 6 * state.numel()
        else:
            def fn(r, k, v, logw, state, u):
                return SSM.chunked_linear_attention(r, k, v, logw, state,
                                                    u=u, chunk=chunk)
            T = lead[1]
            # per chunk: the inter-chunk read, scores, intra-chunk PV and
            # the state update, 2 flops per multiply-add
            flops = (T // chunk) * B * H * (
                2 * chunk * N * N * 2 + 2 * chunk * chunk * N * 2)
        out.append(_scan_op(torch, timer, what, fn,
                            (r, k, v, logw, state, u), io, flops))
        out[-1]["shape"] = {"rk": list(r.shape), "state": list(state.shape)}
    print(json.dumps({"scan_ops": out}), flush=True)
    return out


def phase_rwkv(torch, args, rows):
    """10. rwkv6-7b at full width and depth (32 layers, d 4,096, 16.11 GB
    of random bf16 weights from ``--seed``): (a) the GEMM at its shapes
    and the scan's two ops, (b) serving 8 requests of 64-256 prompt
    tokens and 8 new tokens over the recurrent state store (the GEMM
    must run, flash and paged attention must not), (c) a profile of 3
    full-batch decode steps (each GEMM call one device kernel), (d) two
    layers on the card against the CPU, logits and scan states."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model

    dev = torch.device("cuda")
    cfg = get_config(RWKV_ARCH)
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(args.seed)
    params = Model(cfg, device=dev).init(g)
    torch.cuda.synchronize()
    res = {"init_s": time.perf_counter() - t0,
           "weights_gb": torch.cuda.memory_allocated() / 1e9}
    print(f"[{cfg.name}] {res['weights_gb']:.2f} GB of weights on the card "
          f"in {res['init_s']:.1f} s", flush=True)
    t = time.perf_counter()
    timer = Timer(torch, dev)
    _rwkv_kernels(torch, args, cfg, params, dev, timer, rows)
    res["scan_ops"] = _scan_ops(torch, args, cfg, dev, timer)
    del timer
    res["kernels_s"] = time.perf_counter() - t
    t = time.perf_counter()
    res["serving"] = phase_serving(
        torch, args, cfg, params, ("streaming_gemm",), new_tokens=8,
        tag=f"{cfg.name} serving", n_requests=8, prompt_max=256,
        absent=("flash_attention", "paged_attention",
                "streaming_gemm_grouped"))
    res["serving_s"] = time.perf_counter() - t
    t = time.perf_counter()
    # a recurrent decode step costs the same at any context: 64-token
    # prompts keep the 8 prefills before the window short
    res["decode_profile"] = phase_profile(
        torch, args, cfg, params, n_steps=3,
        tag=f"{cfg.name} decode_profile", one_kernel=("streaming_gemm",),
        prompt_len=64)
    res["profile_s"] = time.perf_counter() - t
    res["card_vs_cpu"] = phase_card_vs_cpu(
        torch, args, cfg, params, n_layers=2, tag=f"{cfg.name} card_vs_cpu")
    res["seconds"] = time.perf_counter() - t0
    print(f"[{cfg.name}] seconds: init {res['init_s']:.1f} kernels "
          f"{res['kernels_s']:.1f} serving {res['serving_s']:.1f} "
          f"profile {res['profile_s']:.1f} card_vs_cpu "
          f"{res['card_vs_cpu']['seconds']:.1f} total "
          f"{res['seconds']:.1f}", flush=True)
    return res


# --------------------------------------------------------- 11. zamba2-7b
ZAMBA_ARCH = "zamba2-7b"


def _zamba_scan_ops(torch, args, cfg, dev, timer):
    """(a) The Mamba2 scan's PyTorch op at the main path's shapes: the
    inclusive ``chunked_linear_attention`` of one decode step (8 slots,
    chunk 1, as ``mamba2_step`` runs it) and of a 256-token prompt
    (chunk 16), over 112 heads of (N 64, hd 64): C and B (the queries
    and keys) one bf16 group broadcast to every head, x·dt bf16, the
    decay dt·a (a softplus draw times -exp of a normal one, fp32, some
    of it below the clamp) broadcast over N, a random fp32 state.
    Printed as one ``{"scan_ops": [...]}`` line, each op held against
    the same op on the CPU."""
    from repro_torch.models import ssm as SSM

    g = torch.Generator(device=dev).manual_seed(args.seed + 60)
    s = cfg.ssm
    nh, N, hd = s.expand * cfg.d_model // s.head_dim, s.d_state, s.head_dim

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    out = []
    for what, B, T, chunk in (("mamba2_step scan", 8, 1, 1),
                              ("mamba2_forward scan", 1, 256,
                               SSM.DEFAULT_CHUNK)):
        c, b = (randn(B, T, 1, N, dtype=torch.bfloat16).expand(B, T, nh, N)
                for _ in range(2))
        xh = randn(B, T, nh, hd, dtype=torch.bfloat16)
        dt = torch.nn.functional.softplus(randn(B, T, nh))
        logw = (dt * -torch.exp(randn(nh)))[..., None].expand(B, T, nh, N)
        state = randn(B, nh, N, hd) * 0.1

        def fn(r, k, v, w, st, chunk=chunk):
            return SSM.chunked_linear_attention(r, k, v, w, st, chunk=chunk,
                                                inclusive=True)

        # each input read once (B, C and the decay before their
        # broadcast), the state read and written, the output written
        io = 2 * B * T * N * 2 + 2 * xh.numel() * 2 + B * T * nh * 4 + \
            2 * state.numel() * 4
        # per chunk and head: the inter-chunk read and the state update
        # (c·N·hd each), scores and intra-chunk PV (c²·N, c²·hd), 2
        # flops per multiply-add
        flops = (T // chunk) * B * nh * (
            2 * chunk * N * hd * 2 + chunk * chunk * (N + hd) * 2)
        out.append(_scan_op(torch, timer, what, fn, (c, b, xh, logw, state),
                            io, flops))
        out[-1]["shape"] = {"rk": [B, T, nh, N], "v": list(xh.shape),
                            "state": list(state.shape), "chunk": chunk}
    print(json.dumps({"scan_ops": out, "model": cfg.name}), flush=True)
    return out


def phase_zamba(torch, args, rows):
    """11. zamba2-7b at full width and depth (81 Mamba2 layers, d 3,584,
    one shared attention block of 32 / 32 heads of 112 run before every
    sixth layer; 38.16 GB of random bf16 weights from ``--seed``): (a)
    the GEMM over layer 0's Mamba2 and MLP weights, the shared block's
    q/k/v/o and the lm_head, flash and paged attention at head dim 112,
    and the scan op; (b) serving 8 requests of 64-256 prompt tokens and
    8 new tokens over the 14-layer KV pool and the state store (GEMM,
    flash and paged must run, the grouped GEMM must not); (c) a profile
    of 3 full-batch decode steps (each GEMM and paged call one device
    kernel, 14 paged calls a step); (d) the first 7 layers (shared
    invocations at layers 0 and 6) on the card against the CPU, logits
    and each layer's scan state."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import n_shared_invocations

    dev = torch.device("cuda")
    cfg = get_config(ZAMBA_ARCH)
    inv = n_shared_invocations(cfg)
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(args.seed)
    params = Model(cfg, device=dev).init(g)
    torch.cuda.synchronize()
    res = {"init_s": time.perf_counter() - t0,
           "weights_gb": torch.cuda.memory_allocated() / 1e9,
           "shared_invocations": inv}
    print(f"[{cfg.name}] {res['weights_gb']:.2f} GB of weights on the card "
          f"in {res['init_s']:.1f} s; {inv} shared-attention invocations",
          flush=True)
    t = time.perf_counter()
    timer = Timer(torch, dev)
    d = cfg.d_model
    lp = params["layers"][0]
    weights = [(lp["mamba"][n], f"mamba {n}") for n in ("in_proj",
                                                         "out_proj")]
    weights += [(lp["mlp"][n], f"mlp {n}") for n in ("wi_gate", "wi_up",
                                                     "wo")]
    weights += _attn_weights(params["shared_attn"]["attn"], d, "shared ")
    _dense_kernels(torch, args, cfg, params, dev, timer, rows, weights)
    res["scan_ops"] = _zamba_scan_ops(torch, args, cfg, dev, timer)
    del timer
    res["kernels_s"] = time.perf_counter() - t
    pages = kv_pool_pages(torch, cfg)
    t = time.perf_counter()
    res["serving"] = phase_serving(
        torch, args, cfg, params, DENSE_KERNELS, new_tokens=8,
        tag=f"{cfg.name} serving", n_requests=8, prompt_max=256,
        pool_pages=pages, absent=("streaming_gemm_grouped",))
    res["serving_s"] = time.perf_counter() - t
    t = time.perf_counter()
    prof = res["decode_profile"] = phase_profile(
        torch, args, cfg, params, n_steps=3,
        tag=f"{cfg.name} decode_profile", pool_pages=pages)
    require(prof["launches_per_step"]["paged_attention"] == inv,
            f"{cfg.name}: {prof['launches_per_step']['paged_attention']} "
            f"paged calls a decode step, not one per invocation ({inv})")
    res["profile_s"] = time.perf_counter() - t
    res["card_vs_cpu"] = phase_card_vs_cpu(
        torch, args, cfg, params, n_layers=7, tag=f"{cfg.name} card_vs_cpu")
    res["seconds"] = time.perf_counter() - t0
    print(f"[{cfg.name}] seconds: init {res['init_s']:.1f} kernels "
          f"{res['kernels_s']:.1f} serving {res['serving_s']:.1f} "
          f"profile {res['profile_s']:.1f} card_vs_cpu "
          f"{res['card_vs_cpu']['seconds']:.1f} total "
          f"{res['seconds']:.1f}", flush=True)
    return res


# ------------------------------------------------ 12. deepseek-v3-671b
DEEPSEEK_PATH_KERNELS = ("streaming_gemm", "streaming_gemm_grouped",
                         "flash_attention", "paged_latent_attention")


def latent_entry(torch, timer, what, q, pool, table, ln, on_path, dv, scale):
    """The latent form of paged decode attention at one shape, as
    ``paged_entry``: the kernel against its plain version; the library
    time is SDPA over a contiguous copy of the latent rows, one KV head
    broadcast to the H query heads (``enable_gqa``), V its first ``dv``
    columns, with the same scale and a length mask."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.paged_attention import latent_plan
    n, H, D = q.shape
    P, page = pool.shape[:2]
    max_pages = table.shape[1]

    def kernel():
        return ops.paged_latent_attention(q, pool, table, ln, dv, scale)

    def plain():
        return ref.paged_ref(q, pool, pool, table, ln, dv=dv, scale=scale)

    err = check_close(f"paged latent {what}", kernel(), plain(), BF16_TOL)
    n_tok = int(ln.sum())
    bms, by = bound(2 * n * H * (D + dv) + 4 * n * (max_pages + 1)
                    + 2 * n_tok * D, 2 * H * n_tok * (D + dv))
    kc = pool[table.long()].reshape(n, 1, max_pages * page, D)
    vc = kc[..., :dv].contiguous()
    mask = (torch.arange(max_pages * page, device=q.device)[None]
            < ln[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]

    def sdpa():
        return F.scaled_dot_product_attention(q4, kc, vc, attn_mask=mask,
                                              scale=scale, enable_gqa=True)

    check_close(f"paged latent {what} contiguous SDPA", sdpa()[:, :, 0],
                plain(), BF16_TOL)
    r = {"shape": {"q": [n, H, D], "pool": [P, page, 1, D], "dv": dv,
                   "lens": ln.tolist()}, "what": what, "on_path": on_path,
         "plan": latent_plan(n, H, max_pages, page), "max_abs_err": err,
         "ms": timer(kernel), "plain_ms": timer(plain),
         "contiguous_sdpa_ms": timer(sdpa), "bound_ms": bms, "bound_by": by}
    print(f"[paged_latent_attention] {what} H={H} D={D}/{dv} (plan "
          f"S={r['plan']}, on_path {on_path}): err {err:.3g} (tol "
          f"{BF16_TOL}) kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} "
          f"ms contiguous SDPA {r['contiguous_sdpa_ms']:.4f} ms bound "
          f"{bms:.4f} ms ({by})", flush=True)
    return r


def _deepseek_kernels(torch, args, cfg, params, dev, timer, rows):
    """(a) Every kernel at deepseek-v3-671b's shapes, kept as each row's
    ``<arch>_path`` (the latent kernel's row is new).  The GEMM at M = 8
    and 256 over layer 0's MLA weights (``wdq``, ``wuq``, ``wdkv``,
    ``wkr``, ``wuk`` and ``wuv`` as prefill reads them, ``wo``), its
    dense MLP, layer 3's router and shared expert, and the lm_head at M
    = 8.  The expert-grouped GEMM at decode (8 tokens) and at a 256-token
    prefill, counts from routing random tokens through layer 3's router,
    for gate/up and down over its 256 experts; and the absorbed decode's
    per-head products, q_nope·W_uk and o_lat·W_uv, with the 128 heads as
    groups of 8 rows.  Flash at (1, 256, 128 / 128, 192 / 128), causal;
    the latent paged kernel at 8 x 272 and at mixed lengths 64-1,024."""
    from repro_torch.models import moe as MOE

    g = torch.Generator(device=dev).manual_seed(args.seed + 70)
    bf16 = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(bf16)

    key = f"{cfg.name}_path"
    m, d, H = cfg.mla, cfg.d_model, cfg.n_heads
    attn, mlp = params["dense_layers"][0]["attn"], \
        params["dense_layers"][0]["mlp"]
    moe = params["layers"][0]["moe"]
    r = m.kv_lora_rank
    weights = [(attn["wdq"], "mla wdq"),
               (attn["wuq"].reshape(m.q_lora_rank, -1), "mla wuq"),
               (attn["wdkv"], "mla wdkv"), (attn["wkr"], "mla wkr"),
               (attn["wuk"].reshape(r, -1), "mla wuk (prefill)"),
               (attn["wuv"].reshape(r, -1), "mla wuv (prefill)"),
               (attn["wo"].reshape(-1, d), "mla wo")]
    weights += [(mlp[n], f"mlp {n}") for n in ("wi_gate", "wi_up", "wo")]
    weights += [(moe["router"], "router")]
    weights += [(moe[n], f"shared {n}") for n in ("shared_wi_gate",
                                                  "shared_wi_up",
                                                  "shared_wo")]
    per_shape = []
    for M in (8, 256):
        a = randn(M, d)
        for w, what in weights:
            x = a if w.shape[0] == d else randn(M, w.shape[0])
            per_shape.append(gemm_entry(torch, timer, x, w, what, True))
    per_shape.append(gemm_entry(torch, timer, randn(8, d),
                                params["lm_head"], "lm_head", True))
    _add_path(rows["streaming_gemm"], per_shape, key)

    E, f = cfg.moe.n_routed_experts, cfg.moe.d_ff_expert
    per_shape = []
    for what, n in (("decode", 8), ("prefill", 256)):
        _, top_e, _ = MOE._route(moe, randn(n, d), cfg)
        counts = MOE._count(top_e, E, torch.int32)
        C = MOE.routed_capacity(n * cfg.moe.top_k, E, n)
        for prod, K, w in (("gate/up", d, moe["wi_gate"]),
                           ("down", f, moe["wo"])):
            a = randn(E, C, K)
            a[torch.arange(C, device=dev)[None, :] >= counts[:, None]] = 0
            per_shape.append(_grouped_entry(
                torch, timer, f"{what} {prod}", a, w, counts, True))
    heads = torch.full((H,), 8, dtype=torch.int32, device=dev)
    per_shape.append(_grouped_entry(
        torch, timer, "absorbed q_nope·W_uk", randn(H, 8, m.qk_nope_head_dim),
        attn["wuk_hkr"], heads, True))
    per_shape.append(_grouped_entry(
        torch, timer, "absorbed o_lat·W_uv", randn(H, 8, r),
        attn["wuv_hrv"], heads, True))
    _add_path(rows["streaming_gemm_grouped"], per_shape, key)

    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    T = 256
    per_shape = [flash_entry(torch, timer, randn(1, T, H, qk),
                             randn(1, T, H, qk),
                             randn(1, T, H, m.v_head_dim), True)]
    _add_path(rows["flash_attention"], per_shape, key)

    B, page, max_pages, D = 8, 16, 64, r + m.qk_rope_head_dim
    P = B * max_pages + 16
    table = torch.randperm(P, generator=g, device=dev)[:B * max_pages] \
        .reshape(B, max_pages).to(torch.int32)
    q, pool = randn(B, H, D), randn(P, page, 1, D)
    mixed = torch.randint(64, 1025, (B,), generator=g, device=dev) \
        .to(torch.int32)
    mixed[0] = 1024
    fixed = torch.full((B,), 272, dtype=torch.int32, device=dev)
    scale = qk ** -0.5
    per_shape = [latent_entry(torch, timer, what, q, pool, table, ln, on_path,
                              r, scale)
                 for what, ln, on_path in (("8 x 272", fixed, True),
                                           ("mixed 64-1024", mixed, False))]
    rows["paged_latent_attention"] = {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:34",
        "note": "the latent (MLA) form of the paged kernel: 128 query "
                "heads over one 576-wide latent head, V its first 512 "
                "columns; the reference computes MLA decode as XLA "
                "einsums (src/repro/models/layers.py:347-394)",
        "tol": BF16_TOL,
        "max_abs_err": max(x["max_abs_err"] for x in per_shape),
        **summary(per_shape, PAGED_KEYS), "library_ms": None,
        key: {**summary(per_shape, PAGED_KEYS), "per_shape": per_shape}}


def _deepseek_moe_card_vs_cpu(torch, args, cfg, params):
    """(d) Layer 3, the first MoE layer, alone: its MoE block fed the
    card's hidden states (a 256-token prompt through the 3 dense layers
    and layer 3's attention and ``ln2`` on the card), once as a prefill
    (256 tokens, capacity 256) and once as a decode batch (its first 8
    tokens, capacity 8), on the card and on the CPU.  Each token's expert
    set is recorded on both sides: the share that agree must reach
    ``ROUTING_AGREEMENT_MIN``.  With one MoE layer and the same inputs on
    both sides every flip is a token's first (none is caused by an
    earlier layer's); flips are counted by how many of the 8 experts
    differ.  The outputs of the tokens routed alike must be within
    E2E_TOL x max(1, max|y|)."""
    import numpy as np
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T
    from repro_torch.models.params import params_to

    dev = params["embed"].device
    rng = np.random.default_rng(args.seed + 5)
    prompt = torch.as_tensor(rng.integers(1, cfg.vocab_size - 1, 256),
                             device=dev)[None]
    t0 = time.perf_counter()
    x = T.embed_tokens(params, cfg, prompt)
    pos = torch.arange(256, device=dev)[None]
    for lp in params["dense_layers"]:
        x, _ = T.dense_layer_fwd(lp, x, cfg, pos)
    lp = params["layers"][0]
    a, _ = L.mla_prefill(lp["attn"], L.apply_norm(lp["ln1"], x, cfg), cfg,
                         pos)
    h = L.apply_norm(lp["ln2"], x + a, cfg)
    cases = (("prefill", h, 256), ("decode", h[0, :8, None], 8))

    def run(p):
        log, outs = [], []
        orig = _record_routes(MOE, log)
        try:
            for _, hh, cap in cases:
                y, _ = MOE.apply_moe(p, hh.to(p["router"].device), cfg,
                                     capacity=cap)
                outs.append(y.reshape(-1, cfg.d_model).float().cpu())
        finally:
            MOE.apply_moe = orig
        return outs, log

    card, card_routes = run(lp["moe"])
    cpu, cpu_routes = run(params_to(lp["moe"], "cpu"))
    res = {"layer": 3, "tokens": {c[0]: c[2] for c in cases}}
    same_all = []
    for (what, _, _), c, w, rc, rw in zip(cases, card, cpu, card_routes,
                                          cpu_routes):
        require(bool(c.isfinite().all()), f"{what}: card MoE output "
                "not finite")
        same = (rc == rw).all(-1)
        same_all.append(same)
        top = w.abs().max().item()
        err = (c[same] - w[same]).abs().max().item() if same.any() else None
        res[what] = {"routing_agreement": float(same.float().mean()),
                     "max_abs_err": err, "max_abs": top,
                     "tol": E2E_TOL * max(1.0, top)}
    share = float(torch.cat(same_all).float().mean())
    res.update({"routing_agreement": share,
                "routing_agreement_min": ROUTING_AGREEMENT_MIN,
                "assignments": int(sum(s.numel() for s in same_all)),
                "first_flips_by_experts_changed": _first_flips(
                    card_routes, cpu_routes),
                "seconds": time.perf_counter() - t0})
    print(f"[{cfg.name} moe_card_vs_cpu] " + json.dumps(res), flush=True)
    require(share >= ROUTING_AGREEMENT_MIN,
            f"card and CPU routing agree on {share:.3f} of the tokens")
    for what, _, _ in cases:
        r = res[what]
        require(r["max_abs_err"] is not None and
                r["max_abs_err"] <= r["tol"],
                f"{cfg.name} layer 3 {what}: card and CPU MoE outputs "
                f"differ by {r['max_abs_err']}")
    return res


def phase_deepseek(torch, args, rows):
    """12. deepseek-v3-671b cut in depth to its 3 dense and first 2 MoE
    layers (``deepseek-v3-671b-5l``) at full width: d 7,168, 128 heads of
    MLA (q/k 128 + 64, v 128, q rank 1,536, latent 512 + 64), 256 routed
    experts of 2,048, top-8, one shared, vocabulary 129,280; 51.8 GB of
    random bf16 weights from ``--seed``.  (a) every kernel at its shapes;
    (b) serving 8 requests of 64-256 prompt tokens and 8 new tokens over
    one latent pool a layer (GEMM, grouped GEMM, flash and the latent
    paged kernel must run, the GQA paged kernel must not); (c) a profile
    of 3 full-batch decode steps (one latent paged call a layer); (d) the
    3 dense layers and the lm_head on the card against the CPU, logits
    within E2E_TOL x max(1, max|logit|), then layer 3's MoE alone,
    routing-aware."""
    from repro_torch.configs.deepseek_v3_671b import SERVING
    from repro_torch.models.model import Model

    dev = torch.device("cuda")
    cfg = SERVING
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(args.seed)
    torch.cuda.reset_peak_memory_stats()
    params = Model(cfg, device=dev).init(g)
    torch.cuda.synchronize()
    res = {"config": cfg.name, "init_s": time.perf_counter() - t0,
           "weights_gb": torch.cuda.memory_allocated() / 1e9,
           "init_peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"[{cfg.name}] {cfg.n_layers} of 61 layers (cut in depth only); "
          f"{res['weights_gb']:.2f} GB of weights on the card in "
          f"{res['init_s']:.1f} s, init peak {res['init_peak_gb']:.2f} GB",
          flush=True)
    t = time.perf_counter()
    timer = Timer(torch, dev)
    _deepseek_kernels(torch, args, cfg, params, dev, timer, rows)
    del timer
    res["kernels_s"] = time.perf_counter() - t
    pages = kv_pool_pages(torch, cfg)
    t = time.perf_counter()
    res["serving"] = phase_serving(
        torch, args, cfg, params, DEEPSEEK_PATH_KERNELS, new_tokens=8,
        tag=f"{cfg.name} serving", n_requests=8, prompt_max=256,
        pool_pages=pages, absent=("paged_attention",))
    res["serving_s"] = time.perf_counter() - t
    t = time.perf_counter()
    prof = res["decode_profile"] = phase_profile(
        torch, args, cfg, params, n_steps=3,
        tag=f"{cfg.name} decode_profile", pool_pages=pages,
        one_kernel=("streaming_gemm", "streaming_gemm_grouped",
                    "paged_latent_attention"))
    require(prof["launches_per_step"]["paged_latent_attention"]
            == cfg.n_layers, f"{cfg.name}: not one latent paged call a layer")
    res["profile_s"] = time.perf_counter() - t
    res["card_vs_cpu"] = phase_card_vs_cpu(
        torch, args, cfg, params, n_layers=cfg.moe.first_dense_layers,
        tag=f"{cfg.name} card_vs_cpu")
    res["moe_card_vs_cpu"] = _deepseek_moe_card_vs_cpu(torch, args, cfg,
                                                       params)
    res["seconds"] = time.perf_counter() - t0
    print(f"[{cfg.name}] seconds: init {res['init_s']:.1f} kernels "
          f"{res['kernels_s']:.1f} serving {res['serving_s']:.1f} "
          f"profile {res['profile_s']:.1f} card_vs_cpu "
          f"{res['card_vs_cpu']['seconds']:.1f} moe_card_vs_cpu "
          f"{res['moe_card_vs_cpu']['seconds']:.1f} total "
          f"{res['seconds']:.1f}", flush=True)
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
    serving = phase_serving(torch, args, cfg, params, DENSE_KERNELS)
    phase_profile(torch, args, cfg, params)
    phase_card_vs_cpu(torch, args, cfg, params)
    phase_streaming(torch, args, cfg, params)
    del params
    torch.cuda.empty_cache()
    moe = phase_moe(torch, args, rows)
    torch.cuda.empty_cache()
    variants = phase_dense_variants(torch, args, rows)
    torch.cuda.empty_cache()
    whisper = phase_whisper(torch, args, rows)
    torch.cuda.empty_cache()
    rwkv = phase_rwkv(torch, args, rows)
    torch.cuda.empty_cache()
    zamba = phase_zamba(torch, args, rows)
    torch.cuda.empty_cache()
    deepseek = phase_deepseek(torch, args, rows)

    # launches: each kernel's count from its own main path's serving run
    # (the grouped GEMM's is the MoE path, the latent paged kernel's
    # deepseek-v3's); every path's counts beside
    paths = {cfg.name: serving["launches"],
             MOE_ARCH: moe["serving"]["launches"],
             **{a: v["serving"]["launches"] for a, v in variants.items()},
             WHISPER_ARCH: whisper["greedy"]["launches"],
             RWKV_ARCH: rwkv["serving"]["launches"],
             ZAMBA_ARCH: zamba["serving"]["launches"],
             deepseek["config"]: deepseek["serving"]["launches"]}
    own = {"streaming_gemm_grouped": MOE_ARCH,
           "paged_latent_attention": deepseek["config"]}
    kernels = [{"name": name, **rows[name],
                "launches": paths[own.get(name, cfg.name)][name],
                "launches_by_path": {p: n[name] for p, n in paths.items()}}
               for name in rows]
    print(json.dumps({"kernels": kernels, "card": card}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
