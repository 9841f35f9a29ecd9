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
   yardstick the port never calls).  The INT8 KV cache's two kernels:
   the int8 kernel (``paged_int8_fwd``) at qwen2-0.5b's and
   qwen1.5-32b's 8 x 272 and mixed 64-1,024 shapes (timed, beside SDPA
   over a contiguous dequantized copy and the bf16 kernel at the same
   shapes), granite-20b's query-head groups, whisper-tiny's D 64 and
   lens 0 (untimed), and its fused append (the decode step's launch) at
   qwen1.5-32b's and qwen2-0.5b's 8 x 272, the pools it writes bit for
   bit against its plain version, timed beside the quantize and paged
   launches it replaces; the quantize-and-append kernel bit for bit
   against its plain version at qwen1.5-32b's decode and 256-token
   prefill rows and qwen2-0.5b's decode rows, timed.
3. Serve qwen2-0.5b at full width (random weights from ``--seed``) with
   ``ServingEngine``: 8 slots, 16-token (4 KB) pages, 16 requests of
   64-512 prompt tokens and 32 new tokens each.  Launch counts are
   zeroed just before and read just after; every kernel of the dense
   path must have run.
4. Profile five full-batch decode steps: device time by kernel beside
   the unprofiled wall time per step (the device's busy share).  One
   more step runs with every wrapper call captured into a CUDA graph:
   each GEMM and paged wrapper call must be exactly one kernel node (the
   counts come from the graphs, not the profiler, which now and then
   loses launches).  A window the profiler recorded empty is profiled
   again (3 at most).
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
   each grouped wrapper call one device kernel; the step's 2-D GEMM
   device ms printed beside the 6.613 it took with the router on the
   scalar kernel (PR 15).  (d) Two full-width
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
   2,048 on both.  Each sub-phase's seconds are printed.  (e) After
   qwen1.5-32b's bf16 run, with its weights still loaded, the INT8 KV
   cache (``Tuning(kv_cache_quant=True)``): the bf16 pool freed, an int8
   pool sized from the free memory (int8 values plus fp16 scales, slots
   of 2,048 tokens; its pages and GB printed); 8 requests served, six of
   64-256 prompt tokens and two of 1,536, 8 new tokens each (the fused
   int8 launch and the prefill's quantize kernel must run, the bf16
   paged kernel must not); three full-batch decode steps profiled (64
   fused int8 launches and no quantize launch a step, each one kernel
   node, no ``index_put`` left; the int8 kernel's device ms a step); the
   first 2 layers on the card against the CPU under the same tuning.
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
13. The timing simulator (``repro_torch.accesys``, the Scenario API,
   ``serving/sim_report``), a numpy model of the paper's MatrixFlow
   accelerator behind PCIe that runs on the host; seconds per sub-phase.
   (a) and (b), like 14's (a) and (b), need no card: each runs in a
   process of its own (``--host-job``, one thread) started after
   phase 1's build, beside phases 2-12, and the phase prints its lines
   and reads its record.
   (a) Each row of ``BENCH_replay.json`` lowered again and replayed in
   DM, DC and DevMem by the compiled and the event engine: engine parity
   (``assert_parity``), the artifact's event count, each mode's
   ``total_us`` within 1e-9 of the artifact's (printed beside it), and
   the replay rate in events/s, labelled with the host's CPU and the
   card line.  (b) The paper-claim scorecard (``validate(fast=True)``),
   every row printed and every claim passing.  (c) qwen2-0.5b at full
   width cut in depth to one layer (each prefill plan repeats every
   layer's weight GEMMs tile by tile: a full-depth trace takes minutes
   of host time to build) serves 8 requests of 64-256 prompt tokens
   (multiples of 64, one plan template each) and 8 new tokens through
   ``ServingEngine(record_plans=True)``: launch counts zeroed just
   before and read just after (all three dense kernels must run), one
   trace record per admission and per decode step; the same requests again without recording, for the card's TTFT
   and decode step; the trace priced by ``simulate_serving_trace`` in
   each mode, the simulated TTFT and TPOT p50 printed beside the card's
   (no agreement asked); then the reduced ``Scenario(model="serve")``
   on the card and on the CPU, with equal ``SimResult``s.  (d) With
   CUDA live, ``tune`` over the default design space at two workers
   (spawned, not forked) equal to one worker.
14. Plan-only open-loop serving (``ServingEngine(plan_only=True)``,
   ``scenario.sweep_load``), on the host; seconds per sub-phase, one
   ``{"open_loop": ...}`` line.  (a) ``BENCH_serving_scale.json``'s
   serve_1k, its 32-token prefix with caching off and on, and
   serve_preempt_1k rebuilt with the benchmark's constants and priced in
   DM / DC / DevMem in one streamed pass: records, events, footprint
   pages, preemptions and swapped pages exactly, each ``total_s`` within
   1e-9 of the artifact's, every request's work conserved; events/s on
   the host.  (b) ``load_sweep_200`` (100 / 300 / 900 qps, 200
   requests) with CUDA live at one worker and two spawned: equal JSON
   but for ``wall_s``; the knee per mode.  (c) qwen2-0.5b at full width,
   1 layer as in 13c, on the card's clock: 13c's card decode-step median
   and this model's card prefill time per token (CUDA events at 64-256
   tokens) drive the plan-only engine (8 slots, 16-token pages,
   ``max_seq`` 1,024, 128-token prefill chunks) over 16 poisson requests
   of 64-256 prompt tokens and 8 new at 0.5, 1 and 2 times
   ``sweep_load``'s capacity, and at 2 times again with
   ``preempt="lifo"`` on the capped pool (at least one preemption);
   invariants every step, drained, work conserved, each trace priced per
   mode, simulated TTFT / TPOT p50 / p99 beside the card's 13c figures
   (no agreement asked).
15. Training of the dense family (``Trainer``, ``build_train_step``),
   the streaming GEMM forward and backward; seconds per sub-phase.  (a)
   Both backward products of every qwen2-0.5b GEMM at M = 4,096 tokens
   on the kernel (the call the autograd Function makes), each against
   its plain version within BF16_TOL and timed beside the plain version,
   ``torch.matmul`` on the same operands and the bound: dA = dC·Bᵀ (a
   K-contiguous B, or for the tied lm_head ``embed`` row-major) and dB
   = Aᵀ·dC (the new M-contiguous A; for the lm_head dBᵀ = dCᵀ·A over
   152,064 x 4,096), for q/o, k/v, gate/up, down and the lm_head; kept
   as the GEMM row's ``train_bwd_path``.  (b) qwen2-0.5b at full width
   cut to 2 layers, 1 x 128 tokens, the same seeded weights on the card
   and on the CPU: the loss within 1e-3 relative and every gradient leaf
   within 5e-2 relative L2 (the limits the CPU tests set at reduced
   width against the reference).  (c) The Trainer at full width and
   depth (24 layers, random bf16 weights from ``--seed``, AdamW,
   ``remat="none"``, 8 x 512 tokens a step, 20 steps, lr 3e-3 with 10
   warm-up steps, a checkpoint every 10): the loss per step (it must
   fall), the median step, tokens/s, model FLOPs a step and their bound
   at 989 TFLOP/s, the peak memory (the autograd Function raises
   rather than give a bf16 product to the scalar kernel); then one step
   from the step-19
   checkpoint under the profiler: device busy share, device ms of the
   forward GEMMs, the backward GEMMs and the rest, and the launches, 169
   forward (7 a layer and the lm_head) and 338 backward, asserted; and
   one layer's chunked attention forward and backward at that shape,
   CUDA events, beside SDPA's on the same inputs (a yardstick).  (d)
   A run that fails after step 12, and a fresh Trainer on its directory
   resuming from the step-9 checkpoint: its losses for steps 10-19
   against (c)'s, the largest difference and whether they are bit for
   bit equal.  (e) One step with ``remat="full"`` (peak memory beside
   (c)'s, loss within 1e-3 of (c)'s first), three Adafactor steps and
   three AdamW steps with gradient compression, every loss finite.
16. Training of the MoE family (qwen2-moe-a2.7b); seconds per
   sub-phase.  (a) The router's three products at 4,096 tokens, rows of
   120 bytes on the tensor-core kernel: x·W, dA = dC·Wᵀ (A with lda 60,
   a K-contiguous B with ldb 60) and dB = xᵀ·dC (B with ldb 60), and its
   serving call at 8 tokens, each against its plain version and timed
   beside it, ``torch.matmul`` and the bound (the GEMM row's
   ``moe_train_path``); the grouped forward at training's C = 344; both
   grouped backward kernels (rows ``grouped_gemm_bwd_da`` and
   ``grouped_gemm_bwd_db``) at qwen2-moe's training counts (60 experts,
   C 344, ~273 rows an expert, three at 0) for gate/up and down, at
   decode counts, and at deepseek-v3's 256 experts of 7,168 -> 2,048,
   every row past a count NaN, each against its plain version and timed
   beside it, ``torch.bmm`` over the whole buffers with those rows
   zeroed, and the bound.  (b) qwen2-moe-a2.7b at full width cut to 1
   layer, 1 x 512 tokens, the same seeded weights on the card and on the
   CPU: both sides' expert sets recorded (the CPU's on its own inputs
   and on the card's router inputs), at least 0.97 alike; then, with the
   CPU run following the card's expert choices, the loss within 1e-3
   relative and every gradient leaf within 5e-2 relative L2.  (c) The
   Trainer
   at full width cut to 4 layers (~2.9 G values, ~35 GB of weights,
   gradients and AdamW moments), AdamW, ``remat="none"``, 8 x 512
   tokens, 20 steps (no checkpoint: the CPU tests hold the MoE tree's
   round trip), then one profiled step from a fresh state: the losses
   (they must fall), the median step, tokens/s, the model-FLOP share of
   989 TFLOP/s, peak memory, the busy share, launches and device ms
   split into 2-D forward, 2-D backward, grouped forward and grouped
   backward; no ``gemm_simt`` kernel, and no ``aten::bmm`` / ``mm`` /
   ``matmul`` inside an expert product.
17. Training of the MLA family (deepseek-v3-671b); seconds per
   sub-phase.  (a) The streaming GEMM at the products the MLA path
   adds, M = 4,096 tokens: the forward x·W, dA = dC·Wᵀ and dB = xᵀ·dC
   of ``wdq``, ``wuq``, ``wdkv``, ``wkr`` (N = 64), ``wuk`` / ``wuv``,
   ``wo``, the MTP head's ``proj`` and the untied lm_head (7,168 x
   129,280), each against its plain version within BF16_TOL, timed
   beside the plain version, ``torch.matmul`` and the bound (the GEMM
   row's ``mla_train_path``).  (b) deepseek-v3-671b at full width cut
   to 1 layer (one dense MLA layer and the MTP head), 1 x 128 tokens,
   the same seeded weights on the card and on the CPU: ce, mtp and the
   loss within 1e-3 relative, every gradient leaf of the reference's
   tree within 5e-2 relative L2, the CPU's seconds.  (c) The Trainer on
   ``deepseek-v3-671b-3l`` (the 3 dense layers and the MTP head at full
   width, ~2,880.8 M values), random bf16 weights from ``--seed``,
   AdamW (lr 3e-5), ``remat="full"``, 8 x 512 tokens, 20 steps: ce and
   mtp per step (both must fall), the median step, tokens/s, the model
   FLOP share of 989 TFLOP/s, peak memory (below 80 GB); then one step
   more under the profiler: device ms of the streaming GEMM (forward;
   backward with remat's recompute), the attention's torch ops (between
   marker kernels), the optimizer and the rest, the busy share, the
   GEMM's launches (43 forward products a pass, 30 more recomputed by
   remat, 86 backward; asserted); the
   absorbed copies equal to the permuted trained ``wuk`` / ``wuv`` bit
   for bit, and no derived key in the AdamW state.
18. Training of the ssm, hybrid and audio families (rwkv6-7b, zamba2-7b,
   whisper-tiny); seconds per sub-phase.  (a) The streaming GEMM at the
   products these paths add, M = 4,096 tokens: the forward x·W, dA =
   dC·Wᵀ and dB = xᵀ·dC of rwkv6's 4,096 x 4,096 (time r, k, v, g, w,
   o; channel r), 4,096 x 14,336, 14,336 x 4,096 and lm_head 4,096 x
   65,536, zamba2's ``in_proj`` 3,584 x 14,576, ``out_proj`` 7,168 x
   3,584, shared 3,584 x 3,584 and lm_head 3,584 x 32,000, whisper's
   384 x 1,536 and lm_head 384 x 51,968, each against its plain version
   within BF16_TOL, timed beside the plain version, ``torch.matmul`` and
   the bound (the GEMM row's ``ssm_train_path``, ``hybrid_train_path``,
   ``audio_train_path``).  (b) rwkv6-7b and zamba2-7b (with its shared
   block) cut to 1 layer and whole whisper-tiny, at full width, 1 x 128
   tokens (whisper: 128 frames and 128 tokens), the same seeded weights
   on the card and on the CPU: the loss within 1e-3 relative, every
   gradient leaf within 5e-2 relative L2, the worst leaf printed.  (c)
   20 AdamW steps of 8 x 512 tokens at ``remat="none"``: the Trainer on
   ``rwkv6-7b-10l`` and ``zamba2-7b-7l`` (``configs.*.TRAINING``; lr
   3e-4), ``build_train_step`` on whisper-tiny with the synthetic
   corpus's tokens and labels and (8, 512, 384) frames drawn from
   ``--seed`` (lr 3e-3); for each the losses (they must fall), the
   median step, tokens/s, the model-FLOP share of 989 TFLOP/s
   (``_ssm_train_flops``), the peak memory (below 80 GB); then one step
   more under the profiler: the busy share, device ms of the streaming
   GEMM's forward and backward, the scan's torch ops, the attention's
   torch ops, the optimizer and the rest, and the GEMM's launches (91 /
   44 / 65 forward, twice as many backward) and no ``gemm_simt``,
   asserted.  (d) ``rwkv6-7b-10l`` from fresh weights, one forward and
   backward pass each under ``remat`` none, full and dots, after a
   warm-up pass: the loss (within 1e-3 of none's; bit for bit or
   not), the gradients bit for bit or not, peak memory, ms, and the
   GEMM's forward launches during the backward pass, 0 / 90 / 0,
   asserted.
19. The mesh (``launch.mesh``, ``launch.steps``): a one-rank NCCL mesh
   (``make_host_mesh(1, 1)``; NCCL cannot put two ranks on one card, so
   multi-rank meshes are held on the CPU through gloo by
   ``tests/test_torch_mesh.py``).  A batch split over one rank runs no
   collective.  (a) qwen2-0.5b at full width and depth, 10 AdamW steps
   of 8 x 512 tokens, 15c's seed and learning rate, by a ``Trainer`` on
   the mesh (through the tensor-parallel step, whose ``model`` of one
   rank splits nothing: ``tensor_parallel`` 1, no collective) and then
   one with no mesh (the local one-rank layout, no process group): the
   mesh's losses equal the local ones bit for bit;
   each run's median step, peak memory, and one step more under the
   profiler (device ms; the collective calls on the host and the NCCL
   kernels, none in either run).  (b)
   ``compressed_psum`` over the mesh's ``data`` axis on the tied
   embedding's gradient (152,064 x 896, from one step of the model):
   equal bit for bit to its codes times its scale; its median ms (an
   axis of one rank: the int8 codes and the scale, no all-reduce).  (c)
   ``build_prefill_step`` / ``build_decode_step`` on the mesh: 8 slots,
   256-token prompts from ``--seed``, 16 greedy steps; the tokens equal
   ``Model.prefill`` / ``decode_step``'s on the card; the GEMM, flash
   and paged launches of the mesh steps go into the ``kernels`` line as
   their own path.  (d) The production plans' per-rank bytes of bf16
   weights plus AdamW state for every arch id at full width, on (16, 16)
   and (2, 16, 16): host arithmetic over the placements, a plan.
20. The dry run and the roofline on the card (``launch.hlo_analysis``,
   ``launch.roofline``, ``launch.dryrun``); seconds per sub-phase.
   ``roofline.HBM_BYTES`` must be the card's ``total_memory``.  (a)
   15c's qwen2-0.5b train step (24 layers, 8 x 512 tokens, AdamW,
   ``remat="none"``), an 8 x 256-token prefill and one decode step over
   phase 3's serving geometry (8 slots of 1,024 tokens, 16-token pages),
   built by ``launch.steps`` on the local one-rank layout, each counted
   under ``hlo_analysis.analyze`` on the card and again on ``meta``
   tensors: flops, bytes and the collective fields must be equal, and
   each wrapper's op count its ``LAUNCHES`` increment (the GEMM in all
   three, flash in the prefill, paged attention in the decode).  (b)
   Each step's roofline terms (``compute_s``, ``memory_s``,
   ``step_time_s``, ``bottleneck``, ``useful_ratio``) beside the median
   of 5 timed steps (CUDA events, after a warm-up, not under the
   counter) and their ratio; ``model_flops_for`` beside 15c's
   ``_train_flops``.  (c) The train step's ``peak_bytes`` on ``meta``
   against ``torch.cuda.max_memory_allocated()`` over one card step
   from the same state (the arguments' bytes added to the rise): within
   10%.  (d) ``dryrun.run_cell`` at full width on the production plans
   for ``qwen2-0.5b.train_4k`` on (16, 16) and ``qwen2-moe-a2.7b
   .train_4k`` on (2, 16, 16) (``DRY_CELLS``), each by the dry run's CLI
   in a process of its own started beside phase 1's build (host work
   that needs no card, ~25 s each): each record's roofline and its
   seconds; the qwen2-0.5b cell runs tensor-parallel (its MLP and
   vocabulary split over ``model``'s 16, ``tensor_parallel`` 16,
   asserted; ``DRY_TP``).
21. Tensor parallelism on one card (``sharding.tensor_parallel``): two
   spawned processes on a (1, 2) mesh of gloo ranks sharing the card
   (``make_host_mesh(..., backend="gloo")``: NCCL cannot put two ranks
   on one card; gloo stages each all-reduce of CUDA tensors through the
   host).  qwen2-0.5b at full width and depth, every split leaf's heads,
   columns or vocabulary halved (H 14, KH 2, f 4,864, V 152,064), 5
   AdamW steps of 8 x 512 tokens from 15c's seed and learning rate: the
   losses equal on both ranks and within 1e-3 relative of the one-rank
   step's on the same weights and batches (run first, in this
   process); every forward product of the first step reads its leaf at
   half N (q, k, v, gate, up, the tied lm_head's ``embed`` block) or
   half K (both ``wo``), asserted, with the (M, N, K) of the forward
   and backward products; the GEMM's launches (169 forward and 338
   backward a step); the all-reduces a step (101, asserted); each
   rank's peak memory (both below 80 GB together); each rank's median
   step ms, staged through the host by gloo and no tensor-parallel speed
   figure.  Then one step more, rank 0's under the profiler with each
   GEMM product in a range of its own: no device kernel named
   ``gemm_simt``, and no library GEMM op (``aten::mm``, ``bmm`` and the
   like) dispatched inside a product's range, asserted (the attention's
   torch ops run their own library GEMMs, outside those ranges).  Its
   GEMM launches join the ``kernels`` line as ``tp_train_launches``.
22. Tensor parallelism of the moe family on one card (``models/moe.py``,
   MLA in ``models/layers.py``), on 21's machinery.  (k) The grouped
   forward, dA and dB at a rank's shapes (``TPM_GROUPED``: qwen2-moe's
   (1, 2) expert split, 30 experts at C 344, 2,048 <-> 1,408; the
   (16, 16) plan's column split, 60 experts, 2,048 <-> 88; deepseek-v3's
   (16, 16) expert split, 16 experts, 7,168 <-> 2,048), each against its
   plain version and beside ``torch.bmm`` and its bound; 21's 2-D
   products at qwen2-0.5b's (1, 2) widths (q 448, gate / up 2,432, o
   and down at K / 2), forward, dA and dB at M = 4,096.  Then two runs
   of 4 AdamW steps of 8 x 512 tokens on the (1, 2) gloo mesh against
   one rank on the same weights and batches: (a) qwen2-moe-a2.7b at 16c's
   4 layers and full width (the expert split, 30 of 60 experts a rank;
   8 of 16 heads, the shared expert's columns and the vocabulary
   halved), (b) deepseek-v3-671b-3l, 17c's run (3 dense MLA layers and
   the MTP block, ``remat="full"``; 64 of 128 heads, 1,024 of 2,048
   MLP columns, 64,640 vocabulary columns).  A route (a token's k
   experts) is a top-k over bf16 logits, and the split rounds a layer's
   output apart from one rank, so (a) is held against the one-rank step
   forced to the ranks' routes each step and layer
   (``_tpm_forced_route``), whose losses must be within 1e-3 relative
   every step, and against one rank on its own routes within 1e-3 on
   the two steps that run on the first weights (``TPM_FREE_STEPS``); the
   tokens whose own route differs are counted a step and layer.  (b)
   has no MoE layer and is held within 1e-4 relative every step.  Each
   run, asserted: both ranks' losses and routes equal; every forward
   product of the first step at its local width, the grouped ones too;
   the GEMM's and the grouped kernels' launches a step; the all-reduces
   and all-gathers a step (each collective records itself through
   ``hlo_analysis.collective``); both peaks together below 80 GB.  Rank
   0 of (a) takes one step more under the profiler: no ``gemm_simt``
   kernel and no library GEMM op inside a product's range.  Both
   runs' lines print before any of these checks.
23. Tensor parallelism of the ssm, hybrid and audio families on one card
   (``models/ssm.py``; the attention and MLPs of ``models/layers.py``),
   on 21's machinery: three runs of 3 AdamW steps of 8 x 512 tokens on
   the (1, 2) gloo mesh against one rank on the same weights and
   batches (run first, in this process): (a) rwkv6-7b at full width
   cut to 4 layers (32 of 64 heads, 2,048 of the time mix's 4,096
   columns, 7,168 of d_ff 14,336, 32,768 vocabulary rows a rank), (b)
   ``zamba2-7b-7l``, 18c's config (56 of 112 Mamba2 heads, 7,288 of
   ``in_proj``'s 14,576 columns, 16 of the shared block's 32 heads,
   run twice), (c) whisper-tiny whole through ``build_train_step`` with
   (8, 512, 384) frames from the seed (3 of 6 heads, 768 MLP columns,
   25,984 vocabulary rows a rank); 18c's learning rates.  Each run,
   asserted: both ranks' losses equal and within 1e-3 relative of one
   rank's every step; every forward product of the first step at its
   local width; the GEMM's launches a step; the all-reduces and
   all-gathers a step (``_tps_counts``); both peaks together below 80
   GB; one step more, rank 0's under the profiler: no ``gemm_simt``
   kernel and no library GEMM op inside a product's range.  The lines
   print before the checks; each run's launches are a path of its own
   in the ``kernels`` line.  First (k), zamba2-7b's ``in_proj`` block on
   the (16, 16) plan (3,584 x 911, bf16 rows of odd length) at M = 4,096
   through the streaming GEMM's Function, its B and dC read through
   copies in padded rows: forward, dA and dB on the tensor-core kernel
   within 2e-2 of the fp32 product.
24. Print each phase's seconds (a ``[phases]`` line), the ``kernels``
   JSON line (20a's counted steps among the paths; each kernel's
   launches from its own
   path's serving run, the int8 kernels' from phase 8e's (the int8
   kernel's under both its counters), the grouped
   backward kernels' from 16c's profiled step, every path's counts
   beside, the GEMM's forward and backward launches of a training step
   as ``train_launches``, of 17c's as ``mla_train_launches``, of 18c's
   as ``ssm_train_launches``, ``hybrid_train_launches`` and
   ``audio_train_launches``, of 21's rank 0 as ``tp_train_launches``,
   of 22's as ``tp_moe_train_launches``, of 23's as
   ``tp_ssm_train_launches``; 22's and 23's runs are paths of their own,
   the grouped backward kernels' launches among them), the
   card line, and last the result line
   ``{"ok": true, "device": {...}}``.
"""
import argparse
import atexit
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.launch import roofline as RL  # noqa: E402

# the H100 80GB HBM3's datasheet peaks at 700 W (one place: the roofline)
HBM_BYTES_PER_S = RL.HBM_BW
BF16_FLOP_PER_S = RL.PEAK_FLOPS_BF16
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
# the MoE decode step's 2-D GEMM device ms on an H100 while the router
# ran on the scalar kernel (PERF.md, PR 15): 7c prints its own beside it
MOE_DECODE_GEMM_MS_SCALAR = 6.613
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
QUANT_KEYS = ("ms", "plain_ms", "bound_ms")


def int8_pools(torch, randn, P, page, KH, D):
    """int8 K and V pools (P, page, KH, D) with their (P, KH, page) fp16
    scale pools, quantized from seeded bf16 values by the plain
    version."""
    from repro_torch.kernels import ref
    out = []
    for _ in range(2):
        codes, scales = ref.kv_quantize_ref(randn(P, page, KH, D))
        out.append((codes, scales.permute(0, 2, 1).contiguous()))
    return out[0][0], out[1][0], out[0][1], out[1][1]


def _int8_plan(q, kp, table):
    """``int8_plan`` of an int8 call's shapes, as a dict."""
    import importlib
    PA = importlib.import_module("repro_torch.kernels.paged_attention")
    n, H, D = q.shape
    return PA.int8_plan(n, H, kp.shape[2], D, table.shape[1],
                        kp.shape[1])._asdict()


def _int8_bound(q, kp, table, ln, append=False):
    """The int8 kernel's bound: q and the output once, the table and
    lengths, each cached token's K and V codes and fp16 scales once; with
    the append also the step's bf16 K and V rows and their int64 rows."""
    n, H, D = q.shape
    KH = kp.shape[2]
    n_tok = int(ln.sum())
    nbytes = 2 * 2 * n * H * D + 4 * n * (table.shape[1] + 1) \
        + 2 * n_tok * KH * (D + 2)
    if append:
        nbytes += 2 * 2 * n * KH * D + 8 * n
    return bound(nbytes, 4 * H * D * n_tok)


def _int8_sdpa(torch, q, kp, vp, ks, vs, table, ln):
    """SDPA over a contiguous dequantized copy of the int8 pools' K/V
    with a length mask: the yardstick (no PyTorch call reads int8 pools
    with scales; the port never calls it)."""
    import torch.nn.functional as F
    n, H, D = q.shape
    P, page, KH, _ = kp.shape
    max_pages = table.shape[1]
    t = table.long()

    def deq(pool, sc):
        return (pool[t].float() * sc[t].permute(0, 1, 3, 2)[..., None]
                .float()).to(torch.bfloat16) \
            .reshape(n, max_pages * page, KH, D).transpose(1, 2).contiguous()

    kc, vc = deq(kp, ks), deq(vp, vs)
    mask = (torch.arange(max_pages * page, device=q.device)[None]
            < ln[:, None])[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(
        q[:, :, None, :], kc, vc, attn_mask=mask, enable_gqa=True)


def paged_int8_entry(torch, timer, what, q, kp, vp, ks, vs, table, ln,
                     on_path, timed=True):
    """The int8 kernel (``paged_int8_fwd`` through ``pa_forward_int8``)
    at one shape against its plain version (BF16_TOL), and, when
    ``timed``, the kernel, the plain version, SDPA over a contiguous
    dequantized copy of the same K/V and the bound (``_int8_bound``)."""
    from repro_torch.kernels import ops, ref
    n, H, D = q.shape
    P, page, KH, _ = kp.shape

    def kernel():
        return ops.paged_attention(q, kp, vp, table, ln, ks, vs)

    def plain():
        return ref.paged_ref(q, kp, vp, table, ln, k_scale=ks, v_scale=vs)

    err = check_close(f"paged int8 {what}", kernel(), plain(), BF16_TOL)
    plan = _int8_plan(q, kp, table)
    r = {"shape": {"q": [n, H, D], "pool": [P, page, KH, D],
                   "lens": ln.tolist()}, "what": what, "on_path": on_path,
         "entry": "pa_forward_int8", "plan": plan["splits"],
         "head_groups": plan["groups"], "int8_plan": plan,
         "max_abs_err": err}
    msg = ""
    if timed:
        bms, by = _int8_bound(q, kp, table, ln)
        r.update({"ms": timer(kernel), "plain_ms": timer(plain),
                  "contiguous_sdpa_ms": timer(_int8_sdpa(
                      torch, q, kp, vp, ks, vs, table, ln)),
                  "bound_ms": bms, "bound_by": by})
        msg = (f" kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms "
               f"dequantized contiguous SDPA {r['contiguous_sdpa_ms']:.4f} "
               f"ms bound {bms:.4f} ms ({by})")
    print(f"[paged_attention_int8] {what} H={H}/{KH} D={D} (plan {plan}, "
          f"on_path {on_path}): err {err:.3g} (tol {BF16_TOL}){msg}",
          flush=True)
    return r


def paged_append_entry(torch, timer, what, q, pools, table, ln, k, v, rows,
                       on_path):
    """The decode step's fused launch (``ops.paged_attention_append``:
    the int8 kernel through ``pa_append_forward_int8``) at one shape: the
    codes and scales it writes equal its plain version's bit for bit
    (``kv_quantize_append_ref``, then ``paged_ref``), its output within
    BF16_TOL; then timed beside the plain version, the two launches it
    replaces (``kv_quantize_append`` and the int8 kernel), SDPA over a
    dequantized copy and the bound (``_int8_bound`` with the append)."""
    from repro_torch.kernels import ops, ref
    n, H, D = q.shape
    P, page, KH, _ = pools[0].shape
    got_pools = [t.clone() for t in pools]
    want = [t.clone() for t in pools]
    got = ops.paged_attention_append(q, k, v, rows, got_pools, table, ln)
    ref.kv_quantize_append_ref(k, v, rows, *want)
    torch.cuda.synchronize()
    bad = [name for name, a, b in zip(("k", "v", "k_scale", "v_scale"),
                                      got_pools, want)
           if not torch.equal(a, b)]
    require(not bad, f"paged append {what}: {bad} differ from the plain "
            "version")

    def plain():
        ref.kv_quantize_append_ref(k, v, rows, *want)
        return ref.paged_ref(q, want[0], want[1], table, ln,
                             k_scale=want[2], v_scale=want[3])

    err = check_close(f"paged append {what}", got, plain(), BF16_TOL)
    plan = _int8_plan(q, pools[0], table)
    bms, by = _int8_bound(q, pools[0], table, ln, append=True)

    def unfused():
        ops.kv_quantize_append(k, v, rows, *got_pools)
        return ops.paged_attention(q, got_pools[0], got_pools[1], table, ln,
                                   got_pools[2], got_pools[3])

    r = {"shape": {"q": [n, H, D], "pool": [P, page, KH, D],
                   "lens": ln.tolist()}, "what": what, "on_path": on_path,
         "entry": "pa_append_forward_int8", "plan": plan["splits"],
         "head_groups": plan["groups"], "int8_plan": plan,
         "bitwise_pools": True, "max_abs_err": err,
         "ms": timer(lambda: ops.paged_attention_append(
             q, k, v, rows, got_pools, table, ln)),
         "plain_ms": timer(plain),
         "quantize_then_paged_ms": timer(unfused),
         "contiguous_sdpa_ms": timer(_int8_sdpa(torch, q, *got_pools[:2],
                                                *got_pools[2:], table, ln)),
         "bound_ms": bms, "bound_by": by}
    print(f"[paged_attention_int8_append] {what} H={H}/{KH} D={D} (plan "
          f"{plan}, on_path {on_path}): pools bitwise, err {err:.3g} (tol "
          f"{BF16_TOL}) fused {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms "
          f"quantize + paged {r['quantize_then_paged_ms']:.4f} ms "
          f"dequantized contiguous SDPA {r['contiguous_sdpa_ms']:.4f} ms "
          f"bound {bms:.4f} ms ({by})", flush=True)
    return r


def kv_quant_entry(torch, timer, what, n, KH, D, on_path, randn, g):
    """The quantize-and-append kernel for ``n`` tokens of KH heads of D
    into 16-token pages at seeded rows: codes and scales equal to its
    plain version's bit for bit, then timed beside the plain version and
    its bound (each bf16 value read once, each code and fp16 scale
    written once, the rows read once)."""
    from repro_torch.kernels import ops, ref
    page = 16
    P = -(-n // page) * 2 + 8
    dev = g.device
    rows = torch.randperm(P * page, generator=g, device=dev)[:n]
    k, v = randn(n, KH, D, scale=3.0), randn(n, KH, D)
    pools = [torch.zeros((P, page, KH, D), dtype=torch.int8, device=dev)
             for _ in range(2)]
    pools += [torch.zeros((P, KH, page), dtype=torch.float16, device=dev)
              for _ in range(2)]
    want = [t.clone() for t in pools]
    ops.kv_quantize_append(k, v, rows, *pools)
    ref.kv_quantize_append_ref(k, v, rows, *want)
    torch.cuda.synchronize()
    bad = [name for name, a, b in zip(("k", "v", "k_scale", "v_scale"),
                                      pools, want) if not torch.equal(a, b)]
    require(not bad, f"kv_quantize {what}: {bad} differ from the plain "
            "version")
    # about 4 fp32 operations a value (|x| and the max, the quotient,
    # the rounding), on the CUDA cores
    bms, by = bound(2 * n * KH * D * 2 + 8 * n + 2 * n * KH * (D + 2),
                    4 * 2 * n * KH * D, FP32_FLOP_PER_S)
    r = {"shape": [n, KH, D], "what": what, "on_path": on_path,
         "bitwise": True, "max_abs_err": 0.0,
         "ms": timer(lambda: ops.kv_quantize_append(k, v, rows, *pools)),
         "plain_ms": timer(lambda: ref.kv_quantize_append_ref(
             k, v, rows, *want)),
         "bound_ms": bms, "bound_by": by}
    print(f"[kv_quantize] {what} n={n} KH={KH} D={D} (on_path {on_path}): "
          f"codes and scales bitwise; kernel {r['ms']:.4f} ms plain "
          f"{r['plain_ms']:.4f} ms bound {bms:.4f} ms ({by})", flush=True)
    return r


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
    rows.update(phase_int8_kernels(torch, timer, randn, g))
    return rows


def phase_int8_kernels(torch, timer, randn, g):
    """Phase 2, the INT8 KV cache's two kernels.  The int8 kernel
    (``paged_int8_fwd``) at qwen2-0.5b's (14 / 2 heads of 64) and
    qwen1.5-32b's (40 / 40 heads of 128) 8 x 272 and mixed 64-1,024
    shapes, timed beside the bf16 kernel at the same shapes (``bf16_ms``);
    granite-20b's query-head groups (48 / 1 heads of 128), whisper's D 64
    (6 / 6 heads) and lens 0 untimed; then the decode step's fused
    launch (``paged_append_entry``) at qwen1.5-32b's 8 x 272 (on the
    int8 path: the decode profile's context) and qwen2-0.5b's.  The
    quantize-and-append kernel bitwise at qwen1.5-32b's 256-token prefill
    rows (on the path) and its decode rows and qwen2-0.5b's (off it since
    the fused launch), timed."""
    from repro_torch.kernels import ops
    dev = g.device
    B, page, max_pages = 8, 16, 64
    P = B * max_pages + 16
    table = torch.randperm(P, generator=g, device=dev)[:B * max_pages] \
        .reshape(B, max_pages).to(torch.int32)
    mixed = torch.randint(64, 1025, (B,), generator=g, device=dev) \
        .to(torch.int32)
    mixed[0] = 1024
    fixed = torch.full((B,), 272, dtype=torch.int32, device=dev)
    edge = torch.tensor([0, 1, page, page * max_pages, 0, 17, 272, 1000],
                        dtype=torch.int32, device=dev)
    per_shape, untimed, kept = [], [], {}
    for arch, H, KH, D, timed in (("qwen2-0.5b", 14, 2, 64, True),
                                  ("qwen1.5-32b", 40, 40, 128, True),
                                  ("granite-20b", 48, 1, 128, False),
                                  ("whisper-tiny", 6, 6, 64, False)):
        q = randn(B, H, D)
        kp, vp, ks, vs = int8_pools(torch, randn, P, page, KH, D)
        cases = ((("8 x 272", fixed), ("mixed 64-1024", mixed)) if timed
                 else (("8 x 272", fixed), ("edge", edge)))
        for what, ln in cases:
            r = paged_int8_entry(
                torch, timer, f"{arch} {what}", q, kp, vp, ks, vs, table, ln,
                False, timed)
            (per_shape if timed else untimed).append(r)
        if timed:
            r = paged_int8_entry(torch, timer, f"{arch} lens 0", q, kp, vp,
                                 ks, vs, table, torch.zeros_like(fixed),
                                 False, False)
            untimed.append(r)
            kept[arch] = (H, KH, D, q, (kp, vp, ks, vs))
    # the bf16 kernel at the timed shapes (new bf16 pools of the same
    # shape), then the fused append: each sequence's next position
    for arch, (H, KH, D, q, pools) in kept.items():
        kb, vb = randn(P, page, KH, D), randn(P, page, KH, D)
        for r, ln in zip((r for r in per_shape
                          if r["what"].startswith(arch + " ")),
                         (fixed, mixed)):
            r["bf16_ms"] = timer(lambda: ops.paged_attention(
                q, kb, vb, table, ln))
            print(f"[paged_attention_int8] {r['what']}: bf16 kernel "
                  f"{r['bf16_ms']:.4f} ms at the same shape, int8 "
                  f"{r['ms']:.4f} ms", flush=True)
        k, v = randn(B, KH, D, scale=3.0), randn(B, KH, D)
        pos = fixed.long() - 1
        rows_ = table.long()[torch.arange(B, device=dev), pos // page] \
            * page + pos % page
        per_shape.append(paged_append_entry(
            torch, timer, f"{arch} 8 x 272", q, pools, table, fixed, k, v,
            rows_, arch == "qwen1.5-32b"))
    rows = {"paged_attention_int8": {
        "route": "cuda", "kernel": "paged_int8_fwd",
        "source": "src/repro_torch/kernels/csrc/paged_int8.cu",
        "replaces": "src/repro/kernels/paged_attention.py:34",
        "reference_int8_decode": "src/repro/models/layers.py:148",
        "entries": ["pa_forward_int8", "pa_append_forward_int8"],
        "tol": BF16_TOL,
        "max_abs_err": max(r["max_abs_err"] for r in per_shape + untimed),
        **summary(per_shape, PAGED_KEYS),
        "library_ms": None, "per_shape": per_shape, "untimed": untimed}}
    per_shape = [kv_quant_entry(torch, timer, what, n, KH, D, on_path,
                                randn, g)
                 for what, n, KH, D, on_path in (
                     ("qwen1.5-32b decode", 8, 40, 128, False),
                     ("qwen1.5-32b prefill 256", 256, 40, 128, True),
                     ("qwen2-0.5b decode", 8, 2, 64, False))]
    rows["kv_quantize"] = {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/kv_quant.cu",
        "replaces": "src/repro/models/layers.py:264",
        "note": "no Pallas original: the reference quantizes in XLA",
        "tol": 0.0, "max_abs_err": 0.0,
        **summary(per_shape, QUANT_KEYS), "library_ms": None,
        "per_shape": per_shape}
    return rows


def phase_serving(torch, args, cfg, params, kernels, new_tokens=32,
                  tag="serving", n_requests=16, prompt_max=512,
                  pool_pages=None, absent=(), max_seq=1024,
                  prompt_lens=None, tuning=None):
    """Serve ``n_requests`` requests of 64-``prompt_max`` prompt tokens
    (or of ``prompt_lens``) and ``new_tokens`` new tokens each on 8 slots
    of 16-token pages (``max_seq`` tokens a slot; a pool of
    ``pool_pages`` pages, by default room for every slot's ``max_seq``;
    an ssm model's state store instead, a hybrid model's beside it),
    after an untimed warm-up request; the engines are built under
    ``tuning`` (the INT8 KV cache's pool is made then).  The launch
    counts are zeroed just before and read just after; each of
    ``kernels`` must have run, and none of ``absent``."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.models import tuning as TU
    from repro_torch.serving.engine import Request, ServingEngine

    def engine():
        with TU.tuning_context(tuning or TU.get()):
            return ServingEngine(cfg, params, slots=8, max_seq=max_seq,
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
        c = eng.cache
        pools = [p for p in (c.k_pages, c.v_pages, c.k_scale, c.v_scale)
                 if p is not None]
        store = {"kv_pool_mb": sum(p.numel() * p.element_size()
                                   for p in pools) / 1e6,
                 "kv_pool_pages": c.cfg.n_pages,
                 "kv_pool_dtype": str(c.k_pages.dtype)}
    states = eng.cache if cfg.family == "ssm" else eng.cache.state
    if states is not None:
        store["state_mb"] = states.nbytes / 1e6
    reqs = []
    for i in range(n_requests if prompt_lens is None else len(prompt_lens)):
        n = int(rng.integers(64, prompt_max + 1)) if prompt_lens is None \
            else prompt_lens[i]
        reqs.append(Request(uid=i, prompt=rng.integers(
            1, cfg.vocab_size - 1, n).astype(np.int32),
            max_new_tokens=new_tokens))
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
    res = {"model": cfg.name, "requests": len(reqs),
           "prompt_tokens": [len(r.prompt) for r in reqs],
           "max_seq": max_seq, "tokens_out": tokens,
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
                      tag="card_vs_cpu", tuning=None):
    """One request, a 64-token prefill and 4 decode steps, on the card and
    on the CPU (every wrapper's plain version), logits within E2E_TOL x
    max(1, max|logit|); with ``n_layers``, only the first ``n_layers``
    layers (full width); both caches are made under ``tuning``.  For a
    config that takes embeddings, also a prefill from 256 seeded bf16
    embeddings, held the same way; for an ssm or hybrid model, each
    layer's final scan state, held the same way."""
    import dataclasses

    import numpy as np
    from repro_torch.models import tuning as TU
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
        with TU.tuning_context(tuning or TU.get()):
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
    if tuning is not None:
        res["tuning"] = repr(tuning)
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


def phase_profile(torch, args, cfg, params, n_steps=5, tag="decode_profile",
                  one_kernel=("streaming_gemm", "paged_attention"),
                  tries=3, pool_pages=None, prompt_len=256, max_seq=1024,
                  tuning=None):
    """Where a full-batch decode step's time goes: ``profile_steps`` over
    the engine's decode steps of 8 slots (prompts of ``prompt_len``
    tokens; the engine built under ``tuning``)."""
    import numpy as np
    from repro_torch.models import tuning as TU
    from repro_torch.serving.engine import Request, ServingEngine

    rng = np.random.default_rng(args.seed + 2)
    with TU.tuning_context(tuning or TU.get()):
        eng = ServingEngine(cfg, params, slots=8, max_seq=max_seq,
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
    times here; the wall time comes from the unprofiled steps, and the
    kernel counts from one more step whose wrapper calls are captured
    into CUDA graphs (``kernel_nodes.step_calls``): each wrapper of
    ``one_kernel`` must make exactly one device kernel per call, and
    every node a wrapper call captures must be a kernel of that wrapper,
    by its name (no memset, copy or library kernel).  A window that
    recorded no device kernel is
    profiled again, up to ``tries`` windows.  The host's
    ``aten::index_put_`` calls a step (the KV scatter into a float pool)
    are counted from the same window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import kernel_nodes as KN
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
        index_put = 0
        for ev in prof.key_averages():
            if ev.device_type != DeviceType.CUDA:  # host ops double-count
                if ev.key == "aten::index_put_":
                    index_put += ev.count
                continue
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = getattr(ev, "self_cuda_time_total", 0)
            if us > 0:
                g = KN.kernel_group(ev.key)
                groups[g] = groups.get(g, 0.0) + us / 1e3 / n_steps
                kernels[g] = kernels.get(g, 0) + ev.count / n_steps
        if groups:
            break
        print(f"[{tag}] window {window}: the profiler recorded no device "
              "kernel", flush=True)
    require(groups, f"{tag}: {tries} profiler windows held no device kernel")
    calls = KN.step_calls(step)
    stray = KN.strays(calls)
    nodes = {k: sum(len(c) for c in calls.get(k, ())) for k in ops.LAUNCHES}
    counted = {k: len(calls.get(k, ())) for k in ops.LAUNCHES}
    busy = sum(groups.values())
    res = {"model": model, "slots": 8,
           "context": f"{context}-{context + (1 + window) * n_steps + 1}",
           "steps": n_steps, "windows": window,
           "wall_ms_per_step": wall_ms, "device_ms_per_step": groups,
           "device_busy_share": busy / wall_ms,
           "launches_per_step": per_step,
           "graph_kernel_nodes_per_step": nodes,
           "graph_stray_nodes": len(stray),
           "profiler_kernels_per_step": kernels,
           "profiler_kernels_total_per_step": sum(kernels.values()),
           "aten_index_put_per_step": index_put / n_steps,
           "peak_mem_gb": peak_gb}
    print(f"[{tag}] " + json.dumps(res), flush=True)
    # one device kernel per wrapper call, counted from the graphs: no
    # hidden second pass, and no launch lost by a profiler window
    for name in one_kernel:
        if not nodes[name] == counted[name] == per_step[name]:
            raise AssertionError(
                f"{name}: {nodes[name]} device kernels in a step for "
                f"{counted[name]} wrapper launches ({per_step[name]} a "
                "profiled step)")
    require(not stray, f"{tag}: wrapper calls captured nodes that are not "
            f"their own kernel: {stray[:4]}")
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

    # ---- the 2-D GEMM: q/k/v/o (2,048 x 2,048), the router (2,048 x 60:
    # rows of 120 bytes, staged in 8-byte copies on the tensor cores), the
    # shared experts (2,048 x 5,632, 5,632 x 2,048) at decode and prefill,
    # the untied lm_head at decode
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
    gemm_ms = res["decode_profile"]["device_ms_per_step"].get(
        "streaming_gemm", 0.0)
    print(f"[moe_router] decode step 2-D GEMM device ms {gemm_ms:.4f} with "
          f"the router on the tensor cores; {MOE_DECODE_GEMM_MS_SCALAR} "
          "with it on the scalar kernel (PERF.md, PR 15)", flush=True)
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


def kv_pool_pages(torch, cfg, slots=8, max_seq=1024, page_tokens=16,
                  int8=False):
    """The serving phases' KV pool in pages: what the card's free memory
    holds after the weights (``mem_get_info`` and the allocator's cached
    free bytes) less ``POOL_MARGIN_BYTES``, at most every slot's
    ``max_seq`` tokens.  Every dense variant but qwen1.5-32b (70.4 GB of
    weights) gets that cap.  A page's bytes are the cache's own
    (``PagedCacheConfig.page_bytes``: an ``int8`` page, the INT8 KV
    cache's, counts its fp16 scales)."""
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info()
    free += torch.cuda.memory_reserved() - torch.cuda.memory_allocated()
    from repro_torch.models.transformer import kv_geometry, kv_layers
    from repro_torch.serving.kv_cache import PagedCacheConfig
    heads, hd = kv_geometry(cfg)
    pools = 1 if cfg.mla else 2         # MLA: one latent pool, no V pool
    page_bytes = pools * kv_layers(cfg) * PagedCacheConfig(
        1, page_tokens, heads, hd, 1,
        dtype="int8" if int8 else "bfloat16").page_bytes
    cap = slots * -(-max_seq // page_tokens)
    pages = min(cap, (free - POOL_MARGIN_BYTES) // page_bytes)
    print(f"[{cfg.name}] KV pool{' (int8)' if int8 else ''}: {pages} "
          f"pages of {page_tokens} tokens "
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
        if arch == INT8_ARCH:
            res["int8"] = phase_int8_serving(torch, args, cfg, params)
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


# the INT8 KV cache's run: qwen1.5-32b after its bf16 run, weights kept
INT8_ARCH = "qwen1.5-32b"
INT8_KERNELS = ("streaming_gemm", "flash_attention",
                "paged_attention_int8_append", "kv_quantize")
INT8_MAX_SEQ = 2048
# six prompts of 64-256 tokens and two of 1,536, which the bf16 pool's
# 1,024-token slots could not hold
INT8_PROMPTS = (64, 100, 150, 200, 256, 180, 1536, 1536)


def phase_int8_serving(torch, args, cfg, params):
    """8e. The INT8 KV cache (``Tuning(kv_cache_quant=True)``) on
    ``INT8_ARCH``, whose weights stay loaded after its bf16 run: the
    bf16 pool freed, an int8 pool sized from the free memory (int8 bytes
    plus the fp16 scales, slots of ``INT8_MAX_SEQ`` tokens); serving the
    ``INT8_PROMPTS`` with 8 new tokens each (the decode step's fused
    launch and the prefill's quantize kernel must run, the bf16 paged
    kernel and the int8 kernel's read-only entry must not); three
    full-batch decode steps profiled (one fused launch a layer, no
    quantize launch and no ``index_put`` left a step; the int8 kernel's
    device ms a step and a call printed); the first 2 layers on the card
    against the CPU under the same tuning."""
    from repro_torch.models import tuning as TU

    quant = TU.Tuning(kv_cache_quant=True)
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    pages = kv_pool_pages(torch, cfg, max_seq=INT8_MAX_SEQ, int8=True)
    res = {"pool_pages": pages}
    res["serving"] = phase_serving(
        torch, args, cfg, params, INT8_KERNELS, new_tokens=8,
        tag=f"{cfg.name} int8 serving", pool_pages=pages,
        absent=("paged_attention", "paged_attention_int8"),
        max_seq=INT8_MAX_SEQ,
        prompt_lens=INT8_PROMPTS, tuning=quant)
    require(res["serving"]["kv_pool_dtype"] == "torch.int8",
            "the int8 run's pool is not int8")
    prof = res["decode_profile"] = phase_profile(
        torch, args, cfg, params, n_steps=3,
        tag=f"{cfg.name} int8 decode_profile", pool_pages=pages,
        max_seq=INT8_MAX_SEQ, tuning=quant,
        one_kernel=("streaming_gemm", "paged_attention_int8_append"))
    per_step = prof["launches_per_step"]
    require(per_step["paged_attention_int8_append"] == cfg.n_layers
            and per_step["kv_quantize"] == per_step["paged_attention"]
            == per_step["paged_attention_int8"] == 0,
            f"{cfg.name} int8: {per_step} a decode step, not one fused "
            "int8 launch a layer and nothing else of attention")
    dms = prof["device_ms_per_step"].get("paged_attention_int8", 0.0)
    res["fused_decode"] = {
        "launches_per_step": per_step["paged_attention_int8_append"],
        "kv_quantize_per_step": per_step["kv_quantize"],
        "device_ms_per_step": dms,
        "device_ms_per_call": dms / cfg.n_layers}
    print(f"[{cfg.name} int8] fused decode: " + json.dumps(
        res["fused_decode"]), flush=True)
    require(prof["aten_index_put_per_step"] == 0,
            f"{cfg.name} int8: {prof['aten_index_put_per_step']} KV "
            "index_put calls a step")
    res["card_vs_cpu"] = phase_card_vs_cpu(
        torch, args, cfg, params, n_layers=2,
        tag=f"{cfg.name} int8 card_vs_cpu", tuning=quant)
    res["seconds"] = time.perf_counter() - t0
    print(f"[{cfg.name} int8] pool {pages} pages "
          f"({res['serving']['kv_pool_mb'] / 1e3:.2f} GB), peak "
          f"{res['serving']['peak_mem_gb']:.2f} GB, {res['seconds']:.1f} s",
          flush=True)
    return res


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


# ------------------------------------------------------------ phase 13
SIM_MODES = ("DM", "DC", "DevMem")
SIM_ARCH = "qwen2-0.5b"
SIM_LAYERS = 1          # the trace's depth (docstring, 13c)
SIM_REQUESTS = 8
SIM_NEW_TOKENS = 8


def host_line():
    """The host CPU the simulator's replay rates were read on: the first
    processor of /proc/cpuinfo, by model name where the machine gives
    one (a VM may say "unknown"), vendor, family, model, stepping and
    clock."""
    import os
    import platform
    info = {}
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            key, sep, val = line.partition(":")
            if not sep:
                if info:
                    break
                continue
            info.setdefault(key.strip(), val.strip())
    except OSError:
        pass
    known = {k: v for k, v in info.items() if v and v.lower() != "unknown"}
    fields = [known.get("model name"), known.get("vendor_id")] + [
        f"{k} {known[k]}" for k in ("cpu family", "model", "stepping")
        if k in known]
    if "cpu MHz" in known:
        fields.append(f"{known['cpu MHz']} MHz")
    name = " ".join(f for f in fields if f) \
        or f"{platform.machine()}, model not identified"
    return f"{name}, {os.cpu_count()} cores"


def _artifact_scenario(SC, sc_json):
    """A ``Scenario`` from the scenario block of a ``BENCH_replay.json``
    row (lists there are tuples in ``Scenario.params``)."""
    def tup(v):
        return tuple(tup(x) for x in v) if isinstance(v, list) else v
    return SC.Scenario(
        model=sc_json["model"], dtype=sc_json["dtype"],
        n_layers=sc_json["n_layers"], sampling=sc_json["sampling"],
        params=SC.as_params(**{k: tup(v)
                               for k, v in sc_json["params"].items()}))


def _sim_replay(card, host):
    """13a: every row of ``BENCH_replay.json`` lowered again and replayed
    in DM, DC and DevMem by both engines: engine parity, the artifact's
    event count, and each mode's ``total_us`` within 1e-9 of it."""
    import dataclasses
    from repro_torch.accesys.pipeline import replay
    from repro_torch.core import scenario as SC

    art = json.loads((Path(__file__).resolve().parent
                      / "BENCH_replay.json").read_text())
    out = {}
    for row, want in art.items():
        if row == "_meta":
            continue
        sc = _artifact_scenario(SC, want["modes"]["DM"]["sim"]["scenario"])
        t = time.perf_counter()
        plan, label, events, total = SC.scenario_plan(sc)
        build_s = time.perf_counter() - t
        require(events == want["events"],
                f"{row}: {events} events, the artifact has {want['events']}")
        res = {"events": events, "build_s": build_s, "modes": {}}
        for mode in SIM_MODES:
            cfg = SC.system_for(dataclasses.replace(sc, mode=mode))
            sims = {}
            for engine in ("compiled", "event"):
                t = time.perf_counter()
                r = replay(cfg, plan, engine=engine)
                wall = time.perf_counter() - t
                sims[engine] = SC.SimResult(
                    scenario=dataclasses.replace(sc, mode=mode,
                                                 engine=engine),
                    label=label, mode=mode, engine=engine, result=r,
                    events_replayed=events, events_total=total,
                    wall_s=wall)
            SC.assert_parity(sims["compiled"], sims["event"])
            got_us = sims["compiled"].total_s * 1e6
            art_us = want["modes"][mode]["sim"]["total_us"]
            require(abs(got_us - art_us) <= 1e-9 * art_us,
                    f"{row} {mode}: total {got_us} us, artifact {art_us}")
            res["modes"][mode] = {
                "total_us": got_us, "artifact_total_us": art_us,
                "compiled_ev_per_s": sims["compiled"].events_per_s,
                "event_ev_per_s": sims["event"].events_per_s}
        out[row] = res
    SC.clear_caches()
    print("[simulator replay] " + json.dumps(
        {"rows": out, "rates_on_host": host, "card": card}), flush=True)
    return out


def _sim_scorecard():
    """13b: the paper-claim scorecard (fast subset); every claim the
    reference's claim tests assert must pass."""
    from repro_torch.accesys import calibration

    claims = calibration.validate(fast=True)
    for c in claims:
        print(f"[simulator scorecard] {c.row()}", flush=True)
    failing = [c.row() for c in claims if not c.ok]
    require(not failing, "scorecard claims missed:\n" + "\n".join(failing))
    require(sum(c.name.startswith("table9") for c in claims) == 6,
            "scorecard lacks a Table 9 row")
    return {"claims": len(claims), "passed": len(claims) - len(failing)}


def _sim_serving(torch, args, card):
    """13c: the card serves and the simulator prices what it served.
    qwen2-0.5b at full width, cut in depth to ``SIM_LAYERS`` layer(s),
    serves ``SIM_REQUESTS`` requests of 64-256 prompt tokens (multiples
    of 64) and ``SIM_NEW_TOKENS`` new tokens through
    ``ServingEngine(record_plans=True)``: launch counts zeroed just
    before and read just after, every dense kernel must run, and the
    trace must hold one record per admission and per decode step.  The
    same requests are then served again without recording, for the
    card's TTFT and decode step (recording builds each plan inside the
    engine loop).  The trace is priced by ``simulate_serving_trace`` in
    DM, DC and DevMem: a model of the paper's MatrixFlow accelerator
    behind PCIe, printed beside the card's figures with no agreement
    asked.  Last, the reduced ``Scenario(model="serve")`` with
    ``device="cuda"`` and again with ``device="cpu"``: equal
    ``SimResult``s."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.configs.base import depth_cut
    from repro_torch.core import scenario as SC
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.sim_report import (simulate_serving_trace,
                                                trace_schedule)

    dev = torch.device("cuda")
    cfg = depth_cut(get_config(SIM_ARCH), SIM_LAYERS)
    params = Model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(args.seed))
    rng = np.random.default_rng(args.seed)
    lens = [64 * int(k) for k in rng.integers(1, 5, SIM_REQUESTS)]
    eng = ServingEngine(cfg, params, slots=8, max_seq=1024,
                        kv_page_tokens=16, device=dev, record_plans=True)
    for i, n in enumerate(lens):
        eng.submit(Request(uid=i, prompt=rng.integers(
            1, cfg.vocab_size - 1, n).astype(np.int32),
            max_new_tokens=SIM_NEW_TOKENS))
    torch.cuda.synchronize()
    ops.reset_launches()
    t = time.perf_counter()
    eng.run_until_drained()
    torch.cuda.synchronize()
    record_s = time.perf_counter() - t
    launches = dict(ops.LAUNCHES)
    missing = [k for k in DENSE_KERNELS if launches[k] <= 0]
    require(not missing, f"simulator serving never launched {missing}")
    require(eng.stats.drained, "record run did not drain")
    trace = eng.trace
    kinds = [r.kind for r in trace]
    require(kinds.count("prefill") == eng.stats.prefills == SIM_REQUESTS,
            f"{kinds.count('prefill')} prefill records for "
            f"{eng.stats.prefills} admissions")
    require(kinds.count("decode") == eng.stats.decode_steps,
            f"{kinds.count('decode')} decode records for "
            f"{eng.stats.decode_steps} decode steps")
    require(len(trace) == len(kinds) == eng.n_records, "trace length")
    del eng

    card_run = phase_serving(
        torch, args, cfg, params, DENSE_KERNELS,
        new_tokens=SIM_NEW_TOKENS, tag="simulator serving card",
        prompt_lens=lens)
    del params
    torch.cuda.empty_cache()

    sched = trace_schedule(trace)
    sim = {}
    for mode in SIM_MODES:
        sys_cfg = SC.system_for(SC.Scenario(model="serve", mode=mode))
        t = time.perf_counter()
        rep = simulate_serving_trace(sys_cfg, trace, sched=sched)
        wall = time.perf_counter() - t
        pct = rep.percentiles()
        require(pct["requests"] == SIM_REQUESTS
                and pct["n_in_flight"] == 0, f"{mode}: {pct}")
        require(np.isfinite(rep.per_event_s).all()
                and abs(rep.per_event_s.sum() - rep.total_s)
                <= 1e-9 * rep.total_s, f"{mode}: per-record attribution")
        sim[mode] = {"total_s": rep.total_s,
                     "ttft_p50_us": pct["ttft_p50_us"],
                     "tpot_p50_us": pct["tpot_p50_us"],
                     "replay_s": wall,
                     "events_per_s": sched.sampled_events / wall}
    res = {"config": cfg.name, "prompt_tokens": lens,
           "new_tokens": SIM_NEW_TOKENS, "records": len(trace),
           "prefill_records": kinds.count("prefill"),
           "decode_records": kinds.count("decode"),
           "events": sched.sampled_events, "record_run_s": record_s,
           "launches": launches,
           "card_ttft_p50_ms": card_run["ttft_p50_ms"],
           "card_decode_step_median_ms": card_run["decode_step_median_ms"],
           "simulated": sim,
           "simulated_is": "a model of the paper's MatrixFlow "
                           "accelerator behind PCIe, not of this card",
           "card": card}
    print("[simulator serving] " + json.dumps(res), flush=True)

    t = time.perf_counter()
    for mode in SIM_MODES:
        sc = SC.Scenario(model="serve", mode=mode)
        on_card, on_cpu = (dataclasses.asdict(SC.simulate(sc, device=d))
                           for d in ("cuda", "cpu"))
        for r in (on_card, on_cpu):
            r.pop("wall_s")
        require(on_card == on_cpu,
                f"serve scenario {mode}: card and CPU SimResults differ")
    res["serve_scenario_s"] = time.perf_counter() - t
    print(f"[simulator serve scenario] reduced {SC.SERVE_SHAPE['arch']}: "
          f"SimResult equal on the card and the CPU in "
          f"{', '.join(SIM_MODES)}", flush=True)
    return res


def _sim_workers(torch):
    """13d: with CUDA live in this process, ``tune`` over the default
    design space at two workers (spawned, not forked) equals one
    worker."""
    from repro_torch.core import scenario as SC

    require(torch.cuda.is_initialized(), "CUDA is not initialized here")
    ex = SC._pool_executor(2)
    method = ex._mp_context.get_start_method()
    ex.shutdown()
    require(method == "spawn", f"workers start by {method} after CUDA")
    sc = SC.Scenario(model="bert-base", n_layers=2)
    one, two = (SC.tune(sc, workers=w).to_json() for w in (1, 2))
    for r in (one, two):
        r.pop("wall_s")
        r.pop("configs_per_s")
    require(one == two, "tune at 2 workers differs from 1 worker")
    return {"points": one["n_points"], "start_method": method}


# host work of phases 13 and 14 that needs no card, each run by
# ``python3 chip_smoke.py --host-job NAME`` in a process of its own
# started after the build (``start_host_jobs``); the phases read their
# records (``_host_result``)
HOST_DIR = Path(__file__).resolve().parent / "build" / "host_jobs"


def run_host_job(torch, name):
    """One host job in this process: its lines printed, its result and
    seconds written to ``HOST_DIR``.  The sweep initialises CUDA first:
    its workers must start by spawn with CUDA live."""
    t = time.perf_counter()
    if name == "sweep":
        torch.cuda.init()
    res = {"replay": lambda: _sim_replay(card_line(), host_line()),
           "scorecard": _sim_scorecard, "bench": _open_loop_bench,
           "sweep": lambda: _open_loop_sweep(torch)}[name]()
    (HOST_DIR / f"{name}.json").write_text(json.dumps(
        {"result": res, "seconds": time.perf_counter() - t}))


def start_host_jobs():
    """Start every host job of phases 13 and 14 (one thread each); the
    processes are stopped at exit."""
    import shutil
    shutil.rmtree(HOST_DIR, ignore_errors=True)
    HOST_DIR.mkdir(parents=True)
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = {name: subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--host-job", name],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for name in ("replay", "scorecard", "bench", "sweep")}
    atexit.register(lambda: [p.kill() for p in procs.values()
                             if p.poll() is None])
    return procs


def _host_result(jobs, name):
    """A host job's result, waited for: its printed lines printed here,
    its exit code 0 required, its own seconds printed."""
    log, _ = jobs[name].communicate(timeout=900)
    print(log, end="", flush=True)
    require(jobs[name].returncode == 0,
            f"host job {name} exited {jobs[name].returncode}")
    rec = json.loads((HOST_DIR / f"{name}.json").read_text())
    print(f"[host job] {name} seconds {rec['seconds']:.1f}", flush=True)
    return rec["result"]


def phase_simulator(torch, args, card, jobs=None):
    """13. The timing simulator (``repro_torch.accesys`` and the
    Scenario API): (a) ``BENCH_replay.json``'s rows, (b) the paper-claim
    scorecard, (c) a trace the card records, priced in DM, DC and
    DevMem, (d) the worker pool after CUDA.  Seconds per sub-phase.
    With ``jobs`` (``start_host_jobs``), (a) and (b) are read from
    their host jobs' records (their seconds here: the wait)."""
    host = host_line()
    res, secs = {}, {}

    def job(name, fn):
        return (lambda: _host_result(jobs, name)) if jobs else fn

    for name, fn in (("replay", job("replay",
                                    lambda: _sim_replay(card, host))),
                     ("scorecard", job("scorecard", _sim_scorecard)),
                     ("serving", lambda: _sim_serving(torch, args, card)),
                     ("workers", lambda: _sim_workers(torch))):
        t = time.perf_counter()
        res[name] = fn()
        secs[name] = time.perf_counter() - t
    res["seconds"] = secs
    print("[simulator] seconds: " + " ".join(
        f"{k} {v:.1f}" for k, v in secs.items())
        + f" total {sum(secs.values()):.1f}", flush=True)
    return res


# ------------------------------------------------------------ phase 14
OPEN_LOOP_CHUNK_EVENTS = 262_144
SWEEP_QPS = (100.0, 300.0, 900.0)
SWEEP_REQUESTS = 200
# 14c: the card-clocked open loop (qwen2-0.5b at full width, SIM_LAYERS)
OPEN_REQUESTS = 16
OPEN_SLOTS = 8
OPEN_PAGE = 16
OPEN_MAX_SEQ = 1024
OPEN_CHUNK = 128
OPEN_PROMPTS = (64, 128, 192, 256)


def _open_loop_bench():
    """14a: ``BENCH_serving_scale.json``'s serve_1k (prefix caching off
    and on) and serve_preempt_1k rebuilt by the plan-only engine and
    priced in DM, DC and DevMem in one streamed pass (the two-pass
    factory form, ``serving.scale``): counts exactly, each mode's
    ``total_s`` within 1e-9 of the artifact's, and every request's work
    conserved."""
    from repro_torch.serving import scale as SCALE

    art = json.loads((Path(__file__).resolve().parent
                      / "BENCH_serving_scale.json").read_text())
    out = {}
    for name in SCALE.WORKLOADS:
        want = SCALE.artifact_row(name, art)
        got = SCALE.reproduce_serving_scale(name, modes=SIM_MODES)
        require(got["drained"], f"{name}: not drained")
        for key, val in want.items():
            if key != "total_s":
                require(got[key] == val,
                        f"{name}: {key} {got[key]}, the artifact has {val}")
        for mode, art_s in want["total_s"].items():
            require(abs(got["total_s"][mode] - art_s) <= 1e-9 * art_s,
                    f"{name} {mode}: total {got['total_s'][mode]} s, "
                    f"artifact {art_s}")
        out[name] = {**got, "artifact_total_s": want["total_s"],
                     "events_per_s_all_modes":
                     len(SIM_MODES) * got["events"] / got["price_s"]}
        print(f"[open_loop bench] {name}: " + json.dumps(out[name]),
              flush=True)
    return out


def _sweep_json(res):
    out = res.to_json()
    out.pop("wall_s")
    return out


def _open_loop_sweep(torch):
    """14b: ``load_sweep_200`` with CUDA live: one worker, then two
    spawned workers; equal ``loadsweep/v1`` JSON but for ``wall_s``."""
    from repro_torch.core import scenario as SC

    require(torch.cuda.is_initialized(), "CUDA is not initialized here")
    runs = {}
    for workers in (1, 2):
        res = SC.sweep_load(qps=SWEEP_QPS, n_requests=SWEEP_REQUESTS,
                            workers=workers)
        runs[workers] = (res, _sweep_json(res))
    require(runs[1][1] == runs[2][1],
            "load sweep at 2 workers differs from 1 worker")
    res = runs[1][0]
    out = {"qps": list(res.qps), "n_requests": res.n_requests,
           "knee_qps": res.knee_qps, "calibration": res.calibration,
           "json_identical": True,
           "wall_s": {f"workers_{w}": r.wall_s for w, (r, _) in runs.items()},
           "ttft_p99_us": {m: [pt.percentiles["ttft_p99_us"]
                               for pt in res.curve(m)] for m in res.modes}}
    print("[open_loop sweep] " + json.dumps(out), flush=True)
    return out


def _open_loop_clock(torch, args, cfg, serving_13c):
    """14c, the card's clock: the engine's decode step is 13c's card
    decode-step median for the same 1-layer model ``cfg``; its prefill
    rate is that model's prefill on the card at 64 / 128 / 192 / 256
    tokens (CUDA events around each prefill, host enqueue included: the
    median of 5 after 2 warm-ups), summed time over summed tokens."""
    import math

    import numpy as np
    from repro_torch.models.model import Model

    step_ms = serving_13c.get("card_decode_step_median_ms")
    require(step_ms is not None and math.isfinite(step_ms) and step_ms > 0,
            f"13c gave no card decode step: {step_ms}")
    dev = torch.device("cuda")
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    cache = model.init_cache(1, OPEN_MAX_SEQ, OPEN_PAGE)
    rng = np.random.default_rng(args.seed)
    prefill_ms = {}
    for n in OPEN_PROMPTS:
        tokens = torch.as_tensor(rng.integers(1, cfg.vocab_size - 1, n),
                                 dtype=torch.int64, device=dev)[None]
        times = []
        for rep in range(7):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            s.record()
            require(cache.alloc_seq(0, n), "prefill cache out of pages")
            model.prefill(params, tokens, cache, [0])
            cache.free_seq(0)
            e.record()
            e.synchronize()
            if rep >= 2:
                times.append(s.elapsed_time(e))
        prefill_ms[n] = statistics.median(times)
    del params, cache, model
    torch.cuda.empty_cache()
    per_token = sum(prefill_ms.values()) / sum(OPEN_PROMPTS) / 1e3
    require(math.isfinite(per_token) and per_token > 0,
            f"no card prefill rate: {prefill_ms}")
    return {"est_step_s": step_ms / 1e3,
            "est_prefill_s_per_token": per_token,
            "card_prefill_ms": {str(k): v for k, v in prefill_ms.items()}}


def _open_loop_runs(cfg, seed, est_step_s, est_prefill_s_per_token):
    """14c, the runs: ``OPEN_REQUESTS`` requests of 64-256 prompt tokens
    (multiples of 64) and ``SIM_NEW_TOKENS`` new tokens, poisson from
    ``seed``, through the plan-only engine on the card's clock at 0.5,
    1 and 2 times the capacity ``sweep_load``'s formula gives, and at 2
    times again with ``preempt="lifo"``, no stall budget and the pool
    capped as ``sweep_load`` caps it.  Invariants every step, drained,
    work conserved; each trace priced in DM / DC / DevMem in one pass."""
    import numpy as np
    from repro_torch.accesys.pipeline import (release_scratch,
                                              replay_trace_streamed)
    from repro_torch.core import scenario as SC
    from repro_torch.core.plan import _plan_n_events, trace_footprint
    from repro_torch.serving import invariants
    from repro_torch.serving.engine import (Request, ServingEngine,
                                            arrival_times)
    from repro_torch.serving.sim_report import ServingAccumulator

    # sweep_load's capacity and pressured pool, for these prompts
    cap_qps = SC.load_capacity_qps(
        est_step_s, est_prefill_s_per_token,
        mean_prompt=sum(OPEN_PROMPTS) / len(OPEN_PROMPTS),
        max_new_tokens=SIM_NEW_TOKENS, slots=OPEN_SLOTS)
    pool = SC.pressured_pool_pages(
        longest_prompt=max(OPEN_PROMPTS), max_new_tokens=SIM_NEW_TOKENS,
        max_seq=OPEN_MAX_SEQ, kv_page_tokens=OPEN_PAGE, slots=OPEN_SLOTS)
    cfgs = [SC.system_for(SC.Scenario(model="serve", mode=m))
            for m in SIM_MODES]

    def requests():
        rng = np.random.default_rng(seed)
        lens = [64 * int(k) for k in rng.integers(1, 5, OPEN_REQUESTS)]
        return [Request(uid=i, prompt=rng.integers(
            1, cfg.vocab_size - 1, n).astype(np.int32),
            max_new_tokens=SIM_NEW_TOKENS) for i, n in enumerate(lens)]

    runs = []
    for factor, preempt in ((0.5, "none"), (1.0, "none"), (2.0, "none"),
                            (2.0, "lifo")):
        qps = factor * cap_qps
        eng = ServingEngine(cfg, plan_only=True, slots=OPEN_SLOTS,
                            max_seq=OPEN_MAX_SEQ, kv_page_tokens=OPEN_PAGE,
                            kv_pool_pages=pool if preempt != "none"
                            else None)
        reqs = requests()
        t = time.perf_counter()
        eng.run_open_loop(
            reqs, arrival_times("poisson", OPEN_REQUESTS, qps, seed=seed),
            est_step_s=est_step_s,
            est_prefill_s_per_token=est_prefill_s_per_token,
            prefill_chunk_tokens=OPEN_CHUNK, preempt=preempt,
            stall_budget_s=0.0, debug_invariants=True)
        build_s = time.perf_counter() - t
        require(eng.stats.drained and eng.n_finished == OPEN_REQUESTS,
                f"{factor}x {preempt}: not drained")
        invariants.check_trace_conservation(eng.trace, reqs,
                                            max_seq=eng.max_seq)
        if preempt != "none":
            require(eng.stats.preemptions >= 1,
                    f"{factor}x {preempt}: no preemption on a {pool}-page "
                    "pool")
        plans = [r.plan for r in eng.trace]
        events = sum(_plan_n_events(p) for p in plans)
        acc = ServingAccumulator()
        t = time.perf_counter()
        results, pers = replay_trace_streamed(
            cfgs, lambda: (r.plan for r in acc.wrap(iter(eng.trace))),
            footprint_pages=trace_footprint(plans),
            chunk_events=OPEN_LOOP_CHUNK_EVENTS)
        price_s = time.perf_counter() - t
        release_scratch()
        require(len(acc.meta) == len(eng.trace), "accumulator passes")
        sim = {}
        for mode, res, per in zip(SIM_MODES, results, pers):
            pct = acc.report(mode, res, per, eng.unfinished_uids()
                             ).percentiles()
            require(pct["requests"] == OPEN_REQUESTS
                    and pct["n_in_flight"] == 0, f"{mode}: {pct}")
            sim[mode] = {k: pct[k] for k in (
                "ttft_p50_us", "ttft_p99_us", "tpot_p50_us", "tpot_p99_us")}
            sim[mode]["total_s"] = res.total_s
        runs.append({"offered_qps": qps, "capacity_factor": factor,
                     "preempt": preempt,
                     "kv_pool_pages": eng._table.cfg.n_pages,
                     "records": len(eng.trace), "events": events,
                     "preemptions": eng.stats.preemptions,
                     "swapped_pages": eng.stats.swapped_pages,
                     "deferred_admissions": eng.deferred_admissions,
                     "build_s": build_s, "price_s": price_s,
                     "simulated": sim})
    return {"capacity_qps": cap_qps, "runs": runs}


def _open_loop_card(torch, args, card, serving_13c):
    """14c: full width on the card's clock (see the two halves)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import depth_cut

    cfg = depth_cut(get_config(SIM_ARCH), SIM_LAYERS)
    clock = _open_loop_clock(torch, args, cfg, serving_13c)
    res = _open_loop_runs(cfg, args.seed, clock["est_step_s"],
                          clock["est_prefill_s_per_token"])
    out = {"config": cfg.name, **clock, **res,
           "card_ttft_p50_ms": serving_13c["card_ttft_p50_ms"],
           "card_decode_step_median_ms":
           serving_13c["card_decode_step_median_ms"],
           "simulated_is": "a model of the paper's MatrixFlow accelerator "
                           "behind PCIe, not of this card", "card": card}
    print("[open_loop card] " + json.dumps(out), flush=True)
    return out


def phase_open_loop(torch, args, card, serving_13c, jobs=None):
    """14. Plan-only open-loop serving, on the host: (a)
    ``BENCH_serving_scale.json`` reproduced, (b) ``load_sweep_200`` at
    one and two spawned workers with CUDA live, (c) full width on the
    card's clock.  Prints one ``{"open_loop": ...}`` line.  With
    ``jobs``, (a) and (b) are read from their host jobs' records."""
    host = host_line()
    res, secs = {}, {}

    def job(name, fn):
        return (lambda: _host_result(jobs, name)) if jobs else fn

    for name, fn in (("bench", job("bench", _open_loop_bench)),
                     ("sweep", job("sweep", lambda: _open_loop_sweep(torch))),
                     ("card_clock", lambda: _open_loop_card(
                         torch, args, card, serving_13c))):
        t = time.perf_counter()
        res[name] = fn()
        secs[name] = time.perf_counter() - t
    res["seconds"] = secs
    print(json.dumps({"open_loop": {
        "bench": {k: {f: v[f] for f in ("records", "events", "total_s",
                                        "events_per_s_all_modes")}
                  for k, v in res["bench"].items()},
        "sweep_knee_qps": res["sweep"]["knee_qps"],
        "sweep_wall_s": res["sweep"]["wall_s"],
        "card_clock": {k: res["card_clock"][k] for k in (
            "est_step_s", "est_prefill_s_per_token", "capacity_qps")},
        "card_clock_runs": [{k: r[k] for k in (
            "capacity_factor", "preempt", "records", "events",
            "preemptions")} for r in res["card_clock"]["runs"]],
        "seconds": secs, "rates_on_host": host, "card": card}}),
        flush=True)
    return res


# ---------------------------------------------------------------- phase 15
TRAIN_ARCH = "qwen2-0.5b"
TRAIN_TOKENS = 4096              # the GEMM's M in 15a: 8 x 512 tokens
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 512, 8, 20
TRAIN_CKPT_EVERY = 10
TRAIN_FAIL_AT = 12
TRAIN_LR = dict(lr_base=3e-3, lr_warmup=10, lr_total=100)
# card vs CPU (15b): the limits the CPU tests set at reduced width,
# where the port's bf16 loss and gradients meet the reference's
# (tests/test_torch_train.py): bf16 rounding after fp32 sums in other
# orders, as between the card and the CPU
TRAIN_LOSS_RTOL = 1e-3
TRAIN_GRAD_REL_L2 = 5e-2
TRAIN_REMAT_RTOL = 1e-3          # remat="full" against "none" (15e)


def _bwd_entry(torch, timer, a, b, out_of):
    """One backward product on the kernel (``ops._gemm_bwd``, the call the
    autograd Function makes), checked against its plain version and
    timed beside the plain version, ``torch.matmul`` on the same
    operands and the bound.  ``out_of``: which product of which
    weight."""
    import importlib
    from repro_torch.kernels import ops, ref
    SG = importlib.import_module("repro_torch.kernels.streaming_gemm")
    M, K = a.shape
    N = b.shape[1]
    layout = SG.mma_layout(a, b)
    require(layout is not None or SG.mcontig_layout(a, b) is not None,
            f"{out_of}: the tensor-core kernel cannot read these operands")
    mode = "m_contiguous_a" if layout is None else (
        "k_contiguous_b" if layout[0] else "row_major")
    want = ref.gemm_ref(a, b)
    rms = want.float().square().mean().sqrt().item()
    require(0.5 <= rms <= 2, f"{out_of}: output rms {rms}, not O(1)")
    err = check_close(f"{out_of} {M}x{K}x{N}", ops._gemm_bwd(a, b),
                      want, BF16_TOL)
    del want
    bms, by = bound(2 * (M * K + K * N + M * N), 2 * M * N * K)
    r = {"shape": [M, K, N], "b": out_of, "mode": mode, "on_path": True,
         "plan": list(SG.plan(M, N, K)), "max_abs_err": err,
         "want_rms": rms,
         "ms": timer(lambda: ops._gemm_bwd(a, b)),
         "plain_ms": timer(lambda: ref.gemm_ref(a, b)),
         "library_ms": timer(lambda: torch.matmul(a, b)),
         "bound_ms": bms, "bound_by": by}
    print(f"[train_bwd] {out_of} M={M} K={K} N={N} ({mode}, plan "
          f"{r['plan']}): err {err:.3g} (tol {BF16_TOL}, output rms "
          f"{rms:.3g}) kernel "
          f"{r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms matmul "
          f"{r['library_ms']:.4f} ms bound {bms:.4f} ms ({by})", flush=True)
    return r


def _train_bwd_kernels(torch, args, dev, timer, rows):
    """15a. Both backward products of every qwen2-0.5b GEMM at M = 4,096
    tokens: dA = dC·Bᵀ and dB = Aᵀ·dC (the tied lm_head: dBᵀ = dCᵀ·A, an
    M-contiguous A of 152,064 x 4,096), kept as the GEMM row's
    ``train_bwd_path``.  dC is drawn at unit scale, B at N^-1/2 and A at
    M^-1/2, so that every output is O(1) (its rms is checked) and
    ``BF16_TOL`` is a few hundredths of a typical value: a kernel that
    drops part of a sum fails."""
    g = torch.Generator(device=dev).manual_seed(args.seed + 15)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev)
                * scale).to(torch.bfloat16)

    M = TRAIN_TOKENS
    per_shape = []
    for name, K, N in (("q / o", 896, 896), ("k / v", 896, 128),
                       ("gate / up", 896, 4864), ("down", 4864, 896),
                       ("lm_head embed.T", 896, 152064)):
        x = randn(M, K, scale=M ** -0.5)
        dc = randn(M, N)
        if N == 152064:
            b = randn(N, K, scale=N ** -0.5).t()       # embed.T in place
            per_shape.append(_bwd_entry(torch, timer, dc, b.t(),
                                        f"{name} dA"))
            per_shape.append(_bwd_entry(torch, timer, dc.t(), x,
                                        f"{name} dB^T"))
        else:
            b = randn(K, N, scale=N ** -0.5)
            per_shape.append(_bwd_entry(torch, timer, dc, b.t(),
                                        f"{name} dA"))
            per_shape.append(_bwd_entry(torch, timer, x.t(), dc,
                                        f"{name} dB"))
        del x, dc, b
    _add_path(rows["streaming_gemm"], per_shape, "train_bwd_path")
    return per_shape


def _leaf_errors(torch, got, want):
    """{path: relative L2 error} of two gradient trees."""
    from repro_torch.checkpoint.checkpoint import _flatten
    w = dict(_flatten(want))
    out = {}
    for path, g in _flatten(got):
        ref_ = w[path].float()
        out["/".join(path)] = ((g.float().cpu() - ref_).norm()
                               / ref_.norm()).item()
    return out


def _train_card_vs_cpu(torch, args, dev):
    """15b. Full width, 2 layers, batch 1 x 128 tokens, the same seeded
    weights on the card and on the CPU: the loss (relative difference)
    and each gradient leaf (relative L2) within the limits the CPU
    tests set at reduced width."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.configs.base import depth_cut
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models.model import Model
    from repro_torch.models.params import params_to

    cfg = depth_cut(get_config(TRAIN_ARCH), 2)
    params = Model(cfg, device="cpu").init(
        torch.Generator().manual_seed(args.seed))
    rng = np.random.default_rng(args.seed + 15)
    toks = rng.integers(1, cfg.vocab_size - 1, (1, 129))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]).to(torch.int32),
             "labels": torch.from_numpy(toks[:, 1:]).to(torch.int32)}
    t = time.perf_counter()
    (loss, _), grads = loss_and_grads(
        Model(cfg, device=dev, remat="none"), params_to(params, dev),
        {k: v.to(dev) for k, v in batch.items()})
    card_s = time.perf_counter() - t
    t = time.perf_counter()
    (want, _), want_g = loss_and_grads(Model(cfg, device="cpu",
                                             remat="none"), params, batch)
    cpu_s = time.perf_counter() - t
    loss_rel = abs(loss.item() - want.item()) / abs(want.item())
    errs = _leaf_errors(torch, grads, want_g)
    worst = max(errs, key=errs.get)
    res = {"config": cfg.name, "tokens": 128, "card_loss": loss.item(),
           "cpu_loss": want.item(), "loss_rel_diff": loss_rel,
           "loss_rtol": TRAIN_LOSS_RTOL, "leaves": len(errs),
           "grad_rel_l2_max": errs[worst], "grad_rel_l2_max_leaf": worst,
           "grad_rel_l2_limit": TRAIN_GRAD_REL_L2,
           "card_s": card_s, "cpu_s": cpu_s}
    print("[train_card_vs_cpu] " + json.dumps(res), flush=True)
    require(loss_rel <= TRAIN_LOSS_RTOL,
            f"train card vs CPU: loss {loss.item()} vs {want.item()}")
    require(errs[worst] <= TRAIN_GRAD_REL_L2,
            f"train card vs CPU: gradient {worst} off by {errs[worst]}")
    return res


def _train_flops(cfg, tokens, seq):
    """Model FLOPs of one training step (forward and backward, 6 per
    weight per token for every GEMM, the attention's QKᵀ and PV at 3
    times their forward, every (query, key) block the chunked attention
    computes)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, KH = cfg.n_heads, cfg.n_kv_heads
    per_layer = d * (H + 2 * KH) * hd + H * hd * d + 3 * d * cfg.d_ff
    weights = cfg.n_layers * per_layer + d * cfg.padded_vocab
    attn = cfg.n_layers * 3 * 2 * 2 * tokens * seq * H * hd
    return 6 * weights * tokens + attn, weights


def _profile_train_step(torch, step, state, batch, tries=3):
    """One training step under ``torch.profiler``; its device kernels
    split by ``_train_kernel_split``.  Returns (state, the split, the
    step's launch counts)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops

    for window in range(1, tries + 1):
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state, _ = step(state, batch)
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches, gemm_bwd = dict(ops.LAUNCHES), dict(ops.GEMM_BWD)
        kern = sorted((ev.time_range.start, ev.time_range.elapsed_us(),
                       ev.name) for ev in prof.events()
                      if ev.device_type == DeviceType.CUDA
                      and ev.time_range.elapsed_us() > 0)
        if kern:
            break
        print(f"[train_profile] window {window}: the profiler recorded no "
              "device kernel", flush=True)
    require(kern, f"train profile: {tries} windows held no device kernel")
    res = _train_kernel_split(kern, launches, gemm_bwd, wall_ms)
    res["profiler_windows"] = window
    return state, res, launches


def _train_kernel_split(kern, launches, gemm_bwd, wall_ms):
    """Device time of a training step's kernels ``kern`` ((start us,
    us, name), in the order the card ran them).  With ``remat="none"``
    the forward ends before the backward starts, on one stream, and the
    backward begins with the lm_head's dA and then its dBᵀ, the first
    kernel of the M-contiguous A mode (``gemm_bf16<BM, BN, false, true,
    NARROW>``): the GEMM kernels before that dA are the forward's, the
    rest the backward products (a split that holds where the profiler
    loses a kernel, which it now and then does)."""
    from repro_torch.kernels import kernel_nodes as KN
    gemm = [(t, us, n) for t, us, n in kern
            if KN.kernel_group(n) == "streaming_gemm"]
    simt = [n for _, _, n in gemm if "gemm_simt" in n]
    mcontig = re.compile(r"gemm_bf16<\d+, \d+, \w+, true, \w+>")
    first_db = next((i for i, (_, _, n) in enumerate(gemm)
                     if mcontig.search(n)), None)
    require(first_db, "train profile: no M-contiguous GEMM kernel recorded")
    fwd, bwd = gemm[:first_db - 1], gemm[first_db - 1:]
    gemm_names = {n for _, _, n in gemm}
    other = sum(us for _, us, n in kern if n not in gemm_names) / 1e3
    span_ms = (kern[-1][0] + kern[-1][1] - kern[0][0]) / 1e3
    busy_ms = sum(us for _, us, _ in kern) / 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms,
            "device_span_ms": span_ms,
            "device_ms": {"forward_gemm": sum(us for _, us, _ in fwd) / 1e3,
                          "backward_gemm": sum(us for _, us, _ in bwd) / 1e3,
                          "other": other},
            "profiler_gemm_kernels": {"forward": len(fwd),
                                      "backward": len(bwd),
                                      "gemm_simt": len(simt)},
            "launches": {"forward": launches["streaming_gemm"]
                         - gemm_bwd["launches"],
                         "backward": gemm_bwd["launches"]},
            "bwd_dc_copies": gemm_bwd["dc_copies"]}


def _train_attention(torch, cfg, dev):
    """One layer's training attention at 15c's shape, forward and
    backward: ``layers.chunked_attention`` as torch ops under autograd
    (what the port runs), beside SDPA's forward and backward on the same
    inputs (a yardstick the port never calls), CUDA events."""
    import torch.nn.functional as F
    from repro_torch.models import layers as L
    B, T, H, KH, hd = (TRAIN_BATCH, TRAIN_SEQ, cfg.n_heads, cfg.n_kv_heads,
                       cfg.resolved_head_dim)
    g = torch.Generator(device=dev).manual_seed(15)

    def randn(*shape, grad=True):
        x = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        return x.requires_grad_(grad)

    q, k, v = randn(B, T, H, hd), randn(B, T, KH, hd), randn(B, T, KH, hd)
    do = randn(B, T, H, hd, grad=False)

    def chunked():
        out = L.chunked_attention(q, k, v, causal=True)
        torch.autograd.grad(out, (q, k, v), do)

    def sdpa():
        out = F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True)
        torch.autograd.grad(out, (q, k, v), do.transpose(1, 2))

    timer = Timer(torch, dev)
    res = {"shape": [B, T, H, KH, hd], "chunked_fwd_bwd_ms": timer(chunked),
           "sdpa_fwd_bwd_ms": timer(sdpa)}
    res["chunked_ms_per_step"] = res["chunked_fwd_bwd_ms"] * cfg.n_layers
    return res


def _trainer(run, ckpt_dir, seed, dev, inject=None):
    from repro_torch.runtime.train_loop import Trainer, TrainerConfig
    return Trainer(run, TrainerConfig(
        ckpt_dir=str(ckpt_dir), ckpt_every=TRAIN_CKPT_EVERY, keep=2,
        seed=seed, **TRAIN_LR), inject_failure_at=inject, device=dev)


def _train_full(torch, args, card, ckpt_root, dev):
    """15c. The Trainer at full width and depth: qwen2-0.5b, random bf16
    weights from ``--seed``, AdamW, ``remat="none"``, 8 x 512 tokens a
    step, 20 steps, a checkpoint every 10; then one profiled step."""
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.data.pipeline import make_loader
    from repro_torch.models.params import n_elements

    cfg = get_config(TRAIN_ARCH)
    run = RunConfig(model=cfg, shape=ShapeConfig(
        "train", "train", TRAIN_SEQ, TRAIN_BATCH), remat="none")
    shutil.rmtree(ckpt_root / "full", ignore_errors=True)
    tr = _trainer(run, ckpt_root / "full", args.seed, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    out = tr.train(TRAIN_STEPS)
    train_s = time.perf_counter() - t
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = out["losses"]
    step_ms = [m["s"] * 1e3 for m in tr.metrics_log]
    med = statistics.median(step_ms[1:])
    tokens = TRAIN_SEQ * TRAIN_BATCH
    flops, weights = _train_flops(cfg, tokens, TRAIN_SEQ)
    bound_ms = flops / BF16_FLOP_PER_S * 1e3
    require(len(losses) == TRAIN_STEPS, f"train: {len(losses)} steps")
    require(all(x == x and abs(x) < float("inf") for x in losses),
            f"train: non-finite loss {losses}")
    require(losses[-1] < losses[0],
            f"train: loss did not fall ({losses[0]} -> {losses[-1]})")
    require(tr.ckpt.all_steps() == [9, 19],
            f"train: checkpoints {tr.ckpt.all_steps()}")

    # one more step, profiled, from the step-19 checkpoint
    state, start = tr.restore_or_init()
    loader = make_loader(cfg, run.shape, dev, start_step=start,
                         seed=args.seed)
    _, batch = next(loader)
    loader.close()
    n_fwd = 7 * cfg.n_layers + 1
    state, prof, launches = _profile_train_step(torch, tr.step_fn, state,
                                                batch)
    del state
    checkpoints = tr.ckpt.all_steps()
    shutil.rmtree(ckpt_root / "full", ignore_errors=True)
    attention = _train_attention(torch, cfg, dev)
    prof["device_busy_share_of_median_step"] = prof["device_busy_ms"] / med
    res = {"config": cfg.name, "params": n_elements(
               tr.model.abstract_params()),
           "gemm_weights": weights, "steps": TRAIN_STEPS,
           "tokens_per_step": tokens, "losses": losses,
           "step_ms": step_ms, "median_step_ms": med,
           "tokens_per_s": tokens / med * 1e3,
           "model_tflop_per_step": flops / 1e12,
           "flop_bound_ms": bound_ms,
           "bf16_peak_share": bound_ms / med,
           "peak_mem_gb": peak_gb, "train_s": train_s,
           "checkpoints": checkpoints,
           "profiled_step": prof, "attention": attention, "card": card}
    print("[train_full] " + json.dumps(res), flush=True)
    require(prof["launches"] == {"forward": n_fwd, "backward": 2 * n_fwd},
            f"train: launches {prof['launches']}, expected {n_fwd} "
            f"forward and {2 * n_fwd} backward")
    require(prof["profiler_gemm_kernels"]["gemm_simt"] == 0,
            "train: the profiled step ran the scalar GEMM kernel")
    return res, launches


def _train_restart(torch, args, full, ckpt_root, dev):
    """15d. A run that fails after step 12, then a fresh Trainer on the
    same directory: it resumes from the step-9 checkpoint, and its
    losses for steps 10-19 against 15c's."""
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig, ShapeConfig

    run = RunConfig(model=get_config(TRAIN_ARCH), shape=ShapeConfig(
        "train", "train", TRAIN_SEQ, TRAIN_BATCH), remat="none")
    d = ckpt_root / "restart"
    shutil.rmtree(d, ignore_errors=True)
    tr = _trainer(run, d, args.seed, dev, inject=TRAIN_FAIL_AT)
    try:
        tr.train(TRAIN_STEPS)
    except RuntimeError as e:
        require("injected node failure" in str(e), f"restart: {e}")
    else:
        raise AssertionError("restart: the injected failure did not fire")
    require(tr.ckpt.all_steps() == [9], f"restart: {tr.ckpt.all_steps()}")
    del tr
    tr = _trainer(run, d, args.seed, dev)
    _, start = tr.restore_or_init()
    require(start == 10, f"restart: resumed at {start}")
    out = tr.train(TRAIN_STEPS)
    want = full["losses"][10:]
    diffs = [abs(a - b) for a, b in zip(out["losses"], want)]
    require(len(out["losses"]) == len(want) == 10,
            f"restart: {len(out['losses'])} steps after the restart")
    shutil.rmtree(d, ignore_errors=True)
    res = {"resumed_at": start, "losses": out["losses"],
           "uninterrupted": want, "max_abs_diff": max(diffs),
           "max_rel_diff": max(d / abs(w) for d, w in zip(diffs, want)),
           "bitwise": max(diffs) == 0.0,
           "deterministic_algorithms":
           torch.are_deterministic_algorithms_enabled()}
    print("[train_restart] " + json.dumps(res), flush=True)
    return res


def _train_modes(torch, args, full, dev):
    """15e. One step with ``remat="full"`` (its peak memory beside 15c's;
    its loss equal to the ``"none"`` step's within 1e-3), three Adafactor
    steps, and three AdamW steps with gradient compression; every loss
    finite."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.data.pipeline import make_loader
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.model import Model
    from repro_torch.optim import get_optimizer
    from repro_torch.runtime import compression as GC

    cfg = get_config(TRAIN_ARCH)
    base = RunConfig(model=cfg, shape=ShapeConfig(
        "train", "train", TRAIN_SEQ, TRAIN_BATCH), remat="none")
    loader = make_loader(cfg, base.shape, dev, seed=args.seed)
    batches = [next(loader)[1] for _ in range(3)]
    loader.close()
    res = {}
    for name, run, steps in (
            ("remat_full", dataclasses.replace(base, remat="full"), 1),
            ("adafactor", dataclasses.replace(base, optimizer="adafactor"),
             3),
            ("adamw_compressed", dataclasses.replace(
                base, gradient_compression=True), 3)):
        params = Model(cfg, device=dev).init(
            torch.Generator(device=dev).manual_seed(args.seed))
        state = {"params": params,
                 "opt": get_optimizer(run.optimizer).init(params)}
        if run.gradient_compression:
            state["ef"] = GC.init_ef(params)
        step = build_train_step(run, dev, **TRAIN_LR)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, ms = [], []
        for b in batches[:steps]:
            t = time.perf_counter()
            state, m = step(state, b)
            losses.append(m["loss"].item())
            ms.append((time.perf_counter() - t) * 1e3)
        res[name] = {"losses": losses, "step_ms": ms,
                     "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        del state, params
        torch.cuda.empty_cache()
        require(all(x == x and abs(x) < float("inf") for x in losses),
                f"{name}: non-finite loss {losses}")
    rel = abs(res["remat_full"]["losses"][0] - full["losses"][0]) / \
        abs(full["losses"][0])
    res["remat_full"].update(loss_rel_diff_to_none=rel,
                             none_peak_mem_gb=full["peak_mem_gb"])
    print("[train_modes] " + json.dumps(res), flush=True)
    require(rel <= TRAIN_REMAT_RTOL,
            f"remat full vs none: loss differs by {rel}")
    return res


def phase_training(torch, args, rows, card, dev):
    """15. Training of the dense family on the card (see the module
    docstring); prints each sub-phase's line and its seconds."""
    ckpt_root = Path(__file__).resolve().parent / "build" / "train_smoke"
    secs, res = {}, {}
    t = time.perf_counter()
    timer = Timer(torch, dev)
    res["bwd"] = _train_bwd_kernels(torch, args, dev, timer, rows)
    del timer
    torch.cuda.empty_cache()
    secs["bwd"] = time.perf_counter() - t
    for name, fn in (
            ("card_vs_cpu", lambda: _train_card_vs_cpu(torch, args, dev)),
            ("full", lambda: _train_full(torch, args, card, ckpt_root,
                                         dev)),
            ("restart", lambda: _train_restart(torch, args, res["full"][0],
                                               ckpt_root, dev)),
            ("modes", lambda: _train_modes(torch, args, res["full"][0],
                                           dev))):
        t = time.perf_counter()
        res[name] = fn()
        torch.cuda.empty_cache()
        secs[name] = time.perf_counter() - t
    print(f"[train] seconds {json.dumps(secs)}", flush=True)
    res["seconds"] = secs
    full, launches = res["full"]
    rows["streaming_gemm"]["train_launches"] = full["profiled_step"][
        "launches"]
    return {**res, "full": full, "launches": launches}


# ---------------------------------------------------------------- phase 16
MOE_TRAIN_LAYERS = 4             # 16c's depth (the module docstring)
MOE_TRAIN_C = 344                # routed_capacity(4,096 x 4, 60 experts)
MOE_TRAIN_ROWS = 273             # 4,096 x 4 / 60 assignments an expert
MOE_TRAIN_CHECK_TOKENS = 512     # 16b's 1 x 512 tokens (its docstring)
# 16a's widths: qwen2-moe's d, experts and d_ff; deepseek-v3's experts, C,
# rows an expert (a 512-token step routed top-8) and its d -> d_ff
MOE_TRAIN_WIDTHS = (2048, 60, 1408)
DEEPSEEK_TRAIN = (256, 24, 16, 7168, 2048)
GROUPED_BWD_NAMES = {"da": "grouped_gemm_bwd_da", "db": "grouped_gemm_bwd_db"}
# device GEMMs of a library (cuBLAS / CUTLASS kernels), by name
LIBRARY_GEMM = re.compile(r"gemm|xmma|cutlass|cublas", re.I)
LIBRARY_OPS = ("aten::bmm", "aten::mm", "aten::matmul", "aten::addmm",
               "aten::baddbmm", "aten::einsum")


def _train_counts(torch, dev, g, E, C, mean, zero=3):
    """(E,) int32 counts on the card: Poisson of ``mean`` clipped to C,
    the first ``zero`` experts at 0 (no token reached them), one at C."""
    counts = torch.poisson(torch.full((E,), float(mean), device=dev),
                           generator=g).clamp(max=C).to(torch.int32)
    counts[:zero] = 0
    counts[zero] = C
    return counts


def _grouped_bwd_entry(torch, timer, what, which, x, y, counts, on_path):
    """One backward product of the grouped GEMM on its kernel
    (``grouped_bwd_a_cuda``: dA = dC·Bᵀ, x = dC, y = B;
    ``grouped_bwd_b_cuda``: dB = Aᵀ·dC, x = A, y = dC), its inputs NaN in
    every row at or beyond a count: held against the plain version
    (dA's kept rows, all of dB), timed beside the plain version,
    ``torch.bmm`` over the whole buffers with those rows zeroed first (a
    yardstick the port never calls) and the bound, which counts the kept
    rows and the touched experts' weights (dB writes every expert)."""
    from repro_torch.kernels import grouped_gemm as GG
    from repro_torch.kernels import ref
    E, C = x.shape[:2]
    rows = torch.arange(C, device=x.device)[None, :] < counts[:, None]
    kept = int(counts.sum())
    touched = int((counts > 0).sum())
    xz = torch.where(rows[..., None], x, 0)
    if which == "da":
        K, N = y.shape[1], x.shape[2]
        kern = lambda: GG.grouped_bwd_a_cuda(x, y, counts)  # noqa: E731
        plain = lambda: ref.grouped_bwd_a_ref(x, y, counts)  # noqa: E731
        lib = lambda: torch.bmm(xz, y.transpose(1, 2))  # noqa: E731
        nbytes = 2 * (kept * N + touched * K * N + kept * K)
    else:
        K, N = x.shape[2], y.shape[2]
        yz = torch.where(rows[..., None], y, 0)
        kern = lambda: GG.grouped_bwd_b_cuda(x, y, counts)  # noqa: E731
        plain = lambda: ref.grouped_bwd_b_ref(x, y, counts)  # noqa: E731
        lib = lambda: torch.bmm(xz.transpose(1, 2), yz)  # noqa: E731
        nbytes = 2 * (kept * (K + N) + E * K * N)
    got, want = kern(), plain()
    if which == "da":
        got, want = got[rows], want[rows]
    require(bool(got.isfinite().all()),
            f"grouped {which} {what}: a row past a count reached a result")
    # expert by expert: deepseek-v3's dB is 3.8 G values, which
    # ``check_close``'s float64 copies would not fit on the card at once
    got, want = (t.reshape(-1, t.shape[-1]) for t in (got, want))
    err = max(check_close(f"grouped {which} {what}", g, w, BF16_TOL)
              for g, w in zip(got.split(4096), want.split(4096)))
    rms = (sum(w.float().square().sum().item() for w in want.split(4096))
           / want.numel()) ** 0.5
    del got, want
    bms, by = bound(nbytes, 2 * kept * K * N)
    r = {"what": what, "product": which, "shape": {
             "E": E, "C": C, "K": K, "N": N}, "rows": kept,
         "experts_touched": touched, "on_path": on_path,
         "plan": (GG.plan_bwd_da(E, C, N, K) if which == "da"
                  else GG.plan_bwd_db(E, C, K, N))._asdict(),
         "max_abs_err": err, "want_rms": rms, "ms": timer(kern),
         "plain_ms": timer(plain), "library_ms": timer(lib),
         "bound_ms": bms, "bound_by": by}
    print(f"[moe_train_kernels] grouped {which} {what} E={E} C={C} K={K} "
          f"N={N} rows {kept} experts {touched} (plan {r['plan']}): err "
          f"{err:.3g} (tol {BF16_TOL}, output rms {rms:.3g}) kernel "
          f"{r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms bmm "
          f"{r['library_ms']:.4f} ms bound {bms:.4f} ms ({by})", flush=True)
    return r


def _moe_train_kernels(torch, args, dev, timer, rows):
    """16a. The router's three products at 4,096 tokens (and its serving
    call at 8), each against its plain version, timed beside the plain
    version, ``torch.matmul`` and the bound (the GEMM row's
    ``moe_train_path``); the grouped forward at training's C = 344
    (more than one 64-row chunk an expert) and both grouped backward
    kernels (rows ``grouped_gemm_bwd_da`` / ``_db``) at qwen2-moe's
    training counts (60 experts, C 344, ~273 rows an expert, three at 0,
    one at C) for gate/up (2,048 -> 1,408) and down (1,408 -> 2,048),
    at decode counts (C 8) and at deepseek-v3's 256 experts of 7,168 ->
    2,048 (C 24, ~16 rows an expert, a 512-token step's routing), off
    the path."""
    g = torch.Generator(device=dev).manual_seed(args.seed + 16)
    bf16 = torch.bfloat16

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev, dtype=bf16) \
            * scale

    M, (d, E, f) = TRAIN_TOKENS, MOE_TRAIN_WIDTHS
    E_ds, C_ds, rows_ds, d_ds, f_ds = DEEPSEEK_TRAIN
    per_shape = [_bwd_entry(torch, timer, randn(8, d),
                            randn(d, E, scale=d ** -0.5),
                            "router x·W (decode)"),
                 _bwd_entry(torch, timer, randn(M, d),
                            randn(d, E, scale=d ** -0.5), "router x·W"),
                 _bwd_entry(torch, timer, randn(M, E),
                            randn(d, E, scale=E ** -0.5).t(),
                            "router dA = dC·Wᵀ"),
                 _bwd_entry(torch, timer, randn(M, d, scale=M ** -0.5).t(),
                            randn(M, E), "router dB = xᵀ·dC")]
    _add_path(rows["streaming_gemm"], per_shape, "moe_train_path")

    fwd, bwd = [], {"da": [], "db": []}
    cases = (("qwen2-moe train", E, MOE_TRAIN_C, MOE_TRAIN_ROWS,
              ((d, f), (f, d)), True),
             ("qwen2-moe decode", E, 8, None, ((d, f), (f, d)), False),
             ("deepseek-v3 train", E_ds, C_ds, rows_ds, ((d_ds, f_ds),),
              False))
    for what, E_, C, mean, prods, on_path in cases:
        counts = (_train_counts(torch, dev, g, E_, C, mean) if mean else
                  torch.randint(0, C + 1, (E_,), generator=g, device=dev)
                  .to(torch.int32))
        past = torch.arange(C, device=dev)[None, :] >= counts[:, None]
        for K, N in prods:
            name = f"{what} {K}->{N}"
            w = randn(E_, K, N, scale=N ** -0.5)
            a = randn(E_, C, K)
            a[past] = 0
            if on_path:
                fwd.append(_grouped_entry(torch, timer, name, a, w * (
                    N ** 0.5 * K ** -0.5), counts, True))
            dc = randn(E_, C, N)
            dc[past] = float("nan")
            bwd["da"].append(_grouped_bwd_entry(
                torch, timer, name, "da", dc, w, counts, on_path))
            a = randn(E_, C, K, scale=MOE_TRAIN_ROWS ** -0.5)
            a[past] = float("nan")
            bwd["db"].append(_grouped_bwd_entry(
                torch, timer, name, "db", a, dc, counts, on_path))
            del w, a, dc
            torch.cuda.empty_cache()
    _add_path(rows["streaming_gemm_grouped"], fwd, "moe_train_path")
    for which, name in GROUPED_BWD_NAMES.items():
        rows[name] = {
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/grouped_gemm.cu",
            "replaces": "src/repro/kernels/streaming_gemm.py:30",
            "note": ("the grouped GEMM's backward product "
                     + ("dA[e] = dC[e]·B[e]ᵀ over the kept rows"
                        if which == "da" else
                        "dB[e] = A[e]ᵀ·dC[e] summed over the kept rows")
                     + (": a persistent TMA + wgmma walk over (touched "
                        "expert, chunk of up to 256 kept rows, 128 columns "
                        "of K), the weight K-major"
                        if which == "da" else
                        ": a persistent TMA + wgmma walk over (expert, 128 "
                        "x 128 output tile), rows past the count zeroed in "
                        "shared memory, a TMA-stored epilogue")
                     + "; work items built on the card from the counts; "
                     "the reference differentiates an XLA einsum "
                     "(src/repro/models/moe.py:115-118)"),
            "tol": BF16_TOL,
            "max_abs_err": max(r["max_abs_err"] for r in bwd[which]),
            **summary(bwd[which]), "per_shape": bwd[which]}
    return {"router": per_shape, "grouped_forward": fwd, **bwd}


def _expert_sets(routes, E):
    """[set of token indices] per expert over one MoE call's (n, k)
    expert sets."""
    sets = [set() for _ in range(E)]
    for t, row in enumerate(routes.tolist()):
        for e in row:
            sets[e].add(t)
    return sets


def _moe_train_card_vs_cpu(torch, args, dev):
    """16b. qwen2-moe-a2.7b at full width cut to 1 layer, 1 x 512 tokens,
    the same seeded weights on the card and on the CPU.

    Routing is recorded on both sides (``_record_routes`` on the card):
    the card's router inputs routed again on the CPU (the same input, as
    in 7d) and the CPU run's own choices on its own inputs; both shares
    must reach ``ROUTING_AGREEMENT_MIN``.  (512 tokens, not 128: at the
    ~1.5% of tokens that a bf16 ulp moves across a router near-tie, 128
    tokens would fall under 0.97 about one run in eight.)

    The CPU run then follows the card's expert choices (its own
    probabilities, the card's top-k), so that both sides differentiate
    the same function.  A token routed elsewhere changes its own output
    and loss gradient, and through them every leaf, not only its
    experts' slices: at random weights each leaf sums uncorrelated
    per-token terms, so 1% of tokens moved one leaf by 30% in a trial
    run.  The loss within 1e-3 relative and every gradient leaf within
    5e-2 relative L2, the experts whose token set the CPU's own routing
    would have changed reported."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.configs.base import depth_cut
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import moe as MOE
    from repro_torch.models.model import Model
    from repro_torch.models.params import params_to

    cfg = depth_cut(get_config(MOE_ARCH), 1)
    E = cfg.moe.n_routed_experts
    params = Model(cfg, device="cpu").init(
        torch.Generator().manual_seed(args.seed))
    rng = np.random.default_rng(args.seed + 16)
    toks = rng.integers(1, cfg.vocab_size - 1,
                        (1, MOE_TRAIN_CHECK_TOKENS + 1))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]).to(torch.int32),
             "labels": torch.from_numpy(toks[:, 1:]).to(torch.int32)}

    def run(device, p, b):
        t = time.perf_counter()
        out = loss_and_grads(Model(cfg, device=device, remat="none"), p, b)
        if device != "cpu":
            torch.cuda.synchronize()
        return out, time.perf_counter() - t

    card_routes, card_inputs = [], []
    orig_apply = _record_routes(MOE, card_routes, card_inputs)
    try:
        ((loss, card_m), grads), card_s = run(
            dev, params_to(params, dev),
            {k: v.to(dev) for k, v in batch.items()})
    finally:
        MOE.apply_moe = orig_apply
    require(len(card_routes) == 1, "routing records")

    forced, own = list(card_routes), []
    orig_route = MOE._route

    def follow_card(p, x, cfg_):
        """The CPU's own top-k (logged), then the card's experts with the
        CPU's probabilities, renormalised, and the aux loss on them."""
        own.append(orig_route(p, x, cfg_)[1].sort(-1).values)
        top_e = forced.pop(0)
        probs = torch.softmax(MOE.L._gemm(x, p["router"]).float(), dim=-1)
        top_p = probs.gather(-1, top_e)
        top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
        ce = MOE._count(top_e, E, torch.float32) / top_e.numel()
        aux = E * torch.sum(probs.reshape(-1, E).mean(0) * ce) \
            * cfg_.moe.router_aux_coef
        return top_p, top_e, aux

    MOE._route = follow_card
    try:
        ((want, cpu_m), want_g), cpu_s = run("cpu", params, batch)
    finally:
        MOE._route = orig_route
    require(len(own) == 1 and not forced, "routing records")
    chained = float((card_routes[0] == own[0]).all(-1).float().mean())
    again = MOE._route(params["layers"][0]["moe"], card_inputs[0],
                       cfg)[1].sort(-1).values
    same = float((card_routes[0] == again).all(-1).float().mean())
    card_sets, cpu_sets = (_expert_sets(r, E) for r in (card_routes[0],
                                                        own[0]))
    moved = [e for e in range(E) if card_sets[e] != cpu_sets[e]]
    errs = _leaf_errors(torch, grads, want_g)
    worst = max(errs, key=errs.get)
    loss_rel = abs(loss.item() - want.item()) / abs(want.item())
    res = {"config": cfg.name, "tokens": MOE_TRAIN_CHECK_TOKENS,
           "card_loss": loss.item(), "cpu_loss": want.item(),
           "card_aux": card_m["aux"].item(), "cpu_aux": cpu_m["aux"].item(),
           "loss_rel_diff": loss_rel, "loss_rtol": TRAIN_LOSS_RTOL,
           "routing_agreement_same_input": same,
           "routing_agreement_own_inputs": chained,
           "routing_agreement_min": ROUTING_AGREEMENT_MIN,
           "experts_the_cpu_would_route_otherwise": moved,
           "first_flips_by_experts_changed": _first_flips(card_routes, own),
           "leaves": len(errs), "grad_rel_l2": errs,
           "grad_rel_l2_max": errs[worst], "grad_rel_l2_max_leaf": worst,
           "grad_rel_l2_limit": TRAIN_GRAD_REL_L2, "card_s": card_s,
           "cpu_s": cpu_s}
    print("[moe_train_card_vs_cpu] " + json.dumps(res), flush=True)
    require(min(chained, same) >= ROUTING_AGREEMENT_MIN,
            f"MoE train routing agrees on {chained:.3f} (same input "
            f"{same:.3f})")
    require(loss_rel <= TRAIN_LOSS_RTOL,
            f"MoE train card vs CPU: loss {loss.item()} vs {want.item()}")
    require(errs[worst] <= TRAIN_GRAD_REL_L2,
            f"MoE train card vs CPU: gradient {worst} off by {errs[worst]}")
    return res


def _moe_train_flops(cfg, tokens, seq):
    """Model FLOPs of one MoE training step: 6 per weight per token for
    every GEMM a token runs through (attention, the router, the shared
    experts, its top-k routed experts, the lm_head), and the attention's
    QKᵀ and PV at 3 times their forward."""
    m, d, hd = cfg.moe, cfg.d_model, cfg.resolved_head_dim
    H, KH = cfg.n_heads, cfg.n_kv_heads
    per_layer = (d * (H + 2 * KH) * hd + H * hd * d
                 + d * m.n_routed_experts
                 + 3 * d * m.d_ff_expert * (m.n_shared_experts + m.top_k))
    weights = cfg.n_layers * per_layer + d * cfg.padded_vocab
    attn = cfg.n_layers * 3 * 2 * 2 * tokens * seq * H * hd
    return 6 * weights * tokens + attn, weights


def _profile_moe_train_step(torch, step, state, batch, tries=3):
    """One MoE training step under ``torch.profiler``, with each
    grouped expert product (forward and backward) inside a
    ``record_function`` range: the device kernels split into 2-D forward
    and backward (as ``_train_kernel_split``), grouped forward and
    grouped backward; the launches from the counters; the library GEMM
    ops (``aten::bmm`` and the like) that ran inside an expert product's
    range (none may)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.kernels import kernel_nodes as KN
    from repro_torch.kernels import ops

    fwd_fn, bwd_fn = ops._grouped, ops._grouped_bwd

    def fwd(*a):
        with record_function("grouped_expert_product"):
            return fwd_fn(*a)

    def bwd(*a):
        with record_function("grouped_expert_product"):
            return bwd_fn(*a)

    ops._grouped, ops._grouped_bwd = fwd, bwd
    try:
        for window in range(1, tries + 1):
            ops.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                state, _ = step(state, batch)
                torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            launches = dict(ops.LAUNCHES)
            gemm_bwd, grouped_bwd = dict(ops.GEMM_BWD), dict(ops.GROUPED_BWD)
            events = prof.events()
            # the ranges show on the device's timeline too: not kernels
            kern = sorted((ev.time_range.start, ev.time_range.elapsed_us(),
                           ev.name) for ev in events
                          if ev.device_type == DeviceType.CUDA
                          and ev.time_range.elapsed_us() > 0
                          and ev.name != "grouped_expert_product")
            if kern:
                break
            print(f"[moe_train_profile] window {window}: the profiler "
                  "recorded no device kernel", flush=True)
    finally:
        ops._grouped, ops._grouped_bwd = fwd_fn, bwd_fn
    require(kern, f"MoE train profile: {tries} windows held no kernel")
    ranges = [(ev.time_range.start, ev.time_range.end) for ev in events
              if ev.name == "grouped_expert_product"
              and ev.device_type == DeviceType.CPU]
    inside = [ev.name for ev in events if ev.name in LIBRARY_OPS and any(
        s <= ev.time_range.start <= e for s, e in ranges)]
    split = _train_kernel_split(kern, launches, gemm_bwd, wall_ms)
    grouped = {"forward": [], "backward": []}
    for _, us, n in kern:
        func = KN.kernel_group(n)
        if func == "streaming_gemm_grouped":
            grouped["backward" if "grouped_bwd" in n
                    else "forward"].append(us)
    lib = [n for _, _, n in kern if LIBRARY_GEMM.search(n)
           and KN.kernel_group(n) == KN.OTHER]
    n_bwd = grouped_bwd["da"] + grouped_bwd["db"]
    split["device_ms"] = {
        "forward_gemm_2d": split["device_ms"]["forward_gemm"],
        "backward_gemm_2d": split["device_ms"]["backward_gemm"],
        "forward_grouped": sum(grouped["forward"]) / 1e3,
        "backward_grouped": sum(grouped["backward"]) / 1e3,
        "other": split["device_ms"]["other"] - sum(
            grouped["forward"] + grouped["backward"]) / 1e3}
    split["launches"] = {
        "forward_2d": split["launches"]["forward"],
        "backward_2d": split["launches"]["backward"],
        "forward_grouped": launches["streaming_gemm_grouped"] - n_bwd,
        "backward_grouped_da": grouped_bwd["da"],
        "backward_grouped_db": grouped_bwd["db"]}
    split["profiler_grouped_kernels"] = {k: len(v)
                                         for k, v in grouped.items()}
    other: dict = {}
    for _, us, n in kern:
        if KN.kernel_group(n) == KN.OTHER:
            other[n[:120]] = other.get(n[:120], 0.0) + us / 1e3
    split["other_top_kernels_ms"] = dict(sorted(
        other.items(), key=lambda kv: -kv[1])[:10])
    split["library_gemm_kernels"] = len(lib)
    split["library_gemm_kernel_names"] = sorted(set(lib))[:8]
    split["expert_product_ranges"] = len(ranges)
    split["library_ops_in_expert_products"] = inside
    split["profiler_windows"] = window
    return state, split, {**launches, GROUPED_BWD_NAMES["da"]:
                          grouped_bwd["da"], GROUPED_BWD_NAMES["db"]:
                          grouped_bwd["db"]}


def _moe_train_full(torch, args, card, ckpt_root, dev):
    """16c. The Trainer with qwen2-moe-a2.7b at full width cut to 4
    layers, random bf16 weights from ``--seed``, AdamW, ``remat="none"``,
    8 x 512 tokens a step, 20 steps (no checkpoint: the state is ~35 GB);
    then one profiled step from a fresh state."""
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig, ShapeConfig, depth_cut
    from repro_torch.data.pipeline import make_loader
    from repro_torch.models.params import n_elements
    from repro_torch.runtime.train_loop import Trainer, TrainerConfig

    cfg = depth_cut(get_config(MOE_ARCH), MOE_TRAIN_LAYERS)
    run = RunConfig(model=cfg, shape=ShapeConfig(
        "train", "train", TRAIN_SEQ, TRAIN_BATCH), remat="none")
    d = ckpt_root / "moe"
    shutil.rmtree(d, ignore_errors=True)
    tr = Trainer(run, TrainerConfig(ckpt_dir=str(d),
                                    ckpt_every=TRAIN_STEPS + 1,
                                    seed=args.seed, **TRAIN_LR), device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    out = tr.train(TRAIN_STEPS)
    train_s = time.perf_counter() - t
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = out["losses"]
    step_ms = [m["s"] * 1e3 for m in tr.metrics_log]
    med = statistics.median(step_ms[1:])
    tokens = TRAIN_SEQ * TRAIN_BATCH
    flops, weights = _moe_train_flops(cfg, tokens, TRAIN_SEQ)
    bound_ms = flops / BF16_FLOP_PER_S * 1e3
    require(len(losses) == TRAIN_STEPS, f"MoE train: {len(losses)} steps")
    require(all(x == x and abs(x) < float("inf") for x in losses),
            f"MoE train: non-finite loss {losses}")
    require(losses[-1] < losses[0],
            f"MoE train: loss did not fall ({losses[0]} -> {losses[-1]})")
    require(tr.ckpt.all_steps() == [], "MoE train wrote a checkpoint")

    state = tr.init_state()
    loader = make_loader(cfg, run.shape, dev, start_step=TRAIN_STEPS,
                         seed=args.seed)
    _, batch = next(loader)
    loader.close()
    state, prof, launches = _profile_moe_train_step(torch, tr.step_fn,
                                                    state, batch)
    del state
    shutil.rmtree(d, ignore_errors=True)
    prof["device_busy_share_of_median_step"] = prof["device_busy_ms"] / med
    n_moe = cfg.n_layers - cfg.moe.first_dense_layers
    res = {"config": cfg.name, "params": n_elements(
               tr.model.abstract_params()),
           "active_gemm_weights": weights, "steps": TRAIN_STEPS,
           "tokens_per_step": tokens, "losses": losses,
           "aux": [m.get("aux") for m in tr.metrics_log],
           "step_ms": step_ms, "median_step_ms": med,
           "tokens_per_s": tokens / med * 1e3,
           "model_tflop_per_step": flops / 1e12,
           "flop_bound_ms": bound_ms, "bf16_peak_share": bound_ms / med,
           "peak_mem_gb": peak_gb, "train_s": train_s,
           "profiled_step": prof, "card": card}
    print("[moe_train_full] " + json.dumps(res), flush=True)
    L = prof["launches"]
    require(prof["profiler_gemm_kernels"]["gemm_simt"] == 0,
            "MoE train: the profiled step ran the scalar GEMM kernel")
    require(L["forward_grouped"] == 3 * n_moe and
            L["backward_grouped_da"] == L["backward_grouped_db"] == 3 * n_moe,
            f"MoE train: grouped launches {L}")
    require(L["backward_2d"] == 2 * L["forward_2d"],
            f"MoE train: 2-D launches {L}")
    require(prof["expert_product_ranges"] == 9 * n_moe
            and not prof["library_ops_in_expert_products"],
            "MoE train: an expert product called a library GEMM: "
            f"{prof['library_ops_in_expert_products'][:4]}")
    return res, launches


def phase_moe_training(torch, args, rows, card, dev):
    """16. Training of the MoE family on the card (see the module
    docstring); prints each sub-phase's line and its seconds."""
    ckpt_root = Path(__file__).resolve().parent / "build" / "train_smoke"
    secs, res = {}, {}
    t = time.perf_counter()
    timer = Timer(torch, dev)
    res["kernels"] = _moe_train_kernels(torch, args, dev, timer, rows)
    del timer
    torch.cuda.empty_cache()
    secs["kernels"] = time.perf_counter() - t
    t = time.perf_counter()
    res["card_vs_cpu"] = _moe_train_card_vs_cpu(torch, args, dev)
    torch.cuda.empty_cache()
    secs["card_vs_cpu"] = time.perf_counter() - t
    t = time.perf_counter()
    res["full"], launches = _moe_train_full(torch, args, card, ckpt_root,
                                            dev)
    torch.cuda.empty_cache()
    secs["full"] = time.perf_counter() - t
    print(f"[moe_train] seconds {json.dumps(secs)}", flush=True)
    res["seconds"] = secs
    for name in GROUPED_BWD_NAMES.values():
        rows[name]["train_launches"] = launches[name]
    return {**res, "launches": launches}


# ---------------------------------------------------------------- phase 17
MLA_ARCH = "deepseek-v3-671b"
MLA_TRAIN_CHECK_TOKENS = 128     # 17b's 1 x 128 tokens (its docstring)
# 17a: the products the MLA training path adds, (weight, K, N) at M =
# 4,096 tokens: the MLA projections, the MTP head's proj and the untied
# lm_head (the MLP's 7,168 <-> 2,048 ran in 12a at M <= 256)
MLA_TRAIN_GEMMS = (("wdq", 7168, 1536), ("wuq", 1536, 24576),
                   ("wdkv", 7168, 512), ("wkr", 7168, 64),
                   ("wuk / wuv", 512, 16384), ("wo", 16384, 7168),
                   ("mtp proj", 14336, 7168), ("lm_head", 7168, 129280))
MLA_GEMMS_A_LAYER = 10           # wdq, wuq, wdkv, wkr, wuk, wuv, wo, MLP 3
# 17c's schedule: AdamW's near-sign steps on the 7,168-wide lm_head move a
# logit by about lr x 7,168 x rms(input), and the MTP head feeds it its
# block's output unnormed (rms ~7 at the reference's init); from 1e-4 up
# the mtp loss climbs, at 3e-5 both losses fall
MLA_TRAIN_LR = dict(lr_base=3e-5, lr_warmup=10, lr_total=100)


def _mla_train_gemms(torch, args, dev, timer, rows):
    """17a. The streaming GEMM at the MLA training path's new shapes, M =
    4,096 tokens: for each weight the forward x·W, dA = dC·Wᵀ (a
    K-contiguous B) and dB = xᵀ·dC (an M-contiguous A), each on the
    kernel against its plain version, timed beside the plain version,
    ``torch.matmul`` and the bound (``_bwd_entry``), kept as the GEMM
    row's ``mla_train_path``.  Operands are scaled so that every output
    is O(1) (as 15a)."""
    g = torch.Generator(device=dev).manual_seed(args.seed + 17)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev)
                * scale).to(torch.bfloat16)

    M = TRAIN_TOKENS
    per_shape = []
    for name, K, N in MLA_TRAIN_GEMMS:
        x, w = randn(M, K), randn(K, N, scale=K ** -0.5)
        per_shape.append(_bwd_entry(torch, timer, x, w, f"{name} x·W"))
        del x, w
        dc, w = randn(M, N), randn(K, N, scale=N ** -0.5)
        per_shape.append(_bwd_entry(torch, timer, dc, w.t(), f"{name} dA"))
        del w
        x = randn(M, K, scale=M ** -0.5)
        per_shape.append(_bwd_entry(torch, timer, x.t(), dc, f"{name} dB"))
        del x, dc
        torch.cuda.empty_cache()
    _add_path(rows["streaming_gemm"], per_shape, "mla_train_path")
    return per_shape


def _mla_train_card_vs_cpu(torch, args, dev):
    """17b. deepseek-v3-671b at full width cut to 1 layer (one dense MLA
    layer and the MTP head), 1 x 128 tokens, the same seeded weights
    (drawn on the card, copied to the host) on the card and on the CPU:
    ce, mtp and the loss within 1e-3 relative and every gradient leaf
    (the reference's tree: no derived copy) within 5e-2 relative L2, the
    limits of 15b and 16b."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.configs.base import depth_cut
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models.model import Model
    from repro_torch.models.params import params_to

    cfg = depth_cut(get_config(MLA_ARCH), 1)
    params = Model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(args.seed))
    rng = np.random.default_rng(args.seed + 17)
    toks = rng.integers(1, cfg.vocab_size - 1,
                        (1, MLA_TRAIN_CHECK_TOKENS + 1))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]).to(torch.int32),
             "labels": torch.from_numpy(toks[:, 1:]).to(torch.int32)}
    t = time.perf_counter()
    (loss, card_m), grads = loss_and_grads(
        Model(cfg, device=dev, remat="none"), params,
        {k: v.to(dev) for k, v in batch.items()})
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t
    grads = params_to(grads, "cpu")
    params = params_to(params, "cpu")
    torch.cuda.empty_cache()
    t = time.perf_counter()
    (want, cpu_m), want_g = loss_and_grads(
        Model(cfg, device="cpu", remat="none"), params, batch)
    cpu_s = time.perf_counter() - t
    rel = {k: abs(a.item() - b.item()) / abs(b.item()) for k, (a, b) in {
        "loss": (loss, want), "ce": (card_m["ce"], cpu_m["ce"]),
        "mtp": (card_m["mtp"], cpu_m["mtp"])}.items()}
    errs = _leaf_errors(torch, grads, want_g)
    worst = max(errs, key=errs.get)
    res = {"config": cfg.name, "tokens": MLA_TRAIN_CHECK_TOKENS,
           "card": {"loss": loss.item(), **{k: v.item()
                                            for k, v in card_m.items()}},
           "cpu": {"loss": want.item(), **{k: v.item()
                                           for k, v in cpu_m.items()}},
           "rel_diff": rel, "loss_rtol": TRAIN_LOSS_RTOL,
           "leaves": len(errs), "grad_rel_l2": errs,
           "grad_rel_l2_max": errs[worst], "grad_rel_l2_max_leaf": worst,
           "grad_rel_l2_limit": TRAIN_GRAD_REL_L2, "card_s": card_s,
           "cpu_s": cpu_s}
    print("[mla_train_card_vs_cpu] " + json.dumps(res), flush=True)
    require(set(card_m) == {"ce", "aux", "mtp"}, f"metrics {set(card_m)}")
    require(max(rel.values()) <= TRAIN_LOSS_RTOL,
            f"MLA train card vs CPU: {rel}")
    require(errs[worst] <= TRAIN_GRAD_REL_L2,
            f"MLA train card vs CPU: gradient {worst} off by {errs[worst]}")
    return res


def _mla_train_flops(cfg, tokens, seq):
    """Model FLOPs of one MLA training step: 6 per weight per token for
    every GEMM a token runs through (each MLA layer's seven projections
    and MLP, the MTP head's proj and block, the lm_head twice: the main
    and the MTP cross-entropy) and the attention's QKᵀ (192 wide) and
    PV (128) at 3 times their forward over every (query, key) pair the
    chunked attention computes."""
    m, d, H = cfg.mla, cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    per_layer = (d * m.q_lora_rank + m.q_lora_rank * H * qk
                 + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                 + m.kv_lora_rank * H * (m.qk_nope_head_dim + m.v_head_dim)
                 + H * m.v_head_dim * d + 3 * d * cfg.d_ff)
    layers = cfg.n_layers + 1                            # + the MTP block
    weights = layers * per_layer + 2 * d * d + 2 * d * cfg.padded_vocab
    attn = layers * 3 * 2 * tokens * seq * H * (qk + m.v_head_dim)
    return 6 * weights * tokens + attn, weights


class _LabelledMarks:
    """Marker kernels (``torch.cuda._sleep``) around every call of the
    functions ``fns`` ({label: (module, name)}), forward and backward:
    one before and one after the forward (a recompute's too), and in the
    backward one when the first output's gradient arrives and one when
    the inputs' gradients leave (an identity autograd Function at each
    end); the device kernels between a label's pair are that function's
    torch ops.  Each marker names itself by how long it spins
    (``MARK_CYCLES``: a (label, end) pair a power of two apart from the
    next, 10-650 us at the H100's ~2 GHz), so a marker the profiler
    loses costs only the attribution of its own region, never the
    pairing of the others.  ``now(label, end)`` launches one more
    (``loss``: the forward's end; ``optimizer``: around the update);
    ``labels`` keeps every (label, end) launched, in order."""

    NAME = re.compile(r"spin|sleep", re.I)
    MARK_CYCLES = {("scan", False): 20_000, ("scan", True): 40_000,
                   ("attention", False): 80_000,
                   ("attention", True): 160_000, ("loss", False): 320_000,
                   ("optimizer", False): 640_000,
                   ("optimizer", True): 1_280_000}

    def __init__(self, torch, fns):
        self.torch, self.fns, self.labels = torch, fns, []
        marks = self

        class Mark(torch.autograd.Function):
            @staticmethod
            def forward(ctx, label, end, *xs):
                ctx.label, ctx.end = label, end
                return tuple(x.view_as(x) for x in xs)

            @staticmethod
            def backward(ctx, *gs):
                marks.now(ctx.label, ctx.end)
                return (None, None, *gs)
        self.mark = Mark

    def now(self, label, end=False):
        self.torch.cuda._sleep(self.MARK_CYCLES[label, end])
        self.labels.append((label, end))

    @classmethod
    def classify(cls, us, cycles_per_us=1980.0):
        """The (label, end) whose spin is nearest, on a log scale, to a
        marker kernel of ``us`` microseconds."""
        import math
        est = math.log(max(us, 1e-3) * cycles_per_us)
        return min(cls.MARK_CYCLES,
                   key=lambda k: abs(math.log(cls.MARK_CYCLES[k]) - est))

    def _wrap(self, label, orig):
        torch, mark = self.torch, self.mark

        def grad(a):
            return torch.is_tensor(a) and a.requires_grad

        def marked(*args, **kw):
            self.now(label)
            args = list(args)
            pos = [i for i, a in enumerate(args) if grad(a)]
            keys = [k for k, a in kw.items() if grad(a)]
            ins = mark.apply(label, True, *(args[i] for i in pos),
                             *(kw[k] for k in keys))
            for i, x in zip(pos, ins):
                args[i] = x
            for k, x in zip(keys, ins[len(pos):]):
                kw[k] = x
            out = orig(*args, **kw)
            if isinstance(out, tuple):
                (first,) = mark.apply(label, False, out[0])
                out = (first, *out[1:])
            else:
                (out,) = mark.apply(label, False, out)
            self.now(label, True)
            return out
        return marked

    def __enter__(self):
        self.saved = []
        for label, (mod, name) in self.fns.items():
            orig = getattr(mod, name)
            self.saved.append((mod, name, orig))
            setattr(mod, name, self._wrap(label, orig))
        return self

    def __exit__(self, *exc):
        for mod, name, orig in self.saved:
            setattr(mod, name, orig)


def _device_kernels(torch, prof):
    """(start us, us, demangled name) of every device activity a profile
    recorded, in the card's order, read from the profiler's raw events
    (``prof.events()`` builds a tree of every host op too, which takes
    tens of seconds for a step of ~43,000 kernels)."""
    from torch.autograd import DeviceType
    names = {}
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.duration_ns() <= 0:
            continue
        raw = e.name()
        if raw not in names:
            names[raw] = torch._C._demangle(raw) if len(raw) > 1 else raw
        out.append((e.start_ns() / 1e3, e.duration_ns() / 1e3, names[raw]))
    return sorted(out)


def _profile_marked_step(torch, step, state, batch, name, tries=3):
    """One training step of config ``name`` under ``torch.profiler`` (17c,
    18c): the scan (``ssm.chunked_linear_attention``), the attention
    (``layers.chunked_attention``) and AdamW's update marked
    (``_LabelledMarks``), and a marker at the end of the forward
    (``Model.loss`` returned).  Device ms split by
    ``_marked_kernel_split``; the GEMM's launches from the counters.  The
    markers the profiler lost (it drops a few of the ~43,000 kernels of
    an rwkv6 step) are counted beside the split.  Returns (state, the
    split, the step's launch counts)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as SSM
    from repro_torch.models.model import Model
    from repro_torch.optim import optimizers as OPT

    orig_update, orig_loss = OPT.AdamW.update, Model.loss
    fns = {"scan": (SSM, "chunked_linear_attention"),
           "attention": (L, "chunked_attention")}
    for window in range(1, tries + 1):
        marks = _LabelledMarks(torch, fns)

        def update(self, *a, **kw):
            marks.now("optimizer")
            out = orig_update(self, *a, **kw)
            marks.now("optimizer", True)
            return out

        def loss(self, *a, **kw):
            out = orig_loss(self, *a, **kw)
            marks.now("loss")
            return out

        OPT.AdamW.update, Model.loss = update, loss
        try:
            with marks:
                ops.reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    state, _ = step(state, batch)
                    torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
        finally:
            OPT.AdamW.update, Model.loss = orig_update, orig_loss
        launches, gemm_bwd = dict(ops.LAUNCHES), dict(ops.GEMM_BWD)
        kern = _device_kernels(torch, prof)
        if kern:
            break
        print(f"[train_profile] {name} window {window}: the profiler "
              "recorded no device kernel", flush=True)
    require(kern, f"{name} train profile: {tries} windows held no device "
            "kernel")
    split, counts, seen = _marked_kernel_split(kern)
    busy_ms = sum(split.values())
    return state, {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms, "device_ms": split,
        "device_kernels": counts,
        "marks_launched": {k: sum(lb == k for lb, _ in marks.labels)
                           for k in seen},
        "marks_recorded": seen,
        "marks_lost": len(marks.labels) - sum(seen.values()),
        "device_kernels_recorded": len(kern),
        "launches": {"forward": launches["streaming_gemm"]
                     - gemm_bwd["launches"],
                     "backward": gemm_bwd["launches"]},
        "gemm_simt": sum("gemm_simt" in n for _, _, n in kern),
        "bwd_dc_copies": gemm_bwd["dc_copies"],
        "profiler_windows": window}, launches


def _marked_kernel_split(kern):
    """Device ms and kernel counts of a profiled training step's kernels
    ``kern`` ((start us, us, name), in the card's order) by part, and the
    markers recorded by label: each marker kernel names itself
    (``_LabelledMarks.classify``); GEMM kernels before the ``loss``
    marker are the forward's, after it the backward's (with a remat's
    recomputed forward products); kernels between a label's start and
    end markers are that label's (``scan``, ``attention``,
    ``optimizer``); the rest ``other``."""
    from repro_torch.kernels import kernel_nodes as KN
    parts = ("gemm_forward", "gemm_backward", "scan", "attention",
             "optimizer", "other")
    split, counts = dict.fromkeys(parts, 0.0), dict.fromkeys(parts, 0)
    seen = {"scan": 0, "attention": 0, "loss": 0, "optimizer": 0}
    inside, backward = None, False
    for _, us, name in kern:
        if _LabelledMarks.NAME.search(name):
            label, end = _LabelledMarks.classify(us)
            seen[label] += 1
            if label == "loss":
                backward = True
            elif not end:
                inside = label
            elif inside == label:
                inside = None
            continue
        if KN.kernel_group(name) == "streaming_gemm":
            part = "gemm_backward" if backward else "gemm_forward"
        else:
            part = inside or "other"
        split[part] += us / 1e3
        counts[part] += 1
    return split, counts, seen


def _absorbed_equal(torch, params, cfg):
    """Whether every MLA layer's absorbed copies equal its permuted
    ``wuk`` / ``wuv``, bit for bit."""
    from repro_torch.models import transformer as T
    return all(torch.equal(lp["attn"]["wuk_hkr"],
                           lp["attn"]["wuk"].permute(1, 2, 0))
               and torch.equal(lp["attn"]["wuv_hrv"],
                               lp["attn"]["wuv"].permute(1, 0, 2))
               for lp, _ in T.layer_stack(params, cfg))


def _mla_train_full(torch, args, card, ckpt_root, dev):
    """17c. The Trainer on ``deepseek-v3-671b-3l``
    (``configs.deepseek_v3_671b.TRAINING``: the 3 dense MLA layers and
    the MTP head at full width), random bf16 weights from ``--seed``,
    AdamW at ``MLA_TRAIN_LR``, ``remat="full"``, 8 x 512 tokens a step,
    20 steps (no checkpoint: the CPU tests hold the MLA tree's round
    trip), then one step more, profiled; the absorbed copies held
    against the trained weights after it."""
    import shutil
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.configs.deepseek_v3_671b import TRAINING
    from repro_torch.checkpoint.checkpoint import _flatten
    from repro_torch.data.pipeline import make_loader
    from repro_torch.models import transformer as T
    from repro_torch.models.params import n_elements
    from repro_torch.runtime.train_loop import Trainer, TrainerConfig

    cfg = TRAINING
    run = RunConfig(model=cfg, shape=ShapeConfig(
        "train", "train", TRAIN_SEQ, TRAIN_BATCH), remat="full")
    d = ckpt_root / "mla"
    shutil.rmtree(d, ignore_errors=True)
    tr = Trainer(run, TrainerConfig(ckpt_dir=str(d),
                                    ckpt_every=TRAIN_STEPS + 1,
                                    seed=args.seed, **MLA_TRAIN_LR),
                 device=dev)
    last, inner = {}, tr.step_fn

    def step_fn(state, batch):
        last["state"], m = inner(state, batch)
        return last["state"], m

    tr.step_fn = step_fn
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    out = tr.train(TRAIN_STEPS)
    train_s = time.perf_counter() - t
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses, log = out["losses"], tr.metrics_log
    step_ms = [m["s"] * 1e3 for m in log]
    med = statistics.median(step_ms[1:])
    tokens = TRAIN_SEQ * TRAIN_BATCH
    flops, weights = _mla_train_flops(cfg, tokens, TRAIN_SEQ)
    bound_ms = flops / BF16_FLOP_PER_S * 1e3
    require(len(losses) == TRAIN_STEPS, f"MLA train: {len(losses)} steps")
    require(all(x == x and abs(x) < float("inf") for x in losses),
            f"MLA train: non-finite loss {losses}")
    state = last.pop("state")
    absorbed_trained = _absorbed_equal(torch, state["params"], cfg)

    loader = make_loader(cfg, run.shape, dev, start_step=TRAIN_STEPS,
                         seed=args.seed)
    _, batch = next(loader)
    loader.close()
    state, prof, launches = _profile_marked_step(torch, inner, state,
                                                 batch, cfg.name)
    absorbed = absorbed_trained and _absorbed_equal(torch, state["params"],
                                                    cfg)
    opt_derived = ["/".join(p) for p, _ in _flatten(state["opt"])
                   if p[-1] in T.DERIVED]
    del state
    shutil.rmtree(d, ignore_errors=True)
    prof["device_busy_share_of_median_step"] = prof["device_busy_ms"] / med
    n_fwd = MLA_GEMMS_A_LAYER * (cfg.n_layers + 1) + 1 + 2
    recomputes = MLA_GEMMS_A_LAYER * cfg.n_layers
    res = {"config": cfg.name, "params": n_elements(
               tr.model.abstract_params()),
           "gemm_weights_a_pass": weights, "steps": TRAIN_STEPS,
           "tokens_per_step": tokens, "remat": run.remat,
           "forward_products_a_pass": n_fwd,
           "remat_recomputes": recomputes,
           "losses": losses, "ce": [m["ce"] for m in log],
           "mtp": [m["mtp"] for m in log],
           "step_ms": step_ms, "median_step_ms": med,
           "tokens_per_s": tokens / med * 1e3,
           "model_tflop_per_step": flops / 1e12,
           "flop_bound_ms": bound_ms, "bf16_peak_share": bound_ms / med,
           "peak_mem_gb": peak_gb, "train_s": train_s,
           "absorbed_copies_equal_trained_weights": absorbed,
           "derived_keys_in_adamw_state": opt_derived,
           "profiled_step": prof, "card": card}
    print("[mla_train_full] " + json.dumps(res), flush=True)
    require(log[-1]["ce"] < log[0]["ce"] and log[-1]["mtp"] < log[0]["mtp"],
            f"MLA train: ce {log[0]['ce']} -> {log[-1]['ce']}, mtp "
            f"{log[0]['mtp']} -> {log[-1]['mtp']}")
    require(peak_gb < 80, f"MLA train: peak {peak_gb} GB")
    require(absorbed and not opt_derived,
            "MLA train: the absorbed copies left the trained weights")
    require(prof["launches"] == {"forward": n_fwd + recomputes,
                                 "backward": 2 * n_fwd},
            f"MLA train: GEMM launches {prof['launches']}")
    require(prof["gemm_simt"] == 0,
            "MLA train: the profiled step ran the scalar GEMM kernel")
    # a marker pair per attention call: forward and backward of every
    # layer and of the MTP block, and the recompute of every remat layer
    marks = prof["marks_launched"]["attention"]
    require(marks == 2 * (3 * cfg.n_layers + 2),
            f"MLA train: {marks} attention markers")
    return res, launches


def phase_mla_training(torch, args, rows, card, dev):
    """17. Training of the MLA family on the card (see the module
    docstring); prints each sub-phase's line and its seconds."""
    ckpt_root = Path(__file__).resolve().parent / "build" / "train_smoke"
    secs, res = {}, {}
    t = time.perf_counter()
    timer = Timer(torch, dev)
    res["gemms"] = _mla_train_gemms(torch, args, dev, timer, rows)
    del timer
    torch.cuda.empty_cache()
    secs["gemms"] = time.perf_counter() - t
    t = time.perf_counter()
    res["card_vs_cpu"] = _mla_train_card_vs_cpu(torch, args, dev)
    torch.cuda.empty_cache()
    secs["card_vs_cpu"] = time.perf_counter() - t
    t = time.perf_counter()
    res["full"], launches = _mla_train_full(torch, args, card, ckpt_root,
                                            dev)
    torch.cuda.empty_cache()
    secs["full"] = time.perf_counter() - t
    print(f"[mla_train] seconds {json.dumps(secs)}", flush=True)
    res["seconds"] = secs
    rows["streaming_gemm"]["mla_train_launches"] = res["full"][
        "profiled_step"]["launches"]
    return {**res, "launches": launches}


# ---------------------------------------------------------------- phase 18
SSM_TRAIN_CHECK_TOKENS = 128     # 18b's 1 x 128 tokens (its docstring)
# 18a: the products the ssm, hybrid and audio training paths add, (the
# GEMM row's key, weight, K, N) at M = 4,096 tokens
SSM_TRAIN_GEMMS = (
    ("ssm_train_path", "rwkv6 time r/k/v/g/w/o, channel r", 4096, 4096),
    ("ssm_train_path", "rwkv6 channel k", 4096, 14336),
    ("ssm_train_path", "rwkv6 channel v", 14336, 4096),
    ("ssm_train_path", "rwkv6 lm_head", 4096, 65536),
    ("hybrid_train_path", "zamba2 in_proj", 3584, 14576),
    ("hybrid_train_path", "zamba2 out_proj", 7168, 3584),
    ("hybrid_train_path", "zamba2 shared q/k/v/o", 3584, 3584),
    ("hybrid_train_path", "zamba2 lm_head", 3584, 32000),
    ("audio_train_path", "whisper wi", 384, 1536),
    ("audio_train_path", "whisper lm_head", 384, 51968))
# 18c's schedules: whisper-tiny at 15c's; the 4,096- and 3,584-wide
# models an order lower (AdamW's near-sign steps move a logit by about
# lr x d x rms(input) a step, 17c)
SSM_TRAIN_LR = dict(lr_base=3e-4, lr_warmup=10, lr_total=100)


def _ssm_train_gemms(torch, args, dev, timer, rows):
    """18a. The streaming GEMM at the products the ssm, hybrid and audio
    training paths add, M = 4,096 tokens: for each weight the forward
    x·W, dA = dC·Wᵀ and dB = xᵀ·dC, each on the kernel against its plain
    version, timed beside the plain version, ``torch.matmul`` and the
    bound (``_bwd_entry``), kept as the GEMM row's ``ssm_train_path``,
    ``hybrid_train_path`` and ``audio_train_path``.  Operands scaled so
    that every output is O(1), as 17a."""
    g = torch.Generator(device=dev).manual_seed(args.seed + 18)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev)
                * scale).to(torch.bfloat16)

    M = TRAIN_TOKENS
    paths = {}
    for key, name, K, N in SSM_TRAIN_GEMMS:
        per_shape = paths.setdefault(key, [])
        x, w = randn(M, K), randn(K, N, scale=K ** -0.5)
        per_shape.append(_bwd_entry(torch, timer, x, w, f"{name} x·W"))
        del x, w
        dc, w = randn(M, N), randn(K, N, scale=N ** -0.5)
        per_shape.append(_bwd_entry(torch, timer, dc, w.t(), f"{name} dA"))
        del w
        x = randn(M, K, scale=M ** -0.5)
        per_shape.append(_bwd_entry(torch, timer, x.t(), dc, f"{name} dB"))
        del x, dc
        torch.cuda.empty_cache()
    for key, per_shape in paths.items():
        _add_path(rows["streaming_gemm"], per_shape, key)
    return paths


def _ssm_train_check_batch(torch, cfg, seed):
    """18b's batch: 1 x 128 token ids and labels from a numpy seed, and
    for the audio model 1 x 128 frames N(0, 1) in bf16."""
    import numpy as np
    rng = np.random.default_rng(seed)
    n = SSM_TRAIN_CHECK_TOKENS
    toks = rng.integers(1, cfg.vocab_size - 1, (1, n + 1))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]).to(torch.int32),
             "labels": torch.from_numpy(toks[:, 1:]).to(torch.int32)}
    if cfg.family == "audio":
        batch["audio_frames"] = torch.from_numpy(rng.standard_normal(
            (1, n, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    return batch


def _ssm_train_card_vs_cpu(torch, args, dev):
    """18b. rwkv6-7b cut to 1 layer, zamba2-7b cut to 1 layer (with its
    shared block) and whole whisper-tiny, at full width, 1 x 128 tokens
    (whisper: 128 frames and 128 tokens), the same seeded weights (drawn
    on the card, copied to the host) on the card and on the CPU: the
    loss within 1e-3 relative and every gradient leaf within 5e-2
    relative L2, the limits of 15b-17b; the worst leaf of each."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import depth_cut
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models.model import Model
    from repro_torch.models.params import params_to

    out = {}
    for arch, layers in ((RWKV_ARCH, 1), (ZAMBA_ARCH, 1),
                         (WHISPER_ARCH, None)):
        cfg = get_config(arch)
        cfg = depth_cut(cfg, layers) if layers else cfg
        params = Model(cfg, device=dev).init(
            torch.Generator(device=dev).manual_seed(args.seed))
        batch = _ssm_train_check_batch(torch, cfg, args.seed + 18)
        t = time.perf_counter()
        (loss, _), grads = loss_and_grads(
            Model(cfg, device=dev, remat="none"), params,
            {k: v.to(dev) for k, v in batch.items()})
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t
        grads = params_to(grads, "cpu")
        params = params_to(params, "cpu")
        torch.cuda.empty_cache()
        t = time.perf_counter()
        (want, _), want_g = loss_and_grads(
            Model(cfg, device="cpu", remat="none"), params, batch)
        cpu_s = time.perf_counter() - t
        rel = abs(loss.item() - want.item()) / abs(want.item())
        errs = _leaf_errors(torch, grads, want_g)
        worst = max(errs, key=errs.get)
        res = {"config": cfg.name, "tokens": SSM_TRAIN_CHECK_TOKENS,
               "card_loss": loss.item(), "cpu_loss": want.item(),
               "loss_rel_diff": rel, "loss_rtol": TRAIN_LOSS_RTOL,
               "leaves": len(errs), "grad_rel_l2_max": errs[worst],
               "grad_rel_l2_max_leaf": worst,
               "grad_rel_l2_top5": dict(sorted(errs.items(),
                                               key=lambda kv: -kv[1])[:5]),
               "grad_rel_l2_limit": TRAIN_GRAD_REL_L2, "card_s": card_s,
               "cpu_s": cpu_s}
        print("[ssm_train_card_vs_cpu] " + json.dumps(res), flush=True)
        require(rel <= TRAIN_LOSS_RTOL,
                f"{cfg.name} train card vs CPU: loss {loss.item()} vs "
                f"{want.item()}")
        require(errs[worst] <= TRAIN_GRAD_REL_L2,
                f"{cfg.name} train card vs CPU: gradient {worst} off by "
                f"{errs[worst]}")
        out[cfg.family] = res
        del params, grads, want_g
    return out


def _ssm_train_gemms_a_pass(cfg):
    """The streaming GEMM's forward products in one pass of a training
    step: rwkv6 9 a layer (time r, k, v, g, w, o; channel k, v, r),
    zamba2 5 a layer (``in_proj``, ``out_proj``, the MLP's 3) and 4 a
    shared invocation (q, k, v, o), whisper 6 an encoder layer and 10 a
    decoder layer (self q, k, v, o, cross q, o, the cross K / V over the
    encoder, the MLP's 2); and the lm_head once (one chunk of
    ``ce_chunk`` 512)."""
    from repro_torch.models import transformer as T
    if cfg.family == "ssm":
        return 9 * cfg.n_layers + 1
    if cfg.family == "hybrid":
        return 5 * cfg.n_layers + 4 * T.n_shared_invocations(cfg) + 1
    return 6 * cfg.n_encoder_layers + 10 * cfg.n_layers + 1


def _ssm_train_flops(cfg, tokens, seq):
    """Model FLOPs of one training step: 6 per weight per token for every
    GEMM a token runs through (rwkv6's time and channel mix; zamba2's
    ``in_proj``, ``out_proj``, MLP and each invocation of the shared
    q/k/v/o; whisper's encoder and decoder layers, whose frames and
    tokens are as many; the lm_head), and the attention's QKᵀ and PV at
    3 times their forward over every (query, key) pair the chunked
    attention computes (zamba2's shared block; whisper's encoder,
    decoder and cross-attention, all T x T at Te = Td).  The scan's chunk
    products are not counted: under 0.3% of the GEMMs' at these widths.
    Returns (FLOPs, GEMM weights a token runs through)."""
    from repro_torch.models import transformer as T
    d, V, f, L = cfg.d_model, cfg.padded_vocab, cfg.d_ff, cfg.n_layers
    H, hd = cfg.n_heads, cfg.resolved_head_dim
    pair = 3 * 2 * 2 * tokens * seq * H * hd
    if cfg.family == "ssm":
        weights, attn = L * (7 * d * d + 2 * d * f) + d * V, 0
    elif cfg.family == "hybrid":
        s = cfg.ssm
        d_in = s.expand * d
        nh = d_in // s.head_dim
        layer = d * (2 * d_in + 2 * s.d_state + nh) + d_in * d + 3 * d * f
        inv = T.n_shared_invocations(cfg)
        weights = L * layer + inv * 4 * d * H * hd + d * V
        attn = inv * pair
    else:
        Le = cfg.n_encoder_layers
        weights = Le * (4 * d * d + 2 * d * f) + \
            L * (8 * d * d + 2 * d * f) + d * V
        attn = (Le + 2 * L) * pair
    return 6 * weights * tokens + attn, weights


def _ssm_train_run(torch, args, card, cfg, ckpt_root, dev):
    """One of 18c's runs: 20 AdamW steps of 8 x 512 tokens at
    ``remat="none"`` (the Trainer for rwkv6 and zamba2, whose synthetic
    corpus has no frames; ``build_train_step`` for whisper, with the
    corpus's tokens and labels and (8, 512, 384) frames drawn from
    ``--seed``), then one step more, profiled."""
    import shutil
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.data.pipeline import make_loader
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import transformer as T
    from repro_torch.models.model import Model
    from repro_torch.models.params import n_elements
    from repro_torch.optim import get_optimizer
    from repro_torch.runtime.train_loop import Trainer, TrainerConfig

    run = RunConfig(model=cfg, shape=ShapeConfig(
        "train", "train", TRAIN_SEQ, TRAIN_BATCH), remat="none")
    lr = TRAIN_LR if cfg.family == "audio" else SSM_TRAIN_LR
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    if cfg.family == "audio":
        g = torch.Generator(device=dev).manual_seed(args.seed + 18)

        def with_frames(batch):
            frames = torch.randn((TRAIN_BATCH, TRAIN_SEQ, cfg.d_model),
                                 generator=g, device=dev)
            return {**batch, "audio_frames": frames.to(torch.bfloat16)}

        step = build_train_step(run, dev, **lr)
        params = Model(cfg, device=dev).init(
            torch.Generator(device=dev).manual_seed(args.seed))
        state = {"params": params,
                 "opt": get_optimizer("adamw").init(T.trainable(params))}
        loader = make_loader(cfg, run.shape, dev, seed=args.seed)
        losses, step_ms = [], []
        for i, batch in loader:
            batch = with_frames(batch)
            if i == TRAIN_STEPS:        # the profiled step's batch
                break
            t0 = time.perf_counter()
            state, m = step(state, batch)
            losses.append(m["loss"].item())
            step_ms.append((time.perf_counter() - t0) * 1e3)
        loader.close()
        inner, n_params = step, n_elements(T.trainable(params))
    else:
        d = ckpt_root / cfg.name
        shutil.rmtree(d, ignore_errors=True)
        tr = Trainer(run, TrainerConfig(ckpt_dir=str(d),
                                        ckpt_every=TRAIN_STEPS + 1,
                                        seed=args.seed, **lr), device=dev)
        last, inner = {}, tr.step_fn

        def step_fn(state, batch):
            last["state"], m = inner(state, batch)
            return last["state"], m

        tr.step_fn = step_fn
        out = tr.train(TRAIN_STEPS)
        losses = out["losses"]
        step_ms = [m["s"] * 1e3 for m in tr.metrics_log]
        state = last.pop("state")
        loader = make_loader(cfg, run.shape, dev, start_step=TRAIN_STEPS,
                             seed=args.seed)
        _, batch = next(loader)
        loader.close()
        n_params = n_elements(tr.model.abstract_params())
        shutil.rmtree(d, ignore_errors=True)
    train_s = time.perf_counter() - t
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    require(len(losses) == TRAIN_STEPS, f"{cfg.name}: {len(losses)} steps")
    require(all(x == x and abs(x) < float("inf") for x in losses),
            f"{cfg.name} train: non-finite loss {losses}")
    med = statistics.median(step_ms[1:])
    tokens = TRAIN_SEQ * TRAIN_BATCH
    flops, weights = _ssm_train_flops(cfg, tokens, TRAIN_SEQ)
    bound_ms = flops / BF16_FLOP_PER_S * 1e3
    state, prof, launches = _profile_marked_step(torch, inner, state,
                                                 batch, cfg.name)
    del state
    prof["device_busy_share_of_median_step"] = prof["device_busy_ms"] / med
    n_fwd = _ssm_train_gemms_a_pass(cfg)
    res = {"config": cfg.name, "params": n_params,
           "gemm_weights_a_pass": weights, "steps": TRAIN_STEPS,
           "tokens_per_step": tokens, "remat": run.remat,
           "lr": lr["lr_base"], "losses": losses, "step_ms": step_ms,
           "median_step_ms": med, "tokens_per_s": tokens / med * 1e3,
           "model_tflop_per_step": flops / 1e12,
           "flop_bound_ms": bound_ms, "bf16_peak_share": bound_ms / med,
           "peak_mem_gb": peak_gb, "train_s": train_s,
           "forward_products_a_pass": n_fwd, "profiled_step": prof,
           "card": card}
    print("[ssm_train_full] " + json.dumps(res), flush=True)
    require(losses[-1] < losses[0],
            f"{cfg.name} train: loss did not fall ({losses[0]} -> "
            f"{losses[-1]})")
    require(peak_gb < 80, f"{cfg.name} train: peak {peak_gb} GB")
    require(prof["launches"] == {"forward": n_fwd, "backward": 2 * n_fwd},
            f"{cfg.name} train: GEMM launches {prof['launches']}, expected "
            f"{n_fwd} forward and {2 * n_fwd} backward")
    require(prof["gemm_simt"] == 0,
            f"{cfg.name} train: the profiled step ran the scalar GEMM kernel")
    return res, launches


def _ssm_train_remat(torch, args, dev):
    """18d. ``rwkv6-7b-10l``, fresh weights from ``--seed`` and one batch
    of 8 x 512 tokens: the loss and its gradients (a forward and a
    backward pass, no optimizer update, so all three start from the same
    weights) under ``remat`` none, full and dots in turn, after one
    untimed pass under none (the allocator warm): the loss
    beside ``"none"``'s (within 1e-3, and whether bit for bit), the
    gradients bit for bit or not, the peak memory, the GEMM's forward
    launches made during the backward pass (0, 90 and 0), and the
    outputs ``"dots"`` kept and handed back."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.rwkv6_7b import TRAINING as cfg
    from repro_torch.data.pipeline import make_loader
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.models.model import Model
    from repro_torch.models.params import tree_leaves, tree_map

    params = T.trainable(Model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(args.seed)))
    loader = make_loader(cfg, ShapeConfig("train", "train", TRAIN_SEQ,
                                          TRAIN_BATCH), dev, seed=args.seed)
    _, batch = next(loader)
    loader.close()

    def grads_of(mode):
        """(loss, grads, ms, forward launches) of one pass under
        ``mode``, the counters reset just before it."""
        leaves = []

        def watch(p):
            p = p.detach().requires_grad_(True)
            leaves.append(p)
            return p

        tree = tree_map(watch, params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t = time.perf_counter()
        loss, _ = Model(cfg, device=dev, remat=mode).loss(tree, batch)
        fwd = ops.LAUNCHES["streaming_gemm"]
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        return loss.item(), grads, (time.perf_counter() - t) * 1e3, fwd

    warm_ms = grads_of("none")[2]
    res, want = {"warm_up_pass_ms": warm_ms}, None
    for mode in ("none", "full", "dots"):
        loss, grads, ms, fwd = grads_of(mode)
        in_bwd = ops.LAUNCHES["streaming_gemm"] - fwd - \
            ops.GEMM_BWD["launches"]
        r = {"loss": loss, "ms": ms,
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
             "forward_launches": fwd, "backward_launches":
             ops.GEMM_BWD["launches"], "forward_launches_in_backward": in_bwd,
             "dots": dict(ops.GEMM_DOTS)}
        grads = [x.cpu() for x in grads]
        if want is None:
            want, want_loss = grads, loss
        else:
            r["loss_rel_diff_to_none"] = abs(loss - want_loss) / \
                abs(want_loss)
            r["loss_bitwise"] = loss == want_loss
            r["grads_bitwise"] = all(torch.equal(a, b)
                                     for a, b in zip(grads, want))
        res[mode] = r
        del grads
    res["config"], res["leaves"] = cfg.name, len(tree_leaves(params))
    print("[ssm_train_remat] " + json.dumps(res), flush=True)
    recomputed = 9 * cfg.n_layers
    in_bwd = [res[m]["forward_launches_in_backward"]
              for m in ("none", "full", "dots")]
    require(in_bwd == [0, recomputed, 0],
            f"remat none / full / dots: forward launches in the backward "
            f"pass {in_bwd}, expected [0, {recomputed}, 0]")
    require(res["dots"]["dots"] == {"saved": recomputed,
                                    "replayed": recomputed},
            f"remat dots: {res['dots']['dots']}")
    for m in ("full", "dots"):
        rel = res[m]["loss_rel_diff_to_none"]
        require(rel <= TRAIN_REMAT_RTOL, f"remat {m}: loss differs by {rel}")
    return res


def phase_ssm_training(torch, args, rows, card, dev):
    """18. Training of the ssm, hybrid and audio families on the card
    (see the module docstring); prints each sub-phase's line and its
    seconds."""
    from repro_torch.configs import get_config
    from repro_torch.configs.rwkv6_7b import TRAINING as RWKV_TRAINING
    from repro_torch.configs.zamba2_7b import TRAINING as ZAMBA_TRAINING

    ckpt_root = Path(__file__).resolve().parent / "build" / "train_smoke"
    secs, res = {}, {"full": {}, "launches": {}}
    t = time.perf_counter()
    timer = Timer(torch, dev)
    res["gemms"] = _ssm_train_gemms(torch, args, dev, timer, rows)
    del timer
    torch.cuda.empty_cache()
    secs["gemms"] = time.perf_counter() - t
    t = time.perf_counter()
    res["card_vs_cpu"] = _ssm_train_card_vs_cpu(torch, args, dev)
    torch.cuda.empty_cache()
    secs["card_vs_cpu"] = time.perf_counter() - t
    for cfg in (RWKV_TRAINING, ZAMBA_TRAINING, get_config(WHISPER_ARCH)):
        t = time.perf_counter()
        res["full"][cfg.family], res["launches"][cfg.family] = \
            _ssm_train_run(torch, args, card, cfg, ckpt_root, dev)
        torch.cuda.empty_cache()
        secs[f"full {cfg.name}"] = time.perf_counter() - t
    t = time.perf_counter()
    res["remat"] = _ssm_train_remat(torch, args, dev)
    torch.cuda.empty_cache()
    secs["remat"] = time.perf_counter() - t
    print(f"[ssm_train] seconds {json.dumps(secs)}", flush=True)
    res["seconds"] = secs
    for fam in ("ssm", "hybrid", "audio"):
        rows["streaming_gemm"][f"{fam}_train_launches"] = res["full"][fam][
            "profiled_step"]["launches"]
    return res


# ---------------------------------------------------------------- phase 19
MESH_SERVE = (8, 256, 16)       # 19c: slots, prompt tokens, greedy steps
MESH_TRAIN_STEPS = 10           # 19a: steps a run (bit for bit needs few)


COLLECTIVE_OPS = re.compile(r"^c10d::(allreduce|allgather)", re.I)


def _collectives(torch, prof, kern):
    """(collective calls on the host, NCCL kernels, their device ms) of
    a profile."""
    from torch.autograd import DeviceType
    calls = sum(1 for e in prof.profiler.kineto_results.events()
                if e.device_type() == DeviceType.CPU
                and COLLECTIVE_OPS.match(e.name()))
    nccl = [us for _, us, name in kern if "nccl" in name.lower()]
    return calls, len(nccl), sum(nccl) / 1e3


def _mesh_train(torch, args, card, dev, mesh):
    """19a. The Trainer on the mesh and on no mesh (the local one-rank
    layout) on 15c's run, in that order; then one profiled step of each
    from fresh weights, after one unprofiled."""
    import shutil
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.data.pipeline import make_loader
    from repro_torch.runtime.train_loop import Trainer, TrainerConfig

    cfg = get_config(TRAIN_ARCH)
    run = RunConfig(model=cfg, shape=ShapeConfig(
        "train", "train", TRAIN_SEQ, TRAIN_BATCH), remat="none")
    root = Path(__file__).resolve().parent / "build" / "mesh_smoke"
    res = {}
    for name, m in (("mesh", mesh), ("meshless", None)):
        shutil.rmtree(root, ignore_errors=True)
        tr = Trainer(run, TrainerConfig(
            ckpt_dir=str(root), ckpt_every=MESH_TRAIN_STEPS + 1, keep=1,
            seed=args.seed, **TRAIN_LR), device=dev, mesh=m)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = tr.train(MESH_TRAIN_STEPS)
        peak = torch.cuda.max_memory_allocated() / 1e9
        step_ms = [r["s"] * 1e3 for r in tr.metrics_log]
        state = tr.init_state()
        loader = make_loader(cfg, run.shape, dev, seed=args.seed,
                             mesh=tr.mesh, placement=tr.placement[1])
        _, batch = next(loader)
        loader.close()
        state, _ = tr.step_fn(state, batch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state, _ = tr.step_fn(state, batch)
            torch.cuda.synchronize()
        kern = _device_kernels(torch, prof)
        calls, n_coll, coll_ms = _collectives(torch, prof, kern)
        if m is not None:
            tr_extent = tr.built.tensor_parallel
        res[name] = {"losses": out["losses"], "step_ms": step_ms,
                     "median_step_ms": statistics.median(step_ms[1:]),
                     "peak_mem_gb": peak,
                     "profiled_device_ms": sum(us for _, us, _ in kern) / 1e3,
                     "profiled_kernels": len(kern),
                     "collective_calls": calls,
                     "collective_kernels": n_coll,
                     "collective_device_ms": coll_ms}
        del tr, state, batch
        torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    res["losses_equal"] = res["mesh"]["losses"] == res["meshless"]["losses"]
    res["tensor_parallel"] = tr_extent
    res["card"] = card
    print("[mesh_train] " + json.dumps(res), flush=True)
    require(len(res["mesh"]["losses"]) == MESH_TRAIN_STEPS,
            f"mesh train: {len(res['mesh']['losses'])} steps")
    require(tr_extent == 1, f"mesh train: a model extent of {tr_extent} on "
            "one rank")
    require(res["losses_equal"], "mesh train: the one-rank mesh's losses "
            "differ from the local Trainer's")
    for name in ("mesh", "meshless"):
        require(res[name]["collective_calls"] == 0,
                f"mesh train: the {name} step made a collective call on "
                "one rank")
    return res


def _mesh_psum(torch, args, card, dev, mesh):
    """19b. ``compressed_psum`` on the tied embedding's gradient of one
    step of qwen2-0.5b from ``--seed``'s weights."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import make_loader
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models.model import Model
    from repro_torch.runtime.compression import _q, compressed_psum

    cfg = get_config(TRAIN_ARCH)
    model = Model(cfg, device=dev, remat="none")
    g = torch.Generator(device=dev).manual_seed(args.seed)
    params = model.init(g)
    loader = make_loader(cfg, ShapeConfig("t", "train", TRAIN_SEQ,
                                          TRAIN_BATCH), dev, seed=args.seed)
    _, batch = next(loader)
    loader.close()
    _, grads = loss_and_grads(model, params, batch)
    x = grads["embed"].float()
    del params, grads
    torch.cuda.empty_cache()
    y = compressed_psum(x, "data", mesh)
    q, scale = _q(x)
    exact = bool(torch.equal(y, q.to(torch.int32).float() * scale))
    ms = Timer(torch, dev)(lambda: compressed_psum(x, "data", mesh))
    res = {"shape": list(x.shape), "exact": exact, "ms": ms,
           "max_abs_err_vs_fp32": float((y - x).abs().max()), "card": card}
    print("[mesh_psum] " + json.dumps(res), flush=True)
    require(list(x.shape) == [cfg.padded_vocab, cfg.d_model],
            f"mesh psum: the embedding gradient is {list(x.shape)}")
    require(exact, "mesh psum: compressed_psum differs from its codes "
            "times its scale")
    return res


def _mesh_serving(torch, args, card, dev, mesh):
    """19c. The mesh's prefill and decode steps against ``Model``'s."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import (SERVE_PAGE_TOKENS,
                                          build_decode_step,
                                          build_prefill_step)
    from repro_torch.models.model import Model

    B, T, n = MESH_SERVE
    cfg = get_config(TRAIN_ARCH)
    model = Model(cfg, device=dev)
    g = torch.Generator(device=dev).manual_seed(args.seed)
    params = model.init(g)
    prompts = torch.randint(1, cfg.vocab_size, (B, T), generator=g,
                            device=dev, dtype=torch.int32)

    def greedy(logits):
        return torch.argmax(logits[..., :cfg.vocab_size], -1).to(
            torch.int32)

    def shape(kind):
        return RunConfig(model=cfg, shape=ShapeConfig(kind, kind, T + n, B))

    pre = build_prefill_step(shape("prefill"), mesh)
    dec = build_decode_step(shape("decode"), mesh)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    cache, logits = pre.fn(params, {"tokens": prompts})
    got = [greedy(logits)]
    for _ in range(n):
        cache, tok = dec.fn(params, cache, got[-1])
        got.append(tok)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    del cache

    cache = model.init_cache(B, T + n, SERVE_PAGE_TOKENS)
    for slot in range(B):
        cache.alloc_seq(slot, T)
    want = [greedy(model.prefill(params, prompts, cache, list(range(B))))]
    for _ in range(n):
        want.append(greedy(model.decode_step(params, cache, want[-1],
                                             list(range(B)))))
    equal = all(bool(torch.equal(a, b)) for a, b in zip(got, want))
    res = {"config": cfg.name, "slots": B, "prompt_tokens": T,
           "greedy_steps": n, "tokens_equal": equal, "seconds": seconds,
           "launches": launches, "card": card}
    print("[mesh_serving] " + json.dumps(res), flush=True)
    require(equal, "mesh serving: the mesh steps' tokens differ from "
            "Model.prefill / decode_step's")
    for name in DENSE_KERNELS:
        require(launches.get(name, 0) > 0,
                f"mesh serving: {name} was not launched")
    return res


def _mesh_plans():
    """19d. Per-rank bytes of bf16 weights plus AdamW state on the
    production plans (host arithmetic over the placements)."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.configs.base import SHAPES, RunConfig
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import build_train_step, per_rank_bytes

    res = {}
    for arch in ARCH_IDS:
        run = RunConfig(model=get_config(arch), shape=SHAPES["train_4k"])
        res[arch] = {
            name: per_rank_bytes(build_train_step(
                run, make_production_mesh(multi_pod=multi))) / 1e9
            for name, multi in (("16x16", False), ("2x16x16", True))}
    print("[mesh_plan] per-rank GB of bf16 weights + AdamW state (a plan, "
          "no card) " + json.dumps(res), flush=True)
    return res


# ---------------------------------------------------------------- phase 20
DRY_SERVE = (8, 256, 1024)      # 20a: slots, prompt tokens, room a slot
DRY_TIMED_STEPS = 5
DRY_PEAK_RTOL = 0.10
# 20d: full-width cells on the production plans (the deepseek-v3 cell
# takes 74-89 s of host time alone, over this phase's budget: PERF.md)
DRY_CELLS = (("qwen2_0_5b", "train_4k", "single"),
             ("qwen2_moe_a2_7b", "train_4k", "multi"))
DRY_OUT = Path(__file__).resolve().parent / "build" / "dryrun_smoke"
# the cells whose layers split over ``model`` (the dense family: the MLP
# and the vocabulary over 16; its 14 heads do not divide), and the extent
DRY_TP = {"qwen2_0_5b.train_4k.single": 16}


def start_dry_cells():
    """20d's cells, each counted by ``python -m repro_torch.launch.dryrun``
    in a process of its own on the host (one thread, no card), started
    beside the kernels' build, which leaves cores idle; phase 20 reads
    their records.  The processes are stopped at exit."""
    import shutil
    shutil.rmtree(DRY_OUT, ignore_errors=True)
    env = {**os.environ, "PYTHONPATH": str(DRY_OUT.parents[1] / "src"),
           "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", mesh, "--out", str(DRY_OUT)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for arch, shape, mesh in DRY_CELLS]
    atexit.register(lambda: [p.kill() for p in procs if p.poll() is None])
    return procs


def _dry_steps(torch, cfg, dev, seed):
    """20a's steps on ``dev``: (name, fn, args, model FLOPs) built
    lazily, in order (train, prefill, decode; the decode's cache is the
    prefill's)."""
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.launch import dryrun, steps
    from repro_torch.sharding.blocks import ONE_RANK

    B, T, room = DRY_SERVE

    def run(kind, seq, batch, **kw):
        return RunConfig(model=cfg, shape=ShapeConfig(kind, kind, seq,
                                                      batch), **kw)

    train = run("train", TRAIN_SEQ, TRAIN_BATCH, remat="none")
    fn, targs, _ = dryrun.cell_step(train, ONE_RANK, dev)
    yield "train", fn, targs, RL.model_flops_for(cfg, train.shape)
    del targs
    pre = steps.build_prefill_step(run("prefill", room, B), ONE_RANK,
                                   device=dev)
    params = dryrun.zeros_tree(pre.abstract_inputs[0], dev)
    g = torch.Generator(device="cpu").manual_seed(seed)
    prompts = torch.randint(1, cfg.vocab_size, (B, T), generator=g,
                            dtype=torch.int32).to(dev)
    yield ("prefill", pre.fn, (params, {"tokens": prompts}),
           RL.model_flops_for(cfg, run("prefill", T, B).shape))
    dec = steps.build_decode_step(run("decode", room, B), ONE_RANK,
                                  device=dev)
    cache, _ = pre.fn(params, {"tokens": prompts})
    yield ("decode", dec.fn, (params, cache, prompts[:, -1]),
           RL.model_flops_for(cfg, run("decode", room, B).shape))


def _dry_count_key(c):
    return {"flops": c.flops, "bytes": c.bytes, "coll_bytes": c.coll_bytes,
            "coll_effective": c.coll_effective, "coll_count": c.coll_count,
            "kernel_ops": c.kernel_ops}


def _dry_counts(torch, args, cfg, dev):
    """20a-c: each step counted on the card and on ``meta``; its roofline
    beside the median of timed steps; the train step's peak memory."""
    from repro_torch.kernels import ops
    from repro_torch.launch import hlo_analysis as HA

    res = {}
    meta = {name: HA.analyze(fn, *a)[1] for name, fn, a, _
            in _dry_steps(torch, cfg, torch.device("meta"), args.seed)}
    for name, fn, a, mf in _dry_steps(torch, cfg, dev, args.seed):
        torch.cuda.synchronize()
        ops.reset_launches()
        _, card = HA.analyze(fn, *a)
        torch.cuda.synchronize()
        launches = {k: v for k, v in ops.LAUNCHES.items() if v}
        m = meta[name]
        r = {"card": _dry_count_key(card), "meta": _dry_count_key(m),
             "launches": launches}
        r["equal"] = r["card"] == r["meta"]
        r["launches_equal"] = launches == card.kernel_ops
        if name == "train":      # 20c: one step more, not counted
            args_bytes = sum(HA.storage_bytes(a).values())
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fn(*a)
            torch.cuda.synchronize()
            card_peak = torch.cuda.max_memory_allocated() - before \
                + args_bytes
            r["peak_bytes"] = {"meta": m.peak_bytes, "card": card_peak,
                               "rel_diff": abs(m.peak_bytes - card_peak)
                               / card_peak}
        times = []
        for i in range(DRY_TIMED_STEPS + 1):       # the first a warm-up
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn(*a)
            e.record()
            e.synchronize()
            if i:
                times.append(s.elapsed_time(e) / 1e3)
        rl = RL.compute_roofline(m, 1, mf)
        r["roofline"] = {k: getattr(rl, k) for k in (
            "compute_s", "memory_s", "step_time_s", "bottleneck",
            "useful_ratio", "model_flops")}
        r["measured_s"] = statistics.median(times)
        r["measured_over_roofline"] = r["measured_s"] / rl.step_time_s
        res[name] = r
        del a
        torch.cuda.empty_cache()
        print(f"[dryrun_count] {name} " + json.dumps(r), flush=True)
        require(r["equal"], f"dry run: the {name} step counts "
                f"{r['card']} on the card, {r['meta']} on meta")
        require(r["launches_equal"], f"dry run: the {name} step's wrapper "
                f"ops {card.kernel_ops} differ from its launches "
                f"{launches}")
    for name, kernel in (("train", "streaming_gemm"),
                         ("prefill", "flash_attention"),
                         ("decode", "paged_attention")):
        require(res[name]["launches"].get(kernel, 0) > 0,
                f"dry run: the {name} step launched no {kernel}")
    peak = res["train"]["peak_bytes"]
    require(peak["rel_diff"] <= DRY_PEAK_RTOL,
            f"dry run: the train step's peak {peak['meta']} B on meta, "
            f"{peak['card']} B on the card")
    return res


def phase_dryrun(torch, args, card, dev, cells):
    """20. The dry run and the roofline on the card (module docstring);
    prints each sub-phase's line and its seconds; ``cells`` are
    ``start_dry_cells``' processes."""
    from repro_torch.configs import get_config

    total = torch.cuda.get_device_properties(0).total_memory
    require(RL.HBM_BYTES == total, f"roofline.HBM_BYTES {RL.HBM_BYTES} is "
            f"not the card's total_memory {total}")
    cfg = get_config(TRAIN_ARCH)
    secs, res = {}, {}
    t = time.perf_counter()
    res["counts"] = _dry_counts(torch, args, cfg, dev)
    secs["counts"] = time.perf_counter() - t
    mine, _ = _train_flops(cfg, TRAIN_SEQ * TRAIN_BATCH, TRAIN_SEQ)
    flops = {"model_flops_for": res["counts"]["train"]["roofline"][
        "model_flops"], "_train_flops": mine, "card": card}
    print("[dryrun_model_flops] 15c's step " + json.dumps(flops),
          flush=True)
    t = time.perf_counter()
    for (arch, shape, mesh), p in zip(DRY_CELLS, cells):
        log, _ = p.communicate(timeout=900)
        require(p.returncode == 0, f"dry run: {arch}.{shape}.{mesh} "
                f"exited {p.returncode}: {log[-2000:]}")
        name = f"{arch}.{shape}.{mesh}"
        rec = json.loads((DRY_OUT / f"{name}.baseline.json").read_text())
        print(f"[dryrun_cell] {name} " + json.dumps(
            {**rec, "seconds": rec["build_s"] + rec["count_s"],
             "card": card}), flush=True)
        require(rec["status"] == "ok", f"dry run: {name} {rec['status']}")
        if name in DRY_TP:
            require(rec.get("tensor_parallel") == DRY_TP[name],
                    f"dry run: {name} ran with a model extent of "
                    f"{rec.get('tensor_parallel')}, not {DRY_TP[name]}")
        res[name] = rec
    secs["cells (waited)"] = time.perf_counter() - t
    print(f"[dryrun] seconds {json.dumps(secs)} total_memory {total}",
          flush=True)
    return res


def phase_mesh(torch, args, card, dev):
    """19. The one-rank NCCL mesh (module docstring); prints each
    sub-phase's line and its seconds, and destroys the process group."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(1, 1, device="cuda")
    secs, res = {}, {}
    try:
        for name, fn in (
                ("train", lambda: _mesh_train(torch, args, card, dev, mesh)),
                ("psum", lambda: _mesh_psum(torch, args, card, dev, mesh)),
                ("serving", lambda: _mesh_serving(torch, args, card, dev,
                                                  mesh)),
                ("plans", _mesh_plans)):
            t = time.perf_counter()
            res[name] = fn()
            torch.cuda.empty_cache()
            secs[name] = time.perf_counter() - t
    finally:
        dist.destroy_process_group()
    print(f"[mesh] seconds {json.dumps(secs)}", flush=True)
    return res


# ---------------------------------------------------------------- phase 21
TP_RANKS = 2
TP_STEPS = 5
TP_LOSS_RTOL = 1e-3
TP_DIR = Path(__file__).resolve().parent / "build" / "tp_smoke"
TP_GB = 80.0                    # the two ranks' peaks together, at most


def _tp_batches(torch, cfg, seed, which=None):
    """21's (or a run of 22's or 23's) batches: the corpus's first
    ``TP_STEPS`` (``TPM_STEPS``, ``TPS_STEPS``) at 15c's shape and seed,
    on the host; whisper's with (8, 512, 384) bf16 frames N(0, 1) from
    the seed."""
    import numpy as np
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    n = TP_STEPS if which is None else \
        TPS_STEPS if which in TPS_RUNS else TPM_STEPS
    corpus = SyntheticCorpus(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        global_batch=TRAIN_BATCH, seed=seed))
    out = [{k: torch.from_numpy(v) for k, v in corpus.batch(i).items()}
           for i in range(n)]
    if cfg.family == "audio":
        rng = np.random.default_rng(seed + 23)
        for b in out:
            b["audio_frames"] = torch.from_numpy(rng.standard_normal(
                (TRAIN_BATCH, TRAIN_SEQ, cfg.d_model)).astype(
                    np.float32)).to(torch.bfloat16)
    return out


def _tp_run(torch, step, state, batches, dev, each=None):
    """(the state after, losses, seconds a step) of ``step`` over
    ``batches``; ``each(i)`` is called before step i."""
    losses, secs = [], []
    for i, b in enumerate(batches):
        if each is not None:
            each(i)
        b = {k: v.to(dev) for k, v in b.items()}
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        secs.append(time.perf_counter() - t)
    return state, losses, secs


def _tp_widths(cfg, m):
    """{leaf name within a layer, or ``embed``: (K, N) of the B operand
    its forward product reads} over a model extent of ``m``: N / m for a
    column-parallel leaf, K / m for a row-parallel one, where the
    leaf's heads, columns or vocabulary divide over ``m``."""
    d, H, KH = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd, f, V = cfg.resolved_head_dim, cfg.d_ff, cfg.padded_vocab

    def local(n, count):
        return n // m if count % m == 0 else n

    q, kv = local(H * hd, H), local(KH * hd, KH)
    return {"attn/wq": (d, q), "attn/wk": (d, kv), "attn/wv": (d, kv),
            "attn/wo": (q, d), "mlp/wi_gate": (d, local(f, f)),
            "mlp/wi_up": (d, local(f, f)), "mlp/wo": (local(f, f), d),
            "embed": (d, local(V, V))}


TP_RANGE = "tp_streaming_gemm"  # 21's profiler range around a product


def _tp_profiled_step(torch, step, state, batch):
    """21's (or 22's) step more on rank 0, under ``torch.profiler``, each
    streaming GEMM product (forward, dA, dB) and each grouped product
    inside a ``TP_RANGE`` range: the
    device kernels by the launch counter their names belong to
    (``kernel_nodes.kernel_group``), those named ``gemm_simt``, the
    library GEMM ops (``LIBRARY_OPS``) the host dispatched inside a
    range (none may), the ranges and the step's launches, read from the
    profiler's raw events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.kernels import kernel_nodes as KN
    from repro_torch.kernels import ops

    fwd, bwd = ops._StreamingGemm.forward, ops._gemm_bwd
    gfwd, gbwd = ops._grouped, ops._grouped_bwd

    def ranged(f):
        def call(*a):
            with record_function(TP_RANGE):
                return f(*a)
        return call

    ops._StreamingGemm.forward = staticmethod(ranged(fwd))
    ops._gemm_bwd, ops._grouped = ranged(bwd), ranged(gfwd)
    ops._grouped_bwd = ranged(gbwd)
    try:
        ops.reset_launches()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state, _ = step(state, batch)
            torch.cuda.synchronize()
        launches, gemm_bwd = dict(ops.LAUNCHES), dict(ops.GEMM_BWD)
    finally:
        ops._StreamingGemm.forward, ops._gemm_bwd = staticmethod(fwd), bwd
        ops._grouped, ops._grouped_bwd = gfwd, gbwd
    groups, simt, ranges, host = {}, 0, [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if e.duration_ns() <= 0 or name == TP_RANGE:
                continue
            name = torch._C._demangle(name)
            grp = KN.kernel_group(name)
            groups[grp] = groups.get(grp, 0) + 1
            simt += "gemm_simt" in name
        elif name == TP_RANGE:
            ranges.append((e.start_ns(), e.start_ns() + e.duration_ns()))
        elif name in LIBRARY_OPS:
            host.append((e.start_ns(), name))
    inside = sorted({n for t, n in host
                     if any(a <= t <= b for a, b in ranges)})
    return state, {"device_kernels": groups, "gemm_simt_kernels": simt,
                   "gemm_ranges": len(ranges),
                   "library_ops_in_gemm_ranges": inside,
                   "library_ops_elsewhere": len(host),
                   "launches": {"forward": launches["streaming_gemm"]
                                - gemm_bwd["launches"],
                                "backward": gemm_bwd["launches"]},
                   "grouped_launches": launches["streaming_gemm_grouped"]}


def _tp_case(which):
    """(config, remat, learning-rate schedule) of phase 21's run
    (``which`` None), of one of 22's (``"a"``, ``"b"``) or of 23's
    (``TPS_RUNS``), each of 8 x 512 tokens a step (15c's, 16c's, 17c's
    and 18c's)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import depth_cut
    if which is None:
        return get_config(TRAIN_ARCH), "none", TRAIN_LR
    if which == "a":
        return (depth_cut(get_config(MOE_ARCH), MOE_TRAIN_LAYERS), "none",
                TRAIN_LR)
    if which in TPS_RUNS:       # 23's: 18c's configs, rwkv6-7b cut deeper
        from repro_torch.configs import zamba2_7b
        cfg = {"rwkv": depth_cut(get_config(RWKV_ARCH), TPS_RWKV_LAYERS),
               "zamba": zamba2_7b.TRAINING,
               "whisper": get_config(WHISPER_ARCH)}[which]
        return cfg, "none", TRAIN_LR if which == "whisper" else SSM_TRAIN_LR
    from repro_torch.configs.deepseek_v3_671b import TRAINING
    return TRAINING, "full", MLA_TRAIN_LR


def _tp_rank(rank, seed, out, runs=(None,), profiled=(None,)):
    """One rank of phase 21 (``runs`` (None,)) or 22 (``("a", "b")``), a
    spawned process: each run in turn on the (1, 2) gloo mesh's train
    step on the shared card (``_tp_rank_run``), its result saved for the
    parent under its key; the runs in ``profiled`` take one step more,
    rank 0's under the profiler."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh

    out = Path(out)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(out / "store"), TP_RANKS), rank=rank, world_size=TP_RANKS)
    try:
        mesh = make_host_mesh(1, TP_RANKS, device="cuda", backend="gloo")
        dev = torch.device("cuda", torch.cuda.current_device())
        res = {}
        for which in runs:
            res[which] = _tp_rank_run(torch, rank, seed, which, mesh, dev,
                                      which in profiled)
            gc.collect()
            torch.cuda.empty_cache()
            print(f"[tp rank {rank}] run {which}: peak "
                  f"{res[which]['peak_gb']:.2f} GB, "
                  f"{torch.cuda.memory_allocated() / 1e9:.2f} GB left",
                  flush=True)
        torch.save(res, out / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _tp_rank_run(torch, rank, seed, which, mesh, dev, profiled):
    """One run of a rank: its first step's streaming and grouped GEMMs
    recorded by the leaf they read, its all-reduces and all-gathers
    counted a step (every collective records itself through
    ``hlo_analysis.collective``), the routes its MoE layers took each step
    (``moe._route``'s expert ids, on the host), its launches, losses, step
    seconds and peak memory; then, with ``profiled``, one step more, on
    rank 0 under the profiler (``_tp_profiled_step``)."""
    from repro_torch.checkpoint.checkpoint import _flatten
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import hlo_analysis as HA
    from repro_torch.launch import steps as S
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T
    from repro_torch.models.model import Model

    cfg, remat, lr = _tp_case(which)
    run = RunConfig(model=cfg, shape=ShapeConfig(
        "train", "train", TRAIN_SEQ, TRAIN_BATCH), remat=remat)
    built = S.build_train_step(run, mesh, **lr)
    g = torch.Generator(device=dev).manual_seed(seed)
    state = S.init_sharded_state(built, Model(cfg, device=dev).init(g))
    torch.cuda.empty_cache()
    leaf = {t.untyped_storage().data_ptr(): "/".join(p)
            for p, t in _flatten(T.trainable(state["params"]))}
    log = {"fwd": [], "bwd": [], "grouped": [], "collectives": [],
           "routes": [], "on": False}
    fwd, bwd, gfwd = (ops._StreamingGemm.forward, ops._gemm_bwd,
                      ops._GroupedGemm.forward)
    coll, route = HA.collective, MOE._route

    def name(b):
        return leaf.get(b.untyped_storage().data_ptr(), "?")

    def rec_fwd(ctx, a, b):
        if log["on"]:
            log["fwd"].append((name(b), a.shape[0], b.shape[1], a.shape[1]))
        return fwd(ctx, a, b)

    def rec_gfwd(ctx, a, b, counts):
        if log["on"]:
            log["grouped"].append((name(b), tuple(a.shape), tuple(b.shape)))
        return gfwd(ctx, a, b, counts)

    def rec_bwd(a, b):
        if log["on"]:
            log["bwd"].append((a.shape[0], b.shape[1], a.shape[1]))
        return bwd(a, b)

    def rec_coll(op, nbytes, group_size):
        if group_size > 1:      # every collective records itself here
            n = log["collectives"][-1]
            n[op] = n.get(op, 0) + 1
        return coll(op, nbytes, group_size)

    def rec_route(p, x, cfg):
        out = route(p, x, cfg)
        log["routes"][-1].append(out[1].detach().clone())
        return out

    def each(i):
        log["on"] = i == 0
        log["collectives"].append({})
        log["routes"].append([])

    ops._StreamingGemm.forward = staticmethod(rec_fwd)
    ops._GroupedGemm.forward = staticmethod(rec_gfwd)
    ops._gemm_bwd, HA.collective = rec_bwd, rec_coll
    MOE._route = rec_route
    try:
        ops.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        batches = _tp_batches(torch, cfg, seed, which)
        state, losses, secs = _tp_run(torch, built.fn, state, batches, dev,
                                      each)
        res = {"losses": losses, "step_s": secs,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "launches": dict(ops.LAUNCHES), "gemm_bwd": dict(ops.GEMM_BWD),
               "gemm_fwd": dict(ops.GEMM_FWD),
               "grouped_bwd": dict(ops.GROUPED_BWD),
               "fwd": log["fwd"], "bwd": log["bwd"], "grouped": log["grouped"],
               "all_reduces": [n.get("all-reduce", 0)
                               for n in log["collectives"]],
               "all_gathers": [n.get("all-gather", 0)
                               for n in log["collectives"]],
               "routes": [[t.cpu() for t in r] for r in log["routes"]],
               "tensor_parallel": built.tensor_parallel, "config": cfg.name,
               "ce_chunks": -(-TRAIN_SEQ // run.ce_chunk)}
    finally:
        ops._StreamingGemm.forward = staticmethod(fwd)
        ops._GroupedGemm.forward = staticmethod(gfwd)
        ops._gemm_bwd, HA.collective = bwd, coll
        MOE._route = route
    if profiled:
        batch = {k: v.to(dev) for k, v in batches[0].items()}
        if rank == 0:
            res["profile"] = _tp_profiled_step(torch, built.fn, state,
                                               batch)[1]
        else:
            built.fn(state, batch)
        torch.cuda.synchronize()
    return res


def phase_tp(torch, args, card, dev, rows):
    """21. Tensor parallelism on one card (module docstring); prints its
    line and its seconds."""
    import shutil
    import torch.multiprocessing as mp
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import transformer as T
    from repro_torch.models.model import Model
    from repro_torch.optim import get_optimizer

    secs = {}
    t = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    batches = _tp_batches(torch, cfg, args.seed)
    run = RunConfig(model=cfg, shape=ShapeConfig(
        "train", "train", TRAIN_SEQ, TRAIN_BATCH), remat="none")
    g = torch.Generator(device=dev).manual_seed(args.seed)
    params = T.trainable(Model(cfg, device=dev).init(g))
    state = {"params": params, "opt": get_optimizer("adamw").init(params)}
    _, want, _ = _tp_run(torch, build_train_step(run, dev, **TRAIN_LR),
                         state, batches, dev)
    del state, params
    torch.cuda.empty_cache()
    secs["one rank"] = time.perf_counter() - t

    t = time.perf_counter()
    shutil.rmtree(TP_DIR, ignore_errors=True)
    TP_DIR.mkdir(parents=True)
    mp.start_processes(_tp_rank, args=(args.seed, str(TP_DIR)),
                       nprocs=TP_RANKS, join=True, start_method="spawn")
    ranks = [torch.load(TP_DIR / f"rank{r}.pt", weights_only=False)[None]
             for r in range(TP_RANKS)]
    shutil.rmtree(TP_DIR, ignore_errors=True)
    secs["two ranks"] = time.perf_counter() - t
    r0 = ranks[0]
    widths = _tp_widths(cfg, TP_RANKS)
    got = {}
    for path, M, N, K in r0["fwd"]:
        key = path.split("/", 2)[2] if path.startswith("layers/") else path
        got.setdefault(key, set()).add((K, N))
    fwd = r0["launches"]["streaming_gemm"] - r0["gemm_bwd"]["launches"]
    res = {"config": cfg.name, "mesh": [1, TP_RANKS], "backend": "gloo",
           "tensor_parallel": r0["tensor_parallel"],
           "tokens_a_step": TRAIN_SEQ * TRAIN_BATCH, "steps": TP_STEPS,
           "losses": r0["losses"], "one_rank_losses": want,
           "max_loss_rel": max(abs(a - b) / abs(b)
                               for a, b in zip(r0["losses"], want)),
           "peak_gb": [r["peak_gb"] for r in ranks],
           "gemm_launches": {"forward": fwd,
                             "backward": r0["gemm_bwd"]["launches"]},
           "forward_mnk": sorted({(M, N, K) for _, M, N, K in r0["fwd"]}),
           "backward_mnk": sorted(set(r0["bwd"])),
           "leaf_kn": {k: sorted(v) for k, v in sorted(got.items())},
           "profiled_step_rank0": r0["profile"],
           "all_reduces_a_step": r0["all_reduces"],
           "median_step_ms_gloo_staged": [
               statistics.median(r["step_s"][1:]) * 1e3 for r in ranks],
           "note": "step ms: every all-reduce staged through the host by "
                   "gloo; not a tensor-parallel speed figure",
           "seconds": secs, "card": card}
    print("[tp_train] " + json.dumps(res), flush=True)
    require(res["tensor_parallel"] == TP_RANKS,
            f"tp: the step split over {res['tensor_parallel']} ranks")
    require(all(r["losses"] == r0["losses"] for r in ranks),
            "tp: the ranks' losses differ")
    require(len(want) == TP_STEPS and res["max_loss_rel"] <= TP_LOSS_RTOL,
            f"tp: losses {r0['losses']} against one rank's {want}")
    require(got == {k: {v} for k, v in widths.items()},
            f"tp: forward GEMM widths {res['leaf_kn']}, want {widths}")
    per = cfg.n_layers * 7 + 1
    require(fwd == per * TP_STEPS
            and r0["gemm_bwd"]["launches"] == 2 * per * TP_STEPS,
            f"tp: GEMM launches {res['gemm_launches']}")
    prof = r0["profile"]
    require(prof["device_kernels"].get("streaming_gemm", 0) > 0,
            f"tp: the profiled step recorded no GEMM kernel {prof}")
    require(prof["gemm_simt_kernels"] == 0,
            f"tp: {prof['gemm_simt_kernels']} kernels on gemm_simt")
    require(prof["gemm_ranges"] == 3 * per
            and prof["launches"] == {"forward": per, "backward": 2 * per}
            and not prof["library_ops_in_gemm_ranges"],
            f"tp: the profiled step's products {prof}")
    # per layer two forward sums and two input-gradient sums; the lookup;
    # the cross-entropy's max, (sum, gold) and hidden-state gradient a
    # chunk; the clipping norm
    ar = 4 * cfg.n_layers + 1 + 3 * (TRAIN_SEQ // run.ce_chunk) + 1
    require(all(n == ar for n in r0["all_reduces"]),
            f"tp: all-reduces a step {r0['all_reduces']}, want {ar}")
    require(sum(res["peak_gb"]) < TP_GB, f"tp: peaks {res['peak_gb']} GB")
    rows["streaming_gemm"]["tp_train_launches"] = res["gemm_launches"]
    res["launches"] = r0["launches"]
    return res


# ---------------------------------------------------------------- phase 22
TPM_STEPS = 4
TPM_RUNS = ("a", "b")
# losses against one rank, relative, every step (PERF.md, phase 22): (a)
# where the routing decides, against one rank on the ranks' routes (a
# top-k near tie may take another expert set on the split), (b) as 21's
TPM_LOSS_RTOL = {"a": 1e-3, "b": 1e-4}
# 22(a)'s steps on the first weights (TRAIN_LR warms up from a rate of 0
# at step 0), where the losses are held against one rank's own routes too
TPM_FREE_STEPS = 2
TPM_DIR = Path(__file__).resolve().parent / "build" / "tp_moe_smoke"
# 22k: the grouped GEMM at a rank's shapes, (what, E, C, rows an expert,
# d, d_ff, on the path): qwen2-moe's (1, 2) expert split (30 of 60
# experts, 22a's), the (16, 16) plan's column split (60 experts, 88 of
# 1,408 columns) and deepseek-v3's (16, 16) expert split (16 of 256)
TPM_GROUPED = (("qwen2-moe (1, 2) experts", 30, MOE_TRAIN_C, MOE_TRAIN_ROWS,
                2048, 1408, True),
               ("qwen2-moe (16, 16) columns", 60, MOE_TRAIN_C,
                MOE_TRAIN_ROWS, 2048, 88, False),
               ("deepseek-v3 (16, 16) experts", 16, DEEPSEEK_TRAIN[1],
                DEEPSEEK_TRAIN[2], 7168, 2048, False))
# 22k: 21's 2-D products at qwen2-0.5b's (1, 2) local widths, M = 4,096
TPM_2D = (("q (1, 2)", 896, 448), ("gate / up (1, 2)", 896, 2432),
          ("o (1, 2)", 448, 896), ("down (1, 2)", 2432, 896))


def _tpm_widths(cfg, m):
    """{leaf key within a layer (or ``mtp/block/...``, ``mtp/proj``,
    ``lm_head``): (K, N) of a 2-D product's B operand, or (E, K, N) of a
    grouped one} of an MoE-family config over a model extent of ``m``
    (the placements: a block where the heads, columns, experts or
    vocabulary divide, the experts split by expert before by column)."""
    d, H, V = cfg.d_model, cfg.n_heads, cfg.padded_vocab

    def local(n, count):
        return n // m if count % m == 0 else n

    def attn(pre):
        if cfg.mla:
            a = cfg.mla
            qk = a.qk_nope_head_dim + a.qk_rope_head_dim
            return {pre + "wdq": (d, a.q_lora_rank),
                    pre + "wuq": (a.q_lora_rank, local(H * qk, H)),
                    pre + "wdkv": (d, a.kv_lora_rank),
                    pre + "wkr": (d, a.qk_rope_head_dim),
                    pre + "wuk": (a.kv_lora_rank,
                                  local(H * a.qk_nope_head_dim, H)),
                    pre + "wuv": (a.kv_lora_rank, local(H * a.v_head_dim, H)),
                    pre + "wo": (local(H * a.v_head_dim, H), d)}
        hd, KH = cfg.resolved_head_dim, cfg.n_kv_heads
        q, kv = local(H * hd, H), local(KH * hd, KH)
        return {pre + "wq": (d, q), pre + "wk": (d, kv), pre + "wv": (d, kv),
                pre + "wo": (q, d)}

    def mlp(pre, f):
        return {pre + "wi_gate": (d, local(f, f)),
                pre + "wi_up": (d, local(f, f)), pre + "wo": (local(f, f), d)}

    mo = cfg.moe
    out = {**attn("attn/"), "lm_head": (d, local(V, V))}
    if cfg.n_layers > mo.first_dense_layers:
        E, f = mo.n_routed_experts, mo.d_ff_expert
        El = local(E, E)
        fl = f if El < E else local(f, f)
        out.update({"moe/router": (d, El), "moe/wi_gate": (El, d, fl),
                    "moe/wi_up": (El, d, fl), "moe/wo": (El, fl, d)})
        if mo.n_shared_experts:
            out.update({k.replace("mlp/", "moe/shared_"): v for k, v in
                        mlp("mlp/", f * mo.n_shared_experts).items()})
    if mo.first_dense_layers:
        out.update(mlp("mlp/", cfg.d_ff))
    if cfg.mtp:
        out["mtp/proj"] = (2 * d, d)
        out.update({"mtp/block/" + k: v for k, v in
                    {**attn("attn/"), **mlp("mlp/", cfg.d_ff)}.items()})
    return out


def _tpm_kernels(torch, args, dev, timer, rows):
    """22k. The grouped forward, dA and dB at a rank's shapes
    (``TPM_GROUPED``), each against its plain version and timed beside
    it, ``torch.bmm`` and the bound (the grouped rows' ``tp_moe_path``;
    on the path: 22a's expert split); and 21's 2-D products at
    qwen2-0.5b's (1, 2) local widths, forward, dA and dB at M = 4,096
    (the GEMM row's ``tp_path``)."""
    g = torch.Generator(device=dev).manual_seed(args.seed + 22)
    bf16 = torch.bfloat16

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev, dtype=bf16) \
            * scale

    fwd, bwd = [], {"da": [], "db": []}
    for what, E, C, mean, d, f, on_path in TPM_GROUPED:
        counts = _train_counts(torch, dev, g, E, C, mean)
        past = torch.arange(C, device=dev)[None, :] >= counts[:, None]
        for K, N in ((d, f), (f, d)):
            name = f"{what} {K}->{N}"
            w = randn(E, K, N, scale=N ** -0.5)
            a = randn(E, C, K)
            a[past] = 0
            fwd.append(_grouped_entry(torch, timer, name, a,
                                      w * (N ** 0.5 * K ** -0.5), counts,
                                      on_path))
            dc = randn(E, C, N)
            dc[past] = float("nan")
            bwd["da"].append(_grouped_bwd_entry(
                torch, timer, name, "da", dc, w, counts, on_path))
            a = randn(E, C, K, scale=mean ** -0.5)
            a[past] = float("nan")
            bwd["db"].append(_grouped_bwd_entry(
                torch, timer, name, "db", a, dc, counts, on_path))
            del w, a, dc
            torch.cuda.empty_cache()
    _add_path(rows["streaming_gemm_grouped"], fwd, "tp_moe_path")
    for which, name in GROUPED_BWD_NAMES.items():
        _add_path(rows[name], bwd[which], "tp_moe_path")
    M, flat = TRAIN_TOKENS, []
    for what, K, N in TPM_2D:
        x = randn(M, K, scale=M ** -0.5)
        b = randn(K, N, scale=N ** -0.5)
        dc = randn(M, N)
        flat += [_bwd_entry(torch, timer, randn(M, K), b * (
                     N ** 0.5 * K ** -0.5), f"{what} x·W"),
                 _bwd_entry(torch, timer, dc, b.t(), f"{what} dA"),
                 _bwd_entry(torch, timer, x.t(), dc, f"{what} dB")]
        del x, b, dc
    _add_path(rows["streaming_gemm"], flat, "tp_path")
    return {"grouped_forward": fwd, **bwd, "gemm": flat}


def _tpm_forced_route(torch, p, x, cfg, top_e):
    """``moe._route`` on one rank with the expert ids ``top_e`` given:
    the same logits and softmax, the given experts' weights
    renormalised, the aux loss over their counts; and the tokens whose
    own top-k (the free route) is another expert set."""
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE
    m = cfg.moe
    E, k = m.n_routed_experts, m.top_k
    probs = torch.softmax(L._gemm(x, p["router"]).float(), dim=-1)
    top_e = top_e.to(x.device).view(*probs.shape[:-1], k)
    top_p = probs.gather(-1, top_e)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    me = probs.reshape(-1, E).mean(0)
    ce = MOE._count(top_e, E, torch.float32) / top_e.numel()
    free = torch.sort(probs.detach(), dim=-1, descending=True,
                      stable=True).indices[..., :k]
    flips = (free.sort(-1).values != top_e.sort(-1).values).any(-1).sum()
    return (top_p, top_e, E * torch.sum(me * ce) * m.router_aux_coef), flips


def _tpm_one_rank(torch, args, dev, which, routes=None, tag="tp_moe"):
    """22's (or 23's) one-rank run ``which`` in this process, on the
    weights and batches the ranks take (``_tp_case``): with ``routes``
    (the ranks' expert ids a step and MoE layer) each MoE layer takes the
    ranks' route (``_tpm_forced_route``), and the tokens whose own route
    differs are counted a step and layer.  ``tag`` names its line."""
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T
    from repro_torch.models.model import Model
    from repro_torch.optim import get_optimizer

    cfg, remat, lr = _tp_case(which)
    run = RunConfig(model=cfg, shape=ShapeConfig(
        "train", "train", TRAIN_SEQ, TRAIN_BATCH), remat=remat)
    g = torch.Generator(device=dev).manual_seed(args.seed)
    params = T.add_derived(T.trainable(Model(cfg, device=dev).init(g)), cfg)
    state = {"params": params,
             "opt": get_optimizer("adamw").init(T.trainable(params))}
    flips, route = [], MOE._route

    def forced(p, x, cfg):
        out, n = _tpm_forced_route(torch, p, x, cfg,
                                   routes[len(flips) - 1][len(flips[-1])])
        flips[-1].append(n)
        return out

    def each(i):
        flips.append([])

    if routes is not None:
        MOE._route = forced
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state, losses, secs = _tp_run(
            torch, build_train_step(run, dev, **lr), state,
            _tp_batches(torch, cfg, args.seed, which), dev, each)
    finally:
        MOE._route = route
    peak = torch.cuda.max_memory_allocated() / 1e9
    del state, params
    gc.collect()
    torch.cuda.empty_cache()
    out = {"losses": losses, "peak_gb": peak,
           "median_step_ms": statistics.median(secs[1:]) * 1e3,
           "left_gb": torch.cuda.memory_allocated() / 1e9}
    if routes is not None:
        out["own_route_differs"] = [[int(n) for n in f] for f in flips]
    on = " on the ranks' routes" if routes is not None else ""
    print(f"[{tag}] one rank {which}{on} ({cfg.name}, {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} tokens): {json.dumps(out)}", flush=True)
    return out


def _tpm_check(torch, which, ranks, want, card, free=None):
    """22(a) / (b)'s line, printed, and its checks, a list of (holds,
    message) (module docstring): ``want`` the one-rank run on the ranks'
    routes, ``free`` (for (a)) the one-rank run on its own."""
    import math
    r0 = ranks[0]
    checks = []

    def check(ok, msg):
        checks.append((bool(ok), msg))

    cfg = _tp_case(which)[0]
    m = TP_RANKS
    widths = _tpm_widths(cfg, m)
    got = {}

    def key(path):
        parts = path.split("/")
        return "/".join(parts[2:]) if parts[0] in ("layers",
                                                   "dense_layers") else path

    for path, M, N, K in r0["fwd"]:
        got.setdefault(key(path), set()).add((K, N))
    for path, a, b in r0["grouped"]:
        got.setdefault(key(path), set()).add(tuple(b))
    fwd = r0["launches"]["streaming_gemm"] - r0["gemm_bwd"]["launches"]
    rel = [abs(a - b) / abs(b) for a, b in zip(r0["losses"],
                                               want["losses"])]
    res = {"run": which, "config": r0["config"], "mesh": [1, m],
           "backend": "gloo", "tensor_parallel": r0["tensor_parallel"],
           "tokens_a_step": TRAIN_SEQ * TRAIN_BATCH, "steps": TPM_STEPS,
           "losses": r0["losses"], "one_rank_losses": want["losses"],
           "loss_rel": rel, "max_loss_rel": max(rel),
           "loss_rtol": TPM_LOSS_RTOL[which],
           "peak_gb": [r["peak_gb"] for r in ranks],
           "one_rank_peak_gb": want["peak_gb"],
           "one_rank_median_step_ms": want["median_step_ms"],
           "gemm_launches": {"forward": fwd,
                             "backward": r0["gemm_bwd"]["launches"]},
           "grouped_launches": {
               "forward": r0["launches"]["streaming_gemm_grouped"]
               - sum(r0["grouped_bwd"].values()), **r0["grouped_bwd"]},
           "forward_mnk": sorted({(M, N, K) for _, M, N, K in r0["fwd"]}),
           "grouped_shapes": sorted({(a, b) for _, a, b in r0["grouped"]}),
           "leaf_widths": {k: sorted(v) for k, v in sorted(got.items())},
           "all_reduces_a_step": r0["all_reduces"],
           "all_gathers_a_step": r0["all_gathers"],
           "median_step_ms_gloo_staged": [
               statistics.median(r["step_s"][1:]) * 1e3 for r in ranks],
           "note": "step ms: every collective staged through the host by "
                   "gloo; not a tensor-parallel speed figure",
           "card": card}
    if free is not None:
        free_rel = [abs(a - b) / abs(b) for a, b in zip(r0["losses"],
                                                        free["losses"])]
        res.update({"one_rank_on": "the ranks' routes",
                    "own_route_differs": want["own_route_differs"],
                    "tokens_a_layer": TRAIN_SEQ * TRAIN_BATCH,
                    "free_one_rank_losses": free["losses"],
                    "free_loss_rel": free_rel,
                    "free_held_steps": TPM_FREE_STEPS})
    if "profile" in r0:
        res["profiled_step_rank0"] = r0["profile"]
    print("[tp_moe_train] " + json.dumps(res), flush=True)
    check(all(len(r["routes"]) == len(r0["routes"]) and all(
        torch.equal(a, b) for ra, rb in zip(r["routes"], r0["routes"])
        for a, b in zip(ra, rb)) for r in ranks),
        f"tp {which}: the ranks routed apart")
    if free is not None:
        check(all(x <= TPM_LOSS_RTOL[which]
                  for x in free_rel[:TPM_FREE_STEPS]),
              f"tp {which}: losses {r0['losses']} against one rank's "
              f"own {free['losses']} on the first weights")
    check(res["tensor_parallel"] == m,
          f"tp {which}: the step split over {res['tensor_parallel']} ranks")
    check(all(r["losses"] == r0["losses"] for r in ranks),
          f"tp {which}: the ranks' losses differ")
    check(all(x <= TPM_LOSS_RTOL[which] for x in rel)
          and all(math.isfinite(x) for x in r0["losses"]),
          f"tp {which}: losses {r0['losses']} against one rank's "
          f"{want['losses']}")
    check(got == {k: {v} for k, v in widths.items()},
          f"tp {which}: GEMM widths {res['leaf_widths']}, want {widths}")
    # a step's products (16c's and 17c's counts) and collectives: (a)
    # every layer MoE, 4 attention products, the router and 3 shared
    # expert ones, the lm_head a CE chunk; 5 all-reduces a layer (the
    # attention's and the MoE's output sums, the input-gradient sums of
    # both and the routing weights' gradient sum), the lookup, the CE's
    # 3 a chunk, the clipping norm; the logits gathered once a layer.
    # (b) every layer dense MLA, 10 products a layer and the MTP block,
    # its proj, the lm_head twice, the 3 layers' 30 recomputed under
    # remat="full"; 4 all-reduces a block and the attention's replayed
    # in each layer's recompute, 2 lookups, the two CEs' 3 a chunk, the
    # norm; the one gather of wuk / wuv whole for the absorbed copies
    L, chunks = cfg.n_layers, r0["ce_chunks"]
    if which == "a":
        per, back, ar, ag = 8 * L + chunks, 8 * L + chunks, \
            5 * L + 1 + 3 * chunks + 1, L
        check(res["grouped_launches"] == {
            "forward": 3 * L * TPM_STEPS, "da": 3 * L * TPM_STEPS,
            "db": 3 * L * TPM_STEPS},
            f"tp {which}: grouped launches {res['grouped_launches']}")
    else:
        per, back, ar, ag = 20 * L + 11 + 2 * chunks, \
            10 * L + 11 + 2 * chunks, 5 * L + 4 + 2 + 6 * chunks + 1, 1
    check(res["gemm_launches"] == {"forward": per * TPM_STEPS,
                                   "backward": 2 * back * TPM_STEPS},
          f"tp {which}: GEMM launches {res['gemm_launches']}")
    check(all(n == ar for n in r0["all_reduces"])
          and all(n == ag for n in r0["all_gathers"]),
          f"tp {which}: all-reduces / all-gathers a step "
          f"{r0['all_reduces']} / {r0['all_gathers']}, want {ar} / {ag}")
    prof = res.get("profiled_step_rank0")
    if prof is not None:
        check(prof["gemm_simt_kernels"] == 0,
              f"tp {which}: {prof['gemm_simt_kernels']} kernels on "
              "gemm_simt")
        check(prof["gemm_ranges"] > 0
              and not prof["library_ops_in_gemm_ranges"],
              f"tp {which}: the profiled step's products {prof}")
    check(sum(res["peak_gb"]) < TP_GB, f"tp {which}: peaks "
          f"{res['peak_gb']} GB")
    res["launches"] = {**r0["launches"], **{
        name: r0["grouped_bwd"][w] for w, name in GROUPED_BWD_NAMES.items()}}
    return res, checks


def phase_tp_moe(torch, args, card, dev, rows):
    """22. Tensor parallelism of the moe family on one card (module
    docstring); prints its lines and its seconds."""
    import shutil
    import torch.multiprocessing as mp

    secs = {}
    t = time.perf_counter()
    kern = _tpm_kernels(torch, args, dev, Timer(torch, dev), rows)
    torch.cuda.empty_cache()
    secs["kernels"] = time.perf_counter() - t
    want = {}
    for which in TPM_RUNS:
        t = time.perf_counter()
        want[which] = _tpm_one_rank(torch, args, dev, which)
        secs[f"one rank {which}"] = time.perf_counter() - t
    free = {"a": want.pop("a")}

    t = time.perf_counter()
    card_free, card_total = torch.cuda.mem_get_info()
    print(f"[tp_moe] before the ranks: this process holds "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB "
          f"({torch.cuda.memory_reserved() / 1e9:.2f} reserved); the card "
          f"{card_free / 1e9:.2f} of {card_total / 1e9:.2f} GB free",
          flush=True)
    shutil.rmtree(TPM_DIR, ignore_errors=True)
    TPM_DIR.mkdir(parents=True)
    mp.start_processes(_tp_rank, args=(args.seed, str(TPM_DIR),
                                       TPM_RUNS, ("a",)),
                       nprocs=TP_RANKS, join=True, start_method="spawn")
    ranks = [torch.load(TPM_DIR / f"rank{r}.pt", weights_only=False)
             for r in range(TP_RANKS)]
    shutil.rmtree(TPM_DIR, ignore_errors=True)
    secs["two ranks"] = time.perf_counter() - t
    t = time.perf_counter()
    want["a"] = _tpm_one_rank(torch, args, dev, "a", ranks[0]["a"]["routes"])
    secs["one rank a on the ranks' routes"] = time.perf_counter() - t
    res, checks = {}, []
    for which in TPM_RUNS:
        res[which], c = _tpm_check(torch, which, [r[which] for r in ranks],
                                   want[which], card, free.get(which))
        checks += c
    print(f"[tp_moe] seconds {json.dumps(secs)}", flush=True)
    for ok, msg in checks:
        require(ok, msg)
    rows["streaming_gemm"]["tp_moe_train_launches"] = {
        w: r["gemm_launches"] for w, r in res.items()}
    return {**res, "kernels": kern}


# ---------------------------------------------------------------- phase 23
TPS_RUNS = ("rwkv", "zamba", "whisper")
TPS_STEPS = 3
TPS_RWKV_LAYERS = 4             # rwkv6-7b's depth in 23(a): full width
# losses against one rank, relative, every step (PERF.md, phase 23)
TPS_LOSS_RTOL = 1e-3
TPS_DIR = Path(__file__).resolve().parent / "build" / "tp_ssm_smoke"


def _tps_widths(cfg, m):
    """{leaf key (the path without a layer's index): (K, N) of the B
    operand its forward product reads} of an ssm, hybrid or audio config
    over a model extent of ``m``: N / m for a column-parallel leaf, K /
    m for a row-parallel one, where its heads, columns or vocabulary
    divide over m."""
    d, V, f = cfg.d_model, cfg.padded_vocab, cfg.d_ff

    def local(n, count):
        return n // m if count % m == 0 else n

    def attn(pre):
        H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        q, kv = local(H * hd, H), local(KH * hd, KH)
        return {pre + "wq": (d, q), pre + "wk": (d, kv),
                pre + "wv": (d, kv), pre + "wo": (q, d)}

    def mlp(pre):
        names = ("wi_gate", "wi_up") if cfg.glu else ("wi",)
        return {**{pre + n: (d, local(f, f)) for n in names},
                pre + "wo": (local(f, f), d)}

    out = {"lm_head": (d, local(V, V))}
    if cfg.family == "ssm":
        c = local(d, d)
        out.update({f"layers/time/{n}": (d, c)
                    for n in ("wr", "wk", "wv", "wg", "ww")})
        out.update({"layers/time/wo": (c, d),
                    "layers/channel/wk": (d, local(f, f)),
                    "layers/channel/wv": (local(f, f), d),
                    "layers/channel/wr": (d, c)})
    elif cfg.family == "hybrid":
        s = cfg.ssm
        d_in = s.expand * d
        cols = 2 * d_in + 2 * s.d_state + d_in // s.head_dim
        out.update({"layers/mamba/in_proj": (d, local(cols, cols)),
                    "layers/mamba/out_proj": (local(d_in, d_in), d),
                    **mlp("layers/mlp/"), **attn("shared_attn/attn/")})
    else:
        out.update({**attn("enc_layers/attn/"), **mlp("enc_layers/mlp/"),
                    **attn("layers/attn/"), **attn("layers/xattn/"),
                    **mlp("layers/mlp/")})
    return out


def _tps_counts(cfg, chunks):
    """(forward GEMM launches, all-reduces, all-gathers) of one step of
    23's run of ``cfg`` on (1, 2), where every split divides: (a) a
    layer's 9 products (time r, k, v, g, w, o; channel k, r, v), 4
    all-reduces (the lerps' gradient sums of both mixes, the sums of
    ``wo`` and ``wv``) and the channel gate's all-gather; (b) a Mamba2
    layer's 5 (``in_proj``, ``out_proj``, the MLP's 3) and 9 (the input's
    and the gathered ``in_proj`` output's and ``conv_w``'s gradient
    sums, ``norm_scale``'s, the sum of squares both ways, the
    ``out_proj`` and MLP output sums, the MLP input's gradient sum) and
    2 all-gathers (``in_proj``'s output and ``conv_w``), the shared
    block's 4 and 2 at each invocation; (c) an encoder layer's 6 and 4,
    a decoder layer's 10 and 6 (the cross-attention's query input and
    output), the encoder output's gradient sum once; and the lm_head
    each CE chunk with 3 all-reduces (its input's gradient, the max, the
    sum), the lookup's sum and the clipping norm's."""
    from repro_torch.models import transformer as T
    L = cfg.n_layers
    if cfg.family == "ssm":
        return 9 * L + chunks, 4 * L + 3 * chunks + 2, L
    if cfg.family == "hybrid":
        inv = T.n_shared_invocations(cfg)
        return 5 * L + 4 * inv + chunks, \
            9 * L + 2 * inv + 3 * chunks + 2, 2 * L
    E = cfg.n_encoder_layers
    return 6 * E + 10 * L + chunks, 4 * E + 6 * L + 1 + 3 * chunks + 2, 0


def _tps_check(torch, which, ranks, want, card):
    """23(a) / (b) / (c)'s line, printed, and its checks, a list of
    (holds, message) (module docstring)."""
    import math
    r0 = ranks[0]
    checks = []

    def check(ok, msg):
        checks.append((bool(ok), msg))

    cfg = _tp_case(which)[0]
    m = TP_RANKS
    widths = _tps_widths(cfg, m)
    got = {}
    for path, M, N, K in r0["fwd"]:
        parts = path.split("/")
        key = "/".join(parts[:1] + parts[2:]) \
            if parts[0] in ("layers", "enc_layers") else path
        got.setdefault(key, set()).add((K, N))
    fwd = r0["launches"]["streaming_gemm"] - r0["gemm_bwd"]["launches"]
    rel = [abs(a - b) / abs(b) for a, b in zip(r0["losses"],
                                               want["losses"])]
    res = {"run": which, "config": r0["config"], "mesh": [1, m],
           "backend": "gloo", "tensor_parallel": r0["tensor_parallel"],
           "tokens_a_step": TRAIN_SEQ * TRAIN_BATCH, "steps": TPS_STEPS,
           "losses": r0["losses"], "one_rank_losses": want["losses"],
           "loss_rel": rel, "max_loss_rel": max(rel),
           "loss_rtol": TPS_LOSS_RTOL,
           "peak_gb": [r["peak_gb"] for r in ranks],
           "one_rank_peak_gb": want["peak_gb"],
           "one_rank_median_step_ms": want["median_step_ms"],
           "gemm_launches": {"forward": fwd,
                             "backward": r0["gemm_bwd"]["launches"]},
           "b_copies": r0["gemm_fwd"]["b_copies"],
           "forward_mnk": sorted({(M, N, K) for _, M, N, K in r0["fwd"]}),
           "leaf_widths": {k: sorted(v) for k, v in sorted(got.items())},
           "all_reduces_a_step": r0["all_reduces"],
           "all_gathers_a_step": r0["all_gathers"],
           "median_step_ms_gloo_staged": [
               statistics.median(r["step_s"][1:]) * 1e3 for r in ranks],
           "note": "step ms: every collective staged through the host by "
                   "gloo; not a tensor-parallel speed figure",
           "card": card}
    if "profile" in r0:
        res["profiled_step_rank0"] = r0["profile"]
    print("[tp_ssm_train] " + json.dumps(res), flush=True)
    check(res["tensor_parallel"] == m,
          f"tp {which}: the step split over {res['tensor_parallel']} ranks")
    check(all(r["losses"] == r0["losses"] for r in ranks),
          f"tp {which}: the ranks' losses differ")
    check(all(x <= TPS_LOSS_RTOL for x in rel)
          and all(math.isfinite(x) for x in r0["losses"]),
          f"tp {which}: losses {r0['losses']} against one rank's "
          f"{want['losses']}")
    check(got == {k: {v} for k, v in widths.items()},
          f"tp {which}: GEMM widths {res['leaf_widths']}, want {widths}")
    per, ar, ag = _tps_counts(cfg, r0["ce_chunks"])
    check(res["gemm_launches"] == {"forward": per * TPS_STEPS,
                                   "backward": 2 * per * TPS_STEPS},
          f"tp {which}: GEMM launches {res['gemm_launches']}, want "
          f"{per} forward a step")
    check(all(n == ar for n in r0["all_reduces"])
          and all(n == ag for n in r0["all_gathers"]),
          f"tp {which}: all-reduces / all-gathers a step "
          f"{r0['all_reduces']} / {r0['all_gathers']}, want {ar} / {ag}")
    prof = res.get("profiled_step_rank0")
    check(prof is not None and prof["gemm_simt_kernels"] == 0
          and prof["device_kernels"].get("streaming_gemm", 0) > 0,
          f"tp {which}: the profiled step's GEMM kernels {prof}")
    check(prof is not None and prof["gemm_ranges"] == 3 * per
          and not prof["library_ops_in_gemm_ranges"],
          f"tp {which}: the profiled step's products {prof}")
    check(sum(res["peak_gb"]) < TP_GB, f"tp {which}: peaks "
          f"{res['peak_gb']} GB")
    res["launches"] = r0["launches"]
    return res, checks


def _tps_odd_block(torch, args, dev):
    """23k. zamba2-7b's ``in_proj`` block on the (16, 16) plan, 3,584 x 911
    (a bf16 row of odd length), at M = 4,096 through the streaming GEMM's
    Function: its B and dC read through copies in padded rows (one each),
    the forward, dA and dB on the tensor-core kernel, each against the
    fp32 product of the same bf16 operands."""
    from repro_torch.kernels import ops
    g = torch.Generator(device=dev).manual_seed(args.seed + 23)
    M, K, N = TRAIN_TOKENS, 3584, 911

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(
            torch.bfloat16)

    a = randn(M, K).requires_grad_(True)
    w = randn(K, N, scale=K ** -0.5).requires_grad_(True)
    dc = randn(M, N)
    ops.reset_launches()
    y = ops.streaming_gemm(a, w)
    y.backward(dc)
    torch.cuda.synchronize()
    af, wf, dcf = a.detach().float(), w.detach().float(), dc.float()
    res = {"shape": [M, K, N], "launches": ops.LAUNCHES["streaming_gemm"],
           "b_copies": ops.GEMM_FWD["b_copies"],
           "dc_copies": ops.GEMM_BWD["dc_copies"]}
    for what, got, want in (("forward", y, af @ wf),
                            ("da", a.grad, dcf @ wf.t()),
                            ("db", w.grad, af.t() @ dcf)):
        res[f"{what}_rel_err"] = float((got.float() - want).abs().max()
                                       / want.abs().max())
    print("[tp_ssm] odd block " + json.dumps(res), flush=True)
    require(res["launches"] == 3 and res["b_copies"] == 1
            and res["dc_copies"] == 1, f"tp odd block: {res}")
    require(all(res[f"{w}_rel_err"] <= BF16_TOL for w in ("forward", "da",
                                                          "db")),
            f"tp odd block: {res}")
    return res


def phase_tp_ssm(torch, args, card, dev, rows):
    """23. Tensor parallelism of the ssm, hybrid and audio families on one
    card (module docstring); prints its lines and its seconds."""
    import shutil
    import torch.multiprocessing as mp

    secs, want = {}, {}
    t = time.perf_counter()
    odd = _tps_odd_block(torch, args, dev)
    secs["odd block"] = time.perf_counter() - t
    for which in TPS_RUNS:
        t = time.perf_counter()
        want[which] = _tpm_one_rank(torch, args, dev, which, tag="tp_ssm")
        secs[f"one rank {which}"] = time.perf_counter() - t
    t = time.perf_counter()
    shutil.rmtree(TPS_DIR, ignore_errors=True)
    TPS_DIR.mkdir(parents=True)
    mp.start_processes(_tp_rank, args=(args.seed, str(TPS_DIR), TPS_RUNS,
                                       TPS_RUNS),
                       nprocs=TP_RANKS, join=True, start_method="spawn")
    ranks = [torch.load(TPS_DIR / f"rank{r}.pt", weights_only=False)
             for r in range(TP_RANKS)]
    shutil.rmtree(TPS_DIR, ignore_errors=True)
    secs["two ranks"] = time.perf_counter() - t
    res, checks = {}, []
    for which in TPS_RUNS:
        res[which], c = _tps_check(torch, which, [r[which] for r in ranks],
                                   want[which], card)
        checks += c
    print(f"[tp_ssm] seconds {json.dumps(secs)}", flush=True)
    for ok, msg in checks:
        require(ok, msg)
    rows["streaming_gemm"]["tp_ssm_train_launches"] = {
        w: r["gemm_launches"] for w, r in res.items()}
    return {**res, "odd_block": odd}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--host-job", choices=("replay", "scorecard", "bench",
                                           "sweep"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script measures the "
                 "card and has no CPU mode")
    if args.host_job:
        return run_host_job(torch, args.host_job)
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops
    from repro_torch.models.model import Model

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    dry_cells = start_dry_cells()
    _build.build_all(verbose=True)
    print(f"[build] {time.perf_counter() - t0:.1f} s; torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)
    host_jobs = start_host_jobs()
    card = card_line()
    print(f"[card] {card}", flush=True)

    laps, t_lap = {"build": time.perf_counter() - t0}, [time.perf_counter()]

    def lap(name):
        """The seconds since the last lap, as phase ``name``'s; the card's
        cache emptied for the next phase."""
        torch.cuda.empty_cache()
        now = time.perf_counter()
        laps[name], t_lap[0] = now - t_lap[0], now

    timer = Timer(torch, dev)
    rows = phase_kernels(torch, args, dev, timer)
    del timer
    lap("2 kernels")

    cfg = get_config("qwen2-0.5b")
    g = torch.Generator(device=dev).manual_seed(args.seed)
    params = Model(cfg, device=dev).init(g)
    serving = phase_serving(torch, args, cfg, params, DENSE_KERNELS)
    phase_profile(torch, args, cfg, params)
    phase_card_vs_cpu(torch, args, cfg, params)
    lap("3-5 serving")
    phase_streaming(torch, args, cfg, params)
    del params
    lap("6 streaming")
    moe = phase_moe(torch, args, rows)
    lap("7 moe")
    variants = phase_dense_variants(torch, args, rows)
    lap("8 dense variants")
    whisper = phase_whisper(torch, args, rows)
    lap("9 whisper")
    rwkv = phase_rwkv(torch, args, rows)
    lap("10 rwkv")
    zamba = phase_zamba(torch, args, rows)
    lap("11 zamba")
    deepseek = phase_deepseek(torch, args, rows)
    lap("12 deepseek")
    simulator = phase_simulator(torch, args, card, host_jobs)
    lap("13 simulator")
    phase_open_loop(torch, args, card, simulator["serving"], host_jobs)
    lap("14 open loop")
    train = phase_training(torch, args, rows, card, dev)
    lap("15 train")
    moe_train = phase_moe_training(torch, args, rows, card, dev)
    lap("16 moe train")
    mla_train = phase_mla_training(torch, args, rows, card, dev)
    lap("17 mla train")
    ssm_train = phase_ssm_training(torch, args, rows, card, dev)
    lap("18 ssm train")
    mesh = phase_mesh(torch, args, card, dev)
    lap("19 mesh")
    dry = phase_dryrun(torch, args, card, dev, dry_cells)
    lap("20 dry run")
    tp = phase_tp(torch, args, card, dev, rows)
    lap("21 tensor parallel")
    tpm = phase_tp_moe(torch, args, card, dev, rows)
    lap("22 tensor parallel moe")
    tps = phase_tp_ssm(torch, args, card, dev, rows)
    lap("23 tensor parallel ssm, hybrid, audio")
    print(f"[phases] seconds {json.dumps(laps)}", flush=True)

    # launches: each kernel's count from its own main path's serving run
    # (the grouped GEMM's is the MoE path, the latent paged kernel's
    # deepseek-v3's); every path's counts beside
    paths = {cfg.name: serving["launches"],
             MOE_ARCH: moe["serving"]["launches"],
             **{a: v["serving"]["launches"] for a, v in variants.items()},
             WHISPER_ARCH: whisper["greedy"]["launches"],
             RWKV_ARCH: rwkv["serving"]["launches"],
             ZAMBA_ARCH: zamba["serving"]["launches"],
             deepseek["config"]: deepseek["serving"]["launches"],
             simulator["serving"]["config"] + " record_plans":
             simulator["serving"]["launches"],
             f"{TRAIN_ARCH} train step": train["launches"]}
    int8_path = f"{INT8_ARCH} int8"
    paths[int8_path] = variants[INT8_ARCH]["int8"]["serving"]["launches"]
    moe_train_path = f"{MOE_ARCH} train step"
    paths[moe_train_path] = moe_train["launches"]
    paths[f"{mla_train['full']['config']} train step"] = \
        mla_train["launches"]
    for fam, launches in ssm_train["launches"].items():
        paths[f"{ssm_train['full'][fam]['config']} train step"] = launches
    paths[f"{cfg.name} mesh serving steps"] = mesh["serving"]["launches"]
    paths[f"{cfg.name} counted steps"] = {
        k: sum(r["launches"].get(k, 0) for r in dry["counts"].values())
        for k in ops.LAUNCHES}
    paths[f"{cfg.name} tp train (1, 2) rank 0"] = tp["launches"]
    for which in TPM_RUNS:
        paths[f"{tpm[which]['config']} tp train (1, 2) rank 0"] = \
            tpm[which]["launches"]
    for which in TPS_RUNS:
        paths[f"{tps[which]['config']} tp train (1, 2) rank 0"] = \
            tps[which]["launches"]
    own = {"streaming_gemm_grouped": MOE_ARCH,
           "paged_latent_attention": deepseek["config"],
           "paged_attention_int8": int8_path, "kv_quantize": int8_path,
           **{n: moe_train_path for n in GROUPED_BWD_NAMES.values()}}
    # the counters of a kernel's wrappers: the int8 kernel's two entries
    counters = {"paged_attention_int8": ("paged_attention_int8",
                                         "paged_attention_int8_append")}

    def launched(n, name):
        return sum(n.get(c, 0) for c in counters.get(name, (name,)))

    kernels = [{"name": name, **rows[name],
                "launches": launched(paths[own.get(name, cfg.name)], name),
                "launches_by_path": {p: launched(n, name)
                                     for p, n in paths.items()},
                **({"launches_by_counter": {
                    c: paths[own[name]].get(c, 0) for c in counters[name]}}
                   if name in counters else {})}
               for name in rows]
    print(json.dumps({"kernels": kernels, "card": card}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
