"""Public kernel wrappers, with the reference ``kernels/ops.py`` layouts.

A tensor on the CPU goes to the plain PyTorch version in ``ref``; a
CUDA tensor goes to the hand-written kernel, which raises on what it
cannot take.  There is no fallback from the kernel to the plain version.

``LAUNCHES`` counts, per wrapper, the kernel launches made (CPU calls do
not count), so a run can show that its main path went through the
kernels.  The int8 paged kernel counts under ``paged_attention_int8``
where it only reads the pools and under ``paged_attention_int8_append``
where the same launch also appends the decode step's rows.  The
streaming GEMM's launches for the backward products of
training count under ``streaming_gemm`` like the forward ones (the same
kernel) and again in ``GEMM_BWD["launches"]``, so a run can tell them
apart; ``GEMM_BWD["dc_copies"]`` counts the copies the backward made
of an output gradient the kernel could not read in place, and
``GEMM_FWD["b_copies"]`` those the Function's forward made of a weight
(a rank's block of 911 of zamba2-7b's 14,576 ``in_proj`` columns: bf16
rows of odd length are not 4-byte aligned).  The grouped
GEMM's backward launches count under ``streaming_gemm_grouped`` and
again in ``GROUPED_BWD`` (``da``, ``db``).  Under ``remat="dots"``
(``GemmTape``) ``GEMM_DOTS`` counts the forward outputs kept for the
backward pass (``saved``) and handed back to its recompute in place of
a launch (``replayed``).  The TPU-only knobs of the reference wrappers
(block sizes, ``interpret``) have no counterpart: the kernels pick their
own tiles and mask ragged edges themselves, so nothing is padded here.

A ``meta`` tensor is a dry run: it goes through the kernel's launcher,
which checks the operands and makes every allocation the launch makes
(its output, a copy of an operand it cannot read in place), launches
nothing and leaves ``LAUNCHES`` as it is.  Under the cost counter
(``launch.hlo_analysis.analyze``) each wrapper records its kernel's
work from its operands' shapes where it launches (or would), and the
ops it dispatches inside are not counted, so a step counts the same on
the card, the CPU and ``meta``.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels import ref
from repro_torch.launch import hlo_analysis as HA
from repro_torch.kernels.flash_attention import flash_cuda
from repro_torch.kernels.grouped_gemm import (grouped_bwd_a_cuda,
                                              grouped_bwd_b_cuda,
                                              grouped_gemm_cuda, launches)
from repro_torch.kernels.kv_quant import kv_quant_cuda
from repro_torch.kernels.paged_attention import (paged_cuda,
                                                 paged_int8_cuda,
                                                 paged_latent_cuda)
from repro_torch.kernels.streaming_gemm import copy_width, gemm_cuda

LAUNCHES = {"streaming_gemm": 0, "streaming_gemm_grouped": 0,
            "flash_attention": 0, "paged_attention": 0,
            "paged_latent_attention": 0, "paged_attention_int8": 0,
            "paged_attention_int8_append": 0, "kv_quantize": 0}
GEMM_BWD = {"launches": 0, "dc_copies": 0}
GEMM_FWD = {"b_copies": 0}
GROUPED_BWD = {"da": 0, "db": 0}
GEMM_DOTS = {"saved": 0, "replayed": 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, GEMM_BWD, GEMM_FWD, GROUPED_BWD, GEMM_DOTS):
        for name in counts:
            counts[name] = 0


def _kernel_path(t: torch.Tensor) -> bool:
    """True where a wrapper takes its kernel's launcher: a CUDA tensor,
    or a ``meta`` one (a dry run: module docstring)."""
    return t.is_cuda or t.is_meta


def _op(name: str, cost, *args):
    """A context for one wrapper op of an active cost count:
    ``cost(*args)`` (flops, bytes) recorded under ``name``, the ops
    dispatched inside not counted; nothing outside a count."""
    if not HA.counting():
        return HA.NULL
    HA.kernel(name, *cost(*args))
    return HA.quiet()


def _launched(name: str, t: torch.Tensor) -> None:
    """Count one launch of ``name``'s kernel: on the card only."""
    if t.is_cuda:
        LAUNCHES[name] += 1


# the tape the streaming GEMM's autograd Function writes to or reads
# from, and how: (GemmTape, "record" | "replay"), or None
_TAPE = None


class GemmTape:
    """The streaming GEMM's outputs in one region of ``remat="dots"``
    (the reference's ``dots_with_no_batch_dims_saveable``: keep the
    output of every 2-D product, recompute the rest).

    ``contexts()`` gives the pair of context managers that
    ``torch.utils.checkpoint``'s ``context_fn`` takes.  Under the first,
    the region's forward, every ``_StreamingGemm`` forward appends its
    output to the tape; under the second, the region's recompute in the
    backward pass, each hands back the next recorded output without a
    launch or the plain version.  The Function's node and saved inputs
    are made as before, so both backward products run unchanged.  The
    tape is emptied when the recompute ends, which may be early: the
    checkpoint stops recomputing once it has what the backward needs.
    The grouped GEMM, the attention and the scans are recomputed."""

    def __init__(self):
        self.outs: list = []
        self.next = 0

    @contextlib.contextmanager
    def _use(self, mode: str):
        global _TAPE
        prev, _TAPE = _TAPE, (self, mode)
        try:
            yield
        finally:
            _TAPE = prev
            if mode == "replay":
                self.outs.clear()

    def contexts(self):
        return self._use("record"), self._use("replay")

    def replay(self, shape) -> torch.Tensor:
        if self.next >= len(self.outs):
            raise RuntimeError("remat='dots': the recompute ran more GEMMs "
                               f"than the forward recorded ({len(self.outs)})")
        out = self.outs[self.next]
        if tuple(out.shape) != tuple(shape):
            raise RuntimeError(f"remat='dots': GEMM {self.next} recorded "
                               f"{tuple(out.shape)}, recompute asks "
                               f"{tuple(shape)}")
        self.next += 1
        GEMM_DOTS["replayed"] += 1
        return out.detach()


def _gemm(a: torch.Tensor, b: torch.Tensor,
          mma_only: bool = False) -> torch.Tensor:
    """One streaming GEMM launch (or its plain version on the CPU), one
    op of a cost count."""
    with _op("streaming_gemm", HA.gemm_cost, a, b):
        if not _kernel_path(a):
            return ref.gemm_ref(a, b)
        out = gemm_cuda(a, b, mma_only=mma_only)
    _launched("streaming_gemm", a)
    return out


def _gemm_bwd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One backward product on the tensor-core kernel (raising where it
    cannot read an operand), or its plain version on the CPU."""
    out = _gemm(a, b, mma_only=a.dtype == torch.bfloat16)
    if a.is_cuda:
        GEMM_BWD["launches"] += 1
    return out


class _StreamingGemm(torch.autograd.Function):
    """C = A·B with both backward products on the same kernel:

    - dA = dC·Bᵀ: Bᵀ of a row-major weight is a K-contiguous B, and of a
      K-contiguous B (the tied lm_head's ``embed.T``) a row-major one;
    - dB = Aᵀ·dC, Aᵀ read as an M-contiguous A, for a row-major B; for
      a K-contiguous B the kernel computes dBᵀ = dCᵀ·A in B's own
      layout (dCᵀ an M-contiguous A), so the tied embedding's gradient
      (152,064 x 896) comes out contiguous.

    In bf16 all three products run on the tensor-core kernel or raise:
    none falls to the scalar one.  The saved tensors are the inputs
    themselves.  ``dC`` is read in place where its rows are contiguous
    and at least 4-byte aligned (the router's 60-wide rows are), else
    copied once into rows padded to 16 bytes (counted in
    ``GEMM_BWD["dc_copies"]``); so is a row-major bf16 B on the kernel's
    path whose rows are not (counted in ``GEMM_FWD["b_copies"]``), and
    the copy is what the forward and both backward products read.
    Under a ``GemmTape`` the forward records its output, or hands back
    the recorded one."""

    @staticmethod
    def forward(ctx, a, b):
        if _kernel_path(b) and b.dtype == torch.bfloat16 \
                and b.stride(1) == 1 and not copy_width(b, b.stride(0)):
            b = _padded_rows(b)
            GEMM_FWD["b_copies"] += 1
        ctx.save_for_backward(a, b)
        tape, mode = _TAPE or (None, None)
        if mode == "replay":
            return tape.replay((a.shape[0], b.shape[1]))
        out = _gemm(a, b, mma_only=a.dtype == torch.bfloat16)
        if mode == "record":
            tape.outs.append(out.detach())
            GEMM_DOTS["saved"] += 1
        return out

    @staticmethod
    def backward(ctx, dc):
        with HA.quiet():
            return _StreamingGemm._backward(ctx, dc)

    @staticmethod
    def _backward(ctx, dc):
        a, b = ctx.saved_tensors
        if _kernel_path(dc) and (dc.stride(1) != 1
                                 or not copy_width(dc, dc.stride(0))):
            dc = _padded_rows(dc)
            GEMM_BWD["dc_copies"] += 1
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _gemm_bwd(dc, b.t())
        if ctx.needs_input_grad[1]:
            if b.stride(0) == 1 and b.stride(1) != 1:    # K-contiguous B
                db = _gemm_bwd(dc.t(), a).t()
            else:
                db = _gemm_bwd(a.t(), dc)
        return da, db


def _padded_rows(t: torch.Tensor) -> torch.Tensor:
    """A copy of (M, N) ``t`` in rows padded to 16 bytes, viewed at its
    N columns."""
    M, N = t.shape
    padded = torch.empty((M, -(-N // 8) * 8), dtype=t.dtype, device=t.device)
    padded[:, :N] = t
    return padded[:, :N]


def streaming_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B for a (M, K), b (K, N) of one dtype; fp32 accumulation
    (int32 for int8), output in ``a.dtype``.  ``b`` may be a strided
    view such as ``embed.T``: the kernel reads it in place.
    Differentiable: where an operand requires a gradient, the backward
    products run on the same kernel (``_StreamingGemm``)."""
    if a.requires_grad or b.requires_grad:
        return _StreamingGemm.apply(a, b)
    return _gemm(a, b)


def _grouped(a, b, counts):
    E, C, K = a.shape
    with _op("streaming_gemm_grouped", HA.grouped_cost, a, b,
             (E, C, b.shape[2]), K, counts):
        if not _kernel_path(a):
            return ref.grouped_gemm_ref(a, b, counts)
        out = grouped_gemm_cuda(a, b, counts)
    _launched("streaming_gemm_grouped", a)
    return out


def _grouped_bwd(which: str, x, y, counts):
    """One backward product of the grouped GEMM (``"da"``: dC·Bᵀ, x = dC,
    y = B; ``"db"``: Aᵀ·dC, x = A, y = dC) on its kernel, or its plain
    version on the CPU; kept rows only."""
    if _kernel_path(x):
        fn = grouped_bwd_a_cuda if which == "da" else grouped_bwd_b_cuda
    else:
        fn = ref.grouped_bwd_a_ref if which == "da" else ref.grouped_bwd_b_ref
    if not launches(x, y):
        return fn(x, y, counts)
    E, C = x.shape[:2]
    if which == "da":       # dC (E, C, N) · B (E, K, N)ᵀ -> (E, C, K)
        shape, contracted = (E, C, y.shape[1]), x.shape[2]
    else:                   # A (E, C, K)ᵀ · dC (E, C, N) -> (E, K, N)
        shape, contracted = (E, x.shape[2], y.shape[2]), C
    with _op("streaming_gemm_grouped", HA.grouped_cost, x, y, shape,
             contracted, counts):
        out = fn(x, y, counts)
    if x.is_cuda:
        LAUNCHES["streaming_gemm_grouped"] += 1
        GROUPED_BWD[which] += 1
    return out


class _GroupedGemm(torch.autograd.Function):
    """C[e] = A[e]·B[e] over each expert's kept rows, with both backward
    products on kernels of their own (``grouped_gemm.py``), one launch
    for all experts each:

    - dA[e] = dC[e]·B[e]ᵀ, rows below the count (the others left
      unwritten on the card, zeros on the CPU, as the forward leaves C);
    - dB[e] = A[e]ᵀ·dC[e], summed over the kept rows only, so what rows
      at or beyond the count hold in A or dC (unwritten memory, NaN)
      never reaches a weight gradient.

    ``counts`` is saved with the inputs.  The backward launches count
    under ``streaming_gemm_grouped`` like the forward and again in
    ``GROUPED_BWD``."""

    @staticmethod
    def forward(ctx, a, b, counts):
        ctx.save_for_backward(a, b, counts)
        return _grouped(a, b, counts)

    @staticmethod
    def backward(ctx, dc):
        with HA.quiet():
            return _GroupedGemm._backward(ctx, dc)

    @staticmethod
    def _backward(ctx, dc):
        a, b, counts = ctx.saved_tensors
        if _kernel_path(dc):
            dc = dc.contiguous()
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _grouped_bwd("da", dc, b, counts)
        if ctx.needs_input_grad[1]:
            db = _grouped_bwd("db", a, dc, counts)
        return da, db, None


def grouped_streaming_gemm(a: torch.Tensor, b: torch.Tensor,
                           counts: torch.Tensor) -> torch.Tensor:
    """C[e] = A[e] @ B[e] for a (E, C, K), b (E, K, N), one launch for
    all experts; ``counts`` (E,) int32 holds each expert's kept rows.
    The kernel writes only rows below the count; the plain version
    computes only those and zero-fills the rest.  Either way the caller
    must select rows at or beyond the count away, never scale them (on
    the card they hold whatever the memory held).  Differentiable where
    an operand requires a gradient (``_GroupedGemm``)."""
    if a.requires_grad or b.requires_grad:
        return _GroupedGemm.apply(a, b, counts)
    return _grouped(a, b, counts)


def flash_attention(q, k, v, causal: bool = True,
                    bk: int = 512) -> torch.Tensor:
    """q: (B, Tq, H, D); k: (B, Tk, KH, D); v: (B, Tk, KH, Dv) — GQA
    folded internally; Dv may differ from D (multi-head latent
    attention's prefill: 192 / 128).  Returns (B, Tq, H, Dv).

    ``bk`` keeps the reference wrapper's contract only: like the
    reference, non-causal attention whose Tk is not a multiple of
    ``min(bk, Tk)`` raises ``NotImplementedError``."""
    Tk = k.shape[1]
    bk_ = min(bk, Tk)
    if not causal and Tk % bk_:
        raise NotImplementedError("pad-free Tk required for non-causal")
    with _op("flash_attention", HA.flash_cost, q, k, v, causal):
        if not _kernel_path(q):     # contiguous, as the kernel's output
            return ref.flash_gqa_ref(q, k, v, causal).contiguous()
        out = flash_cuda(q, k, v, causal=causal)
    _launched("flash_attention", q)
    return out


def paged_attention(q, k_pages, v_pages, table, lens, k_scale=None,
                    v_scale=None) -> torch.Tensor:
    """q: (B, H, D); pools: (P, page, KH, D); table: (B, max_pages)
    int32; lens: (B,) int32.  Returns (B, H, D) in ``q.dtype``.

    The pools' dtype picks the kernel: int8 pools (the INT8 KV cache)
    come with fp16 scale pools ``k_scale`` / ``v_scale`` of (P, KH,
    page) and launch the int8 form, counted as
    ``paged_attention_int8``."""
    name = "paged_attention_int8" if k_pages.dtype == torch.int8 \
        else "paged_attention"
    with _op(name, HA.paged_cost, q, k_pages, v_pages, table, lens,
             k_scale, v_scale):
        if not _kernel_path(q):
            return ref.paged_ref(q, k_pages, v_pages, table, lens,
                                 k_scale=k_scale, v_scale=v_scale)
        out = paged_cuda(q, k_pages, v_pages, table, lens, k_scale,
                         v_scale)
    _launched(name, q)
    return out


def kv_quantize_append(k, v, rows, k_pages, v_pages, k_scale,
                       v_scale) -> None:
    """The INT8 KV cache's write: quantize (n, KH, D) bf16 ``k`` and
    ``v`` per (token, KV head) as the reference does and store the codes
    at the flat pool ``rows`` (n,) int64 of the (P, page, KH, D) int8
    pools and the fp16 scales in the (P, KH, page) scale pools, in
    place, K and V in one launch."""
    if not k.shape[0]:
        return
    with _op("kv_quantize", HA.append_cost, k, v, rows, k_pages, k_scale):
        if not _kernel_path(k):
            ref.kv_quantize_append_ref(k, v, rows, k_pages, v_pages,
                                       k_scale, v_scale)
            return
        kv_quant_cuda(k, v, rows, k_pages, v_pages, k_scale, v_scale)
    _launched("kv_quantize", k)


def kv_write(pools, rows, k, v) -> None:
    """Write one layer's new K/V rows: ``k`` / ``v`` (n, KH, D) at the
    flat pool ``rows`` (n,) int64 of ``pools``, a layer's ``(k_pages,
    v_pages, k_scale, v_scale)`` (``PagedKVCache.layer_pools``).  The
    pools' dtype decides: int8 pools take ``kv_quantize_append``, float
    pools a cast and scatter."""
    k_pages, v_pages, k_scale, v_scale = pools
    if k_pages.dtype == torch.int8:
        kv_quantize_append(k.contiguous(), v.contiguous(), rows, k_pages,
                           v_pages, k_scale, v_scale)
        return
    k_pages.view(-1, *k_pages.shape[2:])[rows] = k.to(k_pages.dtype)
    v_pages.view(-1, *v_pages.shape[2:])[rows] = v.to(v_pages.dtype)


def paged_attention_append(q, k, v, rows, pools, table,
                           lens) -> torch.Tensor:
    """One decode step over int8 pools: write the step's new K/V rows
    ``k`` / ``v`` (n, KH, D) bf16, quantized per (token, KV head), at the
    flat pool ``rows`` (n,) int64, then attend q (n, H, D) over ``pools``
    (a layer's ``(k_pages, v_pages, k_scale, v_scale)``, int8 with fp16
    scales) through table (n, max_pages) int32 and lens (n,) int32, the
    lengths after this token (row b is position ``lens[b] - 1`` of
    sequence b).  Returns (n, H, D) bf16.

    On the card one launch does both (``paged_int8_cuda`` with
    ``append``), counted as ``paged_attention_int8_append``; its plain
    version is ``kv_quantize_append_ref`` followed by ``paged_ref``."""
    k_pages, v_pages, k_scale, v_scale = pools
    k, v = k.contiguous(), v.contiguous()

    def cost():
        pf, pb = HA.paged_cost(q, k_pages, v_pages, table, lens, k_scale,
                               v_scale)
        af, ab = HA.append_cost(k, v, rows, k_pages, k_scale)
        return pf + af, pb + ab

    with _op("paged_attention_int8_append", cost):
        if not _kernel_path(q):
            ref.kv_quantize_append_ref(k, v, rows, k_pages, v_pages,
                                       k_scale, v_scale)
            return ref.paged_ref(q, k_pages, v_pages, table, lens,
                                 k_scale=k_scale, v_scale=v_scale)
        out = paged_int8_cuda(q, k_pages, v_pages, table, lens, k_scale,
                              v_scale, append=(k, v, rows))
    _launched("paged_attention_int8_append", q)
    return out


def paged_latent_attention(q, pool, table, lens, dv: int,
                           scale: float) -> torch.Tensor:
    """Multi-head latent attention's absorbed decode: q (B, H, D) over
    one latent pool (P, page, 1, D) whose first ``dv`` columns are V,
    through table (B, max_pages) int32 and lens (B,) int32; scores
    scaled by ``scale``.  Returns (B, H, dv) in ``q.dtype``."""
    with _op("paged_latent_attention", HA.latent_cost, q, pool, table, lens,
             dv):
        if not _kernel_path(q):
            return ref.paged_ref(q, pool, pool, table, lens, dv=dv,
                                 scale=scale)
        out = paged_latent_cuda(q, pool, table, lens, dv, scale)
    _launched("paged_latent_attention", q)
    return out
