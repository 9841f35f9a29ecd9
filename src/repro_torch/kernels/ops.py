"""Public kernel wrappers, with the reference ``kernels/ops.py`` layouts.

A tensor on the CPU goes to the plain PyTorch version in ``ref``; a
CUDA tensor goes to the hand-written kernel, which raises on what it
cannot take.  There is no fallback from the kernel to the plain version.

``LAUNCHES`` counts, per wrapper, the kernel launches made (CPU calls do
not count), so a run can show that its main path went through the
kernels.  The streaming GEMM's launches for the backward products of
training count under ``streaming_gemm`` like the forward ones (the same
kernel) and again in ``GEMM_BWD["launches"]``, so a run can tell them
apart; ``GEMM_BWD["dc_copies"]`` counts the copies the backward made
of an output gradient the kernel could not read in place.  The grouped
GEMM's backward launches count under ``streaming_gemm_grouped`` and
again in ``GROUPED_BWD`` (``da``, ``db``).  The TPU-only knobs of the reference wrappers (block sizes,
``interpret``) have no counterpart: the kernels pick their own tiles
and mask ragged edges themselves, so nothing is padded here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_cuda
from repro_torch.kernels.grouped_gemm import (grouped_bwd_a_cuda,
                                              grouped_bwd_b_cuda,
                                              grouped_gemm_cuda, launches)
from repro_torch.kernels.kv_quant import kv_quant_cuda
from repro_torch.kernels.paged_attention import paged_cuda, paged_latent_cuda
from repro_torch.kernels.streaming_gemm import copy_width, gemm_cuda

LAUNCHES = {"streaming_gemm": 0, "streaming_gemm_grouped": 0,
            "flash_attention": 0, "paged_attention": 0,
            "paged_latent_attention": 0, "paged_attention_int8": 0,
            "kv_quantize": 0}
GEMM_BWD = {"launches": 0, "dc_copies": 0}
GROUPED_BWD = {"da": 0, "db": 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, GEMM_BWD, GROUPED_BWD):
        for name in counts:
            counts[name] = 0


def _gemm_bwd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One backward product on the tensor-core kernel (raising where it
    cannot read an operand), or its plain version on the CPU."""
    if not a.is_cuda:
        return ref.gemm_ref(a, b)
    out = gemm_cuda(a, b, mma_only=a.dtype == torch.bfloat16)
    LAUNCHES["streaming_gemm"] += 1
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
    ``GEMM_BWD["dc_copies"]``)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if not a.is_cuda:
            return ref.gemm_ref(a, b)
        out = gemm_cuda(a, b, mma_only=a.dtype == torch.bfloat16)
        LAUNCHES["streaming_gemm"] += 1
        return out

    @staticmethod
    def backward(ctx, dc):
        a, b = ctx.saved_tensors
        if dc.is_cuda and (dc.stride(1) != 1
                           or not copy_width(dc, dc.stride(0))):
            M, N = dc.shape
            padded = torch.empty((M, -(-N // 8) * 8), dtype=dc.dtype,
                                 device=dc.device)
            padded[:, :N] = dc
            dc = padded[:, :N]
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


def streaming_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B for a (M, K), b (K, N) of one dtype; fp32 accumulation
    (int32 for int8), output in ``a.dtype``.  ``b`` may be a strided
    view such as ``embed.T``: the kernel reads it in place.
    Differentiable: where an operand requires a gradient, the backward
    products run on the same kernel (``_StreamingGemm``)."""
    if a.requires_grad or b.requires_grad:
        return _StreamingGemm.apply(a, b)
    if not a.is_cuda:
        return ref.gemm_ref(a, b)
    out = gemm_cuda(a, b)
    LAUNCHES["streaming_gemm"] += 1
    return out


def _grouped(a, b, counts):
    if not a.is_cuda:
        return ref.grouped_gemm_ref(a, b, counts)
    out = grouped_gemm_cuda(a, b, counts)
    LAUNCHES["streaming_gemm_grouped"] += 1
    return out


def _grouped_bwd(which: str, x, y, counts):
    """One backward product of the grouped GEMM (``"da"``: dC·Bᵀ, x = dC,
    y = B; ``"db"``: Aᵀ·dC, x = A, y = dC) on its kernel, or its plain
    version on the CPU; kept rows only."""
    if not x.is_cuda:
        fn = ref.grouped_bwd_a_ref if which == "da" else ref.grouped_bwd_b_ref
        return fn(x, y, counts)
    fn = grouped_bwd_a_cuda if which == "da" else grouped_bwd_b_cuda
    out = fn(x, y, counts)
    if launches(x, y):
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
        a, b, counts = ctx.saved_tensors
        if dc.is_cuda:
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
    if q.is_cuda:
        out = flash_cuda(q, k, v, causal=causal)
        LAUNCHES["flash_attention"] += 1
        return out
    return ref.flash_gqa_ref(q, k, v, causal)


def paged_attention(q, k_pages, v_pages, table, lens, k_scale=None,
                    v_scale=None) -> torch.Tensor:
    """q: (B, H, D); pools: (P, page, KH, D); table: (B, max_pages)
    int32; lens: (B,) int32.  Returns (B, H, D) in ``q.dtype``.

    The pools' dtype picks the kernel: int8 pools (the INT8 KV cache)
    come with fp16 scale pools ``k_scale`` / ``v_scale`` of (P, KH,
    page) and launch the int8 form, counted as
    ``paged_attention_int8``."""
    if not q.is_cuda:
        return ref.paged_ref(q, k_pages, v_pages, table, lens,
                             k_scale=k_scale, v_scale=v_scale)
    out = paged_cuda(q, k_pages, v_pages, table, lens, k_scale, v_scale)
    LAUNCHES["paged_attention_int8" if k_pages.dtype == torch.int8
             else "paged_attention"] += 1
    return out


def kv_quantize_append(k, v, rows, k_pages, v_pages, k_scale,
                       v_scale) -> None:
    """The INT8 KV cache's write: quantize (n, KH, D) bf16 ``k`` and
    ``v`` per (token, KV head) as the reference does and store the codes
    at the flat pool ``rows`` (n,) int64 of the (P, page, KH, D) int8
    pools and the fp16 scales in the (P, KH, page) scale pools, in
    place, K and V in one launch."""
    if not k.is_cuda:
        ref.kv_quantize_append_ref(k, v, rows, k_pages, v_pages, k_scale,
                                   v_scale)
        return
    if k.shape[0]:
        kv_quant_cuda(k, v, rows, k_pages, v_pages, k_scale, v_scale)
        LAUNCHES["kv_quantize"] += 1


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


def paged_latent_attention(q, pool, table, lens, dv: int,
                           scale: float) -> torch.Tensor:
    """Multi-head latent attention's absorbed decode: q (B, H, D) over
    one latent pool (P, page, 1, D) whose first ``dv`` columns are V,
    through table (B, max_pages) int32 and lens (B,) int32; scores
    scaled by ``scale``.  Returns (B, H, dv) in ``q.dtype``."""
    if not q.is_cuda:
        return ref.paged_ref(q, pool, pool, table, lens, dv=dv, scale=scale)
    out = paged_latent_cuda(q, pool, table, lens, dv, scale)
    LAUNCHES["paged_latent_attention"] += 1
    return out
