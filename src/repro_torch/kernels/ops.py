"""Public kernel wrappers, with the reference ``kernels/ops.py`` layouts.

A tensor on the CPU goes to the plain PyTorch version in ``ref``; a
CUDA tensor goes to the hand-written kernel, which raises on what it
cannot take.  There is no fallback from the kernel to the plain version.

``LAUNCHES`` counts, per wrapper, the kernel launches made (CPU calls do
not count), so a run can show that its main path went through the
kernels.  The TPU-only knobs of the reference wrappers (block sizes,
``interpret``) have no counterpart: the kernels pick their own tiles
and mask ragged edges themselves, so nothing is padded here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_cuda
from repro_torch.kernels.grouped_gemm import grouped_gemm_cuda
from repro_torch.kernels.paged_attention import paged_cuda, paged_latent_cuda
from repro_torch.kernels.streaming_gemm import gemm_cuda

LAUNCHES = {"streaming_gemm": 0, "streaming_gemm_grouped": 0,
            "flash_attention": 0, "paged_attention": 0,
            "paged_latent_attention": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def streaming_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B for a (M, K), b (K, N) of one dtype; fp32 accumulation
    (int32 for int8), output in ``a.dtype``.  ``b`` may be a strided
    view such as ``embed.T``: the kernel reads it in place."""
    if not a.is_cuda:
        return ref.gemm_ref(a, b)
    out = gemm_cuda(a, b)
    LAUNCHES["streaming_gemm"] += 1
    return out


def grouped_streaming_gemm(a: torch.Tensor, b: torch.Tensor,
                           counts: torch.Tensor) -> torch.Tensor:
    """C[e] = A[e] @ B[e] for a (E, C, K), b (E, K, N), one launch for
    all experts; ``counts`` (E,) int32 holds each expert's kept rows.
    The kernel writes only rows below the count; the plain version
    computes only those and zero-fills the rest.  Either way the caller
    must select rows at or beyond the count away, never scale them (on
    the card they hold whatever the memory held)."""
    if not a.is_cuda:
        return ref.grouped_gemm_ref(a, b, counts)
    out = grouped_gemm_cuda(a, b, counts)
    LAUNCHES["streaming_gemm_grouped"] += 1
    return out


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


def paged_attention(q, k_pages, v_pages, table, lens) -> torch.Tensor:
    """q: (B, H, D); pools: (P, page, KH, D); table: (B, max_pages)
    int32; lens: (B,) int32.  Returns (B, H, D) in ``q.dtype``."""
    if not q.is_cuda:
        return ref.paged_ref(q, k_pages, v_pages, table, lens)
    out = paged_cuda(q, k_pages, v_pages, table, lens)
    LAUNCHES["paged_attention"] += 1
    return out


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
