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
from repro_torch.kernels.paged_attention import paged_cuda
from repro_torch.kernels.streaming_gemm import gemm_cuda

LAUNCHES = {"streaming_gemm": 0, "flash_attention": 0, "paged_attention": 0}


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


def flash_attention(q, k, v, causal: bool = True,
                    bk: int = 512) -> torch.Tensor:
    """q: (B, Tq, H, D); k, v: (B, Tk, KH, D) — GQA folded internally.

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
