"""Flash attention (prefill) on Hopper — launcher of
``csrc/flash_attention.cu``.

Replaces the TPU kernel ``repro/kernels/flash_attention.py``
(``_flash_kernel`` / ``flash_attention_raw``): causal or full
softmax(QKᵀ/√D)·V with an online softmax carried across KV blocks, blocks
above the causal diagonal skipped, mask −1e30, ``l`` floored at 1e-30,
and ``p`` cast to V's dtype before PV.

What bounds it on the H100: at the main path's prefill shapes (T =
64-512, H = 14 over KH = 2, D = 64) both bounds are under a microsecond
(T = 256: 0.31 us of bytes against 0.12 us of bf16 tensor-core
operations), so neither holds the kernel back: latency and parallelism
do, above all the diagonal block's serial walk over every key tile.

What the design does about it (bfloat16): one CTA serves the 7 query
heads of a KV head, its 64 rows being (position, head) pairs, so each
K/V tile is loaded once per KV head and query block; the key tiles of a
block are split over a thread-block cluster of up to 8 CTAs (``plan``),
whose partial softmax states are merged through distributed shared
memory in a fixed rank order, so the causal diagonal block no longer
walks every tile alone (one launch, no workspace, no atomics); K/V stay
bf16 in a cp.async ring with the next tile in flight; QKᵀ and PV run on the
tensor cores (``mma.sync.m16n8k16``, fp32 accumulation, ``ldmatrix``
for K and ``ldmatrix.trans`` for V); the online softmax stays in
registers and P is rounded to bf16 in registers as PV's A fragment (the
reference's ``p.astype(v.dtype)``); the heaviest causal blocks start
first.  The (B, T, H, D) / (B, T, KH, D) layouts are read through
strides, so neither the head transpose nor the GQA repeat of the TPU
wrapper is materialised; bf16 rows must be 16-byte aligned (strides
multiples of 8), and an operand that is not is copied contiguous first.

float32 inputs take a scalar-FMA kernel in the same source (no TF32, for
the 3e-5 contract).  The head dims of q/k (DK) and of v (DV) are
template parameters: DK = DV = 16, 32, 64, 112 (zamba2-7b's shared
attention) and 128, and (DK, DV) = (192, 128), the prefill of
multi-head latent attention (deepseek-v3-671b: 128 nope + 64 rope q/k
columns, 128 v columns, scale 1/√192), are compiled; any other pair
raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.streaming_gemm import MAX_SPLITS, TARGET_CTAS

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (q/k head dim, v head dim) pairs compiled into the kernels
HEAD_DIMS = ((16, 16), (32, 32), (64, 64), (112, 112), (128, 128),
             (192, 128))
_VP, _I32 = ctypes.c_void_p, ctypes.c_int
_ARGS = [_I32, _VP, _VP, _VP, _VP, _I32, _I32, _I32, _I32, _I32, _I32, _I32,
         _VP, _I32, _I32, _VP]
BR = BKV = 64               # flat (position, head) rows and keys per tile


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(B: int, Tq: int, Tk: int, H: int, KH: int, causal: bool) -> int:
    """How many CTAs (one cluster) share each query block's key tiles in
    the bf16 kernel: as many as the heaviest block has tiles, at most
    ``MAX_SPLITS``, while the grid stays within ``TARGET_CTAS``.  The
    diagonal block of a causal prefill walks every key tile; split S
    ways, its critical path is 1/S as long."""
    rows = Tq * (H // KH)
    blocks = B * KH * _cdiv(rows, BR)
    heaviest = _cdiv(min(Tk, Tq) if causal else Tk, BKV)
    return max(1, min(MAX_SPLITS, heaviest, TARGET_CTAS // max(blocks, 1)))



def _rows_aligned16(t: torch.Tensor) -> bool:
    """Every (b, t, h) row starts on 16 bytes (a size-1 dim's stride is
    never multiplied by more than 0)."""
    return t.data_ptr() % 16 == 0 and all(
        st % 8 == 0 for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1)


def flash_cuda(q, k, v, causal: bool = True) -> torch.Tensor:
    """q: (B, Tq, H, DK); k: (B, Tk, KH, DK); v: (B, Tk, KH, DV) CUDA
    tensors with unit stride on the head dims.  Returns (B, Tq, H, DV)
    contiguous in ``q.dtype``."""
    B, Tq, H, D = q.shape
    Bk, Tk, KH, Dk = k.shape
    Dv = v.shape[3]
    if v.shape[:3] != k.shape[:3] or Bk != B or Dk != D or H % KH:
        raise ValueError(f"flash shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if (D, Dv) not in HEAD_DIMS:
        raise ValueError(f"flash head dims (q/k {D}, v {Dv}) not in "
                         f"{HEAD_DIMS}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"flash dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if not _build.on_device(q, k, v):
        raise ValueError("flash_cuda needs q, k, v on one CUDA device")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_cuda needs unit stride on the head dim")
    out = torch.empty((B, Tq, H, Dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if q.dtype == torch.bfloat16:       # cp.async moves 16-byte rows
        q, k, v = (t if _rows_aligned16(t) else t.contiguous()
                   for t in (q, k, v))
    if out.is_meta:
        return out
    strides = (ctypes.c_int64 * 9)(
        q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1),
        k.stride(2), v.stride(0), v.stride(1), v.stride(2))
    code = _build.function("flash_attention", "fa_forward", _ARGS)(
        _DTYPES[q.dtype], _build.ptr(q), _build.ptr(k), _build.ptr(v),
        _build.ptr(out), B, Tq, Tk, H, KH, D, Dv,
        ctypes.cast(strides, ctypes.c_void_p), int(causal),
        plan(B, Tq, Tk, H, KH, causal), _build.stream(q.device))
    _build.check(code, "flash_attention")
    return out
