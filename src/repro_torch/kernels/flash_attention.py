"""Flash attention (prefill) on Hopper — launcher of
``csrc/flash_attention.cu``.

Replaces the TPU kernel ``repro/kernels/flash_attention.py``
(``_flash_kernel`` / ``flash_attention_raw``): causal or full
softmax(QKᵀ/√D)·V with an online softmax carried across KV blocks, blocks
above the causal diagonal skipped, mask −1e30, ``l`` floored at 1e-30,
and ``p`` cast to V's dtype before PV.

What bounds it on the H100: at the main path's prefill shapes (T <= 512,
H = 14, D = 64) the work is small, O(T²·H·D) operations over O(T·H·D)
bytes, so at these lengths it is bound by operations; this first kernel
does them in fp32 FMA on the CUDA cores, not the tensor cores.

What the design does about it: it reads the reference's (B, T, H, D) /
(B, T, KH, D) layout through strides and indexes KV head ``h // G``, so
neither the head transpose nor the GQA repeat of the TPU wrapper is
materialised; the causal loop stops at each query block's diagonal, so
tiles above it are never loaded; Q, K and V tiles are staged once in
shared memory.  Not yet done (later work): ``mma``/``wgmma`` for QKᵀ
and PV, and a TMA-fed K/V ring.

Head dims 16, 32, 64 and 128 in float32 or bfloat16 are compiled.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
_VP, _I32 = ctypes.c_void_p, ctypes.c_int
_ARGS = [_I32, _VP, _VP, _VP, _VP, _I32, _I32, _I32, _I32, _I32, _I32, _VP,
         _I32, _VP]


def flash_cuda(q, k, v, causal: bool = True) -> torch.Tensor:
    """q: (B, Tq, H, D); k, v: (B, Tk, KH, D) CUDA tensors with unit
    stride on D.  Returns (B, Tq, H, D) contiguous in ``q.dtype``."""
    B, Tq, H, D = q.shape
    Bk, Tk, KH, Dk = k.shape
    if v.shape != k.shape or Bk != B or Dk != D or H % KH:
        raise ValueError(f"flash shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash head dim {D} not in {HEAD_DIMS}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"flash dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_cuda and q.device == k.device == v.device):
        raise ValueError("flash_cuda needs q, k, v on one CUDA device")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_cuda needs unit stride on the head dim")
    out = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_int64 * 9)(
        q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1),
        k.stride(2), v.stride(0), v.stride(1), v.stride(2))
    code = _build.function("flash_attention", "fa_forward", _ARGS)(
        _DTYPES[q.dtype], _build.ptr(q), _build.ptr(k), _build.ptr(v),
        _build.ptr(out), B, Tq, Tk, H, KH, D,
        ctypes.cast(strides, ctypes.c_void_p), int(causal),
        _build.stream(q.device))
    _build.check(code, "flash_attention")
    return out
