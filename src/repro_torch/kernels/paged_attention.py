"""Paged decode attention on Hopper — launcher of
``csrc/paged_attention.cu``.

Replaces the TPU kernel ``repro/kernels/paged_attention.py``
(``_paged_kernel`` / ``paged_attention_raw``): one query token per
sequence against a K/V page pool reached through a per-sequence page
table (the paper's SMMU step), with an online softmax across pages,
positions >= len masked at −1e30, ``lens = 0`` giving zeros, fp32
accumulation and output in ``q.dtype``.

What bounds it on the H100: bytes.  Each cached token's K and V
(KH·D·2 values) is read once per decode step for G = H/KH query heads,
about 2·G operations per byte in bf16, far below the tensor cores'
ridge; the least time is the live KV bytes over 3.35 TB/s.

What the design does about it: one CTA per (sequence, KV head) serves
all G query heads of the group, so each page is read from device memory
once (the TPU grid reads it per sequence too, but walks every table
slot); the block reads its own table row and length — there is no
scalar prefetch to port — and loops only over its ceil(len/page)
pages, so pages past ``len`` are never loaded.  G need not be a power of
two (Qwen2-0.5B has G = 7).  Not yet done (later work): splitting long
sequences across CTAs (flash-decoding) — with 8 sequences and 2 KV
heads only 16 CTAs run.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GROUP_ELEMS = 2048      # (H / KH) * D held by one CTA's registers
MAX_SMEM_BYTES = 227 * 1024
_VP, _I32 = ctypes.c_void_p, ctypes.c_int
_ARGS = [_I32, _VP, _VP, _VP, _VP, _VP, _VP, _I32, _I32, _I32, _I32, _I32,
         _I32, _VP]


def paged_cuda(q, k_pages, v_pages, table, lens) -> torch.Tensor:
    """q: (B, H, D); pools: (P, page, KH, D); table: (B, max_pages)
    int32; lens: (B,) int32 — contiguous CUDA tensors on one device.
    Returns (B, H, D) in ``q.dtype``."""
    B, H, D = q.shape
    P, page, KH, Dk = k_pages.shape
    if v_pages.shape != k_pages.shape or Dk != D or H % KH:
        raise ValueError(f"paged shapes q{tuple(q.shape)} "
                         f"pool{tuple(k_pages.shape)}")
    if table.dim() != 2 or table.shape[0] != B or tuple(lens.shape) != (B,):
        raise ValueError(f"paged table{tuple(table.shape)} "
                         f"lens{tuple(lens.shape)} for batch {B}")
    if not (q.dtype == k_pages.dtype == v_pages.dtype) \
            or q.dtype not in _DTYPES:
        raise TypeError(f"paged dtypes {q.dtype}, {k_pages.dtype}, "
                        f"{v_pages.dtype}")
    if table.dtype != torch.int32 or lens.dtype != torch.int32:
        raise TypeError("paged table and lens must be int32")
    ts = (q, k_pages, v_pages, table, lens)
    if not all(t.is_cuda and t.device == q.device for t in ts):
        raise ValueError("paged_cuda needs every operand on q's CUDA device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("paged_cuda needs contiguous operands")
    G = H // KH
    if G * D > MAX_GROUP_ELEMS:
        raise ValueError(f"paged: G*D = {G * D} > {MAX_GROUP_ELEMS}")
    smem = 4 * (G * D + page * (2 * D + 1) + G * page + 3 * G)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"paged: page of {page} tokens needs {smem} B of "
                         "shared memory")
    out = torch.empty_like(q)
    if B == 0:
        return out
    code = _build.function("paged_attention", "pa_forward", _ARGS)(
        _DTYPES[q.dtype], _build.ptr(q), _build.ptr(k_pages),
        _build.ptr(v_pages), _build.ptr(table), _build.ptr(lens),
        _build.ptr(out), B, H, KH, D, page, table.shape[1],
        _build.stream(q.device))
    _build.check(code, "paged_attention")
    return out
