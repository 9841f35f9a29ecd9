"""Paged decode attention on Hopper — launcher of
``csrc/paged_attention.cu``.

Replaces the TPU kernel ``repro/kernels/paged_attention.py``
(``_paged_kernel`` / ``paged_attention_raw``): one query token per
sequence against a K/V page pool reached through a per-sequence page
table (the paper's SMMU step), with an online softmax across pages,
positions >= len masked at −1e30, ``lens = 0`` giving zeros, fp32
scores, probabilities and PV, and output in ``q.dtype``.

What bounds it on the H100: at decode sizes, latency.  Each cached
token's K and V (2·D values of a KV head) is read once per step for the
G = H/KH query heads of its group, about 7 operations per byte at G = 7,
under even the fp32 CUDA-core ridge, and at 8 sequences of 272 tokens
the bytes take a fraction of a microsecond; what a simple kernel pays
for is one CTA per (sequence, KV head) walking its pages one by one.

What the design does about it:

- ``plan(B, KH, max_pages)`` splits each sequence's pages over a
  thread-block cluster of S CTAs (S <= 8), so that B·KH·S reaches the
  card's 132 SMs where the table is wide enough.  It reads only the
  table's width: each CTA reads its sequence's length on the device and
  takes its own contiguous share of the ⌈len/page⌉ pages.
- Inside a CTA the warps take pages round-robin, each with its own
  online-softmax state, streaming pages through a two-slot ``cp.async``
  ring per warp (``walkers`` of them: four, or two where four rings do
  not fit), so four pages are in flight per CTA with no block barrier
  in the page loop; scores, max and sum use warp shuffles.
- The warps' and then the cluster's states are merged in a fixed order
  through shared and distributed shared memory: one launch, no
  workspace, no atomics, the same bits on every run.

What still bounds it: a fixed cost of about 7 µs per launch (the
cluster launch, its barriers and merge, and two dependent round trips to
device memory: the length and table row, then the first pages — the
step the TPU kernel's scalar prefetch hid), and the serial chain of a
page inside one warp (QKᵀ, shuffles, PV), at most two pages per warp at
the main path's shapes.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
PAGE_SIZES = (8, 16, 32)
MAX_GROUP_ELEMS = 2048      # (H / KH) * D: 32 fp32 pairs per lane
MAX_SMEM_BYTES = 227 * 1024
SMS = 132                   # H100 SXM streaming multiprocessors
MAX_SPLITS = 8              # portable thread-block cluster size
WARPS = 4                   # warps per CTA, each walking its own pages
_VP, _I32 = ctypes.c_void_p, ctypes.c_int
_ARGS = [_I32, _VP, _VP, _VP, _VP, _VP, _VP, _I32, _I32, _I32, _I32, _I32,
         _I32, _I32, _I32, _VP]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(B: int, KH: int, max_pages: int) -> int:
    """How many CTAs (one cluster) share each (sequence, KV head)'s pages:
    the fewest for which the grid B·KH·S covers the card's SMs, at most
    ``MAX_SPLITS`` and at most half the table's width (so a full table
    gives every CTA at least two pages).  Reads only the table's width,
    never ``lens``, which lives on the device."""
    return max(1, min(MAX_SPLITS, _cdiv(max_pages, 2),
                      _cdiv(SMS, max(B * KH, 1))))


def smem_bytes(G: int, D: int, page: int, max_pages: int, walkers: int,
               esz: int) -> int:
    """The kernel's dynamic shared memory, as ``layout`` in the source
    computes it: fp32 scratch (q, each warp's p and (m, l), the CTA's
    state, the merge weights), the sequence's table row, then the walking
    warps' two-slot K/V rings of rows padded by 16 bytes, which the
    warps' fp32 partial states take over after the page loop."""
    words = (2 * G * D + WARPS * G * page + 3 * WARPS * G + 3 * G
             + MAX_SPLITS * G + max_pages)
    ring = walkers * 2 * 2 * page * (D * esz + 16)
    return _cdiv(4 * words, 16) * 16 + max(ring, WARPS * G * D * 4)


def walkers(G: int, D: int, page: int, max_pages: int, esz: int) -> int:
    """How many of the four warps walk pages: all four, or two where four
    rings of the largest pages (32 tokens of fp32 at D 128: 264 KB) would
    not fit."""
    fits = smem_bytes(G, D, page, max_pages, WARPS, esz) <= MAX_SMEM_BYTES
    return WARPS if fits else 2


def paged_cuda(q, k_pages, v_pages, table, lens) -> torch.Tensor:
    """q: (B, H, D); pools: (P, page, KH, D); table: (B, max_pages)
    int32; lens: (B,) int32 — contiguous CUDA tensors on one device, the
    pools 16-byte aligned.  Returns (B, H, D) in ``q.dtype``."""
    B, H, D = q.shape
    P, page, KH, Dk = k_pages.shape
    if v_pages.shape != k_pages.shape or Dk != D or H % KH:
        raise ValueError(f"paged shapes q{tuple(q.shape)} "
                         f"pool{tuple(k_pages.shape)}")
    if table.dim() != 2 or table.shape[0] != B or tuple(lens.shape) != (B,):
        raise ValueError(f"paged table{tuple(table.shape)} "
                         f"lens{tuple(lens.shape)} for batch {B}")
    if D not in HEAD_DIMS or page not in PAGE_SIZES:
        raise ValueError(f"paged: head dim {D} not in {HEAD_DIMS} or page "
                         f"{page} not in {PAGE_SIZES}")
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
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged_cuda: cp.async needs 16-byte aligned pools")
    G = H // KH
    if G * D > MAX_GROUP_ELEMS:
        raise ValueError(f"paged: G*D = {G * D} > {MAX_GROUP_ELEMS}")
    max_pages = table.shape[1]
    splits = plan(B, KH, max_pages)
    esz = q.element_size()
    n_walk = walkers(G, D, page, max_pages, esz)
    smem = smem_bytes(G, D, page, max_pages, n_walk, esz)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"paged: {smem} B of shared memory for G {G}, D "
                         f"{D}, page {page}, table width {max_pages}")
    out = torch.empty_like(q)
    if B == 0:
        return out
    code = _build.function("paged_attention", "pa_forward", _ARGS)(
        _DTYPES[q.dtype], _build.ptr(q), _build.ptr(k_pages),
        _build.ptr(v_pages), _build.ptr(table), _build.ptr(lens),
        _build.ptr(out), B, H, KH, D, page, max_pages, splits, n_walk,
        _build.stream(q.device))
    _build.check(code, "paged_attention")
    return out
