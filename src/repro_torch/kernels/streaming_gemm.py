"""MatrixFlow streaming GEMM on Hopper — launcher of
``csrc/streaming_gemm.cu``.

Replaces the TPU kernel ``repro/kernels/streaming_gemm.py``
(``_gemm_kernel`` / ``streaming_gemm_raw``): C = A·B, output-stationary
over a K-inner walk, fp32 accumulation (int32 for int8).

What bounds it on the H100: every main-path shape is bound by bytes.
At decode (M = the live sequences, <= 8) each weight byte is used by a
handful of rows, far below the 295 FLOP/byte at which bf16 tensor cores
become the limit; prefill (M = 64-512) is bound by bytes too (M = 256,
896 x 896: 0.4 us of operations against 0.8 us of bytes).  At these
sizes the limit in practice is memory-level parallelism: enough CTAs and
enough bytes in flight per CTA to cover the memory latency (Little's
law), which a 64 x 64 tile per CTA walking all of K could not give (14
CTAs for N = 896 at M = 8).

What the design does about it:

- ``plan(M, N, K)`` picks the tile and a split of K so that up to two
  CTAs per SM run while each still walks at least two k-tiles; the CTAs
  of one output tile form a thread-block cluster and sum their fp32
  partials through distributed shared memory in a fixed rank order,
  then store C once: one launch per call, no workspace, no atomics, the
  same bits on every run.
- The product is computed as Cᵀ = Bᵀ·Aᵀ, so the weight's N fills the
  16-row side of ``mma.sync.m16n8k16`` and the tokens its n8 side: a
  decode tile stages 8 rows of A, not 64 rows of which 56 are zeros.
- A cp.async ring of 3-8 stages (as many as 64 KB holds) keeps up to
  that many 128-byte-deep k-tiles in flight per CTA; fragments come from
  ``ldmatrix``, and from ``ldmatrix.trans`` for row-major B.
- B may be K-contiguous, so the tied lm_head streams ``embed``
  (152,064 x 896, 272 MB in bf16) as its own transpose without a copy;
  each B tile is a whole number of 4 KB pages (the paper's page rule);
  ragged edges are zero-filled in the kernel, so no padded copies are
  made.
- A may be M-contiguous (with a row-major B), the mirror of the
  K-contiguous B, so the backward products of training read their
  transposed operands in place: the weight gradient dW = Xᵀ·dY reads
  the layer input X, and the tied embedding's gradient dLogitsᵀ·h reads
  the (tokens, 152,064) logit gradient, without a transposed copy.

- Rows that are not 16-byte aligned are staged in 8- or 4-byte copies
  (``copy_width``): qwen2-moe's router, 2,048 x 60 with rows of 120
  bytes, runs all three of its products (x·W, dC·Wᵀ, Xᵀ·dC) and its
  serving calls on the tensor cores.

fp32 and int8 inputs, and bf16 operands whose rows are not even 4-byte
aligned (an odd leading stride), take a scalar-FMA tiled kernel in the
same source: full fp32 (no TF32) and exact int32 sums that wrap on the
int8 store.  The autograd Function never gives it a bf16 product.

The expert-grouped products of the MoE layers run on a kernel of their
own, ``grouped_gemm.py`` (``csrc/grouped_gemm.cu``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_VP, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_MMA_ARGS = [_VP, _VP, _VP, _I32, _I32, _I32, _I64, _I64, _I32, _I32,
             _I64, _I32, _I32, _I32, _I32, _I32, _I32, _VP]
_SIMT_ARGS = [_I32, _VP, _VP, _VP, _I32, _I32, _I32, _I64, _I64, _I64,
              _I64, _I64, _VP]


# The Hopper block chooser.  H100 SXM constants; nothing here is a TPU
# figure (the reference's ``core/overlap.py`` budget is for a TPU).
SMS = 132                   # streaming multiprocessors
TARGET_CTAS = 2 * SMS       # two CTAs per SM
BK = 64                     # k-tile depth: 128-byte rows along K
PAGE_BYTES = 4096           # the paper's page: each B tile is whole pages
BMS = (8, 16, 32, 64, 128)  # token rows per CTA
BNS = (128, 64)             # weight columns per CTA, largest first
MAX_SPLITS = 8              # portable thread-block cluster size
MIN_K_TILES = 2             # k-tiles each split walks, at least


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(M: int, N: int, K: int) -> tuple:
    """``(bm, bn, bk, splits)`` for the bf16 kernel at C (M, N) = A (M, K)
    · B (K, N).

    - ``bm`` is the smallest token tile that holds M (at most 128): a
      decode batch of 8 stages 8 rows.
    - ``bn`` is 128 where the 128-wide tiles, split at most
      ``MAX_SPLITS`` ways, can still reach ``TARGET_CTAS``; else 64.  Wide
      tiles read A fewer times and B in 256-byte row runs.
    - ``splits`` is as many as keep ``MIN_K_TILES`` k-tiles per split, at
      most ``MAX_SPLITS`` (one cluster) and at most ``TARGET_CTAS`` CTAs
      in the grid: splits add bytes in flight at the cost of a reduction
      through distributed shared memory.

    Measured on the H100 (``launch/kernel_sweep.py``), this picks the
    fastest or second-fastest plan at every main-path shape; 32-wide
    tiles, which would give the narrow decode GEMMs more CTAs, were
    slower at each of them.  Every ``bn`` x ``bk`` tile of bf16 B is a
    whole number of 4 KB pages."""
    bm = next((b for b in BMS if M <= b), BMS[-1])
    m_tiles = _cdiv(M, bm)
    bn = next((b for b in BNS
               if m_tiles * _cdiv(N, b) * MAX_SPLITS >= TARGET_CTAS),
              BNS[-1])
    tiles = m_tiles * _cdiv(N, bn)
    splits = max(1, min(MAX_SPLITS, _cdiv(K, BK) // MIN_K_TILES,
                        TARGET_CTAS // tiles))
    return bm, bn, BK, splits


def copy_width(t: torch.Tensor, ld: int, extent: int = 8) -> int:
    """Bytes of the widest cp.async copy (16, 8 or 4) that divides both
    the address of bf16 ``t`` and its leading stride ``ld`` in bytes: how
    the kernel stages the operand's rows; 0 where none does.  16 only
    where ``extent``, the length of the contiguous dimension, is a
    multiple of 8 too: a 16-byte copy takes whole chunks of 8 values."""
    return next((vb for vb in (16, 8, 4)
                 if t.data_ptr() % vb == 0 and 2 * ld % vb == 0
                 and (vb < 16 or extent % 8 == 0)), 0)


def _row_major_b(b: torch.Tensor):
    """``ldb`` of a row-major bf16 B the kernel can read, else None."""
    if b.stride(1) == 1 and copy_width(b, b.stride(0)):
        return b.stride(0)
    return None


def mma_layout(a: torch.Tensor, b: torch.Tensor):
    """``(b_kcontig, ldb)`` when the tensor-core path can take these
    operands with a row-major A (bf16, each operand's address and
    leading stride at least 4-byte aligned), else ``None``."""
    if a.dtype != torch.bfloat16 or a.stride(1) != 1 \
            or not copy_width(a, a.stride(0)):
        return None
    if b.stride(0) == 1 and b.stride(1) != 1 \
            and copy_width(b, b.stride(1)):               # K-contiguous B
        return True, b.stride(1)
    ldb = _row_major_b(b)
    return None if ldb is None else (False, ldb)


def mcontig_layout(a: torch.Tensor, b: torch.Tensor):
    """``(lda, ldb)`` when the tensor-core path can take an M-contiguous
    A (element (m, k) at ``a[k * lda + m]``: ``a.stride(0) == 1``, ``lda
    = a.stride(1)``; any M and K) with a row-major B, each operand's
    address and leading stride at least 4-byte aligned, else ``None``.
    ``Xᵀ`` of a row-major X is such an A."""
    if a.dtype != torch.bfloat16 or a.stride(0) != 1 \
            or not copy_width(a, a.stride(1)):
        return None
    ldb = _row_major_b(b)
    return None if ldb is None else (a.stride(1), ldb)


def gemm_cuda(a: torch.Tensor, b: torch.Tensor,
              mma_only: bool = False) -> torch.Tensor:
    """Launch the kernel: a (M, K), b (K, N) CUDA tensors of one dtype
    (float32, bfloat16 or int8), any strides.  Returns (M, N) in
    ``a.dtype``.  The tensor-core kernel takes a row-major A with a
    row-major or K-contiguous B, and an M-contiguous A with a row-major
    B; other operands go to the scalar kernel, or with ``mma_only``
    raise ``ValueError``."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"gemm shapes {tuple(a.shape)} x {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in _DTYPES:
        raise TypeError(f"gemm dtypes {a.dtype}, {b.dtype}: need one of "
                        f"{list(_DTYPES)} for both")
    if not _build.on_device(a, b):
        raise ValueError("gemm_cuda needs both operands on one CUDA device")
    M, K = a.shape
    N = b.shape[1]
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    if M == 0 or N == 0:
        return out
    layout = mma_layout(a, b)
    mcontig = None if layout is not None else mcontig_layout(a, b)
    if layout is None and mcontig is None and mma_only:
        raise ValueError(
            f"gemm_cuda: the tensor-core kernel cannot read a {a.dtype} "
            f"{tuple(a.shape)} A of strides {a.stride()} with a "
            f"{tuple(b.shape)} B of strides {b.stride()} (needs bf16, a "
            "row-major or M-contiguous A, rows 4-byte aligned)")
    if out.is_meta:
        return out
    st = _build.stream(a.device)
    if layout is not None or mcontig is not None:
        if layout is not None:
            (kcontig, ldb), lda = layout, a.stride(0)
        else:
            kcontig, (lda, ldb) = False, mcontig
        bm, bn, bk, splits = plan(M, N, K)
        fn = _build.function("streaming_gemm", "sg_gemm_bf16", _MMA_ARGS)
        a_vb = copy_width(a, lda, 8 if mcontig is not None else K)
        b_vb = copy_width(b, ldb, K if kcontig else N)
        code = fn(_build.ptr(a), _build.ptr(b), _build.ptr(out), M, N, K,
                  lda, ldb, int(mcontig is not None), int(kcontig), N, bm,
                  bn, bk, splits, a_vb, b_vb, st)
    else:
        fn = _build.function("streaming_gemm", "sg_gemm_simt", _SIMT_ARGS)
        code = fn(_DTYPES[a.dtype], _build.ptr(a), _build.ptr(b),
                  _build.ptr(out), M, N, K, a.stride(0), a.stride(1),
                  b.stride(0), b.stride(1), N, st)
    _build.check(code, "streaming_gemm")
    return out
