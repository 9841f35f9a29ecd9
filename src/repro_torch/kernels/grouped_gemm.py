"""Expert-grouped GEMM on Hopper — launcher of ``csrc/grouped_gemm.cu``.

C[e] = A[e]·B[e] for every expert e of an MoE layer in one launch, A
(E, C, K) the dispatch buffer (or any view with K contiguous), B (E, K,
N) the stacked expert weights read in place, ``counts`` (E,) int32 on
the card the kept rows of each expert; rows at or beyond the count are
neither read into a result nor written.  It replaces no Pallas kernel
(the reference computes these products as an XLA einsum,
``models/moe.py:115-118``); it is the streaming GEMM applied per
expert, and also runs multi-head latent attention's absorbed per-head
products with the heads as groups.

What bounds it on the H100: bytes, the touched experts' weights read
once.  The design (the source's header has the details):

- a persistent grid, one CTA per SM, that builds its list of work
  items from ``counts`` on the card: (touched expert, chunk of at most
  64 kept rows, 128 columns of N); no CTA is scheduled for an expert no
  token chose, and nothing is read back to the host;
- the weight tile is the 64-row side of ``wgmma`` (the transposed
  product, two consumer warpgroups of 64 columns each) and the chunk's
  rows, rounded up to 8, its N side: at most 7 padding rows of tensor
  work an item.  A chunk past 64 rows streams the weight again (from
  L2): training's counts get there (qwen2-moe at 4,096 tokens keeps
  about 273 rows an expert, 5 chunks);
- a ring of 3-6 stages filled by TMA on mbarriers: the weight's map is
  encoded once per tensor, the activations' per call; ragged N and K
  edges are zero-filled by TMA;
- no atomics, no split of K: the same bits on every run.

``plan_grouped`` chooses the grid, the ring's stages and the token
ring's rows from what the host knows (E, C, N, K and the SM count); it
reads nothing from the card.

The backward products of training (``grouped_bwd_a_cuda``,
``grouped_bwd_b_cuda``) are persistent walks of the same shape, one
launch for all experts each, every count read on the card, no atomics
and no split of a reduction (the same bits on every run).  A producer
warpgroup feeds a TMA ring; two consumer warpgroups of 232 registers
(``setmaxnreg``) hold 128 output rows each, so an item's tile is 256
rows: the walks are fed at about the same bytes a cycle an SM, and the
bigger tile needs a third fewer bytes a multiply-add.

- dA[e] = dC[e]·B[e]ᵀ (kernel ``grouped_bwd_da``): the forward's walk
  with the weight K-major.  Items are (touched expert, chunk of kept
  rows, 256 output columns of K, or 128 where no chunk passes 64 rows,
  ``da_cols``); an expert's count is split evenly into ⌈count / 160⌉
  chunks (``da_chunks``), a chunk's rows rounded up to 8 up to 64 and to
  32 beyond: at most 31 padding rows of tensor work an item.  Rows at or
  beyond the count are never written, and what TMA brings in past it
  reaches only those rows; kept rows are written in 16-byte pieces
  through a shared-memory slab.
- dB[e] = Aᵀ[e]·dC[e] (kernel ``grouped_bwd_db``), summed over the kept
  rows only: items are (expert, 256 rows of K, 128 columns of N),
  expert-major, both operands MN-major, the reduction in stages of 64
  rows.  In the stage that holds the count the rows at or beyond it are
  zeroed in both operands' tiles, so NaN there reaches nothing; an
  expert at count 0 loads nothing and stores zeros.  The epilogue stores
  through a swizzled staging tile by TMA, overlapped with the next
  item.

``plan_bwd_da`` and ``plan_bwd_db`` choose each launch's grid, ring
stages and tile from what the host knows; ``bwd_smem_bytes`` mirrors
the source's ``gg_bwd_smem_bytes``.  A layout the kernels do not take
raises; nothing falls back to another kernel.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

SMS = 132                  # H100 SXM streaming multiprocessors
CHUNK = 64                 # token rows of a forward item, at most
TILE_N = 128               # weight columns of a work item
BK = 64                    # k a stage
MIN_STAGES, MAX_STAGES = 3, 6
DA_CHUNK = 160             # token rows of a dA item, at most
DB_BM, DB_BN = 256, 128    # K rows x N columns of a dB item
DB_BOX = 64 * 64 * 2       # one 64 x 64 bf16 box
DB_MIN_STAGES, DB_MAX_STAGES = 2, 3
DA_SLAB = 32               # token rows of a dA epilogue slab
MAX_EXPERTS = 1024
SMEM_LIMIT = 227 * 1024
_VP, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_ARGS = [_VP, _VP, _VP, _VP, _I32, _I32, _I32, _I32, _I64, _I64, _I64,
         _I64, _I64, _I64, _I32, _I32, _I32, _VP]
_DA_ARGS = [_VP, _VP, _VP, _VP, _I32, _I32, _I32, _I32, _I64, _I64, _I64,
            _I64, _I64, _I64, _I32, _I32, _I32, _VP]
_DB_ARGS = [_VP, _VP, _VP, _VP, _I32, _I32, _I32, _I32, _I64, _I64, _I64,
            _I64, _I32, _I32, _VP]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def smem_bytes(E: int, stages: int, nt_max: int) -> int:
    """The kernel's dynamic shared memory, as ``layout`` in the source
    computes it: 1 KB of alignment slack, each stage's two 8 KB weight
    boxes and ``nt_max`` token rows of 128 B, two barriers a stage, then
    the E clamped counts and E + 1 item starts."""
    return 1024 + stages * (2 * 64 * BK * 2 + nt_max * 128) + 16 * stages \
        + 4 * E + 4 * (E + 1)


def plan_grouped(E: int, C: int, N: int, K: int, sms: int = SMS) -> tuple:
    """``(grid, stages, nt_max)`` for E experts of C buffer rows, N x K
    weights.

    - ``nt_max``, the token ring's rows a stage: the largest chunk any
      count can give, min(64, C) rounded up to 8.
    - ``grid``: one CTA per SM (each holds 288 threads and up to ~150 KB
      of ring), fewer where the most items any routing can give, E ·
      ⌈C / 64⌉ · ⌈N / 128⌉, are fewer.  Which experts are touched is
      known only on the card; a CTA left without items leaves at once.
    - ``stages``: as many as fit the shared memory, at most 6 (96 KB of
      weight tiles in flight an SM)."""
    nt_max = min(CHUNK, _cdiv(C, 8) * 8)
    items = E * _cdiv(C, CHUNK) * _cdiv(N, TILE_N)
    grid = max(1, min(sms, items))
    stages = next((s for s in range(MAX_STAGES, MIN_STAGES - 1, -1)
                   if smem_bytes(E, s, nt_max) <= SMEM_LIMIT), MIN_STAGES)
    return grid, stages, nt_max


def _aligned16(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def grouped_gemm_cuda(a: torch.Tensor, b: torch.Tensor,
                      counts: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: a (E, C, K) and b (E, K, N) bf16 CUDA tensors,
    K contiguous in a and N in b, other strides multiples of 8 elements,
    both 16-byte aligned (the stacked expert weights as they lie, the
    heads of a token-major tensor as a strided view); counts (E,) int32
    on the same card.  Returns (E, C, N) bf16 in which rows
    ``[counts[e], C)`` of expert e are left unwritten."""
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] \
            or a.shape[2] != b.shape[1]:
        raise ValueError(f"grouped gemm shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    E, C, K = a.shape
    N = b.shape[2]
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError(f"grouped gemm needs bf16 operands, got {a.dtype}, "
                        f"{b.dtype}")
    if counts.dtype != torch.int32 or tuple(counts.shape) != (E,) \
            or not counts.is_contiguous():
        raise ValueError("counts must be a contiguous (E,) int32 tensor")
    if not _build.on_device(a, b, counts):
        raise ValueError("grouped_gemm_cuda needs every operand on one "
                         "CUDA device")
    strides = a.stride()[:2] + b.stride()[:2]
    if a.stride(2) != 1 or b.stride(2) != 1 or K % 8 or N % 8 \
            or any(s % 8 or s <= 0 for s in strides) \
            or not _aligned16(a) or not _aligned16(b) or E > MAX_EXPERTS:
        raise ValueError(
            f"grouped gemm layout not taken: a strides {a.stride()}, b "
            f"strides {b.stride()}, K {K}, N {N}, E {E} (K-contiguous "
            "rows, N-contiguous experts, 16-byte aligned, at most "
            f"{MAX_EXPERTS} experts)")
    out = torch.empty((E, C, N), dtype=a.dtype, device=a.device)
    if E == 0 or C == 0 or N == 0 or out.is_meta:
        return out
    grid, stages, nt_max = plan_grouped(E, C, N, K)
    fn = _build.function("grouped_gemm", "gg_grouped_gemm", _ARGS)
    code = fn(_build.ptr(a), _build.ptr(b), _build.ptr(out),
              _build.ptr(counts), E, C, N, K, a.stride(1), a.stride(0),
              b.stride(1), b.stride(0), N, C * N, grid, stages, nt_max,
              _build.stream(a.device))
    _build.check(code, "streaming_gemm_grouped")
    return out


class BwdPlan(NamedTuple):
    """A backward launch: ``grid`` persistent CTAs, a ring of ``stages``,
    an item of ``rows`` x ``cols`` (dA: the token rows a stage holds,
    ``nt_max``, by 128 or 256 output columns of K; dB: 256 rows of K by
    128 columns of N) and ``smem`` bytes of dynamic shared memory."""
    grid: int
    stages: int
    rows: int
    cols: int
    smem: int


def da_cols(nt_max: int) -> int:
    """dA's output columns an item: 256 (two 64-row weight boxes for each
    consumer warpgroup) where a chunk can pass 64 rows, else 128."""
    return 256 if nt_max > 64 else 128


def bwd_smem_bytes(which: int, E: int, stages: int, nt_max: int = 0) -> int:
    """A backward kernel's dynamic shared memory, as ``gg_bwd_smem_bytes``
    in the source computes it: 1 KB of alignment slack, then for dA
    (``which`` 0) stages of ``da_cols / 64`` 8 KB weight boxes and
    ``nt_max`` token rows of 128 B, two 4 KB epilogue slabs, two barriers
    a stage, the E clamped counts and E + 1 item starts; for dB (1)
    stages of six 8 KB boxes (four of A, two of dC), two 32 KB staging
    tiles, two barriers a stage and the E clamped counts."""
    if which == 0:
        return 1024 + stages * (da_cols(nt_max) // 64 * DB_BOX
                                + nt_max * 128) + 2 * DA_SLAB * 128 \
            + 16 * stages + 4 * E + 4 * (E + 1)
    return 1024 + stages * 6 * DB_BOX + 2 * 4 * DB_BOX + 16 * stages + 4 * E


def _round_rows(n: int) -> int:
    """A dA chunk's rows as wgmma's N side: up to 7 padding rows to 64,
    up to 31 beyond."""
    return -(-n // 8) * 8 if n <= 64 else -(-n // 32) * 32


def da_chunks(count: int) -> list:
    """``[(row0, rows)]`` of dA's chunks of an expert's kept rows, as the
    kernel splits them: ⌈count / 160⌉ chunks, the first ``count mod n``
    of them one row longer than the rest."""
    if count <= 0:
        return []
    n = _cdiv(count, DA_CHUNK)
    base, rem = divmod(count, n)
    return [(j * base + min(j, rem), base + (j < rem)) for j in range(n)]


def _stages(fits, lo: int, hi: int) -> int:
    return next((s for s in range(hi, lo - 1, -1) if fits(s)), lo)


def plan_bwd_da(E: int, C: int, N: int, K: int, sms: int = SMS) -> BwdPlan:
    """dA = dC·Bᵀ for E experts of C buffer rows, the reduction N and the
    output's K columns:

    - ``rows`` (``nt_max``): the largest chunk any count can give,
      min(160, C) rounded as a chunk is; ``cols``: ``da_cols``;
    - ``grid``: one CTA per SM, fewer where the most items any routing
      can give, E · ⌈C / 160⌉ · ⌈K / cols⌉, are fewer;
    - ``stages``: as many as fit the shared memory, 3-6."""
    nt_max = _round_rows(min(DA_CHUNK, C))
    cols = da_cols(nt_max)
    items = E * _cdiv(C, DA_CHUNK) * _cdiv(K, cols)
    stages = _stages(lambda s: bwd_smem_bytes(0, E, s, nt_max) <= SMEM_LIMIT,
                     MIN_STAGES, MAX_STAGES)
    return BwdPlan(max(1, min(sms, items)), stages, nt_max, cols,
                   bwd_smem_bytes(0, E, stages, nt_max))


def plan_bwd_db(E: int, C: int, K: int, N: int, sms: int = SMS) -> BwdPlan:
    """dB = Aᵀ·dC for E experts of C buffer rows and a (K, N) output a
    expert: every expert has ⌈K / 256⌉ · ⌈N / 128⌉ items (an expert at
    count 0 stores zeros), so ``grid`` is one CTA per SM or the items;
    ``stages``: as many as fit, 2-3."""
    items = E * _cdiv(K, DB_BM) * _cdiv(N, DB_BN)
    stages = _stages(lambda s: bwd_smem_bytes(1, E, s) <= SMEM_LIMIT,
                     DB_MIN_STAGES, DB_MAX_STAGES)
    return BwdPlan(max(1, min(sms, items)), stages, DB_BM, DB_BN,
                   bwd_smem_bytes(1, E, stages))


def launches(x: torch.Tensor, y: torch.Tensor) -> bool:
    """Whether a backward product of operands ``x`` and ``y`` (3-D, one
    expert dimension) launches its kernel: not where any extent is 0."""
    return min(x.shape) > 0 and min(y.shape) > 0


def _aligned(t: torch.Tensor) -> bool:
    """3-D ``t`` as a tensor map reads it: the last dimension contiguous,
    the address and both outer strides 16-byte aligned."""
    return t.stride(2) == 1 and t.data_ptr() % 16 == 0 \
        and t.stride(0) % 8 == 0 and t.stride(1) % 8 == 0


def _check_bwd(what, x, y, counts, E, extent):
    if x.dtype != torch.bfloat16 or y.dtype != torch.bfloat16:
        raise TypeError(f"{what} needs bf16 operands, got {x.dtype}, "
                        f"{y.dtype}")
    if counts.dtype != torch.int32 or tuple(counts.shape) != (E,) \
            or not counts.is_contiguous():
        raise ValueError("counts must be a contiguous (E,) int32 tensor")
    if not _build.on_device(x, y, counts):
        raise ValueError(f"{what} needs every operand on one CUDA device")
    if not (_aligned(x) and _aligned(y)) or extent % 8 or E > MAX_EXPERTS:
        raise ValueError(
            f"{what}: layout not taken, strides {x.stride()} and "
            f"{y.stride()}, N {extent}, E {E} (the last dimension "
            "contiguous, addresses and other strides 16-byte aligned, N a "
            f"multiple of 8, at most {MAX_EXPERTS} experts)")


def _strides(t: torch.Tensor) -> tuple:
    """``(row stride, expert stride)`` of a 3-D operand for its tensor
    map, which takes no zero stride: a dimension of one gets the stride
    it would have if ``t`` were contiguous, and an operand broadcast
    over a longer dimension is copied once."""
    E, R, X = t.shape
    if (E > 1 and t.stride(0) == 0) or (R > 1 and t.stride(1) == 0):
        t = t.contiguous()
    ld = t.stride(1) if R > 1 else _cdiv(X, 8) * 8
    se = t.stride(0) if E > 1 else ld * R
    return t, ld, se


def grouped_bwd_a_cuda(dc: torch.Tensor, b: torch.Tensor,
                       counts: torch.Tensor) -> torch.Tensor:
    """dA[e] = dC[e]·B[e]ᵀ for the rows below ``counts[e]``: dc (E, C, N)
    and b (E, K, N) bf16 CUDA tensors, N contiguous in both and a
    multiple of 8, the other strides multiples of 8 values, both 16-byte
    aligned, E at most 1,024; counts (E,) int32 on the same card.
    Returns (E, C, K) bf16 in which rows ``[counts[e], C)`` of expert e
    are left unwritten, as the forward leaves its own."""
    if dc.dim() != 3 or b.dim() != 3 or dc.shape[0] != b.shape[0] \
            or dc.shape[2] != b.shape[2]:
        raise ValueError(f"grouped dA shapes {tuple(dc.shape)} x "
                         f"{tuple(b.shape)}")
    E, C, N = dc.shape
    K = b.shape[1]
    _check_bwd("grouped dA", dc, b, counts, E, N)
    out = torch.empty((E, C, K), dtype=dc.dtype, device=dc.device)
    if not launches(dc, b):
        return out
    (dc, ldx, sx), (b, ldw, sw) = _strides(dc), _strides(b)
    if out.is_meta:
        return out
    plan = plan_bwd_da(E, C, N, K)
    fn = _build.function("grouped_gemm", "gg_grouped_bwd_da", _DA_ARGS)
    code = fn(_build.ptr(dc), _build.ptr(b), _build.ptr(out),
              _build.ptr(counts), E, C, N, K, ldx, sx, ldw, sw, K, C * K,
              plan.grid, plan.stages, plan.rows, _build.stream(dc.device))
    _build.check(code, "streaming_gemm_grouped dA")
    return out


def grouped_bwd_b_cuda(a: torch.Tensor, dc: torch.Tensor,
                       counts: torch.Tensor) -> torch.Tensor:
    """dB[e] = A[e]ᵀ·dC[e] summed over the rows below ``counts[e]``: a
    (E, C, K) and dc (E, C, N) bf16 CUDA tensors, the last dimension
    contiguous (N a multiple of 8), the other strides multiples of 8
    values, both 16-byte aligned, E at most 1,024; counts (E,) int32 on
    the same card.  Returns (E, K, N) bf16, zeros for an expert at count
    0; no row at or beyond a count reaches a sum."""
    if a.dim() != 3 or dc.dim() != 3 or a.shape[:2] != dc.shape[:2]:
        raise ValueError(f"grouped dB shapes {tuple(a.shape)} x "
                         f"{tuple(dc.shape)}")
    E, C, K = a.shape
    N = dc.shape[2]
    _check_bwd("grouped dB", a, dc, counts, E, N)
    if not launches(a, dc):
        return torch.zeros((E, K, N), dtype=a.dtype, device=a.device)
    out = torch.empty((E, K, N), dtype=a.dtype, device=a.device)
    (a, lda, sa), (dc, ldx, sx) = _strides(a), _strides(dc)
    if out.is_meta:
        return out
    plan = plan_bwd_db(E, C, K, N)
    fn = _build.function("grouped_gemm", "gg_grouped_bwd_db", _DB_ARGS)
    code = fn(_build.ptr(a), _build.ptr(dc), _build.ptr(out),
              _build.ptr(counts), E, C, K, N, lda, sa, ldx, sx, plan.grid,
              plan.stages, _build.stream(a.device))
    _build.check(code, "streaming_gemm_grouped dB")
    return out
