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

The backward products of training, one launch for all experts each
(``grouped_bwd_a_cuda``, ``grouped_bwd_b_cuda``), run the streaming
GEMM's ``mma.sync`` tile (``csrc/mma_tile.cuh``) on a grid of (output
tile, expert), each CTA reading its expert's count on the card:

- dA[e] = dC[e]·B[e]ᵀ: the weight read in place as a K-contiguous
  operand; rows at or beyond the count are neither read nor written;
- dB[e] = A[e]ᵀ·dC[e], summed over the kept rows only: the count is the
  reduction's depth, so rows at or beyond it are zero-filled as they are
  staged (whatever the buffer holds there, NaN included, never reaches
  a sum), and an expert no token reached gets zeros.  fp32 sums in one
  fixed order, no atomics.

They are simple tiles, correct first; ``bwd_plan`` picks a 64- or
128-wide tile on each side.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

SMS = 132                  # H100 SXM streaming multiprocessors
CHUNK = 64                 # token rows of a work item, at most
TILE_N = 128               # weight columns of a work item
BK = 64                    # k a stage
MIN_STAGES, MAX_STAGES = 3, 6
MAX_EXPERTS = 1024
SMEM_LIMIT = 227 * 1024
_VP, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_ARGS = [_VP, _VP, _VP, _VP, _I32, _I32, _I32, _I32, _I64, _I64, _I64,
         _I64, _I64, _I64, _I32, _I32, _I32, _VP]
_BWD_ARGS = [_I32, _VP, _VP, _VP, _VP, _I32, _I32, _I32, _I32, _I32, _I64,
             _I64, _I64, _I64, _I64, _I64, _I32, _I32, _VP]


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
    if not (a.is_cuda and b.is_cuda and counts.is_cuda
            and a.device == b.device == counts.device):
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
    if E == 0 or C == 0 or N == 0:
        return out
    grid, stages, nt_max = plan_grouped(E, C, N, K)
    fn = _build.function("grouped_gemm", "gg_grouped_gemm", _ARGS)
    code = fn(_build.ptr(a), _build.ptr(b), _build.ptr(out),
              _build.ptr(counts), E, C, N, K, a.stride(1), a.stride(0),
              b.stride(1), b.stride(0), N, C * N, grid, stages, nt_max,
              _build.stream(a.device))
    _build.check(code, "streaming_gemm_grouped")
    return out


def bwd_plan(M: int, N: int) -> tuple:
    """``(bm, bn)`` of a backward tile for an output side of M rows (dA:
    the buffer's C; dB: the weight's K) and N columns: 64 where the side
    is at most 64, else 128."""
    return (64 if M <= 64 else 128), (64 if N <= 64 else 128)


def launches(x: torch.Tensor, y: torch.Tensor) -> bool:
    """Whether a backward product of operands ``x`` and ``y`` (3-D, one
    expert dimension) launches its kernel: not where any extent is 0."""
    return min(x.shape) > 0 and min(y.shape) > 0


def _aligned(t: torch.Tensor) -> bool:
    """3-D ``t`` as the tile's 16-byte copies read it: the last dimension
    contiguous, the address and both outer strides 16-byte aligned."""
    return t.stride(2) == 1 and t.data_ptr() % 16 == 0 \
        and t.stride(0) % 8 == 0 and t.stride(1) % 8 == 0


def _check_bwd(what, x, y, counts, E, extent):
    if x.dtype != torch.bfloat16 or y.dtype != torch.bfloat16:
        raise TypeError(f"{what} needs bf16 operands, got {x.dtype}, "
                        f"{y.dtype}")
    if counts.dtype != torch.int32 or tuple(counts.shape) != (E,) \
            or not counts.is_contiguous():
        raise ValueError("counts must be a contiguous (E,) int32 tensor")
    if not (x.is_cuda and y.is_cuda and counts.is_cuda
            and x.device == y.device == counts.device):
        raise ValueError(f"{what} needs every operand on one CUDA device")
    if not (_aligned(x) and _aligned(y)) or extent % 8:
        raise ValueError(
            f"{what}: layout not taken, strides {x.stride()} and "
            f"{y.stride()}, N {extent} (the last dimension contiguous, "
            "addresses and other strides 16-byte aligned, N a multiple of "
            "8)")


def _launch_bwd(which, x, y, out, counts, rows, M, N, K, bm, bn):
    E = x.shape[0]
    fn = _build.function("grouped_gemm", "gg_grouped_bwd", _BWD_ARGS)
    code = fn(which, _build.ptr(x), _build.ptr(y), _build.ptr(out),
              _build.ptr(counts), E, rows, M, N, K, x.stride(1), x.stride(0),
              y.stride(1), y.stride(0), out.stride(1), out.stride(0), bm, bn,
              _build.stream(x.device))
    _build.check(code, "streaming_gemm_grouped backward")


def grouped_bwd_a_cuda(dc: torch.Tensor, b: torch.Tensor,
                       counts: torch.Tensor) -> torch.Tensor:
    """dA[e] = dC[e]·B[e]ᵀ for the rows below ``counts[e]``: dc (E, C, N)
    and b (E, K, N) bf16 CUDA tensors, N contiguous in both and a
    multiple of 8, the other strides multiples of 8 values, both 16-byte
    aligned; counts (E,) int32 on the same card.  Returns
    (E, C, K) bf16 in which rows ``[counts[e], C)`` of expert e are left
    unwritten, as the forward leaves its own."""
    if dc.dim() != 3 or b.dim() != 3 or dc.shape[0] != b.shape[0] \
            or dc.shape[2] != b.shape[2]:
        raise ValueError(f"grouped dA shapes {tuple(dc.shape)} x "
                         f"{tuple(b.shape)}")
    E, C, N = dc.shape
    K = b.shape[1]
    _check_bwd("grouped dA", dc, b, counts, E, N)
    out = torch.empty((E, C, K), dtype=dc.dtype, device=dc.device)
    if launches(dc, b):
        _launch_bwd(0, dc, b, out, counts, C, C, K, N, *bwd_plan(C, K))
    return out


def grouped_bwd_b_cuda(a: torch.Tensor, dc: torch.Tensor,
                       counts: torch.Tensor) -> torch.Tensor:
    """dB[e] = A[e]ᵀ·dC[e] summed over the rows below ``counts[e]``: a
    (E, C, K) and dc (E, C, N) bf16 CUDA tensors, the last dimension
    contiguous (N a multiple of 8), the other strides multiples of 8
    values, both 16-byte aligned; counts (E,) int32 on the same card.
    Returns (E, K, N) bf16, zeros for an expert at count 0; no row at or
    beyond a count is read."""
    if a.dim() != 3 or dc.dim() != 3 or a.shape[:2] != dc.shape[:2]:
        raise ValueError(f"grouped dB shapes {tuple(a.shape)} x "
                         f"{tuple(dc.shape)}")
    E, C, K = a.shape
    N = dc.shape[2]
    _check_bwd("grouped dB", a, dc, counts, E, N)
    if not launches(a, dc):
        return torch.zeros((E, K, N), dtype=a.dtype, device=a.device)
    out = torch.empty((E, K, N), dtype=a.dtype, device=a.device)
    _launch_bwd(1, a, dc, out, counts, C, K, N, C, *bwd_plan(K, N))
    return out
