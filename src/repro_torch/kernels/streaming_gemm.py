"""MatrixFlow streaming GEMM on Hopper — launcher of
``csrc/streaming_gemm.cu``.

Replaces the TPU kernel ``repro/kernels/streaming_gemm.py``
(``_gemm_kernel`` / ``streaming_gemm_raw``): C = A·B, output-stationary
over a K-inner walk, fp32 accumulation (int32 for int8).

What bounds it on the H100: at the main path's decode shapes (M = the
batch of live sequences, <= 8) every weight byte is used by a handful of
rows, so the GEMM is bound by the bytes of B it must stream from device
memory (3.35 TB/s), far below the 295 FLOP/byte at which bf16 tensor
cores become the limit.  Prefill (M = prompt length) sits closer to the
ridge.

What the design does about it: B is read exactly once per 64-row block
of A through 16-byte ``cp.async`` copies into a two-stage shared-memory
ring (the paper's A0/A1, B0/B1 double buffer), so the next K tile is in
flight while ``mma.sync`` multiplies the current one; B may be
K-contiguous, so the tied lm_head streams ``embed`` (152,064 x 896, 272
MB in bf16) as its own transpose without a copy; ragged edges are masked
in the kernel, so no padded copies are made.  Not yet done (later work):
split-K for the narrow decode GEMMs (N = 896 gives only 14 CTAs), TMA
and ``wgmma``.

fp32 and int8 inputs, and bf16 operands whose rows are not 16-byte
aligned, take a scalar-FMA tiled kernel in the same source: full fp32
(no TF32) and exact int32 sums that wrap on the int8 store.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_VP, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_MMA_ARGS = [_VP, _VP, _VP, _I32, _I32, _I32, _I64, _I64, _I32, _I64, _VP]
_SIMT_ARGS = [_I32, _VP, _VP, _VP, _I32, _I32, _I32, _I64, _I64, _I64,
              _I64, _I64, _VP]


def _aligned16(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def mma_layout(a: torch.Tensor, b: torch.Tensor):
    """``(b_kcontig, ldb)`` when the tensor-core path can take these
    operands (bf16, 16-byte aligned rows along each contiguous dim), else
    ``None``."""
    M, K = a.shape
    N = b.shape[1]
    if a.dtype != torch.bfloat16 or a.stride(1) != 1 or K % 8 \
            or a.stride(0) % 8 or not _aligned16(a) or not _aligned16(b):
        return None
    if b.stride(0) == 1 and b.stride(1) % 8 == 0:      # K-contiguous B
        return True, b.stride(1)
    if b.stride(1) == 1 and b.stride(0) % 8 == 0 and N % 8 == 0:
        return False, b.stride(0)
    return None


def gemm_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: a (M, K), b (K, N) CUDA tensors of one dtype
    (float32, bfloat16 or int8), any strides.  Returns (M, N) in
    ``a.dtype``."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"gemm shapes {tuple(a.shape)} x {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in _DTYPES:
        raise TypeError(f"gemm dtypes {a.dtype}, {b.dtype}: need one of "
                        f"{list(_DTYPES)} for both")
    if not (a.is_cuda and b.is_cuda and a.device == b.device):
        raise ValueError("gemm_cuda needs both operands on one CUDA device")
    M, K = a.shape
    N = b.shape[1]
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    if M == 0 or N == 0:
        return out
    st = _build.stream(a.device)
    layout = mma_layout(a, b)
    if layout is not None:
        kcontig, ldb = layout
        fn = _build.function("streaming_gemm", "sg_gemm_bf16_mma",
                             _MMA_ARGS)
        code = fn(_build.ptr(a), _build.ptr(b), _build.ptr(out), M, N, K,
                  a.stride(0), ldb, int(kcontig), N, st)
    else:
        fn = _build.function("streaming_gemm", "sg_gemm_simt", _SIMT_ARGS)
        code = fn(_DTYPES[a.dtype], _build.ptr(a), _build.ptr(b),
                  _build.ptr(out), M, N, K, a.stride(0), a.stride(1),
                  b.stride(0), b.stride(1), N, st)
    _build.check(code, "streaming_gemm")
    return out
