"""INT8 KV quantize-and-append on Hopper — launcher of
``csrc/kv_quant.cu``.

No Pallas original: the reference quantizes its INT8 KV cache in XLA
(``repro/models/layers.py:264-277`` at decode,
``repro/models/decoding.py:275-292`` at prefill).  The port fuses the
quantization of K and V and their scatter into the paged pools into one
launch a layer, so a decode step does not gain a dozen small torch ops
a layer.  Bounded by bytes (each value read once in bf16, written once
as a code) and, at decode sizes, by the launch's fixed cost.

CUDA C++ rather than Triton: the work is an elementwise pass with a
reduction over D, which either serves, and CUDA keeps the one ``nvcc``
/ ``ctypes`` toolchain of ``kernels/_build.py`` (no Triton on the CPU
machine either way).

The kernel equals its plain version ``ref.kv_quantize_append_ref`` bit
for bit: the same fp32 product, IEEE quotient and bf16 roundings.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64, 128)
_VP, _I32 = ctypes.c_void_p, ctypes.c_int
_ARGS = [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _I32, _I32, _I32, _I32, _VP]


def kv_quant_cuda(k, v, rows, k_pages, v_pages, k_scale, v_scale) -> None:
    """k, v: (n, KH, D) bf16; rows: (n,) int64 flat pool rows; pools:
    (P, page, KH, D) int8; scale pools: (P, KH, page) fp16 — contiguous
    CUDA tensors on one device, n >= 1.  Writes the codes and scales in
    place."""
    n, KH, D = k.shape
    P, page = k_pages.shape[:2]
    if v.shape != k.shape or tuple(rows.shape) != (n,) \
            or k_pages.shape != (P, page, KH, D) \
            or v_pages.shape != k_pages.shape \
            or k_scale.shape != (P, KH, page) \
            or v_scale.shape != k_scale.shape:
        raise ValueError(f"kv quant shapes k{tuple(k.shape)} "
                         f"rows{tuple(rows.shape)} pool{tuple(k_pages.shape)} "
                         f"scales{tuple(k_scale.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"kv quant: head dim {D} not in {HEAD_DIMS}")
    if k.dtype != torch.bfloat16 or v.dtype != torch.bfloat16 \
            or rows.dtype != torch.int64 \
            or k_pages.dtype != torch.int8 or v_pages.dtype != torch.int8 \
            or k_scale.dtype != torch.float16 \
            or v_scale.dtype != torch.float16:
        raise TypeError("kv quant takes bf16 k/v, int64 rows, int8 pools "
                        "and fp16 scale pools")
    ts = (k, v, rows, k_pages, v_pages, k_scale, v_scale)
    if not _build.on_device(*ts):
        raise ValueError("kv_quant_cuda needs every operand on k's CUDA "
                         "device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("kv_quant_cuda needs contiguous operands")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("kv_quant_cuda: 16-byte loads need aligned k, v")
    if k.is_meta:
        return
    code = _build.function("kv_quant", "kvq_append", _ARGS)(
        _build.ptr(k), _build.ptr(v), _build.ptr(rows), _build.ptr(k_pages),
        _build.ptr(v_pages), _build.ptr(k_scale), _build.ptr(v_scale), n, KH,
        D, page, _build.stream(k.device))
    _build.check(code, "kv_quantize")
