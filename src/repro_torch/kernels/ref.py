"""Plain PyTorch versions of every kernel — the correctness ground truth.

They mirror the reference's pure-jnp oracles (``kernels/ref.py`` of the
JAX package) op for op.  The wrappers in ``ops`` use them for tensors
that lie on the CPU, and ``chip_smoke.py`` holds each CUDA kernel
against them on the card.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def gemm_ref(a, b, out_dtype=None):
    """C = A @ B, accumulated in float32 (int32 for integer inputs) and
    cast once to ``out_dtype`` (default ``a.dtype``; integer outputs
    wrap like the reference's ``astype``)."""
    out_dtype = out_dtype or a.dtype
    if a.dtype.is_floating_point:
        # both operands in one layout: a strided view (``embed.T``) and
        # its contiguous copy give the same bits on any BLAS, which picks
        # its kernel by the operands' strides
        return (a.float().contiguous() @ b.float().contiguous()).to(
            out_dtype)
    # int64 products of int8 values sum exactly, like the reference's
    # int32 accumulator at these sizes; CUDA has no integer matmul, so
    # this plain version always sums on the host
    acc = (a.cpu().to(torch.int64) @ b.cpu().to(torch.int64))
    return acc.to(torch.int32).to(out_dtype).to(a.device)


def grouped_gemm_ref(a, b, counts=None):
    """C[e] = A[e] @ B[e] for a (E, C, K), b (E, K, N): the reference's
    ``einsum("ecd,edf->ecf")``, accumulated in float32 and cast once to
    ``a.dtype``.  Every row is computed; the kernel writes only the rows
    below each expert's count, so compare those.

    With ``counts`` (E,), only the rows below each expert's count are
    computed, expert by expert, and the others are zeros: an expert no
    row reached costs nothing (deepseek-v3's 256 experts of 7,168 x 2,048
    on the host would otherwise convert 15 GB to fp32 per product)."""
    if counts is None:
        return torch.einsum("ecd,edf->ecf", a.float(), b.float()).to(a.dtype)
    out = torch.zeros(a.shape[:2] + b.shape[2:], dtype=a.dtype,
                      device=a.device)
    for e, c in enumerate(counts.tolist()):
        if c:
            out[e, :c] = (a[e, :c].float() @ b[e].float()).to(a.dtype)
    return out


def _kept(counts, C: int) -> list:
    return [min(max(c, 0), C) for c in counts.tolist()]


def grouped_bwd_a_ref(dc, b, counts):
    """dA[e] = dC[e] @ B[e]ᵀ for dc (E, C, N), b (E, K, N), over the rows
    below each expert's count (clamped to [0, C]), accumulated in float32
    and cast once to ``dc.dtype``; the other rows are zeros and no row at
    or beyond a count is read."""
    E, C, _ = dc.shape
    out = torch.zeros((E, C, b.shape[1]), dtype=dc.dtype, device=dc.device)
    for e, c in enumerate(_kept(counts, C)):
        if c:
            out[e, :c] = (dc[e, :c].float() @ b[e].float().t()).to(dc.dtype)
    return out


def grouped_bwd_b_ref(a, dc, counts):
    """dB[e] = A[e]ᵀ @ dC[e] for a (E, C, K), dc (E, C, N), summed over
    the rows below each expert's count only (clamped to [0, C]) in float32
    and cast once to ``a.dtype``: (E, K, N), zeros for an expert at count
    0; no row at or beyond a count is read."""
    E, C, K = a.shape
    out = torch.zeros((E, K, dc.shape[2]), dtype=a.dtype, device=a.device)
    for e, c in enumerate(_kept(counts, C)):
        if c:
            out[e] = (a[e, :c].float().t() @ dc[e, :c].float()).to(a.dtype)
    return out


def flash_ref(q, k, v, causal=True):
    """q, k: (BH, T, D); v: (BH, Tk, Dv), Dv may differ from D.  Scale
    1/√D."""
    BH, Tq, D = q.shape
    Tk = k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / math.sqrt(D)
    if causal:
        mask = (torch.arange(Tq, device=q.device)[:, None]
                >= torch.arange(Tk, device=q.device)[None, :])
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def flash_gqa_ref(q, k, v, causal=True):
    """The reference wrapper's layout around ``flash_ref``: q (B, Tq, H,
    D), k (B, Tk, KH, D) and v (B, Tk, KH, Dv); folds batch x heads and
    repeats each KV head for its G = H / KH query heads.  Returns (B,
    Tq, H, Dv)."""
    B, Tq, H, D = q.shape
    Tk, KH, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // KH
    qf = q.reshape(B, Tq, KH, G, D).permute(0, 2, 3, 1, 4) \
        .reshape(B * KH * G, Tq, D)
    kf = k.permute(0, 2, 1, 3).reshape(B * KH, Tk, D) \
        .repeat_interleave(G, dim=0)
    vf = v.permute(0, 2, 1, 3).reshape(B * KH, Tk, Dv) \
        .repeat_interleave(G, dim=0)
    out = flash_ref(qf, kf, vf, causal)
    return out.reshape(B, KH, G, Tq, Dv).permute(0, 3, 1, 2, 4) \
        .reshape(B, Tq, H, Dv)


def paged_ref(q, k_pages, v_pages, table, lens, dv=None, scale=None,
              k_scale=None, v_scale=None):
    """Gather pages into contiguous caches, then masked attention.

    q: (B, H, D); pools: (P, page, KH, D); table: (B, max_pages) int32;
    lens: (B,) int32.  Returns (B, H, dv) in ``q.dtype``: V is the first
    ``dv`` columns of ``v_pages`` (default all D), and the scores are
    scaled by ``scale`` (default 1/√D).  The latent form of multi-head
    latent attention passes one pool as both, its first ``dv`` columns
    being V.

    INT8 pools come with fp16 scale pools ``k_scale`` / ``v_scale`` of
    (P, KH, page), one scale per (token, KV head), each KV head's page
    of scales contiguous: the reference's ``decode_attention`` with
    ``k_scale`` / ``v_scale``, scores times the token's K scale and each
    probability times its V scale before PV, P kept in fp32 (the
    reference rounds ``p · v_scale`` to bf16)."""
    B, H, D = q.shape
    P, page, KH, _ = k_pages.shape
    max_pages = table.shape[1]
    G = H // KH
    dv = D if dv is None else dv
    t = table.long()
    k = k_pages[t].reshape(B, max_pages * page, KH, D)
    v = v_pages[t].reshape(B, max_pages * page, KH, -1)[..., :dv]
    qg = q.reshape(B, KH, G, D).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, k.float())
    s = s / math.sqrt(D) if scale is None else s * scale
    if k_scale is not None:
        s = s * _token_scales(k_scale, t)[:, :, None, :]
    valid = (torch.arange(max_pages * page, device=q.device)[None]
             < lens.to(q.device).long()[:, None])
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    if v_scale is not None:
        p = p * _token_scales(v_scale, t)[:, :, None, :]
    out = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    # an empty sequence attends to nothing: zeros, as the paged kernels
    # give (the jnp oracle would average the whole masked table instead)
    out = torch.where(lens.to(q.device)[:, None, None, None] > 0, out, 0.0)
    return out.reshape(B, H, dv).to(q.dtype)


def _token_scales(scale_pages, t):
    """(P, KH, page) scale pools through the table ``t`` (B, max_pages)
    -> (B, KH, max_pages · page) in fp32, token order."""
    B, max_pages = t.shape
    _, KH, page = scale_pages.shape
    return scale_pages[t].float().permute(0, 2, 1, 3) \
        .reshape(B, KH, max_pages * page)


# bf16(1e-8) and 1/127 in fp32: the constants the reference's jitted
# quantization adds and multiplies by (XLA turns ``/ 127.0`` into a
# product with the fp32 reciprocal, and the weakly typed 1e-8 is rounded
# to bf16 first)
KV_INV127 = 0.007874015718698502
KV_EPS = 1.0011717677116394e-08


def kv_quantize_ref(x):
    """The reference's INT8 KV quantization of bf16 ``x`` (..., D) per
    row: s = max|x| / 127 + 1e-8 and codes round(x / s), with the
    roundings the jitted reference keeps: s rounded to bf16 after the
    product and after the sum, the quotient rounded to bf16, then
    rounded half to even and saturated to int8 (XLA's conversion
    saturates: a quotient of 127.5 rounds to 128 and is stored as 127).
    Returns (codes int8 (..., D), scales fp16 (...))."""
    xf = x.float()
    s = (xf.abs().amax(-1) * KV_INV127).to(torch.bfloat16).float()
    s = (s + KV_EPS).to(torch.bfloat16)
    q = torch.round((xf / s.float()[..., None]).to(torch.bfloat16).float())
    return q.clamp(-128, 127).to(torch.int8), s.to(torch.float16)


def kv_quantize_append_ref(k, v, rows, k_pages, v_pages, k_scale, v_scale):
    """Quantize one step's (n, KH, D) bf16 ``k`` and ``v`` and write
    them at the flat pool ``rows`` (n,) (page id · page + token): codes
    into the (P, page, KH, D) int8 pools, scales into the (P, KH, page)
    fp16 scale pools.  In place; returns nothing."""
    page = k_pages.shape[1]
    rows = rows.long()
    pid, t = rows // page, rows % page
    for x, pool, scales in ((k, k_pages, k_scale), (v, v_pages, v_scale)):
        codes, s = kv_quantize_ref(x)
        pool.view(-1, *pool.shape[2:])[rows] = codes
        scales[pid, :, t] = s
