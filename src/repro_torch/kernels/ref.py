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
        return (a.float() @ b.float()).to(out_dtype)
    # int64 products of int8 values sum exactly, like the reference's
    # int32 accumulator at these sizes; CUDA has no integer matmul, so
    # this plain version always sums on the host
    acc = (a.cpu().to(torch.int64) @ b.cpu().to(torch.int64))
    return acc.to(torch.int32).to(out_dtype).to(a.device)


def flash_ref(q, k, v, causal=True):
    """q: (BH, Tq, D); k, v: (BH, Tk, D)."""
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
    D), k and v (B, Tk, KH, D); folds batch x heads and repeats each KV
    head for its G = H / KH query heads."""
    B, Tq, H, D = q.shape
    Tk, KH = k.shape[1], k.shape[2]
    G = H // KH
    qf = q.reshape(B, Tq, KH, G, D).permute(0, 2, 3, 1, 4) \
        .reshape(B * KH * G, Tq, D)
    kf = k.permute(0, 2, 1, 3).reshape(B * KH, Tk, D) \
        .repeat_interleave(G, dim=0)
    vf = v.permute(0, 2, 1, 3).reshape(B * KH, Tk, D) \
        .repeat_interleave(G, dim=0)
    out = flash_ref(qf, kf, vf, causal)
    return out.reshape(B, KH, G, Tq, D).permute(0, 3, 1, 2, 4) \
        .reshape(B, Tq, H, D)


def paged_ref(q, k_pages, v_pages, table, lens):
    """Gather pages into contiguous caches, then masked attention.

    q: (B, H, D); pools: (P, page, KH, D); table: (B, max_pages) int32;
    lens: (B,) int32.  Returns (B, H, D) in ``q.dtype``."""
    B, H, D = q.shape
    P, page, KH, _ = k_pages.shape
    max_pages = table.shape[1]
    G = H // KH
    t = table.long()
    k = k_pages[t].reshape(B, max_pages * page, KH, D)
    v = v_pages[t].reshape(B, max_pages * page, KH, D)
    qg = q.reshape(B, KH, G, D).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, k.float()) / math.sqrt(D)
    valid = (torch.arange(max_pages * page, device=q.device)[None]
             < lens.to(q.device).long()[:, None])
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    # an empty sequence attends to nothing: zeros, as the paged kernels
    # give (the jnp oracle would average the whole masked table instead)
    out = torch.where(lens.to(q.device)[:, None, None, None] > 0, out, 0.0)
    return out.reshape(B, H, D).to(q.dtype)
