"""Core transformer layers, dense subset: norms, RoPE, GQA attention,
MLP.

Every projection and MLP GEMM goes through ``ops.streaming_gemm``;
prefill attention goes through ``ops.flash_attention`` and decode
attention through ``ops.paged_attention`` over the paged KV pool.  The
bias, residual adds, norms, RoPE, SiLU and the KV scatter stay plain
torch ops, as they were plain XLA in the reference.

The dtype flow follows the reference: activations are bf16, norms and
RoPE compute in fp32 and cast back, GEMMs accumulate in fp32 and return
the activation dtype.  PyTorch refuses mixed-dtype arithmetic where JAX
promotes, so casts are explicit.

``chunked_attention`` and ``decode_attention`` are the reference's
plain XLA attention paths, kept for the tests.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import tuning as TU
from repro_torch.models.params import PSpec

NEG_INF = -1e30


# ---------------------------------------------------------------- norms
def norm_pspec(cfg: ModelConfig, d: Optional[int] = None):
    d = d or cfg.d_model
    p = {"scale": PSpec((d,), ("embed_act",), "ones", dtype="float32")}
    if cfg.norm == "layernorm":
        p["bias"] = PSpec((d,), ("embed_act",), "zeros", dtype="float32")
    return p


def apply_norm(p, x, cfg: ModelConfig, eps: float = 1e-5):
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:
        var = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * p["scale"]
    return y.to(x.dtype)


# ---------------------------------------------------------------- rope
def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(x, positions, cfg: ModelConfig):
    """x: (..., T, H, D) with positions (..., T); rotates pairs
    (cfg.rope == "full": all of head_dim; "2d": the first half)."""
    if cfg.rope == "none":
        return x
    d = x.shape[-1]
    rot = d if cfg.rope == "full" else d // 2
    freqs = rope_freqs(rot, cfg.rope_theta, x.device)
    angles = positions[..., None].float() * freqs
    cos, sin = torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]
    xr = x[..., :rot].float()
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    y = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    return torch.cat([y.to(x.dtype), x[..., rot:]], dim=-1)


# ----------------------------------------------- plain attention (tests)
def chunked_attention(q, k, v, *, causal: bool, q_chunk: int = 0,
                      kv_chunk: int = 0):
    """The reference's online-softmax attention in plain torch.

    q: (B, Tq, H, D); k, v: (B, Tk, KH, D) with H = KH * G.
    Returns (B, Tq, H, D) in ``v.dtype``."""
    B, Tq, H, D = q.shape
    _, Tk, KH, Dv = v.shape
    G = H // KH
    t = TU.get()
    q_chunk = min(q_chunk or t.q_chunk, Tq)
    kv_chunk = min(kv_chunk or t.kv_chunk, Tk)
    scale = 1.0 / math.sqrt(D)
    outs = []
    for q0 in range(0, Tq, q_chunk):
        qb = q[:, q0:q0 + q_chunk].reshape(B, -1, KH, G, D)
        qc = qb.shape[1]
        q_pos = q0 + torch.arange(qc, device=q.device)
        acc = torch.zeros((B, KH, G, qc, Dv), dtype=torch.float32,
                          device=q.device)
        m = torch.full((B, KH, G, qc), NEG_INF, device=q.device)
        l = torch.zeros((B, KH, G, qc), device=q.device)
        for k0 in range(0, Tk, kv_chunk):
            ks, vs = k[:, k0:k0 + kv_chunk], v[:, k0:k0 + kv_chunk]
            kv_pos = k0 + torch.arange(ks.shape[1], device=q.device)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qb.float(),
                             ks.float()) * scale
            if causal:
                mask = q_pos[:, None] >= kv_pos[None, :]
                s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p.to(vs.dtype).float(), vs.float())
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, qc, H, Dv))
    return torch.cat(outs, dim=1).to(v.dtype)


def decode_attention(q, k_cache, v_cache, cache_len):
    """The reference's single-token attention against a padded
    contiguous cache, in plain torch.  q: (B, H, D); caches:
    (B, S, KH, D); cache_len: (B,)."""
    B, H, D = q.shape
    _, S, KH, Dv = v_cache.shape
    G = H // KH
    qg = q.reshape(B, KH, G, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qg.float(),
                     k_cache.float()) / math.sqrt(D)
    valid = torch.arange(S, device=q.device)[None, :] \
        < cache_len.to(q.device).long()[:, None]
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, H, Dv).to(v_cache.dtype)


# ---------------------------------------------------------------- MLP
def mlp_pspecs(cfg: ModelConfig, d_ff: Optional[int] = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if not cfg.glu:
        raise NotImplementedError("non-gated MLP is not ported yet")
    return {"wo": PSpec((f, d), ("mlp", "embed")),
            "wi_gate": PSpec((d, f), ("embed", "mlp")),
            "wi_up": PSpec((d, f), ("embed", "mlp"))}


def apply_act(x, cfg: ModelConfig):
    return F.silu(x) if cfg.act == "silu" else F.gelu(x)


def _gemm(x, w):
    """x (..., K) @ w (K, N) through the streaming GEMM."""
    lead = x.shape[:-1]
    y = ops.streaming_gemm(x.reshape(-1, x.shape[-1]), w)
    return y.reshape(*lead, w.shape[-1])


def apply_mlp(p, x, cfg: ModelConfig):
    h = apply_act(_gemm(x, p["wi_gate"]), cfg) * _gemm(x, p["wi_up"])
    return _gemm(h, p["wo"])


# ------------------------------------------------------- GQA attention
def attention_pspecs(cfg: ModelConfig):
    d, H, KH, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                    cfg.resolved_head_dim)
    p = {
        "wq": PSpec((d, H, hd), ("embed", "heads", "head_dim")),
        "wk": PSpec((d, KH, hd), ("embed", "kv_heads", "head_dim")),
        "wv": PSpec((d, KH, hd), ("embed", "kv_heads", "head_dim")),
        "wo": PSpec((H, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        p["bq"] = PSpec((H, hd), ("heads", "head_dim"), "zeros")
        p["bk"] = PSpec((KH, hd), ("kv_heads", "head_dim"), "zeros")
        p["bv"] = PSpec((KH, hd), ("kv_heads", "head_dim"), "zeros")
    return p


def qkv_proj(p, x, cfg: ModelConfig):
    """x: (..., d) -> q (..., H, hd), k and v (..., KH, hd); the 3-D
    weights are read as their 2-D (d, heads·hd) views."""
    d = x.shape[-1]
    q, k, v = (_gemm(x, p[n].reshape(d, -1)).unflatten(-1, p[n].shape[1:])
               for n in ("wq", "wk", "wv"))
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def out_proj(p, out):
    """out: (..., H, hd) -> (..., d) through ``wo`` viewed as
    (H·hd, d)."""
    wo = p["wo"]
    return _gemm(out.flatten(-2), wo.reshape(-1, wo.shape[-1]))


def attention_train(p, x, cfg: ModelConfig, positions, causal=True):
    """Full-sequence attention (prefill).  x: (B, T, d); positions:
    (B, T).  Returns (out (B, T, d), (k, v) each (B, T, KH, hd))."""
    q, k, v = qkv_proj(p, x, cfg)
    q = apply_rope(q, positions, cfg)
    k = apply_rope(k, positions, cfg)
    out = ops.flash_attention(q, k, v, causal=causal)
    return out_proj(p, out), (k, v)


def attention_decode(p, x, cfg: ModelConfig, k_pool, v_pool, view):
    """One token per sequence.  x: (n, d); ``k_pool``/``v_pool``: this
    layer's (P, page, KH, hd) pools; ``view``: the step's
    ``DecodeView`` (positions, write slots, table, new lens).

    The token's K/V is written into its page first, then decode
    attention reads the pool through the page table."""
    q, k, v = qkv_proj(p, x, cfg)
    pos = view.positions                                   # (n,)
    q = apply_rope(q[:, None], pos[:, None], cfg)[:, 0]
    k = apply_rope(k[:, None], pos[:, None], cfg)[:, 0]
    flat_k = k_pool.view(-1, *k_pool.shape[2:])
    flat_v = v_pool.view(-1, *v_pool.shape[2:])
    flat_k[view.write_index] = k.to(k_pool.dtype)
    flat_v[view.write_index] = v.to(v_pool.dtype)
    out = ops.paged_attention(q, k_pool, v_pool, view.table, view.lens)
    return out_proj(p, out)
