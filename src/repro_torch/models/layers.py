"""Core transformer layers: norms, RoPE, GQA attention (self and
cross), multi-head latent attention (MLA), MLP.

Every projection and MLP GEMM goes through ``ops.streaming_gemm``;
prefill attention goes through ``ops.flash_attention`` and decode
attention through ``ops.paged_attention`` over the paged KV pool.  The
biases, residual adds, norms, RoPE, the activation and the KV scatter
stay plain torch ops, as they were plain XLA in the reference; over an
int8 pool (the INT8 KV cache) the quantization and the scatter are one
kernel, ``ops.kv_quantize_append``.

The dtype flow follows the reference: activations are bf16, norms and
RoPE compute in fp32 and cast back, GEMMs accumulate in fp32 and return
the activation dtype.  PyTorch refuses mixed-dtype arithmetic where JAX
promotes, so casts are explicit.

Under a mesh whose ``model`` axis splits a layer's leaves (the train
step, ``launch.steps``),
``qkv_proj``, ``out_proj``'s callers in training, ``apply_mlp`` and
``mla_train_chunked`` run on this rank's blocks, as
``sharding.tensor_parallel`` sets out: the heads or the MLP columns of
the rank, the input through ``copy_to_model``, the output through
``reduce_from_model`` (a bias of the output added once, after it).
MLA's latent path (``wdq``, ``q_norm``, ``wdkv``, ``kv_norm``, ``wkr``)
is whole and runs on every rank; its outputs, not x, go through
``copy_to_model``, so the whole latent weights' gradients come out
whole on every rank.  A layer whose leaves are whole (the head count
does not divide over ``model``) runs whole on every rank, with no
collective.

``chunked_attention`` and ``decode_attention`` are the reference's
plain XLA attention paths.  Training runs ``chunked_attention`` as
torch ops differentiated by autograd (``attention_train_chunked``,
``mla_train_chunked``), as
the reference trains through XLA; the flash kernel, like the reference's
Pallas kernel, has no backward.  ``decode_attention`` is kept for the
tests.
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
from repro_torch.sharding import tensor_parallel as TP

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


def apply_rope(x, positions, cfg: ModelConfig, dim: Optional[int] = None):
    """x: (..., T, H, D) with positions (..., T); rotates pairs
    (cfg.rope == "full": all of head_dim; "2d": the first half; ``dim``:
    the first ``dim`` values, with ``rope_freqs(dim)``)."""
    if cfg.rope == "none":
        return x
    d = x.shape[-1]
    rot = d if cfg.rope == "full" else d // 2
    if dim is not None:
        rot = dim
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


def decode_attention(q, k_cache, v_cache, cache_len, k_scale=None,
                     v_scale=None):
    """The reference's single-token attention against a padded
    contiguous cache, in plain torch.  q: (B, H, D); caches:
    (B, S, KH, D); cache_len: (B,).  ``k_scale`` / ``v_scale``: (B, S,
    KH) dequantization scales of int8 caches: scores times the K scale,
    then ``p · v_scale`` rounded to bf16 before PV, output in bf16."""
    B, H, D = q.shape
    _, S, KH, Dv = v_cache.shape
    G = H // KH
    qg = q.reshape(B, KH, G, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qg.float(),
                     k_cache.float()) / math.sqrt(D)
    if k_scale is not None:
        s = s * k_scale.float().permute(0, 2, 1)[:, :, None]
    valid = torch.arange(S, device=q.device)[None, :] \
        < cache_len.to(q.device).long()[:, None]
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    if v_scale is not None:
        pv = p * v_scale.float().permute(0, 2, 1)[:, :, None]
        out = torch.einsum("bhgk,bkhd->bhgd",
                           pv.to(torch.bfloat16).float(), v_cache.float())
        return out.reshape(B, H, Dv).to(torch.bfloat16)
    out = torch.einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, H, Dv).to(v_cache.dtype)


# ---------------------------------------------------------------- MLP
def mlp_pspecs(cfg: ModelConfig, d_ff: Optional[int] = None):
    """The gated (``wi_gate``, ``wi_up``) or plain (``wi``, ``bi``,
    ``bo``) MLP, leaves in the reference's order."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    p = {"wo": PSpec((f, d), ("mlp", "embed"))}
    if cfg.glu:
        p["wi_gate"] = PSpec((d, f), ("embed", "mlp"))
        p["wi_up"] = PSpec((d, f), ("embed", "mlp"))
    else:
        p["wi"] = PSpec((d, f), ("embed", "mlp"))
        p["bi"] = PSpec((f,), ("mlp",), "zeros")
        p["bo"] = PSpec((d,), ("embed_act",), "zeros")
    return p


def apply_act(x, cfg: ModelConfig):
    # jax.nn.gelu, the reference's GELU, defaults to the tanh form
    return F.silu(x) if cfg.act == "silu" \
        else F.gelu(x, approximate="tanh")


def sigmoid_op_by_op(x):
    """The reference's ``jax.nn.sigmoid`` as XLA computes it called
    eagerly: 1 / (1 + exp(-x)), each op rounded to ``x.dtype``.  On a
    bf16 operand ``torch.sigmoid`` rounds once instead, and differs in
    the last bit of about a third of the outputs."""
    return 1 / (1 + torch.exp(-x))


def _gemm(x, w):
    """x (..., K) @ w (K, N) through the streaming GEMM."""
    lead = x.shape[:-1]
    y = ops.streaming_gemm(x.reshape(-1, x.shape[-1]), w)
    return y.reshape(*lead, w.shape[-1])


def apply_mlp(p, x, cfg: ModelConfig, act=None):
    """The MLP; ``act`` replaces ``apply_act`` (a function of one
    tensor).  Over this rank's block of the ``d_ff`` columns where
    ``model`` splits them (module docstring)."""
    act = act or (lambda y: apply_act(y, cfg))
    tp = TP.parallel(p["wo"].shape[0], cfg.d_ff)
    if tp:
        x = TP.copy_to_model(x)
    if cfg.glu:
        h = act(_gemm(x, p["wi_gate"])) * _gemm(x, p["wi_up"])
        y = _gemm(h, p["wo"])
        return TP.reduce_from_model(y) if tp else y
    h = act(_gemm(x, p["wi"]) + p["bi"])
    y = _gemm(h, p["wo"])
    return (TP.reduce_from_model(y) if tp else y) + p["bo"]


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


def head_proj(w, x):
    """x: (..., d) -> (..., heads, hd) through a (d, heads, hd) weight
    read as its 2-D (d, heads·hd) view."""
    return _gemm(x, w.reshape(x.shape[-1], -1)).unflatten(-1, w.shape[1:])


def heads_split(p, cfg: ModelConfig) -> bool:
    """True where ``model`` splits the attention's query heads
    (``p["wq"]`` holds this rank's)."""
    return TP.parallel(p["wq"].shape[1], cfg.n_heads)


def qkv_proj(p, x, cfg: ModelConfig):
    """x: (..., d) -> q (..., H, hd), k and v (..., KH, hd).  Where
    ``model`` splits the query heads, q holds this rank's and k, v the
    KV heads they read (``tensor_parallel.kv_for_heads`` where the K/V
    leaves are whole), from x through ``copy_to_model``."""
    tp = heads_split(p, cfg)
    if tp:
        x = TP.copy_to_model(x)
    q, k, v = (head_proj(p[n], x) for n in ("wq", "wk", "wv"))
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if tp and not TP.parallel(p["wk"].shape[1], cfg.n_kv_heads):
        k, v = TP.kv_for_heads(k, v, q.shape[-2], cfg.n_heads,
                               cfg.n_kv_heads)
    return q, k, v


def out_proj(p, out):
    """out: (..., H, hd) -> (..., d) through ``wo`` viewed as
    (H·hd, d)."""
    wo = p["wo"]
    return _gemm(out.flatten(-2), wo.reshape(-1, wo.shape[-1]))


def attention_train(p, x, cfg: ModelConfig, positions, causal=True,
                    kv=None):
    """Full-sequence attention (prefill).  x: (B, T, d); positions:
    (B, T).  Returns (out (B, T, d), (k, v) each (B, Tk, KH, hd)).

    ``kv``: external (k, v) for cross-attention (the whisper decoder
    over its encoder): q comes from ``wq`` (plus ``bq``), no RoPE, and
    the given K/V are used and returned as they are.  ``bk = Tk``, one
    key block as long as the keys, keeps the flash wrapper's pad-free
    non-causal contract at any Tk (the encoder's 1,500 frames): the
    kernel masks the ragged last tile itself."""
    if kv is None:
        q, k, v = qkv_proj(p, x, cfg)
        q = apply_rope(q, positions, cfg)
        k = apply_rope(k, positions, cfg)
    else:
        q = head_proj(p["wq"], x)
        if cfg.qkv_bias:
            q = q + p["bq"]
        k, v = kv
    out = ops.flash_attention(q, k, v, causal=causal, bk=k.shape[1])
    return out_proj(p, out), (k, v)


def attention_train_chunked(p, x, cfg: ModelConfig, positions, causal=True,
                            kv=None):
    """Attention of training, the reference's ``attention_train``: the
    projections through the streaming GEMM (whose backward products run
    on the same kernel), RoPE, and ``chunked_attention`` as torch ops,
    which autograd differentiates.  x: (B, T, d); positions: (B, T).
    ``causal=False``: full attention (an encoder layer's, and
    cross-attention's).  ``kv``: external (k, v) (B, Tk, KH, hd) for
    cross-attention (the whisper decoder over its encoder): q comes from
    ``wq`` (plus ``bq``), no RoPE.  Returns (B, T, d).  Where ``model``
    splits the query heads, over this rank's (``qkv_proj``; with ``kv``,
    q from x through ``copy_to_model`` and the given K/V those heads
    read), the output projection's partials summed over ``model``."""
    tp = heads_split(p, cfg)
    if kv is None:
        q, k, v = qkv_proj(p, x, cfg)
        q = apply_rope(q, positions, cfg)
        k = apply_rope(k, positions, cfg)
    else:
        q = head_proj(p["wq"], TP.copy_to_model(x) if tp else x)
        if cfg.qkv_bias:
            q = q + p["bq"]
        k, v = kv
        if tp and not TP.parallel(k.shape[-2], cfg.n_kv_heads):
            k, v = TP.kv_for_heads(k, v, q.shape[-2], cfg.n_heads,
                                   cfg.n_kv_heads)
    out = out_proj(p, chunked_attention(q, k, v, causal=causal))
    return TP.reduce_from_model(out) if tp else out


def attention_decode(p, x, cfg: ModelConfig, pools, view):
    """One token per sequence.  x: (n, d); ``pools``: this layer's
    ``(k_pool, v_pool, k_scale, v_scale)`` (``PagedKVCache.layer_pools``:
    (P, page, KH, hd) pools, and for the INT8 KV cache int8 pools with
    their (P, KH, page) fp16 scales, else scales None); ``view``: the
    step's ``DecodeView`` (positions, write slots, table, new lens).

    The token's K/V is written into its page, then decode attention reads
    the pool through the page table.  Over int8 pools both are one kernel
    (``ops.paged_attention_append``), which quantizes the row per (token,
    KV head) as the reference does after RoPE; over float pools the row
    is scattered first (``ops.kv_write``)."""
    k_pool, v_pool = pools[:2]
    q, k, v = qkv_proj(p, x, cfg)
    pos = view.positions                                   # (n,)
    q = apply_rope(q[:, None], pos[:, None], cfg)[:, 0]
    k = apply_rope(k[:, None], pos[:, None], cfg)[:, 0]
    if k_pool.dtype == torch.int8:
        out = ops.paged_attention_append(q, k, v, view.write_index, pools,
                                         view.table, view.lens)
    else:
        ops.kv_write(pools, view.write_index, k, v)
        out = ops.paged_attention(q, k_pool, v_pool, view.table, view.lens)
    return out_proj(p, out)


def cache_axes(cfg: ModelConfig, quantized: bool = False):
    """Logical axes of one layer's paged K/V pools, (P, page, KH, hd):
    the page and in-page token dims have no counterpart in the
    reference's contiguous (B, S, KH, hd) cache and are ``None``; KH and
    hd keep its ``kv_heads`` and ``head_dim``.  With ``quantized`` the
    INT8 cache's fp16 scales (P, KH, page) too."""
    ax = (None, None, "kv_heads", "head_dim")
    out = {"k": ax, "v": ax}
    if quantized:
        out["k_scale"] = out["v_scale"] = (None, "kv_heads", None)
    return out


def cross_attention_decode(p, x, k_pool, v_pool, view):
    """One token per sequence against its encoder K/V, which prefill
    wrote and nothing changes.  x: (n, d); ``view``: the cross cache's
    ``read_view`` (table, lens = Te).  q = x·``wq`` with no bias, as the
    reference's decode writes it (its prefill adds ``bq``; whisper has
    none)."""
    out = ops.paged_attention(head_proj(p["wq"], x), k_pool, v_pool,
                              view.table, view.lens)
    return out_proj(p, out)


# --------------------------------------------------------------- MLA
def mla_pspecs(cfg: ModelConfig):
    m, d, H = cfg.mla, cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wdq": PSpec((d, m.q_lora_rank), ("embed", "lora")),
        "q_norm": norm_pspec(cfg, m.q_lora_rank),
        "wuq": PSpec((m.q_lora_rank, H, qk), ("lora", "heads", "head_dim")),
        "wdkv": PSpec((d, m.kv_lora_rank), ("embed", "lora")),
        "kv_norm": norm_pspec(cfg, m.kv_lora_rank),
        "wkr": PSpec((d, m.qk_rope_head_dim), ("embed", "head_dim")),
        "wuk": PSpec((m.kv_lora_rank, H, m.qk_nope_head_dim),
                     ("lora", "heads", "head_dim")),
        "wuv": PSpec((m.kv_lora_rank, H, m.v_head_dim),
                     ("lora", "heads", "head_dim")),
        "wo": PSpec((H, m.v_head_dim, d), ("heads", "head_dim", "embed")),
    }


def mla_cache_axes(cfg: ModelConfig):
    """Logical axes of one layer's latent pool, (P, page, 1, r + rope):
    page and in-page token ``None``, the one KV head (the reference's
    latent cache has no head dim) ``None``, the [ckv | kr] row ``lora``
    (the reference names ckv ``lora`` and kr ``head_dim``; both are
    replicated by every rule table)."""
    return {"k": (None, None, None, "lora")}


def mla_absorbed(p) -> dict:
    """The per-head layouts of ``wuk`` and ``wuv`` that the absorbed
    decode multiplies by: ``wuk_hkr`` (H, nope, r) and ``wuv_hrv`` (H, r,
    v), contiguous copies made once when the weights are loaded
    (``transformer.add_derived``), not every step."""
    return {"wuk_hkr": p["wuk"].permute(1, 2, 0).contiguous(),
            "wuv_hrv": p["wuv"].permute(1, 0, 2).contiguous()}


def _mla_q(p, x, cfg: ModelConfig, positions, cq=None):
    """x (..., d) -> q_nope (..., H, nope), q_rope (..., H, rope) after
    RoPE at ``positions`` (x's leading dims); ``cq``, when given, is the
    normed query latent, and x is not read."""
    m = cfg.mla
    if cq is None:
        cq = _mla_cq(p, x, cfg)
    q = head_proj(p["wuq"], cq)
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    return q_nope, apply_rope(q_rope, positions, cfg,
                              dim=m.qk_rope_head_dim)


def _mla_cq(p, x, cfg: ModelConfig):
    """x (..., d) -> the normed query latent (..., q_lora_rank)."""
    return apply_norm(p["q_norm"], _gemm(x, p["wdq"]), cfg)


def _mla_latent(p, x, cfg: ModelConfig, positions):
    """x (..., d) -> the cached latents: ckv (..., r) after ``kv_norm``
    and kr (..., rope) after RoPE at ``positions``."""
    ckv = apply_norm(p["kv_norm"], _gemm(x, p["wdkv"]), cfg)
    kr = apply_rope(_gemm(x, p["wkr"])[..., None, :], positions, cfg,
                    dim=cfg.mla.qk_rope_head_dim)[..., 0, :]
    return ckv, kr


def mla_heads_split(p, cfg: ModelConfig) -> bool:
    """True where ``model`` splits MLA's heads (``p["wuq"]`` holds this
    rank's)."""
    return TP.parallel(p["wuq"].shape[1], cfg.n_heads)


def _mla_qkv(p, x, cfg: ModelConfig, positions):
    """x (B, T, d) -> q, k (B, T, H, nope + rope), v (B, T, H, v) and the
    latents (ckv, kr): k_nope = ckv·W_uk and v = ckv·W_uv per head, the
    rope half of k one head shared by every head (``expand``, so that
    autograd sums its gradient over the heads).  Where ``model`` splits
    the heads, H is the rank's, from the whole latents through one
    ``copy_to_model`` (module docstring)."""
    H, rope = p["wuq"].shape[1], cfg.mla.qk_rope_head_dim
    cq = _mla_cq(p, x, cfg)
    ckv, kr = _mla_latent(p, x, cfg, positions)
    if mla_heads_split(p, cfg):
        cq, ckv, kr = TP.copy_to_model(cq, ckv, kr)
    q_nope, q_rope = _mla_q(p, x, cfg, positions, cq)
    k_nope = head_proj(p["wuk"], ckv)
    v = head_proj(p["wuv"], ckv)
    k = torch.cat([k_nope, kr[..., None, :].expand(*kr.shape[:-1], H, rope)],
                  dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    return q, k, v, (ckv, kr)


def mla_prefill(p, x, cfg: ModelConfig, positions):
    """The reference's ``mla_train``: x (B, T, d), positions (B, T).
    Queries and keys of nope + rope = 192 columns (the rope half of k
    shared by every head), values of ``v_head_dim`` (128), causal flash
    attention at scale 1/√192.  Returns (out (B, T, d), (ckv (B, T, r),
    kr (B, T, rope))), the latents the cache keeps."""
    q, k, v, latents = _mla_qkv(p, x, cfg, positions)
    out = ops.flash_attention(q, k, v, causal=True)
    return out_proj(p, out), latents


def mla_train_chunked(p, x, cfg: ModelConfig, positions):
    """MLA of training, the reference's ``mla_train``: ``mla_prefill``'s
    projections through the streaming GEMM (whose backward products run
    on the same kernel) and ``chunked_attention`` as torch ops, which
    autograd differentiates (the flash kernel has no backward).  x (B,
    T, d); positions (B, T).  Returns (B, T, d).  Where ``model`` splits
    the heads, over this rank's (``_mla_qkv``), ``wo``'s partials summed
    over ``model``."""
    q, k, v, _ = _mla_qkv(p, x, cfg, positions)
    out = out_proj(p, chunked_attention(q, k, v, causal=True))
    return TP.reduce_from_model(out) if mla_heads_split(p, cfg) else out


def mla_decode(p, x, cfg: ModelConfig, pool, view):
    """The reference's absorbed ``mla_decode`` over a paged latent pool.
    x: (n, d); ``pool``: this layer's (P, page, 1, r + rope) latent rows
    [ckv | kr]; ``view``: the step's ``DecodeView``.

    The token's latent row is written at ``view.write_index`` first;
    then q_lat = q_nope·W_uk per head (the expert-grouped GEMM with the
    H heads as groups), rounded to bf16 as the reference's einsum
    output is, and [q_lat | q_rope] attends over the pool, V being its
    first r columns, at the reference's scale 1/√(nope + rope)
    (``ops.paged_latent_attention``); the latent output goes back
    through W_uv per head and ``wo``."""
    m, H = cfg.mla, cfg.n_heads
    r = m.kv_lora_rank
    n = x.shape[0]
    pos = view.positions[:, None]                             # (n, 1)
    q_nope, q_rope = _mla_q(p, x[:, None], cfg, pos)
    ckv, kr = _mla_latent(p, x[:, None], cfg, pos)
    flat = pool.view(-1, pool.shape[-1])
    flat[view.write_index] = torch.cat([ckv[:, 0], kr[:, 0]],
                                       dim=-1).to(pool.dtype)
    counts = torch.full((H,), n, dtype=torch.int32, device=x.device)
    q_lat = ops.grouped_streaming_gemm(q_nope[:, 0].transpose(0, 1),
                                       p["wuk_hkr"], counts)    # (H, n, r)
    q = torch.cat([q_lat.transpose(0, 1), q_rope[:, 0]], dim=-1)
    o_lat = ops.paged_latent_attention(
        q.contiguous(), pool, view.table, view.lens, r,
        1 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim))
    out = ops.grouped_streaming_gemm(o_lat.transpose(0, 1), p["wuv_hrv"],
                                     counts)                    # (H, n, v)
    return out_proj(p, out.transpose(0, 1))
