"""Prefill + single-token decode over the paged KV cache, dense branch.

The reference keeps a contiguous (L, B, S, KH, hd) cache; the port
keeps the paged pools of ``serving.kv_cache.PagedKVCache`` (one table
shared by all layers), so decode attention runs through
``ops.paged_attention``.  The cache dtype is bf16, as in the reference,
and prompt K/V is cast into it.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def prefill(params, cfg: ModelConfig, tokens, cache, slots):
    """tokens: (B, T) prompt ids, one row per cache slot in ``slots``
    (allocated with ``alloc_seq``).  Writes every layer's K/V into the
    slots' pages, sets their lengths to T and returns the last-token
    logits (B, padded_vocab)."""
    B, Tq = tokens.shape
    x = T.embed_tokens(params, cfg, tokens)
    positions = torch.arange(Tq, device=x.device).expand(B, Tq)
    rows = cache.prompt_index(slots, Tq)                  # (B, T)
    for layer, lp in enumerate(params["layers"]):
        x, (k, v) = T.dense_layer_fwd(lp, x, cfg, positions)
        kf, vf = cache.layer_flat(layer)
        kf[rows] = k.to(kf.dtype)
        vf[rows] = v.to(vf.dtype)
    x = L.apply_norm(params["final_norm"], x[:, -1], cfg)
    return T.lm_head(params, cfg, x)


def _dense_decode_layer(lp, x, cfg, k_pool, v_pool, view):
    h = L.apply_norm(lp["ln1"], x, cfg)
    x = x + L.attention_decode(lp["attn"], h, cfg, k_pool, v_pool, view)
    h = L.apply_norm(lp["ln2"], x, cfg)
    return x + L.apply_mlp(lp["mlp"], h, cfg)


def decode_step(params, cfg: ModelConfig, cache, tokens, slots):
    """tokens: (n,) the next token of each active slot in ``slots``.
    Appends each token's K/V at its slot's length and returns logits
    (n, padded_vocab).  Only the given slots are written or read."""
    view = cache.append_view(slots)
    x = params["embed"][tokens].to(torch.bfloat16)
    for layer, lp in enumerate(params["layers"]):
        x = _dense_decode_layer(lp, x, cfg, cache.k_pages[layer],
                                cache.v_pages[layer], view)
    x = L.apply_norm(params["final_norm"], x, cfg)
    return T.lm_head(params, cfg, x)
