"""Prefill + single-token decode over the paged KV cache, dense, vlm and
MoE branches.

The reference keeps a contiguous (L, B, S, KH, hd) cache; the port
keeps the paged pools of ``serving.kv_cache.PagedKVCache`` (one table
shared by all layers; an MoE model's ``dense_layers`` take the first
pool layers), so decode attention runs through
``ops.paged_attention``.  The cache dtype is bf16, as in the reference,
and prompt K/V is cast into it.

MoE layers route losslessly while serving, as the reference does:
capacity ``B * Tq`` at prefill and ``n`` (the active slots) at decode,
so no token is dropped and each token's output is independent of the
others in its batch.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T


def prefill(params, cfg: ModelConfig, tokens, cache, slots, *,
            embeddings=None):
    """tokens: (B, T) prompt ids, one row per cache slot in ``slots``
    (allocated with ``alloc_seq``); or, for a config with
    ``embedding_inputs`` (vlm), ``embeddings`` (B, T, d) in their place,
    precomputed patch embeddings cast to bf16 (``tokens`` None).  Writes
    every layer's K/V into the slots' pages, sets their lengths to T
    and returns the last-token logits (B, padded_vocab)."""
    if (tokens is None) == (embeddings is None):
        raise ValueError("prefill takes token ids or embeddings, "
                         "exactly one of the two")
    if embeddings is not None:
        if not cfg.embedding_inputs:
            raise ValueError(f"{cfg.name} takes token ids, not embeddings")
        x = embeddings.to(torch.bfloat16)
    else:
        x = T.embed_tokens(params, cfg, tokens)
    B, Tq = x.shape[:2]
    positions = torch.arange(Tq, device=x.device).expand(B, Tq)
    rows = cache.prompt_index(slots, Tq)                  # (B, T)
    for layer, (lp, is_moe) in enumerate(T.layer_stack(params, cfg)):
        if is_moe:
            x, _, (k, v) = T.moe_layer_fwd(lp, x, cfg, positions,
                                           capacity=B * Tq)
        else:
            x, (k, v) = T.dense_layer_fwd(lp, x, cfg, positions)
        kf, vf = cache.layer_flat(layer)
        kf[rows] = k.to(kf.dtype)
        vf[rows] = v.to(vf.dtype)
    x = L.apply_norm(params["final_norm"], x[:, -1], cfg)
    return T.lm_head(params, cfg, x)


def _decode_layer(lp, is_moe, x, cfg, k_pool, v_pool, view):
    h = L.apply_norm(lp["ln1"], x, cfg)
    x = x + L.attention_decode(lp["attn"], h, cfg, k_pool, v_pool, view)
    h = L.apply_norm(lp["ln2"], x, cfg)
    if not is_moe:
        return x + L.apply_mlp(lp["mlp"], h, cfg)
    # lossless capacity (C = n tokens) at decode: no token dropping
    y, _ = MOE.apply_moe(lp["moe"], h[:, None], cfg, capacity=x.shape[0])
    return x + y[:, 0]


def decode_step(params, cfg: ModelConfig, cache, tokens, slots):
    """tokens: (n,) the next token of each active slot in ``slots``.
    Appends each token's K/V at its slot's length and returns logits
    (n, padded_vocab).  Only the given slots are written or read."""
    view = cache.append_view(slots)
    x = params["embed"][tokens].to(torch.bfloat16)
    for layer, (lp, is_moe) in enumerate(T.layer_stack(params, cfg)):
        x = _decode_layer(lp, is_moe, x, cfg, cache.k_pages[layer],
                          cache.v_pages[layer], view)
    x = L.apply_norm(params["final_norm"], x, cfg)
    return T.lm_head(params, cfg, x)
