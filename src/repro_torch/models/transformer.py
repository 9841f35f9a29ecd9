"""Model assembly, dense branch: parameter tree, embedding, the dense
decoder layer and the (tied) lm_head.

The reference scans a stacked layer tree with ``lax.scan``; the port
loops over a list of per-layer trees.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.params import PSpec, stack


def dense_layer_pspecs(cfg: ModelConfig):
    return {"ln1": L.norm_pspec(cfg), "attn": L.attention_pspecs(cfg),
            "ln2": L.norm_pspec(cfg), "mlp": L.mlp_pspecs(cfg)}


def lm_pspecs(cfg: ModelConfig):
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet")
    d, V = cfg.d_model, cfg.padded_vocab
    p: dict = {"embed": PSpec((V, d), ("vocab", "embed"), scale=0.02)}
    if not cfg.tie_embeddings:
        p["lm_head"] = PSpec((d, V), ("embed", "vocab"))
    p["final_norm"] = L.norm_pspec(cfg)
    p["layers"] = stack(dense_layer_pspecs(cfg), cfg.n_layers)
    return p


def embed_tokens(params, cfg: ModelConfig, tokens):
    return params["embed"][tokens].to(torch.bfloat16)


def dense_layer_fwd(lp, x, cfg: ModelConfig, positions):
    """Prefill body of one layer.  Returns (x', (k, v))."""
    h = L.apply_norm(lp["ln1"], x, cfg)
    a, kv = L.attention_train(lp["attn"], h, cfg, positions)
    x = x + a
    h = L.apply_norm(lp["ln2"], x, cfg)
    return x + L.apply_mlp(lp["mlp"], h, cfg), kv


def lm_head(params, cfg: ModelConfig, h):
    """h: (n, d) -> logits (n, padded_vocab) in ``h.dtype``.  The tied
    head streams ``embed`` through its transposed view, without a
    copy."""
    w = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    return ops.streaming_gemm(h, w.to(h.dtype))
