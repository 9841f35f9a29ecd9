"""Model assembly, dense, vlm, MoE, audio, ssm and hybrid branches:
parameter tree, embedding, the dense and MoE decoder layers, the audio
encoder, the RWKV6 and Mamba2 layers, the hybrid's shared attention
block and the lm_head (tied or not).  A vlm model is the
dense decoder; only its prefill input differs (precomputed embeddings,
``decoding.prefill``).  An audio model (whisper) is an encoder of
non-causal dense layers over precomputed frames and a decoder whose
layers add cross-attention over the encoder's output, with a learned
``pos_embed``.  An ssm model (rwkv6) is attention-free: each layer is a
time mix and a channel mix (``models.ssm``) over a recurrent state.  A
hybrid model (zamba2) is a stack of Mamba2 layers, each a Mamba2 block
and a gated MLP, with ONE shared attention block (``shared_attn``:
a norm and attention, no MLP) run on the residual stream before every
layer whose index is a multiple of ``attn_every``; each of those
invocations keeps its own K/V.

The reference scans a stacked layer tree with ``lax.scan``; the port
loops over a list of per-layer trees.  An MoE model may start with
``first_dense_layers`` dense layers (a ``dense_layers`` stack before
``layers``), as in the reference.

A config with ``mla`` (deepseek-v3) runs multi-head latent attention
in place of GQA in every layer (``layers.mla_prefill``,
``layers.mla_decode``), and with ``mtp`` carries the reference's
multi-token-prediction head (``mtp``: ``proj``, a dense ``block``,
``norm_h``, ``norm_e``), which serving builds but never runs.
"""
from __future__ import annotations

import torch

from repro_torch.configs import check_ported
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.params import PSpec, stack


def dense_layer_pspecs(cfg: ModelConfig, cross: bool = False):
    """A dense layer; with ``cross``, a decoder layer of an
    encoder-decoder, which adds ``ln_x`` and the cross-attention
    ``xattn``."""
    p = {"ln1": L.norm_pspec(cfg), "attn": _attn_pspecs(cfg),
         "ln2": L.norm_pspec(cfg), "mlp": L.mlp_pspecs(cfg)}
    if cross:
        p["ln_x"] = L.norm_pspec(cfg)
        p["xattn"] = L.attention_pspecs(cfg)
    return p


def _attn_pspecs(cfg: ModelConfig):
    return L.mla_pspecs(cfg) if cfg.mla else L.attention_pspecs(cfg)


def moe_layer_pspecs(cfg: ModelConfig):
    return {"ln1": L.norm_pspec(cfg), "attn": _attn_pspecs(cfg),
            "ln2": L.norm_pspec(cfg), "moe": MOE.moe_pspecs(cfg)}


def rwkv_layer_pspecs(cfg: ModelConfig):
    p = SSM.rwkv_pspecs(cfg)
    return {"ln1": L.norm_pspec(cfg), "time": p["time"],
            "ln2": L.norm_pspec(cfg), "channel": p["channel"]}


def mamba_layer_pspecs(cfg: ModelConfig):
    return {"ln1": L.norm_pspec(cfg), "mamba": SSM.mamba2_pspecs(cfg),
            "ln2": L.norm_pspec(cfg), "mlp": L.mlp_pspecs(cfg)}


def n_shared_invocations(cfg: ModelConfig) -> int:
    """How many times a hybrid model runs its shared attention block:
    before layers 0, attn_every, 2·attn_every, ..."""
    return -(-cfg.n_layers // cfg.ssm.attn_every)


def kv_layers(cfg: ModelConfig) -> int:
    """Pool layers of the model's paged KV cache: one per decoder layer,
    or one per shared-attention invocation of a hybrid model."""
    return n_shared_invocations(cfg) if cfg.family == "hybrid" \
        else cfg.n_layers


def kv_geometry(cfg: ModelConfig) -> tuple:
    """(KV heads, head dim) of a pool row: one latent head of
    ``kv_lora_rank + qk_rope_head_dim`` for MLA, else the config's."""
    if cfg.mla:
        return 1, cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
    return cfg.n_kv_heads, cfg.resolved_head_dim


def lm_pspecs(cfg: ModelConfig):
    check_ported(cfg)
    d, V = cfg.d_model, cfg.padded_vocab
    p: dict = {"embed": PSpec((V, d), ("vocab", "embed"), scale=0.02)}
    if not cfg.tie_embeddings:
        p["lm_head"] = PSpec((d, V), ("embed", "vocab"))
    p["final_norm"] = L.norm_pspec(cfg)
    if cfg.family in ("dense", "vlm"):
        p["layers"] = stack(dense_layer_pspecs(cfg), cfg.n_layers)
        return p
    if cfg.family == "ssm":
        p["layers"] = stack(rwkv_layer_pspecs(cfg), cfg.n_layers)
        return p
    if cfg.family == "hybrid":
        p["layers"] = stack(mamba_layer_pspecs(cfg), cfg.n_layers)
        p["shared_attn"] = {"ln": L.norm_pspec(cfg),
                            "attn": L.attention_pspecs(cfg)}
        return p
    if cfg.family == "audio":
        p["enc_layers"] = stack(dense_layer_pspecs(cfg), cfg.n_encoder_layers)
        p["enc_norm"] = L.norm_pspec(cfg)
        p["layers"] = stack(dense_layer_pspecs(cfg, cross=True),
                            cfg.n_layers)
        p["pos_embed"] = PSpec((cfg.max_train_seq * 8, d), (None, "embed"),
                               scale=0.02)
        return p
    nd = cfg.moe.first_dense_layers
    if nd:
        p["dense_layers"] = stack(dense_layer_pspecs(cfg), nd)
    p["layers"] = stack(moe_layer_pspecs(cfg), cfg.n_layers - nd)
    if cfg.mtp:
        p["mtp"] = {"proj": PSpec((2 * d, d), ("embed", "embed_act")),
                    "block": dense_layer_pspecs(cfg),
                    "norm_h": L.norm_pspec(cfg), "norm_e": L.norm_pspec(cfg)}
    return p


def add_derived(params, cfg: ModelConfig):
    """Add to ``params`` (in place, and return it) the copies that the
    decode path reads in another layout than the reference's tree: for
    every MLA layer, ``attn["wuk_hkr"]`` and ``attn["wuv_hrv"]``
    (``layers.mla_absorbed``), made once here.  Other configs have
    none."""
    if cfg.mla:
        for lp, _ in layer_stack(params, cfg):
            lp["attn"].update(L.mla_absorbed(lp["attn"]))
    return params


def layer_stack(params, cfg: ModelConfig) -> list:
    """``(layer tree, is_moe)`` for every decoder layer in order (an
    encoder-decoder's encoder layers are not in it); the index in the
    list is the layer's KV-cache layer."""
    is_moe = cfg.family == "moe"
    return [(lp, False) for lp in params.get("dense_layers", [])] + \
        [(lp, is_moe) for lp in params["layers"]]


def embed_tokens(params, cfg: ModelConfig, tokens):
    return params["embed"][tokens].to(torch.bfloat16)


def _attn_fwd(p, h, cfg: ModelConfig, positions, causal=True):
    """Prefill attention: GQA, returning (out, (k, v)), or MLA (causal),
    returning (out, (ckv, kr))."""
    if cfg.mla:
        return L.mla_prefill(p, h, cfg, positions)
    return L.attention_train(p, h, cfg, positions, causal)


def dense_layer_fwd(lp, x, cfg: ModelConfig, positions, causal=True):
    """Prefill body of one layer.  Returns (x', (k, v)), or for MLA (x',
    (ckv, kr))."""
    h = L.apply_norm(lp["ln1"], x, cfg)
    a, kv = _attn_fwd(lp["attn"], h, cfg, positions, causal)
    x = x + a
    h = L.apply_norm(lp["ln2"], x, cfg)
    return x + L.apply_mlp(lp["mlp"], h, cfg), kv


def dense_layer_fwd_nocausal(lp, x, cfg: ModelConfig, positions):
    """An encoder layer: ``dense_layer_fwd`` with full attention and no
    KV kept.  Returns x'."""
    return dense_layer_fwd(lp, x, cfg, positions, causal=False)[0]


def cross_layer_fwd(lp, x, enc, cfg: ModelConfig, positions):
    """Prefill body of an encoder-decoder's decoder layer (the
    reference's ``dec_body``): causal self-attention, then ``ln_x`` and
    cross-attention over the encoder output's K/V = enc·``wk``,
    enc·``wv`` (no bias), then ``ln2`` and the MLP.  Returns (x',
    (k, v), (k_enc, v_enc))."""
    h = L.apply_norm(lp["ln1"], x, cfg)
    a, kv = L.attention_train(lp["attn"], h, cfg, positions)
    x = x + a
    h = L.apply_norm(lp["ln_x"], x, cfg)
    xa = lp["xattn"]
    xkv = L.head_proj(xa["wk"], enc), L.head_proj(xa["wv"], enc)
    a, _ = L.attention_train(xa, h, cfg, positions, causal=False, kv=xkv)
    x = x + a
    h = L.apply_norm(lp["ln2"], x, cfg)
    return x + L.apply_mlp(lp["mlp"], h, cfg), kv, xkv


def encode(params, cfg: ModelConfig, frames):
    """The audio encoder: (B, Te, d) precomputed frame embeddings, cast
    to bf16, through ``enc_layers`` and ``enc_norm``."""
    x = frames.to(torch.bfloat16)
    B, Te = x.shape[:2]
    positions = torch.arange(Te, device=x.device).expand(B, Te)
    for lp in params["enc_layers"]:
        x = dense_layer_fwd_nocausal(lp, x, cfg, positions)
    return L.apply_norm(params["enc_norm"], x, cfg)


def moe_layer_fwd(lp, x, cfg: ModelConfig, positions, capacity=None):
    """Prefill body of one MoE layer.  Returns (x', aux, (k, v)) (MLA:
    (ckv, kr)); ``capacity`` as in ``moe.apply_moe``."""
    h = L.apply_norm(lp["ln1"], x, cfg)
    a, kv = _attn_fwd(lp["attn"], h, cfg, positions)
    x = x + a
    h = L.apply_norm(lp["ln2"], x, cfg)
    y, aux = MOE.apply_moe(lp["moe"], h, cfg, capacity=capacity)
    return x + y, aux, kv


def rwkv_layer_fwd(lp, x, cfg: ModelConfig, state):
    """Prefill body of one RWKV6 layer from ``state`` (a tree as
    ``ssm.init_rwkv_state`` makes).  Returns (x', the layer's final
    state)."""
    h = L.apply_norm(lp["ln1"], x, cfg)
    t, tstate = SSM.rwkv_time_mix(lp["time"], h, cfg, state["time"])
    x = x + t
    h = L.apply_norm(lp["ln2"], x, cfg)
    c, cshift = SSM.rwkv_channel_mix(lp["channel"], h,
                                     state["channel_shift"])
    return x + c, {"time": tstate, "channel_shift": cshift}


def mamba_layer_fwd(lp, x, cfg: ModelConfig, state):
    """One Mamba2 layer over a sequence (x: (B, T, d)) or one token (x:
    (n, d)) from ``state`` (a tree as ``ssm.init_mamba_state`` makes).
    Returns (x', the layer's final state).

    The MLP's SiLU rounds its sigmoid and product separately
    (``ssm._silu``), as the reference's ops do run one by one: the
    hybrid family, like the ssm family, is held to the reference run op
    by op, and with this the port's prefill equals it."""
    h = L.apply_norm(lp["ln1"], x, cfg)
    fwd = SSM.mamba2_step if x.ndim == 2 else SSM.mamba2_forward
    m, st = fwd(lp["mamba"], h, cfg, state)
    x = x + m
    h = L.apply_norm(lp["ln2"], x, cfg)
    return x + L.apply_mlp(lp["mlp"], h, cfg, act=SSM._silu), st


def shared_attn_fwd(sp, x, cfg: ModelConfig, positions):
    """The hybrid's shared block over a sequence: x + attention(norm(x)),
    causal.  Returns (x', (k, v))."""
    h = L.apply_norm(sp["ln"], x, cfg)
    a, kv = L.attention_train(sp["attn"], h, cfg, positions)
    return x + a, kv


def lm_head(params, cfg: ModelConfig, h):
    """h: (n, d) -> logits (n, padded_vocab) in ``h.dtype``.  The tied
    head streams ``embed`` through its transposed view, without a
    copy."""
    w = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    return ops.streaming_gemm(h, w.to(h.dtype))
