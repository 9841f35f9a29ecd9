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

Training (``forward_train``, ``chunked_ce_loss``, ``mtp_loss``) covers
every family: each layer's attention is ``layers.attention_train_chunked``
(causal, or non-causal in whisper's encoder and cross-attention) or
``layers.mla_train_chunked`` (chunked attention as torch ops), and the
ssm and hybrid layers run the chunked scan (``models.ssm``) as torch
ops from a zero state; every projection, the MLP, the router, the
shared experts, the MTP head's ``proj`` and the lm_head run through the
streaming GEMM, whose backward products run on the same kernel, and the
expert products through the grouped GEMM, whose backward products run
on kernels of their own.  An MoE model runs its ``dense_layers`` first
(its ``layers`` may be empty, as in a depth cut to the dense layers)
and sums its layers' aux losses.  A hybrid model runs its shared block
inside the body of every layer whose index is a multiple of
``attn_every``.  ``remat`` picks what the backward pass recomputes
(``_remat``: ``"none"``, ``"dots"`` or ``"full"``, through
``torch.utils.checkpoint``).

A config with ``mla`` (deepseek-v3) runs multi-head latent attention
in place of GQA in every layer (``layers.mla_prefill``,
``layers.mla_decode``, ``layers.mla_train_chunked``), and with ``mtp``
carries the reference's multi-token-prediction head (``mtp``: ``proj``,
a dense ``block``, ``norm_h``, ``norm_e``), which training runs
(``mtp_loss``) and serving builds but never runs.  The absorbed decode's
per-head copies of ``wuk`` / ``wuv`` (``DERIVED``) are no parameters:
``trainable`` leaves them out of what the optimizer, the gradients and
the checkpoints hold, and ``add_derived`` remakes them.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import check_ported
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models import tuning as TU
from repro_torch.models.params import PSpec, stack
from repro_torch.sharding import tensor_parallel as TP


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


# the copies the decode path reads in another layout than the
# reference's tree (``layers.mla_absorbed``): no parameters
DERIVED = ("wuk_hkr", "wuv_hrv")


def add_derived(params, cfg: ModelConfig):
    """Add to ``params`` (in place, and return it) the copies that the
    decode path reads in another layout than the reference's tree: for
    every MLA layer, ``attn["wuk_hkr"]`` and ``attn["wuv_hrv"]``
    (``layers.mla_absorbed``), made here when the weights are loaded and
    made again from the updated ``wuk`` / ``wuv`` after every optimizer
    update.  Other configs have none."""
    if cfg.mla:
        for lp, _ in layer_stack(params, cfg):
            lp["attn"].update(L.mla_absorbed(lp["attn"]))
    return params


def remake_derived(tree, template):
    """``tree``, a tree without the derived copies (``trainable``), with
    them made from its weights in every dict whose counterpart in
    ``template`` holds them (a checkpoint restored into a template made
    by ``Model.init``).  In place; returns ``tree``."""
    if isinstance(template, dict):
        if any(k in template for k in DERIVED):
            tree.update(L.mla_absorbed(tree))
        for k, v in tree.items():
            if k in template:
                remake_derived(v, template[k])
    elif isinstance(template, list):
        for v, t in zip(tree, template):
            remake_derived(v, t)
    return tree


def trainable(tree):
    """``tree`` (parameters, or a train state holding them) without the
    derived copies (``DERIVED``): the reference's leaves, which the
    gradients, the optimizer state, gradient compression and the
    checkpoints hold.  The tensors are shared, not copied."""
    if isinstance(tree, dict):
        return {k: trainable(v) for k, v in tree.items()
                if k not in DERIVED}
    if isinstance(tree, list):
        return [trainable(v) for v in tree]
    return tree


def layer_stack(params, cfg: ModelConfig) -> list:
    """``(layer tree, is_moe)`` for every decoder layer in order (an
    encoder-decoder's encoder layers are not in it); the index in the
    list is the layer's KV-cache layer."""
    is_moe = cfg.family == "moe"
    return [(lp, False) for lp in params.get("dense_layers", [])] + \
        [(lp, is_moe) for lp in params["layers"]]


def embed_tokens(params, cfg: ModelConfig, tokens):
    """The rows of ``tokens``, in bf16; from the vocabulary split over
    ``model`` where ``params["embed"]`` holds this rank's block of rows
    (``tensor_parallel.embedding``)."""
    emb = params["embed"]
    if TP.parallel(emb.shape[0], cfg.padded_vocab):
        return TP.embedding(emb, tokens)
    return emb[tokens].to(torch.bfloat16)


def _vocab_split(params, cfg: ModelConfig) -> bool:
    """True where ``model`` splits the lm_head's vocabulary (the tied
    ``embed``'s rows, or ``lm_head``'s columns)."""
    w = params["embed"] if cfg.tie_embeddings else params["lm_head"].t()
    return TP.parallel(w.shape[0], cfg.padded_vocab)


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


# =====================================================================
# training: every family
# =====================================================================
def _remat(fn, mode: str):
    """``fn`` as the layer body of training: ``"none"`` keeps every
    activation for the backward pass, ``"full"`` keeps only the layer's
    inputs and recomputes the rest in the backward pass, ``"dots"``
    keeps the layer's inputs and every streaming-GEMM output and
    recomputes the rest (the grouped GEMM, the attention, the scans and
    the elementwise ops), as the reference's
    ``dots_with_no_batch_dims_saveable``: its 2-D projections are the
    port's streaming GEMM, and its batched einsums are what the port
    recomputes."""
    if mode == "none":
        return fn
    if mode == "full":
        return lambda *args: checkpoint(fn, *args, use_reentrant=False)
    if mode == "dots":      # the recompute replays the GEMM's outputs
        return lambda *args: checkpoint(
            fn, *args, use_reentrant=False,
            context_fn=lambda: ops.GemmTape().contexts())
    raise ValueError(f"remat {mode!r}: none | dots | full")


def _attn_train(p, h, cfg: ModelConfig, positions, causal=True):
    """Training attention, MLA (causal) or GQA as the config says (the
    reference's ``_attn_block``)."""
    if cfg.mla:
        return L.mla_train_chunked(p, h, cfg, positions)
    return L.attention_train_chunked(p, h, cfg, positions, causal)


def dense_layer_train(lp, x, cfg: ModelConfig, positions, causal=True):
    """Training body of one dense layer (the reference's
    ``dense_layer_fwd``, or with ``causal=False`` an encoder layer,
    ``dense_layer_fwd_nocausal``): x + attention(norm(x)), then
    x + mlp(norm(x))."""
    h = L.apply_norm(lp["ln1"], x, cfg)
    x = x + _attn_train(lp["attn"], h, cfg, positions, causal)
    h = L.apply_norm(lp["ln2"], x, cfg)
    return x + L.apply_mlp(lp["mlp"], h, cfg)


def moe_layer_train(lp, x, cfg: ModelConfig, positions):
    """Training body of one MoE layer (the reference's
    ``moe_layer_fwd``): x + attention(norm(x)), then x + moe(norm(x)).
    Returns (x', the layer's aux loss)."""
    h = L.apply_norm(lp["ln1"], x, cfg)
    x = x + _attn_train(lp["attn"], h, cfg, positions)
    h = L.apply_norm(lp["ln2"], x, cfg)
    y, aux = MOE.apply_moe(lp["moe"], h, cfg)
    return x + y, aux


def hybrid_layer_train(lp, shared, x, cfg: ModelConfig, positions, state,
                       with_attn: bool):
    """Training body of one hybrid layer (the reference's scanned body):
    with ``with_attn`` (the layer's index a multiple of ``attn_every``)
    the shared block first, x + attention(norm(x)) through ``shared``,
    then the Mamba2 layer from the zero ``state``.  The shared block's
    leaves are the same tensors at every invocation, so autograd sums
    their gradients."""
    if with_attn:
        h = L.apply_norm(shared["ln"], x, cfg)
        x = x + L.attention_train_chunked(shared["attn"], h, cfg, positions)
    return mamba_layer_fwd(lp, x, cfg, state)[0]


def cross_layer_train(lp, x, enc, cfg: ModelConfig, positions):
    """Training body of an encoder-decoder's decoder layer (the
    reference's ``dec_body``): causal self-attention, then ``ln_x`` and
    non-causal cross-attention over enc·``wk``, enc·``wv`` (no bias, no
    RoPE), then ``ln2`` and the MLP."""
    h = L.apply_norm(lp["ln1"], x, cfg)
    x = x + L.attention_train_chunked(lp["attn"], h, cfg, positions)
    h = L.apply_norm(lp["ln_x"], x, cfg)
    xa = lp["xattn"]
    kv = L.head_proj(xa["wk"], enc), L.head_proj(xa["wv"], enc)
    x = x + L.attention_train_chunked(xa, h, cfg, positions, causal=False,
                                      kv=kv)
    h = L.apply_norm(lp["ln2"], x, cfg)
    return x + L.apply_mlp(lp["mlp"], h, cfg)


def forward_train(params, cfg: ModelConfig, batch, remat: str = "full"):
    """A batch to the final normed hidden states.  Returns (hidden (B,
    T, d), aux loss, extras).

    The input is token ids ``batch["tokens"]`` (B, T), or (B, T, d)
    ``batch["embeddings"]`` for a config with ``embedding_inputs``; an
    audio model takes (B, Te, d) ``batch["audio_frames"]`` and the
    decoder's token ids (``_forward_train_encdec``) and returns the
    encoder's output as extras ``{"encoder_out": enc}``, the others
    ``{}``.  The aux loss is the sum over the MoE layers, a float32 zero
    for the other families.  Each layer runs from the zero state of an
    ssm (``ssm.init_rwkv_state`` with the activations' dtype) or hybrid
    (``ssm.init_mamba_state``) model, as the reference's does."""
    if cfg.family == "audio":
        return _forward_train_encdec(params, cfg, batch, remat)
    if cfg.embedding_inputs and "embeddings" in batch:
        x = batch["embeddings"].to(torch.bfloat16)
    else:
        x = embed_tokens(params, cfg, batch["tokens"])
    B, T = x.shape[:2]
    positions = torch.arange(T, device=x.device).expand(B, T)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        state = SSM.init_rwkv_state(cfg, B, x.dtype, x.device)
        body = _remat(lambda lp, x: rwkv_layer_fwd(lp, x, cfg, state)[0],
                      remat)
        for lp in params["layers"]:
            x = body(lp, x)
    elif cfg.family == "hybrid":
        state = SSM.init_mamba_state(cfg, B, device=x.device)
        shared, every = params["shared_attn"], cfg.ssm.attn_every
        body = _remat(lambda lp, x, attn: hybrid_layer_train(
            lp, shared, x, cfg, positions, state, attn), remat)
        for i, lp in enumerate(params["layers"]):
            x = body(lp, x, i % every == 0)
    else:
        body = _remat(lambda lp, x: dense_layer_train(lp, x, cfg,
                                                      positions), remat)
        for lp in params.get("dense_layers", []):
            x = body(lp, x)
        if cfg.family == "moe":
            moe_body = _remat(
                lambda lp, x: moe_layer_train(lp, x, cfg, positions), remat)
            for lp in params["layers"]:
                x, a = moe_body(lp, x)
                aux = aux + a
        else:
            for lp in params["layers"]:
                x = body(lp, x)
    x = L.apply_norm(params["final_norm"], x, cfg)
    return x, aux, {}


def _forward_train_encdec(params, cfg: ModelConfig, batch, remat):
    """The audio family's training forward (the reference's
    ``_forward_train_encdec``): the non-causal encoder over
    ``batch["audio_frames"]`` (cast to bf16) and ``enc_norm``, then the
    decoder over the token ids plus ``pos_embed[:Td]``, each decoder
    layer attending over the encoder's output.  Returns (hidden (B, Td,
    d), a float32 zero, {"encoder_out": enc})."""
    x = batch["audio_frames"].to(torch.bfloat16)
    B, Te = x.shape[:2]
    pos_e = torch.arange(Te, device=x.device).expand(B, Te)
    enc_body = _remat(lambda lp, x: dense_layer_train(
        lp, x, cfg, pos_e, causal=False), remat)
    for lp in params["enc_layers"]:
        x = enc_body(lp, x)
    enc = L.apply_norm(params["enc_norm"], x, cfg)

    tokens = batch["tokens"]
    Td = tokens.shape[1]
    x = embed_tokens(params, cfg, tokens)
    x = x + params["pos_embed"][:Td].to(x.dtype)
    pos_d = torch.arange(Td, device=x.device).expand(tokens.shape[0], Td)
    dec_body = _remat(lambda lp, x, enc: cross_layer_train(
        lp, x, enc, cfg, pos_d), remat)
    for lp in params["layers"]:
        x = dec_body(lp, x, enc)
    x = L.apply_norm(params["final_norm"], x, cfg)
    return x, torch.zeros((), dtype=torch.float32, device=x.device), \
        {"encoder_out": enc}


def chunked_ce_loss(params, cfg: ModelConfig, h, labels, t_chunk: int = 0):
    """Mean cross-entropy over the valid labels (``-1`` is ignored).
    h: (B, T, d); labels: (B, T).  The logits are made ``t_chunk`` (default
    ``Tuning.ce_chunk``) positions at a time, (B·t_chunk, padded vocab)
    in fp32, never (B, T, V); a T that ``t_chunk`` does not divide ends
    with a shorter chunk (the reference pads it with ignored labels,
    which add nothing).  Logits of the vocabulary's padding columns are
    masked out.  Where ``model`` splits the vocabulary, each rank makes
    the logits of its block, from h through ``copy_to_model``, and the
    softmax is taken over the blocks
    (``tensor_parallel.cross_entropy``)."""
    B, T, d = h.shape
    V = cfg.padded_vocab
    t_chunk = min(t_chunk or TU.get().ce_chunk, T)
    split = _vocab_split(params, cfg)
    pad = None
    if V != cfg.vocab_size and not split:
        pad = torch.arange(V, device=h.device) >= cfg.vocab_size
    losses, counts = [], []
    for t0 in range(0, T, t_chunk):
        hb = h[:, t0:t0 + t_chunk].reshape(-1, d)
        lb = labels[:, t0:t0 + t_chunk].reshape(-1).long()
        if split:
            logits = lm_head(params, cfg, TP.copy_to_model(hb)).float()
            lse, gold = TP.cross_entropy(logits, lb, cfg.vocab_size)
        else:
            logits = lm_head(params, cfg, hb).float()
            if pad is not None:
                logits = logits.masked_fill(pad, L.NEG_INF)
            lse = torch.logsumexp(logits, dim=-1)
            gold = logits.gather(-1, lb.clamp(min=0)[:, None])[:, 0]
        valid = (lb >= 0).float()
        losses.append(((lse - gold) * valid).sum())
        counts.append(valid.sum())
    return torch.stack(losses).sum() / \
        torch.clamp(torch.stack(counts).sum(), min=1.0)


def mtp_loss(params, cfg: ModelConfig, h, batch):
    """DeepSeek-V3's multi-token prediction (depth 1), the reference's
    ``mtp_loss``: predict token t+2 from [norm_h(h_t) | norm_e(embed(token
    t+1))] (the last position's next token is token 0) through ``proj``
    (2d x d) and one dense layer (``mtp.block``, MLA attention), then the
    chunked cross-entropy against the labels shifted left by one (the
    last column ``-1``), with no final norm, as the reference.  h: (B, T,
    d), the final normed hidden states.  A config without ``mtp`` raises
    ``ValueError`` (the reference fails on the missing ``mtp`` key)."""
    if not cfg.mtp:
        raise ValueError(f"{cfg.name} has no multi-token-prediction head "
                         "(cfg.mtp is off)")
    mp = params["mtp"]
    tokens, labels = batch["tokens"], batch["labels"]
    B, T = tokens.shape
    nxt = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])], dim=1)
    e = embed_tokens(params, cfg, nxt)
    hh = torch.cat([L.apply_norm(mp["norm_h"], h, cfg),
                    L.apply_norm(mp["norm_e"], e, cfg)], dim=-1)
    x = L._gemm(hh, mp["proj"])
    positions = torch.arange(T, device=x.device).expand(B, T)
    x = dense_layer_train(mp["block"], x, cfg, positions)
    lbl2 = torch.cat([labels[:, 1:], torch.full_like(labels[:, :1], -1)],
                     dim=1)
    return chunked_ce_loss(params, cfg, x, lbl2)
