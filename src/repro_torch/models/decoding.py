"""Prefill + single-token decode, dense, vlm, MoE and audio branches
over the paged KV cache, and the ssm branch over the per-slot recurrent
state (``serving.state_cache.RecurrentStateCache``).

The reference keeps a contiguous (L, B, S, KH, hd) cache; the port
keeps the paged pools of ``serving.kv_cache.PagedKVCache`` (one table
shared by all layers; an MoE model's ``dense_layers`` take the first
pool layers), so decode attention runs through
``ops.paged_attention``.  The cache dtype is bf16, as in the reference,
and prompt K/V is cast into it; or, for the INT8 KV cache
(``Tuning.kv_cache_quant`` when the cache was made), int8 pools with
fp16 per-(token, KV head) scales, into which prefill quantizes the
prompt's rows and decode each new token's (``ops.kv_quantize_append``,
one launch a layer for K and V).  Prefill attention runs on the
unquantized bf16 K/V, as the reference's does.  The hybrid's shared
pool, the latent pool and whisper's cross pool stay bf16 (the
reference quantizes only a GQA cache it builds with ``_attn_cache_zeros``
or pads through ``_pad_cache_seq``).

MoE layers route losslessly while serving, as the reference does:
capacity ``B * Tq`` at prefill and ``n`` (the active slots) at decode,
so no token is dropped and each token's output is independent of the
others in its batch.

An audio model (whisper) keeps its encoder's K/V in a second paged
cache, ``cache.cross``: prefill writes it once, and decode attends over
it with ``ops.paged_attention`` at lens = Te, the reference's
``decode_attention(q, xk, xv, Te)`` over a paged layout.

An ssm model (rwkv6) has no KV: prefill runs each layer from a zero
state over the prompt and writes the layer's final state into the
slots; decode gathers the slots' state, runs one recurrence step and
scatters it back.  Neither runs attention.

A model with multi-head latent attention (deepseek-v3) keeps ONE latent
pool per layer, (P, page, 1, r + rope) rows [ckv | kr] (``cache.k_pages``;
``cache.v_pages`` is None): V is the first r columns of the same rows.
Prefill writes ckv after ``kv_norm`` and kr after RoPE, as the
reference's prefill returns them; decode appends the token's row at its
write index, then attends in the absorbed form
(``layers.mla_decode``).

A hybrid model (zamba2) has both: its Mamba2 layers' state lives in the
cache's ``state`` store, handled as the ssm model's is, and its shared
attention block's K/V in a paged pool of one layer per invocation
(pool layer ``inv`` for the invocation before layer ``inv ·
attn_every``; one table shared by them all).  Prefill runs the shared
block through ``ops.flash_attention`` and writes pool layer ``inv``;
decode attends over it through ``ops.paged_attention``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as T
from repro_torch.models import tuning as TU


# =====================================================================
# the cache's logical axes
# =====================================================================
def quantized_cache(cfg: ModelConfig) -> bool:
    """True when ``Model.init_cache`` under the active ``Tuning`` makes
    int8 K/V pools: dense, vlm, MoE (not MLA) and audio (its
    self-attention), with ``kv_cache_quant``."""
    return TU.get().kv_cache_quant and cfg.mla is None and \
        cfg.family in ("dense", "vlm", "moe", "audio")


def _attn_cache_axes(cfg: ModelConfig, quantized: bool = False):
    """The pools of every layer, (L, P, page, KH, hd) (and their (L, P,
    KH, page) scales), as ``PagedKVCache`` holds them: ``layers`` before
    one layer's axes (``layers.cache_axes`` / ``mla_cache_axes``)."""
    per = L.mla_cache_axes(cfg) if cfg.mla else \
        L.cache_axes(cfg, quantized)
    names = {"k": "k_pages", "v": "v_pages", "k_scale": "k_scale",
             "v_scale": "v_scale"}
    return {names[k]: ("layers",) + a for k, a in per.items()}


def cache_axes(cfg: ModelConfig):
    """Logical axes of the tensors of ``Model.init_cache``'s cache
    (``cache_tree``), under the active ``Tuning``.  The reference's cache
    is contiguous, (L, B, S, KH, hd); the port's is paged, (L, P, page,
    KH, hd) pools with one page table, so the leaves differ: every dim
    that means what a reference dim means keeps its name (``layers``,
    ``kv_heads``, ``head_dim``, the latent ``lora``, the state dims,
    ``cache_batch`` for a state store's slot), the page and in-page
    token dims are ``None``.  The page tables and lengths live on the
    host and have no axes."""
    fam = cfg.family
    if fam == "ssm":
        st = SSM.rwkv_state_axes(cfg)
        flat = {**st["time"], "channel_shift": st["channel_shift"]}
        return {k: ("layers",) + a for k, a in flat.items()}
    ax = _attn_cache_axes(cfg, quantized_cache(cfg))
    if fam == "hybrid":
        ax["state"] = {k: ("layers",) + a
                       for k, a in SSM.mamba_state_axes(cfg).items()}
    elif fam == "audio":
        ax["cross"] = _attn_cache_axes(cfg)
    return ax


def cache_tree(cache) -> dict:
    """The tensors of a ``PagedKVCache`` or ``RecurrentStateCache``, in
    ``cache_axes``' structure."""
    if not hasattr(cache, "k_pages"):
        return {n: getattr(cache, n) for n in cache.names}
    out = {n: getattr(cache, n) for n in ("k_pages", "v_pages", "k_scale",
                                          "v_scale")
           if getattr(cache, n) is not None}
    if cache.state is not None:
        out["state"] = cache_tree(cache.state)
    if cache.cross is not None:
        out["cross"] = cache_tree(cache.cross)
    return out


def prefill(params, cfg: ModelConfig, tokens, cache, slots, *,
            embeddings=None, audio_frames=None):
    """tokens: (B, T) prompt ids, one row per cache slot in ``slots``
    (allocated with ``alloc_seq``); or, for a config with
    ``embedding_inputs`` (vlm), ``embeddings`` (B, T, d) in their place,
    precomputed patch embeddings cast to bf16 (``tokens`` None).  Writes
    every layer's K/V into the slots' pages, sets their lengths to T
    and returns the last-token logits (B, padded_vocab).

    An audio config (whisper) takes ``audio_frames`` (B, Te, d) beside
    the decoder's ``tokens``: see ``_prefill_audio``.  An ssm config
    (rwkv6) writes each layer's final recurrent state into the slots of
    its ``RecurrentStateCache`` instead: see ``_prefill_ssm``."""
    if cfg.family == "audio":
        if embeddings is not None or audio_frames is None or tokens is None:
            raise ValueError(f"{cfg.name} prefills decoder token ids with "
                             "audio_frames, and takes no embeddings")
        return _prefill_audio(params, cfg, tokens, audio_frames, cache,
                              slots)
    if audio_frames is not None:
        raise ValueError(f"{cfg.name} takes no audio_frames")
    if (tokens is None) == (embeddings is None):
        raise ValueError("prefill takes token ids or embeddings, "
                         "exactly one of the two")
    if embeddings is not None:
        if not cfg.embedding_inputs:
            raise ValueError(f"{cfg.name} takes token ids, not embeddings")
        x = embeddings.to(torch.bfloat16)
    else:
        x = T.embed_tokens(params, cfg, tokens)
    if cfg.family == "ssm":
        return _prefill_ssm(params, cfg, x, cache, slots)
    if cfg.family == "hybrid":
        return _prefill_hybrid(params, cfg, x, cache, slots)
    B, Tq = x.shape[:2]
    positions = torch.arange(Tq, device=x.device).expand(B, Tq)
    rows = cache.prompt_index(slots, Tq)                  # (B, T)
    write = _write_latent if cfg.mla else _write
    for layer, (lp, is_moe) in enumerate(T.layer_stack(params, cfg)):
        if is_moe:
            x, _, kv = T.moe_layer_fwd(lp, x, cfg, positions,
                                       capacity=B * Tq)
        else:
            x, kv = T.dense_layer_fwd(lp, x, cfg, positions)
        write(cache, layer, rows, *kv)
    x = L.apply_norm(params["final_norm"], x[:, -1], cfg)
    return T.lm_head(params, cfg, x)


def _prefill_ssm(params, cfg: ModelConfig, x, cache, slots):
    """The ssm branch of prefill (reference ``decoding.prefill``): every
    layer from a zero state; its final state overwrites the slots' state
    in ``cache`` (a ``RecurrentStateCache``)."""
    B, Tq = x.shape[:2]
    idx = cache.prompt_slots(slots, Tq)
    st0 = SSM.init_rwkv_state(cfg, B, x.dtype, x.device)
    for layer, lp in enumerate(params["layers"]):
        x, st = T.rwkv_layer_fwd(lp, x, cfg, st0)
        cache.write(layer, idx, st)
    x = L.apply_norm(params["final_norm"], x[:, -1], cfg)
    return T.lm_head(params, cfg, x)


def _prefill_hybrid(params, cfg: ModelConfig, x, cache, slots):
    """The hybrid branch of prefill (reference ``decoding.prefill``):
    the shared block before every ``attn_every``-th layer, its K/V into
    pool layer ``inv``; every Mamba2 layer from a zero state, its final
    state overwriting the slots' state in ``cache.state``."""
    B, Tq = x.shape[:2]
    positions = torch.arange(Tq, device=x.device).expand(B, Tq)
    rows = cache.prompt_index(slots, Tq)
    idx = cache.state.prompt_slots(slots, Tq)
    st0 = SSM.init_mamba_state(cfg, B, x.dtype, x.device)
    for layer, lp in enumerate(params["layers"]):
        if layer % cfg.ssm.attn_every == 0:
            x, (k, v) = T.shared_attn_fwd(params["shared_attn"], x, cfg,
                                          positions)
            _write(cache, layer // cfg.ssm.attn_every, rows, k, v)
        x, st = T.mamba_layer_fwd(lp, x, cfg, st0)
        cache.state.write(layer, idx, st)
    x = L.apply_norm(params["final_norm"], x[:, -1], cfg)
    return T.lm_head(params, cfg, x)


def _write(cache, layer, rows, k, v):
    """Prompt K/V (B, T, KH, hd) into ``layer`` at the flat pool ``rows``
    (B, T): cast into a float pool, quantized into an int8 one."""
    KH, hd = k.shape[-2:]
    ops.kv_write(cache.layer_pools(layer), rows.reshape(-1),
                 k.reshape(-1, KH, hd), v.reshape(-1, KH, hd))


def _write_latent(cache, layer, rows, ckv, kr):
    """An MLA layer's prompt latents: rows [ckv | kr] of its pool."""
    pool = cache.k_pages[layer]
    flat = pool.view(-1, pool.shape[-1])
    flat[rows] = torch.cat([ckv, kr], dim=-1).to(flat.dtype)


def _prefill_audio(params, cfg: ModelConfig, tokens, frames, cache, slots):
    """Whisper's prefill (reference ``decoding.prefill``, audio branch):
    encode the frames with full attention; embed the decoder tokens and
    add ``pos_embed[:Td]``; run each decoder layer
    (``transformer.cross_layer_fwd``), its self K/V into ``cache`` and
    its encoder K/V into ``cache.cross``, where each slot takes Te
    tokens.  The slots' cross pages must be free."""
    cross = cache.cross
    B, Te = frames.shape[:2]
    for slot in slots:
        if cross.active[slot]:
            raise ValueError(f"slot {slot} still holds encoder KV: free "
                             "it before a new prefill")
        if not cross.alloc_seq(slot, Te):
            raise RuntimeError("out of cross-attention KV pages")
    xrows = cross.prompt_index(slots, Te)                  # (B, Te)
    enc = T.encode(params, cfg, frames)
    x = T.embed_tokens(params, cfg, tokens)
    Td = x.shape[1]
    x = x + params["pos_embed"][:Td].to(x.dtype)
    positions = torch.arange(Td, device=x.device).expand(B, Td)
    rows = cache.prompt_index(slots, Td)
    for layer, (lp, _) in enumerate(T.layer_stack(params, cfg)):
        x, kv, xkv = T.cross_layer_fwd(lp, x, enc, cfg, positions)
        _write(cache, layer, rows, *kv)
        _write(cross, layer, xrows, *xkv)
    x = L.apply_norm(params["final_norm"], x[:, -1], cfg)
    return T.lm_head(params, cfg, x)


def _decode_layer(lp, is_moe, x, cfg, pools, view, cross=None):
    """``pools``: the layer's ``PagedKVCache.layer_pools``.  ``cross``:
    an encoder-decoder's (k_pool, v_pool, read view) of this layer's
    encoder KV, attended between self-attention and the MLP."""
    h = L.apply_norm(lp["ln1"], x, cfg)
    if cfg.mla:      # pools[0] is the layer's latent pool; no V pool
        x = x + L.mla_decode(lp["attn"], h, cfg, pools[0], view)
    else:
        x = x + L.attention_decode(lp["attn"], h, cfg, pools, view)
    if cross is not None:
        h = L.apply_norm(lp["ln_x"], x, cfg)
        x = x + L.cross_attention_decode(lp["xattn"], h, *cross)
    h = L.apply_norm(lp["ln2"], x, cfg)
    if not is_moe:
        return x + L.apply_mlp(lp["mlp"], h, cfg)
    # lossless capacity (C = n tokens) at decode: no token dropping
    y, _ = MOE.apply_moe(lp["moe"], h[:, None], cfg, capacity=x.shape[0])
    return x + y[:, 0]


def decode_step(params, cfg: ModelConfig, cache, tokens, slots):
    """tokens: (n,) the next token of each active slot in ``slots``.
    Appends each token's K/V at its slot's length and returns logits
    (n, padded_vocab).  Only the given slots are written or read.  An
    audio model adds ``pos_embed`` at each slot's own position and
    reads, per layer, the encoder KV that prefill wrote.  An ssm model
    steps each slot's recurrent state instead (``_decode_ssm``); a
    hybrid model does both (``_decode_hybrid``)."""
    if cfg.family == "ssm":
        return _decode_ssm(params, cfg, cache, tokens, slots)
    if cfg.family == "hybrid":
        return _decode_hybrid(params, cfg, cache, tokens, slots)
    view = cache.append_view(slots)
    x = params["embed"][tokens].to(torch.bfloat16)
    audio = cfg.family == "audio"
    if audio:
        x = x + params["pos_embed"][view.positions].to(x.dtype)
        xview = cache.cross.read_view(slots)
    for layer, (lp, is_moe) in enumerate(T.layer_stack(params, cfg)):
        cross = (cache.cross.k_pages[layer], cache.cross.v_pages[layer],
                 xview) if audio else None
        x = _decode_layer(lp, is_moe, x, cfg, cache.layer_pools(layer),
                          view, cross)
    x = L.apply_norm(params["final_norm"], x, cfg)
    return T.lm_head(params, cfg, x)


def _decode_ssm(params, cfg: ModelConfig, cache, tokens, slots):
    """The ssm branch of decode_step: per layer, gather the slots'
    state, run the time mix's single step and the channel mix on the
    token, scatter the new state back."""
    idx = cache.decode_slots(slots)
    x = params["embed"][tokens].to(torch.bfloat16)
    for layer, lp in enumerate(params["layers"]):
        st = cache.read(layer, idx)
        h = L.apply_norm(lp["ln1"], x, cfg)
        t, tstate = SSM.rwkv_time_mix_step(lp["time"], h, cfg, st["time"])
        x = x + t
        h = L.apply_norm(lp["ln2"], x, cfg)
        c, cshift = SSM.rwkv_channel_mix(lp["channel"], h,
                                         st["channel_shift"])
        x = x + c
        cache.write(layer, idx, {"time": tstate, "channel_shift": cshift})
    x = L.apply_norm(params["final_norm"], x, cfg)
    return T.lm_head(params, cfg, x)


def _decode_hybrid(params, cfg: ModelConfig, cache, tokens, slots):
    """The hybrid branch of decode_step: the shared block's decode
    attention over pool layer ``inv`` before every ``attn_every``-th
    layer (the token's K/V appended there first), and per Mamba2 layer
    the slots' state gathered, stepped and scattered back."""
    view = cache.append_view(slots)
    idx = cache.state.decode_slots(slots)
    sp = params["shared_attn"]
    x = params["embed"][tokens].to(torch.bfloat16)
    for layer, lp in enumerate(params["layers"]):
        if layer % cfg.ssm.attn_every == 0:
            inv = layer // cfg.ssm.attn_every
            h = L.apply_norm(sp["ln"], x, cfg)
            x = x + L.attention_decode(sp["attn"], h, cfg,
                                       cache.layer_pools(inv), view)
        x, st = T.mamba_layer_fwd(lp, x, cfg, cache.state.read(layer, idx))
        cache.state.write(layer, idx, st)
    x = L.apply_norm(params["final_norm"], x, cfg)
    return T.lm_head(params, cfg, x)
