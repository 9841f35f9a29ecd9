"""Unified model API used by the server: dense, vlm and MoE decoders,
the attention-free ssm model (rwkv6), the hybrid model (zamba2), and
the audio encoder-decoder (whisper), which only this API serves.

``Model(cfg, device=...)`` exposes:
    init(generator) -> params
    init_cache(slots, max_seq, page_tokens, n_pages, enc_seq=0)
        -> PagedKVCache (with ``.state`` for a hybrid model), or
           RecurrentStateCache for an ssm model
    prefill(params, tokens, cache, slots, embeddings=None,
            audio_frames=None) -> logits
    decode_step(params, cache, tokens, slots) -> logits

The device defaults to ``"cuda"``; without a card the constructor
raises unless the caller passes ``device="cpu"``, where every kernel
wrapper runs its plain PyTorch version.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import decoding as D
from repro_torch.models import transformer as T
from repro_torch.models.params import init_tree
from repro_torch.serving.kv_cache import PagedCacheConfig, PagedKVCache
from repro_torch.serving.state_cache import RecurrentStateCache


class Model:
    def __init__(self, cfg: ModelConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._pspecs = T.lm_pspecs(cfg)

    def init(self, generator: torch.Generator):
        """Random weights with the reference's init laws, drawn from
        ``generator`` on its device (make it on the model's device),
        with the decode path's derived layouts added
        (``transformer.add_derived``)."""
        return T.add_derived(init_tree(self._pspecs, generator), self.cfg)

    def init_cache(self, slots: int, max_seq: int, page_tokens: int = 8,
                   n_pages: Optional[int] = None,
                   enc_seq: int = 0):
        """A paged pool where, by default, every slot can grow to
        ``max_seq`` tokens; one pool layer per decoder layer of every
        stack (an MoE model's dense layers first).  An audio model also
        gets ``cache.cross``, a pool of one layer per decoder layer in
        which every slot holds ``enc_seq`` encoder tokens (the
        reference's ``init_cache(batch, seq, enc_seq)``).

        An ssm model gets a ``RecurrentStateCache`` of ``slots`` slots
        and no KV pool: its state does not grow with the sequence, so
        ``max_seq`` and ``page_tokens`` size nothing, and ``n_pages`` is
        refused.  A hybrid model gets a pool of one layer per
        shared-attention invocation, which carries the Mamba2 layers'
        ``RecurrentStateCache`` of ``slots`` slots as ``cache.state``.
        An MLA model gets one latent pool per layer, rows of
        ``kv_lora_rank + qk_rope_head_dim`` values under one KV head, and
        no V pool."""
        cfg = self.cfg
        if cfg.family == "ssm":
            if n_pages is not None or enc_seq:
                raise ValueError(f"{cfg.name} has no KV pool")
            return RecurrentStateCache(cfg, slots, device=self.device)
        if (cfg.family == "audio") != (enc_seq > 0):
            raise ValueError(f"{cfg.name}: enc_seq is the encoder length "
                             "of an audio model, and only of one")
        cache = self._paged(slots, max_seq, page_tokens, n_pages)
        if enc_seq:
            cache.cross = self._paged(slots, enc_seq, page_tokens, None)
        if cfg.family == "hybrid":
            cache.state = RecurrentStateCache(cfg, slots, device=self.device)
        return cache

    def _paged(self, slots, max_seq, page_tokens, n_pages) -> PagedKVCache:
        cfg = self.cfg
        pages_per_seq = -(-max_seq // page_tokens)
        kv_heads, head_dim = T.kv_geometry(cfg)
        return PagedKVCache(
            PagedCacheConfig(
                n_pages=n_pages or slots * pages_per_seq,
                page_tokens=page_tokens, n_kv_heads=kv_heads,
                head_dim=head_dim, max_pages_per_seq=pages_per_seq),
            max_seqs=slots, n_layers=T.kv_layers(cfg), device=self.device,
            v_pool=cfg.mla is None)

    def prefill(self, params, tokens, cache, slots, *,
                embeddings=None, audio_frames=None):
        """Token ids (B, T), or ``tokens=None`` and (B, T, d)
        ``embeddings`` for a vlm config; an audio config takes the
        decoder's token ids with (B, Te, d) ``audio_frames``.  Decode
        takes token ids."""
        return D.prefill(params, self.cfg, tokens, cache, slots,
                         embeddings=embeddings, audio_frames=audio_frames)

    def decode_step(self, params, cache, tokens, slots):
        return D.decode_step(params, self.cfg, cache, tokens, slots)
