"""Unified model API used by the server, dense decoders.

``Model(cfg, device=...)`` exposes:
    init(generator) -> params
    init_cache(slots, max_seq, page_tokens, n_pages) -> PagedKVCache
    prefill(params, tokens, cache, slots) -> logits
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


class Model:
    def __init__(self, cfg: ModelConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._pspecs = T.lm_pspecs(cfg)

    def init(self, generator: torch.Generator):
        """Random weights with the reference's init laws, drawn from
        ``generator`` on its device (make it on the model's device)."""
        return init_tree(self._pspecs, generator)

    def init_cache(self, slots: int, max_seq: int, page_tokens: int = 8,
                   n_pages: Optional[int] = None) -> PagedKVCache:
        """A paged pool where, by default, every slot can grow to
        ``max_seq`` tokens."""
        cfg = self.cfg
        pages_per_seq = -(-max_seq // page_tokens)
        return PagedKVCache(
            PagedCacheConfig(
                n_pages=n_pages or slots * pages_per_seq,
                page_tokens=page_tokens, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.resolved_head_dim,
                max_pages_per_seq=pages_per_seq),
            max_seqs=slots, n_layers=cfg.n_layers, device=self.device)

    def prefill(self, params, tokens, cache: PagedKVCache, slots):
        return D.prefill(params, self.cfg, tokens, cache, slots)

    def decode_step(self, params, cache: PagedKVCache, tokens, slots):
        return D.decode_step(params, self.cfg, cache, tokens, slots)
