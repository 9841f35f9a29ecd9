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
    loss(params, batch) -> (loss, {"ce", "aux"[, "mtp"]})  (every family)
    abstract_params() -> the parameter tree on the ``meta`` device
    param_axes() / cache_axes() -> logical axes of those trees

``input_specs(cfg, shape)`` gives ``meta``-device stand-ins of every
model input of a shape cell, ``batch_axes`` their logical axes, and
``make_concrete_batch`` a small random batch of those shapes.

The device defaults to ``"cuda"``; without a card the constructor
raises unless the caller passes ``device="cpu"``, where every kernel
wrapper runs its plain PyTorch version.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models import decoding as D
from repro_torch.models import transformer as T
from repro_torch.models.params import axes_tree, init_tree, tree_map
from repro_torch.serving.kv_cache import PagedCacheConfig, PagedKVCache
from repro_torch.serving.state_cache import RecurrentStateCache


class Model:
    def __init__(self, cfg: ModelConfig, device="cuda", remat: str = "full"):
        """``remat`` is training's recomputation policy (``"none"``,
        ``"dots"`` or ``"full"``, ``transformer._remat``)."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.remat = remat
        self._pspecs = T.lm_pspecs(cfg)

    def init(self, generator: torch.Generator):
        """Random weights with the reference's init laws, drawn from
        ``generator`` on its device (make it on the model's device),
        with the decode path's derived layouts added
        (``transformer.add_derived``)."""
        return T.add_derived(init_tree(self._pspecs, generator), self.cfg)

    def abstract_params(self):
        """The reference's parameter tree as ``meta``-device tensors of
        the leaves' shapes and dtypes: no memory, no draws (the
        reference's ``eval_shape`` of ``init``; without the decode
        path's derived layouts, ``transformer.add_derived``)."""
        return tree_map(
            lambda p: torch.empty(p.shape, device="meta", dtype=getattr(
                torch, p.dtype) if p.dtype else torch.bfloat16),
            self._pspecs)

    def param_axes(self):
        """Logical axes of every parameter leaf, per layer (the
        reference's without its leading ``"layers"``)."""
        return axes_tree(self._pspecs)

    def cache_axes(self):
        """Logical axes of ``init_cache``'s tensors
        (``decoding.cache_axes``)."""
        return D.cache_axes(self.cfg)

    def loss(self, params, batch):
        """Mean next-token cross-entropy of ``batch`` (``tokens`` or
        ``embeddings``, and ``labels``; ``-1`` ignored; an audio model
        takes the decoder's ``tokens`` and ``labels`` with (B, Te, d)
        ``audio_frames``) plus the aux loss (the MoE layers'
        load-balancing loss summed; zero for the other families), plus
        0.3 times the multi-token-prediction loss for a config with
        ``mtp`` (``transformer.mtp_loss``).
        Returns (loss, {"ce", "aux"} and "mtp" with ``mtp``), float32
        scalars.  ``params`` need not hold the decode path's derived
        copies (``transformer.DERIVED``): training reads none."""
        cfg = self.cfg
        h, aux, _ = T.forward_train(params, cfg, batch, self.remat)
        ce = T.chunked_ce_loss(params, cfg, h, batch["labels"])
        total, metrics = ce + aux, {"ce": ce, "aux": aux}
        if cfg.mtp:
            metrics["mtp"] = T.mtp_loss(params, cfg, h, batch)
            total = total + 0.3 * metrics["mtp"]
        return total, metrics

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
        no V pool.

        Under ``Tuning(kv_cache_quant=True)`` the GQA cache of the dense,
        vlm, MoE (not MLA) and audio (its self-attention) families is
        int8 with fp16 per-(token, KV head) scales, as the reference's
        ``init_cache`` makes it; the hybrid's shared pool, the latent
        pool and whisper's cross pool stay bf16."""
        cfg = self.cfg
        if cfg.family == "ssm":
            if n_pages is not None or enc_seq:
                raise ValueError(f"{cfg.name} has no KV pool")
            return RecurrentStateCache(cfg, slots, device=self.device)
        if (cfg.family == "audio") != (enc_seq > 0):
            raise ValueError(f"{cfg.name}: enc_seq is the encoder length "
                             "of an audio model, and only of one")
        cache = self._paged(slots, max_seq, page_tokens, n_pages,
                            "int8" if D.quantized_cache(cfg) else "bfloat16")
        if enc_seq:
            cache.cross = self._paged(slots, enc_seq, page_tokens, None)
        if cfg.family == "hybrid":
            cache.state = RecurrentStateCache(cfg, slots, device=self.device)
        return cache

    def _paged(self, slots, max_seq, page_tokens, n_pages,
               dtype: str = "bfloat16") -> PagedKVCache:
        cfg = self.cfg
        pages_per_seq = -(-max_seq // page_tokens)
        kv_heads, head_dim = T.kv_geometry(cfg)
        return PagedKVCache(
            PagedCacheConfig(
                n_pages=n_pages or slots * pages_per_seq,
                page_tokens=page_tokens, n_kv_heads=kv_heads,
                head_dim=head_dim, max_pages_per_seq=pages_per_seq,
                dtype=dtype),
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


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """``meta``-device stand-ins for every model input of the (arch x
    shape) cell, the reference's ``input_specs``: no memory."""
    B, S = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16

    def sds(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind == "train":
        if cfg.family == "audio":
            return {"audio_frames": sds((B, S, cfg.d_model), bf16),
                    "tokens": sds((B, S), i32), "labels": sds((B, S), i32)}
        if cfg.embedding_inputs:
            return {"embeddings": sds((B, S, cfg.d_model), bf16),
                    "labels": sds((B, S), i32)}
        return {"tokens": sds((B, S), i32), "labels": sds((B, S), i32)}
    if shape.kind == "prefill":
        if cfg.family == "audio":
            return {"audio_frames": sds((B, S, cfg.d_model), bf16),
                    "tokens": sds((B, max(S // 8, 16)), i32)}
        if cfg.embedding_inputs:
            return {"embeddings": sds((B, S, cfg.d_model), bf16)}
        return {"tokens": sds((B, S), i32)}
    return {"tokens": sds((B,), i32)}


def batch_axes(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Logical axes of each ``input_specs`` input, the reference's."""
    if shape.kind == "train":
        if cfg.family == "audio":
            return {"audio_frames": ("batch", "seq", "embed_act"),
                    "tokens": ("batch", "seq"), "labels": ("batch", "seq")}
        if cfg.embedding_inputs:
            return {"embeddings": ("batch", "seq", "embed_act"),
                    "labels": ("batch", "seq")}
        return {"tokens": ("batch", "seq"), "labels": ("batch", "seq")}
    if shape.kind == "prefill":
        if cfg.family == "audio":
            return {"audio_frames": ("batch", "seq", "embed_act"),
                    "tokens": ("batch", "seq")}
        if cfg.embedding_inputs:
            return {"embeddings": ("batch", "seq", "embed_act")}
        return {"tokens": ("batch", "seq")}
    return {"tokens": ("batch",)}


def make_concrete_batch(cfg: ModelConfig, shape: ShapeConfig,
                        generator: Optional[torch.Generator] = None,
                        batch: Optional[int] = None,
                        seq: Optional[int] = None, device="cuda") -> dict:
    """A random batch of ``input_specs``' shapes on ``device``: token ids
    uniform in [0, vocab_size), embeddings N(0, 1) x 0.02 in bf16, drawn
    from ``generator`` (on ``device``; default seed 0).  torch's draws,
    not the reference's."""
    dev = resolve_device(device)
    g = generator if generator is not None else \
        torch.Generator(device=dev).manual_seed(0)
    specs = input_specs(cfg, ShapeConfig(shape.name, shape.kind,
                                         seq or shape.seq_len,
                                         batch or shape.global_batch))
    out = {}
    for k, v in specs.items():
        if v.dtype.is_floating_point:
            out[k] = (torch.randn(v.shape, generator=g, device=dev)
                      * 0.02).to(v.dtype)
        else:
            out[k] = torch.randint(0, cfg.vocab_size, v.shape, generator=g,
                                   device=dev, dtype=v.dtype)
    return out
