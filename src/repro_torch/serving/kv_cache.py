"""Paged KV cache — the SMMU/page-table design applied to serving.

A global pool of fixed-size pages plus a per-sequence page table, as in
the reference.  Allocation is host-side (numpy free list); the device
sees only (pool, table, lens), which ``kernels.paged_attention``
consumes.  With KH = 2, hd = 64 and bf16, ``page_tokens = 16`` gives the
paper's 4,096-byte page.

``PageTable`` is the reference's bookkeeping (``alloc_seq``,
``free_seq``, ``ensure_capacity``, ``note_tokens``, ``validate``) and
its StreamPlan builders (``decode_step_plan``, ``prefill_plan``,
``shared_prefill_plan``), whose page ids come verbatim from the tables.
The swap and prefix-cache bookkeeping of the reference is not ported
yet.  ``PagedKVCache`` adds torch pools of shape (L, P, page, KH, hd)
on the device, one table shared by every layer.

Unlike the reference's ``PagedKVCache.append_token``, which writes for
every slot passed — active or not — the port writes only for active
slots: a retired slot's table row is stale (``free_seq`` does not clear
it) and may point at a page that another sequence now owns.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import plan as plan_ir
from repro_torch.device import resolve_device
from repro_torch.serving.state_cache import RecurrentStateCache


def _itemsize(dtype: str) -> int:
    return torch.empty((), dtype=getattr(torch, dtype)).element_size()


@dataclasses.dataclass
class PagedCacheConfig:
    n_pages: int
    page_tokens: int
    n_kv_heads: int
    head_dim: int
    max_pages_per_seq: int
    dtype: str = "bfloat16"

    @property
    def page_bytes(self) -> int:
        return self.page_tokens * self.n_kv_heads * self.head_dim * \
            _itemsize(self.dtype)


class PageTable:
    """Host-side paged-KV bookkeeping: free list, per-sequence page
    tables and lengths, and the plan builders.  Holds no device pools,
    so the serving engine can shadow its cache with one of these to
    emit a StreamPlan per step at bookkeeping cost."""

    def __init__(self, cfg: PagedCacheConfig, max_seqs: int,
                 templated: bool = False):
        self.cfg = cfg
        self.max_seqs = max_seqs
        # route the plan builders through plan.PLAN_TEMPLATES: one
        # compile per geometry, page-id relabels per step
        self.templated = templated
        self._free = list(range(cfg.n_pages - 1, -1, -1))
        self.tables = np.zeros((max_seqs, cfg.max_pages_per_seq), np.int32)
        self.lens = np.zeros((max_seqs,), np.int32)
        self.held = np.zeros((max_seqs,), np.int32)   # pages per slot
        self.active = np.zeros((max_seqs,), bool)

    # --------------------------------------------------- slot lifecycle
    def alloc_seq(self, slot: int, prompt_len: int) -> bool:
        n_pages = -(-max(prompt_len, 1) // self.cfg.page_tokens)
        if n_pages > len(self._free) or \
                n_pages > self.cfg.max_pages_per_seq:
            return False
        self.tables[slot, :] = 0
        for i in range(n_pages):
            self.tables[slot, i] = self._free.pop()
        self.lens[slot] = 0
        self.held[slot] = n_pages
        self.active[slot] = True
        return True

    def free_seq(self, slot: int):
        for i in range(int(self.held[slot])):
            self._free.append(int(self.tables[slot, i]))
        self.lens[slot] = 0
        self.held[slot] = 0
        self.active[slot] = False

    def ensure_capacity(self, slot: int, new_len: int) -> bool:
        """Grow the table if the next token crosses a page boundary.
        Pages assigned before the free list runs dry stay recorded in
        ``held`` (``free_seq`` returns them)."""
        have = int(self.held[slot])
        need = -(-new_len // self.cfg.page_tokens)
        if need > self.cfg.max_pages_per_seq:
            return False
        while have < need:
            if not self._free:
                self.held[slot] = have
                return False
            self.tables[slot, have] = self._free.pop()
            have += 1
        self.held[slot] = have
        return True

    def note_tokens(self, slot: int, new_len: int) -> bool:
        """Record that ``slot`` now caches ``new_len`` tokens, growing
        its table across page boundaries as needed."""
        if not self.ensure_capacity(slot, new_len):
            return False
        self.lens[slot] = new_len
        return True

    # ------------------------------------------------------ invariants
    def validate(self) -> None:
        """Pool-accounting check: the free list and every active slot's
        pages must partition ``range(n_pages)`` — no double frees, no
        leaks, no aliased tables.  Raises ``AssertionError`` (explicitly,
        so the check survives ``python -O``)."""
        def require(cond, msg):
            if not cond:
                raise AssertionError(msg)

        free = list(self._free)
        owned: list = []
        for s in range(self.max_seqs):
            held = int(self.held[s])
            if not self.active[s]:
                require(held == 0, f"inactive slot {s} still holds {held} "
                        "pages")
                continue
            owned += [int(p) for p in self.tables[s, :held]]
        for label, part in (("free", free), ("owned", owned)):
            require(len(part) == len(set(part)),
                    f"duplicate page ids in {label}: {sorted(part)}")
        overlap = set(free) & set(owned)
        require(not overlap, f"pages both free and owned: {sorted(overlap)}")
        pool = set(range(self.cfg.n_pages))
        union = set(free) | set(owned)
        require(union == pool, f"pool leak: {sorted(pool - union)} "
                f"unaccounted, {sorted(union - pool)} phantom")

    # ------------------------------------------------------- streaming
    def decode_step_plan(self, slots, out: str = "decode_out", *,
                         n_q_heads=None, n_layers: int = 1):
        """StreamPlan for one batched decode step over these slots:
        DMA_IN page ids taken verbatim from the page tables, so the
        plan's page traffic is the pool traffic.  ``n_q_heads`` enables
        GQA fan-out over the shared KV pages; ``n_layers`` composes the
        per-layer stack (this table stands in for every layer's)."""
        tables = [self.tables[s, :int(self.held[s])]
                  if self.active[s] else [] for s in slots]
        lens = [int(self.lens[s]) if self.active[s] else 0
                for s in slots]
        build = plan_ir.PLAN_TEMPLATES.decode_step if self.templated \
            else plan_ir.decode_step_plan
        return build(
            tables, lens, self.cfg.page_tokens, self.cfg.n_kv_heads,
            self.cfg.head_dim, _itemsize(self.cfg.dtype), out=out,
            n_q_heads=n_q_heads, n_layers=n_layers)

    def prefill_plan(self, slot: int, prompt_len=None, *, n_q_heads=None,
                     d_model=None, d_ff=None, n_layers: int = 1,
                     span=None, out: str = "prefill_out"):
        """StreamPlan for prefilling ``slot``'s prompt into the pages it
        holds (see ``plan.prefill_plan``); ``span=(t0, t1)`` prefills
        only that page-aligned token window."""
        held = int(self.held[slot])
        if prompt_len is None:
            prompt_len = int(self.lens[slot]) or held * \
                self.cfg.page_tokens
        build = plan_ir.PLAN_TEMPLATES.prefill if self.templated \
            else plan_ir.prefill_plan
        return build(
            self.tables[slot, :held], prompt_len, self.cfg.page_tokens,
            self.cfg.n_kv_heads, self.cfg.head_dim,
            _itemsize(self.cfg.dtype), n_q_heads=n_q_heads,
            d_model=d_model, d_ff=d_ff, n_layers=n_layers, span=span,
            out=out, name=f"prefill.s{slot}")

    def shared_prefill_plan(self, pages, prompt_len: int, *,
                            n_q_heads=None, d_model=None, d_ff=None,
                            n_layers: int = 1, out: str = "prefix_out"):
        """StreamPlan prefilling a shared page run (a prefix-cache
        system prompt) that belongs to no slot."""
        build = plan_ir.PLAN_TEMPLATES.prefill if self.templated \
            else plan_ir.prefill_plan
        return build(
            np.asarray(pages, np.int32), prompt_len,
            self.cfg.page_tokens, self.cfg.n_kv_heads,
            self.cfg.head_dim, _itemsize(self.cfg.dtype),
            n_q_heads=n_q_heads, d_model=d_model, d_ff=d_ff,
            n_layers=n_layers, out=out, name="prefix")

    @property
    def pages_in_use(self) -> int:
        return self.cfg.n_pages - len(self._free)


@dataclasses.dataclass
class DecodeView:
    """What one decode step hands every layer, on the device.  A
    ``read_view`` of a cache that the step does not write (an
    encoder-decoder's cross KV) has no positions and no write index."""
    positions: Optional[torch.Tensor]    # (n,) int64: new token's position
    write_index: Optional[torch.Tensor]  # (n,) int64: flat row it lands in
    table: torch.Tensor         # (n, max_pages) int32
    lens: torch.Tensor          # (n,) int32: lengths after this token


class PagedKVCache(PageTable):
    """Every layer's paged K/V pool plus one page table for up to
    ``max_seqs`` sequences.  The pools live on the card unless the
    caller passes ``device="cpu"``.

    An encoder-decoder's self-attention cache holds its cross-attention
    cache as ``cross`` (another ``PagedKVCache``, one pool layer per
    decoder layer, written once by prefill and only read by decode):
    ``free_seq`` frees a slot in both and ``validate`` checks both.

    A hybrid model's cache (one pool layer per shared-attention
    invocation) holds its Mamba2 layers' per-slot state store as
    ``state`` (a ``RecurrentStateCache``): ``alloc_seq`` claims a slot
    in both, ``free_seq`` frees both and ``validate`` checks both.

    With ``v_pool=False`` there is one pool, ``k_pages``, and
    ``v_pages`` is None: multi-head latent attention keeps one latent
    row per token (its V is the first columns of the row)."""

    def __init__(self, cfg: PagedCacheConfig, max_seqs: int,
                 n_layers: int, device="cuda", v_pool: bool = True):
        super().__init__(cfg, max_seqs)
        self.device = resolve_device(device)
        shape = (n_layers, cfg.n_pages, cfg.page_tokens, cfg.n_kv_heads,
                 cfg.head_dim)
        dt = getattr(torch, cfg.dtype)
        self.k_pages = torch.zeros(shape, dtype=dt, device=self.device)
        self.v_pages = torch.zeros(shape, dtype=dt, device=self.device) \
            if v_pool else None
        self.cross: Optional[PagedKVCache] = None
        self.state: Optional[RecurrentStateCache] = None

    def alloc_seq(self, slot: int, prompt_len: int) -> bool:
        if self.state is not None and self.state.active[slot]:
            return False
        if not super().alloc_seq(slot, prompt_len):
            return False
        if self.state is not None:
            self.state.alloc_seq(slot, prompt_len)
        return True

    def free_seq(self, slot: int):
        super().free_seq(slot)
        if self.cross is not None and self.cross.active[slot]:
            self.cross.free_seq(slot)
        if self.state is not None:
            self.state.free_seq(slot)

    def validate(self) -> None:
        super().validate()
        for sub in (self.cross, self.state):
            if sub is not None:
                sub.validate()
        if self.state is not None and not (
                np.array_equal(self.state.active, self.active)
                and np.array_equal(self.state.lens, self.lens)):
            raise AssertionError("the state store's slots and lengths "
                                 "differ from the KV table's")

    def _flat_rows(self, slot: int, start: int, stop: int) -> np.ndarray:
        pos = np.arange(start, stop)
        pt = self.cfg.page_tokens
        return self.tables[slot, pos // pt].astype(np.int64) * pt + pos % pt

    def prompt_index(self, slots, n_tokens: int) -> torch.Tensor:
        """Claim pages for ``n_tokens`` prompt tokens in each of
        ``slots`` (allocated with ``alloc_seq``) and return the flat
        pool rows they land in, (len(slots), n_tokens) on the device.
        The slots' lengths become ``n_tokens``."""
        rows = []
        for slot in slots:
            if not self.active[slot]:
                raise ValueError(f"slot {slot} is not allocated")
            if not self.note_tokens(slot, n_tokens):
                raise RuntimeError("out of KV pages")
            rows.append(self._flat_rows(slot, 0, n_tokens))
        return torch.from_numpy(np.stack(rows)).to(self.device)

    def append_view(self, slots) -> DecodeView:
        """Claim room for one more token in each of ``slots`` (all
        active) and return the step's ``DecodeView``; the slots'
        lengths grow by one."""
        slots = [int(s) for s in slots]
        for slot in slots:
            if not self.active[slot]:
                raise ValueError(f"decode of inactive slot {slot}")
        pos = self.lens[slots].astype(np.int64)
        for slot, p in zip(slots, pos):
            if not self.note_tokens(slot, int(p) + 1):
                raise RuntimeError("out of KV pages")
        widx = np.array([self._flat_rows(s, int(p), int(p) + 1)[0]
                         for s, p in zip(slots, pos)], np.int64)
        dev = self.device
        return DecodeView(
            positions=torch.from_numpy(pos).to(dev),
            write_index=torch.from_numpy(widx).to(dev),
            table=torch.from_numpy(self.tables[slots]).to(dev),
            lens=torch.from_numpy(self.lens[slots].copy()).to(dev))

    def read_view(self, slots) -> DecodeView:
        """The table rows and lengths of ``slots`` (all active) on the
        device, with nothing claimed or written: a decode step's view of
        a cache it only reads."""
        slots = [int(s) for s in slots]
        for slot in slots:
            if not self.active[slot]:
                raise ValueError(f"read of inactive slot {slot}")
        dev = self.device
        return DecodeView(
            positions=None, write_index=None,
            table=torch.from_numpy(self.tables[slots]).to(dev),
            lens=torch.from_numpy(self.lens[slots].copy()).to(dev))

    def _need_v_pool(self, what: str) -> None:
        if self.v_pages is None:
            raise ValueError(
                f"{what} needs separate K and V pools; this cache holds "
                "one latent pool (v_pool=False: k_pages holds each "
                "token's latent row, whose first columns are V)")

    def page_dicts(self, slots, layer: int = 0):
        """``({page_id: page}, {page_id: page})`` views of ``layer``'s K
        and V pools for the pages the given slots hold: the ``paged``
        input of ``core.streaming.execute_plan``."""
        self._need_v_pool("page_dicts")
        pids = sorted({int(p) for s in slots if self.active[s]
                       for p in self.tables[s, :int(self.held[s])]})
        k, v = self.k_pages[layer], self.v_pages[layer]
        return {p: k[p] for p in pids}, {p: v[p] for p in pids}

    def layer_flat(self, layer: int):
        """This layer's (k, v) pools viewed as (P·page, KH, hd) rows."""
        self._need_v_pool("layer_flat")
        k, v = self.k_pages[layer], self.v_pages[layer]
        return (k.view(-1, *k.shape[2:]), v.view(-1, *v.shape[2:]))
