"""Paged KV cache — the SMMU/page-table design applied to serving.

A global pool of fixed-size pages plus a per-sequence page table, as in
the reference.  Allocation is host-side (numpy free list); the device
sees only (pool, table, lens), which ``kernels.paged_attention``
consumes.  With KH = 2, hd = 64 and bf16, ``page_tokens = 16`` gives the
paper's 4,096-byte page.

``PageTable`` is the reference's bookkeeping (``alloc_seq``,
``free_seq``, ``ensure_capacity``, ``note_tokens``, ``validate``)
without the plan builders, which need the plan IR and come later.
``PagedKVCache`` adds torch pools of shape (L, P, page, KH, hd) on the
device, one table shared by every layer.

Unlike the reference's ``PagedKVCache.append_token``, which writes for
every slot passed — active or not — the port writes only for active
slots: a retired slot's table row is stale (``free_seq`` does not clear
it) and may point at a page that another sequence now owns.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device


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
    tables and lengths.  Holds no device pools."""

    def __init__(self, cfg: PagedCacheConfig, max_seqs: int):
        self.cfg = cfg
        self.max_seqs = max_seqs
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

    @property
    def pages_in_use(self) -> int:
        return self.cfg.n_pages - len(self._free)


@dataclasses.dataclass
class DecodeView:
    """What one decode step hands every layer, on the device."""
    positions: torch.Tensor     # (n,) int64: the new token's position
    write_index: torch.Tensor   # (n,) int64: flat pool row it lands in
    table: torch.Tensor         # (n, max_pages) int32
    lens: torch.Tensor          # (n,) int32: lengths after this token


class PagedKVCache(PageTable):
    """Every layer's paged K/V pool plus one page table for up to
    ``max_seqs`` sequences.  The pools live on the card unless the
    caller passes ``device="cpu"``."""

    def __init__(self, cfg: PagedCacheConfig, max_seqs: int,
                 n_layers: int, device="cuda"):
        super().__init__(cfg, max_seqs)
        self.device = resolve_device(device)
        shape = (n_layers, cfg.n_pages, cfg.page_tokens, cfg.n_kv_heads,
                 cfg.head_dim)
        dt = getattr(torch, cfg.dtype)
        self.k_pages = torch.zeros(shape, dtype=dt, device=self.device)
        self.v_pages = torch.zeros(shape, dtype=dt, device=self.device)

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

    def layer_flat(self, layer: int):
        """This layer's (k, v) pools viewed as (P·page, KH, hd) rows."""
        k, v = self.k_pages[layer], self.v_pages[layer]
        return (k.view(-1, *k.shape[2:]), v.view(-1, *v.shape[2:]))
