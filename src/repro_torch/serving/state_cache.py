"""Per-slot recurrent state of an attention-free (ssm) model: what a
paged KV pool is to an attention model.

An RWKV6 layer carries, per sequence, its scan state ``s`` (H, N, N)
fp32 and two token-shift vectors (d,) in the activation dtype (the last
token the time mix and the channel mix saw).  None of it grows with the
sequence, so there are no pages: the store holds a fixed row per slot
and per layer, (L, slots, ...) on the device, as the reference's cache
dict holds (L, B, ...) leaves.  No KV pool is allocated.

Bookkeeping reads as the paged cache's does: ``alloc_seq`` /
``free_seq`` mark a slot active or free, ``lens`` counts the tokens each
slot has seen, ``validate`` checks the two agree.  Prefill overwrites a
slot's whole state in every layer, so nothing of a retired request
reaches the next one.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device


class RecurrentStateCache:
    def __init__(self, cfg: ModelConfig, max_seqs: int, device="cuda",
                 dtype=torch.bfloat16):
        self.device = resolve_device(device)
        self.max_seqs = max_seqs
        L, d, H = cfg.n_layers, cfg.d_model, cfg.n_heads
        N = d // H
        self.s = torch.zeros((L, max_seqs, H, N, N), dtype=torch.float32,
                             device=self.device)
        self.shift = torch.zeros((L, max_seqs, d), dtype=dtype,
                                 device=self.device)
        self.channel_shift = torch.zeros((L, max_seqs, d), dtype=dtype,
                                         device=self.device)
        self.lens = np.zeros((max_seqs,), np.int32)
        self.active = np.zeros((max_seqs,), bool)

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.s, self.shift, self.channel_shift))

    # --------------------------------------------------- slot lifecycle
    def alloc_seq(self, slot: int, prompt_len: int) -> bool:
        """Claim a free ``slot`` for a new sequence (its state is written
        by prefill, whatever ``prompt_len``).  False if the slot is
        taken."""
        if self.active[slot]:
            return False
        self.active[slot] = True
        self.lens[slot] = 0
        return True

    def free_seq(self, slot: int):
        self.active[slot] = False
        self.lens[slot] = 0

    def validate(self) -> None:
        """Free slots hold no tokens.  Raises ``AssertionError``
        (explicitly, so the check survives ``python -O``)."""
        stale = np.flatnonzero(~self.active & (self.lens != 0))
        if len(stale):
            raise AssertionError(f"free slots {stale.tolist()} still "
                                 "count tokens")

    # ------------------------------------------------------------ steps
    def _index(self, slots) -> torch.Tensor:
        slots = [int(s) for s in slots]
        for slot in slots:
            if not self.active[slot]:
                raise ValueError(f"slot {slot} is not allocated")
        return torch.tensor(slots, dtype=torch.int64, device=self.device)

    def prompt_slots(self, slots, n_tokens: int) -> torch.Tensor:
        """The index of ``slots`` (all allocated) on the device, for a
        prefill of ``n_tokens`` tokens each; their lengths become
        ``n_tokens``."""
        idx = self._index(slots)
        self.lens[[int(s) for s in slots]] = n_tokens
        return idx

    def decode_slots(self, slots) -> torch.Tensor:
        """The index of ``slots`` (all allocated) on the device, for one
        decode step; their lengths grow by one."""
        idx = self._index(slots)
        self.lens[[int(s) for s in slots]] += 1
        return idx

    def read(self, layer: int, idx: torch.Tensor) -> dict:
        """``layer``'s state of the slots in ``idx``, gathered:
        {"time": {"s", "shift"}, "channel_shift"}."""
        return {"time": {"s": self.s[layer].index_select(0, idx),
                         "shift": self.shift[layer].index_select(0, idx)},
                "channel_shift":
                    self.channel_shift[layer].index_select(0, idx)}

    def write(self, layer: int, idx: torch.Tensor, state: dict) -> None:
        """Scatter a state tree of the slots in ``idx`` into ``layer``."""
        self.s[layer].index_copy_(0, idx, state["time"]["s"])
        self.shift[layer].index_copy_(
            0, idx, state["time"]["shift"].to(self.shift.dtype))
        self.channel_shift[layer].index_copy_(
            0, idx, state["channel_shift"].to(self.channel_shift.dtype))
