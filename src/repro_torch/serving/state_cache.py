"""Per-slot recurrent state of an ssm model, and of a hybrid model's
Mamba2 layers: what a paged KV pool is to an attention model.

An RWKV6 layer carries, per sequence, its scan state ``s`` (H, N, N)
fp32 and two token-shift vectors (d,) in the activation dtype (the last
token the time mix and the channel mix saw).  A Mamba2 layer carries
its scan state ``s`` (nh, N, hd) fp32 and ``conv``, the last d_conv - 1
inputs of its causal convolution (d_conv - 1, d_in + 2N), in the
activation dtype.  None of it grows with the sequence, so there are no
pages: the store holds a fixed row per slot and per layer, (L, slots,
...) on the device, as the reference's cache dict holds (L, B, ...)
leaves.  An ssm model has no KV pool; a hybrid model's paged cache
carries its store as ``state``.

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


def state_layout(cfg: ModelConfig, dtype=torch.bfloat16) -> dict:
    """{leaf name: (per-slot shape, dtype)} of one layer's state."""
    d = cfg.d_model
    if cfg.family == "hybrid":                      # Mamba2
        s = cfg.ssm
        d_in = s.expand * d
        nh = d_in // s.head_dim
        return {"s": ((nh, s.d_state, s.head_dim), torch.float32),
                "conv": ((s.d_conv - 1, d_in + 2 * s.d_state), dtype)}
    H = cfg.n_heads
    N = d // H
    return {"s": ((H, N, N), torch.float32), "shift": ((d,), dtype),
            "channel_shift": ((d,), dtype)}


class RecurrentStateCache:
    def __init__(self, cfg: ModelConfig, max_seqs: int, device="cuda",
                 dtype=torch.bfloat16):
        self.device = resolve_device(device)
        self.max_seqs = max_seqs
        self.names = tuple(state_layout(cfg, dtype))
        for name, (shape, dt) in state_layout(cfg, dtype).items():
            setattr(self, name, torch.zeros(
                (cfg.n_layers, max_seqs) + shape, dtype=dt,
                device=self.device))
        self.lens = np.zeros((max_seqs,), np.int32)
        self.active = np.zeros((max_seqs,), bool)

    @property
    def nbytes(self) -> int:
        return sum(getattr(self, n).numel() * getattr(self, n).element_size()
                   for n in self.names)

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
        """``layer``'s state of the slots in ``idx``, gathered, as the
        layer takes it: {"time": {"s", "shift"}, "channel_shift"} for
        RWKV6, {"s", "conv"} for Mamba2."""
        st = {n: getattr(self, n)[layer].index_select(0, idx)
              for n in self.names}
        if "shift" in st:
            return {"time": {"s": st["s"], "shift": st["shift"]},
                    "channel_shift": st["channel_shift"]}
        return st

    def write(self, layer: int, idx: torch.Tensor, state: dict) -> None:
        """Scatter a state tree of the slots in ``idx`` (as ``read``
        gives it) into ``layer``."""
        if "time" in state:
            state = {**state["time"], "channel_shift": state["channel_shift"]}
        for n in self.names:
            dst = getattr(self, n)[layer]
            dst.index_copy_(0, idx, state[n].to(dst.dtype))
