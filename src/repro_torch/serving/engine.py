"""Continuous-batching serving engine over the paged KV cache.

Slot-based continuous batching as in the reference: finished slots are
recycled and newly admitted requests are prefilled into their slot
between decode steps; greedy argmax over the real vocabulary picks every
token.  Admission is the reference's conservative rule: a request is
admitted only if the free pages can hold its maximum length on top of
every admitted request's remaining growth, else it waits at the head of
the queue.

Each step decodes only the active slots.  The reference decodes all B
slots of its contiguous cache every step, which is harmless there; on a
paged pool a retired slot's stale table row may point at a page another
sequence owns, so writing its K/V would corrupt live KV.

Not ported yet: ``record_plans`` / ``plan_only`` (they need the plan IR),
the open-loop path, prefix caching and preemption.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import Model


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray              # (T,) int32
    max_new_tokens: int = 16
    submitted_s: float = 0.0
    first_token_s: Optional[float] = None
    done_s: Optional[float] = None
    output: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class EngineStats:
    decode_steps: int = 0
    prefills: int = 0
    tokens_out: int = 0
    wall_s: float = 0.0
    # False when the run hit ``max_steps`` with work still queued or
    # in flight
    drained: bool = True

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_out / max(self.wall_s, 1e-9)


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params=None, *, slots: int = 4,
                 max_seq: int = 256, eos_token: Optional[int] = None,
                 kv_page_tokens: int = 8,
                 kv_pool_pages: Optional[int] = None, device="cuda",
                 record_plans: bool = False, plan_only: bool = False):
        if record_plans or plan_only:
            raise NotImplementedError(
                "record_plans / plan_only need the plan IR, which is not "
                "ported yet")
        self.cfg = cfg
        self.model = Model(cfg, device=device)
        self.device = self.model.device
        self.params = params
        self.slots = slots
        self.max_seq = max_seq
        self.eos = eos_token
        self.cache = self.model.init_cache(slots, max_seq, kv_page_tokens,
                                           kv_pool_pages)
        self.slot_req: list[Optional[Request]] = [None] * slots
        self.queue: deque[Request] = deque()
        self.stats = EngineStats()
        self._next_tokens = np.zeros((slots,), np.int64)
        self._remaining = np.zeros((slots,), np.int32)
        self.n_finished = 0
        self.deferred_admissions = 0

    # ------------------------------------------------------------- API
    def submit(self, req: Request):
        req.submitted_s = time.perf_counter()
        self.queue.append(req)

    def preempt(self, *args, **kwargs):
        raise NotImplementedError("preemption is not ported yet")

    def _max_pages(self, req: Request) -> int:
        """Worst-case pages ``req`` can ever hold."""
        max_len = min(len(req.prompt) + req.max_new_tokens, self.max_seq)
        return -(-max_len // self.cache.cfg.page_tokens)

    def _can_admit(self, req: Request) -> bool:
        t = self.cache
        need = self._max_pages(req)
        if need > min(t.cfg.n_pages, t.cfg.max_pages_per_seq):
            raise ValueError(
                f"request uid={req.uid} needs {need} KV pages at its "
                f"max length but the pool can never hold that "
                f"(n_pages={t.cfg.n_pages}, "
                f"max_pages_per_seq={t.cfg.max_pages_per_seq})")
        growth = sum(self._max_pages(r) - int(t.held[s])
                     for s, r in enumerate(self.slot_req) if r is not None)
        return len(t._free) >= need + growth

    def _admit(self):
        for slot in range(self.slots):
            if self.slot_req[slot] is not None or not self.queue:
                continue
            if not self._can_admit(self.queue[0]):
                # the request stays queued until retirements free pages
                self.deferred_admissions += 1
                return
            req = self.queue.popleft()
            if not self.cache.alloc_seq(slot, len(req.prompt)):
                raise RuntimeError(           # _can_admit guarantees it
                    "KV pool out of pages at admission")
            tokens = torch.as_tensor(req.prompt, dtype=torch.int64,
                                     device=self.device)[None]
            logits = self.model.prefill(self.params, tokens, self.cache,
                                        [slot])
            self.stats.prefills += 1
            tok = int(torch.argmax(logits[0, :self.cfg.vocab_size]))
            req.first_token_s = time.perf_counter()
            req.output.append(tok)
            self._next_tokens[slot] = tok
            self._remaining[slot] = req.max_new_tokens - 1
            self.slot_req[slot] = req
            self.stats.tokens_out += 1

    def _retire(self, slot: int):
        req = self.slot_req[slot]
        req.done_s = time.perf_counter()
        self.slot_req[slot] = None
        self.n_finished += 1
        self.cache.free_seq(slot)

    def step(self):
        """One engine iteration: admit + one batched decode step over
        the active slots."""
        self._admit()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return False
        toks = torch.as_tensor(self._next_tokens[active],
                               device=self.device)
        logits = self.model.decode_step(self.params, self.cache, toks,
                                        active)
        self.stats.decode_steps += 1
        nxt = torch.argmax(logits[:, :self.cfg.vocab_size], dim=-1).cpu()
        for i, slot in enumerate(active):
            req = self.slot_req[slot]
            tok = int(nxt[i])
            req.output.append(tok)
            self.stats.tokens_out += 1
            self._next_tokens[slot] = tok
            self._remaining[slot] -= 1
            hit_eos = self.eos is not None and tok == self.eos
            if self._remaining[slot] <= 0 or hit_eos or \
                    int(self.cache.lens[slot]) >= self.max_seq - 1:
                self._retire(slot)
        return True

    def run_until_drained(self, max_steps: int = 10_000) -> EngineStats:
        t0 = time.perf_counter()
        steps = 0
        while (self.queue or any(r is not None for r in self.slot_req)) \
                and steps < max_steps:
            self.step()
            steps += 1
        self.stats.wall_s = time.perf_counter() - t0
        self.stats.drained = not self.queue and \
            all(r is None for r in self.slot_req)
        return self.stats
