"""Continuous-batching serving engine over the paged KV cache, over
the per-slot recurrent state of an attention-free (ssm) model, or over
both (a hybrid model).

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

``record_plans=True`` records the reference's closed-loop plan trace
(``trace``): one ``prefill_plan`` record per admission and one
multi-layer GQA ``decode_step_plan`` record per step, each tagged with
the step index and the slot -> request-uid mapping.  The plans' page ids
come from a shadow ``PageTable`` (no device pools) that follows the
batch composition, as in the reference, not from the live pool.

An ssm model (rwkv6) has no KV pool: its ``RecurrentStateCache`` holds
a fixed state per slot, so a free slot is enough to admit a request.
With ``record_plans`` it is admitted against the shadow ``PageTable``
instead, and its trace prices each step as GQA KV pages of
``n_kv_heads`` x ``head_dim``, as the reference's does.

A hybrid model (zamba2) needs both a state slot and KV pages for its
shared attention block's invocations: its cache is a paged pool that
carries the state store (``cache.state``), admission is held to that
pool as for the attention families, and retiring frees both.  Its
trace, like the reference's, prices all ``n_layers`` layers as GQA KV
pages.

A model with multi-head latent attention (deepseek-v3) keeps one latent
pool a layer; its shadow table keeps the reference's GQA geometry
(``n_kv_heads`` x ``resolved_head_dim``).  Both count tokens in pages of
``kv_page_tokens``, so admission, held to the live pool, and the trace
see the same pages.

The INT8 KV cache needs no logic here: the engine builds its cache
through ``Model.init_cache``, so an engine constructed under
``tuning_context(Tuning(kv_cache_quant=True))`` gets int8 pools, and
admission counts pages of that live pool; the ``record_plans`` shadow
table stays bf16, as the reference engine's does.

Not ported yet: ``plan_only``, the open-loop path, prefix caching and
preemption.  An audio (encoder-decoder) config is refused, as the
reference engine cannot prefill its frames: it runs through ``Model``.
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
from repro_torch.serving.kv_cache import PagedCacheConfig, PageTable


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray              # (T,) int32
    max_new_tokens: int = 16
    submitted_s: float = 0.0
    first_token_s: Optional[float] = None
    done_s: Optional[float] = None
    output: list = dataclasses.field(default_factory=list)
    # index into the engine's plan trace at submission time
    arrival_event: int = 0


@dataclasses.dataclass
class PlanRecord:
    """One record of a serving plan trace: a prompt prefill (one per
    admission) or a batched multi-layer decode step, tagged with the
    engine step index and the slot -> request-uid mapping."""
    kind: str                       # "prefill" | "decode"
    step_idx: int                   # engine decode-step counter
    slots: tuple                    # slot ids this plan covers
    uids: tuple                     # request uid per slot
    plan: object                    # core.plan.StreamPlan / TemplatedPlan
    arrival_event: int = 0          # prefill: requester's arrival index
    n_tokens: int = 0               # prefill: tokens this plan covers


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
        """``record_plans`` keeps a ``PlanRecord`` per admission and per
        decode step, template-instanced (``plan.PLAN_TEMPLATES``), with
        page ids from a shadow ``PageTable``."""
        if plan_only:
            raise NotImplementedError("plan_only is not ported yet")
        if cfg.family == "audio":
            # as in the reference, whose engine prefills token ids only
            raise NotImplementedError(
                f"{cfg.name} is an encoder-decoder over audio frames: the "
                "engine prefills token ids only; run it through "
                "Model.prefill(..., audio_frames=...) and "
                "Model.decode_step")
        self.cfg = cfg
        self.model = Model(cfg, device=device)
        self.device = self.model.device
        self.params = params
        self.slots = slots
        self.max_seq = max_seq
        self.eos = eos_token
        if cfg.family == "ssm":
            self.cache = self.model.init_cache(slots, max_seq)
        else:
            self.cache = self.model.init_cache(slots, max_seq,
                                               kv_page_tokens, kv_pool_pages)
        self.slot_req: list[Optional[Request]] = [None] * slots
        self.queue: deque[Request] = deque()
        self.stats = EngineStats()
        self._next_tokens = np.zeros((slots,), np.int64)
        self._remaining = np.zeros((slots,), np.int32)
        self.n_finished = 0
        self.deferred_admissions = 0
        self.trace: list[PlanRecord] = []
        self.n_records = 0
        self._table: Optional[PageTable] = None
        if record_plans:
            pages_per_seq = -(-max_seq // kv_page_tokens)
            self._table = PageTable(
                PagedCacheConfig(
                    n_pages=kv_pool_pages or slots * pages_per_seq,
                    page_tokens=kv_page_tokens, n_kv_heads=cfg.n_kv_heads,
                    head_dim=cfg.resolved_head_dim,
                    max_pages_per_seq=pages_per_seq),
                max_seqs=slots, templated=True)
        # the pages admission is held to: the live pool, or an ssm
        # model's shadow table (None without record_plans)
        self._pages: Optional[PageTable] = \
            self._table if cfg.family == "ssm" else self.cache

    @property
    def step_plans(self) -> list:
        """The decode plans of the recorded trace, in step order."""
        return [r.plan for r in self.trace if r.kind == "decode"]

    def _record(self, rec: PlanRecord) -> None:
        self.n_records += 1
        self.trace.append(rec)

    # ------------------------------------------------------------- API
    def submit(self, req: Request):
        req.submitted_s = time.perf_counter()
        req.arrival_event = self.n_records
        self.queue.append(req)

    def preempt(self, *args, **kwargs):
        raise NotImplementedError("preemption is not ported yet")

    def _max_pages(self, req: Request) -> int:
        """Worst-case pages ``req`` can ever hold."""
        max_len = min(len(req.prompt) + req.max_new_tokens, self.max_seq)
        return -(-max_len // self._pages.cfg.page_tokens)

    def _can_admit(self, req: Request) -> bool:
        t = self._pages
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
            if self._pages is not None and \
                    not self._can_admit(self.queue[0]):
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
            if self._table is not None:
                if not self._table.alloc_seq(slot, len(req.prompt)) or \
                        not self._table.note_tokens(
                            slot, int(self.cache.lens[slot])):
                    raise RuntimeError("shadow KV table out of pages")
                self._record(PlanRecord(
                    "prefill", self.stats.decode_steps, (slot,),
                    (req.uid,),
                    self._table.prefill_plan(
                        slot, len(req.prompt), n_q_heads=self.cfg.n_heads,
                        d_model=self.cfg.d_model, d_ff=self.cfg.d_ff,
                        n_layers=self.cfg.n_layers),
                    arrival_event=req.arrival_event,
                    n_tokens=len(req.prompt)))

    def _retire(self, slot: int):
        req = self.slot_req[slot]
        req.done_s = time.perf_counter()
        self.slot_req[slot] = None
        self.n_finished += 1
        self.cache.free_seq(slot)
        if self._table is not None:
            self._table.free_seq(slot)

    def step(self):
        """One engine iteration: admit + one batched decode step over
        the active slots."""
        self._admit()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return False
        if self._table is not None:
            # the step streams each active slot's resident KV pages; the
            # new token's KV lands before the next step
            self._record(PlanRecord(
                "decode", self.stats.decode_steps, tuple(active),
                tuple(self.slot_req[s].uid for s in active),
                self._table.decode_step_plan(
                    active, n_q_heads=self.cfg.n_heads,
                    n_layers=self.cfg.n_layers)))
        toks = torch.as_tensor(self._next_tokens[active],
                               device=self.device)
        logits = self.model.decode_step(self.params, self.cache, toks,
                                        active)
        self.stats.decode_steps += 1
        if self._table is not None:
            for slot in active:
                if not self._table.note_tokens(
                        slot, int(self.cache.lens[slot])):
                    raise RuntimeError("shadow KV table out of pages")
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
