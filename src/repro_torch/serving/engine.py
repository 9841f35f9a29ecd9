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
table stays float16, as the reference engine's does by default.

``plan_only=True`` is the reference's open-loop capacity-planning
mode: no ``Model``, no cache and no device state, only the shadow
``PageTable``, for every family.  ``open_loop_records`` /
``run_open_loop`` drive it on a seeded arrival clock
(``arrival_times``) with chunked prefill, a shared prefix
(``prefix_tokens``, interned once under ``prefix_caching``), and
preemption with KV swap to the host (``preempt=``), and yield the plan
trace that ``accesys.pipeline.replay_trace_streamed`` prices.  The
model-backed engine refuses ``prefix_tokens``: the reference's closed
loop accepts it under ``record_plans`` but never prefills or maps the
prefix.

An audio (encoder-decoder) config is refused when a model is built, as
the reference engine cannot prefill its frames: it runs through
``Model``.
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
    admission, or one per chunk under chunked prefill) or a batched
    multi-layer decode step, tagged with the engine step index and the
    slot -> request-uid mapping.  ``uids == (-1,)`` marks the shared
    prefix-cache prefill, which belongs to no request.  ``swap_out`` /
    ``swap_in`` records carry a preempted request's KV traffic to and
    from the host (``n_tokens`` = cached tokens at the swap point)."""
    kind: str             # "prefill" | "decode" | "swap_out" | "swap_in"
    step_idx: int                   # engine decode-step counter
    slots: tuple                    # slot ids this plan covers
    uids: tuple                     # request uid per slot
    plan: object                    # core.plan.StreamPlan / TemplatedPlan
    arrival_event: int = 0          # prefill: requester's arrival index
    n_tokens: int = 0               # prefill: tokens this plan covers


def arrival_times(kind: str, n: int, qps: float, seed: int = 0, *,
                  burst_factor: float = 4.0, burst_len: float = 16.0,
                  period_s: float = 60.0, depth: float = 0.8
                  ) -> np.ndarray:
    """Seeded open-loop arrival process: ``n`` absolute arrival times
    at a mean offered rate of ``qps`` requests/second, deterministic in
    ``(kind, n, qps, seed, shape params)``.

    - ``poisson``: i.i.d. exponential gaps.
    - ``bursty``: exponential gaps scaled by alternating quiet/hot runs
      of geometric length ``burst_len``: hot gaps shrink by
      ``burst_factor``, quiet gaps stretch to keep the mean rate.
    - ``diurnal``: gaps modulated by ``1 + depth*sin(2*pi*t/period_s)``,
      a load wave compressed to seconds."""
    if qps <= 0:
        raise ValueError(f"qps must be > 0, got {qps}")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / qps, size=n)
    if kind == "poisson":
        pass
    elif kind == "bursty":
        lo = 1.0 / burst_factor
        hi = 2.0 - lo                 # quiet stretch preserving mean
        scale = np.empty(n)
        i, hot = 0, False
        while i < n:
            run = int(rng.geometric(1.0 / burst_len))
            scale[i:i + run] = lo if hot else hi
            i += run
            hot = not hot
        gaps *= scale
    elif kind == "diurnal":
        t = np.cumsum(gaps)
        rate = np.maximum(
            1.0 + depth * np.sin(2.0 * np.pi * t / period_s), 1e-3)
        gaps = gaps / rate
    else:
        raise ValueError(
            f"unknown arrival process {kind!r} — expected poisson, "
            "bursty, or diurnal")
    return np.cumsum(gaps)


@dataclasses.dataclass
class EngineStats:
    decode_steps: int = 0
    prefills: int = 0
    tokens_out: int = 0
    wall_s: float = 0.0
    preemptions: int = 0
    swapped_pages: int = 0          # device pages moved host-ward
    # False when the run hit ``max_steps`` with work still queued or
    # in flight (pair with ``unfinished_uids()`` to censor a report)
    drained: bool = True

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_out / max(self.wall_s, 1e-9)


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params=None, *, slots: int = 4,
                 max_seq: int = 256, eos_token: Optional[int] = None,
                 record_plans: bool = False, kv_page_tokens: int = 8,
                 kv_pool_pages: Optional[int] = None,
                 plan_only: bool = False, prefix_tokens: int = 0,
                 prefix_caching: bool = False, templated: bool = True,
                 device="cuda"):
        """``record_plans`` keeps a ``PlanRecord`` per admission and per
        decode step, with page ids from a shadow float16 ``PageTable``;
        ``templated`` (default) instances each plan from
        a compiled skeleton (``plan.PLAN_TEMPLATES``), which prices
        bitwise like the event-built plan.

        ``plan_only=True`` builds no model, no cache and no device state
        (``params`` and ``device`` unused) and drives the shadow table
        alone: the open-loop mode, where token values never matter and
        only the plan trace does.  ``prefix_tokens`` prepends a shared
        system prompt to every request; with ``prefix_caching=True`` its
        pages are interned once (``reserve_prefix``) and every request
        maps them read-only, otherwise each request prefills them."""
        self.cfg = cfg
        self.plan_only = plan_only
        record_plans = record_plans or plan_only
        if not plan_only:
            if cfg.family == "audio":
                # as in the reference, whose engine prefills token ids
                raise NotImplementedError(
                    f"{cfg.name} is an encoder-decoder over audio frames: "
                    "the engine prefills token ids only; run it through "
                    "Model.prefill(..., audio_frames=...) and "
                    "Model.decode_step")
            if prefix_tokens:
                raise ValueError(
                    "prefix_tokens needs plan_only=True: the model-backed "
                    "engine does not prefill a shared prefix")
        self.model = None if plan_only else Model(cfg, device=device)
        self.device = None if plan_only else self.model.device
        self.params = params
        self.slots = slots
        self.max_seq = max_seq
        self.eos = eos_token
        if plan_only:
            self.cache = None
        elif cfg.family == "ssm":
            self.cache = self.model.init_cache(slots, max_seq)
        else:
            self.cache = self.model.init_cache(slots, max_seq,
                                               kv_page_tokens, kv_pool_pages)
        self.slot_req: list[Optional[Request]] = [None] * slots
        self.queue: deque[Request] = deque()
        self.stats = EngineStats()
        self._next_tokens = np.zeros((slots,), np.int64)
        self._remaining = np.zeros((slots,), np.int32)
        self._lens = np.zeros((slots,), np.int32)   # plan-only mirror
        self.trace: list[PlanRecord] = []
        self.n_records = 0          # records emitted (trace + sinks)
        self.n_finished = 0
        self.deferred_admissions = 0
        self.sim_t = 0.0            # open-loop simulated clock
        self._sink: Optional[list] = None
        self._prefilling: dict = {}  # slot -> [req, done, total]
        # ---- preemption / swap state (open-loop path)
        self._preempt_policy = "none"
        self._stall_budget_s = 0.0
        self._debug_invariants = False
        self._defer_since: Optional[float] = None  # head's wait start
        self._swapped: dict = {}    # uid -> (n_pages, tokens, remaining,
        #                             prefill_total | None)
        self._progress: dict = {}   # slot -> tokens since (re)admission
        self._admit_seq: dict = {}  # slot -> admission order counter
        self._admit_counter = 0
        self._prefix_tokens = int(prefix_tokens)
        self._prefix_pages: Optional[np.ndarray] = None
        self._prefix_recorded = False
        self._table: Optional[PageTable] = None
        if record_plans:
            pages_per_seq = -(-max_seq // kv_page_tokens)
            self._table = PageTable(
                PagedCacheConfig(
                    n_pages=kv_pool_pages or slots * pages_per_seq,
                    page_tokens=kv_page_tokens, n_kv_heads=cfg.n_kv_heads,
                    head_dim=cfg.resolved_head_dim,
                    # the reference engine's default: traces price alike
                    max_pages_per_seq=pages_per_seq, dtype="float16"),
                max_seqs=slots, templated=templated)
        if self._prefix_tokens:
            if self._prefix_tokens % kv_page_tokens:
                raise ValueError(
                    f"prefix_tokens={prefix_tokens} must be a multiple "
                    f"of kv_page_tokens={kv_page_tokens} (chunked "
                    "prefill spans are page-aligned)")
            if prefix_caching:
                self._prefix_pages = self._table.reserve_prefix(
                    self._prefix_tokens // kv_page_tokens)
        # the pages admission is held to: the live pool, or the shadow
        # table of a plan-only engine or an ssm model (None for an ssm
        # model without record_plans)
        self._pages: Optional[PageTable] = \
            self._table if plan_only or cfg.family == "ssm" else self.cache

    @property
    def step_plans(self) -> list:
        """The decode plans of the recorded trace, in step order."""
        return [r.plan for r in self.trace if r.kind == "decode"]

    def _record(self, rec: PlanRecord) -> int:
        """Append a trace record (to the streaming sink when one is
        installed) and return its global index, the ``arrival_event``
        coordinate space."""
        idx = self.n_records
        self.n_records += 1
        (self.trace if self._sink is None else self._sink).append(rec)
        return idx

    # ------------------------------------------------------------- API
    def submit(self, req: Request):
        req.submitted_s = time.perf_counter()
        req.arrival_event = self.n_records
        self.queue.append(req)

    def _max_pages(self, req: Request) -> int:
        """Worst-case pages ``req`` can ever hold, shared prefix pages
        included."""
        max_len = min(self._prefix_tokens + len(req.prompt)
                      + req.max_new_tokens, self.max_seq)
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
        if self._prefix_pages is not None:
            need -= len(self._prefix_pages)   # shared pages are mapped
        # pages admitted slots may still claim while decoding
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
        if self.plan_only:
            raise ValueError(
                "a plan_only engine has no model: drive it with "
                "open_loop_records() or run_open_loop()")
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

    # ------------------------------------------ open-loop (plan-only)
    def unfinished_uids(self) -> tuple:
        """Uids the engine has accepted but not retired — running,
        prefilling, or queued.  The censoring set for trace-end
        percentile reports."""
        live = [r.uid for r in self.slot_req if r is not None]
        live += [r.uid for r in self.queue]
        return tuple(live)

    def _pick_victim(self, exclude: Optional[int] = None
                     ) -> Optional[int]:
        """Choose a running slot to preempt, or None.  Only slots that
        have produced at least one token since (re)admission are
        eligible — preempting zero-progress work can livelock two
        large requests into evicting each other forever, while
        requiring progress guarantees every preemption cycle advances
        someone.  ``lifo``: most recently admitted (vLLM's default —
        the newest request has the least sunk cost); ``longest``: most
        own pages held (frees the most memory per eviction)."""
        cands = [s for s, r in enumerate(self.slot_req)
                 if r is not None and s != exclude
                 and self._progress.get(s, 0) > 0]
        if not cands:
            return None
        if self._preempt_policy == "lifo":
            return max(cands, key=lambda s: self._admit_seq[s])
        # "longest": frees the most device pages
        t = self._table
        return max(cands, key=lambda s: (int(t.held[s])
                                         - int(t.shared[s]),
                                         self._admit_seq[s]))

    def _preempt(self, slot: int):
        """Evict ``slot``: record the page-aligned swap-out of its
        written KV (``PageTable.swap_out`` frees the device pages),
        stash its exact progress for resume, and re-queue it directly
        BEHIND the queue head — the head's admission is the point of
        the eviction, and the victim resumes right after it."""
        req = self.slot_req[slot]
        pf = self._prefilling.pop(slot, None)
        if pf is not None:
            tokens, remaining, total = pf[1], -1, pf[2]
        else:
            tokens = int(self._lens[slot])
            remaining, total = int(self._remaining[slot]), None
        plan, n_swap = self._table.swap_out(
            slot, tokens, req.uid, n_layers=self.cfg.n_layers)
        if plan is not None:
            self._record(PlanRecord(
                "swap_out", self.stats.decode_steps, (slot,),
                (req.uid,), plan, arrival_event=req.arrival_event,
                n_tokens=tokens))
        self._swapped[req.uid] = (n_swap, tokens, remaining, total)
        self.slot_req[slot] = None
        self._lens[slot] = 0
        self._progress.pop(slot, None)
        self.stats.preemptions += 1
        self.stats.swapped_pages += n_swap
        if self.queue:
            head = self.queue.popleft()
            self.queue.appendleft(req)
            self.queue.appendleft(head)
        else:
            self.queue.appendleft(req)

    def _resume_or_start(self, slot: int, req: Request):
        """Bind ``req`` to ``slot``: allocate its device pages and
        either enter the chunked-prefill state machine (fresh request,
        or one preempted mid-prefill — it continues at the chunk
        boundary it stopped on) or rejoin the decode batch (preempted
        while decoding), recording the swap-in DMA first."""
        swap = self._swapped.pop(req.uid, None)
        full = self._prefix_tokens + len(req.prompt)
        alloc_tokens = full if swap is None else max(full, swap[1])
        if not self._table.alloc_seq(slot, alloc_tokens,
                                     prefix=self._prefix_pages):
            raise RuntimeError(       # _can_admit guarantees it
                "shadow KV table out of pages at admission")
        self.slot_req[slot] = req
        self._progress[slot] = 0
        self._admit_seq[slot] = self._admit_counter
        self._admit_counter += 1
        if swap is None:
            done = self._prefix_tokens \
                if self._prefix_pages is not None else 0
            self._prefilling[slot] = [req, done, full]
            return
        n_swap, tokens, remaining, total = swap
        if n_swap:
            self._record(PlanRecord(
                "swap_in", self.stats.decode_steps, (slot,),
                (req.uid,),
                self._table.swap_in_plan(n_swap, req.uid,
                                         n_layers=self.cfg.n_layers),
                arrival_event=req.arrival_event, n_tokens=tokens))
        if total is not None:            # was mid-prefill: continue it
            self._prefilling[slot] = [req, tokens, total]
        else:                            # was decoding: rejoin batch
            self._lens[slot] = tokens
            if not self._table.note_tokens(slot, tokens):
                raise RuntimeError(   # alloc_seq covered these pages
                    "swap-in lost pages the allocation reserved")
            self._remaining[slot] = remaining

    def _admit_open(self):
        """Open-loop admission: same conservative capacity check as
        ``_admit``, but the admitted request enters the chunked-prefill
        state machine instead of being prefilled whole — long prompts
        cost several engine steps, not one monolithic stall.

        With a preemption policy armed, a head deferred longer than
        the stall budget evicts victims (``_pick_victim``) until its
        conservative reservation fits — head-of-line blocking degrades
        into swap thrash instead of unbounded queueing."""
        for slot in range(self.slots):
            if self.slot_req[slot] is not None or not self.queue:
                continue
            if not self._can_admit(self.queue[0]):
                if self._defer_since is None:
                    self._defer_since = self.sim_t
                if self._preempt_policy != "none" and \
                        self.sim_t - self._defer_since >= \
                        self._stall_budget_s:
                    while not self._can_admit(self.queue[0]):
                        victim = self._pick_victim()
                        if victim is None:
                            break
                        self._preempt(victim)
                if not self._can_admit(self.queue[0]):
                    self.deferred_admissions += 1
                    return
            self._defer_since = None
            req = self.queue.popleft()
            self._resume_or_start(slot, req)

    def _retire_open(self, slot: int):
        req = self.slot_req[slot]
        req.done_s = self.sim_t
        self.slot_req[slot] = None
        self.n_finished += 1
        self._lens[slot] = 0
        self._progress.pop(slot, None)
        self._table.free_seq(slot)

    def _prefill_chunk_open(self, slot: int, chunk: int,
                            est_prefill_s_per_token: float) -> float:
        """Advance one slot's chunked prefill by one page-aligned span
        and record its plan; on the last chunk the slot joins the
        decode batch (its ``first token`` is the prefill's)."""
        req, done, total = self._prefilling[slot]
        end = total if total - done <= chunk else done + chunk
        self._record(PlanRecord(
            "prefill", self.stats.decode_steps, (slot,), (req.uid,),
            self._table.prefill_plan(
                slot, total, span=(done, end),
                n_q_heads=self.cfg.n_heads, d_model=self.cfg.d_model,
                d_ff=self.cfg.d_ff, n_layers=self.cfg.n_layers),
            arrival_event=req.arrival_event, n_tokens=end - done))
        self.stats.prefills += 1
        self._progress[slot] = self._progress.get(slot, 0) + end - done
        if end == total:
            del self._prefilling[slot]
            self._lens[slot] = total
            if not self._table.note_tokens(slot, total):
                raise RuntimeError("shadow KV table out of pages")
            self._remaining[slot] = req.max_new_tokens - 1
            self.stats.tokens_out += 1
            if self._remaining[slot] <= 0 or total >= self.max_seq - 1:
                self._retire_open(slot)       # prefill-only request
        else:
            self._prefilling[slot][1] = end
        return est_prefill_s_per_token * (end - done)

    def _step_open(self, chunk: int, est_step_s: float,
                   est_prefill_s_per_token: float) -> float:
        """One open-loop engine iteration: advance every in-flight
        chunked prefill by one span, then one batched decode step over
        the slots not still prefilling.  Returns the simulated time
        this step consumed (the admission clock — reported latencies
        come from the accesys replay, not from these estimates)."""
        dt = 0.0
        for slot in sorted(self._prefilling):
            dt += self._prefill_chunk_open(slot, chunk,
                                           est_prefill_s_per_token)
        active = [s for s, r in enumerate(self.slot_req)
                  if r is not None and s not in self._prefilling]
        if active:
            self._record(PlanRecord(
                "decode", self.stats.decode_steps, tuple(active),
                tuple(self.slot_req[s].uid for s in active),
                self._table.decode_step_plan(
                    active, n_q_heads=self.cfg.n_heads,
                    n_layers=self.cfg.n_layers)))
            self.stats.decode_steps += 1
            dt += est_step_s
            for slot in active:
                self._lens[slot] += 1
                self._progress[slot] = self._progress.get(slot, 0) + 1
                self.stats.tokens_out += 1
                self._remaining[slot] -= 1
                grew = self._table.note_tokens(slot,
                                               int(self._lens[slot]))
                if self._remaining[slot] <= 0 or \
                        int(self._lens[slot]) >= self.max_seq - 1:
                    self._retire_open(slot)
                elif not grew:
                    # mid-decode page growth failed — only reachable
                    # when the pool shrank under us (fault injection
                    # seizing pages breaks the conservative admission
                    # reservation).  Degrade gracefully: swap this
                    # slot out and resume it when pages return,
                    # instead of crashing the run.
                    if self._preempt_policy == "none":
                        raise RuntimeError(
                            "shadow KV table out of pages")
                    self._preempt(slot)
        return dt

    def open_loop_records(self, requests, arrival_s, *,
                          est_step_s: float = 1e-3,
                          est_prefill_s_per_token: float = 1e-4,
                          prefill_chunk_tokens: int = 64,
                          max_steps: int = 1_000_000,
                          preempt: str = "none",
                          stall_budget_s: float = 0.0,
                          faults=None,
                          debug_invariants: bool = False):
        """Generator driving an OPEN-loop run — requests arrive on the
        ``arrival_s`` clock whether or not the engine keeps up (the
        queue grows past saturation) — yielding ``PlanRecord``s as they
        are produced WITHOUT retaining them, so a 10k-request trace can
        stream straight into ``replay_trace_streamed`` in O(chunk)
        memory.  Plan-only: token values are never computed; the
        ``est_*`` rates only advance the simulated admission clock
        (calibrate them from a small priced probe trace — reported
        TTFT/TPOT always come from the replay itself).

        ``preempt`` arms graceful degradation under memory pressure:
        when the queue head has been deferred for more than
        ``stall_budget_s`` of simulated time, a running victim
        (``"lifo"``: newest admission; ``"longest"``: most pages) is
        swapped out to host (priced ``swap_out``/``swap_in`` records)
        and re-queued behind the head.  ``faults`` is an optional
        object whose ``on_step(engine, step_idx)`` is called once per
        iteration (``serving.faults`` injects pool seizures there);
        ``debug_invariants`` runs the ``serving.invariants`` validator
        every step and at drain.

        Deterministic: same requests + arrivals => identical records.
        Use ``run_open_loop`` to retain the trace instead."""
        if not self.plan_only or self._table is None:
            raise ValueError(
                "open_loop_records() needs plan_only=True (the "
                "model-backed path is closed-loop only)")
        if preempt not in ("none", "lifo", "longest"):
            raise ValueError(
                f"unknown preemption policy {preempt!r} — expected "
                "none, lifo, or longest")
        if stall_budget_s < 0:
            raise ValueError(
                f"stall_budget_s must be >= 0: {stall_budget_s}")
        self._preempt_policy = preempt
        self._stall_budget_s = float(stall_budget_s)
        self._debug_invariants = bool(debug_invariants)
        if prefill_chunk_tokens % self._table.cfg.page_tokens:
            raise ValueError(
                f"prefill_chunk_tokens={prefill_chunk_tokens} must be "
                f"page-aligned ({self._table.cfg.page_tokens} tokens)")
        reqs = list(requests)
        arr = np.asarray(arrival_s, float)
        if len(reqs) != arr.size:
            raise ValueError(
                f"{len(reqs)} requests but {arr.size} arrival times")
        buf: list = []
        self._sink = buf
        try:
            if self._prefix_pages is not None and \
                    not self._prefix_recorded:
                self._prefix_recorded = True
                self._record(PlanRecord(
                    "prefill", 0, (), (-1,),
                    self._table.shared_prefill_plan(
                        self._prefix_pages, self._prefix_tokens,
                        n_q_heads=self.cfg.n_heads,
                        d_model=self.cfg.d_model, d_ff=self.cfg.d_ff,
                        n_layers=self.cfg.n_layers),
                    n_tokens=self._prefix_tokens))
            i = 0
            steps = 0
            while i < len(reqs) or self.queue or \
                    any(r is not None for r in self.slot_req):
                if steps >= max_steps:
                    break
                busy = self.queue or \
                    any(r is not None for r in self.slot_req)
                if not busy and arr[i] > self.sim_t:
                    self.sim_t = float(arr[i])    # idle: jump ahead
                while i < len(reqs) and arr[i] <= self.sim_t:
                    req = reqs[i]
                    self.submit(req)
                    req.submitted_s = float(arr[i])
                    i += 1
                if faults is not None:
                    faults.on_step(self, steps)
                self._admit_open()
                dt = self._step_open(prefill_chunk_tokens, est_step_s,
                                     est_prefill_s_per_token)
                self.sim_t += dt
                if dt == 0.0 and self.queue and i < len(reqs) and \
                        all(r is None for r in self.slot_req):
                    # fully stalled on admission (nothing running,
                    # head deferred): open-loop time still passes —
                    # jump to the next arrival so the queue keeps
                    # growing instead of the loop spinning in place
                    self.sim_t = max(self.sim_t, float(arr[i]))
                if self._debug_invariants:
                    from repro_torch.serving import invariants
                    invariants.check_step(self)
                steps += 1
                yield from buf
                buf.clear()
            self.stats.drained = i >= len(reqs) and not self.queue \
                and all(r is None for r in self.slot_req)
            if self._debug_invariants and self.stats.drained:
                from repro_torch.serving import invariants
                invariants.check_drained(self)
        finally:
            self._sink = None

    def run_open_loop(self, requests, arrival_s, **kw) -> EngineStats:
        """Open-loop run retaining the full trace (small-n paths and
        tests; the load sweep streams ``open_loop_records`` instead)."""
        for rec in self.open_loop_records(requests, arrival_s, **kw):
            self.trace.append(rec)
        return self.stats
