"""Request-centric serving simulation: fold one batched trace replay
back onto the recorded request timeline.

``ServingEngine(record_plans=True)`` leaves behind a plan trace — one
``prefill_plan`` per admission (one per CHUNK under chunked-prefill
admission) and one multi-layer decode plan per engine step, each
tagged ``(step_idx, slot -> uid)``.  This module prices the WHOLE
trace in one compiled replay (``accesys.pipeline.replay_trace``, or
the chunk-streamed ``replay_trace_streamed`` for open-loop scale —
shared page interning, one continuous timeline) and attributes the
per-record simulated durations to individual requests:

  * simulated TTFT — trace time at the request's prefill completion
    (the LAST prefill chunk emits the first token) minus its arrival
    time, so queueing/deferral delay is included;
  * simulated TPOT — (last decode-token time - prefill completion) /
    decoded tokens;
  * component split — per request, TTFT decomposes into queue /
    prefill / swap-stall and the decode phase into decode / swap /
    stall, with swap DMA (``swap_out``/``swap_in`` preemption
    records) and preemption counts attributed to their victim.

Edge cases are reported as CENSORED, never dropped silently or left
to skew the tails: a request still in flight when the trace ends
contributes no TPOT (its decode is truncated) and, if it never
finished prefilling, no TTFT either; prefill-only requests
(``max_new_tokens == 1``: zero decode steps) have ``tpot_s = nan``
and are counted.  ``percentiles()`` filters the nans and carries the
counts, so the p50/p95/p99 numbers a serving SLO speaks stay honest
at every load point — including past the saturation knee, where the
in-flight fraction grows.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Sequence

import numpy as np

from repro_torch.accesys.pipeline import HOST_S_PER_ELEM, replay_trace
from repro_torch.core import plan as plan_ir


@dataclasses.dataclass
class RequestSim:
    """Simulated latency of one served request, split into additive
    components: ``queue_s + prefill_s + swap_pre_s == ttft_s`` and
    (for decoded requests) ``decode_s + swap_post_s + stall_s`` spans
    first token -> last token, so end-to-end latency is exactly the
    sum of all six.  ``queue_s``/``stall_s`` are the residuals — time
    the request spent waiting on admission, deferral, or other
    requests' records; the other four are the request's own priced
    record durations."""
    uid: int
    ttft_s: float                  # arrival -> first token (nan if the
    #                                prefill never completed)
    tpot_s: float                  # per decoded token (nan if none or
    #                                censored)
    n_tokens: int                  # tokens attributed (prefill + decode)
    censored: bool = False         # still in flight at trace end
    queue_s: float = math.nan      # ttft share: waiting / others' turns
    prefill_s: float = math.nan    # ttft share: own prefill records
    swap_pre_s: float = math.nan   # ttft share: swap DMA before 1st tok
    decode_s: float = math.nan     # own decode records
    stall_s: float = math.nan      # decode-phase waiting on others
    swap_post_s: float = math.nan  # swap DMA after the first token
    e2e_s: float = math.nan        # arrival -> last attributed record
    n_preempt: int = 0             # times this request was evicted

    @property
    def swap_s(self) -> float:
        """Total swap DMA time attributed to this request."""
        return self.swap_pre_s + self.swap_post_s


class RecMeta(NamedTuple):
    """The O(1) per-record metadata request folding needs — what a
    streaming accumulator keeps when the plans themselves are not
    retained."""
    kind: str
    uids: tuple
    arrival_event: int


@dataclasses.dataclass
class ServingSimReport:
    mode: str
    total_s: float                 # simulated end-to-end trace time
    per_event_s: np.ndarray        # one duration per trace record
    requests: list                 # [RequestSim], submission order
    result: object                 # aggregate accesys GemmResult

    def percentiles(self) -> dict:
        """{ttft,tpot}_{p50,p95,p99}_us over the trace's requests,
        plus censoring counters: ``n_in_flight`` (still running or
        queued at trace end — no TPOT contribution) and
        ``n_prefill_only`` (finished with zero decode steps)."""
        ttft = np.array([r.ttft_s for r in self.requests])
        ttft = ttft[~np.isnan(ttft)]
        tpot = np.array([r.tpot_s for r in self.requests])
        tpot = tpot[~np.isnan(tpot)]
        swap = np.array([r.swap_s for r in self.requests
                         if not math.isnan(r.swap_s)])
        queue = np.array([r.queue_s for r in self.requests])
        queue = queue[~np.isnan(queue)]
        out = {"requests": len(self.requests),
               "n_in_flight": sum(r.censored for r in self.requests),
               "n_prefill_only": sum(
                   1 for r in self.requests
                   if not r.censored and r.n_tokens <= 1),
               "n_preempted": sum(r.n_preempt > 0
                                  for r in self.requests),
               "preemptions": sum(r.n_preempt for r in self.requests),
               "swap_s_total": float(sum(
                   r.swap_s for r in self.requests
                   if not math.isnan(r.swap_s)))}
        for label, arr in (("ttft", ttft), ("tpot", tpot),
                           ("swap", swap), ("queue", queue)):
            for p in (50, 95, 99):
                out[f"{label}_p{p}_us"] = float(
                    np.percentile(arr, p) * 1e6) if arr.size else \
                    math.nan
        return out


def trace_schedule(trace: Sequence) -> "plan_ir.PlanSchedule":
    """The trace as a repeat-1 ``PlanSchedule`` — build ONCE per trace
    and reuse across memory modes so the compiled form and its
    trace-intrinsic LRU analysis are shared."""
    return plan_ir.PlanSchedule("serve_trace",
                                [(r.plan, 1) for r in trace])


def fold_requests(trace: Sequence, per: np.ndarray,
                  in_flight: Sequence = ()) -> list:
    """Attribute per-record durations to requests.  ``trace`` is any
    sequence exposing ``kind / uids / arrival_event`` per record
    (``PlanRecord``s or ``RecMeta``s); ``per`` the matching replay
    durations; ``in_flight`` the uids the engine had not retired when
    the trace ended (``ServingEngine.unfinished_uids()``).

    Handles chunked prefills (a uid's arrival anchors at its FIRST
    prefill record, completion at its LAST — preemption may interleave
    ``swap_out``/``swap_in`` records between chunks), skips the shared
    prefix-cache record (``uid < 0`` — its duration stays on the
    timeline but belongs to no request), and censors in-flight
    requests: truncated decodes contribute no TPOT, and an in-flight
    request with no decode steps is conservatively treated as still
    prefilling (``ttft_s = nan``).

    Swap DMA records are attributed to their request and the latency
    split into additive components: before the first token,
    ``ttft = queue_s + prefill_s + swap_pre_s``; after it,
    ``last_tok - first_tok = decode_s + swap_post_s + stall_s``.
    ``queue_s``/``stall_s`` are residuals (time the request existed
    but its own records weren't running); both identities hold
    exactly and ``e2e_s`` is their sum."""
    cum = np.cumsum(per)
    arrival: dict = {}
    prefill_done: dict = {}
    prefill_last_i: dict = {}
    prefill_s: dict = {}
    last_tok: dict = {}
    n_decode: dict = {}
    decode_s: dict = {}
    swaps: dict = {}               # uid -> [(rec index, duration)]
    n_preempt: dict = {}
    order: list = []
    for i, rec in enumerate(trace):
        if rec.kind == "prefill":
            uid = rec.uids[0] if rec.uids else -1
            if uid < 0:          # shared prefix prefill: no request
                continue
            if uid not in arrival:
                order.append(uid)
                ae = rec.arrival_event
                arrival[uid] = float(cum[ae - 1]) if ae > 0 else 0.0
            prefill_done[uid] = float(cum[i])
            prefill_last_i[uid] = i
            prefill_s[uid] = prefill_s.get(uid, 0.0) + float(per[i])
        elif rec.kind in ("swap_out", "swap_in"):
            uid = rec.uids[0]
            # a request can be evicted before its first prefill chunk
            # ever ran? no — victims always have progress, so arrival
            # is already anchored; still, guard the fold
            if uid not in arrival:
                order.append(uid)
                ae = rec.arrival_event
                arrival[uid] = float(cum[ae - 1]) if ae > 0 else 0.0
            swaps.setdefault(uid, []).append((i, float(per[i])))
            if rec.kind == "swap_out":
                n_preempt[uid] = n_preempt.get(uid, 0) + 1
            last_tok[uid] = float(cum[i])
        else:                      # decode
            for uid in rec.uids:
                last_tok[uid] = float(cum[i])
                n_decode[uid] = n_decode.get(uid, 0) + 1
                decode_s[uid] = decode_s.get(uid, 0.0) + float(per[i])
    live = set(in_flight)
    requests = []
    for uid in order:
        nd = n_decode.get(uid, 0)
        cens = uid in live
        done = prefill_done.get(uid)
        tpot = (last_tok[uid] - done) / nd \
            if nd and not cens and done is not None else math.nan
        ttft = math.nan if done is None or (cens and nd == 0) else \
            done - arrival[uid]
        sim = RequestSim(
            uid=uid, ttft_s=ttft, tpot_s=tpot, n_tokens=1 + nd,
            censored=cens, n_preempt=n_preempt.get(uid, 0))
        if not math.isnan(ttft):
            pf_i = prefill_last_i[uid]
            sim.prefill_s = prefill_s[uid]
            sim.swap_pre_s = sum(d for i, d in swaps.get(uid, ())
                                 if i < pf_i)
            sim.queue_s = ttft - sim.prefill_s - sim.swap_pre_s
            if nd and not cens:
                sim.decode_s = decode_s[uid]
                sim.swap_post_s = sum(d for i, d in swaps.get(uid, ())
                                      if i > pf_i)
                span = last_tok[uid] - done
                sim.stall_s = span - sim.decode_s - sim.swap_post_s
                sim.e2e_s = last_tok[uid] - arrival[uid]
            elif not cens:         # prefill-only: no decode phase
                sim.decode_s = sim.swap_post_s = sim.stall_s = 0.0
                sim.e2e_s = ttft
        requests.append(sim)
    return requests


class ServingAccumulator:
    """Streaming counterpart of ``fold_requests``: tee the O(1) fold
    metadata off a record generator while the plans stream through to
    the replayer UNRETAINED, then fold the per-plan durations the
    replay returns.  Memory is O(records), never O(events) — the
    per-event timeline only ever exists one replay chunk at a time."""

    def __init__(self):
        self.meta: list = []

    def wrap(self, records):
        """Pass-through generator collecting fold metadata."""
        for rec in records:
            self.meta.append(RecMeta(rec.kind, rec.uids,
                                     rec.arrival_event))
            yield rec

    def report(self, mode: str, result, per: np.ndarray,
               in_flight: Sequence = ()) -> ServingSimReport:
        return ServingSimReport(
            mode=mode, total_s=result.total_s, per_event_s=per,
            requests=fold_requests(self.meta, per, in_flight),
            result=result)


def simulate_serving_trace(cfg, trace: Sequence, *,
                           host_s_per_elem: float = HOST_S_PER_ELEM,
                           engine: Optional[str] = None,
                           sched: Optional["plan_ir.PlanSchedule"]
                           = None,
                           in_flight: Sequence = ()
                           ) -> ServingSimReport:
    """Replay a recorded engine trace once (batched) on ``cfg`` and
    attribute simulated time to requests.  ``trace`` is
    ``ServingEngine.trace`` (a list of ``PlanRecord``)."""
    sched = sched if sched is not None else trace_schedule(trace)
    result, per = replay_trace(cfg, sched,
                               host_s_per_elem=host_s_per_elem,
                               engine=engine)
    return ServingSimReport(mode=cfg.mode, total_s=result.total_s,
                            per_event_s=per,
                            requests=fold_requests(trace, per,
                                                   in_flight),
                            result=result)
