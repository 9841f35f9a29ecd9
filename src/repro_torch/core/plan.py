"""StreamPlan — the event-graph IR of the paper's streaming (Figs. 2/6).

One typed event graph of ``DMA_IN`` / ``COMPUTE`` / ``DMA_OUT`` events —
carrying page ids, byte counts, dependency edges and double-buffer lane
assignments — is the single source of truth for the paper's Algorithm-1
loop nest.  ``core.streaming.execute_plan`` is its functional executor:
it runs the plan tile by tile through a mode-aware ``PageStore`` (DM /
DC / DevMem) and returns numerical results plus metered traffic.  The
reference package also replays the same events in a timing simulator
(``accesys``), which the port does not have yet; the compiled
(array) form below is what that replayer reads, and it is kept here so
that a recorded trace compiles to the reference's arrays bit for bit.

This module is numpy, like the reference's, and follows it line for
line: every builder here gives the reference builder's events and
compiled arrays exactly.

Builders cover the paper's GEMM (Algorithm 1), paged attention
(QK^T -> softmax -> PV streaming over KV pages), full transformer
layers / N-layer models composed from per-op plans, expert-routed MoE
FFN layers (``moe_layer_plan`` — per-expert page sets sized by router
capacity), scan-structured SSM layers (``ssm_layer_plan`` — chunked
linear attention with a state-carry dependency chain), batched decode
steps over a paged KV cache (``decode_step_plan`` — DMA_IN page ids
taken verbatim from a live page table; GQA q-head fan-out and
multi-layer composition), prompt prefills over the same pool pages
(``prefill_plan``) and KV swaps (``swap_plan``).

``PlanSchedule`` is the steady-state-sampled view of a long composed
plan: a list of (steady-window sub-plan, repeat count) segments.
"""
from __future__ import annotations

import collections
import dataclasses
import enum
import functools
from typing import Iterator, Mapping, Optional, Sequence

import numpy as np

from repro_torch.core import paging
from repro_torch.models.moe import routed_capacity

# accesys dtype names <-> element sizes; tile geometry depends only on
# the element size, so each size maps onto one canonical numpy dtype.
ELEM_BYTES = {"int8": 1, "int16": 2, "int32": 4,
              "fp8": 1, "fp16": 2, "fp32": 4}
_NP_FOR_ELEM = {1: "int8", 2: "float16", 4: "float32"}


def _require(cond, msg) -> None:
    """The reference's ``assert`` checks, kept under ``python -O``."""
    if not cond:
        raise AssertionError(msg)


def np_dtype_for(dtype) -> str:
    """Canonical numpy dtype name for an accesys or numpy dtype."""
    if isinstance(dtype, str) and dtype in ELEM_BYTES:
        return _NP_FOR_ELEM[ELEM_BYTES[dtype]]
    return _NP_FOR_ELEM[paging.dtype_bytes(dtype)]


def elem_bytes_for(dtype) -> int:
    if isinstance(dtype, str) and dtype in ELEM_BYTES:
        return ELEM_BYTES[dtype]
    return paging.dtype_bytes(dtype)


class EventKind(enum.Enum):
    DMA_IN = "DMA_IN"
    COMPUTE = "COMPUTE"
    DMA_OUT = "DMA_OUT"
    COLLECTIVE = "COLLECTIVE"      # inter-device exchange hop (multidev)


@dataclasses.dataclass(frozen=True)
class Event:
    """One node of the stream graph.

    ``page`` is a ``(tensor_name, page_id)`` key — the same key the
    PageStore, SMMU TLB and LLC see, so functional and timing runs touch
    identical page streams.  ``lane`` is the DMA-channel / double-buffer
    lane (A-operand lane 0, B-operand lane 1; ``meta["buf"]`` carries the
    ping-pong buffer index).  ``deps`` are eids that must complete first
    (data edges; resource serialization is the replayer's job).
    """
    eid: int
    kind: EventKind
    nbytes: int = 0
    page: Optional[tuple] = None
    deps: tuple = ()
    lane: int = 0
    op: str = ""
    unit: str = "sa"              # COMPUTE: "sa" (accelerator) | "host"
    meta: Mapping = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class TensorSpec:
    rows: int
    cols: int
    roles: set                     # subset of {"A", "B", "C", "P"}
    kind: str = "input"            # input | weight | intermediate | output
    # role "P" (paged): pre-paged pool tensor (e.g. a KV-cache pool);
    # ``pages`` is the number of distinct pool pages the plan touches.
    pages: Optional[int] = None


@dataclasses.dataclass
class StreamPlan:
    """A topologically-ordered event list plus its tensor registry."""
    name: str
    dtype: str                     # canonical numpy dtype name
    page_bytes: int
    events: list
    tensors: dict                  # name -> TensorSpec
    macs: int = 0
    n_calls: int = 0               # offloaded launches (doorbell+IRQ each)
    total_steps: int = 0           # inner steps the plan logically covers
    sampled_steps: int = 0         # steps materialized (== total unless sampled)
    exact_events: int = 0          # events the unsampled plan would hold
                                   # (0 -> len(events); see n_exact_events)

    @property
    def n_exact_events(self) -> int:
        return self.exact_events or len(self.events)

    # ------------------------------------------------------------ info
    @property
    def footprint_pages(self) -> int:
        """Pages the SMMU can see: per tensor, one page set per role
        (a tensor produced as C tiles and re-consumed as an A operand
        occupies both page namespaces, exactly as the replayer keys them).
        Computed once per instance — plans are immutable after
        ``validate()``, and every replay re-reads this.
        """
        cached = self.__dict__.get("_footprint_pages")
        if cached is None:
            cached = 0
            for spec in self.tensors.values():
                for role in spec.roles:
                    cached += self._role_pages(spec, role)
            self.__dict__["_footprint_pages"] = cached
        return cached

    def _role_pages(self, spec: TensorSpec, role: str) -> int:
        if role == "P":
            return spec.pages or 0
        if role == "C":
            w = paging.SA_DIM
            return (-(-spec.rows // w)) * (-(-spec.cols // w))
        lay = paging.layout_for((spec.rows, spec.cols), self.dtype, role,
                                self.page_bytes)
        return lay.n_pages

    def counts(self) -> dict:
        """Event statistics (page loads per tensor, computes, stores)."""
        loads: dict = {}
        stores: dict = {}
        sa = host = coll = coll_bytes = 0
        for ev in self.events:
            if ev.kind is EventKind.DMA_IN:
                loads[ev.page[0]] = loads.get(ev.page[0], 0) + 1
            elif ev.kind is EventKind.DMA_OUT:
                stores[ev.page[0]] = stores.get(ev.page[0], 0) + 1
            elif ev.kind is EventKind.COLLECTIVE:
                coll += 1
                coll_bytes += ev.nbytes
            elif ev.unit == "sa":
                sa += 1
            else:
                host += 1
        out = {"dma_in": loads, "dma_out": stores,
               "sa_computes": sa, "host_computes": host,
               "n_events": len(self.events)}
        if coll:
            out["collectives"] = coll
            out["collective_bytes"] = coll_bytes
        return out

    def validate(self) -> None:
        """Events must be topologically ordered with in-plan deps."""
        seen: set = set()
        for ev in self.events:
            _require(ev.eid not in seen, f"duplicate eid {ev.eid}")
            for d in ev.deps:
                _require(d in seen, f"event {ev.eid} depends on unseen {d}")
            seen.add(ev.eid)

    def compile(self) -> "CompiledPlan":
        """Array-form view of this plan for the compiled replayer —
        built once per plan instance and cached on it (the memoized
        plan builders make that cache effective across benchmark
        sweeps)."""
        c = self.__dict__.get("_compiled")
        if c is None:
            c = _compile_events([self.events])
            self.__dict__["_compiled"] = c
        return c


# ------------------------------------------------- compiled (array) form
OP_SA, OP_HOST, OP_OUT, OP_TAIL, OP_COLL = 1, 2, 3, 4, 5


@dataclasses.dataclass
class CompiledPlan:
    """Structure-of-arrays form of a replayable event stream.

    Event kinds, DMA lanes, byte counts, SA depths and host element
    counts become flat NumPy arrays; page keys are interned to dense
    int ids so the SMMU/LLC models can price the whole access trace in
    one vectorized stack-distance pass.  The replay timeline collapses
    to a sequence of *ops* — SA computes, host computes, DMA-outs and
    end-of-stream drains — each owning the contiguous run of DMA-in
    events it consumes (``grp_end``), which is exactly the
    double-buffer grouping the event-loop replayer discovers
    dynamically.  ``seg_op`` / ``seg_trace`` mark sub-stream boundaries
    so a ``PlanSchedule``'s segments can be replayed on one continuous
    timeline with per-segment deltas read off afterwards.  ``memo``
    caches trace-intrinsic LRU results (stack distances do not depend
    on any cache parameter), so one compile serves every mode and
    system config.
    """
    n_events: int
    page_keys: list               # interned page id -> event .page key
    trace_ids: np.ndarray         # int32 per DMA access, event order
    trace_nbytes: np.ndarray      # float64 per DMA access
    trace_is_out: np.ndarray      # bool per DMA access (DMA_OUT)
    in_lane: np.ndarray           # int16 per DMA_IN (trace subsequence)
    op_kind: np.ndarray           # int8 per op (OP_*)
    op_val: np.ndarray            # float64: SA depth | host elems | 0
    grp_end: np.ndarray           # int64 per op: DMA_INs consumed so far
    n_lanes: np.ndarray           # int16 per op: distinct pending lanes
    seg_op: np.ndarray            # int64 cumulative op count per stream
    seg_trace: np.ndarray         # int64 cumulative DMA count per stream
    memo: dict = dataclasses.field(default_factory=dict)

    @property
    def n_ops(self) -> int:
        return int(self.op_kind.size)

    def relabel(self, page_map: dict) -> "CompiledPlan":
        """Cheap page-id relabel: a new ``CompiledPlan`` for the same
        event structure under renamed page keys (``page_map`` maps old
        key -> new key, identity for unmapped keys).  Every
        page-id-independent array (byte counts, lanes, op kinds,
        drain-group boundaries, segment marks) and every
        page-id-independent ``memo`` entry is shared BY REFERENCE;
        only the interned-id column is re-derived — and when the
        relabel is injective (the usual case: distinct physical pages)
        even ``trace_ids`` is shared, making an instance O(pages
        touched), not O(events).  Keys that collapse (e.g. shared
        prefix pages mapped into several slots) re-intern in
        first-access order, exactly as compiling the relabeled events
        would."""
        keys = [page_map.get(key, key) for key in self.page_keys]
        intern: dict = {}
        out_keys: list = []
        ids = _reintern_skeleton(self, keys, intern, out_keys)
        return dataclasses.replace(
            self, page_keys=out_keys, trace_ids=ids,
            memo=_geometry_memo(self.memo))


def _compile_events(streams: Sequence[list], intern: dict = None,
                    page_keys: list = None) -> CompiledPlan:
    """Lower one or more event lists (a plan, or a schedule's segment
    plans back-to-back) into a ``CompiledPlan``.  Pending DMA_INs
    attach to the next COMPUTE regardless of interleaved DMA_OUTs, and
    each stream ends with an ``OP_TAIL`` barrier that drains trailing
    fetches — the same grouping ``_replay_events`` applies event by
    event.  Passing a shared ``intern``/``page_keys`` pair threads one
    page-id namespace through successive calls, so a long trace can be
    compiled chunk by chunk while cross-chunk page reuse stays visible
    to the LRU analyses."""
    if intern is None:
        intern = {}
    if page_keys is None:
        page_keys = []
    t_ids: list = []
    t_nb: list = []
    t_out: list = []
    in_lane: list = []
    opk: list = []
    opv: list = []
    gend: list = []
    nl: list = []
    seg_op: list = []
    seg_trace: list = []
    n_events = 0
    consumed = 0
    for events in streams:
        n_events += len(events)
        glanes: set = set()
        for ev in events:
            k = ev.kind
            if k is EventKind.DMA_IN:
                pid = intern.get(ev.page)
                if pid is None:
                    pid = intern[ev.page] = len(page_keys)
                    page_keys.append(ev.page)
                t_ids.append(pid)
                t_nb.append(ev.nbytes)
                t_out.append(False)
                in_lane.append(ev.lane)
                glanes.add(ev.lane)
            elif k is EventKind.COMPUTE:
                if ev.unit == "sa":
                    opk.append(OP_SA)
                    opv.append(float(ev.meta["depth"]))
                else:
                    opk.append(OP_HOST)
                    opv.append(float(ev.meta["elems"]))
                nl.append(len(glanes))
                glanes = set()
                consumed = len(in_lane)
                gend.append(consumed)
            elif k is EventKind.COLLECTIVE:
                # one inter-device exchange hop: no page traffic on the
                # host<->device path (the fabric owns dedicated links),
                # just a fabric-priced barrier op on the timeline —
                # pending fetches of the NEXT op keep prefetching
                # underneath it, exactly like a DMA_OUT drain
                opk.append(OP_COLL)
                opv.append(float(ev.nbytes))
                gend.append(consumed)
                nl.append(0)
            else:                                  # DMA_OUT
                pid = intern.get(ev.page)
                if pid is None:
                    pid = intern[ev.page] = len(page_keys)
                    page_keys.append(ev.page)
                t_ids.append(pid)
                t_nb.append(ev.nbytes)
                t_out.append(True)
                opk.append(OP_OUT)
                opv.append(0.0)
                gend.append(consumed)
                nl.append(0)
        # every stream ends with a drain barrier, pending fetches or
        # not: an empty tail is numerically inert (nothing pending, and
        # its ready value is already folded into t_sa), but it pins a
        # segment boundary at every plan end, which is what lets a
        # chunked compile+replay of the same streams stay bitwise equal
        # to the monolithic one
        opk.append(OP_TAIL)
        opv.append(0.0)
        nl.append(len(glanes))
        consumed = len(in_lane)
        gend.append(consumed)
        seg_op.append(len(opk))
        seg_trace.append(len(t_ids))
    return CompiledPlan(
        n_events=n_events, page_keys=page_keys,
        trace_ids=np.asarray(t_ids, np.int32),
        trace_nbytes=np.asarray(t_nb, np.float64),
        trace_is_out=np.asarray(t_out, bool),
        in_lane=np.asarray(in_lane, np.int16),
        op_kind=np.asarray(opk, np.int8),
        op_val=np.asarray(opv, np.float64),
        grp_end=np.asarray(gend, np.int64),
        n_lanes=np.asarray(nl, np.int16),
        seg_op=np.asarray(seg_op, np.int64),
        seg_trace=np.asarray(seg_trace, np.int64))


# --------------------------------------------------- plan templating
# ``CompiledPlan.memo`` entries derived ONLY from event structure (op
# kinds, DMA lanes, drain-group and segment boundaries) — safe to share
# by reference between a template skeleton and every relabeled
# instance.  Everything else ("prev"/"sd" stack distances, "mru"
# orders, ("l2", te) subset analyses, ...) is derived from the interned
# page-id column and must be recomputed per instance.
_GEOMETRY_MEMO_KEYS = ("gs", "npend", "hasp", "inout_pos", "lanes",
                       "lane_masks", "lane_pack", "out_ops", "segb")


def _geometry_memo(memo: dict) -> dict:
    return {k: memo[k] for k in _GEOMETRY_MEMO_KEYS if k in memo}


def _reintern_skeleton(sk: "CompiledPlan", keys: list, intern: dict,
                       page_keys: list) -> np.ndarray:
    """Re-derive a skeleton's interned-id column under relabeled page
    keys (``keys`` index-aligned with ``sk.page_keys``), interning into
    the caller's namespace — the shared chunk namespace during trace
    assembly, or a fresh one for a standalone instance compile.
    Returns the global ``trace_ids`` column; when the namespace started
    empty and no keys collapse, the skeleton's own column is shared by
    reference (the relabel is then pure bookkeeping)."""
    base = len(page_keys)
    l2g = np.empty(len(keys), np.int32)
    for i, key in enumerate(keys):
        pid = intern.get(key)
        if pid is None:
            pid = intern[key] = len(page_keys)
            page_keys.append(key)
        l2g[i] = pid
    if base == 0 and len(page_keys) == len(keys):
        return sk.trace_ids            # identity relabel: 0..n-1 again
    return l2g[sk.trace_ids]


def _plan_n_events(p) -> int:
    n = getattr(p, "n_events", None)
    return len(p.events) if n is None else int(n)


def _compiled_part(p, intern: dict, page_keys: list) -> tuple:
    """One plan's compiled columns with globally interned page ids —
    spliced from the template skeleton when the plan is a
    ``TemplatedPlan`` (no event graph is materialized), compiled from
    the event list otherwise."""
    sk = getattr(p, "skeleton", None)
    if sk is not None:
        ids = _reintern_skeleton(sk, p.inst_keys, intern, page_keys)
        return (ids, sk.trace_nbytes, sk.trace_is_out, sk.in_lane,
                sk.op_kind, sk.op_val, sk.grp_end, sk.n_lanes,
                sk.seg_op, sk.seg_trace, sk.n_events)
    c = _compile_events([p.events], intern, page_keys)
    return (c.trace_ids, c.trace_nbytes, c.trace_is_out, c.in_lane,
            c.op_kind, c.op_val, c.grp_end, c.n_lanes, c.seg_op,
            c.seg_trace, c.n_events)


def _concat_parts(parts: list, page_keys: list) -> CompiledPlan:
    """Concatenate per-plan compiled columns (page ids already global)
    into one ``CompiledPlan`` — ``grp_end`` shifts by the DMA_INs of
    the preceding plans, ``seg_op``/``seg_trace`` by their op/access
    counts, reproducing ``_compile_events`` over the same plans' event
    lists bit for bit (every value is the same int/float in the same
    position; only the walk that produced it differs)."""
    t_ids: list = []
    t_nb: list = []
    t_out: list = []
    lanes: list = []
    opk: list = []
    opv: list = []
    gend: list = []
    nl: list = []
    sop: list = []
    strc: list = []
    in_off = op_off = tr_off = 0
    n_events = 0
    for (ids, nb, out, lane, kind, val, ge, nlanes, so, st, nev) \
            in parts:
        t_ids.append(ids)
        t_nb.append(nb)
        t_out.append(out)
        lanes.append(lane)
        opk.append(kind)
        opv.append(val)
        gend.append(ge + in_off if in_off else ge)
        nl.append(nlanes)
        sop.append(so + op_off if op_off else so)
        strc.append(st + tr_off if tr_off else st)
        in_off += lane.size
        op_off += kind.size
        tr_off += ids.size
        n_events += nev
    cat = (lambda xs: xs[0]) if len(parts) == 1 else np.concatenate
    return CompiledPlan(
        n_events=n_events, page_keys=page_keys,
        trace_ids=cat(t_ids), trace_nbytes=cat(t_nb),
        trace_is_out=cat(t_out), in_lane=cat(lanes),
        op_kind=cat(opk), op_val=cat(opv), grp_end=cat(gend),
        n_lanes=cat(nl), seg_op=cat(sop), seg_trace=cat(strc))


def _compile_plans(plans: Sequence, intern: dict = None,
                   page_keys: list = None) -> CompiledPlan:
    """Compile a batch of plans into one ``CompiledPlan``, splicing
    templated instances from their skeletons and walking raw plans'
    events — bitwise-identical to ``_compile_events`` over everyone's
    event lists."""
    if intern is None:
        intern = {}
        page_keys = []
    if not any(getattr(p, "skeleton", None) is not None for p in plans):
        return _compile_events([p.events for p in plans], intern,
                               page_keys)
    return _concat_parts([_compiled_part(p, intern, page_keys)
                          for p in plans], page_keys)


def trace_footprint(plans) -> int:
    """Distinct page keys a sequence of plans touches — the global
    address-space footprint the SMMU walk model needs before a chunked
    replay can price its first chunk.  Accepts any iterable of
    ``StreamPlan``s or ``TemplatedPlan``s (a generator is consumed);
    templated instances contribute their relabeled key slots directly,
    without materializing events."""
    seen: set = set()
    for p in plans:
        keys = getattr(p, "inst_keys", None)
        if keys is not None:
            seen.update(keys)
            continue
        for ev in p.events:
            if ev.kind is not EventKind.COMPUTE and ev.page is not None:
                seen.add(ev.page)
    return len(seen)


def compile_trace_chunks(plans, chunk_events: int = 262_144):
    """Compile a (possibly unbounded) sequence of plans into bounded
    ``CompiledPlan`` chunks, splitting only at plan boundaries.

    Yields ``(compiled_chunk, plan_batch)`` pairs.  All chunks share
    ONE page-id namespace (the same ``intern``/``page_keys`` objects
    thread through every compile), so cross-chunk and cross-request
    page reuse — the prefix-caching / KV-pool-recycling signal —
    survives chunking; only the compiled arrays themselves are
    chunk-sized.  ``plans`` may be a generator: at most one chunk of
    plans is held at a time.  ``TemplatedPlan`` instances are spliced
    from their compiled skeletons (an array concatenation plus a
    per-unique-page re-intern), so a fully templated trace compiles in
    O(unique structure) instead of O(events)."""
    if chunk_events < 1:
        raise ValueError(f"chunk_events must be >= 1: {chunk_events}")
    intern: dict = {}
    page_keys: list = []
    batch: list = []
    n = 0
    for p in plans:
        batch.append(p)
        n += _plan_n_events(p)
        if n >= chunk_events:
            yield _compile_plans(batch, intern, page_keys), batch
            batch, n = [], 0
    if batch:
        yield _compile_plans(batch, intern, page_keys), batch


class TemplatedPlan:
    """A template instance: one geometry's compiled skeleton plus this
    step's page-key relabel — the ``(template_key, page_map)`` record
    the serving engine emits instead of a fresh event graph.

    Duck-types ``StreamPlan`` for every replay-path consumer (name /
    dtype / page_bytes / macs / n_calls / step counters), while
    ``compile_trace_chunks`` / ``trace_footprint`` /
    ``PlanSchedule.compile`` splice the skeleton arrays directly.
    Anything that genuinely needs the event graph (the functional
    executor, the event-engine parity path, event-level invariants)
    still works: ``.events`` lazily re-runs the original builder with
    this instance's real page ids and caches the result, so the
    materialized plan is exactly what the non-templated path would
    have recorded."""

    total_steps = 0
    sampled_steps = 0
    exact_events = 0

    __slots__ = ("skeleton", "inst_keys", "name", "dtype", "page_bytes",
                 "macs", "n_calls", "_build", "_plan", "_compiled")

    def __init__(self, skeleton: CompiledPlan, inst_keys: list, *,
                 name: str, dtype: str, page_bytes: int, macs: int,
                 n_calls: int, build):
        self.skeleton = skeleton
        self.inst_keys = inst_keys    # relabeled skeleton.page_keys
        self.name = name
        self.dtype = dtype
        self.page_bytes = page_bytes
        self.macs = macs
        self.n_calls = n_calls
        self._build = build
        self._plan = None
        self._compiled = None

    @property
    def n_events(self) -> int:
        return self.skeleton.n_events

    @property
    def n_exact_events(self) -> int:
        return self.skeleton.n_events

    def materialize(self) -> StreamPlan:
        """The full event-graph ``StreamPlan`` this instance stands
        for (the builder re-run with the real page ids) — cached."""
        p = self._plan
        if p is None:
            p = self._plan = self._build()
        return p

    @property
    def events(self) -> list:
        return self.materialize().events

    @property
    def tensors(self) -> dict:
        return self.materialize().tensors

    @property
    def footprint_pages(self) -> int:
        return self.materialize().footprint_pages

    def counts(self) -> dict:
        return self.materialize().counts()

    def validate(self) -> None:
        pass                  # structure was validated at template time

    def compile(self) -> CompiledPlan:
        """Standalone compiled form: the skeleton re-interned under
        this instance's keys (collapsing duplicates in first-access
        order), sharing every geometry array and page-id-independent
        memo entry with the skeleton — identical arrays to compiling
        the freshly built plan."""
        c = self._compiled
        if c is None:
            intern: dict = {}
            page_keys: list = []
            ids = _reintern_skeleton(self.skeleton, self.inst_keys,
                                     intern, page_keys)
            c = dataclasses.replace(
                self.skeleton, page_keys=page_keys, trace_ids=ids,
                memo=_geometry_memo(self.skeleton.memo))
            self._compiled = c
        return c


class PlanTemplate:
    """Compile-once, instance-many plan templating (the tentpole of
    O(unique structure) trace construction).

    A serving trace is thousands of structurally identical plans:
    every decode step at a given page-table composition, every prefill
    at a given (prompt, span) shape, every swap of n pages — only the
    pool page ids (and the swap tag) differ step to step.  A template
    builds and compiles the plan ONCE per geometry, with canonical
    page ids ``0..n-1``, then hands out ``TemplatedPlan`` instances
    whose construction cost is one dict lookup plus an O(pages
    touched) key relabel.  Slot-bearing names and per-request uids
    never enter the geometry key (they don't change the compiled
    arrays); score/output scratch keys relabel to themselves, exactly
    as the raw builders reuse them across steps."""

    def __init__(self, maxsize: int = 512):
        self._cache: collections.OrderedDict = collections.OrderedDict()
        self._maxsize = maxsize
        self.hits = 0
        self.misses = 0

    def clear(self) -> None:
        self._cache.clear()
        self.hits = self.misses = 0

    def _skeleton(self, key, build):
        ent = self._cache.get(key)
        if ent is None:
            self.misses += 1
            plan = build()
            ent = (plan.compile(), plan)
            self._cache[key] = ent
            if len(self._cache) > self._maxsize:
                self._cache.popitem(last=False)
        else:
            self.hits += 1
            self._cache.move_to_end(key)
        return ent

    @staticmethod
    def _pool_relabel(sk: CompiledPlan, pools, idmap: dict) -> list:
        """Relabel the skeleton's key slots: canonical pool-page ids
        map through ``idmap`` inside the named pool namespaces; every
        other key (score/output scratch, weight and activation pages)
        is shared across instances on purpose."""
        keys = []
        for key in sk.page_keys:
            t, p = key
            a = idmap.get(p) if t in pools else None
            keys.append(key if a is None else (t, a))
        return keys

    # ------------------------------------------------------- builders
    def decode_step(self, page_tables, lens, page_tokens: int,
                    n_kv_heads: int, head_dim: int, elem: int, *,
                    n_q_heads: Optional[int] = None, n_layers: int = 1,
                    out: str = "decode_out",
                    name: str = "decode_step") -> TemplatedPlan:
        tables = [tuple(int(p) for p in t) for t in page_tables]
        lens = [int(ln) for ln in lens]
        npgs = tuple(len(t) for t in tables)
        HQ = n_kv_heads if n_q_heads is None else n_q_heads
        key = ("decode", npgs, page_tokens, n_kv_heads, head_dim, elem,
               HQ, n_layers, out)
        canon: list = []
        c = 0
        for npg in npgs:
            canon.append(tuple(range(c, c + npg)))
            c += npg
        sk, skp = self._skeleton(key, lambda: decode_step_plan(
            canon, [npg * page_tokens for npg in npgs], page_tokens,
            n_kv_heads, head_dim, elem, n_q_heads=n_q_heads,
            n_layers=n_layers, out=out, name=name))
        idmap: dict = {}
        for ct, at in zip(canon, tables):
            for cp_, ap in zip(ct, at):
                idmap[cp_] = ap
        pools = set()
        for i in range(n_layers):
            P = f"L{i}." if n_layers > 1 else ""
            pools.update((P + "k", P + "v"))
        build = lambda: decode_step_plan(
            tables, lens, page_tokens, n_kv_heads, head_dim, elem,
            n_q_heads=n_q_heads, n_layers=n_layers, out=out, name=name)
        return TemplatedPlan(
            sk, self._pool_relabel(sk, pools, idmap), name=name,
            dtype=skp.dtype, page_bytes=skp.page_bytes, macs=skp.macs,
            n_calls=skp.n_calls, build=build)

    def prefill(self, page_table, prompt_len: int, page_tokens: int,
                n_kv_heads: int, head_dim: int, elem: int, *,
                n_q_heads: Optional[int] = None,
                d_model: Optional[int] = None,
                d_ff: Optional[int] = None, n_layers: int = 1,
                span: Optional[tuple] = None,
                out: str = "prefill_out",
                name: str = "prefill") -> TemplatedPlan:
        T = int(prompt_len)
        npg = -(-T // page_tokens)
        tbl = tuple(int(p) for p in page_table)[:npg]
        if len(tbl) != npg:
            raise ValueError(
                f"page_table holds {len(page_table)} pages but a "
                f"{T}-token prompt needs {npg}")
        sp = None if span is None else (int(span[0]), int(span[1]))
        HQ = n_kv_heads if n_q_heads is None else n_q_heads
        key = ("prefill", T, sp, page_tokens, n_kv_heads, head_dim,
               elem, HQ, d_model, d_ff, n_layers, out)
        sk, skp = self._skeleton(key, lambda: prefill_plan(
            tuple(range(npg)), T, page_tokens, n_kv_heads, head_dim,
            elem, n_q_heads=n_q_heads, d_model=d_model, d_ff=d_ff,
            n_layers=n_layers, span=sp, out=out, name=name))
        idmap = dict(zip(range(npg), tbl))
        pools = set()
        for i in range(n_layers):
            P = f"L{i}." if n_layers > 1 else ""
            pools.update((P + "k", P + "v"))
        build = lambda: prefill_plan(
            tbl, T, page_tokens, n_kv_heads, head_dim, elem,
            n_q_heads=n_q_heads, d_model=d_model, d_ff=d_ff,
            n_layers=n_layers, span=sp, out=out, name=name)
        s0, s1 = (0, T) if sp is None else sp
        tag = "" if sp is None else f".{s0}-{s1}"
        return TemplatedPlan(
            sk, self._pool_relabel(sk, pools, idmap),
            name=f"{name}{T}t{n_layers}l{tag}", dtype=skp.dtype,
            page_bytes=skp.page_bytes, macs=skp.macs,
            n_calls=skp.n_calls, build=build)

    def swap(self, n_pages: int, page_tokens: int, n_kv_heads: int,
             head_dim: int, elem: int, *, direction: str, tag,
             n_layers: int = 1) -> TemplatedPlan:
        key = ("swap", n_pages, direction, n_layers, page_tokens,
               n_kv_heads, head_dim, elem)
        sk, skp = self._skeleton(key, lambda: swap_plan(
            n_pages, page_tokens, n_kv_heads, head_dim, elem,
            direction=direction, tag=0, n_layers=n_layers))
        # every skeleton key is (ns, (0, j)) — retag the host region
        inst_keys = [(t, (tag, p[1])) for t, p in sk.page_keys]
        build = lambda: swap_plan(
            n_pages, page_tokens, n_kv_heads, head_dim, elem,
            direction=direction, tag=tag, n_layers=n_layers)
        return TemplatedPlan(
            sk, inst_keys, name=f"swap_{direction}.u{tag}",
            dtype=skp.dtype, page_bytes=skp.page_bytes, macs=skp.macs,
            n_calls=skp.n_calls, build=build)


# Process-global template store: geometry keys are fully qualified
# (page/head/layer shapes, element size, span, output name), so one
# cache safely serves every engine in the process; spawned sweep
# workers start with an empty store and grow their own entries.
PLAN_TEMPLATES = PlanTemplate()


# --------------------------------------------------------------- compose
def concat(plans: Sequence[StreamPlan], name: str = "composed",
           barrier: bool = True) -> StreamPlan:
    """Sequential composition: renumber eids, merge tensor registries,
    and (with ``barrier``) add a dependency edge from each sub-plan's
    last event to the next sub-plan's first — activations produced by
    op N feed op N+1."""
    if not plans:
        raise ValueError("concat() needs at least one sub-plan")
    events: list = []
    tensors: dict = {}
    macs = n_calls = total = sampled = exact = 0
    offset = 0
    prev_last: Optional[int] = None
    dtype = plans[0].dtype
    page_bytes = plans[0].page_bytes
    for p in plans:
        _require(p.dtype == dtype and p.page_bytes == page_bytes,
                 (p.name, p.dtype, p.page_bytes))
        for name_, spec in p.tensors.items():
            if name_ in tensors:
                t = tensors[name_]
                _require((t.rows, t.cols) == (spec.rows, spec.cols),
                         f"tensor {name_} redeclared with a different shape")
                t.roles |= spec.roles
                if spec.kind != "input":
                    t.kind = spec.kind
                if spec.pages:
                    t.pages = max(t.pages or 0, spec.pages)
            else:
                tensors[name_] = TensorSpec(spec.rows, spec.cols,
                                            set(spec.roles), spec.kind,
                                            spec.pages)
        for idx, ev in enumerate(p.events):
            deps = tuple(d + offset for d in ev.deps)
            if barrier and idx == 0 and prev_last is not None:
                deps = (prev_last,) + deps
            events.append(dataclasses.replace(
                ev, eid=ev.eid + offset, deps=deps))
        if p.events:
            prev_last = events[-1].eid
            offset = events[-1].eid + 1
        macs += p.macs
        n_calls += p.n_calls
        total += p.total_steps
        sampled += p.sampled_steps
        exact += p.n_exact_events
    return StreamPlan(name, dtype, page_bytes, events, tensors,
                      macs=macs, n_calls=n_calls,
                      total_steps=total, sampled_steps=sampled,
                      exact_events=exact)


# ----------------------------------------------------- sampled schedules
@dataclasses.dataclass
class PlanSchedule:
    """Steady-state-sampled view of a composed plan.

    ``segments`` is an ordered list of ``(StreamPlan, repeat)`` pairs:
    each sub-plan is a steady window replayed once and scaled by its
    repeat count (N identical transformer layers -> one layer's
    sub-plans, each repeated N times).  The replayer walks segments
    sequentially against shared SMMU/LLC state, so within-window page
    reuse is timed exactly while the cross-repeat steady state is
    assumed — the approximation that keeps a BERT-Base replay at tens of
    thousands of events instead of hundreds of thousands.
    """
    name: str
    segments: list                 # [(StreamPlan, int repeat)]

    @property
    def macs(self) -> int:
        return sum(p.macs * r for p, r in self.segments)

    @property
    def n_calls(self) -> int:
        return sum(p.n_calls * r for p, r in self.segments)

    @property
    def footprint_pages(self) -> int:
        """SMMU-visible pages of the FULL (unsampled) workload: every
        repeat owns its own tensors (layer i's weights are distinct
        pages from layer j's), so windows count once per repeat.
        Cached per instance (schedules are immutable after
        ``validate()``, like the plans they hold)."""
        cached = self.__dict__.get("_footprint_pages")
        if cached is None:
            cached = sum(p.footprint_pages * r for p, r in self.segments)
            self.__dict__["_footprint_pages"] = cached
        return cached

    @property
    def sampled_events(self) -> int:
        return sum(len(p.events) for p, _ in self.segments)

    @property
    def exact_events(self) -> int:
        return sum(p.n_exact_events * r for p, r in self.segments)

    def validate(self) -> None:
        for p, r in self.segments:
            _require(r >= 1, (p.name, r))
            p.validate()

    def compile(self) -> "CompiledPlan":
        """One compiled stream over the schedule's segments back to
        back (page interning shared, segment boundaries recorded), so
        the compiled replayer can walk a whole sampling pass on one
        continuous timeline — cached on the schedule instance.
        Templated segments splice their skeletons (no event graphs)."""
        c = self.__dict__.get("_compiled")
        if c is None:
            c = _compile_plans([p for p, _ in self.segments])
            self.__dict__["_compiled"] = c
        return c


# ------------------------------------------------------------- Algorithm 1
@dataclasses.dataclass(frozen=True)
class TileStep:
    """One inner-loop step of Algorithm 1 (i, j output tile; k depth)."""
    i: int
    j: int
    k: int
    a_page: int
    b_page: int
    first_k: bool
    last_k: bool
    depth: int                     # effective K depth (last page may be partial)


def gemm_tile_steps(M: int, N: int, K: int, dtype,
                    page_bytes: int = paging.PAGE_BYTES,
                    order: str = "jik") -> Iterator[TileStep]:
    """The paper's loop nest — THE single source of the loop order.
    Default ``jik`` keeps the current B column (K/L pages) hot in the LLC
    across the i-sweep (§3.3 'blocking improves cache utilization');
    ``ijk`` is the naive un-co-designed baseline."""
    la = paging.layout_for((M, K), np_dtype_for(dtype), "A", page_bytes)
    lb = paging.layout_for((K, N), np_dtype_for(dtype), "B", page_bytes)
    W, L = la.tile_r, la.tile_c
    ni, nj, kk = -(-M // W), -(-N // W), -(-K // L)
    outer, inner = (range(nj), range(ni)) if order == "jik" \
        else (range(ni), range(nj))
    for o in outer:
        for p in inner:
            i, j = (p, o) if order == "jik" else (o, p)
            for k in range(kk):
                yield TileStep(
                    i, j, k,
                    a_page=la.page_of(i * W, k * L),
                    b_page=lb.page_of(k * L, j * W),
                    first_k=(k == 0), last_k=(k == kk - 1),
                    depth=min(L, K - k * L))


def gemm_plan(M: int, N: int, K: int, dtype, *,
              a: str = "a", b: str = "b", c: str = "c",
              order: str = "jik",
              page_bytes: int = paging.PAGE_BYTES,
              sample_stride: int = 1,
              a_kind: str = "input", b_kind: str = "input",
              c_kind: str = "output",
              name: Optional[str] = None) -> StreamPlan:
    """Algorithm-1 GEMM as an event graph: per inner step, DMA-in one A
    page (lane 0) and one B page (lane 1), one W×W×depth compute
    depending on both (and on the previous k step of the same output
    tile — the output-stationary accumulator chain), and after the last
    k a DMA-out of the W×W C tile.

    ``sample_stride > 1`` materializes only every stride-th steady-state
    step (first/last k always kept) for very large problems; the
    replayer scales by ``total_steps / sampled_steps``.
    """
    np_dt = np_dtype_for(dtype)
    elem = paging.dtype_bytes(np_dt)
    la = paging.layout_for((M, K), np_dt, "A", page_bytes)
    W = la.tile_r
    kk = -(-K // la.tile_c)
    events: list = []
    eid = 0
    chain = -1                     # previous compute eid of this (i, j)
    sampled = 0
    for st in gemm_tile_steps(M, N, K, np_dt, page_bytes, order):
        if sample_stride > 1 and ((st.i + st.j) * kk + st.k) \
                % sample_stride and not st.last_k and not st.first_k:
            continue
        sampled += 1
        ea = Event(eid, EventKind.DMA_IN, nbytes=page_bytes,
                   page=(a, st.a_page), lane=0, op="load",
                   meta={"buf": st.k & 1})
        eb = Event(eid + 1, EventKind.DMA_IN, nbytes=page_bytes,
                   page=(b, st.b_page), lane=1, op="load",
                   meta={"buf": st.k & 1})
        deps = (ea.eid, eb.eid) if st.first_k \
            else (ea.eid, eb.eid, chain)
        ec = Event(eid + 2, EventKind.COMPUTE, deps=deps, op="gemm",
                   unit="sa",
                   meta={"i": st.i, "j": st.j, "k": st.k,
                         "depth": st.depth, "first_k": st.first_k,
                         "last_k": st.last_k, "w": W,
                         "a": a, "b": b, "c": c,
                         "a_page": st.a_page, "b_page": st.b_page})
        events += [ea, eb, ec]
        chain = ec.eid
        eid += 3
        if st.last_k:
            events.append(Event(eid, EventKind.DMA_OUT,
                                nbytes=W * W * elem,
                                page=(c, (st.i, st.j)),
                                deps=(ec.eid,), op="store"))
            eid += 1
    ni, nj = -(-M // W), -(-N // W)
    tensors = {a: TensorSpec(M, K, {"A"}, a_kind),
               b: TensorSpec(K, N, {"B"}, b_kind),
               c: TensorSpec(M, N, {"C"}, c_kind)}
    return StreamPlan(name or f"gemm{M}x{N}x{K}", np_dt, page_bytes,
                      events, tensors, macs=M * N * K, n_calls=1,
                      total_steps=ni * nj * kk, sampled_steps=sampled,
                      exact_events=ni * nj * (3 * kk + 1))


# ------------------------------------------------------ memoized builders
@functools.lru_cache(maxsize=64)
def gemm_tile_steps_cached(M: int, N: int, K: int, dtype,
                           page_bytes: int = paging.PAGE_BYTES,
                           order: str = "jik") -> tuple:
    """Materialized ``gemm_tile_steps`` — benchmark sweeps walk the
    same loop nests row after row."""
    return tuple(gemm_tile_steps(M, N, K, dtype, page_bytes, order))


@functools.lru_cache(maxsize=256)
def gemm_plan_cached(M: int, N: int, K: int, dtype, *,
                     page_bytes: int = paging.PAGE_BYTES,
                     sample_stride: int = 1,
                     order: str = "jik") -> StreamPlan:
    """Memoized Algorithm-1 plan with canonical tensor names.  Sweeps
    (``bench_gemm_size``, ``bench_interconnect``, TLB/packet/memory
    sweeps, calibration) re-request identical geometries per mode and
    per link config; the cached plan also carries its compiled form
    and its LRU trace analysis across those calls.  Callers must not
    mutate the returned plan."""
    return gemm_plan(M, N, K, dtype, order=order, page_bytes=page_bytes,
                     sample_stride=sample_stride)


# ------------------------------------------------------------- host ops
def host_plan(op: str, inputs: Sequence[str], output: Optional[str],
              out_shape: Optional[tuple], elems: int, dtype,
              page_bytes: int = paging.PAGE_BYTES,
              meta: Optional[dict] = None,
              out_kind: str = "intermediate",
              outs: Optional[Sequence[tuple]] = None) -> StreamPlan:
    """A single host-side COMPUTE event (softmax / layernorm / gelu /
    slice / concat / add / transpose — the paper keeps these on the CPU,
    §4.2).  ``elems`` sizes the replayer's host-time model.

    ``outs`` (a sequence of ``(name, (rows, cols))`` pairs) declares a
    multi-output op — e.g. MoE dispatch producing one routed buffer per
    expert, or an SSM scan chunk producing (chunk output, carry state);
    the executor stores every named result."""
    m = {"inputs": tuple(inputs), "out": output, "elems": elems}
    if outs is not None:
        m["outs"] = tuple(n for n, _ in outs)
    m.update(meta or {})
    ev = Event(0, EventKind.COMPUTE, op=op, unit="host", meta=m)
    tensors = {}
    if output is not None and out_shape is not None:
        tensors[output] = TensorSpec(out_shape[0], out_shape[1], set(),
                                     out_kind)
    for name_, shape in (outs or ()):
        tensors[name_] = TensorSpec(shape[0], shape[1], set(), out_kind)
    return StreamPlan(f"host.{op}", np_dtype_for(dtype), page_bytes,
                      [ev], tensors)


# ---------------------------------------------------------- collectives
def collective_plan(op: str, hop_bytes: Sequence[int], dtype,
                    page_bytes: int = paging.PAGE_BYTES, *,
                    lane: int = 0, meta: Optional[dict] = None,
                    name: Optional[str] = None) -> StreamPlan:
    """One rank's share of an inter-device collective as a chain of
    per-hop COLLECTIVE events (ring all-gather: p-1 hops of B/p bytes
    each; all-to-all over a full crossbar: p-1 peer transfers; ...).
    The TOPOLOGY decides the hop decomposition at plan-build time —
    ``core.multidev`` owns those builders — so the replayer prices each
    hop as one transfer on the rank's dedicated fabric link, with no
    page traffic on the host<->device path.  ``lane`` tags the fabric
    link the hops ride (rank-tagged collective lanes)."""
    events = [Event(i, EventKind.COLLECTIVE, nbytes=int(nb),
                    deps=(i - 1,) if i else (), lane=lane, op=op,
                    unit="link", meta={"hop": i, **(meta or {})})
              for i, nb in enumerate(hop_bytes)]
    return StreamPlan(name or f"coll.{op}", np_dtype_for(dtype),
                      page_bytes, events, {})


# ----------------------------------------------------------- attention
def _attention_plans(S: int, d_head: int, dtype, *,
                     q: str = "q", kT: str = "kT", v: str = "v",
                     out: str = "attn", prefix: str = "",
                     page_bytes: int = paging.PAGE_BYTES,
                     sample_stride: int = 1) -> list:
    """The three attention sub-plans, kept separate so schedules can
    stride the GEMMs without the stride scale bleeding into the host
    softmax's time."""
    scores, p = prefix + "scores", prefix + "p"
    return [
        gemm_plan(S, S, d_head, dtype, a=q, b=kT, c=scores,
                  c_kind="intermediate", page_bytes=page_bytes,
                  sample_stride=sample_stride),
        host_plan("softmax", (scores,), p, (S, S), S * S, dtype,
                  page_bytes),
        gemm_plan(S, d_head, S, dtype, a=p, b=v, c=out,
                  c_kind="intermediate", page_bytes=page_bytes,
                  sample_stride=sample_stride),
    ]


def attention_plan(S: int, d_head: int, dtype, *,
                   q: str = "q", kT: str = "kT", v: str = "v",
                   out: str = "attn", prefix: str = "",
                   page_bytes: int = paging.PAGE_BYTES,
                   sample_stride: int = 1) -> StreamPlan:
    """Paged attention for one head: QK^T streamed over K pages, host
    softmax, then PV streamed over V pages (paper §4.2: MHA GEMMs on the
    accelerator, softmax on the host)."""
    return concat(_attention_plans(S, d_head, dtype, q=q, kT=kT, v=v,
                                   out=out, prefix=prefix,
                                   page_bytes=page_bytes,
                                   sample_stride=sample_stride),
                  name=f"attention{S}x{d_head}")


# ----------------------------------------------- transformer layer / model
def _transformer_layer_plans(S: int, d_model: int, n_heads: int,
                             d_ff: int, dtype, *, x: str = "x",
                             layer: int = 0, out: Optional[str] = None,
                             page_bytes: int = paging.PAGE_BYTES,
                             sample_stride: int = 1) -> list:
    """The ordered sub-plans of one encoder layer — shared by the exact
    composed plan (``transformer_layer_plan``) and the steady-state
    schedule (``model_schedule``, which keeps the sub-plans as separate
    segments so strided GEMM sampling scales independently of the
    unsampled host ops)."""
    P = f"L{layer}."
    hd = d_model // n_heads
    dt = dtype
    ss = sample_stride
    plans = [gemm_plan(S, 3 * d_model, d_model, dt, a=x, b=P + "wqkv",
                       c=P + "qkv", b_kind="weight", sample_stride=ss,
                       c_kind="intermediate", page_bytes=page_bytes)]
    head_outs = []
    for h in range(n_heads):
        qh, kh, vh = P + f"q{h}", P + f"kT{h}", P + f"v{h}"
        oh = P + f"o{h}"
        plans += [
            host_plan("slice_cols", (P + "qkv",), qh, (S, hd), S * hd, dt,
                      page_bytes, {"start": h * hd, "stop": (h + 1) * hd}),
            host_plan("slice_cols", (P + "qkv",), kh, (hd, S), S * hd, dt,
                      page_bytes, {"start": d_model + h * hd,
                                   "stop": d_model + (h + 1) * hd,
                                   "transpose": True}),
            host_plan("slice_cols", (P + "qkv",), vh, (S, hd), S * hd, dt,
                      page_bytes, {"start": 2 * d_model + h * hd,
                                   "stop": 2 * d_model + (h + 1) * hd}),
        ] + _attention_plans(S, hd, dt, q=qh, kT=kh, v=vh, out=oh,
                             prefix=P + f"h{h}.", page_bytes=page_bytes,
                             sample_stride=ss)
        head_outs.append(oh)
    out = out or P + "out"
    plans += [
        host_plan("concat_cols", tuple(head_outs), P + "attn",
                  (S, d_model), S * d_model, dt, page_bytes),
        gemm_plan(S, d_model, d_model, dt, a=P + "attn", b=P + "wo",
                  c=P + "proj", b_kind="weight", c_kind="intermediate",
                  page_bytes=page_bytes, sample_stride=ss),
        host_plan("add", (x, P + "proj"), P + "res1", (S, d_model),
                  S * d_model, dt, page_bytes),
        host_plan("layernorm", (P + "res1",), P + "ln1", (S, d_model),
                  2 * S * d_model, dt, page_bytes),
        gemm_plan(S, d_ff, d_model, dt, a=P + "ln1", b=P + "w1",
                  c=P + "ff1", b_kind="weight", c_kind="intermediate",
                  page_bytes=page_bytes, sample_stride=ss),
        host_plan("gelu", (P + "ff1",), P + "g", (S, d_ff), S * d_ff, dt,
                  page_bytes),
        gemm_plan(S, d_model, d_ff, dt, a=P + "g", b=P + "w2",
                  c=P + "ff2", b_kind="weight", c_kind="intermediate",
                  page_bytes=page_bytes, sample_stride=ss),
        host_plan("add", (P + "ln1", P + "ff2"), P + "res2", (S, d_model),
                  S * d_model, dt, page_bytes),
        host_plan("layernorm", (P + "res2",), out, (S, d_model),
                  2 * S * d_model, dt, page_bytes,
                  out_kind="output"),
    ]
    return plans


def transformer_layer_plan(S: int, d_model: int, n_heads: int, d_ff: int,
                           dtype, *, x: str = "x", layer: int = 0,
                           out: Optional[str] = None,
                           page_bytes: int = paging.PAGE_BYTES,
                           sample_stride: int = 1) -> StreamPlan:
    """One post-LN encoder layer (BERT/ViT-class) as a composed plan:
    QKV projection -> per-head paged attention -> output projection ->
    residual+LN -> FFN (FF1, gelu, FF2) -> residual+LN.  GEMMs stream
    through the accelerator; everything else is host work."""
    plans = _transformer_layer_plans(
        S, d_model, n_heads, d_ff, dtype, x=x, layer=layer, out=out,
        page_bytes=page_bytes, sample_stride=sample_stride)
    return concat(plans, name=f"layer{layer}")


def model_plan(S: int, d_model: int, n_heads: int, d_ff: int,
               n_layers: int, dtype, *, x: str = "x",
               page_bytes: int = paging.PAGE_BYTES) -> StreamPlan:
    """N stacked encoder layers; layer i's output tensor feeds layer
    i+1.  This is the plan the reference's timing replayer prices end
    to end."""
    plans = []
    inp = x
    for i in range(n_layers):
        plans.append(transformer_layer_plan(
            S, d_model, n_heads, d_ff, dtype, x=inp, layer=i,
            page_bytes=page_bytes))
        inp = f"L{i}.out"
    return concat(plans, name=f"transformer{n_layers}x{d_model}")


def model_schedule(S: int, d_model: int, n_heads: int, d_ff: int,
                   n_layers: int, dtype, *, x: str = "x",
                   page_bytes: int = paging.PAGE_BYTES,
                   sample_stride: int = 1) -> PlanSchedule:
    """Steady-state-sampled counterpart of ``model_plan``: the layer
    stack is homogeneous, so one layer is the steady window — each of
    its sub-plans becomes a segment repeated ``n_layers`` times.  With
    ``sample_stride > 1`` the GEMM segments are additionally
    steady-state sampled inside the window; host-op segments are never
    strided, so their time scales only by the repeat count."""
    plans = _transformer_layer_plans(
        S, d_model, n_heads, d_ff, dtype, x=x, layer=0,
        page_bytes=page_bytes, sample_stride=sample_stride)
    return PlanSchedule(f"transformer{n_layers}x{d_model}~sampled",
                        [(p, n_layers) for p in plans])


def layer_weights(d_model: int, d_ff: int, layer: int = 0) -> dict:
    """Shapes of the weight tensors one layer plan expects — handy for
    building executor inputs."""
    P = f"L{layer}."
    return {P + "wqkv": (d_model, 3 * d_model),
            P + "wo": (d_model, d_model),
            P + "w1": (d_model, d_ff),
            P + "w2": (d_ff, d_model)}


# ------------------------------------------------------------- MoE layer
def _moe_layer_plans(n_tokens: int, d_model: int, n_experts: int,
                     top_k: int, d_ff: int, dtype, *,
                     capacity: Optional[int] = None,
                     capacity_factor: float = 1.25,
                     act: str = "silu", x: str = "x", layer: int = 0,
                     out: Optional[str] = None,
                     page_bytes: int = paging.PAGE_BYTES,
                     sample_stride: int = 1) -> list:
    P = f"M{layer}."
    C = routed_capacity(n_tokens * top_k, n_experts, capacity,
                        capacity_factor)
    dt = dtype
    ss = sample_stride
    logits = P + "logits"
    plans = [
        gemm_plan(n_tokens, n_experts, d_model, dt, a=x,
                  b=P + "router", c=logits, b_kind="weight",
                  c_kind="intermediate", page_bytes=page_bytes,
                  sample_stride=ss),
        host_plan("moe_dispatch", (x, logits), None, None,
                  n_experts * C * d_model, dt, page_bytes,
                  meta={"E": n_experts, "k": top_k, "C": C},
                  outs=[(P + f"e{e}.buf", (C, d_model))
                        for e in range(n_experts)]),
    ]
    for e in range(n_experts):
        E = P + f"e{e}."
        plans += [
            gemm_plan(C, d_ff, d_model, dt, a=E + "buf", b=E + "wg",
                      c=E + "g", b_kind="weight", c_kind="intermediate",
                      page_bytes=page_bytes, sample_stride=ss),
            gemm_plan(C, d_ff, d_model, dt, a=E + "buf", b=E + "wu",
                      c=E + "u", b_kind="weight", c_kind="intermediate",
                      page_bytes=page_bytes, sample_stride=ss),
            host_plan("act_mul", (E + "g", E + "u"), E + "h",
                      (C, d_ff), 2 * C * d_ff, dt, page_bytes,
                      meta={"act": act}),
            gemm_plan(C, d_model, d_ff, dt, a=E + "h", b=E + "wo",
                      c=E + "y", b_kind="weight", c_kind="intermediate",
                      page_bytes=page_bytes, sample_stride=ss),
        ]
    out = out or P + "out"
    plans.append(host_plan(
        "moe_combine",
        (logits,) + tuple(P + f"e{e}.y" for e in range(n_experts)),
        out, (n_tokens, d_model), n_tokens * top_k * d_model, dt,
        page_bytes, meta={"E": n_experts, "k": top_k, "C": C},
        out_kind="output"))
    return plans


def moe_layer_plan(n_tokens: int, d_model: int, n_experts: int,
                   top_k: int, d_ff: int, dtype, *,
                   capacity: Optional[int] = None,
                   capacity_factor: float = 1.25,
                   act: str = "silu", x: str = "x", layer: int = 0,
                   out: Optional[str] = None,
                   page_bytes: int = paging.PAGE_BYTES) -> StreamPlan:
    """Expert-routed FFN layer mirroring ``models/moe.py`` grouped-GEMM
    dispatch: router GEMM on the accelerator, host-side top-k sort /
    capacity-C dispatch into per-expert buffers, then per expert the
    gated-FFN GEMM triple (wi_gate, wi_up, wo) over its fixed-capacity
    buffer, and a host combine weighted by the routing probs.

    Every expert streams exactly its capacity-C page set (the routed
    buffers are page-aligned fixed-shape blocks, the activation-side
    analogue of the paper's tiles), so the plan's per-expert page
    traffic is statically known — sum of expert page sets == pages of
    the E x C routed token block.  For strided steady-state sampling
    use ``moe_schedule``: a single strided plan would scale its
    unsampled host ops by the GEMM stride."""
    plans = _moe_layer_plans(n_tokens, d_model, n_experts, top_k, d_ff,
                             dtype, capacity=capacity,
                             capacity_factor=capacity_factor, act=act,
                             x=x, layer=layer, out=out,
                             page_bytes=page_bytes)
    C = routed_capacity(n_tokens * top_k, n_experts, capacity,
                        capacity_factor)
    return concat(plans, name=f"moe{layer}.{n_experts}x{C}x{d_ff}")


def moe_schedule(n_tokens: int, d_model: int, n_experts: int,
                 top_k: int, d_ff: int, n_layers: int, dtype, *,
                 capacity: Optional[int] = None,
                 capacity_factor: float = 1.25, act: str = "silu",
                 x: str = "x",
                 page_bytes: int = paging.PAGE_BYTES,
                 sample_stride: int = 1) -> PlanSchedule:
    """Steady-state-sampled N-layer MoE FFN stack: one layer's
    sub-plans as segments repeated ``n_layers`` times, GEMM segments
    optionally strided — host ops stay separate segments so their time
    scales only by the repeat count."""
    plans = _moe_layer_plans(n_tokens, d_model, n_experts, top_k, d_ff,
                             dtype, capacity=capacity,
                             capacity_factor=capacity_factor, act=act,
                             x=x, layer=0, page_bytes=page_bytes,
                             sample_stride=sample_stride)
    return PlanSchedule(f"moe_x{n_layers}~sampled",
                        [(p, n_layers) for p in plans])


def moe_layer_weights(d_model: int, n_experts: int, d_ff: int,
                      layer: int = 0) -> dict:
    """Shapes of the weight tensors ``moe_layer_plan`` expects."""
    P = f"M{layer}."
    w = {P + "router": (d_model, n_experts)}
    for e in range(n_experts):
        w[P + f"e{e}.wg"] = (d_model, d_ff)
        w[P + f"e{e}.wu"] = (d_model, d_ff)
        w[P + f"e{e}.wo"] = (d_ff, d_model)
    return w


# ------------------------------------------------------------- SSM layer
def _ssm_layer_plans(T: int, d_model: int, n_heads: int, dtype, *,
                     chunk: int = 16, x: str = "x", layer: int = 0,
                     out: Optional[str] = None, inclusive: bool = True,
                     page_bytes: int = paging.PAGE_BYTES,
                     sample_stride: int = 1) -> list:
    P = f"S{layer}."
    N = d_model // n_heads
    dt = dtype
    ss = sample_stride
    plans = [
        gemm_plan(T, d_model, d_model, dt, a=x, b=P + "wr", c=P + "r",
                  b_kind="weight", c_kind="intermediate",
                  page_bytes=page_bytes, sample_stride=ss),
        gemm_plan(T, d_model, d_model, dt, a=x, b=P + "wk", c=P + "k",
                  b_kind="weight", c_kind="intermediate",
                  page_bytes=page_bytes, sample_stride=ss),
        gemm_plan(T, d_model, d_model, dt, a=x, b=P + "wv", c=P + "v",
                  b_kind="weight", c_kind="intermediate",
                  page_bytes=page_bytes, sample_stride=ss),
    ]
    nc = -(-T // chunk)
    state = P + "s0"
    chunk_outs = []
    for c in range(nc):
        t0, t1 = c * chunk, min(T, (c + 1) * chunk)
        o, s = P + f"c{c}.o", P + f"c{c}.s"
        plans.append(host_plan(
            "ssm_scan", (P + "r", P + "k", P + "v", P + "logw", state),
            None, None, (t1 - t0) * n_heads * N * N, dt, page_bytes,
            meta={"t0": t0, "t1": t1, "H": n_heads, "N": N,
                  "inclusive": inclusive},
            outs=[(o, (t1 - t0, d_model)), (s, (n_heads * N, N))]))
        state = s
        chunk_outs.append(o)
    out = out or P + "out"
    plans += [
        host_plan("concat_rows", tuple(chunk_outs), P + "scan",
                  (T, d_model), T * d_model, dt, page_bytes),
        gemm_plan(T, d_model, d_model, dt, a=P + "scan", b=P + "wo",
                  c=out, b_kind="weight", c_kind="output",
                  page_bytes=page_bytes, sample_stride=ss),
    ]
    # register the caller-supplied scan inputs on the first sub-plan so
    # both the concat plan and schedule segments know their shapes
    plans[0].tensors[P + "logw"] = TensorSpec(T, d_model, set(), "input")
    plans[0].tensors[P + "s0"] = TensorSpec(n_heads * N, N, set(),
                                            "input")
    return plans


def ssm_layer_plan(T: int, d_model: int, n_heads: int, dtype, *,
                   chunk: int = 16, x: str = "x", layer: int = 0,
                   out: Optional[str] = None, inclusive: bool = True,
                   page_bytes: int = paging.PAGE_BYTES) -> StreamPlan:
    """Scan-structured SSM layer mirroring ``models/ssm.py``: r/k/v
    projections stream through the accelerator, then the sequence is
    processed in pages (chunks) by host-side chunked linear attention —
    each chunk's COMPUTE depends on the previous chunk's carry state
    (the O(state) recurrence that replaces a giant KV cache), forming
    an explicit scan dependency chain — and the gathered outputs feed
    the output projection GEMM.

    Caller supplies ``S{layer}.logw`` (per-token log-decay, (T, d)) and
    ``S{layer}.s0`` (initial state, (H*N, N)) alongside ``x`` and the
    weights from ``ssm_layer_weights``.  For strided steady-state
    sampling use ``ssm_schedule`` (host scan ops must not inherit the
    GEMM stride scale)."""
    plans = _ssm_layer_plans(T, d_model, n_heads, dtype, chunk=chunk,
                             x=x, layer=layer, out=out,
                             inclusive=inclusive, page_bytes=page_bytes)
    return concat(plans, name=f"ssm{layer}.{T}x{d_model}c{chunk}")


def ssm_schedule(T: int, d_model: int, n_heads: int, n_layers: int,
                 dtype, *, chunk: int = 16, x: str = "x",
                 inclusive: bool = True,
                 page_bytes: int = paging.PAGE_BYTES,
                 sample_stride: int = 1) -> PlanSchedule:
    """Steady-state-sampled N-layer SSM stack; see ``moe_schedule``."""
    plans = _ssm_layer_plans(T, d_model, n_heads, dtype, chunk=chunk,
                             x=x, layer=0, inclusive=inclusive,
                             page_bytes=page_bytes,
                             sample_stride=sample_stride)
    return PlanSchedule(f"ssm_x{n_layers}~sampled",
                        [(p, n_layers) for p in plans])


def ssm_layer_weights(d_model: int, layer: int = 0) -> dict:
    """Shapes of the weight tensors ``ssm_layer_plan`` expects."""
    P = f"S{layer}."
    return {P + w: (d_model, d_model) for w in ("wr", "wk", "wv", "wo")}


# ------------------------------------------------------------ decode step
def decode_step_plan(page_tables: Sequence[Sequence[int]],
                     lens: Sequence[int], page_tokens: int,
                     n_kv_heads: int, head_dim: int, elem: int, *,
                     n_q_heads: Optional[int] = None,
                     n_layers: int = 1,
                     q: str = "q", k: str = "k", v: str = "v",
                     out: str = "decode_out",
                     scale: Optional[float] = None,
                     name: str = "decode_step") -> StreamPlan:
    """One batched decode step over a paged KV cache: for every active
    sequence, DMA-in its K pages (ids taken VERBATIM from the page
    table, so plan page traffic equals the pool pages actually
    resident), one QK^T tile per page on the accelerator, drain the
    score blocks, host masked-softmax over the valid length, then the
    PV accumulation streamed over the V pages and one output drain.

    ``page_tables[b]`` lists the pool page ids sequence b holds;
    ``lens[b]`` is its valid token count; ``elem`` is the KV element
    size in bytes.  The plan's ``page_bytes`` is the KV page size, and
    total DMA_IN bytes == n_layers * 2 * sum(held_pages) * page_bytes —
    the bytes actually resident for the batch.

    GQA (``n_q_heads > n_kv_heads``): each KV page is fetched ONCE and
    the q-head fan-out becomes ``n_q_heads / n_kv_heads`` extra SA
    passes over the loaded page (pass g covers the contiguous q-head
    block ``[g*KH, (g+1)*KH)``, each q head reading kv head
    ``h // group``) — KV bytes stay accounted per KV head while compute
    and score traffic scale with the query heads.

    ``n_layers > 1`` composes one per-layer plan (tensor names prefixed
    ``L{i}.``, so each layer's KV pool pages occupy their own SMMU
    namespace, exactly as the per-layer device pools would) via
    ``concat`` — the exact multi-layer step.  ``decode_step_schedule``
    is the steady-state-sampled counterpart (one layer window x
    repeat)."""
    pt, KH, hd = page_tokens, n_kv_heads, head_dim
    HQ = KH if n_q_heads is None else n_q_heads
    _require(HQ % KH == 0, (HQ, KH))
    group = HQ // KH
    if n_layers > 1:
        plans = [decode_step_plan(
            page_tables, lens, pt, KH, hd, elem, n_q_heads=HQ,
            q=f"L{i}.{q}", k=f"L{i}.{k}", v=f"L{i}.{v}",
            out=f"L{i}.{out}", scale=scale, name=f"{name}.L{i}")
            for i in range(n_layers)]
        return concat(plans, name=name)
    page_bytes = pt * KH * hd * elem
    np_dt = _NP_FOR_ELEM[elem]
    scale = scale if scale is not None else hd ** -0.5
    events: list = []
    eid = 0
    macs = 0
    B = len(page_tables)
    tensors = {q: TensorSpec(B, HQ * hd, set(), "input"),
               out: TensorSpec(B * HQ, hd, {"C"}, "output")}
    k_pages: set = set()
    v_pages: set = set()
    for b, (tbl, ln) in enumerate(zip(page_tables, lens)):
        tbl = [int(p) for p in tbl]
        npg = len(tbl)
        if npg == 0:
            continue
        scores, p = f"{out}.s{b}", f"{out}.p{b}"
        tensors[scores] = TensorSpec(HQ, npg * pt, set(), "intermediate")
        tensors[p] = TensorSpec(HQ, npg * pt, set(), "intermediate")
        for pi, pid in enumerate(tbl):
            k_pages.add(pid)
            ek = Event(eid, EventKind.DMA_IN, nbytes=page_bytes,
                       page=(k, pid), lane=0, op="load")
            eid += 1
            for g in range(group):
                ec = Event(eid, EventKind.COMPUTE, deps=(ek.eid,),
                           op="attn_qk", unit="sa",
                           meta={"q": q, "k": k, "page": pid, "slot": b,
                                 "page_idx": pi, "heads": KH,
                                 "head_dim": hd, "pt": pt, "depth": hd,
                                 "scores": scores, "g": g,
                                 "q0": g * KH, "n_q": HQ,
                                 "group": group})
                eo = Event(eid + 1, EventKind.DMA_OUT,
                           nbytes=KH * pt * elem,
                           page=(scores, (g, pi)), deps=(ec.eid,),
                           op="store", meta={"at": (g * KH, pi * pt)})
                events += [ec, eo] if g else [ek, ec, eo]
                eid += 2
        sm = Event(eid, EventKind.COMPUTE, deps=(eid - 1,),
                   op="masked_softmax", unit="host",
                   meta={"inputs": (scores,), "out": p,
                         "elems": HQ * npg * pt, "valid": int(ln),
                         "scale": scale})
        events.append(sm)
        eid += 1
        chain = [None] * group
        for pi, pid in enumerate(tbl):
            v_pages.add(pid)
            ev = Event(eid, EventKind.DMA_IN, nbytes=page_bytes,
                       page=(v, pid), lane=1, op="load")
            eid += 1
            for g in range(group):
                deps = (ev.eid, sm.eid) if chain[g] is None \
                    else (ev.eid, sm.eid, chain[g])
                ec = Event(eid, EventKind.COMPUTE, deps=deps,
                           op="attn_pv", unit="sa",
                           meta={"p": p, "v": v, "page": pid, "slot": b,
                                 "page_idx": pi, "heads": KH,
                                 "head_dim": hd, "pt": pt, "depth": pt,
                                 "out": out, "g": g, "q0": g * KH,
                                 "n_q": HQ, "group": group,
                                 "first": pi == 0,
                                 "last": pi == npg - 1})
                events += [ec] if g else [ev, ec]
                chain[g] = ec.eid
                eid += 1
        for g in range(group):
            events.append(Event(eid, EventKind.DMA_OUT,
                                nbytes=KH * hd * elem,
                                page=(out, (b, g)),
                                deps=(chain[g],), op="store",
                                meta={"at": (b * HQ + g * KH, 0)}))
            eid += 1
        macs += npg * pt * HQ * hd * 2         # QK^T + PV per page
    tensors[k] = TensorSpec(len(k_pages) * pt, KH * hd, {"P"}, "input",
                            pages=len(k_pages))
    tensors[v] = TensorSpec(len(v_pages) * pt, KH * hd, {"P"}, "input",
                            pages=len(v_pages))
    return StreamPlan(name, np_dt, page_bytes, events, tensors,
                      macs=macs, n_calls=1)


def decode_step_schedule(page_tables: Sequence[Sequence[int]],
                         lens: Sequence[int], page_tokens: int,
                         n_kv_heads: int, head_dim: int, elem: int,
                         n_layers: int, *,
                         n_q_heads: Optional[int] = None,
                         out: str = "decode_out",
                         scale: Optional[float] = None,
                         name: str = "decode_step") -> PlanSchedule:
    """Steady-state-sampled N-layer decode step: the layer stack is
    homogeneous (every layer streams the same page-table composition),
    so ONE layer's step plan is the steady window, repeated
    ``n_layers`` times — layer i's pool pages are physically distinct
    from layer j's, which is exactly the schedule footprint rule
    (windows count once per repeat)."""
    layer = decode_step_plan(page_tables, lens, page_tokens, n_kv_heads,
                             head_dim, elem, n_q_heads=n_q_heads,
                             out=out, scale=scale,
                             name=f"{name}.layer")
    return PlanSchedule(f"{name}_x{n_layers}~sampled",
                        [(layer, n_layers)])


# ------------------------------------------------------------- prefill
def prefill_plan(page_table: Sequence[int], prompt_len: int,
                 page_tokens: int, n_kv_heads: int, head_dim: int,
                 elem: int, *,
                 n_q_heads: Optional[int] = None,
                 d_model: Optional[int] = None,
                 d_ff: Optional[int] = None,
                 n_layers: int = 1,
                 x: str = "prompt", k: str = "k", v: str = "v",
                 out: str = "prefill_out",
                 scale: Optional[float] = None,
                 span: Optional[tuple] = None,
                 name: str = "prefill") -> StreamPlan:
    """One request's prompt prefill over the SAME ``PageTable`` pages a
    decode step streams: per layer, a weight-streaming QKV projection
    GEMM (Algorithm 1), DMA-out of the freshly produced K/V into the
    sequence's pool pages (ids verbatim from the page table), then
    chunked causal attention — the prompt is processed in page-sized
    query chunks, each chunk streaming the KV pages written so far
    (QK^T per page per q-head group, host masked-softmax over the
    causal length, PV accumulation) — followed by the output-projection
    and FFN weight-streaming GEMMs.

    ``page_table`` lists the pool page ids the sequence holds (the
    prompt occupies the first ``ceil(prompt_len / page_tokens)`` of
    them); causality is modeled at chunk granularity (chunk i attends
    to the first ``(i+1) * page_tokens`` positions).  Multi-layer plans
    prefix all tensor names ``L{i}.`` so each layer's weights and KV
    pages own their SMMU namespace; layer i's output feeds layer i+1.

    ``span=(t0, t1)`` restricts the plan to prefilling query tokens
    ``[t0, t1)`` of the prompt — chunked-prefill admission splits a
    long prompt into successive span plans over the SAME page table,
    each attending over every KV page written so far (pages ``[0,
    ceil(t1 / page_tokens))``), so earlier chunks' pool pages are
    re-streamed exactly as a later decode step would re-stream them.
    ``t0`` must be page-aligned; ``t1`` page-aligned or the prompt
    end.  The default span ``(0, prompt_len)`` produces the identical
    plan this builder has always produced.
    """
    pt, KH, hd = page_tokens, n_kv_heads, head_dim
    HQ = KH if n_q_heads is None else n_q_heads
    _require(HQ % KH == 0, (HQ, KH))
    group = HQ // KH
    T = int(prompt_len)
    npg = -(-T // pt)
    tbl = [int(p) for p in page_table][:npg]
    if len(tbl) != npg:
        raise ValueError(
            f"page_table holds {len(page_table)} pages but a "
            f"{T}-token prompt needs {npg}")
    s0, s1 = (0, T) if span is None else (int(span[0]), int(span[1]))
    if not (0 <= s0 < s1 <= T) or s0 % pt or (s1 != T and s1 % pt):
        raise ValueError(
            f"span {span} invalid for a {T}-token prompt with "
            f"{pt}-token pages (start page-aligned, end page-aligned "
            f"or the prompt end)")
    c0, c1 = s0 // pt, -(-s1 // pt)
    Tq = s1 - s0                        # query tokens this plan covers
    dm = d_model if d_model is not None else HQ * hd
    dff = d_ff if d_ff is not None else 4 * dm
    page_bytes = pt * KH * hd * elem
    np_dt = _NP_FOR_ELEM[elem]
    scale = scale if scale is not None else hd ** -0.5

    def layer_plans(P: str, x_in: str, out_name: str) -> list:
        kt, vt = P + k, P + v
        plans = [gemm_plan(Tq, (HQ + 2 * KH) * hd, dm, np_dt, a=x_in,
                           b=P + "wqkv", c=P + "qkv", b_kind="weight",
                           c_kind="intermediate", page_bytes=page_bytes)]
        # write the freshly projected K/V into the sequence's pool
        # pages — the same physical pages every later decode step (and
        # every later chunk of this prefill) streams back in
        events: list = []
        eid = 0
        for pid in tbl[c0:c1]:
            for pool in (kt, vt):
                events.append(Event(eid, EventKind.DMA_OUT,
                                    nbytes=page_bytes,
                                    page=(pool, pid), op="store"))
                eid += 1
        kv_spec = lambda: TensorSpec(npg * pt, KH * hd, {"P"},
                                     "intermediate", pages=npg)
        plans.append(StreamPlan(P + "kv_write", np_dt, page_bytes,
                                events, {kt: kv_spec(), vt: kv_spec()}))
        # chunked causal attention over the written pages
        events = []
        eid = 0
        macs = 0
        attn = P + "attn"
        # rows = this span's query tokens (the wo GEMM consumes the
        # same Tq-row view); store offsets below are span-relative
        tensors = {attn: TensorSpec(Tq, HQ * hd, {"C"}, "intermediate"),
                   kt: kv_spec(), vt: kv_spec()}
        for ci in range(c0, c1):
            t1 = min(s1, (ci + 1) * pt)
            qt = t1 - ci * pt
            kv_upto = ci + 1
            scores, p = P + f"c{ci}.s", P + f"c{ci}.p"
            tensors[scores] = TensorSpec(HQ * qt, kv_upto * pt, set(),
                                         "intermediate")
            tensors[p] = TensorSpec(HQ * qt, kv_upto * pt, set(),
                                    "intermediate")
            for pi in range(kv_upto):
                ek = Event(eid, EventKind.DMA_IN, nbytes=page_bytes,
                           page=(kt, tbl[pi]), lane=0, op="load")
                eid += 1
                for g in range(group):
                    ec = Event(eid, EventKind.COMPUTE, deps=(ek.eid,),
                               op="prefill_qk", unit="sa",
                               meta={"chunk": ci, "page_idx": pi,
                                     "heads": KH, "q_tokens": qt,
                                     "depth": hd, "g": g})
                    eo = Event(eid + 1, EventKind.DMA_OUT,
                               nbytes=KH * qt * pt * elem,
                               page=(scores, (g, pi)), deps=(ec.eid,),
                               op="store",
                               meta={"at": (g * KH * qt, pi * pt)})
                    events += [ec, eo] if g else [ek, ec, eo]
                    eid += 2
            sm = Event(eid, EventKind.COMPUTE, deps=(eid - 1,),
                       op="masked_softmax", unit="host",
                       meta={"inputs": (scores,), "out": p,
                             "elems": HQ * qt * kv_upto * pt,
                             "valid": t1, "scale": scale})
            events.append(sm)
            eid += 1
            chain = [None] * group
            for pi in range(kv_upto):
                ev = Event(eid, EventKind.DMA_IN, nbytes=page_bytes,
                           page=(vt, tbl[pi]), lane=1, op="load")
                eid += 1
                for g in range(group):
                    deps = (ev.eid, sm.eid) if chain[g] is None \
                        else (ev.eid, sm.eid, chain[g])
                    ec = Event(eid, EventKind.COMPUTE, deps=deps,
                               op="prefill_pv", unit="sa",
                               meta={"chunk": ci, "page_idx": pi,
                                     "heads": KH, "q_tokens": qt,
                                     "depth": pt, "g": g,
                                     "first": pi == 0,
                                     "last": pi == kv_upto - 1})
                    events += [ec] if g else [ev, ec]
                    chain[g] = ec.eid
                    eid += 1
            for g in range(group):
                events.append(Event(eid, EventKind.DMA_OUT,
                                    nbytes=KH * qt * hd * elem,
                                    page=(attn, (ci, g)),
                                    deps=(chain[g],), op="store",
                                    meta={"at": (ci * pt - s0,
                                                 g * KH * hd)}))
                eid += 1
            macs += qt * HQ * kv_upto * pt * hd * 2
        plans.append(StreamPlan(P + "chunked_attn", np_dt, page_bytes,
                                events, tensors, macs=macs, n_calls=1))
        plans += [
            gemm_plan(Tq, dm, HQ * hd, np_dt, a=attn, b=P + "wo",
                      c=P + "proj", b_kind="weight",
                      c_kind="intermediate", page_bytes=page_bytes),
            host_plan("layernorm", (P + "proj",), P + "ln", (Tq, dm),
                      2 * Tq * dm, np_dt, page_bytes),
            gemm_plan(Tq, dff, dm, np_dt, a=P + "ln", b=P + "w1",
                      c=P + "ff1", b_kind="weight",
                      c_kind="intermediate", page_bytes=page_bytes),
            host_plan("gelu", (P + "ff1",), P + "g", (Tq, dff),
                      Tq * dff, np_dt, page_bytes),
            gemm_plan(Tq, dm, dff, np_dt, a=P + "g", b=P + "w2",
                      c=out_name, b_kind="weight", c_kind="output",
                      page_bytes=page_bytes),
        ]
        return plans

    plans: list = []
    inp = x
    for i in range(n_layers):
        P = f"L{i}." if n_layers > 1 else ""
        out_name = f"L{i}.{out}" if n_layers > 1 and i < n_layers - 1 \
            else out
        plans += layer_plans(P, inp, out_name)
        inp = out_name
    tag = "" if span is None else f".{s0}-{s1}"
    return concat(plans, name=f"{name}{T}t{n_layers}l{tag}")


# ---------------------------------------------------------------- swap
SWAP_LANE = 2      # DMA channel for KV swap traffic (A=0, B=1)


def swap_plan(n_pages: int, page_tokens: int, n_kv_heads: int,
              head_dim: int, elem: int, *, direction: str, tag,
              n_layers: int = 1, k: str = "k", v: str = "v",
              name: Optional[str] = None) -> StreamPlan:
    """Page-aligned KV swap between the device pool and host memory —
    the preemption path priced as ordinary DMA traffic.

    ``direction="out"`` emits one DMA_OUT per resident K and V page
    per layer (the victim's KV streamed to a host swap region);
    ``direction="in"`` emits the matching DMA_INs on resume.  Swap
    pages live in their own SMMU namespace (``L{i}.k.swap`` /
    ``L{i}.v.swap``) keyed ``(tag, page_index)`` — ``tag`` (the
    request uid) makes the host region stable across a request's
    swap-out/swap-in pair, so the LLC/TLB models see the swap-in
    re-touch exactly the pages the swap-out wrote, and a second
    preemption of the same request reuses its region.  Swap-in DMAs
    ride a dedicated lane (``SWAP_LANE``) so they group as their own
    transfer stream, not as attention operand traffic.

    The result is an exact repeat-1 ``StreamPlan`` like every other
    serving record, so swap-bearing traces flow through
    ``replay_trace`` / ``replay_trace_streamed`` unchanged (and stay
    bitwise-identical under chunking)."""
    if direction not in ("out", "in"):
        raise ValueError(f"direction must be 'out' or 'in': {direction}")
    if n_pages < 1:
        raise ValueError(f"swap_plan needs >= 1 page, got {n_pages}")
    page_bytes = page_tokens * n_kv_heads * head_dim * elem
    np_dt = _NP_FOR_ELEM[elem]
    kind = EventKind.DMA_OUT if direction == "out" else EventKind.DMA_IN
    events: list = []
    tensors: dict = {}
    eid = 0
    for i in range(n_layers):
        P = f"L{i}." if n_layers > 1 else ""
        for pool in (P + k, P + v):
            ns = pool + ".swap"
            tensors[ns] = TensorSpec(n_pages * page_tokens,
                                     n_kv_heads * head_dim, {"P"},
                                     "intermediate", pages=n_pages)
            for j in range(n_pages):
                events.append(Event(
                    eid, kind, nbytes=page_bytes, page=(ns, (tag, j)),
                    lane=SWAP_LANE, op=f"swap_{direction}"))
                eid += 1
    if name is None:
        name = f"swap_{direction}.u{tag}"
    return StreamPlan(name, np_dt, page_bytes, events, tensors,
                      n_calls=1)
