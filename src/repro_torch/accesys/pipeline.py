"""Event-driven StreamPlan replayer (paper Fig. 2 + Fig. 6).

``replay`` times ANY ``core.plan.StreamPlan`` — single GEMMs, paged
attention, composed N-layer transformer models, expert-routed MoE
layers, scan-structured SSM layers, paged-KV decode steps, or
steady-state-sampled ``PlanSchedule``s — against the
component models: DMA-in on two read channels (lane 0 = A, lane 1 = B),
SA compute with double buffering (transfers for step t+1 overlap compute
of step t), host-side ops, and DMA-out draining behind the next tile's
compute.  It produces end-to-end latency plus the Fig.-2 latency buckets
(descriptor / translation / transfer / compute / drain) and TLB stats
(Table 8).

``simulate_gemm`` keeps its historical signature but is now a thin
wrapper: build the (possibly steady-state-sampled) Algorithm-1 plan and
replay it — the SAME plan ``core.streaming.gemm_streamed`` executes
functionally.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Optional

import numpy as np

from repro_torch.accesys.components import (DMAEngine, DRAM, Fabric, LLC,
                                            LRUStreamState, PCIeLink, SMMU,
                                            SystolicArray, _lru_trace_memo)
from repro_torch.core import plan as P
from repro_torch.core import streaming

# behavioural host rate for plan-level host ops (softmax/LN/gelu):
# matches system.CPUModel.nongemm_cycles_per_elem at 1 GHz
HOST_S_PER_ELEM = 0.8e-9

# replay engine selection: "auto" uses the compiled (array-form) engine
# once a plan is big enough to amortize the vectorized passes, and the
# event loop below that; "event" / "compiled" force one engine
DEFAULT_ENGINE = "auto"
COMPILED_MIN_EVENTS = 3000


@dataclasses.dataclass
class GemmResult:
    total_s: float
    compute_s: float
    transfer_s: float            # serialized transfer demand
    exposed_transfer_s: float    # transfer time NOT hidden by compute
    descriptor_s: float
    translation_s: float
    tlb_lookups: int
    tlb_misses: int
    ptw_walks: int
    macs: int
    host_s: float = 0.0          # host-side op time (composed plans)
    drain_s: float = 0.0         # DMA-out tail not hidden by compute
    coll_s: float = 0.0          # inter-device collective time (multidev)

    @property
    def translation_overhead(self) -> float:
        return self.translation_s / max(self.total_s, 1e-30)

    @property
    def gops(self) -> float:
        return 2.0 * self.macs / max(self.total_s, 1e-30) / 1e9

    def buckets(self) -> dict:
        """Fig.-2 latency buckets, as shares of total."""
        t = max(self.total_s, 1e-30)
        return {"descriptor": self.descriptor_s / t,
                "translation": self.translation_s / t,
                "transfer": self.exposed_transfer_s / t,
                "compute": self.compute_s / t,
                "drain": self.drain_s / t,
                "host": self.host_s / t,
                "collective": self.coll_s / t}


# keep the historical name but make the generality explicit
ReplayResult = GemmResult


@dataclasses.dataclass
class SystemConfig:
    sa: SystolicArray = dataclasses.field(default_factory=SystolicArray)
    pcie: PCIeLink = dataclasses.field(default_factory=PCIeLink)
    dram: DRAM = dataclasses.field(default_factory=DRAM)
    dma: DMAEngine = dataclasses.field(default_factory=DMAEngine)
    smmu: SMMU = dataclasses.field(default_factory=SMMU)
    llc: LLC = dataclasses.field(default_factory=LLC)
    fabric: Fabric = dataclasses.field(default_factory=Fabric)
    mode: str = "DC"                   # DM | DC | DevMem
    page_bytes: int = 4096

    def path_time(self, nbytes: int, page_id, footprint_pages: int):
        """(transfer_s, translation_s) along the selected datapath."""
        trans = self.smmu.access(page_id, footprint_pages)
        if self.mode == "DevMem":
            # arrow (6): on-card memory — no PCIe crossing
            return self.dram.transfer_time(nbytes), trans
        link = self.pcie.transfer_time(nbytes)
        if self.mode == "DC" and self.llc.access(page_id):
            # arrows (2,4): LLC hit — the coherent root-complex path
            # coalesces repeated reads of cache-hot pages, so the
            # endpoint sees only a fraction of the full serialization
            mem = self.llc.hit_time(nbytes)
            link *= 0.25
        else:
            mem = self.dram.transfer_time(nbytes)  # arrows (3,5)/(5)
        return link + mem, trans


@dataclasses.dataclass
class _Trace:
    """Raw replay timeline state + bucket accumulators (unscaled)."""
    t_sa_free: float = 0.0
    t_out_free: float = 0.0
    t_dma_free: float = 0.0
    compute_s: float = 0.0
    transfer_s: float = 0.0
    exposed_s: float = 0.0
    desc_s: float = 0.0
    trans_s: float = 0.0
    host_s: float = 0.0
    coll_s: float = 0.0

    @property
    def makespan(self) -> float:
        return max(self.t_sa_free, self.t_out_free)


def _replay_events(cfg: SystemConfig, events, footprint_pages: int,
                   host_s_per_elem: float = HOST_S_PER_ELEM,
                   tr: Optional[_Trace] = None) -> _Trace:
    """Walk the event list against the component models.

    Double buffering: a COMPUTE's input DMA group is charged against the
    input-DMA channel timeline, so the fetch for step t+1 runs during
    step t's compute; only the excess surfaces as exposed transfer.
    DMA-out uses the write channels and drains behind compute.

    Passing an existing ``tr`` continues its timeline — the schedule
    replayer walks steady-state windows back-to-back on one clock, so
    drain tails and DMA-engine occupancy overlap the next window's
    compute exactly as they do in an exact composed replay.
    """
    tr = tr if tr is not None else _Trace()
    pending: list = []             # (lane, transfer_s, translation_s)

    def drain_pending() -> float:
        """Charge the queued DMA_IN group against the input-DMA
        timeline; returns when its data is ready on-chip."""
        nonlocal pending
        d = len(pending) * cfg.dma.descriptor_time() \
            / cfg.dma.read_channels
        tr.desc_s += d
        lanes: dict = {}
        for lane, t, _ in pending:
            lanes[lane] = lanes.get(lane, 0.0) + t
        if cfg.dma.read_channels >= len(lanes):
            tin = d + max(lanes.values())
        else:
            tin = d + sum(t for _, t, _ in pending)
        ready = max(tr.t_dma_free, 0.0) + tin \
            + sum(x for _, _, x in pending)
        tr.t_dma_free = ready
        pending = []
        return ready

    for ev in events:
        if ev.kind is P.EventKind.DMA_IN:
            t, x = cfg.path_time(ev.nbytes, ev.page, footprint_pages)
            pending.append((ev.lane, t, x))
            tr.transfer_s += t
            tr.trans_s += x
        elif ev.kind is P.EventKind.COMPUTE and ev.unit == "sa":
            ready = drain_pending() if pending else 0.0
            start = max(ready, tr.t_sa_free)
            tr.exposed_s += max(0.0, ready - tr.t_sa_free)
            tile = cfg.sa.tile_time(ev.meta["depth"])
            tr.t_sa_free = start + tile
            tr.compute_s += tile
        elif ev.kind is P.EventKind.COMPUTE:
            # host op: waits for fetches in flight and for the producing
            # C tiles to drain, then runs on the CPU while the
            # accelerator idles (paper §4.2)
            if pending:                  # pages fetched for host use
                ready = drain_pending()
                tr.exposed_s += max(0.0, ready - tr.t_sa_free)
                tr.t_sa_free = max(tr.t_sa_free, ready)
            th = ev.meta["elems"] * host_s_per_elem
            tr.t_sa_free = max(tr.t_sa_free, tr.t_out_free) + th
            tr.host_s += th
        elif ev.kind is P.EventKind.COLLECTIVE:
            # inter-device exchange hop: a barrier on this rank's
            # timeline priced on the dedicated fabric link — no page
            # traffic on the host<->device path, and pending fetches
            # of the NEXT op keep prefetching underneath it (they
            # drain at that op, exactly as across a DMA_OUT)
            tc = cfg.fabric.hop_time(ev.nbytes)
            tr.t_sa_free = max(tr.t_sa_free, tr.t_out_free) + tc
            tr.coll_s += tc
        else:                       # DMA_OUT
            tc, xc = cfg.path_time(ev.nbytes, ev.page, footprint_pages)
            tr.desc_s += cfg.dma.descriptor_time()
            tr.trans_s += xc
            tr.transfer_s += tc
            tr.t_out_free = max(tr.t_out_free, tr.t_sa_free) + tc
    if pending:                     # trailing fetches no compute consumed
        ready = drain_pending()
        tr.exposed_s += max(0.0, ready - tr.t_sa_free)
        tr.t_sa_free = max(tr.t_sa_free, ready)
    return tr


def _result(cfg: SystemConfig, tr: _Trace, macs: int, n_calls: int,
            scale: float = 1.0) -> GemmResult:
    control = n_calls * (cfg.dma.doorbell_ns + cfg.dma.interrupt_ns) * 1e-9
    total = max(tr.t_sa_free, tr.t_out_free) * scale + control
    return GemmResult(
        total_s=total,
        compute_s=tr.compute_s * scale,
        transfer_s=tr.transfer_s * scale,
        exposed_transfer_s=tr.exposed_s * scale,
        descriptor_s=tr.desc_s * scale,
        translation_s=tr.trans_s * scale,
        tlb_lookups=int(cfg.smmu.lookups * scale),
        tlb_misses=int(cfg.smmu.misses * scale),
        ptw_walks=int(cfg.smmu.walks * scale),
        macs=macs,
        host_s=tr.host_s * scale,
        drain_s=max(0.0, tr.t_out_free - tr.t_sa_free) * scale,
        coll_s=tr.coll_s * scale)


def _use_compiled(engine: Optional[str], n_events: int,
                  reset: bool) -> bool:
    engine = engine or DEFAULT_ENGINE
    if engine == "event" or not reset:
        return False                 # continuing a live timeline/state
    if engine == "compiled":
        return True
    if engine != "auto":
        raise ValueError(f"unknown replay engine {engine!r}; valid: "
                         "'auto', 'event', 'compiled'")
    return n_events >= COMPILED_MIN_EVENTS


def replay(cfg: SystemConfig, plan,
           host_s_per_elem: float = HOST_S_PER_ELEM,
           reset: bool = True,
           footprint_pages: Optional[int] = None,
           engine: Optional[str] = None) -> GemmResult:
    """Time an arbitrary StreamPlan end-to-end on this system config.

    Works for single-op plans, for composed multi-layer transformer /
    MoE / SSM / decode plans, and for ``PlanSchedule`` steady-state
    samples (dispatched to ``replay_schedule``); per-offloaded-call
    control cost (doorbell + completion IRQ) is charged
    ``plan.n_calls`` times.  ``footprint_pages`` overrides the
    SMMU-visible footprint (used when a window plan stands in for a
    much larger workload, so page-walk depth reflects the real one).

    ``engine`` selects the replayer: ``"event"`` walks Python event
    objects one by one; ``"compiled"`` runs the array-form engine over
    ``plan.compile()`` (numerically interchangeable, ~10-100x faster
    on composed plans); ``"auto"`` (default) picks by plan size.  With
    ``reset=False`` the event engine is always used — only it can
    continue a live timeline/cache state (results are identical either
    way, by the parity suite).
    """
    if isinstance(plan, P.PlanSchedule):
        return replay_schedule(cfg, plan, host_s_per_elem, reset,
                               footprint_pages, engine)
    if _use_compiled(engine, len(plan.events), reset):
        return replay_compiled(cfg, plan, host_s_per_elem,
                               footprint_pages)
    if reset:
        cfg.smmu.reset()
        cfg.llc.reset()
    scale = plan.total_steps / max(plan.sampled_steps, 1) \
        if plan.total_steps else 1.0
    foot = plan.footprint_pages if footprint_pages is None \
        else footprint_pages
    tr = _replay_events(cfg, plan.events, foot, host_s_per_elem)
    return _result(cfg, tr, plan.macs, plan.n_calls, scale)


def _schedule_passes(unit_ctrl, segments, seg_delta,
                     on_pass_reset=None, zero=0.0):
    """The two-pass steady-window accumulation shared by the event,
    compiled and config-batched schedule replayers.

    Two passes on ONE continuous timeline: the first (weight 1) is the
    cold-start window; the second (weight repeat-1) sees the
    steady-state DMA/compute phase relationship — cold windows expose
    more transfer than steady ones because the input-DMA timeline has
    not yet fallen behind compute.  ``on_pass_reset`` runs between the
    passes (per-key SMMU/LLC reset: in the exact replay every repeat
    owns fresh pages, so key reuse across passes would fake translation
    hits).  ``seg_delta(pass_no, si, pl)`` yields a segment's unscaled
    deltas for the 12 accumulated quantities (total, compute, transfer,
    exposed, desc, trans, host, coll, drain, lookups, misses, walks) —
    each a scalar, or a per-config array when ``zero`` is one.
    ``unit_ctrl`` is the per-call doorbell+IRQ time.  Returns
    (accumulators, control, macs)."""
    multi = any(rep > 1 for _, rep in segments)
    acc = [zero] * 12
    control = zero
    macs = 0
    for pass_no in range(2 if multi else 1):
        if pass_no == 1 and on_pass_reset is not None:
            on_pass_reset()
        for si, (pl, rep) in enumerate(segments):
            weight = 1.0 if pass_no == 0 else float(rep - 1)
            scale = weight * (pl.total_steps / max(pl.sampled_steps, 1)
                              if pl.total_steps else 1.0)
            acc = [a + dv * scale
                   for a, dv in zip(acc, seg_delta(pass_no, si, pl))]
            control = control + pl.n_calls * weight * unit_ctrl
            if pass_no == 0:
                macs += pl.macs * rep
    return acc, control, macs


def _passes_result(acc, control, macs: int) -> GemmResult:
    (total, compute, transfer, exposed, desc, trans, host, coll,
     drain, lookups, misses, walks) = acc
    return GemmResult(
        total_s=total + control, compute_s=compute, transfer_s=transfer,
        exposed_transfer_s=exposed, descriptor_s=desc,
        translation_s=trans, tlb_lookups=int(lookups),
        tlb_misses=int(misses), ptw_walks=int(walks), macs=macs,
        host_s=host, drain_s=max(0.0, drain), coll_s=coll)


def replay_schedule(cfg: SystemConfig, sched: P.PlanSchedule,
                    host_s_per_elem: float = HOST_S_PER_ELEM,
                    reset: bool = True,
                    footprint_pages: Optional[int] = None,
                    engine: Optional[str] = None) -> GemmResult:
    """Steady-state replay of a ``PlanSchedule``: each segment's steady
    window is replayed ONCE against shared SMMU/LLC state and its
    timeline scaled by ``repeat`` (x the intra-GEMM sampling scale, for
    strided windows).  This is what lets a composed BERT-Base forward
    pass replay one layer's events instead of the full stack's while
    matching the exact replay to within a couple of percent."""
    if _use_compiled(engine, sched.sampled_events, reset):
        return replay_schedule_compiled(cfg, sched, host_s_per_elem,
                                        footprint_pages)
    if reset:
        cfg.smmu.reset()
        cfg.llc.reset()
    foot = sched.footprint_pages if footprint_pages is None \
        else footprint_pages
    tr = _Trace()

    def seg_delta(pass_no, si, pl):
        lk0, ms0, wk0 = cfg.smmu.lookups, cfg.smmu.misses, \
            cfg.smmu.walks
        m0, c0, x0, e0 = tr.makespan, tr.compute_s, tr.transfer_s, \
            tr.exposed_s
        d0, tn0, h0, cl0 = tr.desc_s, tr.trans_s, tr.host_s, tr.coll_s
        dr0 = max(0.0, tr.t_out_free - tr.t_sa_free)
        _replay_events(cfg, pl.events, foot, host_s_per_elem, tr)
        return (tr.makespan - m0, tr.compute_s - c0,
                tr.transfer_s - x0, tr.exposed_s - e0,
                tr.desc_s - d0, tr.trans_s - tn0, tr.host_s - h0,
                tr.coll_s - cl0,
                max(0.0, tr.t_out_free - tr.t_sa_free) - dr0,
                cfg.smmu.lookups - lk0, cfg.smmu.misses - ms0,
                cfg.smmu.walks - wk0)

    def reset_state():
        cfg.smmu.reset()
        cfg.llc.reset()

    acc, control, macs = _schedule_passes(
        (cfg.dma.doorbell_ns + cfg.dma.interrupt_ns) * 1e-9,
        sched.segments, seg_delta, on_pass_reset=reset_state)
    return _passes_result(acc, control, macs)


# ===================================================================
# Compiled (array-form) replay engine
# ===================================================================
# The event loop above dispatches on one Python ``Event`` object per
# iteration; the engine below replays the SAME timeline over the
# pre-resolved arrays of a ``core.plan.CompiledPlan``: one vectorized
# SMMU/LLC stack-distance pass prices the whole page trace, DMA-in
# groups reduce to per-op lane sums, and the double-buffer recurrence
# (input-DMA channel vs SA busy time vs DMA-out drain) runs over float
# arrays.  Results match ``replay`` to float tolerance for every
# workload and mode — exact composed replays stop being the slow path.

def _resolve_access_times(cfg: SystemConfig, cp, foot: int):
    """(transfer_s, translation_s) per DMA access — the batch
    counterpart of ``SystemConfig.path_time`` over the whole trace."""
    x = cfg.smmu.access_many(cp.trace_ids, foot, memo=cp.memo,
                             keys=cp.page_keys)
    nb = cp.trace_nbytes
    dlat = cfg.dram.latency_ns * 1e-9
    dbw = cfg.dram.bandwidth * cfg.dram.stream_efficiency
    if cfg.mode == "DevMem":
        return dlat + nb / dbw, x
    link = nb / cfg.pcie.effective_bw
    mem = dlat + nb / dbw
    if cfg.mode == "DC":
        hit = cfg.llc.access_many(cp.trace_ids, memo=cp.memo,
                                  keys=cp.page_keys)
        llc_t = cfg.llc.hit_latency_ns * 1e-9 + nb / cfg.llc.hit_bw
        return np.where(hit, link * 0.25 + llc_t, link + mem), x
    return link + mem, x


def _grp_starts(cp) -> np.ndarray:
    gs = cp.memo.get("gs")
    if gs is None:
        ge = cp.grp_end
        gs = np.concatenate([[0], ge[:-1]]) if ge.size else ge
        cp.memo["gs"] = gs
    return gs


def _seg_sum(v: np.ndarray, s: np.ndarray, e: np.ndarray) -> np.ndarray:
    """Per-segment sums of ``v`` over contiguous tiling segments
    ``[s[i], e[i])``.  Each segment is reduced left-to-right over its
    OWN elements only (``np.add.reduceat``), matching the event loop's
    per-group ``sum`` — and, unlike a diff-of-prefix-cumsum, the value
    of a segment does not depend on anything outside it, so a trace
    priced in chunks produces bitwise the same per-op sums as the
    monolithic pass."""
    out = np.zeros(s.size)
    ne = np.nonzero(e > s)[0]
    if ne.size:
        # non-empty segments tile v exactly (empties have s == e), so
        # reduceat over their starts reduces each segment in isolation
        out[ne] = np.add.reduceat(v, s[ne])
    return out


def _gsum(cp, v: np.ndarray) -> np.ndarray:
    """Sum of the per-access quantity ``v`` over each op's drain
    group."""
    return _seg_sum(v, _grp_starts(cp), cp.grp_end)


def _pending_counts(cp):
    """(npend, has_p) per op — trace-intrinsic, cached on the plan."""
    npend = cp.memo.get("npend")
    if npend is None:
        npend = cp.grp_end - _grp_starts(cp)
        cp.memo["npend"] = npend
        cp.memo["hasp"] = npend > 0
    return npend, cp.memo["hasp"]


def _inout_positions(cp):
    """(input, output) access index arrays — trace-intrinsic."""
    pos = cp.memo.get("inout_pos")
    if pos is None:
        is_out = cp.trace_is_out
        pos = (np.nonzero(~is_out)[0], np.nonzero(is_out)[0])
        cp.memo["inout_pos"] = pos
    return pos


def _group_xlat_sum(cp, x: np.ndarray) -> np.ndarray:
    """Per-op translation sum — depends only on the SMMU row."""
    return _gsum(cp, np.take(x, _inout_positions(cp)[0]))


def _group_path_sums(cp, t: np.ndarray):
    """Per-op input totals, lane maxima and DMA_OUT transfer times —
    depend only on the datapath (transfer) row."""
    in_pos, out_pos = _inout_positions(cp)
    in_t = np.take(t, in_pos)
    tot_t = _gsum(cp, in_t)
    lanes = cp.memo.get("lanes")
    if lanes is None:
        lanes = np.unique(cp.in_lane)
        cp.memo["lanes"] = lanes
        cp.memo["lane_masks"] = [cp.in_lane == ln for ln in lanes]
    if lanes.size <= 1:
        lane_max = tot_t
    else:
        # lane-compacted per-group sums: each lane's accesses are
        # packed contiguously, so its per-group spans tile the packed
        # array and ``_seg_sum`` reduces each group in isolation
        pack = cp.memo.get("lane_pack")
        if pack is None:
            pack = []
            for m_ in cp.memo["lane_masks"]:
                cnt = np.empty(m_.size + 1, np.int64)
                cnt[0] = 0
                np.cumsum(m_, out=cnt[1:])
                pack.append((np.nonzero(m_)[0],
                             cnt[_grp_starts(cp)], cnt[cp.grp_end]))
            cp.memo["lane_pack"] = pack
        lane_max = None
        for pos, si, ei in pack:
            s_ = _seg_sum(np.take(in_t, pos), si, ei)
            lane_max = s_ if lane_max is None \
                else np.maximum(lane_max, s_)
    out_ops = cp.memo.get("out_ops")
    if out_ops is None:
        out_ops = np.nonzero(cp.op_kind == P.OP_OUT)[0]
        cp.memo["out_ops"] = out_ops
    tc = np.zeros(cp.op_kind.size)
    if out_pos.size:
        tc[out_ops] = np.take(t, out_pos)[:out_ops.size]
    return tot_t, lane_max, tc


def _group_reduce(cfg: SystemConfig, cp, t: np.ndarray, x: np.ndarray,
                  *, sums=None):
    """Per-op drain-group quantities: pending count, descriptor time,
    channel-limited input time (``tin``), translation sum, plus the
    per-op DMA_OUT transfer times.  When ``sums`` is given (batched
    path), the per-access reductions already computed for configs
    sharing this SMMU/datapath row pair are reused."""
    if sums is None:
        sums = (_group_xlat_sum(cp, x), _group_path_sums(cp, t))
    sx, (tot_t, lane_max, tc) = sums
    ge = cp.grp_end
    npend, has_p = _pending_counts(cp)
    d = npend * cfg.dma.descriptor_time() / cfg.dma.read_channels
    tin = d + np.where(cfg.dma.read_channels >= cp.n_lanes,
                       lane_max, tot_t)
    # input-DMA channel timeline: advances only when a group drains;
    # interleave tin/sx so the float op order matches the event loop's
    # ``(t_dma + tin) + sum(x)``
    z = np.zeros(2 * len(ge))
    z[0::2] = np.where(has_p, tin, 0.0)
    z[1::2] = np.where(has_p, sx, 0.0)
    ready = np.cumsum(z)[1::2]
    return has_p, d, sx, ready, tc


def _op_amounts_base(cfg: SystemConfig, cp,
                     host_s_per_elem: float) -> np.ndarray:
    """SA tile + host + collective op amounts — depend only on the SA
    variant and the fabric (the host term is config-independent)."""
    k = cp.op_kind
    val = np.where(k == P.OP_SA,
                   cfg.sa.passes * (cp.op_val + 2 * (cfg.sa.w - 1))
                   / cfg.sa.freq, 0.0)
    val = np.where(k == P.OP_HOST, cp.op_val * host_s_per_elem, val)
    return np.where(k == P.OP_COLL,
                    cp.op_val / cfg.fabric.link.effective_bw
                    + cfg.fabric.hop_latency_ns * 1e-9, val)


def _op_amounts(cfg: SystemConfig, cp, tc: np.ndarray,
                host_s_per_elem: float, base=None) -> np.ndarray:
    """The one scalar each op adds to its timeline: SA tile time, host
    op time, or DMA_OUT transfer time."""
    if base is None:
        base = _op_amounts_base(cfg, cp, host_s_per_elem)
    return np.where(cp.op_kind == P.OP_OUT, tc, base)


def _run_ops_loop(opk, has_p, ready, val, t_sa, t_out):
    """Reference scalar recurrence — fastest for small op streams and
    the literal transcription of the event loop's timeline updates."""
    n = len(opk)
    tsa_a = np.empty(n)
    tout_a = np.empty(n)
    exp_a = np.zeros(n)
    opk_l, hp_l = opk.tolist(), has_p.tolist()
    rdy_l, val_l = ready.tolist(), val.tolist()
    for g in range(n):
        k = opk_l[g]
        if k == P.OP_OUT:
            if t_sa > t_out:
                t_out = t_sa
            t_out += val_l[g]
        else:
            if hp_l[g]:
                r = rdy_l[g]
                if r > t_sa:
                    exp_a[g] = r - t_sa
                    t_sa = r
            if k == P.OP_HOST or k == P.OP_COLL:
                if t_out > t_sa:
                    t_sa = t_out
            if k != P.OP_TAIL:
                t_sa += val_l[g]
        tsa_a[g] = t_sa
        tout_a[g] = t_out
    return tsa_a, tout_a, exp_a, t_sa, t_out


def _run_ops_vec(opk, has_p, ready, val, t_sa, t_out):
    """Vectorized recurrence: host/collective ops and stream drains are
    the only points where the SA timeline reads the DMA-out timeline, so
    the op stream splits into segments that reduce to cumulative sums
    plus running maxima (the max-plus closed form of the double-buffer
    recurrence)."""
    n = opk.size
    tsa_a = np.empty(n)
    tout_a = np.empty(n)
    exp_a = np.zeros(n)
    barrier = np.nonzero((opk == P.OP_HOST) | (opk == P.OP_COLL)
                         | (opk == P.OP_TAIL))[0]
    starts = np.concatenate([[0], barrier + 1])
    ends = np.concatenate([barrier, [n]])
    for s0, s1 in zip(starts, ends):
        s0, s1 = int(s0), int(s1)
        if s1 > s0:
            k = opk[s0:s1]
            v = val[s0:s1]
            sa = np.nonzero(k == P.OP_SA)[0]
            out = np.nonzero(k == P.OP_OUT)[0]
            tsa_seg = None
            if sa.size:
                tiles = v[sa]
                pre = np.cumsum(tiles)
                r = np.where(has_p[s0:s1][sa], ready[s0:s1][sa],
                             -np.inf)
                q = r - np.concatenate([[0.0], pre[:-1]])
                run = np.maximum.accumulate(q)
                tsa_seg = pre + np.maximum(t_sa, run)
                prev_run = np.maximum(
                    t_sa, np.concatenate([[-np.inf], run[:-1]]))
                exp_a[s0:s1][sa] = np.maximum(q - prev_run, 0.0)
            sa_cum = np.cumsum(k == P.OP_SA) - 1
            tsa_sl = np.where(
                sa_cum >= 0,
                tsa_seg[np.maximum(sa_cum, 0)] if tsa_seg is not None
                else t_sa, t_sa)
            tout_seg = None
            if out.size:
                tcs = v[out]
                tcum = np.cumsum(tcs)
                p = tsa_sl[out] - np.concatenate([[0.0], tcum[:-1]])
                tout_seg = tcum + np.maximum(
                    t_out, np.maximum.accumulate(p))
            out_cum = np.cumsum(k == P.OP_OUT) - 1
            tout_sl = np.where(
                out_cum >= 0,
                tout_seg[np.maximum(out_cum, 0)] if tout_seg is not None
                else t_out, t_out)
            tsa_a[s0:s1] = tsa_sl
            tout_a[s0:s1] = tout_sl
            t_sa = float(tsa_sl[-1])
            t_out = float(tout_sl[-1])
        if s1 < n:                           # the barrier op itself
            g = s1
            if has_p[g]:
                r = ready[g]
                if r > t_sa:
                    exp_a[g] = r - t_sa
                    t_sa = r
            if opk[g] == P.OP_HOST or opk[g] == P.OP_COLL:
                if t_out > t_sa:
                    t_sa = t_out
                t_sa += val[g]
            tsa_a[g] = t_sa
            tout_a[g] = t_out
    return tsa_a, tout_a, exp_a, t_sa, t_out


def _run_ops(opk, has_p, ready, val, t_sa=0.0, t_out=0.0,
             force: Optional[str] = None):
    use_vec = (opk.size >= 2048) if force is None else (force == "vec")
    fn = _run_ops_vec if use_vec else _run_ops_loop
    return fn(opk, has_p, ready, val, t_sa, t_out)


def _compiled_arrays(cfg: SystemConfig, cp, foot: int,
                     host_s_per_elem: float):
    t, x = _resolve_access_times(cfg, cp, foot)
    has_p, d, sx, ready, tc = _group_reduce(cfg, cp, t, x)
    val = _op_amounts(cfg, cp, tc, host_s_per_elem)
    return t, x, has_p, d, ready, val


def replay_compiled(cfg: SystemConfig, plan,
                    host_s_per_elem: float = HOST_S_PER_ELEM,
                    footprint_pages: Optional[int] = None,
                    _recur: Optional[str] = None) -> GemmResult:
    """Array-form replay of a StreamPlan: numerically interchangeable
    with ``replay(engine="event")`` but runs over the compiled plan's
    pre-resolved float arrays instead of per-event object dispatch.
    Always starts from reset SMMU/LLC state (use the event engine to
    continue a live timeline)."""
    if isinstance(plan, P.PlanSchedule):
        return replay_schedule_compiled(cfg, plan, host_s_per_elem,
                                        footprint_pages, _recur)
    cfg.smmu.reset()
    cfg.llc.reset()
    cp = plan.compile()
    foot = plan.footprint_pages if footprint_pages is None \
        else footprint_pages
    t, x, has_p, d, ready, val = _compiled_arrays(cfg, cp, foot,
                                                  host_s_per_elem)
    k = cp.op_kind
    _, _, exp_a, t_sa, t_out = _run_ops(k, has_p, ready, val,
                                        force=_recur)
    tr = _Trace(
        t_sa_free=t_sa, t_out_free=t_out,
        compute_s=float(val[k == P.OP_SA].sum()),
        transfer_s=float(t.sum()),
        exposed_s=float(exp_a.sum()),
        desc_s=float(d[has_p].sum())
        + float((k == P.OP_OUT).sum()) * cfg.dma.descriptor_time(),
        trans_s=float(x.sum()),
        host_s=float(val[k == P.OP_HOST].sum()),
        coll_s=float(val[k == P.OP_COLL].sum()))
    scale = plan.total_steps / max(plan.sampled_steps, 1) \
        if plan.total_steps else 1.0
    return _result(cfg, tr, plan.macs, plan.n_calls, scale)


def replay_schedule_compiled(cfg: SystemConfig, sched: P.PlanSchedule,
                             host_s_per_elem: float = HOST_S_PER_ELEM,
                             footprint_pages: Optional[int] = None,
                             _recur: Optional[str] = None) -> GemmResult:
    """Compiled counterpart of ``replay_schedule``: the two sampling
    passes run over ONE concatenated op stream (pass 1 repeats pass 0's
    arrays on the continuing timeline — per-key SMMU/LLC state resets
    between passes, and both passes start that state empty, so the
    per-access times are identical), with per-segment deltas read off
    the op trajectories at the recorded boundaries."""
    cfg.smmu.reset()
    cfg.llc.reset()
    cp = sched.compile()
    foot = sched.footprint_pages if footprint_pages is None \
        else footprint_pages
    t, x, has_p, d, ready, val = _compiled_arrays(cfg, cp, foot,
                                                  host_s_per_elem)
    k = cp.op_kind
    multi = any(rep > 1 for _, rep in sched.segments)
    n_ops = k.size
    if multi:                       # pass 1 = same ops, timeline continues
        k2 = np.concatenate([k, k])
        has_p2 = np.concatenate([has_p, has_p])
        adv_total = ready[-1] if n_ops else 0.0
        ready2 = np.concatenate([ready, ready + adv_total])
        val2 = np.concatenate([val, val])
    else:
        k2, has_p2, ready2, val2 = k, has_p, ready, val
    tsa_a, tout_a, exp_a, _, _ = _run_ops(k2, has_p2, ready2, val2,
                                          force=_recur)

    # op-index boundaries of every (pass, segment) on the run timeline
    bounds2 = np.concatenate([[0], cp.seg_op]) if not multi else \
        np.concatenate([[0], cp.seg_op, n_ops + cp.seg_op])

    def snaps(per_op, init=0.0):
        return np.concatenate([[init], per_op])[bounds2]

    # cumulative per-op / per-access contributions (identical for both
    # passes — only the timeline-dependent ones use the doubled run)
    def cum_at(per_item, bounds):
        c = np.concatenate([[0.0], np.cumsum(per_item)])
        return c[np.concatenate([[0], bounds])]

    comp_c = cum_at(np.where(k == P.OP_SA, val, 0.0), cp.seg_op)
    host_c = cum_at(np.where(k == P.OP_HOST, val, 0.0), cp.seg_op)
    coll_c = cum_at(np.where(k == P.OP_COLL, val, 0.0), cp.seg_op)
    desc_c = cum_at(np.where(has_p, d, 0.0)
                    + np.where(k == P.OP_OUT,
                               cfg.dma.descriptor_time(), 0.0),
                    cp.seg_op)
    xfer_c = cum_at(t, cp.seg_trace)
    trans_c = cum_at(x, cp.seg_trace)
    tlb_miss, miss_pos, walk_sub = cfg.smmu.tlb_walk_masks(cp.trace_ids,
                                                           cp.memo)
    walk_mask = np.zeros(cp.trace_ids.size, bool)
    walk_mask[miss_pos[walk_sub]] = True
    miss_c = cum_at(tlb_miss.astype(np.float64), cp.seg_trace)
    walk_c = cum_at(walk_mask.astype(np.float64), cp.seg_trace)
    look_c = np.concatenate([[0], cp.seg_trace]).astype(np.float64)
    # timeline-dependent snapshots per (pass, segment boundary)
    tsa_s = snaps(tsa_a)
    tout_s = snaps(tout_a)
    mks_s = np.maximum(tsa_s, tout_s)
    drain_s_snap = np.maximum(0.0, tout_s - tsa_s)
    exp_s = np.concatenate([[0.0], np.cumsum(exp_a)])[bounds2]

    nseg = len(sched.segments)

    def seg_delta(pass_no, si, pl):
        tb = pass_no * nseg + si            # timeline boundary index
        return (mks_s[tb + 1] - mks_s[tb],
                comp_c[si + 1] - comp_c[si],
                xfer_c[si + 1] - xfer_c[si],
                exp_s[tb + 1] - exp_s[tb],
                desc_c[si + 1] - desc_c[si],
                trans_c[si + 1] - trans_c[si],
                host_c[si + 1] - host_c[si],
                coll_c[si + 1] - coll_c[si],
                drain_s_snap[tb + 1] - drain_s_snap[tb],
                look_c[si + 1] - look_c[si],
                miss_c[si + 1] - miss_c[si],
                walk_c[si + 1] - walk_c[si])

    acc, control, macs = _schedule_passes(
        (cfg.dma.doorbell_ns + cfg.dma.interrupt_ns) * 1e-9,
        sched.segments, seg_delta)
    return _passes_result(acc, control, macs)


def replay_trace(cfg: SystemConfig, plans,
                 host_s_per_elem: float = HOST_S_PER_ELEM,
                 footprint_pages: Optional[int] = None,
                 engine: Optional[str] = None):
    """Price an entire sequence of plans (e.g. a recorded serving
    trace: prefills + per-step decode plans) as ONE replay on one
    continuous timeline — shared SMMU/LLC state and shared page-id
    interning across plans, so cross-step KV-page reuse is visible to
    the translation and cache models instead of every step starting
    cold.  Returns ``(aggregate GemmResult, per-plan seconds)`` where
    the per-plan array reads each plan's contribution (its makespan
    delta plus its own doorbell/IRQ control time) off the trajectory
    at the recorded segment boundaries — the attribution the serving
    report folds back onto requests.  ``sum(per_plan) == total_s``.

    ``plans`` is a sequence of StreamPlans or a ``PlanSchedule`` whose
    repeats are all 1 (build the schedule once and pass it to share the
    compiled form and its trace-intrinsic LRU analysis across memory
    modes).  Trace replay is exact: steady-state-sampled plans are
    rejected.  The SMMU footprint defaults to the number of DISTINCT
    pages the whole trace touches (the union, not the per-plan sum —
    steps re-touch the same resident pool)."""
    if isinstance(plans, P.PlanSchedule):
        sched = plans
    else:
        sched = P.PlanSchedule("trace", [(p, 1) for p in plans])
    if not sched.segments:
        raise ValueError("replay_trace() needs at least one plan")
    for pl, rep in sched.segments:
        if rep != 1:
            raise ValueError(
                f"replay_trace() needs repeat-1 segments, got "
                f"({pl.name}, {rep}) — use replay_schedule for "
                "steady-state sampling")
        if pl.sampled_steps != pl.total_steps:
            raise ValueError(
                f"trace replay is exact; plan {pl.name} is "
                "steady-state sampled")
    cp = sched.compile()
    foot = len(cp.page_keys) if footprint_pages is None \
        else footprint_pages
    ctrl_unit = (cfg.dma.doorbell_ns + cfg.dma.interrupt_ns) * 1e-9
    n_calls = np.array([pl.n_calls for pl, _ in sched.segments],
                       np.float64)
    macs = sum(pl.macs for pl, _ in sched.segments)
    cfg.smmu.reset()
    cfg.llc.reset()
    if not _use_compiled(engine, cp.n_events, True):
        tr = _Trace()
        per = np.empty(len(sched.segments))
        prev = 0.0
        for i, (pl, _) in enumerate(sched.segments):
            _replay_events(cfg, pl.events, foot, host_s_per_elem, tr)
            per[i] = tr.makespan - prev
            prev = tr.makespan
        res = _result(cfg, tr, macs, int(n_calls.sum()))
        return res, per + n_calls * ctrl_unit
    # the monolithic compiled path IS the streamed core run on one
    # chunk — one code path, so chunked replay is bitwise-identical
    st = _TraceStream([cfg.smmu.tlb_entries])
    _stream_chunk([cfg], cp, [pl for pl, _ in sched.segments], foot,
                  host_s_per_elem, st)
    results, pers = _stream_results([cfg], st, foot)
    return results[0], pers[0]


# ===================================================================
# Config-batched pricing
# ===================================================================
# A design-space sweep prices the SAME compiled plan under many
# ``SystemConfig``s.  Everything trace-intrinsic (page interning, LRU
# stack distances, drain-group structure, barrier layout) is already
# shared through ``cp.memo``; what differs per config factors into a
# handful of row families — translation times (SMMU parameters),
# transfer times (datapath), group reductions (DMA engine), op amounts
# (SA) — and most sweep axes leave most families untouched.
# ``replay_batch`` therefore dedups each family (reusing the scalar
# helpers above row by row, so the per-config float operations are
# IDENTICAL to ``replay_compiled``'s), then evaluates the max-plus
# timeline recurrence once over a (configs × ops) matrix.

def _smmu_row_key(s: SMMU, foot: int) -> tuple:
    return ("smmu", s.tlb_entries, s.l2_entries, s.hit_cycles,
            s.l2_fill_cycles, s.freq, s.walk_cycles(foot))


def _path_row_key(cfg: SystemConfig) -> tuple:
    d = (cfg.dram.latency_ns, cfg.dram.bandwidth,
         cfg.dram.stream_efficiency)
    if cfg.mode == "DevMem":
        return ("DevMem", d)
    if cfg.mode == "DC":
        return ("DC", d, cfg.pcie.effective_bw, cfg.llc.capacity_pages,
                cfg.llc.hit_latency_ns, cfg.llc.hit_bw)
    return (cfg.mode, d, cfg.pcie.effective_bw)


def _dma_row_key(dma: DMAEngine) -> tuple:
    return ("dma", dma.descriptor_ns, dma.read_channels)


def _sa_row_key(sa: SystolicArray) -> tuple:
    return ("sa", sa.dtype, sa.w, sa.tile_w)


def _amount_row_key(cfg: SystemConfig) -> tuple:
    """Key of the SA/host/collective op-amount row: the SA variant plus
    the fabric (collective hops price on the fabric link)."""
    return (_sa_row_key(cfg.sa), cfg.fabric.row_key())


def _price_key(cfg: SystemConfig, foot: int) -> tuple:
    """Configs with equal keys produce identical results for any plan —
    the batch replays one representative per key."""
    return (_smmu_row_key(cfg.smmu, foot), _path_row_key(cfg),
            _dma_row_key(cfg.dma), _amount_row_key(cfg),
            cfg.dma.doorbell_ns, cfg.dma.interrupt_ns)


def _xlat_row(smmu: SMMU, cp, foot: int):
    """Per-access translation seconds + whole-trace (lookups, misses,
    walks) + the mask handles — ``SMMU.access_many``'s arithmetic
    without its state/counter side effects."""
    tlb_miss, miss_pos, walk_sub = smmu.tlb_walk_masks(cp.trace_ids,
                                                       cp.memo)
    cyc = np.full(cp.trace_ids.size, float(smmu.hit_cycles))
    cyc[miss_pos] += smmu.l2_fill_cycles
    cyc[miss_pos[walk_sub]] += smmu.walk_cycles(foot)
    stats = (int(cp.trace_ids.size), int(miss_pos.size),
             int(walk_sub.sum()))
    return cyc / smmu.freq, stats, (tlb_miss, miss_pos, walk_sub)


def _transfer_row(cfg: SystemConfig, cp, cache: dict = None) -> np.ndarray:
    """Per-access transfer seconds — ``_resolve_access_times``'s
    datapath arithmetic without touching the LLC object.  ``cache``
    (batched path) shares the per-access component arrays between path
    rows that differ only in one stage (e.g. LLC capacity)."""
    nb = cp.trace_nbytes
    if cache is None:
        cache = {}
    dbw = cfg.dram.bandwidth * cfg.dram.stream_efficiency
    mk = ("mem", cfg.dram.latency_ns, dbw)
    mem = cache.get(mk)
    if mem is None:
        mem = cache[mk] = cfg.dram.latency_ns * 1e-9 + nb / dbw
    if cfg.mode == "DevMem":
        return mem
    lk = ("link", cfg.pcie.effective_bw)
    link = cache.get(lk)
    if link is None:
        link = cache[lk] = nb / cfg.pcie.effective_bw
    lm = cache.get(("lm", lk, mk))
    if lm is None:
        lm = cache[("lm", lk, mk)] = link + mem
    if cfg.mode == "DC":
        prev, sd = _lru_trace_memo(cp.memo, cp.trace_ids)
        hit = (prev >= 0) & (sd < cfg.llc.capacity_pages)
        hk = ("llc", lk, cfg.llc.hit_latency_ns, cfg.llc.hit_bw)
        ht = cache.get(hk)
        if ht is None:
            llc_t = cfg.llc.hit_latency_ns * 1e-9 + nb / cfg.llc.hit_bw
            ht = cache[hk] = link * 0.25 + llc_t
        return np.where(hit, ht, lm)
    return lm


@dataclasses.dataclass
class _Rows:
    """One config's pricing rows — deduped, shared by reference.
    ``base`` (SA/host amounts, per SA key) and ``tc`` (DMA_OUT
    amounts, per path key) compose to ``val``; the plan path works on
    the components and leaves ``val`` unbuilt."""
    sk: tuple
    pk: tuple
    gk: tuple
    vk: tuple
    x: np.ndarray
    stats: tuple
    masks: tuple
    t: np.ndarray
    has_p: np.ndarray
    d: np.ndarray
    ready: np.ndarray
    base: np.ndarray
    tc: np.ndarray
    val: np.ndarray


def _batch_rows(cfgs, cp, foot: int, host_s_per_elem: float,
                need_val: bool = True,
                ready_carry: Optional[dict] = None) -> list:
    xrows: dict = {}
    trows: dict = {}
    grows: dict = {}
    vrows: dict = {}
    srows: dict = {}            # sk -> per-op translation sums
    prows: dict = {}            # pk -> per-op path sums
    brows: dict = {}            # sa key -> SA/host op-amount base
    drows: dict = {}            # dma key -> per-op descriptor time
    tinrows: dict = {}          # (dma, pk) -> masked input time
    sxmrows: dict = {}          # sk -> masked translation sum
    tcache: dict = {}
    out = []
    for cfg in cfgs:
        sk = _smmu_row_key(cfg.smmu, foot)
        pk = _path_row_key(cfg)
        gk = (sk, pk, _dma_row_key(cfg.dma))
        if sk not in xrows:
            xrows[sk] = _xlat_row(cfg.smmu, cp, foot)
            srows[sk] = _group_xlat_sum(cp, xrows[sk][0])
        if pk not in trows:
            trows[pk] = _transfer_row(cfg, cp, cache=tcache)
            prows[pk] = _group_path_sums(cp, trows[pk])
        x, stats, masks = xrows[sk]
        if gk not in grows:
            # ``_group_reduce``'s assembly, with the descriptor /
            # channel-limited-input / translation components shared at
            # their own key granularity (same float op order)
            npend, hp = _pending_counts(cp)
            dk = gk[2]
            d = drows.get(dk)
            if d is None:
                d = drows[dk] = (npend * cfg.dma.descriptor_time()
                                 / cfg.dma.read_channels)
            tinm = tinrows.get((dk, pk))
            if tinm is None:
                tot_t, lane_max, _ = prows[pk]
                tin = d + np.where(
                    cfg.dma.read_channels >= cp.n_lanes,
                    lane_max, tot_t)
                tinm = tinrows[dk, pk] = np.where(hp, tin, 0.0)
            sxm = sxmrows.get(sk)
            if sxm is None:
                sxm = sxmrows[sk] = np.where(hp, srows[sk], 0.0)
            if ready_carry is None:
                z = np.empty(2 * hp.size)
                z[0::2] = tinm
                z[1::2] = sxm
                ready = np.cumsum(z)[1::2]
            else:
                # continued cumsum: the carried partial sum becomes
                # the first element, so every addition happens in the
                # same left-to-right order as one monolithic cumsum —
                # the ready values (and the 0.0-carry first chunk)
                # stay bitwise identical to the unchunked pass
                z = np.empty(2 * hp.size + 1)
                z[0] = ready_carry.get(gk, 0.0)
                z[1::2] = tinm
                z[2::2] = sxm
                ready = np.cumsum(z)[2::2]
                if ready.size:
                    ready_carry[gk] = float(ready[-1])
            grows[gk] = (hp, d, srows[sk], ready, prows[pk][2])
        has_p, d, _, ready, _ = grows[gk]
        ak = _amount_row_key(cfg)
        vk = (ak, pk)
        if ak not in brows:
            brows[ak] = _op_amounts_base(cfg, cp, host_s_per_elem)
        if need_val and vk not in vrows:
            # tc depends only on the transfer row, so any gk with this
            # pk yields the same values
            vrows[vk] = _op_amounts(cfg, cp, prows[pk][2],
                                    host_s_per_elem, base=brows[ak])
        out.append(_Rows(sk, pk, gk, vk, x, stats, masks, trows[pk],
                         has_p, d, ready, brows[ak], prows[pk][2],
                         vrows.get(vk)))
    return out


def _run_ops_vec_batch(opk, has_p, ready, val, t_sa, t_out):
    """``_run_ops_vec`` with a leading config axis: the barrier layout
    (host ops / stream drains) is trace-intrinsic, so one pass over the
    segments prices every config at once — the per-segment closed forms
    become axis-1 cumulative sums, running maxima and gathers.  Per
    config row the float operations (and hence the results) are
    identical to the scalar vectorized recurrence."""
    B, n = val.shape
    tsa_a = np.empty((B, n))
    tout_a = np.empty((B, n))
    exp_a = np.zeros((B, n))
    t_sa = np.asarray(t_sa, np.float64).copy()
    t_out = np.asarray(t_out, np.float64).copy()
    barrier = np.nonzero((opk == P.OP_HOST) | (opk == P.OP_COLL)
                         | (opk == P.OP_TAIL))[0]
    starts = np.concatenate([[0], barrier + 1])
    ends = np.concatenate([barrier, [n]])
    for s0, s1 in zip(starts, ends):
        s0, s1 = int(s0), int(s1)
        if s1 > s0:
            k = opk[s0:s1]
            v = val[:, s0:s1]
            sa = np.nonzero(k == P.OP_SA)[0]
            out = np.nonzero(k == P.OP_OUT)[0]
            tsa_seg = None
            if sa.size:
                tiles = v[:, sa]
                pre = np.cumsum(tiles, axis=1)
                r = np.where(has_p[s0:s1][sa][None, :],
                             ready[:, s0:s1][:, sa], -np.inf)
                q = r - np.concatenate(
                    [np.zeros((B, 1)), pre[:, :-1]], axis=1)
                run = np.maximum.accumulate(q, axis=1)
                tsa_seg = pre + np.maximum(t_sa[:, None], run)
                prev_run = np.maximum(
                    t_sa[:, None],
                    np.concatenate([np.full((B, 1), -np.inf),
                                    run[:, :-1]], axis=1))
                exp_a[:, s0:s1][:, sa] = np.maximum(q - prev_run, 0.0)
            sa_cum = np.cumsum(k == P.OP_SA) - 1
            tsa_sl = np.where(
                sa_cum[None, :] >= 0,
                tsa_seg[:, np.maximum(sa_cum, 0)]
                if tsa_seg is not None else t_sa[:, None],
                t_sa[:, None])
            tout_seg = None
            if out.size:
                tcs = v[:, out]
                tcum = np.cumsum(tcs, axis=1)
                p = tsa_sl[:, out] - np.concatenate(
                    [np.zeros((B, 1)), tcum[:, :-1]], axis=1)
                tout_seg = tcum + np.maximum(
                    t_out[:, None], np.maximum.accumulate(p, axis=1))
            out_cum = np.cumsum(k == P.OP_OUT) - 1
            tout_sl = np.where(
                out_cum[None, :] >= 0,
                tout_seg[:, np.maximum(out_cum, 0)]
                if tout_seg is not None else t_out[:, None],
                t_out[:, None])
            tsa_a[:, s0:s1] = tsa_sl
            tout_a[:, s0:s1] = tout_sl
            t_sa = tsa_sl[:, -1].copy()
            t_out = tout_sl[:, -1].copy()
        if s1 < n:                           # the barrier op itself
            g = s1
            if has_p[g]:
                r = ready[:, g]
                m = r > t_sa
                exp_a[m, g] = (r - t_sa)[m]
                t_sa = np.where(m, r, t_sa)
            if opk[g] == P.OP_HOST or opk[g] == P.OP_COLL:
                t_sa = np.maximum(t_sa, t_out) + val[:, g]
            tsa_a[:, g] = t_sa
            tout_a[:, g] = t_out
    return tsa_a, tout_a, exp_a, t_sa, t_out


# ===================================================================
# Streaming chunked trace replay
# ===================================================================
# ``replay_trace`` materializes one CompiledPlan (plus its memoized
# stack-distance passes) for the whole trace — fine at 78k events,
# unaffordable at the multi-million-event traces an open-loop serving
# run produces.  The streamed path prices the trace chunk by chunk
# (chunks split only at plan boundaries, where the unconditional
# OP_TAIL pins a recurrence barrier) while carrying exact cross-chunk
# state: LRU stacks for the uTLB / L2-TLB / LLC (``LRUStreamState``
# prefix replay), the input-DMA ready cumsum per group key, the
# per-timeline (t_sa, t_out) max-plus frontier, and continued-cumsum
# bucket accumulators.  Every carried quantity reproduces the
# monolithic float operations in the same left-to-right order, so the
# results are bitwise identical to ``replay_trace`` at ANY chunk size
# while peak incremental allocations stay bounded by the chunk.

def _chain_sum(carry: float, arr: np.ndarray) -> float:
    """Left-to-right continued sum ``(((carry + a0) + a1) + ...)``.
    Unlike ``arr.sum()`` (pairwise), chaining per-chunk partial sums
    this way yields the same float no matter where the trace was
    chunked."""
    if arr.size == 0:
        return carry
    z = np.empty(arr.size + 1)
    z[0] = carry
    z[1:] = arr
    return float(np.cumsum(z)[-1])


class _TraceStream:
    """Cross-chunk carried state of one streamed trace replay."""

    def __init__(self, tes):
        self.lru = LRUStreamState()        # page-id LRU (uTLB + LLC)
        self.l2 = {te: LRUStreamState() for te in tes}
        self.tes = tes                     # distinct uTLB reaches
        self.ready = {}                    # gk -> ready cumsum carry
        self.tl = {}         # (gk, vk) -> [t_sa, t_out, last mks]
        self.keys = None                   # timeline key order
        self.chain = {}                    # bucket key -> chained sum
        self.stats = {}      # sk -> [lookups, misses, walks]
        self.n_out = 0
        self.n_events = 0
        self.macs = 0
        self.n_calls = []                  # per plan
        self.per = []        # per-chunk (timelines, plans) mks deltas


def _stream_seed_memo(cp, st: _TraceStream) -> None:
    """Seed a chunk's trace-intrinsic memo from the carried LRU state,
    so every downstream consumer (``tlb_walk_masks``, the LLC hit mask
    via ``_lru_trace_memo``) reads globally-exact prev/stack-distance
    arrays without knowing about chunking.  A no-op when the compile
    was already analyzed (the cached single-chunk path)."""
    if "prev" in cp.memo:
        return
    ids = cp.trace_ids
    prev, sd = st.lru.analyze(ids)
    cp.memo["prev"], cp.memo["sd"] = prev, sd
    for te in st.tes:
        miss = ~((prev >= 0) & (sd < te))
        mp = np.nonzero(miss)[0]
        sub_prev, sub_sd = st.l2[te].analyze(ids[mp])
        cp.memo[("l2", te)] = (mp, sub_prev, sub_sd)


def _stream_chunk(cfgs, cp, batch, foot: int, host_s_per_elem: float,
                  st: _TraceStream) -> None:
    """Price one compiled chunk for every config and fold the results
    into the carried accumulators."""
    _stream_seed_memo(cp, st)
    rows = _batch_rows(cfgs, cp, foot, host_s_per_elem,
                       ready_carry=st.ready)
    tl_idx, tl_rows = _unique_timelines(rows)
    keys = list(tl_idx)
    if st.keys is None:
        st.keys = keys
        for key in keys:
            st.tl[key] = [0.0, 0.0, 0.0]
    elif keys != st.keys:    # fixed cfgs+foot => chunk-invariant keys
        raise AssertionError("timeline keys changed across chunks")
    ready_m = np.stack([r.ready for r in tl_rows])
    val_m = np.stack([r.val for r in tl_rows])
    t_sa0 = np.array([st.tl[key][0] for key in keys])
    t_out0 = np.array([st.tl[key][1] for key in keys])
    tsa_a, tout_a, exp_a, tsa_f, tout_f = _run_ops_vec_batch(
        cp.op_kind, rows[0].has_p, ready_m, val_m, t_sa0, t_out0)
    # per-plan makespan deltas: every plan ends in an OP_TAIL barrier,
    # so chunk-local snapshots at plan bounds equal the monolithic ones
    mks = np.maximum(tsa_a, tout_a)
    mb = mks[:, cp.seg_op - 1]
    prevcol = np.array([st.tl[key][2] for key in keys])[:, None]
    st.per.append(np.diff(np.concatenate([prevcol, mb], axis=1),
                          axis=1))
    k = cp.op_kind
    done: set = set()
    for r in rows:
        tkey = (r.gk, r.vk)
        for key, arr in (
                (("c", r.vk[0]), r.base[k == P.OP_SA]),
                (("t", r.pk), r.t),
                (("d", r.gk), r.d[r.has_p]),
                (("x", r.sk), r.x),
                (("h",), r.base[k == P.OP_HOST]),
                (("l", r.vk[0]), r.base[k == P.OP_COLL]),
                (("e", tkey), exp_a[tl_idx[tkey]])):
            if key not in done:
                done.add(key)
                st.chain[key] = _chain_sum(st.chain.get(key, 0.0), arr)
        if ("s", r.sk) not in done:
            done.add(("s", r.sk))
            acc = st.stats.setdefault(r.sk, [0, 0, 0])
            for q in range(3):
                acc[q] += r.stats[q]
    for j, key in enumerate(keys):
        st.tl[key] = [float(tsa_f[j]), float(tout_f[j]),
                      float(mb[j, -1])]
    st.n_out += int((k == P.OP_OUT).sum())
    st.n_events += cp.n_events
    for pl in batch:
        st.macs += pl.macs
        st.n_calls.append(pl.n_calls)


def _stream_results(cfgs, st: _TraceStream, foot: int):
    """Per-config ``GemmResult``s + per-plan second arrays from a
    finished ``_TraceStream`` — the same assembly ``_result`` /
    ``_plan_batch_results`` perform, read off the carried
    accumulators."""
    per_all = np.concatenate(st.per, axis=1)
    n_calls = np.asarray(st.n_calls, np.float64)
    total_calls = int(n_calls.sum())
    tl_pos = {key: j for j, key in enumerate(st.keys)}
    results, pers = [], []
    for cfg in cfgs:
        sk = _smmu_row_key(cfg.smmu, foot)
        pk = _path_row_key(cfg)
        gk = (sk, pk, _dma_row_key(cfg.dma))
        vk = (_amount_row_key(cfg), pk)
        tkey = (gk, vk)
        tsa_f, tout_f, _ = st.tl[tkey]
        lk, ms, wk = st.stats[sk]
        ctrl_unit = (cfg.dma.doorbell_ns +
                     cfg.dma.interrupt_ns) * 1e-9
        results.append(GemmResult(
            total_s=max(tsa_f, tout_f) + total_calls * ctrl_unit,
            compute_s=st.chain[("c", vk[0])],
            transfer_s=st.chain[("t", pk)],
            exposed_transfer_s=st.chain[("e", tkey)],
            descriptor_s=st.chain[("d", gk)]
            + st.n_out * cfg.dma.descriptor_time(),
            translation_s=st.chain[("x", sk)],
            tlb_lookups=lk, tlb_misses=ms, ptw_walks=wk,
            macs=st.macs,
            host_s=st.chain[("h",)],
            drain_s=max(0.0, tout_f - tsa_f),
            coll_s=st.chain[("l", vk[0])]))
        pers.append(per_all[tl_pos[tkey]] + n_calls * ctrl_unit)
    return results, pers


def replay_trace_streamed(cfgs, plans,
                          host_s_per_elem: float = HOST_S_PER_ELEM,
                          footprint_pages: Optional[int] = None,
                          chunk_events: int = 262_144):
    """Price a (possibly very long) trace of plans in O(chunk) memory.

    ``cfgs`` is one ``SystemConfig`` or a sequence of them — every
    extra config reuses each chunk's trace analysis through the
    config-batched row dedup, so a DM/DC/DevMem sweep over a 10k-request
    trace costs one streaming pass.  ``plans`` is a sequence of
    repeat-1 ``StreamPlan``s, a repeat-1 ``PlanSchedule``, or a
    zero-argument callable returning a fresh plan iterable — the
    bounded-memory form: it is called once to measure the page
    footprint (skipped when ``footprint_pages`` is given) and once
    more to price, and at no point is more than one chunk of compiled
    arrays (plus the carried LRU state) live.

    Returns ``(results, per_plan)`` lists aligned with ``cfgs`` — or
    ``(result, per)`` when a single config was passed — bitwise
    identical to the monolithic ``replay_trace`` at ANY
    ``chunk_events`` (chunks split at plan boundaries; the carried
    LRU / ready / max-plus state reproduces the monolithic float
    operations in order)."""
    single = isinstance(cfgs, SystemConfig)
    cfg_list = [cfgs] if single else list(cfgs)
    if not cfg_list:
        raise ValueError("replay_trace_streamed() needs >= 1 config")
    if isinstance(plans, P.PlanSchedule):
        segs = plans.segments
        for pl, rep in segs:
            if rep != 1:
                raise ValueError(
                    f"replay_trace_streamed() needs repeat-1 "
                    f"segments, got ({pl.name}, {rep})")

        def factory():
            return (pl for pl, _ in segs)
    elif callable(plans):
        factory = plans
    else:
        seq = list(plans)

        def factory():
            return iter(seq)

    def checked():
        for pl in factory():
            if pl.sampled_steps != pl.total_steps:
                raise ValueError(
                    f"trace replay is exact; plan {pl.name} is "
                    "steady-state sampled")
            yield pl

    foot = footprint_pages if footprint_pages is not None \
        else P.trace_footprint(checked())
    # configs with equal price keys replay once, like replay_batch
    uniq: "OrderedDict[tuple, int]" = OrderedDict()
    slot = []
    reps = []
    for cfg in cfg_list:
        key = _price_key(cfg, foot)
        if key not in uniq:
            uniq[key] = len(reps)
            reps.append(cfg)
        slot.append(uniq[key])
    st = _TraceStream(sorted({c.smmu.tlb_entries for c in reps}))
    for cp, batch in P.compile_trace_chunks(checked(), chunk_events):
        _stream_chunk(reps, cp, batch, foot, host_s_per_elem, st)
    if st.keys is None:
        raise ValueError("replay_trace_streamed() needs >= 1 plan")
    rres, rper = _stream_results(reps, st, foot)
    results = [rres[s] if slot.count(s) == 1 else
               dataclasses.replace(rres[s]) for s in slot]
    pers = [rper[s] if slot.count(s) == 1 else rper[s].copy()
            for s in slot]
    if single:
        return results[0], pers[0]
    return results, pers


def _segment_bundle(cp):
    """Trace-intrinsic segment structure for the sums-only batched
    recurrence — barrier layout plus per-segment SA/OUT spans and the
    SA index preceding each OUT op — computed once per compiled plan
    and cached in its memo."""
    b = cp.memo.get("segb")
    if b is None:
        opk = cp.op_kind
        barrier = np.nonzero((opk == P.OP_HOST) | (opk == P.OP_COLL) |
                             (opk == P.OP_TAIL))[0]
        starts = np.concatenate([[0], barrier + 1])
        ends = np.concatenate([barrier, [opk.size]])
        sa_all = np.nonzero(opk == P.OP_SA)[0]
        out_all = np.nonzero(opk == P.OP_OUT)[0]
        cnt = np.cumsum(opk == P.OP_SA) - 1
        sa_lo = np.searchsorted(sa_all, starts)
        seg_of_out = np.searchsorted(starts, out_all,
                                     side="right") - 1
        idx_rel = cnt[out_all] - sa_lo[seg_of_out]
        b = (barrier, sa_all, out_all,
             sa_lo.tolist(), np.searchsorted(sa_all, ends).tolist(),
             np.searchsorted(out_all, starts).tolist(),
             np.searchsorted(out_all, ends).tolist(),
             np.maximum(idx_rel, 0), idx_rel < 0,
             ((opk[barrier] == P.OP_HOST) |
              (opk[barrier] == P.OP_COLL)).tolist())
        cp.memo["segb"] = b
    return b


_SCRATCH_POOL: dict = {}
_SCRATCH_CAP_BYTES = 512 << 20      # pool size that triggers a purge


def release_scratch() -> int:
    """Free the persistent batched-pricing scratch arrays and return
    the number of bytes released.  ``tune()`` calls this after its
    pricing phase so back-to-back searches don't hold each other's peak
    scratch; safe to call any time (the pool refills on demand)."""
    freed = sum(v.nbytes for v in _SCRATCH_POOL.values())
    _SCRATCH_POOL.clear()
    return freed


def _scratch(tag, shape):
    """Persistent scratch for the batched recurrence: the big
    (rows x positions) arrays exceed the allocator's mmap threshold,
    so reusing them across calls avoids a page-fault sweep per sweep.
    Callers fully overwrite every buffer they request.  The pool is
    bounded: allocating past ``_SCRATCH_CAP_BYTES`` purges it first
    (``release_scratch()`` frees it explicitly)."""
    a = _SCRATCH_POOL.get((tag, shape))
    if a is None:
        if sum(v.nbytes for v in _SCRATCH_POOL.values()) > \
                _SCRATCH_CAP_BYTES:
            _SCRATCH_POOL.clear()
        a = np.empty(shape)
        _SCRATCH_POOL[tag, shape] = a
    return a


def _run_ops_vec_batch_sums(cp, has_p, ready_rows, base_rows,
                            tc_rows, ir, ia, ip):
    """Sums-only leading-axis recurrence for the StreamPlan batch path.

    Same per-row float operations as ``_run_ops_vec`` (so per-config
    results match the sequential vectorized path), but materializes NO
    (rows × ops) trajectory arrays — only the exposed-transfer sum and
    the final timeline values each config needs.  SA/OUT positions are
    gathered globally once, so per-segment math runs on contiguous
    views; cumulative sums run on the unique component rows — op
    amounts at SA positions depend only on the SA key (``base_rows``),
    at OUT positions only on the path key (``tc_rows``), and at
    barrier ops on neither — and expand to the ``B`` timeline rows
    (``ir``/``ia``/``ip`` index maps) only for the coupled recurrence
    terms, keeping working sets cache-resident."""
    (barrier, sa_all, out_all, sa_lo, sa_hi, out_lo, out_hi,
     idx_clip, idx_neg, bar_host) = _segment_bundle(cp)
    A, Pk, R = len(base_rows), len(tc_rows), len(ready_rows)
    buf = _scratch
    base_sa = buf("base_sa", (A, sa_all.size))
    tc_out = buf("tc_out", (Pk, out_all.size))
    readys_sa = buf("readys_sa", (R, sa_all.size))
    for j, v in enumerate(base_rows):
        np.take(v, sa_all, out=base_sa[j])
    for j, v in enumerate(tc_rows):
        np.take(v, out_all, out=tc_out[j])
    for j, r in enumerate(ready_rows):
        np.take(r, sa_all, out=readys_sa[j])
    readys_sa[:, ~has_p[sa_all]] = -np.inf   # where(has_p, ready, -inf)
    B = ir.size
    n_sa = sa_all.size
    # prefix sums of the SA op amounts, restarted at each barrier,
    # materialized once over the full (compact) SA stream
    pre_full = buf("pre_full", (A, n_sa))
    sa_starts = []
    for i in range(len(sa_lo)):
        a0, a1 = sa_lo[i], sa_hi[i]
        if a1 > a0:
            sa_starts.append(a0)
            np.cumsum(base_sa[:, a0:a1], axis=1,
                      out=pre_full[:, a0:a1])
    sa_starts = np.asarray(sa_starts, dtype=np.int64)
    # fused expand + pre-subtraction into timeline rows: each column
    # is ready minus the prefix sum up to its previous SA op;
    # segment-start columns (no predecessor) keep the plain ready.
    # Per-segment views of this are consumed exactly once, in place.
    q_all = buf("q_all", (B, n_sa))
    for j in range(B):
        np.subtract(readys_sa[ir[j], 1:], pre_full[ia[j], :-1],
                    out=q_all[j, 1:])
        q_all[j, sa_starts] = readys_sa[ir[j], sa_starts]
    # barrier-op amounts are path independent but DO vary with the
    # amount row (collective hops price per fabric): expand per
    # timeline row via the base index map
    bar_val = np.stack([b[barrier] for b in base_rows])[ia]
    readys_bar = np.stack([r[barrier] for r in ready_rows])[ir]
    hp_bar = has_p[barrier].tolist()
    t_sa = np.zeros(B)
    t_out = np.zeros(B)
    exp_sum = np.zeros(B)

    # ``ia`` is sorted, so rows sharing a base cumsum row form
    # contiguous blocks the segment math can broadcast over
    blocks = []
    s = 0
    for j in range(1, B + 1):
        if j == B or ia[j] != ia[s]:
            blocks.append((s, j, int(ia[s])))
            s = j
    for i in range(len(sa_lo)):
        a0, a1 = sa_lo[i], sa_hi[i]
        o0, o1 = out_lo[i], out_hi[i]
        run = None
        if a1 > a0:
            m = a1 - a0
            q = q_all[:, a0:a1]
            # seeding col 0 with max(q_0, t_sa) makes the running max
            # max(t_sa, run) directly; the SA completion times are
            # pre + run, whose one-step increments are exactly the
            # exposed-transfer terms max(q_i - max(t_sa, run_{i-1}), 0)
            np.maximum(q[:, 0], t_sa, out=q[:, 0])
            run = np.maximum.accumulate(q, axis=1, out=q)
            e = buf("e", (B, m))
            np.subtract(run[:, 0], t_sa, out=e[:, 0])
            np.subtract(run[:, 1:], run[:, :-1], out=e[:, 1:])
            exp_sum += e.sum(axis=1)
            # pre + run is only ever read at the DMA_OUT wait columns
            # and the final column — gather there instead of another
            # full (rows x m) pass
        if o1 > o0:
            mo = o1 - o0
            tcum_u = np.cumsum(tc_out[:, o0:o1], axis=1,
                               out=buf("tcu", (Pk, mo)))
            tcum = np.take(tcum_u, ip, axis=0,
                           out=buf("tc", (B, mo)))
            p = buf("p", (B, mo))
            if run is not None:
                idx = a0 + idx_clip[o0:o1]
                np.take(run, idx_clip[o0:o1], axis=1, out=p)
                pre_idx = np.take(pre_full, idx, axis=1,
                                  out=buf("pre_idx", (A, mo)))
                for g0, g1, a in blocks:
                    p[g0:g1] += pre_idx[a]
                np.copyto(p, t_sa[:, None],
                          where=idx_neg[None, o0:o1])
            else:
                np.copyto(p, t_sa[:, None])
            p[:, 1:] -= tcum[:, :-1]         # p[:, 0] -= 0.0 is a no-op
            t_out = tcum[:, -1] + np.maximum(t_out, p.max(axis=1))
        if run is not None:
            t_sa = run[:, -1].copy()
            for g0, g1, a in blocks:
                t_sa[g0:g1] += pre_full[a, a1 - 1]
        if i < barrier.size:                 # the barrier op itself
            if hp_bar[i]:
                r = readys_bar[:, i]
                m = r > t_sa
                exp_sum += np.where(m, r - t_sa, 0.0)
                t_sa = np.where(m, r, t_sa)
            if bar_host[i]:
                t_sa = np.maximum(t_sa, t_out) + bar_val[:, i]
    return exp_sum, t_sa, t_out


def _unique_timelines(rows):
    """Configs sharing (group, op-amount) rows share one recurrence."""
    tl_idx: "OrderedDict[tuple, int]" = OrderedDict()
    tl_rows = []
    for r in rows:
        key = (r.gk, r.vk)
        if key not in tl_idx:
            tl_idx[key] = len(tl_rows)
            tl_rows.append(r)
    return tl_idx, tl_rows


def _unique_rows(tl_rows):
    """The unique ready (by group key), SA/host-amount (by SA key) and
    DMA_OUT-amount (by path key) rows among the timeline rows — kept
    as row lists; the recurrence gathers just the positions it needs —
    plus per-timeline index maps."""
    gk_ix: dict = {}
    ak_ix: dict = {}
    pk_ix: dict = {}
    ready_rows: list = []
    base_rows: list = []
    tc_rows: list = []
    ir, ia, ip = [], [], []
    for r in tl_rows:
        ak = r.vk[0]
        if r.gk not in gk_ix:
            gk_ix[r.gk] = len(ready_rows)
            ready_rows.append(r.ready)
        if ak not in ak_ix:
            ak_ix[ak] = len(base_rows)
            base_rows.append(r.base)
        if r.pk not in pk_ix:
            pk_ix[r.pk] = len(tc_rows)
            tc_rows.append(r.tc)
        ir.append(gk_ix[r.gk])
        ia.append(ak_ix[ak])
        ip.append(pk_ix[r.pk])
    return (ready_rows, base_rows, tc_rows, np.asarray(ir),
            np.asarray(ia), np.asarray(ip))


def _plan_batch_results(cfgs, rows, plan, cp, max_chunk_elems):
    k = cp.op_kind
    n_ops = int(k.size)
    scale = plan.total_steps / max(plan.sampled_steps, 1) \
        if plan.total_steps else 1.0
    n_out = int((k == P.OP_OUT).sum())
    has_p = rows[0].has_p
    _, tl_rows = _unique_timelines(rows)
    # group timelines sharing an SA base row so the recurrence can
    # broadcast each unique cumsum row over a contiguous row block
    tl_rows.sort(key=lambda r: r.vk[0])
    tl_idx = {(r.gk, r.vk): j for j, r in enumerate(tl_rows)}
    ready_rows, base_rows, tc_rows, ir_all, ia_all, ip_all = \
        _unique_rows(tl_rows)
    exp_sum = np.empty(len(tl_rows))
    t_sa = np.empty(len(tl_rows))
    t_out = np.empty(len(tl_rows))
    chunk = max(1, max_chunk_elems // max(n_ops, 1))
    for lo in range(0, len(tl_rows), chunk):
        B = len(tl_rows[lo:lo + chunk])
        es, ts, to = _run_ops_vec_batch_sums(
            cp, has_p, ready_rows, base_rows, tc_rows,
            ir_all[lo:lo + B], ia_all[lo:lo + B], ip_all[lo:lo + B])
        exp_sum[lo:lo + B] = es
        t_sa[lo:lo + B] = ts
        t_out[lo:lo + B] = to
    sums: dict = {}

    def row_sum(key, arr, mask=None):
        if key not in sums:
            sums[key] = float(arr.sum()) if mask is None \
                else float(arr[mask].sum())
        return sums[key]

    results = []
    for cfg, r in zip(cfgs, rows):
        ti = tl_idx[(r.gk, r.vk)]
        tsa_f, tout_f = float(t_sa[ti]), float(t_out[ti])
        lk, ms, wk = r.stats
        control = plan.n_calls * (cfg.dma.doorbell_ns +
                                  cfg.dma.interrupt_ns) * 1e-9
        results.append(GemmResult(
            total_s=max(tsa_f, tout_f) * scale + control,
            compute_s=row_sum(("c", r.vk[0]), r.base,
                              k == P.OP_SA) * scale,
            transfer_s=row_sum(("t", r.pk), r.t) * scale,
            exposed_transfer_s=float(exp_sum[ti]) * scale,
            descriptor_s=(row_sum(("d", r.gk), r.d, r.has_p)
                          + n_out * cfg.dma.descriptor_time()) * scale,
            translation_s=row_sum(("x", r.sk), r.x) * scale,
            tlb_lookups=int(lk * scale), tlb_misses=int(ms * scale),
            ptw_walks=int(wk * scale), macs=plan.macs,
            host_s=row_sum(("h",), r.base, k == P.OP_HOST) * scale,
            drain_s=max(0.0, tout_f - tsa_f) * scale,
            coll_s=row_sum(("l", r.vk[0]), r.base,
                           k == P.OP_COLL) * scale))
    return results


def _schedule_batch_results(cfgs, rows, sched, cp, max_chunk_elems):
    k = cp.op_kind
    n_ops = int(k.size)
    multi = any(rep > 1 for _, rep in sched.segments)
    has_p = rows[0].has_p
    if multi:
        k2 = np.concatenate([k, k])
        has_p2 = np.concatenate([has_p, has_p])
    else:
        k2, has_p2 = k, has_p
    bounds2 = np.concatenate([[0], cp.seg_op]) if not multi else \
        np.concatenate([[0], cp.seg_op, n_ops + cp.seg_op])

    def cum_at(per_item, bounds):
        c = np.concatenate([[0.0], np.cumsum(per_item)])
        return c[np.concatenate([[0], bounds])]

    look_c = np.concatenate([[0], cp.seg_trace]).astype(np.float64)
    tl_idx, tl_rows = _unique_timelines(rows)
    nb2 = int(bounds2.size)
    tsa_s = np.empty((len(tl_rows), nb2))
    tout_s = np.empty((len(tl_rows), nb2))
    exp_s = np.empty((len(tl_rows), nb2))
    n2 = 2 * n_ops if multi else n_ops
    chunk = max(1, max_chunk_elems // max(n2, 1))
    for lo in range(0, len(tl_rows), chunk):
        sub = tl_rows[lo:lo + chunk]
        B = len(sub)
        if multi:   # pass 1 = same ops, timeline continues
            ready = np.stack(
                [np.concatenate(
                    [r.ready,
                     r.ready + (r.ready[-1] if n_ops else 0.0)])
                 for r in sub])
            val = np.stack([np.concatenate([r.val, r.val])
                            for r in sub])
        else:
            ready = np.stack([r.ready for r in sub])
            val = np.stack([r.val for r in sub])
        tsa_a, tout_a, exp_a, _, _ = _run_ops_vec_batch(
            k2, has_p2, ready, val, np.zeros(B), np.zeros(B))
        z = np.zeros((B, 1))
        tsa_s[lo:lo + B] = np.concatenate([z, tsa_a],
                                          axis=1)[:, bounds2]
        tout_s[lo:lo + B] = np.concatenate([z, tout_a],
                                           axis=1)[:, bounds2]
        exp_s[lo:lo + B] = np.concatenate(
            [z, np.cumsum(exp_a, axis=1)], axis=1)[:, bounds2]
    cums: dict = {}

    def row_cum(key, fn):
        if key not in cums:
            cums[key] = fn()
        return cums[key]

    nseg = len(sched.segments)
    results = []
    for cfg, r in zip(cfgs, rows):
        ti = tl_idx[(r.gk, r.vk)]
        tsa_r, tout_r = tsa_s[ti], tout_s[ti]
        mks_s = np.maximum(tsa_r, tout_r)
        drain_snap = np.maximum(0.0, tout_r - tsa_r)
        exp_r = exp_s[ti]
        comp_c = row_cum(("c", r.vk), lambda: cum_at(
            np.where(k == P.OP_SA, r.val, 0.0), cp.seg_op))
        host_c = row_cum(("h", r.vk), lambda: cum_at(
            np.where(k == P.OP_HOST, r.val, 0.0), cp.seg_op))
        coll_c = row_cum(("l", r.vk), lambda: cum_at(
            np.where(k == P.OP_COLL, r.val, 0.0), cp.seg_op))
        desc_c = row_cum(("d", r.gk), lambda: cum_at(
            np.where(r.has_p, r.d, 0.0)
            + np.where(k == P.OP_OUT, cfg.dma.descriptor_time(), 0.0),
            cp.seg_op))
        xfer_c = row_cum(("t", r.pk),
                         lambda: cum_at(r.t, cp.seg_trace))
        trans_c = row_cum(("x", r.sk),
                          lambda: cum_at(r.x, cp.seg_trace))

        def miss_walk():
            tlb_miss, miss_pos, walk_sub = r.masks
            walk_mask = np.zeros(cp.trace_ids.size, bool)
            walk_mask[miss_pos[walk_sub]] = True
            return (cum_at(tlb_miss.astype(np.float64), cp.seg_trace),
                    cum_at(walk_mask.astype(np.float64), cp.seg_trace))

        miss_c, walk_c = row_cum(("mw", r.sk), miss_walk)

        def seg_delta(pass_no, si, pl):
            tb = pass_no * nseg + si    # timeline boundary index
            return (mks_s[tb + 1] - mks_s[tb],
                    comp_c[si + 1] - comp_c[si],
                    xfer_c[si + 1] - xfer_c[si],
                    exp_r[tb + 1] - exp_r[tb],
                    desc_c[si + 1] - desc_c[si],
                    trans_c[si + 1] - trans_c[si],
                    host_c[si + 1] - host_c[si],
                    coll_c[si + 1] - coll_c[si],
                    drain_snap[tb + 1] - drain_snap[tb],
                    look_c[si + 1] - look_c[si],
                    miss_c[si + 1] - miss_c[si],
                    walk_c[si + 1] - walk_c[si])

        acc, control, macs = _schedule_passes(
            (cfg.dma.doorbell_ns + cfg.dma.interrupt_ns) * 1e-9,
            sched.segments, seg_delta)
        results.append(_passes_result(acc, control, macs))
    return results


def replay_batch(cfgs, plan,
                 host_s_per_elem: float = HOST_S_PER_ELEM,
                 footprint_pages: Optional[int] = None,
                 max_chunk_elems: int = 32_000_000) -> list:
    """Price a batch of ``SystemConfig``s against ONE plan (or
    ``PlanSchedule``) in a single vectorized pass.

    Returns one ``GemmResult`` per config, in order, equal to what a
    sequential ``replay_compiled(cfg, plan)`` sweep returns (the
    per-config float operations are the same, so parity holds to
    rtol<=1e-9 on every field — asserted by the property suite).
    Pricing is PURE: unlike the sequential entry points the configs'
    SMMU/LLC objects are neither reset nor mutated, and the
    trace-intrinsic analysis cached on ``plan.compile().memo`` is
    shared across all of them.  ``max_chunk_elems`` bounds the
    (configs × ops) work matrices, chunking very large sweeps."""
    cfgs = list(cfgs)
    if not cfgs:
        return []
    cp = plan.compile()
    foot = plan.footprint_pages if footprint_pages is None \
        else footprint_pages
    # full-result dedup: a structured grid varies one knob at a time,
    # so many configs price identically — replay one representative
    uniq: "OrderedDict[tuple, int]" = OrderedDict()
    reps: list = []
    slot = []
    for cfg in cfgs:
        key = _price_key(cfg, foot)
        if key not in uniq:
            uniq[key] = len(reps)
            reps.append(cfg)
        slot.append(uniq[key])
    sched = isinstance(plan, P.PlanSchedule)
    rows = _batch_rows(reps, cp, foot, host_s_per_elem,
                       need_val=sched)
    if sched:
        ures = _schedule_batch_results(reps, rows, plan, cp,
                                       max_chunk_elems)
    else:
        ures = _plan_batch_results(reps, rows, plan, cp,
                                   max_chunk_elems)
    return [dataclasses.replace(ures[s]) for s in slot]


def simulate_gemm(cfg: SystemConfig, M: int, N: int, K: int,
                  dtype: Optional[str] = None,
                  max_steps: int = 400_000,
                  engine: Optional[str] = None) -> GemmResult:
    """Replay Algorithm 1 for one GEMM.  For very large problems the
    plan is built steady-state-sampled and scaled.  The plan itself is
    memoized (``gemm_plan_cached``) so benchmark sweeps stop rebuilding
    identical loop nests row after row."""
    dtype = dtype or cfg.sa.dtype
    np_name = P.np_dtype_for(dtype)
    counts = streaming.tile_counts(M, N, K, np_name,
                                   page_bytes=cfg.page_bytes)
    stride = max(1, counts["inner_steps"] // max_steps)
    plan = P.gemm_plan_cached(M, N, K, np_name,
                              page_bytes=cfg.page_bytes,
                              sample_stride=stride)
    return replay(cfg, plan, engine=engine)
