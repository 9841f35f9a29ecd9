"""Gem5-AcceSys analogue — component models.

Cycle-calibrated (not cycle-accurate) models of every box in the paper's
Fig. 1: the PCIe link with TLP packetization, the multi-channel DMA
engine, the SMMU (64-entry TLB + page walker), DRAM technologies
(Table 7), the LLC for DC mode, and the MatrixFlow systolic array
(Table 6). The pipeline simulator in ``pipeline.py`` composes them over
the tile schedule from ``core.streaming``.
"""
from __future__ import annotations

import collections
import dataclasses
import math

import numpy as np


# ---------------------------------------------------- batch LRU machinery
def prev_occurrence(ids: np.ndarray) -> np.ndarray:
    """``prev[i]`` = index of the previous access to ``ids[i]`` in the
    trace (-1 for a first access).  Vectorized: a stable argsort groups
    equal ids in access order, so each access's predecessor is its left
    neighbour within its group."""
    n = int(ids.size)
    prev = np.full(n, -1, np.int64)
    if n == 0:
        return prev
    order = np.argsort(ids, kind="stable")
    si = ids[order]
    same = si[1:] == si[:-1]
    prev[order[1:][same]] = order[:-1][same]
    return prev


def lru_stack_distances(prev: np.ndarray) -> np.ndarray:
    """Exact LRU stack distance of every access, in one vectorized
    divide-and-conquer pass over the trace.

    ``sd[i]`` = number of DISTINCT ids touched strictly between access
    ``i`` and the previous access to the same id (``n`` — effectively
    infinite — for first accesses).  A move-to-front LRU of capacity C
    hits access ``i`` iff ``prev[i] >= 0 and sd[i] < C``, so this one
    trace-intrinsic pass prices every cache in the hierarchy (uTLB,
    L2 TLB, LLC) at once.

    Method: an access ``j`` is the first in-window touch of its id iff
    its own previous access predates the window, so
    ``sd[i] = #{j in (prev[i], i) : prev[j] <= prev[i]}``.  That count
    is accumulated by merge-sort D&C over ``prev``: at each level every
    still-active access sitting in the right half of its pair-block
    ranks, via one global ``searchsorted`` into the block-sorted left
    halves, the in-window ``j`` it gains from the left half.  The level
    at which the window start enters the block is an access's last
    contribution (the ``j <= prev[i]`` overcount is subtracted in
    closed form — every such ``j`` satisfies ``prev[j] < j``), so the
    active set shrinks as reuse distances resolve and the sweep stops
    as soon as none remain.
    """
    n = int(prev.size)
    sd = np.full(n, n, np.int64)
    if n == 0:
        return sd
    act = np.nonzero(prev >= 0)[0]
    sd[act] = 0
    if act.size == 0:
        return sd
    nbits = max(1, int(n - 1).bit_length())
    size = 1 << nbits
    big = np.int64(n + 2)
    a = np.full(size, n + 1, np.int32)          # sort keys; pad = +inf
    a[:n] = (prev + 1).astype(np.int32)
    thr = prev[act] + 1
    for lev in range(nbits):
        block = np.int64(1 << lev)
        pair = block << 1
        on_right = (act & block) != 0
        if np.any(on_right):
            q = act[on_right]
            pid = q >> (lev + 1)
            if block <= 16:
                # tiny left blocks: rank by direct gathered compares —
                # cheaper than a global searchsorted at the dense levels
                gath = a.reshape(-1, pair)[:, :block][pid]
                cnt = (gath <= thr[on_right][:, None]).sum(
                    axis=1, dtype=np.int64)
            else:
                left = a.reshape(-1, pair)[:, :block].astype(np.int64)
                left += (np.arange(left.shape[0], dtype=np.int64)
                         * big)[:, None]
                cnt = np.searchsorted(left.ravel(),
                                      pid * big + thr[on_right],
                                      side="right") - pid * block
            pstart = q & ~(pair - 1)
            pq = prev[q]
            crossed = pq >= pstart
            cnt[crossed] -= pq[crossed] - pstart[crossed] + 1
            sd[q] += cnt
            live = ~crossed
            act = np.concatenate([act[~on_right], q[live]])
            thr = np.concatenate([thr[~on_right], thr[on_right][live]])
            if act.size == 0:
                break                            # all reuses resolved
        a = np.sort(a.reshape(-1, int(pair)), axis=1,
                    kind="stable").ravel()
    return sd


def _lru_trace_memo(memo, ids):
    """Trace-intrinsic (parameter-independent) prev/stack-distance
    arrays, cached in ``memo`` across replays of the same trace."""
    if "prev" not in memo:
        memo["prev"] = prev_occurrence(ids)
        memo["sd"] = lru_stack_distances(memo["prev"])
    return memo["prev"], memo["sd"]


def _mru_ids(memo, key, ids):
    """Distinct ids of a trace ordered oldest-to-newest by last touch —
    trace-intrinsic, so cached in ``memo`` like the stack distances."""
    if key not in memo:
        uniq, ridx = np.unique(ids[::-1], return_index=True)
        memo[key] = uniq[np.argsort(ids.size - 1 - ridx)]
    return memo[key]


def _rebuild_lru_state(od, mru, keys, cap):
    """Reconstruct the OrderedDict an equivalent sequential sweep would
    leave behind: the ``cap`` most-recently-used distinct ids, oldest
    first."""
    od.clear()
    if keys is None:
        return
    for pid in mru[-cap:].tolist():
        od[keys[pid]] = True


def _mru_of(ids):
    """Distinct ids of ``ids`` ordered LRU -> MRU (oldest last touch
    first) — the complete LRU state any capacity's stack leaves behind."""
    if ids.size == 0:
        return np.empty(0, ids.dtype)
    uniq, ridx = np.unique(ids[::-1], return_index=True)
    return uniq[np.argsort(ids.size - 1 - ridx)]


class LRUStreamState:
    """Resumable exact LRU analysis for a trace processed in chunks.

    Carries the distinct ids seen so far in LRU->MRU order.  For each
    chunk, the carried ids are prefix-replayed in front of the chunk
    (one access each, oldest first): any chunk access whose previous
    occurrence falls before the chunk start then hits its carried id at
    exactly the stack distance the monolithic trace would have produced
    (the carried prefix IS the LRU stack at the chunk boundary, so the
    distinct-ids-since-last-touch count is preserved for EVERY
    capacity at once).  First-ever accesses keep ``prev == -1``.  The
    per-chunk ``(prev, sd)`` slices are therefore bitwise-equal to the
    corresponding slices of a single whole-trace analysis wherever a
    consumer tests ``(prev >= 0) & (sd < capacity)`` — prev indices
    that point into the replayed prefix stay ``>= 0``, which is all the
    hit/miss masks ever read.

    The empty-carry path returns the chunk's own arrays unmodified, so
    a single-chunk stream is literally the monolithic computation.
    """

    __slots__ = ("mru",)

    def __init__(self):
        self.mru = np.empty(0, np.int64)

    def analyze(self, ids):
        """(prev, sd) for ``ids`` as the monolithic trace would see
        them; advances the carried LRU state past this chunk."""
        m = int(self.mru.size)
        ext = ids if m == 0 else \
            np.concatenate([self.mru.astype(ids.dtype, copy=False), ids])
        prev = prev_occurrence(ext)
        sd = lru_stack_distances(prev)
        self.mru = _mru_of(ext)
        return (prev, sd) if m == 0 else (prev[m:], sd[m:])

# ----------------------------------------------------------------- SA
# Table 6 (post-synthesis PPA; fixed-point @1 GHz, floating @0.6 GHz)
SA_VARIANTS = {
    # name: (freq_hz, area_um2, power_mw, peak_gops)
    ("int8", 4): (1.0e9, 16_186, 7.464, 32.0),
    ("int8", 16): (1.0e9, 186_875, 84.550, 512.0),
    ("int16", 4): (1.0e9, 24_989, 11.813, 32.0),
    ("int16", 16): (1.0e9, 397_558, 149.419, 512.0),
    ("int32", 4): (1.0e9, 73_483, 33.302, 32.0),
    ("int32", 16): (1.0e9, 1_163_841, 392.978, 512.0),
    ("fp8", 4): (0.6e9, 8_806, 2.251, 19.2),
    ("fp8", 16): (0.6e9, 142_816, 34.557, 307.2),
    ("fp16", 4): (0.6e9, 22_802, 5.580, 19.2),
    ("fp16", 16): (0.6e9, 363_805, 83.655, 307.2),
    ("fp32", 4): (0.6e9, 62_693, 16.938, 19.2),
    ("fp32", 16): (0.6e9, 1_032_820, 258.173, 307.2),
}

DTYPE_BYTES = {"int8": 1, "int16": 2, "int32": 4,
               "fp8": 1, "fp16": 2, "fp32": 4}


def sa_variant(dtype: str, w: int) -> tuple:
    """(freq_hz, area_um2, power_mw, peak_gops) for a W×W array.

    Widths in Table 6 are returned verbatim.  Other widths follow the
    table's own scaling: frequency is set by the MAC pipeline (the
    dtype), not the width; peak = 2·W² MACs/cycle; area and power obey
    the power law the two synthesized points define (log-log
    interpolation, anchored at W=16 so the paper baseline is exact)."""
    v = SA_VARIANTS.get((dtype, w))
    if v is not None:
        return v
    lo = SA_VARIANTS[(dtype, 4)]
    hi = SA_VARIANTS[(dtype, 16)]
    freq = hi[0]

    def powlaw(a4: float, a16: float) -> float:
        alpha = math.log(a16 / a4) / math.log(4.0)
        return a16 * (w / 16.0) ** alpha

    return (freq, powlaw(lo[1], hi[1]), powlaw(lo[2], hi[2]),
            2.0 * w * w * freq / 1e9)


@dataclasses.dataclass(frozen=True)
class SystolicArray:
    """MatrixFlow-style output-stationary W×W array.  ``tile_w`` is the
    row-block size the plan layer streams (``paging.SA_DIM``): an array
    narrower than the streamed tile sweeps it in ``ceil(tile_w/w)²``
    output-stationary passes, so pricing a 16-row-tiled plan on an
    8×8 array honestly charges 4 passes per tile instead of pretending
    the tile fits."""
    dtype: str = "int8"
    w: int = 16
    tile_w: int = 16               # streamed tile rows (paging.SA_DIM)

    @property
    def freq(self) -> float:
        return sa_variant(self.dtype, self.w)[0]

    @property
    def area_um2(self) -> float:
        return sa_variant(self.dtype, self.w)[1]

    @property
    def power_mw(self) -> float:
        return sa_variant(self.dtype, self.w)[2]

    @property
    def peak_gops(self) -> float:
        return sa_variant(self.dtype, self.w)[3]

    @property
    def passes(self) -> int:
        """Output-stationary sweeps needed per streamed tile."""
        return (-(-self.tile_w // self.w)) ** 2

    def tile_cycles(self, l: int) -> int:
        """One streamed tile over depth l: passes × (l + fill/drain)."""
        return self.passes * (l + 2 * (self.w - 1))

    def tile_time(self, l: int) -> float:
        return self.tile_cycles(l) / self.freq


# ---------------------------------------------------------------- PCIe
@dataclasses.dataclass(frozen=True)
class PCIeLink:
    """lanes × gbps_per_lane with TLP packetization effects (Fig. 10).

    efficiency(packet): payload / (payload + header) captures the 64 B
    penalty; an on-chip TLP pipeline depth limits outstanding packets, so
    very large TLPs (4096 B) stall the pipeline when serialization time
    exceeds the window — worst at low link speeds (paper: +36 %)."""
    lanes: int = 16
    gbps_per_lane: float = 64.0      # Gen6 ×16 = 128 GB/s (paper baseline)
    packet_bytes: int = 256
    header_bytes: int = 26          # TLP+DLLP+framing overhead
    pipeline_ns: float = 180.0      # per-TLP processing window
    encoding: float = 128.0 / 130.0

    @property
    def raw_bw(self) -> float:      # B/s, one direction
        return self.lanes * self.gbps_per_lane * 1e9 / 8 * self.encoding

    def efficiency(self) -> float:
        p = self.packet_bytes
        payload_eff = p / (p + self.header_bytes)
        # serialization of one TLP vs the pipeline window: once a packet
        # takes longer than the window, the link pipeline bubbles
        ser_ns = (p + self.header_bytes) / self.raw_bw * 1e9
        stall = max(0.0, ser_ns - self.pipeline_ns) / max(ser_ns, 1e-9)
        return payload_eff * (1.0 - 0.55 * stall)

    @property
    def effective_bw(self) -> float:
        return self.raw_bw * self.efficiency()

    def transfer_time(self, nbytes: int) -> float:
        return nbytes / self.effective_bw


# -------------------------------------------------------------- fabric
FABRIC_TOPOLOGIES = ("ring", "alltoall")


@dataclasses.dataclass(frozen=True)
class Fabric:
    """Inter-device interconnect for multi-device sharded plans: p
    symmetric accelerators joined by dedicated PCIe-class links (one
    per neighbour, separate from the host<->device streaming link), a
    topology that decides how a collective decomposes into per-hop
    transfers at plan-build time (``core.multidev``), and a per-hop
    launch latency.  Timing reuses the PCIeLink model verbatim: one
    collective hop of B bytes costs ``hop_time(B)`` on the rank's own
    fabric lane."""
    link: PCIeLink = PCIeLink()
    topology: str = "ring"          # ring | alltoall
    hop_latency_ns: float = 500.0   # per-hop launch/sync latency

    def __post_init__(self):
        if self.topology not in FABRIC_TOPOLOGIES:
            raise ValueError(
                f"unknown fabric topology {self.topology!r}; valid: "
                f"{FABRIC_TOPOLOGIES}")

    def hop_time(self, nbytes) -> float:
        """One inter-device hop: link serialization + launch latency
        (vectorizes over an nbytes array, like the replayer's paths)."""
        return nbytes / self.link.effective_bw \
            + self.hop_latency_ns * 1e-9

    def row_key(self) -> tuple:
        """The pricing-relevant identity (topology acts at plan build,
        not at pricing) — part of the batched replayer's row dedup."""
        return ("fab", self.link.effective_bw, self.hop_latency_ns)


# ---------------------------------------------------------------- DRAM
# Table 7: tech -> (channels, data_width_bits, bandwidth B/s, data rate)
DRAM_TECH = {
    "DDR3": (1, 64, 12.8e9, 1600),
    "DDR4": (1, 64, 19.2e9, 2400),
    "DDR5": (2, 32, 25.6e9, 3200),
    "GDDR6": (2, 64, 32.0e9, 2000),
    "HBM2": (2, 128, 64.0e9, 2000),
}


@dataclasses.dataclass(frozen=True)
class DRAM:
    tech: str = "DDR3"
    latency_ns: float = 12.0
    stream_efficiency: float = 0.87     # bank/queueing losses on bursts

    @property
    def bandwidth(self) -> float:
        return DRAM_TECH[self.tech][2]

    def transfer_time(self, nbytes: int) -> float:
        return self.latency_ns * 1e-9 + \
            nbytes / (self.bandwidth * self.stream_efficiency)


# ---------------------------------------------------------------- SMMU
@dataclasses.dataclass
class SMMU:
    """Two-level TLB + walk cache + page walker (Table 8).

    The 64-entry uTLB backs onto a larger L2 TLB: most uTLB misses fill
    from L2 / the walk cache in ~10–25 cycles (the paper's mean
    translation times), and only L2 misses pay a full multi-level walk
    (~180–368 cycles, deeper as the footprint outgrows the reach)."""
    tlb_entries: int = 64
    l2_entries: int = 8192
    l2_fill_cycles: float = 12.0
    base_walk_cycles: float = 180.0     # few-page working sets
    deep_walk_cycles: float = 368.0     # >reach thrash regime
    freq: float = 1.0e9
    hit_cycles: float = 1.0

    def __post_init__(self):
        self._tlb: "collections.OrderedDict" = collections.OrderedDict()
        self._l2: "collections.OrderedDict" = collections.OrderedDict()
        self.lookups = 0
        self.misses = 0
        self.walks = 0

    def reset(self):
        self._tlb.clear()
        self._l2.clear()
        self.lookups = self.misses = self.walks = 0

    def walk_cycles(self, footprint_pages: int) -> float:
        if footprint_pages <= self.l2_entries:
            return self.base_walk_cycles
        scale = min(1.0, math.log2(footprint_pages / self.l2_entries) / 3.0)
        return self.base_walk_cycles + scale * (self.deep_walk_cycles -
                                                self.base_walk_cycles)

    def _touch(self, cache, key, cap) -> bool:
        if key in cache:
            cache.move_to_end(key)
            return True
        cache[key] = True
        while len(cache) > cap:
            cache.popitem(last=False)
        return False

    def access(self, page_id, footprint_pages: int) -> float:
        """Translate one page access; returns seconds."""
        self.lookups += 1
        if self._touch(self._tlb, page_id, self.tlb_entries):
            return self.hit_cycles / self.freq
        self.misses += 1
        if self._touch(self._l2, page_id, self.l2_entries):
            return (self.hit_cycles + self.l2_fill_cycles) / self.freq
        self.walks += 1
        return (self.hit_cycles + self.l2_fill_cycles +
                self.walk_cycles(footprint_pages)) / self.freq

    # ------------------------------------------------------ batch path
    def tlb_walk_masks(self, ids: np.ndarray, memo: dict):
        """(uTLB-miss mask over the trace, walk mask over the uTLB-miss
        subsequence) — the exact hit/miss sequence a sequential sweep
        from reset state would produce, computed from the trace's stack
        distances.  ``memo`` caches the trace-intrinsic arrays; only
        the capacity comparisons depend on this SMMU's parameters."""
        prev, sd = _lru_trace_memo(memo, ids)
        tlb_miss = ~((prev >= 0) & (sd < self.tlb_entries))
        key = ("l2", self.tlb_entries)
        if key not in memo:
            miss_pos = np.nonzero(tlb_miss)[0]
            sub_prev = prev_occurrence(ids[miss_pos])
            memo[key] = (miss_pos, sub_prev,
                         lru_stack_distances(sub_prev))
        miss_pos, sub_prev, sub_sd = memo[key]
        walk_sub = ~((sub_prev >= 0) & (sub_sd < self.l2_entries))
        return tlb_miss, miss_pos, walk_sub

    def access_many(self, ids: np.ndarray, footprint_pages: int,
                    memo: dict, keys=None) -> np.ndarray:
        """Batch counterpart of ``access`` over a whole interned page-id
        trace: per-access translation seconds, identical to a sequential
        sweep from reset state (counters updated; final LRU state
        reconstructed when ``keys`` maps ids back to page keys)."""
        if self._tlb or self._l2:
            raise RuntimeError("access_many requires reset SMMU state")
        tlb_miss, miss_pos, walk_sub = self.tlb_walk_masks(ids, memo)
        self.lookups += int(ids.size)
        self.misses += int(miss_pos.size)
        self.walks += int(walk_sub.sum())
        # one cached per-access time array, replaced when the SMMU
        # parameters change — mode sweeps over one config reuse it,
        # parameter sweeps do not accumulate one array per config
        tkey = (self.tlb_entries, self.l2_entries, self.hit_cycles,
                self.l2_fill_cycles, self.freq,
                self.walk_cycles(footprint_pages))
        if memo.get("xlat", (None,))[0] != tkey:
            cyc = np.full(ids.size, float(self.hit_cycles))
            cyc[miss_pos] += self.l2_fill_cycles
            cyc[miss_pos[walk_sub]] += self.walk_cycles(footprint_pages)
            memo["xlat"] = (tkey, cyc / self.freq)
        _rebuild_lru_state(self._tlb, _mru_ids(memo, "mru", ids), keys,
                           self.tlb_entries)
        _rebuild_lru_state(self._l2,
                           _mru_ids(memo, ("mru_l2", self.tlb_entries),
                                    ids[miss_pos]),
                           keys, self.l2_entries)
        return memo["xlat"][1]


# ---------------------------------------------------------------- DMA
@dataclasses.dataclass(frozen=True)
class DMAEngine:
    read_channels: int = 2
    write_channels: int = 2
    burst_bytes: int = 1024
    descriptor_ns: float = 45.0     # enqueue+fetch one descriptor
    doorbell_ns: float = 400.0      # MMIO write (per offloaded call)
    interrupt_ns: float = 4000.0    # MSI + IRQ + driver completion

    def descriptor_time(self) -> float:
        return self.descriptor_ns * 1e-9


# ---------------------------------------------------------------- LLC
@dataclasses.dataclass
class LLC:
    """Shared last-level cache for DC mode, page-granular LRU."""
    size_bytes: int = 2 * 1024 * 1024
    page_bytes: int = 4096
    hit_latency_ns: float = 18.0
    hit_bw: float = 64e9

    def __post_init__(self):
        self._lru: "collections.OrderedDict" = collections.OrderedDict()
        self.hits = 0
        self.misses = 0

    @property
    def capacity_pages(self) -> int:
        return self.size_bytes // self.page_bytes

    def reset(self):
        self._lru.clear()
        self.hits = self.misses = 0

    def access(self, page_id) -> bool:
        """Returns hit?"""
        if page_id in self._lru:
            self.hits += 1
            self._lru.move_to_end(page_id)
            return True
        self.misses += 1
        self._lru[page_id] = True
        while len(self._lru) > self.capacity_pages:
            self._lru.popitem(last=False)
        return False

    def hit_time(self, nbytes: int) -> float:
        return self.hit_latency_ns * 1e-9 + nbytes / self.hit_bw

    # ------------------------------------------------------ batch path
    def access_many(self, ids: np.ndarray, memo: dict,
                    keys=None) -> np.ndarray:
        """Batch counterpart of ``access``: the exact hit mask of a
        sequential sweep from reset state, from the same trace-intrinsic
        stack distances the SMMU pass uses (one ``memo`` per trace
        serves the whole component hierarchy)."""
        if self._lru:
            raise RuntimeError("access_many requires reset LLC state")
        prev, sd = _lru_trace_memo(memo, ids)
        hit = (prev >= 0) & (sd < self.capacity_pages)
        nh = int(hit.sum())
        self.hits += nh
        self.misses += int(ids.size) - nh
        _rebuild_lru_state(self._lru, _mru_ids(memo, "mru", ids), keys,
                           self.capacity_pages)
        return hit
