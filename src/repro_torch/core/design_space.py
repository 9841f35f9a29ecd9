"""Co-design knob space for the system-accelerator search.

The paper's headline configuration — 16×16 SA, 4 KB pages, ~20 KB of
on-chip buffering, PCIe attach — is one point in the space Gem5-AcceSys
was built to explore.  A ``DesignPoint`` names one candidate along the
axes the component models price mechanistically (SA dimension, page
bytes, on-chip buffer budget, uTLB/L2-TLB reach, LLC capacity, memory
mode, PCIe lanes+generation, datatype); ``system_for_point`` lowers it
to an accesys ``SystemConfig`` and ``point_area_um2`` to the silicon
area proxy the Pareto frontier trades latency against.

``DesignSpace.grid()`` / ``.sample()`` enumerate candidates with the
infeasible ones (double-buffered pages + output tile no longer fit the
buffer budget) filtered out; ``scenario.tune`` prices a whole space
against one workload in a single config-batched replay.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Iterable, Iterator, Optional, Sequence

from repro_torch.accesys.components import (DMAEngine, DRAM, DRAM_TECH, LLC,
                                            PCIeLink, SMMU, SystolicArray,
                                            sa_variant)
from repro_torch.accesys.pipeline import SystemConfig
from repro_torch.core import paging
from repro_torch.core.plan import ELEM_BYTES

# PCIe per-lane signalling rates (gbps) by generation
PCIE_GEN_GBPS = {3: 8.0, 4: 16.0, 5: 32.0, 6: 64.0}

# single-port SRAM area proxy (um^2 per byte, ~7 nm class) for the
# on-chip buffer — coarse, but it only has to rank buffer budgets
SRAM_UM2_PER_BYTE = 0.35

# accumulator width: the paper's SA keeps 32-bit partial sums
ACC_BYTES = 4


@dataclasses.dataclass(frozen=True)
class DesignPoint:
    """One co-design candidate.  The defaults ARE the paper point —
    ``system_for_point(DesignPoint())`` equals ``default_system()``."""
    sa_w: int = 16                 # systolic array dimension (W x W)
    page_bytes: int = paging.PAGE_BYTES
    buffer_kb: int = 20            # on-chip staging SRAM budget
    tlb_entries: int = 64          # SMMU uTLB reach
    l2_entries: int = 8192         # SMMU L2 TLB reach
    llc_kb: int = 2048             # host LLC carve-out (DC mode)
    mode: str = "DC"               # DM | DC | DevMem
    pcie_lanes: int = 16
    pcie_gen: int = 6
    dtype: str = "int8"
    devmem_dram: str = "HBM2"      # DRAM tech for DevMem mode

    @property
    def required_buffer_kb(self) -> float:
        """Double-buffered A/B page staging plus one accumulator tile:
        the minimum SRAM the streaming schedule needs (the paper's
        16x16 / 4 KB point needs ~18 KB -> the 20 KB default)."""
        return (2 * 2 * self.page_bytes
                + 2 * self.sa_w * self.sa_w * ACC_BYTES) / 1024

    @property
    def feasible(self) -> bool:
        return self.buffer_kb >= self.required_buffer_kb

    def canonical(self) -> "DesignPoint":
        """Collapse don't-care axes so grid dedup (and the batched
        replayer's own config dedup) see identical points: DevMem DRAM
        tech only exists in DevMem mode, the LLC carve-out only in DC."""
        p = self
        if p.mode != "DevMem" and p.devmem_dram != "HBM2":
            p = dataclasses.replace(p, devmem_dram="HBM2")
        if p.mode != "DC" and p.llc_kb != 2048:
            p = dataclasses.replace(p, llc_kb=2048)
        return p

    def label(self) -> str:
        s = (f"{self.sa_w}x{self.sa_w}/{self.dtype} "
             f"pg{self.page_bytes // 1024}K buf{self.buffer_kb}K "
             f"tlb{self.tlb_entries} {self.mode}")
        if self.mode == "DC":
            s += f" llc{self.llc_kb}K"
        if self.mode == "DevMem":
            s += f" {self.devmem_dram}"
        s += f" x{self.pcie_lanes}g{self.pcie_gen}"
        return s


def system_for_point(p: DesignPoint) -> SystemConfig:
    """Lower a design point to the accesys component stack."""
    if p.mode not in ("DM", "DC", "DevMem"):
        raise ValueError(f"unknown memory mode {p.mode!r}")
    if p.dtype not in ELEM_BYTES:
        raise ValueError(f"unknown dtype {p.dtype!r}")
    if p.pcie_gen not in PCIE_GEN_GBPS:
        raise ValueError(f"unknown PCIe generation {p.pcie_gen!r}")
    if p.devmem_dram not in DRAM_TECH:
        raise ValueError(f"unknown DRAM tech {p.devmem_dram!r}")
    dram = DRAM(p.devmem_dram) if p.mode == "DevMem" else DRAM("DDR3")
    return SystemConfig(
        sa=SystolicArray(dtype=p.dtype, w=p.sa_w,
                         tile_w=paging.SA_DIM),
        pcie=PCIeLink(lanes=p.pcie_lanes,
                      gbps_per_lane=PCIE_GEN_GBPS[p.pcie_gen]),
        dram=dram,
        dma=DMAEngine(),
        smmu=SMMU(tlb_entries=p.tlb_entries, l2_entries=p.l2_entries),
        llc=LLC(size_bytes=p.llc_kb * 1024, page_bytes=p.page_bytes),
        mode=p.mode,
        page_bytes=p.page_bytes)


def point_area_um2(p: DesignPoint) -> float:
    """Accelerator-silicon area proxy: SA macro (synthesis-calibrated
    power law over W) + staging SRAM.  Host-side LLC/TLB are not the
    accelerator's silicon and stay out of the proxy."""
    return sa_variant(p.dtype, p.sa_w)[1] \
        + SRAM_UM2_PER_BYTE * p.buffer_kb * 1024


@dataclasses.dataclass(frozen=True)
class DesignSpace:
    """Cartesian knob space.  ``grid()`` enumerates the feasible
    canonical points (duplicates from don't-care axes removed);
    ``sample(n, seed)`` draws a random feasible subset."""
    sa_w: Sequence[int] = (4, 8, 16, 32)
    page_bytes: Sequence[int] = (1024, 4096, 16384)
    buffer_kb: Sequence[int] = (20, 72, 132)
    tlb_entries: Sequence[int] = (16, 64, 256)
    l2_entries: Sequence[int] = (8192,)
    llc_kb: Sequence[int] = (2048,)
    mode: Sequence[str] = ("DM", "DC", "DevMem")
    pcie_lanes: Sequence[int] = (16,)
    pcie_gen: Sequence[int] = (6,)
    dtype: Sequence[str] = ("int8",)
    devmem_dram: Sequence[str] = ("HBM2",)

    _AXES = ("sa_w", "page_bytes", "buffer_kb", "tlb_entries",
             "l2_entries", "llc_kb", "mode", "pcie_lanes", "pcie_gen",
             "dtype", "devmem_dram")

    def grid(self) -> Iterator[DesignPoint]:
        seen = set()
        axes = [getattr(self, a) for a in self._AXES]
        for combo in itertools.product(*axes):
            p = DesignPoint(**dict(zip(self._AXES, combo))).canonical()
            if p.feasible and p not in seen:
                seen.add(p)
                yield p

    def sample(self, n: int, seed: int = 0) -> list:
        import numpy as np
        rng = np.random.default_rng(seed)
        axes = [getattr(self, a) for a in self._AXES]
        out, seen, tries = [], set(), 0
        while len(out) < n and tries < 100 * n:
            tries += 1
            combo = [ax[int(rng.integers(0, len(ax)))] for ax in axes]
            p = DesignPoint(**dict(zip(self._AXES, combo))).canonical()
            if p.feasible and p not in seen:
                seen.add(p)
                out.append(p)
        return out

    def size(self) -> int:
        return sum(1 for _ in self.grid())


def default_space() -> DesignSpace:
    """The paper-centric search space ``tune()`` uses when none is
    given — it contains the paper's 16x16 / 4 KB / 20 KB point."""
    return DesignSpace()


def bench_grid() -> list:
    """The deterministic 64-config sweep the design-space benchmark and
    the CI trajectory guard both price (kept here so the plain-script
    trajectory check and the benchmark can never drift apart):
    4 SA dims x 2 uTLB reaches x 2 LLC carve-outs x 2 PCIe gens x
    DM/DC.  One plan geometry (page_bytes fixed) -> one trace analysis
    shared by all 64 configs."""
    pts = [DesignPoint(sa_w=w, tlb_entries=tlb, llc_kb=llc,
                       pcie_gen=gen, mode=mode, buffer_kb=132)
           for w in (4, 8, 16, 32)
           for tlb in (16, 64)
           for llc in (1024, 4096)
           for gen in (5, 6)
           for mode in ("DM", "DC")]
    return pts


def pareto_front(scored: Iterable[tuple]) -> list:
    """Indices of the non-dominated (latency, area) points: a point is
    kept iff no other point is <= on both axes and < on one."""
    items = [(float(t), float(a), i) for i, (t, a) in enumerate(scored)]
    best: Optional[float] = None
    keep = []
    for t, a, i in sorted(items):
        if best is None or a < best:
            best = a
            keep.append(i)
    return sorted(keep)
