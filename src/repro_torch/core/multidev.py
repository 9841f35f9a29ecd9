"""Multi-device sharded plans: fabric parsing, TP/EP partitioning and
coupled N-rank replay.

A multi-device step is N per-rank ``StreamPlan``s that synchronize at
COLLECTIVE events (``core.plan.collective_plan`` hops priced on the
``accesys.components.Fabric`` link).  This module owns the three layers
on top of that event kind:

* **Partitioning** — ``tp_split`` / ``tp_shard_plan`` / ``ep_shard_plan``
  decide per-rank extents through the SAME logical rule table as
  ``sharding/logical.spec_for`` (a dim shards only when the rule maps it
  to the ``model`` axis AND the size divides the degree; otherwise it is
  replicated — never silently padded).
* **Collective lowering** — ``ag_plan`` / ``rs_plan`` / ``a2a_plan``
  build one rank's share of a collective as per-hop COLLECTIVE events.
  The topology decides the hop decomposition at plan-build time: a ring
  moves ``p-1`` chained hops of one shard each (total ``(p-1)/p`` of the
  full tensor — the classic ring AG/RS volume), a full crossbar
  (``alltoall``) issues the same byte volume as ONE descriptor chain
  paying a single hop latency.  Link bandwidth stays a pricing-time knob
  (``Fabric.link``), so one plan skeleton serves a whole fabric sweep.
* **Coupled replay** — ``replay_multidev`` prices N ranks as N coupled
  max-plus timelines: each rank's op stream runs independently between
  collectives, and at collective ``j`` every rank's SA timeline is
  raised to the across-rank barrier ``max_r max(t_sa_r, t_out_r)``
  before the hop time is added.  For symmetric ranks the barrier is a
  no-op and every rank's result coincides bitwise with a solo
  ``replay_compiled`` of its own plan — which is why ``Scenario`` can
  price a TP step through the ordinary single-plan path.

``rank_instances`` turns one compiled skeleton into N rank instances via
``CompiledPlan.relabel`` with rank-prefixed page maps (injective, so the
interned trace is shared by reference — an instance is O(pages), not
O(events)).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.core import paging
from repro_torch.core import plan as P
from repro_torch.sharding import logical

# accesys imports stay call-time, as in the reference: the accesys
# package init imports pipeline, which imports the core plan modules


# ------------------------------------------------------------- fabric
def parse_fabric(spec) -> Fabric:
    """Parse a fabric spec string into a ``Fabric``.

    Forms: ``"ring"`` | ``"alltoall"`` (default PCIe link), ``"ring:64"``
    (link bandwidth in GB/s), ``"ring:64:800"`` (+ per-hop latency in
    ns).  A ``Fabric`` passes through unchanged."""
    from repro_torch.accesys.components import Fabric
    from repro_torch.accesys.system import pcie_for_bw
    if isinstance(spec, Fabric):
        return spec
    parts = str(spec).split(":")
    topo = parts[0] or "ring"
    link = pcie_for_bw(float(parts[1])) if len(parts) > 1 \
        else Fabric().link
    hop = float(parts[2]) if len(parts) > 2 else Fabric().hop_latency_ns
    return Fabric(link=link, topology=topo, hop_latency_ns=hop)


# ------------------------------------------------- logical partitioning
# the simulator's mesh is single-pod: drop the pure data-parallel pod
# axis from the rule table, exactly like make_rules(multi_pod=False)
_MESH_RULES = logical.make_rules(multi_pod=False)


def tp_split(size: int, logical_name: str, p: int) -> Optional[int]:
    """Per-rank extent of a dim of ``size`` whose logical name is
    ``logical_name`` under TP degree ``p`` — or ``None`` when
    ``sharding.logical.spec_for`` would replicate it (rule table does
    not map the name to the ``model`` axis, or the size does not divide
    ``p``; GSPMD would pad, we replicate)."""
    spec = logical.spec_for((logical_name,), (size,), _MESH_RULES,
                            {"model": p})
    entry = spec[0] if len(spec) else None
    if entry is None:
        return None
    axes = entry if isinstance(entry, tuple) else (entry,)
    if "model" not in axes:
        return None
    return size // p


def tp_shard_plan(p: int, **dims) -> dict:
    """TP-partition a set of logically named dims (e.g. ``heads=32,
    kv_heads=8, mlp=11008``).  Returns ``{name: (per_rank, sharded)}``
    where replicated dims keep their full size — the decision is
    exactly ``spec_for``'s, so plan-level sharding can never drift from
    the logical rule table."""
    out = {}
    for name, size in dims.items():
        per = tp_split(size, name, p)
        out[name] = (size, False) if per is None else (per, True)
    return out


def ep_shard_plan(p: int, n_experts: int) -> int:
    """Experts per rank under EP degree ``p``.  Unlike TP dims, experts
    cannot fall back to replication (that would silently turn EP off),
    so an indivisible count is an error."""
    per = tp_split(n_experts, "expert", p)
    if per is None:
        raise ValueError(
            f"cannot expert-parallelize {n_experts} experts over "
            f"ep={p}: the 'expert' rule requires exact divisibility")
    return per


# ------------------------------------------------- collective builders
def _coll_hops(shard_bytes: int, p: int, topology: str) -> list:
    from repro_torch.accesys.components import FABRIC_TOPOLOGIES
    if topology not in FABRIC_TOPOLOGIES:
        raise ValueError(f"unknown fabric topology {topology!r}; "
                         f"valid: {FABRIC_TOPOLOGIES}")
    if p <= 1 or shard_bytes <= 0:
        return []
    if topology == "alltoall":
        return [(p - 1) * shard_bytes]
    return [shard_bytes] * (p - 1)


def ag_plan(shard_bytes: int, p: int, topology: str, dtype,
            *, lane: int = 0, page_bytes: int = paging.PAGE_BYTES,
            name: Optional[str] = None) -> Optional[P.StreamPlan]:
    """One rank's share of an all-gather of ``p`` shards of
    ``shard_bytes`` each: ring = ``p-1`` chained hops of one shard
    (total ``(p-1)/p`` of the gathered tensor), crossbar = the same
    volume in one chain.  ``None`` when no wire crossing happens."""
    hops = _coll_hops(shard_bytes, p, topology)
    if not hops:
        return None
    return P.collective_plan("all_gather", hops, dtype, page_bytes,
                             lane=lane, meta={"p": p},
                             name=name or f"ag.p{p}")


def rs_plan(shard_bytes: int, p: int, topology: str, dtype,
            *, lane: int = 0, page_bytes: int = paging.PAGE_BYTES,
            name: Optional[str] = None) -> Optional[P.StreamPlan]:
    """Reduce-scatter: the byte volume mirrors the all-gather (ring
    ``(p-1)/p`` of the reduced tensor) — the reduction itself rides the
    SA/host ops that produced the partials."""
    hops = _coll_hops(shard_bytes, p, topology)
    if not hops:
        return None
    return P.collective_plan("reduce_scatter", hops, dtype, page_bytes,
                             lane=lane, meta={"p": p},
                             name=name or f"rs.p{p}")


def a2a_plan(shard_bytes: int, p: int, topology: str, dtype,
             *, op: str = "all_to_all", lane: int = 0,
             page_bytes: int = paging.PAGE_BYTES,
             name: Optional[str] = None) -> Optional[P.StreamPlan]:
    """All-to-all (MoE dispatch/combine): each rank keeps its own
    ``1/p`` and exchanges ``p-1`` peer blocks of ``shard_bytes`` —
    dispatch and combine volumes are equal by construction."""
    hops = _coll_hops(shard_bytes, p, topology)
    if not hops:
        return None
    return P.collective_plan(op, hops, dtype, page_bytes, lane=lane,
                             meta={"p": p}, name=name or f"{op}.p{p}")


# ----------------------------------------------------- rank instancing
def rank_instances(plan: P.StreamPlan, p: int,
                   tag: str = "r") -> list:
    """N per-rank ``CompiledPlan`` instances of one skeleton: rank 0 is
    the compile itself; rank ``r`` relabels every page key ``(name, i)``
    to ``(f"{tag}{r}.{name}", i)`` — injective, so the interned trace
    arrays are shared by reference and each rank prices an identical
    (but disjointly paged) timeline."""
    sk = plan.compile()
    out = [sk]
    for r in range(1, p):
        pmap = {key: (f"{tag}{r}.{key[0]}",) + tuple(key[1:])
                for key in sk.page_keys}
        out.append(sk.relabel(pmap))
    return out


# ----------------------------------------------------- coupled replay
def replay_multidev(cfg, plans: Sequence,
                    host_s_per_elem: Optional[float] = None,
                    footprint_pages: Optional[int] = None) -> list:
    """Price N per-rank plans as N coupled max-plus timelines.

    Every rank's op stream runs the ordinary double-buffer recurrence
    between collectives; collective ``j`` is a synchronization point —
    all ranks must have the same collective count — where each rank's
    SA timeline is raised to ``max_r max(t_sa_r, t_out_r)`` before its
    own hop time is added.  Returns one ``GemmResult`` per rank.  For
    symmetric ranks the barrier never binds and each result equals a
    solo ``replay_compiled`` of that rank's plan (property-tested), so
    single-plan pricing remains exact for homogeneous TP/EP."""
    from repro_torch.accesys import pipeline as PL
    if host_s_per_elem is None:
        host_s_per_elem = PL.HOST_S_PER_ELEM
    states = []
    for pl in plans:
        cfg.smmu.reset()
        cfg.llc.reset()
        cp = pl.compile()
        foot = pl.footprint_pages if footprint_pages is None \
            else footprint_pages
        t, x, has_p, d, ready, val = PL._compiled_arrays(
            cfg, cp, foot, host_s_per_elem)
        k = cp.op_kind
        states.append({
            "pl": pl, "k": k, "has_p": has_p, "ready": ready,
            "val": val, "t": t, "x": x, "d": d,
            "coll": np.nonzero(k == P.OP_COLL)[0],
            "stats": (cfg.smmu.lookups, cfg.smmu.misses,
                      cfg.smmu.walks),
            "t_sa": 0.0, "t_out": 0.0, "exp": 0.0, "pos": 0})
    n_coll = {st["coll"].size for st in states}
    if len(n_coll) > 1:
        raise ValueError(
            f"ranks disagree on collective count {sorted(n_coll)}: "
            "multi-device plans must synchronize at the same barriers")

    def advance(st, stop):
        s0 = st["pos"]
        if stop > s0:
            _, _, exp_a, t_sa, t_out = PL._run_ops_loop(
                st["k"][s0:stop], st["has_p"][s0:stop],
                st["ready"][s0:stop], st["val"][s0:stop],
                st["t_sa"], st["t_out"])
            st["exp"] += float(exp_a.sum())
            st["t_sa"], st["t_out"] = t_sa, t_out
        st["pos"] = stop

    for j in range(n_coll.pop()):
        for st in states:
            advance(st, int(st["coll"][j]))
        barrier = max(max(st["t_sa"], st["t_out"]) for st in states)
        for st in states:
            g = int(st["coll"][j])
            st["t_sa"] = barrier + st["val"][g]
            st["pos"] = g + 1
    results = []
    for st in states:
        advance(st, st["k"].size)
        pl, k, val = st["pl"], st["k"], st["val"]
        scale = pl.total_steps / max(pl.sampled_steps, 1) \
            if pl.total_steps else 1.0
        control = pl.n_calls * (cfg.dma.doorbell_ns +
                                cfg.dma.interrupt_ns) * 1e-9
        lk, ms, wk = st["stats"]
        results.append(PL.GemmResult(
            total_s=max(st["t_sa"], st["t_out"]) * scale + control,
            compute_s=float(val[k == P.OP_SA].sum()) * scale,
            transfer_s=float(st["t"].sum()) * scale,
            exposed_transfer_s=st["exp"] * scale,
            descriptor_s=(float(st["d"][st["has_p"]].sum())
                          + float((k == P.OP_OUT).sum())
                          * cfg.dma.descriptor_time()) * scale,
            translation_s=float(st["x"].sum()) * scale,
            tlb_lookups=int(lk * scale), tlb_misses=int(ms * scale),
            ptw_walks=int(wk * scale), macs=pl.macs,
            host_s=float(val[k == P.OP_HOST].sum()) * scale,
            drain_s=max(0.0, st["t_out"] - st["t_sa"]) * scale,
            coll_s=float(val[k == P.OP_COLL].sum()) * scale))
    return results
