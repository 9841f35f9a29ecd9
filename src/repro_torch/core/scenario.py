"""Scenario API — the declarative front door to the streaming simulator.

A ``Scenario`` names a workload (any ``configs/*.py`` ``ModelConfig``,
one of the paper's BERT/ViT models, or a synthetic workload class) plus
the knobs that make it runnable — dtype, seq/batch, memory mode,
replay engine, sampling policy, serving parameters — and
``simulate(scenario)`` lowers it to a ``StreamPlan``/``PlanSchedule``,
replays it against the accesys component models, and returns a typed
``SimResult`` (Fig.-2 buckets, TLB stats, events/sec, per-request
percentiles when serving, stable ``to_json()`` schema).  ``sweep``
runs many scenarios with shared plan/compile caching, so a DM/DC/DevMem
sweep builds (and compiles) each plan once.

The lowering is registry-driven: ``WORKLOAD_REGISTRY`` maps a config
*family* to a layer-class stack builder —

  * ``dense`` / ``vlm`` — GQA/MQA attention + (gated or plain) MLP;
  * ``moe``   — attention (MLA-aware for deepseek-v3) + expert-routed
    FFN, honoring ``MoEConfig.first_dense_layers`` (dense layers first)
    and ``n_shared_experts`` (an always-on dense expert branch);
  * ``ssm``   — rwkv-style chunked-scan time mix + channel-mix FFN;
  * ``hybrid``— zamba2: mamba2 layers with the shared attention+MLP
    block inserted every ``SSMConfig.attn_every`` layers;
  * ``audio`` — whisper: encoder self-attention layers plus decoder
    layers with cross-attention over the encoder memory.

A heterogeneous stack (zamba2's mamba/attention interleave) lowers to
ONE steady window per layer *class*, each with its own repeat count —
the heterogeneous-schedule follow-on of the steady-state sampling work.
Unknown scenario names raise ``UnsupportedScenario`` with a
did-you-mean hint; unknown families raise it too (never ``KeyError``).

This is the PyTorch port's copy of the reference package's Scenario
API: the lowering, the replay and every result are numpy on the host
and equal the reference's.  The one path through the card is the
``serve`` kind, whose engine runs on ``device`` (``simulate``,
``sweep``, ``sampling_error`` and ``scenario_plan`` take it; the card
unless the caller asks for ``"cpu"``).  The open-loop load sweep
(``sweep_load``, ``LoadPoint``, ``LoadSweepResult``) drives the
plan-only engine, which has no device, and prices on the host.
"""
from __future__ import annotations

import dataclasses
import difflib
import functools
import time
from collections import OrderedDict
from typing import Callable, Optional, Sequence

from repro_torch.core import multidev as MD
from repro_torch.core import paging
from repro_torch.core import plan as plan_ir
from repro_torch.core.plan import (PlanSchedule, StreamPlan, concat, gemm_plan,
                                   host_plan)

PAGE_BYTES = paging.PAGE_BYTES
MODES = ("DM", "DC", "DevMem")
ENGINES = ("auto", "event", "compiled", "both")

# tiny-but-representative geometry for the synthetic workload classes
# (override any of these through ``Scenario.params``)
MOE_SHAPE = dict(n_tokens=64, d_model=128, n_experts=8, top_k=2,
                 d_ff=256, capacity_factor=1.25)
SSM_SHAPE = dict(T=128, d_model=128, n_heads=4, chunk=16)
DECODE_SHAPE = dict(n_pages=64, page_tokens=8, n_kv_heads=4,
                    head_dim=32, max_pages_per_seq=8,
                    prompt_lens=(20, 9, 33), churn=((1, 12),),
                    n_q_heads=None)
SERVE_SHAPE = dict(arch="qwen2_0_5b", slots=2, n_requests=5,
                   max_new_tokens=6, max_seq=48, prompt_lo=8,
                   prompt_hi=8, seed=0)


class UnsupportedScenario(ValueError):
    """Raised for unknown scenario names / model families — always with
    the valid alternatives spelled out, never a bare ``KeyError``."""


def as_params(**kw) -> tuple:
    """Workload-shape overrides as the hashable ``Scenario.params``
    form: a sorted tuple of (key, value) pairs."""
    return tuple(sorted(kw.items()))


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One declarative simulator run.  ``model`` is any name from
    ``scenario_names()``: a config-zoo ``ModelConfig`` name (full or
    ``-reduced``), a paper model (``bert-base`` …), a workload-class
    alias (``bert``/``vit``), or a synthetic class (``moe``/``ssm``/
    ``decode``/``serve``).  ``params`` carries per-class shape
    overrides (see ``as_params``)."""
    model: str
    dtype: str = "int8"            # int8|int16|int32|fp8|fp16|fp32
    mode: str = "DC"               # DM | DC | DevMem
    seq: Optional[int] = None      # tokens = batch * seq (default: per-model)
    batch: int = 1
    n_layers: Optional[int] = None # cap the layer stack
    sampling: str = "sampled"      # sampled | exact
    sample_stride: int = 1         # stride GEMM inner loops of windows
    engine: str = "auto"           # auto | event | compiled | both
    devmem_dram: str = "HBM2"      # DRAM tech for DevMem mode
    page_bytes: int = PAGE_BYTES   # streaming page/tile granularity
    params: tuple = ()             # workload-class overrides (as_params)
    tp: int = 1                    # tensor-parallel degree (model axis)
    ep: int = 1                    # expert-parallel degree (MoE only)
    fabric: str = "ring"           # interconnect "topo[:GB/s[:hop_ns]]"
    pcie_gb_s: Optional[float] = None  # host-link bandwidth override

    def __post_init__(self):
        if self.mode not in MODES:
            raise UnsupportedScenario(
                f"unknown memory mode {self.mode!r}; valid: {MODES}")
        if self.page_bytes < 256 or \
                self.page_bytes & (self.page_bytes - 1):
            raise UnsupportedScenario(
                f"page_bytes must be a power of two >= 256, got "
                f"{self.page_bytes}")
        if self.dtype not in plan_ir.ELEM_BYTES:
            raise UnsupportedScenario(
                f"unknown dtype {self.dtype!r}; valid: "
                f"{sorted(plan_ir.ELEM_BYTES)}")
        if self.sampling not in ("sampled", "exact"):
            raise UnsupportedScenario(
                f"unknown sampling policy {self.sampling!r}; valid: "
                "('sampled', 'exact')")
        if self.engine not in ENGINES:
            raise UnsupportedScenario(
                f"unknown engine {self.engine!r}; valid: {ENGINES}")
        for deg, nm in ((self.tp, "tp"), (self.ep, "ep")):
            if not isinstance(deg, int) or deg < 1:
                raise UnsupportedScenario(
                    f"{nm} must be an int >= 1, got {deg!r}")
        try:
            MD.parse_fabric(self.fabric)
        except (TypeError, ValueError) as e:
            raise UnsupportedScenario(
                f"bad fabric spec {self.fabric!r}: {e}") from None
        if self.pcie_gb_s is not None and not self.pcie_gb_s > 0:
            raise UnsupportedScenario(
                f"pcie_gb_s must be positive, got {self.pcie_gb_s!r}")

    def param_dict(self) -> dict:
        return dict(self.params)

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["params"] = {k: list(v) if isinstance(v, tuple) else v
                       for k, v in self.params}
        return d


# ------------------------------------------------------------ SimResult
@dataclasses.dataclass
class SimResult:
    """Typed result of one ``simulate()`` run — the single artifact
    every benchmark and the CLI consume.  ``result`` keeps the raw
    accesys ``GemmResult`` for parity checks; ``to_json()`` is the
    stable serialization (schema ``simresult/v1``)."""
    scenario: Scenario
    label: str                     # plan/schedule name
    mode: str
    engine: str                    # engine actually used
    result: object                 # accesys.pipeline.GemmResult
    events_replayed: int
    events_total: int
    wall_s: float                  # replay wall-clock on this host
    serving: Optional[dict] = None # percentiles + trace stats (serve)
    sampling_error: Optional[dict] = None   # see sampling_error()

    SCHEMA = "simresult/v1"

    @property
    def total_s(self) -> float:
        return self.result.total_s

    def buckets(self) -> dict:
        return self.result.buckets()

    @property
    def events_per_s(self) -> float:
        return self.events_replayed / max(self.wall_s, 1e-9)

    @property
    def sampling_speedup(self) -> float:
        return self.events_total / max(self.events_replayed, 1)

    def to_json(self) -> dict:
        r = self.result
        return {
            "schema": self.SCHEMA,
            "scenario": self.scenario.to_json(),
            "label": self.label,
            "mode": self.mode,
            "engine": self.engine,
            "total_us": r.total_s * 1e6,
            "buckets": {k: round(v, 9) for k, v in r.buckets().items()},
            "tlb": {"lookups": r.tlb_lookups, "misses": r.tlb_misses,
                    "walks": r.ptw_walks},
            "macs": r.macs,
            "gops": round(r.gops, 3),
            "events": {"replayed": self.events_replayed,
                       "total": self.events_total,
                       "speedup": round(self.sampling_speedup, 2)},
            "wall_s": round(self.wall_s, 6),
            "events_per_s": round(self.events_per_s, 1),
            "serving": self.serving,
            "sampling_error": self.sampling_error,
        }


def assert_parity(a: SimResult, b: SimResult, rtol: float = 1e-9):
    """Every ``GemmResult`` field of two runs of the same scenario must
    agree to ``rtol`` — the compiled-vs-event engine contract."""
    for f in dataclasses.fields(a.result):
        va, vb = getattr(a.result, f.name), getattr(b.result, f.name)
        if not (va == vb or (isinstance(va, float) and
                             abs(va - vb) <= rtol * max(abs(vb), 1e-30))):
            raise AssertionError(
                f"engine parity violated for {a.label} [{a.mode}]: "
                f"{f.name} {a.engine}={va!r} {b.engine}={vb!r}")


# =============================================================== lowering
# Layer-class stacks: a family lowerer turns a ModelConfig into an
# ordered list of _Layer instances; _stack_plan composes them into an
# exact plan (interleaved, activations chained) or a steady-state
# PlanSchedule (one window per layer CLASS, repeated by class count).

@dataclasses.dataclass(frozen=True)
class _Layer:
    cls: str                       # layer-class key ("layer", "mamba", …)
    build: Callable                # (idx:int, x:str, out:str) -> [StreamPlan]


def _norm_plan(src: str, out: str, S: int, d: int, dt, norm: str,
               pb: int, out_kind: str = "intermediate") -> StreamPlan:
    return host_plan(norm, (src,), out, (S, d), 2 * S * d, dt, pb,
                     out_kind=out_kind)


@dataclasses.dataclass(frozen=True)
class _Shard:
    """The sharding context a config stack lowers under — one RANK's
    view of a tp/ep-partitioned model.  Set (and restored) around
    ``_build_plan`` for config scenarios; the layer builders read it to
    shrink head/ffn/expert extents per ``sharding.logical``'s rule
    table and to insert the Megatron-style collectives (all-gather of
    the block input, reduce-scatter of the block output, all-to-all
    around MoE dispatch/combine).  ``tp == ep == 1`` is the identity:
    every builder takes the exact unsharded code path, so a degree-1
    "sharded" plan is bitwise the unsharded plan.  Because symmetric
    ranks never bind ``replay_multidev``'s barrier, pricing ONE rank's
    plan through the ordinary single-plan engines is exact for the
    whole homogeneous TP/EP group."""
    tp: int = 1
    ep: int = 1
    topology: str = "ring"


_SHARD = _Shard()


def _attn_plans(cfg, S: int, dt, P: str, x: str, out: str, ss: int,
                pb: int, *, kv_src: Optional[str] = None,
                S_kv: Optional[int] = None) -> list:
    """GQA/MQA (and MLA, for deepseek-v3) attention sub-block:
    projections -> per-q-head paged attention over shared per-kv-head
    K/V -> output projection -> residual + norm, ending at ``out``.
    ``kv_src`` switches to cross-attention: queries come from ``x``,
    keys/values from the ``kv_src`` memory tensor of ``S_kv`` rows."""
    hd = cfg.resolved_head_dim
    HQ, KH = cfg.n_heads, cfg.n_kv_heads
    tp, topo = _SHARD.tp, _SHARD.topology
    if tp > 1:
        # shard iff spec_for's rule table would: q heads must divide;
        # kv heads shard with them or stay replicated (MQA/GQA) when
        # the local q heads still group evenly over the full KV set
        HQ_l = MD.tp_split(HQ, "heads", tp)
        KH_l = MD.tp_split(KH, "kv_heads", tp)
        if HQ_l is None:
            tp = 1                     # replicate the whole block
        elif KH_l is not None:
            HQ, KH = HQ_l, KH_l
        elif HQ_l % KH == 0:
            HQ = HQ_l                  # shard q heads, replicate KV
        else:
            tp = 1
    group = HQ // KH
    Sk = S if S_kv is None else S_kv
    d = cfg.d_model
    plans: list = []
    if tp > 1:
        # Megatron cut: ranks hold S/tp rows of x — all-gather the
        # block input before the projections, reduce-scatter the
        # partial output projection before the residual add
        shard = S * d * plan_ir.ELEM_BYTES[dt] // tp
        ag = MD.ag_plan(shard, tp, topo, dt, page_bytes=pb,
                        name=P + f"ag.p{tp}")
        if ag is not None:
            plans.append(ag)
    mla = getattr(cfg, "mla", None) if kv_src is None else None
    if mla is not None:
        q_hd = mla.qk_nope_head_dim + mla.qk_rope_head_dim
        v_hd = mla.v_head_dim
        plans += [
            gemm_plan(S, mla.q_lora_rank, d, dt, a=x, b=P + "wq_a",
                      c=P + "q_lat", b_kind="weight",
                      c_kind="intermediate", page_bytes=pb,
                      sample_stride=ss),
            gemm_plan(S, HQ * q_hd, mla.q_lora_rank, dt, a=P + "q_lat",
                      b=P + "wq_b", c=P + "q", b_kind="weight",
                      c_kind="intermediate", page_bytes=pb,
                      sample_stride=ss),
            # the joint down-projection splits into its two outputs —
            # the compressed KV latent (consumed by wk_b/wv_b) and the
            # shared rope key (concatenated into k directly) — so
            # kv_lat's declared shape matches what its consumers read
            gemm_plan(S, mla.kv_lora_rank, d, dt,
                      a=x, b=P + "wkv_a", c=P + "kv_lat",
                      b_kind="weight", c_kind="intermediate",
                      page_bytes=pb, sample_stride=ss),
            gemm_plan(S, mla.qk_rope_head_dim, d, dt,
                      a=x, b=P + "wk_rope", c=P + "k_rope",
                      b_kind="weight", c_kind="intermediate",
                      page_bytes=pb, sample_stride=ss),
            gemm_plan(Sk, KH * q_hd, mla.kv_lora_rank, dt,
                      a=P + "kv_lat", b=P + "wk_b", c=P + "k",
                      b_kind="weight", c_kind="intermediate",
                      page_bytes=pb, sample_stride=ss),
            gemm_plan(Sk, KH * v_hd, mla.kv_lora_rank, dt,
                      a=P + "kv_lat", b=P + "wv_b", c=P + "v",
                      b_kind="weight", c_kind="intermediate",
                      page_bytes=pb, sample_stride=ss),
        ]
        q_src, k_src, v_src = P + "q", P + "k", P + "v"
        q_base = lambda h: h * q_hd
        k_base = lambda kv: kv * q_hd
        v_base = lambda kv: kv * v_hd
    elif kv_src is not None:
        q_hd = v_hd = hd
        plans += [
            gemm_plan(S, HQ * hd, d, dt, a=x, b=P + "wq", c=P + "q",
                      b_kind="weight", c_kind="intermediate",
                      page_bytes=pb, sample_stride=ss),
            gemm_plan(Sk, 2 * KH * hd, d, dt, a=kv_src, b=P + "wkv",
                      c=P + "kv", b_kind="weight",
                      c_kind="intermediate", page_bytes=pb,
                      sample_stride=ss),
        ]
        q_src, k_src, v_src = P + "q", P + "kv", P + "kv"
        q_base = lambda h: h * hd
        k_base = lambda kv: kv * hd
        v_base = lambda kv: KH * hd + kv * hd
    else:
        q_hd = v_hd = hd
        plans.append(
            gemm_plan(S, (HQ + 2 * KH) * hd, d, dt, a=x, b=P + "wqkv",
                      c=P + "qkv", b_kind="weight",
                      c_kind="intermediate", page_bytes=pb,
                      sample_stride=ss))
        q_src = k_src = v_src = P + "qkv"
        q_base = lambda h: h * hd
        k_base = lambda kv: HQ * hd + kv * hd
        v_base = lambda kv: (HQ + KH) * hd + kv * hd
    head_outs = []
    for h in range(HQ):
        kv = h // group
        qh, oh = P + f"q{h}", P + f"o{h}"
        kT, vh = P + f"kT{kv}", P + f"v{kv}"
        plans.append(host_plan(
            "slice_cols", (q_src,), qh, (S, q_hd), S * q_hd, dt, pb,
            {"start": q_base(h), "stop": q_base(h) + q_hd}))
        if h % group == 0:
            plans += [
                host_plan("slice_cols", (k_src,), kT, (q_hd, Sk),
                          Sk * q_hd, dt, pb,
                          {"start": k_base(kv),
                           "stop": k_base(kv) + q_hd,
                           "transpose": True}),
                host_plan("slice_cols", (v_src,), vh, (Sk, v_hd),
                          Sk * v_hd, dt, pb,
                          {"start": v_base(kv),
                           "stop": v_base(kv) + v_hd}),
            ]
        sc, pr = P + f"h{h}.scores", P + f"h{h}.p"
        plans += [
            gemm_plan(S, Sk, q_hd, dt, a=qh, b=kT, c=sc,
                      c_kind="intermediate", page_bytes=pb,
                      sample_stride=ss),
            host_plan("softmax", (sc,), pr, (S, Sk), S * Sk, dt, pb),
            gemm_plan(S, v_hd, Sk, dt, a=pr, b=vh, c=oh,
                      c_kind="intermediate", page_bytes=pb,
                      sample_stride=ss),
        ]
        head_outs.append(oh)
    plans += [
        host_plan("concat_cols", tuple(head_outs), P + "attn",
                  (S, HQ * v_hd), S * HQ * v_hd, dt, pb),
        gemm_plan(S, d, HQ * v_hd, dt, a=P + "attn", b=P + "wo",
                  c=P + "proj", b_kind="weight", c_kind="intermediate",
                  page_bytes=pb, sample_stride=ss),
    ]
    if tp > 1:
        rs = MD.rs_plan(S * d * plan_ir.ELEM_BYTES[dt] // tp, tp, topo,
                        dt, page_bytes=pb, name=P + f"rs.p{tp}")
        if rs is not None:
            plans.append(rs)
    plans += [
        host_plan("add", (x, P + "proj"), P + "res_a", (S, d),
                  S * d, dt, pb),
        _norm_plan(P + "res_a", out, S, d, dt, cfg.norm, pb),
    ]
    return plans


def _mlp_body(cfg, S: int, d_ff: int, dt, P: str, x: str, out: str,
              ss: int, pb: int) -> list:
    """Gated (SwiGLU/GeGLU) or plain MLP producing ``out`` — the
    FFN GEMM/activation body WITHOUT the residual/norm tail, shared by
    the per-layer FFN and MoE shared-expert branches so their plan
    accounting can never diverge."""
    d = cfg.d_model
    tp, topo = _SHARD.tp, _SHARD.topology
    if tp > 1:
        d_ff_l = MD.tp_split(d_ff, "mlp", tp)
        if d_ff_l is None:
            tp = 1                     # indivisible width: replicate
        else:
            d_ff = d_ff_l
    plans: list = []
    if tp > 1:
        shard = S * d * plan_ir.ELEM_BYTES[dt] // tp
        ag = MD.ag_plan(shard, tp, topo, dt, page_bytes=pb,
                        name=P + f"ag.p{tp}")
        if ag is not None:
            plans.append(ag)
    if cfg.glu:
        plans += [
            gemm_plan(S, d_ff, d, dt, a=x, b=P + "w1", c=P + "gate",
                      b_kind="weight", c_kind="intermediate",
                      page_bytes=pb, sample_stride=ss),
            gemm_plan(S, d_ff, d, dt, a=x, b=P + "w3", c=P + "up",
                      b_kind="weight", c_kind="intermediate",
                      page_bytes=pb, sample_stride=ss),
            host_plan("act_mul", (P + "gate", P + "up"), P + "h",
                      (S, d_ff), 2 * S * d_ff, dt, pb,
                      meta={"act": cfg.act}),
        ]
    else:
        plans += [
            gemm_plan(S, d_ff, d, dt, a=x, b=P + "w1", c=P + "ff1",
                      b_kind="weight", c_kind="intermediate",
                      page_bytes=pb, sample_stride=ss),
            host_plan(cfg.act, (P + "ff1",), P + "h", (S, d_ff),
                      S * d_ff, dt, pb),
        ]
    plans.append(
        gemm_plan(S, d, d_ff, dt, a=P + "h", b=P + "w2", c=out,
                  b_kind="weight", c_kind="intermediate",
                  page_bytes=pb, sample_stride=ss))
    if tp > 1:
        rs = MD.rs_plan(S * d * plan_ir.ELEM_BYTES[dt] // tp, tp, topo,
                        dt, page_bytes=pb, name=P + f"rs.p{tp}")
        if rs is not None:
            plans.append(rs)
    return plans


def _ffn_plans(cfg, S: int, d_ff: int, dt, P: str, x: str, out: str,
               ss: int, pb: int, out_kind: str = "output") -> list:
    """Gated (SwiGLU/GeGLU) or plain MLP + residual + norm."""
    d = cfg.d_model
    plans = _mlp_body(cfg, S, d_ff, dt, P, x, P + "ff", ss, pb)
    plans += [
        host_plan("add", (x, P + "ff"), P + "res_f", (S, d), S * d,
                  dt, pb),
        _norm_plan(P + "res_f", out, S, d, dt, cfg.norm, pb,
                   out_kind=out_kind),
    ]
    return plans


def _dense_layer(cfg, S, dt, ss, pb, cls_name="layer"):
    def build(idx, x, out):
        P = f"{cls_name}{idx}."
        plans = _attn_plans(cfg, S, dt, P, x, P + "ln_a", ss, pb)
        plans += _ffn_plans(cfg, S, cfg.d_ff, dt, P, P + "ln_a", out,
                            ss, pb)
        return plans
    return _Layer(cls_name, build)


def _moe_layer(cfg, S, dt, ss, pb):
    mo = cfg.moe

    def build(idx, x, out):
        P = f"moe{idx}."
        plans = _attn_plans(cfg, S, dt, P, x, P + "ln_a", ss, pb)
        moe_out = P + "moe_y" if mo.n_shared_experts else P + "ff"
        ep, topo = _SHARD.ep, _SHARD.topology
        E_local = mo.n_routed_experts
        capacity = None
        if ep > 1:
            from repro_torch.models.moe import routed_capacity
            # each rank hosts E/ep experts but keeps the GLOBAL
            # per-expert capacity (dispatch rebalances tokens across
            # ranks, it does not shrink an expert's buffer)
            E_local = MD.ep_shard_plan(ep, mo.n_routed_experts)
            capacity = routed_capacity(S * mo.top_k,
                                       mo.n_routed_experts, None, 1.25)
        mp = plan_ir._moe_layer_plans(
            S, cfg.d_model, E_local, mo.top_k,
            mo.d_ff_expert, dt, capacity=capacity, act=cfg.act,
            x=P + "ln_a", layer=idx, out=moe_out, page_bytes=pb,
            sample_stride=ss)
        if ep > 1:
            # a2a dispatch rides between host dispatch and the expert
            # GEMMs; combine between the last expert and host combine.
            # Each rank exchanges its (p-1)/p share of the routed
            # token block — dispatch and combine volumes are equal.
            shard = S * mo.top_k * cfg.d_model * \
                plan_ir.ELEM_BYTES[dt] // ep
            colls = [MD.a2a_plan(shard, ep, topo, dt,
                                 op="a2a_dispatch", page_bytes=pb,
                                 name=P + f"a2a_d.p{ep}"),
                     MD.a2a_plan(shard, ep, topo, dt,
                                 op="a2a_combine", page_bytes=pb,
                                 name=P + f"a2a_c.p{ep}")]
            disp, comb = colls
            if disp is not None:
                mp = mp[:2] + [disp] + mp[2:]
            if comb is not None:
                mp = mp[:-1] + [comb, mp[-1]]
        plans += mp
        if mo.n_shared_experts:
            # the always-on shared-expert branch: one dense gated FFN
            # of width n_shared * d_ff_expert over every token —
            # the SAME MLP body the per-layer FFN builds
            d_se = mo.n_shared_experts * mo.d_ff_expert
            SP = P + "se."
            plans += _mlp_body(cfg, S, d_se, dt, SP, P + "ln_a",
                               SP + "y", ss, pb)
            plans.append(
                host_plan("add", (moe_out, SP + "y"), P + "ff",
                          (S, cfg.d_model), S * cfg.d_model, dt, pb))
        plans += [
            host_plan("add", (P + "ln_a", P + "ff"), P + "res_f",
                      (S, cfg.d_model), S * cfg.d_model, dt, pb),
            _norm_plan(P + "res_f", out, S, cfg.d_model, dt, cfg.norm,
                       pb, out_kind="output"),
        ]
        return plans
    return _Layer("moe", build)


def _ssm_layer(cfg, S, dt, ss, pb):
    """rwkv-style attention-free block: chunked-scan time mix (the
    ``ssm_layer_plan`` machinery, mirroring ``models/ssm.py``) followed
    by the channel-mix FFN."""
    hd = cfg.ssm.head_dim if cfg.ssm is not None else \
        cfg.resolved_head_dim
    n_heads = max(1, cfg.d_model // hd)
    chunk = max(1, min(16, S))

    def build(idx, x, out):
        P = f"ssm{idx}."
        plans = plan_ir._ssm_layer_plans(
            S, cfg.d_model, n_heads, dt, chunk=chunk, x=x, layer=idx,
            out=P + "mix", page_bytes=pb, sample_stride=ss)
        plans += [
            host_plan("add", (x, P + "mix"), P + "res_t",
                      (S, cfg.d_model), S * cfg.d_model, dt, pb),
            _norm_plan(P + "res_t", P + "ln_t", S, cfg.d_model, dt,
                       cfg.norm, pb),
        ]
        plans += _ffn_plans(cfg, S, cfg.d_ff, dt, P, P + "ln_t", out,
                            ss, pb)
        return plans
    return _Layer("ssm", build)


def _mamba_layer(cfg, S, dt, ss, pb):
    """mamba2 block (zamba2): in-projection GEMM, host conv+act, the
    chunked selective scan with an explicit state-carry chain, gating,
    and the out-projection GEMM."""
    sm = cfg.ssm
    d_in = sm.expand * cfg.d_model
    H, N = max(1, d_in // sm.head_dim), sm.head_dim
    chunk = max(1, min(16, S))

    def build(idx, x, out):
        P = f"mamba{idx}."
        plans = [
            gemm_plan(S, 2 * d_in, cfg.d_model, dt, a=x, b=P + "win",
                      c=P + "xz", b_kind="weight",
                      c_kind="intermediate", page_bytes=pb,
                      sample_stride=ss),
            host_plan("conv_act", (P + "xz",), P + "u", (S, d_in),
                      S * d_in * sm.d_conv, dt, pb,
                      meta={"d_conv": sm.d_conv}),
        ]
        nc = -(-S // chunk)
        state = P + "s0"
        chunk_outs = []
        for c in range(nc):
            t0, t1 = c * chunk, min(S, (c + 1) * chunk)
            o, s = P + f"c{c}.o", P + f"c{c}.s"
            plans.append(host_plan(
                "ssm_scan", (P + "u", state), None, None,
                (t1 - t0) * H * N * N, dt, pb,
                meta={"t0": t0, "t1": t1, "H": H, "N": N},
                outs=[(o, (t1 - t0, d_in)), (s, (H * N, N))]))
            state = s
            chunk_outs.append(o)
        plans += [
            host_plan("concat_rows", tuple(chunk_outs), P + "scan",
                      (S, d_in), S * d_in, dt, pb),
            host_plan("gate", (P + "xz", P + "scan"), P + "g",
                      (S, d_in), 2 * S * d_in, dt, pb),
            gemm_plan(S, cfg.d_model, d_in, dt, a=P + "g",
                      b=P + "wout", c=P + "proj", b_kind="weight",
                      c_kind="intermediate", page_bytes=pb,
                      sample_stride=ss),
            host_plan("add", (x, P + "proj"), P + "res",
                      (S, cfg.d_model), S * cfg.d_model, dt, pb),
            _norm_plan(P + "res", out, S, cfg.d_model, dt, cfg.norm,
                       pb, out_kind="output"),
        ]
        plans[0].tensors[P + "s0"] = plan_ir.TensorSpec(H * N, N, set(),
                                                        "input")
        return plans
    return _Layer("mamba", build)


def _dec_layer(cfg, S, dt, ss, pb):
    """whisper decoder layer: causal self-attention, cross-attention
    over the encoder memory (``P+"mem"``), then the FFN."""
    def build(idx, x, out):
        P = f"dec{idx}."
        plans = _attn_plans(cfg, S, dt, P + "sa.", x, P + "ln_a", ss,
                            pb)
        plans += _attn_plans(cfg, S, dt, P + "xa.", P + "ln_a",
                             P + "ln_x", ss, pb, kv_src=P + "mem",
                             S_kv=S)
        plans += _ffn_plans(cfg, S, cfg.d_ff, dt, P, P + "ln_x", out,
                            ss, pb)
        return plans
    return _Layer("dec", build)


# family -> (cfg, S, dtype, n_layers, sample_stride, page_bytes)
#        -> ordered list of _Layer instances
def _dense_stack(cfg, S, dt, n_layers, ss, pb):
    return [_dense_layer(cfg, S, dt, ss, pb)] * n_layers


def _moe_stack(cfg, S, dt, n_layers, ss, pb):
    first = min(cfg.moe.first_dense_layers, n_layers)
    dense = _dense_layer(cfg, S, dt, ss, pb, cls_name="dense")
    moe = _moe_layer(cfg, S, dt, ss, pb)
    return [dense] * first + [moe] * (n_layers - first)


def _ssm_stack(cfg, S, dt, n_layers, ss, pb):
    return [_ssm_layer(cfg, S, dt, ss, pb)] * n_layers


def _hybrid_stack(cfg, S, dt, n_layers, ss, pb):
    """zamba2: ``n_layers`` mamba blocks with the shared attention+MLP
    block inserted after every ``attn_every`` of them."""
    mamba = _mamba_layer(cfg, S, dt, ss, pb)
    attn = _dense_layer(cfg, S, dt, ss, pb, cls_name="attn")
    every = max(1, cfg.ssm.attn_every if cfg.ssm else 6)
    stack = []
    for i in range(n_layers):
        stack.append(mamba)
        if (i + 1) % every == 0:
            stack.append(attn)
    return stack


def _audio_stack(cfg, S, dt, n_layers, ss, pb):
    # Scenario.n_layers caps BOTH stacks (like every other family caps
    # its whole stack): n_layers=1 -> 1 encoder + 1 decoder block
    enc = _dense_layer(cfg, S, dt, ss, pb, cls_name="enc")
    dec = _dec_layer(cfg, S, dt, ss, pb)
    return [enc] * min(cfg.n_encoder_layers, n_layers) + \
        [dec] * n_layers


WORKLOAD_REGISTRY = {
    "dense": _dense_stack,
    "vlm": _dense_stack,           # LM backbone; frontend is a stub
    "moe": _moe_stack,
    "ssm": _ssm_stack,
    "hybrid": _hybrid_stack,
    "audio": _audio_stack,
}


def _config_stack(cfg, S, dt, n_layers, ss, pb):
    lower = WORKLOAD_REGISTRY.get(cfg.family)
    if lower is None:
        raise UnsupportedScenario(
            f"model family {cfg.family!r} (config {cfg.name!r}) has no "
            f"workload lowering; supported families: "
            f"{sorted(WORKLOAD_REGISTRY)}")
    return lower(cfg, S, dt, n_layers, ss, pb)


def _stack_plan(name: str, stack: Sequence[_Layer], exact: bool):
    """Compose a layer-class stack: exact = every instance materialized
    in order, activations chained; sampled = one steady window per
    layer CLASS, repeated by that class's instance count (heterogeneous
    stacks keep one window per class — zamba2's mamba/attention
    interleave becomes two windows with repeats 4 and 2, say)."""
    if not stack:
        raise UnsupportedScenario(f"{name}: empty layer stack")
    if exact:
        plans = []
        inp = "x"
        for i, layer in enumerate(stack):
            out = "out" if i == len(stack) - 1 else f"B{i}.out"
            plans += layer.build(i, inp, out)
            inp = out
        return concat(plans, name=f"{name}.x{len(stack)}")
    classes: "OrderedDict[str, list]" = OrderedDict()
    for layer in stack:
        classes.setdefault(layer.cls, [layer, 0])[1] += 1
    segments = []
    for cls, (layer, count) in classes.items():
        window = layer.build(0, f"{cls}.win_in", f"{cls}.win_out")
        segments += [(p, count) for p in window]
    tag = ",".join(f"{c}:{n}" for c, (_, n) in classes.items())
    return PlanSchedule(f"{name}~sampled({tag})", segments)


# ============================================================== registry
@dataclasses.dataclass(frozen=True)
class _Target:
    kind: str                      # "config" | "moe" | "ssm" | "decode"
                                   # | "serve" | "gemm"
    config: object = None          # ModelConfig for kind == "config"
    default_seq: int = 128


@functools.lru_cache(maxsize=1)
def _targets() -> dict:
    from repro_torch.configs import ARCH_IDS, get_config, get_reduced
    from repro_torch.configs.paper_models import PAPER_MODELS
    out: dict = {}
    for name, cfg in PAPER_MODELS.items():
        out[name] = _Target("config", cfg,
                            default_seq=cfg.max_train_seq)
    for arch in ARCH_IDS:
        for cfg, seq in ((get_config(arch), 128),
                         (get_reduced(arch), 64)):
            out[cfg.name] = _Target("config", cfg, default_seq=seq)
    out["bert"] = out["bert-base"]
    out["vit"] = out["vit-base-16"]
    for kind in ("moe", "ssm", "decode", "serve", "gemm"):
        out[kind] = _Target(kind)
    return out


def scenario_names() -> list:
    """Every name ``Scenario.model`` accepts, sorted."""
    return sorted(_targets())


def resolve(name: str) -> _Target:
    """Name -> lowering target, or ``UnsupportedScenario`` with a
    did-you-mean hint and the full valid list."""
    table = _targets()
    t = table.get(name)
    if t is not None:
        return t
    close = difflib.get_close_matches(name, table, n=3, cutoff=0.5)
    hint = f" — did you mean {', '.join(map(repr, close))}?" if close \
        else ""
    raise UnsupportedScenario(
        f"unknown scenario model {name!r}{hint}  Valid scenarios: "
        f"{', '.join(sorted(table))}")


def smoke_matrix() -> list:
    """One reduced scenario per model family (generated from the
    registry — this is the CI simulate-smoke matrix) plus the synthetic
    decode class."""
    from repro_torch.configs import ARCH_IDS, get_reduced
    by_family: "OrderedDict[str, str]" = OrderedDict()
    for arch in ARCH_IDS:
        cfg = get_reduced(arch)
        by_family.setdefault(cfg.family, cfg.name)
    out = [Scenario(model=name, seq=32, engine="both")
           for name in by_family.values()]
    out.append(Scenario(model="decode", dtype="fp16", engine="both"))
    return out


# ============================================================ plan cache
_PLAN_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()
_PLAN_CACHE_MAX = 8
_TRACE_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()
_TRACE_CACHE_MAX = 2
cache_hits = 0
cache_misses = 0


def clear_caches():
    """Drop cached plans/serving traces (exact full-depth plans plus
    their compiled arrays are order-100 MB)."""
    global cache_hits, cache_misses
    from repro_torch.accesys.pipeline import release_scratch
    _PLAN_CACHE.clear()
    _TRACE_CACHE.clear()
    release_scratch()
    cache_hits = cache_misses = 0


def _pool_executor(workers: int):
    """A ``ProcessPoolExecutor`` for sweep fan-out, or ``None`` for the
    inline path.  Workers are spawned, not forked as in the reference:
    a process that has run a ``serve`` scenario holds a live CUDA
    context (and torch's thread pools), which a forked child would
    inherit and must never touch.  A spawned worker imports the
    simulator afresh, starts with empty caches, and prices plans in
    numpy without any CUDA state; the main script of a program that
    fans out must therefore guard its entry point with
    ``if __name__ == "__main__"``."""
    if workers <= 1:
        return None
    import concurrent.futures
    import multiprocessing
    return concurrent.futures.ProcessPoolExecutor(
        max_workers=workers, mp_context=multiprocessing.get_context("spawn"))


def _cache_get(cache: OrderedDict, key):
    """LRU read: a hit refreshes recency, so an interleaved sweep
    cannot evict its own hot plan."""
    hit = cache.get(key)
    if hit is not None:
        cache.move_to_end(key)
    return hit


def _cache_put(cache: OrderedDict, maxsize: int, key, value):
    cache[key] = value
    cache.move_to_end(key)     # overwriting an old key refreshes it too
    while len(cache) > maxsize:
        cache.popitem(last=False)


def _plan_key(sc: Scenario) -> tuple:
    # mode / engine / devmem_dram excluded: a DM/DC/DevMem (or
    # engine-parity) sweep reuses one plan and its compiled form.
    # Fabric/host-link BANDWIDTH and hop latency are pricing-time knobs
    # (excluded too — a bandwidth sweep reuses one plan); the fabric
    # TOPOLOGY changes the collective hop decomposition, so it is part
    # of the plan identity along with the tp/ep degrees.
    return (sc.model, sc.dtype, sc.seq, sc.batch, sc.n_layers,
            sc.sampling, sc.sample_stride, sc.page_bytes, sc.params,
            sc.tp, sc.ep, MD.parse_fabric(sc.fabric).topology)


def _decode_table(p: dict, np_dt: str):
    """A churned driver-side ``PageTable`` (no device pools, no model
    on this path) whose page ids feed the decode plan verbatim."""
    from repro_torch.serving.kv_cache import PagedCacheConfig, PageTable
    import numpy as np
    cfg = PagedCacheConfig(
        n_pages=p["n_pages"], page_tokens=p["page_tokens"],
        n_kv_heads=p["n_kv_heads"], head_dim=p["head_dim"],
        max_pages_per_seq=p["max_pages_per_seq"], dtype=np_dt)
    pt = PageTable(cfg, max_seqs=len(p["prompt_lens"]))
    for slot, ln in enumerate(p["prompt_lens"]):
        if not pt.alloc_seq(slot, ln) or not pt.note_tokens(slot, ln):
            raise UnsupportedScenario(
                f"decode scenario: KV pool too small for slot {slot} "
                f"({ln} tokens; params={p})")
    for slot, ln in (p.get("churn") or ()):
        pt.free_seq(slot)
        if not pt.alloc_seq(slot, ln) or not pt.note_tokens(slot, ln):
            raise UnsupportedScenario(
                f"decode scenario: KV pool too small for readmitted "
                f"slot {slot} ({ln} tokens)")
    return pt, np.dtype(np_dt).itemsize


def _merge_params(kind: str, defaults: dict, p: dict) -> dict:
    """Overlay scenario params on a workload class's shape defaults —
    unknown keys raise (a typo'd override must never silently leave
    the default in place)."""
    bad = sorted(set(p) - set(defaults))
    if bad:
        raise UnsupportedScenario(
            f"unknown {kind} scenario params {bad}; valid keys: "
            f"{sorted(defaults)}")
    return {**defaults, **p}


def _check_sharding(sc: Scenario, target: _Target):
    """tp/ep degrees shard model-config stacks only, and only the
    families whose blocks the partitioner understands."""
    if sc.tp == 1 and sc.ep == 1:
        return
    if target.kind != "config":
        raise UnsupportedScenario(
            f"tp/ep sharding applies to model-config scenarios only, "
            f"not the {target.kind!r} workload class")
    cfg = target.config
    if sc.tp > 1 and cfg.family in ("ssm", "hybrid"):
        raise UnsupportedScenario(
            f"tp>1 unsupported for family {cfg.family!r} "
            f"({cfg.name!r}): the selective-scan state is not "
            "head-partitionable in this lowering")
    if sc.ep > 1 and cfg.family != "moe":
        raise UnsupportedScenario(
            f"ep>1 requires a MoE config; {cfg.name!r} has family "
            f"{cfg.family!r}")


def _build_plan(sc: Scenario, target: _Target):
    """Lower a (non-serve) scenario to its plan or schedule.  Returns
    (plan_or_schedule, label, events_replayed, events_total)."""
    _check_sharding(sc, target)
    exact = sc.sampling == "exact"
    ss = sc.sample_stride
    p = {**sc.param_dict()}
    if target.kind == "config" and p:
        raise UnsupportedScenario(
            f"config scenario {sc.model!r} takes no params (got "
            f"{sorted(p)}); use seq/batch/n_layers/dtype instead")
    if target.kind == "config":
        cfg = target.config
        S = (sc.seq or target.default_seq) * sc.batch
        n_layers = sc.n_layers or cfg.n_layers
        global _SHARD
        saved = _SHARD
        _SHARD = _Shard(sc.tp, sc.ep,
                        MD.parse_fabric(sc.fabric).topology)
        try:
            stack = _config_stack(cfg, S, sc.dtype, n_layers, ss,
                                  sc.page_bytes)
            plan = _stack_plan(cfg.name, stack, exact)
        finally:
            _SHARD = saved
    elif target.kind == "gemm":
        from repro_torch.core.streaming import tile_counts
        sh = _merge_params("gemm", dict(m=1024, n=1024, k=1024), p)
        m, n, k = sh["m"], sh["n"], sh["k"]
        np_name = plan_ir.np_dtype_for(sc.dtype)
        counts = tile_counts(m, n, k, np_name,
                             page_bytes=sc.page_bytes)
        # same auto-sampling rule as pipeline.simulate_gemm, so the
        # pinned seed GEMM numbers hold through this path too
        stride = 1 if exact else \
            max(ss, counts["inner_steps"] // 400_000, 1)
        plan = plan_ir.gemm_plan_cached(m, n, k, np_name,
                                        page_bytes=sc.page_bytes,
                                        sample_stride=stride)
    elif target.kind == "moe":
        sh = _merge_params("moe", MOE_SHAPE, p)
        n_layers = sc.n_layers or 2
        if exact:
            plan = concat(
                [plan_ir.moe_layer_plan(
                    sh["n_tokens"], sh["d_model"], sh["n_experts"],
                    sh["top_k"], sh["d_ff"], sc.dtype,
                    capacity_factor=sh["capacity_factor"], layer=i,
                    x="x" if i == 0 else f"M{i-1}.out",
                    page_bytes=sc.page_bytes)
                 for i in range(n_layers)], name=f"moe_x{n_layers}")
        else:
            plan = plan_ir.moe_schedule(
                sh["n_tokens"], sh["d_model"], sh["n_experts"],
                sh["top_k"], sh["d_ff"], n_layers, sc.dtype,
                capacity_factor=sh["capacity_factor"],
                page_bytes=sc.page_bytes, sample_stride=ss)
    elif target.kind == "ssm":
        sh = _merge_params("ssm", SSM_SHAPE, p)
        n_layers = sc.n_layers or 2
        if exact:
            plan = concat(
                [plan_ir.ssm_layer_plan(
                    sh["T"], sh["d_model"], sh["n_heads"], sc.dtype,
                    chunk=sh["chunk"], layer=i,
                    x="x" if i == 0 else f"S{i-1}.out",
                    page_bytes=sc.page_bytes)
                 for i in range(n_layers)], name=f"ssm_x{n_layers}")
        else:
            plan = plan_ir.ssm_schedule(
                sh["T"], sh["d_model"], sh["n_heads"], n_layers,
                sc.dtype, chunk=sh["chunk"],
                page_bytes=sc.page_bytes, sample_stride=ss)
    elif target.kind == "decode":
        sh = _merge_params("decode", DECODE_SHAPE, p)
        np_dt = plan_ir.np_dtype_for(sc.dtype)
        pt, elem = _decode_table(sh, np_dt)
        slots = list(range(len(sh["prompt_lens"])))
        tables = [pt.tables[s, :int(pt.held[s])] for s in slots]
        lens = [int(pt.lens[s]) for s in slots]
        n_layers = sc.n_layers or 1
        if exact or n_layers == 1:
            plan = plan_ir.decode_step_plan(
                tables, lens, sh["page_tokens"], sh["n_kv_heads"],
                sh["head_dim"], elem, n_q_heads=sh["n_q_heads"],
                n_layers=n_layers)
        else:
            plan = plan_ir.decode_step_schedule(
                tables, lens, sh["page_tokens"], sh["n_kv_heads"],
                sh["head_dim"], elem, n_layers,
                n_q_heads=sh["n_q_heads"])
    else:
        raise UnsupportedScenario(
            f"scenario kind {target.kind!r} has no plan lowering")
    if isinstance(plan, PlanSchedule):
        return plan, plan.name, plan.sampled_events, plan.exact_events
    return plan, plan.name, len(plan.events), plan.n_exact_events


def _plan_for(sc: Scenario, target: _Target):
    global cache_hits, cache_misses
    key = _plan_key(sc)
    hit = _cache_get(_PLAN_CACHE, key)
    if hit is not None:
        cache_hits += 1
        return hit
    cache_misses += 1
    built = _build_plan(sc, target)
    _cache_put(_PLAN_CACHE, _PLAN_CACHE_MAX, key, built)
    return built


def _serve_trace(sc: Scenario, device):
    """Run the reduced continuous-batching engine on ``device`` with
    plan recording and cache (trace, schedule): the engine run dwarfs
    replay cost, and every memory mode prices the same trace.  The
    weights come from a seeded generator; with no end-of-sequence token
    every request runs its ``max_new_tokens``, so the trace does not
    depend on the weights or on the device.  The device is part of the
    cache key all the same, so a run on one device never reads the
    other's trace."""
    global cache_hits, cache_misses
    sh = _merge_params("serve", SERVE_SHAPE, sc.param_dict())
    key = tuple(sorted(sh.items())) + (("device", str(device)),)
    hit = _cache_get(_TRACE_CACHE, key)
    if hit is not None:
        cache_hits += 1
        return hit
    cache_misses += 1
    import numpy as np
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.sim_report import trace_schedule
    cfg = get_reduced(sh["arch"])
    model = Model(cfg, device=device)
    params = model.init(
        torch.Generator(device=model.device).manual_seed(0))
    rng = np.random.default_rng(sh["seed"])
    eng = ServingEngine(cfg, params, slots=sh["slots"],
                        max_seq=sh["max_seq"], device=model.device,
                        record_plans=True)
    lo, hi = sh["prompt_lo"], sh["prompt_hi"]
    for i in range(sh["n_requests"]):
        size = lo if lo >= hi else int(rng.integers(lo, hi))
        eng.submit(Request(
            uid=i, prompt=rng.integers(1, 250, size=size
                                       ).astype(np.int32),
            max_new_tokens=sh["max_new_tokens"]))
    eng.run_until_drained(max_steps=10 * sh["n_requests"] *
                          sh["max_new_tokens"] + 1000)
    out = (eng.trace, trace_schedule(eng.trace))
    _cache_put(_TRACE_CACHE, _TRACE_CACHE_MAX, key, out)
    return out


# ================================================================ façade
def _resolved_engine(engine: Optional[str], n_events: int) -> str:
    """The engine a fresh (reset=True) replay of ``n_events`` actually
    uses — the single place SimResult labels resolve ``auto`` through
    the pipeline's own size rule."""
    if engine is not None:
        return engine
    from repro_torch.accesys.pipeline import _use_compiled
    return "compiled" if _use_compiled("auto", n_events, True) \
        else "event"


def system_for(sc: Scenario):
    """The accesys ``SystemConfig`` a scenario runs on."""
    from repro_torch.accesys.components import DRAM
    from repro_torch.accesys.system import default_system
    dtype = "fp16" if resolve(sc.model).kind == "serve" else sc.dtype
    dram = DRAM(sc.devmem_dram) if sc.mode == "DevMem" else None
    from repro_torch.accesys.system import pcie_for_bw
    pcie = pcie_for_bw(sc.pcie_gb_s) if sc.pcie_gb_s is not None \
        else None
    cfg = default_system(sc.mode, dtype=dtype, pcie=pcie, dram=dram)
    cfg.fabric = MD.parse_fabric(sc.fabric)
    if sc.page_bytes != cfg.page_bytes:
        cfg.page_bytes = sc.page_bytes
        cfg.llc = dataclasses.replace(cfg.llc,
                                      page_bytes=sc.page_bytes)
    return cfg


def scenario_plan(sc: Scenario, device="cuda"):
    """Public lowering hook: (plan_or_schedule, label, events_replayed,
    events_total).  Serve scenarios lower to the recorded trace's
    repeat-1 schedule, recorded by the engine on ``device``."""
    target = resolve(sc.model)
    if target.kind == "serve":
        _check_sharding(sc, target)
        _, sched = _serve_trace(sc, device)
        return sched, sched.name, sched.sampled_events, \
            sched.sampled_events
    return _plan_for(sc, target)


def _simulate_serve(sc: Scenario, engine: Optional[str],
                    host_s_per_elem: Optional[float],
                    device) -> SimResult:
    from repro_torch.accesys.pipeline import HOST_S_PER_ELEM
    from repro_torch.serving.sim_report import simulate_serving_trace
    trace, sched = _serve_trace(sc, device)
    cfg = system_for(sc)
    t0 = time.perf_counter()
    rep = simulate_serving_trace(
        cfg, trace, sched=sched,
        host_s_per_elem=host_s_per_elem or HOST_S_PER_ELEM,
        engine=engine)
    wall = time.perf_counter() - t0
    decode_steps = sum(1 for r in trace if r.kind == "decode")
    decode_s = sum(s for s, r in zip(rep.per_event_s, trace)
                   if r.kind == "decode")
    serving = dict(rep.percentiles())
    serving.update({
        "decode_steps": decode_steps,
        "prefills": len(trace) - decode_steps,
        "sim_us_per_decode_step":
            decode_s * 1e6 / max(decode_steps, 1),
        "prefill_share": 1.0 - decode_s / max(rep.total_s, 1e-30),
    })
    return SimResult(
        scenario=sc, label=f"serve_trace({len(trace)} records)",
        mode=sc.mode,
        engine=_resolved_engine(engine, sched.sampled_events),
        result=rep.result,
        events_replayed=sched.sampled_events,
        events_total=sched.sampled_events, wall_s=wall,
        serving=serving)


def simulate(sc: Scenario, *,
             host_s_per_elem: Optional[float] = None,
             device="cuda") -> SimResult:
    """Lower ``sc`` to a plan, replay it on the scenario's system
    config, and return a ``SimResult``.  ``engine="both"`` runs the
    compiled AND event engines, asserts field-exact parity (rtol
    1e-9), and returns the compiled result tagged ``both``.

    ``device`` is where a ``serve`` scenario's engine runs (the card
    unless the caller asks for ``"cpu"``); the replay itself is numpy
    on the host, and no other kind reads it."""
    if sc.engine == "both":
        a = simulate(dataclasses.replace(sc, engine="compiled"),
                     host_s_per_elem=host_s_per_elem, device=device)
        b = simulate(dataclasses.replace(sc, engine="event"),
                     host_s_per_elem=host_s_per_elem, device=device)
        assert_parity(a, b)
        a.engine = "both"
        return a
    engine = None if sc.engine == "auto" else sc.engine
    target = resolve(sc.model)
    if target.kind == "serve":
        _check_sharding(sc, target)
        return _simulate_serve(sc, engine, host_s_per_elem, device)
    from repro_torch.accesys.pipeline import HOST_S_PER_ELEM, replay
    plan, label, replayed, total = _plan_for(sc, target)
    cfg = system_for(sc)
    t0 = time.perf_counter()
    result = replay(cfg, plan,
                    host_s_per_elem=host_s_per_elem or HOST_S_PER_ELEM,
                    engine=engine)
    wall = time.perf_counter() - t0
    return SimResult(scenario=sc, label=label, mode=sc.mode,
                     engine=_resolved_engine(engine, replayed),
                     result=result, events_replayed=replayed,
                     events_total=total, wall_s=wall)


def sweep(scenarios: Sequence[Scenario], *,
          host_s_per_elem: Optional[float] = None,
          tp_degrees: Optional[Sequence[int]] = None,
          device="cuda") -> list:
    """Simulate many scenarios.  Scenarios that differ only in memory
    mode / engine / DevMem DRAM (or fabric/host-link bandwidth) share
    one lowered plan (and its compiled form and trace-intrinsic LRU
    analysis) through the plan cache — the paper's design-space sweeps
    in one call.  ``tp_degrees`` crosses every scenario with a list of
    tensor-parallel degrees (the TP-degree axis of the multi-device
    sweep).  ``device`` is where ``serve`` scenarios' engine runs."""
    if tp_degrees:
        scenarios = [dataclasses.replace(sc, tp=tp)
                     for sc in scenarios for tp in tp_degrees]
    return [simulate(sc, host_s_per_elem=host_s_per_elem, device=device)
            for sc in scenarios]


# ========================================================= design search
@dataclasses.dataclass
class TunedPoint:
    """One scored design-space candidate."""
    point: object                  # design_space.DesignPoint
    result: object                 # accesys GemmResult
    area_um2: float                # accelerator-silicon area proxy
    score: float                   # objective value (lower is better)
    on_pareto: bool = False        # latency-vs-area non-dominated

    @property
    def total_s(self) -> float:
        return self.result.total_s

    def to_json(self) -> dict:
        return {"point": dataclasses.asdict(self.point),
                "label": self.point.label(),
                "total_us": self.total_s * 1e6,
                "area_mm2": self.area_um2 / 1e6,
                "score": self.score,
                "on_pareto": self.on_pareto}


@dataclasses.dataclass
class TuneResult:
    """Result of one ``tune()`` search: every scored point (input
    order), the latency-vs-area Pareto frontier, and the sweep
    throughput the config-batched replayer achieved."""
    scenario: Scenario
    objective: str
    points: list                   # [TunedPoint]
    n_infeasible: int              # filtered before pricing
    wall_s: float

    SCHEMA = "tuneresult/v1"

    @property
    def pareto(self) -> list:
        return [tp for tp in self.points if tp.on_pareto]

    @property
    def best(self) -> TunedPoint:
        return min(self.points, key=lambda tp: tp.score)

    @property
    def configs_per_s(self) -> float:
        return len(self.points) / max(self.wall_s, 1e-9)

    def to_json(self) -> dict:
        return {"schema": self.SCHEMA,
                "scenario": self.scenario.to_json(),
                "objective": self.objective,
                "n_points": len(self.points),
                "n_infeasible": self.n_infeasible,
                "wall_s": round(self.wall_s, 6),
                "configs_per_s": round(self.configs_per_s, 1),
                "best": self.best.to_json(),
                "pareto": [tp.to_json() for tp in self.pareto],
                "points": [tp.to_json() for tp in self.points]}


def _tune_group(payload: tuple) -> list:
    """Price one (dtype, page_bytes) tune group: lower the scenario
    once and config-batch-replay every design point of the group.
    Module-level and plain-data in/out (Scenario + DesignPoints in,
    GemmResults out) so ``tune(workers=N)`` can fan groups over a
    process pool; scoring stays in the parent, so the objective
    callable never needs to be picklable."""
    sc, dt, pb, points, hpe, in_worker = payload
    from repro_torch.accesys.pipeline import release_scratch, replay_batch
    from repro_torch.core import design_space as DS
    plan, _, _, _ = _plan_for(
        dataclasses.replace(sc, dtype=dt, page_bytes=pb),
        resolve(sc.model))
    results = replay_batch(
        [DS.system_for_point(p) for p in points], plan,
        host_s_per_elem=hpe)
    if in_worker:
        release_scratch()      # workers drop their scratch before exit
    return results


def tune(sc: Scenario, space=None, objective="latency", *,
         host_s_per_elem: Optional[float] = None,
         workers: int = 1) -> TuneResult:
    """Search a co-design knob space against one workload: lower ``sc``
    once per distinct (dtype, page_bytes) — those change the plan — and
    price every ``DesignPoint`` of each group in ONE config-batched
    replay (``replay_batch``), so an N-point sweep costs one trace
    analysis plus a vectorized pricing pass instead of N replays.

    ``space`` is a ``design_space.DesignSpace`` (default:
    ``default_space()``) or an explicit iterable of ``DesignPoint``s;
    infeasible points (buffer budget too small for the streaming
    schedule) are filtered and counted.  ``objective`` is ``"latency"``
    or a callable ``(point, result) -> float`` (lower is better); the
    latency-vs-area Pareto frontier is marked regardless of objective.
    Per-point results equal a sequential ``simulate()`` of the same
    configuration at rtol 1e-9 — DM/DC/DevMem orderings match
    ``sweep()``.

    ``workers > 1`` fans the per-(dtype, page_bytes) groups over a
    process pool (each worker prices its groups with its own scratch
    pool and releases it on the way out); results and ordering are
    identical to ``workers=1``."""
    from repro_torch.accesys.pipeline import HOST_S_PER_ELEM
    from repro_torch.core import design_space as DS
    target = resolve(sc.model)
    if target.kind == "serve":
        raise UnsupportedScenario(
            "tune() prices plan/schedule scenarios; serve traces have "
            "per-request semantics — sweep() them per config instead")
    if space is None:
        space = DS.default_space()
    pts = list(space.grid()) if isinstance(space, DS.DesignSpace) \
        else [p.canonical() for p in space]
    n_bad = sum(1 for p in pts if not p.feasible)
    pts = [p for p in pts if p.feasible]
    if not pts:
        raise UnsupportedScenario(
            "design space has no feasible points (buffer_kb below "
            "every point's required_buffer_kb)")
    if callable(objective):
        score_fn = objective
        obj_name = getattr(objective, "__name__", "custom")
    elif objective == "latency":
        def score_fn(point, r):
            return r.total_s
        obj_name = "latency"
    else:
        raise UnsupportedScenario(
            f"unknown tune objective {objective!r}; valid: 'latency' "
            "or a callable (point, result) -> float")
    t0 = time.perf_counter()
    groups: "OrderedDict[tuple, list]" = OrderedDict()
    for i, p in enumerate(pts):
        groups.setdefault((p.dtype, p.page_bytes), []).append(i)
    scored: list = [None] * len(pts)
    hpe = host_s_per_elem or HOST_S_PER_ELEM
    ex = _pool_executor(min(workers, len(groups)))
    payloads = [(sc, dt, pb, [pts[i] for i in idxs], hpe, ex is not None)
                for (dt, pb), idxs in groups.items()]
    try:
        group_results = list(ex.map(_tune_group, payloads)) \
            if ex is not None else [_tune_group(p) for p in payloads]
    finally:
        if ex is not None:
            ex.shutdown()
    for idxs, results in zip(groups.values(), group_results):
        for i, r in zip(idxs, results):
            scored[i] = TunedPoint(
                point=pts[i], result=r,
                area_um2=DS.point_area_um2(pts[i]),
                score=score_fn(pts[i], r))
    wall = time.perf_counter() - t0
    from repro_torch.accesys.pipeline import release_scratch
    release_scratch()          # batched pricing holds peak scratch
    for i in DS.pareto_front((tp.total_s, tp.area_um2)
                             for tp in scored):
        scored[i].on_pareto = True
    return TuneResult(scenario=sc, objective=obj_name, points=scored,
                      n_infeasible=n_bad, wall_s=wall)


def sampling_error(sc: Scenario, *,
                   host_s_per_elem: Optional[float] = None,
                   device="cuda") -> SimResult:
    """Steady-state sampling error bars: run ``sc`` sampled AND exact
    (compiled engine makes the exact run cheap) and return the sampled
    ``SimResult`` with ``sampling_error`` filled in — per-total and
    per-bucket relative error vs the exact replay."""
    sampled = simulate(dataclasses.replace(sc, sampling="sampled"),
                       host_s_per_elem=host_s_per_elem, device=device)
    exact = simulate(dataclasses.replace(sc, sampling="exact"),
                     host_s_per_elem=host_s_per_elem, device=device)
    eb, sb = exact.result.buckets(), sampled.result.buckets()
    sampled.sampling_error = {
        "exact_total_us": exact.total_s * 1e6,
        "sampled_total_us": sampled.total_s * 1e6,
        "rel_err_total": abs(sampled.total_s - exact.total_s)
            / max(exact.total_s, 1e-30),
        "abs_err_bucket_shares": {k: abs(sb[k] - eb[k]) for k in eb},
        "events_exact": exact.events_replayed,
        "events_sampled": sampled.events_replayed,
        "events_ratio": exact.events_replayed
            / max(sampled.events_replayed, 1),
    }
    return sampled


# ============================================================ load sweep
LOAD_SHAPE = dict(arch="qwen2_0_5b", slots=4, max_seq=96,
                  prompt_lo=8, prompt_hi=24, max_new_tokens=8,
                  prefill_chunk_tokens=16, kv_page_tokens=8,
                  prefix_tokens=0, seed=0, kv_pool_pages=None)


@dataclasses.dataclass
class LoadPoint:
    """One (offered QPS, memory mode) cell of a load sweep."""
    qps: float                     # offered arrival rate
    mode: str
    percentiles: dict              # ServingSimReport.percentiles()
    total_s: float                 # simulated time to drain the trace
    n_finished: int
    n_records: int
    n_events: int
    drained: bool = True           # False: hit max_steps with work left

    @property
    def goodput_qps(self) -> float:
        return self.n_finished / max(self.total_s, 1e-30)

    def to_json(self) -> dict:
        return {"qps": self.qps, "mode": self.mode,
                "total_s": self.total_s,
                "goodput_qps": self.goodput_qps,
                "n_finished": self.n_finished,
                "n_records": self.n_records,
                "n_events": self.n_events,
                "drained": self.drained, **self.percentiles}


@dataclasses.dataclass
class LoadSweepResult:
    """Offered-QPS vs tail-latency curves per memory mode, the
    saturation knee per mode, and (when a shared prefix is configured)
    the prefix-caching on/off delta at the reference load."""
    arch: str
    arrivals: str
    qps: tuple                     # ascending offered-rate grid
    modes: tuple
    n_requests: int
    points: list                   # [LoadPoint], qps-major, mode order
    knee_qps: dict                 # mode -> first saturated qps | None
    calibration: dict              # est_step_s / est_prefill_s_per_token
    prefix_delta: Optional[dict] = None   # mode -> on/off tails
    wall_s: float = 0.0
    preempt: str = "none"          # preemption policy the sweep ran with
    kv_pool_pages: Optional[int] = None   # actual pool cap (None: full)

    SCHEMA = "loadsweep/v1"

    def curve(self, mode: str) -> list:
        return [pt for pt in self.points if pt.mode == mode]

    def to_json(self) -> dict:
        return {"schema": self.SCHEMA, "arch": self.arch,
                "arrivals": self.arrivals, "qps": list(self.qps),
                "modes": list(self.modes),
                "n_requests": self.n_requests,
                "knee_qps": self.knee_qps,
                "calibration": self.calibration,
                "prefix_delta": self.prefix_delta,
                "wall_s": round(self.wall_s, 3),
                "preempt": self.preempt,
                "kv_pool_pages": self.kv_pool_pages,
                "points": [pt.to_json() for pt in self.points]}


def load_capacity_qps(est_step_s: float, est_prefill_s_per_token: float,
                      *, mean_prompt: float, max_new_tokens: int,
                      slots: int) -> float:
    """The service capacity ``sweep_load`` brackets its grid around:
    one request's prefill of ``mean_prompt`` tokens plus its share of
    the decode steps, ``max_new_tokens`` steps shared by ``slots``."""
    return 1.0 / (est_prefill_s_per_token * mean_prompt
                  + est_step_s * max_new_tokens / slots)


def pressured_pool_pages(*, longest_prompt: int, max_new_tokens: int,
                         max_seq: int, kv_page_tokens: int, slots: int,
                         prefix_tokens: int = 0) -> int:
    """``sweep_load``'s KV pool under preemption: without a cap the full
    pool never defers and no preemption can ever fire, so cap it at
    ~60% of the all-slots worst case while guaranteeing any single
    request (and the shared prefix) still fits."""
    pt = kv_page_tokens
    worst = min(prefix_tokens + longest_prompt + max_new_tokens, max_seq)
    worst_pages = -(-worst // pt)
    return prefix_tokens // pt + max(worst_pages + 1,
                                     int(slots * worst_pages * 0.6))


def _run_load_point(payload: tuple) -> list:
    """Price ONE offered rate across every memory mode: rebuild the
    engine and system configs from the plain-data payload (picklable,
    so ``sweep_load(workers=N)`` can fan rates over a process pool),
    run the two-pass streamed replay, and return the per-mode
    ``LoadPoint`` list.  Pure in the payload — a workers=N sweep is
    byte-identical to workers=1, which runs this same function
    inline."""
    import numpy as np
    from repro_torch.accesys.pipeline import (release_scratch,
                                        replay_trace_streamed)
    from repro_torch.configs import get_reduced
    from repro_torch.core.plan import _plan_n_events, trace_footprint
    from repro_torch.serving.engine import (Request, ServingEngine,
                                            arrival_times)
    from repro_torch.serving.sim_report import ServingAccumulator

    (sh, pool, modes, arrivals, n_requests, open_kw, hpe,
     chunk_events, lam, caching, templated, in_worker) = payload
    cfg_model = get_reduced(sh["arch"])
    sys_cfgs = [system_for(Scenario(model="serve", mode=m))
                for m in modes]

    def mk_engine() -> ServingEngine:
        return ServingEngine(
            cfg_model, slots=sh["slots"], max_seq=sh["max_seq"],
            plan_only=True, kv_page_tokens=sh["kv_page_tokens"],
            kv_pool_pages=pool, templated=templated,
            prefix_tokens=sh["prefix_tokens"], prefix_caching=caching)

    def mk_requests() -> list:
        rng = np.random.default_rng(sh["seed"] + 1)
        lo, hi = sh["prompt_lo"], sh["prompt_hi"]
        return [Request(
            uid=i,
            prompt=rng.integers(
                1, 250,
                size=lo if lo >= hi else int(rng.integers(lo, hi))
            ).astype(np.int32),
            max_new_tokens=sh["max_new_tokens"])
            for i in range(n_requests)]

    arr = arrival_times(arrivals, n_requests, lam, seed=sh["seed"])
    eng1 = mk_engine()
    counts = {"records": 0, "events": 0}

    def plans_pass1():
        for rec in eng1.open_loop_records(mk_requests(), arr,
                                          **open_kw):
            counts["records"] += 1
            counts["events"] += _plan_n_events(rec.plan)
            yield rec.plan
    foot = trace_footprint(plans_pass1())
    acc = ServingAccumulator()
    eng2 = mk_engine()

    def plans_pass2():
        return (rec.plan for rec in acc.wrap(
            eng2.open_loop_records(mk_requests(), arr, **open_kw)))
    results, pers = replay_trace_streamed(
        sys_cfgs, plans_pass2, host_s_per_elem=hpe,
        footprint_pages=foot, chunk_events=chunk_events)
    live = eng2.unfinished_uids()
    pts = [LoadPoint(
        qps=lam, mode=m, percentiles=rep.percentiles(),
        total_s=rep.total_s, n_finished=eng2.n_finished,
        n_records=counts["records"], n_events=counts["events"],
        drained=eng2.stats.drained)
        for m, rep in zip(modes, (
            acc.report(m, r, p, live)
            for m, r, p in zip(modes, results, pers)))]
    if in_worker:
        release_scratch()      # workers drop their scratch before exit
    return pts


def sweep_load(qps=None, *, n_requests: int = 1000,
               arrivals: str = "poisson", modes=MODES,
               prefix_caching: bool = True,
               chunk_events: int = 262_144, knee_factor: float = 3.0,
               max_steps: int = 1_000_000,
               preempt: str = "none", stall_budget_s: float = 0.0,
               host_s_per_elem: Optional[float] = None,
               workers: int = 1, templated: bool = True,
               **shape) -> LoadSweepResult:
    """Capacity-plan an open-loop serving workload: drive the
    plan-only engine at each offered rate in ``qps`` (auto: a grid
    bracketing the calibrated service capacity), stream every trace
    through ONE chunked multi-mode replay
    (``replay_trace_streamed`` — O(chunk) memory, all memory modes in
    a single pass), and fold the priced durations back onto requests.

    Returns offered-QPS vs TTFT/TPOT p50/p95/p99 curves per memory
    mode plus the saturation knee — the first grid rate whose TTFT
    p99 exceeds ``knee_factor`` x the unloaded (lowest-rate) baseline.
    With ``prefix_tokens`` set in ``shape``, the main curves run with
    ``prefix_caching`` as given and the opposite setting is measured
    once at the reference (lowest) rate — the on/off delta.

    ``preempt`` ("lifo" | "longest") sweeps the swap-thrash regime:
    unless ``kv_pool_pages`` is given in ``shape``, the KV pool is
    capped well below the all-slots worst case so admission stalls
    past ``stall_budget_s`` trigger preemption + KV swap-to-host, and
    the grid is extended (bounded doubling) until every mode has at
    least one priced point STRICTLY past its knee — the curve the
    report's swap/queue percentiles and preemption counts describe.

    The engine's admission clock is calibrated from a small probe
    trace priced on the DC system; reported latencies always come
    from the replay itself, never from the estimates.

    ``workers > 1`` fans the offered-rate grid over a process pool
    (each worker re-derives its traces and prices with its own scratch
    pool, released on the way out); the grid extensions and the prefix
    delta stay sequential because they depend on earlier points.  The
    result is byte-identical to ``workers=1``, and — since templated
    plans replay bitwise identically — to ``templated=False``, which
    rebuilds every plan as a fresh event graph (the pre-templating
    path, kept for benchmarking the template speedup)."""
    import numpy as np
    from repro_torch.accesys.pipeline import (HOST_S_PER_ELEM, release_scratch,
                                        replay_trace)
    from repro_torch.configs import get_reduced
    from repro_torch.serving.engine import Request, ServingEngine

    t0 = time.perf_counter()
    sh = _merge_params("load", LOAD_SHAPE, shape)
    hpe = host_s_per_elem or HOST_S_PER_ELEM
    modes = tuple(modes)
    cfg_model = get_reduced(sh["arch"])

    pool = sh["kv_pool_pages"]
    if pool is None and preempt != "none":
        pool = pressured_pool_pages(
            longest_prompt=sh["prompt_lo"]
            if sh["prompt_lo"] >= sh["prompt_hi"] else sh["prompt_hi"] - 1,
            max_new_tokens=sh["max_new_tokens"], max_seq=sh["max_seq"],
            kv_page_tokens=sh["kv_page_tokens"], slots=sh["slots"],
            prefix_tokens=sh["prefix_tokens"])

    def mk_engine(caching: bool) -> ServingEngine:
        return ServingEngine(
            cfg_model, slots=sh["slots"], max_seq=sh["max_seq"],
            plan_only=True, kv_page_tokens=sh["kv_page_tokens"],
            kv_pool_pages=pool, templated=templated,
            prefix_tokens=sh["prefix_tokens"], prefix_caching=caching)

    def mk_requests(n: int) -> list:
        rng = np.random.default_rng(sh["seed"] + 1)
        lo, hi = sh["prompt_lo"], sh["prompt_hi"]
        return [Request(
            uid=i,
            prompt=rng.integers(
                1, 250,
                size=lo if lo >= hi else int(rng.integers(lo, hi))
            ).astype(np.int32),
            max_new_tokens=sh["max_new_tokens"])
            for i in range(n)]

    # ---- calibrate the admission clock on a small priced probe (DC)
    probe = mk_engine(prefix_caching and sh["prefix_tokens"] > 0)
    probe.run_open_loop(
        mk_requests(min(8, n_requests)), np.zeros(min(8, n_requests)),
        prefill_chunk_tokens=sh["prefill_chunk_tokens"])
    dc = system_for(Scenario(model="serve", mode="DC"))
    _, probe_per = replay_trace(dc, [r.plan for r in probe.trace],
                                host_s_per_elem=hpe)
    dec = [s for s, r in zip(probe_per, probe.trace)
           if r.kind == "decode"]
    pft = [(s, r.n_tokens) for s, r in zip(probe_per, probe.trace)
           if r.kind == "prefill" and r.n_tokens]
    est_step = float(np.mean(dec)) if dec else 1e-4
    est_pf = float(sum(s for s, _ in pft)
                   / max(sum(n for _, n in pft), 1))
    mean_prompt = sh["prefix_tokens"] + \
        (sh["prompt_lo"] + max(sh["prompt_lo"], sh["prompt_hi"] - 1)) / 2
    cap_qps = load_capacity_qps(est_step, est_pf, mean_prompt=mean_prompt,
                                max_new_tokens=sh["max_new_tokens"],
                                slots=sh["slots"])
    if qps is None:
        qps = tuple(round(cap_qps * f, 3)
                    for f in (0.25, 0.5, 1.0, 2.0, 4.0))
    qps = tuple(sorted(float(q) for q in qps))
    open_kw = dict(est_step_s=est_step, est_prefill_s_per_token=est_pf,
                   prefill_chunk_tokens=sh["prefill_chunk_tokens"],
                   max_steps=max_steps, preempt=preempt,
                   stall_budget_s=stall_budget_s)

    ex = _pool_executor(workers)

    def price(lams, caching: bool) -> list:
        """Per-mode LoadPoints for each rate in ``lams``, in order —
        inline when serial, fanned over the pool otherwise."""
        payloads = [(sh, pool, modes, arrivals, n_requests, open_kw,
                     hpe, chunk_events, lam, caching, templated,
                     ex is not None)
                    for lam in lams]
        if ex is None:
            return [_run_load_point(p) for p in payloads]
        return list(ex.map(_run_load_point, payloads))

    caching_main = prefix_caching and sh["prefix_tokens"] > 0
    points: list = []
    try:
        for mode_pts in price(qps, caching_main):
            points += mode_pts

        def compute_knee() -> dict:
            knee = {}
            for m in modes:
                curve = [pt for pt in points if pt.mode == m]
                base = curve[0].percentiles["ttft_p99_us"]
                knee[m] = next(
                    (pt.qps for pt in curve
                     if pt.percentiles["ttft_p99_us"]
                     > knee_factor * base), None)
            return knee

        knee = compute_knee()
        # preemption sweeps must price the thrash regime: keep doubling
        # the top rate (bounded) until every mode has a grid point
        # STRICTLY past its knee
        extensions = 0
        while preempt != "none" and extensions < 3 and any(
                knee[m] is None or knee[m] >= qps[-1] for m in modes):
            lam = round(qps[-1] * 2.0, 3)
            qps = qps + (lam,)
            points += price((lam,), caching_main)[0]
            knee = compute_knee()
            extensions += 1
        prefix_delta = None
        if sh["prefix_tokens"] > 0:
            other = price((qps[0],), not caching_main)[0]
            prefix_delta = {}
            for pt_main, pt_other in zip(
                    [pt for pt in points if pt.qps == qps[0]], other):
                on, off = (pt_main, pt_other) if caching_main else \
                    (pt_other, pt_main)
                prefix_delta[pt_main.mode] = {
                    "ttft_p99_us_on": on.percentiles["ttft_p99_us"],
                    "ttft_p99_us_off": off.percentiles["ttft_p99_us"],
                    "total_s_on": on.total_s,
                    "total_s_off": off.total_s,
                    "records_on": on.n_records,
                    "records_off": off.n_records}
    finally:
        if ex is not None:
            ex.shutdown()
    release_scratch()
    return LoadSweepResult(
        arch=sh["arch"], arrivals=arrivals, qps=qps, modes=modes,
        n_requests=n_requests, points=points, knee_qps=knee,
        calibration={"est_step_s": est_step,
                     "est_prefill_s_per_token": est_pf,
                     "capacity_qps_est": cap_qps},
        prefix_delta=prefix_delta,
        wall_s=time.perf_counter() - t0,
        preempt=preempt, kv_pool_pages=pool)
