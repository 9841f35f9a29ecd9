"""The port's Scenario API, multi-device replay, serving report and
simulate CLI against the reference, exactly.

Each test feeds both packages the same scenario and compares the
results with ``==`` (NaN-aware, through ``np.testing.assert_equal``),
leaving out only wall-clock fields.  The ``serve`` scenario runs the
port's engine with ``device="cpu"`` and the reference's JAX engine;
with no end-of-sequence token both record the same trace, whatever the
weights.
"""
import contextlib
import dataclasses
import io
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.accesys import pipeline as RP  # noqa: E402
from repro.core import design_space as RD  # noqa: E402
from repro.core import multidev as RM  # noqa: E402
from repro.core import plan as RPl  # noqa: E402
from repro.core import scenario as RS  # noqa: E402
from repro.launch import simulate as RCLI  # noqa: E402
from repro.serving import sim_report as RR  # noqa: E402
from repro.sharding import logical as RL  # noqa: E402
from repro_torch.accesys import pipeline as TP  # noqa: E402
from repro_torch.core import design_space as TD  # noqa: E402
from repro_torch.core import multidev as TM  # noqa: E402
from repro_torch.core import plan as TPl  # noqa: E402
from repro_torch.core import scenario as TS  # noqa: E402
from repro_torch.launch import simulate as TCLI  # noqa: E402
from repro_torch.serving import sim_report as TR  # noqa: E402
from repro_torch.sharding import logical as TL  # noqa: E402

MODES = ("DM", "DC", "DevMem")
ROOT = Path(__file__).resolve().parents[1]
WALL = ("wall_s", "configs_per_s")


def _sim(res) -> dict:
    out = dataclasses.asdict(res)
    out.pop("wall_s")
    return out


def _pair(**kw):
    """The same scenario in both packages."""
    return RS.Scenario(**kw), TS.Scenario(**kw)


# -------------------------------------------------------------- registry
def test_scenario_names_and_resolution_match_reference():
    assert TS.scenario_names() == RS.scenario_names()
    for name in TS.scenario_names():
        t, r = TS.resolve(name), RS.resolve(name)
        assert (t.kind, t.default_seq) == (r.kind, r.default_seq)
        if t.config is not None:
            assert dataclasses.asdict(t.config) == \
                dataclasses.asdict(r.config)
    with pytest.raises(TS.UnsupportedScenario) as got:
        TS.resolve("bert-bas")
    with pytest.raises(RS.UnsupportedScenario) as want:
        RS.resolve("bert-bas")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("i", range(len(RS.smoke_matrix())))
def test_smoke_matrix_scenario_matches_reference(i):
    """Each scenario of the smoke matrix (one reduced config per family
    plus the decode class), run with engine parity asserted inside
    ``simulate``, gives the reference's ``SimResult``."""
    st, sr = TS.smoke_matrix()[i], RS.smoke_matrix()[i]
    assert dataclasses.asdict(st) == dataclasses.asdict(sr)
    for mode in MODES:
        got = TS.simulate(dataclasses.replace(st, mode=mode))
        want = RS.simulate(dataclasses.replace(sr, mode=mode))
        np.testing.assert_equal(_sim(got), _sim(want))
        assert got.to_json()["schema"] == want.to_json()["schema"]


def test_sampling_error_and_tp_sweep_match_reference():
    sr, st = _pair(model="moe")
    np.testing.assert_equal(_sim(TS.sampling_error(st)),
                            _sim(RS.sampling_error(sr)))
    sr, st = _pair(model="qwen2-0.5b-reduced", seq=32)
    got = TS.sweep([st], tp_degrees=(1, 2))
    want = RS.sweep([sr], tp_degrees=(1, 2))
    assert [_sim(g) for g in got] == [_sim(w) for w in want]


# ---------------------------------------------------------------- design
def _tune_json(res) -> dict:
    out = res.to_json()
    for k in WALL:
        out.pop(k)
    return out


def test_tune_workers_match_each_other_and_reference():
    """``tune`` at one and two workers gives the same scored points,
    Pareto marks and best point, equal to the reference's."""
    sr, st = _pair(model="bert-base", n_layers=2)
    pts_t = TD.default_space().sample(8, seed=0)
    pts_r = RD.default_space().sample(8, seed=0)
    one = TS.tune(st, pts_t, workers=1)
    two = TS.tune(st, pts_t, workers=2)
    want = RS.tune(sr, pts_r, workers=1)
    assert _tune_json(one) == _tune_json(two) == _tune_json(want)
    assert [dataclasses.asdict(p.result) for p in one.points] == \
        [dataclasses.asdict(p.result) for p in want.points]


def test_tune_workers_are_spawned():
    """Sweep workers are spawned, never forked (a process that served
    on the card holds a CUDA context a forked child must not touch)."""
    ex = TS._pool_executor(2)
    try:
        assert ex._mp_context.get_start_method() == "spawn"
    finally:
        ex.shutdown()
    assert TS._pool_executor(1) is None


# ------------------------------------------------------------ multidev
@pytest.mark.parametrize("shard", [dict(tp=2), dict(ep=2)])
@pytest.mark.parametrize("model", ["qwen2-moe-a2.7b-reduced",
                                   "deepseek-v3-reduced"])
def test_multidev_matches_reference(model, shard):
    """TP 2 and EP 2 on the reduced MoE configs: the sharded scenario's
    ``SimResult`` and the coupled two-rank ``replay_multidev`` of its
    plan equal the reference's."""
    sr, st = _pair(model=model, seq=32, sampling="exact", **shard)
    np.testing.assert_equal(_sim(TS.simulate(st)), _sim(RS.simulate(sr)))
    pr, pt = RS.scenario_plan(sr)[0], TS.scenario_plan(st)[0]
    got = TM.replay_multidev(TS.system_for(st), [pt, pt])
    want = RM.replay_multidev(RS.system_for(sr), [pr, pr])
    assert [dataclasses.asdict(g) for g in got] == \
        [dataclasses.asdict(w) for w in want]


def _rank_plan(pkg, md, n, tag):
    g = pkg.gemm_plan(n, n, n, "int8", a=f"{tag}a", b=f"{tag}b",
                      c=f"{tag}c")
    coll = md.rs_plan(2048, 4, "ring", "int8", name=f"{tag}rs")
    g2 = pkg.gemm_plan(n, n, n, "int8", a=f"{tag}c", b=f"{tag}b2",
                       c=f"{tag}d")
    return pkg.concat([g, coll, g2], name=f"{tag}step")


def test_multidev_asymmetric_ranks_and_partitioning_match_reference():
    cfg_t, cfg_r = TS.system_for(TS.Scenario(model="gemm")), \
        RS.system_for(RS.Scenario(model="gemm"))
    got = TM.replay_multidev(cfg_t, [_rank_plan(TPl, TM, 192, "s."),
                                     _rank_plan(TPl, TM, 96, "f.")])
    want = RM.replay_multidev(cfg_r, [_rank_plan(RPl, RM, 192, "s."),
                                      _rank_plan(RPl, RM, 96, "f.")])
    assert [dataclasses.asdict(g) for g in got] == \
        [dataclasses.asdict(w) for w in want]
    insts = TM.rank_instances(_rank_plan(TPl, TM, 96, ""), 3)
    want_insts = RM.rank_instances(_rank_plan(RPl, RM, 96, ""), 3)
    assert [cp.page_keys for cp in insts] == \
        [cp.page_keys for cp in want_insts]
    for name in ("heads", "kv_heads", "mlp", "expert", "embed", "vocab"):
        for size, p in ((64, 2), (6, 4), (8, 8), (3, 2)):
            assert TM.tp_split(size, name, p) == RM.tp_split(size, name, p)
    for multi_pod in (False, True):
        for long_context in (False, True):
            assert TL.make_rules(multi_pod, long_context) == \
                RL.make_rules(multi_pod, long_context)
    mesh = {"pod": 2, "data": 4, "model": 8}
    rules = TL.make_rules(True)
    for axes, shape in ((("batch", "seq", "embed_act"), (16, 128, 512)),
                        (("embed", "heads", "head_dim"), (512, 8, 64)),
                        (("embed", "kv_heads", "head_dim"), (512, 2, 64)),
                        (("expert", "embed", "mlp"), (60, 512, 1408)),
                        (("cache_batch", "cache_seq", "kv_heads", None),
                         (8, 1024, 4, 64)),
                        (("vocab", "embed"), (151936, 896))):
        assert TL.spec_for(axes, shape, rules, mesh) == \
            tuple(RL.spec_for(axes, shape, rules, mesh)), axes
    for spec in ("ring", "alltoall", "ring:64", "alltoall:16:800"):
        assert dataclasses.asdict(TM.parse_fabric(spec)) == \
            dataclasses.asdict(RM.parse_fabric(spec))


# --------------------------------------------------------------- serving
def _traces():
    """The reference engine's and the port's (on the CPU) recorded
    traces of the default serve scenario, with their schedules."""
    sr, st = _pair(model="serve")
    return RS._serve_trace(sr), TS._serve_trace(st, "cpu")


@pytest.mark.parametrize("mode", MODES)
def test_serve_scenario_on_the_cpu_matches_reference(mode):
    """The port's engine on the CPU records the reference engine's
    trace: one record per admission and per decode step, and the
    priced ``SimResult`` (percentiles included) is the reference's."""
    sr, st = _pair(model="serve", mode=mode)
    got = TS.simulate(st, device="cpu")
    want = RS.simulate(sr)
    np.testing.assert_equal(_sim(got), _sim(want))
    (rtrace, _), (ttrace, _) = _traces()
    assert [(r.kind, r.step_idx, r.slots, r.uids, r.arrival_event)
            for r in ttrace] == \
        [(r.kind, r.step_idx, r.slots, r.uids, r.arrival_event)
         for r in rtrace]
    n_req = dict(TS.SERVE_SHAPE)["n_requests"]
    assert sum(r.kind == "prefill" for r in ttrace) == n_req
    assert got.serving["decode_steps"] + n_req == len(ttrace)


def _report(rep) -> dict:
    out = dataclasses.asdict(rep)
    out["result"] = dataclasses.asdict(rep.result)
    return out


def test_replay_trace_and_streamed_match_reference():
    """One recorded trace priced by ``replay_trace`` (both engines), by
    ``replay_trace_streamed`` in small chunks over all three modes at
    once, and folded onto requests by ``simulate_serving_trace`` and
    ``ServingAccumulator``: every number equals the reference's."""
    (rtrace, rsched), (ttrace, tsched) = _traces()
    sr, st = _pair(model="serve")
    cfgs_r = [RS.system_for(dataclasses.replace(sr, mode=m))
              for m in MODES]
    cfgs_t = [TS.system_for(dataclasses.replace(st, mode=m))
              for m in MODES]
    for cr, ct in zip(cfgs_r, cfgs_t):
        for engine in ("event", "compiled"):
            got, per_t = TP.replay_trace(ct, tsched, engine=engine)
            want, per_r = RP.replay_trace(cr, rsched, engine=engine)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert np.array_equal(per_t, per_r)
        np.testing.assert_equal(
            _report(TR.simulate_serving_trace(ct, ttrace, sched=tsched)),
            _report(RR.simulate_serving_trace(cr, rtrace, sched=rsched)))
    got, per_t = TP.replay_trace_streamed(
        cfgs_t, [r.plan for r in ttrace], chunk_events=512)
    want, per_r = RP.replay_trace_streamed(
        cfgs_r, [r.plan for r in rtrace], chunk_events=512)
    assert [dataclasses.asdict(g) for g in got] == \
        [dataclasses.asdict(w) for w in want]
    for a, b in zip(per_t, per_r):
        assert np.array_equal(a, b)
    acc_t, acc_r = TR.ServingAccumulator(), RR.ServingAccumulator()
    res_t, p_t = TP.replay_trace_streamed(
        cfgs_t[1], lambda: (r.plan for r in acc_t.wrap(iter(ttrace))))
    res_r, p_r = RP.replay_trace_streamed(
        cfgs_r[1], lambda: (r.plan for r in acc_r.wrap(iter(rtrace))))
    acc_t.meta = acc_t.meta[len(ttrace):]     # the priced pass only
    acc_r.meta = acc_r.meta[len(rtrace):]
    np.testing.assert_equal(_report(acc_t.report("DC", res_t, p_t)),
                            _report(acc_r.report("DC", res_r, p_r)))


# ------------------------------------------------------------------- CLI
def _cli_lines(main, argv) -> list:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    # wall-clock and events/s are the only host-timed fields
    return [line.split("  [")[0] if "wall=" in line else line
            for line in buf.getvalue().splitlines()]


@pytest.mark.parametrize("argv", [
    ["--gemm", "512", "512", "512"],
    ["--workload", "bert-medium", "--layers", "2"],
    ["--smoke"],
    ["--workload", "serve", "--modes", "DC"],
], ids=["gemm", "bert-medium", "smoke", "serve"])
def test_cli_prints_the_reference_lines(argv):
    dev = ["--device", "cpu"] if "serve" in argv else []
    got = _cli_lines(TCLI.main, argv + dev)
    want = _cli_lines(RCLI.main, argv)
    assert got == want and len(got) >= 3


# one case per load-sweep flag, each a small sweep (--arrivals always)
LOAD_SWEEP_ARGV = {
    "--arrivals": ["--arrivals", "bursty", "--qps", "10", "30"],
    "--qps": ["--qps", "10", "20", "40"],
    "--requests": ["--requests", "12", "--qps", "50"],
    "--prefix-tokens": ["--prefix-tokens", "16", "--qps", "10", "30"],
    "--preempt": ["--preempt", "lifo", "--qps", "1000", "4000"],
    "--stall-budget-us": ["--preempt", "longest", "--stall-budget-us",
                          "100", "--qps", "1000", "4000"],
    "--swap": ["--swap", "--preempt", "lifo", "--qps", "2000"],
    "--workers": ["--workers", "2", "--qps", "10", "30"],
}


def _sweep_lines(main, argv) -> list:
    """The CLI's load-sweep lines, the header's host-timed ``wall N.Ns``
    cut off."""
    return [line.split("; wall ")[0] if line.startswith("load sweep")
            else line for line in _cli_lines(main, argv)]


@pytest.mark.parametrize("flag", sorted(LOAD_SWEEP_ARGV))
def test_load_sweep_flags_refuse_naming_item_12(flag):
    """Each load-sweep flag (once refused, ROADMAP Queue A item 12)
    drives a small open-loop sweep whose printed lines are the reference
    CLI's."""
    argv = ["--workload", "serve", "--requests", "8",
            "--arrivals", "poisson"] + LOAD_SWEEP_ARGV[flag]
    got = _sweep_lines(TCLI.main, argv)
    assert got == _sweep_lines(RCLI.main, argv)
    assert got[0].startswith("load sweep") and len(got) >= 4
    assert flag != "--swap" or "swap_p99=" in got[1]


def test_load_sweep_api_refuses_naming_item_12():
    """``LoadPoint`` and ``LoadSweepResult`` (once refused, ROADMAP
    Queue A item 12) build and serialise as the reference's do."""
    pct = {"ttft_p99_us": 12.5, "tpot_p99_us": 3.25, "requests": 4}
    kw = dict(qps=100.0, mode="DC", percentiles=pct, total_s=0.02,
              n_finished=4, n_records=9, n_events=1234, drained=False)
    got, want = TS.LoadPoint(**kw), RS.LoadPoint(**kw)
    assert got.to_json() == want.to_json()
    assert got.goodput_qps == want.goodput_qps == 200.0
    res = dict(arch="qwen2_0_5b", arrivals="poisson", qps=(100.0,),
               modes=("DC",), n_requests=4, knee_qps={"DC": None},
               calibration={"est_step_s": 1e-4}, wall_s=1.23456,
               preempt="lifo", kv_pool_pages=7)
    t = TS.LoadSweepResult(points=[got], **res)
    r = RS.LoadSweepResult(points=[want], **res)
    assert t.to_json() == r.to_json()
    assert json.loads(json.dumps(t.to_json())) == t.to_json()
    assert t.to_json()["schema"] == TS.LoadSweepResult.SCHEMA == \
        "loadsweep/v1"
    assert t.curve("DC") == [got] and t.curve("DM") == []
    assert TS.LOAD_SHAPE == RS.LOAD_SHAPE


# -------------------------------------------------------------- artifact
ARTIFACT = json.loads((ROOT / "BENCH_replay.json").read_text())


@pytest.mark.parametrize("row", [k for k in ARTIFACT if k != "_meta"])
def test_bench_replay_artifact_is_reproduced(row):
    """Each row of the replay benchmark's artifact, lowered and replayed
    by the port: its event count exactly, and each mode's ``total_us``
    to 1e-9."""
    art = ARTIFACT[row]
    sc_json = art["modes"]["DM"]["sim"]["scenario"]
    params = {k: tuple(tuple(x) if isinstance(x, list) else x for x in v)
              if isinstance(v, list) else v
              for k, v in sc_json["params"].items()}
    st = TS.Scenario(
        model=sc_json["model"], dtype=sc_json["dtype"],
        n_layers=sc_json["n_layers"], sampling=sc_json["sampling"],
        params=TS.as_params(**params))
    plan, _, events, _ = TS.scenario_plan(st)
    assert events == art["events"]
    for mode in MODES:
        res = TP.replay(TS.system_for(dataclasses.replace(st, mode=mode)),
                        plan, engine="compiled")
        want = art["modes"][mode]["sim"]["total_us"]
        assert abs(res.total_s * 1e6 - want) <= 1e-9 * want, mode
    TS.clear_caches()
