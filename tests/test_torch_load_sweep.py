"""The port's open-loop load sweep against the reference, and the serving
scale artifact reproduced.

``sweep_load`` drives the plan-only engine at each offered rate and
prices every trace in DM / DC / DevMem in one streamed replay; its
``loadsweep/v1`` JSON, without the host-timed ``wall_s``, must equal
the reference's, bit for bit: plain, with a shared prefix (the on/off
delta), under ``preempt="lifo"`` (a pressure-capped pool and grid
doubling past the knee), over bursty and diurnal arrivals, with the grid
left to the calibration, event-built, and at two spawned workers.  Then
``serve_1k`` and ``serve_preempt_1k`` of ``BENCH_serving_scale.json``,
rebuilt with the benchmark's constants: counts exact, each mode's
``total_s`` within 1e-9.
"""
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.core import scenario as RS  # noqa: E402
from repro_torch.core import scenario as TS  # noqa: E402
from repro_torch.serving import scale as SCALE  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(qps=(10.0, 30.0, 90.0), n_requests=16)
SWEEPS = {
    "plain": SMALL,
    "prefix": dict(SMALL, prefix_tokens=16),
    "prefix_off_main": dict(SMALL, prefix_tokens=16, prefix_caching=False),
    # no mode saturates on this grid: it doubles the top rate until
    # each has a point past its knee
    "lifo_extends": dict(qps=(1000.0, 2000.0, 4000.0), n_requests=24,
                         preempt="lifo", slots=3, max_seq=64,
                         prefill_chunk_tokens=8),
    "longest_budget": dict(n_requests=24, preempt="longest",
                           stall_budget_s=1e-4, modes=("DC",), slots=3,
                           max_seq=64, prefill_chunk_tokens=8),
    "bursty": dict(SMALL, arrivals="bursty", modes=("DM", "DevMem")),
    "diurnal_auto_grid": dict(n_requests=16, arrivals="diurnal",
                              modes=("DC",)),
    "untemplated": dict(qps=(1000.0, 4000.0), n_requests=12,
                        templated=False, preempt="lifo", modes=("DC",)),
}


def _json(res) -> dict:
    out = res.to_json()
    out.pop("wall_s")
    return out


@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_sweep_load_matches_reference(name):
    kw = SWEEPS[name]
    got, want = TS.sweep_load(**kw), RS.sweep_load(**kw)
    assert _json(got) == _json(want)
    assert got.qps == want.qps and got.knee_qps == want.knee_qps
    assert all(pt.drained for pt in got.points)
    if name == "lifo_extends":
        assert len(got.qps) > len(kw["qps"])
        assert got.kv_pool_pages < 3 * (64 // 8)        # pressured
        k = got.knee_qps["DC"]
        assert k is not None
        assert any(pt.percentiles["preemptions"] > 0
                   for pt in got.curve("DC") if pt.qps > k)
    if kw.get("prefix_tokens"):
        d = got.prefix_delta["DC"]
        assert d["records_on"] < d["records_off"]
        assert d["total_s_on"] < d["total_s_off"]


def test_sweep_load_at_two_spawned_workers_matches_one():
    """The rate grid fanned over two spawned workers, with the grid
    extensions and the prefix delta after it, equals the serial sweep."""
    kw = dict(qps=(1000.0, 2000.0, 4000.0), n_requests=16, preempt="lifo",
              prefix_tokens=8, slots=3, max_seq=64,
              prefill_chunk_tokens=8)
    one, two = TS.sweep_load(**kw), TS.sweep_load(workers=2, **kw)
    assert _json(two) == _json(one)
    assert len(one.qps) > 3 and one.prefix_delta is not None


def test_sweep_load_refuses_unknown_shape_keys():
    with pytest.raises(TS.UnsupportedScenario, match="load scenario"):
        TS.sweep_load(qps=(1.0,), n_requests=2, slot=3)


# --------------------------------------------------- BENCH_serving_scale
ARTIFACT = json.loads((ROOT / "BENCH_serving_scale.json").read_text())


@pytest.mark.parametrize("name", ["serve_1k", "serve_preempt_1k"])
def test_bench_serving_scale_is_reproduced(name):
    """The plan-only engine, templated, with the benchmark's constants;
    both passes of the streamed replay over DM / DC / DevMem: records,
    events, footprint pages, preemptions and swapped pages exactly as
    in the artifact, each mode's total within 1e-9 of it, and every
    request's work conserved across preemptions."""
    want = SCALE.artifact_row(name, ARTIFACT)
    got = SCALE.reproduce_serving_scale(
        name, ARTIFACT["workloads"][name]["requests"])
    assert got["drained"]
    assert {k: got[k] for k in want if k != "total_s"} == \
        {k: v for k, v in want.items() if k != "total_s"}
    assert set(got["total_s"]) == set(want["total_s"]) == set(TS.MODES)
    for mode, art in want["total_s"].items():
        assert abs(got["total_s"][mode] - art) <= 1e-9 * art, \
            (mode, got["total_s"][mode])
