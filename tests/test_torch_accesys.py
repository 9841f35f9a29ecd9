"""The port's accesys timing simulator against the reference, exactly.

Both packages get the same inputs: seeded numpy page-id streams for the
batch LRU machinery, the same scenario lowering for the replayers, the
same design-space grid for the config-batched replayer.  Every result
must be equal with ``==`` (rtol 0): each ``GemmResult`` field, the
component counters and the LRU state they leave behind, the scorecard's
``Claim`` values.  The simulator is numpy on the host in both packages,
so nothing here needs a card.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.accesys import calibration as RC  # noqa: E402
from repro.accesys import components as RCo  # noqa: E402
from repro.accesys import pipeline as RP  # noqa: E402
from repro.accesys import system as RSy  # noqa: E402
from repro.accesys import workloads as RW  # noqa: E402
from repro.configs import paper_models as RPM  # noqa: E402
from repro.core import design_space as RD  # noqa: E402
from repro.core import scenario as RS  # noqa: E402
from repro_torch.accesys import calibration as TC  # noqa: E402
from repro_torch.accesys import components as TCo  # noqa: E402
from repro_torch.accesys import pipeline as TP  # noqa: E402
from repro_torch.accesys import system as TSy  # noqa: E402
from repro_torch.accesys import workloads as TW  # noqa: E402
from repro_torch.configs import paper_models as TPM  # noqa: E402
from repro_torch.core import design_space as TD  # noqa: E402
from repro_torch.core import scenario as TS  # noqa: E402

MODES = ("DM", "DC", "DevMem")


def _asdict(x):
    return dataclasses.asdict(x)


def _pair(**kw):
    """The same scenario in both packages."""
    return RS.Scenario(**kw), TS.Scenario(**kw)


def _stream(seed: int, n: int, n_ids: int) -> np.ndarray:
    """A page-id stream with reuse at every distance: a random walk over
    a hot set mixed with uniform draws over the whole id space."""
    rng = np.random.default_rng(seed)
    hot = rng.integers(0, max(n_ids // 8, 1), size=n)
    cold = rng.integers(0, n_ids, size=n)
    return np.where(rng.random(n) < 0.6, hot, cold).astype(np.int64)


STREAMS = [(0, 0, 1), (1, 1, 1), (2, 700, 40), (3, 5000, 300),
           (4, 20000, 4000)]


# ------------------------------------------------------------ components
@pytest.mark.parametrize("seed,n,n_ids", STREAMS)
def test_prev_occurrence_and_stack_distances(seed, n, n_ids):
    ids = _stream(seed, n, n_ids)
    prev = TCo.prev_occurrence(ids)
    want = RCo.prev_occurrence(ids)
    assert prev.dtype == want.dtype and np.array_equal(prev, want)
    sd = TCo.lru_stack_distances(prev)
    want_sd = RCo.lru_stack_distances(want)
    assert sd.dtype == want_sd.dtype and np.array_equal(sd, want_sd)


def test_lru_stream_state_chunks_match_reference():
    ids = _stream(5, 6000, 500)
    t, r = TCo.LRUStreamState(), RCo.LRUStreamState()
    for chunk in np.array_split(ids, 7):
        (tp, tsd), (rp, rsd) = t.analyze(chunk), r.analyze(chunk)
        assert np.array_equal(tp, rp) and np.array_equal(tsd, rsd)
        assert np.array_equal(t.mru, r.mru)


def _keys(n_ids):
    return [("p", i) for i in range(n_ids)]


@pytest.mark.parametrize("seed,n,n_ids", STREAMS[2:])
def test_smmu_access_many_matches_reference(seed, n, n_ids):
    """Per-access seconds, the counters and the rebuilt uTLB / L2 LRU
    state equal the reference's, and equal a sequential ``access``
    sweep of the same stream."""
    ids = _stream(seed, n, n_ids)
    keys = _keys(n_ids)
    foot = n_ids * 3
    t = TCo.SMMU(tlb_entries=16, l2_entries=64)
    r = RCo.SMMU(tlb_entries=16, l2_entries=64)
    xt = t.access_many(ids, foot, {}, keys=keys)
    xr = r.access_many(ids, foot, {}, keys=keys)
    assert np.array_equal(xt, xr)
    assert (t.lookups, t.misses, t.walks) == (r.lookups, r.misses, r.walks)
    assert list(t._tlb) == list(r._tlb) and list(t._l2) == list(r._l2)
    seq = TCo.SMMU(tlb_entries=16, l2_entries=64)
    xs = np.array([seq.access(keys[i], foot) for i in ids.tolist()])
    assert np.array_equal(xs, xt)
    assert (seq.lookups, seq.misses, seq.walks) == \
        (t.lookups, t.misses, t.walks)
    assert list(seq._tlb) == list(t._tlb) and list(seq._l2) == list(t._l2)
    with pytest.raises(RuntimeError):
        t.access_many(ids, foot, {}, keys=keys)      # state not reset


@pytest.mark.parametrize("seed,n,n_ids", STREAMS[2:])
def test_llc_access_many_matches_reference(seed, n, n_ids):
    ids = _stream(seed, n, n_ids)
    keys = _keys(n_ids)
    t = TCo.LLC(size_bytes=32 * 4096)
    r = RCo.LLC(size_bytes=32 * 4096)
    ht, hr = t.access_many(ids, {}, keys=keys), r.access_many(ids, {},
                                                              keys=keys)
    assert np.array_equal(ht, hr)
    assert (t.hits, t.misses) == (r.hits, r.misses)
    assert list(t._lru) == list(r._lru)
    seq = TCo.LLC(size_bytes=32 * 4096)
    hs = np.array([seq.access(keys[i]) for i in ids.tolist()])
    assert np.array_equal(hs, ht) and list(seq._lru) == list(t._lru)


def test_component_models_match_reference():
    assert TCo.DRAM_TECH == RCo.DRAM_TECH
    assert TCo.FABRIC_TOPOLOGIES == RCo.FABRIC_TOPOLOGIES
    assert TCo.SA_VARIANTS == RCo.SA_VARIANTS
    for dtype in TCo.DTYPE_BYTES:
        for w in (4, 8, 16, 32):
            t, r = TCo.SystolicArray(dtype=dtype, w=w), \
                RCo.SystolicArray(dtype=dtype, w=w)
            assert (t.freq, t.area_um2, t.power_mw, t.peak_gops,
                    t.passes, t.tile_cycles(128), t.tile_time(64)) == \
                (r.freq, r.area_um2, r.power_mw, r.peak_gops, r.passes,
                 r.tile_cycles(128), r.tile_time(64))
    for gb_s, pkt in ((2, 64), (8, 256), (64, 4096)):
        t, r = TSy.pcie_for_bw(gb_s, pkt), RSy.pcie_for_bw(gb_s, pkt)
        assert _asdict(t) == _asdict(r)
        assert (t.raw_bw, t.efficiency(), t.effective_bw,
                t.transfer_time(12345)) == \
            (r.raw_bw, r.efficiency(), r.effective_bw,
             r.transfer_time(12345))
    for tech in TCo.DRAM_TECH:
        t, r = TCo.DRAM(tech), RCo.DRAM(tech)
        assert (t.bandwidth, t.transfer_time(4096)) == \
            (r.bandwidth, r.transfer_time(4096))
    for topo in TCo.FABRIC_TOPOLOGIES:
        t, r = TCo.Fabric(topology=topo), RCo.Fabric(topology=topo)
        assert (t.hop_time(8192), t.row_key()) == \
            (r.hop_time(8192), r.row_key())
    for mode in MODES:
        for dtype in ("int8", "fp16", "int32"):
            assert _asdict(TSy.default_system(mode, dtype)) == \
                _asdict(RSy.default_system(mode, dtype))


def test_paper_models_match_reference():
    assert list(TPM.PAPER_MODELS) == list(RPM.PAPER_MODELS)
    for name, cfg in TPM.PAPER_MODELS.items():
        assert _asdict(cfg) == _asdict(RPM.PAPER_MODELS[name])
        assert _asdict(TW.transformer_trace(name)) == \
            _asdict(RW.transformer_trace(name))
    for n in TW.MICRO_SIZES:
        assert _asdict(TW.micro_gemm(n)) == _asdict(RW.micro_gemm(n))


# ---------------------------------------------------------------- replay
REPLAY_CASES = {
    "gemm": dict(model="gemm", params=RS.as_params(m=256, n=192, k=320)),
    "bert-base.2l": dict(model="bert-base", n_layers=2),
    "vit-base-16.2l": dict(model="vit-base-16", n_layers=2),
    "moe": dict(model="moe"),
    "ssm": dict(model="ssm"),
    "decode": dict(model="decode", dtype="fp16"),
}


@pytest.mark.parametrize("sampling", ["sampled", "exact"])
@pytest.mark.parametrize("case", sorted(REPLAY_CASES))
def test_replay_matches_reference(case, sampling):
    """Every workload class in DM, DC and DevMem through the event
    engine and the compiled engine (auto, and both recurrences forced):
    every ``GemmResult`` field equals the reference's."""
    sr, st = _pair(sampling=sampling, **REPLAY_CASES[case])
    pr, pt = RS.scenario_plan(sr)[0], TS.scenario_plan(st)[0]
    for mode in MODES:
        cr = RS.system_for(dataclasses.replace(sr, mode=mode))
        ct = TS.system_for(dataclasses.replace(st, mode=mode))
        assert _asdict(ct) == _asdict(cr)
        for engine in ("event", "compiled"):
            want = _asdict(RP.replay(cr, pr, engine=engine))
            assert _asdict(TP.replay(ct, pt, engine=engine)) == want, \
                (mode, engine)
        for recur in ("loop", "vec"):
            want = _asdict(RP.replay_compiled(cr, pr, _recur=recur))
            got = _asdict(TP.replay_compiled(ct, pt, _recur=recur))
            assert got == want, (mode, recur)


def test_replay_batch_over_bench_grid_matches_reference():
    """The config-batched replayer over the 64-config benchmark grid
    equals the reference's, point for point, and each point equals a
    sequential compiled replay of its own system."""
    grid_t, grid_r = TD.bench_grid(), RD.bench_grid()
    assert [_asdict(p) for p in grid_t] == [_asdict(p) for p in grid_r]
    sr, st = _pair(model="bert-base", n_layers=2, sampling="exact")
    pr, pt = RS.scenario_plan(sr)[0], TS.scenario_plan(st)[0]
    got = TP.replay_batch([TD.system_for_point(p) for p in grid_t], pt)
    want = RP.replay_batch([RD.system_for_point(p) for p in grid_r], pr)
    assert [_asdict(g) for g in got] == [_asdict(w) for w in want]
    for p, g in list(zip(grid_t, got))[::9]:
        seq = TP.replay_compiled(TD.system_for_point(p), pt)
        for f in dataclasses.fields(seq):
            assert getattr(g, f.name) == pytest.approx(
                getattr(seq, f.name), rel=1e-9), f.name
    assert [TD.point_area_um2(p) for p in grid_t] == \
        [RD.point_area_um2(p) for p in grid_r]
    TP.release_scratch()
    RP.release_scratch()


# the reference's pinned seed numbers for simulate_gemm:
# (total_s, tlb_lookups, tlb_misses, ptw_walks)
SEED_GEMM_NUMBERS = {
    ("int8", 512, "DM"): (1.000546582376e-03, 5120, 3136, 1152),
    ("int8", 512, "DC"): (6.151879396860e-04, 5120, 3136, 1152),
    ("int8", 512, "DevMem"): (9.272243448276e-04, 5120, 3136, 1152),
    ("int32", 1024, "DM"): (3.149002630646e-02, 135168, 70656, 6144),
    ("int32", 1024, "DevMem"): (2.914377735627e-02, 135168, 70656, 6144),
    ("fp16", 512, "DC"): (1.135804546039e-03, 9216, 5248, 1280),
}


@pytest.mark.parametrize("dtype,n,mode", sorted(SEED_GEMM_NUMBERS))
def test_simulate_gemm_seed_numbers(dtype, n, mode):
    total, lookups, misses, walks = SEED_GEMM_NUMBERS[(dtype, n, mode)]
    got = TP.simulate_gemm(TSy.default_system(mode, dtype=dtype), n, n, n)
    want = RP.simulate_gemm(RSy.default_system(mode, dtype=dtype), n, n, n)
    assert _asdict(got) == _asdict(want)
    assert abs(got.total_s - total) / total < 1e-9
    assert (got.tlb_lookups, got.tlb_misses, got.ptw_walks) == \
        (lookups, misses, walks)


@pytest.mark.parametrize("sampled", [False, True])
def test_composed_transformer_matches_reference(sampled):
    for mode in MODES:
        got = TSy.run_transformer_composed(
            TSy.default_system(mode), "bert-medium", n_layers=2,
            sampled=sampled)
        want = RSy.run_transformer_composed(
            RSy.default_system(mode), "bert-medium", n_layers=2,
            sampled=sampled)
        assert _asdict(got) == _asdict(want), mode


# -------------------------------------------------------------- scorecard
def test_scorecard_matches_reference():
    """``validate(fast=True)`` gives the reference's claim list value
    for value, and every claim passes, as the reference's claim tests
    require."""
    got, want = TC.validate(fast=True), RC.validate(fast=True)
    assert [_asdict(c) for c in got] == [_asdict(c) for c in want]
    failing = [c.row() for c in got if not c.ok]
    assert not failing, "\n".join(failing)
    assert len([c for c in got if c.name.startswith("table9")]) == 6


def test_nongemm_crossover_and_scaling_match_reference():
    assert TC.nongemm_crossover() == RC.nongemm_crossover()
    for name in ("bert-base", "vit-base-16"):
        for frac in (0.05, 0.3):
            assert _asdict(TC.scale_nongemm(TW.transformer_trace(name),
                                            frac)) == \
                _asdict(RC.scale_nongemm(RW.transformer_trace(name), frac))
    for name in TPM.PAPER_MODELS:
        for threads, simd in ((1, False), (256, False), (1, True)):
            assert _asdict(TSy.run_transformer_cpu(
                TW.transformer_trace(name), threads=threads,
                simd=simd)) == _asdict(RSy.run_transformer_cpu(
                    RW.transformer_trace(name), threads=threads,
                    simd=simd))
