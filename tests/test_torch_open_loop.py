"""The port's plan-only open-loop serving against the reference, bitwise.

Both packages' ``ServingEngine(plan_only=True)`` run the same requests on
their own arrival clocks, in each mode of the open loop: chunked
prefill, prefix caching on and off, preemption with KV swap under both
policies and stall budgets, a pool that shrinks under the engine, a run
cut by ``max_steps`` and event-built (``templated=False``) plans.  The
records (kind, step, slots, uids, arrival index, token count, plan name
and every compiled array), ``EngineStats``, the unfinished uids, the
shadow table's state and the invariants' tallies must be equal, with
no tolerance.  Then the ``PageTable`` bookkeeping beneath, the
invariant checks on corrupted state, the fault-injection harness and
the serving report over a swap-bearing trace, streamed at several chunk
sizes.
"""
import contextlib
import dataclasses
import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.accesys import pipeline as RP  # noqa: E402
from repro.configs import get_reduced as ref_reduced  # noqa: E402
from repro.core import scenario as RS  # noqa: E402
from repro.serving import engine as RE  # noqa: E402
from repro.serving import faults as RF  # noqa: E402
from repro.serving import invariants as RI  # noqa: E402
from repro.serving import kv_cache as RK  # noqa: E402
from repro.serving import sim_report as RR  # noqa: E402
from repro_torch.accesys import pipeline as TP  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core import scenario as TS  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402
from repro_torch.serving import faults as TF  # noqa: E402
from repro_torch.serving import invariants as TI  # noqa: E402
from repro_torch.serving import kv_cache as TK  # noqa: E402
from repro_torch.serving import sim_report as TR  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
MODES = ("DM", "DC", "DevMem")
COMPILED_COLS = ("trace_ids", "trace_nbytes", "trace_is_out", "in_lane",
                 "op_kind", "op_val", "grp_end", "n_lanes", "seg_op",
                 "seg_trace")
# (engine module, faults module, invariants module, get_reduced)
REF = (RE, RF, RI, ref_reduced)
PORT = (TE, TF, TI, get_reduced)
RUN_KW = dict(est_step_s=1e-4, est_prefill_s_per_token=1e-5)


# --------------------------------------------------------------- helpers
def _specs(n, seed=7, prompt=(4, 20), new=(1, 8)):
    """Seeded (prompt, max_new_tokens) pairs, built once for both
    packages."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, 250, size=int(rng.integers(*prompt))
                          ).astype(np.int32), int(rng.integers(*new)))
            for _ in range(n)]


def _fixed(*lens, new=2):
    return [(np.arange(1, n + 1, dtype=np.int32), new) for n in lens]


def _assert_records_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.kind, g.step_idx, g.slots, g.uids, g.arrival_event,
                g.n_tokens, g.plan.name) == \
            (w.kind, w.step_idx, w.slots, w.uids, w.arrival_event,
             w.n_tokens, w.plan.name)
        a, b = g.plan.compile(), w.plan.compile()
        assert a.n_events == b.n_events and a.page_keys == b.page_keys
        for f in COMPILED_COLS:
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), f


def _table_state(t) -> dict:
    return {"free": list(t._free), "tables": t.tables.tolist(),
            "lens": t.lens.tolist(), "held": t.held.tolist(),
            "shared": t.shared.tolist(), "active": t.active.tolist(),
            "prefix": list(t._prefix), "seized": list(t._seized)}


def _engine_state(eng) -> dict:
    return {"stats": dataclasses.asdict(eng.stats),
            "unfinished": eng.unfinished_uids(),
            "n_finished": eng.n_finished, "n_records": eng.n_records,
            "deferred": eng.deferred_admissions, "sim_t": eng.sim_t,
            "table": _table_state(eng._table)}


# a 13-page pool under 30 requests of 4-51 prompt tokens at 2,000 qps:
# admission stalls, and with a policy armed, evicts
PRESSURE = dict(specs=_specs(30, 5, (4, 52), (1, 8)), qps=2000.0,
                engine=dict(kv_pool_pages=13))
PRESSURE_RUN = dict(prefill_chunk_tokens=8)
# one open-loop run per case: engine arguments, requests, arrivals and
# run arguments
CASES = {
    "plain": dict(specs=_specs(12), qps=400.0),
    "chunk8": dict(specs=_specs(12), qps=400.0, run=dict(
        prefill_chunk_tokens=8)),
    "chunk16": dict(specs=_specs(12, prompt=(8, 40)), qps=400.0,
                    run=dict(prefill_chunk_tokens=16)),
    "prefix_cached": dict(specs=_specs(10), qps=100.0, engine=dict(
        prefix_tokens=16, prefix_caching=True), run=dict(
        prefill_chunk_tokens=8)),
    "prefix_uncached": dict(specs=_specs(10), qps=100.0, engine=dict(
        prefix_tokens=16, prefix_caching=False), run=dict(
        prefill_chunk_tokens=8)),
    "lifo_stall0": dict(PRESSURE, run=dict(PRESSURE_RUN, preempt="lifo")),
    "lifo_stall_budget": dict(PRESSURE, run=dict(
        PRESSURE_RUN, preempt="lifo", stall_budget_s=3e-4)),
    "longest_stall0": dict(PRESSURE, run=dict(PRESSURE_RUN,
                                              preempt="longest")),
    "longest_stall_budget": dict(PRESSURE, run=dict(
        PRESSURE_RUN, preempt="longest", stall_budget_s=3e-4)),
    # three requests at t = 0 on a 9-page pool: the newest runner is
    # evicted between prefill chunks and resumes where it stopped
    "mid_prefill": dict(specs=_fixed(40, 20, 20), arrivals="zeros",
                        engine=dict(kv_pool_pages=9), run=dict(
                            prefill_chunk_tokens=8, preempt="lifo")),
    # a co-tenant seizes pages at step 5 and returns them at step 40:
    # decode-time growth fails and the slot is swapped out instead
    "pool_shrink": dict(specs=_specs(16, 3, (8, 40), (4, 12)), qps=800.0,
                        engine=dict(kv_pool_pages=16), run=dict(
                            prefill_chunk_tokens=8, preempt="lifo"),
                        fault=(5, 10, 40)),
    "max_steps": dict(specs=_specs(8, 9, (4, 20), (6, 12)),
                      arrivals="zeros", run=dict(
                          prefill_chunk_tokens=8, max_steps=6)),
    "untemplated": dict(PRESSURE, engine=dict(kv_pool_pages=13,
                                              templated=False),
                        run=dict(PRESSURE_RUN, preempt="lifo")),
}
# plan-only accepts every family: one run of each non-dense kind
FAMILY_CASES = ("rwkv6_7b", "zamba2_7b", "deepseek_v3_671b")


def _run(side, case, arch="qwen2_0_5b"):
    E, F, _, reduced = side
    engine = dict(slots=3, max_seq=64, kv_page_tokens=8)
    engine.update(case.get("engine", {}))
    eng = E.ServingEngine(reduced(arch), plan_only=True, **engine)
    reqs = [E.Request(uid=i, prompt=p, max_new_tokens=m)
            for i, (p, m) in enumerate(case["specs"])]
    arr = np.zeros(len(reqs)) if case.get("arrivals") == "zeros" else \
        E.arrival_times("poisson", len(reqs), case.get("qps", 400.0),
                        seed=3)
    faults = None
    if "fault" in case:
        at, n, back = case["fault"]
        faults = F.PoolShrinkFault(at_step=at, n_pages=n, restore_step=back)
    eng.run_open_loop(reqs, arr, faults=faults, debug_invariants=True,
                      **{**RUN_KW, **case.get("run", {})})
    return eng, reqs


def _conservation(side, eng, reqs, case):
    engine = case.get("engine", {})
    return side[2].check_trace_conservation(
        eng.trace, reqs, prefix_tokens=engine.get("prefix_tokens", 0),
        prefix_cached=engine.get("prefix_caching", False),
        max_seq=eng.max_seq, unfinished=eng.unfinished_uids())


@pytest.fixture(scope="module")
def runs():
    """Each case run once by each package, shared by the tests below."""
    out = {}

    def get(name, arch="qwen2_0_5b"):
        key = (name, arch)
        if key not in out:
            case = CASES[name]
            out[key] = [(*_run(side, case, arch), side)
                        for side in (REF, PORT)]
        return out[key]
    return get


# ------------------------------------------------------------- arrivals
@pytest.mark.parametrize("seed", [0, 11, 12])
@pytest.mark.parametrize("kind", ["poisson", "bursty", "diurnal"])
def test_arrival_times_match_reference(kind, seed):
    got = TE.arrival_times(kind, 500, 25.0, seed=seed)
    want = RE.arrival_times(kind, 500, 25.0, seed=seed)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.all(np.diff(got) >= 0) and got[0] >= 0
    kw = dict(burst_factor=8.0, burst_len=4.0, period_s=2.0, depth=0.5)
    assert np.array_equal(TE.arrival_times(kind, 64, 300.0, seed, **kw),
                          RE.arrival_times(kind, 64, 300.0, seed, **kw))


def test_arrival_times_refuse_what_the_reference_refuses():
    for args in (("weibull", 10, 1.0), ("poisson", 10, 0.0)):
        with pytest.raises(ValueError) as want:
            RE.arrival_times(*args)
        with pytest.raises(ValueError, match=str(want.value)[:20]):
            TE.arrival_times(*args)


# ------------------------------------------------------------ PageTable
def _tables(n_pages=12, templated=False):
    kw = dict(n_pages=n_pages, page_tokens=8, n_kv_heads=2, head_dim=16,
              max_pages_per_seq=8, dtype="float16")
    return (RK.PageTable(RK.PagedCacheConfig(**kw), max_seqs=3,
                         templated=templated),
            TK.PageTable(TK.PagedCacheConfig(**kw), max_seqs=3,
                         templated=templated))


@pytest.mark.parametrize("templated", [False, True])
def test_page_table_prefix_and_swap_match_reference(templated):
    r, t = _tables(16, templated)
    outs = []
    for tbl in (r, t):
        pfx = tbl.reserve_prefix(2)
        steps = [pfx.tolist(), tbl.alloc_seq(0, 32, prefix=pfx),
                 tbl.alloc_seq(1, 20), tbl.alloc_seq(2, 9, prefix=pfx),
                 tbl.pages_in_use]
        steps += [tbl.written_own_pages(s, n) for s, n in
                  ((0, 0), (0, 17), (0, 999), (1, 9), (1, 20), (2, 9))]
        tbl.validate()
        plans = [tbl.swap_out(0, 30, tag=5, n_layers=2),
                 tbl.swap_out(2, 3, tag=6)]
        steps += [n for _, n in plans] + [plans[1][0] is None,
                                          tbl.pages_in_use]
        back = tbl.swap_in_plan(plans[0][1], tag=5, n_layers=2)
        tbl.validate()
        tbl.free_seq(1)
        steps += [tbl.pages_in_use, _table_state(tbl)]
        outs.append((steps, plans[0][0], back))
    (sr, out_r, in_r), (st, out_t, in_t) = outs
    assert st == sr
    assert st[-2] == 2            # only the prefix pages stay reserved
    _assert_records_equal(
        [TE.PlanRecord("swap_out", 0, (0,), (5,), out_t),
         TE.PlanRecord("swap_in", 0, (0,), (5,), in_t)],
        [RE.PlanRecord("swap_out", 0, (0,), (5,), out_r),
         RE.PlanRecord("swap_in", 0, (0,), (5,), in_r)])
    assert len(out_t.events) == 2 * 2 * st[11]   # pages x layers x (K, V)
    with pytest.raises(ValueError, match="cannot reserve 99"):
        t.reserve_prefix(99)


def test_page_table_seize_restore_match_reference():
    r, t = _tables()
    outs = []
    for tbl in (r, t):
        seq = [tbl.seize_pages(5), tbl.pages_in_use]
        tbl.validate()
        seq += [tbl.alloc_seq(0, 40), tbl.seize_pages(99)]
        tbl.validate()
        seq += [tbl.restore_pages(3), tbl.restore_pages(), tbl.pages_in_use,
                _table_state(tbl)]
        tbl.validate()
        outs.append(seq)
    assert outs[1] == outs[0]
    assert outs[1][:4] == [5, 5, True, 2]


@pytest.mark.parametrize("fault", ["double_free", "leak", "alias",
                                   "phantom_shared", "inactive_holds"])
def test_page_table_validate_catches_what_the_reference_catches(fault):
    """Each corruption raises ``AssertionError`` in both packages, with
    the reference's message."""
    msgs = []
    for tbl in _tables():
        pfx = tbl.reserve_prefix(1)
        tbl.alloc_seq(0, 16)
        tbl.alloc_seq(1, 16, prefix=pfx)
        tbl.validate()
        if fault == "double_free":
            tbl._free.append(int(tbl.tables[0, 0]))
        elif fault == "leak":
            tbl._free.pop()
        elif fault == "alias":
            tbl.tables[1, 1] = tbl.tables[0, 1]
        elif fault == "phantom_shared":
            tbl.tables[1, 0] = tbl.tables[0, 0]
        else:
            tbl.active[0] = False
        with pytest.raises(AssertionError) as e:
            tbl.validate()
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]


def test_live_cache_refuses_a_prefix_and_keeps_its_sub_caches():
    cache = TK.PagedKVCache(TK.PagedCacheConfig(
        n_pages=8, page_tokens=8, n_kv_heads=2, head_dim=16,
        max_pages_per_seq=4), max_seqs=2, n_layers=1, device="cpu")
    with pytest.raises(ValueError, match="prefix"):
        cache.alloc_seq(0, 8, prefix=np.array([0], np.int32))
    assert cache.alloc_seq(0, 8) and cache.pages_in_use == 1
    cache.validate()
    cache.free_seq(0)
    assert cache.pages_in_use == 0 and int(cache.shared[0]) == 0


# ----------------------------------------------------- the engine, built
@pytest.mark.parametrize("arch", ["qwen2_0_5b", "qwen2_moe_a2_7b",
                                  "internvl2_2b", "whisper_tiny",
                                  "rwkv6_7b", "zamba2_7b",
                                  "deepseek_v3_671b"])
def test_plan_only_builds_no_model_for_every_family(arch):
    """No ``Model``, no cache and no device: only the shadow table, of
    the reference's geometry (an audio config is refused only when a
    model is built)."""
    got = TE.ServingEngine(get_reduced(arch), plan_only=True, slots=2,
                           max_seq=32, prefix_tokens=8,
                           prefix_caching=True)
    want = RE.ServingEngine(ref_reduced(arch), plan_only=True, slots=2,
                            max_seq=32, prefix_tokens=8,
                            prefix_caching=True)
    assert got.model is None and got.cache is None and got.device is None
    assert dataclasses.asdict(got._table.cfg) == \
        dataclasses.asdict(want._table.cfg)
    assert _table_state(got._table) == _table_state(want._table)
    with pytest.raises(ValueError, match="open_loop_records"):
        got.step()


def test_engine_refuses_what_the_reference_refuses():
    cfg = get_reduced("qwen2_0_5b")
    for kw in (dict(prefix_tokens=12), dict(prefix_tokens=8,
                                             kv_page_tokens=16)):
        with pytest.raises(ValueError, match="multiple of kv_page_tokens"):
            TE.ServingEngine(cfg, plan_only=True, **kw)
    eng = TE.ServingEngine(cfg, plan_only=True)
    req = [TE.Request(uid=0, prompt=np.arange(1, 9, dtype=np.int32))]
    for kw, match in ((dict(preempt="fifo"), "preemption policy"),
                      (dict(preempt="lifo", stall_budget_s=-1.0),
                       "stall_budget_s"),
                      (dict(prefill_chunk_tokens=12), "page-aligned")):
        with pytest.raises(ValueError, match=match):
            list(eng.open_loop_records(req, np.zeros(1), **kw))
    with pytest.raises(ValueError, match="2 arrival times"):
        list(eng.open_loop_records(req, np.zeros(2)))
    big = [TE.Request(uid=0, prompt=np.arange(1, 41, dtype=np.int32))]
    with pytest.raises(ValueError, match="can never hold"):
        TE.ServingEngine(cfg, plan_only=True, kv_pool_pages=4)\
            .run_open_loop(big, np.zeros(1))
    with pytest.raises(ValueError, match="plan_only"):
        TE.ServingEngine(cfg, device="cpu", record_plans=True)\
            .run_open_loop(req, np.zeros(1))


# ------------------------------------------------- the engine, open loop
@pytest.mark.parametrize("name", sorted(CASES))
def test_open_loop_matches_reference(runs, name):
    (r_eng, r_reqs, _), (t_eng, t_reqs, _) = runs(name)
    _assert_records_equal(t_eng.trace, r_eng.trace)
    assert _engine_state(t_eng) == _engine_state(r_eng)
    assert [(r.uid, r.submitted_s, r.done_s, r.arrival_event)
            for r in t_reqs] == \
        [(r.uid, r.submitted_s, r.done_s, r.arrival_event) for r in r_reqs]
    assert _conservation(PORT, t_eng, t_reqs, CASES[name]) == \
        _conservation(REF, r_eng, r_reqs, CASES[name])


@pytest.mark.parametrize("arch", FAMILY_CASES)
def test_open_loop_matches_reference_for_every_family(runs, arch):
    (r_eng, _, _), (t_eng, _, _) = runs("lifo_stall0", arch)
    _assert_records_equal(t_eng.trace, r_eng.trace)
    assert _engine_state(t_eng) == _engine_state(r_eng)
    assert t_eng.stats.preemptions > 0


def test_open_loop_modes_do_what_they_name(runs):
    """The cases exercise what their names say (on the port's runs)."""
    def port(name):
        return runs(name)[1][0]

    assert port("plain").stats.preemptions == 0 and \
        port("plain").stats.drained
    # chunked prefill: more prefill records than requests
    assert port("chunk16").stats.prefills > 12
    on, off = port("prefix_cached"), port("prefix_uncached")
    assert on.trace[0].uids == (-1,) and len(on.trace) < len(off.trace)
    assert all(r.uids != (-1,) for r in off.trace)
    for name in ("lifo_stall0", "longest_stall0", "lifo_stall_budget",
                 "longest_stall_budget", "pool_shrink", "untemplated"):
        eng = port(name)
        assert eng.stats.drained and eng.stats.preemptions > 0, name
        assert any(r.kind == "swap_out" for r in eng.trace), name
    assert port("lifo_stall_budget").stats.preemptions < \
        port("lifo_stall0").stats.preemptions
    # an eviction between prefill chunks, resumed at its boundary
    eng, reqs, _ = runs("mid_prefill")[1]
    done: dict = {}
    mid = set()
    for rec in eng.trace:
        if rec.kind == "prefill":
            done[rec.uids[0]] = done.get(rec.uids[0], 0) + rec.n_tokens
        elif rec.kind == "swap_out":
            uid = rec.uids[0]
            if 0 < done.get(uid, 0) < len(reqs[uid].prompt):
                mid.add(uid)
    assert mid
    # cut by max_steps: not drained, work left
    cut = port("max_steps")
    assert not cut.stats.drained and cut.unfinished_uids()
    assert all(getattr(r.plan, "skeleton", None) is None
               for r in port("untemplated").trace)


def test_swap_in_racing_a_retire_matches_reference():
    """A request preempted mid-decode with one token left resumes and
    retires at once (its last swap_in followed by at most one decode),
    in the same trace as the reference's."""
    found = []
    for seed in range(6):
        t_eng, t_reqs = TF.overload_run(seed, n_requests=40, preempt="lifo")
        tally = TI.check_trace_conservation(t_eng.trace, t_reqs,
                                            max_seq=t_eng.max_seq)
        for uid, v in tally.items():
            if not v["swap_ins"]:
                continue
            last_in = max(i for i, r in enumerate(t_eng.trace)
                          if r.kind == "swap_in" and r.uids[0] == uid)
            if sum(1 for r in t_eng.trace[last_in + 1:]
                   if r.kind == "decode" and uid in r.uids) <= 1:
                found.append(seed)
                break
        if found:
            break
    assert found
    r_eng, r_reqs = RF.overload_run(found[0], n_requests=40,
                                    preempt="lifo")
    _assert_records_equal(t_eng.trace, r_eng.trace)
    assert _engine_state(t_eng) == _engine_state(r_eng)


# ------------------------------------------------------------ invariants
def _corrupt_trace(trace, how):
    trace = list(trace)
    if how == "lost_decode":
        i = next(i for i, r in enumerate(trace) if r.kind == "decode")
        del trace[i]
    elif how == "repeated_prefill":
        i = next(i for i, r in enumerate(trace) if r.kind == "prefill")
        trace.insert(i, trace[i])
    elif how == "swap_pages_mismatch":
        i = next(i for i, r in enumerate(trace) if r.kind == "swap_in")
        out = next(r for r in trace if r.kind == "swap_out")
        bigger = [r for r in trace if r.kind == "swap_out"
                  and len(r.plan.events) != len(trace[i].plan.events)]
        trace[i] = dataclasses.replace(trace[i], plan=(bigger or [out])[0]
                                       .plan)
    elif how == "double_swap_out":
        i = next(i for i, r in enumerate(trace) if r.kind == "swap_out")
        trace.insert(i, trace[i])
    else:
        trace.append(dataclasses.replace(trace[0], kind="bogus"))
    return trace


@pytest.mark.parametrize("how", ["lost_decode", "repeated_prefill",
                                 "swap_pages_mismatch", "double_swap_out",
                                 "unknown_kind"])
def test_invariants_catch_a_corrupted_trace(runs, how):
    msgs = []
    for eng, reqs, side in runs("lifo_stall0"):
        side[2].check_trace_conservation(eng.trace, reqs,
                                         max_seq=eng.max_seq)
        with pytest.raises(side[2].InvariantViolation) as e:
            side[2].check_trace_conservation(
                _corrupt_trace(eng.trace, how), reqs,
                max_seq=eng.max_seq)
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]
    assert issubclass(TI.InvariantViolation, AssertionError)


@pytest.mark.parametrize("how", ["double_free", "queued_and_running",
                                 "swap_state_left", "prefill_state_left",
                                 "leaked_page"])
def test_invariants_catch_a_corrupted_engine(how):
    """``check_step`` / ``check_drained`` on an engine whose state was
    broken after a drained run raise in both packages alike."""
    msgs = []
    for side in (REF, PORT):
        eng, _ = _run(side, CASES["chunk8"])
        side[2].check_drained(eng)
        t = eng._table
        if how == "double_free":
            t._free.append(t._free[0])
        elif how == "queued_and_running":
            req = side[0].Request(uid=99, prompt=np.ones(4, np.int32))
            t.alloc_seq(0, 4)
            eng.slot_req[0] = req
            eng._lens[0] = 4
            eng.queue.append(req)
        elif how == "swap_state_left":
            eng._swapped[3] = (1, 8, 2, None)
        elif how == "prefill_state_left":
            eng._prefilling[1] = [None, 0, 8]
        else:
            t._seized.append(t._free.pop())
            t._seized.pop()
        check = side[2].check_step if how == "queued_and_running" \
            else side[2].check_drained
        with pytest.raises(side[2].InvariantViolation) as e:
            check(eng)
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]


def test_expected_decodes_matches_reference():
    for n, new, pfx, max_seq in ((8, 4, 0, 64), (60, 8, 0, 64),
                                 (30, 20, 16, 48), (10, 1, 8, 32)):
        rq = RE.Request(uid=0, prompt=np.ones(n, np.int32),
                        max_new_tokens=new)
        tq = TE.Request(uid=0, prompt=np.ones(n, np.int32),
                        max_new_tokens=new)
        assert TI.expected_decodes(tq, pfx, max_seq) == \
            RI.expected_decodes(rq, pfx, max_seq)


# ---------------------------------------------------------------- faults
@pytest.mark.parametrize("policy", ["lifo", "longest"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_overload_run_matches_reference(seed, policy):
    t_eng, t_reqs = TF.overload_run(seed, preempt=policy)
    r_eng, r_reqs = RF.overload_run(seed, preempt=policy)
    assert t_eng.stats.drained and t_eng.n_finished == len(t_reqs)
    assert t_eng.stats.preemptions > 0
    assert _engine_state(t_eng) == _engine_state(r_eng)
    _assert_records_equal(t_eng.trace, r_eng.trace)
    TI.check_drained(t_eng)
    assert TI.check_trace_conservation(t_eng.trace, t_reqs,
                                       max_seq=t_eng.max_seq) == \
        RI.check_trace_conservation(r_eng.trace, r_reqs,
                                    max_seq=r_eng.max_seq)


def test_fault_generators_match_reference():
    for seed in (0, 3):
        assert np.array_equal(TF.storm_arrivals(100, 50.0, seed, storms=4),
                              RF.storm_arrivals(100, 50.0, seed, storms=4))
        got = TF.adversarial_requests(64, seed, max_seq=64, prefix_tokens=8)
        want = RF.adversarial_requests(64, seed, max_seq=64,
                                       prefix_tokens=8)
        assert [(r.uid, r.prompt.tolist(), r.max_new_tokens)
                for r in got] == \
            [(r.uid, r.prompt.tolist(), r.max_new_tokens) for r in want]
    for mod in (TF, RF):
        with pytest.raises(ValueError, match="storm_frac"):
            mod.storm_arrivals(10, 1.0, storm_frac=1.5)
        with pytest.raises(ValueError, match="too tight"):
            mod.adversarial_requests(4, max_seq=12)


def test_pool_shrink_fault_and_schedule():
    eng = TE.ServingEngine(get_reduced("qwen2_0_5b"), plan_only=True,
                           slots=3, max_seq=64, kv_pool_pages=10)
    f = TF.PoolShrinkFault(at_step=0, n_pages=4, restore_step=2)
    g = TF.PoolShrinkFault(at_step=1, n_pages=2)
    sched = TF.FaultSchedule([f, g])
    sched.on_step(eng, 0)
    assert f.seized == 4 and eng._table.pages_in_use == 4
    sched.on_step(eng, 1)
    assert g.seized == 2 and eng._table.pages_in_use == 6
    sched.on_step(eng, 2)
    # restore_pages() returns every seized page, the other fault's too
    assert f.restored and not g.restored
    assert eng._table.pages_in_use == 0
    eng._table.validate()


def test_fault_smoke_module_exits_zero_with_the_reference_lines():
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.serving.faults", "--seeds", "0"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert RF.main(["--seeds", "0"]) == 0
    assert out.stdout.splitlines() == buf.getvalue().splitlines()
    assert out.stdout.strip().endswith("fault-injection smoke OK")


# ------------------------------------------- the report over a swap trace
def _report(rep) -> dict:
    out = dataclasses.asdict(rep)
    out["result"] = dataclasses.asdict(rep.result)
    return out


@pytest.fixture(scope="module")
def swap_traces():
    t_eng, _ = TF.overload_run(1, n_requests=40, preempt="lifo")
    r_eng, _ = RF.overload_run(1, n_requests=40, preempt="lifo")
    assert t_eng.stats.preemptions > 0
    return r_eng.trace, t_eng.trace


@pytest.mark.parametrize("chunk", [1, 311, 10**9])
def test_swap_trace_streamed_matches_reference(swap_traces, chunk):
    rtrace, ttrace = swap_traces
    cfgs_r = [RS.system_for(RS.Scenario(model="serve", mode=m))
              for m in MODES]
    cfgs_t = [TS.system_for(TS.Scenario(model="serve", mode=m))
              for m in MODES]
    got, per_t = TP.replay_trace_streamed(
        cfgs_t, [r.plan for r in ttrace], chunk_events=chunk)
    want, per_r = RP.replay_trace_streamed(
        cfgs_r, [r.plan for r in rtrace], chunk_events=chunk)
    assert [dataclasses.asdict(g) for g in got] == \
        [dataclasses.asdict(w) for w in want]
    for a, b in zip(per_t, per_r):
        assert np.array_equal(a, b)
    if chunk == 311:
        acc_t, acc_r = TR.ServingAccumulator(), RR.ServingAccumulator()
        res_t, p_t = TP.replay_trace_streamed(
            cfgs_t[1], lambda: (r.plan for r in acc_t.wrap(iter(ttrace))),
            chunk_events=chunk)
        res_r, p_r = RP.replay_trace_streamed(
            cfgs_r[1], lambda: (r.plan for r in acc_r.wrap(iter(rtrace))),
            chunk_events=chunk)
        acc_t.meta = acc_t.meta[len(ttrace):]     # the priced pass only
        acc_r.meta = acc_r.meta[len(rtrace):]
        rep_t = acc_t.report("DC", res_t, p_t)
        np.testing.assert_equal(_report(rep_t),
                                _report(acc_r.report("DC", res_r, p_r)))
        assert rep_t.percentiles()["n_preempted"] > 0
        np.testing.assert_equal(
            _report(TR.simulate_serving_trace(cfgs_t[1], ttrace)),
            _report(RR.simulate_serving_trace(cfgs_r[1], rtrace)))
