"""The serving-scale workloads of ``BENCH_serving_scale.json``, rebuilt by
the plan-only engine and priced by the streamed replay.

Each workload is 1,000 requests of 8-11 prompt tokens and 2-3 new
tokens, arriving poisson at 500 qps into 8 slots of ``max_seq`` 64 with
8-token pages and 16-token prefill chunks, on the benchmark's fixed
admission clock (``est_step_s`` 1e-4, ``est_prefill_s_per_token``
1e-5).  ``serve_1k.prefix_32tok.{off,on}`` prepend a 32-token shared
prefix without and with prefix caching; ``serve_preempt_1k`` caps the
pool at 4 pages under ``preempt="lifo"``.

``reproduce_serving_scale(name)`` builds one workload's trace, checks
that every request's work is conserved, prices it in every memory mode
in one two-pass streamed replay, and returns its counts and totals;
``artifact_row(name, artifact)`` reads the same fields from the
artifact, so a caller compares the two.
"""
import time

import numpy as np

QPS = 500.0
SEED = 0
N_REQUESTS = 1000
CHUNK_EVENTS = 262_144
ENGINE_KW = dict(slots=8, max_seq=64, kv_page_tokens=8)
RUN_KW = dict(est_step_s=1e-4, est_prefill_s_per_token=1e-5,
              prefill_chunk_tokens=16)
# name -> (engine, run) arguments on top of ENGINE_KW / RUN_KW
WORKLOADS = {
    "serve_1k": ({}, {}),
    "serve_1k.prefix_32tok.off": (dict(prefix_tokens=32), {}),
    "serve_1k.prefix_32tok.on": (dict(prefix_tokens=32,
                                      prefix_caching=True), {}),
    "serve_preempt_1k": (dict(kv_pool_pages=4), dict(preempt="lifo")),
}


def scale_requests(n: int) -> list:
    """The benchmark's ``n`` requests, drawn from seed ``SEED + 1``."""
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(SEED + 1)
    return [Request(uid=i, prompt=rng.integers(
        1, 250, size=int(rng.integers(8, 12))).astype(np.int32),
        max_new_tokens=int(rng.integers(2, 4))) for i in range(n)]


def artifact_row(name: str, artifact: dict) -> dict:
    """``name``'s counts and per-mode ``total_s`` in the artifact.  Its
    prefix rows give records, events and the DC total alone; a
    top-level row without swap counts ran without preemption."""
    if name.startswith("serve_1k.prefix_32tok."):
        row = artifact["workloads"]["serve_1k"]["prefix_32tok"][
            name.rsplit(".", 1)[1]]
        out = {k: row[k] for k in ("records", "events")}
    else:
        row = artifact["workloads"][name]
        out = {k: row.get(k, 0) for k in (
            "records", "events", "footprint_pages", "preemptions",
            "swapped_pages")}
    out["total_s"] = row["total_s"] if isinstance(row["total_s"], dict) \
        else {"DC": row["total_s"]}
    return out


def reproduce_serving_scale(name: str, n_requests: int = N_REQUESTS,
                            modes=None) -> dict:
    """Rebuild workload ``name`` with the templated plan-only engine,
    hold its trace to ``invariants.check_trace_conservation``, and price
    it in ``modes`` (default DM / DC / DevMem) in one streamed replay
    whose second pass rebuilds the trace.  Returns the records, events,
    footprint pages, preemptions, swapped pages, whether it drained,
    each mode's ``total_s``, and the host seconds of the build
    (``gen_s``) and of the replay (``price_s``)."""
    from repro_torch.accesys.pipeline import (release_scratch,
                                              replay_trace_streamed)
    from repro_torch.configs import get_reduced
    from repro_torch.core import scenario as SC
    from repro_torch.core.plan import _plan_n_events, trace_footprint
    from repro_torch.serving import invariants
    from repro_torch.serving.engine import ServingEngine, arrival_times

    engine_kw, run_kw = WORKLOADS[name]
    modes = tuple(modes or SC.MODES)
    engines = []

    def records():
        eng = ServingEngine(get_reduced("qwen2_0_5b"), plan_only=True,
                            **ENGINE_KW, **engine_kw)
        engines.append(eng)
        return eng.open_loop_records(
            scale_requests(n_requests),
            arrival_times("poisson", n_requests, QPS, seed=SEED),
            **RUN_KW, **run_kw)

    t = time.perf_counter()
    trace = list(records())
    gen_s = time.perf_counter() - t
    eng = engines[0]
    invariants.check_trace_conservation(
        trace, scale_requests(n_requests),
        prefix_tokens=engine_kw.get("prefix_tokens", 0),
        prefix_cached=engine_kw.get("prefix_caching", False),
        max_seq=eng.max_seq)
    got = {"records": len(trace),
           "events": sum(_plan_n_events(r.plan) for r in trace),
           "footprint_pages": trace_footprint(r.plan for r in trace),
           "preemptions": eng.stats.preemptions,
           "swapped_pages": eng.stats.swapped_pages,
           "drained": eng.stats.drained and eng.n_finished == n_requests}
    del trace
    cfgs = [SC.system_for(SC.Scenario(model="serve", mode=m))
            for m in modes]
    t = time.perf_counter()
    results, _ = replay_trace_streamed(
        cfgs, lambda: (r.plan for r in records()),
        footprint_pages=got["footprint_pages"], chunk_events=CHUNK_EVENTS)
    price_s = time.perf_counter() - t
    release_scratch()
    got["total_s"] = {m: r.total_s for m, r in zip(modes, results)}
    return {**got, "gen_s": gen_s, "price_s": price_s}
