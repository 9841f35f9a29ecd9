"""Offline what-if simulation CLI — a thin front-end over the Scenario
API (``core.scenario``).

    PYTHONPATH=src python -m repro_torch.launch.simulate \
        --workload zamba2-7b-reduced
    PYTHONPATH=src python -m repro_torch.launch.simulate \
        --model bert-medium --layers 2
    PYTHONPATH=src python -m repro_torch.launch.simulate --gemm 512 512 512
    PYTHONPATH=src python -m repro_torch.launch.simulate --workload serve
    PYTHONPATH=src python -m repro_torch.launch.simulate --list
    PYTHONPATH=src python -m repro_torch.launch.simulate --smoke
    PYTHONPATH=src python -m repro_torch.launch.simulate \
        --model bert-base --tune

``--workload`` (and its historical alias ``--model``) accepts ANY name
from the scenario registry: every ``configs/*.py`` ``ModelConfig``
(full or ``-reduced``), the paper's BERT/ViT models, the workload-class
aliases (``bert``/``vit``), and the synthetic classes
(``moe``/``ssm``/``decode``/``serve``/``gemm``).  Unknown names get a
did-you-mean error listing the valid scenarios — resolution always goes
through the registry, never a partial name table.

Workloads replay steady-state sampled by default (one window per layer
CLASS x repeat — heterogeneous stacks like zamba2 sample each class
separately); ``--exact`` materializes the full composed event graph.
``--engine both`` replays on the compiled array engine AND the event
loop and asserts every result field agrees to rtol 1e-9.  ``--smoke``
runs the registry-generated CI matrix: one reduced scenario per model
family, engine parity on each.

``--tune`` searches the co-design knob space (``core.design_space``)
against the selected workload instead of replaying a single system:
every feasible point is priced with the config-batched replayer and
the latency-vs-area Pareto frontier is printed.  ``--tune-points N``
random-samples the space instead of enumerating the full grid.

``--workload serve`` runs the reduced serving engine with plan
recording on ``--device`` (``cuda`` by default; ``cpu`` runs the plain
PyTorch versions of the kernels) and prices the recorded trace in each
memory mode.  The replay itself is numpy on the host.

``--workload serve --arrivals poisson`` switches the serve scenario
from draining a closed queue to an open-loop load sweep
(``core.scenario.sweep_load``): seeded poisson/bursty/diurnal
arrivals at each ``--qps`` grid rate (auto-bracketed around the
calibrated capacity when omitted), ``--requests`` requests per
point, every trace priced across the memory modes in one chunked
streaming replay — printing offered QPS vs TTFT/TPOT p99 per mode
plus the saturation knee.  ``--preempt lifo|longest`` pressure-caps
the KV pool so admission stalls trigger preemption + KV swap-to-host
and extends the grid past the knee (the swap-thrash curve);
``--swap`` adds per-point preemption counts and swap-DMA / queue
tail columns.  The sweep's engine is plan-only: it runs on the host
whatever ``--device`` says.

    PYTHONPATH=src python -m repro_torch.launch.simulate --workload serve \
        --arrivals poisson --qps 100 300 900 --requests 200
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.core.scenario import (Scenario, SimResult,
                                       UnsupportedScenario, as_params,
                                       resolve, scenario_names, simulate,
                                       smoke_matrix)


def _fmt(res: SimResult) -> str:
    r = res.result
    b = r.buckets()
    shares = " ".join(f"{k}={v:5.1%}" for k, v in b.items())
    return f"total={r.total_s*1e6:10.1f}us  {shares}  " \
           f"tlb_miss={r.tlb_misses}  gops={r.gops:.1f}"


def _run_modes(sc: Scenario, modes, engine: str, device="cuda") -> None:
    """Simulate one scenario across memory modes, printing a row per
    (mode, engine); ``engine="both"`` prints both rows plus the parity
    confirmation ``simulate`` asserts internally."""
    header = None
    for mode in modes:
        engines = ("compiled", "event") if engine == "both" \
            else (engine,)
        results = {}
        for eng in engines:
            res = simulate(dataclasses.replace(sc, mode=mode,
                                               engine=eng),
                           device=device)
            results[eng] = res
            if header is None:
                # serve replays a recorded trace exactly — the
                # sampling policy does not apply to it
                policy = "trace" if res.serving is not None \
                    else sc.sampling
                header = f"{res.label} ({policy}): events " \
                         f"replayed={res.events_replayed} " \
                         f"total={res.events_total} " \
                         f"({res.sampling_speedup:.1f}x fewer)"
                print(header)
            print(f"{res.label} {res.scenario.dtype} {mode:7s} "
                  f"{_fmt(res)}  [{res.engine}: "
                  f"wall={res.wall_s*1e3:.1f}ms "
                  f"{res.events_per_s:,.0f} ev/s]")
        last = results[engines[-1]]
        if last.serving is not None:    # once per mode, engines agree
            pct = last.serving
            print(f"serve {mode:7s} simulated latency: " + "  ".join(
                f"{k}={pct[k]:.1f}" for k in
                ("ttft_p50_us", "ttft_p95_us", "ttft_p99_us",
                 "tpot_p50_us", "tpot_p95_us", "tpot_p99_us")) +
                f"  requests={pct['requests']}")
        if engine == "both":
            from repro_torch.core.scenario import assert_parity
            assert_parity(results["compiled"], results["event"])
            print(f"{results['compiled'].label} {mode}: compiled == "
                  f"event (all GemmResult fields, rtol<=1e-9)")


def _run_tune(sc: Scenario, n_points) -> int:
    """Price the co-design knob space against one workload and print
    the scored points, the latency-vs-area Pareto frontier and the
    batched-pricing throughput."""
    from repro_torch.core.design_space import default_space
    from repro_torch.core.scenario import tune

    space = default_space()
    points = space.sample(n_points, seed=0) \
        if n_points is not None else space
    res = tune(sc, points)
    print(f"tune {res.scenario.model} ({res.scenario.sampling}): "
          f"{len(res.points)} points scored in {res.wall_s:.2f}s "
          f"({res.configs_per_s:,.0f} configs/s, "
          f"{res.n_infeasible} infeasible filtered)")
    best = res.best
    shown = sorted(res.points, key=lambda tp: tp.score)[:10]
    for tp in shown:
        mark = "*" if tp is best else " "
        front = "pareto" if tp.on_pareto else "      "
        print(f" {mark} {front} {tp.point.label():44s} "
              f"total={tp.total_s * 1e6:9.1f}us "
              f"area={tp.area_um2 / 1e6:6.2f}mm2 "
              f"score={tp.score:.4g}")
    n_more = len(res.points) - len(shown)
    if n_more > 0:
        print(f"   ... {n_more} more points (lowest 10 scores shown)")
    print(f"pareto frontier: {len(res.pareto)} points; "
          f"best ({res.objective}): {best.point.label()}")
    return 0


def _run_load_sweep(args) -> int:
    """Open-loop load sweep over the memory modes: one line per
    (offered QPS, mode) plus the saturation knee per mode.  With
    ``--preempt`` the pool is pressure-capped and the grid extended
    past the knee; ``--swap`` adds the swap-thrash columns."""
    from repro_torch.core.scenario import sweep_load
    res = sweep_load(qps=args.qps, n_requests=args.requests,
                     arrivals=args.arrivals, modes=tuple(args.modes),
                     prefix_tokens=args.prefix_tokens,
                     preempt=args.preempt,
                     stall_budget_s=args.stall_budget_us * 1e-6,
                     workers=args.workers)
    cal = res.calibration
    pool = f", pool={res.kv_pool_pages} pages" \
        if res.kv_pool_pages is not None else ""
    pre = f", preempt={res.preempt}{pool}" \
        if res.preempt != "none" else ""
    print(f"load sweep {res.arch} ({res.arrivals}, "
          f"{res.n_requests} requests/point{pre}): est capacity "
          f"{cal['capacity_qps_est']:,.0f} qps "
          f"(decode step {cal['est_step_s']*1e6:.1f}us); "
          f"wall {res.wall_s:.1f}s")
    for mode in res.modes:
        for pt in res.curve(mode):
            p = pt.percentiles
            cens = f" in_flight={p['n_in_flight']}" \
                if p["n_in_flight"] else ""
            swap = f" preempt={p['preemptions']:4d} " \
                   f"swap_p99={p['swap_p99_us']:7.1f}us " \
                   f"queue_p99={p['queue_p99_us']:9.1f}us" \
                if args.swap else ""
            print(f"  {mode:7s} qps={pt.qps:10,.1f} "
                  f"ttft_p99={p['ttft_p99_us']:9.1f}us "
                  f"tpot_p99={p['tpot_p99_us']:8.1f}us "
                  f"goodput={pt.goodput_qps:10,.1f}/s "
                  f"events={pt.n_events:,}{swap}{cens}")
        k = res.knee_qps[mode]
        print(f"  {mode:7s} saturation knee: " +
              (f"{k:,.1f} qps" if k else "not reached on this grid"))
    if res.prefix_delta:
        for mode, d in res.prefix_delta.items():
            print(f"  {mode:7s} prefix caching: ttft_p99 "
                  f"{d['ttft_p99_us_on']:.1f}us vs "
                  f"{d['ttft_p99_us_off']:.1f}us uncached "
                  f"({d['records_off'] - d['records_on']} prefill "
                  f"records saved)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", metavar="SCENARIO",
                    help="any scenario-registry name (see --list)")
    ap.add_argument("--model", metavar="SCENARIO",
                    help="historical alias of --workload")
    ap.add_argument("--gemm", type=int, nargs=3, metavar=("M", "N", "K"),
                    help="single Algorithm-1 GEMM instead of a model")
    ap.add_argument("--list", action="store_true",
                    help="print every valid scenario name and exit")
    ap.add_argument("--smoke", action="store_true",
                    help="registry-generated CI matrix: one reduced "
                         "scenario per model family, engine parity")
    ap.add_argument("--layers", type=int, default=None,
                    help="cap the layer stack (default: full model)")
    ap.add_argument("--seq", type=int, default=None,
                    help="sequence length (default: per-model)")
    ap.add_argument("--dtype", default="int8",
                    choices=["int8", "int16", "int32", "fp8", "fp16",
                             "fp32"])
    ap.add_argument("--modes", nargs="+", default=["DM", "DC", "DevMem"],
                    choices=["DM", "DC", "DevMem"])
    ap.add_argument("--sample-stride", type=int, default=1,
                    help="additionally stride the GEMM inner loops of "
                         "the sampled window")
    ap.add_argument("--exact", action="store_true",
                    help="replay the full composed event graph instead "
                         "of the steady-state sample")
    ap.add_argument("--engine", default="auto",
                    choices=["auto", "event", "compiled", "both"],
                    help="replayer: compiled array engine vs Python "
                         "event loop ('both' checks parity)")
    ap.add_argument("--tune", action="store_true",
                    help="design-space search (core.design_space) over "
                         "the workload: batched pricing + Pareto front")
    ap.add_argument("--tune-points", type=int, default=None,
                    metavar="N",
                    help="random-sample the space to N points instead "
                         "of the full grid (seeded, deterministic)")
    ap.add_argument("--devmem-dram", default="HBM2",
                    help="DRAM tech for DevMem mode (paper Fig. 12)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree: shard heads/FFN over "
                         "N ranks with all-gather/reduce-scatter at "
                         "the Megatron cut points (config models only)")
    ap.add_argument("--ep", type=int, default=1,
                    help="expert-parallel degree: shard MoE experts "
                         "over N ranks with all-to-all dispatch/combine")
    ap.add_argument("--fabric", default="ring",
                    metavar="TOPO[:GBS[:HOP_NS]]",
                    help="inter-accelerator fabric, e.g. 'ring', "
                         "'alltoall', 'ring:64', 'ring:64:800' "
                         "(topology, link GB/s, per-hop latency)")
    ap.add_argument("--pcie-gb-s", type=float, default=None,
                    help="override the host link's raw bandwidth (GB/s)")
    ap.add_argument("--device", default="cuda",
                    help="where the serve scenario's engine runs "
                         "(default cuda; cpu runs the kernels' plain "
                         "PyTorch versions)")
    ap.add_argument("--arrivals", default=None,
                    choices=["poisson", "bursty", "diurnal"],
                    help="serve only: open-loop load sweep with this "
                         "arrival process (core.scenario.sweep_load)")
    ap.add_argument("--qps", type=float, nargs="+", default=None,
                    metavar="RATE",
                    help="offered-rate grid for --arrivals (default: "
                         "auto-bracketed around calibrated capacity)")
    ap.add_argument("--requests", type=int, default=200,
                    help="requests per load point for --arrivals "
                         "(default 200)")
    ap.add_argument("--prefix-tokens", type=int, default=0,
                    help="shared system-prompt tokens for --arrivals "
                         "(reports the prefix-caching on/off delta)")
    ap.add_argument("--preempt", default="none",
                    choices=["none", "lifo", "longest"],
                    help="serve only: preemption policy under memory "
                         "pressure — caps the KV pool and extends the "
                         "sweep past the knee (swap-thrash curve)")
    ap.add_argument("--stall-budget-us", type=float, default=0.0,
                    help="admission stall tolerated before preempting "
                         "a victim (default 0: preempt immediately)")
    ap.add_argument("--swap", action="store_true",
                    help="serve only: print per-point preemption / "
                         "swap-DMA / queue-delay tail columns")
    ap.add_argument("--workers", type=int, default=1,
                    help="process-pool width for --arrivals sweep "
                         "points (results identical to --workers 1)")
    args = ap.parse_args(argv)
    if args.list:
        print("\n".join(scenario_names()))
        return 0
    name = args.model or args.workload
    if args.smoke:
        for sc in smoke_matrix():
            sc = dataclasses.replace(sc, devmem_dram=args.devmem_dram)
            _run_modes(sc, args.modes, "both")
        print(f"smoke matrix OK: {len(smoke_matrix())} scenarios x "
              f"{len(args.modes)} modes, engine parity held")
        return 0
    if not name and not args.gemm:
        ap.error("one of --workload / --model / --gemm / --smoke / "
                 "--list is required")
    if args.layers is not None and args.layers < 1:
        ap.error("--layers must be >= 1")
    if args.sample_stride < 1:
        ap.error("--sample-stride must be >= 1")
    if args.tune_points is not None:
        if not args.tune:
            ap.error("--tune-points requires --tune")
        if args.tune_points < 1:
            ap.error("--tune-points must be >= 1")

    params = ()
    if args.gemm:
        name = "gemm"
        m, n, k = args.gemm
        params = as_params(m=m, n=n, k=k)
    try:
        target = resolve(name)
    except UnsupportedScenario as e:
        ap.error(str(e))
    if target.kind == "serve":
        args.dtype = "fp16"        # the engine's KV cache dtype decides
    if args.arrivals is None and (args.preempt != "none" or args.swap):
        ap.error("--preempt/--swap require --arrivals (load sweep)")
    if args.arrivals is not None:
        if target.kind != "serve":
            ap.error("--arrivals only applies to --workload serve")
        if args.requests < 1:
            ap.error("--requests must be >= 1")
        if args.stall_budget_us < 0:
            ap.error("--stall-budget-us must be >= 0")
        return _run_load_sweep(args)
    try:
        sc = Scenario(model=name, dtype=args.dtype, seq=args.seq,
                      n_layers=args.layers,
                      sampling="exact" if args.exact else "sampled",
                      sample_stride=args.sample_stride,
                      devmem_dram=args.devmem_dram, params=params,
                      tp=args.tp, ep=args.ep, fabric=args.fabric,
                      pcie_gb_s=args.pcie_gb_s)
        if args.tune:
            return _run_tune(sc, args.tune_points)
        _run_modes(sc, args.modes, args.engine, args.device)
    except UnsupportedScenario as e:
        ap.error(str(e))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
