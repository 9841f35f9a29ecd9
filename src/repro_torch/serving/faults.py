"""Deterministic overload / fault injection for the serving engine.

Three seeded pressure generators drive the property tests (and the
smoke matrix of ``main``) that prove the engine degrades gracefully instead of
leaking, livelocking, or corrupting state:

* ``storm_arrivals`` — burst storms: whole cohorts of requests
  arriving at the same instant, separated by quiet gaps.  Far
  harsher than the ``bursty`` arrival process — the queue must grow
  and drain, never wedge.
* ``adversarial_requests`` — long-prompt mixes: a seeded blend of
  tiny requests and near-``max_seq`` monsters whose worst-case page
  reservations collide, maximizing deferrals and preemptions.
* ``PoolShrinkFault`` — mid-run pool shrinkage: a co-tenant seizes
  free KV pages at a scheduled step and returns them later, breaking
  the conservative-admission reservation out from under admitted
  requests (the only path that can make decode-time page growth
  fail — exercising the swap-out degradation instead of the
  ``RuntimeError``).

Everything is seeded and replayable: same seed => same storm, same
seizure schedule, same trace.  ``python -m repro_torch.serving.faults
--seeds 0 1 2`` runs the smoke matrix with invariants on, on the host:
the engine it drives is plan-only and touches no device.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def storm_arrivals(n: int, qps: float, seed: int = 0, *,
                   storm_frac: float = 0.5,
                   storms: int = 4) -> np.ndarray:
    """``n`` sorted arrival times at mean rate ``qps`` where
    ``storm_frac`` of the requests land in ``storms`` zero-width
    spikes (every request in a spike arrives at the SAME instant) and
    the rest trickle as a Poisson stream — the worst realizable burst
    for an admission queue."""
    if not 0.0 <= storm_frac <= 1.0:
        raise ValueError(f"storm_frac must be in [0, 1]: {storm_frac}")
    rng = np.random.default_rng(seed)
    span = n / qps
    n_storm = int(n * storm_frac)
    trickle = np.sort(rng.uniform(0.0, span, size=n - n_storm))
    centers = np.sort(rng.uniform(0.0, span, size=max(storms, 1)))
    per = np.full(max(storms, 1), n_storm // max(storms, 1))
    per[:n_storm - int(per.sum())] += 1
    spikes = np.repeat(centers, per)
    return np.sort(np.concatenate([trickle, spikes]))


def adversarial_requests(n: int, seed: int = 0, *, max_seq: int = 64,
                         prefix_tokens: int = 0,
                         monster_frac: float = 0.25,
                         max_new_lo: int = 1,
                         max_new_hi: int = 8) -> list:
    """Seeded long-prompt mix: ``monster_frac`` of the requests carry
    prompts close to the ``max_seq`` budget (their conservative page
    reservations dominate the pool), the rest are small.  Interleaved
    in arrival order, so monsters repeatedly stall behind and preempt
    the small fry."""
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(seed)
    budget = max_seq - prefix_tokens - max_new_hi
    if budget < 8:
        raise ValueError(
            f"max_seq={max_seq} leaves a {budget}-token prompt budget "
            "— too tight for an adversarial mix")
    reqs = []
    for i in range(n):
        if rng.random() < monster_frac:
            t = int(rng.integers(max(budget * 3 // 4, 4), budget + 1))
        else:
            t = int(rng.integers(4, max(budget // 4, 5)))
        reqs.append(Request(
            uid=i,
            prompt=rng.integers(1, 250, size=t).astype(np.int32),
            max_new_tokens=int(rng.integers(max_new_lo, max_new_hi))))
    return reqs


@dataclasses.dataclass
class PoolShrinkFault:
    """Seize ``n_pages`` free KV pages at engine step ``at_step`` and
    restore them at ``restore_step`` (never, if None) — deterministic
    mid-run memory loss.  Implements the ``on_step`` hook
    ``open_loop_records(faults=...)`` calls once per iteration."""
    at_step: int
    n_pages: int
    restore_step: int | None = None
    seized: int = 0
    restored: bool = False

    def on_step(self, eng, step: int) -> None:
        if step == self.at_step and not self.seized:
            self.seized = eng._table.seize_pages(self.n_pages)
        if self.restore_step is not None and step >= self.restore_step \
                and self.seized and not self.restored:
            eng._table.restore_pages()
            self.restored = True


@dataclasses.dataclass
class FaultSchedule:
    """Compose several faults into one ``on_step`` hook."""
    faults: list

    def on_step(self, eng, step: int) -> None:
        for f in self.faults:
            f.on_step(eng, step)


def overload_run(seed: int, *, n_requests: int = 60, slots: int = 3,
                 max_seq: int = 64, kv_page_tokens: int = 8,
                 preempt: str = "lifo", qps: float = 400.0,
                 pool_frac: float = 0.55, shrink_frac: float = 0.25,
                 max_steps: int = 50_000, arch: str = "qwen2_0_5b"):
    """One seeded overload scenario: storm arrivals x adversarial
    prompts x a mid-run pool shrink, on a pool deliberately too small
    for the worst case, with invariants checked EVERY step.  Returns
    ``(engine, requests)`` — the drained engine retains the trace for
    further assertions."""
    from repro_torch.configs import get_reduced
    from repro_torch.serving.engine import ServingEngine

    pages_per_seq = -(-max_seq // kv_page_tokens)
    pool = max(pages_per_seq + 1,
               int(slots * pages_per_seq * pool_frac))
    eng = ServingEngine(get_reduced(arch), plan_only=True, slots=slots,
                        max_seq=max_seq, kv_page_tokens=kv_page_tokens,
                        kv_pool_pages=pool)
    reqs = adversarial_requests(n_requests, seed, max_seq=max_seq)
    arr = storm_arrivals(n_requests, qps, seed)
    fault = PoolShrinkFault(at_step=10,
                            n_pages=max(1, int(pool * shrink_frac)),
                            restore_step=200 + 10 * seed)
    eng.run_open_loop(reqs, arr, prefill_chunk_tokens=kv_page_tokens,
                      est_step_s=1e-4, est_prefill_s_per_token=1e-5,
                      max_steps=max_steps, preempt=preempt,
                      faults=fault, debug_invariants=True)
    return eng, reqs


def main(argv=None) -> int:
    """Smoke the fault matrix: for each seed, run the overload
    scenario under both preemption policies with per-step invariants
    on, then check trace-level token conservation.  Exits non-zero on
    any violation."""
    import argparse

    from repro_torch.serving import invariants

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--requests", type=int, default=60)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        for policy in ("lifo", "longest"):
            eng, reqs = overload_run(seed, n_requests=args.requests,
                                     preempt=policy)
            if not eng.stats.drained:
                print(f"FAIL seed={seed} {policy}: not drained")
                return 1
            invariants.check_drained(eng)
            invariants.check_trace_conservation(
                eng.trace, reqs, max_seq=eng.max_seq)
            s = eng.stats
            print(f"seed={seed} {policy:7s}: {eng.n_finished} finished"
                  f", {s.preemptions} preemptions, {s.swapped_pages} "
                  f"pages swapped, {eng.deferred_admissions} deferrals"
                  f", {s.decode_steps} decode steps — invariants OK")
    print("fault-injection smoke OK")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
