"""Conservation invariants for the serving engine under pressure.

Preemption and KV swap add state transitions (evict, re-queue,
resume) that are easy to get subtly wrong: a leaked page here, a
re-decoded token there, and the priced trace silently stops meaning
what the report claims.  This module is the executable contract —
``ServingEngine(... ).open_loop_records(debug_invariants=True)`` runs
``check_step`` every iteration and ``check_drained`` at the end, and
the fault-injection suite (``tests/test_torch_open_loop.py``) runs
``check_trace_conservation`` over whole recorded traces:

* **Pool accounting** (every step): the free list, active slots' own
  pages, reserved prefix pages and fault-seized pages partition the
  pool — no double-frees, no leaks (``PageTable.validate``).
* **Slot/queue coherence** (every step): prefilling slots are a
  subset of occupied slots; a request is never simultaneously queued
  and running; swap state only exists for requests NOT in a slot.
* **Post-drain emptiness**: ``pages_in_use`` equals exactly the
  reserved prefix + seized pages (0 with neither), no swap state
  survives, every accepted request finished.
* **Token conservation** (trace-level): across any number of
  preemptions, every request's prefill chunks cover each prompt token
  EXACTLY once and it decodes EXACTLY its expected token count — work
  is moved by preemption, never lost or repeated.
"""
from __future__ import annotations


class InvariantViolation(AssertionError):
    """A serving-engine conservation invariant failed."""


def _fail(msg: str):
    raise InvariantViolation(msg)


def check_step(eng) -> None:
    """Per-iteration engine coherence + pool accounting."""
    t = eng._table
    try:
        t.validate()
    except AssertionError as e:
        _fail(f"pool accounting: {e}")
    occupied = {s for s, r in enumerate(eng.slot_req) if r is not None}
    if not set(eng._prefilling) <= occupied:
        _fail(f"prefilling slots {sorted(eng._prefilling)} not a "
              f"subset of occupied {sorted(occupied)}")
    running = {eng.slot_req[s].uid for s in occupied}
    queued = [r.uid for r in eng.queue]
    if len(queued) != len(set(queued)):
        _fail(f"duplicate uids in queue: {queued}")
    both = running & set(queued)
    if both:
        _fail(f"uids both running and queued: {sorted(both)}")
    swapped_running = set(eng._swapped) & running
    if swapped_running:
        _fail(f"uids running with live swap state: "
              f"{sorted(swapped_running)}")
    for s in occupied:
        if s not in eng._prefilling and int(eng._lens[s]) < 1:
            _fail(f"decoding slot {s} has no cached tokens")


def check_drained(eng) -> None:
    """Nothing survives a drained run but the permanent reservations."""
    if eng.queue or any(r is not None for r in eng.slot_req):
        _fail("check_drained on an engine with live work")
    t = eng._table
    expect = len(t._prefix) + len(t._seized)
    if t.pages_in_use != expect:
        _fail(f"post-drain pages_in_use={t.pages_in_use}, expected "
              f"{expect} (prefix {len(t._prefix)} + seized "
              f"{len(t._seized)}) — leaked "
              f"{t.pages_in_use - expect} pages")
    if eng._swapped:
        _fail(f"post-drain swap state survives for uids "
              f"{sorted(eng._swapped)}")
    if eng._prefilling:
        _fail(f"post-drain prefill state survives for slots "
              f"{sorted(eng._prefilling)}")
    check_step(eng)


def expected_decodes(req, prefix_tokens: int, max_seq: int) -> int:
    """Decode steps a finished request must have consumed: its
    max_new_tokens minus the prefill-emitted first token, clipped by
    the ``max_seq - 1`` retirement the engine enforces."""
    full = prefix_tokens + len(req.prompt)
    if full >= max_seq - 1:
        return 0                       # retired at end of prefill
    return max(0, min(req.max_new_tokens - 1, (max_seq - 1) - full))


def check_trace_conservation(trace, requests, *, prefix_tokens: int = 0,
                             prefix_cached: bool = False,
                             max_seq: int = 10**9,
                             unfinished=()) -> dict:
    """Fold a recorded trace and verify per-request work conservation
    across preemptions.  Returns the per-uid tallies for further
    assertions: ``{"prefill_tokens", "decodes", "swap_outs",
    "swap_ins", "swap_out_pages", "swap_in_pages"}`` keyed by uid.

    For every FINISHED request: prefill chunk ``n_tokens`` must sum to
    its prompt (+ the shared prefix when it is NOT cached) — each
    token prefilled exactly once no matter how many times the request
    was evicted mid-prefill — and decode records containing its uid
    must number ``expected_decodes`` exactly — each token decoded
    exactly once.  Swap records must pair up: every ``swap_out`` is
    matched by a later ``swap_in`` of the SAME page count (unfinished
    requests may hold one trailing unmatched ``swap_out``)."""
    pf: dict = {}
    dec: dict = {}
    so: dict = {}
    si: dict = {}
    so_pages: dict = {}
    si_pages: dict = {}
    pending_swap: dict = {}
    for rec in trace:
        if rec.kind == "prefill":
            uid = rec.uids[0] if rec.uids else -1
            if uid < 0:
                continue
            pf[uid] = pf.get(uid, 0) + rec.n_tokens
        elif rec.kind == "decode":
            for uid in rec.uids:
                dec[uid] = dec.get(uid, 0) + 1
        elif rec.kind == "swap_out":
            uid = rec.uids[0]
            so[uid] = so.get(uid, 0) + 1
            n = len(rec.plan.events) // _streams_per_page(rec.plan)
            so_pages[uid] = so_pages.get(uid, 0) + n
            if uid in pending_swap:
                _fail(f"uid {uid}: swap_out while already swapped out")
            pending_swap[uid] = n
        elif rec.kind == "swap_in":
            uid = rec.uids[0]
            si[uid] = si.get(uid, 0) + 1
            n = len(rec.plan.events) // _streams_per_page(rec.plan)
            si_pages[uid] = si_pages.get(uid, 0) + n
            if pending_swap.pop(uid, None) != n:
                _fail(f"uid {uid}: swap_in of {n} pages does not "
                      "match its pending swap_out")
        else:
            _fail(f"unknown record kind {rec.kind!r}")
    live = set(unfinished)
    for req in requests:
        uid = req.uid
        if uid in live:
            continue
        want_pf = len(req.prompt) + \
            (0 if prefix_cached else prefix_tokens)
        if pf.get(uid, 0) != want_pf:
            _fail(f"uid {uid}: prefilled {pf.get(uid, 0)} tokens, "
                  f"expected {want_pf} — preemption lost or repeated "
                  "prefill work")
        want_dec = expected_decodes(req, prefix_tokens, max_seq)
        if dec.get(uid, 0) != want_dec:
            _fail(f"uid {uid}: {dec.get(uid, 0)} decode steps, "
                  f"expected {want_dec} — a token was decoded "
                  "zero or twice across preemptions")
        if uid in pending_swap:
            _fail(f"uid {uid}: finished with an unmatched swap_out")
    return {uid: {"prefill_tokens": pf.get(uid, 0),
                  "decodes": dec.get(uid, 0),
                  "swap_outs": so.get(uid, 0),
                  "swap_ins": si.get(uid, 0),
                  "swap_out_pages": so_pages.get(uid, 0),
                  "swap_in_pages": si_pages.get(uid, 0)}
            for uid in set(pf) | set(dec) | set(so) | set(si)}


def _streams_per_page(plan) -> int:
    """A swap plan holds n_layers * 2 (K and V) events per page."""
    return max(1, len(plan.tensors))
