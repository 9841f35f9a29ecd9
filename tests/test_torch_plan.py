"""The port's StreamPlan IR against the reference, builder by builder.

Every builder gets the same arguments in both packages; the plans must
be bitwise equal: every ``Event`` field, every ``TensorSpec``,
``counts()``, ``footprint_pages``, ``n_exact_events``, the step
counters, and the ``compile()`` arrays (values, dtypes and the interned
page-key order).  Templated instances, relabelling and chunked trace
compilation are held to the same standard.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import plan as R  # noqa: E402
from repro_torch.core import plan as P  # noqa: E402

COMPILED_COLS = ("trace_ids", "trace_nbytes", "trace_is_out", "in_lane",
                 "op_kind", "op_val", "grp_end", "n_lanes", "seg_op",
                 "seg_trace")


def _event(ev):
    return (ev.eid, ev.kind.value, ev.nbytes, ev.page, ev.deps, ev.lane,
            ev.op, ev.unit, dict(ev.meta))


def _spec(t):
    return (t.rows, t.cols, set(t.roles), t.kind, t.pages)


def assert_compiled_equal(a, b):
    assert a.n_events == b.n_events
    assert a.page_keys == b.page_keys
    for f in COMPILED_COLS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        assert np.array_equal(x, y), f


def assert_plan_equal(got, want):
    assert (got.name, got.dtype, got.page_bytes) == \
        (want.name, want.dtype, want.page_bytes)
    assert [_event(e) for e in got.events] == \
        [_event(e) for e in want.events]
    assert {n: _spec(t) for n, t in got.tensors.items()} == \
        {n: _spec(t) for n, t in want.tensors.items()}
    for f in ("macs", "n_calls", "total_steps", "sampled_steps",
              "exact_events", "n_exact_events", "footprint_pages"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.counts() == want.counts()
    got.validate()
    assert_compiled_equal(got.compile(), want.compile())


def assert_schedule_equal(got, want):
    assert got.name == want.name
    assert [r for _, r in got.segments] == [r for _, r in want.segments]
    for (g, _), (w, _) in zip(got.segments, want.segments):
        assert_plan_equal(g, w)
    for f in ("macs", "n_calls", "footprint_pages", "sampled_events",
              "exact_events"):
        assert getattr(got, f) == getattr(want, f), f
    got.validate()
    assert_compiled_equal(got.compile(), want.compile())


def _both(builder, *args, **kwargs):
    return getattr(P, builder)(*args, **kwargs), \
        getattr(R, builder)(*args, **kwargs)


# --------------------------------------------------------------- GEMM
@pytest.mark.parametrize("m,n,k", [(33, 41, 100), (64, 64, 64),
                                   (17, 100, 300), (1, 1, 1)])
@pytest.mark.parametrize("dtype", ["int8", "float16", "float32", "fp16"])
def test_gemm_plan_equal(m, n, k, dtype):
    assert_plan_equal(*_both("gemm_plan", m, n, k, dtype))


@pytest.mark.parametrize("kw", [dict(order="ijk"), dict(sample_stride=7),
                                dict(page_bytes=8192, a="x", b="w", c="y",
                                     b_kind="weight", name="proj")])
def test_gemm_plan_options_equal(kw):
    assert_plan_equal(*_both("gemm_plan", 100, 90, 300, "float16", **kw))


def test_gemm_plan_of_a_bfloat16_operand_is_a_float16_plan():
    got = P.gemm_plan(40, 48, 130, torch.bfloat16)
    assert got.dtype == "float16"
    assert_plan_equal(got, R.gemm_plan(40, 48, 130, np.float16))


def test_gemm_tile_steps_and_cached_builders_equal():
    assert [dataclasses.astuple(st) for st in
            P.gemm_tile_steps_cached(50, 70, 300, "int8")] == \
        [dataclasses.astuple(st) for st in
         R.gemm_tile_steps_cached(50, 70, 300, "int8")]
    got = P.gemm_plan_cached(50, 70, 300, "float32", sample_stride=3)
    assert got is P.gemm_plan_cached(50, 70, 300, "float32",
                                     sample_stride=3)
    assert_plan_equal(got, R.gemm_plan_cached(50, 70, 300, "float32",
                                              sample_stride=3))


# ----------------------------------------------------------- host, coll
def test_host_and_collective_plans_equal():
    assert_plan_equal(*_both(
        "host_plan", "moe_dispatch", ("x", "logits"), None, None, 640,
        "float32", meta={"E": 2, "k": 1, "C": 8},
        outs=[("e0.buf", (8, 40)), ("e1.buf", (8, 40))]))
    assert_plan_equal(*_both("host_plan", "gelu", ("a",), "g", (4, 8), 32,
                             "int8", out_kind="output"))
    assert_plan_equal(*_both("collective_plan", "all_gather",
                             [4096, 4096, 8192], "float16", lane=3,
                             meta={"group": "tp"}))


# ------------------------------------------------- attention and layers
def test_attention_and_layer_plans_equal():
    assert_plan_equal(*_both("attention_plan", 24, 16, "float32"))
    assert_plan_equal(*_both("attention_plan", 40, 32, "int8",
                             sample_stride=3, prefix="h0."))
    assert_plan_equal(*_both("transformer_layer_plan", 16, 32, 2, 64,
                             "float32", layer=1, x="emb"))
    assert_plan_equal(*_both("model_plan", 32, 64, 2, 256, 2, "int8"))
    assert P.layer_weights(32, 64, 3) == R.layer_weights(32, 64, 3)


def test_model_schedule_equal():
    assert_schedule_equal(*_both("model_schedule", 32, 64, 2, 256, 3,
                                 "int8", sample_stride=2))


# ----------------------------------------------------------- MoE / SSM
def test_moe_plans_equal():
    assert_plan_equal(*_both("moe_layer_plan", 16, 32, 4, 2, 64,
                             "float32", capacity=16))
    assert_plan_equal(*_both("moe_layer_plan", 30, 32, 3, 2, 48, "int8",
                             act="gelu", layer=2))
    assert_schedule_equal(*_both("moe_schedule", 64, 64, 4, 2, 128, 3,
                                 "int8", sample_stride=2))
    assert P.moe_layer_weights(32, 4, 64, 1) == \
        R.moe_layer_weights(32, 4, 64, 1)


def test_ssm_plans_equal():
    assert_plan_equal(*_both("ssm_layer_plan", 32, 64, 4, "float32",
                             chunk=16))
    assert_plan_equal(*_both("ssm_layer_plan", 40, 32, 2, "int8",
                             chunk=16, inclusive=False, layer=1))
    assert_schedule_equal(*_both("ssm_schedule", 64, 64, 4, 3, "int8",
                                 sample_stride=3))
    assert P.ssm_layer_weights(64, 2) == R.ssm_layer_weights(64, 2)


# ------------------------------------------------- decode, prefill, swap
TABLES = [[3, 9, 4], [], [7], [12, 2, 30, 31]]
LENS = [20, 0, 5, 27]


@pytest.mark.parametrize("kw", [dict(), dict(n_q_heads=14, n_kv_heads=2),
                                dict(n_layers=3, n_q_heads=4),
                                dict(scale=0.25, out="o", name="d")])
def test_decode_step_plan_equal(kw):
    kw = dict(kw)
    kh = kw.pop("n_kv_heads", 2)
    assert_plan_equal(*_both("decode_step_plan", TABLES, LENS, 8, kh, 16,
                             2, **kw))


def test_decode_step_schedule_equal():
    assert_schedule_equal(*_both("decode_step_schedule", TABLES, LENS, 8,
                                 2, 16, 1, 4, n_q_heads=4))


@pytest.mark.parametrize("kw", [
    dict(), dict(n_q_heads=4, d_model=64, d_ff=96, n_layers=2),
    dict(span=(8, 24)), dict(span=(16, 27), n_q_heads=4)])
def test_prefill_plan_equal(kw):
    assert_plan_equal(*_both("prefill_plan", [5, 1, 9, 2], 27, 8, 2, 16,
                             2, **kw))


def test_prefill_plan_refuses_short_tables_like_the_reference():
    with pytest.raises(ValueError):
        P.prefill_plan([5], 27, 8, 2, 16, 2)
    with pytest.raises(ValueError):
        P.prefill_plan([5, 1, 9, 2], 27, 8, 2, 16, 2, span=(3, 24))


@pytest.mark.parametrize("direction", ["out", "in"])
def test_swap_plan_equal(direction):
    assert_plan_equal(*_both("swap_plan", 3, 8, 2, 16, 2,
                             direction=direction, tag=17, n_layers=2))


def test_concat_equal():
    parts = lambda M: [M.gemm_plan(16, 16, 64, "float32", c="t"),  # noqa
                       M.host_plan("gelu", ("t",), "g", (16, 16), 256,
                                   "float32"),
                       M.gemm_plan(16, 16, 16, "float32", a="g", b="w",
                                   c="out")]
    for barrier in (True, False):
        assert_plan_equal(P.concat(parts(P), barrier=barrier),
                          R.concat(parts(R), barrier=barrier))
    with pytest.raises(ValueError):
        P.concat([])


# ---------------------------------------------------- templates, traces
def test_templated_instances_equal_reference_instances():
    tp, tr = P.PlanTemplate(), R.PlanTemplate()
    rng = np.random.default_rng(0)
    for trial in range(8):
        tables = [[int(p) for p in rng.choice(200, int(rng.integers(0, 4)),
                                               replace=False)]
                  for _ in range(3)]
        tables[0] = tables[0] or [199]
        lens = [0 if not t else len(t) * 8 - int(rng.integers(0, 8))
                for t in tables]
        kw = dict(n_q_heads=4, n_layers=1 + trial % 2)
        got = tp.decode_step(tables, lens, 8, 2, 16, 2, **kw)
        want = tr.decode_step(tables, lens, 8, 2, 16, 2, **kw)
        assert got.name == want.name and got.macs == want.macs
        assert got.inst_keys == want.inst_keys
        assert_compiled_equal(got.compile(), want.compile())
        assert_plan_equal(got.materialize(), want.materialize())
        assert got.n_exact_events == want.n_exact_events
    got = tp.prefill([4, 8, 15], 20, 8, 2, 16, 2, n_q_heads=4, d_model=64,
                     d_ff=96, span=(8, 20))
    want = tr.prefill([4, 8, 15], 20, 8, 2, 16, 2, n_q_heads=4,
                      d_model=64, d_ff=96, span=(8, 20))
    assert got.name == want.name and got.inst_keys == want.inst_keys
    assert_compiled_equal(got.compile(), want.compile())
    for direction in ("out", "in"):
        got = tp.swap(3, 8, 2, 16, 2, direction=direction, tag=5)
        want = tr.swap(3, 8, 2, 16, 2, direction=direction, tag=5)
        assert got.name == want.name
        assert_compiled_equal(got.compile(), want.compile())
    assert (tp.hits, tp.misses) == (tr.hits, tr.misses)


def test_relabel_equal():
    mk = lambda M: M.decode_step_plan([[1, 2], [2, 3]], [12, 9], 8, 2, 16,  # noqa
                                      2).compile()
    page_map = {("k", 2): ("k", 40), ("v", 3): ("v", 2)}
    assert_compiled_equal(mk(P).relabel(page_map),
                          mk(R).relabel(page_map))


def _trace(M):
    tpl = M.PlanTemplate()
    plans = [M.gemm_plan(20, 30, 40, "int8"),
             tpl.decode_step([[1, 2], [5]], [12, 3], 8, 2, 16, 1),
             M.decode_step_plan([[1, 2, 7], [5]], [17, 4], 8, 2, 16, 1),
             tpl.decode_step([[3, 4], [6]], [12, 3], 8, 2, 16, 1),
             tpl.swap(2, 8, 2, 16, 1, direction="out", tag=1),
             tpl.prefill([9, 10], 11, 8, 2, 16, 1)]
    return plans


@pytest.mark.parametrize("chunk_events", [1, 37, 10**9])
def test_compile_trace_chunks_equal(chunk_events):
    got = list(P.compile_trace_chunks(iter(_trace(P)), chunk_events))
    want = list(R.compile_trace_chunks(iter(_trace(R)), chunk_events))
    assert len(got) == len(want)
    for (gc, gb), (wc, wb) in zip(got, want):
        assert len(gb) == len(wb)
        assert_compiled_equal(gc, wc)
    assert P.trace_footprint(_trace(P)) == R.trace_footprint(_trace(R))
    assert_compiled_equal(P._compile_plans(_trace(P)),
                          R._compile_plans(_trace(R)))
    with pytest.raises(ValueError):
        next(P.compile_trace_chunks(iter(_trace(P)), 0))
