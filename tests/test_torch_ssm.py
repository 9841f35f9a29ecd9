"""The ssm family (rwkv6-7b, reduced) against the reference on the CPU:
the RWKV6 recurrence, time mix and channel mix, prefill and decode over
the per-slot recurrent state, the serving engine's tokens and plan
trace, and what the state store holds.

The reference's bf16 weights (``Model.init(PRNGKey(0))``) are bridged
into the port with ``from_reference``.  Its init zeroes ``mix``, ``u``
and ``w_bias``, so the block-level tests draw every time-mix leaf (the
bonus ``u`` included) and a non-zero carried state from a numpy seed.

The model-level references run op by op (``jax.disable_jit()``): under
``lax.scan`` XLA fuses the bf16 ops of the layer body and rounds at
other places, and the reference's own logits then move by up to 2% of
max|logit| on this model (0.039-0.070 at max|logit| 2.9-3.5 over a
prefill and three decode steps).  Op by op, the port computes each of
the reference's bf16 ops as XLA does (``layers.sigmoid_op_by_op``),
and its logits and states have come out equal to the reference's.

Tolerances: fp32 3e-5 (the recurrence, sums in another order); bf16
block outputs 2e-2 absolute and relative (one bf16 ulp with margin);
fp32 states 1e-4 of their largest magnitude; logits ``logit_tol`` of
``test_torch_models.py``, max(1e-2, 1.5e-2 · max|logit|).
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs import get_reduced as ref_reduced  # noqa: E402
from repro.models import ssm as RS  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro.serving.engine import Request as RefRequest  # noqa: E402
from repro.serving.engine import ServingEngine as RefEngine  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.models import ssm as PS  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import from_reference, to_torch  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.serving.state_cache import RecurrentStateCache  # noqa: E402

logit_tol = importlib.import_module("test_torch_models").logit_tol
SERVING = importlib.import_module("test_torch_serving")
_leaves = importlib.import_module("test_torch_params")._leaves

ARCH = "rwkv6_7b"
F32_TOL = 3e-5
BF16_TOL = 2e-2
STATE_RTOL = 1e-4
S = 64                          # max_seq of the caches and engines


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _bf16(a):
    """numpy fp32 -> (jax bf16, torch bf16) holding the same values."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, to_torch(np.asarray(j))


def _close_logits(got, want):
    np.testing.assert_allclose(_np(got), _np(want), atol=logit_tol(want),
                               rtol=0)


def _close_state(got, want):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=STATE_RTOL * np.abs(want).max())


@pytest.fixture(scope="module")
def pair():
    rm = RefModel(ref_reduced(ARCH), remat="none")
    rp = rm.init(jax.random.PRNGKey(0))
    cfg = get_reduced(ARCH)
    pp = from_reference(jax.tree.map(np.asarray, rp), cfg)
    return rm, rp, Model(cfg, device="cpu"), pp


def _time_params(seed):
    """Every time-mix leaf of the reduced config drawn from ``seed``:
    matrices fan-in scaled (``ww`` at 0.01, as its init law), ``u``,
    ``w_bias`` and ``mix`` N(0, 1); as (jax tree, torch tree), bf16."""
    cfg = get_reduced(ARCH)
    rng = np.random.default_rng(seed)
    jt, tt = {}, {}
    for name, p in PS.rwkv_pspecs(cfg)["time"].items():
        scale = 1.0 if p.init == "zeros" else \
            (p.scale or p.shape[0] ** -0.5)
        jt[name], tt[name] = _bf16(rng.standard_normal(p.shape) * scale)
    return jt, tt


def _state(B, seed):
    """A time-mix state (s fp32, shift bf16) as (jax, torch)."""
    cfg = get_reduced(ARCH)
    H = cfg.n_heads
    N = cfg.d_model // H
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((B, H, N, N)).astype(np.float32)
    js, ts = _bf16(rng.standard_normal((B, cfg.d_model)))
    return ({"s": jnp.asarray(s), "shift": js},
            {"s": torch.from_numpy(s.copy()), "shift": ts})


# --------------------------------------------------------- recurrence
@pytest.mark.parametrize("inclusive", [False, True])
def test_linear_attention_step_matches_reference(inclusive):
    rng = np.random.default_rng(0)
    B, H, N, M = 3, 4, 16, 8
    r, k, logw = (rng.standard_normal((B, H, N)).astype(np.float32)
                  for _ in range(3))
    logw = -np.exp(logw)                       # some below LOGW_MIN
    v = rng.standard_normal((B, H, M)).astype(np.float32)
    s = rng.standard_normal((B, H, N, M)).astype(np.float32)
    u = rng.standard_normal((H, N)).astype(np.float32)
    args = (r, k, v, logw, s)
    want_o, want_s = RS.linear_attention_step(
        *(jnp.asarray(a) for a in args), u=jnp.asarray(u),
        inclusive=inclusive)
    got_o, got_s = PS.linear_attention_step(
        *(torch.from_numpy(a) for a in args), u=torch.from_numpy(u),
        inclusive=inclusive)
    assert got_o.dtype == torch.float32 and got_s.dtype == torch.float32
    for got, want in ((got_o, want_o), (got_s, want_s)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=F32_TOL, rtol=F32_TOL)


# ------------------------------------------------------------ blocks
@pytest.mark.parametrize("T", [16, 32, 5, 21])
def test_time_mix_matches_reference(T):
    """Chunked over T tokens (16 = ssm_chunk, 32 = two chunks, 5 and 21
    padded) from a non-zero state: bf16 output, fp32 state, shift."""
    cfg, rcfg = get_reduced(ARCH), ref_reduced(ARCH)
    jp, tp = _time_params(1)
    xj, xt = _bf16(np.random.default_rng(2).standard_normal(
        (2, T, cfg.d_model)))
    js, ts = _state(2, 3)
    want, wst = RS.rwkv_time_mix(jp, xj, rcfg, js)
    got, gst = PS.rwkv_time_mix(tp, xt, cfg, ts)
    assert got.dtype == torch.bfloat16 and gst["s"].dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), atol=BF16_TOL,
                               rtol=BF16_TOL)
    _close_state(gst["s"], wst["s"])
    assert np.array_equal(_np(gst["shift"]), _np(wst["shift"]))


def test_time_mix_step_matches_reference():
    """Three single-token steps from a non-zero state, each step's
    output the next one's input."""
    cfg, rcfg = get_reduced(ARCH), ref_reduced(ARCH)
    jp, tp = _time_params(4)
    xj, xt = _bf16(np.random.default_rng(5).standard_normal(
        (3, cfg.d_model)))
    js, ts = _state(3, 6)
    for _ in range(3):
        want, js = RS.rwkv_time_mix_step(jp, xj, rcfg, js)
        got, ts = PS.rwkv_time_mix_step(tp, xt, cfg, ts)
        np.testing.assert_allclose(_np(got), _np(want), atol=BF16_TOL,
                                   rtol=BF16_TOL)
        _close_state(ts["s"], js["s"])
        assert torch.equal(ts["shift"], xt)
        xj, xt = want, got


def test_chunked_time_mix_equals_step_by_step():
    """Within the port, in fp32 (the reference's ``test_ssm.py`` check):
    the chunked forward's outputs and final state equal a replay of the
    single-token step."""
    cfg = get_reduced(ARCH)
    _, tp = _time_params(7)
    tp = {k: v.float() for k, v in tp.items()}
    B, T = 2, 37
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (B, T, cfg.d_model)).astype(np.float32) * 0.3)
    st = PS.init_rwkv_state(cfg, B)["time"]
    out_c, st_c = PS.rwkv_time_mix(tp, x, cfg, st)
    st_s, outs = st, []
    for t in range(T):
        o, st_s = PS.rwkv_time_mix_step(tp, x[:, t], cfg, st_s)
        outs.append(o)
    np.testing.assert_allclose(out_c.numpy(), torch.stack(outs, 1).numpy(),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(st_c["s"].numpy(), st_s["s"].numpy(),
                               rtol=2e-3, atol=2e-3)


def test_channel_mix_matches_reference(pair):
    """Over a sequence (with the previous tail) and on one token."""
    _, rp, _, pp = pair
    cfg = get_reduced(ARCH)
    jc = jax.tree.map(lambda a: a[1], rp["layers"])["channel"]
    tc = pp["layers"][1]["channel"]
    rng = np.random.default_rng(9)
    xj, xt = _bf16(rng.standard_normal((2, 11, cfg.d_model)))
    lj, lt = _bf16(rng.standard_normal((2, cfg.d_model)))
    for x_j, x_t in ((xj, xt), (xj[:, 3], xt[:, 3])):
        want, wsh = RS.rwkv_channel_mix(jc, x_j, lj)
        got, gsh = PS.rwkv_channel_mix(tc, x_t, lt)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(got), _np(want), atol=BF16_TOL,
                                   rtol=BF16_TOL)
        assert np.array_equal(_np(gsh), _np(wsh))


def test_init_rwkv_state_shapes_and_dtypes():
    cfg, rcfg = get_reduced(ARCH), ref_reduced(ARCH)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        got = PS.init_rwkv_state(cfg, 3, dt)
        want = RS.init_rwkv_state(rcfg, 3, jdt)
        for (path, g), (_, w) in zip(_leaves(got), _leaves(want),
                                     strict=True):
            assert tuple(g.shape) == w.shape, path
            assert str(g.dtype).removeprefix("torch.") == w.dtype.name
            assert not g.any()
    assert got["time"]["s"].dtype == torch.float32


# ------------------------------------------------------ prefill/decode
def _ref_state(rcache, slot):
    layers = rcache["layers"]
    return (layers["time"]["s"][:, slot], layers["time"]["shift"][:, slot],
            layers["channel_shift"][:, slot])


def _assert_states(cache, slot, rcache, rslot):
    s, shift, cshift = _ref_state(rcache, rslot)
    _close_state(cache.s[:, slot], s)
    for got, want in ((cache.shift[:, slot], shift),
                      (cache.channel_shift[:, slot], cshift)):
        np.testing.assert_allclose(_np(got), _np(want), atol=BF16_TOL,
                                   rtol=BF16_TOL)


def test_prefill_logits_and_states_match_reference(pair):
    rm, rp, pm, pp = pair
    toks = np.random.default_rng(0).integers(1, 250, (2, 21)).astype(
        np.int32)
    with jax.disable_jit():
        rcache, want = rm.prefill(rp, {"tokens": jnp.asarray(toks)}, S)
    cache = pm.init_cache(3, S)
    for s in (2, 0):
        assert cache.alloc_seq(s, 21)
    got = pm.prefill(pp, torch.as_tensor(toks, dtype=torch.int64), cache,
                     [2, 0])
    assert got.dtype == torch.bfloat16
    _close_logits(got, want)
    assert (_np(got).argmax(-1) == _np(want).argmax(-1)).all()
    assert list(cache.lens) == [21, 0, 21]
    _assert_states(cache, 2, rcache, 0)
    _assert_states(cache, 0, rcache, 1)
    assert not cache.s[:, 1].any()


def test_teacher_forced_decode_mixed_lengths_matches_reference(pair):
    """Three prompts of different lengths prefilled one by one (the
    reference spliced into one batched cache, as its engine does), then
    four decode steps on the same forced tokens; logits and states."""
    rm, rp, pm, pp = pair
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 250, n).astype(np.int32) for n in (5, 16, 23)]
    forced = rng.integers(1, 250, (4, 3)).astype(np.int32)
    models = importlib.import_module("test_torch_models")
    with jax.disable_jit():
        rcache, rlog = models._ref_batched_cache(rm, rp, prompts, S)
    cache = pm.init_cache(3, S)
    for slot, p in enumerate(prompts):
        cache.alloc_seq(slot, len(p))
        got = pm.prefill(pp, torch.as_tensor(p[None], dtype=torch.int64),
                         cache, [slot])
        _close_logits(got[0], rlog[slot])
    for step in range(4):
        with jax.disable_jit():
            rcache, want = rm.decode_step(rp, rcache,
                                          jnp.asarray(forced[step]))
        got = pm.decode_step(pp, cache, torch.as_tensor(
            forced[step], dtype=torch.int64), [0, 1, 2])
        _close_logits(got, want)
    assert list(cache.lens) == [9, 20, 27]
    for slot in range(3):
        _assert_states(cache, slot, rcache, slot)
    cache.validate()


def test_decode_reads_and_writes_only_its_slots(pair):
    """A step over slots [2, 0] leaves slot 1's state as it was and
    equals the same step over each slot alone."""
    _, _, pm, pp = pair
    rng = np.random.default_rng(2)
    cache = pm.init_cache(3, S)
    for slot in range(3):
        cache.alloc_seq(slot, 7)
        pm.prefill(pp, torch.as_tensor(rng.integers(1, 250, (1, 7))),
                   cache, [slot])
    before = cache.s[:, 1].clone(), cache.shift[:, 1].clone()
    alone = [pm.init_cache(3, S) for _ in range(2)]
    for c in alone:
        for name in ("s", "shift", "channel_shift"):
            getattr(c, name).copy_(getattr(cache, name))
        c.active[:] = True
        c.lens[:] = cache.lens
    toks = torch.tensor([11, 12])
    both = pm.decode_step(pp, cache, toks, [2, 0])
    one = [pm.decode_step(pp, alone[0], toks[:1], [2]),
           pm.decode_step(pp, alone[1], toks[1:], [0])]
    np.testing.assert_allclose(_np(both), _np(torch.cat(one)),
                               atol=BF16_TOL, rtol=0)
    assert torch.equal(cache.s[:, 1], before[0])
    assert torch.equal(cache.shift[:, 1], before[1])
    assert list(cache.lens) == [8, 7, 8]


def test_prefill_then_decode_matches_longer_prefill(pair):
    """prefill(t[:n-1]) + decode(t[n-1]) == prefill(t), logits and
    states: the chunked scan and the single step carry one state."""
    _, _, pm, pp = pair
    toks = torch.as_tensor(np.random.default_rng(3).integers(1, 250, (2, 17)),
                           dtype=torch.int64)
    cache = pm.init_cache(2, S)
    cache2 = pm.init_cache(2, S)
    for s in range(2):
        cache.alloc_seq(s, 17)
        cache2.alloc_seq(s, 16)
    full = pm.prefill(pp, toks, cache, [0, 1])
    pm.prefill(pp, toks[:, :-1], cache2, [0, 1])
    dec = pm.decode_step(pp, cache2, toks[:, -1], [0, 1])
    _close_logits(dec, full)
    _close_state(cache2.s, cache.s)
    assert list(cache2.lens) == list(cache.lens) == [17, 17]


def test_prefill_overwrites_the_whole_slot_state(pair):
    """A slot that held another request's state (and garbage) gives the
    same logits and state after prefill as a fresh store."""
    _, _, pm, pp = pair
    toks = torch.as_tensor(np.random.default_rng(4).integers(1, 250, (1, 9)))
    fresh = pm.init_cache(2, S)
    fresh.alloc_seq(1, 9)
    want = pm.prefill(pp, toks, fresh, [1])
    used = pm.init_cache(2, S)
    for t in (used.s, used.shift, used.channel_shift):
        t.normal_(generator=torch.Generator().manual_seed(5))
    used.alloc_seq(1, 4)
    pm.prefill(pp, toks[:, :4], used, [1])
    used.free_seq(1)
    used.alloc_seq(1, 9)
    got = pm.prefill(pp, toks, used, [1])
    assert torch.equal(got, want)
    for name in ("s", "shift", "channel_shift"):
        assert torch.equal(getattr(used, name)[:, 1],
                           getattr(fresh, name)[:, 1])


# ------------------------------------------------------------ serving
def _serve(engine, cls, seed=7, n=5):
    reqs = SERVING._requests(n, np.random.default_rng(seed), cls)
    for r in reqs:
        engine.submit(r)
    return reqs, engine.run_until_drained()


@pytest.mark.parametrize("slots", [2, 3])
def test_greedy_tokens_match_reference_engine(pair, slots):
    """5 requests of 4-11 prompt tokens, 5 new tokens each, through
    ``slots`` slots (retired slots are reused): every token equals the
    reference engine's, run op by op."""
    _, rp, _, pp = pair
    with jax.disable_jit():
        ref_reqs, _ = _serve(RefEngine(ref_reduced(ARCH), rp, slots=slots,
                                       max_seq=S), RefRequest)
    eng = ServingEngine(get_reduced(ARCH), pp, slots=slots, max_seq=S,
                        device="cpu")
    reqs, stats = _serve(eng, Request)
    assert [r.output for r in reqs] == [r.output for r in ref_reqs]
    assert stats.drained and stats.prefills == 5
    assert stats.tokens_out == 25 == sum(len(r.output) for r in reqs)
    assert not eng.cache.active.any() and not eng.cache.lens.any()
    eng.cache.validate()


def test_reused_slot_gives_a_fresh_engines_tokens(pair):
    """With one slot every request after the first reuses it: each
    one's tokens equal those of a fresh engine serving it alone."""
    _, _, _, pp = pair
    cfg = get_reduced(ARCH)
    reqs, _ = _serve(ServingEngine(cfg, pp, slots=1, max_seq=S,
                                   device="cpu"), Request, n=4)
    for r in reqs:
        alone = ServingEngine(cfg, pp, slots=1, max_seq=S, device="cpu")
        again = Request(uid=r.uid, prompt=r.prompt,
                        max_new_tokens=r.max_new_tokens)
        alone.submit(again)
        alone.run_until_drained()
        assert again.output == r.output, r.uid


@pytest.mark.parametrize("pool_pages", [None, 5])
def test_recorded_plan_trace_matches_reference_engine(pair, pool_pages):
    """``record_plans``: the trace equals the reference engine's record
    for record, compiled arrays bitwise, where the reference prices each
    ssm step as GQA KV pages (``n_kv_heads`` x ``head_dim``) on a shadow
    table.  A pool of 5 pages of 8 tokens defers admissions, which then
    follow the shadow table as the reference's do."""
    _, rp, _, pp = pair
    kw = dict(slots=3, max_seq=S, record_plans=True,
              kv_pool_pages=pool_pages)
    ref_eng = RefEngine(ref_reduced(ARCH), rp, **kw)
    eng = ServingEngine(get_reduced(ARCH), pp, device="cpu", **kw)
    _serve(ref_eng, RefRequest)
    _serve(eng, Request)
    assert len(eng.trace) == len(ref_eng.trace) == eng.n_records
    assert eng.deferred_admissions == ref_eng.deferred_admissions
    assert (eng.deferred_admissions > 0) == (pool_pages is not None)
    for got, want in zip(eng.trace, ref_eng.trace):
        assert (got.kind, got.step_idx, got.slots, got.uids, got.n_tokens,
                got.arrival_event) == \
            (want.kind, want.step_idx, want.slots, want.uids,
             want.n_tokens, want.arrival_event)
        assert got.plan.name == want.plan.name
        a, b = got.plan.compile(), want.plan.compile()
        assert a.n_events == b.n_events and a.page_keys == b.page_keys
        for f in SERVING.COMPILED_COLS:
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), f
    eng._table.validate()
    assert eng._table.pages_in_use == 0


# --------------------------------------------------------- the store
def test_init_cache_allocates_no_kv_pool(pair):
    """An ssm model's cache is the recurrent state store: (L, slots, H,
    N, N) fp32 and two (L, slots, d) bf16 shifts, nothing else; a KV
    pool size is refused, and the engine holds the same store."""
    _, _, pm, pp = pair
    cfg = get_reduced(ARCH)
    cache = pm.init_cache(4, 1024, page_tokens=16)
    assert isinstance(cache, RecurrentStateCache)
    assert not hasattr(cache, "k_pages") and not hasattr(cache, "tables")
    L, H, N, d = cfg.n_layers, cfg.n_heads, cfg.d_model // cfg.n_heads, \
        cfg.d_model
    assert tuple(cache.s.shape) == (L, 4, H, N, N)
    assert cache.s.dtype == torch.float32
    for t in (cache.shift, cache.channel_shift):
        assert tuple(t.shape) == (L, 4, d) and t.dtype == torch.bfloat16
    assert cache.nbytes == L * 4 * (H * N * N * 4 + 2 * d * 2)
    with pytest.raises(ValueError, match="no KV pool"):
        pm.init_cache(4, 1024, n_pages=64)
    eng = ServingEngine(cfg, pp, slots=4, max_seq=1024, device="cpu")
    assert isinstance(eng.cache, RecurrentStateCache)
    assert eng._table is None and eng._pages is None


def test_state_store_bookkeeping():
    cache = RecurrentStateCache(get_reduced(ARCH), 2, device="cpu")
    assert cache.alloc_seq(0, 5) and not cache.alloc_seq(0, 5)
    with pytest.raises(ValueError, match="not allocated"):
        cache.decode_slots([1])
    cache.prompt_slots([0], 5)
    cache.decode_slots([0])
    assert list(cache.lens) == [6, 0]
    cache.validate()
    cache.free_seq(0)
    assert list(cache.lens) == [0, 0] and not cache.active.any()
    cache.lens[1] = 3                       # a free slot counting tokens
    with pytest.raises(AssertionError, match="free slots"):
        cache.validate()


def test_full_config_size_and_what_n_params_omits():
    """The port's full tree holds 8,053,063,680 values, 16.11 GB of
    bf16 (matrices; the zero- and one-initialised vectors add 0.03%).
    The reference's ``n_params()`` counts 7,516,192,768 (15.03 GB): its
    ssm branch leaves out the channel mix's receptance ``wr``, d x d in
    each of the 32 layers (536,870,912 values, 1.07 GB)."""
    cfg, rcfg = get_config(ARCH), ref_config(ARCH)
    spec = PT.lm_pspecs(cfg)
    total = sum(int(np.prod(p.shape)) for _, p in _leaves(spec))
    mats = sum(int(np.prod(p.shape)) for _, p in _leaves(spec)
               if p.init == "normal")
    wr = sum(int(np.prod(layer["channel"]["wr"].shape))
             for layer in spec["layers"])
    assert rcfg.n_params() == 7_516_192_768 == mats - wr
    assert wr == cfg.n_layers * cfg.d_model ** 2 == 536_870_912
    assert mats == 8_053_063_680 and round(2 * mats / 1e9, 2) == 16.11
    assert (total - mats) / total < 3e-4
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_ff,
            cfg.padded_vocab) == (32, 4096, 64, 14336, 65536)
    assert cfg.source == rcfg.source == "arXiv:2404.05892; hf"


def test_mla_config_is_accepted():
    """Multi-head latent attention (deepseek-v3's ``mla``) is ported: the
    tree and the bridge take a config that sets it, and the bridged
    tree holds every leaf of the tree's MLA attention."""
    cfg = get_reduced("deepseek_v3_671b")
    spec = PT.lm_pspecs(cfg)
    assert set(spec["layers"][0]["attn"]) == {
        "wdq", "q_norm", "wuq", "wdkv", "kv_norm", "wkr", "wuk", "wuv", "wo"}
    rp = RefModel(ref_reduced("deepseek_v3_671b"), remat="none").init(
        jax.random.PRNGKey(0))
    pp = from_reference(jax.tree.map(np.asarray, rp), cfg)
    assert set(pp["layers"][0]["attn"]) == set(spec["layers"][0]["attn"]) \
        | {"wuk_hkr", "wuv_hrv"}
    assert set(pp["mtp"]) == {"proj", "block", "norm_h", "norm_e"}
