"""The port's serving engine and paged cache against the reference."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as ref_reduced  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro.serving.engine import Request as RefRequest  # noqa: E402
from repro.serving.engine import ServingEngine as RefEngine  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import from_reference  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.serving.kv_cache import (PagedCacheConfig,  # noqa: E402
                                          PagedKVCache)

COMPILED_COLS = ("trace_ids", "trace_nbytes", "trace_is_out", "in_lane",
                 "op_kind", "op_val", "grp_end", "n_lanes", "seg_op",
                 "seg_trace")

ARCH = "qwen2_0_5b"
ARCHS = ["qwen2_0_5b", "chatglm3_6b", "granite_20b", "internvl2_2b",
         "qwen1_5_32b"]


@functools.lru_cache(maxsize=None)
def _weights(arch):
    rp = RefModel(ref_reduced(arch), remat="none").init(
        jax.random.PRNGKey(0))
    return rp, from_reference(jax.tree.map(np.asarray, rp),
                              get_reduced(arch))


@pytest.fixture(scope="module")
def weights():
    return _weights(ARCH)


def _requests(n, rng, cls):
    """The workload of tests/test_serving.py (5 requests, 4-11 prompt
    tokens, 5 new tokens each)."""
    return [cls(uid=i,
                prompt=rng.integers(1, 250, size=int(rng.integers(4, 12))
                                    ).astype(np.int32),
                max_new_tokens=5) for i in range(n)]


def _bf16_ulp(*xs):
    """One bf16 ulp at the largest magnitude of ``xs``."""
    m = max(abs(float(x)) for x in xs)
    return torch.finfo(torch.bfloat16).eps * 2.0 ** np.floor(np.log2(m)) \
        if m > 0 else 0.0


def _port_logits(arch, pp, prompt, toks):
    """The port's logits for the token after ``prompt + toks[:i]``, for
    i = 0 .. len(toks): the prompt's prefill, then ``toks`` decoded
    token by token."""
    m = Model(get_reduced(arch), device="cpu")
    cache = m.init_cache(1, 64)
    cache.alloc_seq(0, len(prompt))
    out = [m.prefill(pp, torch.as_tensor(prompt[None], dtype=torch.int64),
                     cache, [0])[0].float()]
    for t in toks:
        out.append(m.decode_step(pp, cache, torch.tensor([int(t)]),
                                 [0])[0].float())
    return out


def _ref_picks(arch, rp, prompt, toks):
    """The reference's greedy pick after ``prompt + toks[:i]``, for
    i = 0 .. len(toks), teacher-forced on ``toks``."""
    rm = RefModel(ref_reduced(arch), remat="none")
    cache, lg = rm.prefill(rp, {"tokens": jnp.asarray(prompt[None])}, 64)
    picks = [int(np.asarray(lg[0], np.float32).argmax())]
    for t in toks:
        cache, lg = rm.decode_step(rp, cache, jnp.asarray([int(t)]))
        picks.append(int(np.asarray(lg[0], np.float32).argmax()))
    return picks


def _assert_tie(lg, got, want, where):
    """``got`` (the port's pick on its own logits ``lg``) and ``want``
    lie within one bf16 ulp of each other."""
    a, b = lg[got].item(), lg[want].item()
    assert 0 <= a - b <= _bf16_ulp(a, b), (where, got, want, a, b)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("slots", [1, 3])
def test_greedy_tokens_match_reference_engine(slots, arch):
    """Every request's tokens equal the reference engine's; qwen2's
    exactly, as they always have.  The other three may leave the
    reference only at an exact tie: the two picks within one bf16 ulp
    of each other on the port's own logits (the reduced granite's
    logits of ~2 tie in bf16, and argmax then takes the lower id on the
    port's side).  Every token before such a tie equals the
    reference's, and every token after it is the reference's greedy
    pick teacher-forced on the port's own tokens, up to the same kind
    of tie."""
    rp, pp = _weights(arch)
    ref_eng = RefEngine(ref_reduced(arch), rp, slots=slots, max_seq=64)
    ref_reqs = _requests(5, np.random.default_rng(7), RefRequest)
    for r in ref_reqs:
        ref_eng.submit(r)
    ref_eng.run_until_drained()
    eng = ServingEngine(get_reduced(arch), pp, slots=slots, max_seq=64,
                        device="cpu")
    reqs = _requests(5, np.random.default_rng(7), Request)
    for r in reqs:
        eng.submit(r)
    stats = eng.run_until_drained()
    if arch == ARCH:
        assert [r.output for r in reqs] == [r.output for r in ref_reqs]
    for r, want in zip(reqs, ref_reqs):
        assert len(r.output) == len(want.output) == 5
        j = next((i for i, (a, b) in enumerate(zip(r.output, want.output))
                  if a != b), None)
        if j is None:
            continue
        assert r.output[:j] == want.output[:j]
        lg = _port_logits(arch, pp, r.prompt, r.output[:-1])
        _assert_tie(lg[j], r.output[j], want.output[j], (r.uid, j))
        ref = _ref_picks(arch, rp, r.prompt, r.output[:-1])
        for i in range(j + 1, len(r.output)):
            if r.output[i] != ref[i]:
                _assert_tie(lg[i], r.output[i], ref[i], (r.uid, i))
    assert stats.drained and stats.prefills == 5
    assert stats.tokens_out == sum(len(r.output) for r in reqs)
    eng.cache.validate()
    assert eng.cache.pages_in_use == 0


@pytest.mark.parametrize("slots", [3, 2])
def test_recorded_plan_trace_matches_reference_engine(weights, slots):
    """``record_plans``: the port engine's closed-loop trace equals the
    reference engine's record for record (kind, step, slots, uids,
    token counts, arrival index) and each record's compiled arrays are
    bitwise equal, with the page ids taken from the shadow table."""
    rp, pp = weights
    ref_eng = RefEngine(ref_reduced(ARCH), rp, slots=slots, max_seq=64,
                        record_plans=True)
    eng = ServingEngine(get_reduced(ARCH), pp, slots=slots, max_seq=64,
                        device="cpu", record_plans=True)
    for e, cls in ((ref_eng, RefRequest), (eng, Request)):
        for r in _requests(5, np.random.default_rng(7), cls):
            e.submit(r)
        e.run_until_drained()
    assert len(eng.trace) == len(ref_eng.trace) == eng.n_records
    assert [r.kind for r in eng.trace].count("prefill") == 5
    assert len(eng.step_plans) == eng.stats.decode_steps
    for got, want in zip(eng.trace, ref_eng.trace):
        assert (got.kind, got.step_idx, got.slots, got.uids, got.n_tokens,
                got.arrival_event) == \
            (want.kind, want.step_idx, want.slots, want.uids,
             want.n_tokens, want.arrival_event)
        assert got.plan.name == want.plan.name
        a, b = got.plan.compile(), want.plan.compile()
        assert a.n_events == b.n_events and a.page_keys == b.page_keys
        for f in COMPILED_COLS:
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), f
    eng._table.validate()
    assert eng._table.pages_in_use == 0


def test_retired_slot_stale_table_does_not_touch_live_kv(weights):
    """Retire slot 1 and hand its pages to a new sequence in slot 3: the
    retired row still points at them.  Decoding only the active slots
    keeps every live slot's logits equal to the reference's contiguous
    cache, over two steps (a write through the stale row in step 1
    would corrupt slot 3's KV in step 2)."""
    rp, pp = weights
    rm = RefModel(ref_reduced(ARCH), remat="none")
    pm = Model(get_reduced(ARCH), device="cpu")
    rng = np.random.default_rng(5)
    prompts = {s: rng.integers(1, 250, n).astype(np.int32)
               for s, n in ((0, 6), (1, 7), (2, 5), (3, 8))}
    S = 24
    cache = pm.init_cache(4, S, page_tokens=4)
    for s in (0, 1, 2):
        cache.alloc_seq(s, len(prompts[s]))
        pm.prefill(pp, torch.as_tensor(prompts[s][None], dtype=torch.int64),
                   cache, [s])
    stale = cache.tables[1, :int(cache.held[1])].copy()
    cache.free_seq(1)
    cache.alloc_seq(3, len(prompts[3]))
    pm.prefill(pp, torch.as_tensor(prompts[3][None], dtype=torch.int64),
               cache, [3])
    assert set(stale) & set(cache.tables[3, :int(cache.held[3])])
    with pytest.raises(ValueError):
        cache.append_view([0, 1])

    rcache = rm.init_cache(4, S)
    for s in (0, 2, 3):
        one, _ = rm.prefill(rp, {"tokens": jnp.asarray(prompts[s][None])}, S)
        rcache = jax.tree.map(
            lambda full, o: (full.at[:, s].set(o[:, 0])
                             if full.ndim >= 2 and full.shape[1] == 4
                             else full), rcache, one)
        rcache["len"] = rcache["len"].at[s].set(one["len"][0])
    live = [0, 2, 3]
    for step in range(2):
        toks = rng.integers(1, 250, 4).astype(np.int32)
        rcache, want = rm.decode_step(rp, rcache, jnp.asarray(toks))
        got = pm.decode_step(pp, cache, torch.as_tensor(
            toks[live], dtype=torch.int64), live)
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(want, np.float32)[live],
            atol=1e-2, rtol=0)
    cache.validate()


def test_paged_cache_alloc_free_invariants():
    cfg = PagedCacheConfig(n_pages=16, page_tokens=8, n_kv_heads=2,
                           head_dim=16, max_pages_per_seq=4)
    assert cfg.page_bytes == 8 * 2 * 16 * 2
    cache = PagedKVCache(cfg, max_seqs=3, n_layers=1, device="cpu")
    assert cache.alloc_seq(0, prompt_len=20)     # 3 pages
    cache.prompt_index([0], 20)
    assert cache.pages_in_use == 3
    view = cache.append_view([0])
    assert int(cache.lens[0]) == 21 and int(view.positions[0]) == 20
    cache.validate()
    cache.free_seq(0)
    assert cache.pages_in_use == 0
    assert cache.alloc_seq(1, prompt_len=32)
    assert not cache.alloc_seq(2, prompt_len=32 * 8)
    cache.validate()
    cache._free.append(int(cache.tables[1, 0]))     # a double free
    with pytest.raises(AssertionError,
                       match="page partitions overlap: free∩owned"):
        cache.validate()


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is usable")
    cfg = get_reduced(ARCH)
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(cfg, None)


def test_paged_cache_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is usable")
    cfg = PagedCacheConfig(n_pages=4, page_tokens=8, n_kv_heads=2,
                           head_dim=16, max_pages_per_seq=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedKVCache(cfg, max_seqs=1, n_layers=1)
    assert PagedKVCache(cfg, max_seqs=1, n_layers=1,
                        device="cpu").k_pages.device.type == "cpu"


def test_unported_paths_raise():
    cfg = get_reduced(ARCH)
    # plan_only builds with no card and no Model; a model-backed engine
    # refuses a shared prefix, which only the plan-only engine maps
    eng = ServingEngine(cfg, None, plan_only=True)
    assert eng.model is None and eng.cache is None and eng.device is None
    assert eng._table is not None and eng._table.pages_in_use == 0
    with pytest.raises(ValueError, match="prefix_tokens"):
        ServingEngine(cfg, None, device="cpu", prefix_tokens=8,
                      record_plans=True)
    # deepseek-v3-671b, the last architecture ported, now loads: MLA set,
    # the published widths
    from repro_torch.configs import NOT_PORTED, get_config
    ds = get_config("deepseek-v3-671b")
    assert NOT_PORTED == [] and ds.mla is not None
    assert (ds.n_layers, ds.d_model, ds.n_heads, ds.vocab_size,
            ds.moe.n_routed_experts, ds.moe.top_k,
            ds.mla.kv_lora_rank, ds.mla.qk_rope_head_dim) == \
        (61, 7168, 128, 129280, 256, 8, 512, 64)
    # the INT8 KV cache is ported: the flag builds (its paths are held in
    # test_torch_int8_kv.py)
    from repro_torch.models.tuning import Tuning
    assert Tuning(kv_cache_quant=True).kv_cache_quant
