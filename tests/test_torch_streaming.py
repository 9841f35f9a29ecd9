"""The port's page store and StreamPlan executor against the reference,
on the CPU, in DM, DC and DevMem.

The same plan and the same seeded numpy inputs go through the
reference's ``execute_plan`` and the port's; outputs must agree within
the dtype's tolerance and the ``TrafficStats`` (bytes, hits, misses,
lookups) must be equal.  Tolerances: int8 exact; fp16 1e-2 (fp16
operands, fp32 sums in another order); fp32 GEMM 1e-5; fp32 attention,
MoE and SSM plans 1e-4 (several fp32 products and a host op in a
chain); the transformer layer 2e-3 (as ``tests/test_stream_plan.py``);
the churned-cache decode plan rtol 1e-4 / atol 1e-5 (as
``tests/test_workload_plans.py``).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import plan as RP  # noqa: E402
from repro.core import streaming as RS  # noqa: E402
from repro.core.modes import MemoryMode as RMode  # noqa: E402
from repro.core.modes import PageStore as RStore  # noqa: E402
from repro_torch.core import plan as PP  # noqa: E402
from repro_torch.core import streaming as PS  # noqa: E402
from repro_torch.core.modes import MemoryMode, PageStore  # noqa: E402
from repro_torch.serving.kv_cache import (PagedCacheConfig,  # noqa: E402
                                          PagedKVCache, PageTable)

MODES = [(m, RMode(m.value)) for m in MemoryMode]


def _stats(store):
    return dataclasses.astuple(store.stats)


def _run_both(plan_p, plan_r, tensors, mode, rmode, cache_pages=512,
              paged=None, rpaged=None):
    got, store = PS.execute_plan(
        plan_p, {k: torch.from_numpy(v) for k, v in tensors.items()}, mode,
        cache_pages=cache_pages, paged=paged, device="cpu")
    want, rstore = RS.execute_plan(plan_r, tensors, rmode,
                                   cache_pages=cache_pages, paged=rpaged)
    assert set(got) == set(want)
    assert _stats(store) == _stats(rstore)
    return got, want, store


# --------------------------------------------------------------- store
@pytest.mark.parametrize("cache_pages", [1, 3, 8])
def test_page_store_counts_like_the_reference(cache_pages):
    rng = np.random.default_rng(cache_pages)
    pages = {("t", i): rng.standard_normal((4, 8)).astype(np.float32)
             for i in range(10)}
    pages[("u", 0)] = rng.standard_normal((2, 3)).astype(np.float32)
    keys = list(pages)
    seq = [keys[int(i)] for i in rng.choice(len(keys), 60)]
    for mode, rmode in MODES:
        store = PageStore({k: torch.from_numpy(v) for k, v in pages.items()},
                          mode, cache_pages=cache_pages, device="cpu")
        rstore = RStore(pages, rmode, cache_pages=cache_pages)
        for key in seq:
            got = store.get(key)
            want = rstore.get(key)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            assert _stats(store) == _stats(rstore)
        assert list(store._cache) == list(rstore._cache)


def test_page_store_on_the_cpu_keeps_plain_host_pages():
    store = PageStore({0: torch.ones(4, 8)}, MemoryMode.DM, device="cpu")
    assert store.device.type == "cpu"
    assert store._host[0].device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            PageStore({}, MemoryMode.DM)


# ---------------------------------------------------------------- GEMM
@pytest.mark.parametrize("dtype", [np.int8, np.float16, np.float32])
@pytest.mark.parametrize("mode,rmode", MODES)
def test_gemm_plan_matches_reference(dtype, mode, rmode):
    rng = np.random.default_rng(3)
    if np.issubdtype(dtype, np.integer):
        a = rng.integers(-128, 128, (45, 70)).astype(dtype)
        b = rng.integers(-128, 128, (70, 300)).astype(dtype)
    else:
        a = rng.standard_normal((45, 70)).astype(dtype)
        b = rng.standard_normal((70, 300)).astype(dtype)
    got, store = PS.gemm_streamed(torch.from_numpy(a), torch.from_numpy(b),
                                  mode, cache_pages=8, device="cpu")
    want, rstore = RS.gemm_streamed(a, b, rmode, cache_pages=8)
    assert got.dtype == torch.float64 and tuple(got.shape) == (45, 300)
    assert _stats(store) == _stats(rstore)
    if dtype == np.int8:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            got.numpy(), a.astype(np.int64) @ b.astype(np.int64))
    else:
        tol = 1e-2 if dtype == np.float16 else 1e-5
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=tol, atol=tol)


def test_bfloat16_gemm_runs_as_a_float16_plan_like_the_reference():
    rng = np.random.default_rng(8)
    a = torch.from_numpy(rng.standard_normal((20, 130)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((130, 24)).astype(np.float32))
    a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    got, store = PS.gemm_streamed(a, b, MemoryMode.DM, device="cpu")
    want, rstore = RS.gemm_streamed(
        np.asarray(jnp.asarray(a.float().numpy(), jnp.bfloat16)),
        np.asarray(jnp.asarray(b.float().numpy(), jnp.bfloat16)),
        RMode.DM)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-2,
                               atol=1e-2)
    assert _stats(store) == _stats(rstore)
    # every DMA_IN moved one float16 page
    assert store.stats.host_to_device_bytes == 4096 * store.stats.lookups


def test_gemm_traffic_ordering_and_tile_counts():
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal((33, 100)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((100, 41)).astype(np.float32))
    stores = {m: PS.gemm_streamed(a, b, m, cache_pages=64,
                                  device="cpu")[1] for m in MemoryMode}
    counts = PS.tile_counts(33, 41, 100, torch.float32)
    loads = counts["a_page_loads"] + counts["b_page_loads"]
    assert stores[MemoryMode.DM].stats.lookups == loads
    assert stores[MemoryMode.DM].stats.host_to_device_bytes == loads * 4096
    assert stores[MemoryMode.DM].stats.host_to_device_bytes >= \
        stores[MemoryMode.DC].stats.host_to_device_bytes
    assert stores[MemoryMode.DEVMEM].stats.host_to_device_bytes == 0


# ------------------------------------------------------ attention, layer
@pytest.mark.parametrize("mode,rmode", MODES)
def test_attention_plan_matches_reference(mode, rmode):
    rng = np.random.default_rng(5)
    S, hd = 24, 16
    q, k, v = (rng.standard_normal((S, hd)).astype(np.float32)
               for _ in range(3))
    got, want, _ = _run_both(
        PP.attention_plan(S, hd, "float32"),
        RP.attention_plan(S, hd, np.float32),
        {"q": q, "kT": np.ascontiguousarray(k.T), "v": v}, mode, rmode)
    for name in got:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("mode,rmode", MODES)
def test_transformer_layer_plan_matches_reference(mode, rmode):
    rng = np.random.default_rng(0)
    S, d, h, dff = 16, 32, 2, 64
    x = rng.standard_normal((S, d)).astype(np.float32) * 0.5
    w = {name: (rng.standard_normal(shape).astype(np.float32)
                / np.sqrt(shape[0]))
         for name, shape in RP.layer_weights(d, dff).items()}
    got, want, _ = _run_both(
        PP.transformer_layer_plan(S, d, h, dff, "float32"),
        RP.transformer_layer_plan(S, d, h, dff, np.float32),
        {"x": x, **w}, mode, rmode, cache_pages=16)
    np.testing.assert_allclose(got["L0.out"].numpy(),
                               np.asarray(want["L0.out"]), rtol=2e-3,
                               atol=5e-4)


# ------------------------------------------------------------ MoE, SSM
@pytest.mark.parametrize("mode,rmode", MODES)
@pytest.mark.parametrize("capacity", [16, 4])
def test_moe_plan_matches_reference(mode, rmode, capacity):
    rng = np.random.default_rng(capacity)
    n, d, E, k, f = 16, 32, 4, 2, 64
    x = rng.standard_normal((n, d)).astype(np.float32) * 0.5
    tensors = {"x": x, "M0.router": rng.standard_normal((d, E)).astype(
        np.float32) / np.sqrt(d)}
    for e in range(E):
        tensors[f"M0.e{e}.wg"] = rng.standard_normal((d, f)).astype(
            np.float32) / np.sqrt(d)
        tensors[f"M0.e{e}.wu"] = rng.standard_normal((d, f)).astype(
            np.float32) / np.sqrt(d)
        tensors[f"M0.e{e}.wo"] = rng.standard_normal((f, d)).astype(
            np.float32) / np.sqrt(f)
    got, want, _ = _run_both(
        PP.moe_layer_plan(n, d, E, k, f, "float32", capacity=capacity),
        RP.moe_layer_plan(n, d, E, k, f, np.float32, capacity=capacity),
        tensors, mode, rmode, cache_pages=32)
    np.testing.assert_allclose(got["M0.out"].numpy(),
                               np.asarray(want["M0.out"]), rtol=1e-4,
                               atol=1e-4)


def test_moe_routing_breaks_ties_toward_the_lower_expert():
    logits = torch.tensor([[1.0, 3.0, 3.0, 3.0], [2.0, 2.0, 0.0, 2.0]])
    e_sorted, tok, pos, keep, p = PS._moe_route(logits, 2, 8)
    want = RS._moe_route(logits.numpy(), 2, 8)
    for g, w in zip((e_sorted, tok, pos, keep, p), want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("mode,rmode", MODES)
@pytest.mark.parametrize("inclusive", [True, False])
def test_ssm_plan_matches_reference(mode, rmode, inclusive):
    rng = np.random.default_rng(1)
    T, d, H, chunk = 40, 64, 4, 16
    N = d // H
    x = rng.standard_normal((T, d)).astype(np.float32) * 0.3
    w = {name: rng.standard_normal(s).astype(np.float32) / np.sqrt(s[0])
         for name, s in RP.ssm_layer_weights(d).items()}
    logw = -np.abs(rng.standard_normal((T, d))).astype(np.float32) * 0.5
    s0 = rng.standard_normal((H * N, N)).astype(np.float32) * 0.1
    got, want, _ = _run_both(
        PP.ssm_layer_plan(T, d, H, "float32", chunk=chunk,
                          inclusive=inclusive),
        RP.ssm_layer_plan(T, d, H, np.float32, chunk=chunk,
                          inclusive=inclusive),
        {"x": x, "S0.logw": logw, "S0.s0": s0, **w}, mode, rmode,
        cache_pages=64)
    np.testing.assert_allclose(got["S0.out"].numpy(),
                               np.asarray(want["S0.out"]), rtol=1e-4,
                               atol=1e-4)


# -------------------------------------------------------------- decode
def _churned(dtype="float32", seed=2):
    """The churned cache of ``tests/test_workload_plans.py`` in the
    reference, and the same bookkeeping on the port's ``PageTable``."""
    from repro.serving.kv_cache import PagedCacheConfig as RCfg
    from repro.serving.kv_cache import PagedKVCache as RCache
    rng = np.random.default_rng(seed)
    kw = dict(n_pages=32, page_tokens=8, n_kv_heads=2, head_dim=16,
              max_pages_per_seq=4, dtype=dtype)
    ref = RCache(RCfg(**kw), max_seqs=3)
    port = PageTable(PagedCacheConfig(**kw), max_seqs=3)
    mk = lambda t: jnp.asarray(  # noqa: E731
        rng.standard_normal((t, 2, 16)), jnp.dtype(dtype))
    for slot, ln in enumerate((20, 9, 17)):
        assert ref.alloc_seq(slot, ln) and port.alloc_seq(slot, ln)
        ref.write_prompt(slot, mk(ln), mk(ln))
        port.note_tokens(slot, ln)
    ref.append_token(np.array([0, 1, 2]), mk(3).reshape(3, 2, 16),
                     mk(3).reshape(3, 2, 16))
    for slot in range(3):
        port.note_tokens(slot, int(port.lens[slot]) + 1)
    ref.free_seq(1)
    port.free_seq(1)
    assert ref.alloc_seq(1, 12) and port.alloc_seq(1, 12)
    ref.write_prompt(1, mk(12), mk(12))
    port.note_tokens(1, 12)
    return ref, port


@pytest.mark.parametrize("mode,rmode", MODES)
def test_churned_decode_plan_matches_reference(mode, rmode):
    ref, port = _churned()
    np.testing.assert_array_equal(port.tables, ref.tables)
    np.testing.assert_array_equal(port.lens, ref.lens)
    slots = [0, 1, 2]
    plan, rplan = port.decode_step_plan(slots), ref.decode_step_plan(slots)
    assert [dataclasses.astuple(e)[2:6] for e in plan.events] == \
        [dataclasses.astuple(e)[2:6] for e in rplan.events]
    rk, rv = ref.page_dicts(slots)
    paged = {"k": {p: torch.from_numpy(a.copy()) for p, a in rk.items()},
             "v": {p: torch.from_numpy(a.copy()) for p, a in rv.items()}}
    q = np.random.default_rng(3).standard_normal((3, 32)).astype(np.float32)
    got, want, store = _run_both(plan, rplan, {"q": q}, mode, rmode,
                                 cache_pages=4, paged=paged,
                                 rpaged={"k": rk, "v": rv})
    np.testing.assert_allclose(got["decode_out"].numpy(),
                               np.asarray(want["decode_out"]), rtol=1e-4,
                               atol=1e-5)
    assert store.stats.lookups == 2 * sum(int(port.held[s]) for s in slots)


@pytest.mark.parametrize("mode,rmode", MODES)
def test_gqa_decode_plan_over_a_port_pool_matches_reference(mode, rmode):
    """A GQA (7 q heads per KV head) decode plan over the port's layered
    pool, paged through ``page_dicts(slots, layer)``, against the
    reference executor on the same pages."""
    rng = np.random.default_rng(9)
    cfg = PagedCacheConfig(n_pages=24, page_tokens=8, n_kv_heads=2,
                           head_dim=16, max_pages_per_seq=6,
                           dtype="float32")
    cache = PagedKVCache(cfg, max_seqs=3, n_layers=2, device="cpu")
    cache.k_pages.copy_(torch.from_numpy(rng.standard_normal(
        tuple(cache.k_pages.shape)).astype(np.float32)))
    cache.v_pages.copy_(torch.from_numpy(rng.standard_normal(
        tuple(cache.v_pages.shape)).astype(np.float32)))
    for slot, ln in enumerate((30, 3, 17)):
        cache.alloc_seq(slot, ln)
        cache.prompt_index([slot], ln)
    slots = [2, 0, 1]
    plan = cache.decode_step_plan(slots, n_q_heads=14)
    rplan = RP.decode_step_plan(
        [cache.tables[s, :int(cache.held[s])] for s in slots],
        [int(cache.lens[s]) for s in slots], 8, 2, 16, 4, n_q_heads=14)
    kd, vd = cache.page_dicts(slots, layer=1)
    assert all(kd[p].data_ptr() == cache.k_pages[1, p].data_ptr()
               for p in kd)
    q = rng.standard_normal((3, 14 * 16)).astype(np.float32)
    got, want, _ = _run_both(
        plan, rplan, {"q": q}, mode, rmode, cache_pages=3,
        paged={"k": kd, "v": vd},
        rpaged={"k": {p: t.numpy() for p, t in kd.items()},
                "v": {p: t.numpy() for p, t in vd.items()}})
    np.testing.assert_allclose(got["decode_out"].numpy(),
                               np.asarray(want["decode_out"]), rtol=1e-4,
                               atol=1e-5)


def test_executor_refuses_what_the_reference_refuses():
    plan = PP.decode_step_plan([[1]], [3], 8, 2, 16, 4)
    with pytest.raises(ValueError, match="paged"):
        PS.execute_plan(plan, {"q": torch.zeros(1, 32)}, MemoryMode.DM,
                        device="cpu")
    # the prefill plan's K/V write to pool pages is timing-only
    with pytest.raises(NotImplementedError, match="timing-only"):
        PS.execute_plan(PP.prefill_plan([1], 8, 8, 2, 16, 4),
                        {"prompt": torch.zeros(8, 32),
                         "wqkv": torch.zeros(32, 96)}, MemoryMode.DM,
                        device="cpu")
