"""Page geometry, pack/unpack, the Eq.-1 overlap algebra, the MoE
capacity rule and the chunked SSM scan of the port against the
reference, on the CPU.

Mirrors ``tests/test_paging_properties.py`` (hypothesis included), with
bfloat16 added: the same seeded numpy inputs go through both packages,
and page geometry and packed pages must be bitwise equal.  The SSM scan
is fp32 in both; tolerance 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip(
    "hypothesis",
    reason="property tests need hypothesis (see requirements-dev.txt)")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import overlap as ref_overlap  # noqa: E402
from repro.core import paging as ref_paging  # noqa: E402
from repro.core import streaming as ref_streaming  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro_torch.core import overlap, paging, streaming  # noqa: E402
from repro_torch.models import moe, ssm  # noqa: E402

# (numpy dtype for the reference, torch dtype for the port)
DTYPES = {"int8": (np.int8, torch.int8),
          "float16": (np.float16, torch.float16),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float32": (np.float32, torch.float32)}


def _pair(rng, shape, name):
    """The same values in both packages: numpy/jnp for the reference, a
    torch tensor for the port (bfloat16 through its bit pattern)."""
    np_dt, t_dt = DTYPES[name]
    x = rng.standard_normal(shape) * 10
    if name == "bfloat16":
        t = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
        return jnp.asarray(t.float().numpy(), jnp.bfloat16), t
    a = x.astype(np_dt)
    return jnp.asarray(a), torch.from_numpy(a)


def _bits(x) -> np.ndarray:
    """Raw bytes of a jax array or torch tensor, for bitwise equality."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().view(np.uint8)
    a = np.asarray(x)
    return np.ascontiguousarray(a).view(np.uint8)


@pytest.mark.parametrize("name", list(DTYPES))
def test_dtype_bytes_and_tile_shape_match_reference(name):
    np_dt, t_dt = DTYPES[name]
    want = ref_paging.dtype_bytes(np_dt)
    assert paging.dtype_bytes(t_dt) == want
    assert paging.dtype_bytes(name) == want
    if name != "bfloat16":
        assert paging.dtype_bytes(np_dt) == want
        assert paging.dtype_bytes(np.dtype(np_dt)) == want
    for page_bytes in (4096, 8192, 2048):
        assert paging.tile_shape(t_dt, page_bytes) == \
            ref_paging.tile_shape(np_dt, page_bytes)


def test_dtype_bytes_refuses_unknown_names():
    with pytest.raises(TypeError):
        paging.dtype_bytes("complex_bfloat")


@settings(max_examples=40, deadline=None)
@given(r=st.integers(1, 200), c=st.integers(1, 200),
       name=st.sampled_from(list(DTYPES)), op=st.sampled_from(["A", "B"]))
def test_pack_unpack_bitwise_equal_to_reference(r, c, name, op):
    rng = np.random.default_rng(r * 1000 + c)
    xr, xt = _pair(rng, (r, c), name)
    lay = paging.layout_for((r, c), DTYPES[name][1], op)
    rlay = ref_paging.layout_for((r, c), DTYPES[name][0], op)
    assert (lay.rows, lay.cols, lay.tile_r, lay.tile_c, lay.row_striped) \
        == (rlay.rows, rlay.cols, rlay.tile_r, rlay.tile_c,
            rlay.row_striped)
    assert (lay.grid, lay.n_pages, lay.padded) == \
        (rlay.grid, rlay.n_pages, rlay.padded)
    pages = paging.pack_pages(xt, lay)
    rpages = ref_paging.pack_pages(xr, rlay)
    assert tuple(pages.shape) == tuple(rpages.shape)
    assert pages.shape[1] * pages.shape[2] * pages.element_size() == \
        paging.PAGE_BYTES
    np.testing.assert_array_equal(_bits(pages), _bits(rpages))
    back = paging.unpack_pages(pages, lay)
    np.testing.assert_array_equal(_bits(back), _bits(xt))
    np.testing.assert_array_equal(
        _bits(back), _bits(ref_paging.unpack_pages(rpages, rlay)))


@settings(max_examples=20, deadline=None)
@given(r=st.integers(1, 300), c=st.integers(1, 300),
       name=st.sampled_from(list(DTYPES)), op=st.sampled_from(["A", "B"]))
def test_page_of_is_a_partition_equal_to_reference(r, c, name, op):
    lay = paging.layout_for((r, c), name, op)
    rlay = ref_paging.layout_for((r, c), DTYPES[name][0], op)
    seen = {}
    for rr in range(0, r, lay.tile_r):
        for cc in range(0, c, lay.tile_c):
            pid = lay.page_of(rr, cc)
            assert pid == rlay.page_of(rr, cc)
            assert lay.page_offset(rr + 1, cc + 2) == \
                rlay.page_offset(rr + 1, cc + 2)
            assert 0 <= pid < lay.n_pages and pid not in seen
            seen[pid] = (rr, cc)
    assert len(seen) == lay.n_pages


@settings(max_examples=15, deadline=None)
@given(m=st.integers(1, 100), n=st.integers(1, 100), k=st.integers(1, 400),
       name=st.sampled_from(["int8", "float16", "float32"]),
       order=st.sampled_from(["jik", "ijk"]))
def test_schedule_and_tile_counts_equal_reference(m, n, k, name, order):
    np_dt = DTYPES[name][0]
    got = list(streaming.schedule(m, n, k, name, order=order))
    want = list(ref_streaming.schedule(m, n, k, np_dt, order=order))
    assert [tuple(vars(o).values()) for o in got] == \
        [tuple(vars(o).values()) for o in want]
    counts = streaming.tile_counts(m, n, k, name)
    assert counts == ref_streaming.tile_counts(m, n, k, np_dt)
    seen = {}
    for op in got:
        if op.first_k:
            assert (op.i, op.j) not in seen
            seen[(op.i, op.j)] = 0
        seen[(op.i, op.j)] += 1
    assert len(seen) == counts["out_tiles"]
    assert all(v == counts["k_steps"] for v in seen.values())


@settings(max_examples=20, deadline=None)
@given(w=st.sampled_from([8, 16, 32]), l=st.integers(4, 2048),
       s=st.sampled_from([1, 2, 4]),
       bw=st.sampled_from([8e9, 32e9, 64e9, 128e9, 1e12]))
def test_overlap_bound_equals_reference(w, l, s, bw):
    f = 1e9
    assert overlap.required_bandwidth(w, l, f, s, 0.9, 0.8) == \
        ref_overlap.required_bandwidth(w, l, f, s, 0.9, 0.8)
    assert overlap.asymptotic_bandwidth(w, f, s) == \
        ref_overlap.asymptotic_bandwidth(w, f, s)
    assert vars(overlap.evaluate(w, l, f, s, bw)) == \
        vars(ref_overlap.evaluate(w, l, f, s, bw))
    assert overlap.sram_doubling_delta(w, l, f, s) == \
        ref_overlap.sram_doubling_delta(w, l, f, s)
    assert overlap.min_feasible_tile_len(w, f, s, bw) == \
        ref_overlap.min_feasible_tile_len(w, f, s, bw)
    req = overlap.required_bandwidth(w, l, f, s)
    assert req < overlap.asymptotic_bandwidth(w, f, s)
    assert overlap.required_bandwidth(w, l + 1, f, s) >= req


def test_overlap_module_has_no_tpu_block_chooser():
    assert not hasattr(overlap, "choose_gemm_blocks")
    assert not hasattr(overlap, "tpu_block_overlap")


@pytest.mark.parametrize("n_assign,n_exp,cap,factor", [
    (32, 4, None, 1.25), (32, 4, 16, 1.25), (7, 8, None, 1.0),
    (1000, 64, None, 1.25), (1000, 64, 3, 1.25), (64, 3, None, 2.0),
    (5, 1, None, 1.25), (256, 16, 100, 1.25)])
def test_routed_capacity_equals_reference(n_assign, n_exp, cap, factor):
    assert moe.routed_capacity(n_assign, n_exp, cap, factor) == \
        ref_moe.routed_capacity(n_assign, n_exp, cap, factor)


@pytest.mark.parametrize("T,chunk,inclusive,bonus", [
    (32, 16, True, False), (32, 16, False, True), (21, 8, False, True),
    (7, 16, True, False), (40, 16, True, True)])
def test_chunked_linear_attention_matches_reference(T, chunk, inclusive,
                                                    bonus):
    rng = np.random.default_rng(T * 10 + chunk)
    B, H, N, M = 2, 3, 8, 5
    r = rng.standard_normal((B, T, H, N)).astype(np.float32)
    k = rng.standard_normal((B, T, H, N)).astype(np.float32) * 0.5
    v = rng.standard_normal((B, T, H, M)).astype(np.float32)
    logw = -np.abs(rng.standard_normal((B, T, H, N))).astype(np.float32)
    s0 = rng.standard_normal((B, H, N, M)).astype(np.float32) * 0.1
    u = rng.standard_normal((H, N)).astype(np.float32) if bonus else None
    want, want_s = ref_ssm.chunked_linear_attention(
        jnp.asarray(r), jnp.asarray(k), jnp.asarray(v), jnp.asarray(logw),
        jnp.asarray(s0), u=None if u is None else jnp.asarray(u),
        chunk=chunk, inclusive=inclusive)
    got, got_s = ssm.chunked_linear_attention(
        torch.from_numpy(r), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(logw), torch.from_numpy(s0),
        u=None if u is None else torch.from_numpy(u), chunk=chunk,
        inclusive=inclusive)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("inclusive", [True, False])
def test_scan_chunk_2d_matches_reference(inclusive):
    rng = np.random.default_rng(4)
    L, H, N = 16, 4, 8
    r, k, v = (rng.standard_normal((L, H * N)).astype(np.float32)
               for _ in range(3))
    logw = -np.abs(rng.standard_normal((L, H * N))).astype(np.float32)
    s0 = rng.standard_normal((H * N, N)).astype(np.float32) * 0.1
    want, want_s = ref_ssm.scan_chunk_2d(r, k, v, logw, s0, H, N,
                                         inclusive=inclusive)
    got, got_s = ssm.scan_chunk_2d(*(torch.from_numpy(a) for a in
                                     (r, k, v, logw, s0)), H, N,
                                   inclusive=inclusive)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=1e-5, atol=1e-5)
