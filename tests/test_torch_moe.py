"""The port's MoE layer and its expert-grouped GEMM against the
reference, on the CPU at the reduced qwen2-moe config.

Weights come from the reference's ``init_tree`` and are bridged into
the port; inputs are seeded numpy arrays.  Cases mirror
``tests/test_moe.py``: global dispatch, row-local dispatch under
``moe_local_dispatch``, lossless capacity, ``capacity_factor=0.5`` with
drops, and the aux loss.  Tolerance 2e-3 in fp32 (fp32 sums in another
order) and 1e-2 in bf16 (about one bf16 ulp of O(1) outputs).
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as ref_reduced  # noqa: E402
from repro.models import moe as RM  # noqa: E402
from repro.models import tuning as RTU  # noqa: E402
from repro.models.params import init_tree as ref_init  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import moe as PM  # noqa: E402
from repro_torch.models import tuning as PTU  # noqa: E402
from repro_torch.models.params import to_torch  # noqa: E402

GG = importlib.import_module("repro_torch.kernels.grouped_gemm")

ARCH = "qwen2_moe_a2_7b"
TOL = {"float32": 2e-3, "bfloat16": 1e-2}

# (name, batch shape, x scale, apply_moe kwargs, row-local dispatch)
CASES = [
    ("lossless", (2, 8), 0.5, {"capacity": 16}, False),
    ("drops", (2, 32), 1.0, {"capacity_factor": 0.5}, False),
    ("decode", (8, 1), 1.0, {"capacity": 8}, False),
    ("local_lossless", (3, 8), 0.5, {"capacity": 16}, True),
    ("local_drops", (2, 32), 1.0, {"capacity_factor": 0.5}, True),
]


def _weights(dtype, seed=0):
    cfg = ref_reduced(ARCH)
    rp = ref_init(RM.moe_pspecs(cfg), jax.random.PRNGKey(seed),
                  jnp.dtype(dtype))
    rp_np = jax.tree.map(np.asarray, rp)
    return rp, {k: to_torch(v) for k, v in rp_np.items()}


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _run_both(rp, pp, x_np, dtype, kwargs, local):
    cfg, rcfg = get_reduced(ARCH), ref_reduced(ARCH)
    jx = jnp.asarray(x_np, jnp.dtype(dtype))
    tx = torch.from_numpy(x_np).to(getattr(torch, dtype))
    with RTU.tuning_context(RTU.Tuning(moe_local_dispatch=local)):
        want, want_aux = RM.apply_moe(rp, jx, rcfg, **kwargs)
    with PTU.tuning_context(PTU.Tuning(moe_local_dispatch=local)):
        got, got_aux = PM.apply_moe(pp, tx, cfg, **kwargs)
    return got, got_aux, want, want_aux


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,shape,scale,kwargs,local", CASES,
                         ids=[c[0] for c in CASES])
def test_apply_moe_matches_reference(dtype, name, shape, scale, kwargs,
                                     local):
    rp, pp = _weights(dtype)
    d = get_reduced(ARCH).d_model
    x = np.random.default_rng(len(name)).standard_normal(
        shape + (d,), np.float32) * scale
    got, got_aux, want, want_aux = _run_both(rp, pp, x, dtype, kwargs, local)
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-5)
    assert float(got_aux) >= 0.0


def test_capacity_drops_happen_in_the_drop_cases():
    """The drop cases really drop: some expert receives more than C
    assignments, expert E-1 included in at least one (the cell the
    reference's dropped zeros land on)."""
    cfg = get_reduced(ARCH)
    _, pp = _weights("float32")
    E, k = cfg.moe.n_routed_experts, cfg.moe.top_k
    x = np.random.default_rng(len("drops")).standard_normal(
        (2, 32, cfg.d_model), np.float32)
    _, top_e, _ = PM._route(pp, torch.from_numpy(x).reshape(-1, 64), cfg)
    counts = torch.bincount(top_e.reshape(-1), minlength=E)
    C = PM.routed_capacity(64 * k, E, None, 0.5)
    assert int(counts.max()) > C and int(counts[E - 1]) > C


@pytest.mark.parametrize("local", [False, True])
def test_router_ties_break_to_the_lower_expert_like_jax(local):
    """Three experts share one router column that wins on positive
    inputs: every token has a three-way exact tie for its top 2, and
    both packages must keep the two lower expert ids
    (``jax.lax.top_k``'s order)."""
    rp, pp = _weights("float32", seed=3)
    router = np.asarray(rp["router"]).copy()
    router[:, [1, 4, 6]] = 0.5
    rp = {**rp, "router": jnp.asarray(router)}
    pp = {**pp, "router": torch.from_numpy(router)}
    cfg = get_reduced(ARCH)
    x = np.abs(np.random.default_rng(9).standard_normal(
        (2, 6, cfg.d_model), np.float32))
    _, top_e, _ = PM._route(pp, torch.from_numpy(x), cfg)
    _, want_e = jax.lax.top_k(jax.nn.softmax(
        jnp.asarray(x) @ jnp.asarray(router), -1), cfg.moe.top_k)
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(want_e))
    assert (top_e.numpy() == [1, 4]).all()
    got, _, want, _ = _run_both(rp, pp, x, "float32", {"capacity": 12},
                                local)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-3, atol=2e-3)


def test_unwritten_rows_beyond_the_counts_are_selected_away(monkeypatch):
    """On the card the grouped kernel leaves rows at or beyond each
    expert's count unwritten.  Fill them with NaN in the plain version:
    the layer's output must not change, in either dispatch, with and
    without drops."""
    real = ops.grouped_streaming_gemm

    def nan_tail(a, b, counts):
        out = real(a, b, counts).clone()
        rows = torch.arange(out.shape[1])[None, :] >= counts[:, None]
        out[rows] = float("nan")
        return out

    rp, pp = _weights("bfloat16")
    d = get_reduced(ARCH).d_model
    for name, shape, scale, kwargs, local in CASES:
        x = np.random.default_rng(len(name)).standard_normal(
            shape + (d,), np.float32) * scale
        clean = _run_both(rp, pp, x, "bfloat16", kwargs, local)[0]
        monkeypatch.setattr(ops, "grouped_streaming_gemm", nan_tail)
        dirty = _run_both(rp, pp, x, "bfloat16", kwargs, local)[0]
        monkeypatch.setattr(ops, "grouped_streaming_gemm", real)
        assert torch.isfinite(dirty).all(), name
        assert torch.equal(dirty, clean), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_gemm_ref_matches_per_expert_gemm(dtype):
    rng = np.random.default_rng(5)
    dt = getattr(torch, dtype)
    a = torch.from_numpy(rng.standard_normal((5, 12, 40), np.float32)).to(dt)
    b = torch.from_numpy(rng.standard_normal((5, 40, 24), np.float32)).to(dt)
    got = ref.grouped_gemm_ref(a, b)
    assert got.dtype == dt and got.shape == (5, 12, 24)
    tol = 1e-5 if dtype == "float32" else 1e-2     # fp32 sum order
    for e in range(5):
        np.testing.assert_allclose(_np(got[e]), _np(ref.gemm_ref(a[e], b[e])),
                                   rtol=tol, atol=tol)
    # rows below an expert's count do not depend on the rows beyond it
    counts = torch.tensor([0, 12, 7, 1, 5], dtype=torch.int32)
    cut = a.clone()
    for e, c in enumerate(counts.tolist()):
        cut[e, c:] = 0
    out = ops.grouped_streaming_gemm(cut, b, counts)
    for e, c in enumerate(counts.tolist()):
        np.testing.assert_allclose(_np(out[e, :c]),
                                   _np(ref.gemm_ref(a[e, :c], b[e])),
                                   rtol=tol, atol=tol)
        assert not out[e, c:].any()
    assert ops.LAUNCHES["streaming_gemm_grouped"] == 0


@pytest.mark.parametrize("E,C,N,K", [(60, 8, 1408, 2048),
                                     (60, 8, 2048, 1408),
                                     (60, 512, 1408, 2048),
                                     (60, 512, 2048, 1408),
                                     (8, 24, 96, 64)])
def test_plan_grouped_counts_every_experts_tiles(E, C, N, K):
    """``plan_grouped`` sizes the persistent grid from every expert's
    work items, E x ceil(C / 64) row chunks x ceil(N / 128) column tiles
    (which experts are touched is known only on the card), capped at one
    CTA per SM; the token ring holds the largest chunk, min(64, C)
    rounded up to 8 rows; the ring takes as many of 3-6 stages as the
    shared memory holds."""
    grid, stages, nt_max = GG.plan_grouped(E, C, N, K)
    items = E * -(-C // GG.CHUNK) * -(-N // GG.TILE_N)
    assert grid == min(GG.SMS, items)
    assert nt_max == min(GG.CHUNK, -(-C // 8) * 8)
    assert GG.MIN_STAGES <= stages <= GG.MAX_STAGES
    assert GG.smem_bytes(E, stages, nt_max) <= GG.SMEM_LIMIT
    assert stages == GG.MAX_STAGES or \
        GG.smem_bytes(E, stages + 1, nt_max) > GG.SMEM_LIMIT


@pytest.mark.parametrize("E", [1, 60, 256, 1024])
@pytest.mark.parametrize("C", [3, 8, 65, 300])
@pytest.mark.parametrize("N,K", [(8, 8), (2048, 7168)])
def test_plan_grouped_bounds(E, C, N, K):
    """At every shape the kernel takes: 1 <= grid <= the SMs, a token
    ring of 8-64 rows (a multiple of 8) that holds any chunk, 3-6
    stages, within the shared memory; and the plan reads only shapes
    (``sms`` defaults to the H100's 132)."""
    grid, stages, nt_max = GG.plan_grouped(E, C, N, K)
    assert 1 <= grid <= GG.SMS
    assert 8 <= nt_max <= GG.CHUNK and nt_max % 8 == 0
    assert nt_max >= min(C, GG.CHUNK)
    assert GG.MIN_STAGES <= stages <= GG.MAX_STAGES
    assert GG.smem_bytes(E, stages, nt_max) <= GG.SMEM_LIMIT
    assert GG.plan_grouped(E, C, N, K, sms=8)[0] <= 8
