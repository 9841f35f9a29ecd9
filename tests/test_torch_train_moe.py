"""Training of the MoE family (qwen2-moe-a2.7b, reduced: 2 layers, d 64,
8 experts of d_ff 96, top-2, one shared expert) in the port against the
reference, on the CPU, with the reference's bf16 weights bridged in
(``from_reference``) and seeded numpy batches of 2 x 40 tokens at
capacity factor 1.25, so that some assignments are dropped (asserted).

- The loss within 1e-3 relative and every gradient leaf within 5e-2
  relative L2 of ``jax.value_and_grad`` of the reference's loss run op
  by op (``jax.disable_jit()``): for the global dispatch, for
  ``Tuning.moe_local_dispatch`` and for a ``first_dense_layers = 1``
  variant.  The jitted reference is not the yardstick: XLA drops the
  bf16 roundings between the ops it fuses, which moves a router
  near-tie to another expert (``tests/test_torch_moe_model.py``); op by
  op, both sides round every op, and every (layer, token) expert set
  is recorded on both sides and must agree, so no tolerance covers a
  routing difference.
- ``remat="full"`` against ``"none"``: bit for bit.
- ``_GroupedGemm`` (``ops.grouped_streaming_gemm`` under autograd) on the
  CPU against autograd of ``ref.grouped_gemm_ref`` in fp32, with an
  expert at count 0 and the rows past each count filled with NaN in the
  activations and in the output gradient: equal within fp32 rounding,
  and no NaN reaches a gradient.
- One Adafactor step and one AdamW step with INT8 gradient compression
  on the MoE tree (4-D stacked expert leaves, Adafactor factored over
  their last two dimensions) against the reference's.
- A checkpoint round trip of the MoE train state, and a Trainer that
  fails and resumes replaying the same losses bit for bit.
- MLA, ssm, hybrid and audio training, and ``remat="dots"``, still
  raise, naming ROADMAP 13b.
"""
import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as ref_reduced  # noqa: E402
from repro.models import moe as RMOE  # noqa: E402
from repro.models import tuning as RTU  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro.optim import Adafactor as RefAdafactor  # noqa: E402
from repro.optim import AdamW as RefAdamW  # noqa: E402
from repro.runtime import compression as RGC  # noqa: E402
from repro_torch.checkpoint.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.configs.base import RunConfig, ShapeConfig  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch.steps import loss_and_grads  # noqa: E402
from repro_torch.models import moe as PMOE  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models import tuning as TU  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import (from_reference,  # noqa: E402
                                       opt_state_from_reference,
                                       tree_leaves)
from repro_torch.optim import Adafactor, AdamW  # noqa: E402
from repro_torch.runtime import compression as GC  # noqa: E402
from repro_torch.runtime.train_loop import Trainer, TrainerConfig  # noqa: E402,E501

ARCH = "qwen2_moe_a2_7b"
LOSS_RTOL = 1e-3
GRAD_REL_L2 = 5e-2
B, S = 2, 40
VARIANTS = ("global", "local", "dense+moe")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the reduced model's ops are tiny, and on a
    shared host several threads each spin for far longer than the op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(variant):
    rcfg, cfg = ref_reduced(ARCH), get_reduced(ARCH)
    if variant == "dense+moe":
        rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
            rcfg.moe, first_dense_layers=1))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, first_dense_layers=1))
    return rcfg, cfg


def _tunings(variant):
    local = variant == "local"
    return (RTU.tuning_context(RTU.Tuning(moe_local_dispatch=local)),
            TU.tuning_context(TU.Tuning(moe_local_dispatch=local)))


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[0, :5] = -1
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)
                                   ).astype(np.int32), "labels": labels}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@contextlib.contextmanager
def _routes():
    """Record every MoE call's expert sets, (n tokens, k) sorted, on both
    sides in call order; the reference's through an ordered debug
    callback (its values are tracers under ``value_and_grad``)."""
    ref_routes, port_routes = [], []
    ref_apply, port_apply = RMOE.apply_moe, PMOE.apply_moe

    def ref_wrap(p, x, cfg, capacity_factor=1.25, capacity=None):
        xt = x.reshape(-1, x.shape[-1])
        probs = jax.nn.softmax((xt @ p["router"]).astype(jnp.float32), -1)
        _, top_e = jax.lax.top_k(probs, cfg.moe.top_k)
        jax.debug.callback(
            lambda e: ref_routes.append(np.sort(np.asarray(e), -1)),
            top_e, ordered=True)
        return ref_apply(p, x, cfg, capacity_factor, capacity)

    def port_wrap(p, x, cfg, capacity_factor=1.25, capacity=None):
        _, top_e, _ = PMOE._route(p, x.reshape(-1, x.shape[-1]), cfg)
        port_routes.append(np.sort(top_e.numpy(), -1))
        return port_apply(p, x, cfg, capacity_factor, capacity)

    RMOE.apply_moe, PMOE.apply_moe = ref_wrap, port_wrap
    try:
        yield ref_routes, port_routes
    finally:
        jax.effects_barrier()
        RMOE.apply_moe, PMOE.apply_moe = ref_apply, port_apply


@pytest.fixture(scope="module", params=VARIANTS)
def case(request):
    """(variant, port cfg, port params, batch, reference loss and aux,
    reference grads in the port's tree, routes of both sides)."""
    variant = request.param
    rcfg, cfg = _cfgs(variant)
    rm = RefModel(rcfg, remat="none")
    rp = rm.init(jax.random.PRNGKey(0))
    batch = _batch(cfg)
    params = from_reference(jax.tree.map(np.asarray, rp), cfg)
    ref_tune, port_tune = _tunings(variant)
    with _routes() as (ref_routes, port_routes):
        with ref_tune, jax.disable_jit():
            (loss, metrics), g = jax.value_and_grad(rm.loss, has_aux=True)(
                rp, {k: jnp.asarray(v) for k, v in batch.items()})
        with port_tune:
            got = loss_and_grads(Model(cfg, device="cpu", remat="none"),
                                 params, _torch_batch(batch))
    return {"variant": variant, "cfg": cfg, "params": params,
            "batch": batch, "loss": float(loss), "aux": float(metrics["aux"]),
            "grads": from_reference(jax.tree.map(np.asarray, g), cfg),
            "got": got, "ref_routes": ref_routes,
            "port_routes": port_routes}


def test_routes_agree_and_tokens_are_dropped(case):
    """Both sides send every (layer, token) to the same experts, and the
    capacity drops some assignments (so the drop rule and the zeroed
    (E-1, C-1) cell are exercised)."""
    cfg = case["cfg"]
    ref_routes, port_routes = case["ref_routes"], case["port_routes"]
    n_moe = cfg.n_layers - cfg.moe.first_dense_layers
    assert len(ref_routes) == len(port_routes) == n_moe
    for r, p in zip(ref_routes, port_routes):
        np.testing.assert_array_equal(r, p)
    E, k = cfg.moe.n_routed_experts, cfg.moe.top_k
    local = case["variant"] == "local"
    C = PMOE.routed_capacity((S if local else B * S) * k, E, None,
                             multiple=4 if local else 8)
    dropped = 0
    for e in port_routes:
        groups = e.reshape(B, S * k) if local else e.reshape(1, -1)
        for row in groups:
            dropped += int(np.clip(np.bincount(row, minlength=E) - C, 0,
                                   None).sum())
    assert dropped > 0


def test_loss_matches_reference(case):
    (loss, metrics), _ = case["got"]
    want = case["loss"]
    assert loss.dtype == torch.float32 and set(metrics) == {"ce", "aux"}
    assert float(metrics["aux"]) > 0
    assert abs(float(metrics["aux"]) - case["aux"]) <= 1e-3 * case["aux"]
    assert abs(float(loss) - want) <= LOSS_RTOL * abs(want), \
        (float(loss), want)


def test_every_gradient_leaf_matches_reference(case):
    _, grads = case["got"]
    got, want = tree_leaves(grads), tree_leaves(case["grads"])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert bool(g.float().isfinite().all())
        err = float((g.float() - w.float()).norm() / w.float().norm())
        assert err <= GRAD_REL_L2, err


@pytest.mark.parametrize("variant", ["global", "dense+moe"])
def test_remat_full_equals_none(variant):
    _, cfg = _cfgs(variant)
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    batch = _torch_batch(_batch(cfg, seed=3))
    (l0, m0), g0 = loss_and_grads(Model(cfg, device="cpu", remat="none"),
                                  params, batch)
    (l1, m1), g1 = loss_and_grads(Model(cfg, device="cpu", remat="full"),
                                  params, batch)
    assert torch.equal(l0, l1) and torch.equal(m0["aux"], m1["aux"])
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(g0), tree_leaves(g1)))


def test_grouped_gemm_function_backward_matches_autograd_of_plain_version():
    """dA = dC·Bᵀ over the kept rows (zeros past them) and dB = Aᵀ·dC over
    the kept rows only, with expert 1 at count 0, expert 2 full, and
    NaN in every row past a count of A and of dC: equal to autograd of
    ``ref.grouped_gemm_ref`` within fp32 rounding, all finite."""
    rng = np.random.default_rng(11)
    E, C, K, N = 4, 24, 40, 56
    counts = torch.tensor([7, 0, C, 13], dtype=torch.int32)
    past = torch.arange(C)[None, :] >= counts[:, None]
    a = torch.from_numpy(rng.standard_normal((E, C, K), np.float32))
    a[past] = float("nan")
    b = torch.from_numpy(rng.standard_normal((E, K, N), np.float32))
    dc = torch.from_numpy(rng.standard_normal((E, C, N), np.float32))
    dc[past] = float("nan")
    got, want = [], []
    for fn, out in ((ops.grouped_streaming_gemm, got),
                    (ref.grouped_gemm_ref, want)):
        a_, b_ = a.clone().requires_grad_(), b.clone().requires_grad_()
        c = fn(a_, b_, counts)
        assert not bool(c[~past].isnan().any())
        out.extend(torch.autograd.grad(c, (a_, b_), dc))
    for g, w in zip(got, want):
        assert g.shape == w.shape and bool(g.isfinite().all())
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    assert not got[0][past].any() and not got[1][1].any()
    assert ops.GROUPED_BWD == {"da": 0, "db": 0}     # CPU: no launches


@pytest.fixture(scope="module")
def moe_weights_and_grads():
    rp = RefModel(ref_reduced(ARCH)).init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    g = jax.tree.map(lambda x: jnp.asarray(
        rng.standard_normal(x.shape).astype(np.float32) * 0.05), rp)
    return rp, g


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _assert_update(before, got_p, want_p):
    for old, got, want in zip(before, tree_leaves(got_p),
                              tree_leaves(want_p)):
        assert got.dtype == want.dtype and got.shape == want.shape
        ulp = 2.0 ** -7 if got.dtype == torch.bfloat16 else 2.0 ** -20
        lim = ulp * torch.maximum(old.float().abs(), want.float().abs())
        assert bool(((got.float() - want.float()).abs() <= lim).all())


def test_adafactor_step_on_moe_tree_matches_reference(moe_weights_and_grads):
    """The stacked expert leaves are (L, E, d, f): Adafactor factors them
    over the last two dimensions, as the reference does; one update from
    a state with history, parameters within one bf16 ulp, slots within
    1e-6 relative."""
    cfg = get_reduced(ARCH)
    rp, g = moe_weights_and_grads
    ropt = RefAdafactor()
    p1, st1, _ = ropt.update(g, ropt.init(rp), rp, 0.01)
    p2, st2, m2 = ropt.update(g, st1, p1, 0.01)
    params = from_reference(_np_tree(p1), cfg)
    state = opt_state_from_reference(_np_tree(st1), cfg)
    slots = state["slots"]["layers"]["moe"]["wi_gate"]
    L, E, d, f = (cfg.n_layers, cfg.moe.n_routed_experts, cfg.d_model,
                  cfg.moe.d_ff_expert)
    assert tuple(slots["vr"].shape) == (L, E, d)
    assert tuple(slots["vc"].shape) == (L, E, f)
    fresh = Adafactor().init(params)["slots"]["layers"]["moe"]["wi_gate"]
    assert {k: tuple(v.shape) for k, v in fresh.items()} == \
        {k: tuple(v.shape) for k, v in slots.items()}
    before = [p.clone() for p in tree_leaves(params)]
    new_p, new_st, met = Adafactor().update(
        from_reference(_np_tree(g), cfg), state, params,
        torch.tensor(0.01, dtype=torch.float32))
    assert abs(float(met["grad_norm"]) - float(m2["grad_norm"])) <= \
        1e-6 * float(m2["grad_norm"])
    _assert_update(before, new_p, from_reference(_np_tree(p2), cfg))
    want_st = opt_state_from_reference(_np_tree(st2), cfg)
    for a, b in zip(tree_leaves(new_st), tree_leaves(want_st)):
        assert a.shape == b.shape and a.dtype == b.dtype
        if a.dtype == torch.float32:
            assert bool(((a - b).abs() <= 1e-6 * b.abs() + 1e-30).all())


def test_compressed_adamw_step_on_moe_tree_matches_reference(
        moe_weights_and_grads):
    """INT8 compression with error feedback (one scale per stacked leaf)
    and then AdamW, as the reference trainer's wrapped step: the
    dequantized gradients and the new error feedback within fp32
    rounding, the parameters within one bf16 ulp."""
    cfg = get_reduced(ARCH)
    rp, g = moe_weights_and_grads
    rng = np.random.default_rng(4)
    ef = jax.tree.map(lambda x: jnp.asarray(
        rng.standard_normal(x.shape).astype(np.float32) * 1e-3), g)
    rdq, ref_ef = RGC.apply_compression(g, ef)
    ropt = RefAdamW()
    st0 = ropt.init(rp)
    want_p, _, want_m = ropt.update(rdq, st0, rp, 0.01)
    params = from_reference(_np_tree(rp), cfg)
    dq, new_ef = GC.apply_compression(from_reference(_np_tree(g), cfg),
                                      from_reference(_np_tree(ef), cfg))
    for a, b in ((dq, rdq), (new_ef, ref_ef)):
        for x, y in zip(tree_leaves(a), tree_leaves(
                from_reference(_np_tree(b), cfg))):
            torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-9)
    before = [p.clone() for p in tree_leaves(params)]
    opt = AdamW()
    new_p, _, met = opt.update(dq, opt.init(params), params,
                               torch.tensor(0.01, dtype=torch.float32))
    assert abs(float(met["grad_norm"]) - float(want_m["grad_norm"])) <= \
        1e-6 * float(want_m["grad_norm"])
    _assert_update(before, new_p, from_reference(_np_tree(want_p), cfg))


def _run(tmp, steps, inject=None):
    cfg = get_reduced(ARCH)
    run = RunConfig(model=cfg, shape=ShapeConfig("train", "train", 32, 4),
                    remat="none")
    tr = Trainer(run, TrainerConfig(ckpt_dir=str(tmp), ckpt_every=2,
                                    seed=5, lr_base=3e-3, lr_warmup=2,
                                    lr_total=20),
                 inject_failure_at=inject, device="cpu")
    return tr, tr.train(steps) if inject is None else None


def test_checkpoint_roundtrip_of_moe_train_state(tmp_path):
    """The MoE train state (the expert leaves (E, d, f) per layer, AdamW's
    moments) saved and restored into ``abstract_params``' template, bit
    for bit."""
    tr, _ = _run(tmp_path / "a", 2)
    state, start = tr.restore_or_init()
    assert start == 2
    mgr = CheckpointManager(tmp_path / "b", async_save=False)
    mgr.save(state, 7)
    template = tr._state(tr.model.abstract_params())
    restored, step = mgr.restore(template, device="cpu")
    assert step == 7
    got, want = tree_leaves(restored), tree_leaves(state)
    assert len(got) == len(want)
    assert any(tuple(t.shape) == (8, 64, 96) for t in got)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_trainer_restart_replays_the_same_steps(tmp_path):
    """A run that fails after step 2 and a fresh Trainer on its directory
    (resuming from the step-1 checkpoint) give steps 2-3 the losses of
    an uninterrupted run, bit for bit."""
    _, full = _run(tmp_path / "full", 4)
    assert len(full["losses"]) == 4 and np.isfinite(full["losses"]).all()
    with pytest.raises(RuntimeError, match="injected node failure"):
        _run(tmp_path / "restart", 4, inject=2)[0].train(4)
    tr, out = _run(tmp_path / "restart", 4)
    assert tr.ckpt.all_steps() == [1, 3]
    assert out["losses"] == full["losses"][2:]


@pytest.mark.parametrize("arch", ["deepseek_v3_671b", "rwkv6_7b",
                                  "zamba2_7b", "whisper_tiny"])
def test_untrained_configs_still_raise_naming_13b(arch):
    cfg = get_reduced(arch)
    params = Model(cfg, device="cpu").abstract_params()
    with pytest.raises(NotImplementedError, match="Queue A item 13b"):
        T.forward_train(params, cfg, {"tokens": torch.zeros(
            (1, 4), dtype=torch.int32)})


def test_moe_remat_dots_and_mtp_still_raise():
    cfg = get_reduced(ARCH)
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="Queue A item 13b"):
        T.forward_train(params, cfg, {"tokens": torch.zeros(
            (1, 4), dtype=torch.int32)}, remat="dots")
    with pytest.raises(NotImplementedError, match="Queue A item 13b"):
        T.mtp_loss(params, cfg, None, {})
