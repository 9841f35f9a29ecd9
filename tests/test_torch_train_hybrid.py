"""Training of the hybrid family (zamba2-7b, reduced: 4 Mamba2 layers, d
64, the shared attention block before layers 0 and 2) in the port
against the reference, on the CPU, with the reference's bf16 weights
bridged in (``from_reference``) and seeded numpy batches of 2 x 40
tokens: the scan's chunks of 16 leave a padded last chunk, and the
gradients cross two chunk boundaries.

- The loss within 1e-3 relative and every gradient leaf within 5e-2
  relative L2 of ``jax.value_and_grad`` of the reference's loss run op
  by op (``jax.disable_jit()``, ~50 s).  Jitted, XLA fuses the layer
  body's bf16 ops and the worst leaf, a ``D``, is 6% from the port's.
  Op by op the worst is a ``D`` at 4.8%: ``D``'s gradient is a sum over
  batch, time and head dim (2,560 terms here) of the gradient of a
  broadcast product, which the reference accumulates in bf16 (on 2,560
  random bf16 terms 16% off the exact sum, where ``jnp.sum`` of the same
  terms is within 0.1%) and the port in fp32.
- The shared block's gradient sums over both invocations: the block run
  through two copies of its leaves, one an invocation, gives two
  non-zero gradients whose sum is the shared leaves' gradient.
- ``remat="full"`` and ``"dots"`` against ``"none"``: bit for bit, and
  under ``"dots"`` the 5 products of each layer and the 4 of each
  shared invocation recorded and handed back.
- One AdamW and one Adafactor update from a state with history on the
  zamba2 tree (fp32 ``norm_scale``, ``A_log``, ``D``, ``dt_bias``,
  ``conv_w``, ``shared_attn``) against the reference's; a checkpoint
  round trip of a train state; the size of ``TRAINING``.
"""
import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as ref_reduced  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro.optim import Adafactor as RefAdafactor  # noqa: E402
from repro.optim import AdamW as RefAdamW  # noqa: E402
from repro_torch.checkpoint.checkpoint import (CheckpointManager,  # noqa: E402
                                               _flatten)
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.configs.base import RunConfig, ShapeConfig  # noqa: E402
from repro_torch.configs.zamba2_7b import TRAINING  # noqa: E402
from repro_torch.launch.steps import loss_and_grads  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import (from_reference,  # noqa: E402
                                       n_elements,
                                       opt_state_from_reference,
                                       tree_leaves, tree_map)
from repro_torch.optim import get_optimizer  # noqa: E402
from repro_torch.runtime.train_loop import Trainer, TrainerConfig  # noqa: E402,E501

TT = importlib.import_module("test_torch_train")

ARCH = "zamba2_7b"
LOSS_RTOL = 1e-3
GRAD_REL_L2 = 5e-2
B, S = 2, 40


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the reduced model's ops are tiny, and on a
    shared host several threads each spin for far longer than the op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _ref_init(seed):
    return jax.jit(RefModel(ref_reduced(ARCH)).init)(jax.random.PRNGKey(seed))


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[0, :5] = -1
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)
                                   ).astype(np.int32), "labels": labels}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def case():
    """The reference's loss and gradients op by op beside the port's."""
    rm = RefModel(ref_reduced(ARCH), remat="none")
    rp = _ref_init(0)
    cfg = get_reduced(ARCH)
    batch = _batch(cfg)
    with jax.disable_jit():
        (loss, _), g = jax.value_and_grad(rm.loss, has_aux=True)(
            rp, {k: jnp.asarray(v) for k, v in batch.items()})
    params = from_reference(_np_tree(rp), cfg)
    got = loss_and_grads(Model(cfg, device="cpu", remat="none"), params,
                         _torch_batch(batch))
    return {"cfg": cfg, "params": params, "batch": batch,
            "loss": float(loss), "grads": from_reference(_np_tree(g), cfg),
            "got": got}


def test_loss_matches_reference(case):
    (loss, metrics), _ = case["got"]
    assert loss.dtype == torch.float32 and set(metrics) == {"ce", "aux"}
    assert float(metrics["aux"]) == 0.0
    want = case["loss"]
    assert abs(float(loss) - want) <= LOSS_RTOL * abs(want), \
        (float(loss), want)


def test_every_gradient_leaf_matches_reference(case):
    _, grads = case["got"]
    got, ref_g = _flatten(grads), _flatten(case["grads"])
    assert [p for p, _ in got] == [p for p, _ in ref_g]
    assert any(p[0] == "shared_attn" for p, _ in got)
    for (path, g), (_, w) in zip(got, ref_g):
        assert g.shape == w.shape and g.dtype == w.dtype, path
        assert bool(g.float().isfinite().all()), path
        err = float((g.float() - w.float()).norm() / w.float().norm())
        assert err <= GRAD_REL_L2, ("/".join(path), err)


def test_shared_block_gradient_sums_over_its_invocations(case,
                                                         monkeypatch):
    """Each invocation of the shared block (before layers 0 and 2) run
    through its own copy of the block's leaves: both copies get a
    non-zero gradient, and their sum is the gradient of the shared
    leaves (the same bf16 additions autograd makes, so bit for bit)."""
    cfg, params = case["cfg"], case["params"]
    assert T.n_shared_invocations(cfg) == 2
    _, want = case["got"]
    copies = [tree_map(lambda p: p.detach().clone().requires_grad_(True),
                       params["shared_attn"]) for _ in range(2)]
    body, seen = T.hybrid_layer_train, []

    def split(lp, shared, x, cfg_, positions, state, with_attn):
        if with_attn:
            shared = copies[len(seen)]
            seen.append(shared)
        return body(lp, shared, x, cfg_, positions, state, with_attn)

    monkeypatch.setattr(T, "hybrid_layer_train", split)
    loss, _ = Model(cfg, device="cpu", remat="none").loss(
        params, _torch_batch(case["batch"]))
    leaves = [tree_leaves(c) for c in copies]
    grads = torch.autograd.grad(loss, leaves[0] + leaves[1])
    n = len(leaves[0])
    assert len(seen) == 2 and n == len(tree_leaves(params["shared_attn"]))
    for g0, g1, w in zip(grads[:n], grads[n:],
                         tree_leaves(want["shared_attn"])):
        assert bool(g0.float().norm() > 0) and bool(g1.float().norm() > 0)
        assert torch.equal(g0 + g1, w)


def test_remat_full_and_dots_equal_none(case):
    cfg = case["cfg"]
    assert TT.assert_remat_modes_equal(
        cfg, case["params"], _torch_batch(case["batch"])) == \
        5 * cfg.n_layers + 4 * T.n_shared_invocations(cfg)


@pytest.fixture(scope="module")
def zamba_weights_and_grads():
    rp = _ref_init(1)
    rng = np.random.default_rng(1)
    g = jax.tree.map(lambda x: jnp.asarray(
        rng.standard_normal(x.shape).astype(np.float32) * 0.05), rp)
    return rp, g


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_update_on_zamba_tree_matches_reference(
        zamba_weights_and_grads, name):
    """One update from a state with history on the zamba2 tree: the
    parameters within one bf16 ulp (fp32 leaves, ``norm_scale`` among
    them, within 2^-20) of the reference's (jitted), the optimizer's
    fp32 state within 1e-6 relative, the gradient norm within 1e-6."""
    cfg = get_reduced(ARCH)
    rp, g = zamba_weights_and_grads
    ropt = (RefAdamW if name == "adamw" else RefAdafactor)()
    update = jax.jit(ropt.update)
    p1, st1, _ = update(g, ropt.init(rp), rp, 0.01)
    p2, st2, m2 = update(g, st1, p1, 0.01)
    params = from_reference(_np_tree(p1), cfg)
    mamba = params["layers"][0]["mamba"]
    assert mamba["norm_scale"].dtype == torch.float32
    assert {"A_log", "D", "dt_bias", "conv_w"} <= set(mamba)
    state = opt_state_from_reference(_np_tree(st1), cfg)
    before = [p.clone() for p in tree_leaves(params)]
    new_p, new_st, met = get_optimizer(name).update(
        from_reference(_np_tree(g), cfg), state, params,
        torch.tensor(0.01, dtype=torch.float32))
    assert abs(float(met["grad_norm"]) - float(m2["grad_norm"])) <= \
        1e-6 * float(m2["grad_norm"])
    want = tree_leaves(from_reference(_np_tree(p2), cfg))
    assert len(want) == len(before)
    for old, got, w in zip(before, tree_leaves(new_p), want):
        assert got.dtype == w.dtype and got.shape == w.shape
        ulp = 2.0 ** -7 if got.dtype == torch.bfloat16 else 2.0 ** -20
        lim = ulp * torch.maximum(old.float().abs(), w.float().abs())
        assert bool(((got.float() - w.float()).abs() <= lim).all())
    got_st = tree_leaves(new_st)
    want_st = tree_leaves(opt_state_from_reference(_np_tree(st2), cfg))
    assert len(got_st) == len(want_st)
    for a, b in zip(got_st, want_st):
        assert a.shape == b.shape and a.dtype == b.dtype
        if a.dtype == torch.float32:
            assert bool(((a - b).abs() <= 1e-6 * b.abs() + 1e-30).all())


def test_checkpoint_roundtrip_of_zamba_train_state(tmp_path):
    """Two Trainer steps on reduced zamba2, then the train state (the
    per-layer Mamba2 leaves, ``shared_attn``, AdamW's moments) saved and
    restored into ``abstract_params``' template, bit for bit."""
    cfg = get_reduced(ARCH)
    run = RunConfig(model=cfg, shape=ShapeConfig("train", "train", 32, 2),
                    remat="none")
    tr = Trainer(run, TrainerConfig(ckpt_dir=str(tmp_path / "a"),
                                    ckpt_every=2, seed=5, lr_base=3e-3,
                                    lr_warmup=2, lr_total=20), device="cpu")
    out = tr.train(2)
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    state, start = tr.restore_or_init()
    assert start == 2
    mgr = CheckpointManager(tmp_path / "b", async_save=False)
    mgr.save(state, 7)
    restored, step = mgr.restore(tr._state(tr.model.abstract_params()),
                                 device="cpu")
    assert step == 7
    got, want = _flatten(restored), _flatten(state)
    assert [p for p, _ in got] == [p for p, _ in want]
    assert any(p[:2] == ("opt", "m") and "shared_attn" in p
               for p, _ in got)
    for (_, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_training_cut_of_the_full_config():
    """``TRAINING``: the first 7 layers at full width, the shared block
    run twice (before layers 0 and 6), ~1,905.6 M values."""
    cfg = get_config(ARCH)
    assert TRAINING.name == "zamba2-7b-7l" and TRAINING.n_layers == 7
    assert dataclasses.replace(TRAINING, name=cfg.name, n_layers=81) == cfg
    assert T.n_shared_invocations(TRAINING) == 2
    tree = Model(TRAINING, device="cpu").abstract_params()
    assert len(tree["layers"]) == 7
    assert abs(n_elements(tree["layers"][0]) / 1e6 - 232.1) < 0.05
    assert abs(n_elements(tree["shared_attn"]) / 1e6 - 51.4) < 0.05
    assert abs(n_elements(tree) / 1e6 - 1905.6) < 0.05
