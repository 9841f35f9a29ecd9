"""Training of the ssm family (rwkv6-7b, reduced: 2 layers, d 64, 4 heads
of 16, d_ff 128) in the port against the reference, on the CPU, with the
reference's bf16 weights bridged in (``from_reference``) and seeded
numpy batches of 2 x 40 tokens: the scan's chunks of 16 leave a padded
last chunk, and the gradients cross two chunk boundaries.

The reference's init zeroes the token-shift ``mix`` rows, the bonus
``u`` and the decay bias ``w_bias``; here every layer's are drawn N(0,
1) from a numpy seed on the reference's side first, so that their
gradients and the lerps they drive are not those of a symmetric point.

- The loss within 1e-3 relative and every gradient leaf within 5e-2
  relative L2 of ``jax.value_and_grad`` of the reference's loss, jitted
  (it stays within both limits here: 3.7e-5 and 2.6%, where the jitted
  serving logits move by up to 2%, ``tests/test_torch_ssm.py``).
- Training runs each layer from a zero state whose token shifts have
  the activations' dtype (``init_rwkv_state(cfg, B, x.dtype)``, as the
  reference's ``forward_train``): the layers run by hand from such a
  state give the same hidden states bit for bit, and from the serving
  default (fp32 shifts, which promote every lerp to fp32) other ones.
- ``remat="full"`` and ``"dots"`` against ``"none"``: bit for bit, and
  under ``"dots"`` the 9 products of each layer recorded and handed
  back, none computed again in the backward pass.
- One AdamW and one Adafactor update from a state with history on the
  rwkv tree (the (5, d) and (2, d) ``mix``, ``w_bias``, ``u``) against
  the reference's; a Trainer that fails and resumes replaying the same
  losses; the CLI's falling losses; the size of ``TRAINING``.
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
from repro_torch.checkpoint.checkpoint import _flatten  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.configs.base import RunConfig, ShapeConfig  # noqa: E402
from repro_torch.configs.rwkv6_7b import TRAINING  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.steps import loss_and_grads  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import (from_reference,  # noqa: E402
                                       n_elements,
                                       opt_state_from_reference,
                                       tree_leaves)
from repro_torch.optim import get_optimizer  # noqa: E402
from repro_torch.runtime.train_loop import Trainer, TrainerConfig  # noqa: E402,E501

TT = importlib.import_module("test_torch_train")

ARCH = "rwkv6_7b"
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


def _ref_params(seed=0):
    """The reference's weights with every layer's ``mix`` rows, ``u`` and
    ``w_bias`` drawn N(0, 1) in bf16 from a numpy seed."""
    rp = jax.jit(RefModel(ref_reduced(ARCH)).init)(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 100)
    layers = dict(rp["layers"])
    for mix in ("time", "channel"):
        block = dict(layers[mix])
        for name in ("mix", "u", "w_bias") if mix == "time" else ("mix",):
            block[name] = jnp.asarray(
                rng.standard_normal(block[name].shape), jnp.bfloat16)
        layers[mix] = block
    return {**rp, "layers": layers}


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
    """(cfg, port params, batch, reference loss, reference grads in the
    port's tree)."""
    rm = RefModel(ref_reduced(ARCH), remat="none")
    rp = _ref_params()
    cfg = get_reduced(ARCH)
    batch = _batch(cfg)
    (loss, _), g = jax.jit(jax.value_and_grad(rm.loss, has_aux=True))(
        rp, {k: jnp.asarray(v) for k, v in batch.items()})
    return (cfg, from_reference(_np_tree(rp), cfg), batch, float(loss),
            from_reference(_np_tree(g), cfg))


def test_loss_matches_reference(case):
    cfg, params, batch, want, _ = case
    (loss, metrics), _ = loss_and_grads(Model(cfg, device="cpu",
                                              remat="none"),
                                        params, _torch_batch(batch))
    assert loss.dtype == torch.float32 and set(metrics) == {"ce", "aux"}
    assert float(metrics["aux"]) == 0.0
    assert abs(float(loss) - want) <= LOSS_RTOL * abs(want), \
        (float(loss), want)


def test_every_gradient_leaf_matches_reference(case):
    cfg, params, batch, _, want = case
    _, grads = loss_and_grads(Model(cfg, device="cpu", remat="none"),
                              params, _torch_batch(batch))
    got, ref_g = _flatten(grads), _flatten(want)
    assert [p for p, _ in got] == [p for p, _ in ref_g]
    for (path, g), (_, w) in zip(got, ref_g):
        assert g.shape == w.shape and g.dtype == w.dtype, path
        assert bool(g.float().isfinite().all()), path
        err = float((g.float() - w.float()).norm() / w.float().norm())
        assert err <= GRAD_REL_L2, ("/".join(path), err)


def test_layers_run_from_a_zero_state_in_the_activation_dtype(case):
    """``forward_train`` equals the layers run by hand from
    ``init_rwkv_state(cfg, B, torch.bfloat16)``, bit for bit, and
    differs from them run from the serving default (fp32 token shifts,
    which ``torch.cat`` promotes the bf16 activations to)."""
    cfg, params, batch, _, _ = case
    tokens = _torch_batch(batch)["tokens"]
    h, aux, extras = T.forward_train(params, cfg, {"tokens": tokens},
                                     "none")
    assert h.dtype == torch.bfloat16 and extras == {} and float(aux) == 0

    def by_hand(dtype):
        x = T.embed_tokens(params, cfg, tokens)
        state = SSM.init_rwkv_state(cfg, B, dtype)
        for lp in params["layers"]:
            x = T.rwkv_layer_fwd(lp, x, cfg, state)[0]
        return L.apply_norm(params["final_norm"], x, cfg)

    assert torch.equal(h, by_hand(torch.bfloat16))
    assert by_hand(torch.float32).dtype == torch.float32
    assert not torch.equal(h.float(), by_hand(torch.float32))


def test_remat_full_and_dots_equal_none(case):
    cfg, params, batch, _, _ = case
    assert TT.assert_remat_modes_equal(cfg, params, _torch_batch(batch)) \
        == 9 * cfg.n_layers


@pytest.fixture(scope="module")
def rwkv_weights_and_grads():
    rp = _ref_params(1)
    rng = np.random.default_rng(1)
    g = jax.tree.map(lambda x: jnp.asarray(
        rng.standard_normal(x.shape).astype(np.float32) * 0.05), rp)
    return rp, g


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_update_on_rwkv_tree_matches_reference(
        rwkv_weights_and_grads, name):
    """One update from a state with history on the rwkv tree (the
    stacked (L, 5, d) / (L, 2, d) ``mix``, the (L, H, N) ``u`` and
    ``w_bias``, the layernorm biases): the parameters within one bf16
    ulp of the reference's (jitted), the optimizer's fp32 state within
    1e-6 relative, the gradient norm within 1e-6."""
    cfg = get_reduced(ARCH)
    rp, g = rwkv_weights_and_grads
    ropt = (RefAdamW if name == "adamw" else RefAdafactor)()
    update = jax.jit(ropt.update)
    p1, st1, _ = update(g, ropt.init(rp), rp, 0.01)
    p2, st2, m2 = update(g, st1, p1, 0.01)
    params = from_reference(_np_tree(p1), cfg)
    assert tuple(params["layers"][0]["time"]["mix"].shape) == \
        (5, cfg.d_model)
    assert tuple(params["layers"][0]["channel"]["mix"].shape) == \
        (2, cfg.d_model)
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
    want_st = opt_state_from_reference(_np_tree(st2), cfg)
    got_st, want_st = tree_leaves(new_st), tree_leaves(want_st)
    assert len(got_st) == len(want_st)
    for a, b in zip(got_st, want_st):
        assert a.shape == b.shape and a.dtype == b.dtype
        if a.dtype == torch.float32:
            assert bool(((a - b).abs() <= 1e-6 * b.abs() + 1e-30).all())


def _run(tmp, steps, inject=None):
    cfg = get_reduced(ARCH)
    run = RunConfig(model=cfg, shape=ShapeConfig("train", "train", S, B),
                    remat="none")
    tr = Trainer(run, TrainerConfig(ckpt_dir=str(tmp), ckpt_every=2,
                                    seed=5, lr_base=3e-3, lr_warmup=2,
                                    lr_total=20),
                 inject_failure_at=inject, device="cpu")
    return tr, tr.train(steps) if inject is None else None


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


def test_cli_trains_rwkv_with_falling_losses(tmp_path, capsys):
    train_cli.main(["--arch", "rwkv6-7b", "--reduced", "--device", "cpu",
                    "--steps", "6", "--seq", "32", "--batch", "4",
                    "--ckpt-dir", str(tmp_path / "ckpt")])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[rwkv6-7b-reduced] 6 steps on cpu, loss ")
    first, last = (float(x) for x in
                   line.split("loss ")[1].split(" (")[0].split(" -> "))
    assert last < first, line


def test_training_cut_of_the_full_config():
    """``TRAINING``: the first 10 layers at full width, ~2,886.2 M
    values (embed and lm_head 268.4 M each, 234.9 M a layer)."""
    cfg = get_config(ARCH)
    assert TRAINING.name == "rwkv6-7b-10l" and TRAINING.n_layers == 10
    assert dataclasses.replace(TRAINING, name=cfg.name, n_layers=32) == cfg
    tree = Model(TRAINING, device="cpu").abstract_params()
    assert len(tree["layers"]) == 10
    assert abs(n_elements(tree["layers"][0]) / 1e6 - 234.9) < 0.05
    assert abs(n_elements(tree) / 1e6 - 2886.2) < 0.05
