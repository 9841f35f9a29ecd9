"""Training of the audio family (whisper-tiny, reduced: 2 encoder and 2
decoder layers, d 64, 4 heads of 16, vocabulary 250 padded to 256) in
the port against the reference, on the CPU, with the reference's bf16
weights bridged in (``from_reference``) and seeded numpy batches: 2 x 48
bf16 frames and 2 x 40 decoder tokens.

- The loss within 1e-3 relative and every gradient leaf within 5e-2
  relative L2 of ``jax.value_and_grad`` of the reference's loss,
  jitted; the encoder's output (the extras ``encoder_out``) against the
  reference's ``forward_train``.
- ``pos_embed``'s gradient: non-zero on each of the first Td rows and
  exactly zero below them.
- ``remat="full"`` and ``"dots"`` against ``"none"``: bit for bit, and
  under ``"dots"`` the 6 products of each encoder layer and the 10 of
  each decoder layer (self q, k, v, o, cross q, o, the cross K / V over
  the encoder's output, the MLP's 2) recorded and handed back.
- Whisper trains through ``build_train_step`` with batches that carry
  frames (the loss falls over a few AdamW steps); the CLI, whose loader
  yields no frames, raises ``ValueError``.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as ref_reduced  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro_torch.checkpoint.checkpoint import _flatten  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.configs.base import RunConfig, ShapeConfig  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.steps import (build_train_step,  # noqa: E402
                                      loss_and_grads)
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import from_reference, to_torch  # noqa: E402
from repro_torch.optim import get_optimizer  # noqa: E402

TT = importlib.import_module("test_torch_train")

ARCH = "whisper_tiny"
LOSS_RTOL = 1e-3
GRAD_REL_L2 = 5e-2
ENC_TOL = 2e-2
B, TE, TD = 2, 48, 40


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


def _batch(cfg, seed=0):
    """Token ids and labels (some ``-1``) of TD decoder positions, and
    TE frames of N(0, 1) values rounded to bf16."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (B, TD)).astype(np.int32)
    labels[0, :5] = -1
    frames = rng.standard_normal((B, TE, cfg.d_model))
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, TD)
                                   ).astype(np.int32), "labels": labels,
            "audio_frames": np.asarray(jnp.asarray(frames, jnp.bfloat16),
                                       np.float32)}


def _jax_batch(batch):
    out = {k: jnp.asarray(v) for k, v in batch.items()}
    out["audio_frames"] = out["audio_frames"].astype(jnp.bfloat16)
    return out


def _torch_batch(batch):
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    out["audio_frames"] = out["audio_frames"].to(torch.bfloat16)
    return out


@pytest.fixture(scope="module")
def case():
    rcfg = ref_reduced(ARCH)
    rm = RefModel(rcfg, remat="none")
    rp = jax.jit(rm.init)(jax.random.PRNGKey(0))
    cfg = get_reduced(ARCH)
    batch = _batch(cfg)
    (loss, _), g = jax.jit(jax.value_and_grad(rm.loss, has_aux=True))(
        rp, _jax_batch(batch))
    _, _, extras = jax.jit(lambda p, b: RT.forward_train(
        p, rcfg, b, "none"))(rp, _jax_batch(batch))
    params = from_reference(_np_tree(rp), cfg)
    return {"cfg": cfg, "params": params, "batch": batch,
            "loss": float(loss), "grads": from_reference(_np_tree(g), cfg),
            "encoder_out": to_torch(np.asarray(extras["encoder_out"])),
            "got": loss_and_grads(Model(cfg, device="cpu", remat="none"),
                                  params, _torch_batch(batch))}


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
    for (path, g), (_, w) in zip(got, ref_g):
        assert g.shape == w.shape and g.dtype == w.dtype, path
        assert bool(g.float().isfinite().all()), path
        err = float((g.float() - w.float()).norm() / w.float().norm())
        assert err <= GRAD_REL_L2, ("/".join(path), err)


def test_encoder_output_matches_reference(case):
    cfg = case["cfg"]
    h, aux, extras = T.forward_train(case["params"], cfg,
                                     _torch_batch(case["batch"]), "none")
    assert h.shape == (B, TD, cfg.d_model) and float(aux) == 0.0
    enc, want = extras["encoder_out"], case["encoder_out"]
    assert enc.shape == (B, TE, cfg.d_model) and enc.dtype == want.dtype
    err = float((enc.float() - want.float()).norm() / want.float().norm())
    assert err <= ENC_TOL, err


def test_pos_embed_gradient_only_on_the_decoder_rows(case):
    (_, _), grads = case["got"]
    g = grads["pos_embed"].float()
    assert g.shape[0] == case["cfg"].max_train_seq * 8 > TD
    assert bool((g[:TD].norm(dim=-1) > 0).all())
    assert not bool(g[TD:].any())
    assert not bool(case["grads"]["pos_embed"][TD:].float().any())


def test_remat_full_and_dots_equal_none(case):
    cfg = case["cfg"]
    assert TT.assert_remat_modes_equal(
        cfg, case["params"], _torch_batch(case["batch"])) == \
        6 * cfg.n_encoder_layers + 10 * cfg.n_layers


def test_build_train_step_trains_whisper_on_batches_with_frames():
    cfg = get_reduced(ARCH)
    run = RunConfig(model=cfg, shape=ShapeConfig("train", "train", TD, B),
                    remat="none")
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(2))
    state = {"params": params, "opt": get_optimizer("adamw").init(params)}
    step = build_train_step(run, "cpu", lr_base=3e-3, lr_warmup=1)
    batch = _torch_batch(_batch(cfg, seed=2))
    losses = []
    for _ in range(4):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


def test_cli_refuses_whisper_naming_the_missing_frames(tmp_path):
    with pytest.raises(ValueError, match="audio_frames"):
        train_cli.main(["--arch", "whisper-tiny", "--reduced", "--device",
                        "cpu", "--steps", "2", "--seq", "16", "--batch",
                        "2", "--ckpt-dir", str(tmp_path / "ckpt")])
