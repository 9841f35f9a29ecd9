"""The port's train step and ``Trainer`` on the CPU.

- One ``build_train_step`` step against the reference's on the same
  weights, optimizer state and batch (the reference's after 5 steps,
  bridged): the loss within 1e-3 relative, the clipped gradient norm
  within 1e-2, the learning rate equal, and each leaf's update (new
  parameter less old) within 0.3 of the reference's update in relative
  L2, all leaves together within 0.1.  The bf16 rounding of the
  gradients and of the parameters moves a small leaf's update by up to
  about 0.25 (Adafactor's 32-element biases), the whole by about 0.03;
  a skipped update is off by 1, a half-applied one by 0.5.  A leaf whose
  update the reference's own rounding decides is held by its size (its
  L2 norm within 0.3 of the reference's), not its direction, and is
  left out of the total: those whose reference update moves by more
  than ``NOISE_REL`` when the reference's gradient is taken op by op
  instead of jitted (only its rounding differs).  Those are the
  ``ln1`` scales: their values lie near 1, where bf16 steps by 2^-8 or
  2^-7, so an update of lr (3e-3) times an RMS-normalised step moves
  each value by no step or one, and the last bits of the gradient
  decide which (the reference's own two gradients give updates 0.41 and
  0.44 apart under Adafactor, 0.12 under AdamW).  The key bias ``bk``
  is no such leaf: its gradient is of ``bq``'s order, since RoPE
  rotates it with the key's position, and the port's matches the
  reference's as closely as any leaf's.
- The loss falls over a few steps; a crash at step 7 and a fresh
  trainer on the same directory resume from the step-4 checkpoint and
  give the uninterrupted run's losses bit for bit; the straggler
  watchdog fires (as the reference's ``tests/test_system.py``);
  gradient compression runs, with ``ef`` in the state.
- ``launch/train.py --device cpu --reduced`` runs; without ``--device
  cpu`` and without a card the CLI, ``Trainer``, ``build_train_step``
  and both training examples raise.
"""
import runpy
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as ref_reduced  # noqa: E402
from repro.configs.base import RunConfig as RefRun  # noqa: E402
from repro.configs.base import ShapeConfig as RefShape  # noqa: E402
from repro.data.pipeline import DataConfig, SyntheticCorpus  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.launch.steps import build_train_step as ref_build  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro.optim import get_optimizer as ref_optimizer  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.configs.base import RunConfig, ShapeConfig  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.steps import build_train_step  # noqa: E402
from repro_torch.models.params import (from_reference,  # noqa: E402
                                       opt_state_from_reference)
from repro_torch.models.params import tree_leaves  # noqa: E402
from repro_torch.runtime.train_loop import Trainer, TrainerConfig  # noqa: E402,E501

ARCH = "qwen2_0_5b"
EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
NOISE_REL = 0.1


def _noise_leaves(rcfg, opt, state, batch, lr) -> set:
    """Indices (in ``tree_leaves`` order of the port's parameters) of the
    leaves whose reference update is round-off (module docstring): the
    reference's optimizer fed its gradient jitted and op by op."""
    model = RefModel(rcfg, remat="none")
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    grad = jax.grad(lambda q: model.loss(q, b)[0])
    with jax.disable_jit():
        slow = grad(state["params"])
    news = [ref_optimizer(opt).update(g, state["opt"], state["params"],
                                      lr)[0]
            for g in (jax.jit(grad)(state["params"]), slow)]
    cfg = get_reduced(ARCH)
    old, fast, slow = (tree_leaves(from_reference(
        jax.tree.map(np.asarray, t), cfg))
        for t in (state["params"], *news))
    out = set()
    for i, (o, f, s) in enumerate(zip(old, fast, slow)):
        d_f, d_s = f.float() - o.float(), s.float() - o.float()
        if float((d_f - d_s).norm()) > NOISE_REL * float(d_f.norm()):
            out.add(i)
    return out


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_one_step_matches_reference(opt):
    rcfg, cfg = ref_reduced(ARCH), get_reduced(ARCH)
    lr = dict(lr_base=3e-3, lr_warmup=4, lr_total=100)
    rrun = RefRun(model=rcfg, shape=RefShape("t", "train", 64, 4),
                  remat="none", optimizer=opt)
    mesh = make_host_mesh(1, 1)
    step_ref = jax.jit(ref_build(rrun, mesh, **lr).fn)
    p = RefModel(rcfg, remat="none").init(jax.random.PRNGKey(0))
    st = {"params": p, "opt": ref_optimizer(opt).init(p)}
    corpus = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=64, global_batch=4, seed=0))
    with mesh:
        for s in range(5):
            st, _ = step_ref(st, {k: jnp.asarray(v)
                                  for k, v in corpus.batch(s).items()})
        batch = corpus.batch(5)
        st2, want = step_ref(st, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
    to_np = lambda t: jax.tree.map(np.asarray, t)   # noqa: E731
    state = {"params": from_reference(to_np(st["params"]), cfg),
             "opt": opt_state_from_reference(to_np(st["opt"]), cfg)}
    before = [t.clone() for t in tree_leaves(state["params"])]
    run = RunConfig(model=cfg, shape=ShapeConfig("t", "train", 64, 4),
                    remat="none", optimizer=opt)
    new, got = build_train_step(run, "cpu", **lr)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(got) == {"ce", "aux", "loss", "lr", "grad_norm"}
    assert abs(float(got["loss"]) - float(want["loss"])) <= \
        1e-3 * abs(float(want["loss"]))
    assert abs(float(got["grad_norm"]) - float(want["grad_norm"])) <= \
        1e-2 * float(want["grad_norm"])
    assert float(got["lr"]) == float(want["lr"]) > 0
    noise = _noise_leaves(rcfg, opt, st, batch, want["lr"])
    assert len(noise) < len(before) // 4
    off = total = 0.0
    for i, (old, a, w) in enumerate(zip(
            before, tree_leaves(new["params"]),
            tree_leaves(from_reference(to_np(st2["params"]), cfg)))):
        got_d, want_d = a.float() - old.float(), w.float() - old.float()
        err, size = (got_d - want_d).norm(), want_d.norm()
        assert size > 0
        if i in noise:
            assert abs(got_d.norm() - size) <= 0.3 * size
            continue
        assert err <= 0.3 * size
        off, total = off + float(err) ** 2, total + float(size) ** 2
    assert off ** 0.5 <= 0.1 * total ** 0.5
    assert int(new["opt"]["step"]) == 6



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the reduced models' ops are tiny, and on a
    shared host several threads each spin for far longer than the op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _trainer(tmp, steps_cfg=None, inject=None, compression=False):
    run = RunConfig(model=get_reduced(ARCH),
                    shape=ShapeConfig("t", "train", 32, 4), remat="none",
                    gradient_compression=compression)
    return Trainer(run, TrainerConfig(ckpt_dir=str(tmp), ckpt_every=5,
                                      lr_base=5e-3, lr_warmup=2,
                                      lr_total=200),
                   inject_failure_at=inject, device="cpu")


def test_loss_falls(tmp_path):
    out = _trainer(tmp_path).train(14)
    assert len(out["losses"]) == 14
    assert out["final_loss"] < out["losses"][0]


def test_crash_restart_resumes_exactly(tmp_path):
    tr = _trainer(tmp_path / "a", inject=7)
    with pytest.raises(RuntimeError, match="injected node failure"):
        tr.train(30)
    assert tr.ckpt.all_steps() == [4]
    resumed = _trainer(tmp_path / "a")
    state, start = resumed.restore_or_init()
    assert start == 5
    out = resumed.train(10)
    full = _trainer(tmp_path / "b").train(10)
    assert len(out["losses"]) == 5
    assert out["losses"] == full["losses"][5:]        # bit for bit


def test_straggler_watchdog_fires(tmp_path):
    """A step that takes 0.5 s among steps of microseconds (the step
    replaced by one that returns its state) is flagged."""
    tr = _trainer(tmp_path)
    calls = {"n": 0}

    def slow_step(state, batch):
        calls["n"] += 1
        if calls["n"] == 10:
            time.sleep(0.5)
        return state, {"loss": torch.tensor(1.0)}

    tr.step_fn = slow_step
    out = tr.train(14)
    assert 9 in out["stragglers"]


def test_gradient_compression_runs(tmp_path):
    tr = _trainer(tmp_path, compression=True)
    out = tr.train(8)
    assert all(np.isfinite(out["losses"]))
    assert out["final_loss"] < out["losses"][0]
    state, _ = tr.restore_or_init()
    assert set(state) == {"params", "opt", "ef"}
    assert any(float(e.abs().max()) > 0 for e in tree_leaves(state["ef"]))


def test_train_cli_runs_on_the_cpu(tmp_path, capsys):
    train_cli.main(["--reduced", "--device", "cpu", "--steps", "6",
                    "--seq", "32", "--batch", "2", "--ckpt-every", "3",
                    "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "6 steps on cpu" in out and "checkpoints=[2, 5]" in out


def test_without_a_card_each_entry_point_raises(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points run on it")
    run = RunConfig(model=get_reduced(ARCH),
                    shape=ShapeConfig("t", "train", 32, 2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_train_step(run)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(run, TrainerConfig(ckpt_dir=str(tmp_path)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--reduced", "--steps", "1",
                        "--ckpt-dir", str(tmp_path)])
    for name in ("train_lm_torch.py", "quickstart_torch.py"):
        monkeypatch.setattr("sys.argv", [name, "--ckpt-dir", str(tmp_path)])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            runpy.run_path(str(EXAMPLES / name), run_name="__main__")
