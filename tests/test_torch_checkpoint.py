"""The port's ``CheckpointManager`` on the CPU: the reference's four
checkpoint tests mirrored (round trip with dtypes, keep-n and latest,
async save, no partial checkpoint visible), and the port restoring the
parameters of a checkpoint that the reference's ``CheckpointManager``
wrote (stacked layer leaves, bf16 widened to fp32 on disk) into the
tree ``from_reference`` builds, bit for bit.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint.checkpoint import CheckpointManager as RefManager  # noqa: E402,E501
from repro.configs import get_reduced as ref_reduced  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro.optim import AdamW as RefAdamW  # noqa: E402
from repro_torch.checkpoint.checkpoint import (CheckpointManager,  # noqa: E402,E501
                                               _flatten)
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import (from_reference,  # noqa: E402
                                       opt_state_from_reference)
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((8, 16), generator=g).to(
                           torch.bfloat16),
                       "b": torch.arange(16, dtype=torch.float32),
                       "layers": [{"s": torch.randn(4, generator=g)}
                                  for _ in range(2)]},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)}}


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=False)
    st = _state()
    mgr.save(st, 3)
    template = {"params": {"w": torch.empty((8, 16), dtype=torch.bfloat16,
                                            device="meta"),
                           "b": torch.empty(16, device="meta"),
                           "layers": [{"s": torch.empty(4, device="meta")}
                                      for _ in range(2)]},
                "opt": {"step": torch.empty((), dtype=torch.int32,
                                            device="meta")}}
    restored, step = mgr.restore(template, device="cpu")
    assert step == 3
    for a, b in zip(tree_leaves(st), tree_leaves(restored)):
        assert a.dtype == b.dtype and b.device.type == "cpu"
        assert torch.equal(a, b)
    meta = json.loads((tmp_path / "step_00000003" / "meta.json").read_text())
    assert meta["dtypes"]["params/w"] == "bfloat16"
    assert "params/layers/1/s" in meta["keys"]
    assert np.load(tmp_path / "step_00000003" / "arrays.npz")[
        "params__w"].dtype == np.float32


def test_keep_n_and_latest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, async_save=False)
    for s in (1, 5, 9):
        mgr.save(_state(s), s)
    assert mgr.all_steps() == [5, 9]
    assert mgr.latest_step() == 9


def test_async_save_waits(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=True)
    mgr.save(_state(), 1)
    mgr.wait()
    assert mgr.latest_step() == 1


def test_async_save_snapshots_before_in_place_updates(tmp_path):
    """The optimizers write the state in place while an async write is in
    flight: the checkpoint holds the values at ``save``, not later ones.
    The writer thread is held until the tree has been changed."""
    import threading
    mgr = CheckpointManager(tmp_path, async_save=True)
    st = _state()
    want = [t.clone() for t in tree_leaves(st)]
    gate = threading.Event()
    mgr._pool.submit(gate.wait)          # the write queues behind this
    mgr.save(st, 1)
    with torch.no_grad():
        for t in tree_leaves(st):
            t.add_(1)
    gate.set()
    mgr.wait()
    restored, step = mgr.restore(_state(5))
    assert step == 1
    for a, b in zip(want, tree_leaves(restored)):
        assert torch.equal(a, b)


def test_no_partial_checkpoint_visible(tmp_path):
    """tmp dirs never count as checkpoints (atomicity)."""
    mgr = CheckpointManager(tmp_path, async_save=False)
    (tmp_path / ".tmp_step_00000007").mkdir()
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(_state())


def test_restores_a_checkpoint_the_reference_wrote(tmp_path):
    """The reference saves its training state (stacked layers, bf16
    weights, AdamW moments); the port restores it into the trees
    ``from_reference`` and ``opt_state_from_reference`` build, bit for
    bit."""
    arch = "qwen2_0_5b"
    rp = RefModel(ref_reduced(arch)).init(jax.random.PRNGKey(0))
    ropt = RefAdamW()
    rstate = {"params": rp, "opt": ropt.init(rp)}
    rng = np.random.default_rng(0)
    rstate["opt"]["m"] = jax.tree.map(lambda x: rng.standard_normal(
        x.shape).astype(np.float32), rstate["opt"]["m"])
    RefManager(tmp_path, async_save=False).save(rstate, 11)
    cfg = get_reduced(arch)
    to_np = lambda t: jax.tree.map(np.asarray, t)   # noqa: E731
    want = {"params": from_reference(to_np(rp), cfg),
            "opt": opt_state_from_reference(to_np(rstate["opt"]), cfg)}
    model = Model(cfg, device="cpu")
    template = {"params": model.abstract_params()}
    template["opt"] = AdamW().init(template["params"])
    got, step = CheckpointManager(tmp_path).restore(template, device="cpu")
    assert step == 11
    got, want = dict(_flatten(got)), dict(_flatten(want))
    assert got.keys() == want.keys()
    for k, a in got.items():
        assert a.dtype == want[k].dtype and torch.equal(a, want[k]), k
