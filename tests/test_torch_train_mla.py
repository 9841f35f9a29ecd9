"""Training of the MLA family (deepseek-v3, reduced: one dense layer, one
MoE layer of 8 experts, top-2, one shared expert, MLA with q/k 16 + 8
and v 16, latent 16 + 8, and the multi-token-prediction head) in the
port against the reference, on the CPU, with the reference's bf16
weights bridged in (``from_reference``) and seeded numpy batches of
2 x 16 tokens.

- The loss, ce, aux and mtp within 1e-3 relative and every gradient
  leaf within 5e-2 relative L2 of ``jax.value_and_grad`` of the
  reference's loss run op by op (``jax.disable_jit()``), every (layer,
  token) expert set recorded on both sides and equal.
- The reduced config cut to one layer (one dense layer, no MoE layer: a
  stack of length zero, the structure of the card's
  ``deepseek-v3-671b-3l``) against the reference jitted, since a scan of
  length zero fails under ``disable_jit``; the same limits.
- ``mla_train_chunked`` alone against the reference's ``mla_train`` in
  fp32 and bf16 (output and the input's gradient), and ``mtp_loss``
  alone against the reference's.
- ``remat="full"`` against ``"none"``: bit for bit.
- A train step with AdamW and with Adafactor: no derived copy
  (``transformer.DERIVED``) in the gradients, the optimizer state or the
  checkpoint, and the absorbed copies equal to the permuted updated
  ``wuk`` / ``wuv`` bit for bit; each optimizer's update on the MLA tree
  against the reference's.
- A checkpoint round trip, a Trainer that fails and resumes replaying
  the same losses, and the CLI printing the mtp loss.
"""
import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as ref_reduced  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import moe as RMOE  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.models import tuning as RTU  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro.optim import Adafactor as RefAdafactor  # noqa: E402
from repro.optim import AdamW as RefAdamW  # noqa: E402
from repro_torch.checkpoint.checkpoint import (CheckpointManager,  # noqa: E402
                                               _flatten)
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.configs.base import RunConfig, ShapeConfig  # noqa: E402
from repro_torch.configs.deepseek_v3_671b import TRAINING  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.steps import (build_train_step,  # noqa: E402
                                      loss_and_grads)
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models import moe as PMOE  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models import tuning as TU  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import (from_reference,  # noqa: E402
                                       n_elements,
                                       opt_state_from_reference, to_torch,
                                       tree_leaves)
from repro_torch.optim import Adafactor, AdamW, get_optimizer  # noqa: E402
from repro_torch.runtime.train_loop import Trainer, TrainerConfig  # noqa: E402,E501

ARCH = "deepseek_v3_671b"
LOSS_RTOL = 1e-3
GRAD_REL_L2 = 5e-2
B, S = 2, 16
METRICS = ("ce", "aux", "mtp")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the reduced model's ops are tiny, and on a
    shared host several threads each spin for far longer than the op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(layers=None):
    rcfg, cfg = ref_reduced(ARCH), get_reduced(ARCH)
    if layers:
        rcfg = dataclasses.replace(rcfg, n_layers=layers)
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return rcfg, cfg


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[0, :3] = -1
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)
                                   ).astype(np.int32), "labels": labels}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _ref_init(rcfg, seed):
    """The reference's weights, its init jitted (op by op it takes
    seconds a leaf kind)."""
    return jax.jit(RefModel(rcfg).init)(jax.random.PRNGKey(seed))


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


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


def _case(layers):
    rcfg, cfg = _cfgs(layers)
    rm = RefModel(rcfg, remat="none")
    rp = _ref_init(rcfg, 0)
    batch = _batch(cfg)
    params = from_reference(_np_tree(rp), cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    vg = jax.value_and_grad(rm.loss, has_aux=True)
    with _routes() as (ref_routes, port_routes):
        if layers:      # no MoE layer: a scan of length zero needs jit
            (loss, metrics), g = jax.jit(vg)(rp, jbatch)
        else:
            with jax.disable_jit():
                (loss, metrics), g = vg(rp, jbatch)
        got = loss_and_grads(Model(cfg, device="cpu", remat="none"),
                             params, _torch_batch(batch))
    return {"cfg": cfg, "rp": rp, "params": params, "batch": batch,
            "loss": float(loss),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "ref_grads": g, "grads": from_reference(_np_tree(g), cfg),
            "got": got, "ref_routes": ref_routes,
            "port_routes": port_routes}


@pytest.fixture(scope="module", params=[None, 1], ids=["1dense+1moe",
                                                       "1layer"])
def case(request):
    """The reduced model op by op, or cut to its one dense layer and
    jitted: the port's loss and gradients beside the reference's."""
    return _case(request.param)


def test_loss_and_metrics_match_reference(case):
    (loss, metrics), _ = case["got"]
    assert loss.dtype == torch.float32 and set(metrics) == set(METRICS)
    assert set(case["metrics"]) == set(METRICS)
    for k in METRICS:
        want = case["metrics"][k]
        assert abs(float(metrics[k]) - want) <= LOSS_RTOL * abs(want), \
            (k, float(metrics[k]), want)
    n_moe = case["cfg"].n_layers - case["cfg"].moe.first_dense_layers
    assert (float(metrics["aux"]) > 0) == (n_moe > 0)
    assert abs(float(loss) - case["loss"]) <= LOSS_RTOL * abs(case["loss"])
    total = metrics["ce"] + metrics["aux"] + 0.3 * metrics["mtp"]
    assert torch.equal(loss, total)


def test_every_gradient_leaf_matches_reference(case):
    """Every leaf of the reference's tree (the derived copies, which
    ``from_reference`` adds to the reference's gradients, are none of
    them)."""
    _, grads = case["got"]
    want = T.trainable(case["grads"])
    got, ref_g = _flatten(grads), _flatten(want)
    assert [p for p, _ in got] == [p for p, _ in ref_g]
    assert len(got) == len(jax.tree.leaves(case["ref_grads"])) + sum(
        a.shape[0] - 1 for a in _ref_stacked(case["ref_grads"]))
    for (path, g), (_, w) in zip(got, ref_g):
        assert g.shape == w.shape and g.dtype == w.dtype, path
        assert bool(g.float().isfinite().all()), path
        err = float((g.float() - w.float()).norm() / w.float().norm())
        assert err <= GRAD_REL_L2, ("/".join(path), err)


def _ref_stacked(tree):
    """The reference's stacked layer leaves (one per layer in the
    port's tree)."""
    return [a for name in ("dense_layers", "layers") if name in tree
            for a in jax.tree.leaves(tree[name])]


def test_routes_agree(case):
    cfg = case["cfg"]
    n_moe = cfg.n_layers - cfg.moe.first_dense_layers
    assert len(case["ref_routes"]) == len(case["port_routes"]) == n_moe
    for r, p in zip(case["ref_routes"], case["port_routes"]):
        np.testing.assert_array_equal(r, p)


def test_zero_length_moe_stack_in_both_trees():
    """A cut to the dense layers: ``Model.init`` and ``from_reference``
    give the same tree, with an empty ``layers`` list, and every reader
    takes it."""
    rcfg, cfg = _cfgs(1)
    rp = _ref_init(rcfg, 0)
    bridged = from_reference(_np_tree(rp), cfg)
    fresh = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert bridged["layers"] == [] == fresh["layers"]
    assert len(bridged["dense_layers"]) == 1
    assert sorted(p for p, _ in _flatten(bridged)) == \
        sorted(p for p, _ in _flatten(fresh))
    assert sorted(p for p, _ in _flatten(T.trainable(bridged))) == sorted(
        p for p, _ in _flatten(Model(cfg, device="cpu").abstract_params()))
    assert [lp for lp, _ in T.layer_stack(bridged, cfg)] == \
        bridged["dense_layers"]
    for opt in (AdamW(), Adafactor()):
        st = opt.init(T.trainable(bridged))
        assert not tree_leaves(st.get("m", {}).get("layers", []))


@pytest.mark.parametrize("dtype,T_,chunks", [("float32", 24, (16, 8)),
                                             ("bfloat16", S, (512, 1024))])
def test_mla_train_chunked_matches_reference_mla_train(dtype, T_, chunks):
    """Output and the input's gradient of one MLA attention block against
    the reference's ``mla_train``: jitted in fp32 at a T that spans two
    query and three KV chunks; run op by op in bf16 (where XLA's fusion
    would drop the roundings the port makes), in one chunk at the
    model's T, whose primitives the op-by-op model run has compiled."""
    rcfg, cfg = _cfgs()
    rp = _ref_init(rcfg, 1)
    rattn = jax.tree.map(lambda a: a[0].astype(dtype),
                         rp["dense_layers"]["attn"])
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, T_, cfg.d_model)).astype(np.float32)
    ct = rng.standard_normal((B, T_, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T_), (B, T_))

    def ref(x_, ct_):
        out, vjp = jax.vjp(lambda x_: RL.mla_train(
            rattn, x_, rcfg, jnp.asarray(pos))[0], x_)
        return out, vjp(ct_)[0]

    eager = jax.disable_jit() if dtype == "bfloat16" \
        else contextlib.nullcontext()
    with RTU.tuning_context(RTU.Tuning(*chunks)), eager:
        out, dx = (ref if dtype == "bfloat16" else jax.jit(ref))(
            jnp.asarray(x, dtype), jnp.asarray(ct, dtype))
    pattn = _bridge_attn(rattn)
    xt = to_torch(np.asarray(jnp.asarray(x, dtype))).requires_grad_(True)
    with TU.tuning_context(TU.Tuning(*chunks)):
        got = PL.mla_train_chunked(pattn, xt, cfg, torch.as_tensor(pos))
    (gx,) = torch.autograd.grad(got, xt, to_torch(np.asarray(
        jnp.asarray(ct, dtype))))
    tol = 1e-5 if dtype == "float32" else 2e-2
    for g, w in ((got.detach(), out), (gx, dx)):
        w = to_torch(np.asarray(w))
        assert g.dtype == w.dtype
        err = float((g.float() - w.float()).norm() / w.float().norm())
        assert err <= tol, err


def _bridge_attn(rattn):
    return {k: (_bridge_attn(v) if isinstance(v, dict)
                else to_torch(np.asarray(v))) for k, v in rattn.items()}


def test_mtp_loss_matches_reference():
    """``mtp_loss`` alone, on seeded hidden states: the value and the
    hidden states' gradient against the reference's op by op."""
    rcfg, cfg = _cfgs()
    rp = _ref_init(rcfg, 2)
    batch = _batch(cfg, seed=5)
    rng = np.random.default_rng(6)
    h = np.asarray(jnp.asarray(rng.standard_normal(
        (B, S, cfg.d_model)), jnp.bfloat16))
    with jax.disable_jit():
        want, dh = jax.value_and_grad(lambda h_: RT.mtp_loss(
            rp, rcfg, h_, {k: jnp.asarray(v) for k, v in batch.items()}))(
            jnp.asarray(h))
    params = from_reference(_np_tree(rp), cfg)
    ht = to_torch(h).requires_grad_(True)
    got = T.mtp_loss(params, cfg, ht, _torch_batch(batch))
    (gh,) = torch.autograd.grad(got, ht)
    assert abs(float(got) - float(want)) <= LOSS_RTOL * abs(float(want))
    w = to_torch(np.asarray(dh)).float()
    assert float((gh.float() - w).norm() / w.norm()) <= GRAD_REL_L2


def test_mtp_loss_refuses_a_config_without_mtp():
    cfg = get_reduced("qwen2_moe_a2_7b")
    params = Model(cfg, device="cpu").abstract_params()
    with pytest.raises(ValueError, match="no multi-token-prediction head"):
        T.mtp_loss(params, cfg, None, {})


def test_remat_full_equals_none():
    _, cfg = _cfgs()
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    batch = _torch_batch(_batch(cfg, seed=3))
    (l0, m0), g0 = loss_and_grads(Model(cfg, device="cpu", remat="none"),
                                  params, batch)
    (l1, m1), g1 = loss_and_grads(Model(cfg, device="cpu", remat="full"),
                                  params, batch)
    assert torch.equal(l0, l1)
    assert all(torch.equal(m0[k], m1[k]) for k in METRICS)
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(g0), tree_leaves(g1)))


def _derived_paths(tree):
    return [p for p, _ in _flatten(tree) if p[-1] in T.DERIVED]


def _assert_absorbed(params, cfg):
    """Every MLA layer's absorbed copies equal its permuted weights, bit
    for bit (the MTP block has none: decode never runs it)."""
    stack = T.layer_stack(params, cfg)
    assert stack and "wuk_hkr" not in params["mtp"]["block"]["attn"]
    for lp, _ in stack:
        a = lp["attn"]
        assert set(T.DERIVED) <= set(a)
        assert torch.equal(a["wuk_hkr"], a["wuk"].permute(1, 2, 0))
        assert torch.equal(a["wuv_hrv"], a["wuv"].permute(1, 0, 2))


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_train_step_keeps_derived_copies_out_of_the_optimizer(opt):
    _, cfg = _cfgs()
    run = RunConfig(model=cfg, shape=ShapeConfig("train", "train", S, B),
                    remat="none", optimizer=opt)
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(4))
    state = {"params": params,
             "opt": get_optimizer(opt).init(T.trainable(params))}
    assert not _derived_paths(state["opt"])
    before = {k: params["dense_layers"][0]["attn"][k].clone()
              for k in ("wuk", "wuk_hkr")}
    step = build_train_step(run, "cpu", lr_base=1e-2, lr_warmup=1)
    batch = _torch_batch(_batch(cfg, seed=4))
    (want, _), grads = loss_and_grads(Model(cfg, device="cpu",
                                            remat="none"), params, batch)
    assert not _derived_paths(grads)
    for _ in range(2):
        state, metrics = step(state, batch)
    assert torch.equal(metrics["loss"], metrics["loss"]) and \
        set(METRICS) <= set(metrics)
    assert not _derived_paths(state["opt"])
    attn = state["params"]["dense_layers"][0]["attn"]
    assert not torch.equal(attn["wuk"], before["wuk"])
    assert not torch.equal(attn["wuk_hkr"], before["wuk_hkr"])
    _assert_absorbed(state["params"], cfg)


@pytest.fixture(scope="module")
def mla_weights_and_grads():
    rp = _ref_init(ref_reduced(ARCH), 0)
    rng = np.random.default_rng(1)
    g = jax.tree.map(lambda x: jnp.asarray(
        rng.standard_normal(x.shape).astype(np.float32) * 0.05), rp)
    return rp, g


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_update_on_mla_tree_matches_reference(
        mla_weights_and_grads, name):
    """One update from a state with history on the MLA tree (the MTP
    head, the 3-D ``wuq`` / ``wuk`` / ``wuv`` / ``wo``): the parameters
    within one bf16 ulp of the reference's (jitted), the derived copies
    in no state."""
    cfg = get_reduced(ARCH)
    rp, g = mla_weights_and_grads
    ropt = (RefAdamW if name == "adamw" else RefAdafactor)()
    update = jax.jit(ropt.update)
    p1, st1, _ = update(g, ropt.init(rp), rp, 0.01)
    p2, _, m2 = update(g, st1, p1, 0.01)
    params = T.trainable(from_reference(_np_tree(p1), cfg))
    state = opt_state_from_reference(_np_tree(st1), cfg)
    assert not _derived_paths(state)
    before = [p.clone() for p in tree_leaves(params)]
    new_p, _, met = get_optimizer(name).update(
        T.trainable(from_reference(_np_tree(g), cfg)), state, params,
        torch.tensor(0.01, dtype=torch.float32))
    assert abs(float(met["grad_norm"]) - float(m2["grad_norm"])) <= \
        1e-6 * float(m2["grad_norm"])
    want = tree_leaves(T.trainable(from_reference(_np_tree(p2), cfg)))
    assert len(want) == len(before)
    for old, got, w in zip(before, tree_leaves(new_p), want):
        assert got.dtype == w.dtype and got.shape == w.shape
        ulp = 2.0 ** -7 if got.dtype == torch.bfloat16 else 2.0 ** -20
        lim = ulp * torch.maximum(old.float().abs(), w.float().abs())
        assert bool(((got.float() - w.float()).abs() <= lim).all())


def _run(tmp, steps, inject=None, layers=None):
    _, cfg = _cfgs(layers)
    run = RunConfig(model=cfg, shape=ShapeConfig("train", "train", S, B),
                    remat="none")
    tr = Trainer(run, TrainerConfig(ckpt_dir=str(tmp), ckpt_every=2,
                                    seed=5, lr_base=3e-3, lr_warmup=2,
                                    lr_total=20),
                 inject_failure_at=inject, device="cpu")
    return tr, tr.train(steps) if inject is None else None


def test_checkpoint_roundtrip_of_mla_train_state(tmp_path):
    """The MLA train state saved without the derived copies and restored
    into ``abstract_params``' template (and into one that holds them,
    made again from the restored weights), bit for bit; the Trainer's
    log carries the mtp loss."""
    tr, out = _run(tmp_path / "a", 2)
    assert all("mtp" in m for m in tr.metrics_log)
    state, start = tr.restore_or_init()
    assert start == 2
    _assert_absorbed(state["params"], tr.run.model)
    mgr = CheckpointManager(tmp_path / "b", async_save=False)
    mgr.save(state, 7)
    with np.load(tmp_path / "b" / "step_00000007" / "arrays.npz") as data:
        keys = list(data.keys())
    assert keys and not [k for k in keys if k.split("__")[-1] in T.DERIVED]
    for template in (tr._state(tr.model.abstract_params()),
                     tr._state(tr.model.init(torch.Generator()))):
        restored, step = mgr.restore(template, device="cpu")
        assert step == 7
        got, want = _flatten(restored), _flatten(
            state if _derived_paths(template) else T.trainable(state))
        assert [p for p, _ in got] == [p for p, _ in want]
        for (_, a), (_, b) in zip(got, want):
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


def test_cli_trains_deepseek_and_prints_the_mtp_loss(tmp_path, capsys):
    train_cli.main(["--arch", "deepseek-v3-671b", "--reduced", "--device",
                    "cpu", "--steps", "2", "--seq", "16", "--batch", "2",
                    "--ckpt-dir", str(tmp_path / "ckpt")])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[deepseek-v3-reduced] 2 steps on cpu")
    assert ", mtp " in line


def test_training_cut_of_the_full_config():
    """``TRAINING``: the 3 dense layers and the MTP head at full width,
    no MoE layer, ~2,880.8 M values."""
    cfg = get_config(ARCH)
    assert TRAINING.name == "deepseek-v3-671b-3l"
    assert TRAINING.n_layers == TRAINING.moe.first_dense_layers == 3
    assert dataclasses.replace(TRAINING, name=cfg.name, n_layers=61) == cfg
    tree = Model(TRAINING, device="cpu").abstract_params()
    assert tree["layers"] == [] and len(tree["dense_layers"]) == 3
    assert abs(n_elements(tree) / 1e6 - 2880.8) < 0.5
