"""The port's optimizers, gradient compression and synthetic corpus
against the reference's, on the CPU.

- ``cosine_schedule``: equal within fp32 rounding (rtol 1e-6) at every
  step of warm-up, decay and beyond.
- One AdamW and one Adafactor update of the reduced qwen2-0.5b's bf16
  weights from the same fp32 gradients and the same state (the
  reference's after one step, bridged by ``opt_state_from_reference``):
  every new bf16 parameter within one bf16 ulp at the parameter's scale
  before the update (|Δ| <= 2^-7 max(|p|, |p'|): an update that cancels
  a parameter to near 0 differs there by fp32 rounding only) and every
  fp32 one (the norm scales) within 2^-20 of it, every
  moment within 1e-6 relative, the clipped global norm within 1e-6.
- The reference's optimizer tests mirrored: convergence on a quadratic,
  Adafactor's factored state.
- ``compress`` / ``decompress``: int8 codes bit for bit, scales and
  error feedback within fp32 rounding, over the layer stacks' per-stack
  scales; the reference's compression tests mirrored.
- ``SyntheticCorpus.batch(step)``: bit for bit the reference's, for
  several steps and seeds; ``DeviceLoader`` yields them in order from
  its start step.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as ref_reduced  # noqa: E402
from repro.data.pipeline import DataConfig as RefDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticCorpus as RefCorpus  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro.optim import Adafactor as RefAdafactor  # noqa: E402
from repro.optim import AdamW as RefAdamW  # noqa: E402
from repro.optim import cosine_schedule as ref_cosine  # noqa: E402
from repro.runtime import compression as RGC  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.data.pipeline import (DataConfig, DeviceLoader,  # noqa: E402
                                       SyntheticCorpus)
from repro_torch.models.params import (from_reference,  # noqa: E402
                                       opt_state_from_reference, tree_map)
from repro_torch.optim import (Adafactor, AdamW,  # noqa: E402
                               cosine_schedule, get_optimizer)
from repro_torch.models.params import tree_leaves  # noqa: E402
from repro_torch.runtime import compression as GC  # noqa: E402

ARCH = "qwen2_0_5b"


def test_cosine_schedule_equals_reference():
    for base, warm, total in ((3e-3, 10, 100), (0.3, 5, 60), (1e-4, 0, 7)):
        ref, got = ref_cosine(base, warm, total), cosine_schedule(base, warm,
                                                                  total)
        steps = np.arange(0, total + 20)
        want = np.array([float(ref(s)) for s in steps], np.float32)
        have = np.array([float(got(s)) for s in steps], np.float32)
        # fp32 rounding; the cosine's cancellation near its end in
        # absolute terms of the base rate
        np.testing.assert_allclose(have, want, rtol=1e-6, atol=1e-7 * base)
        t = got(torch.tensor(3, dtype=torch.int32))
        assert t.dtype == torch.float32 and t.shape == ()


@pytest.fixture(scope="module")
def weights_and_grads():
    rp = RefModel(ref_reduced(ARCH)).init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    g = jax.tree.map(lambda x: jnp.asarray(
        rng.standard_normal(x.shape).astype(np.float32) * 0.05), rp)
    return rp, g


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_one_update_matches_reference(weights_and_grads, name):
    cfg = get_reduced(ARCH)
    rp, g = weights_and_grads
    ropt = {"adamw": RefAdamW(), "adafactor": RefAdafactor()}[name]
    st0 = ropt.init(rp)
    p1, st1, _ = ropt.update(g, st0, rp, 0.01)      # a state with history
    p2, st2, m2 = ropt.update(g, st1, p1, 0.01)
    to_np = lambda t: jax.tree.map(np.asarray, t)   # noqa: E731
    params = from_reference(to_np(p1), cfg)
    state = opt_state_from_reference(to_np(st1), cfg)
    before = [p.clone() for p in tree_leaves(params)]
    new_p, new_st, met = get_optimizer(name).update(
        from_reference(to_np(g), cfg), state, params,
        torch.tensor(0.01, dtype=torch.float32))
    assert new_p is params                          # updated in place
    assert abs(float(met["grad_norm"]) - float(m2["grad_norm"])) <= \
        1e-6 * float(m2["grad_norm"])
    want_p = tree_leaves(from_reference(to_np(p2), cfg))
    for old, got, want in zip(before, tree_leaves(new_p), want_p):
        assert got.dtype == want.dtype
        ulp = 2.0 ** -7 if got.dtype == torch.bfloat16 else 2.0 ** -20
        lim = ulp * torch.maximum(old.float().abs(), want.float().abs())
        assert bool(((got.float() - want.float()).abs() <= lim).all())
    want_st = opt_state_from_reference(to_np(st2), cfg)
    assert int(new_st["step"]) == int(st2["step"]) == 2
    got_m, want_m = tree_leaves(new_st), tree_leaves(want_st)
    assert len(got_m) == len(want_m)
    for a, b in zip(got_m, want_m):
        assert a.shape == b.shape and a.dtype == b.dtype
        if a.dtype == torch.float32:
            assert bool(((a - b).abs() <= 1e-6 * b.abs() + 1e-30).all())


def _quad_losses(opt, steps=60):
    target = torch.from_numpy(
        np.random.default_rng(0).standard_normal((8, 8)).astype(np.float32))
    params = {"w": torch.zeros((8, 8), dtype=torch.float32)}
    state = opt.init(params)
    lr = cosine_schedule(0.3, 5, steps)
    losses = []
    for s in range(steps):
        grads = {"w": 2 * (params["w"] - target)}
        params, state, _ = opt.update(grads, state, params, lr(s))
        losses.append(float(((params["w"] - target) ** 2).mean()))
    return losses


def test_adamw_converges_quadratic():
    losses = _quad_losses(AdamW(weight_decay=0.0))
    assert losses[-1] < 0.05 * losses[0]


def test_adafactor_converges_quadratic():
    losses = _quad_losses(Adafactor())
    assert losses[-1] < 0.1 * losses[0]


def test_adafactor_state_is_factored():
    st = Adafactor().init({"w": torch.zeros((64, 128))})
    slots = st["slots"]["w"]
    assert slots["vr"].shape == (64,) and slots["vc"].shape == (128,)


def test_adafactor_slots_are_the_references_stacked_slots():
    """Each layer stack's slots have the reference's stacked shapes: the
    per-layer norm scales (d,) of L layers factor as the reference's
    (L, d) leaf does."""
    cfg = get_reduced(ARCH)
    rp = RefModel(ref_reduced(ARCH)).init(jax.random.PRNGKey(0))
    want = jax.tree.map(lambda x: x.shape, RefAdafactor().init(rp)["slots"])
    params = from_reference(jax.tree.map(np.asarray, rp), cfg)
    got = Adafactor().init(params)["slots"]
    flat_w = jax.tree.leaves(want, is_leaf=lambda x: isinstance(x, tuple))
    assert sorted(tuple(t.shape) for t in tree_leaves(got)) == \
        sorted(tuple(s) for s in flat_w)
    assert tuple(got["layers"]["ln1"]["scale"]["vr"].shape) == \
        (cfg.n_layers,)


def test_compression_codes_equal_reference(weights_and_grads):
    cfg = get_reduced(ARCH)
    _, g = weights_and_grads
    rng = np.random.default_rng(4)
    ef = jax.tree.map(lambda x: jnp.asarray(
        rng.standard_normal(x.shape).astype(np.float32) * 1e-3), g)
    qs, scales, new_ef = RGC.compress(g, ef)
    to_np = lambda t: jax.tree.map(np.asarray, t)   # noqa: E731
    pq, ps, pef = GC.compress(from_reference(to_np(g), cfg),
                              from_reference(to_np(ef), cfg))
    for a, b in zip(tree_leaves(pq), tree_leaves(from_reference(
            to_np(qs), cfg))):
        assert a.dtype == torch.int8 and torch.equal(a, b)
    for a, b in zip(tree_leaves(pef), tree_leaves(from_reference(
            to_np(new_ef), cfg))):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)
    ref_scales = [float(s) for s in jax.tree.leaves(scales)]
    assert len(tree_leaves(ps)) == len(ref_scales)
    np.testing.assert_allclose(sorted(float(s) for s in tree_leaves(ps)),
                               sorted(ref_scales), rtol=1e-7)
    deq = GC.decompress(pq, ps)
    want = from_reference(to_np(RGC.decompress(qs, scales)), cfg)
    for a, b in zip(tree_leaves(deq), tree_leaves(want)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0)


def test_error_feedback_is_unbiased_over_time():
    """Accumulated dequantized grads converge to accumulated true grads."""
    rng = np.random.default_rng(0)
    g = {"w": torch.full((32, 32), 0.001) + torch.from_numpy(
        rng.standard_normal((32, 32)).astype(np.float32)) * 1e-5}
    ef = GC.init_ef(g)
    total = torch.zeros((32, 32))
    n = 50
    for _ in range(n):
        dq, ef = GC.apply_compression(g, ef)
        total = total + dq["w"]
    np.testing.assert_allclose((total / n).numpy(), g["w"].numpy(),
                               rtol=0.02, atol=1e-5)


def test_quantization_error_bounded():
    x = {"w": torch.from_numpy(np.random.default_rng(1).standard_normal(
        64).astype(np.float32)) * 3}
    qs, scales, _ = GC.compress(x, GC.init_ef(x))
    err = (GC.decompress(qs, scales)["w"] - x["w"]).abs().max()
    assert float(err) <= float(scales["w"]) * 0.5 + 1e-6


@pytest.mark.parametrize("seed", [1234, 7])
def test_corpus_batches_bitwise_equal_reference(seed):
    for vocab, seq, batch in ((256, 64, 4), (151936, 33, 2), (100, 7, 3)):
        ref = RefCorpus(RefDataConfig(vocab_size=vocab, seq_len=seq,
                                      global_batch=batch, seed=seed))
        got = SyntheticCorpus(DataConfig(vocab_size=vocab, seq_len=seq,
                                         global_batch=batch, seed=seed))
        for step in (0, 1, 9, 123):
            a, b = got.batch(step), ref.batch(step)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype == np.int32
                np.testing.assert_array_equal(a[k], b[k])


def test_device_loader_yields_steps_in_order():
    corpus = SyntheticCorpus(DataConfig(vocab_size=100, seq_len=16,
                                        global_batch=2))
    loader = DeviceLoader(corpus, "cpu", start_step=5)
    try:
        for want in (5, 6, 7):
            step, batch = next(loader)
            assert step == want
            assert torch.equal(batch["tokens"], torch.from_numpy(
                corpus.batch(step)["tokens"]))
    finally:
        loader.close()
    assert tree_map(lambda t: t.device.type, batch) == \
        {"tokens": "cpu", "labels": "cpu"}


def test_device_loader_raises_what_its_thread_met():
    class Broken(SyntheticCorpus):
        def batch(self, step):
            raise ValueError(f"no batch {step}")

    loader = DeviceLoader(Broken(DataConfig(vocab_size=10, seq_len=4,
                                            global_batch=1)), "cpu")
    try:
        with pytest.raises(ValueError, match="no batch 0"):
            next(loader)
    finally:
        loader.close()
    assert not loader._thread.is_alive()
