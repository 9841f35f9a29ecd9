"""Training of the dense and vlm families in the port against the
reference, on the CPU, with the reference's bf16 weights bridged in
(``from_reference``): qwen2-0.5b, internvl2-2b (from embeddings),
chatglm3-6b, granite-20b and qwen1.5-32b, reduced.

- The loss against the reference's jitted ``Model.loss``: relative
  difference <= 1e-3 (the logits, which the serving tests hold at 1e-2,
  enter the loss through a mean of log-softmax values).
- Each gradient leaf against ``jax.grad`` of the reference's loss:
  relative L2 error <= 5e-2.  The gradients are bf16, as in the
  reference, and each backward product and elementwise op rounds to bf16
  where XLA's fused computation keeps some values in fp32: about 1% per
  leaf at two layers, where a wrong term (a missing product, a factor
  of 2) is off by 50% or more.
- The streaming GEMM's autograd Function on the CPU (the same backward
  formulas the card runs, on the plain version) against autograd of
  ``ref.gemm_ref`` in fp32: equal within fp32 rounding.
- ``chunked_ce_loss`` at a T that ``ce_chunk`` does not divide, with
  ``-1`` labels and a padded vocabulary, against the reference's and
  against the whole-logit cross-entropy.
- ``remat="full"`` against ``"none"``: the same loss and gradients, bit
  for bit (the recomputation repeats the same CPU ops).
- The families whose training is not ported raise, naming the ROADMAP
  (the MoE family trains: ``tests/test_torch_train_moe.py``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as ref_reduced  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch.steps import loss_and_grads  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models import tuning as TU  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import from_reference, to_torch  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402

ARCHS = ["qwen2_0_5b", "internvl2_2b", "chatglm3_6b", "granite_20b",
         "qwen1_5_32b"]
LOSS_RTOL = 1e-3
GRAD_REL_L2 = 5e-2
B, S = 2, 40



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the reduced models' ops are tiny, and on a
    shared host several threads each spin for far longer than the op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _batch(cfg, seed=0):
    """Seeded numpy inputs: token ids (or bf16-representable embeddings
    for a vlm config) and labels with some ``-1``."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[0, :5] = -1
    if cfg.embedding_inputs:
        emb = (rng.standard_normal((B, S, cfg.d_model)) * 0.02)
        emb = np.asarray(jnp.asarray(emb, jnp.bfloat16), np.float32)
        return {"embeddings": emb, "labels": labels}
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)
                                   ).astype(np.int32), "labels": labels}


def _torch_batch(batch):
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    if "embeddings" in out:
        out["embeddings"] = out["embeddings"].to(torch.bfloat16)
    return out


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    """(port cfg, port params, batch, reference loss, reference grads in
    the port's tree)."""
    rm = RefModel(ref_reduced(request.param), remat="none")
    rp = rm.init(jax.random.PRNGKey(0))
    cfg = get_reduced(request.param)
    batch = _batch(cfg)
    (loss, _), g = jax.jit(jax.value_and_grad(rm.loss, has_aux=True))(
        rp, {k: jnp.asarray(v) for k, v in batch.items()})
    return (cfg, from_reference(jax.tree.map(np.asarray, rp), cfg), batch,
            float(loss), from_reference(jax.tree.map(np.asarray, g), cfg))


def _port(cfg, params, batch, remat="none"):
    return loss_and_grads(Model(cfg, device="cpu", remat=remat), params,
                          _torch_batch(batch))


def test_loss_matches_reference(case):
    cfg, params, batch, want, _ = case
    (loss, metrics), _ = _port(cfg, params, batch)
    assert loss.dtype == torch.float32 and set(metrics) == {"ce", "aux"}
    assert float(metrics["aux"]) == 0.0
    assert abs(float(loss) - want) <= LOSS_RTOL * abs(want), \
        (float(loss), want)


def test_every_gradient_leaf_matches_reference(case):
    cfg, params, batch, _, want = case
    _, grads = _port(cfg, params, batch)
    got, ref_g = tree_leaves(grads), tree_leaves(want)
    assert len(got) == len(ref_g)
    for g, w in zip(got, ref_g):
        assert g.shape == w.shape and g.dtype == w.dtype
        if not w.float().norm():    # a vlm's unused embedding table
            assert not g.float().norm()
            continue
        err = float((g.float() - w.float()).norm() / w.float().norm())
        assert err <= GRAD_REL_L2, err


def test_remat_full_equals_none(case):
    cfg, params, batch, _, _ = case
    (l0, _), g0 = _port(cfg, params, batch, "none")
    (l1, _), g1 = _port(cfg, params, batch, "full")
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(g0), tree_leaves(g1)))


@pytest.mark.parametrize("tied", [False, True])
def test_gemm_function_backward_matches_autograd_of_plain_version(tied):
    """``ops.streaming_gemm`` differentiated on the CPU (dA = dC·Bᵀ, dB =
    Aᵀ·dC, or dBᵀ = dCᵀ·A for a K-contiguous B) against autograd of
    ``ref.gemm_ref`` on the same fp32 operands."""
    rng = np.random.default_rng(int(tied))
    a = torch.from_numpy(rng.standard_normal((24, 40), np.float32))
    w = torch.from_numpy(rng.standard_normal((56, 40) if tied else (40, 56),
                                             np.float32))
    dc = torch.from_numpy(rng.standard_normal((24, 56), np.float32))
    got, want = [], []
    for fn, out in ((ops.streaming_gemm, got), (ref.gemm_ref, want)):
        a_, w_ = a.clone().requires_grad_(), w.clone().requires_grad_()
        c = fn(a_, w_.t() if tied else w_)
        out.extend(torch.autograd.grad(c, (a_, w_), dc))
    for g, w_ in zip(got, want):
        assert g.shape == w_.shape
        torch.testing.assert_close(g, w_, rtol=1e-5, atol=1e-5)
    assert ops.GEMM_BWD["launches"] == 0      # CPU: no launches


def test_chunked_ce_ragged_chunks_ignored_labels_padded_vocab():
    """T = 37 in chunks of 16 (the last one 5 positions), a vocabulary of
    250 padded to 256, labels -1 at several places: equal to the
    reference's ``chunked_ce_loss`` (which pads the last chunk) and to the
    cross-entropy of the whole (B, T, V) logits with the padding masked."""
    rcfg = dataclasses.replace(ref_reduced("qwen2_0_5b"), vocab_size=250)
    cfg = dataclasses.replace(get_reduced("qwen2_0_5b"), vocab_size=250)
    assert cfg.padded_vocab == 256
    rp = RefModel(rcfg).init(jax.random.PRNGKey(1))
    params = from_reference(jax.tree.map(np.asarray, rp), cfg)
    rng = np.random.default_rng(3)
    h = np.asarray(jnp.asarray(rng.standard_normal((2, 37, cfg.d_model)),
                               jnp.bfloat16))
    labels = rng.integers(0, 250, (2, 37)).astype(np.int32)
    labels[0, ::3] = -1
    labels[1, 30:] = -1
    want = float(RT.chunked_ce_loss(rp, rcfg, jnp.asarray(h),
                                    jnp.asarray(labels), t_chunk=16))
    th, tl = to_torch(h), torch.from_numpy(labels)
    with TU.tuning_context(TU.Tuning(ce_chunk=16)):
        got = T.chunked_ce_loss(params, cfg, th, tl)
    assert abs(float(got) - want) <= 1e-5 * abs(want), (float(got), want)
    logits = T.lm_head(params, cfg, th.reshape(-1, cfg.d_model)).float()
    logits[:, 250:] = -1e30
    whole = torch.nn.functional.cross_entropy(
        logits, tl.reshape(-1).long(), ignore_index=-1)
    torch.testing.assert_close(got, whole, rtol=1e-5, atol=0)


@pytest.mark.parametrize("arch", ["qwen2_moe_a2_7b", "rwkv6_7b",
                                  "zamba2_7b", "whisper_tiny",
                                  "deepseek_v3_671b"])
def test_untrained_families_raise_naming_the_roadmap(arch):
    """``forward_train`` raises for the families it does not train yet;
    qwen2-moe trains (``tests/test_torch_train_moe.py``), and every
    config's ``mtp_loss`` raises."""
    cfg = get_reduced(arch)
    params = Model(cfg, device="cpu").abstract_params()
    if arch != "qwen2_moe_a2_7b":
        with pytest.raises(NotImplementedError,
                           match="ROADMAP Queue A item 13b"):
            T.forward_train(params, cfg, {"tokens": torch.zeros(
                (1, 4), dtype=torch.int32)})
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item 13b"):
        T.mtp_loss(params, cfg, None, {})


def test_remat_dots_raises_naming_the_roadmap():
    cfg = get_reduced("qwen2_0_5b")
    params = Model(cfg, device="cpu").abstract_params()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.forward_train(params, cfg, {"tokens": torch.zeros(
            (1, 4), dtype=torch.int32)}, remat="dots")


@pytest.mark.parametrize("arch", ["qwen2_0_5b", "internvl2_2b",
                                  "whisper_tiny"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_input_specs_and_concrete_batch_match_reference(arch, kind):
    """``input_specs`` gives the reference's keys, shapes and dtypes as
    ``meta`` tensors; ``make_concrete_batch`` fills them (ids within the
    vocabulary) on the device asked for, at a batch and seq of its own."""
    from repro.configs.base import ShapeConfig as RefShape
    from repro.models.model import input_specs as ref_specs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.model import input_specs, make_concrete_batch
    cfg = get_reduced(arch)
    want = ref_specs(ref_reduced(arch), RefShape("s", kind, 64, 4))
    got = input_specs(cfg, ShapeConfig("s", kind, 64, 4))
    assert got.keys() == want.keys()
    for k, v in got.items():
        assert v.device.type == "meta"
        assert tuple(v.shape) == tuple(want[k].shape)
        assert str(v.dtype).replace("torch.", "") == str(want[k].dtype)
    batch = make_concrete_batch(cfg, ShapeConfig("s", kind, 64, 4),
                                batch=2, seq=16, device="cpu")
    small = input_specs(cfg, ShapeConfig("s", kind, 16, 2))
    for k, v in batch.items():
        assert v.device.type == "cpu" and v.shape == small[k].shape
        if not v.dtype.is_floating_point:
            assert 0 <= int(v.min()) and int(v.max()) < cfg.vocab_size
