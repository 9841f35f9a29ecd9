"""The port's dense model against the reference on qwen2-0.5b-reduced,
with the reference's bf16 weights bridged into the port.

Both run in bf16 with the same dtype flow (the reference cannot serve
with fp32 weights: its bf16 activations meet them inside ``lax.scan``).
The port runs on the CPU, where the kernel wrappers take their plain
versions, and decodes through the paged cache; the reference decodes
its contiguous cache with XLA attention.

Tolerance: |Δlogit| <= 1e-2 at logits of size <= 0.5.  The gap is bf16
rounding at different places: GEMM outputs rounded after fp32 sums in
another order, and decode probabilities that the reference rounds to
bf16 before PV while the paged path keeps them fp32 (as its Pallas
counterpart does).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as ref_reduced  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import from_reference  # noqa: E402

ATOL = 1e-2
ARCH = "qwen2_0_5b"


@pytest.fixture(scope="module")
def pair():
    rm = RefModel(ref_reduced(ARCH), remat="none")
    rp = rm.init(jax.random.PRNGKey(0))
    cfg = get_reduced(ARCH)
    pp = from_reference(jax.tree.map(np.asarray, rp), cfg)
    return rm, rp, Model(cfg, device="cpu"), pp


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def test_prefill_logits_match_reference(pair):
    rm, rp, pm, pp = pair
    toks = np.random.default_rng(0).integers(1, 250, (2, 12)).astype(
        np.int32)
    _, want = rm.prefill(rp, {"tokens": jnp.asarray(toks)}, 32)
    cache = pm.init_cache(2, 32)
    for s in range(2):
        cache.alloc_seq(s, 12)
    got = pm.prefill(pp, torch.as_tensor(toks, dtype=torch.int64), cache,
                     [0, 1])
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=0)
    assert (_np(got).argmax(-1) == _np(want).argmax(-1)).all()
    assert list(cache.lens[:2]) == [12, 12]


def _ref_batched_cache(rm, rp, prompts, S):
    """The reference engine's splice of single-sequence prefills into
    one batched contiguous cache (serving/engine.py, _admit)."""
    B = len(prompts)
    cache = rm.init_cache(B, S)
    logits = []
    for slot, p in enumerate(prompts):
        one, lg = rm.prefill(rp, {"tokens": jnp.asarray(p[None])}, S)
        cache = jax.tree.map(
            lambda full, o: (full.at[:, slot].set(o[:, 0])
                             if full.ndim >= 2 and full.shape[1] == B
                             else full), cache, one)
        cache["len"] = cache["len"].at[slot].set(one["len"][0])
        logits.append(lg[0])
    return cache, logits


def test_teacher_forced_decode_mixed_lengths_matches_reference(pair):
    """Prefill three sequences of different lengths one by one, then
    four batched decode steps on the same forced tokens; page_tokens=4
    makes the sequences cross page boundaries mid-run."""
    rm, rp, pm, pp = pair
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 250, n).astype(np.int32) for n in (5, 9, 14)]
    forced = rng.integers(1, 250, (4, 3)).astype(np.int32)
    S = 32
    rcache, rlog = _ref_batched_cache(rm, rp, prompts, S)
    cache = pm.init_cache(3, S, page_tokens=4)
    for slot, p in enumerate(prompts):
        cache.alloc_seq(slot, len(p))
        got = pm.prefill(pp, torch.as_tensor(p[None], dtype=torch.int64),
                         cache, [slot])
        np.testing.assert_allclose(_np(got[0]), _np(rlog[slot]),
                                   atol=ATOL, rtol=0)
    for step in range(4):
        rcache, want = rm.decode_step(rp, rcache, jnp.asarray(forced[step]))
        got = pm.decode_step(pp, cache, torch.as_tensor(
            forced[step], dtype=torch.int64), [0, 1, 2])
        np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=0)
    assert list(cache.lens[:3]) == [9, 13, 18]
    cache.validate()


def test_prefill_then_decode_matches_longer_prefill(pair):
    """Port-side mirror of the reference continuity test: prefill(t[:n-1])
    + decode(t[n-1]) == prefill(t) on the paged cache."""
    _, _, pm, pp = pair
    toks = torch.as_tensor(np.random.default_rng(2).integers(1, 250, (2, 17)),
                           dtype=torch.int64)
    cache = pm.init_cache(2, 32, page_tokens=8)
    for s in range(2):
        cache.alloc_seq(s, 17)
    full = pm.prefill(pp, toks, cache, [0, 1])
    cache2 = pm.init_cache(2, 32, page_tokens=8)
    for s in range(2):
        cache2.alloc_seq(s, 16)
    pm.prefill(pp, toks[:, :-1], cache2, [0, 1])
    dec = pm.decode_step(pp, cache2, toks[:, -1], [0, 1])
    np.testing.assert_allclose(_np(dec), _np(full), atol=ATOL, rtol=0)


def test_norm_and_rope_match_reference():
    cfg, rcfg = get_reduced(ARCH), ref_reduced(ARCH)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, 4, 16), np.float32)
    scale = rng.standard_normal((16,), np.float32)
    pos = np.broadcast_to(np.arange(7), (2, 7)).astype(np.int32)
    for dt in ("float32", "bfloat16"):
        jx = jnp.asarray(x, jnp.dtype(dt))
        tx = torch.from_numpy(x).to(getattr(torch, dt))
        want = RL.apply_norm({"scale": jnp.asarray(scale)}, jx, rcfg)
        got = PL.apply_norm({"scale": torch.from_numpy(scale)}, tx, cfg)
        tol = 1e-6 if dt == "float32" else 1e-2
        np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
        want = RL.apply_rope(jx, jnp.asarray(pos), rcfg)
        got = PL.apply_rope(tx, torch.from_numpy(pos), cfg)
        np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_attention_matches_reference(causal):
    """The port's plain chunked/decode attention (fp32, 3e-5) against the
    reference XLA paths, with chunks small enough to stream."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 40, 4, 16), np.float32)
    k = rng.standard_normal((2, 40, 2, 16), np.float32)
    v = rng.standard_normal((2, 40, 2, 16), np.float32)
    want = RL.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, q_chunk=16,
                                kv_chunk=8)
    got = PL.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=causal,
                               q_chunk=16, kv_chunk=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5,
                               rtol=3e-5)
    lens = np.array([13, 40], np.int32)
    want = RL.decode_attention(jnp.asarray(q[:, 0]), jnp.asarray(k),
                               jnp.asarray(v), jnp.asarray(lens))
    got = PL.decode_attention(torch.from_numpy(q[:, 0]), torch.from_numpy(k),
                              torch.from_numpy(v), torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5,
                               rtol=3e-5)
