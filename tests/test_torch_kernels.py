"""Port kernels against the reference Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; the
reference wrappers run their Pallas kernels in interpret mode.  Both get
the same seeded numpy inputs.  The cases are those of
``tests/test_kernels.py`` plus a ragged/GQA G = 7 paged case and
``lens = 0``.

Tolerances (as in the reference kernel tests): int8 exact (integer
sums); bf16 GEMM 2e-2 (one bf16 ulp of outputs of size ~10 after fp32
sums in another order); fp32 GEMM 2e-4 and attention 3e-5 (fp32 sums in
another order, no TF32).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attention as jax_flash  # noqa: E402
from repro.kernels import paged_attention as jax_paged  # noqa: E402
from repro.kernels import streaming_gemm as jax_gemm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402

GEMM_SHAPES = [(64, 128, 128), (100, 200, 300), (256, 256, 512),
               (33, 257, 129)]
FLASH_CASES = [(128, 128, 4, 2, 32, True), (128, 128, 4, 2, 32, False),
               (64, 256, 8, 8, 64, True), (96, 96, 6, 1, 16, True),
               (96, 96, 6, 1, 16, False)]
PAGED_CASES = [(3, 8, 2, 32, 16, 4), (2, 4, 4, 64, 8, 6),
               (1, 16, 1, 16, 32, 2), (3, 14, 2, 64, 16, 5)]   # G = 7


def _both(x: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor of ``dtype``
    (both round float32 to bf16 to nearest even)."""
    return jnp.asarray(x, jnp.dtype(dtype)), \
        torch.from_numpy(x).to(getattr(torch, dtype))


def _np(t) -> np.ndarray:
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


@pytest.mark.parametrize("m,n,k", GEMM_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemm_matches_reference(m, n, k, dtype):
    rng = np.random.default_rng(0)
    ja, ta = _both(rng.standard_normal((m, k), np.float32), dtype)
    jb, tb = _both(rng.standard_normal((k, n), np.float32), dtype)
    want = jax_gemm(ja, jb, bm=32, bn=128, bk=128, interpret=True)
    got = ops.streaming_gemm(ta, tb)
    assert got.dtype == ta.dtype and got.shape == (m, n)
    tol = 2e-2 if dtype == "bfloat16" else 2e-4
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_gemm_transposed_operand_matches_contiguous():
    """The lm_head reads embed.T as a strided view: same result as a
    contiguous copy."""
    rng = np.random.default_rng(1)
    h = torch.from_numpy(rng.standard_normal((5, 64), np.float32))
    emb = torch.from_numpy(rng.standard_normal((96, 64), np.float32))
    np.testing.assert_array_equal(
        ops.streaming_gemm(h, emb.t()).numpy(),
        ops.streaming_gemm(h, emb.t().contiguous()).numpy())


def test_gemm_int8_exact():
    rng = np.random.default_rng(0)
    a = rng.integers(-127, 127, (64, 256)).astype(np.int8)
    b = rng.integers(-127, 127, (256, 128)).astype(np.int8)
    want = jax_gemm(jnp.asarray(a), jnp.asarray(b), bm=32, bn=128, bk=128,
                    interpret=True)
    got = ops.streaming_gemm(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy().astype(np.int32),
                                  np.asarray(want, np.int32))


@pytest.mark.parametrize("tq,tk,h,kh,d,causal", FLASH_CASES)
def test_flash_matches_reference(tq, tk, h, kh, d, causal):
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, tq, h, d), np.float32)
    k = rng.standard_normal((2, tk, kh, d), np.float32)
    v = rng.standard_normal((2, tk, kh, d), np.float32)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, bq=32, bk=32, interpret=True)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=3e-5, atol=3e-5)


def test_flash_noncausal_padded_tk_raises_like_reference():
    q = torch.zeros((1, 8, 2, 16))
    k = torch.zeros((1, 600, 2, 16))
    with pytest.raises(NotImplementedError):
        ops.flash_attention(q, k, k, causal=False)
    with pytest.raises(NotImplementedError):
        jax_flash(jnp.zeros((1, 8, 2, 16)), jnp.zeros((1, 600, 2, 16)),
                  jnp.zeros((1, 600, 2, 16)), causal=False, interpret=True)


def _paged_inputs(b, h, kh, d, page, mp, seed=0, lens=None):
    rng = np.random.default_rng(seed)
    P = b * mp + 4
    q = rng.standard_normal((b, h, d), np.float32)
    kp = rng.standard_normal((P, page, kh, d), np.float32)
    vp = rng.standard_normal((P, page, kh, d), np.float32)
    table = rng.permutation(P)[:b * mp].reshape(b, mp).astype(np.int32)
    if lens is None:
        lens = rng.integers(1, page * mp, size=(b,))
    return q, kp, vp, table, np.asarray(lens, np.int32)


def _paged_both(args):
    want = jax_paged(*(jnp.asarray(a) for a in args), interpret=True)
    got = ops.paged_attention(*(torch.from_numpy(a) for a in args))
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("b,h,kh,d,page,mp", PAGED_CASES)
def test_paged_matches_reference(b, h, kh, d, page, mp):
    got, want = _paged_both(_paged_inputs(b, h, kh, d, page, mp))
    np.testing.assert_allclose(got, want, rtol=3e-5, atol=3e-5)


def test_paged_zero_length_gives_zeros():
    args = _paged_inputs(3, 8, 2, 32, 16, 4, lens=[0, 17, 0])
    got, want = _paged_both(args)
    np.testing.assert_allclose(got, want, rtol=3e-5, atol=3e-5)
    assert not got[0].any() and not got[2].any()


def test_paged_matches_contiguous_decode():
    """Paged plain version == the port's contiguous decode attention."""
    b, h, kh, d, page, mp = 2, 8, 2, 32, 16, 4
    q, kp, vp, _, _ = _paged_inputs(b, h, kh, d, page, mp)
    table = np.arange(b * mp, dtype=np.int32).reshape(b, mp)
    lens = np.asarray([17, 61], np.int32)
    args = [torch.from_numpy(a) for a in (q, kp, vp, table, lens)]
    paged = ops.paged_attention(*args)
    k = args[1][args[3].long()].reshape(b, mp * page, kh, d)
    v = args[2][args[3].long()].reshape(b, mp * page, kh, d)
    contig = PL.decode_attention(args[0], k, v, args[4])
    np.testing.assert_allclose(paged.numpy(), contig.numpy(),
                               rtol=3e-5, atol=3e-5)


def test_cpu_wrappers_do_not_count_launches():
    ops.reset_launches()
    ops.streaming_gemm(torch.ones((2, 8)), torch.ones((8, 4)))
    assert ops.LAUNCHES == {name: 0 for name in ops.LAUNCHES}
