"""The CUDA kernels against their plain versions on the card.

These tests need an NVIDIA card (``-m cuda``) and skip without one.  They
import no JAX, so they run on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Cases are those of ``tests/test_kernels.py`` (the ragged GEMM included)
plus G = 7 paged attention and ``lens = 0``; then the bf16 kernels'
own cases: the split-K GEMM at decode widths (M in {1, 5, 8, 16}), N =
128, K not a multiple of splits x 64, a K-contiguous B as the lm_head's
``embed.T``, bitwise-equal repeated runs and one launch per call; the
tensor-core flash kernel at ragged Tq/Tk, D in {16, 128} and G = 7; the
cluster-split paged kernel at every split S = 1..8 with edge lengths,
at the main path's shape, bitwise repeatable and one launch per call.
Tolerances: int8 exact; fp32 GEMM 2e-4 and fp32 attention 3e-5 (fp32
sums in another order, no TF32); bf16 2e-2 (one bf16 ulp of the
outputs).
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402

GEMM_SHAPES = [(64, 128, 128), (100, 200, 300), (256, 256, 512),
               (33, 257, 129), (8, 896, 896)]
FLASH_CASES = [(128, 128, 4, 2, 32, True), (128, 128, 4, 2, 32, False),
               (64, 256, 8, 8, 64, True), (96, 96, 6, 1, 16, True),
               (96, 96, 6, 1, 16, False), (100, 100, 14, 2, 128, True)]
PAGED_CASES = [(3, 8, 2, 32, 16, 4), (2, 4, 4, 64, 8, 6),
               (1, 16, 1, 16, 32, 2), (3, 14, 2, 64, 16, 5)]   # G = 7
# (M, N, K): decode widths, N = 128, and K = 4824 (76 k-tiles of 64 minus
# a partial one) split 8 ways, so no split is a whole multiple of 64 x 8
SPLITK_SHAPES = [(1, 896, 896), (5, 128, 896), (8, 896, 4824),
                 (16, 4864, 896), (8, 896, 4864), (16, 128, 200)]
# (Tq, Tk, H, KH, D, causal)
FLASH_BF16_CASES = [(100, 96, 14, 2, 64, True), (100, 96, 14, 2, 64, False),
                    (96, 100, 7, 1, 16, True), (100, 96, 14, 2, 128, True),
                    (257, 257, 14, 2, 64, True), (64, 64, 4, 4, 32, True)]
SG = importlib.import_module("repro_torch.kernels.streaming_gemm")
PA = importlib.import_module("repro_torch.kernels.paged_attention")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels are CUDA C++")
    return torch.device("cuda")


def _bf16(rng, shape, dev, scale=1.0):
    x = rng.standard_normal(shape, np.float32) * scale
    return torch.from_numpy(x).to(dev, torch.bfloat16)


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_cuda_kernels_match_plain_versions(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels are CUDA C++")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    tol = {"float32": 2e-4, "bfloat16": 2e-2, "int8": 0}[dtype]
    for m, n, k in GEMM_SHAPES:
        if dtype == "int8":
            a = torch.from_numpy(rng.integers(-127, 127, (m, k))
                                 .astype(np.int8)).to(dev)
            b = torch.from_numpy(rng.integers(-127, 127, (k, n))
                                 .astype(np.int8)).to(dev)
        else:
            dt = getattr(torch, dtype)
            a = torch.from_numpy(rng.standard_normal((m, k), np.float32)
                                 ).to(dev, dt)
            b = torch.from_numpy(rng.standard_normal((k, n), np.float32)
                                 ).to(dev, dt)
        for bb in (b, b.t().contiguous().t()):
            got, want = ops.streaming_gemm(a, bb), ref.gemm_ref(a, bb)
            np.testing.assert_allclose(got.cpu().float().numpy(),
                                       want.cpu().float().numpy(),
                                       rtol=tol, atol=tol)
    if dtype == "int8":
        return
    dt = getattr(torch, dtype)
    att_tol = 3e-5 if dtype == "float32" else 2e-2
    for tq, tk, h, kh, d, causal in FLASH_CASES:
        q = torch.from_numpy(rng.standard_normal((2, tq, h, d), np.float32))
        k = torch.from_numpy(rng.standard_normal((2, tk, kh, d), np.float32))
        v = torch.from_numpy(rng.standard_normal((2, tk, kh, d), np.float32))
        q, k, v = (t.to(dev, dt) for t in (q, k, v))
        got = ops.flash_attention(q, k, v, causal=causal)
        want = ops.flash_attention(q.cpu(), k.cpu(), v.cpu(), causal=causal)
        np.testing.assert_allclose(got.cpu().float().numpy(),
                                   want.float().numpy(), rtol=att_tol,
                                   atol=att_tol)
    for case in PAGED_CASES:
        for lens in (None, [0] * case[0]):
            args = _paged_inputs(*case, lens=lens)
            cpu = [torch.from_numpy(a) for a in args]
            cpu[:3] = [t.to(dt) for t in cpu[:3]]
            got = ops.paged_attention(*(t.to(dev) for t in cpu))
            want = ops.paged_attention(*cpu)
            np.testing.assert_allclose(got.cpu().float().numpy(),
                                       want.float().numpy(), rtol=att_tol,
                                       atol=att_tol)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", SPLITK_SHAPES)
def test_cuda_splitk_gemm_matches_plain_version(m, n, k):
    dev = _card()
    rng = np.random.default_rng(m * 7 + n + k)
    a = _bf16(rng, (m, k), dev)
    w = _bf16(rng, (k, n), dev, scale=k ** -0.5)
    emb = _bf16(rng, (n, k), dev, scale=k ** -0.5)    # B = emb.T in place
    for b in (w, emb.t()):
        got, want = ops.streaming_gemm(a, b), ref.gemm_ref(a, b)
        np.testing.assert_allclose(got.cpu().float().numpy(),
                                   want.cpu().float().numpy(),
                                   rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
def test_cuda_splitk_gemm_is_deterministic_and_one_launch():
    """The cluster sums its partials in a fixed rank order with no
    atomics: repeated runs give the same bits.  Each call is one kernel
    launch (no second reduction pass)."""
    from torch.profiler import ProfilerActivity, profile
    dev = _card()
    rng = np.random.default_rng(3)
    a = _bf16(rng, (8, 4864), dev)
    b = _bf16(rng, (4864, 896), dev, scale=4864 ** -0.5)
    assert SG.plan(8, 896, 4864)[3] > 1
    first = ops.streaming_gemm(a, b)
    for _ in range(5):
        assert torch.equal(ops.streaming_gemm(a, b), first)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            ops.streaming_gemm(a, b)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    gemm = [n for n in names if "gemm_bf16" in n]
    assert len(gemm) == 3, names


@pytest.mark.cuda
@pytest.mark.parametrize("tq,tk,h,kh,d,causal", FLASH_BF16_CASES)
def test_cuda_tensor_core_flash_matches_plain_version(tq, tk, h, kh, d,
                                                       causal):
    dev = _card()
    rng = np.random.default_rng(tq + tk + d)
    q = _bf16(rng, (2, tq, h, d), dev)
    k = _bf16(rng, (2, tk, kh, d), dev)
    v = _bf16(rng, (2, tk, kh, d), dev)
    got = ops.flash_attention(q, k, v, causal=causal)
    want = ref.flash_gqa_ref(q, k, v, causal)
    np.testing.assert_allclose(got.cpu().float().numpy(),
                               want.cpu().float().numpy(), rtol=2e-2,
                               atol=2e-2)


# (H, KH, D, page, max_pages): the main path's G = 7 at D 64, G = 4 at
# page 8, G = 16 at D 128 (G·D = 2048, fp32 ring of 32-token pages), and
# bf16 D 16 at page 8 (8-byte K slices)
PAGED_SPLIT_SHAPES = [(14, 2, 64, 16, 8), (8, 2, 32, 8, 12),
                      (16, 1, 128, 32, 6), (4, 4, 16, 8, 7)]


def _paged_card(shape, lens, dtype, dev, seed=0):
    h, kh, d, page, mp = shape
    args = _paged_inputs(len(lens), h, kh, d, page, mp, seed=seed,
                         lens=lens)
    cpu = [torch.from_numpy(a) for a in args]
    cpu[:3] = [t.to(dtype) for t in cpu[:3]]
    return [t.to(dev) for t in cpu]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("splits", range(1, 9))
def test_cuda_paged_every_split_at_edge_lengths(splits, dtype, monkeypatch):
    """Every cluster size S = 1..8, forced through ``plan``, on one batch
    whose lengths are 0, 1, page - 1, page, page + 1 and the full table:
    ranks with no page, a rank with a partial page, more ranks than
    pages.  fp32 within 3e-5, bf16 within 2e-2 of the plain version."""
    dev = _card()
    monkeypatch.setattr(PA, "plan", lambda *_: splits)
    dt = getattr(torch, dtype)
    tol = 3e-5 if dtype == "float32" else 2e-2
    for shape in PAGED_SPLIT_SHAPES:
        page, mp = shape[3], shape[4]
        lens = [0, 1, page - 1, page, page + 1, page * mp]
        args = _paged_card(shape, lens, dt, dev, seed=splits)
        got = ops.paged_attention(*args)
        want = ref.paged_ref(*args)
        np.testing.assert_allclose(got.cpu().float().numpy(),
                                   want.cpu().float().numpy(), rtol=tol,
                                   atol=tol, err_msg=str(shape))
        assert not got[0].float().abs().max().item()


@pytest.mark.cuda
def test_cuda_paged_main_path_shape():
    """B 8, H 14 / KH 2 (G = 7), D 64, 16-token pages, a 64-page table,
    at the plan the wrapper picks, for ragged lengths and for the decode
    profile's 272 tokens."""
    dev = _card()
    assert PA.plan(8, 2, 64) == 8
    rng = np.random.default_rng(5)
    for lens in (rng.integers(1, 1025, 8), [272] * 8, [1024] * 8):
        args = _paged_card((14, 2, 64, 16, 64), list(lens), torch.bfloat16,
                           dev)
        np.testing.assert_allclose(
            ops.paged_attention(*args).cpu().float().numpy(),
            ref.paged_ref(*args).cpu().float().numpy(), rtol=2e-2,
            atol=2e-2)


@pytest.mark.cuda
def test_cuda_paged_is_deterministic_and_one_launch():
    """The warps' and the cluster's states merge in a fixed order with
    no atomics: repeated runs give the same bits.  Each call is one
    kernel launch (no second reduction pass)."""
    from torch.profiler import ProfilerActivity, profile
    dev = _card()
    args = _paged_card((14, 2, 64, 16, 64), [1024, 700, 272, 1, 0, 16, 17,
                                             555], torch.bfloat16, dev)
    first = ops.paged_attention(*args)
    for _ in range(5):
        assert torch.equal(ops.paged_attention(*args), first)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            ops.paged_attention(*args)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len([n for n in names if "paged_fwd" in n]) == 3, names


@pytest.mark.cuda
def test_cuda_paged_shared_memory_estimate_matches_the_kernel():
    """The wrapper's shared-memory check computes what the kernel
    launches with."""
    import ctypes
    from repro_torch.kernels import _build
    _card()
    fn = _build.function("paged_attention", "pa_smem_bytes",
                         [ctypes.c_int] * 6)
    for case in ((7, 64, 16, 64, 4, 2), (16, 128, 32, 6, 2, 4),
                 (128, 16, 8, 1000, 4, 2)):
        assert fn(*case) == PA.smem_bytes(*case)
