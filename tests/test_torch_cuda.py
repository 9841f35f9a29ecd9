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
at the main path's shape, bitwise repeatable and one launch per call;
the same for its query-head groups at granite-20b's G·D = 6,144 (48
heads of 128 over one KV head, 3 groups) and at 2 KV heads of 2 groups.
The expert-grouped GEMM of the MoE layers at qwen2-moe-a2.7b's and
deepseek-v3's decode and prefill shapes, the absorbed decode's products
(strided heads) and ragged ones (N and K off the tiles), with counts of
0, C and mid-chunk, bitwise repeatable and one launch per call.
Last, page streaming on the card: the page store's pinned host pages
and device pages, the layer streamer's side-stream fetches (DM and DC
equal DevMem bit for bit through the GEMM kernel), Algorithm 1 on the
card against its CPU run, and a decode-step plan against the paged
kernel.  Then whisper-tiny: non-causal flash at the encoder's 1,500
frames (self- and cross-attention), paged attention over its 94-page
cross table, and its decode step as one device kernel per GEMM and
paged wrapper call.  Then rwkv6-7b at reduced width: prefill of mixed
prompt lengths and decode steps on the card against the same weights on
the CPU (logits and scan states within 5e-2 of their largest magnitude:
bf16 rounding after fp32 sums in another order, through two layers),
through the GEMM kernel alone (9 per layer and the lm_head per step, no
attention kernel).  Then head dim 112 (zamba2-7b's shared attention):
flash at ragged Tq / Tk, causal and full, bf16 and fp32; paged at every
split S with edge lengths at 8-, 16- and 32-token pages, fp32 and bf16,
its shared-memory estimate, and its decode shape bitwise repeatable
and one launch per call; and the reduced zamba2 on the card against
the CPU.  Then the INT8 KV cache: the int8 kernel (``paged_int8_fwd``)
at every split S and ring depth with edge lengths (lens 0 included) at
D 16, 32, 64 and 128, at every heads tier (1, 2, 4, 8) and in head
groups, its decode shapes bitwise repeatable and one launch per call,
its shared-memory estimate; its fused append at every split, the codes
and scales it writes bit for bit equal to the quantize kernel's and the
plain version's; the quantize-and-append kernel bit for bit against its
plain version; and the reduced qwen1.5-32b under the flag on the card
against the CPU, one fused int8 launch a layer at decode and no
quantize launch.  Then the GEMM's forward and both backward products at
the MLA training path's new weights (``wkr``, ``wuq``, ``wo``, the MTP
head's ``proj`` and a column slice of the untied lm_head) at M = 512.
Every "one launch per call" count reads the kernel nodes of a captured
CUDA graph, not a profiler window (which now and then loses launches).
Tolerances: int8 exact; fp32 GEMM 2e-4 and fp32 attention 3e-5 (fp32
sums in another order, no TF32); bf16 2e-2 (one bf16 ulp of the
outputs).
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import kernel_nodes as KN  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

GEMM_SHAPES = [(64, 128, 128), (100, 200, 300), (256, 256, 512),
               (33, 257, 129), (8, 896, 896)]
FLASH_CASES = [(128, 128, 4, 2, 32, True), (128, 128, 4, 2, 32, False),
               (64, 256, 8, 8, 64, True), (96, 96, 6, 1, 16, True),
               (96, 96, 6, 1, 16, False), (100, 100, 14, 2, 128, True),
               (100, 96, 4, 4, 112, True), (100, 96, 4, 4, 112, False)]
PAGED_CASES = [(3, 8, 2, 32, 16, 4), (2, 4, 4, 64, 8, 6),
               (1, 16, 1, 16, 32, 2), (3, 14, 2, 64, 16, 5)]   # G = 7
# (M, N, K): decode widths, N = 128, and K = 4824 (76 k-tiles of 64 minus
# a partial one) split 8 ways, so no split is a whole multiple of 64 x 8
SPLITK_SHAPES = [(1, 896, 896), (5, 128, 896), (8, 896, 4824),
                 (16, 4864, 896), (8, 896, 4864), (16, 128, 200)]
# (Tq, Tk, H, KH, D, causal)
FLASH_BF16_CASES = [(100, 96, 14, 2, 64, True), (100, 96, 14, 2, 64, False),
                    (96, 100, 7, 1, 16, True), (100, 96, 14, 2, 128, True),
                    (257, 257, 14, 2, 64, True), (64, 64, 4, 4, 32, True),
                    # zamba2-7b's shared attention: 32 / 32 heads of 112
                    (100, 96, 32, 32, 112, True),
                    (100, 96, 32, 32, 112, False),
                    (257, 257, 8, 2, 112, True)]
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
    dev = _card()
    rng = np.random.default_rng(3)
    a = _bf16(rng, (8, 4864), dev)
    b = _bf16(rng, (4864, 896), dev, scale=4864 ** -0.5)
    assert SG.plan(8, 896, 4864)[3] > 1
    first = ops.streaming_gemm(a, b)
    for _ in range(5):
        assert torch.equal(ops.streaming_gemm(a, b), first)
    groups = KN.captured_groups(lambda: ops.streaming_gemm(a, b), reps=3)
    assert groups == ["streaming_gemm"] * 3, groups


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
    dev = _card()
    args = _paged_card((14, 2, 64, 16, 64), [1024, 700, 272, 1, 0, 16, 17,
                                             555], torch.bfloat16, dev)
    first = ops.paged_attention(*args)
    for _ in range(5):
        assert torch.equal(ops.paged_attention(*args), first)
    groups = KN.captured_groups(lambda: ops.paged_attention(*args), reps=3)
    assert groups == ["paged_attention"] * 3, groups


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
                 (128, 16, 8, 1000, 4, 2),
                 # a granite head group (16 of 48 heads of 128)
                 (16, 128, 16, 64, 4, 2), (16, 128, 16, 64, 4, 4),
                 (16, 128, 32, 64, 2, 4), (16, 128, 16, 4096, 4, 2),
                 # zamba2-7b's head dim 112, G 1, every page size
                 (1, 112, 8, 64, 4, 2), (1, 112, 16, 64, 4, 2),
                 (1, 112, 32, 64, 2, 4), (2, 112, 32, 64, 4, 4)):
        assert fn(*case) == PA.smem_bytes(*case)


# (H, KH, D, page, max_pages): head dim 112 (zamba2-7b: 32 / 32 heads)
# at every page size (a lane's slice of D is 28, 56 or 112 elements),
# and G = 2 at 16-token pages
PAGED_D112_SHAPES = [(32, 32, 112, 8, 6), (32, 32, 112, 16, 5),
                     (32, 32, 112, 32, 4), (8, 4, 112, 16, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("splits", range(1, 9))
def test_cuda_paged_head_dim_112_every_split_at_edge_lengths(splits, dtype,
                                                            monkeypatch):
    """D 112 at every cluster size S = 1..8 forced through ``plan``,
    lengths 0, 1, page - 1, page, page + 1 and the full table; fp32
    within 3e-5, bf16 within 2e-2 of the plain version."""
    dev = _card()
    monkeypatch.setattr(PA, "plan", lambda *_: splits)
    dt = getattr(torch, dtype)
    tol = 3e-5 if dtype == "float32" else 2e-2
    for shape in PAGED_D112_SHAPES:
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
def test_cuda_paged_head_dim_112_decode_shape_deterministic_one_launch():
    """zamba2-7b's decode shape (8 sequences, 32 / 32 heads of 112,
    16-token pages, a 64-page table) at the plan the wrapper picks (one
    group, S = 1 at 256 grid rows): within 2e-2 of the plain version,
    the same bits on every run, one kernel launch per call."""
    dev = _card()
    assert PA.launch_plan(8, 32, 32, 112, 64) == (1, 1)
    args = _paged_card((32, 32, 112, 16, 64), [1024, 700, 272, 1, 0, 16,
                                               17, 555], torch.bfloat16, dev)
    first = ops.paged_attention(*args)
    np.testing.assert_allclose(first.cpu().float().numpy(),
                               ref.paged_ref(*args).cpu().float().numpy(),
                               rtol=2e-2, atol=2e-2)
    for _ in range(5):
        assert torch.equal(ops.paged_attention(*args), first)
    groups = KN.captured_groups(lambda: ops.paged_attention(*args), reps=3)
    assert groups == ["paged_attention"] * 3, groups


# (H, KH, D, page, max_pages): granite-20b's MQA (48 query heads of 128
# over one KV head: 3 groups of 16), and 2 KV heads of 32 heads of 128
# (2 groups each, G·D 4,096) at 8-token pages
PAGED_GROUP_SHAPES = [(48, 1, 128, 16, 6), (64, 2, 128, 8, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("splits", range(1, 9))
def test_cuda_paged_head_groups_every_split_at_edge_lengths(splits, dtype,
                                                           monkeypatch):
    """G·D > 2,048 through the query-head groups, every cluster size S =
    1..8 forced through ``plan``, lengths 0, 1, page - 1, page, page + 1
    and the full table; fp32 within 3e-5, bf16 within 2e-2."""
    dev = _card()
    monkeypatch.setattr(PA, "plan", lambda *_: splits)
    dt = getattr(torch, dtype)
    tol = 3e-5 if dtype == "float32" else 2e-2
    for shape in PAGED_GROUP_SHAPES:
        h, kh, d, page, mp = shape
        assert PA.head_groups(h // kh, d) > 1
        lens = [0, 1, page - 1, page, page + 1, page * mp]
        args = _paged_card(shape, lens, dt, dev, seed=splits)
        got = ops.paged_attention(*args)
        want = ref.paged_ref(*args)
        np.testing.assert_allclose(got.cpu().float().numpy(),
                                   want.cpu().float().numpy(), rtol=tol,
                                   atol=tol, err_msg=str(shape))
        assert not got[0].float().abs().max().item()


@pytest.mark.cuda
def test_cuda_paged_head_groups_deterministic_and_one_launch():
    """granite's decode shape (8 sequences, 48 / 1 heads of 128, 16-token
    pages, a 64-page table) at the plan the wrapper picks: within 2e-2
    of the plain version, the same bits on every run, and one kernel
    launch per call whatever the group count (the groups share one
    grid)."""
    dev = _card()
    assert PA.launch_plan(8, 48, 1, 128, 64) == (3, 6)
    args = _paged_card((48, 1, 128, 16, 64), [1024, 700, 272, 1, 0, 16, 17,
                                              555], torch.bfloat16, dev)
    first = ops.paged_attention(*args)
    np.testing.assert_allclose(first.cpu().float().numpy(),
                               ref.paged_ref(*args).cpu().float().numpy(),
                               rtol=2e-2, atol=2e-2)
    for _ in range(5):
        assert torch.equal(ops.paged_attention(*args), first)
    groups = KN.captured_groups(lambda: ops.paged_attention(*args), reps=3)
    assert groups == ["paged_attention"] * 3, groups


# ----------------------------------------------- expert-grouped GEMM
# (E, C, N, K): qwen2-moe-a2.7b's gate/up and down products at decode
# (C = 8) and at a 64-token prefill, then N and K off the 64/128 tiles
# (300 rows: five chunks of 64), then deepseek-v3's decode gate/up, a
# prefill-like buffer of 256 rows whose mixed counts are ~8 an expert (a
# 256-token prompt routed top-8 over 256 experts), and the absorbed
# decode's q_nope x W_uk (128 heads as groups)
GROUPED_SHAPES = [(60, 8, 1408, 2048), (60, 8, 2048, 1408),
                  (60, 64, 1408, 2048), (7, 40, 200, 136), (5, 300, 136, 264),
                  (256, 8, 2048, 7168), (256, 256, 2048, 7168),
                  (128, 8, 512, 128)]
ROUTED_MEAN = {(256, 256, 2048, 7168): 8}


def _grouped_inputs(shape, counts, dev, seed=0):
    """A (E, C, K) with rows at or beyond each count zeroed (as the MoE
    dispatch leaves them), expert weights (E, K, N), counts on the card;
    seeded normals drawn on the card (deepseek-v3's expert stack is 3.8 G
    values)."""
    E, C, N, K = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn((E, C, K), generator=g, device=dev).to(torch.bfloat16)
    counts = torch.as_tensor(counts, dtype=torch.int32, device=dev)
    a[torch.arange(C, device=dev)[None, :] >= counts[:, None]] = 0
    b = (torch.randn((E, K, N), generator=g, device=dev) * K ** -0.5).to(
        torch.bfloat16)
    return a, b, counts


def _grouped_counts(E, C, rng, mean=None):
    """Per expert: 0, C, 1, a count that ends inside a chunk, then random
    (uniform over 0..C, or Poisson of ``mean`` clipped to C)."""
    fixed = [0, C, 1, max(1, C - 3)]
    return [fixed[e] if e < len(fixed) else
            int(rng.integers(0, C + 1)) if mean is None else
            int(min(C, rng.poisson(mean))) for e in range(E)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", GROUPED_SHAPES, ids=str)
def test_cuda_grouped_gemm_matches_plain_version(shape):
    """Rows below each expert's count within 2e-2 of the plain version,
    for mixed counts, all counts 0 (no work item: every CTA leaves at
    once) and all counts C."""
    dev = _card()
    E, C, N, K = shape
    rng = np.random.default_rng(sum(shape))
    mixed = _grouped_counts(E, C, rng, ROUTED_MEAN.get(shape))
    for counts in (mixed, [0] * E, [C] * E):
        a, b, cnt = _grouped_inputs(shape, counts, dev, seed=C)
        before = ops.LAUNCHES["streaming_gemm_grouped"]
        got = ops.grouped_streaming_gemm(a, b, cnt)
        assert ops.LAUNCHES["streaming_gemm_grouped"] == before + 1
        want = ref.grouped_gemm_ref(a, b, cnt)
        torch.cuda.synchronize()
        rows = torch.arange(C, device=dev)[None, :] < cnt[:, None]
        assert got.shape == (E, C, N) and got.dtype == torch.bfloat16
        np.testing.assert_allclose(got[rows].cpu().float().numpy(),
                                   want[rows].cpu().float().numpy(),
                                   rtol=2e-2, atol=2e-2, err_msg=str(counts))


@pytest.mark.cuda
def test_cuda_grouped_gemm_is_deterministic_and_one_launch():
    """The same bits on every run, and one device kernel per call: three
    calls captured into a CUDA graph are three kernel nodes and nothing
    else.  (Counted from the graph: a profiler window opened after
    another one in the same process read 0 or 1 of the 3 kernels in
    most full runs of this file on the H100, while the first window of
    a process always read all 3.)"""
    dev = _card()
    shape = GROUPED_SHAPES[0]
    rng = np.random.default_rng(7)
    a, b, cnt = _grouped_inputs(shape, _grouped_counts(60, 8, rng), dev)
    rows = torch.arange(8, device=dev)[None, :] < cnt[:, None]
    first = ops.grouped_streaming_gemm(a, b, cnt)[rows]
    for _ in range(5):
        assert torch.equal(ops.grouped_streaming_gemm(a, b, cnt)[rows], first)
    before = ops.LAUNCHES["streaming_gemm_grouped"]
    groups = KN.captured_groups(
        lambda: ops.grouped_streaming_gemm(a, b, cnt), reps=3)
    assert groups == ["streaming_gemm_grouped"] * 3, groups
    assert ops.LAUNCHES["streaming_gemm_grouped"] == before + 3


@pytest.mark.cuda
def test_cuda_grouped_gemm_reads_strided_heads():
    """The absorbed decode's operand as the model passes it: the heads of
    a token-major (n, H, K) tensor, (H, n, K) with expert stride K (the
    token map's dims reorder to keep strides increasing), at n = 3 rows
    (fewer than a token box's 8): within 2e-2 of the plain version."""
    dev = _card()
    rng = np.random.default_rng(3)
    for n, K, N in ((3, 128, 512), (8, 512, 128)):
        a = _bf16(rng, (n, 128, K), dev).transpose(0, 1)
        b = _bf16(rng, (128, K, N), dev, scale=K ** -0.5)
        cnt = torch.full((128,), n, dtype=torch.int32, device=dev)
        got = ops.grouped_streaming_gemm(a, b, cnt)
        want = ref.grouped_gemm_ref(a, b)
        np.testing.assert_allclose(got.cpu().float().numpy(),
                                   want.cpu().float().numpy(),
                                   rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
def test_cuda_grouped_gemm_shared_memory_estimate_matches_the_kernel():
    """The plan's shared-memory count is what the kernel launches with."""
    import ctypes
    from repro_torch.kernels import _build
    _card()
    GG = importlib.import_module("repro_torch.kernels.grouped_gemm")
    fn = _build.function("grouped_gemm", "gg_smem_bytes", [ctypes.c_int] * 3)
    for E in (1, 60, 256, 1024):
        for stages in (3, 6):
            for nt in (8, 64):
                assert fn(E, stages, nt) == GG.smem_bytes(E, stages, nt)


@pytest.mark.cuda
def test_cuda_grouped_gemm_refuses_what_it_cannot_take():
    dev = _card()
    a = torch.zeros((4, 8, 64), dtype=torch.bfloat16, device=dev)
    b = torch.zeros((4, 64, 64), dtype=torch.bfloat16, device=dev)
    cnt = torch.full((4,), 8, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        ops.grouped_streaming_gemm(a.float(), b.float(), cnt)
    with pytest.raises(ValueError):
        ops.grouped_streaming_gemm(a, b.transpose(1, 2), cnt)
    with pytest.raises(ValueError):
        ops.grouped_streaming_gemm(a, b, cnt.long())
    with pytest.raises(ValueError):
        ops.grouped_streaming_gemm(a, b, cnt.cpu())


# ------------------------------------------- page streaming on the card
@pytest.mark.cuda
def test_cuda_page_store_pins_host_pages_and_serves_device_pages():
    from repro_torch.core.modes import MemoryMode, PageStore
    dev = _card()
    pages = {i: torch.full((16, 128), float(i), dtype=torch.float16)
             for i in range(6)}
    for mode in MemoryMode:
        store = PageStore(pages, mode, cache_pages=2, device=dev)
        if mode is MemoryMode.DEVMEM:
            assert all(p.is_cuda for p in store._resident.values())
        else:
            assert all(p.device.type == "cpu" and p.is_pinned()
                       for p in store._host.values())
        for i in (0, 1, 0, 5, 1):
            got = store.get(i)
            assert got.is_cuda and torch.equal(got.cpu(), pages[i])
        assert all(p.is_cuda for p in store._cache.values())
        sent = store.stats.host_to_device_bytes
        assert sent == {MemoryMode.DEVMEM: 0, MemoryMode.DM: 5 * 4096,
                        MemoryMode.DC: 4 * 4096}[mode]


@pytest.mark.cuda
def test_cuda_layer_streamer_side_stream_dm_equals_devmem():
    """Layers whose function runs the streaming GEMM kernel: DM and DC
    fetch on a side stream from pinned memory, and give DevMem's bits."""
    from repro_torch.core.modes import MemoryMode
    from repro_torch.core.offload import LayerStreamer
    dev = _card()
    L, d = 8, 896
    rng = np.random.default_rng(11)
    stacked = {"w": _bf16(rng, (L, d, d), "cpu", d ** -0.5),
               "b": _bf16(rng, (L, d), "cpu")}
    x0 = _bf16(rng, (8, d), dev)
    fn = lambda p, x: torch.tanh(ops.streaming_gemm(x, p["w"]) + p["b"])  # noqa: E731
    ops.reset_launches()
    outs = {}
    for mode in MemoryMode:
        s = LayerStreamer(stacked, L, mode, cache_layers=3, device=dev)
        if mode is MemoryMode.DEVMEM:
            assert s._copy_stream is None and s._stacked[0].is_cuda
        else:          # one pinned row per layer, one copy per fetch
            assert s._host.is_pinned() and s._host.shape[0] == L
            assert s._copy_stream != torch.cuda.current_stream(dev)
        for _ in range(2):
            outs[mode], rep = s.run(fn, x0)
        fetched = {MemoryMode.DEVMEM: 0, MemoryMode.DM: 2 * L,
                   MemoryMode.DC: 2 * L - 3}[mode]
        assert rep.bytes_streamed == fetched * s._layer_bytes
    assert ops.LAUNCHES["streaming_gemm"] == 3 * 2 * L
    assert torch.equal(outs[MemoryMode.DM], outs[MemoryMode.DEVMEM])
    assert torch.equal(outs[MemoryMode.DC], outs[MemoryMode.DEVMEM])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int8", "float16", "float32"])
def test_cuda_gemm_streamed_equals_its_cpu_run(dtype):
    """Algorithm 1 on the card (pages on the card, H2D copies from
    pinned pages in DM/DC) against the same walk on the CPU: int8
    exact, floats to fp32 rounding; equal traffic."""
    from repro_torch.core import streaming as S
    from repro_torch.core.modes import MemoryMode
    dev = _card()
    assert not torch.backends.cuda.matmul.allow_tf32
    rng = np.random.default_rng(12)
    if dtype == "int8":
        a = torch.from_numpy(rng.integers(-128, 128, (50, 600)).astype(
            np.int8))
        b = torch.from_numpy(rng.integers(-128, 128, (600, 70)).astype(
            np.int8))
    else:
        a = torch.from_numpy(rng.standard_normal((50, 600))).to(
            getattr(torch, dtype))
        b = torch.from_numpy(rng.standard_normal((600, 70))).to(
            getattr(torch, dtype))
    for mode in MemoryMode:
        got, store = S.gemm_streamed(a.to(dev), b.to(dev), mode,
                                     cache_pages=16, device=dev)
        want, cstore = S.gemm_streamed(a, b, mode, cache_pages=16,
                                       device="cpu")
        assert vars(store.stats) == vars(cstore.stats)
        if dtype == "int8":
            assert torch.equal(got, want)
        else:
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cuda_decode_plan_matches_the_paged_kernel():
    """A GQA decode-step plan (H 14 / KH 2, D 64, 16-token pages)
    executed over a bf16 pool on the card, in DM, against
    ``ops.paged_attention`` on the same q, pool, table and lens."""
    from repro_torch.core import streaming as S
    from repro_torch.core.modes import MemoryMode
    from repro_torch.serving.kv_cache import PagedCacheConfig, PagedKVCache
    dev = _card()
    cfg = PagedCacheConfig(n_pages=64, page_tokens=16, n_kv_heads=2,
                           head_dim=64, max_pages_per_seq=16)
    cache = PagedKVCache(cfg, max_seqs=4, n_layers=2, device=dev)
    rng = np.random.default_rng(13)
    cache.k_pages.copy_(_bf16(rng, tuple(cache.k_pages.shape), dev))
    cache.v_pages.copy_(_bf16(rng, tuple(cache.v_pages.shape), dev))
    for slot, n in enumerate((200, 1, 16, 97)):
        cache.alloc_seq(slot, n)
        cache.prompt_index([slot], n)
    slots = [0, 1, 2, 3]
    plan = cache.decode_step_plan(slots, n_q_heads=14)
    kd, vd = cache.page_dicts(slots, layer=1)
    q = _bf16(rng, (4, 14 * 64), dev)
    outs, store = S.execute_plan(plan, {"q": q}, MemoryMode.DM,
                                 paged={"k": kd, "v": vd}, device=dev)
    want = ops.paged_attention(
        q.view(4, 14, 64), cache.k_pages[1], cache.v_pages[1],
        torch.from_numpy(cache.tables[slots]).to(dev),
        torch.from_numpy(cache.lens[slots].copy()).to(dev))
    np.testing.assert_allclose(
        outs["decode_out"].view(4, 14, 64).float().numpy(),
        want.float().cpu().numpy(), rtol=2e-2, atol=2e-2)
    assert store.stats.lookups == 2 * int(cache.held[slots].sum())


# ------------------------------------------------------- whisper-tiny
# (Tq, Tk): the encoder's self-attention over 1,500 frames, and the
# decoder prompt's cross-attention over them
WHISPER_FLASH = [(1500, 1500), (4, 1500)]


@pytest.mark.cuda
@pytest.mark.parametrize("tq,tk", WHISPER_FLASH)
def test_cuda_flash_noncausal_at_the_whisper_encoder_length(tq, tk):
    """8 clips, 6 / 6 heads of 64, non-causal, Tk = 1,500 (a multiple of
    no 64-key tile), as the model calls it (``bk = Tk``): within 2e-2
    of the plain version."""
    dev = _card()
    rng = np.random.default_rng(tq)
    q = _bf16(rng, (8, tq, 6, 64), dev)
    k, v = _bf16(rng, (8, tk, 6, 64), dev), _bf16(rng, (8, tk, 6, 64), dev)
    got = ops.flash_attention(q, k, v, causal=False, bk=tk)
    want = ref.flash_gqa_ref(q, k, v, False)
    np.testing.assert_allclose(got.cpu().float().numpy(),
                               want.cpu().float().numpy(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.cuda
def test_cuda_paged_over_the_whisper_cross_table():
    """Decode cross-attention: 8 sequences, each of the encoder's 1,500
    tokens, 16-token pages over a 94-page table (the last page 12 tokens
    full), 6 / 6 heads of 64, at the plan the wrapper picks: within 2e-2
    of the plain version, the same bits on every run."""
    dev = _card()
    assert PA.launch_plan(8, 6, 6, 64, 94) == (1, 3)
    args = _paged_card((6, 6, 64, 16, 94), [1500] * 8, torch.bfloat16, dev)
    first = ops.paged_attention(*args)
    np.testing.assert_allclose(first.cpu().float().numpy(),
                               ref.paged_ref(*args).cpu().float().numpy(),
                               rtol=2e-2, atol=2e-2)
    for _ in range(3):
        assert torch.equal(ops.paged_attention(*args), first)


@pytest.mark.cuda
def test_cuda_whisper_decode_step_is_one_kernel_per_wrapper_call():
    """Full-width whisper-tiny, 8 clips of 1,500 frames prefilled with a
    4-token prompt, then one decode step: per layer 4 self-attention, 2
    cross-attention (q, o) and 2 MLP GEMMs and 2 paged calls (self and
    cross), plus the lm_head; each wrapper call is one device kernel
    (the call captured into a CUDA graph is one kernel node), the
    wrapper's own by its name."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    dev = _card()
    cfg = get_config("whisper-tiny")
    m = Model(cfg, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    params = m.init(g)
    B, Te = 8, 1500
    cache = m.init_cache(B, 64, page_tokens=16, enc_seq=Te)
    slots = list(range(B))
    for s in slots:
        cache.alloc_seq(s, 4)
    frames = torch.randn((B, Te, cfg.d_model), generator=g, device=dev) * 0.02
    toks = torch.randint(1, cfg.vocab_size, (B, 4), generator=g, device=dev)
    tok = m.prefill(params, toks, cache, slots, audio_frames=frames)[
        :, :cfg.vocab_size].argmax(-1)
    ops.reset_launches()

    def step():
        return m.decode_step(params, cache, tok, slots)

    calls = KN.step_calls(step)
    steps = 1                   # captured calls do not run
    assert ops.LAUNCHES["streaming_gemm"] == cfg.n_layers * 8 + 1
    assert ops.LAUNCHES["paged_attention"] == cfg.n_layers * 2
    assert ops.LAUNCHES["flash_attention"] == 0
    assert {k: len(v) for k, v in calls.items()} == {
        "streaming_gemm": cfg.n_layers * 8 + 1,
        "paged_attention": cfg.n_layers * 2}
    assert all(len(nodes) == 1 for v in calls.values() for nodes in v), calls
    assert KN.strays(calls) == []
    assert list(cache.lens[:B]) == [4 + steps] * B
    assert list(cache.cross.lens[:B]) == [Te] * B
    cache.validate()


@pytest.mark.cuda
def test_cuda_rwkv6_prefill_and_decode_match_the_cpu():
    from repro_torch.configs import get_reduced
    from repro_torch.models.model import Model
    from repro_torch.models.params import params_to
    dev = _card()
    cfg = get_reduced("rwkv6-7b")
    cpu_model, card_model = Model(cfg, device="cpu"), Model(cfg, device=dev)
    params = cpu_model.init(torch.Generator().manual_seed(0))
    card_params = params_to(params, dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in (5, 16, 23)]
    forced = rng.integers(1, cfg.vocab_size, (4, 3))

    def run(m, p):
        cache = m.init_cache(3, 64)
        out = []
        for slot, prompt in enumerate(prompts):
            cache.alloc_seq(slot, len(prompt))
            out.append(m.prefill(p, torch.as_tensor(prompt[None],
                                                    device=m.device),
                                 cache, [slot]))
        for step in range(4):
            ops.reset_launches()
            out.append(m.decode_step(p, cache, torch.as_tensor(
                forced[step], device=m.device), [2, 0, 1]))
        return torch.cat(out).float().cpu(), cache

    want, cpu_cache = run(cpu_model, params)
    got, card_cache = run(card_model, card_params)
    assert ops.LAUNCHES["streaming_gemm"] == 9 * cfg.n_layers + 1
    assert ops.LAUNCHES["flash_attention"] == 0
    assert ops.LAUNCHES["paged_attention"] == 0
    assert bool(got.isfinite().all())
    for g, w in ((got, want), (card_cache.s.cpu(), cpu_cache.s)):
        tol = 5e-2 * max(1.0, w.abs().max().item())
        assert (g - w).abs().max().item() <= tol
    assert list(card_cache.lens) == list(cpu_cache.lens) == [9, 20, 27]


@pytest.mark.cuda
def test_cuda_zamba2_prefill_and_decode_match_the_cpu():
    """The reduced zamba2 (4 Mamba2 layers, the shared block before
    layers 0 and 2): prefill of mixed prompt lengths and decode steps on
    the card against the same weights on the CPU (logits and every
    layer's scan state within 5e-2 of their largest magnitude: bf16
    rounding after fp32 sums in another order).  A decode step runs 5
    GEMMs a Mamba2 layer, 4 a shared invocation and the lm_head, and
    one paged attention a shared invocation; no flash."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import transformer as T
    from repro_torch.models.model import Model
    from repro_torch.models.params import params_to
    dev = _card()
    cfg = get_reduced("zamba2-7b")
    cpu_model, card_model = Model(cfg, device="cpu"), Model(cfg, device=dev)
    params = cpu_model.init(torch.Generator().manual_seed(0))
    card_params = params_to(params, dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in (5, 16, 23)]
    forced = rng.integers(1, cfg.vocab_size, (4, 3))
    inv = T.n_shared_invocations(cfg)

    def run(m, p):
        cache = m.init_cache(3, 64)
        out = []
        for slot, prompt in enumerate(prompts):
            cache.alloc_seq(slot, len(prompt))
            out.append(m.prefill(p, torch.as_tensor(prompt[None],
                                                    device=m.device),
                                 cache, [slot]))
        for step in range(4):
            ops.reset_launches()
            out.append(m.decode_step(p, cache, torch.as_tensor(
                forced[step], device=m.device), [2, 0, 1]))
        return torch.cat(out).float().cpu(), cache

    want, cpu_cache = run(cpu_model, params)
    got, card_cache = run(card_model, card_params)
    assert ops.LAUNCHES["streaming_gemm"] == 5 * cfg.n_layers + 4 * inv + 1
    assert ops.LAUNCHES["paged_attention"] == inv == 2
    assert ops.LAUNCHES["flash_attention"] == 0
    assert bool(got.isfinite().all())
    for g, w in ((got, want), (card_cache.state.s.cpu(), cpu_cache.state.s)):
        tol = 5e-2 * max(1.0, w.abs().max().item())
        assert (g - w).abs().max().item() <= tol
    assert list(card_cache.lens) == list(cpu_cache.lens) == [9, 20, 27]
    card_cache.validate()


# ------------------------------------------- deepseek-v3-671b (MLA)
# flash at q/k dim 192, v dim 128 (the MLA prefill): (Tq, Tk, H, KH,
# causal), ragged T, G = 1 as the model runs it and G = 4
FLASH_MLA_CASES = [(100, 96, 8, 8, True), (100, 96, 8, 8, False),
                   (257, 257, 16, 16, True), (33, 200, 4, 1, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tq,tk,h,kh,causal", FLASH_MLA_CASES)
def test_cuda_flash_qk_192_v_128_matches_plain_version(tq, tk, h, kh, causal,
                                                       dtype):
    """q and k of 192 columns, v of 128: the output (B, Tq, H, 128),
    scale 1/sqrt(192); fp32 within 3e-5, bf16 within 2e-2 of the plain
    version; one kernel per call (three calls captured into a CUDA
    graph are three kernel nodes: profiler windows late in a full run
    of this file read empty, as the grouped test's docstring says)."""
    dev = _card()
    rng = np.random.default_rng(tq + tk + h)
    dt = getattr(torch, dtype)
    tol = 3e-5 if dtype == "float32" else 2e-2
    q = _bf16(rng, (2, tq, h, 192), dev).to(dt)
    k = _bf16(rng, (2, tk, kh, 192), dev).to(dt)
    v = _bf16(rng, (2, tk, kh, 128), dev).to(dt)
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal, bk=tk)
    assert ops.LAUNCHES["flash_attention"] == before + 1
    assert got.shape == (2, tq, h, 128) and got.dtype == dt
    want = ref.flash_gqa_ref(q, k, v, causal)
    np.testing.assert_allclose(got.cpu().float().numpy(),
                               want.cpu().float().numpy(), rtol=tol,
                               atol=tol)
    groups = KN.captured_groups(
        lambda: ops.flash_attention(q, k, v, causal, bk=tk), reps=3)
    assert groups == ["flash_attention"] * 3, groups


def _latent_card(lens, h, page, mp, dtype, dev, seed=0):
    """q (B, h, 576) and one latent pool (P, page, 1, 576) of seeded
    normals, a permuted table of ``mp`` pages a sequence, ``lens``."""
    rng = np.random.default_rng(seed)
    B, P = len(lens), len(lens) * mp + 4
    q = torch.from_numpy(rng.standard_normal((B, h, 576), np.float32))
    pool = torch.from_numpy(rng.standard_normal((P, page, 1, 576),
                                                np.float32))
    table = torch.from_numpy(
        rng.permutation(P)[:B * mp].reshape(B, mp).astype(np.int32))
    ln = torch.tensor(lens, dtype=torch.int32)
    return q.to(dev, dtype), pool.to(dev, dtype), table.to(dev), ln.to(dev)


MLA_SCALE = 192 ** -0.5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("page", [8, 16, 32])
@pytest.mark.parametrize("splits", range(1, 9))
def test_cuda_paged_latent_every_split_at_edge_lengths(splits, page, dtype,
                                                       monkeypatch):
    """The latent form at every cluster size S = 1..8 (forced through
    ``latent_plan``) and 8-, 16- and 32-token pages: 32 query heads (two
    fp32 head blocks of 16; one bf16 block of 64 with 32 heads masked)
    of 576 over one latent pool, V its first 512 columns, lengths 1,
    page - 1, page, page + 1 and 1,024; fp32 within 3e-5, bf16 (tensor
    cores, P as bf16 hi + lo) within 2e-2 of the plain version."""
    dev = _card()
    monkeypatch.setattr(PA, "latent_plan", lambda *_: splits)
    dt = getattr(torch, dtype)
    tol = 3e-5 if dtype == "float32" else 2e-2
    lens = [1, page - 1, page, page + 1, 1024]
    q, pool, table, ln = _latent_card(lens, 32, page, 1024 // page, dt, dev,
                                      seed=splits + page)
    got = ops.paged_latent_attention(q, pool, table, ln, 512, MLA_SCALE)
    want = ref.paged_ref(q, pool, pool, table, ln, dv=512, scale=MLA_SCALE)
    assert got.shape == (5, 32, 512) and got.dtype == dt
    np.testing.assert_allclose(got.cpu().float().numpy(),
                               want.cpu().float().numpy(), rtol=tol,
                               atol=tol)


@pytest.mark.cuda
def test_cuda_paged_latent_decode_shape_deterministic_one_launch():
    """deepseek-v3-671b's decode shape: 8 sequences of 128 heads of 576
    over 16-token pages of a 64-page table, at the plan the wrapper
    picks, for 8 x 272 tokens and mixed lengths with an empty sequence:
    within 2e-2 of the plain version, the same bits on every run, one
    kernel per call (counted from a captured CUDA graph)."""
    dev = _card()
    assert PA.latent_plan(8, 128, 64) == 6
    for lens in ([272] * 8, [1024, 700, 272, 1, 0, 16, 17, 555]):
        args = _latent_card(lens, 128, 16, 64, torch.bfloat16, dev)
        before = ops.LAUNCHES["paged_latent_attention"]
        first = ops.paged_latent_attention(*args, 512, MLA_SCALE)
        assert ops.LAUNCHES["paged_latent_attention"] == before + 1
        np.testing.assert_allclose(
            first.cpu().float().numpy(),
            ref.paged_ref(args[0], args[1], args[1], *args[2:], dv=512,
                          scale=MLA_SCALE).cpu().float().numpy(),
            rtol=2e-2, atol=2e-2)
        for _ in range(3):
            assert torch.equal(
                ops.paged_latent_attention(*args, 512, MLA_SCALE), first)
    assert not first[4].float().abs().max().item()
    groups = KN.captured_groups(
        lambda: ops.paged_latent_attention(*args, 512, MLA_SCALE), reps=3)
    assert groups == ["paged_latent_attention"] * 3, groups


@pytest.mark.cuda
def test_cuda_paged_latent_shared_memory_estimate_matches_the_kernel():
    """The wrapper's shared-memory check computes what the kernel
    launches with; shapes it cannot take raise."""
    import ctypes
    from repro_torch.kernels import _build
    dev = _card()
    fn = _build.function("paged_attention", "pa_latent_smem_bytes",
                         [ctypes.c_int] * 5)
    for page in (8, 16, 32):
        for mp in (1, 64, 128):
            for esz in (2, 4):
                assert fn(576, 512, page, mp, esz) == \
                    PA.latent_smem_bytes(576, 512, page, mp, esz)
    q, pool, table, ln = _latent_card([5], 16, 16, 2, torch.bfloat16, dev)
    with pytest.raises(ValueError):
        ops.paged_latent_attention(q, pool, table, ln, 256, MLA_SCALE)
    with pytest.raises(ValueError):
        ops.paged_latent_attention(q[:, :8].contiguous(), pool, table, ln,
                                   512, MLA_SCALE)


@pytest.mark.cuda
def test_cuda_latent_cluster_table_matches_the_card():
    """``latent_plan`` counts waves with ``LATENT_CLUSTERS``, the clusters
    of S bf16 latent CTAs the H100 runs at once: the card's own count
    (cudaOccupancyMaxActiveClusters at the kernel's shared memory) must
    match, or the table is stale."""
    import ctypes
    from repro_torch.kernels import _build
    _card()
    if "H100" not in torch.cuda.get_device_name(0):
        pytest.skip("the table is the H100's")
    fn = _build.function("paged_attention", "pa_latent_max_clusters",
                         [ctypes.c_int] * 2)
    assert tuple(fn(64, s) for s in range(1, 9)) == PA.LATENT_CLUSTERS


@pytest.mark.cuda
def test_cuda_mla_prefill_and_decode_match_the_cpu():
    """An MLA model at the latent kernel's widths and a small d (2
    layers: one dense, one MoE of 8 experts, top-2; d 512, 16 heads of
    q/k 128 + 64 and v 128, latent 512 + 64): prefill of mixed prompt
    lengths (flash at 192 / 128) and decode steps (the absorbed products
    on the grouped GEMM, the latent paged kernel) on the card against
    the same weights on the CPU, logits within 5e-2 of their largest
    magnitude (bf16 rounding after fp32 sums in another order, the
    card's flash P in bf16).  A decode step runs 8 GEMMs in the dense
    layer, 9 in the MoE layer and the lm_head, 2 absorbed grouped
    products a layer and the MoE's 3, and one latent call a layer."""
    from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig
    from repro_torch.models.model import Model
    from repro_torch.models.params import params_to
    dev = _card()
    cfg = ModelConfig(
        name="mla-card", family="moe", n_layers=2, d_model=512, n_heads=16,
        n_kv_heads=16, d_ff=256, vocab_size=512,
        moe=MoEConfig(n_routed_experts=8, top_k=2, d_ff_expert=256,
                      n_shared_experts=1, first_dense_layers=1),
        mla=MLAConfig(q_lora_rank=128, kv_lora_rank=512,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128), mtp=True)
    cpu_model, card_model = Model(cfg, device="cpu"), Model(cfg, device=dev)
    params = cpu_model.init(torch.Generator().manual_seed(0))
    card_params = params_to(params, dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in (5, 16, 70)]
    forced = rng.integers(1, cfg.vocab_size, (4, 3))

    def run(m, p):
        cache = m.init_cache(3, 128, page_tokens=16)
        out = []
        for slot, prompt in enumerate(prompts):
            cache.alloc_seq(slot, len(prompt))
            out.append(m.prefill(p, torch.as_tensor(prompt[None],
                                                    device=m.device),
                                 cache, [slot]))
        for step in range(4):
            ops.reset_launches()
            out.append(m.decode_step(p, cache, torch.as_tensor(
                forced[step], device=m.device), [2, 0, 1]))
        return torch.cat(out).float().cpu(), cache

    want, cpu_cache = run(cpu_model, params)
    got, card_cache = run(card_model, card_params)
    assert ops.LAUNCHES["streaming_gemm"] == 8 + 9 + 1
    assert ops.LAUNCHES["streaming_gemm_grouped"] == 2 * 2 + 3
    assert ops.LAUNCHES["paged_latent_attention"] == 2
    assert ops.LAUNCHES["paged_attention"] == ops.LAUNCHES[
        "flash_attention"] == 0
    assert bool(got.isfinite().all())
    tol = 5e-2 * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= tol
    assert list(card_cache.lens) == list(cpu_cache.lens) == [9, 20, 74]
    card_cache.validate()


# --------------------------------------------------- INT8 KV cache
# (H, KH, D, page, max_pages): D 16, 32, 64 and 128 (8-, 16- and 32-token
# pages: a lane's int8 slice is read 4, 8 or 16 bytes at a time), heads
# tiers 8 (G 7), 4, 2 and 1, granite-20b's MQA in 6 head groups of 8,
# G 16 and 32 in 2 and 4 groups, qwen1.5-32b's 40 / 40 heads and
# whisper-tiny's 6 / 6 heads of 64
PAGED_INT8_SHAPES = [(14, 2, 64, 16, 8), (8, 2, 32, 8, 12),
                     (16, 1, 128, 32, 6), (4, 4, 16, 8, 7),
                     (48, 1, 128, 16, 6), (40, 40, 128, 16, 5),
                     (6, 6, 64, 16, 5), (64, 2, 128, 8, 5),
                     (16, 8, 128, 16, 4), (12, 1, 32, 16, 4)]


def _forced_int8_plan(monkeypatch, **fields):
    """Force fields of ``int8_plan`` (the split, the ring depth)."""
    orig = PA.int8_plan
    monkeypatch.setattr(PA, "int8_plan",
                        lambda *a, **k: orig(*a, **k)._replace(**fields))


def _paged_int8_card(shape, lens, dev, seed=0):
    """q (bf16), int8 K/V pools quantized from seeded bf16 values by the
    plain version, table, lens and the (P, KH, page) fp16 scale pools, in
    ``ops.paged_attention``'s argument order."""
    h, kh, d, page, mp = shape
    q, kp, vp, table, lens = _paged_inputs(len(lens), h, kh, d, page, mp,
                                           seed=seed, lens=lens)
    out = [torch.from_numpy(q).to(dev, torch.bfloat16)]
    scales = []
    for pool in (kp, vp):
        codes, sc = ref.kv_quantize_ref(
            torch.from_numpy(pool).to(dev, torch.bfloat16))
        out.append(codes)
        scales.append(sc.permute(0, 2, 1).contiguous())
    out += [torch.from_numpy(table).to(dev), torch.from_numpy(lens).to(dev)]
    return out + scales


@pytest.mark.cuda
@pytest.mark.parametrize("splits", range(1, 9))
def test_cuda_paged_int8_every_split_at_edge_lengths(splits, monkeypatch):
    """The int8 kernel at every cluster size S = 1..8 and ring depth 2 and
    4 forced through ``int8_plan``, lengths 0, 1, page - 1, page, page + 1
    and the full table, within 2e-2 of its plain version (bf16 output; P
    in fp32 on both)."""
    dev = _card()
    for ring in (2, 4):
        _forced_int8_plan(monkeypatch, splits=splits, ring=ring)
        for shape in PAGED_INT8_SHAPES:
            page, mp = shape[3], shape[4]
            lens = [0, 1, page - 1, page, page + 1, page * mp]
            args = _paged_int8_card(shape, lens, dev, seed=splits)
            got = ops.paged_attention(*args)
            want = ref.paged_ref(*args[:5], k_scale=args[5], v_scale=args[6])
            np.testing.assert_allclose(got.cpu().float().numpy(),
                                       want.cpu().float().numpy(), rtol=2e-2,
                                       atol=2e-2, err_msg=f"{shape} {ring}")
            assert not got[0].float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("h,kh,d", [(40, 40, 128), (14, 2, 64),
                                    (48, 1, 128)])
def test_cuda_paged_int8_decode_shape_deterministic_one_launch(h, kh, d):
    """qwen1.5-32b's (S = 1 at 320 grid rows), qwen2-0.5b's and granite's
    decode shapes (8 sequences, 16-token pages, a 64-page table) at the
    plan the wrapper picks: within 2e-2 of the plain version, the same
    bits on every run, one kernel launch per call (graph nodes)."""
    dev = _card()
    args = _paged_int8_card((h, kh, d, 16, 64), [1024, 700, 272, 1, 0, 16,
                                                 17, 555], dev)
    first = ops.paged_attention(*args)
    np.testing.assert_allclose(
        first.cpu().float().numpy(),
        ref.paged_ref(*args[:5], k_scale=args[5], v_scale=args[6])
        .cpu().float().numpy(), rtol=2e-2, atol=2e-2)
    for _ in range(5):
        assert torch.equal(ops.paged_attention(*args), first)
    groups = KN.captured_groups(lambda: ops.paged_attention(*args), reps=3)
    assert groups == ["paged_attention_int8"] * 3, groups


@pytest.mark.cuda
def test_cuda_paged_int8_shared_memory_estimate_matches_the_kernel():
    """``int8_smem_bytes`` (heads tier, D, page, table width, ring)
    computes what the int8 kernel's ``layout`` launches with, at every
    tier, head dim, page and ring depth."""
    import ctypes
    from repro_torch.kernels import _build
    _card()
    fn = _build.function("paged_int8", "pa_int8_smem_bytes",
                         [ctypes.c_int] * 5)
    for tier in PA.INT8_TIERS:
        for d in PA.INT8_HEAD_DIMS:
            for page in PA.PAGE_SIZES:
                for mp, ring in ((64, 2), (7, 3), (4096, 4)):
                    case = (tier, d, page, mp, ring)
                    assert fn(*case) == PA.int8_smem_bytes(*case), case


@pytest.mark.cuda
def test_cuda_paged_int8_plan_wave_is_what_the_card_holds():
    """``int8_ctas_per_sm``, the CTAs an SM that ``int8_plan``'s wave
    counts on, is at most what the card holds at once of each tier's
    kernel at the ring depth the plan takes on a full grid
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    import ctypes
    from repro_torch.kernels import _build
    _card()
    fn = _build.function("paged_int8", "pa_int8_resident_ctas",
                         [ctypes.c_int] * 5)
    for tier in PA.INT8_TIERS:
        for d in PA.INT8_HEAD_DIMS:
            for page in PA.PAGE_SIZES:
                for mp in (64, 128):
                    n = fn(tier, d, page, mp, 2)
                    assert n >= PA.int8_ctas_per_sm(tier, d, page, mp, 2), \
                        (tier, d, page, mp, n)


@pytest.mark.cuda
@pytest.mark.parametrize("splits", range(1, 9))
def test_cuda_paged_int8_append_writes_the_quantize_kernels_bits(
        splits, monkeypatch):
    """The fused append (``ops.paged_attention_append``) at every split S:
    the codes and scales it stores equal, bit for bit, those of the
    quantize kernel (``kv_quantize_append`` on the card) and of the plain
    version, every other row untouched; its output is within 2e-2 of the
    plain version's (the plain quantize-and-append, then ``paged_ref``);
    one kernel launch per call (graph nodes), counted as
    ``paged_attention_int8_append``."""
    dev = _card()
    _forced_int8_plan(monkeypatch, splits=splits)
    for shape in PAGED_INT8_SHAPES:
        h, kh, d, page, mp = shape
        lens = [1, page - 1, page, page + 1, page * mp, 2 * page + 3]
        q, kp, vp, table, ln, ks, vs = _paged_int8_card(shape, lens, dev,
                                                        seed=splits)
        rng = np.random.default_rng(splits + d)
        b = len(lens)
        k = _bf16(rng, (b, kh, d), dev, scale=3.0)
        v = _bf16(rng, (b, kh, d), dev)
        k[0, 0] = 0
        v[-1, 0] = 0
        v[-1, 0, 0] = 2.75          # 2.75 / bf16(2.75 / 127) rounds to 128
        pos = ln.long() - 1
        rows = table.long()[torch.arange(b, device=dev), pos // page] \
            * page + pos % page
        got = [t.clone() for t in (kp, vp, ks, vs)]
        by_kernel = [t.clone() for t in (kp, vp, ks, vs)]
        plain = [t.clone() for t in (kp, vp, ks, vs)]
        ops.reset_launches()
        out = ops.paged_attention_append(q, k, v, rows, got, table, ln)
        assert ops.LAUNCHES["paged_attention_int8_append"] == 1
        ops.kv_quantize_append(k, v, rows, *by_kernel)
        ref.kv_quantize_append_ref(k, v, rows, *plain)
        for a, bk, bp in zip(got, by_kernel, plain):
            assert torch.equal(a, bk) and torch.equal(a, bp), shape
        want = ref.paged_ref(q, plain[0], plain[1], table, ln,
                             k_scale=plain[2], v_scale=plain[3])
        np.testing.assert_allclose(out.cpu().float().numpy(),
                                   want.cpu().float().numpy(), rtol=2e-2,
                                   atol=2e-2, err_msg=str(shape))
    groups = KN.captured_groups(lambda: ops.paged_attention_append(
        q, k, v, rows, got, table, ln), reps=3)
    assert groups == ["paged_attention_int8"] * 3, groups


@pytest.mark.cuda
@pytest.mark.parametrize("n,kh,d,page", [(8, 40, 128, 16), (300, 2, 64, 16),
                                         (5, 3, 16, 8), (7, 4, 32, 32),
                                         (8, 1, 128, 16)])
def test_cuda_kv_quantize_is_bitwise_and_one_launch(n, kh, d, page):
    """The fused quantize-and-append kernel writes the same int8 codes
    and fp16 scales as its plain version, bit for bit, at the seeded
    rows (values of every magnitude, an all-zero row, rows at the
    saturation edge), leaves every other row alone, and is one kernel
    launch per call (graph nodes)."""
    dev = _card()
    rng = np.random.default_rng(n + d)
    P = -(-n // page) * 2 + 4
    rows = torch.from_numpy(rng.permutation(P * page)[:n].astype(np.int64)
                            ).to(dev)
    k = _bf16(rng, (n, kh, d), dev, scale=3.0) * torch.from_numpy(
        rng.uniform(0, 2, (n, kh, 1)).astype(np.float32)).to(
        dev, torch.bfloat16)
    v = _bf16(rng, (n, kh, d), dev)
    k[0, 0] = 0
    v[-1, 0] = 0
    v[-1, 0, 0] = 2.75          # 2.75 / bf16(2.75 / 127) rounds to 128
    pools = [torch.full((P, page, kh, d), 7, dtype=torch.int8, device=dev)
             for _ in range(2)]
    pools += [torch.full((P, kh, page), 3.0, dtype=torch.float16,
                         device=dev) for _ in range(2)]
    want = [t.clone() for t in pools]
    ops.kv_quantize_append(k, v, rows, *pools)
    ref.kv_quantize_append_ref(k, v, rows, *want)
    for a, b in zip(pools, want):
        assert torch.equal(a, b)
    assert pools[1].view(-1, kh, d)[rows[-1], 0, 0].item() == 127
    groups = KN.captured_groups(
        lambda: ops.kv_quantize_append(k, v, rows, *pools), reps=3)
    assert groups == ["kv_quantize"] * 3, groups


@pytest.mark.cuda
def test_cuda_int8_kv_decode_matches_the_cpu_one_launch_a_layer():
    """The reduced qwen1.5-32b under ``Tuning(kv_cache_quant=True)``: a
    prefill of 2 x 40 tokens and 3 decode steps on the card against the
    same weights on the CPU, logits within 5e-2 of their largest
    magnitude (bf16 rounding after fp32 sums in another order); one more
    step with its wrapper calls captured into CUDA graphs makes one fused
    int8 launch a layer (``paged_attention_int8_append``, one kernel node
    each), and no quantize, read-only int8 or bf16 paged launch."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import tuning as TU
    from repro_torch.models.model import Model
    from repro_torch.models.params import params_to
    dev = _card()
    cfg = get_reduced("qwen1_5_32b")
    rng = np.random.default_rng(9)
    prompt = rng.integers(1, 250, (2, 40))
    steps = rng.integers(1, 250, (4, 2))
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))

    def run(device, p, count=False):
        m = Model(cfg, device=device)
        with TU.tuning_context(TU.Tuning(kv_cache_quant=True)):
            cache = m.init_cache(2, 64, page_tokens=16)
        assert cache.k_pages.dtype == torch.int8
        for s in range(2):
            cache.alloc_seq(s, 40)
        out = [m.prefill(p, torch.as_tensor(prompt, device=m.device), cache,
                         [0, 1])]
        for t in steps[:3]:
            out.append(m.decode_step(p, cache, torch.as_tensor(
                t, device=m.device), [0, 1]))
        calls = None
        if count:
            ops.reset_launches()
            calls = KN.step_calls(lambda: m.decode_step(
                p, cache, torch.as_tensor(steps[3], device=m.device),
                [0, 1]))
        return torch.cat(out).float().cpu(), calls

    card, calls = run(dev, params_to(params, dev), count=True)
    cpu, _ = run("cpu", params)
    err = (card - cpu).abs().max().item()
    assert err <= 5e-2 * max(1.0, cpu.abs().max().item()), err
    assert len(calls["paged_attention_int8_append"]) == cfg.n_layers
    assert not {"kv_quantize", "paged_attention_int8",
                "paged_attention"} & set(calls), calls
    assert ops.LAUNCHES["paged_attention"] == 0
    assert all(len(nodes) == 1 for v in calls.values() for nodes in v), calls
    assert KN.strays(calls) == []


# ------------------------------------------- the GEMM's backward products
# (M, N, K) of an M-contiguous A: qwen2-0.5b's weight gradients at 4,096
# tokens (dW = Xᵀ·dY: M = d_in, K = tokens), and ragged M / N / K (M off
# the 8-row chunks, K off the k-tiles)
MCONTIG_SHAPES = [(896, 128, 4096), (4864, 896, 512), (896, 4864, 512),
                  (100, 200, 300), (33, 264, 129), (7, 64, 5), (136, 8, 77)]


def _mcontig(rng, m, k, dev):
    """(M, K) bf16 A with element (m, k) at a[k * lda + m], lda = M
    rounded up to 8: Xᵀ of a (K, M) row-major X whose rows are padded to
    16 bytes, as a layer input's are."""
    lda = -(-m // 8) * 8
    return _bf16(rng, (k, lda), dev)[:, :m].t()


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", MCONTIG_SHAPES)
def test_cuda_gemm_mcontig_a_matches_plain_version(m, n, k):
    """The M-contiguous A mode on the tensor-core kernel, one launch of
    ``gemm_bf16`` (no scalar kernel), within one bf16 ulp of the plain
    version."""
    dev = _card()
    rng = np.random.default_rng(m + 3 * n + 7 * k)
    a = _mcontig(rng, m, k, dev)
    b = _bf16(rng, (k, n), dev, scale=k ** -0.5)
    assert SG.mma_layout(a, b) is None
    assert SG.mcontig_layout(a, b) == (-(-m // 8) * 8, n)
    got, want = SG.gemm_cuda(a, b, mma_only=True), ref.gemm_ref(a, b)
    np.testing.assert_allclose(got.cpu().float().numpy(),
                               want.cpu().float().numpy(),
                               rtol=2e-2, atol=2e-2)
    nodes = KN.captured_nodes(lambda: SG.gemm_cuda(a, b, mma_only=True))
    assert len(nodes) == 1 and "gemm_bf16<" in nodes[0], nodes
    assert torch.equal(SG.gemm_cuda(a, b), got)      # deterministic


@pytest.mark.cuda
def test_cuda_gemm_mcontig_a_refuses_what_it_cannot_take():
    """An M-contiguous A whose stride along K is not a multiple of 8, or
    that is misaligned, or a K-contiguous B beside it, is refused by the
    tensor-core path: ``mma_only`` raises, the plain call takes the
    scalar kernel, and under autograd ``ops.streaming_gemm`` raises in
    its forward as in its backward rather than take the scalar kernel."""
    dev = _card()
    rng = np.random.default_rng(5)
    b = _bf16(rng, (64, 64), dev)
    odd_m = _bf16(rng, (64, 104), dev)[:, :99].t()  # M 99, lda 104: taken
    assert SG.mcontig_layout(odd_m, b) == (104, 64)
    bad_ld = _bf16(rng, (64, 99), dev).t()          # lda 99: refused
    misaligned = _bf16(rng, (64 * 96 + 1,), dev)[1:].view(64, 96).t()
    for a in (bad_ld, misaligned):
        assert SG.mcontig_layout(a, b) is None
        with pytest.raises(ValueError, match="tensor-core kernel"):
            SG.gemm_cuda(a, b, mma_only=True)
        np.testing.assert_allclose(SG.gemm_cuda(a, b).cpu().float().numpy(),
                                   ref.gemm_ref(a, b).cpu().float().numpy(),
                                   rtol=2e-2, atol=2e-2)
    a = _mcontig(rng, 64, 64, dev)
    with pytest.raises(ValueError, match="tensor-core kernel"):
        SG.gemm_cuda(a, b.t(), mma_only=True)       # K-contiguous B
    w = b.clone().requires_grad_(True)
    with pytest.raises(ValueError, match="tensor-core kernel"):
        ops.streaming_gemm(bad_ld, w)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,tied", [(512, 896, 896, False),
                                        (512, 896, 128, False),
                                        (256, 4864, 896, False),
                                        (100, 64, 1032, True),
                                        (256, 896, 8192, True)])
def test_cuda_gemm_backward_products_match_plain_version(m, k, n, tied):
    """``ops.streaming_gemm`` under autograd: dA = dC·Bᵀ and dB = Aᵀ·dC
    (for a tied K-contiguous B, dBᵀ = dCᵀ·A) each one ``gemm_bf16``
    launch, counted under ``streaming_gemm`` and in ``GEMM_BWD``, within
    one bf16 ulp of the plain products; a non-contiguous dC is copied
    once and counted."""
    dev = _card()
    rng = np.random.default_rng(m + n)
    a = _bf16(rng, (m, k), dev).requires_grad_(True)
    w = (_bf16(rng, (n, k), dev, scale=k ** -0.5) if tied
         else _bf16(rng, (k, n), dev, scale=k ** -0.5)).requires_grad_(True)
    b = w.t() if tied else w
    dc = _bf16(rng, (m, n), dev)
    ops.reset_launches()
    c = ops.streaming_gemm(a, b)
    da, dw = torch.autograd.grad(c, (a, w), dc)
    assert ops.LAUNCHES["streaming_gemm"] == 3
    assert ops.GEMM_BWD == {"launches": 2, "dc_copies": 0}
    want_da = ref.gemm_ref(dc, b.detach().t())
    want_dw = ref.gemm_ref(dc.t(), a.detach()) if tied \
        else ref.gemm_ref(a.detach().t(), dc)
    for got, want in ((da, want_da), (dw, want_dw)):
        assert got.shape == want.shape and got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(),
                                   rtol=2e-2, atol=2e-2)
    # the products the Function launches, captured as its backward calls
    # them: one tensor-core kernel each
    ad, bd = a.detach(), b.detach()
    for x, y in ((dc, bd.t()), (dc.t(), ad) if tied else (ad.t(), dc)):
        nodes = KN.captured_nodes(lambda: ops._gemm_bwd(x, y))
        assert len(nodes) == 1 and "gemm_bf16<" in nodes[0], nodes
    # a dC the kernel cannot read in place (column-major)
    cols = _bf16(rng, (n, m), dev).t()
    got = torch.autograd.grad(ops.streaming_gemm(a, b), a, cols)[0]
    assert ops.GEMM_BWD["dc_copies"] == 1
    np.testing.assert_allclose(
        got.float().cpu().numpy(),
        ref.gemm_ref(cols.contiguous(), b.detach().t()).float().cpu().numpy(),
        rtol=2e-2, atol=2e-2)


# (weight, K, N, columns taken) of the MLA training path's new products
# at M = 512: ``wkr``, whose dB has N = 64; ``wuq``; ``wo`` (K 16,384);
# the MTP head's ``proj`` (K 14,336); and a column slice of the untied
# lm_head (7,168 x 129,280), a B whose rows are 129,280 values apart
MLA_TRAIN_SHAPES = [("wkr", 7168, 64, None), ("wuq", 1536, 24576, None),
                    ("wo", 16384, 7168, None),
                    ("mtp_proj", 14336, 7168, None),
                    ("lm_head", 7168, 129280, 8192)]


@pytest.mark.cuda
@pytest.mark.parametrize("name,k,n,cols", MLA_TRAIN_SHAPES,
                         ids=[s[0] for s in MLA_TRAIN_SHAPES])
def test_cuda_gemm_mla_train_shapes_match_plain_version(name, k, n, cols):
    """The forward, dA = dC·Bᵀ and dB = Aᵀ·dC of ``ops.streaming_gemm``
    under autograd at the MLA training path's weights, M = 512: each one
    ``gemm_bf16`` launch (no scalar kernel), within one bf16 ulp of the
    plain products."""
    dev = _card()
    m = 512
    g = torch.Generator(device=dev).manual_seed(k + n)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev)
                * scale).to(torch.bfloat16)

    a = randn(m, k).requires_grad_(True)
    w = randn(k, n, scale=k ** -0.5).requires_grad_(True)
    b = w[:, :cols] if cols else w
    dc = randn(m, b.shape[1])
    ops.reset_launches()
    c = ops.streaming_gemm(a, b)
    da, db = torch.autograd.grad(c, (a, b), dc)
    assert ops.LAUNCHES["streaming_gemm"] == 3
    assert ops.GEMM_BWD == {"launches": 2, "dc_copies": 0}
    ad, bd = a.detach(), b.detach()
    for got, want in ((c, ref.gemm_ref(ad, bd)),
                      (da, ref.gemm_ref(dc, bd.t())),
                      (db, ref.gemm_ref(ad.t(), dc))):
        assert got.shape == want.shape and got.dtype == torch.bfloat16
        err = (got.float() - want.float()).abs()
        assert bool((err <= 2e-2 + 2e-2 * want.float().abs()).all()), \
            float(err.max())
    for x, y in ((ad, bd), (dc, bd.t()), (ad.t(), dc)):
        nodes = KN.captured_nodes(lambda: ops._gemm_bwd(x, y))
        assert len(nodes) == 1 and "gemm_bf16<" in nodes[0], nodes


@pytest.mark.cuda
def test_cuda_train_step_launches_only_the_tensor_core_gemm():
    """One training step of the reduced qwen2 on the card: every GEMM,
    forward and backward, is ``gemm_bf16`` (7 a layer and the lm_head
    forward, twice that backward; no ``gemm_simt``), and the loss and
    gradients agree with the same step on the CPU."""
    from repro_torch.configs import get_reduced
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models.model import Model
    from repro_torch.models.params import params_to, tree_map
    from repro_torch.models.params import tree_leaves
    dev = _card()
    cfg = get_reduced("qwen2_0_5b")
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64)))
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}

    def run(device, p, b=None):
        return loss_and_grads(Model(cfg, device=device, remat="none"), p,
                              b or tree_map(lambda t: t.to(device), batch))

    on_card = params_to(params, dev)
    batch_card = tree_map(lambda t: t.to(dev), batch)
    ops.reset_launches()
    (loss, _), grads = run(dev, on_card, batch_card)
    fwd = 7 * cfg.n_layers + 1
    assert ops.LAUNCHES["streaming_gemm"] == 3 * fwd
    assert ops.GEMM_BWD["launches"] == 2 * fwd
    (want, _), want_g = run("cpu", params)
    assert abs(loss.item() - want.item()) <= 1e-2 * abs(want.item())
    for g, w in zip(tree_leaves(grads), tree_leaves(want_g)):
        err = ((g.float().cpu() - w.float()).norm() / w.float().norm())
        assert err <= 5e-2, err
    nodes = KN.captured_nodes(lambda: run(dev, on_card, batch_card))
    names = [n for n in nodes if n and ("gemm_bf16<" in n or
                                        "gemm_simt<" in n)]
    assert len(names) == 3 * fwd and all("gemm_bf16<" in n for n in names)


# ------------------------------------------------- MoE training (slice 16)
# the router's 2,048 x 60 weight: rows of 120 bytes, staged in 8-byte
# copies; 62 columns (124-byte rows) take 4-byte copies
ROUTER_CASES = [(8, 2048, 60), (4096, 2048, 60), (300, 2048, 62),
                (4096, 7168, 256)]


def _router_products(x, w, dc):
    """(name, A, B) of the router's three products as the autograd
    Function launches them: the forward x·W (row-major B, ldb = N), dA =
    dC·Wᵀ (a row-major A with lda = N, a K-contiguous B with ldb = N) and
    dW = xᵀ·dC (an M-contiguous A, a row-major B with ldb = N); and dWᵀ =
    dCᵀ·x, the form a K-contiguous weight's gradient takes (an
    M-contiguous A with lda = N)."""
    return (("forward", x, w), ("dA", dc, w.t()), ("dB", x.t(), dc),
            ("dB^T", dc.t(), x))


@pytest.mark.cuda
@pytest.mark.parametrize("m,d,n", ROUTER_CASES, ids=str)
def test_cuda_router_products_run_on_the_tensor_core_kernel(m, d, n):
    """Each of the router's three products, at rows narrower than 16
    bytes, is one ``gemm_bf16`` launch (never ``gemm_simt``) within one
    bf16 ulp of the plain version, bitwise repeatable; the serving call
    (no ``mma_only``) takes the same kernel."""
    SG = importlib.import_module("repro_torch.kernels.streaming_gemm")
    dev = _card()
    rng = np.random.default_rng(m + n)
    x = _bf16(rng, (m, d), dev, scale=m ** -0.5)
    w = _bf16(rng, (d, n), dev, scale=n ** -0.5)
    dc = _bf16(rng, (m, n), dev)
    for name, a, b in _router_products(x, w, dc):
        assert SG.mma_layout(a, b) is not None or \
            SG.mcontig_layout(a, b) is not None, name
        got = SG.gemm_cuda(a, b, mma_only=True)
        want = ref.gemm_ref(a, b)
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(),
                                   rtol=2e-2, atol=2e-2, err_msg=name)
        assert torch.equal(SG.gemm_cuda(a, b), got), name
        nodes = KN.captured_nodes(lambda: SG.gemm_cuda(a, b))
        assert len(nodes) == 1 and "gemm_bf16<" in nodes[0], (name, nodes)


@pytest.mark.cuda
def test_cuda_router_under_autograd_reads_dc_in_place():
    """The router's product under autograd: forward and both backward
    products on ``gemm_bf16``, the (M, 60) output gradient read in place
    (no copy), gradients within one bf16 ulp of the plain products."""
    dev = _card()
    rng = np.random.default_rng(60)
    x = _bf16(rng, (512, 2048), dev, scale=512 ** -0.5).requires_grad_(True)
    w = _bf16(rng, (2048, 60), dev, scale=60 ** -0.5).requires_grad_(True)
    dc = _bf16(rng, (512, 60), dev)
    ops.reset_launches()
    dx, dw = torch.autograd.grad(ops.streaming_gemm(x, w), (x, w), dc)
    assert ops.LAUNCHES["streaming_gemm"] == 3
    assert ops.GEMM_BWD == {"launches": 2, "dc_copies": 0}
    for got, want in ((dx, ref.gemm_ref(dc, w.detach().t())),
                      (dw, ref.gemm_ref(x.detach().t(), dc))):
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(),
                                   rtol=2e-2, atol=2e-2)
    # an output gradient with an odd row stride is copied once into
    # rows padded to 16 bytes, which the kernel reads
    odd = _bf16(rng, (512, 61), dev)[:, :60]
    got = torch.autograd.grad(ops.streaming_gemm(x, w), x, odd)[0]
    assert ops.GEMM_BWD["dc_copies"] == 1
    np.testing.assert_allclose(
        got.float().cpu().numpy(),
        ref.gemm_ref(odd.contiguous(), w.detach().t()).float().cpu().numpy(),
        rtol=2e-2, atol=2e-2)


# (E, C, K, N, counts mean): qwen2-moe at training's capacity (4,096
# tokens, top-4 over 60 experts: C 344, ~273 rows an expert) for gate/up
# and down, at decode (C 8), and deepseek-v3's 256 experts of 7,168 <->
# 2,048 at ~16 rows an expert; then ragged widths; then "edges": counts
# at every edge of the kernels' walks (dA's chunks of up to 256 rows and
# their 8- and 32-row rounding, dB's stages of 64 rows) and C, with K and
# N not multiples of 64 or 128
GROUPED_BWD_CASES = [(60, 344, 2048, 1408, 273), (60, 344, 1408, 2048, 273),
                     (60, 8, 2048, 1408, None), (256, 32, 7168, 2048, 16),
                     (7, 40, 136, 200, None), (5, 300, 264, 136, None),
                     (12, 300, 1408, 2048, "edges"),
                     (10, 520, 264, 200, "edges"),
                     (9, 260, 136, 72, "edges"), (3, 70, 40, 24, "edges")]
EDGE_COUNTS = (0, 1, 63, 64, 65, 255, 256, 257)


def _poisoned(shape, dev, seed):
    """A (E, C, K), the weight (E, K, N), dC (E, C, N) and counts (E,)
    with 0, C and a mid-tile count among them; every row of A and dC at
    or beyond its count is NaN."""
    E, C, K, N, mean = shape
    rng = np.random.default_rng(seed)
    if mean == "edges":
        fixed = [min(c, C) for c in EDGE_COUNTS] + [C]
        counts = [fixed[e] if e < len(fixed) else int(rng.integers(0, C + 1))
                  for e in range(E)]
    else:
        counts = _grouped_counts(E, C, rng, mean)
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn((E, C, K), generator=g, device=dev).to(torch.bfloat16)
    b = (torch.randn((E, K, N), generator=g, device=dev) * N ** -0.5).to(
        torch.bfloat16)
    dc = torch.randn((E, C, N), generator=g, device=dev).to(torch.bfloat16)
    cnt = torch.as_tensor(counts, dtype=torch.int32, device=dev)
    past = torch.arange(C, device=dev)[None, :] >= cnt[:, None]
    a[past] = float("nan")
    dc[past] = float("nan")
    return a, b, dc, cnt, past


def _close_on_card(got, want, tol=2e-2):
    """|got - want| <= tol (1 + |want|) elementwise, expert by expert on
    the card (deepseek-v3's dB is 3.8 G values: a host copy in fp32
    would not fit the host's memory)."""
    assert got.shape == want.shape
    for g, w in zip(got, want):
        err = (g.float() - w.float()).abs()
        assert bool((err <= tol * (1 + w.float().abs())).all()), \
            float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", GROUPED_BWD_CASES, ids=str)
def test_cuda_grouped_backward_kernels_match_plain_versions(shape):
    """dA = dC·Bᵀ (kept rows) and dB = Aᵀ·dC (summed over the kept rows)
    with NaN in every row past a count: finite, within one bf16 ulp of
    the plain versions (zeros for an expert at count 0), bitwise
    repeatable, one kernel node each."""
    GG = importlib.import_module("repro_torch.kernels.grouped_gemm")
    dev = _card()
    a, b, dc, cnt, past = _poisoned(shape, dev, sum(shape[:4]))
    da = GG.grouped_bwd_a_cuda(dc, b, cnt)
    db = GG.grouped_bwd_b_cuda(a, dc, cnt)
    want_da = ref.grouped_bwd_a_ref(dc, b, cnt)
    want_db = ref.grouped_bwd_b_ref(a, dc, cnt)
    kept = ~past
    assert bool(da[kept].isfinite().all()) and bool(db.isfinite().all())
    _close_on_card(da[kept], want_da[kept])
    _close_on_card(db, want_db)
    del want_da, want_db
    assert not db[cnt == 0].any()
    assert torch.equal(GG.grouped_bwd_a_cuda(dc, b, cnt)[kept], da[kept])
    assert torch.equal(GG.grouped_bwd_b_cuda(a, dc, cnt), db)
    for fn, name in ((lambda: GG.grouped_bwd_a_cuda(dc, b, cnt),
                      "grouped_bwd_da"),
                     (lambda: GG.grouped_bwd_b_cuda(a, dc, cnt),
                      "grouped_bwd_db")):
        nodes = [n for n in KN.captured_nodes(fn) if n]
        assert len(nodes) == 1 and name in nodes[0], nodes
        assert KN.kernel_group(nodes[0]) == "streaming_gemm_grouped"


@pytest.mark.cuda
def test_cuda_grouped_backward_kernels_take_strided_operands():
    """Every layout the wrappers take: the heads of token-major tensors
    (the expert stride the smaller, so the tensor maps' outer dims swap),
    a weight broadcast over the experts (stride 0, copied once) and a
    single expert; within 2e-2 of the plain versions."""
    GG = importlib.import_module("repro_torch.kernels.grouped_gemm")
    dev = _card()
    rng = np.random.default_rng(11)
    E, C, K, N = 6, 90, 136, 200
    dc = _bf16(rng, (C, E, N), dev).transpose(0, 1)
    a = _bf16(rng, (C, E, K), dev).transpose(0, 1)
    b = _bf16(rng, (1, K, N), dev, scale=N ** -0.5).expand(E, K, N)
    cnt = torch.as_tensor([0, 1, 64, 65, 89, 90], dtype=torch.int32,
                          device=dev)
    kept = torch.arange(C, device=dev)[None, :] < cnt[:, None]
    for e in (slice(None), slice(E - 1, E)):
        got = GG.grouped_bwd_a_cuda(dc[e], b[e], cnt[e])
        want = ref.grouped_bwd_a_ref(dc[e], b[e], cnt[e])
        _close_on_card(got[kept[e]], want[kept[e]])
        _close_on_card(GG.grouped_bwd_b_cuda(a[e], dc[e], cnt[e]),
                       ref.grouped_bwd_b_ref(a[e], dc[e], cnt[e]))


@pytest.mark.cuda
def test_cuda_grouped_backward_shared_memory_estimate_matches_the_kernel():
    """The backward plans' shared-memory count is what the kernels launch
    with (``gg_bwd_smem_bytes``), for dA's and dB's rings."""
    import ctypes
    from repro_torch.kernels import _build
    _card()
    GG = importlib.import_module("repro_torch.kernels.grouped_gemm")
    fn = _build.function("grouped_gemm", "gg_bwd_smem_bytes",
                         [ctypes.c_int] * 4)
    for E in (1, 60, 256, 1024):
        for stages in (2, 3, 4, 6):
            for nt in (8, 64, 96, 160):
                assert fn(0, E, stages, nt) == GG.bwd_smem_bytes(0, E, stages,
                                                                  nt)
            assert fn(1, E, stages, 0) == GG.bwd_smem_bytes(1, E, stages)
        for which, plan in ((0, GG.plan_bwd_da(E, 344, 1408, 2048)),
                            (1, GG.plan_bwd_db(E, 344, 2048, 1408))):
            assert plan.smem == fn(which, E, plan.stages, plan.rows)


@pytest.mark.cuda
def test_cuda_grouped_gemm_function_backward_counts_and_no_nan():
    """``ops.grouped_streaming_gemm`` under autograd on the card: the
    forward and both backward kernels, counted under
    ``streaming_gemm_grouped`` and in ``GROUPED_BWD``; with NaN in the
    rows past the counts of A and of the output gradient, no NaN reaches
    a kept row of dA or any of dB."""
    dev = _card()
    a, b, dc, cnt, past = _poisoned((60, 344, 256, 192, 273), dev, 5)
    a_ = a.clone().requires_grad_(True)
    b_ = b.clone().requires_grad_(True)
    ops.reset_launches()
    c = ops.grouped_streaming_gemm(a_, b_, cnt)
    da, db = torch.autograd.grad(c, (a_, b_), dc)
    assert ops.LAUNCHES["streaming_gemm_grouped"] == 3
    assert ops.GROUPED_BWD == {"da": 1, "db": 1}
    assert bool(da[~past].isfinite().all()) and bool(db.isfinite().all())
    np.testing.assert_allclose(
        db.float().cpu().numpy(),
        ref.grouped_bwd_b_ref(a, dc, cnt).float().cpu().numpy(),
        rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
def test_cuda_moe_train_step_runs_only_hand_written_gemms():
    """One training step of the reduced qwen2-moe on the card: the grouped
    kernels (forward, dA, dB) counted, no ``gemm_simt`` kernel, no
    library GEMM op inside an expert product; the loss within 1e-2 of
    the same step on the CPU (routing may differ at a near-tie) and
    every gradient finite."""
    from repro_torch.configs import get_reduced
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models.model import Model
    from repro_torch.models.params import params_to, tree_map
    from repro_torch.models.params import tree_leaves
    dev = _card()
    cfg = get_reduced("qwen2_moe_a2_7b")
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64)))
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    on_card = params_to(params, dev)
    batch_card = tree_map(lambda t: t.to(dev), batch)

    def step():
        return loss_and_grads(Model(cfg, device=dev, remat="none"), on_card,
                              batch_card)

    ops.reset_launches()
    (loss, metrics), grads = step()
    assert ops.GROUPED_BWD == {"da": 3 * cfg.n_layers,
                               "db": 3 * cfg.n_layers}
    assert ops.LAUNCHES["streaming_gemm_grouped"] == 9 * cfg.n_layers
    (want, want_m), want_g = loss_and_grads(
        Model(cfg, device="cpu", remat="none"), params, batch)
    assert abs(loss.item() - want.item()) <= 1e-2 * abs(want.item())
    assert float(metrics["aux"]) > 0
    for g, w in zip(tree_leaves(grads), tree_leaves(want_g)):
        assert g.shape == w.shape and bool(g.float().isfinite().all())
    # the step under the profiler (the dispatch's masked indexing syncs
    # with the host, so the step cannot be captured into a graph), each
    # expert product inside a range of its own: no scalar GEMM kernel,
    # and no library GEMM op inside an expert product (the chunked
    # attention's torch ops are the only library GEMMs of the step)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    fwd_fn, bwd_fn = ops._grouped, ops._grouped_bwd

    def ranged(fn):
        def call(*a):
            with record_function("grouped_expert_product"):
                return fn(*a)
        return call

    ops._grouped, ops._grouped_bwd = ranged(fwd_fn), ranged(bwd_fn)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
    finally:
        ops._grouped, ops._grouped_bwd = fwd_fn, bwd_fn
    events = prof.events()
    names = {ev.name for ev in events if ev.device_type == DeviceType.CUDA}
    assert not any("gemm_simt" in n for n in names), names
    ranges = [(ev.time_range.start, ev.time_range.end) for ev in events
              if ev.name == "grouped_expert_product"
              and ev.device_type == DeviceType.CPU]
    assert len(ranges) == 9 * cfg.n_layers
    inside = [ev.name for ev in events
              if ev.name in ("aten::bmm", "aten::mm", "aten::matmul",
                             "aten::addmm", "aten::baddbmm")
              and any(a <= ev.time_range.start <= b for a, b in ranges)]
    assert not inside, inside


@pytest.mark.cuda
@pytest.mark.parametrize("arch, kind", [
    ("qwen2_0_5b", "train"), ("qwen2_moe_a2_7b", "train"),
    ("zamba2_7b", "train"), ("qwen2_0_5b", "prefill"),
    ("qwen2_0_5b", "decode"), ("qwen2_moe_a2_7b", "decode")])
def test_cuda_step_counts_as_on_meta(arch, kind):
    """One step of a reduced config counted on the card
    (``launch.hlo_analysis``) equals its count on ``meta`` (flops, bytes,
    collectives, wrapper ops), and each wrapper op is one launch."""
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.sharding.blocks import ONE_RANK
    dev = _card()
    run = RunConfig(model=get_reduced(arch),
                    shape=ShapeConfig(kind, kind, 32, 2))
    got = {}
    for d in (dev, torch.device("meta")):
        fn, args, donated = dryrun.cell_step(run, ONE_RANK, d)
        ops.reset_launches()
        _, c, _ = dryrun.count(fn, args, donated)
        got[d.type] = (c, {k: v for k, v in ops.LAUNCHES.items() if v})
    (card, launches), (meta, none) = got["cuda"], got["meta"]

    def key(c):
        return (c.flops, c.bytes, c.coll_bytes, c.coll_count, c.kernel_ops)

    assert key(card) == key(meta)
    assert launches == card.kernel_ops and none == {}
