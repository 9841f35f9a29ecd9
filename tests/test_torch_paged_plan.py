"""The paged kernel's cluster split (``plan``) and its split arithmetic,
on the CPU.

The kernel runs only on the card, but how it cuts a sequence's pages is
fixed in Python and in a few lines of index arithmetic, so both are
checked here: ``plan``'s rule at the main path's and the tests' shapes,
and a plain PyTorch model of the kernel's partition — rank r of S takes
pages [r·c, min(n, (r+1)·c)) with n = ⌈len/page⌉ and c = ⌈n/S⌉, its
walking warps (four, or two) take those pages round-robin, each keeps
its own (m, l, acc),
and the states are merged warp by warp, then rank by rank, in order —
held against the reference Pallas kernel (interpret mode) for S = 1..8
in fp32 within 3e-5 (fp32 sums in another order).
"""
import functools
import importlib
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import paged_attention as jax_paged  # noqa: E402

PA = importlib.import_module("repro_torch.kernels.paged_attention")
NEG_INF = -1e30

# (B, H, KH, D, page, max_pages, lens): the reference kernel tests'
# shapes, with ranks that get no page (S above a sequence's page count)
# and lens = 0; the last is G = 7 at the main path's head and page sizes
SPLIT_CASES = [
    (3, 8, 2, 32, 16, 4, (17, 64, 0)),
    (2, 4, 4, 64, 8, 6, (1, 41)),
    (1, 16, 1, 16, 32, 2, (33,)),
    (4, 14, 2, 64, 16, 5, (0, 15, 16, 80)),
]


def _cdiv(a, b):
    return -(-a // b)


@pytest.mark.parametrize("b,kh,max_pages,want", [
    (8, 2, 64, 8),      # main path: 16 (sequence, KV head) pairs -> 128 CTAs
    (1, 2, 64, 8),      # a lone long request: 16 CTAs
    (4, 2, 64, 8),
    (8, 8, 64, 3),      # 64 pairs: 192 CTAs
    (66, 2, 64, 1),     # 132 pairs fill the card alone
    (3, 2, 4, 2),       # reference test shapes: capped at half the table
    (2, 4, 6, 3),
    (1, 1, 2, 1),
    (3, 2, 1, 1),
    (5, 2, 0, 1),       # an empty table
])
def test_plan_rule(b, kh, max_pages, want):
    assert PA.plan(b, kh, max_pages) == want


@pytest.mark.parametrize("b", [1, 2, 3, 8, 16, 33, 64, 200])
@pytest.mark.parametrize("kh", [1, 2, 4, 8])
@pytest.mark.parametrize("max_pages", [0, 1, 2, 3, 7, 16, 64, 1000])
def test_plan_bounds(b, kh, max_pages):
    """1 <= S <= 8, never more ranks than a full table has pages, and the
    fewest that cover the 132 SMs unless a cap stops it first."""
    s = PA.plan(b, kh, max_pages)
    assert 1 <= s <= PA.MAX_SPLITS
    assert s <= max(1, max_pages)
    caps = (PA.MAX_SPLITS, _cdiv(max_pages, 2))
    if s > 1:
        assert b * kh * (s - 1) < PA.SMS
    assert b * kh * s >= PA.SMS or s in caps or s == 1


def test_plan_reads_only_the_table_width():
    """``plan`` takes shapes, not tensors: the lengths stay on the
    device and each CTA reads its own."""
    import inspect
    assert list(inspect.signature(PA.plan).parameters) == \
        ["B", "KH", "max_pages"]


@pytest.mark.parametrize("g,d,page,mp,esz", [
    (7, 64, 16, 64, 2), (1, 64, 8, 6, 4), (16, 16, 32, 2, 4),
    (16, 128, 32, 6, 4), (128, 16, 32, 64, 4), (16, 128, 32, 64, 2)])
def test_every_accepted_shape_fits_shared_memory(g, d, page, mp, esz):
    """Every (G, D, page) the wrapper accepts fits 227 KB, with two
    walking warps only where four rings do not fit."""
    w = PA.walkers(g, d, page, mp, esz)
    assert w in (2, PA.WARPS)
    assert PA.smem_bytes(g, d, page, mp, w, esz) <= PA.MAX_SMEM_BYTES
    if w == 2:
        assert PA.smem_bytes(g, d, page, mp, PA.WARPS, esz) > \
            PA.MAX_SMEM_BYTES


def test_main_path_walkers():
    """At the main path's shape all four warps of each CTA walk pages."""
    assert PA.walkers(7, 64, 16, 64, 2) == PA.WARPS
    assert PA.walkers(16, 128, 32, 6, 4) == 2


def _page_state(q, k, v, pos0, length, state):
    """One page of the online softmax, fp32, as a warp of the kernel does
    it (natural log domain; the kernel's log2 domain is the same up to
    rounding)."""
    m, l, acc = state
    D = q.shape[-1]
    s = (q @ k.T) / math.sqrt(D)                              # (G, page)
    pos = pos0 + torch.arange(k.shape[0])
    s = torch.where(pos[None] < length, s, torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m, s.max(-1).values)
    p = torch.exp(s - m_new[:, None])
    corr = torch.exp(m - m_new)
    return m_new, l * corr + p.sum(-1), acc * corr[:, None] + p @ v


def _merge(states):
    """Merge (m, l, acc) states in list order, rescaled by
    exp(m_i - max m)."""
    mx = torch.stack([m for m, _, _ in states]).max(0).values
    l = torch.zeros_like(mx)
    acc = torch.zeros_like(states[0][2])
    for m, li, ai in states:
        w = torch.exp(m - mx)
        l = l + li * w
        acc = acc + ai * w[:, None]
    return mx, l, acc


def split_model(q, k_pages, v_pages, table, lens, splits,
                walkers=PA.WARPS):
    """The kernel's partition in plain PyTorch, fp32: ranks, walking
    warps round-robin inside a rank, merges in warp and rank order."""
    B, H, D = q.shape
    _, page, KH, _ = k_pages.shape
    G, max_pages = H // KH, table.shape[1]
    out = torch.zeros((B, H, D))
    for b in range(B):
        length = int(lens[b])
        n = min(_cdiv(length, page), max_pages) if length > 0 else 0
        c = _cdiv(n, splits)
        for kh in range(KH):
            qg = q[b, kh * G:(kh + 1) * G].float()
            ranks = []
            for r in range(splits):
                lo = min(n, r * c)
                hi = min(n, lo + c)
                warps = []
                for w in range(PA.WARPS):
                    st = (torch.full((G,), NEG_INF), torch.zeros(G),
                          torch.zeros(G, D))
                    for p in range(lo + w, hi if w < walkers else lo,
                                   walkers):
                        pid = int(table[b, p])
                        st = _page_state(qg, k_pages[pid, :, kh].float(),
                                         v_pages[pid, :, kh].float(),
                                         p * page, length, st)
                    warps.append(st)
                ranks.append(_merge(warps))
            _, l, acc = _merge(ranks)
            out[b, kh * G:(kh + 1) * G] = acc / l.clamp_min(1e-30)[:, None]
    return out


def _inputs(case, seed=0):
    B, H, KH, D, page, mp, lens = case
    rng = np.random.default_rng(seed)
    P = B * mp + 4
    q = rng.standard_normal((B, H, D), np.float32)
    kp = rng.standard_normal((P, page, KH, D), np.float32)
    vp = rng.standard_normal((P, page, KH, D), np.float32)
    table = rng.permutation(P)[:B * mp].reshape(B, mp).astype(np.int32)
    return q, kp, vp, table, np.asarray(lens, np.int32)


@functools.lru_cache(maxsize=None)
def _reference(ci):
    args = _inputs(SPLIT_CASES[ci])
    return np.asarray(jax_paged(*(jnp.asarray(a) for a in args),
                                interpret=True))


@pytest.mark.parametrize("splits", range(1, 9))
@pytest.mark.parametrize("ci", range(len(SPLIT_CASES)))
def test_split_model_matches_reference_kernel(ci, splits):
    args = [torch.from_numpy(a) for a in _inputs(SPLIT_CASES[ci])]
    walkers = 2 if splits % 2 else PA.WARPS   # both warp counts
    got = split_model(*args, splits, walkers).numpy()
    want = _reference(ci)
    np.testing.assert_allclose(got, want, rtol=3e-5, atol=3e-5)
    lens = SPLIT_CASES[ci][-1]
    for b, length in enumerate(lens):
        if length == 0:
            assert not got[b].any()


def test_split_model_ranks_partition_the_pages():
    """The rank ranges cover the live pages once, in order, and a rank
    past the last page gets an empty range."""
    for n in range(0, 70):
        for s in range(1, 9):
            c = _cdiv(n, s)
            ranges = [(min(n, r * c), min(n, min(n, r * c) + c))
                      for r in range(s)]
            pages = [p for lo, hi in ranges for p in range(lo, hi)]
            assert pages == list(range(n))
            assert all(lo <= hi for lo, hi in ranges)
