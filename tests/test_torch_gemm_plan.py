"""The Hopper block chooser of the streaming GEMM (``plan``), and the
key-range split of the flash kernel, on the CPU.

The kernels run only on the card, but the tiles and splits they launch
with are chosen in Python, so their rules are checked here: at every
main-path shape of qwen2-0.5b (decode M <= 8 and 16, prefill M = 64-512;
the q/k/v/o projections, the MLP and the tied lm_head; prefill attention
at 64-512 tokens) and at the ragged shapes of the kernel contracts.
"""
import importlib

import pytest

pytest.importorskip("torch")

# the package re-exports the wrapper ``streaming_gemm`` under the
# module's name, so fetch the module itself
SG = importlib.import_module("repro_torch.kernels.streaming_gemm")

KN_MAIN = [(896, 896), (896, 128), (896, 4864), (4864, 896),
           (896, 152064)]
SHAPES = [(m, n, k) for m in (1, 5, 8, 16, 64, 256, 512)
          for k, n in KN_MAIN]
RAGGED = [(64, 128, 128), (100, 200, 300), (256, 256, 512),
          (33, 257, 129), (5, 128, 896), (8, 896, 4864 - 40)]


def _split_ranges(k, splits):
    """The k-tile range [begin, end) of each split as the kernel computes
    it: split r of S walks k-tiles [r·nk/S, (r+1)·nk/S)."""
    nk = -(-k // SG.BK)
    return [(r * nk // splits, (r + 1) * nk // splits)
            for r in range(splits)]


def _ctas(m, n, k):
    bm, bn, _, splits = SG.plan(m, n, k)
    return -(-m // bm) * -(-n // bn) * splits


@pytest.mark.parametrize("m,n,k", SHAPES + RAGGED)
def test_plan_rules(m, n, k):
    bm, bn, bk, splits = SG.plan(m, n, k)
    # B tiles are whole 4 KB pages of bf16
    assert bk == 64 and (bn * bk * 2) % SG.PAGE_BYTES == 0
    assert bn in SG.BNS and bm in SG.BMS
    # the token tile holds a decode batch without staging zero rows
    assert bm == min(b for b in SG.BMS if b >= min(m, SG.BMS[-1]))
    # a cluster holds at most 8 CTAs; the splits cover K exactly
    assert 1 <= splits <= SG.MAX_SPLITS
    ranges = _split_ranges(k, splits)
    nk = -(-k // bk)
    assert ranges[0][0] == 0 and ranges[-1][1] == nk
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    if splits > 1:
        assert min(e - b for b, e in ranges) >= SG.MIN_K_TILES
    # the grid fills the card, or K and the cluster size allow no more
    # splits; it stays within two CTAs per SM unless K is not split
    ctas = _ctas(m, n, k)
    assert ctas >= SG.SMS or \
        splits == max(1, min(SG.MAX_SPLITS, nk // SG.MIN_K_TILES))
    assert ctas <= SG.TARGET_CTAS or splits == 1


@pytest.mark.parametrize("m", [1, 8, 256])
def test_plan_fills_the_card_where_the_work_allows(m):
    """The MLP's up projections and the lm_head fill every SM; the
    896-wide projections and the down projection take every split their
    K and the cluster size allow."""
    assert _ctas(m, 4864, 896) >= SG.SMS
    assert _ctas(m, 152064, 896) >= SG.SMS
    assert SG.plan(m, 896, 4864)[3] == SG.MAX_SPLITS
    assert SG.plan(m, 896, 896)[3] == 896 // SG.BK // SG.MIN_K_TILES


def test_plan_at_decode_shapes():
    """The decode plans that measured fastest (or within 3% of it) in
    the kernel sweep on the H100; the lm_head needs no split."""
    assert SG.plan(8, 896, 896) == (8, 64, 64, 7)
    assert SG.plan(8, 4864, 896) == (8, 128, 64, 6)
    assert SG.plan(8, 896, 4864) == (8, 64, 64, 8)
    assert SG.plan(8, 152064, 896) == (8, 128, 64, 1)


FA = importlib.import_module("repro_torch.kernels.flash_attention")


@pytest.mark.parametrize("b,tq,tk,h,kh,causal",
                         [(1, 64, 64, 14, 2, True), (1, 256, 256, 14, 2, True),
                          (1, 512, 512, 14, 2, True), (2, 100, 96, 14, 2, True),
                          (2, 96, 100, 7, 1, False), (8, 256, 256, 14, 2, True),
                          (1, 0, 0, 14, 2, True)])
def test_flash_split_plan(b, tq, tk, h, kh, causal):
    """The key-range split of the tensor-core flash kernel: one cluster
    (at most 8 CTAs) per query block, never more CTAs than the heaviest
    block has key tiles, and within two CTAs per SM where it splits."""
    s = FA.plan(b, tq, tk, h, kh, causal)
    blocks = b * kh * -(-tq * (h // kh) // FA.BR)
    tiles = -(-(min(tq, tk) if causal else tk) // FA.BKV)
    assert 1 <= s <= FA.MAX_SPLITS and (s == 1 or s <= tiles)
    assert s == 1 or blocks * s <= FA.TARGET_CTAS
