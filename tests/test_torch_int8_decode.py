"""The INT8 KV cache's decode on the CPU: the int8 kernel's launch plan
(``paged_attention.int8_plan``) and the decode step's fused
quantize-and-append (``ops.paged_attention_append``, whose plain version
the wrapper takes on the CPU) against the reference's int8 decode
(``repro/models/layers.py:148-177`` and ``:264-277``).

Tolerances are those of ``tests/test_torch_int8_kv.py``: the codes and
scales bitwise; attention outputs within 2e-2 (one bf16 ulp of O(1)
outputs with margin: the reference rounds ``p · v_scale`` to bf16, the
port keeps P in fp32); a layer's output within ``logit_tol`` of
``test_torch_models.py``, max(1e-2, 1.5e-2 · max|x|).
"""
import importlib
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as ref_reduced  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_reduced  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models import tuning as TU  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving.kv_cache import DecodeView  # noqa: E402

PA = importlib.import_module("repro_torch.kernels.paged_attention")
INT8 = importlib.import_module("test_torch_int8_kv")
SERVING = importlib.import_module("test_torch_serving")
logit_tol = importlib.import_module("test_torch_models").logit_tol
ATT_TOL = INT8.ATT_TOL


# ------------------------------------------------------------- the plan
@pytest.mark.parametrize("B,G,KH,tier,groups", [
    (8, 1, 40, 1, 1),       # qwen1.5-32b: 320 rows
    (8, 7, 2, 1, 7),        # qwen2-0.5b: 16 rows, one head a group
    (8, 48, 1, 2, 24),      # granite-20b: 8 rows, 24 groups reach 192
    (8, 16, 2, 1, 16),      # chatglm3-6b
    (8, 2, 8, 1, 2),        # internvl2-2b: 64 rows
    (128, 7, 2, 8, 1),      # 256 rows: qwen2-0.5b's heads in one CTA
    (128, 48, 1, 8, 6),     # 128 rows: granite's 48 in groups of 8
    (32, 16, 2, 4, 4),      # 64 rows: 4 groups of 4 reach 256
    (40, 3, 4, 4, 1),       # 160 rows: 3 heads in the 4-head tier
    (70, 2, 2, 2, 1),       # 140 rows
    (4, 12, 1, 1, 12)])     # no grouping reaches 132 rows
def test_int8_plan_tier_and_head_groups(B, G, KH, tier, groups):
    """G query heads a KV head over B · KH grid rows: the fewest equal
    head groups of at most 8 heads that give the grid 132 rows (one a
    head where none does), and the least tier of 1, 2, 4, 8 that holds
    a group."""
    plan = PA.int8_plan(B, G * KH, KH, 128, 64)
    assert (plan.tier, plan.groups) == (tier, groups)
    assert PA.int8_head_groups(G, B * KH) == groups


def _int8_archs():
    """(arch, H, KH, D) of every arch whose cache turns int8 under the
    flag, at full width and reduced."""
    out = []
    for arch in ARCH_IDS:
        red = get_reduced(arch)
        enc = 16 if red.family == "audio" else 0
        with TU.tuning_context(TU.Tuning(kv_cache_quant=True)):
            cache = Model(red, device="cpu").init_cache(2, 16, enc_seq=enc)
        pool = getattr(cache, "k_pages", None)
        if pool is None or pool.dtype != torch.int8:
            continue
        for cfg in (get_config(arch), red):
            out.append((arch, cfg.n_heads, cfg.n_kv_heads,
                        cfg.resolved_head_dim))
    return out


def test_int8_archs_cover_the_served_head_shapes():
    """The archs whose caches turn int8 serve G 1, 2, 7, 16 and 48 at D
    64 and 128 (full width) and D 16 (reduced)."""
    shapes = _int8_archs()
    assert {h // kh for _, h, kh, _ in shapes} >= {1, 2, 7, 16, 48}
    assert {d for *_, d in shapes} == {16, 64, 128}


@pytest.mark.parametrize("page", PA.PAGE_SIZES)
def test_int8_plan_for_every_served_shape(page):
    """For every int8 arch (full and reduced), batch 1 and 8, and table
    widths 1 to 4,096: the head groups split G equally into groups of at
    most the tier, no fewer groups would do, the split S is within
    1..8 and at most half the table's width, the ring holds 2-4 slots a
    warp, and the CTA fits 227 KB."""
    for arch, H, KH, D in _int8_archs():
        G = H // KH
        for B in (1, 8):
            for mp in (1, 2, 7, 64, 128, 4096):
                plan = PA.int8_plan(B, H, KH, D, mp, page)
                gh = G // plan.groups
                assert G % plan.groups == 0 and gh <= plan.tier <= 8
                assert plan.tier in PA.INT8_TIERS
                assert plan.tier == 1 or plan.tier // 2 < gh
                assert all(G % n or G // n > 8 or B * KH * n < PA.SMS
                           for n in range(1, plan.groups)), (arch, G)
                assert plan.groups == G or B * KH * plan.groups >= PA.SMS
                assert 1 <= plan.splits <= max(1, min(8, -(-mp // 2)))
                assert PA.INT8_RING[0] <= plan.ring <= PA.INT8_RING[1]
                smem = PA.int8_smem_bytes(plan.tier, D, page, mp, plan.ring)
                assert smem <= PA.MAX_SMEM_BYTES, (arch, B, mp, smem)


def test_int8_plan_reads_the_table_width_not_lens():
    """The plan takes shapes only: the lengths live on the device."""
    assert list(inspect.signature(PA.int8_plan).parameters) == \
        ["B", "H", "KH", "D", "max_pages", "page"]


@pytest.mark.parametrize("B,H,KH,D,mp,want", [
    (8, 40, 40, 128, 64, 1),     # qwen1.5-32b: 320 rows, 85 MB of tables
    (8, 40, 40, 128, 128, 1),    # its serving table (2,048 tokens)
    (1, 40, 40, 128, 128, 4),    # one sequence: 40 rows fill the card
    (8, 14, 2, 64, 64, 4),       # qwen2-0.5b: 7 groups, 112 rows, a wave
    (8, 48, 1, 128, 64, 2),      # granite-20b: 24 groups, 192 rows
    (8, 16, 16, 128, 64, 2),     # qwen2-moe-a2.7b: 128 rows, 34 MB
    (8, 16, 8, 128, 64, 2),      # internvl2-2b: 2 groups, 17 MB
    (8, 6, 6, 64, 64, 6),        # whisper-tiny: 48 rows, 6.4 MB
    (8, 14, 2, 64, 1, 1),        # a one-page table
    (8, 14, 2, 64, 5, 3)])       # at most half the table's width
def test_int8_plan_split_rule(B, H, KH, D, mp, want):
    """S, within 1..8 and half the table's width, gives the card at least
    one CTA an SM, and beyond that splits no further than one wave
    (``int8_ctas_per_sm`` CTAs an SM: 4 at tiers 1-2 and D <= 64, else 3,
    fewer where their shared memory does not fit 228 KB) nor than the
    full tables' bytes allow (``BANDWIDTH_BOUND_BYTES``); where the data
    allow, the grid keeps at least ``INFLIGHT_BYTES`` in flight (two
    slots of a page's K, V and scales for each of a CTA's warps)."""
    plan = PA.int8_plan(B, H, KH, D, mp)
    assert plan.splits == want
    rows = B * KH * plan.groups
    wave = PA.SMS * PA.int8_ctas_per_sm(plan.tier, D, 16, mp, 2)
    cap = max(1, min(8, -(-mp // 2)))
    nbytes = B * KH * mp * 16 * (2 * D + 4)
    assert rows * plan.splits >= PA.SMS or plan.splits == cap
    if rows * (plan.splits - 1) >= PA.SMS:      # split past filling the SMs
        assert rows * plan.splits <= wave
        assert plan.splits * nbytes <= PA.BANDWIDTH_BOUND_BYTES
    slots = min(PA.WARPS * 2, -(-mp // plan.splits))
    inflight = rows * plan.splits * slots * 2 * 16 * (D + 2)
    if B == 8 and mp >= 64:
        assert inflight >= PA.INFLIGHT_BYTES, inflight


def test_int8_plan_ring_deepens_only_on_small_grids():
    """Two slots a warp where the grid has more CTAs than SMs; on a
    smaller grid as many as a warp's pages of a full table, at most 4."""
    assert PA.int8_plan(8, 40, 40, 128, 64).ring == 2
    assert PA.int8_plan(1, 6, 6, 64, 128).ring == 4  # 6 rows x S 8
    assert PA.int8_plan(1, 6, 6, 64, 20).ring == 2   # 3 pages a CTA


@pytest.mark.parametrize("tier,D,page,mp,ring,want", [
    (1, 128, 16, 64, 2, 3),      # 37 KB: the registers bound it
    (1, 64, 16, 64, 2, 4),
    (8, 128, 32, 64, 2, 2),      # 80 KB a CTA: two fit 228 KB
    (8, 128, 32, 4096, 4, 1)])
def test_int8_ctas_per_sm(tier, D, page, mp, ring, want):
    """The CTAs an SM the plan's wave counts on: the launch bounds' three
    (four at tiers 1-2 and D <= 64), fewer where shared memory runs out
    (the card tests hold it to cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    assert PA.int8_ctas_per_sm(tier, D, page, mp, ring) == want


def test_int8_smem_bytes_mirrors_the_kernel_layout():
    """The layout of ``csrc/paged_int8.cu`` by hand at tier 1, D 128,
    16-token pages, a 64-page table and 2 slots a warp: the boxes
    (32,768), the scale pages (512), the barriers (64), q (512), the
    probabilities (256), the warps' m, l and weights (48), the CTA's m
    and l (32), acc (512), the merge weights (32), 1 / l (16), the
    appended row (272 rounded from 260), the ids (256), and the 1 KB
    alignment slack."""
    assert PA.int8_smem_bytes(1, 128, 16, 64, 2) == 36304
    # a slot more a warp: four K and V boxes, scale pages and barriers
    assert PA.int8_smem_bytes(1, 128, 16, 64, 3) - \
        PA.int8_smem_bytes(1, 128, 16, 64, 2) == 4 * (2 * 16 * 128 + 4 * 16
                                                      + 8)


# ------------------------------------------- the fused append's plain path
def _ref_append(x):
    """The reference's quantization of a decode row (layers.py:264-267)."""
    s = jnp.max(jnp.abs(x), -1) / 127.0 + 1e-8
    return jnp.round(x / s[..., None]).astype(jnp.int8), s.astype(
        jnp.float16)


@pytest.mark.parametrize("H,KH,D", [(8, 2, 16), (6, 6, 64), (12, 1, 32),
                                    (4, 4, 16)])
def test_paged_attention_append_matches_reference_decode(H, KH, D):
    """``ops.paged_attention_append`` on the CPU (the plain quantize and
    append, then ``paged_ref``) against the reference's int8 decode step:
    the new row quantized as ``attention_decode`` does, set into the
    cache at each sequence's length, then ``decode_attention`` with the
    scales.  The codes and scales written equal the reference's bit for
    bit and no other row moves; outputs within 2e-2, ragged lengths."""
    rng = np.random.default_rng(H * D)
    B, S, page = 4, 32, 8
    k, ks, v, vs = INT8._int8_cache(rng, B, S, KH, D)
    qj, qt = INT8._bf16(rng.standard_normal((B, H, D)))
    kj, kt = INT8._bf16(rng.standard_normal((B, KH, D)) * 2)
    vj, vt = INT8._bf16(rng.standard_normal((B, KH, D)))
    pos = np.array([31, 16, 0, 7], np.int32)       # the new token's place
    kq, kqs = _ref_append(kj)
    vq, vqs = _ref_append(vj)
    b = jnp.arange(B)
    kc, vc = k.at[b, pos].set(kq), v.at[b, pos].set(vq)
    ksc, vsc = ks.at[b, pos].set(kqs), vs.at[b, pos].set(vqs)
    want = INT8._np(RL.decode_attention(qj, kc, vc, jnp.asarray(pos + 1),
                                        k_scale=ksc, v_scale=vsc))

    kp, ksp, table = INT8._to_pages(k, ks, page)
    vp, vsp, _ = INT8._to_pages(v, vs, page)
    before = [t.clone() for t in (kp, vp, ksp, vsp)]
    pools = (kp, vp, ksp, vsp)
    rows = torch.from_numpy(
        (np.asarray(table)[np.arange(B), pos // page] * page + pos % page)
        .astype(np.int64))
    got = ops.paged_attention_append(qt, kt, vt, rows, pools, table,
                                     torch.from_numpy(pos + 1))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(INT8._np(got), want, atol=ATT_TOL,
                               rtol=ATT_TOL)
    for new, old, wc, ws, pool, sc in (
            (kq, before[0], kqs, None, kp, ksp),
            (vq, before[1], vqs, None, vp, vsp)):
        assert np.array_equal(pool.view(-1, KH, D)[rows].numpy(),
                              np.asarray(new))
        assert np.array_equal(sc[rows // page, :, rows % page].numpy(),
                              np.asarray(wc))
        moved = (pool != old).view(-1, KH, D).any(-1).any(-1)
        assert set(torch.nonzero(moved).flatten().tolist()) <= \
            set(rows.tolist())
    assert ops.LAUNCHES["paged_attention_int8_append"] == 0


# ------------------------------------------- attention_decode over int8
@pytest.mark.parametrize("arch", ["qwen1_5_32b", "qwen2_0_5b",
                                  "granite_20b"])
def test_attention_decode_over_int8_pools_matches_reference(arch):
    """A layer's decode attention (reduced width, layer 0's bridged
    weights): the port's ``attention_decode`` over int8 pools, through
    ``ops.paged_attention_append``, against the reference's
    ``attention_decode`` with an int8 cache.  Each sequence's new row
    lands in the pools with the reference cache's codes and scales,
    bit for bit; the layer's output is within ``logit_tol``."""
    rp, pp = SERVING._weights(arch)
    rcfg, pcfg = ref_reduced(arch), get_reduced(arch)
    p_ref = jax.tree.map(lambda a: a[0], rp["layers"]["attn"])
    p_port = pp["layers"][0]["attn"]
    KH, D = pcfg.n_kv_heads, pcfg.resolved_head_dim
    rng = np.random.default_rng(5)
    B, S, page = 3, 24, 8
    k, ks, v, vs = INT8._int8_cache(rng, B, S, KH, D)
    xj, xt = INT8._bf16(rng.standard_normal((B, pcfg.d_model)))
    pos = np.array([5, 16, 23], np.int32)
    cache = {"k": k, "v": v, "k_scale": ks, "v_scale": vs,
             "len": jnp.asarray(pos)}
    want, new = RL.attention_decode(p_ref, xj, rcfg, cache)

    kp, ksp, table = INT8._to_pages(k, ks, page)
    vp, vsp, _ = INT8._to_pages(v, vs, page)
    rows = torch.from_numpy(
        (np.asarray(table)[np.arange(B), pos // page] * page + pos % page)
        .astype(np.int64))
    view = DecodeView(positions=torch.from_numpy(pos.astype(np.int64)),
                      write_index=rows, table=table,
                      lens=torch.from_numpy(pos + 1))
    ops.reset_launches()
    got = PL.attention_decode(p_port, xt, pcfg, (kp, vp, ksp, vsp), view)
    assert not any(ops.LAUNCHES.values())          # the CPU: plain versions
    b = np.arange(B)
    for name, pool, sc in (("k", kp, ksp), ("v", vp, vsp)):
        assert np.array_equal(pool.view(-1, KH, D)[rows].numpy(),
                              np.asarray(new[name])[b, pos])
        assert np.array_equal(sc[rows // page, :, rows % page].numpy(),
                              np.asarray(new[name + "_scale"])[b, pos])
    np.testing.assert_allclose(INT8._np(got), INT8._np(want),
                               atol=logit_tol(INT8._np(want)), rtol=0)
