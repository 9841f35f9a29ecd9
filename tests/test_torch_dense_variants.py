"""The dense variants of internvl2-2b, chatglm3-6b and granite-20b against
the reference, piece by piece, on the CPU.

- GELU: the port's ``apply_act`` is the tanh form of ``jax.nn.gelu``,
  within 1e-6 in fp32 over [-8, 8].  In bf16 it rounds once from fp32,
  so it is held to the reference's formula evaluated in fp32 on the same
  bf16 inputs and rounded once: within one bf16 ulp, or within 1e-6
  where fp32 ``tanh`` saturates in the far negative tail.
- The non-gated MLP (granite: ``wi``, ``bi``, ``wo``, ``bo``), the 2-D
  RoPE (chatglm3: the first half of each head rotated) and layernorm
  with a bias (granite), in fp32 and bf16.
- Prefill from precomputed embeddings (internvl2), then decode steps,
  with the reference's weights bridged; and the inputs prefill refuses.
- The paged kernel's query-head groups (granite's 48 heads of 128 over
  one KV head): ``head_groups``, ``launch_plan`` and the shared memory of a
  group's CTA, and a plain model of the grouped launch against the
  reference Pallas kernel (interpret mode).
- The full configs' parameter counts against the reference's
  ``n_params``.

Tolerances: fp32 3e-5 where GEMMs sum in another order (1e-6 for the
elementwise pieces); bf16 1e-2 · max(1, max|want|): bf16 rounding at
other places (the reference rounds each of its elementwise ops in bf16,
the port rounds once).  Logits as in ``test_torch_models.py``.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs import get_reduced as ref_reduced  # noqa: E402
from repro.kernels import paged_attention as jax_paged  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import from_reference  # noqa: E402

PA = importlib.import_module("repro_torch.kernels.paged_attention")
PLAN = importlib.import_module("test_torch_paged_plan")
logit_tol = importlib.import_module("test_torch_models").logit_tol


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _bf16_bits(a):
    """Each bf16 value's position on a line where neighbours differ by
    one (ulp distance is a difference of two such positions)."""
    b = torch.from_numpy(np.array(a, np.float32)).bfloat16() \
        .view(torch.int16).int().numpy()
    return np.where(b < 0, -(b & 0x7FFF), b)


def _pair(x, dt):
    return jnp.asarray(x, jnp.dtype(dt)), \
        torch.from_numpy(x).to(getattr(torch, dt))


# ---------------------------------------------------------------- GELU
GRID = np.linspace(-8, 8, 200_001, dtype=np.float32)


def test_gelu_matches_jax_fp32():
    """The tanh form, as ``jax.nn.gelu``; the erf form ``F.gelu(x)``
    (the port's GELU before) is 4.7e-4 away."""
    cfg = get_reduced("granite_20b")
    want = np.asarray(jax.nn.gelu(jnp.asarray(GRID)))
    got = PL.apply_act(torch.from_numpy(GRID), cfg).numpy()
    assert np.abs(got - want).max() <= 1e-6
    erf = F.gelu(torch.from_numpy(GRID)).numpy()
    assert np.abs(erf - want).max() > 4e-4


def test_gelu_bf16_within_one_ulp():
    cfg = get_reduced("granite_20b")
    xb = torch.from_numpy(GRID).bfloat16()
    want = np.asarray(jax.nn.gelu(jnp.asarray(xb.float().numpy()))
                      .astype(jnp.bfloat16).astype(jnp.float32))
    got = PL.apply_act(xb, cfg)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    ulps = np.abs(_bf16_bits(got) - _bf16_bits(want))
    assert ((ulps <= 1) | (np.abs(got - want) <= 1e-6)).all()
    assert (ulps == 0).mean() > 0.9


# ---------------------------------------------------- non-gated MLP
def _mlp_params(rng, d, f):
    return {"wi": rng.standard_normal((d, f), np.float32) * d ** -0.5,
            "bi": rng.standard_normal((f,), np.float32) * 0.1,
            "wo": rng.standard_normal((f, d), np.float32) * f ** -0.5,
            "bo": rng.standard_normal((d,), np.float32) * 0.1}


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_plain_mlp_matches_reference(dt):
    """granite's ``act(x·wi + bi)·wo + bo``, both GEMMs through the
    streaming GEMM's wrapper (its plain version on the CPU)."""
    cfg, rcfg = get_reduced("granite_20b"), ref_reduced("granite_20b")
    assert not cfg.glu and cfg.act == "gelu"
    rng = np.random.default_rng(0)
    p = _mlp_params(rng, cfg.d_model, cfg.d_ff)
    x = rng.standard_normal((2, 5, cfg.d_model), np.float32)
    jp = {k: _pair(v, dt)[0] for k, v in p.items()}
    tp = {k: _pair(v, dt)[1] for k, v in p.items()}
    want = _np(RL.apply_mlp(jp, _pair(x, dt)[0], rcfg))
    got = PL.apply_mlp(tp, _pair(x, dt)[1], cfg)
    assert got.dtype == getattr(torch, dt) and got.shape == (2, 5, 64)
    tol = 3e-5 if dt == "float32" else 1e-2 * max(1, np.abs(want).max())
    np.testing.assert_allclose(_np(got), want, atol=tol, rtol=0)


# --------------------------------------------------- RoPE and layernorm
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_rope_2d_matches_reference(dt):
    """chatglm3's 2-D RoPE rotates the first half of each head's pairs
    and passes the second half through unchanged."""
    cfg, rcfg = get_reduced("chatglm3_6b"), ref_reduced("chatglm3_6b")
    assert cfg.rope == "2d"
    rng = np.random.default_rng(1)
    hd = cfg.resolved_head_dim
    x = rng.standard_normal((2, 9, cfg.n_heads, hd), np.float32)
    pos = rng.integers(0, 4096, (2, 9)).astype(np.int32)
    jx, tx = _pair(x, dt)
    want = _np(RL.apply_rope(jx, jnp.asarray(pos), rcfg))
    got = PL.apply_rope(tx, torch.from_numpy(pos), cfg)
    tol = 1e-5 if dt == "float32" else 1e-2
    np.testing.assert_allclose(_np(got), want, atol=tol, rtol=tol)
    assert torch.equal(got[..., hd // 2:], tx[..., hd // 2:])
    assert not torch.equal(got[..., :hd // 2], tx[..., :hd // 2])


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_layernorm_with_bias_matches_reference(dt):
    cfg, rcfg = get_reduced("granite_20b"), ref_reduced("granite_20b")
    assert cfg.norm == "layernorm"
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 7, cfg.d_model), np.float32) * 3 + 0.5
    p = {"scale": rng.standard_normal((cfg.d_model,), np.float32),
         "bias": rng.standard_normal((cfg.d_model,), np.float32)}
    want = _np(RL.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                             _pair(x, dt)[0], rcfg))
    got = PL.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                        _pair(x, dt)[1], cfg)
    assert got.dtype == getattr(torch, dt)
    tol = 1e-5 if dt == "float32" else 1e-2
    np.testing.assert_allclose(_np(got), want, atol=tol, rtol=tol)


# --------------------------------------------- prefill from embeddings
@pytest.fixture(scope="module")
def vlm():
    arch = "internvl2_2b"
    rm = RefModel(ref_reduced(arch), remat="none")
    rp = rm.init(jax.random.PRNGKey(0))
    cfg = get_reduced(arch)
    assert cfg.family == "vlm" and cfg.embedding_inputs
    pp = from_reference(jax.tree.map(np.asarray, rp), cfg)
    return rm, rp, Model(cfg, device="cpu"), pp


def _logit_close(got, want):
    np.testing.assert_allclose(_np(got), _np(want), atol=logit_tol(want),
                               rtol=0)


def test_embedding_prefill_then_decode_matches_reference(vlm):
    """Reference ``prefill(params, {"embeddings": e}, S)`` against the
    port's ``prefill(..., embeddings=e)`` on the same numpy-seeded
    embeddings (cast to bf16 on both sides), then three decode steps on
    token ids through both caches."""
    rm, rp, pm, pp = vlm
    rng = np.random.default_rng(3)
    B, T, S = 2, 11, 32
    e = rng.standard_normal((B, T, pm.cfg.d_model), np.float32)
    rcache, want = rm.prefill(rp, {"embeddings": jnp.asarray(e)}, S)
    cache = pm.init_cache(B, S, page_tokens=4)
    for s in range(B):
        cache.alloc_seq(s, T)
    got = pm.prefill(pp, None, cache, list(range(B)),
                     embeddings=torch.from_numpy(e))
    assert got.dtype == torch.bfloat16
    _logit_close(got, want)
    assert (_np(got).argmax(-1) == _np(want).argmax(-1)).all()
    for step in range(3):
        toks = rng.integers(1, 250, B).astype(np.int32)
        rcache, want = rm.decode_step(rp, rcache, jnp.asarray(toks))
        got = pm.decode_step(pp, cache, torch.as_tensor(
            toks, dtype=torch.int64), list(range(B)))
        _logit_close(got, want)
    assert list(cache.lens[:B]) == [T + 3] * B
    cache.validate()


def test_embedding_prefill_equals_token_prefill_of_the_same_rows(vlm):
    """Embeddings that are the embedding table's rows give the token
    prefill's logits bit for bit."""
    _, _, pm, pp = vlm
    toks = torch.as_tensor(np.random.default_rng(4).integers(1, 250, (1, 9)))
    out = []
    for kw in ({"tokens": toks}, {"tokens": None,
                                  "embeddings": pp["embed"][toks].float()}):
        cache = pm.init_cache(1, 16)
        cache.alloc_seq(0, 9)
        out.append(pm.prefill(pp, cache=cache, slots=[0], **kw))
    assert torch.equal(out[0], out[1])


def test_prefill_takes_exactly_one_input(vlm):
    _, _, pm, pp = vlm
    cache = pm.init_cache(1, 16)
    cache.alloc_seq(0, 4)
    toks = torch.ones((1, 4), dtype=torch.int64)
    e = torch.zeros((1, 4, pm.cfg.d_model))
    with pytest.raises(ValueError, match="exactly one"):
        pm.prefill(pp, toks, cache, [0], embeddings=e)
    with pytest.raises(ValueError, match="exactly one"):
        pm.prefill(pp, None, cache, [0])
    dense = Model(get_reduced("qwen2_0_5b"), device="cpu")
    with pytest.raises(ValueError, match="token ids"):
        dense.prefill(None, None, cache, [0], embeddings=e)


# ---------------------------------------- paged attention: head groups
def test_head_groups_rule():
    """One group while G·D <= 2,048 (every shape served before, and
    chatglm3's 16 x 128 exactly at the cap); granite's 48 x 128 takes 3
    groups of 16 heads; a count that does not divide G grows to one
    that does."""
    assert PA.head_groups(7, 64) == 1             # qwen2-0.5b
    assert PA.head_groups(1, 128) == 1            # qwen2-moe
    assert PA.head_groups(2, 128) == 1            # internvl2-2b
    assert PA.head_groups(16, 128) == 1           # chatglm3-6b
    assert PA.head_groups(48, 128) == 3           # granite-20b
    assert PA.head_groups(21, 128) == 3           # ⌈2688/2048⌉ = 2 ∤ 21
    assert PA.head_groups(25, 128) == 5
    for D in PA.HEAD_DIMS:
        for G in range(1, 129):
            n = PA.head_groups(G, D)
            assert G % n == 0 and (G // n) * D <= PA.MAX_GROUP_ELEMS
            assert all(G % m or (G // m) * D > PA.MAX_GROUP_ELEMS
                       for m in range(1, n))


@pytest.mark.parametrize("b,max_pages,want", [
    (8, 64, 6),       # 8 sequences x 3 groups: 24 rows -> 144 CTAs
    (8, 17, 6),
    (1, 64, 8),
    (44, 64, 1),      # 132 rows fill the card alone
    (8, 3, 2),        # capped at half the table
])
def test_plan_counts_head_groups(b, max_pages, want):
    """granite (KH 1, 3 groups): ``launch_plan`` counts B · KH · groups
    rows."""
    assert PA.launch_plan(b, 48, 1, 128, max_pages) == (3, want)
    assert PA.plan(b, 3, max_pages) == want


@pytest.mark.parametrize("H,KH,D", [(14, 2, 64), (16, 16, 128),
                                    (16, 8, 128), (32, 2, 128)])
@pytest.mark.parametrize("b,max_pages", [(8, 64), (1, 17), (44, 64)])
def test_launch_plan_one_group_is_the_kv_head_plan(H, KH, D, b, max_pages):
    """qwen2-0.5b, qwen2-moe, internvl2-2b and chatglm3-6b take one
    group, and their split is the plan over their KV heads, as before
    the groups."""
    assert PA.launch_plan(b, H, KH, D, max_pages) == \
        (1, PA.plan(b, KH, max_pages))


@pytest.mark.parametrize("page,mp,esz,walk", [
    (16, 64, 2, 4), (16, 64, 4, 4), (32, 64, 2, 4), (32, 64, 4, 2),
    (8, 1000, 4, 4), (16, 4096, 2, 4)])
def test_group_shared_memory_fits(page, mp, esz, walk):
    """A granite group's CTA (16 heads of 128) fits 227 KB at every page
    size and dtype, with two walking warps only for 32-token fp32 pages;
    the whole 48 heads in one CTA would not fit the registers' cap."""
    G = 48 // PA.head_groups(48, 128)
    assert G * 128 == PA.MAX_GROUP_ELEMS
    assert PA.walkers(G, 128, page, mp, esz) == walk
    assert PA.smem_bytes(G, 128, page, mp, walk, esz) <= PA.MAX_SMEM_BYTES


def grouped_model(q, k_pages, v_pages, table, lens, splits, groups):
    """The grouped launch in plain PyTorch: grid row y = kh · groups + g
    takes query heads [y·G', (y+1)·G') over KV head y // groups, i.e. the
    ungrouped kernel over a pool whose KV heads are each repeated
    ``groups`` times; each row split over ``splits`` ranks as the kernel
    splits it (``test_torch_paged_plan.split_model``)."""
    return PLAN.split_model(q, k_pages.repeat_interleave(groups, dim=2),
                            v_pages.repeat_interleave(groups, dim=2), table,
                            lens, splits)


@pytest.mark.parametrize("splits", [1, 3, 6])
def test_grouped_model_matches_reference_kernel(splits):
    """granite's heads (48 over one KV head of 128, 3 groups) and a GQA
    case with 2 KV heads of 2 groups each, lengths 0, 1, a page boundary
    and the full table, against the Pallas kernel in fp32 (3e-5)."""
    for case, groups in (((4, 48, 1, 128, 16, 4, (0, 1, 16, 64)), 3),
                         ((2, 8, 2, 64, 8, 3, (24, 9)), 2)):
        args = PLAN._inputs(case, seed=splits)
        want = np.asarray(jax_paged(*(jnp.asarray(a) for a in args),
                                    interpret=True))
        got = grouped_model(*(torch.from_numpy(a) for a in args), splits,
                            groups).numpy()
        np.testing.assert_allclose(got, want, rtol=3e-5, atol=3e-5)
        for b, length in enumerate(case[-1]):
            assert length or not got[b].any()


# ------------------------------------------------- full config sizes
@pytest.mark.parametrize("arch,gb", [("internvl2_2b", 3.78),
                                     ("chatglm3_6b", 12.49),
                                     ("granite_20b", 40.63),
                                     ("qwen1_5_32b", 70.39)])
def test_full_config_sizes(arch, gb):
    """The port's matrices hold the reference's ``n_params()`` (norms and
    biases aside), in bf16 ``gb`` GB; KV is 2 · layers · KH · D · 2 B a
    token."""
    cfg, rcfg = get_config(arch), ref_config(arch)
    spec = PT.lm_pspecs(cfg)
    mats = 0
    for layer in spec["layers"]:
        mats += sum(int(np.prod(p.shape))
                    for p in _flat(layer) if p.init == "normal")
    mats += sum(int(np.prod(spec[k].shape)) for k in ("embed", "lm_head"))
    assert mats == rcfg.n_params()
    assert round(2 * mats / 1e9, 2) == gb
    kv = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.resolved_head_dim * 2
    assert kv == {"internvl2_2b": 98_304, "chatglm3_6b": 28_672,
                  "granite_20b": 26_624, "qwen1_5_32b": 1_310_720}[arch]


def _flat(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _flat(v)
    else:
        yield tree
