"""Multi-head latent attention (MLA) and deepseek-v3-671b against the
reference on the CPU, at the reduced config (2 layers: one dense, one
MoE of 8 experts, top-2, one shared; d 64, 4 heads; q/k dim 16 + 8 = 24,
v dim 16, latent 16 + 8), with the reference's bf16 weights
(``Model.init(PRNGKey(0))``) bridged by ``from_reference``.

The port runs MLA's prefill through flash attention at q/k dim ≠ v dim
and its decode in the absorbed form over a paged latent pool (one pool
row [ckv | kr] a token, V its first r columns).  On the CPU both
wrappers run their plain versions, which keep the softmax
probabilities P in fp32 where the reference rounds them to bf16
(``chunked_attention``; ``mla_decode``'s ``pattn.astype``).  So the
model is held twice, as ``test_torch_hybrid.py`` holds the hybrid:

- with the reference's arithmetic: both wrappers replaced by the
  reference's attention (``layers.chunked_attention``; a latent decode
  that rounds P to bf16 over the same pages) and the dense MLP's SiLU
  rounded op by op, against the reference run op by op
  (``jax.disable_jit()``).  The logits then came out equal bit for bit;
  they are held at ``logit_tol`` of ``test_torch_models.py``.
- as the port runs (the kernels' plain versions), against the reference
  as it serves (jitted), at ``LOGIT_TOL`` = 2.5e-2 · max(1, max|logit|),
  the MoE model's tolerance (``test_torch_moe_model.py``: P's rounding
  and XLA's fused bf16 ops move these logits by 1-1.6% of their max,
  measured), with every (layer, token)'s expert set recorded on both
  sides; greedy tokens are compared while a request's routing agrees.

Block tolerances: fp32 3e-5 (sums in another order); the latents, which
no attention reaches, 1e-2 of their largest magnitude (one bf16 ulp);
the attention outputs 2e-2 absolute and relative (one bf16 ulp of O(1)
values, after P kept in fp32).
"""
import importlib
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs import get_reduced as ref_reduced  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro.serving.engine import Request as RefRequest  # noqa: E402
from repro.serving.engine import ServingEngine as RefEngine  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.configs.deepseek_v3_671b import SERVING  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import from_reference, to_torch  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.serving.kv_cache import PagedKVCache  # noqa: E402

MOE_MODEL = importlib.import_module("test_torch_moe_model")
logit_tol = importlib.import_module("test_torch_models").logit_tol
_leaves = MOE_MODEL._leaves

ARCH = "deepseek_v3_671b"
LOGIT_TOL = 2.5e-2
F32_TOL = 3e-5
BF16_TOL = 2e-2
LATENT_RTOL = 1e-2
S = 64                          # max_seq of the caches and engines


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, rtol):
    """Within ``rtol`` of want's largest magnitude (at least 1)."""
    want = _np(want)
    np.testing.assert_allclose(
        _np(got), want, rtol=0,
        atol=rtol * max(1.0, float(np.abs(want).max())))


def _close_latent(got, want):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=LATENT_RTOL * np.abs(want).max())


@pytest.fixture(scope="module")
def pair():
    rm = RefModel(ref_reduced(ARCH), remat="none")
    rp = rm.init(jax.random.PRNGKey(0))
    cfg = get_reduced(ARCH)
    pp = from_reference(jax.tree.map(np.asarray, rp), cfg)
    return rm, rp, Model(cfg, device="cpu"), pp


def _latent_as_reference(q, pool, table, lens, dv, scale):
    """``ops.paged_latent_attention`` with the reference's decode
    arithmetic: the pages gathered into a contiguous latent cache, fp32
    scores divided by 1/scale, the masked softmax, P rounded to the
    cache's dtype before PV."""
    B = q.shape[0]
    c = pool[table.long()].reshape(B, -1, pool.shape[-1])
    s = torch.einsum("bhd,bsd->bhs", q.float(), c.float()) \
        / math.sqrt(1 / scale ** 2)
    valid = torch.arange(c.shape[1])[None] < lens.long()[:, None]
    s = torch.where(valid[:, None], s, torch.full_like(s, PL.NEG_INF))
    p = torch.softmax(s, dim=-1).to(c.dtype)
    return torch.einsum("bhs,bsr->bhr", p.float(),
                        c[..., :dv].float()).to(q.dtype)


@pytest.fixture
def ref_arithmetic(monkeypatch):
    """The reference model's arithmetic in the port: prefill attention
    through ``layers.chunked_attention`` and decode attention through
    ``_latent_as_reference`` (P rounded to bf16 in both), and the dense
    MLP's SiLU rounded op by op, as the reference's ops run one by one
    (the MoE experts' SiLU already is)."""
    monkeypatch.setattr(
        ops, "flash_attention",
        lambda q, k, v, causal=True, bk=512: PL.chunked_attention(
            q, k, v, causal=causal))
    monkeypatch.setattr(ops, "paged_latent_attention", _latent_as_reference)
    monkeypatch.setattr(PL, "apply_act",
                        lambda x, cfg: x * PL.sigmoid_op_by_op(x))


# ----------------------------------------------------------- the tree
@pytest.mark.parametrize("reduced", [True, False])
def test_mla_pspec_tree_matches_reference(reduced):
    """Leaf for leaf, the MLA attention of both stacks and the MTP head
    included: shape, init law, scale and dtype."""
    rcfg = ref_reduced(ARCH) if reduced else ref_config(ARCH)
    pcfg = get_reduced(ARCH) if reduced else get_config(ARCH)
    rspec, pspec = RT.lm_pspecs(rcfg), PT.lm_pspecs(pcfg)
    assert list(pspec) == list(rspec) == ["embed", "lm_head", "final_norm",
                                          "dense_layers", "layers", "mtp"]
    nd = pcfg.moe.first_dense_layers
    for name, n in (("dense_layers", nd), ("layers", pcfg.n_layers - nd)):
        assert len(pspec[name]) == n
        rlayer = dict(_leaves(rspec[name]))
        plist = list(_leaves(pspec[name][0]))
        assert {p for p, _ in plist} == set(rlayer)
        assert {p for p, _ in plist if p.startswith("/attn/")} == {
            f"/attn/{k}" for k in ("wdq", "q_norm/scale", "wuq", "wdkv",
                                   "kv_norm/scale", "wkr", "wuk", "wuv",
                                   "wo")}
        for path, p in plist:
            r = rlayer[path]
            assert (n,) + p.shape == r.shape, path
            assert (p.init, p.scale, p.dtype) == (r.init, r.scale,
                                                  r.dtype), path
            assert p.shape[p.fan_axis] == r.shape[r.fan_axis], path
    for key in ("embed", "lm_head", "final_norm", "mtp"):
        got, want = list(_leaves(pspec[key])), list(_leaves(rspec[key]))
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path, p), (_, r) in zip(got, want):
            assert (p.shape, p.init, p.scale, p.dtype) == \
                (r.shape, r.init, r.scale, r.dtype), path


def test_from_reference_is_bitwise_and_adds_the_absorbed_layouts(pair):
    """Every reference leaf, the MTP head's included, equal in dtype,
    shape and bits; each layer's attention also carries ``wuk_hkr`` (H,
    nope, r) and ``wuv_hrv`` (H, r, v), contiguous copies of ``wuk`` and
    ``wuv`` in the absorbed decode's layout."""
    rm, rp, pm, pp = pair
    rp_np = jax.tree.map(np.asarray, rp)
    stacks = ("layers", "dense_layers")
    got = dict(_leaves({k: v for k, v in pp.items() if k not in stacks}))
    n = 0
    for path, leaf in _leaves({k: v for k, v in rp_np.items()
                               if k not in stacks}):
        MOE_MODEL._assert_same(got[path], leaf)
        n += 1
    assert n == len(got)
    cfg, m = pm.cfg, pm.cfg.mla
    for name in stacks:
        assert len(pp[name]) == len(rp_np[name]["ln1"]["scale"])
        for i, layer in enumerate(pp[name]):
            want = dict(_leaves(jax.tree.map(lambda a: a[i], rp_np[name])))
            got_l = dict(_leaves(layer))
            assert set(got_l) == set(want) | {"/attn/wuk_hkr",
                                              "/attn/wuv_hrv"}
            for path, leaf in want.items():
                MOE_MODEL._assert_same(got_l[path], leaf)
            a = layer["attn"]
            assert a["wuk_hkr"].shape == (cfg.n_heads, m.qk_nope_head_dim,
                                          m.kv_lora_rank)
            assert torch.equal(a["wuk_hkr"], a["wuk"].permute(1, 2, 0))
            assert torch.equal(a["wuv_hrv"], a["wuv"].permute(1, 0, 2))
            assert a["wuk_hkr"].is_contiguous()
            assert a["wuv_hrv"].is_contiguous()


def test_full_config_sizes_and_what_n_params_counts():
    """deepseek-v3-671b's tree at full width: embed and lm_head 926.7 M
    values each, a dense layer 231.2 M (MLA 187.1 M), a MoE layer 11.507
    G, the MTP head 333.9 M.  The reference's ``n_params()`` counts every
    one of the 61 layers as a MoE layer and leaves out the MTP head and
    the norms: 703,796,805,632 (1,407.6 GB), against the tree's
    670,302,339,072 matrix values.  The serving cut
    (``deepseek-v3-671b-5l``: the 3 dense layers and 2 MoE layers) holds
    51.79 GB in bf16, every width published."""
    cfg, rcfg = get_config(ARCH), ref_config(ARCH)
    spec = PT.lm_pspecs(cfg)

    def size(tree, mats=False):
        return sum(int(np.prod(p.shape)) for _, p in _leaves(tree)
                   if not mats or p.init == "normal")

    dense, moe = spec["dense_layers"][0], spec["layers"][0]
    assert size(spec["embed"]) == size(spec["lm_head"]) == 926_679_040
    assert (size(dense), size(dense["attn"])) == (231_161_856, 187_107_328)
    assert size(moe) == 11_507_286_016
    assert size(spec["mtp"]) == 333_936_640
    assert rcfg.n_params() == 703_796_805_632
    assert size(spec, mats=True) == 670_302_339_072 == rcfg.n_params() \
        - 3 * (size(moe, True) - size(dense, True)) + size(spec["mtp"], True)
    assert SERVING.name == "deepseek-v3-671b-5l" and SERVING.n_layers == 5
    assert SERVING.mla == cfg.mla and SERVING.moe == cfg.moe
    cut = PT.lm_pspecs(SERVING)
    nbytes = sum(int(np.prod(p.shape)) * (4 if p.dtype == "float32" else 2)
                 for _, p in _leaves(cut))
    assert nbytes == 51_790_958_592
    assert (len(cut["dense_layers"]), len(cut["layers"])) == (3, 2)


def test_init_scales_in_place_with_the_same_values():
    """``init_tree`` scales its fp32 draw in place (one 15 GB temporary
    for a deepseek-v3 expert leaf, not two): the weights are those of
    ``(randn * scale).to(bf16)`` from the same generator."""
    from repro_torch.models.params import PSpec, init_tree
    tree = {"w": PSpec((48, 3, 40), ("a", "b", "c")),
            "e": PSpec((5, 7), ("a", "b"), scale=0.02)}
    got = init_tree(tree, torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(3)
    for name, scale in (("w", 48 ** -0.5), ("e", 0.02)):
        want = (torch.randn(tree[name].shape, generator=g) * scale).to(
            torch.bfloat16)
        assert torch.equal(got[name], want), name


def test_moe_path_shapes_at_256_experts():
    """The existing MoE path at deepseek-v3's widths: the router's 7,168
    x 256 takes the tensor-core layout (N and K multiples of 8), and
    ``plan_grouped`` plans 256 experts at decode and at a 256-token
    prefill: one CTA per SM, a token ring of 8 rows at decode and of 64
    (the largest chunk) at prefill, within the shared memory."""
    from repro_torch.kernels import grouped_gemm as GG
    from repro_torch.kernels.streaming_gemm import mma_layout
    x = torch.zeros(8, 7168, dtype=torch.bfloat16)
    router = torch.zeros(7168, 256, dtype=torch.bfloat16)
    assert mma_layout(x, router) == (False, 256)
    for C in (8, 256):
        for N, K in ((2048, 7168), (7168, 2048)):
            grid, stages, nt_max = GG.plan_grouped(256, C, N, K)
            assert grid == GG.SMS and nt_max == min(C, GG.CHUNK)
            assert GG.smem_bytes(256, stages, nt_max) <= GG.SMEM_LIMIT


# ------------------------------------------------------------ blocks
def test_apply_rope_rotates_the_first_dim_values():
    """``dim`` rotates the first ``dim`` values with ``rope_freqs(dim)``,
    as the reference: fp32 within 3e-5."""
    rng = np.random.default_rng(0)
    cfg, rcfg = get_reduced(ARCH), ref_reduced(ARCH)
    x = rng.standard_normal((2, 7, 4, 24)).astype(np.float32)
    pos = rng.integers(0, 500, (2, 7))
    for dim in (8, 16, 24):
        want = RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), rcfg, dim=dim)
        got = PL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), cfg,
                            dim=dim)
        np.testing.assert_allclose(_np(got), _np(want), atol=F32_TOL,
                                   rtol=F32_TOL)
        assert torch.equal(got[..., dim:], torch.from_numpy(x)[..., dim:])


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_version_at_v_dim_not_qk_dim(causal):
    """The flash wrapper's plain version (q/k dim 24, v dim 16, G = 2)
    against the reference's ``chunked_attention`` over three 8-key
    chunks in fp32 (3e-5): scale 1/√24 and the output's width 16."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 24, 4, 24)).astype(np.float32)
    k = rng.standard_normal((2, 24, 2, 24)).astype(np.float32)
    v = rng.standard_normal((2, 24, 2, 16)).astype(np.float32)
    want = RL.chunked_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                                q_chunk=8, kv_chunk=8)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=causal, bk=24)
    assert got.shape == (2, 24, 4, 16)
    np.testing.assert_allclose(_np(got), _np(want), atol=F32_TOL,
                               rtol=F32_TOL)
    assert torch.equal(got, ref.flash_gqa_ref(
        *map(torch.from_numpy, (q, k, v)), causal))


def _layer_attn(pair, stack="dense_layers"):
    rm, rp, pm, pp = pair
    return (jax.tree.map(lambda a: a[0], rp[stack])["attn"],
            pp[stack][0]["attn"])


def _bf16_input(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape)
    xj = jnp.asarray(x, jnp.bfloat16)
    return xj, to_torch(np.asarray(xj))


@pytest.mark.parametrize("stack", ["dense_layers", "layers"])
def test_mla_prefill_matches_reference_mla_train(pair, stack, monkeypatch):
    """``mla_prefill`` against the reference's ``mla_train`` (run op by
    op) on the bridged weights: the latents (ckv after ``kv_norm``, kr
    after RoPE) within one bf16 ulp of their largest magnitude, the
    output through the plain flash (P in fp32) within 2e-2, and through
    the reference's attention arithmetic within one bf16 ulp."""
    rcfg, cfg = ref_reduced(ARCH), get_reduced(ARCH)
    rattn, pattn = _layer_attn(pair, stack)
    xj, xt = _bf16_input((2, 13, cfg.d_model), 3)
    pos = np.tile(np.arange(13), (2, 1))
    with jax.disable_jit():
        want, (ckv_w, kr_w) = RL.mla_train(rattn, xj, rcfg, jnp.asarray(pos))
    got, (ckv, kr) = PL.mla_prefill(pattn, xt, cfg, torch.as_tensor(pos))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 13, cfg.d_model)
    assert ckv.shape == (2, 13, 16) and kr.shape == (2, 13, 8)
    _close_latent(ckv, ckv_w)
    _close_latent(kr, kr_w)
    np.testing.assert_allclose(_np(got), _np(want), atol=BF16_TOL,
                               rtol=BF16_TOL)
    monkeypatch.setattr(
        ops, "flash_attention",
        lambda q, k, v, causal=True, bk=512: PL.chunked_attention(
            q, k, v, causal=causal))
    got, _ = PL.mla_prefill(pattn, xt, cfg, torch.as_tensor(pos))
    _close_latent(got, want)


@pytest.mark.parametrize("page_tokens", [4, 8])
def test_mla_decode_over_paged_pool_matches_reference(pair, page_tokens,
                                                      monkeypatch):
    """One decode token for 3 sequences of mixed lengths (3, 9, 14): the
    port's ``mla_decode`` over a paged latent pool (rows [ckv | kr]
    written through the cache's own page tables) against the reference's
    ``mla_decode`` over its contiguous cache holding the same latents.
    The new token's latent row equals the reference's new cache entry
    (within one bf16 ulp); the output is within 2e-2 through the plain
    latent kernel (P in fp32) and within one bf16 ulp through the
    reference's arithmetic."""
    rcfg, cfg = ref_reduced(ARCH), get_reduced(ARCH)
    rattn, pattn = _layer_attn(pair, "layers")
    lens = np.array([3, 9, 14])
    B, r, rope = 3, cfg.mla.kv_lora_rank, cfg.mla.qk_rope_head_dim
    rng = np.random.default_rng(5)
    ckv = jnp.asarray(rng.standard_normal((B, S, r)), jnp.bfloat16)
    kr = jnp.asarray(rng.standard_normal((B, S, rope)), jnp.bfloat16)
    xj, xt = _bf16_input((B, cfg.d_model), 6)
    with jax.disable_jit():
        want, new = RL.mla_decode(rattn, xj, rcfg, {
            "ckv": ckv, "kr": kr, "len": jnp.asarray(lens, jnp.int32)})

    def run():
        cache = Model(cfg, device="cpu").init_cache(B, S, page_tokens)
        assert cache.v_pages is None
        assert cache.k_pages.shape[-2:] == (1, r + rope)
        rows = np.concatenate([np.asarray(ckv, np.float32),
                               np.asarray(kr, np.float32)], -1)
        flat = cache.k_pages[0].view(-1, r + rope)
        for s, n in enumerate(lens):
            cache.alloc_seq(s, int(n))
            idx = cache.prompt_index([s], int(n))[0]
            flat[idx] = torch.from_numpy(rows[s, :n]).to(torch.bfloat16)
        view = cache.append_view([0, 1, 2])
        out = PL.mla_decode(pattn, xt, cfg, cache.k_pages[0], view)
        return out, flat[view.write_index]

    got, row = run()
    assert got.shape == (B, cfg.d_model) and got.dtype == torch.bfloat16
    bidx = np.arange(B)
    _close_latent(row[:, :r], new["ckv"][bidx, lens])
    _close_latent(row[:, r:], new["kr"][bidx, lens])
    np.testing.assert_allclose(_np(got), _np(want), atol=BF16_TOL,
                               rtol=BF16_TOL)
    monkeypatch.setattr(ops, "paged_latent_attention", _latent_as_reference)
    got, _ = run()
    _close_latent(got, want)


# ------------------------------------------------------------- model
def _teacher_forced(rm, rp, pm, pp, page_tokens=4):
    """Prefill 3 prompts of mixed lengths one by one, then 4 batched
    decode steps on forced tokens; the logits of each call, (reference,
    port) in pairs."""
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 250, n).astype(np.int32) for n in (5, 9, 14)]
    forced = rng.integers(1, 250, (4, 3)).astype(np.int32)
    B = 3
    rcache = rm.init_cache(B, S)
    cache = pm.init_cache(B, S, page_tokens=page_tokens)
    out = []
    for slot, p in enumerate(prompts):
        one, rlog = rm.prefill(rp, {"tokens": jnp.asarray(p[None])}, S)
        rcache = jax.tree.map(
            lambda full, o: (full.at[:, slot].set(o[:, 0])
                             if full.ndim >= 2 and full.shape[1] == B
                             else full), rcache, one)
        rcache["len"] = rcache["len"].at[slot].set(one["len"][0])
        cache.alloc_seq(slot, len(p))
        got = pm.prefill(pp, torch.as_tensor(p[None], dtype=torch.int64),
                         cache, [slot])
        out.append((rlog[0], got[0]))
    for step in range(4):
        rcache, want = rm.decode_step(rp, rcache, jnp.asarray(forced[step]))
        got = pm.decode_step(pp, cache, torch.as_tensor(
            forced[step], dtype=torch.int64), [0, 1, 2])
        out.append((want, got))
    assert list(cache.lens[:3]) == [9, 13, 18]
    cache.validate()
    return out


def test_reference_arithmetic_matches_op_by_op_reference(pair,
                                                         ref_arithmetic):
    """With the reference's attention arithmetic and SiLU
    (``ref_arithmetic``), prefill of mixed lengths and 4 teacher-forced
    decode steps through 4-token pages against the reference run op by
    op: within ``logit_tol`` (measured: equal bit for bit)."""
    with jax.disable_jit():
        out = _teacher_forced(*pair)
    for want, got in out:
        np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                                   atol=logit_tol(want))


def test_prefill_and_decode_logits_match_reference(pair, monkeypatch):
    """As the port runs (plain kernel versions) against the reference as
    it serves (jitted): logits within ``LOGIT_TOL``, and every (layer,
    token)'s expert set equal on both sides."""
    with MOE_MODEL._routes(monkeypatch) as (ref_routes, port_routes):
        out = _teacher_forced(*pair)
    for want, got in out:
        assert got.dtype == torch.bfloat16
        _close(got, want, LOGIT_TOL)
    # one MoE layer: 3 prefills and 4 decode steps
    assert len(port_routes) == 7
    assert MOE_MODEL._agreement(ref_routes, port_routes) == 1.0


@pytest.mark.parametrize("slots", [1, 3])
def test_greedy_tokens_match_reference_engine(pair, slots, monkeypatch):
    """Greedy tokens against the reference engine as it compiles by
    default, routing-aware as in ``test_torch_moe_model.py``: every token
    a request produced while its routing had agreed in all its steps
    equals the reference's."""
    rm, rp, pm, pp = pair
    cfg = get_reduced(ARCH)
    with MOE_MODEL._routes(monkeypatch) as (ref_routes, port_routes):
        ref_eng = RefEngine(ref_reduced(ARCH), rp, slots=slots, max_seq=S,
                            record_plans=True)
        ref_reqs = MOE_MODEL._requests(5, np.random.default_rng(7),
                                       RefRequest)
        for r in ref_reqs:
            ref_eng.submit(r)
        ref_eng.run_until_drained()
        jax.effects_barrier()
        n_ref = len(ref_routes)
        eng = ServingEngine(cfg, pp, slots=slots, max_seq=S, device="cpu",
                            record_plans=True)
        reqs = MOE_MODEL._requests(5, np.random.default_rng(7), Request)
        for r in reqs:
            eng.submit(r)
        stats = eng.run_until_drained()
    assert len(ref_routes) == n_ref
    n_moe = cfg.n_layers - cfg.moe.first_dense_layers
    agree, share = MOE_MODEL._step_agreement(eng.trace, ref_routes,
                                             port_routes, n_moe)
    compared = 0
    for r, want in zip(reqs, ref_reqs):
        ok = np.logical_and.accumulate(agree[r.uid])
        assert r.uid == want.uid and len(ok) == len(r.output) == \
            len(want.output)
        for j in np.flatnonzero(ok):
            assert r.output[j] == want.output[j], (r.uid, j)
            compared += 1
    assert compared >= sum(len(r.output) for r in reqs) // 2, compared
    assert share >= 0.9, share
    assert stats.drained and stats.prefills == 5
    eng.cache.validate()
    assert eng.cache.pages_in_use == 0


def test_recorded_plan_trace_matches_reference_engine(pair):
    """``record_plans`` on the MLA config: the same records, and the same
    compiled arrays, as the reference engine's (its GQA geometry: 4 KV
    heads of d_model / n_heads = 16)."""
    rm, rp, pm, pp = pair
    ref_eng = RefEngine(ref_reduced(ARCH), rp, slots=3, max_seq=S,
                        record_plans=True)
    eng = ServingEngine(get_reduced(ARCH), pp, slots=3, max_seq=S,
                        device="cpu", record_plans=True)
    for e, cls in ((ref_eng, RefRequest), (eng, Request)):
        for r in MOE_MODEL._requests(5, np.random.default_rng(7), cls):
            e.submit(r)
        e.run_until_drained()
    assert len(eng.trace) == len(ref_eng.trace) == eng.n_records
    for got, want in zip(eng.trace, ref_eng.trace):
        assert (got.kind, got.step_idx, got.slots, got.uids, got.n_tokens,
                got.arrival_event) == \
            (want.kind, want.step_idx, want.slots, want.uids,
             want.n_tokens, want.arrival_event)
        a, b = got.plan.compile(), want.plan.compile()
        assert a.n_events == b.n_events and a.page_keys == b.page_keys
        for f in MOE_MODEL.COMPILED_COLS:
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), f


def test_latent_pool_and_shadow_table_count_the_same_pages(pair):
    """An MLA engine's live pool is one latent pool per layer (rows of r +
    rope = 24 under one KV head, no V pool) while its ``record_plans``
    shadow table keeps the reference's GQA geometry (4 KV heads of 16).
    Both count tokens in pages of ``page_tokens``: after every step of a
    run that defers admissions on a small pool, the two hold the same
    pages and lengths for every slot."""
    rm, rp, pm, pp = pair
    cfg = get_reduced(ARCH)
    eng = ServingEngine(cfg, pp, slots=3, max_seq=S, device="cpu",
                        record_plans=True, kv_page_tokens=4,
                        kv_pool_pages=6)
    assert isinstance(eng.cache, PagedKVCache) and eng.cache.v_pages is None
    assert tuple(eng.cache.k_pages.shape) == (cfg.n_layers, 6, 4, 1, 24)
    t = eng._table.cfg
    assert (t.n_kv_heads, t.head_dim, t.page_tokens, t.n_pages) == \
        (4, 16, 4, 6)
    for r in MOE_MODEL._requests(5, np.random.default_rng(3), Request):
        eng.submit(r)
    steps = 0
    while eng.step():
        steps += 1
        assert np.array_equal(eng._table.held, eng.cache.held)
        assert np.array_equal(eng._table.lens, eng.cache.lens)
        assert eng._table.pages_in_use == eng.cache.pages_in_use
    assert steps and eng.deferred_admissions > 0 and eng.n_finished == 5
    assert eng.cache.pages_in_use == eng._table.pages_in_use == 0


@pytest.mark.parametrize("what", ["page_dicts", "layer_flat"])
def test_latent_cache_refuses_the_k_and_v_views(what):
    """A cache of one latent pool (``v_pool=False``) has no V pool to
    view: ``page_dicts`` and ``layer_flat`` raise a ``ValueError`` that
    names the latent pool, not a ``TypeError`` from indexing None; a
    cache with both pools still gives both views."""
    from repro_torch.serving.kv_cache import PagedCacheConfig
    cfg = PagedCacheConfig(n_pages=4, page_tokens=4, n_kv_heads=1,
                           head_dim=24, max_pages_per_seq=2)
    latent = PagedKVCache(cfg, max_seqs=2, n_layers=1, device="cpu",
                          v_pool=False)
    assert latent.alloc_seq(0, 3)
    call = {"page_dicts": lambda c: c.page_dicts([0], 0),
            "layer_flat": lambda c: c.layer_flat(0)}[what]
    with pytest.raises(ValueError, match="latent pool"):
        call(latent)
    both = PagedKVCache(cfg, max_seqs=2, n_layers=1, device="cpu")
    assert both.alloc_seq(0, 3)
    k, v = call(both)
    assert len(k) == len(v) > 0


def test_serve_launcher_takes_the_arch_with_a_depth_cut(capsys,
                                                        monkeypatch):
    """``launch/serve.py --arch deepseek-v3-671b --layers N`` serves the
    config cut to N layers (here the reduced config on the CPU)."""
    import sys
    from repro_torch.launch import serve
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "deepseek-v3-671b", "--reduced", "--layers", "1",
        "--device", "cpu", "--requests", "2", "--new-tokens", "3"])
    serve.main()
    out = capsys.readouterr().out
    assert "[deepseek-v3-reduced-1l on cpu] 6 tokens" in out
