"""The INT8 KV cache (``Tuning.kv_cache_quant``) of the port against the
reference on the CPU, with the reference's bf16 weights bridged by
``from_reference``.

The port quantizes K/V per (token, KV head) exactly as the jitted
reference does (``kernels.ref.kv_quantize_ref``: the same fp32 product
by 1/127, bf16 roundings and int8 saturation); its paged plain version
keeps P in fp32 where the reference rounds ``p · v_scale`` to bf16
before PV, as the bf16 paged path does (ROADMAP Queue C, "Attention
probabilities").

Tolerances: the quantization is held bitwise (codes and fp16 scales);
attention outputs within 2e-2 (one bf16 ulp of O(1) outputs, with
margin: the rounding of P, then of the output); logits within
``logit_tol`` of ``test_torch_models.py``, max(1e-2, 1.5e-2 ·
max|logit|); int8 against bf16 logits at the reference test's rtol
0.12, atol 0.25 (``test_int8_kv_cache_decode_close_to_bf16`` of
``tests/test_models.py``).
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as ref_reduced  # noqa: E402
from repro.models import decoding as RD  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import tuning as RTU  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro.serving.engine import Request as RefRequest  # noqa: E402
from repro.serving.engine import ServingEngine as RefEngine  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_reduced  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models import tuning as TU  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.serving.kv_cache import (PagedCacheConfig,  # noqa: E402
                                          PagedKVCache)

logit_tol = importlib.import_module("test_torch_models").logit_tol
SERVING = importlib.import_module("test_torch_serving")
QUANT = TU.Tuning(kv_cache_quant=True)
REF_QUANT = RTU.Tuning(kv_cache_quant=True)
ATT_TOL = 2e-2
ARCH = "qwen1_5_32b"


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(got, want):
    np.testing.assert_allclose(_np(got)[..., :_np(want).shape[-1]],
                               _np(want), atol=logit_tol(want), rtol=0)


def _bf16(x):
    """The same bf16 values on both sides, as (jax, torch)."""
    xj = jnp.asarray(x, jnp.bfloat16)
    return xj, torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        torch.bfloat16)


@pytest.fixture(scope="module")
def pair():
    return SERVING._weights(ARCH)


# ------------------------------------------------------- quantization
@pytest.mark.parametrize("jit", [True, False])
def test_kv_quantize_ref_equals_the_reference(jit):
    """K/V rows of every magnitude (all-zero rows included) through the
    reference's prefill quantization (``_pad_cache_seq`` under the
    flag), jitted and op by op, against ``kv_quantize_ref``: the share
    of equal int8 codes, of codes at most 1 apart and of equal fp16
    scales are all 1 (quotients of 127.5 saturate to 127 on both)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 96, 4, 64)).astype(np.float32) * \
        rng.uniform(0, 6, (2, 3, 96, 4, 1)).astype(np.float32)
    x[0, 0, 0, 0] = 0.0
    xj, xt = _bf16(x)

    def quant(k, v):
        with RTU.tuning_context(REF_QUANT):
            return RD._pad_cache_seq({"k": k, "v": v}, k.shape[2])

    if jit:
        want = jax.jit(quant)(xj, xj * 0.5)
    else:
        with jax.disable_jit():
            want = quant(xj, xj * 0.5)
    for name, src in (("k", xt), ("v", (xt.float() * 0.5).to(torch.bfloat16))):
        codes, scales = ref.kv_quantize_ref(src)
        wc = np.asarray(want[name])
        ws = np.asarray(want[name + "_scale"])
        assert codes.dtype == torch.int8 and scales.dtype == torch.float16
        diff = np.abs(codes.numpy().astype(np.int32) - wc.astype(np.int32))
        shares = ((diff == 0).mean(), (diff <= 1).mean(),
                  (scales.numpy() == ws).mean())
        assert shares == (1.0, 1.0, 1.0), (name, shares)
    # a row at the saturation edge: max 2.75, s = bf16(2.75/127), and
    # 2.75 / s = 127.28 rounds to bf16 127.5, then to 128: stored as 127
    edge = torch.tensor([[2.75] + [0.0] * 63], dtype=torch.bfloat16)
    assert ref.kv_quantize_ref(edge)[0][0, 0].item() == 127


def test_kv_quantize_append_ref_writes_the_reference_rows():
    """One decode step's quantize-and-append (the plain version of the
    fused kernel) against the reference's ``attention_decode`` writes:
    the codes at each sequence's position and the scales, in the port's
    (P, KH, page) scale layout."""
    rng = np.random.default_rng(1)
    n, KH, D, page, P = 3, 2, 16, 4, 9
    kj, kt = _bf16(rng.standard_normal((n, KH, D)) * 2)
    vj, vt = _bf16(rng.standard_normal((n, KH, D)))
    rows = torch.tensor([5, 12, 33])
    pools = [torch.zeros((P, page, KH, D), dtype=torch.int8)
             for _ in range(2)]
    scales = [torch.zeros((P, KH, page), dtype=torch.float16)
              for _ in range(2)]
    ops.kv_quantize_append(kt, vt, rows, *pools, *scales)
    for x, pool, sc in ((kj, pools[0], scales[0]), (vj, pools[1], scales[1])):
        s = jnp.max(jnp.abs(x), -1) / 127.0 + 1e-8
        codes = np.asarray(jnp.round(x / s[..., None]).astype(jnp.int8))
        got = pool.view(-1, KH, D)[rows]
        assert np.array_equal(got.numpy(), codes)
        got_s = sc[rows // page, :, rows % page]
        assert np.array_equal(got_s.numpy(), np.asarray(s.astype(
            jnp.float16)))
    untouched = torch.ones(P * page, dtype=torch.bool)
    untouched[rows] = False
    assert not pools[0].view(-1, KH, D)[untouched].any()


# ------------------------------------------------ attention over int8
def _int8_cache(rng, B, S, KH, D):
    """A quantized contiguous cache (B, S, KH, D) with its (B, S, KH)
    scales, as both sides hold it."""
    out = []
    for scale in (1.5, 1.0):
        xj, _ = _bf16(rng.standard_normal((B, S, KH, D)) * scale)
        s = jnp.max(jnp.abs(xj), -1) / 127.0 + 1e-8
        out += [jnp.round(xj / s[..., None]).astype(jnp.int8),
                s.astype(jnp.float16)]
    return out          # k, k_scale, v, v_scale


def _to_pages(cache, scales, page):
    """(B, S, KH, D) and (B, S, KH) -> pools (B·S/page, page, KH, D),
    scale pools (P, KH, page), the identity table."""
    B, S, KH, D = cache.shape
    pool = torch.from_numpy(np.array(cache)).reshape(-1, page, KH, D)
    sc = torch.from_numpy(np.array(scales)).reshape(-1, page, KH) \
        .permute(0, 2, 1).contiguous()
    table = torch.arange(B * S // page, dtype=torch.int32).reshape(B, -1)
    return pool, sc, table


@pytest.mark.parametrize("H,KH,D", [(8, 2, 16), (6, 6, 64), (12, 1, 32)])
def test_int8_paged_ref_matches_reference_decode_attention(H, KH, D):
    """``paged_ref`` over int8 pools with (P, KH, page) scale pools, and
    the port's plain ``decode_attention`` with ``k_scale`` / ``v_scale``,
    against the reference's ``decode_attention`` on the same int8 cache
    and scales, ragged lengths with one empty sequence (zeros on the
    port's paged side; the reference averages the masked cache).  The
    port's contiguous form equals the reference's arithmetic to fp32 sum
    order; the paged form keeps P in fp32 (measured: under 1 bf16 ulp
    of the outputs)."""
    rng = np.random.default_rng(H + D)
    B, S, page = 4, 32, 8
    k, ks, v, vs = _int8_cache(rng, B, S, KH, D)
    qj, qt = _bf16(rng.standard_normal((B, H, D)))
    lens = np.array([32, 17, 1, 0], np.int32)
    want = _np(RL.decode_attention(qj, k, v, jnp.asarray(lens), k_scale=ks,
                                   v_scale=vs))
    kp, ksp, table = _to_pages(k, ks, page)
    vp, vsp, _ = _to_pages(v, vs, page)
    lt = torch.from_numpy(lens)
    got = ops.paged_attention(qt, kp, vp, table, lt, ksp, vsp)
    assert got.dtype == torch.bfloat16
    live = lens > 0
    np.testing.assert_allclose(_np(got)[live], want[live], atol=ATT_TOL,
                               rtol=ATT_TOL)
    assert not got[~torch.from_numpy(live)].any()
    plain = PL.decode_attention(
        qt, *(torch.from_numpy(np.array(a)) for a in (k, v)), lt,
        k_scale=torch.from_numpy(np.array(ks)),
        v_scale=torch.from_numpy(np.array(vs)))
    np.testing.assert_allclose(_np(plain), want, atol=1e-2, rtol=1e-2)


# ------------------------------------------------------------- models
def _prefill_decode(pm, pp, prompt, steps, cache_seq, page_tokens=8):
    cache = pm.init_cache(prompt.shape[0], cache_seq, page_tokens)
    slots = list(range(prompt.shape[0]))
    for s in slots:
        cache.alloc_seq(s, prompt.shape[1])
    out = [pm.prefill(pp, torch.as_tensor(prompt, dtype=torch.int64), cache,
                      slots)]
    for t in steps:
        out.append(pm.decode_step(pp, cache, torch.as_tensor(
            t, dtype=torch.int64), slots))
    return cache, out


def test_int8_prefill_and_decode_logits_match_reference(pair):
    """qwen1.5-32b (reduced: 4 / 4 heads of 16, two layers) under the
    flag on both sides: a 24-token prefill of 2 sequences into int8
    pools, then 3 decode steps; every step's logits within
    ``logit_tol`` of the reference's int8 run.  Layer 0's prompt codes
    and scales equal the reference cache's bit for bit (its bf16 K/V are
    the same on both sides); layer 1's K/V come from hidden states that
    differ by bf16 roundings, so its codes move by up to 2 (74-76% equal,
    98.5-99.2% within 1): its dequantized K/V stay within 1.5e-2 of the
    largest magnitude (1.19e-2 measured)."""
    rp, pp = pair
    rm = RefModel(ref_reduced(ARCH), remat="none")
    rng = np.random.default_rng(0)
    prompt = rng.integers(1, 250, (2, 24)).astype(np.int32)
    steps = rng.integers(1, 250, (3, 2)).astype(np.int32)
    with RTU.tuning_context(REF_QUANT):
        rcache, lg = rm.prefill(rp, {"tokens": jnp.asarray(prompt)}, 40)
        want = [lg]
        pre = jax.tree.map(np.asarray, rcache)
        for t in steps:
            rcache, lg = rm.decode_step(rp, rcache, jnp.asarray(t))
            want.append(lg)
    pm = Model(get_reduced(ARCH), device="cpu")
    with TU.tuning_context(QUANT):
        cache, got = _prefill_decode(pm, pp, prompt, [], 40)
    assert cache.k_pages.dtype == torch.int8
    assert cache.k_scale.dtype == torch.float16
    rows = torch.stack([torch.from_numpy(cache._flat_rows(s, 0, 24))
                        for s in range(2)])
    page = cache.cfg.page_tokens
    for layer in range(pm.cfg.n_layers):
        for name, pool, sc in (("k", cache.k_pages, cache.k_scale),
                               ("v", cache.v_pages, cache.v_scale)):
            codes = pool[layer].view(-1, *pool.shape[3:])[rows].numpy()
            s = sc[layer][rows // page, :, rows % page].numpy()
            wc = pre["layers"][name][layer][:, :24]
            ws = pre["layers"][name + "_scale"][layer][:, :24]
            if layer == 0:      # the same bf16 K/V on both sides
                assert np.array_equal(codes, wc) and np.array_equal(s, ws)
            deq = codes * s.astype(np.float32)[..., None]
            want_deq = wc * ws.astype(np.float32)[..., None]
            err = np.abs(deq - want_deq).max() / np.abs(want_deq).max()
            assert err <= 1.5e-2, (layer, name, err)
    for t in steps:
        got.append(pm.decode_step(pp, cache, torch.as_tensor(
            t, dtype=torch.int64), [0, 1]))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        _close(g, w)


def test_int8_kv_cache_decode_close_to_bf16(pair):
    """The port's mirror of the reference's
    ``test_int8_kv_cache_decode_close_to_bf16``: prefill 2 x 24 tokens
    into a 40-token cache, decode the last prompt token; int8 logits
    within rtol 0.12, atol 0.25 of the bf16 cache's."""
    _, pp = pair
    pm = Model(get_reduced(ARCH), device="cpu")
    prompt = np.random.default_rng(3).integers(1, 250, (2, 24)).astype(
        np.int32)
    _, bf = _prefill_decode(pm, pp, prompt, [prompt[:, -1]], 40)
    with TU.tuning_context(QUANT):
        cache, q8 = _prefill_decode(pm, pp, prompt, [prompt[:, -1]], 40)
    assert cache.k_pages.dtype == torch.int8
    np.testing.assert_allclose(_np(q8[1]), _np(bf[1]), rtol=0.12, atol=0.25)


def _ref_kv_dtypes(cache):
    """{which cache: dtype} of a reference cache tree: the GQA ``k``
    (and an MoE model's ``dense_layers``), a latent ``ckv``, the
    hybrid's ``shared`` K, whisper's ``cross`` K."""
    out = {}
    for key in ("dense_layers", "layers"):
        tree = cache.get(key, {})
        if "k" in tree:
            out["self"] = str(tree["k"].dtype)
        elif "ckv" in tree:
            out["self"] = str(tree["ckv"].dtype)
    for key in ("shared", "cross"):
        if key in cache:
            out[{"shared": "self", "cross": "cross"}[key]] = \
                str(cache[key]["k"].dtype)
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_dtypes_under_the_flag_match_reference(arch):
    """For each of the ten arch ids (reduced), the KV caches that
    ``init_cache`` makes under the flag have the reference's dtypes:
    int8 (with fp16 scales) for the dense, vlm, non-MLA MoE and
    whisper self caches, bf16 for MLA's latent pool, the hybrid's
    shared pool and whisper's cross pool; rwkv6 holds no KV."""
    rcfg, pcfg = ref_reduced(arch), get_reduced(arch)
    enc = 16 if pcfg.family == "audio" else 0
    with RTU.tuning_context(REF_QUANT):
        rcache = RD.init_cache(rcfg, 2, 16, enc_seq=enc)
    with TU.tuning_context(QUANT):
        cache = Model(pcfg, device="cpu").init_cache(2, 16, enc_seq=enc)
    want = _ref_kv_dtypes(rcache)
    names = {torch.int8: "int8", torch.bfloat16: "bfloat16"}
    got = {}
    if pcfg.family != "ssm":
        got["self"] = names[cache.k_pages.dtype]
        quant = got["self"] == "int8"
        assert cache.quantized == quant
        assert (cache.k_scale is not None) == quant
        if quant:
            assert cache.k_scale.dtype == cache.v_scale.dtype == \
                torch.float16
            assert (rcache["layers"]["k_scale"].dtype == jnp.float16)
        if cache.cross is not None:
            got["cross"] = names[cache.cross.k_pages.dtype]
            assert not cache.cross.quantized
    assert got == want
    with TU.tuning_context(TU.Tuning()):
        plain = Model(pcfg, device="cpu").init_cache(2, 16, enc_seq=enc)
    assert pcfg.family == "ssm" or plain.k_pages.dtype == torch.bfloat16


def test_whisper_int8_self_pool_beside_bf16_cross_pool():
    """whisper-tiny (reduced) under the flag: the self cache is int8, the
    cross cache bf16; prefill of 2 clips and 3 decode steps within
    ``logit_tol`` of the reference's int8 run."""
    arch = "whisper_tiny"
    rp, pp = SERVING._weights(arch)
    rm = RefModel(ref_reduced(arch), remat="none")
    rng = np.random.default_rng(4)
    d = get_reduced(arch).d_model
    frames = rng.standard_normal((2, 40, d), np.float32) * 0.02
    toks = rng.integers(1, 250, (2, 4)).astype(np.int32)
    steps = rng.integers(1, 250, (3, 2)).astype(np.int32)
    with RTU.tuning_context(REF_QUANT):
        rcache, lg = rm.prefill(rp, {"audio_frames": jnp.asarray(frames),
                                     "tokens": jnp.asarray(toks)}, 16)
        assert rcache["layers"]["k"].dtype == jnp.int8
        want = [lg]
        for t in steps:
            rcache, lg = rm.decode_step(rp, rcache, jnp.asarray(t))
            want.append(lg)
    pm = Model(get_reduced(arch), device="cpu")
    with TU.tuning_context(QUANT):
        cache = pm.init_cache(2, 16, page_tokens=8, enc_seq=40)
    assert cache.k_pages.dtype == torch.int8
    assert cache.cross.k_pages.dtype == torch.bfloat16
    for s in range(2):
        cache.alloc_seq(s, 4)
    got = [pm.prefill(pp, torch.from_numpy(toks).long(), cache, [0, 1],
                      audio_frames=torch.from_numpy(frames))]
    for t in steps:
        got.append(pm.decode_step(pp, cache, torch.from_numpy(t).long(),
                                  [0, 1]))
    for g, w in zip(got, want):
        _close(g, w)


# ------------------------------------------------------------- serving
@pytest.mark.parametrize("arch", ["qwen2_0_5b", "qwen1_5_32b"])
def test_int8_greedy_engine_tokens_match_reference_engine(arch):
    """The engine under the flag (its cache int8) against the reference
    engine under the flag: 5 requests on 3 slots, every token equal, or
    a pick within one bf16 ulp of the reference's on the port's own
    logits (a tie) after which the reference is teacher-forced on the
    port's tokens, as ``test_torch_serving`` holds the bf16 engines."""
    rp, pp = SERVING._weights(arch)
    with RTU.tuning_context(REF_QUANT):
        ref_eng = RefEngine(ref_reduced(arch), rp, slots=3, max_seq=64)
        ref_reqs = SERVING._requests(5, np.random.default_rng(7), RefRequest)
        for r in ref_reqs:
            ref_eng.submit(r)
        ref_eng.run_until_drained()
        assert ref_eng.cache["layers"]["k"].dtype == jnp.int8
    with TU.tuning_context(QUANT):
        eng = ServingEngine(get_reduced(arch), pp, slots=3, max_seq=64,
                            device="cpu")
    assert eng.cache.k_pages.dtype == torch.int8
    reqs = SERVING._requests(5, np.random.default_rng(7), Request)
    for r in reqs:
        eng.submit(r)
    assert eng.run_until_drained().drained
    eng.cache.validate()
    rm = RefModel(ref_reduced(arch), remat="none")
    for r, w in zip(reqs, ref_reqs):
        if r.output == w.output:
            continue
        i = next(j for j, (a, b) in enumerate(zip(r.output, w.output))
                 if a != b)
        with RTU.tuning_context(REF_QUANT):
            cache, lg = rm.prefill(rp, {"tokens": jnp.asarray(
                np.concatenate([r.prompt, r.output[:i]])[None].astype(
                    np.int32))}, 64)
        m = Model(get_reduced(arch), device="cpu")
        with TU.tuning_context(QUANT):
            c = m.init_cache(1, 64)
        seq = np.concatenate([r.prompt, r.output[:i]])
        c.alloc_seq(0, len(seq))
        plg = m.prefill(pp, torch.as_tensor(seq[None], dtype=torch.int64),
                        c, [0])[0].float()
        SERVING._assert_tie(plg, r.output[i], w.output[i], (r.uid, i))


def test_int8_engine_records_the_bf16_plan_trace():
    """``record_plans`` under the flag: the shadow table stays a 2-byte
    float (float16, the reference engine's default), so the trace equals
    the reference engine's under the flag and the port's own without it,
    record for record and compiled array for compiled array."""
    rp, pp = SERVING._weights("qwen2_0_5b")
    traces = []
    for port, tuned in ((True, True), (True, False), (False, True)):
        if port:
            with TU.tuning_context(QUANT if tuned else TU.Tuning()):
                eng = ServingEngine(get_reduced("qwen2_0_5b"), pp, slots=3,
                                    max_seq=64, device="cpu",
                                    record_plans=True)
            assert eng.cache.quantized == tuned
            assert eng._table.cfg.dtype == "float16"
            cls = Request
        else:
            with RTU.tuning_context(REF_QUANT):
                eng = RefEngine(ref_reduced("qwen2_0_5b"), rp, slots=3,
                                max_seq=64, record_plans=True)
            cls = RefRequest
        for r in SERVING._requests(5, np.random.default_rng(7), cls):
            eng.submit(r)
        if port:
            eng.run_until_drained()
        else:
            with RTU.tuning_context(REF_QUANT):
                eng.run_until_drained()
        traces.append(eng.trace)
    first = traces[0]
    for other in traces[1:]:
        assert len(other) == len(first)
        for got, want in zip(first, other):
            assert (got.kind, got.step_idx, got.slots, got.uids,
                    got.n_tokens) == (want.kind, want.step_idx, want.slots,
                                      want.uids, want.n_tokens)
            a, b = got.plan.compile(), want.plan.compile()
            assert a.n_events == b.n_events and a.page_keys == b.page_keys
            for f in SERVING.COMPILED_COLS:
                assert np.array_equal(getattr(a, f), getattr(b, f)), f


def test_int8_paged_cache_pools_and_views():
    """An int8 cache config: int8 pools plus fp16 (L, P, KH, page) scale
    pools; ``page_bytes`` counts the scales; ``layer_flat`` returns the
    flat int8 rows and ``layer_pools`` the layer's pools and scale pools
    (a float cache's scales None); ``page_dicts`` refuses the int8 pool,
    whose pages the executor does not stream."""
    cfg = PagedCacheConfig(n_pages=6, page_tokens=8, n_kv_heads=2,
                           head_dim=16, max_pages_per_seq=3, dtype="int8")
    assert cfg.page_bytes == 8 * 2 * (16 + 2)
    assert PagedCacheConfig(6, 8, 2, 16, 3).page_bytes == 8 * 2 * 16 * 2
    cache = PagedKVCache(cfg, max_seqs=2, n_layers=3, device="cpu")
    assert cache.quantized
    assert cache.k_pages.shape == (3, 6, 8, 2, 16)
    assert cache.k_scale.shape == cache.v_scale.shape == (3, 6, 2, 8)
    kf, vf = cache.layer_flat(1)
    assert kf.shape == (48, 2, 16) and kf.dtype == torch.int8
    kp, vp, ks, vs = cache.layer_pools(1)
    assert kp.data_ptr() == kf.data_ptr() == cache.k_pages[1].data_ptr()
    assert ks.data_ptr() == cache.k_scale[1].data_ptr()
    assert vs.data_ptr() == cache.v_scale[1].data_ptr()
    bf16 = PagedKVCache(PagedCacheConfig(6, 8, 2, 16, 3), max_seqs=2,
                        n_layers=1, device="cpu")
    assert not bf16.quantized
    assert bf16.layer_pools(0)[2:] == (None, None)
    cache.alloc_seq(0, 5)
    with pytest.raises(ValueError, match="int8"):
        cache.page_dicts([0])
    with pytest.raises(ValueError):
        PagedKVCache(cfg, max_seqs=2, n_layers=1, device="cpu",
                     v_pool=False)
