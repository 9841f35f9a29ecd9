"""The hybrid family (zamba2-7b, reduced: 4 Mamba2 layers of d 64 and a
shared attention block before layers 0 and 2) against the reference on
the CPU: the causal convolution, the Mamba2 block and its single step,
prefill and decode over the shared block's paged KV (one pool layer per
invocation) and the per-slot Mamba2 state, the serving engine's tokens
and plan trace, the cache's bookkeeping, and the full config's size.

The reference's bf16 weights (``Model.init(PRNGKey(0))``) are bridged
into the port with ``from_reference``.  Its init zeroes ``A_log`` and
``dt_bias`` and sets ``D`` and ``norm_scale`` to one, so the block-level
tests draw every Mamba2 leaf and a non-zero carried state from a numpy
seed.

The model-level references run op by op (``jax.disable_jit()``), as in
``test_torch_ssm.py`` and for the same reason: under ``lax.scan`` XLA
fuses the bf16 ops of the layer body, and the reference's own logits
then move by about 1% of max|logit| on this model.

The attention kernels' plain versions, which the port runs on the CPU,
keep the softmax probabilities P in fp32 (the contract of the JAX
package's kernel oracles), where the reference model's attention
(``chunked_attention``, ``decode_attention``) rounds P to bf16 before
PV.  Through this small random model that one rounding moves the
logits by up to 2.3% of max|logit| and the states by 1.7% of their
largest magnitude.  So the model is held to the reference twice: with
the two wrappers running the reference's attention arithmetic
(``layers.chunked_attention`` and ``layers.decode_attention``, the
port's mirrors of it, over the same pages), where the port's prefill,
decode and greedy tokens equal the reference's (the hybrid's MLP rounds
SiLU's sigmoid and product apart, as the reference's ops do one by one)
and are held at ``logit_tol``; and through the plain kernel versions as
they run, held at ``KERNEL_TOL``.

Tolerances: fp32 3e-5 (sums in another order); bf16 block outputs 2e-2
absolute and relative (one bf16 ulp with margin); fp32 states 1e-4 of
their largest magnitude; logits ``logit_tol`` of ``test_torch_models.py``,
max(1e-2, 1.5e-2 · max|logit|); through the plain kernel versions,
logits and states 5e-2 · max(1, max|·|), the tolerance ``chip_smoke.py``
gives the same rounding of P (done on the card, not on the CPU).
"""
import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs import get_reduced as ref_reduced  # noqa: E402
from repro.models import ssm as RS  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro.serving.engine import Request as RefRequest  # noqa: E402
from repro.serving.engine import ServingEngine as RefEngine  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models import ssm as PS  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import from_reference, to_torch  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.serving.kv_cache import PagedKVCache  # noqa: E402
from repro_torch.serving.state_cache import RecurrentStateCache  # noqa: E402

logit_tol = importlib.import_module("test_torch_models").logit_tol
MODELS = importlib.import_module("test_torch_models")
SERVING = importlib.import_module("test_torch_serving")
_leaves = importlib.import_module("test_torch_params")._leaves

ARCH = "zamba2_7b"
F32_TOL = 3e-5
BF16_TOL = 2e-2
STATE_RTOL = 1e-4
KERNEL_TOL = 5e-2
S = 64                          # max_seq of the caches and engines


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _cast(a, dtype):
    """numpy fp32 -> (jax, torch) arrays of ``dtype`` holding the same
    values."""
    j = jnp.asarray(a, getattr(jnp, dtype))
    return j, to_torch(np.asarray(j))


def _close_logits(got, want):
    np.testing.assert_allclose(_np(got), _np(want), atol=logit_tol(want),
                               rtol=0)


def _close_state(got, want, rtol=STATE_RTOL):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=rtol * np.abs(want).max())


def _paged_as_reference(q, k_pages, v_pages, table, lens, k_scale=None,
                        v_scale=None):
    """``ops.paged_attention`` with the reference's decode arithmetic:
    the pages gathered into a contiguous cache, then
    ``layers.decode_attention``.  The shared pool is bf16: no scales."""
    assert k_scale is None and v_scale is None
    B, t = q.shape[0], table.long()
    k = k_pages[t].reshape(B, -1, *k_pages.shape[2:])
    v = v_pages[t].reshape(B, -1, *v_pages.shape[2:])
    return PL.decode_attention(q, k, v, lens)


@pytest.fixture
def ref_attention(monkeypatch):
    """Both attention wrappers with the reference model's arithmetic (P
    rounded to bf16): prefill through ``layers.chunked_attention``,
    decode through ``layers.decode_attention`` over the same pages."""
    monkeypatch.setattr(
        ops, "flash_attention",
        lambda q, k, v, causal=True, bk=512: PL.chunked_attention(
            q, k, v, causal=causal))
    monkeypatch.setattr(ops, "paged_attention", _paged_as_reference)


def _close_kernel(got, want):
    """Through the plain kernel versions: within ``KERNEL_TOL`` of
    max(1, max|want|)."""
    want = _np(want)
    np.testing.assert_allclose(
        _np(got), want, rtol=0,
        atol=KERNEL_TOL * max(1.0, float(np.abs(want).max())))


@pytest.fixture(scope="module")
def pair():
    rm = RefModel(ref_reduced(ARCH), remat="none")
    rp = rm.init(jax.random.PRNGKey(0))
    cfg = get_reduced(ARCH)
    pp = from_reference(jax.tree.map(np.asarray, rp), cfg)
    return rm, rp, Model(cfg, device="cpu"), pp


def _mamba_params(seed, dtype):
    """Every Mamba2 leaf of the reduced config from ``seed``: matrices
    and the convolution fan-in scaled, ``A_log``, ``dt_bias`` and ``D``
    N(0, 1), ``norm_scale`` 1 + N(0, 0.1) (fp32, as its spec says); as
    (jax tree, torch tree) in ``dtype``."""
    rng = np.random.default_rng(seed)
    jt, tt = {}, {}
    for name, p in PS.mamba2_pspecs(get_reduced(ARCH)).items():
        x = rng.standard_normal(p.shape)
        if name == "norm_scale":
            x = 1 + 0.1 * x
        elif p.init == "normal":
            x = x * p.shape[0] ** -0.5
        jt[name], tt[name] = _cast(x, p.dtype or dtype)
    return jt, tt


def _mamba_state(B, seed, dtype):
    """A Mamba2 state (s fp32, conv in ``dtype``) as (jax, torch)."""
    cfg = get_reduced(ARCH)
    rng = np.random.default_rng(seed)
    js, ts = {}, {}
    for name, shape, dt in (
            ("s", PS.init_mamba_state(cfg, B)["s"].shape, "float32"),
            ("conv", PS.init_mamba_state(cfg, B)["conv"].shape, dtype)):
        js[name], ts[name] = _cast(rng.standard_normal(tuple(shape)), dt)
    return js, ts


def _tols(dtype):
    return (F32_TOL, F32_TOL) if dtype == "float32" else (BF16_TOL,
                                                          STATE_RTOL)


# ------------------------------------------------------------ blocks
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(dtype, with_state):
    rng = np.random.default_rng(0)
    xj, xt = _cast(rng.standard_normal((2, 9, 12)), dtype)
    wj, wt = _cast(rng.standard_normal((4, 12)), dtype)
    sj, st = _cast(rng.standard_normal((2, 3, 12)), dtype) if with_state \
        else (None, None)
    want, want_tail = RS._causal_conv(xj, wj, sj)
    got, got_tail = PS._causal_conv(xt, wt, st)
    assert got.dtype == getattr(torch, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
    assert np.array_equal(_np(got_tail), _np(want_tail))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [16, 32, 5, 21])
def test_mamba2_forward_matches_reference(dtype, T):
    """Chunked over T tokens (16 = the chunk, 32 = two chunks, 5 and 21
    padded) from a non-zero state: output, fp32 scan state and the
    convolution's tail (the last inputs: ``in_proj`` outputs, held as
    the output is)."""
    cfg, rcfg = get_reduced(ARCH), ref_reduced(ARCH)
    jp, tp = _mamba_params(1, dtype)
    xj, xt = _cast(np.random.default_rng(2).standard_normal(
        (2, T, cfg.d_model)), dtype)
    js, ts = _mamba_state(2, 3, dtype)
    want, wst = RS.mamba2_forward(jp, xj, rcfg, js)
    got, gst = PS.mamba2_forward(tp, xt, cfg, ts)
    out_tol, s_tol = _tols(dtype)
    assert got.dtype == getattr(torch, dtype)
    assert gst["s"].dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), atol=out_tol,
                               rtol=out_tol)
    _close_state(gst["s"], wst["s"], s_tol)
    np.testing.assert_allclose(_np(gst["conv"]), _np(wst["conv"]),
                               atol=out_tol, rtol=out_tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_step_matches_reference(dtype):
    """Three single-token steps from a non-zero state, each step's
    output the next one's input."""
    cfg, rcfg = get_reduced(ARCH), ref_reduced(ARCH)
    jp, tp = _mamba_params(4, dtype)
    xj, xt = _cast(np.random.default_rng(5).standard_normal(
        (3, cfg.d_model)), dtype)
    js, ts = _mamba_state(3, 6, dtype)
    out_tol, s_tol = _tols(dtype)
    for _ in range(3):
        want, js = RS.mamba2_step(jp, xj, rcfg, js)
        got, ts = PS.mamba2_step(tp, xt, cfg, ts)
        np.testing.assert_allclose(_np(got), _np(want), atol=out_tol,
                                   rtol=out_tol)
        _close_state(ts["s"], js["s"], s_tol)
        np.testing.assert_allclose(_np(ts["conv"]), _np(js["conv"]),
                                   atol=out_tol, rtol=out_tol)
        xj, xt = want, got


def test_mamba_chunked_equals_step_by_step():
    """Within the port, in fp32 (the reference's
    ``test_ssm.py::test_mamba_chunked_vs_step``): the chunked forward's
    outputs and final state equal a replay of the single-token step.

    The convolution state is, by definition, the convolution inputs
    ([x | B | C] of ``in_proj``) of the last d_conv - 1 tokens: it is
    held bit for bit against the chunked pass's own ``in_proj`` rows.
    The replay computes those rows in products of B rows instead of
    B·T, which a BLAS may block differently (a last-bit change on some
    hosts), so against the replay it is held at ``s``'s 3e-3."""
    cfg = get_reduced(ARCH)
    rng = np.random.default_rng(7)
    p = {}
    for name, spec in PS.mamba2_pspecs(cfg).items():
        if spec.init == "normal":
            p[name] = torch.from_numpy(rng.standard_normal(spec.shape)
                                       .astype(np.float32)
                                       * spec.shape[0] ** -0.5)
        else:
            p[name] = torch.full(spec.shape, float(spec.init == "ones"))
    B, T = 2, 32
    x = torch.from_numpy(rng.standard_normal(
        (B, T, cfg.d_model)).astype(np.float32) * 0.3)
    st = PS.init_mamba_state(cfg, B, torch.float32)
    out_c, st_c = PS.mamba2_forward(p, x, cfg, st)
    st_s, outs = st, []
    for t in range(T):
        o, st_s = PS.mamba2_step(p, x[:, t], cfg, st_s)
        outs.append(o)
    np.testing.assert_allclose(out_c.numpy(), torch.stack(outs, 1).numpy(),
                               rtol=3e-3, atol=3e-3)
    np.testing.assert_allclose(st_c["s"].numpy(), st_s["s"].numpy(),
                               rtol=3e-3, atol=3e-3)
    d_in, _, N = PS._mamba_split(cfg)
    rows = PL._gemm(x, p["in_proj"])[:, T - (cfg.ssm.d_conv - 1):]
    assert torch.equal(st_c["conv"], rows[..., d_in:2 * d_in + 2 * N])
    np.testing.assert_allclose(st_c["conv"].numpy(), st_s["conv"].numpy(),
                               rtol=3e-3, atol=3e-3)


def test_init_mamba_state_shapes_and_dtypes():
    cfg, rcfg = get_reduced(ARCH), ref_reduced(ARCH)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        got = PS.init_mamba_state(cfg, 3, dt)
        want = RS.init_mamba_state(rcfg, 3, jdt)
        for (path, g), (_, w) in zip(_leaves(got), _leaves(want),
                                     strict=True):
            assert tuple(g.shape) == w.shape, path
            assert str(g.dtype).removeprefix("torch.") == w.dtype.name
            assert not g.any()
    assert got["s"].dtype == torch.float32


def test_shared_block_runs_before_every_attn_every_th_layer():
    """The reduced config invokes the shared block twice (before layers
    0 and 2), the full one 14 times (before layers 0, 6, ..., 78); the
    paged pool has one layer per invocation."""
    for get, ref_get, n in ((get_reduced, ref_reduced, 2),
                            (get_config, ref_config, 14)):
        cfg = get(ARCH)
        assert PT.n_shared_invocations(cfg) == n == PT.kv_layers(cfg)
        from repro.models.decoding import n_shared_invocations
        assert n_shared_invocations(ref_get(ARCH)) == n
    assert PT.kv_layers(get_reduced("qwen2_0_5b")) == \
        get_reduced("qwen2_0_5b").n_layers


# ------------------------------------------------------ prefill/decode
def _assert_states(cache, slot, rcache, rslot):
    """Every layer's Mamba2 state of ``slot`` against the reference's
    ``rslot``: ``s`` within ``STATE_RTOL`` of its largest magnitude,
    ``conv`` (bf16 ``in_proj`` outputs) within ``BF16_TOL``."""
    layers = rcache["layers"]
    _close_state(cache.state.s[:, slot], layers["s"][:, rslot])
    np.testing.assert_allclose(_np(cache.state.conv[:, slot]),
                               _np(layers["conv"][:, rslot]),
                               atol=BF16_TOL, rtol=BF16_TOL)


def _assert_shared_kv(cache, slot, rcache, rslot, n):
    """Pool layer ``inv`` holds the reference's ``shared`` K/V of
    invocation ``inv`` for the slot's first ``n`` tokens."""
    rows = cache._flat_rows(slot, 0, n)
    for inv in range(PT.kv_layers(get_reduced(ARCH))):
        for pool, name in zip(cache.layer_flat(inv), ("k", "v")):
            np.testing.assert_array_equal(
                _np(pool[torch.from_numpy(rows)]),
                _np(rcache["shared"][name][inv, rslot, :n]))


def _prefill_two(pair):
    """Two prompts of 21 tokens into slots [2, 0] of a 3-slot cache, on
    both sides: (reference cache, reference logits, cache, logits)."""
    rm, rp, pm, pp = pair
    toks = np.random.default_rng(0).integers(1, 250, (2, 21)).astype(
        np.int32)
    with jax.disable_jit():
        rcache, want = rm.prefill(rp, {"tokens": jnp.asarray(toks)}, S)
    cache = pm.init_cache(3, S)
    for s in (2, 0):
        assert cache.alloc_seq(s, 21)
    got = pm.prefill(pp, torch.as_tensor(toks, dtype=torch.int64), cache,
                     [2, 0])
    assert got.dtype == torch.bfloat16
    assert list(cache.lens) == list(cache.state.lens) == [21, 0, 21]
    assert not cache.state.s[:, 1].any() and not cache.state.conv[:, 1].any()
    cache.validate()
    return rcache, want, cache, got


def test_prefill_logits_and_states_match_reference(pair, ref_attention):
    """With the reference's attention arithmetic: logits, every layer's
    Mamba2 state and both invocations' K/V equal the reference's."""
    rcache, want, cache, got = _prefill_two(pair)
    _close_logits(got, want)
    assert (_np(got).argmax(-1) == _np(want).argmax(-1)).all()
    for slot, rslot in ((2, 0), (0, 1)):
        _assert_states(cache, slot, rcache, rslot)
        _assert_shared_kv(cache, slot, rcache, rslot, 21)


def test_prefill_through_the_kernels_stays_near_reference(pair):
    """Through the plain kernel versions (fp32 P): logits and states
    within ``KERNEL_TOL``; the shared block's first invocation reads the
    embeddings alone, so its K/V still equal the reference's."""
    rcache, want, cache, got = _prefill_two(pair)
    _close_kernel(got, want)
    for slot, rslot in ((2, 0), (0, 1)):
        _close_kernel(cache.state.s[:, slot], rcache["layers"]["s"][:, rslot])
        rows = torch.from_numpy(cache._flat_rows(slot, 0, 21))
        for pool, name in zip(cache.layer_flat(0), ("k", "v")):
            np.testing.assert_array_equal(
                _np(pool[rows]), _np(rcache["shared"][name][0, rslot, :21]))


def _teacher_forced(pair, close, close_state):
    """Three prompts of different lengths prefilled one by one (the
    reference spliced into one batched cache, as its engine does), then
    four decode steps on the same forced tokens over 8-token pages (the
    5-token prompt crosses a page boundary); each logit row held by
    ``close``, every slot's final Mamba2 states by ``close_state``."""
    rm, rp, pm, pp = pair
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 250, n).astype(np.int32) for n in (5, 16, 23)]
    forced = rng.integers(1, 250, (4, 3)).astype(np.int32)
    with jax.disable_jit():
        rcache, rlog = MODELS._ref_batched_cache(rm, rp, prompts, S)
    cache = pm.init_cache(3, S)
    for slot, p in enumerate(prompts):
        cache.alloc_seq(slot, len(p))
        got = pm.prefill(pp, torch.as_tensor(p[None], dtype=torch.int64),
                         cache, [slot])
        close(got[0], rlog[slot])
    for step in range(4):
        with jax.disable_jit():
            rcache, want = rm.decode_step(rp, rcache,
                                          jnp.asarray(forced[step]))
        got = pm.decode_step(pp, cache, torch.as_tensor(
            forced[step], dtype=torch.int64), [0, 1, 2])
        close(got, want)
    assert list(cache.lens) == list(cache.state.lens) == [9, 20, 27]
    for slot in range(3):
        close_state(cache, slot, rcache)
    cache.validate()


def test_teacher_forced_decode_mixed_lengths_matches_reference(
        pair, ref_attention):
    """With the reference's attention arithmetic: logits at
    ``logit_tol``, states as after prefill."""
    _teacher_forced(pair, _close_logits,
                    lambda c, slot, rc: _assert_states(c, slot, rc, slot))


def test_teacher_forced_decode_through_the_kernels_stays_near_reference(
        pair):
    """Through the plain kernel versions: logits and scan states within
    ``KERNEL_TOL``."""
    _teacher_forced(pair, _close_kernel, lambda c, slot, rc: _close_kernel(
        c.state.s[:, slot], rc["layers"]["s"][:, slot]))


def _copy_cache(pm, cache):
    """A second cache holding the same pools, tables, lengths and
    states."""
    c = pm.init_cache(cache.max_seqs, S)
    c.k_pages.copy_(cache.k_pages)
    c.v_pages.copy_(cache.v_pages)
    for name in ("tables", "lens", "held", "active"):
        getattr(c, name)[:] = getattr(cache, name)
    c._free = list(cache._free)
    for name in ("s", "conv"):
        getattr(c.state, name).copy_(getattr(cache.state, name))
    c.state.active[:] = cache.state.active
    c.state.lens[:] = cache.state.lens
    return c


def test_decode_reads_and_writes_only_its_slots(pair):
    """A step over slots [2, 0] leaves slot 1's state and pages as they
    were and equals the same step over each slot alone."""
    _, _, pm, pp = pair
    rng = np.random.default_rng(2)
    cache = pm.init_cache(3, S)
    for slot in range(3):
        cache.alloc_seq(slot, 7)
        pm.prefill(pp, torch.as_tensor(rng.integers(1, 250, (1, 7))),
                   cache, [slot])
    before = (cache.state.s[:, 1].clone(), cache.state.conv[:, 1].clone(),
              cache.k_pages.clone())
    alone = [_copy_cache(pm, cache) for _ in range(2)]
    toks = torch.tensor([11, 12])
    both = pm.decode_step(pp, cache, toks, [2, 0])
    one = [pm.decode_step(pp, alone[0], toks[:1], [2]),
           pm.decode_step(pp, alone[1], toks[1:], [0])]
    np.testing.assert_allclose(_np(both), _np(torch.cat(one)),
                               atol=BF16_TOL, rtol=0)
    assert torch.equal(cache.state.s[:, 1], before[0])
    assert torch.equal(cache.state.conv[:, 1], before[1])
    page1 = torch.from_numpy(cache.tables[1, :int(cache.held[1])]).long()
    assert torch.equal(cache.k_pages[:, page1], before[2][:, page1])
    assert list(cache.lens) == list(cache.state.lens) == [8, 7, 8]


def test_prefill_then_decode_matches_longer_prefill(pair):
    """prefill(t[:n-1]) + decode(t[n-1]) == prefill(t), logits and
    states: the chunked scan and the single step carry one state, and
    the shared block's decode reads the K/V its prefill wrote."""
    _, _, pm, pp = pair
    toks = torch.as_tensor(np.random.default_rng(3).integers(1, 250, (2, 17)),
                           dtype=torch.int64)
    cache = pm.init_cache(2, S)
    cache2 = pm.init_cache(2, S)
    for s in range(2):
        cache.alloc_seq(s, 17)
        cache2.alloc_seq(s, 16)
    full = pm.prefill(pp, toks, cache, [0, 1])
    pm.prefill(pp, toks[:, :-1], cache2, [0, 1])
    dec = pm.decode_step(pp, cache2, toks[:, -1], [0, 1])
    _close_logits(dec, full)
    _close_state(cache2.state.s, cache.state.s)
    assert list(cache2.lens) == list(cache.lens) == [17, 17]


def test_prefill_overwrites_the_whole_slot_state(pair):
    """A slot that held another request's state and pages (and garbage)
    gives the same logits and state after prefill as a fresh cache."""
    _, _, pm, pp = pair
    toks = torch.as_tensor(np.random.default_rng(4).integers(1, 250, (1, 9)))
    fresh = pm.init_cache(2, S)
    fresh.alloc_seq(1, 9)
    want = pm.prefill(pp, toks, fresh, [1])
    used = pm.init_cache(2, S)
    g = torch.Generator().manual_seed(5)
    for t in (used.state.s, used.state.conv, used.k_pages, used.v_pages):
        t.normal_(generator=g)
    used.alloc_seq(1, 4)
    pm.prefill(pp, toks[:, :4], used, [1])
    used.free_seq(1)
    used.alloc_seq(1, 9)
    got = pm.prefill(pp, toks, used, [1])
    assert torch.equal(got, want)
    for name in ("s", "conv"):
        assert torch.equal(getattr(used.state, name)[:, 1],
                           getattr(fresh.state, name)[:, 1])


# ------------------------------------------------------------ serving
def _serve(engine, cls, seed=7, n=5):
    reqs = SERVING._requests(n, np.random.default_rng(seed), cls)
    for r in reqs:
        engine.submit(r)
    return reqs, engine.run_until_drained()


@pytest.mark.parametrize("slots", [2, 3])
def test_greedy_tokens_match_reference_engine(pair, ref_attention, slots):
    """5 requests of 4-11 prompt tokens, 5 new tokens each, through
    ``slots`` slots (retired slots are reused), with the reference's
    attention arithmetic: every token equals the reference engine's,
    run op by op."""
    _, rp, _, pp = pair
    with jax.disable_jit():
        ref_reqs, _ = _serve(RefEngine(ref_reduced(ARCH), rp, slots=slots,
                                       max_seq=S), RefRequest)
    eng = ServingEngine(get_reduced(ARCH), pp, slots=slots, max_seq=S,
                        device="cpu")
    reqs, stats = _serve(eng, Request)
    assert [r.output for r in reqs] == [r.output for r in ref_reqs]
    assert stats.drained and stats.prefills == 5
    assert stats.tokens_out == 25 == sum(len(r.output) for r in reqs)
    assert not eng.cache.active.any() and not eng.cache.state.active.any()
    assert eng.cache.pages_in_use == 0
    eng.cache.validate()


@pytest.mark.parametrize("pool_pages", [None, 5])
def test_recorded_plan_trace_matches_reference_engine(pair, pool_pages):
    """``record_plans``: the trace equals the reference engine's record
    for record, compiled arrays bitwise, where the reference prices
    every one of the ``n_layers`` layers as GQA KV pages (``n_kv_heads``
    x ``head_dim``) on a shadow table.  A pool of 5 pages of 8 tokens
    defers admissions: the port holds them to its live pool of the
    shared block's pages, which has the shadow table's pages, and they
    follow the reference's."""
    _, rp, _, pp = pair
    kw = dict(slots=3, max_seq=S, record_plans=True,
              kv_pool_pages=pool_pages)
    ref_eng = RefEngine(ref_reduced(ARCH), rp, **kw)
    eng = ServingEngine(get_reduced(ARCH), pp, device="cpu", **kw)
    _serve(ref_eng, RefRequest)
    _serve(eng, Request)
    assert eng._pages is eng.cache
    assert len(eng.trace) == len(ref_eng.trace) == eng.n_records
    assert eng.deferred_admissions == ref_eng.deferred_admissions
    assert (eng.deferred_admissions > 0) == (pool_pages is not None)
    for got, want in zip(eng.trace, ref_eng.trace):
        assert (got.kind, got.step_idx, got.slots, got.uids, got.n_tokens,
                got.arrival_event) == \
            (want.kind, want.step_idx, want.slots, want.uids,
             want.n_tokens, want.arrival_event)
        assert got.plan.name == want.plan.name
        a, b = got.plan.compile(), want.plan.compile()
        assert a.n_events == b.n_events and a.page_keys == b.page_keys
        for f in SERVING.COMPILED_COLS:
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), f
    eng._table.validate()
    assert eng._table.pages_in_use == 0 == eng.cache.pages_in_use


# --------------------------------------------------------- the cache
def test_init_cache_builds_the_invocation_pool_and_the_state_store(pair):
    """A hybrid model's cache is a paged pool of one layer per
    shared-attention invocation (I = 2 here) carrying a state store of
    (L, slots, nh, N, hd) fp32 and (L, slots, K - 1, d_in + 2N) bf16;
    the engine serves from the same cache."""
    _, _, pm, pp = pair
    cfg = get_reduced(ARCH)
    cache = pm.init_cache(4, 64, page_tokens=16)
    assert isinstance(cache, PagedKVCache)
    assert isinstance(cache.state, RecurrentStateCache)
    assert cache.cross is None
    KH, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    assert tuple(cache.k_pages.shape) == (2, 16, 16, KH, hd)
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim
    L = cfg.n_layers
    assert tuple(cache.state.s.shape) == (L, 4, nh, s.d_state, s.head_dim)
    assert cache.state.s.dtype == torch.float32
    assert tuple(cache.state.conv.shape) == (L, 4, s.d_conv - 1,
                                             d_in + 2 * s.d_state)
    assert cache.state.conv.dtype == torch.bfloat16
    assert cache.state.names == ("s", "conv")
    assert cache.state.nbytes == L * 4 * (nh * s.d_state * s.head_dim * 4
                                          + (s.d_conv - 1)
                                          * (d_in + 2 * s.d_state) * 2)
    with pytest.raises(ValueError, match="enc_seq"):
        pm.init_cache(4, 64, enc_seq=10)
    eng = ServingEngine(cfg, pp, slots=4, max_seq=64, device="cpu")
    assert isinstance(eng.cache.state, RecurrentStateCache)
    assert eng._pages is eng.cache and eng._table is None


def test_hybrid_cache_bookkeeping(pair):
    """``alloc_seq`` claims a slot in the pool and the store together,
    ``free_seq`` frees both, and ``validate`` catches a store whose
    slots or lengths drift from the table's."""
    _, _, pm, _ = pair
    cache = pm.init_cache(2, 32, page_tokens=8)
    assert cache.alloc_seq(0, 5) and not cache.alloc_seq(0, 5)
    assert cache.state.active[0] and cache.held[0] == 1
    with pytest.raises(ValueError, match="not allocated"):
        cache.state.decode_slots([1])
    cache.prompt_index([0], 5)
    cache.state.prompt_slots([0], 5)
    cache.append_view([0])
    cache.state.decode_slots([0])
    assert list(cache.lens) == list(cache.state.lens) == [6, 0]
    cache.validate()
    cache.state.lens[0] = 4
    with pytest.raises(AssertionError, match="differ"):
        cache.validate()
    cache.state.lens[0] = 6
    cache.free_seq(0)
    assert not cache.active.any() and not cache.state.active.any()
    assert cache.pages_in_use == 0 and not cache.state.lens.any()
    cache.validate()
    cache.state.active[1] = True             # a store slot still held
    assert not cache.alloc_seq(1, 3) and not cache.active[1]


def test_full_config_size_and_what_n_params_omits():
    """The full tree holds 19,082,080,336 values, 38.16 GB of bf16 (all
    but 0.01% of it matrices), the reference's tree leaf for leaf.  The
    reference's ``n_params()`` counts 6,679,916,544 (13.36 GB): its
    hybrid branch leaves out the gated MLP (3 x 3,584 x 14,336) that each
    of the 81 Mamba2 layers carries (12,485,394,432), the B, C and dt
    columns of ``in_proj`` (81 x 3,584 x 240), the convolution's B and C
    channels (81 x 4 x 128) and the vectors, and counts a shared-block
    MLP (3 x 3,584 x 14,336) that the tree does not have."""
    cfg, rcfg = get_config(ARCH), ref_config(ARCH)
    spec = PT.lm_pspecs(cfg)
    rspec = RT.lm_pspecs(rcfg)

    def size(tree, normal_only=False):
        return sum(int(np.prod(p.shape)) for _, p in _leaves(tree)
                   if p.init == "normal" or not normal_only)

    total, mats = size(spec), size(spec, True)
    assert total == size(rspec) == 19_082_080_336
    assert round(2 * total / 1e9, 2) == 38.16
    assert (total - mats) / total < 1e-4
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    s = cfg.ssm
    d_in = s.expand * d
    nh = d_in // s.head_dim
    mlp = sum(size(layer["mlp"]) for layer in spec["layers"])
    assert mlp == L * 3 * d * f == 12_485_394_432
    bc_dt = L * d * (2 * s.d_state + nh) + L * s.d_conv * 2 * s.d_state
    vectors = total - mats
    assert "mlp" not in spec["shared_attn"]
    assert rcfg.n_params() == 6_679_916_544 == \
        total - mlp - bc_dt - vectors + 3 * d * f
    assert (L, d, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, f,
            cfg.padded_vocab) == (81, 3584, 32, 32, 112, 14336, 32000)
    assert cfg.source == rcfg.source == "arXiv:2411.15242; unverified"
