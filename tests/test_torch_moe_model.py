"""The port's MoE model and engine against the reference, on the CPU at
the reduced qwen2-moe config (2 layers, d 64, 4/4 heads, 8 experts of
d_ff 96, top-2, one shared expert), with the reference's bf16 weights
bridged into the port.

Both serve with lossless routing (capacity ``B * Tq`` at prefill, the
token count at decode).  A variant with ``first_dense_layers = 1`` runs
the ``dense_layers`` stack before the MoE stack.

Tolerances.  The reference runs as it serves, jitted with XLA's
default options, and the logits differ from it for two rounding
differences that the dense tests also meet: the reference's XLA
attention rounds probabilities to bf16 before PV where the flash and
paged oracles keep them fp32, and XLA drops the bf16 roundings between
the ops it fuses (``xla_allow_excess_precision``) where PyTorch rounds
every op.  The dense model's logits stay under 0.5 and meet 1e-2; here
the reference's init law gives the experts a 1/sqrt(E) scale, the
residual stream reaches |x| ~ 60 after two layers and the untied head
gives logits of ~3, so the same ulps read 0.03-0.06 (measured).  Logits
are held to 2.5e-2·max(1, max|logit|), and each (layer, token)'s expert
set is recorded on both sides and must agree.  A router near-tie turns
such ulps into another expert and an O(1) change of that token, so the
greedy-token test compares the tokens each request produced while its
routing agreed with the reference's.
"""
import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs import get_reduced as ref_reduced  # noqa: E402
from repro.models import moe as RMOE  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro.serving.engine import Request as RefRequest  # noqa: E402
from repro.serving.engine import ServingEngine as RefEngine  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.models import moe as PMOE  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import from_reference  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402

LOGIT_TOL = 2.5e-2
ARCH = "qwen2_moe_a2_7b"
COMPILED_COLS = ("trace_ids", "trace_nbytes", "trace_is_out", "in_lane",
                 "op_kind", "op_val", "grp_end", "n_lanes", "seg_op",
                 "seg_trace")


def _cfgs(first_dense: int):
    rcfg, cfg = ref_reduced(ARCH), get_reduced(ARCH)
    if first_dense:
        rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
            rcfg.moe, first_dense_layers=first_dense))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, first_dense_layers=first_dense))
    return rcfg, cfg


@pytest.fixture(scope="module", params=[0, 1], ids=["moe", "dense+moe"])
def pair(request):
    rcfg, cfg = _cfgs(request.param)
    rm = RefModel(rcfg, remat="none")
    rp = rm.init(jax.random.PRNGKey(0))
    pp = from_reference(jax.tree.map(np.asarray, rp), cfg)
    return rm, rp, Model(cfg, device="cpu"), pp


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


@contextlib.contextmanager
def _routes(monkeypatch):
    """Record every MoE call's expert sets, (n tokens, k) sorted, on both
    sides, in call order (layer by layer within each prefill or decode
    step).  The reference's are read from inside its layer scan with an
    ordered debug callback, from the same router expression."""
    ref_routes, port_routes = [], []
    ref_apply, port_apply = RMOE.apply_moe, PMOE.apply_moe

    def ref_wrap(p, x, cfg, capacity_factor=1.25, capacity=None):
        xt = x.reshape(-1, x.shape[-1])
        probs = jax.nn.softmax((xt @ p["router"]).astype(jnp.float32), -1)
        _, top_e = jax.lax.top_k(probs, cfg.moe.top_k)
        jax.debug.callback(
            lambda e: ref_routes.append(np.sort(np.asarray(e), -1)),
            top_e, ordered=True)
        return ref_apply(p, x, cfg, capacity_factor, capacity)

    def port_wrap(p, x, cfg, capacity_factor=1.25, capacity=None):
        _, top_e, _ = PMOE._route(p, x.reshape(-1, x.shape[-1]), cfg)
        port_routes.append(np.sort(top_e.numpy(), -1))
        return port_apply(p, x, cfg, capacity_factor, capacity)

    monkeypatch.setattr(RMOE, "apply_moe", ref_wrap)
    monkeypatch.setattr(PMOE, "apply_moe", port_wrap)
    yield ref_routes, port_routes
    jax.effects_barrier()


def _agreement(ref_routes, port_routes) -> float:
    assert len(ref_routes) == len(port_routes) > 0
    same = [np.all(r == p, -1) for r, p in zip(ref_routes, port_routes)]
    return float(np.concatenate(same).mean())


def _close(got, want):
    want = _np(want)
    np.testing.assert_allclose(
        _np(got), want, rtol=0,
        atol=LOGIT_TOL * max(1.0, float(np.abs(want).max())))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def test_from_reference_bridges_moe_weights_leaf_by_leaf(pair):
    """Every leaf, the (E, d, f) experts, the (d, E) router, the shared
    experts and the ``dense_layers`` stack included, equal in dtype,
    shape and value."""
    rm, rp, pm, pp = pair
    rp_np = jax.tree.map(np.asarray, rp)
    stacks = ("layers", "dense_layers")
    top = {k: v for k, v in rp_np.items() if k not in stacks}
    got = dict(_leaves({k: v for k, v in pp.items() if k not in stacks}))
    n = 0
    for path, leaf in _leaves(top):
        _assert_same(got[path], leaf)
        n += 1
    cfg = pm.cfg
    nd = cfg.moe.first_dense_layers
    assert len(pp.get("dense_layers", [])) == nd
    assert len(pp["layers"]) == cfg.n_layers - nd
    for name in stacks:
        for i, layer in enumerate(pp.get(name, [])):
            want = dict(_leaves(jax.tree.map(lambda a: a[i], rp_np[name])))
            got_l = dict(_leaves(layer))
            assert got_l.keys() == want.keys()
            for path, leaf in want.items():
                _assert_same(got_l[path], leaf)
                n += 1
    moe = pp["layers"][0]["moe"]
    E, d, f = 8, cfg.d_model, cfg.moe.d_ff_expert
    assert tuple(moe["wi_gate"].shape) == (E, d, f)
    assert tuple(moe["wo"].shape) == (E, f, d)
    assert tuple(moe["router"].shape) == (d, E)
    # embed, lm_head, final norm; 16 leaves a MoE layer, 12 a dense one
    assert n == 3 + 16 * (cfg.n_layers - nd) + 12 * nd


def _assert_same(t, a):
    assert tuple(t.shape) == a.shape
    assert str(t.dtype).removeprefix("torch.") == a.dtype.name
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))


@pytest.mark.parametrize("reduced", [True, False])
def test_moe_pspec_tree_matches_reference(reduced):
    rcfg = ref_reduced(ARCH) if reduced else ref_config(ARCH)
    pcfg = get_reduced(ARCH) if reduced else get_config(ARCH)
    rspec, pspec = RT.lm_pspecs(rcfg), PT.lm_pspecs(pcfg)
    assert "lm_head" in pspec and "dense_layers" not in pspec
    assert len(pspec["layers"]) == pcfg.n_layers
    rlayer = dict(_leaves(rspec["layers"]))
    plist = list(_leaves(pspec["layers"][0]))
    assert {p for p, _ in plist} == set(rlayer)
    for path, p in plist:
        r = rlayer[path]
        assert (pcfg.n_layers,) + p.shape == r.shape, path
        assert (p.init, p.scale, p.dtype) == (r.init, r.scale, r.dtype)
        assert p.shape[p.fan_axis] == r.shape[r.fan_axis], path
    for key in ("embed", "lm_head", "final_norm"):
        for (path, p), (_, r) in zip(_leaves(pspec[key]),
                                     _leaves(rspec[key])):
            assert (p.shape, p.init, p.scale, p.dtype) == \
                (r.shape, r.init, r.scale, r.dtype), path


def test_full_config_sizes():
    """qwen2-moe-a2.7b at full width: 14,316,158,976 parameters (28.6 GB
    in bf16), 570,554,368 of them in each layer's bf16 leaves, 91% of
    those in the routed experts."""
    cfg = get_config("qwen2-moe-a2.7b")
    spec = PT.lm_pspecs(cfg)
    sizes = [int(np.prod(p.shape)) for _, p in _leaves(spec)]
    assert sum(sizes) == 14_316_158_976 + 24 * 2 * 2048 + 2048
    layer = dict(_leaves(spec["layers"][0]))
    bf16 = sum(int(np.prod(p.shape)) for p in layer.values()
               if p.dtype is None)
    experts = sum(int(np.prod(layer[f"/moe/{k}"].shape))
                  for k in ("wi_gate", "wi_up", "wo"))
    assert bf16 == 570_554_368 and experts == 519_045_120


def test_prefill_logits_match_reference(pair, monkeypatch):
    rm, rp, pm, pp = pair
    toks = np.random.default_rng(0).integers(1, 250, (2, 12)).astype(
        np.int32)
    cache = pm.init_cache(2, 32)
    for s in range(2):
        cache.alloc_seq(s, 12)
    with _routes(monkeypatch) as (ref_routes, port_routes):
        _, want = rm.prefill(rp, {"tokens": jnp.asarray(toks)}, 32)
        got = pm.prefill(pp, torch.as_tensor(toks, dtype=torch.int64),
                         cache, [0, 1])
    assert got.dtype == torch.bfloat16
    assert len(port_routes) == len(pp["layers"])
    assert _agreement(ref_routes, port_routes) == 1.0
    _close(got, want)
    assert list(cache.lens[:2]) == [12, 12]


def test_teacher_forced_decode_mixed_lengths_matches_reference(
        pair, monkeypatch):
    """Prefill three sequences of different lengths one by one, then
    four batched decode steps on forced tokens through 4-token pages;
    the expert sets of every (layer, token) on both sides agree."""
    with _routes(monkeypatch) as (ref_routes, port_routes):
        _teacher_forced(*pair)
    assert len(port_routes) == 7 * len(pair[3]["layers"])
    assert _agreement(ref_routes, port_routes) == 1.0


def _teacher_forced(rm, rp, pm, pp):
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 250, n).astype(np.int32) for n in (5, 9, 14)]
    forced = rng.integers(1, 250, (4, 3)).astype(np.int32)
    S, B = 32, 3
    rcache = rm.init_cache(B, S)
    cache = pm.init_cache(B, S, page_tokens=4)
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
        _close(got[0], rlog[0])
    for step in range(4):
        rcache, want = rm.decode_step(rp, rcache, jnp.asarray(forced[step]))
        got = pm.decode_step(pp, cache, torch.as_tensor(
            forced[step], dtype=torch.int64), [0, 1, 2])
        _close(got, want)
    assert list(cache.lens[:3]) == [9, 13, 18]
    cache.validate()


def test_decode_is_independent_of_the_batch(pair):
    """Lossless routing: a slot's decode logits are the same whether it
    decodes alone or beside others."""
    _, _, pm, pp = pair
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, 250, n).astype(np.int32) for n in (6, 11)]
    cache = pm.init_cache(2, 32, page_tokens=4)
    for slot, p in enumerate(prompts):
        cache.alloc_seq(slot, len(p))
        pm.prefill(pp, torch.as_tensor(p[None], dtype=torch.int64), cache,
                   [slot])
    lone = pm.init_cache(1, 32, page_tokens=4)
    lone.alloc_seq(0, len(prompts[1]))
    pm.prefill(pp, torch.as_tensor(prompts[1][None], dtype=torch.int64),
               lone, [0])
    both = pm.decode_step(pp, cache, torch.tensor([7, 9]), [0, 1])
    one = pm.decode_step(pp, lone, torch.tensor([9]), [0])
    assert torch.equal(both[1], one[0])


def _requests(n, rng, cls):
    return [cls(uid=i,
                prompt=rng.integers(1, 250, size=int(rng.integers(4, 12))
                                    ).astype(np.int32),
                max_new_tokens=5) for i in range(n)]


@pytest.fixture(scope="module")
def weights():
    rp = RefModel(ref_reduced(ARCH), remat="none").init(
        jax.random.PRNGKey(0))
    return rp, from_reference(jax.tree.map(np.asarray, rp),
                              get_reduced(ARCH))


def _step_agreement(trace, ref_routes, port_routes, n_moe):
    """Per request, whether its expert sets agreed on both sides in every
    MoE layer of each of its steps ({uid: [bool per step]}), and the
    share of (layer, token) sets that agree.  Steps follow the engines'
    plan records; the port decodes only the active slots, in record
    order, the reference all slots, by slot index."""
    assert len(ref_routes) == len(port_routes) == n_moe * len(trace)
    steps, same = {}, []
    for s, rec in enumerate(trace):
        calls = range(s * n_moe, (s + 1) * n_moe)
        for i, (slot, uid) in enumerate(zip(rec.slots, rec.uids)):
            rows = [np.all(ref_routes[c] == port_routes[c], -1)
                    if rec.kind == "prefill" else
                    np.all(ref_routes[c][slot:slot + 1]
                           == port_routes[c][i:i + 1], -1)
                    for c in calls]
            same.extend(rows)
            # a prompt token's last-layer expert set reaches only its
            # own logits, which prefill drops unless it is the last token
            if rec.kind == "prefill":
                rows[-1] = rows[-1][-1:]
            steps.setdefault(uid, []).append(all(r.all() for r in rows))
    return steps, float(np.concatenate(same).mean())


@pytest.mark.parametrize("slots", [1, 3])
def test_greedy_tokens_match_reference_engine(weights, slots, monkeypatch):
    """Greedy tokens against the reference engine as it compiles by
    default, routing-aware (see the module docstring): each request's
    expert sets are recorded on both sides at every step, and every
    token produced while the request's routing had agreed in all its
    steps so far equals the reference's.  A routing fault reads far
    below the agreement floor (1/C(8, 2) of sets agree by chance)."""
    rp, pp = weights
    cfg = get_reduced(ARCH)
    with _routes(monkeypatch) as (ref_routes, port_routes):
        ref_eng = RefEngine(ref_reduced(ARCH), rp, slots=slots, max_seq=64,
                            record_plans=True)
        ref_reqs = _requests(5, np.random.default_rng(7), RefRequest)
        for r in ref_reqs:
            ref_eng.submit(r)
        ref_eng.run_until_drained()
        jax.effects_barrier()
        n_ref = len(ref_routes)
        eng = ServingEngine(cfg, pp, slots=slots, max_seq=64,
                            device="cpu", record_plans=True)
        reqs = _requests(5, np.random.default_rng(7), Request)
        for r in reqs:
            eng.submit(r)
        stats = eng.run_until_drained()
    assert len(ref_routes) == n_ref
    n_moe = cfg.n_layers - cfg.moe.first_dense_layers
    agree, share = _step_agreement(eng.trace, ref_routes, port_routes,
                                   n_moe)
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


def test_recorded_plan_trace_matches_reference_engine(weights):
    """``record_plans`` on the MoE config: the same records, and the
    same compiled arrays, as the reference engine's."""
    rp, pp = weights
    ref_eng = RefEngine(ref_reduced(ARCH), rp, slots=3, max_seq=64,
                        record_plans=True)
    eng = ServingEngine(get_reduced(ARCH), pp, slots=3, max_seq=64,
                        device="cpu", record_plans=True)
    for e, cls in ((ref_eng, RefRequest), (eng, Request)):
        for r in _requests(5, np.random.default_rng(7), cls):
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
        for f in COMPILED_COLS:
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), f
