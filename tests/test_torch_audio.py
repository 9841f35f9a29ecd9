"""The audio family (whisper-tiny, reduced) against the reference on the
CPU: the encoder-decoder's parameter tree, encoder, prefill with its
cross-attention KV, decode steps over the paged cross cache, the
non-causal flash wrapper at a ragged key length, and what the entry
points refuse.

The reference's bf16 weights are bridged into the port with
``from_reference``; frames and tokens are numpy draws from a seed (the
frames ``x 0.02``, as ``make_concrete_batch`` draws them).  The port runs
on the CPU, where every kernel wrapper takes its plain version, and its
cross-attention reads the encoder's K/V from ``cache.cross`` through
the paged wrapper; the reference reads a contiguous cross cache with
XLA attention.

Tolerances: fp32 3e-5 (the kernels' plain versions against the Pallas
kernels in interpret mode: fp32 sums in another order).  bf16 logits,
encoder outputs and cross K/V: ``logit_tol`` of ``test_torch_models.py``,
max(1e-2, 1.5e-2 · max|want|): bf16 rounding at other places (the
reference rounds attention probabilities to bf16 before PV, the plain
flash and paged versions keep them fp32).
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs import get_reduced as ref_reduced  # noqa: E402
from repro.kernels import flash_attention as jax_flash  # noqa: E402
from repro.kernels import paged_attention as jax_paged  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import from_reference  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

logit_tol = importlib.import_module("test_torch_models").logit_tol
SERVING = importlib.import_module("test_torch_serving")
PARAMS = importlib.import_module("test_torch_params")
_leaves, _same = PARAMS._leaves, PARAMS._assert_same

ARCH = "whisper_tiny"
F32_TOL = 3e-5
B, TE, TD = 2, 40, 4          # clips, encoder frames, decoder prompt


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(got, want):
    np.testing.assert_allclose(_np(got), _np(want), atol=logit_tol(want),
                               rtol=0)


@pytest.fixture(scope="module")
def pair():
    rm = RefModel(ref_reduced(ARCH), remat="none")
    rp = rm.init(jax.random.PRNGKey(0))
    cfg = get_reduced(ARCH)
    pp = from_reference(jax.tree.map(np.asarray, rp), cfg)
    return rm, rp, Model(cfg, device="cpu"), pp


def _inputs(seed, b=B, td=TD):
    rng = np.random.default_rng(seed)
    d = get_reduced(ARCH).d_model
    frames = rng.standard_normal((b, TE, d), np.float32) * 0.02
    toks = rng.integers(1, 250, (b, td)).astype(np.int32)
    return rng, frames, toks


def _prefill(pm, pp, frames, toks, slots, cache=None, max_seq=16):
    if cache is None:
        cache = pm.init_cache(len(slots), max_seq, page_tokens=8,
                              enc_seq=frames.shape[1])
    for s in slots:
        cache.alloc_seq(s, toks.shape[1])
    logits = pm.prefill(pp, torch.from_numpy(toks).long(), cache, slots,
                        audio_frames=torch.from_numpy(frames))
    return cache, logits


# ------------------------------------------------------ parameter tree
@pytest.mark.parametrize("reduced", [True, False])
def test_pspec_tree_matches_reference(reduced):
    """Same leaves in the same order, shapes, init laws and dtypes as the
    reference tree, each stack's L axis split into a list of layers:
    ``enc_layers`` plain dense layers, ``layers`` with ``ln_x`` and
    ``xattn``, and ``pos_embed`` (max_train_seq · 8, d) at scale 0.02."""
    rcfg = ref_reduced(ARCH) if reduced else ref_config(ARCH)
    pcfg = get_reduced(ARCH) if reduced else get_config(ARCH)
    rspec, pspec = RT.lm_pspecs(rcfg), PT.lm_pspecs(pcfg)
    assert list(pspec) == list(rspec) == [
        "embed", "lm_head", "final_norm", "enc_layers", "enc_norm",
        "layers", "pos_embed"]
    assert len(pspec["enc_layers"]) == pcfg.n_encoder_layers
    assert len(pspec["layers"]) == pcfg.n_layers
    for stack in ("enc_layers", "layers"):
        # the reference's stacked layer tree comes out of a tree map,
        # with its keys sorted
        want = sorted(_leaves(rspec[stack]), key=lambda kv: kv[0])
        got = sorted(_leaves(pspec[stack][0]), key=lambda kv: kv[0])
        assert [k for k, _ in got] == [k for k, _ in want]
        n = len(pspec[stack])
        for (_, p), (path, r) in zip(got, want):
            assert (n,) + p.shape == r.shape, path
            assert (p.init, p.scale, p.dtype) == \
                (r.init, r.scale, r.dtype), path
            assert p.shape[p.fan_axis] == r.shape[r.fan_axis], path
    assert {"ln_x", "xattn"} <= set(pspec["layers"][0])
    assert not {"ln_x", "xattn"} & set(pspec["enc_layers"][0])
    for key in ("embed", "lm_head", "final_norm", "enc_norm", "pos_embed"):
        for (path, p), (_, r) in zip(_leaves(pspec[key]),
                                     _leaves(rspec[key]), strict=True):
            assert (p.shape, p.init, p.scale, p.dtype) == \
                (r.shape, r.init, r.scale, r.dtype), path
    assert pspec["pos_embed"].shape == (pcfg.max_train_seq * 8,
                                        pcfg.d_model)


def test_from_reference_equals_reference_leaf_by_leaf(pair):
    _, rp, _, pp = pair
    rp_np = jax.tree.map(np.asarray, rp)
    n = 0
    for key, ref_tree in rp_np.items():
        if key in ("enc_layers", "layers"):
            assert len(pp[key]) == ref_tree["ln1"]["scale"].shape[0]
            for i, layer in enumerate(pp[key]):
                got = dict(_leaves(layer))
                for path, a in _leaves(jax.tree.map(lambda x, i=i: x[i],
                                                    ref_tree)):
                    _same(got[path], a)
                    n += 1
        else:
            got = dict(_leaves(pp[key]))
            for path, a in _leaves(ref_tree):
                _same(got[path], a)
                n += 1
    # embed, lm_head, final norm (2), enc_norm (2), pos_embed; 12 leaves
    # an encoder layer (2 norms of 2, q/k/v/o, the plain MLP's 4) and 18
    # a decoder layer (plus ln_x's 2 and xattn's 4), 2 layers each
    assert n == 7 + 2 * 12 + 2 * 18


# ------------------------------------------------------------- forward
def test_encoder_matches_reference(pair):
    """The port's ``encode`` (non-causal flash per layer, then
    ``enc_norm``) against the reference's encoder output."""
    _, rp, pm, pp = pair
    _, frames, toks = _inputs(0)
    _, _, extras = RT.forward_train(
        rp, ref_reduced(ARCH), {"audio_frames": jnp.asarray(frames),
                                "tokens": jnp.asarray(toks)}, remat="none")
    got = PT.encode(pp, pm.cfg, torch.from_numpy(frames))
    assert got.dtype == torch.bfloat16 and got.shape == (B, TE, 64)
    _close(got, extras["encoder_out"])


def test_prefill_logits_and_cross_kv_match_reference(pair):
    """Last-token logits, and every layer's encoder K/V in the cross pool
    against the reference's ``cache["cross"]``; the cross lengths are Te,
    the self lengths Td."""
    rm, rp, pm, pp = pair
    _, frames, toks = _inputs(1)
    rcache, want = rm.prefill(rp, {"audio_frames": jnp.asarray(frames),
                                   "tokens": jnp.asarray(toks)}, 16)
    cache, got = _prefill(pm, pp, frames, toks, [0, 1])
    assert got.dtype == torch.bfloat16
    _close(got, want)
    assert (_np(got).argmax(-1) == _np(want).argmax(-1)).all()
    cross = cache.cross
    assert list(cache.lens[:B]) == [TD] * B
    assert list(cross.lens[:B]) == [TE] * B
    assert cross.cfg.max_pages_per_seq == -(-TE // 8)
    rows = torch.stack([torch.from_numpy(cross._flat_rows(s, 0, TE))
                        for s in range(B)])
    for layer in range(pm.cfg.n_layers):
        kf, vf = cross.layer_flat(layer)
        _close(kf[rows], rcache["cross"]["k"][layer])
        _close(vf[rows], rcache["cross"]["v"][layer])
    cache.validate()


def test_decode_steps_and_greedy_tokens_match_reference(pair):
    """Four greedy decode steps on the reference; the port decodes the
    reference's tokens (teacher-forced), its logits within ``logit_tol``
    each step and its own greedy pick the reference's, or within one
    bf16 ulp of it on the port's logits (a tie)."""
    rm, rp, pm, pp = pair
    _, frames, toks = _inputs(2)
    rcache, want = rm.prefill(rp, {"audio_frames": jnp.asarray(frames),
                                   "tokens": jnp.asarray(toks)}, 16)
    cache, got = _prefill(pm, pp, frames, toks, [0, 1])
    V = pm.cfg.vocab_size
    for step in range(5):
        _close(got, want)
        picks = _np(want)[:, :V].argmax(-1)
        for b, (mine, ref) in enumerate(zip(_np(got)[:, :V].argmax(-1),
                                            picks)):
            if mine != ref:
                SERVING._assert_tie(got[b].float(), int(mine), int(ref),
                                    (step, b))
        if step == 4:
            break
        rcache, want = rm.decode_step(rp, rcache, jnp.asarray(
            picks.astype(np.int32)))
        got = pm.decode_step(pp, cache, torch.from_numpy(picks).long(),
                             [0, 1])
    assert list(cache.lens[:B]) == [TD + 4] * B
    assert list(cache.cross.lens[:B]) == [TE] * B
    cache.validate()


def test_mixed_prompt_lengths_decode_matches_reference(pair):
    """Two clips prefilled one at a time with decoder prompts of 3 and 6
    tokens, then decoded together: each slot adds ``pos_embed`` at its
    own position and reads its own cross pages.  Each clip runs alone
    through the reference."""
    rm, rp, pm, pp = pair
    rng, frames, _ = _inputs(3)
    prompts = [rng.integers(1, 250, (1, n)).astype(np.int32) for n in (3, 6)]
    forced = rng.integers(1, 250, (3, B)).astype(np.int32)
    cache = pm.init_cache(B, 16, page_tokens=4, enc_seq=TE)
    refs = []
    for s, p in enumerate(prompts):
        rc, want = rm.prefill(rp, {"audio_frames": jnp.asarray(
            frames[s:s + 1]), "tokens": jnp.asarray(p)}, 16)
        _, got = _prefill(pm, pp, frames[s:s + 1], p, [s], cache=cache)
        _close(got, want)
        refs.append(rc)
    for step in range(3):
        got = pm.decode_step(pp, cache, torch.from_numpy(
            forced[step]).long(), [0, 1])
        for s in range(B):
            refs[s], want = rm.decode_step(rp, refs[s], jnp.asarray(
                forced[step, s:s + 1]))
            _close(got[s:s + 1], want)
    assert list(cache.lens[:B]) == [6, 9]
    cache.validate()


def test_cross_pages_are_freed_with_the_slot(pair):
    """``free_seq`` returns a slot's self and cross pages together; a new
    prefill into the slot then reuses them; a slot that still holds
    encoder KV refuses a prefill."""
    _, _, pm, pp = pair
    _, frames, toks = _inputs(4)
    cache, _ = _prefill(pm, pp, frames, toks, [0, 1])
    held = cache.cross.pages_in_use
    assert held == B * -(-TE // 8)
    cache.free_seq(1)
    assert cache.cross.pages_in_use == held // 2
    assert not cache.cross.active[1] and cache.cross.active[0]
    cache.validate()
    with pytest.raises(ValueError, match="still holds encoder KV"):
        pm.prefill(pp, torch.from_numpy(toks[:1]).long(), cache, [0],
                   audio_frames=torch.from_numpy(frames[:1]))
    cache.free_seq(0)
    _prefill(pm, pp, frames[1:], toks[1:], [1], cache=cache)
    assert cache.cross.pages_in_use == held // 2
    cache.validate()


def test_read_view_claims_and_writes_nothing(pair):
    _, _, pm, pp = pair
    _, frames, toks = _inputs(5)
    cache, _ = _prefill(pm, pp, frames, toks, [0, 1])
    cross = cache.cross
    before = (cross.k_pages.clone(), cross.lens.copy(), cross.held.copy())
    view = cross.read_view([1, 0])
    assert view.positions is None and view.write_index is None
    assert view.lens.tolist() == [TE, TE]
    assert torch.equal(view.table, torch.from_numpy(cross.tables[[1, 0]]))
    assert torch.equal(cross.k_pages, before[0])
    assert (cross.lens == before[1]).all() and (cross.held == before[2]).all()
    cache.free_seq(1)
    with pytest.raises(ValueError, match="inactive slot 1"):
        cross.read_view([1])


# ----------------------------------------------------------- kernels
@pytest.mark.parametrize("tq,tk", [(150, 150), (4, 150), (37, 150)])
def test_flash_noncausal_ragged_tk_matches_reference(tq, tk):
    """``ops.flash_attention(..., causal=False, bk=Tk)`` at a key length
    that is a multiple of no 64-key tile (the encoder's 1,500 frames,
    scaled down), self-attention (Tq = Tk) and cross-attention (Tq !=
    Tk), against the reference wrapper's Pallas kernel in interpret mode
    with ``bk=Tk``; fp32, 3e-5."""
    rng = np.random.default_rng(6)
    q = rng.standard_normal((2, tq, 4, 16), np.float32)
    k = rng.standard_normal((2, tk, 4, 16), np.float32)
    v = rng.standard_normal((2, tk, 4, 16), np.float32)
    want = jax_flash(*(jnp.asarray(a) for a in (q, k, v)), causal=False,
                     bk=tk, interpret=True)
    got = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=False, bk=tk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL,
                               rtol=F32_TOL)


def test_paged_cross_table_matches_reference():
    """Decode cross-attention's paged call: every sequence at the
    encoder's length Te over a table of ⌈Te / page⌉ pages (the full
    model's 1,500 frames over 94 pages of 16, scaled down to 150 over
    10), against the Pallas kernel in interpret mode; fp32, 3e-5."""
    rng = np.random.default_rng(7)
    b, h, d, page, te = 3, 6, 16, 16, 150
    mp = -(-te // page)
    P = b * mp + 2
    q = rng.standard_normal((b, h, d), np.float32)
    kp = rng.standard_normal((P, page, h, d), np.float32)
    vp = rng.standard_normal((P, page, h, d), np.float32)
    table = rng.permutation(P)[:b * mp].reshape(b, mp).astype(np.int32)
    lens = np.full((b,), te, np.int32)
    args = (q, kp, vp, table, lens)
    want = jax_paged(*(jnp.asarray(a) for a in args), interpret=True)
    got = ops.paged_attention(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL,
                               rtol=F32_TOL)


# -------------------------------------------------------- full size
def test_full_config_size_and_what_n_params_omits():
    """The reference's ``n_params()`` counts whisper-tiny as 8 layers of
    self-attention and MLP (each encoder layer counted as a decoder
    layer) plus the embedding and the untied head: 54,067,200, 0.11 GB
    of bf16.  It leaves out the 4 decoder layers' cross-attention (4 ·
    4 · 384², 2,359,296) and the 65,536 x 384 ``pos_embed``
    (25,165,824), which the port's tree holds: 81,592,320 matrix
    values, 0.16 GB."""
    cfg, rcfg = get_config(ARCH), ref_config(ARCH)
    spec = PT.lm_pspecs(cfg)

    def mats(tree, skip=None):
        return sum(int(np.prod(p.shape)) for path, p in _leaves(tree)
                   if p.init == "normal" and not (skip and skip in path))

    counted = (mats(spec["enc_layers"]) + mats(spec["layers"], "/xattn")
               + mats(spec["embed"]) + mats(spec["lm_head"]))
    assert counted == rcfg.n_params() == 54_067_200
    assert round(2 * counted / 1e9, 2) == 0.11
    xattn = sum(mats(layer["xattn"]) for layer in spec["layers"])
    assert xattn == cfg.n_layers * 4 * cfg.d_model ** 2 == 2_359_296
    assert mats(spec["pos_embed"]) == 65_536 * 384
    total = sum(mats(spec[k]) for k in spec)
    assert total == counted + xattn + 65_536 * 384 == 81_592_320
    assert cfg.padded_vocab == 51_968 and cfg.resolved_head_dim == 64


# ---------------------------------------------------------- refusals
def test_entry_points_refuse_what_they_must(pair, monkeypatch):
    """The engine refuses an audio config (the reference's prefills
    token ids only), and so does ``launch/serve.py --arch whisper-tiny``
    with the same message; prefill takes frames and tokens for audio,
    never embeddings, and no frames for any other family; the cross
    cache comes with an audio config and an encoder length only."""
    _, _, pm, pp = pair
    cfg = pm.cfg
    with pytest.raises(NotImplementedError, match="Model.prefill"):
        ServingEngine(cfg, pp, device="cpu")
    from repro_torch.launch import serve
    monkeypatch.setattr("sys.argv", ["serve", "--arch", "whisper-tiny",
                                     "--reduced", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="Model.prefill"):
        serve.main()
    _, frames, toks = _inputs(8, b=1)
    f, t = torch.from_numpy(frames), torch.from_numpy(toks).long()
    cache = pm.init_cache(1, 16, enc_seq=TE)
    cache.alloc_seq(0, TD)
    with pytest.raises(ValueError, match="no embeddings"):
        pm.prefill(pp, t, cache, [0], audio_frames=f,
                   embeddings=torch.zeros((1, TD, cfg.d_model)))
    with pytest.raises(ValueError, match="audio_frames"):
        pm.prefill(pp, t, cache, [0])
    with pytest.raises(ValueError, match="audio_frames"):
        pm.prefill(pp, None, cache, [0], audio_frames=f)
    dense = Model(get_reduced("qwen2_0_5b"), device="cpu")
    with pytest.raises(ValueError, match="no audio_frames"):
        dense.prefill(None, t, dense.init_cache(1, 16), [0], audio_frames=f)
    with pytest.raises(ValueError, match="enc_seq"):
        pm.init_cache(1, 16)
    with pytest.raises(ValueError, match="enc_seq"):
        dense.init_cache(1, 16, enc_seq=TE)
    assert dense.init_cache(1, 16).cross is None
