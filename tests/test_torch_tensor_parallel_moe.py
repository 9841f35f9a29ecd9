"""Tensor parallelism of the moe family in the port's train step
(``models/moe.py``, MLA in ``models/layers.py``,
``sharding/tensor_parallel.py``, ``launch/steps.py``): the routed
experts split over ``model`` by expert (E divides the extent) or by
column (it does not), the router's logits gathered, the shared experts
and the dense MLP by column, MLA and GQA attention by heads, the
vocabulary in blocks.

Gloo ranks on the CPU (``torch_mesh_ranks.start``; bodies in
``torch_tp_moe_ranks``), reduced qwen2-moe-a2.7b (8 experts of 96
columns, top-2, one shared expert, 4 heads) and deepseek-v3 (one dense
MLA layer and one MoE layer of 8 experts of 48 columns, MTP head) with
the reference's weights (``from_reference``), on (1, 2), (1, 3), (1, 4)
and (2, 2) meshes: all jobs and two reference processes at once in one
module fixture (about 70 s alone on one worker).

- Routes.  A tensor-parallel step rounds a layer's output once more or
  less than one rank does (``models/moe.py``), and a token whose k-th
  and (k+1)-th router logits are a near tie can take another expert set
  with it; on these models such a flip moves a step's loss by up to
  1.4e-3 and its gradient norm by 3%.  So each run is held on the same
  routes as its witness (``torch_tp_moe_ranks.RouteBook``), and the
  routes themselves are held apart: at the first batch, every token
  whose expert set the mesh and one rank chose differently is a near
  tie, its one-rank logits' gap at most ``TIE`` (4 bf16 steps at 1), at
  most ``FLIPS`` of a layer's tokens (measured: 0 in every first layer;
  2 of 128 in qwen2-moe's second, gaps 0.0156 and 0.0059; 4 of 128 on
  (2, 2), three of them exact ties in bf16).
- Every case is held as ``tests/test_torch_mesh.py`` holds a mesh run:
  the first step of the mesh taking the one-rank port's routes against
  the reference's first step at its tolerances (metrics at 1e-3, grad
  norm 1e-2; the AdamW gradient each leaf within 5e-2 relative L2);
  every step of the mesh (its own routes) against the one-rank step
  taking those routes (each leaf's update within 0.3 relative L2, all
  together within 0.1, a leaf whose update rounding decides by its
  size; 4 steps, 2 with Adafactor), and the first batch's gradient
  against one rank's, each leaf within 5e-2.  Against one rank the
  metrics are held at 3e-3 (loss, cross-entropy, aux, MTP) and the grad
  norm at 2e-2, wider than the dense cases' 1e-3 and 1e-2: on the same
  routes the reduced MoE layers' outputs (values up to ~80) move by a
  bf16 rounding, and the MTP head's unnormed logits magnify a relative
  change of its input; measured at most 8e-4 (loss), 1.6e-3 (aux),
  2.5e-3 (MTP, (1, 3) deepseek-v3 at step 3) and 1.38e-2 (grad norm,
  (1, 2) deepseek-v3 after Adam's first update).  Under INT8
  compression each leaf's codes are 1/127 of its largest value, and the
  rounding apart flips codes: the first gradient is held at 0.1 per
  leaf (measured 7.3%) and the updates together at 0.15 (measured
  0.128); the INT8 case's first gradient against the reference at 0.1
  too.  Every leaf's first gradient is held by its direction, the key
  bias ``bk`` too (measured at most 2.9% against one rank, 6.0% under
  INT8).
  The cases: (1, 2) qwen2-moe (expert split, 4 of 8; heads, shared
  expert and vocabulary split), with remat "full" and with INT8
  compression; (1, 3) qwen2-moe (8 experts do not divide: the column
  split, 32 of 96 columns; the attention and the vocabulary whole);
  (1, 2) and (1, 4) deepseek-v3 (MLA heads, experts, dense MLP, MTP
  loss), (1, 2) with Adafactor; (1, 3) deepseek-v3 (column split, 16 of
  48; MLA whole); (2, 2) qwen2-moe (batch split, row-local dispatch).
- Every forward product of the mesh's first step reads its weight leaf
  at the local width, the grouped ones included: (E / m, K, N) by
  expert, (E, K, N / m) or (E, K / m, N) by column.
- ``gather_from_model`` on 4 ranks against the whole computation
  (forward, each block's gradient under a softmax, one all-gather
  recorded), and ``copy_to_model`` of two tensors (their gradients
  summed in one all-reduce).
- A (1, 2) MoE state, split by expert, restores onto (2, 1) bit for bit
  and trains on.
- The dry run on a reduced (4, 4) plan on ``meta``: rank 0's 2-D and
  grouped GEMM flops equal the placements' prediction exactly for both
  archs, ``tensor_parallel`` 4, each MoE layer's logits gathered once
  a forward; on the production (16, 16) plan both archs' train step
  splits over 16.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import torch_mesh_ranks as R  # noqa: E402
import torch_mesh_reference as REF  # noqa: E402
import torch_tp_moe_ranks as TPM  # noqa: E402
from repro.configs import get_reduced as ref_reduced  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.configs.base import RunConfig, ShapeConfig  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import hlo_analysis as HA  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.launch.mesh import MeshPlan, make_production_mesh  # noqa: E402,E501
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.params import (from_reference, tree_leaves,  # noqa: E402,E501
                                       tree_map)
from repro_torch.optim import AdamW  # noqa: E402
from test_torch_dryrun import count_by_group  # noqa: E402
from test_torch_mesh import (GRAD_REL_L2, LEAF_REL, NOISE_REL,  # noqa: E402
                             TOTAL_REL, _assert_equal_to_checkpoint,
                             _by_path, _checkpoint, _hold_metrics)

QMOE, DS = "qwen2_moe_a2_7b", "deepseek_v3_671b"
STEPS = 4
TIE = 4 / 128           # the logit gap of a route flip: 4 bf16 steps at 1
FLIPS = 0.05            # the share of a layer's tokens that may flip
# the MoE cases' tolerances against one rank (module docstring)
TP_LOSS_RTOL, TP_NORM_RTOL = 3e-3, 2e-2
INT8_GRAD_REL_L2, INT8_TOTAL_REL = 0.1, 0.15
# name: (mesh, arch, run settings)
CASES = {
    "1x2-qwen2moe": ((1, 2), QMOE, {}),
    "1x2-qwen2moe-full": ((1, 2), QMOE, dict(remat="full")),
    "1x2-qwen2moe-compression": ((1, 2), QMOE, dict(compression=True)),
    "1x2-deepseek": ((1, 2), DS, {}),
    "1x2-deepseek-adafactor": ((1, 2), DS, dict(opt="adafactor")),
    "1x3-qwen2moe": ((1, 3), QMOE, {}),
    "1x3-deepseek": ((1, 3), DS, {}),
    "1x4-deepseek": ((1, 4), DS, {}),
    "2x2-qwen2moe": ((2, 2), QMOE, dict(local=True)),
}
MESHES = sorted({c[0] for c in CASES.values()})
UNIT_WORLD = 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(arch):
    p = RefModel(ref_reduced(arch), remat="none").init(jax.random.PRNGKey(0))
    return from_reference(jax.tree.map(np.asarray, p), get_reduced(arch))


def _batches(cfg, n=STEPS, seq=32, batch=4):
    corpus = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=seq, global_batch=batch,
                                        seed=0))
    return [{k: torch.from_numpy(v) for k, v in corpus.batch(s).items()}
            for s in range(n)]


def _units():
    rng = np.random.default_rng(7)
    return dict(
        logits=torch.from_numpy(rng.standard_normal(
            (6, 8)).astype(np.float32)).to(torch.bfloat16),
        weight=torch.from_numpy(rng.standard_normal((6, 8))
                                .astype(np.float32)),
        a=torch.from_numpy(rng.standard_normal((5, 3)).astype(np.float32)),
        b=torch.from_numpy(rng.standard_normal((4,)).astype(np.float32))
        .to(torch.bfloat16))


@pytest.fixture(scope="module")
def moe_runs(tmp_path_factory):
    """Every job and the reference's first steps, all at once: ({case:
    result}, {case: reference}, {arch: weights before}, unit results,
    elastic result, tmp)."""
    tmp = tmp_path_factory.mktemp("tp_moe")
    before = {a: _params(a) for a in (QMOE, DS)}
    batches = {a: _batches(get_reduced(a)) for a in (QMOE, DS)}
    ref_cases = [{}, {}]
    for i, (name, (mesh, arch, kw)) in enumerate(CASES.items()):
        ref_cases[i % 2][name] = (arch, batches[arch][0], dict(kw))
    refs = [REF.start(tmp / f"ref{i}", c, timeout=400.0)
            for i, c in enumerate(ref_cases)]
    jobs = {}
    for mesh in MESHES:
        inputs = {"cases": [
            (name, get_reduced(arch), mesh, before[arch], batches[arch], kw)
            for name, (m, arch, kw) in CASES.items() if m == mesh]}
        if mesh == (1, UNIT_WORLD):
            inputs["units"] = _units()
        if mesh == (1, 2):
            inputs["elastic"] = {"cfg": get_reduced(QMOE),
                                 "ckpt_dir": str(tmp / "ckpt")}
        jobs[mesh] = R.start(TPM.job, mesh[0] * mesh[1],
                             tmp / "x".join(map(str, mesh)), inputs,
                             timeout=400.0)
    res = {}
    for j in jobs.values():
        res.update(j.result())
    refs = {**refs[0].result(), **refs[1].result()}
    return res, refs, before, res.pop("units"), res.pop("elastic"), tmp


# ---------------------------------------------------------- the steps
def _hold_tp(got, got_p, want, want_p, before, rounding, total_rel):
    """``test_torch_mesh._hold`` at the MoE cases' tolerances (module
    docstring): the metrics at ``TP_LOSS_RTOL`` / ``TP_NORM_RTOL``, all
    leaves' updates together at ``total_rel``."""
    for g, w in zip(got, want):
        for k in ("loss", "ce", "aux") + (("mtp",) if "mtp" in w else ()):
            assert abs(g[k] - w[k]) <= TP_LOSS_RTOL * abs(w[k]), (k, g, w)
        assert abs(g["grad_norm"] - w["grad_norm"]) <= \
            TP_NORM_RTOL * w["grad_norm"], (g, w)
        assert g["lr"] == w["lr"]
    off = total = 0.0
    got_p, want_p = _by_path(got_p), _by_path(want_p)
    for path, old in _by_path(T.trainable(before)).items():
        got_d = got_p[path].float() - old.float()
        want_d = want_p[path].float() - old.float()
        err, size = float((got_d - want_d).norm()), float(want_d.norm())
        if path in rounding:
            assert abs(float(got_d.norm()) - size) <= LEAF_REL * size, path
            continue
        assert err <= LEAF_REL * size, path
        off, total = off + err ** 2, total + size ** 2
    assert off ** 0.5 <= total_rel * total ** 0.5


def _rounding(res, grad_rel) -> set:
    """``test_torch_mesh._rounding_leaves``: the first batch's gradients
    of the mesh and of one rank, each leaf within ``grad_rel`` of the
    other; the leaves whose first AdamW step the two put more than
    ``NOISE_REL`` apart."""
    mesh, one = (_by_path(g) for g in res["grad0"])
    out = set()
    for path, w in one.items():
        g, size = mesh[path], float(w.norm())
        assert g.shape == w.shape, path
        assert float((g - w).norm()) <= grad_rel * size, path
        step_g, step_w = (t / (t.abs() + AdamW.eps) for t in (g, w))
        if float((step_g - step_w).norm()) > \
                NOISE_REL * float(step_w.norm()):
            out.add(path)
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_moe_tp_step_matches_reference_and_meshless(moe_runs, name):
    res, refs, before = moe_runs[:3]
    r, ref = res[name], refs[name]
    arch, kw = CASES[name][1:]
    steps = 2 if kw.get("opt") == "adafactor" else STEPS
    assert r["tensor_parallel"] == CASES[name][0][1]
    int8 = kw.get("compression", False)
    _hold_tp(r["got"][:steps], r["params"][steps - 1], r["want"][:steps],
             r["meshless"][steps - 1], before[arch],
             _rounding(r, INT8_GRAD_REL_L2 if int8 else GRAD_REL_L2),
             INT8_TOTAL_REL if int8 else TOTAL_REL)
    _hold_metrics([r["forced0"]], [ref["metrics"]])
    got = _by_path(r["grad0"][0])
    for path, w in _by_path(ref["grad"]).items():
        g, w = got[path], w.float()
        assert g.shape == w.shape, path
        size = float(w.norm())
        assert float((g - w).norm()) <= (
            INT8_GRAD_REL_L2 if int8 else GRAD_REL_L2) * size, path
    for held, due, _ in r["sizes"]:
        assert held == due


@pytest.mark.parametrize("name", sorted(CASES))
def test_route_flips_are_near_ties(moe_runs, name):
    flips = moe_runs[0][name]["flips"]
    cfg = get_reduced(CASES[name][1])
    assert len(flips) == cfg.n_layers - cfg.moe.first_dense_layers
    for layer, (n, total, gaps) in flips.items():
        assert n <= FLIPS * total, (layer, n, total)
        assert all(0 <= g <= TIE for g in gaps), (layer, gaps)


def _local(n, count, m):
    """A dim of n over ``count`` heads / columns / experts on a model
    extent of m: its block where ``count`` divides, else whole."""
    return n // m if m > 1 and count % m == 0 else n


def _moe_widths(cfg, m):
    """{leaf key: (K, N) of a 2-D product's B operand, or (E, K, N) of a
    grouped one} of an MoE arch on a model extent of ``m``: a leaf
    inside a layer keyed without its ``layers/i/`` (``dense_layers/i/``)
    prefix, the MTP block's under ``mtp/block/``."""
    d, H, V = cfg.d_model, cfg.n_heads, cfg.padded_vocab

    def attn(pre):
        if cfg.mla:
            a = cfg.mla
            qk = a.qk_nope_head_dim + a.qk_rope_head_dim
            return {pre + "wdq": (d, a.q_lora_rank),
                    pre + "wuq": (a.q_lora_rank, _local(H * qk, H, m)),
                    pre + "wdkv": (d, a.kv_lora_rank),
                    pre + "wkr": (d, a.qk_rope_head_dim),
                    pre + "wuk": (a.kv_lora_rank,
                                  _local(H * a.qk_nope_head_dim, H, m)),
                    pre + "wuv": (a.kv_lora_rank,
                                  _local(H * a.v_head_dim, H, m)),
                    pre + "wo": (_local(H * a.v_head_dim, H, m), d)}
        hd, KH = cfg.resolved_head_dim, cfg.n_kv_heads
        q, kv = _local(H * hd, H, m), _local(KH * hd, KH, m)
        return {pre + "wq": (d, q), pre + "wk": (d, kv),
                pre + "wv": (d, kv), pre + "wo": (q, d)}

    def mlp(pre, f):
        lf = _local(f, f, m)
        return {pre + "wi_gate": (d, lf), pre + "wi_up": (d, lf),
                pre + "wo": (lf, d)}

    mo = cfg.moe
    E, f = mo.n_routed_experts, mo.d_ff_expert
    El = _local(E, E, m)
    fl = f if El < E else _local(f, f, m)
    out = {**attn("attn/"), "moe/router": (d, El),
           "moe/wi_gate": (El, d, fl), "moe/wi_up": (El, d, fl),
           "moe/wo": (El, fl, d), "lm_head": (d, _local(V, V, m))}
    if mo.n_shared_experts:
        fs = f * mo.n_shared_experts
        out.update({k.replace("mlp/", "moe/shared_"): v
                    for k, v in mlp("mlp/", fs).items()})
    if mo.first_dense_layers:
        out.update(mlp("mlp/", cfg.d_ff))
    if cfg.mtp:
        out["mtp/proj"] = (2 * d, d)
        out.update({"mtp/block/" + k: v for k, v in
                    {**attn("attn/"), **mlp("mlp/", cfg.d_ff)}.items()})
    return out


def _key(path):
    parts = path.split("/")
    return "/".join(parts[2:]) if parts[0] in ("layers", "dense_layers") \
        else path


@pytest.mark.parametrize("name", sorted(CASES))
def test_moe_gemms_run_at_local_widths(moe_runs, name):
    res = moe_runs[0][name]
    mesh, arch = CASES[name][:2]
    want = _moe_widths(get_reduced(arch), mesh[1])
    got = {}
    for which, path, shape in res["gemm_widths"]:
        assert (which == "grouped") == (len(shape) == 3), (path, shape)
        got.setdefault(_key(path), set()).add(shape)
    assert got == {k: {v} for k, v in want.items()}


def test_the_split_forms():
    """(1, 3) takes the column split, the other extents the expert
    split, as the placements give (``expert`` outranks ``mlp``)."""
    for name, (mesh, arch, _) in CASES.items():
        w = _moe_widths(get_reduced(arch), mesh[1])["moe/wi_gate"]
        E = get_reduced(arch).moe.n_routed_experts
        by_expert = E % mesh[1] == 0
        assert (w[0] < E) == by_expert and (w[2] < get_reduced(
            arch).moe.d_ff_expert) == (not by_expert), name


@pytest.mark.parametrize("arch", [QMOE, DS])
@pytest.mark.parametrize("m", [2, 16])
def test_local_widths_take_the_kernels(arch, m):
    """At full width, every 2-D product a rank's blocks make (forward,
    dA, dB) has operands the tensor-core kernel reads, and every grouped
    one has K and N in multiples of 8 (the grouped kernels raise on
    others); ``meta`` operands, M = 4,096."""
    from repro_torch.kernels.streaming_gemm import (mcontig_layout,
                                                    mma_layout, plan)
    cfg, M = get_config(arch), 4096

    def meta(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device="meta")

    for key, shape in _moe_widths(cfg, m).items():
        if len(shape) == 3:
            assert shape[1] % 8 == 0 and shape[2] % 8 == 0, (key, shape)
            continue
        K, N = shape
        a, b, dc = meta(M, K), meta(K, N), meta(M, N)
        assert mma_layout(a, b) is not None, (key, K, N)
        assert mma_layout(dc, b.t()) is not None, (key, K, N)
        assert mcontig_layout(a.t(), dc) is not None, (key, K, N)
        assert plan(M, N, K)[3] >= 1


# ---------------------------------------------------------- the pieces
def test_gather_from_model_against_the_whole(moe_runs):
    units, u = moe_runs[3], _units()
    logits = u["logits"].clone().requires_grad_(True)
    (torch.softmax(logits.float(), -1) * u["weight"]).sum().backward()
    n = logits.shape[1] // UNIT_WORLD
    for rank, out in enumerate(units):
        y, grad = out["gather"]
        assert torch.equal(y, u["logits"])
        assert torch.equal(grad, logits.grad[:, rank * n:(rank + 1) * n])
        gathers = [c for c in out["collectives"] if c[0] == "all-gather"]
        assert gathers == [("all-gather", u["logits"].numel() * 2,
                            UNIT_WORLD)]


def test_copy_of_two_tensors_sums_in_one_all_reduce(moe_runs):
    units, u = moe_runs[3], _units()
    total = sum(r + 1.0 for r in range(UNIT_WORLD))
    for out in units:
        (ya, yb), (ga, gb) = out["copy2"]
        assert torch.equal(ya, u["a"]) and torch.equal(yb, u["b"])
        assert torch.equal(ga, torch.full_like(u["a"], total))
        assert torch.equal(gb, torch.full_like(u["b"], total))
        reduces = [c for c in out["collectives"] if c[0] == "all-reduce"]
        assert reduces == [("all-reduce", (u["a"].numel() + u["b"].numel())
                            * 4, UNIT_WORLD)]


def test_elastic_restore_from_an_expert_split_state(moe_runs):
    res, tmp = moe_runs[4], moe_runs[5]
    assert res["a_tp"] == 2 and len(res["a"]["losses"]) == 4
    assert res["b_start"] == 4 and len(res["b"]["losses"]) == 4
    assert np.isfinite(res["b"]["losses"]).all()
    _assert_equal_to_checkpoint(res["b_state"], _checkpoint(tmp / "ckpt",
                                                            3))


# ---------------------------------------------------------- the dry run
PLAN = MeshPlan((4, 4), ("data", "model"))
TRAIN = ShapeConfig("train_4k", "train", 64, 8)


def _gemm_flops(run, mesh):
    """(2-D GEMM flops, grouped GEMM flops, collectives by (op, group
    size)) of rank 0's step on ``mesh``, counted on ``meta``."""
    flops = {"streaming_gemm": 0, "streaming_gemm_grouped": 0}
    kernel = HA.kernel

    def count(name, f, b):
        if name in flops:
            flops[name] += f
        kernel(name, f, b)

    HA.kernel = count
    try:
        fn, args, donated = dryrun.cell_step(run, mesh)
        _, groups = count_by_group(fn, args, donated)
    finally:
        HA.kernel = kernel
    return flops["streaming_gemm"], flops["streaming_gemm_grouped"], groups


def _predicted(cfg, run, m, data):
    """Rank 0's (2-D, grouped) GEMM flops from the placements: each
    product's forward, dA and dB at the local width, 2·M·K·N each (M the
    rank's tokens; a grouped product at its capacity rows, row-local
    dispatch), the layers' forward once more under ``remat="full"``
    (the MTP block and the lm_head are not rematerialised)."""
    B, T = run.shape.global_batch // data, run.shape.seq_len
    w = _moe_widths(cfg, m)
    per = 4 if run.remat == "full" else 3
    mo = cfg.moe
    n_moe = cfg.n_layers - mo.first_dense_layers

    def two_d(keys):
        return sum(w[k][0] * w[k][1] for k in keys)

    attn = [k for k in w if k.startswith("attn/")]
    shared = [k for k in w if k.startswith("moe/shared_")]
    dense = two_d(attn + [k for k in w if k.startswith("mlp/")])
    moe = two_d(attn + shared + ["moe/router"])
    head = two_d(["lm_head"]) * (2 if cfg.mtp else 1)
    mtp = two_d([k for k in w if k.startswith("mtp/")])
    flat = 2 * B * T * ((mo.first_dense_layers * dense + n_moe * moe) * per
                        + 3 * (head + mtp))
    C = MOE.routed_capacity(T * mo.top_k, mo.n_routed_experts, None,
                            multiple=4)
    El, K, N = w["moe/wi_gate"]
    grouped = n_moe * per * 3 * 2 * El * B * C * K * N
    return flat, grouped


@pytest.mark.parametrize("arch", [QMOE, DS])
@pytest.mark.parametrize("remat", ["none", "full"])
def test_dry_run_gemm_flops_follow_the_placements(arch, remat):
    cfg = get_reduced(arch)
    run = RunConfig(model=cfg, shape=TRAIN, remat=remat,
                    moe_local_dispatch=True)
    flat, grouped, groups = _gemm_flops(run, PLAN)
    assert (flat, grouped) == _predicted(cfg, run, 4, 4)
    assert S.build_train_step(run, PLAN).tensor_parallel == 4
    # the logits gathered once a forward of each MoE layer (again in the
    # recompute under remat="full"), and the split leaves gathered over
    # ``data`` once
    n_moe = cfg.n_layers - cfg.moe.first_dense_layers
    assert groups[("all-gather", 4)][0] == \
        n_moe * (2 if remat == "full" else 1) + 1


def test_production_plan_splits_both_archs():
    shape = dryrun.SHAPES["train_4k"]
    for arch in (QMOE, DS):
        run = RunConfig(model=get_config(arch), shape=shape,
                        moe_local_dispatch=True)
        built = S.build_train_step(run, make_production_mesh())
        assert built.tensor_parallel == 16, arch


# ------------------------------------------- the recompute on a thread
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_recompute_on_another_thread_keeps_the_contexts(remat):
    """Autograd runs a CUDA tensor's backward pass, and with it a
    remat recompute, on a thread of its own: the recompute runs under the
    mesh context and the ``Tuning`` of the forward all the same.  On the
    CPU the backward runs on the thread that asks for it, so this one
    asks from a new thread, where neither context is active; every call
    of the MoE layer (the forward's and the recompute's) records what it
    sees, and the gradients equal those of a backward on this thread."""
    import threading

    from repro_torch.models import tuning as TU
    from repro_torch.sharding import context as SC
    from repro_torch.sharding import logical as LG
    from repro_torch.sharding.blocks import ONE_RANK

    cfg = get_reduced(QMOE)
    params = T.trainable(_params(QMOE))
    batch = _batches(cfg, n=1)[0]
    seen, apply = [], MOE.apply_moe

    def recording(p, x, cfg, *a, **kw):
        seen.append((SC.current() is not None,
                     TU.get().moe_local_dispatch))
        return apply(p, x, cfg, *a, **kw)

    def grads(on_thread):
        leaves = [t.detach().requires_grad_(True)
                  for t in tree_leaves(params)]
        it = iter(leaves)
        p = tree_map(lambda _: next(it), params)
        with SC.mesh_context(ONE_RANK, LG.make_rules(False)), \
                TU.tuning_context(dataclasses.replace(
                    TU.get(), moe_local_dispatch=True)):
            h, aux, _ = T.forward_train(p, cfg, batch, remat=remat)
            loss = (h.float().square().mean() + aux)
        out = []
        if on_thread:
            out = torch.autograd.grad(loss, leaves, allow_unused=True)
        else:
            t = threading.Thread(target=lambda: out.extend(
                torch.autograd.grad(loss, leaves, allow_unused=True)))
            t.start()
            t.join()
        return out

    MOE.apply_moe = recording
    try:
        want = grads(True)
        seen.clear()
        got = grads(False)
    finally:
        MOE.apply_moe = apply
    n_moe = cfg.n_layers - cfg.moe.first_dense_layers
    assert seen == [(True, True)] * (2 * n_moe)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert torch.equal(g, w)
