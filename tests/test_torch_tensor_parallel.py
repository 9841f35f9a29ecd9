"""Tensor parallelism in the port's train step (``sharding/
tensor_parallel.py``, ``launch/steps.py``): the dense and vlm families
split attention heads, MLP columns and the vocabulary over ``model``.

Gloo ranks on the CPU (``torch_mesh_ranks.start``; bodies in
``torch_tp_ranks``), reduced configs with the reference's weights
(``from_reference``), on (1, 2), (1, 4), (2, 2) and (1, 3) meshes, all
jobs and two reference processes at once in one module fixture.

- Every case is held as ``tests/test_torch_mesh.py`` holds a mesh run,
  at its tolerances (``_check_run``): the first step against the
  reference's (metrics; AdamW's reduced gradient, each leaf within 5e-2
  relative L2), every step against the one-rank step (metrics, each
  leaf's update; a leaf whose update rounding decides, by its size;
  4 steps, 2 with Adafactor, as there).
  The cases: qwen2-0.5b, chatglm3-6b, granite-20b (one KV head) and
  internvl2-2b (trained on embeddings; vocabulary 250 padded to 256, so
  the last of 4 blocks holds padding), remat none and full, AdamW,
  Adafactor and INT8 compression, and qwen2-0.5b with 6 query heads
  over 3 KV heads on (1, 2), where rank 1's query heads start inside a
  KV group.  On (1, 3) the heads and the vocabulary do not divide and
  only chatglm3's and internvl2's MLP (96 columns) splits.
- Every forward product of the first step reads its weight leaf at the
  local width: N / m for a column-parallel leaf (q, k, v, the MLP's
  gate / up, the lm_head's vocabulary block), K / m for a row-parallel
  one (``wo``), whole for a leaf ``model`` does not split.
- The K/V leaves of a layer whose query heads split and whose KV heads
  do not: the gradient the mesh reduced equals the one-rank gradient
  (each leaf within 5e-2 relative L2, ``tests/test_torch_mesh.py``'s
  measure; the two differ by the row-parallel partials' bf16
  rounding).
- The pieces on 4 ranks against the whole computation: ``copy_to_model``
  and ``reduce_from_model`` (forward and gradients), the
  vocabulary-parallel lookup and cross-entropy (padded vocabulary,
  ignored labels; forward and gradient of each block).
- A (1, 2) state, split over ``model``, restores onto (2, 1) bit for bit
  and trains on.
- The dry run on a reduced (4, 4) plan on ``meta``: rank 0's GEMM flops
  equal the placements' prediction exactly (whole / 4 for a split leaf,
  whole for a replicated one), and every all-reduce is over 4 ranks, the
  tensor-parallel ones counted; the non-dense families' records equal
  those the step made before it split any layer over ``model``
  (``NON_DENSE``), with ``tensor_parallel`` 1.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import torch_mesh_ranks as R  # noqa: E402
import torch_mesh_reference as REF  # noqa: E402
import torch_tp_ranks as TPR  # noqa: E402
from repro.configs import get_reduced as ref_reduced  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.configs.base import RunConfig, ShapeConfig  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import hlo_analysis as HA  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.launch.mesh import MeshPlan  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.params import from_reference, tree_leaves  # noqa: E402,E501
from test_torch_dryrun import count_by_group  # noqa: E402
from test_torch_mesh import (GRAD_REL_L2, _assert_equal_to_checkpoint,  # noqa: E402,E501
                             _by_path, _check_run, _checkpoint)

QWEN = "qwen2_0_5b"
VARIANT = dict(n_heads=6, n_kv_heads=3, head_dim=16)
STEPS = 4
# name: (mesh, arch, config overrides, run settings, trains on embeddings)
CASES = {
    "1x2-qwen2": ((1, 2), QWEN, {}, {}, False),
    "1x2-qwen2-full": ((1, 2), QWEN, {}, dict(remat="full"), False),
    "1x2-qwen2-adafactor": ((1, 2), QWEN, {}, dict(opt="adafactor"), False),
    "1x2-qwen2-compression": ((1, 2), QWEN, {}, dict(compression=True),
                              False),
    "1x2-chatglm3": ((1, 2), "chatglm3_6b", {}, {}, False),
    "1x2-granite": ((1, 2), "granite_20b", {}, {}, False),
    "1x2-internvl2": ((1, 2), "internvl2_2b", {}, {}, True),
    "1x2-heads6-kv3": ((1, 2), QWEN, VARIANT, {}, False),
    "1x4-qwen2": ((1, 4), QWEN, {}, {}, False),
    "1x4-qwen2-full": ((1, 4), QWEN, {}, dict(remat="full"), False),
    "1x4-chatglm3": ((1, 4), "chatglm3_6b", {}, {}, False),
    "1x4-granite": ((1, 4), "granite_20b", {}, {}, False),
    "1x4-internvl2": ((1, 4), "internvl2_2b", {}, {}, True),
    "2x2-qwen2": ((2, 2), QWEN, {}, {}, False),
    "2x2-granite-full": ((2, 2), "granite_20b", {}, dict(remat="full"),
                         False),
    "2x2-chatglm3-adafactor": ((2, 2), "chatglm3_6b", {},
                               dict(opt="adafactor"), False),
    "2x2-internvl2-compression": ((2, 2), "internvl2_2b", {},
                                  dict(compression=True), True),
    "1x3-chatglm3": ((1, 3), "chatglm3_6b", {}, {}, False),
    "1x3-internvl2": ((1, 3), "internvl2_2b", {}, {}, True),
    "1x3-qwen2": ((1, 3), QWEN, {}, {}, False),
}
MESHES = sorted({c[0] for c in CASES.values()})
UNIT_WORLD = 4
UNIT_VOCAB, UNIT_PADDED = 250, 256


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch, overrides):
    return (dataclasses.replace(ref_reduced(arch), **overrides),
            dataclasses.replace(get_reduced(arch), **overrides))


def _params(arch, overrides):
    rcfg, cfg = _configs(arch, overrides)
    p = RefModel(rcfg, remat="none").init(jax.random.PRNGKey(0))
    return from_reference(jax.tree.map(np.asarray, p), cfg)


def _batches(cfg, embeddings, n=STEPS, seq=32, batch=4):
    """The corpus's batches; with ``embeddings``, (B, T, d) bf16
    embeddings N(0, 1) x 0.02 from a seed in place of the ids."""
    corpus = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=seq, global_batch=batch,
                                        seed=0))
    rng = np.random.default_rng(3)
    out = []
    for s in range(n):
        b = {k: torch.from_numpy(v) for k, v in corpus.batch(s).items()}
        if embeddings:
            b["embeddings"] = torch.from_numpy(rng.standard_normal(
                (batch, seq, cfg.d_model)).astype(np.float32) * 0.02
            ).to(torch.bfloat16)
            del b["tokens"]
        out.append(b)
    return out


def _units():
    rng = np.random.default_rng(5)
    labels = rng.integers(0, UNIT_VOCAB, 10)
    labels[[1, 6]] = -1
    return dict(
        x=torch.from_numpy(rng.standard_normal((5, 8)).astype(np.float32)),
        parts=torch.from_numpy(rng.standard_normal(
            (UNIT_WORLD, 6, 8)).astype(np.float32)).to(torch.bfloat16),
        table=torch.from_numpy(rng.standard_normal(
            (UNIT_PADDED, 16)).astype(np.float32)).to(torch.bfloat16),
        tokens=torch.from_numpy(rng.permutation(UNIT_VOCAB)[:21]
                                .reshape(3, 7)),
        logits=torch.from_numpy(rng.standard_normal(
            (10, UNIT_PADDED)).astype(np.float32) * 3),
        labels=torch.from_numpy(labels), vocab_size=UNIT_VOCAB)


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """Every job and the reference's first steps, all at once: ({case:
    result}, {case: reference}, {case: weights before}, unit results,
    elastic result)."""
    tmp = tmp_path_factory.mktemp("tp")
    before, batches, ref_cases = {}, {}, [{}, {}]
    for i, (name, (mesh, arch, ov, kw, emb)) in enumerate(CASES.items()):
        cfg = _configs(arch, ov)[1]
        before[name] = _params(arch, ov)
        batches[name] = _batches(cfg, emb)
        ref_cases[i % 2][name] = (arch, batches[name][0],
                                  dict(kw, overrides=ov))
    refs = [REF.start(tmp / f"ref{i}", c, timeout=400.0)
            for i, c in enumerate(ref_cases)]
    jobs = {}
    for mesh in MESHES:
        inputs = {"cases": [
            (name, _configs(arch, ov)[1], mesh, before[name], batches[name],
             kw) for name, (m, arch, ov, kw, _) in CASES.items()
            if m == mesh]}
        if mesh == (1, UNIT_WORLD):
            inputs["units"] = _units()
        if mesh == (1, 2):
            inputs["elastic"] = {"cfg": get_reduced("qwen1_5_32b"),
                                 "ckpt_dir": str(tmp / "ckpt")}
        jobs[mesh] = R.start(TPR.job, mesh[0] * mesh[1],
                             tmp / "x".join(map(str, mesh)), inputs,
                             timeout=400.0)
    res = {}
    for j in jobs.values():
        res.update(j.result())
    refs = {**refs[0].result(), **refs[1].result()}
    return res, refs, before, res.pop("units"), res.pop("elastic"), tmp


# ---------------------------------------------------------- the steps
def _extent(name):
    return CASES[name][0][1]


@pytest.mark.parametrize("name", sorted(CASES))
def test_tp_step_matches_reference_and_meshless(tp_runs, name):
    res, refs, before, *_ = tp_runs
    # Adafactor's further updates are ill-conditioned on these models'
    # key bias: 2 steps, as ``tests/test_torch_mesh.py`` takes
    steps = 2 if CASES[name][3].get("opt") == "adafactor" else STEPS
    _check_run(res[name], refs[name], before[name], steps, CASES[name][1])


def _widths(cfg, m):
    """{leaf name in a layer, or a top leaf: (K, N) of the B operand its
    forward product reads} on a model extent of ``m``."""
    d, H, KH = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd, f, V = cfg.resolved_head_dim, cfg.d_ff, cfg.padded_vocab

    def local(n, count):        # a dim of n over ``count`` heads / columns
        return n // m if m > 1 and count % m == 0 else n

    q, kv = local(H * hd, H), local(KH * hd, KH)
    out = {"attn/wq": (d, q), "attn/wk": (d, kv), "attn/wv": (d, kv),
           "attn/wo": (q, d), "mlp/wo": (local(f, f), d)}
    for leaf in (("wi_gate", "wi_up") if cfg.glu else ("wi",)):
        out["mlp/" + leaf] = (d, local(f, f))
    out["embed" if cfg.tie_embeddings else "lm_head"] = (d, local(V, V))
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_gemms_run_at_local_widths(tp_runs, name):
    res = tp_runs[0][name]
    mesh, arch, ov = CASES[name][:3]
    cfg = _configs(arch, ov)[1]
    want = _widths(cfg, mesh[1])
    got = {}
    for path, shapes in res["gemm_widths"].items():
        key = path.split("/", 2)[2] if path.startswith("layers/") else path
        assert len(shapes) == 1, (path, shapes)
        assert got.setdefault(key, shapes[0]) == shapes[0], path
    assert got == want
    assert sum(p.startswith("layers/") for p in res["gemm_widths"]) == \
        cfg.n_layers * (len(want) - 1)


def _kv_partial(name):
    """True where the case's layers split their query heads and not
    their KV heads."""
    mesh, arch, ov = CASES[name][:3]
    cfg = _configs(arch, ov)[1]
    m = mesh[1]
    return cfg.n_heads % m == 0 and cfg.n_kv_heads % m != 0


@pytest.mark.parametrize("name", [n for n in sorted(CASES)
                                  if _kv_partial(n)])
def test_kv_gradient_of_q_split_layers_equals_meshless(tp_runs, name):
    got, want = (_by_path(g) for g in tp_runs[0][name]["grad0"])
    kv = [p for p in want if p.rsplit("/", 1)[-1] in ("wk", "wv", "bk",
                                                      "bv")]
    assert kv
    for path in kv:
        g, w = got[path], want[path]
        assert float((g - w).norm()) <= GRAD_REL_L2 * float(w.norm()), path


@pytest.mark.parametrize("arch", [QWEN, "chatglm3_6b", "granite_20b",
                                  "internvl2_2b", "qwen1_5_32b"])
@pytest.mark.parametrize("m", [2, 16])
def test_local_widths_take_the_tensor_core_kernel(arch, m):
    """At full width, every product a rank's blocks make (forward, dA =
    dC·Bᵀ, dB = Aᵀ·dC; the tied lm_head's block read K-contiguous) has
    operands the tensor-core kernel reads (``mma_layout`` /
    ``mcontig_layout``), so ``_StreamingGemm`` never raises for them;
    ``meta`` operands, M = 4,096."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.streaming_gemm import (mcontig_layout,
                                                    mma_layout, plan)
    cfg, M = get_config(arch), 4096

    def meta(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device="meta")

    for key, (K, N) in _widths(cfg, m).items():
        a = meta(M, K)
        b = meta(N, K).t() if key == "embed" else meta(K, N)
        dc = meta(M, N)
        assert mma_layout(a, b) is not None, (key, K, N)
        assert mma_layout(dc, b.t()) is not None, (key, K, N)
        # dB: for the K-contiguous block, dBᵀ = dCᵀ·A in its own layout
        assert (mcontig_layout(dc.t(), a) if key == "embed"
                else mcontig_layout(a.t(), dc)) is not None, (key, K, N)
        assert plan(M, N, K)[3] >= 1


def test_tensor_parallel_extent_per_case():
    for name, (mesh, arch, ov, kw, _) in CASES.items():
        cfg = _configs(arch, ov)[1]
        run = R._run(cfg, **kw)
        built = S.build_train_step(run, MeshPlan(mesh, ("data", "model")))
        splits = mesh[1] > 1 and any(
            n % mesh[1] == 0 for n in (cfg.n_heads, cfg.d_ff,
                                       cfg.padded_vocab))
        assert built.tensor_parallel == (mesh[1] if splits else 1), name
    moe = R._run(get_reduced("qwen2_moe_a2_7b"), local=True)
    assert S.build_train_step(moe, MeshPlan((1, 2), ("data", "model"))
                              ).tensor_parallel == 1


# ---------------------------------------------------------- the pieces
def test_copy_and_reduce_against_the_whole(tp_runs):
    units, u = tp_runs[3], _units()
    total = sum(r + 1.0 for r in range(UNIT_WORLD))
    want = u["parts"].float().sum(0).to(torch.bfloat16)
    weight = torch.arange(want.numel()).view(want.shape).to(torch.bfloat16)
    for rank, out in enumerate(units):
        y, gx = out["copy"]
        assert torch.equal(y, u["x"])
        assert torch.equal(gx, torch.full_like(u["x"], total))
        y, gp = out["reduce"]
        assert torch.equal(y, want)
        assert torch.equal(gp, weight)


def test_vocab_parallel_lookup_against_the_whole(tp_runs):
    units, u = tp_runs[3], _units()
    table = u["table"].clone().requires_grad_(True)
    e = table[u["tokens"]]
    (e.float() * torch.linspace(-1, 1, e.shape[-1])).sum().backward()
    n = UNIT_PADDED // UNIT_WORLD
    for rank, out in enumerate(units):
        got, grad = out["embedding"]
        assert torch.equal(got, e.detach())
        assert torch.equal(grad, table.grad[rank * n:(rank + 1) * n])


def test_vocab_parallel_cross_entropy_against_the_whole(tp_runs):
    units, u = tp_runs[3], _units()
    logits = u["logits"].clone().requires_grad_(True)
    pad = torch.arange(UNIT_PADDED) >= UNIT_VOCAB
    masked = logits.masked_fill(pad, -1e30)
    lse = torch.logsumexp(masked, -1)
    labels = u["labels"].long()
    gold = masked.gather(-1, labels.clamp(min=0)[:, None])[:, 0]
    valid = labels >= 0
    ((lse - gold) * valid.float()).sum().backward()
    n = UNIT_PADDED // UNIT_WORLD
    for rank, out in enumerate(units):
        (got_lse, got_gold), grad = out["cross_entropy"]
        torch.testing.assert_close(got_lse, lse.detach(), rtol=1e-6,
                                   atol=1e-6)
        torch.testing.assert_close(got_gold[valid], gold.detach()[valid],
                                   rtol=0, atol=0)
        assert not got_gold[~valid].any()
        torch.testing.assert_close(grad, logits.grad[:, rank * n:
                                                     (rank + 1) * n],
                                   rtol=1e-6, atol=1e-7)
    assert not units[-1]["cross_entropy"][1][:, -int(pad.sum()):].any()


def test_elastic_restore_from_a_tensor_parallel_state(tp_runs):
    res, tmp = tp_runs[4], tp_runs[5]
    assert res["a_tp"] == 2 and len(res["a"]["losses"]) == 4
    assert res["b_start"] == 4 and len(res["b"]["losses"]) == 4
    assert np.isfinite(res["b"]["losses"]).all()
    _assert_equal_to_checkpoint(res["b_state"], _checkpoint(tmp / "ckpt",
                                                            3))


# ---------------------------------------------------------- the dry run
PLAN = MeshPlan((4, 4), ("data", "model"))
TRAIN = ShapeConfig("train_4k", "train", 64, 8)


def _gemm_flops(run, mesh):
    """(GEMM flops, its collectives by (op, group size)) of rank 0's
    step on ``mesh``, counted on ``meta``."""
    flops = []
    kernel = HA.kernel

    def count(name, f, b):
        if name == "streaming_gemm":
            flops.append(f)
        kernel(name, f, b)

    HA.kernel = count
    try:
        fn, args, donated = dryrun.cell_step(run, mesh)
        _, groups = count_by_group(fn, args, donated)
    finally:
        HA.kernel = kernel
    return sum(flops), groups


def _predicted_gemm_flops(cfg, run, m, data):
    """Rank 0's GEMM flops from the placements: every product 2·M·K·N
    of the rank's rows, a split leaf's at its local width; the forward,
    dA and dB of each, the layers' forward once more under
    ``remat="full"``."""
    M = run.shape.global_batch // data * run.shape.seq_len
    w = _widths(cfg, m)
    layer = sum(k * n for key, (k, n) in w.items()
                if key not in ("embed", "lm_head"))
    head = w["embed" if cfg.tie_embeddings else "lm_head"]
    per = 4 if run.remat == "full" else 3
    return 2 * M * (cfg.n_layers * layer * per + head[0] * head[1] * 3)


@pytest.mark.parametrize("arch", [QWEN, "chatglm3_6b", "granite_20b",
                                  "internvl2_2b"])
@pytest.mark.parametrize("remat", ["none", "full"])
def test_dry_run_gemm_flops_follow_the_placements(arch, remat):
    cfg = get_reduced(arch)
    run = RunConfig(model=cfg, shape=TRAIN, remat=remat)
    got, groups = _gemm_flops(run, PLAN)
    assert got == _predicted_gemm_flops(cfg, run, 4, 4)
    assert S.build_train_step(run, PLAN).tensor_parallel == 4
    # every all-reduce is over 4 ranks (data and model alike): the batch
    # split's three, and the tensor-parallel ones
    assert {g for op, g in groups if op == "all-reduce"} == {4}
    # per layer: the two forward sums and the two backward input sums;
    # under remat="full" the recompute replays the attention's sum, and
    # stops before the MLP's, whose output no backward product reads
    layers = cfg.n_layers * (4 + (remat == "full"))
    vocab = 3 + (0 if cfg.embedding_inputs else 1)  # CE max, sum, dh; lookup
    partial = int(cfg.n_kv_heads % 4 != 0)  # K/V gradient shares
    assert groups[("all-reduce", 4)][0] == 3 + layers + vocab + partial + 1


# the records of the families the step does not split, as the step
# counted them on PLAN at TRAIN before it split any layer over ``model``
# (reduced configs, remat "full"): flops, bytes, collective bytes and
# count, temporary bytes
NON_DENSE = {
    "qwen2_moe_a2_7b": (196796213.0, 66023742.0, 3144426.0, 8, 4787236),
    "deepseek_v3_671b": (162137475.0, 66765244.0, 1800708.0, 7, 2442804),
    "rwkv6_7b": (118350385.0, 59446106.0, 980370.0, 4, 1690408),
    "zamba2_7b": (302797505.0, 138760618.0, 2050074.0, 4, 3308016),
    "whisper_tiny": (249651627.0, 420293482.0, 58189074.0, 4, 52711972),
}


@pytest.mark.parametrize("arch", sorted(NON_DENSE))
def test_dry_run_of_the_other_families_is_unchanged(arch):
    rec = dryrun.run_cell(arch, "train_4k", False, mesh=PLAN,
                          config=get_reduced(arch), shape=TRAIN)
    assert rec["tensor_parallel"] == 1
    rl = rec["roofline"]
    got = (rl["flops_per_device"], rl["bytes_per_device"],
           rl["collective_bytes"], rl["collective_count"],
           rec["memory_analysis"]["temp_bytes"])
    assert got == NON_DENSE[arch]


def test_tp_leaves_of_every_family():
    for arch in ("qwen2_moe_a2_7b", "deepseek_v3_671b", "rwkv6_7b",
                 "zamba2_7b", "whisper_tiny"):
        run = RunConfig(model=get_reduced(arch), shape=TRAIN)
        built = S.build_train_step(run, PLAN)
        w_pl = T.trainable(built.in_shardings[0]["params"])
        assert not any(tree_leaves(S.tensor_parallel_leaves(
            run.model, w_pl, PLAN))), arch
