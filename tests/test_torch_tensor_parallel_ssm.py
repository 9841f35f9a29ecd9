"""Tensor parallelism of the ssm family in the port's train step
(``models/ssm.py``, ``sharding/tensor_parallel.py``, ``launch/steps.py``):
RWKV6's time mix by heads (its five projections' columns, ``w_bias`` /
``u`` rows, ``wo`` rows), its channel mix by ``wk`` / ``wv`` columns and
``wr``'s columns gathered, the vocabulary in blocks.

Gloo ranks on the CPU (``torch_mesh_ranks.start``; bodies in
``torch_tp_ranks``, set up by ``torch_tp_family``), reduced rwkv6-7b (2
layers, d 64, 4 heads of 16, d_ff 128) with the reference's weights
(``from_reference``), on (1, 2), (1, 4) and (2, 2) meshes, all jobs and
two reference processes at once in one module fixture.

- Every case is held as ``tests/test_torch_mesh.py`` holds a mesh run
  (``torch_tp_family.check_run``): the first step against the
  reference's (metrics within 1e-3 relative, the grad norm 1e-2; the
  AdamW gradient each leaf within 5e-2 relative L2), every step against
  the one-rank step (the loss within 1e-3; each leaf's update within
  0.3 relative L2, all together within 0.1; a leaf whose update
  rounding decides by its size), the first batch's gradient against one
  rank's, each leaf within 5e-2 relative L2; 3 steps, 2 with Adafactor,
  the grad norm within 2e-2.  The reduced rwkv6 is chaotic under this
  learning rate (3e-3, 2 steps of warm-up): on one rank alone, one bf16
  ulp on half the values of every ``wo`` / ``wv`` moves the loss by up
  to 7.8e-4 at step 2 and 3.5e-3 at step 3, the grad norm by up to
  9.6e-3 and 4.1e-2 (three seeds); the split, which rounds those
  products' partials, moved them by up to 6.3e-4 and 1.45e-2 at step
  2, and 1.5e-3 and 0.10 at step 3.  Under INT8 compression (each
  leaf's codes 1/127 of its largest value, the rounding apart flipping
  codes) the first gradient is held at 0.1 a leaf and the updates
  together at 0.15, as the moe family's (measured 5.2%).  The cases:
  (1, 2) with remat "none" and "full", Adafactor; (1, 4); (2, 2) with
  INT8 compression; and (1, 4) with 2 heads of 32, where each rank's 16
  columns cut a head: the projections are gathered whole and every rank
  scans both heads.
- One layer's time and channel mix in fp32 on 2 ranks against the
  whole layer (the output, x's gradient, each leaf's block of the
  gradient within 1e-4 relative L2): 4 heads (each rank 2), and 1 head
  of 64, which the ranks' column blocks cut.
- Every forward product of the first step reads its leaf at the local
  width (``torch_tp_family.widths``).
- The sum-then-slice gather and the two-way sum on 4 ranks against the
  whole computation: ``copy_to_model(gather_from_model(y))`` equals y on
  every rank and gives each block its slice of the gradient of the
  ranks' summed reads (each rank's, summed in fp32 and rounded once),
  bit for bit; ``copy_to_model(reduce_from_model(s))`` of fp32
  ``s`` stays fp32, equals the sum, and gives each rank the sum of every
  rank's gradient; one all-gather and one all-reduce, and two
  all-reduces, recorded with the group's size.
- A (1, 2) state, split over ``model``, restores onto (2, 1) bit for
  bit and trains on.
- The dry run on a reduced (4, 4) plan on ``meta``: rank 0's GEMM flops
  equal the placements' prediction exactly, ``tensor_parallel`` 4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_tp_family as F  # noqa: E402
from repro_torch.configs.base import RunConfig, ShapeConfig  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.launch.mesh import MeshPlan  # noqa: E402
from test_torch_mesh import _assert_equal_to_checkpoint, _checkpoint  # noqa: E402,E501

ARCH = "rwkv6_7b"
HEADS2 = dict(n_heads=2, n_kv_heads=2)
CASES = {
    "1x2-rwkv6": ((1, 2), {}, {}),
    "1x2-rwkv6-full": ((1, 2), {}, dict(remat="full")),
    "1x2-rwkv6-adafactor": ((1, 2), {}, dict(opt="adafactor")),
    "1x4-rwkv6": ((1, 4), {}, {}),
    "1x4-rwkv6-heads2": ((1, 4), HEADS2, {}),
    "2x2-rwkv6-compression": ((2, 2), {}, dict(compression=True)),
}
WORLD = 4
STEPS = 3
TOL = F.Tol(norm=2e-2)
INT8 = F.Tol(norm=2e-2, grad=0.1, total=0.15)
LAYERS = [("rwkv", {}), ("rwkv-one-head", dict(n_heads=1, n_kv_heads=1))]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pieces():
    rng = np.random.default_rng(11)
    weights = np.zeros((WORLD, 5, 8 * WORLD), np.float32)
    for r in range(WORLD):      # each rank reads its own columns
        cols = rng.choice(8 * WORLD, 10, replace=False)
        weights[r][:, cols] = rng.standard_normal((5, 10))
    return dict(
        y=torch.from_numpy(rng.standard_normal((5, 8 * WORLD)).astype(
            np.float32)).to(torch.bfloat16),
        weights=torch.from_numpy(weights),
        s=torch.from_numpy(rng.standard_normal((WORLD, 6, 1)).astype(
            np.float32)),
        c=torch.from_numpy(rng.standard_normal((WORLD, 6, 1)).astype(
            np.float32)))


@pytest.fixture(scope="module")
def ssm_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_ssm")
    layers = [F.layer_case(n, ARCH, ov, 20 + i)
              for i, (n, ov) in enumerate(LAYERS)]
    return F.start(tmp, ARCH, CASES, pieces={
        (1, WORLD): [("gather_and_sum_pieces", _pieces())],
        (1, 2): [("layer_pieces", {"cases": layers})]},
        elastic=((1, 2), {"cfg": F.configs(ARCH, {})[1],
                          "ckpt_dir": str(tmp / "ckpt")})), tmp


@pytest.mark.parametrize("name", sorted(CASES))
def test_ssm_tp_step_matches_reference_and_meshless(ssm_runs, name):
    (res, refs, before, _, _), _ = ssm_runs
    mesh, _, kw = CASES[name]
    assert res[name]["tensor_parallel"] == mesh[1]
    steps = 2 if kw.get("opt") == "adafactor" else STEPS
    F.check_run(res[name], refs[name], before[name], steps,
                INT8 if kw.get("compression") else TOL)


@pytest.mark.parametrize("name", [n for n, _ in LAYERS])
def test_one_layer_in_fp32_against_the_whole(ssm_runs, name):
    F.check_layer([r[name] for r in ssm_runs[0][3]["layer_pieces"]])


@pytest.mark.parametrize("name", sorted(CASES))
def test_ssm_gemms_run_at_local_widths(ssm_runs, name):
    res = ssm_runs[0][0][name]
    mesh, ov, _ = CASES[name]
    cfg = F.configs(ARCH, ov)[1]
    want = F.widths(cfg, mesh[1])
    assert F.gemm_widths(res) == {k: {v} for k, v in want.items()}
    assert sum(p.startswith("layers/") for p in res["gemm_widths"]) == \
        cfg.n_layers * (len(want) - 1)


def test_sum_then_slice_gather_against_the_whole(ssm_runs):
    every, u = ssm_runs[0][3]["gather_and_sum_pieces"], _pieces()
    # the whole y's gradient: every rank's (its weights in y's bf16),
    # summed in fp32 and rounded once
    want = sum(w.to(torch.bfloat16).float() for w in u["weights"]).to(
        torch.bfloat16)
    n = want.shape[1] // WORLD
    for rank, out in enumerate(every):
        (z, grad), seen = out["gather"]
        assert torch.equal(z, u["y"])
        assert torch.equal(grad, want[:, rank * n:(rank + 1) * n])
        assert seen == [("all-gather", u["y"].numel() * 2, WORLD),
                        ("all-reduce", u["y"].numel() * 4, WORLD)]


def test_two_way_sum_against_the_whole(ssm_runs):
    every, u = ssm_runs[0][3]["gather_and_sum_pieces"], _pieces()
    want = u["s"].sum(0)
    for rank, out in enumerate(every):
        (t, dtype, grad), seen = out["sum"]
        assert dtype == torch.float32
        torch.testing.assert_close(t, want, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(grad, u["c"].sum(0), rtol=1e-6,
                                   atol=1e-6)
        assert seen == [("all-reduce", 6 * 4, WORLD)] * 2


def test_elastic_restore_from_a_head_split_state(ssm_runs):
    (_, _, _, _, res), tmp = ssm_runs
    assert res["a_tp"] == 2 and len(res["a"]["losses"]) == 4
    assert res["b_start"] == 4 and len(res["b"]["losses"]) == 4
    assert np.isfinite(res["b"]["losses"]).all()
    _assert_equal_to_checkpoint(res["b_state"], _checkpoint(tmp / "ckpt",
                                                            3))


PLAN = MeshPlan((4, 4), ("data", "model"))
TRAIN = ShapeConfig("train_4k", "train", 64, 8)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_dry_run_gemm_flops_follow_the_placements(remat):
    cfg = F.configs(ARCH, {})[1]
    run = RunConfig(model=cfg, shape=TRAIN, remat=remat)
    got, groups = F.dry_run_flops(run, PLAN)
    assert got == F.predicted_flops(cfg, run, 4, 4)
    assert S.build_train_step(run, PLAN).tensor_parallel == 4
    assert {g for op, g in groups if op == "all-reduce"} == {4}
    # each layer's channel-mix gate gathered once a forward (again in
    # the recompute), the split leaves gathered over ``data`` once
    assert groups[("all-gather", 4)][0] == \
        cfg.n_layers * (2 if remat == "full" else 1) + 1
