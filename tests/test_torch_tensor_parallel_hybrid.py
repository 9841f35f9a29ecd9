"""Tensor parallelism of the hybrid family in the port's train step
(``models/ssm.py``, ``models/transformer.py``, ``launch/steps.py``):
Mamba2 by heads (the fused ``in_proj``'s column blocks and ``conv_w``'s
gathered whole, each rank's heads' channels taken from them, the gated
RMSNorm's sum of squares summed over ``model``, ``out_proj`` by rows),
the shared attention block by heads at each of its invocations, the
MLPs by columns, the vocabulary in blocks.

Gloo ranks on the CPU (``torch_mesh_ranks.start``; bodies in
``torch_tp_ranks``, set up by ``torch_tp_family``), reduced zamba2-7b (4
layers, d 64, d_in 128 in 4 heads of 32, d_state 16, the shared block
before layers 0 and 2) with the reference's weights
(``from_reference``), on (1, 2), (1, 4), (2, 2), (1, 3) and (1, 1)
meshes, all jobs and two reference processes at once in one module
fixture.

- Every case is held as ``tests/test_torch_mesh.py`` holds a mesh run
  (``torch_tp_family.check_run``): metrics 1e-3 relative against the
  reference's first step and the one-rank step's, each leaf's update
  within 0.3 relative L2 and all within 0.1 of the one-rank step's,
  each leaf's first gradient within 5e-2 of one rank's and of the
  reference's; 3 steps, 2 with Adafactor, the grad norm within 2e-2 of
  one rank's (measured 1.3e-2 at step 2; 3.0e-2 at step 3, where
  Adam's near-sign steps have carried two updates' rounding: the
  ssm file sets out the measure).  Mamba's per-head leaves (``A_log``,
  ``dt_bias``, ``D``: 4 values a layer) and the conv taps (``conv_w``:
  4 a channel), each a sum over every token with much cancelled, have
  their first gradient held at 0.1 (measured 7.4% and 5.3% against one
  rank, 8.4% against the reference); ``D`` is left out
  against the reference, which sums its gradient in bf16 (8.7% apart
  from one rank's port).  Under INT8 compression the first gradient is
  held at 0.1 a leaf and the updates together at 0.15, as the moe
  family's.  The cases: (1, 2) with remat "none" and "full", INT8
  compression; (1, 4), where a rank's ``in_proj`` block is 73 columns
  wide; (2, 2) with Adafactor.
- On (1, 3) nothing divides (4 heads, 292 ``in_proj`` columns, d_ff
  128, vocabulary 256): the step splits no leaf, and its metrics and
  weights equal a (1, 1) mesh's bit for bit at every step.  (Against
  the one-rank step with no mesh, the local layout, a few single values
  of a gradient or of the weights part by one ulp, at the first step or
  from the third on, from run to run; in the parent commit too, where
  the hybrid family split nothing: ROADMAP Queue C.)
- One Mamba2 block in fp32 on 2 ranks against the whole block (the
  output, x's gradient, each leaf's block of the gradient within 1e-4
  relative L2): 4 heads (each rank 2), and one head of 128, which does
  not divide: ``in_proj`` (289 columns) and the head's leaves whole,
  ``conv_w`` and ``out_proj`` split, every rank running the head and
  feeding ``out_proj`` its rows.
- Every forward product of the first step reads its leaf at the local
  width (``torch_tp_family.widths``), the shared block's at each
  invocation.
- The dry run on a reduced (4, 4) plan on ``meta``: rank 0's GEMM flops
  equal the placements' prediction exactly, ``tensor_parallel`` 4.
"""
import pytest

torch = pytest.importorskip("torch")

import torch_tp_family as F  # noqa: E402
from repro_torch.configs.base import RunConfig, ShapeConfig  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.launch.mesh import MeshPlan  # noqa: E402
from test_torch_mesh import _by_path  # noqa: E402

ARCH = "zamba2_7b"
CASES = {
    "1x1-zamba2": ((1, 1), {}, {}),
    "1x2-zamba2": ((1, 2), {}, {}),
    "1x2-zamba2-full": ((1, 2), {}, dict(remat="full")),
    "1x2-zamba2-compression": ((1, 2), {}, dict(compression=True)),
    "1x4-zamba2": ((1, 4), {}, {}),
    "2x2-zamba2-adafactor": ((2, 2), {}, dict(opt="adafactor")),
    "1x3-zamba2": ((1, 3), {}, {}),
}
STEPS = 3
HEAD_LEAVES = ("A_log", "dt_bias", "D", "conv_w")
TOL = F.Tol(norm=2e-2, loose=HEAD_LEAVES, loose_rel=0.1, skip_ref=("D",))
INT8 = F.Tol(norm=2e-2, grad=0.1, total=0.15, skip_ref=("D",))
LAYERS = [("mamba", {}), ("mamba-one-head", {"ssm": {"head_dim": 128}})]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def hybrid_runs(tmp_path_factory):
    layers = [F.layer_case(n, ARCH, ov, 30 + i)
              for i, (n, ov) in enumerate(LAYERS)]
    return F.start(tmp_path_factory.mktemp("tp_hybrid"), ARCH, CASES,
                   pieces={(1, 2): [("layer_pieces", {"cases": layers})]})


def _extent(mesh):
    """The model extent a case's step splits over: none on (1, 3)."""
    return 1 if mesh[1] == 3 else mesh[1]


@pytest.mark.parametrize("name", sorted(CASES))
def test_hybrid_tp_step_matches_reference_and_meshless(hybrid_runs, name):
    res, refs, before = hybrid_runs[:3]
    mesh, _, kw = CASES[name]
    assert res[name]["tensor_parallel"] == _extent(mesh)
    steps = 2 if kw.get("opt") == "adafactor" else STEPS
    F.check_run(res[name], refs[name], before[name], steps,
                INT8 if kw.get("compression") else TOL)


def test_nothing_divides_on_three_ranks_bit_for_bit(hybrid_runs):
    res = hybrid_runs[0]
    got, one = res["1x3-zamba2"], res["1x1-zamba2"]
    assert got["got"] == one["got"]
    for a, b in zip(got["params"], one["params"]):
        a, b = _by_path(a), _by_path(b)
        assert set(a) == set(b)
        for k in b:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("name", [n for n, _ in LAYERS])
def test_one_block_in_fp32_against_the_whole(hybrid_runs, name):
    F.check_layer([r[name] for r in hybrid_runs[3]["layer_pieces"]])


@pytest.mark.parametrize("name", sorted(CASES))
def test_hybrid_gemms_run_at_local_widths(hybrid_runs, name):
    res = hybrid_runs[0][name]
    mesh, ov, _ = CASES[name]
    cfg = F.configs(ARCH, ov)[1]
    want = F.widths(cfg, _extent(mesh))
    assert F.gemm_widths(res) == {k: {v} for k, v in want.items()}


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
    # each layer's in_proj product and conv_w gathered once a forward
    # (again in the recompute), the split leaves gathered over ``data``
    # once
    assert groups[("all-gather", 4)][0] == \
        2 * cfg.n_layers * (2 if remat == "full" else 1) + 1
