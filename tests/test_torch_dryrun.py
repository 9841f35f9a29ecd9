"""The port's dry run (``repro_torch.launch.dryrun``): rank 0 of a mesh
plan counted on ``meta`` tensors, as the reference's
``tests/test_dryrun_small.py`` lowers and compiles a cell on 8 fake
devices.

- A reduced train cell on a (2, 4) plan is ``ok`` with positive terms;
  its collectives are the step's own (one all-gather of every rank's
  split weight blocks, the three all-reduces of the batch split), its
  ``argument_bytes`` the rank's state (``steps.per_rank_bytes``) plus
  its batch rows; an MoE model there takes the row-local dispatch and
  all-reduces its load-balancing sums.
- Serving cells on that plan are skipped naming ROADMAP 14f; long_500k
  x a full-attention model with the reference's reason; on one rank the
  prefill and decode cells are counted.
- Real tensors on a plan of more ranks raise.
- The vectorised ``sharding.blocks.gather`` puts every rank's block
  where ``local_slice`` takes it from.
- The CLI writes a record per cell, which ``report`` reads.
- The full qwen2-0.5b cell on the production plan is ``slow``, as the
  reference's full cell is.
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs.base import skip_reason as ref_skip_reason  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.configs.base import RunConfig, ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import hlo_analysis as HA  # noqa: E402
from repro_torch.launch import report  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import MeshPlan  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402
from repro_torch.sharding import blocks as BL  # noqa: E402

PLAN = MeshPlan((2, 4), ("data", "model"))
TRAIN = ShapeConfig("train_4k", "train", 64, 8)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def count_by_group(fn, args, donated):
    """``dryrun.count(fn, args, donated)`` and the collectives it
    counted by (op, group size): (count, bytes), read through
    ``hlo_analysis.collective``."""
    seen, orig = {}, HA.collective

    def record(op, nbytes, group_size):
        if HA._ACTIVE is not None and group_size > 1:
            n, b = seen.get((op, group_size), (0, 0.0))
            seen[(op, group_size)] = (n + 1, b + nbytes)
        orig(op, nbytes, group_size)

    HA.collective = record
    try:
        return dryrun.count(fn, args, donated), seen
    finally:
        HA.collective = orig


def _cell(arch, shape_name="train_4k", shape=TRAIN, mesh=PLAN):
    return dryrun.run_cell(arch, shape_name, False, mesh=mesh,
                           config=get_reduced(arch), shape=shape)


def test_reduced_train_cell_on_a_plan():
    rec = _cell("qwen2_0_5b")
    rl = rec["roofline"]
    assert rec["status"] == "ok" and rec["mesh"] == "2x4"
    assert rec["n_devices"] == 8 and rec["optimizer"] == "adamw"
    assert rl["compute_s"] > 0 and rl["bytes_per_device"] > 0
    assert rl["collective_count"] > 0 and rl["collective_s"] > 0
    assert rec["kernel_ops"]["streaming_gemm"] > 0
    mem = rec["memory_analysis"]
    assert mem["temp_bytes"] > 0
    assert mem["alias_bytes"] > 0          # the state, updated in place


def test_collectives_and_arguments_are_the_steps_own():
    cfg = get_reduced("qwen2_0_5b")
    run = RunConfig(model=cfg, shape=TRAIN)
    built = steps.build_train_step(run, PLAN)
    fn, args, donated = dryrun.cell_step(run, PLAN)
    (_, costs, mem), groups = count_by_group(fn, args, donated)
    ms = BL.mesh_shape_dict(PLAN)
    # ``model`` (4) splits the query heads, the MLP and the vocabulary:
    # those leaves are gathered over the 2 data ranks only, the others
    # over all 8 ranks
    w_pl = T.trainable(built.in_shardings[0]["params"])
    w = T.trainable(args[0]["params"])
    tp = BL.tree_leaves_of(steps.tensor_parallel_leaves(cfg, w_pl, PLAN),
                           w)
    leaves = list(zip(tree_leaves(w), BL.tree_leaves_of(w_pl, w), tp))
    assert built.tensor_parallel == 4 and any(tp) and not all(tp)

    def nbytes(t):
        return t.numel() * t.element_size()

    whole = sum(nbytes(t) for t, s, p in leaves
                if not p and BL.splits(s, ms))
    over_data = sum(nbytes(t) for t, s, p in leaves
                    if p and BL.splits(BL.restrict(s, ("data",)), ms))
    # over the 2 data ranks: the label counts, the flat fp32 gradients
    # (a split leaf's ``model`` block), the cross-entropy share
    grads = 4 * sum(t.numel() * (2 if BL.splits(BL.restrict(
        s, ("data",)), ms) else 1) for t, s, _ in leaves)
    # over the 4 model ranks, in fp32: per layer the attention's and the
    # MLP's output sums and their inputs' gradient sums, the attention's
    # sum again in remat="full"'s recompute; the lookup; the
    # cross-entropy's max, (sum of exp, gold) and hidden-state gradient;
    # the K/V gradient shares (the 2 KV heads do not split over 4); the
    # clipping norm's split squares
    rows = TRAIN.global_batch // 2 * TRAIN.seq_len
    act = rows * cfg.d_model * 4
    kv = 4 * sum(lp["attn"][k].numel()
                 for lp in built.abstract_inputs[0]["params"]["layers"]
                 for k in ("wk", "wv", "bk", "bv"))
    model = [act] * (5 * cfg.n_layers + 1) + [rows * 4, rows * 8, act, kv,
                                              4]
    data = [8, grads, 4]
    assert groups == {
        ("all-gather", 8): (1, 8.0 * whole),
        ("all-gather", 2): (1, 2.0 * over_data),
        ("all-reduce", 2): (3, float(sum(data))),
        ("all-reduce", 4): (len(model), float(sum(model)))}
    assert costs.coll_count == 5 + len(model)
    assert costs.coll_effective == 8 * whole * 7 / 8 + 2 * over_data / 2 \
        + 2 * sum(data) / 2 + 2 * sum(model) * 3 / 4
    batch = sum(t.numel() * t.element_size() for t in tree_leaves(args[1]))
    assert batch == 2 * (8 // 2) * 64 * 4       # tokens and labels rows
    assert mem["argument_bytes"] == steps.per_rank_bytes(built) + batch


@pytest.mark.parametrize("remat", ["none", "full"])
def test_moe_cell_on_a_plan_takes_the_row_local_dispatch(remat):
    cfg = get_reduced("qwen2_moe_a2_7b")
    rec = dryrun.run_cell("qwen2_moe_a2_7b", "train_4k", False,
                          {"remat": remat}, PLAN, config=cfg, shape=TRAIN)
    assert rec["status"] == "ok" and rec["moe_dispatch"] == "row-local"
    assert rec["kernel_ops"]["streaming_gemm_grouped"] > 0
    # the dense arch's four, and one all-reduce each time a MoE layer's
    # forward runs (its load-balancing sums over the batch ranks): again
    # in the backward pass under remat="full"
    runs = 2 if remat == "full" else 1
    assert rec["roofline"]["collective_count"] == \
        4 + runs * (cfg.n_layers - cfg.moe.first_dense_layers)


def test_mla_cell_on_a_plan():
    rec = _cell("deepseek_v3_671b")
    assert rec["status"] == "ok" and rec["moe_dispatch"] == "row-local"
    assert rec["roofline"]["flops_per_device"] > 0


@pytest.mark.parametrize("shape_name", ["prefill_32k", "decode_32k"])
def test_serving_cells_on_a_plan_are_skipped(shape_name):
    rec = _cell("qwen2_0_5b", shape_name, ShapeConfig(
        shape_name, shape_name.split("_")[0], 64, 8))
    assert rec["status"] == "skipped"
    assert "14f" in rec["reason"]


def test_long_context_of_a_full_attention_model_is_skipped():
    rec = dryrun.run_cell("qwen2_0_5b", "long_500k", False, mesh=PLAN)
    assert rec["status"] == "skipped"
    assert rec["reason"] == ref_skip_reason(ref_config("qwen2_0_5b"),
                                            "long_500k")


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_serving_cells_on_one_rank_are_counted(kind):
    rec = _cell("qwen2_0_5b", f"{kind}_32k",
                ShapeConfig(f"{kind}_32k", kind, 64, 2), BL.ONE_RANK)
    assert rec["status"] == "ok" and rec["mesh"] == "1x1"
    assert rec["kernel_ops"]["flash_attention" if kind == "prefill"
                             else "paged_attention"] == 2
    assert rec["roofline"]["collective_count"] == 0
    mem = rec["memory_analysis"]
    if kind == "decode":        # the cache's pools, written in place
        assert mem["alias_bytes"] > 0 and \
            mem["alias_bytes"] <= mem["argument_bytes"]


def test_real_tensors_on_a_plan_raise():
    run = RunConfig(model=get_reduced("qwen2_0_5b"), shape=TRAIN)
    fn, args, _ = dryrun.cell_step(run, PLAN, "cpu")
    with pytest.raises(ValueError, match="plan with no ranks"):
        fn(*args)


def test_gather_puts_each_rank_block_in_its_place():
    ms = {"pod": 2, "data": 2, "model": 3}
    plan = MeshPlan(tuple(ms.values()), tuple(ms))
    n = math.prod(ms.values())
    specs = [(("pod", "data"), "model"), (None, "model"), ("data", None),
             (("model", "pod"),)]
    wholes = [torch.arange(4 * 6, dtype=torch.bfloat16).view(4, 6),
              torch.arange(5 * 3, dtype=torch.float32).view(5, 3),
              torch.arange(2 * 7, dtype=torch.int32).view(2, 7),
              torch.arange(12, dtype=torch.float64)]
    blocks = [[BL.local_slice(w, s, plan, r).contiguous() for r in range(n)]
              for w, s in zip(wholes, specs)]
    # every rank's buffer of its blocks, as the all-gather leaves them
    parts = torch.stack([torch.cat([b[r].view(-1).view(torch.uint8)
                                    for b in blocks]) for r in range(n)])
    at = 0
    for w, s, b in zip(wholes, specs, blocks):
        f = b[0].numel() * b[0].element_size()
        local = b[0]
        shape = (*local.shape[:-1], local.shape[-1] * local.element_size())
        got = BL._assemble(parts[:, at:at + f].view(*ms.values(), *shape),
                           s, ms).view(w.dtype)
        assert torch.equal(got, w), s
        at += f
    # on the plan itself (meta): whole shapes, one recorded all-gather
    from repro_torch.launch import hlo_analysis as HA
    local = [b[0].to("meta") for b in blocks]
    out, c = HA.analyze(BL.gather, local, specs, plan)
    assert [tuple(t.shape) for t in out] == [tuple(w.shape) for w in wholes]
    assert c.coll_by_op == {"all-gather": float(n * parts.shape[1])}


def test_cli_records_cells_and_report_reads_them(tmp_path, monkeypatch,
                                                 capsys):
    monkeypatch.setattr("sys.argv", [
        "dryrun", "--arch", "qwen2-0.5b", "--shape", "long_500k",
        "decode_32k", "--mesh", "single", "multi", "--out", str(tmp_path)])
    dryrun.main()
    assert "done: 0 ok, 4 skipped, 0 errors" in capsys.readouterr().out
    assert len(list(tmp_path.glob("*.json"))) == 4
    assert report.summary(tmp_path).splitlines() == [
        "single: 0 ok / 2 skipped / 0 errors (2 cells)",
        "multi: 0 ok / 2 skipped / 0 errors (2 cells)"]
    assert report.roofline_table(tmp_path).count("*skip*") == 2


@pytest.mark.slow
def test_full_width_cell_on_the_production_plan():
    rec = dryrun.run_cell("qwen2_0_5b", "train_4k", False)
    rl = rec["roofline"]
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    assert rl["compute_s"] > 0 and rl["bytes_per_device"] > 0
    # ``model`` splits the MLP and the vocabulary (14 heads do not divide
    # over 16): two all-gathers, the batch split's three all-reduces, and
    # over ``model`` each layer's MLP output and input-gradient sums
    # (the recompute stops before the output's), the lookup, three for
    # each of the 8 cross-entropy chunks and the clipping norm's
    assert rec["tensor_parallel"] == 16
    assert rl["collective_count"] == 2 + 3 + 24 * 2 + 1 + 8 * 3 + 1


def test_every_reference_module_has_its_counterpart():
    """With the dry run, the cost counter, the roofline and the report,
    a diff of the two packages' module paths finds nothing in the
    reference alone."""
    from pathlib import Path
    src = Path(__file__).resolve().parents[1] / "src"

    def paths(pkg):
        return {p.relative_to(src / pkg) for p in (src / pkg).rglob("*.py")}

    assert paths("repro") - paths("repro_torch") == set()
