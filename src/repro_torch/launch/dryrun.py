"""Dry run: every (architecture x input shape x mesh) cell counted on
``meta`` tensors, with its roofline terms.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch all --shape all --mesh single multi --out build/dryrun

The reference lowers and compiles each cell's jitted step for the
production mesh and reads XLA's cost and memory analyses.  Torch has
no compiler to ask.  The port builds the cell's step on the mesh
(``launch.steps``; the production meshes are ``MeshPlan``s, (16, 16)
and (2, 16, 16)) and runs rank 0 of it on ``meta`` tensors under the
cost counter (``launch.hlo_analysis.analyze``): the rank's blocks of
the state and its rows of the batch, every collective recorded with the
group size the plan's axes give.  Nothing is allocated and no card is
needed; the count is the one the same step makes on the card.  The
plan holds the rank count, so there is no device-count flag.

``build_s`` (building the step and the rank's ``meta`` blocks) and
``count_s`` (running the step under the counter) replace the
reference's ``lower_s`` / ``compile_s``: there is no lowering or
compilation, and ``count_s`` is host time that grows with the number
of ops the step dispatches.

Cells:

- ``train``: as the reference, a model over 3e10 parameters defaults to
  Adafactor.  ``tensor_parallel`` is the ``model`` extent over which the
  dense and vlm families' layers split their leaves
  (``steps.tensor_parallel_leaves``), or 1: the counts are then rank
  0's, computing with its ``model`` blocks.  On a mesh that splits the
  batch rows over more than one rank an MoE model runs the row-local
  dispatch (``moe_local_dispatch``, recorded as ``moe_dispatch``): the
  global one raises there (ROADMAP 14g).
- ``prefill`` / ``decode``: the port serves on one rank only (ROADMAP
  14f), so on a mesh of more ranks these cells are recorded as
  skipped with that reason.  On one rank the prefill step is counted
  over the shape's prompts, and one decode step over a cache whose
  slots were prefilled (uncounted) with ``seq_len - 1`` tokens.
- ``long_500k`` x a full-attention model: skipped with the reference's
  reason.

``memory_analysis`` takes XLA's four fields from the counter:
``argument_bytes``, the storages of the step's arguments (the rank's
state, ``steps.per_rank_bytes``, plus its batch rows; an MLA model's
derived copies, which are whole on every rank, besides); ``output_
bytes``, those of its results; ``alias_bytes``, the results' storages
that are the donated argument's (the state the update writes in place,
the cache); ``temp_bytes``, the counter's peak less the arguments.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import ALIASES, ARCH_IDS, SHAPES, get_config, \
    skip_reason
from repro_torch.configs.base import RunConfig
from repro_torch.launch import hlo_analysis as HA
from repro_torch.launch import roofline as RL
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.decoding import cache_tree
from repro_torch.models.params import tree_map
from repro_torch.sharding import blocks as BL

SERVE_ONE_RANK = ("prefill and decode steps serve on one rank only "
                  "(ROADMAP 14f: multi-rank serving)")


def _storages(tree) -> dict:
    """{storage key: bytes} of the tensors in ``tree`` (a cache's among
    them)."""
    if isinstance(tree, (list, tuple)):
        tree = [cache_tree(x) if hasattr(x, "alloc_seq") else x
                for x in tree]
    return HA.storage_bytes(tree)


def count(fn, args, donated):
    """(result, costs, memory_analysis) of ``fn(*args)``,
    ``args[donated]`` the donated argument."""
    arg = _storages(args)
    given = _storages(args[donated])
    out, costs = HA.analyze(fn, *args)
    res = _storages(out)
    mem = {"argument_bytes": sum(arg.values()),
           "output_bytes": sum(res.values()),
           "temp_bytes": int(costs.peak_bytes) - sum(arg.values()),
           "alias_bytes": sum(v for k, v in res.items() if k in given)}
    return out, costs, mem


def zeros_tree(tree, device):
    """Zeros on ``device`` of each leaf of ``tree``'s shape and dtype."""
    return tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                          device=device), tree)


def cell_step(run, mesh, device="meta"):
    """``(fn, args, donated)``: the cell's step on rank 0 of ``mesh``
    (on ``device``, where ``mesh`` is of one rank) and its arguments,
    zeros: the rank's blocks of the state and its batch rows (train), the
    weights and the prompts (prefill), the weights, a prefilled cache and
    one token a slot (decode); ``args[donated]`` is donated."""
    if run.shape.kind == "train":
        built, args = _train_cell(run, mesh, device)
        return built.fn, args, 0
    if run.shape.kind == "prefill":
        built = steps.build_prefill_step(run, mesh, device=device)
        return built.fn, tuple(zeros_tree(t, device)
                               for t in built.abstract_inputs), 0
    return _decode(run, mesh, device)


def _train_cell(run, mesh, device):
    """(the train step's ``BuiltStep``, its arguments on rank 0)."""
    built = steps.build_train_step(run, mesh, device=device)
    (astate, abatch), (s_pl, b_pl) = built.abstract_inputs, \
        built.in_shardings
    return built, (BL.local_zeros(astate, s_pl, mesh, device),
                   BL.local_zeros(abatch, b_pl, mesh, device))


def _decode(run, mesh, device):
    """One decode step after a prefill (not counted) of ``seq_len - 1``
    tokens a slot."""
    pre = steps.build_prefill_step(dataclasses.replace(
        run, shape=dataclasses.replace(run.shape, kind="prefill")), mesh,
        device=device)
    params = zeros_tree(pre.abstract_inputs[0], device)
    batch = {k: torch.zeros((v.shape[0], v.shape[1] - (k != "audio_frames"),
                             *v.shape[2:]), dtype=v.dtype, device=device)
             for k, v in pre.abstract_inputs[1].items()}
    cache, _ = pre.fn(params, batch)
    built = steps.build_decode_step(run, mesh, device=device)

    def decode(params, pools, tokens):
        # the cache's tensors ride along as ``pools``, so that they are
        # counted among the arguments, as the donated one
        return built.fn(params, cache, tokens)

    return decode, (params, cache_tree(cache),
                    zeros_tree(built.abstract_inputs[2], device)), 1


def mesh_name(mesh) -> str:
    return "x".join(str(n) for n in BL.mesh_shape_dict(mesh).values())


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             run_overrides: dict | None = None, mesh=None, *,
             config=None, shape=None) -> dict:
    """The cell's record (module docstring).  ``mesh`` defaults to the
    production plan; ``config`` and ``shape`` replace the arch's full
    config and the named shape (a reduced cell)."""
    cfg = config or get_config(arch)
    shape = shape or SHAPES[shape_name]
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    n_dev = math.prod(BL.mesh_shape_dict(mesh).values())
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name(mesh),
           "kind": shape.kind}
    reason = skip_reason(cfg, shape_name)
    if reason is None and shape.kind != "train" and n_dev > 1:
        reason = SERVE_ONE_RANK
    if reason:
        rec["status"] = "skipped"
        rec["reason"] = reason
        return rec

    overrides = dict(run_overrides or {})
    if shape.kind == "train" and cfg.n_params() > 3e10:
        overrides.setdefault("optimizer", "adafactor")
    ms = BL.mesh_shape_dict(mesh)
    if cfg.moe is not None and shape.kind == "train" \
            and ms.get("pod", 1) * ms.get("data", 1) > 1:
        overrides.setdefault("moe_local_dispatch", True)
    run = RunConfig(model=cfg, shape=shape, multi_pod=multi_pod,
                    **overrides)

    t0 = time.time()
    if shape.kind == "train":
        built, args = _train_cell(run, mesh, "meta")
        fn, donated = built.fn, 0
        rec["tensor_parallel"] = built.tensor_parallel
    else:
        fn, args, donated = cell_step(run, mesh)
    build_s = time.time() - t0
    t0 = time.time()
    _, costs, mem = count(fn, args, donated)
    count_s = time.time() - t0
    stats = RL.MemoryStats(mem["argument_bytes"], mem["output_bytes"],
                           mem["temp_bytes"], mem["alias_bytes"])
    rl = RL.compute_roofline(costs, n_dev, RL.model_flops_for(cfg, shape),
                             stats)
    rec.update(status="ok", build_s=round(build_s, 2),
               count_s=round(count_s, 2), n_devices=n_dev,
               optimizer=run.optimizer, roofline=rl.to_dict(),
               memory_analysis=mem, kernel_ops=costs.kernel_ops)
    if cfg.moe is not None:
        rec["moe_dispatch"] = "row-local" if run.moe_local_dispatch \
            else "global"
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+", default=["all"])
    ap.add_argument("--shape", nargs="+", default=["all"])
    ap.add_argument("--mesh", nargs="+", default=["single"],
                    choices=["single", "multi"])
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--optimizer", default=None)
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--q-chunk", type=int, default=0)
    ap.add_argument("--kv-chunk", type=int, default=0)
    ap.add_argument("--ce-chunk", type=int, default=0)
    ap.add_argument("--ssm-chunk", type=int, default=0)
    ap.add_argument("--kv-cache-quant", action="store_true")
    ap.add_argument("--moe-cap-axis", default="")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--moe-local", action="store_true")
    args = ap.parse_args()

    archs = ARCH_IDS if args.arch == ["all"] else [
        ALIASES.get(a, a) for a in args.arch]
    shapes = list(SHAPES) if args.shape == ["all"] else args.shape
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    overrides = {"remat": args.remat}
    if args.optimizer:
        overrides["optimizer"] = args.optimizer
    for field, val in (("q_chunk", args.q_chunk),
                       ("kv_chunk", args.kv_chunk),
                       ("ce_chunk", args.ce_chunk),
                       ("ssm_chunk", args.ssm_chunk)):
        if val:
            overrides[field] = val
    if args.kv_cache_quant:
        overrides["kv_cache_quant"] = True
    if args.moe_cap_axis:
        overrides["moe_cap_axis"] = args.moe_cap_axis
    if args.no_fsdp:
        overrides["fsdp"] = False
    if args.moe_local:
        overrides["moe_local_dispatch"] = True

    results = []
    for arch in archs:
        for shape in shapes:
            for mesh_kind in args.mesh:
                multi = mesh_kind == "multi"
                name = f"{arch}.{shape}.{mesh_kind}.{args.tag}"
                path = outdir / f"{name}.json"
                try:
                    rec = run_cell(arch, shape, multi, overrides)
                except Exception as e:  # a failing cell is a bug: surface it
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                           "status": "error", "error": repr(e),
                           "traceback": traceback.format_exc()}
                rec["tag"] = args.tag
                path.write_text(json.dumps(rec, indent=1))
                results.append(rec)
                if rec["status"] == "ok":
                    r = rec["roofline"]
                    print(f"{name:55s} OK  count={rec['count_s']:7.1f}s "
                          f"compute={r['compute_s']:.3e} "
                          f"memory={r['memory_s']:.3e} "
                          f"coll={r['collective_s']:.3e} "
                          f"bound={r['bottleneck']:10s} "
                          f"roofline={r['roofline_fraction']:.3f}",
                          flush=True)
                else:
                    print(f"{name:55s} {rec['status'].upper()} "
                          f"{rec.get('reason', rec.get('error', ''))[:90]}",
                          flush=True)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"\ndone: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
