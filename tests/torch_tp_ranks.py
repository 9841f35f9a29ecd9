"""Rank bodies of ``tests/test_torch_tensor_parallel.py``, started by
``torch_mesh_ranks.start`` (gloo ranks on the CPU, ``spawn``).  This
module imports no JAX.

- ``train_cases``: each (name, cfg, mesh shape, weights, batches, run
  settings) through ``torch_mesh_ranks.train_against_meshless``, the
  streaming GEMM's B operand of every forward product of the mesh's
  first step recorded by the weight leaf it reads (``gemm_widths``).
- ``unit_pieces``: ``copy_to_model``, ``reduce_from_model``, the
  vocabulary-parallel lookup and cross-entropy on a (1, world) mesh,
  forward and gradients of every rank.
- ``elastic_restore``: a ``Trainer`` on (1, 2), where ``model`` splits the
  weights, checkpoints; one on (2, 1) restores it and trains on.

``job`` runs the train cases, then the others where it is given their
inputs.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

import torch_mesh_ranks as R


def _paths(tree) -> dict:
    from repro_torch.checkpoint.checkpoint import _flatten
    return {"/".join(p): t for p, t in _flatten(tree)}


def _recorded(run_first_step):
    """(``run_first_step()``'s result, {leaf path: sorted set of the B
    shapes the forward products read from it}) over the first
    ``loss_and_grads`` call made while it runs: B's storage tells the
    leaf."""
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as S
    fwd, lag = ops._StreamingGemm.forward, S.loss_and_grads
    seen, first = [], {}

    def record(ctx, a, b):
        if first.get("on"):
            seen.append((b.untyped_storage().data_ptr(), tuple(b.shape)))
        return fwd(ctx, a, b)

    def loss_and_grads(model, params, batch, objective=None):
        if "w" in first:
            return lag(model, params, batch, objective)
        first.update(w=params, on=True)
        try:
            return lag(model, params, batch, objective)
        finally:
            first["on"] = False

    ops._StreamingGemm.forward = staticmethod(record)
    S.loss_and_grads = loss_and_grads
    try:
        out = run_first_step()
    finally:
        ops._StreamingGemm.forward = staticmethod(fwd)
        S.loss_and_grads = lag
    leaf = {t.untyped_storage().data_ptr(): p
            for p, t in _paths(first["w"]).items()}
    widths = {}
    for ptr, shape in seen:
        widths.setdefault(leaf.get(ptr, "?"), set()).add(shape)
    return out, {k: sorted(v) for k, v in widths.items()}


def job(rank, cases, units=None, elastic=None):
    """The train ``cases``, then with ``units`` (its keyword arguments)
    the pieces, with ``elastic`` (its keyword arguments) the restore."""
    out = train_cases(rank, cases)
    if units is not None:
        out["units"] = unit_pieces(rank, **units)
    if elastic is not None:
        out["elastic"] = elastic_restore(rank, **elastic)
    return out


def train_cases(rank, cases):
    """The train cases (module docstring)."""
    out = {}
    for name, cfg, shape, params, batches, run_kw in cases:
        res, widths = _recorded(lambda: R.train_against_meshless(
            rank, cfg, shape, params, batches, run_kw))
        if rank == 0:
            res["gemm_widths"] = widths
        out[name] = res
    return out


def unit_pieces(rank, x, parts, table, tokens, logits, labels, vocab_size):
    """Each tensor-parallel piece on a (1, world) mesh, from whole inputs
    every rank holds alike: this rank's block taken, the piece run under
    the mesh context, its output and its block's gradient (of the sum of
    the output times a fixed weight) returned for every rank."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import logical as LG
    from repro_torch.sharding import tensor_parallel as TP
    from repro_torch.sharding.context import mesh_context
    world = dist.get_world_size()
    mesh = make_host_mesh(1, world, device="cpu")
    out = {}
    with mesh_context(mesh, LG.make_rules(False)):
        xi = x.clone().requires_grad_(True)
        y = TP.copy_to_model(xi)
        (y * (rank + 1.0)).sum().backward()
        out["copy"] = (y.detach(), xi.grad)
        pi = parts[rank].clone().requires_grad_(True)
        y = TP.reduce_from_model(pi)
        (y.float() * torch.arange(y.numel()).view(y.shape)).sum().backward()
        out["reduce"] = (y.detach(), pi.grad)
        n = table.shape[0] // world
        block = table[rank * n:(rank + 1) * n].clone().requires_grad_(True)
        e = TP.embedding(block, tokens)
        (e.float() * torch.linspace(-1, 1, e.shape[-1])).sum().backward()
        out["embedding"] = (e.detach(), block.grad)
        n = logits.shape[1] // world
        li = logits[:, rank * n:(rank + 1) * n].clone().requires_grad_(True)
        lse, gold = TP.cross_entropy(li, labels, vocab_size)
        valid = (labels >= 0).float()
        ((lse - gold) * valid).sum().backward()
        out["cross_entropy"] = ((lse.detach(), gold.detach()), li.grad)
    every = [None] * world
    dist.all_gather_object(every, out)
    return every


def elastic_restore(rank, cfg, ckpt_dir):
    """A Trainer on (1, 2) for 4 steps with a checkpoint every 4 (step
    3), then one on (2, 1) that restores it and trains to 8.  Returns
    the losses, the restored state gathered whole, and whether the
    first run's step split its weights over ``model``."""
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.runtime.train_loop import Trainer, TrainerConfig
    from repro_torch.sharding.blocks import gather_tree
    run = RunConfig(model=cfg, shape=ShapeConfig("t", "train", 32, 4),
                    remat="none")
    tc = TrainerConfig(ckpt_dir=ckpt_dir, ckpt_every=4, lr_base=5e-3,
                       lr_warmup=2)

    def trainer(shape):
        return Trainer(run, tc, device="cpu",
                       mesh=make_host_mesh(*shape, device="cpu"))

    tr_a = trainer((1, 2))
    out = {"a": tr_a.train(4), "a_tp": tr_a.built.tensor_parallel}
    tr_b = trainer((2, 1))
    state, out["b_start"] = tr_b.restore_or_init()
    out["b_state"] = gather_tree(T.trainable(state),
                                 T.trainable(tr_b.placement[0]), tr_b.mesh)
    out["b"] = tr_b.train(8)
    return out
