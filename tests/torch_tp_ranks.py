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
- ``gather_and_sum_pieces``: the sum-then-slice gather
  (``copy_to_model(gather_from_model(y))``) and the two-way sum
  (``copy_to_model(reduce_from_model(s))``) on a (1, world) mesh, each
  rank reading its own part of the result (``tests/
  test_torch_tensor_parallel_ssm.py``).
- ``cross_pieces``: the cross-attention over given K/V with its query
  heads split, with and without ``copy_to_model`` on its input
  (``tests/test_torch_tensor_parallel_audio.py``).
- ``layer_pieces``: an RWKV6 time and channel mix or a Mamba2 block in
  fp32 on a (1, world) mesh over the rank's blocks of its leaves,
  against the whole layer on one rank.

``job`` runs the train cases, then the others where it is given their
inputs; ``family_job`` the train cases, then the piece it names.
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


def family_job(rank, cases, pieces=(), elastic=None):
    """The train ``cases``; then each of ``pieces`` (the name of a
    function of this module and its keyword arguments), its result under
    ``"pieces"`` by name; with ``elastic`` the restore."""
    out = train_cases(rank, cases)
    if pieces:
        out["pieces"] = {name: globals()[name](rank, **kw)
                         for name, kw in pieces}
    if elastic is not None:
        out["elastic"] = elastic_restore(rank, **elastic)
    return out


def _on_model_mesh(fn):
    """``fn()`` on a (1, world) CPU mesh's context, every collective it
    records kept: (its result, [(op, bytes, group size)])."""
    from repro_torch.launch import hlo_analysis as HA
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import logical as LG
    from repro_torch.sharding.context import mesh_context
    mesh = make_host_mesh(1, dist.get_world_size(), device="cpu")
    seen, orig = [], HA.collective

    def record(op, nbytes, size):
        seen.append((op, nbytes, size))

    HA.collective = record
    try:
        with mesh_context(mesh, LG.make_rules(False)):
            return fn(), seen
    finally:
        HA.collective = orig


def gather_and_sum_pieces(rank, y, weights, s, c):
    """On a (1, world) mesh: rank r gathers its column block of ``y`` (n,
    m x b) whole through ``copy_to_model(gather_from_model(.))`` and
    reads the columns ``weights[r]`` is not zero at, summing the product
    (each rank a different part: its gradient of the whole a share);
    then ``copy_to_model(reduce_from_model(s[r]))`` of its (n, 1) fp32
    ``s[r]``, read times ``c[r]``.  Returns, for every rank, the gathered
    value, its block's gradient and the gather's collectives, then the
    sum, its dtype, ``s[r]``'s gradient and the sum's collectives."""
    from repro_torch.sharding import tensor_parallel as TP
    world = dist.get_world_size()
    n = y.shape[1] // world

    def gather():
        block = y[:, rank * n:(rank + 1) * n].clone().requires_grad_(True)
        z = TP.copy_to_model(TP.gather_from_model(block))
        (z.float() * weights[rank]).sum().backward()
        return z.detach(), block.grad

    def two_way():
        si = s[rank].clone().requires_grad_(True)
        t = TP.copy_to_model(TP.reduce_from_model(si))
        (t * c[rank]).sum().backward()
        return t.detach(), t.dtype, si.grad

    out = {"gather": _on_model_mesh(gather), "sum": _on_model_mesh(two_way)}
    every = [None] * world
    dist.all_gather_object(every, out)
    return every


def cross_pieces(rank, cfg, params, x, k, v, weight):
    """Whisper's cross-attention (``layers.attention_train_chunked`` with
    ``kv``, non-causal) on a (1, world) mesh over the rank's query heads
    (its blocks of ``params``' ``wq`` and ``wo``, and of the given K/V),
    the output summed against ``weight``: x's gradient, as the layer
    runs and with ``copy_to_model`` made the identity (as if q read x
    without it), and the output; on rank 0 too the whole layer's on one
    rank."""
    from repro_torch.models import layers as L
    from repro_torch.sharding import tensor_parallel as TP
    world = dist.get_world_size()
    H = cfg.n_heads
    n = H // world
    heads = slice(rank * n, (rank + 1) * n)
    local = {"wq": params["wq"][:, heads], "wo": params["wo"][heads]}
    T = x.shape[1]
    pos = torch.arange(T).expand(x.shape[0], T)

    def run(p, kv):
        xi = x.clone().requires_grad_(True)
        out = L.attention_train_chunked(p, xi, cfg, pos, causal=False,
                                        kv=kv)
        (out.float() * weight).sum().backward()
        return out.detach(), xi.grad

    kv = (k[:, :, heads], v[:, :, heads])
    got = _on_model_mesh(lambda: run(local, kv))[0]
    copy = TP.copy_to_model
    TP.copy_to_model = lambda *xs: xs[0] if len(xs) == 1 else xs
    try:
        without = _on_model_mesh(lambda: run(local, kv))[0]
    finally:
        TP.copy_to_model = copy
    out = {"split": got, "without_copy": without}
    if rank == 0:
        out["whole"] = run(params, (k, v))
    every = [None] * world
    dist.all_gather_object(every, out)
    return every


def _local_leaves(tree, specs, mesh):
    """The rank's blocks of the whole leaves ``tree`` (a dict) under the
    placements of the ``PSpec``s ``specs`` on ``mesh``."""
    from repro_torch.sharding import blocks as BL
    from repro_torch.sharding import logical as LG
    ms = BL.mesh_shape_dict(mesh)
    rules = LG.make_rules(False)
    return {k: BL.local_slice(v, LG.spec_for(specs[k].axes, tuple(v.shape),
                                             rules, ms), mesh).clone()
            for k, v in tree.items()}


def layer_pieces(rank, cases):
    """Each (name, cfg, whole fp32 leaves, x, weight) case, an RWKV6
    layer's time and channel mix (the ssm family) or a Mamba2 block, on
    a (1, world) mesh over the rank's blocks of the leaves (their
    placements': ``ssm.rwkv_pspecs`` / ``mamba2_pspecs``) from a zero
    state, the output summed against ``weight``; and the whole layer on
    one rank (no mesh).  Returns, for every rank, both runs' output, x's
    gradient and the rank's blocks of the leaves' gradients."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import ssm as SSM
    world = dist.get_world_size()
    mesh = make_host_mesh(1, world, device="cpu")

    def run(cfg, leaves, x, weight):
        leaves = {k: {n: t.clone().requires_grad_(True)
                      for n, t in v.items()} for k, v in leaves.items()}
        xi = x.clone().requires_grad_(True)
        B = x.shape[0]
        if cfg.family == "ssm":
            st = SSM.init_rwkv_state(cfg, B, x.dtype)
            y, _ = SSM.rwkv_time_mix(leaves["time"], xi, cfg, st["time"])
            c, _ = SSM.rwkv_channel_mix(leaves["channel"], xi,
                                        st["channel_shift"], cfg)
            y = y + c
        else:
            y, _ = SSM.mamba2_forward(leaves["mamba"], xi, cfg,
                                      SSM.init_mamba_state(cfg, B, x.dtype))
        (y * weight).sum().backward()
        return y.detach(), xi.grad, {k: {n: t.grad for n, t in v.items()}
                                     for k, v in leaves.items()}

    out = {}
    for name, cfg, leaves, x, weight in cases:
        specs = SSM.rwkv_pspecs(cfg) if cfg.family == "ssm" else \
            {"mamba": SSM.mamba2_pspecs(cfg)}

        def blocks(tree):
            return {k: _local_leaves(v, specs[k], mesh)
                    for k, v in tree.items()}

        got = _on_model_mesh(lambda: run(cfg, blocks(leaves), x, weight))[0]
        y, gx, grads = run(cfg, leaves, x, weight)
        out[name] = {"split": got, "whole": (y, gx, blocks(grads))}
    every = [None] * world
    dist.all_gather_object(every, out)
    return every
