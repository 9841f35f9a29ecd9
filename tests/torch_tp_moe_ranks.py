"""Rank bodies of ``tests/test_torch_tensor_parallel_moe.py``, started by
``torch_mesh_ranks.start`` (gloo ranks on the CPU, ``spawn``).  This
module imports no JAX.

A route (the set of k experts a token takes in a layer) is decided by a
top-k over bf16 logits, and a tensor-parallel step moves a layer's
output by about one bf16 rounding against one rank (``models/moe.py``),
so a token whose k-th and (k+1)-th logits are a near tie can take
another expert set.  ``RouteBook`` records every (step, layer) route of
a run and forces recorded ones on another, so that two runs are held
against each other on the same routes:

- ``moe_case``: the mesh's steps with their own routes (recorded; the
  first one's GEMM operands recorded by the weight leaf they read,
  ``gemm_widths``); the one-rank step of the first batch with its own
  routes, on every rank (recorded, with each token's gap between its
  k-th and (k+1)-th logit); the mesh's step of the first batch forced
  to those routes (the gradient it reduced, read from AdamW's state,
  and its metrics: the ones held against the reference, whose routes
  the one-rank port's follow); on rank 0 the one-rank steps forced to
  the mesh's routes, which every mesh step is held against.
- ``unit_pieces``: ``gather_from_model`` and ``copy_to_model`` of two
  tensors on a (1, world) mesh, forward and gradients of every rank.
- ``elastic_restore``: a ``Trainer`` on (1, 2), where ``model`` splits
  the MoE leaves by expert, checkpoints; one on (2, 1) restores it and
  trains on (row-local dispatch on both).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

import torch_mesh_ranks as R


def _ptr(t) -> int:
    return t.untyped_storage().data_ptr()


def _forced_route(p, x, cfg, top_e):
    """``moe._route`` with the expert ids ``top_e`` given: the same
    logits (gathered over ``model`` where the router is split), softmax,
    weights of the given experts renormalised and aux loss."""
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE
    from repro_torch.sharding import blocks as BL
    from repro_torch.sharding import context as SC
    from repro_torch.sharding import tensor_parallel as TP
    m = cfg.moe
    E, k = m.n_routed_experts, m.top_k
    logits = L._gemm(x, p["router"])
    if TP.parallel(p["router"].shape[1], E):
        logits = TP.gather_from_model(logits)
    probs = torch.softmax(logits.float(), dim=-1)
    top_e = top_e.to(x.device).view(*probs.shape[:-1], k)
    top_p = probs.gather(-1, top_e)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    group = SC.batch_group()
    if group is None:
        me = probs.reshape(-1, E).mean(0)
        ce = MOE._count(top_e, E, torch.float32) / top_e.numel()
    else:
        flat = probs.reshape(-1, E)
        local = flat.sum(0)
        stats = torch.cat([local.detach(),
                           MOE._count(top_e, E, torch.float32),
                           local.new_tensor([flat.shape[0]])])
        BL.all_reduce(stats, group)
        n = stats[-1]
        me = (stats[:E] + (local - local.detach())) / n
        ce = stats[E:2 * E] / (n * k)
    return top_p, top_e, E * torch.sum(me * ce) * m.router_aux_coef


class RouteBook:
    """Patches ``moe._route`` and ``steps.loss_and_grads`` while active.
    ``at(tag, step, force=None)`` names what the next steps do: record
    their routes under (``tag``, ``step``, layer), or with ``force`` a
    tag, take those recorded under (``force``, ``step``, layer), the
    rows of this rank's data block where the batch is split.  The layer
    is the index in ``params["layers"]`` of the router the route reads
    (known from the weights each ``loss_and_grads`` call is handed)."""

    def __init__(self, rows=(0, None)):
        self.routes, self.gaps = {}, {}
        self.tag, self.step, self.force = None, 0, None
        self.rows = rows            # this rank's rows of the whole batch
        self.layers, self.widths, self._first = {}, [], False

    def at(self, tag, step, force=None, widths=False):
        self.tag, self.step, self.force = tag, step, force
        self._first = widths

    def __enter__(self):
        from repro_torch.kernels import ops
        from repro_torch.launch import steps as S
        from repro_torch.models import moe as MOE
        self._saved = (MOE._route, S.loss_and_grads,
                       ops._StreamingGemm.forward, ops._GroupedGemm.forward)
        route, lag, fwd, gfwd = self._saved
        book = self

        def loss_and_grads(model, params, batch, objective=None):
            book.layers = {_ptr(lp["moe"]["router"]): i
                           for i, lp in enumerate(params["layers"])
                           if "moe" in lp}
            book._leaves = {_ptr(t): "/".join(p) for p, t in
                            _flat(params)} if book._first else None
            try:
                return lag(model, params, batch, objective)
            finally:
                book._first = False

        def routed(p, x, cfg):
            key = (book.step, book.layers[_ptr(p["router"])])
            if book.force is not None:
                top_e = book.routes[(book.force,) + key]
                lo, hi = book.rows
                if top_e.shape[0] != x.shape[0]:     # the rank's rows
                    top_e = top_e[lo:hi]
                return _forced_route(p, x, cfg, top_e)
            out = route(p, x, cfg)
            book.routes[(book.tag,) + key] = out[1].detach().clone()
            with torch.no_grad():
                from repro_torch.models import layers as L
                logits = L._gemm(x.detach(), p["router"]).float()
                if logits.shape[-1] == cfg.moe.n_routed_experts:
                    s = logits.sort(-1, descending=True).values
                    k = cfg.moe.top_k
                    book.gaps[(book.tag,) + key] = s[..., k - 1] - s[..., k]
            return out

        def rec(which, f):
            def forward(ctx, a, b, *rest):
                if book._first and book._leaves is not None:
                    book.widths.append((which, book._leaves.get(
                        _ptr(b), "?"), tuple(b.shape)))
                return f(ctx, a, b, *rest)
            return staticmethod(forward)

        MOE._route, S.loss_and_grads = routed, loss_and_grads
        ops._StreamingGemm.forward = rec("gemm", fwd)
        ops._GroupedGemm.forward = rec("grouped", gfwd)
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        from repro_torch.launch import steps as S
        from repro_torch.models import moe as MOE
        route, lag, fwd, gfwd = self._saved
        MOE._route, S.loss_and_grads = route, lag
        ops._StreamingGemm.forward = staticmethod(fwd)
        ops._GroupedGemm.forward = staticmethod(gfwd)


def _flat(tree):
    from repro_torch.checkpoint.checkpoint import _flatten
    return _flatten(tree)


def _whole_routes(book, tag, mesh):
    """{(step, layer): routes of the whole batch} of ``tag`` from every
    data rank's rows (those at model index 0, in data order)."""
    from repro_torch.sharding.blocks import coordinate
    mine = {k[1:]: v for k, v in book.routes.items() if k[0] == tag}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (coordinate(mesh), mine))
    parts = sorted((c.get("data", 0), r) for c, r in every
                   if c.get("model", 0) == 0)
    return {k: torch.cat([r[k] for _, r in parts]) for k in mine}


def moe_case(rank, cfg, shape, params, batches, run_kw):
    """One case (module docstring).  Returns, on rank 0, what
    ``test_torch_mesh._check_run``'s pieces read (``got``, ``want``,
    ``params``, ``meshless``, ``opt0``, ``grad0``, ``sizes``,
    ``tensor_parallel``), the forced mesh step's metrics (``forced0``),
    the routes' differences at the first batch (``flips``: per layer the
    tokens whose expert set the mesh's free step and the one-rank step
    chose differently, and the one-rank logit gaps at them) and the
    first step's ``gemm_widths``; None on the other ranks."""
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.sharding.blocks import coordinate, gather_tree
    run = R._run(cfg, **run_kw)
    mesh = make_host_mesh(*shape, device="cpu")
    built = S.build_train_step(run, mesh, **R.LR)
    w_pl = T.trainable(built.in_shardings[0]["params"])
    n_rows = batches[0]["labels"].shape[0] // shape[0]
    at = coordinate(mesh)["data"] * n_rows
    book = RouteBook(rows=(at, at + n_rows) if shape[0] > 1 else (0, None))
    with book:
        state = S.init_sharded_state(built, R._clone(params))
        got, whole = [], []
        for s, b in enumerate(batches):
            book.at("mesh", s, widths=s == 0)
            state, m = built.fn(state, R._local_batch(b, built))
            got.append({k: float(v) for k, v in m.items()})
            whole.append(R._clone(gather_tree(T.trainable(state["params"]),
                                              w_pl, mesh)))
            if s == 0:
                opt0 = R._clone(gather_tree(
                    state["opt"], built.in_shardings[0]["opt"], mesh))
        mine = (R._bytes(T.trainable(state)),) + R._expected_bytes(built)
        mesh_routes = _whole_routes(book, "mesh", mesh)

        # the first batch: one rank free, then the mesh forced to it
        arun = dataclasses.replace(run, optimizer="adamw")
        book.at("one", 0)
        one, om = S.build_train_step(arun, "cpu", **R.LR)(
            R._meshless_state(arun, R._clone(params)), batches[0])
        one_grad = R._adamw_gradient(one["opt"], float(om["grad_norm"]))
        book.at("forced", 0, force="one")
        abuilt = S.build_train_step(arun, mesh, **R.LR)
        st, fm = abuilt.fn(S.init_sharded_state(abuilt, R._clone(params)),
                           R._local_batch(batches[0], abuilt))
        mesh_grad = R._adamw_gradient(gather_tree(
            st["opt"], abuilt.in_shardings[0]["opt"], mesh),
            float(fm["grad_norm"]))
        sizes = [None] * dist.get_world_size()
        dist.all_gather_object(sizes, mine)
        if rank != 0:
            return None

        # the one-rank steps on the mesh's routes
        book.routes.update({("mesh",) + k: v for k, v in
                            mesh_routes.items()})
        book.rows = (0, None)
        step = S.build_train_step(run, "cpu", **R.LR)
        ref_state = R._meshless_state(run, R._clone(params))
        want, meshless = [], []
        for s, b in enumerate(batches):
            book.at("witness", s, force="mesh")
            ref_state, m = step(ref_state, b)
            want.append({k: float(v) for k, v in m.items()})
            meshless.append(R._clone(T.trainable(ref_state["params"])))
    flips = {}
    for (s, layer), e in mesh_routes.items():
        if s != 0:
            continue
        one_e = book.routes[("one", 0, layer)]
        differ = (e.sort(-1).values != one_e.sort(-1).values).any(-1)
        flips[layer] = (int(differ.sum()), differ.numel(),
                        book.gaps[("one", 0, layer)][differ].tolist())
    return {"got": got, "want": want, "sizes": sizes, "params": whole,
            "meshless": meshless, "opt0": opt0,
            "grad0": (mesh_grad, one_grad),
            "forced0": {k: float(v) for k, v in fm.items()},
            "tensor_parallel": built.tensor_parallel, "flips": flips,
            "gemm_widths": book.widths}


def job(rank, cases, units=None, elastic=None):
    """The ``cases``, then with ``units`` (its keyword arguments) the
    pieces, with ``elastic`` (its keyword arguments) the restore."""
    out = {name: moe_case(rank, cfg, shape, params, batches, run_kw)
           for name, cfg, shape, params, batches, run_kw in cases}
    if units is not None:
        out["units"] = unit_pieces(rank, **units)
    if elastic is not None:
        out["elastic"] = elastic_restore(rank, **elastic)
    return out


def unit_pieces(rank, logits, weight, a, b):
    """``gather_from_model`` of the rank's column block of the whole
    (n, E) ``logits`` (every rank holds them alike) under a softmax
    weighted by ``weight``, and ``copy_to_model(a, b)`` weighted by
    rank + 1: outputs and the blocks' gradients of every rank, and the
    collectives each recorded."""
    from repro_torch.launch import hlo_analysis as HA
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import logical as LG
    from repro_torch.sharding import tensor_parallel as TP
    from repro_torch.sharding.context import mesh_context
    world = dist.get_world_size()
    mesh = make_host_mesh(1, world, device="cpu")
    seen, orig = [], HA.collective

    def record(op, nbytes, size):
        seen.append((op, nbytes, size))

    HA.collective = record
    try:
        with mesh_context(mesh, LG.make_rules(False)):
            n = logits.shape[1] // world
            block = logits[:, rank * n:(rank + 1) * n].clone() \
                .requires_grad_(True)
            y = TP.gather_from_model(block)
            (torch.softmax(y.float(), -1) * weight).sum().backward()
            out = {"gather": (y.detach(), block.grad)}
            ai, bi = (t.clone().requires_grad_(True) for t in (a, b))
            ya, yb = TP.copy_to_model(ai, bi)
            ((ya.float() * (rank + 1.0)).sum()
             + (yb.float() * (rank + 1.0)).sum()).backward()
            out["copy2"] = ((ya.detach(), yb.detach()), (ai.grad, bi.grad))
    finally:
        HA.collective = orig
    out["collectives"] = seen
    every = [None] * world
    dist.all_gather_object(every, out)
    return every


def elastic_restore(rank, cfg, ckpt_dir):
    """A Trainer on (1, 2) for 4 steps with a checkpoint every 4 (step
    3), then one on (2, 1) that restores it and trains to 8, row-local
    dispatch on both.  Returns the losses, the restored state gathered
    whole, and the first run's ``model`` extent."""
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.runtime.train_loop import Trainer, TrainerConfig
    from repro_torch.sharding.blocks import gather_tree
    run = RunConfig(model=cfg, shape=ShapeConfig("t", "train", 32, 4),
                    remat="none", moe_local_dispatch=True)
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
