"""How a leaf lies on a mesh: its blocks, the ranks that hold them, and
the process groups of the mesh's axes.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` (``launch.mesh.
make_host_mesh``: ranks behind it) or a ``MeshPlan`` (a shape and axis
names, with no process group).  A plan of more than one rank is for
placements and byte counts, and for a dry run of its rank 0 on ``meta``
tensors (``launch.dryrun``): its blocks, and each collective recorded by
the cost counter (``launch.hlo_analysis``) over a ``PlanGroup`` of the
size the plan's axes give, its result a ``meta`` tensor of the gathered
or reduced shape, with no process group; real tensors on such a plan
raise.  A plan of one rank (``ONE_RANK``) is local: it runs in this
process with no process group, nothing split and no collective, and is
what a step built without a mesh runs on.

A leaf's placement is ``sharding.logical.spec_for``'s tuple: per dim
None, a mesh axis name, or a tuple of names (the first the major).  A
rank holds the block of each dim at its coordinates on those axes
(``local_slice``); ``gather`` rebuilds whole leaves from every rank's
blocks with one ``all_gather`` of their bytes.  A leaf that a placement
splits over no axis of more than one rank is whole on every rank, and
``gather`` returns it as it is.  Both take the axes to work over
(default: every axis of the mesh): ``gather(..., axes=("data",))``
undoes only a leaf's split over ``data``, through the group of the
ranks that share this rank's other coordinates, and hands back the
rank's block over the rest (its ``model`` block, which a
tensor-parallel layer reads).  Every collective goes through
``all_reduce`` or ``gather``, which record it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import torch
import torch.distributed as dist

from repro_torch.launch import hlo_analysis as HA
from repro_torch.models.params import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """A mesh that exists only as a plan: its shape and axis names."""
    shape: tuple
    axis_names: tuple

    @property
    def size(self) -> int:
        return math.prod(self.shape)


ONE_RANK = MeshPlan((1, 1), ("data", "model"))


@dataclasses.dataclass(frozen=True)
class PlanGroup:
    """The ranks a collective over a plan's axes spans, with no process
    group behind them: a collective over it is recorded and moves
    nothing."""
    size: int


def group_size(group) -> int:
    return group.size if isinstance(group, PlanGroup) \
        else dist.get_world_size(group)


def all_reduce(t, group, op=dist.ReduceOp.SUM):
    """``t`` summed (or reduced by ``op``) in place over ``group``'s ranks
    (``dist.all_reduce``; nothing moves over a ``PlanGroup``), recorded
    as one all-reduce of ``t``'s bytes.  Every rank of the group must
    call it."""
    HA.collective("all-reduce", t.numel() * t.element_size(),
                  group_size(group))
    if not isinstance(group, PlanGroup):
        dist.all_reduce(t, op=op, group=group)
    return t


def mesh_shape_dict(mesh) -> dict:
    """{axis name: extent} of a ``DeviceMesh``, a ``MeshPlan`` or a
    mapping of the same."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    if isinstance(mesh, MeshPlan):
        return dict(zip(mesh.axis_names, mesh.shape))
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def is_live(mesh) -> bool:
    """True for a mesh with ranks behind it (not a plan or a mapping)."""
    return not isinstance(mesh, (MeshPlan, Mapping))


def is_local(mesh) -> bool:
    """True for a plan of one rank, which runs in this process."""
    return isinstance(mesh, MeshPlan) and mesh.size == 1


def require_runnable(mesh, what: str, tensor=None) -> None:
    """Raise for a plan of more than one rank (or a mapping), unless
    ``tensor`` lies on ``meta``: a dry run of the plan's rank 0."""
    if tensor is not None and tensor.is_meta and isinstance(mesh, MeshPlan):
        return
    if not (is_live(mesh) or is_local(mesh)):
        ms = mesh_shape_dict(mesh)
        raise ValueError(
            f"{what}: {ms} is a plan with no ranks behind it "
            f"({math.prod(ms.values())} needed; this process group has "
            f"{dist.get_world_size() if dist.is_initialized() else 0})")


def mesh_rank(mesh) -> int:
    """This process's rank on a live mesh; 0 on a local one."""
    return dist.get_rank() if is_live(mesh) else 0


def barrier(mesh) -> None:
    """A barrier over a live mesh of more than one rank; else nothing."""
    if is_live(mesh) and mesh.mesh.numel() > 1:
        dist.barrier()


def coordinate(mesh, rank=None) -> dict:
    """{axis name: index} of ``rank`` (default: this process's) on a live
    mesh, or on a plan (default rank 0; ranks in row-major order)."""
    if not is_live(mesh):
        ms, at = mesh_shape_dict(mesh), {}
        rank = rank or 0
        for a in reversed(ms):
            rank, at[a] = divmod(rank, ms[a])
        return {a: at[a] for a in ms}
    rank = dist.get_rank() if rank is None else rank
    at = (mesh.mesh == rank).nonzero()
    if len(at) != 1:
        raise ValueError(f"rank {rank} is not on the mesh")
    return dict(zip(mesh.mesh_dim_names, at[0].tolist()))


def axis_group(mesh, axes):
    """The process group of the ranks that share this rank's
    coordinates on every axis not in ``axes`` (the group a collective
    over ``axes`` runs on), or None when ``axes`` span one rank, where a
    collective over them is the identity and none is made.  The groups
    are made for every such set of ranks at the first call, which every
    rank must make, and cached on the mesh."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    ms = mesh_shape_dict(mesh)
    unknown = [a for a in axes if a not in ms]
    if unknown:
        raise ValueError(f"no axis {unknown} on a mesh of {tuple(ms)}")
    if math.prod(ms[a] for a in axes) == 1:
        return None
    if not is_live(mesh):
        return PlanGroup(math.prod(ms[a] for a in axes))
    cache = mesh.__dict__.setdefault("_axis_groups", {})
    if axes not in cache:
        ranks = mesh.mesh.permute(
            [i for i, a in enumerate(ms) if a not in axes]
            + [i for i, a in enumerate(ms) if a in axes])
        ranks = ranks.reshape(-1, math.prod(ms[a] for a in axes))
        mine = None
        for row in ranks.tolist():
            g = dist.new_group(row)
            if dist.get_rank() in row:
                mine = g
        cache[axes] = mine
    return cache[axes]


# --------------------------------------------------------------- leaves
def dim_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def restrict(spec, axes) -> tuple:
    """``spec`` with only the mesh ``axes`` kept (None keeps every axis):
    the split that working over ``axes`` undoes or makes.  A dim split
    over kept and dropped axes must name the dropped ones first (the
    major ones), so that the rank's block over them is one run."""
    if axes is None:
        return tuple(spec)
    out = []
    for e in spec:
        names = dim_axes(e)
        kept = tuple(a for a in names if a in axes)
        if kept and names[len(names) - len(kept):] != kept:
            raise ValueError(f"spec {spec}: axes {axes} are not the minor "
                             f"ones of {e}")
        out.append(None if not kept else kept[0] if len(kept) == 1
                   else kept)
    return tuple(out)


def splits(spec, ms) -> bool:
    """True when ``spec`` splits some dim over more than one rank."""
    return any(ms[a] > 1 for e in spec for a in dim_axes(e))


def local_shape(spec, shape, ms) -> tuple:
    """The shape of one rank's block of a leaf of ``shape``."""
    return tuple(n // math.prod(ms[a] for a in dim_axes(e))
                 for e, n in zip(spec, shape))


def _block(spec, shape, ms, coord) -> tuple:
    """The slices of the block a rank at ``coord`` holds."""
    out = []
    for e, n in zip(spec, shape):
        i, k = 0, 1
        for a in dim_axes(e):
            i, k = i * ms[a] + coord[a], k * ms[a]
        out.append(slice(i * (n // k), (i + 1) * (n // k)))
    return tuple(out)


def local_slice(t, spec, mesh, rank=None, axes=None):
    """This rank's block over ``axes`` (default: all) of the leaf ``t``,
    whole over them (a view; numpy arrays too)."""
    ms = mesh_shape_dict(mesh)
    spec = restrict(spec, axes)
    if not splits(spec, ms):
        return t
    return t[_block(spec, tuple(t.shape), ms, coordinate(mesh, rank))]


def gather(leaves, specs, mesh, axes=None) -> list:
    """Leaves whole over ``axes`` (default: every axis of the mesh) from
    each rank's blocks ``leaves`` under ``specs`` (lists, in one order on
    every rank): one ``all_gather`` of the split leaves' bytes over the
    ranks that share this rank's coordinates off ``axes`` into an
    (ranks, bytes) buffer (recorded; on a plan nothing moves), then each
    leaf's blocks put in their places by one copy, from the ranks at
    index 0 of the axes its placement does not use (the others hold
    replicas).  A leaf that is not split over ``axes`` is returned as it
    is.  Every rank must call it."""
    ms = mesh_shape_dict(mesh)
    whole = axes is None or set(axes) >= set(ms)
    sub = {a: n for a, n in ms.items() if whole or a in axes}
    specs = [restrict(s, None if whole else axes) for s in specs]
    split = [i for i, s in enumerate(specs) if splits(s, ms)]
    out = list(leaves)
    if not split:
        return out
    flat = [leaves[i].contiguous().view(-1).view(torch.uint8) for i in split]
    buf = torch.cat(flat)
    n = math.prod(sub.values())
    parts = buf.new_empty((n, buf.numel()))
    HA.collective("all-gather", parts.numel(), n)
    if is_live(mesh):
        group = None if whole else axis_group(mesh, tuple(sub))
        dist.all_gather(list(parts.unbind(0)), buf, group=group)
    at = 0
    for i, f in zip(split, flat):
        local = leaves[i]
        # bytes: the last dim counted in bytes, so one view fits every
        # dtype wherever its bytes start in the buffer
        shape = (*local.shape[:-1], local.shape[-1] * local.element_size())
        blocks = parts[:, at:at + f.numel()].view(*sub.values(), *shape)
        out[i] = _assemble(blocks, specs[i], sub).view(local.dtype)
        at += f.numel()
    return out


def _assemble(blocks, spec, ms):
    """The whole leaf from ``blocks`` (the mesh's dims, then one block's):
    index 0 on the axes ``spec`` does not use, then each dim of the leaf
    after the axes that split it, major first, in one copy."""
    names = list(ms)
    used = [a for a in names if any(a in dim_axes(e) for e in spec)]
    blocks = blocks[tuple(slice(None) if a in used else 0 for a in names)]
    order, shape = [], []
    for d, e in enumerate(spec):
        order += [used.index(a) for a in dim_axes(e)]
        order.append(len(used) + d)
        shape.append(blocks.shape[len(used) + d]
                     * math.prod(ms[a] for a in dim_axes(e)))
    return blocks.permute(order).reshape(shape).contiguous()


# ---------------------------------------------------------------- trees
def shard_tree(tree, placement, mesh):
    """Each rank's blocks of the whole leaves of ``tree`` (copies where a
    placement splits the leaf, the leaf itself where none does), in the
    placement's key order (the optimizers pair leaves by order)."""
    ms = mesh_shape_dict(mesh)
    return tree_map(lambda spec, t: local_slice(t, spec, mesh).clone()
                    if splits(spec, ms) else t, placement, tree)


def gather_tree(tree, placement, mesh, axes=None):
    """Leaves whole over ``axes`` from every rank's blocks of ``tree``
    (``gather``)."""
    it = iter(gather(tree_leaves(tree), tree_leaves_of(placement, tree),
                     mesh, axes))
    return tree_map(lambda _: next(it), tree)


def tree_leaves_of(placement, like) -> list:
    """The spec tuples of ``placement`` at ``like``'s leaves, in order."""
    out = []
    tree_map(lambda _, spec: out.append(spec), like, placement)
    return out


def local_zeros(abstract, placement, mesh, device):
    """Zeros of each rank's block shape of every leaf of ``abstract``."""
    ms = mesh_shape_dict(mesh)
    return tree_map(lambda a, spec: torch.zeros(
        local_shape(spec, tuple(a.shape), ms), dtype=a.dtype,
        device=device), abstract, placement)
