"""How a leaf lies on a mesh: its blocks, the ranks that hold them, and
the process groups of the mesh's axes.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` (``launch.mesh.
make_host_mesh``: ranks behind it) or a ``MeshPlan`` (a shape and axis
names, with no process group).  A plan of more than one rank is only
for placements and byte counts.  A plan of one rank (``ONE_RANK``) is
local: it runs in this process with no process group, nothing split and
no collective, and is what a step built without a mesh runs on.

A leaf's placement is ``sharding.logical.spec_for``'s tuple: per dim
None, a mesh axis name, or a tuple of names (the first the major).  A
rank holds the block of each dim at its coordinates on those axes
(``local_slice``); ``gather`` rebuilds whole leaves from every rank's
blocks with one ``all_gather`` of their bytes.  A leaf that a placement
splits over no axis of more than one rank is whole on every rank, and
``gather`` returns it as it is.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import torch
import torch.distributed as dist

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


def require_runnable(mesh, what: str) -> None:
    """Raise for a plan of more than one rank (or a mapping)."""
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
    mesh."""
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


def local_slice(t, spec, mesh, rank=None):
    """This rank's block of the whole leaf ``t`` (a view; numpy arrays
    too)."""
    ms = mesh_shape_dict(mesh)
    if not splits(spec, ms):
        return t
    return t[_block(spec, tuple(t.shape), ms, coordinate(mesh, rank))]


def whole_shape(spec, shape, ms) -> tuple:
    """The shape of the whole leaf of which a block has ``shape``."""
    return tuple(n * math.prod(ms[a] for a in dim_axes(e))
                 for e, n in zip(spec, shape))


def gather(leaves, specs, mesh) -> list:
    """Whole leaves from each rank's blocks ``leaves`` under ``specs``
    (lists, in one order on every rank): one ``all_gather`` of
    the split leaves' bytes over the mesh, each block then copied to its
    place from one rank of the ranks that hold it.  A leaf that is not
    split is returned as it is.  Every rank must call it."""
    ms = mesh_shape_dict(mesh)
    split = [i for i, s in enumerate(specs) if splits(s, ms)]
    out = list(leaves)
    if not split:
        return out
    flat = [leaves[i].contiguous().view(-1).view(torch.uint8) for i in split]
    buf = torch.cat(flat)
    n = mesh.mesh.numel()
    parts = [torch.empty_like(buf) for _ in range(n)]
    dist.all_gather(parts, buf)
    coords = [coordinate(mesh, r) for r in range(n)]
    at = 0
    for i, f in zip(split, flat):
        spec, local = specs[i], leaves[i]
        shape = whole_shape(spec, tuple(local.shape), ms)
        used = {a for e in spec for a in dim_axes(e)}
        whole = torch.empty(shape, dtype=local.dtype, device=local.device)
        for r, c in enumerate(coords):
            if any(c[a] for a in ms if a not in used):
                continue        # a replica of a block another rank gives
            whole[_block(spec, shape, ms, c)] = parts[r][at:at + f.numel()] \
                .view(local.dtype).view(local.shape)
        out[i] = whole
        at += f.numel()
    return out


# ---------------------------------------------------------------- trees
def shard_tree(tree, placement, mesh):
    """Each rank's blocks of the whole leaves of ``tree`` (copies where a
    placement splits the leaf, the leaf itself where none does), in the
    placement's key order (the optimizers pair leaves by order)."""
    ms = mesh_shape_dict(mesh)
    return tree_map(lambda spec, t: local_slice(t, spec, mesh).clone()
                    if splits(spec, ms) else t, placement, tree)


def gather_tree(tree, placement, mesh):
    """Whole leaves from every rank's blocks of ``tree`` (``gather``)."""
    it = iter(gather(tree_leaves(tree), tree_leaves_of(placement, tree),
                     mesh))
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
