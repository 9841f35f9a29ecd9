"""Meshes: the reference's ``launch/mesh.py``.

``make_host_mesh`` builds a ``torch.distributed.device_mesh.DeviceMesh``
with the reference's axis names, ``("data", "model")`` or ``("pod",
"data", "model")``, over the ranks of the process group: NCCL on the
card (the default), gloo with ``device="cpu"``.  A one-rank mesh makes
its own process group when the process has none (an in-process
``HashStore``); a mesh of more ranks needs the group its ranks started
(``torch.distributed.init_process_group`` with an address, a world size
and a rank), whose world size must equal the mesh's rank count.  NCCL
cannot put two ranks on one card, so a one-card machine runs a one-rank
mesh; meshes of more ranks run on the CPU through gloo.  ``backend=
"gloo"`` on the card is the one exception: several processes sharing
one card, their collectives staged through the host (a correctness
check of tensor parallelism on one card, not a speed figure).

``make_production_mesh`` is a plan only (``sharding.blocks.MeshPlan``):
the reference's (16, 16) and (2, 16, 16) shapes and axis names, with no
process group, for placements and per-rank byte counts.  How a leaf
lies on a mesh is ``sharding.blocks``.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.sharding.blocks import MeshPlan, mesh_shape_dict  # noqa: F401


def make_production_mesh(multi_pod: bool = False) -> MeshPlan:
    """The reference's production mesh as a plan: (16, 16) = 256 ranks
    over ("data", "model"), or (2, 16, 16) = 512 over ("pod", "data",
    "model")."""
    if multi_pod:
        return MeshPlan((2, 16, 16), ("pod", "data", "model"))
    return MeshPlan((16, 16), ("data", "model"))


def make_host_mesh(data: int = 1, model: int = 1, pod: int = 0,
                   device="cuda", backend=None):
    """A ``DeviceMesh`` of (pod,) data x model ranks on ``device``'s
    backend (module docstring): ``backend`` None takes NCCL on the card
    and gloo on the CPU; ``"gloo"`` takes gloo on either.  Raises
    without a card unless ``device="cpu"``, and when the process group's
    world size is not the mesh's rank count."""
    dev = resolve_device(device)
    shape, names = ((pod, data, model), ("pod", "data", "model")) if pod \
        else ((data, model), ("data", "model"))
    n = math.prod(shape)
    if backend not in (None, "gloo"):
        raise ValueError(f"backend {backend!r}: None or 'gloo'")
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(
                f"a mesh of {n} ranks needs a process group of {n} ranks: "
                "call torch.distributed.init_process_group in each rank "
                "first")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    if dist.get_world_size() != n:
        raise ValueError(f"a {shape} mesh has {n} ranks; the process group "
                         f"has {dist.get_world_size()}")
    if backend not in dist.get_backend():
        raise ValueError(f"a mesh on {dev.type} runs through {backend}; the "
                         f"process group's backend is {dist.get_backend()}")
    if dev.type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(dev.type, torch.arange(n).reshape(shape),
                      mesh_dim_names=names)
