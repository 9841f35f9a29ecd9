"""The mesh context model code reads: ``shard(x, axes)`` names an
activation's logical axes under the active mesh, without threading the
mesh and its rules through every function signature, as in the
reference.

The reference's ``shard`` constrains the activation's layout for
GSPMD.  This port splits no activation across ranks: every rank of a
mesh runs the whole model on its rows of the batch (the batch is split
by the data loader, not inside the model), so ``shard`` resolves the
spec, checks the rank of ``x`` against ``axes`` and returns ``x``
itself.  Outside a context it is a no-op, as in the reference.

``batch_group()`` is what the port adds: the process group over which
the active train step splits the batch rows (None when the rows are
not split over more than one rank).  The MoE load-balancing loss
reads it to take its means over the whole batch.  ``model_group()``
and ``model_index()`` are the ``model`` axis's group and this rank's
coordinate on it, which the tensor-parallel layers
(``sharding.tensor_parallel``) reduce over and take their blocks by.
"""
from __future__ import annotations

import contextlib
import threading

from repro_torch.sharding import logical as LG
from repro_torch.sharding.blocks import axis_group, coordinate, \
    mesh_shape_dict

_STATE = threading.local()


def current():
    """(mesh, rules, mesh shape dict, batch group) of the active
    context, or None."""
    return getattr(_STATE, "ctx", None)


@contextlib.contextmanager
def mesh_context(mesh, rules, batch_group=None):
    """Activate ``mesh`` and its logical ``rules``; ``batch_group`` is the
    process group over which the step splits the batch rows (None: not
    split)."""
    prev = current()
    _STATE.ctx = (mesh, rules, mesh_shape_dict(mesh), batch_group)
    try:
        yield
    finally:
        _STATE.ctx = prev


def shard(x, axes):
    """``x`` under the logical ``axes`` of the active mesh context: the
    spec is resolved (``len(axes)`` must equal ``x.ndim``) and ``x`` is
    returned as it is, since no activation is split across ranks
    (module docstring).  A no-op without a context."""
    ctx = current()
    if ctx is None:
        return x
    if len(axes) != x.ndim:
        raise ValueError(f"shard: axes {tuple(axes)} for a tensor of rank "
                         f"{x.ndim}")
    _, rules, ms, _ = ctx
    LG.spec_for(axes, tuple(x.shape), rules, ms)
    return x


def batch_group():
    """The process group of the active step's batch split when it spans
    more than one rank, else None."""
    ctx = current()
    return None if ctx is None else ctx[3]


def model_group():
    """The active mesh's ``model`` group when ``model`` spans more than
    one rank, else None (``blocks.axis_group``: made at the first call,
    which every rank of the mesh makes, by the first layer ``model``
    splits)."""
    ctx = current()
    if ctx is None or "model" not in ctx[2]:
        return None
    return axis_group(ctx[0], "model")


def model_index() -> int:
    """This rank's coordinate on ``model`` (0 outside a context)."""
    ctx = current()
    if ctx is None or ctx[2].get("model", 1) == 1:
        return 0
    return coordinate(ctx[0])["model"]
