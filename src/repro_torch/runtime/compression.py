"""Gradient compression: INT8 per-tensor quantization with error
feedback, the reference's ``init_ef`` / ``compress`` / ``decompress`` /
``apply_compression``.

The quantization residual is carried to the next step, so compression
introduces no asymptotic bias (Karimireddy et al., 2019).  Each
tensor's scale is max|x| / 127 + 1e-12 over the reference's leaf, which
for a layer stack is the whole stack (``optim.optimizers.stacked``):
the port takes one scale per stacked group of per-layer tensors, so its
int8 codes equal the reference's.  ``torch.round`` rounds half to even,
as ``jnp.round`` does.

``compressed_psum(x, axis, mesh)`` is the reference's hand-scheduled
int8 all-reduce over a named mesh axis: each rank quantizes its tensor
with its own scale (``_q``), the int8 codes are summed as int32 and the
scales reduced by max over the axis's ranks, and the result is the
summed codes times the largest scale.  The codes are widened to int32
before the sum, as the reference's ``psum`` widens them (an int8 sum
would overflow), so the wire carries four bytes a value, not one.  Over
an axis of one rank no collective runs: the sum is the rank's own
codes times its scale.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.models.params import tree_map
from repro_torch.optim.optimizers import stacked, stacked_map
from repro_torch.sharding.blocks import all_reduce, axis_group


def init_ef(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _scale(leaf) -> torch.Tensor:
    parts = leaf if isinstance(leaf, tuple) else (leaf,)
    return torch.stack([x.abs().max() for x in parts]).max() / 127.0 + 1e-12


def _per_leaf(scales, like):
    """The ``stacked`` tree of scales spread over ``like``'s structure:
    each layer of a stack gets its stack's scale."""
    if isinstance(like, dict):
        return {k: _per_leaf(scales[k], like[k]) for k in like}
    if isinstance(like, list):
        return [_per_leaf(scales, lp) for lp in like]
    return scales


def compress(grads, ef):
    """-> (int8 codes, scales, new error feedback).  Codes and error
    feedback are congruent with ``grads``; ``scales`` holds one float32
    scalar per reference leaf, in the ``stacked`` structure (one per
    layer stack and leaf path)."""
    x = tree_map(lambda g, e: g.float() + e, grads, ef)
    scales = stacked_map(_scale, stacked(x))
    s = _per_leaf(scales, x)
    codes = tree_map(lambda x, s: torch.clamp(torch.round(x / s), -127,
                                              127).to(torch.int8), x, s)
    new_ef = tree_map(lambda x, q, s: x - q.float() * s, x, codes, s)
    return codes, scales, new_ef


def decompress(qs, scales):
    """Codes times their scale, float32, congruent with the codes."""
    return tree_map(lambda q, s: q.float() * s, qs, _per_leaf(scales, qs))


def apply_compression(grads, ef):
    """The round trip: (dequantized gradients, new error feedback), the
    gradients being exactly what another worker would receive."""
    qs, scales, new_ef = compress(grads, ef)
    return decompress(qs, scales), new_ef


def _q(x):
    """(int8 codes, scale) of one tensor, the reference's ``_q``: scale =
    max|x| / 127 + 1e-12, codes round(x / scale) clipped to +-127."""
    scale = x.abs().max() / 127.0 + 1e-12
    return torch.clamp(torch.round(x / scale), -127, 127) \
        .to(torch.int8), scale


def compressed_psum(x, axis, mesh):
    """The int8-compressed sum of ``x`` over the ranks of the mesh axis
    ``axis`` (a name or a tuple of names; module docstring), float32,
    the same on every rank of the axis.  Every rank of the axis must
    call it."""
    group = axis_group(mesh, axis)
    q, scale = _q(x.float())
    qsum = q.to(torch.int32)
    smax = scale.reshape(1).clone()
    if group is not None:
        all_reduce(qsum, group)
        all_reduce(smax, group, op=dist.ReduceOp.MAX)
    return qsum.float() * smax[0]
