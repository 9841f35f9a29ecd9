"""Parameter declaration, initialisation, and the bridge from the
reference's parameter pytree.

Modules declare a tree (dicts and lists) of ``PSpec`` leaves (shape +
logical axes + init law), as in the reference.  The port keeps the
reference's per-layer leaf shapes but holds the layer stack as a Python
list of per-layer trees instead of one leading ``L`` axis, since the
forward pass is an eager Python loop rather than ``lax.scan``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class PSpec:
    shape: tuple
    axes: tuple            # logical axis names, same length as shape
    init: str = "normal"   # normal | zeros | ones
    scale: Optional[float] = None   # None => fan-in 1/sqrt(shape[fan_axis])
    fan_axis: int = 0
    dtype: Optional[str] = None     # override param dtype (e.g. fp32 norms)

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def stack(tree, n: int) -> list:
    """The port's counterpart of the reference ``stack``: ``n`` copies
    of a per-layer tree, one per layer."""
    return [tree for _ in range(n)]


def tree_map(fn, tree):
    """Map ``fn`` over the leaves of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def init_tree(tree, generator: torch.Generator, dtype=torch.bfloat16):
    """Materialise every ``PSpec`` leaf with the reference's laws:
    zeros, ones, or ``N(0, 1) * scale`` drawn in float32 and cast (scale
    defaults to ``fan ** -0.5`` over ``shape[fan_axis]``).  Tensors land
    on ``generator.device``.  The draws are torch's, not JAX's: equal
    weights in both packages come through ``from_reference``."""
    device = generator.device

    def one(p: PSpec):
        dt = getattr(torch, p.dtype) if p.dtype else dtype
        if p.init == "zeros":
            return torch.zeros(p.shape, dtype=dt, device=device)
        if p.init == "ones":
            return torch.ones(p.shape, dtype=dt, device=device)
        scale = p.scale
        if scale is None:
            scale = max(int(p.shape[p.fan_axis]), 1) ** -0.5
        x = torch.randn(p.shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (x * scale).to(dt)

    return tree_map(one, tree)


def to_torch(a: np.ndarray) -> torch.Tensor:
    """numpy -> torch, carrying bfloat16 through its bit pattern so no
    bfloat16-aware numpy extension is needed."""
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def from_reference(params_np, cfg) -> dict:
    """The reference's parameter pytree (leaves as numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) -> the port's weights.

    The stacked leading ``L`` axis of ``params_np["layers"]`` is split
    into a list of per-layer trees; every leaf keeps its dtype and
    per-layer shape."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet")

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        return to_torch(np.asarray(tree))

    out = {k: conv(v) for k, v in params_np.items() if k != "layers"}
    layers = conv(params_np["layers"])
    out["layers"] = [tree_map(lambda a, i=i: a[i].clone(), layers)
                     for i in range(cfg.n_layers)]
    return out


def params_to(params, device) -> dict:
    """A copy of a parameter tree on ``device``."""
    return tree_map(lambda a: a.to(device), params)
