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

from repro_torch.configs import check_ported


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


def tree_map(fn, tree, *rest):
    """Map ``fn`` over the leaves of a tree of dicts and lists (and of
    the trees in ``rest``, of the same structure, leaf by leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts and lists, in order."""
    out = []
    tree_map(out.append, tree)
    return out


def n_elements(tree) -> int:
    """Element count of a tree of tensors."""
    return sum(t.numel() for t in tree_leaves(tree))


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
        # in place: one fp32 temporary, not two (a (256, 7168, 2048)
        # expert leaf of deepseek-v3 is 15 GB in fp32); the same values
        return x.mul_(scale).to(dt)

    return tree_map(one, tree)


def to_torch(a: np.ndarray) -> torch.Tensor:
    """numpy -> torch, carrying bfloat16 through its bit pattern so no
    bfloat16-aware numpy extension is needed."""
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _conv(tree):
    if isinstance(tree, dict):
        return {k: _conv(v) for k, v in tree.items()}
    return to_torch(np.asarray(tree))


def _split_stacks(tree_np, cfg) -> dict:
    """A tree in the reference's parameter layout (numpy leaves) -> the
    port's: each layer stack's leading ``L`` axis split into a list of
    per-layer trees (an empty list for a stack of no layer: an MoE
    model cut to its dense layers), every other key kept whole."""
    nd = cfg.moe.first_dense_layers if cfg.family == "moe" else 0
    stacks = {"dense_layers": nd, "enc_layers": cfg.n_encoder_layers,
              "layers": cfg.n_layers - nd}
    out = {k: _conv(v) for k, v in tree_np.items() if k not in stacks}
    for name, n in stacks.items():
        if name in tree_np:
            layers = _conv(tree_np[name])
            out[name] = [tree_map(lambda a, i=i: a[i].clone(), layers)
                         for i in range(n)]
    return out


def from_reference(params_np, cfg) -> dict:
    """The reference's parameter pytree (leaves as numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) -> the port's weights.

    The stacked leading ``L`` axis of each layer stack (``layers``, an
    MoE model's ``dense_layers``, an audio model's ``enc_layers``) is
    split into a list of per-layer trees; every leaf keeps its dtype and
    per-layer shape (an expert leaf stays (E, d, f), the router (d, E),
    an RWKV6 layer's ``mix`` (5, d) and ``u`` (H, N), a Mamba2 layer's
    ``conv_w`` (K, C)); ``pos_embed``, ``enc_norm``, a hybrid's
    ``shared_attn`` and deepseek-v3's ``mtp`` head stay whole.  The decode
    path's derived layouts are added (``transformer.add_derived``)."""
    from repro_torch.models.transformer import add_derived
    check_ported(cfg)
    return add_derived(_split_stacks(params_np, cfg), cfg)


def opt_state_from_reference(state_np, cfg) -> dict:
    """The reference optimizer's state (numpy leaves) -> the port's, with
    the key map of ``from_reference``: AdamW's ``m`` and ``v`` split per
    layer like the parameters; Adafactor's ``slots`` (``vr`` / ``vc`` /
    ``v``) kept stacked, as the port's Adafactor holds them
    (``optim.optimizers``); ``step`` as a scalar int32 tensor."""
    check_ported(cfg)
    out = {"step": to_torch(np.asarray(state_np["step"]))}
    if "slots" in state_np:
        out["slots"] = _conv(state_np["slots"])
    else:
        out["m"] = _split_stacks(state_np["m"], cfg)
        out["v"] = _split_stacks(state_np["v"], cfg)
    return out


def params_to(params, device) -> dict:
    """A copy of a parameter tree on ``device``."""
    return tree_map(lambda a: a.to(device), params)
