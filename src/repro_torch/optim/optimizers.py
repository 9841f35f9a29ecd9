"""Optimizers: AdamW (fp32 moments) and Adafactor (factored second
moment), with the reference's arithmetic.

API, as in the reference:
    opt.init(params) -> state
    opt.update(grads, state, params, lr) -> (params, state, {"grad_norm"})
    opt.state_axes(param_axes) -> logical-axes tree congruent with state
Global-norm clipping is fused into ``update``.  The update runs under
``torch.no_grad()`` and writes the parameters and the state in place
(JAX's are immutable; in place, a step holds no second copy of either)
and returns the same trees.  ``lr`` is a float or a float32 scalar
tensor (``cosine_schedule``'s).

The reference scans each layer stack as one stacked leaf, and
Adafactor's factoring (by the leaf's rank) and its update clipping (by
the leaf's RMS) are defined on that stacked leaf; so Adafactor keeps the
reference's stacked slots, one per (stack, leaf path), and updates each
group of per-layer tensors as one stacked tensor.  AdamW is elementwise
and keeps per-layer moments congruent with the parameters.

On a mesh (``launch.steps``) each rank holds a block of every
parameter and state leaf.  AdamW is ``elementwise``: a rank updates its
blocks in place from its block of the whole reduced gradient, with the
clipping factor taken over the whole gradient (``clip_scale``, passed
as ``clip``; where a tensor-parallel step holds only its ``model``
block of some gradients, their squares are summed over ``model``).
Adafactor is not: its factored statistics and its update
clipping reduce over whole stacked leaves, so a rank updates whole
leaves (its state gathered) and keeps its blocks.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.sharding import blocks as BL


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """lr(step): linear warm-up to ``base_lr`` over ``warmup`` steps, then
    a half cosine to 0 at ``total``; float32, on the step's device."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = 0.5 * base_lr * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)
    return lr


def stacked(tree):
    """``tree`` with each layer stack (a list of per-layer trees) turned
    into one tree whose leaves are tuples of the per-layer tensors: the
    reference's stacked leaves, held apart."""
    if isinstance(tree, dict):
        return {k: stacked(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return _zip_layers(tree)
    return tree


def _zip_layers(layers):
    if not layers:           # a stack of no layer holds no leaf
        return {}
    if isinstance(layers[0], dict):
        return {k: _zip_layers([lp[k] for lp in layers]) for k in layers[0]}
    return tuple(layers)


def stacked_map(fn, tree):
    """Map ``fn`` over the leaves of a ``stacked`` tree (tensors, and
    tuples of per-layer tensors)."""
    if isinstance(tree, dict):
        return {k: stacked_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def group_shape(leaf) -> tuple:
    """The reference's leaf shape of a ``stacked`` leaf: (L, ...) for a
    tuple of L per-layer tensors."""
    if isinstance(leaf, tuple):
        return (len(leaf),) + tuple(leaf[0].shape)
    return tuple(leaf.shape)


def _global_norm(grads, split=None) -> torch.Tensor:
    """The L2 norm of every leaf of ``grads`` together.  ``split``:
    (a tree of bools congruent with ``grads``, a process group), where
    a True leaf is this rank's block of one split over the group's
    ranks: the squares of those blocks are summed over the group (one
    all-reduce; every rank of it must call), the other leaves, whole and
    alike on every rank, counted once."""
    if split is None:
        return torch.sqrt(sum(g.float().square().sum()
                              for g in tree_leaves(grads)))
    flags, group = split
    pairs = []
    tree_map(lambda g, f: pairs.append((g, f)), grads, flags)
    whole = mine = torch.zeros((), dtype=torch.float32,
                               device=pairs[0][0].device)
    for g, f in pairs:
        if f:
            mine = mine + g.float().square().sum()
        else:
            whole = whole + g.float().square().sum()
    mine = mine.reshape(1)
    BL.all_reduce(mine, group)
    return torch.sqrt(mine[0] + whole)


def clip_scale(grads, max_norm: float, split=None):
    """(scale, norm): the reference's ``_clip_by_global_norm`` factor;
    ``split`` as in ``_global_norm``."""
    norm = _global_norm(grads, split)
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0), norm


@dataclasses.dataclass(frozen=True)
class AdamW:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    elementwise = True

    def init(self, params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        dev = tree_leaves(params)[0].device
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def update(self, grads, state, params, lr, clip=None):
        """``clip``: (factor, norm) of ``clip_scale`` over the whole
        gradient, when ``grads``, ``state`` and ``params`` are one rank's
        blocks; else taken from ``grads``."""
        scale, gnorm = clip or clip_scale(grads, self.clip_norm)
        step = state["step"] + 1
        t = step.float()
        bc1 = 1 - self.b1 ** t
        bc2 = 1 - self.b2 ** t
        for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state["m"]),
                              tree_leaves(state["v"]), tree_leaves(params)):
            g = g.float() * scale
            m.copy_(self.b1 * m + (1 - self.b1) * g)
            v.copy_(self.b2 * v + (1 - self.b2) * g.square())
            pf = p.float()
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            u = u + self.weight_decay * pf
            p.copy_((pf - lr * u).to(p.dtype))
        state["step"] = step
        return params, state, {"grad_norm": gnorm}

    def state_axes(self, param_axes):
        return {"m": param_axes, "v": param_axes, "step": ()}


@dataclasses.dataclass(frozen=True)
class Adafactor:
    """Factored second-moment optimizer (Shazeer & Stern 2018), no
    momentum: O(params/row + params/col) state instead of 2 x params.
    Slots are the reference's, stacked over each layer stack (module
    docstring)."""
    decay: float = 0.8
    eps: float = 1e-30
    clip_norm: float = 1.0
    weight_decay: float = 0.0
    min_dim_factored: int = 2
    elementwise = False

    def _factored(self, shape) -> bool:
        return len(shape) >= self.min_dim_factored

    def init(self, params):
        def st(leaf):
            shape = group_shape(leaf)
            dev = (leaf[0] if isinstance(leaf, tuple) else leaf).device
            def zeros(s):
                return torch.zeros(s, dtype=torch.float32, device=dev)
            if self._factored(shape):
                return {"vr": zeros(shape[:-1]),
                        "vc": zeros(shape[:-2] + shape[-1:])}
            return {"v": zeros(shape)}
        dev = tree_leaves(params)[0].device
        return {"slots": stacked_map(st, stacked(params)),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def update(self, grads, state, params, lr):
        scale, gnorm = clip_scale(grads, self.clip_norm)
        step = state["step"] + 1
        beta = 1.0 - (step.float() + 1.0) ** (-self.decay)

        def upd(pair):
            (g, p), sl = pair
            many = isinstance(p, tuple)
            g = (torch.stack([x.float() for x in g]) if many
                 else g.float()) * scale
            pf = torch.stack([x.float() for x in p]) if many else p.float()
            g2 = g.square() + self.eps
            if self._factored(pf.shape):
                vr = beta * sl["vr"] + (1 - beta) * g2.mean(-1)
                vc = beta * sl["vc"] + (1 - beta) * g2.mean(-2)
                denom = vr[..., None] * vc[..., None, :] / torch.clamp(
                    vr.mean(-1)[..., None, None], min=self.eps)
                u = g * torch.rsqrt(torch.clamp(denom, min=self.eps))
                sl["vr"].copy_(vr)
                sl["vc"].copy_(vc)
            else:
                v = beta * sl["v"] + (1 - beta) * g2
                u = g * torch.rsqrt(torch.clamp(v, min=self.eps))
                sl["v"].copy_(v)
            # update clipping (RMS <= 1), per the paper
            rms = torch.sqrt(u.square().mean() + 1e-30)
            u = u / torch.clamp(rms, min=1.0)
            if self.weight_decay:
                u = u + self.weight_decay * pf
            new = pf - lr * u
            for i, x in enumerate(p if many else (p,)):
                x.copy_((new[i] if many else new).to(x.dtype))

        for pair in _zip_slots(stacked(grads), stacked(params),
                               state["slots"]):
            upd(pair)
        state["step"] = step
        return params, state, {"grad_norm": gnorm}

    def state_axes(self, param_axes):
        """The slots' axes over the reference's stacked leaves (a layer
        stack's per-layer axes behind a leading ``"layers"``), factored
        as ``init`` factors them."""
        def ax(a):
            if len(a) >= self.min_dim_factored:
                return {"vr": a[:-1], "vc": a[:-2] + a[-1:]}
            return {"v": a}
        return {"slots": stacked_map(ax, stacked_axes(param_axes)),
                "step": ()}


def stacked_axes(axes):
    """A per-layer axes tree (``Model.param_axes``) in ``stacked``'s
    structure, each layer stack's leaf the reference's stacked axes:
    ``("layers",)`` before the per-layer axes."""
    if isinstance(axes, dict):
        return {k: stacked_axes(v) for k, v in axes.items()}
    if isinstance(axes, list):
        return _zip_axes(axes)
    return axes


def _zip_axes(layers):
    if not layers:
        return {}
    if isinstance(layers[0], dict):
        return {k: _zip_axes([lp[k] for lp in layers]) for k in layers[0]}
    return ("layers",) + layers[0]


def _zip_slots(g, p, slots):
    """((grad leaf, param leaf), slot) of every leaf of ``stacked``
    trees, with the slot dict ({"vr", "vc"} or {"v"}) at the same path."""
    if isinstance(p, dict):
        for k in p:
            yield from _zip_slots(g[k], p[k], slots[k])
    else:
        yield (g, p), slots


def get_optimizer(name: str, **kw):
    if name == "adamw":
        return AdamW(**kw)
    if name == "adafactor":
        return Adafactor(**kw)
    raise KeyError(name)
