"""Logical-axis sharding rules (MaxText-style), as the simulator reads
them.

Every parameter / activation dimension carries a *logical* name
("embed", "heads", "mlp", "vocab", "expert", "batch", "cache_seq", ...).
A rule table maps logical names to physical mesh axes; ``spec_for``
resolves a tuple of logical names into a partition spec while enforcing
(a) each mesh axis is claimed at most once, and (b) a dim is only
sharded if its size divides the mesh-axis extent (padding would waste
memory silently; the dim is replicated instead).

This is the rule table and resolver of the reference package's
``sharding/logical.py``, with the same tables and the same claim order.
``spec_for`` returns a plain tuple with one entry per dim (``None``,
an axis name, or a tuple of axis names) in place of a JAX
``PartitionSpec``; ``core/multidev.py`` reads per-rank extents from it.

Physical axes: ``("pod", "data", "model")`` multi-pod, ``("data",
"model")`` single-pod. Weights are FSDP-sharded over ``data`` and
TP-sharded over ``model``; ``pod`` is pure data-parallel.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence


# Default logical->physical mapping. Tuples mean "shard over several axes".
# Order in PRIORITY decides who wins when two dims of one tensor want the
# same mesh axis (first claim wins, later claims are dropped).
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    # activations
    "batch": ("pod", "data"),
    "seq": (),                # activations' seq dim: unsharded by default
    # decode KV/state cache seq dim: claims `model` ONLY when the kv-head
    # dims could not (GQA with few KV heads) — see PRIORITY
    "cache_seq": ("model",),
    "cache_batch": ("pod", "data"),
    # weights
    "expert": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "qkv": ("model",),        # fused heads*head_dim projections
    "seq_q": ("model",),      # query-chunk dim: claims model ONLY when the
                              # head dims could not (GQA with few heads) —
                              # sequence-parallel attention fallback
    "vocab": ("model",),
    "mlp": ("model",),
    "embed": ("data",),       # FSDP axis for weights
    "embed_act": (),          # activations' model dim
    "head_dim": (),
    "state": (),
    "layers": (),             # stacked-scan leading dim
    "conv": (),
    "lora": (),               # MLA latent dims
    "moe_cap": (),            # MoE capacity dim
}

# Context-parallel variant for long-context decode (batch=1): shard the
# cache sequence instead of batch, keep heads on model.
LONG_CONTEXT_OVERRIDES: dict[str, tuple[str, ...]] = {
    "batch": (),
    "cache_batch": (),
    "cache_seq": ("data",),
}

PRIORITY = [
    "expert", "heads", "qkv", "kv_heads", "seq_q", "vocab", "mlp",
    "moe_cap", "cache_seq", "cache_batch", "batch", "embed", "seq",
    "embed_act", "head_dim", "state", "layers", "conv", "lora",
]
_PRIO = {n: i for i, n in enumerate(PRIORITY)}


def make_rules(multi_pod: bool, long_context: bool = False,
               overrides: Optional[Mapping[str, tuple[str, ...]]] = None,
               ) -> dict[str, tuple[str, ...]]:
    rules = dict(DEFAULT_RULES)
    if long_context:
        rules.update(LONG_CONTEXT_OVERRIDES)
    if overrides:
        rules.update(overrides)
    if not multi_pod:
        rules = {k: tuple(a for a in v if a != "pod") for k, v in rules.items()}
    return rules


def spec_for(axes: Sequence[Optional[str]],
             shape: Sequence[int],
             rules: Mapping[str, tuple[str, ...]],
             mesh_shape: Mapping[str, int]) -> tuple:
    """Resolve logical axes + concrete shape into a partition spec: one
    entry per dim, ``None`` (replicated), an axis name, or a tuple of
    axis names."""
    if len(axes) != len(shape):
        raise ValueError(f"axes {axes} and shape {shape} differ in rank")
    # Claim mesh axes in priority order.
    order = sorted(range(len(axes)),
                   key=lambda i: _PRIO.get(axes[i] or "", len(PRIORITY)))
    taken: set[str] = set()
    out: list = [None] * len(axes)
    for i in order:
        name = axes[i]
        if name is None:
            continue
        want = [a for a in rules.get(name, ()) if a in mesh_shape]
        got: list[str] = []
        extent = 1
        for a in want:
            if a in taken:
                continue
            if shape[i] % (extent * mesh_shape[a]) != 0:
                continue   # would need padding: replicate instead
            got.append(a)
            extent *= mesh_shape[a]
        if got:
            taken.update(got)
            out[i] = tuple(got) if len(got) > 1 else got[0]
    return tuple(out)
