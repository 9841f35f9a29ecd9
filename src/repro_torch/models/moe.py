"""Mixture-of-Experts FFN: the capacity rule.

Only ``routed_capacity`` is ported so far: the plan IR sizes each
expert's routed buffer with it (``core.plan.moe_layer_plan``).  The
dispatch paths of the reference module come with the MoE family.
"""
from __future__ import annotations


def routed_capacity(n_assignments: int, n_experts: int,
                    capacity: int | None,
                    capacity_factor: float = 1.25,
                    multiple: int = 8) -> int:
    """Per-expert buffer capacity C for ``n_assignments`` (= tokens x
    top_k) routed slots: capacity-factor sized (or explicit), rounded up
    to ``multiple`` and clamped to the assignment count."""
    C = capacity if capacity is not None else \
        max(int(n_assignments / n_experts * capacity_factor), multiple)
    return min(-(-C // multiple) * multiple, n_assignments)
