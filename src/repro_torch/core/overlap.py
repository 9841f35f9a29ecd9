"""The paper's overlap bound (Eq. 1).

For a W×W output-stationary array at clock f consuming A (W×L) and B
(L×W) page tiles and draining C (W×W), transfers fully hide behind
compute iff

    S·(2WL + W²) / (η_io·BW) ≤ (L + 2(W−1)) / (η_sa·f)
    ⟹  BW ≥ S·f·(2WL + W²)/(L + 2(W−1)) · η_sa/η_io

Asymptotes (L→∞): BW∞ = 2·S·f·W → 32/64/128 GB/s for INT8/FP16/FP32 at
W = 16, f = 1 GHz.

Only the paper's algebra lives here.  The reference's TPU re-derivation
of it (``tpu_block_overlap`` and the Pallas block chooser
``choose_gemm_blocks``, with TPU v5e constants) has no counterpart in
this module: the port's Hopper block chooser is
``repro_torch.kernels.streaming_gemm.plan``, which keeps the rule that
every B tile is a whole number of 4 KB pages and uses no TPU constant.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class OverlapPoint:
    bw_required: float          # B/s to keep the array busy
    compute_s: float            # per-tile compute time
    transfer_s: float           # per-tile transfer time at bw_peak
    feasible: bool


def required_bandwidth(W: int, L: int, f: float, elem_bytes: int,
                       eta_sa: float = 1.0, eta_io: float = 1.0) -> float:
    """Eq. 1 right-hand side."""
    num = elem_bytes * f * (2 * W * L + W * W)
    den = L + 2 * (W - 1)
    return num / den * (eta_sa / eta_io)


def asymptotic_bandwidth(W: int, f: float, elem_bytes: int) -> float:
    """L→∞ limit of Eq. 1: 2·S·f·W."""
    return 2.0 * elem_bytes * f * W


def evaluate(W: int, L: int, f: float, elem_bytes: int, bw_peak: float,
             eta_sa: float = 1.0, eta_io: float = 1.0) -> OverlapPoint:
    bw_req = required_bandwidth(W, L, f, elem_bytes, eta_sa, eta_io)
    compute = (L + 2 * (W - 1)) / (eta_sa * f)
    transfer = elem_bytes * (2 * W * L + W * W) / (eta_io * bw_peak)
    return OverlapPoint(bw_req, compute, transfer, transfer <= compute)


def sram_doubling_delta(W: int, L: int, f: float, elem_bytes: int) -> float:
    """Relative change of the Eq.-1 bound when on-chip SRAM doubles
    (L → 2L).  Positive: the requirement gets tighter, since longer
    tiles amortize the fill/drain bubbles that gave the link slack."""
    b1 = required_bandwidth(W, L, f, elem_bytes)
    b2 = required_bandwidth(W, 2 * L, f, elem_bytes)
    return (b2 - b1) / b1


def min_feasible_tile_len(W: int, f: float, elem_bytes: int,
                          bw_peak: float, max_l: int = 65536) -> int | None:
    """Smallest L whose Eq.-1 bound fits under bw_peak (None if even the
    asymptote exceeds the link: the design is bandwidth-starved)."""
    if asymptotic_bandwidth(W, f, elem_bytes) > bw_peak:
        return None
    lo, hi = 1, max_l
    if required_bandwidth(W, hi, f, elem_bytes) > bw_peak:
        return None
    while lo < hi:
        mid = (lo + hi) // 2
        if required_bandwidth(W, mid, f, elem_bytes) <= bw_peak:
            hi = mid
        else:
            lo = mid + 1
    return lo
