"""Roofline terms of a counted step, against an H100's datasheet peaks.

Three terms per (arch x shape x mesh) cell, in seconds:
    compute    = per-rank flops / peak bf16 FLOP/s
    memory     = per-rank bytes / HBM bandwidth
    collective = per-rank collective bytes (ring-model effective) / link
                 bandwidth

The reference reads them from a compiled module's HLO text; the port
reads them from a ``launch.hlo_analysis.Costs``: the count of one rank's
dispatched ops (on a plan of more ranks, rank 0's on ``meta`` tensors),
already per rank, so no division by the rank count.

The constants are an NVIDIA H100 80GB HBM3 (SXM) at its 700 W power
limit, from NVIDIA's datasheet (dense rates, no sparsity): 989e12 bf16
FLOP/s and 3.35e12 B/s (the figures ``chip_smoke.py`` bounds its kernels
by), and one NVLink 4 bandwidth, 450e9 B/s a direction, for the
collective term.  A group larger than a node of 8 cards would cross the
network, which this term does not model, as the reference's single ICI
constant does not model its DCN.  ``HBM_BYTES`` is the device memory
``torch.cuda.get_device_properties(0).total_memory`` reports on an H100
80GB HBM3 (``chip_smoke.py`` phase 20 asserts it on the card).  A card
set below 700 W runs slower than these terms under load.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

# ----- H100 80GB HBM3 (SXM), 700 W: datasheet peaks, per card -----
PEAK_FLOPS_BF16 = 989e12     # FLOP/s, dense bf16 tensor cores
HBM_BW = 3.35e12             # B/s
LINK_BW = 450e9              # B/s, NVLink 4, one direction
HBM_BYTES = 85_017_493_504   # B, total_memory of an H100 80GB HBM3


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_op: dict
    effective_bytes: float      # ring-model per-device bytes on the wire
    count: int

    @property
    def total_bytes(self) -> float:
        return float(sum(self.bytes_by_op.values()))


@dataclasses.dataclass
class MemoryStats:
    """A step's memory as XLA's ``memory_analysis()`` names it, from the
    counter's peak (``launch.dryrun``)."""
    argument_size_in_bytes: float
    output_size_in_bytes: float
    temp_size_in_bytes: float
    alias_size_in_bytes: float


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    collective_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float            # 6·N·D (train) / 2·N·D (inference), global
    useful_ratio: float           # model_flops / (flops_per_device × chips)
    memory_per_device_bytes: Optional[float] = None
    fits_hbm: Optional[bool] = None
    collective_count: int = 0
    step_time_s: float = 0.0      # max of the three terms (overlap ideal)
    roofline_fraction: float = 0.0  # useful compute time / step time

    def to_dict(self):
        return dataclasses.asdict(self)


def compute_roofline(costs, n_devices: int, model_flops: float,
                     memory_stats: Optional[MemoryStats] = None) -> Roofline:
    """The reference's ``compute_roofline`` over one rank's ``costs``."""
    coll = CollectiveStats(costs.coll_by_op, costs.coll_effective,
                           costs.coll_count)
    flops, nbytes = float(costs.flops), float(costs.bytes)
    compute_s = flops / PEAK_FLOPS_BF16
    memory_s = nbytes / HBM_BW
    collective_s = coll.effective_bytes / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    mem_per_dev = None
    fits = None
    if memory_stats is not None:
        mem_per_dev = float(
            memory_stats.argument_size_in_bytes
            + memory_stats.output_size_in_bytes
            + memory_stats.temp_size_in_bytes
            - memory_stats.alias_size_in_bytes)
        fits = mem_per_dev <= HBM_BYTES
    useful = model_flops / max(flops * n_devices, 1.0)
    step = max(compute_s, memory_s, collective_s)
    useful_compute_s = (model_flops / n_devices) / PEAK_FLOPS_BF16
    return Roofline(
        flops_per_device=flops, bytes_per_device=nbytes,
        collective_bytes=coll.effective_bytes,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        bottleneck=bottleneck, model_flops=model_flops, useful_ratio=useful,
        memory_per_device_bytes=mem_per_dev, fits_hbm=fits,
        collective_count=coll.count, step_time_s=step,
        roofline_fraction=useful_compute_s / max(step, 1e-30))


def model_flops_for(cfg, shape) -> float:
    """Useful model FLOPs for this cell: 6·N·D train, 2·N·D inference
    (N = active params, D = tokens processed globally)."""
    n = active_params(cfg)
    if shape.kind == "train":
        return 6.0 * n * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n * shape.seq_len * shape.global_batch
    return 2.0 * n * shape.global_batch        # decode: 1 token per seq


def active_params(cfg) -> float:
    """Per-token active parameter count (MoE: top-k + shared only)."""
    n = cfg.n_params()
    if cfg.moe is not None:
        m = cfg.moe
        ff_mult = 3 if cfg.glu else 2
        per_expert = ff_mult * cfg.d_model * m.d_ff_expert
        moe_layers = cfg.n_layers - m.first_dense_layers
        inactive = (m.n_routed_experts - m.top_k) * per_expert * moe_layers
        n = n - inactive
    return float(n)
