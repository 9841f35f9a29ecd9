"""Transformer workload traces (paper §4.2): BERT-Medium/Base/Large and
ViT-Base/Large/Huge as sequences of GEMM calls + non-GEMM host work.
All GEMMs inside attention and FFN blocks are offloaded to MatrixFlow;
softmax/layernorm/activations stay on the host CPU (paper §4.2).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.paper_models import PAPER_MODELS


@dataclasses.dataclass(frozen=True)
class GemmCall:
    m: int
    n: int
    k: int
    count: int
    cls: str            # FF1 | FF2 | MHA | Proj


@dataclasses.dataclass(frozen=True)
class Workload:
    name: str
    gemms: tuple
    nongemm_elems: int          # host-side elementwise work (elements)
    seq: int

    @property
    def total_macs(self) -> int:
        return sum(g.m * g.n * g.k * g.count for g in self.gemms)


def transformer_trace(name: str) -> Workload:
    cfg = PAPER_MODELS[name]
    S = cfg.max_train_seq
    d = cfg.d_model
    h = cfg.n_heads
    hd = d // h
    L = cfg.n_layers
    f = cfg.d_ff
    gemms = (
        GemmCall(S, 3 * d, d, L, "Proj"),        # fused QKV projection
        GemmCall(S, S, hd, L * h, "MHA"),        # QK^T per head
        GemmCall(S, hd, S, L * h, "MHA"),        # PV per head
        GemmCall(S, d, d, L, "Proj"),            # output projection
        GemmCall(S, f, d, L, "FF1"),
        GemmCall(S, d, f, L, "FF2"),
    )
    # softmax + 2×layernorm + gelu + residuals per layer (host side)
    nongemm = L * (h * S * S + 2 * S * d + S * f + 2 * S * d)
    return Workload(name, gemms, nongemm, S)


MICRO_SIZES = (64, 128, 256, 512, 1024, 2048)


def micro_gemm(n: int) -> Workload:
    return Workload(f"gemm{n}", (GemmCall(n, n, n, 1, "GEMM"),), 0, n)
