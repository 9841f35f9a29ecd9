"""Model configuration dataclass — the port's own copy of the reference
``ModelConfig`` (same fields, same defaults, same derived properties),
so that the port never imports the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 => d_model // n_heads
    qkv_bias: bool = False
    rope: str = "full"           # full | 2d | none
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    act: str = "silu"            # silu | gelu
    glu: bool = True             # gated FFN (SwiGLU/GeGLU) vs plain MLP
    tie_embeddings: bool = False
    # MoE / MLA / SSM sub-configs: not ported yet, always None here
    moe: Optional[object] = None
    mla: Optional[object] = None
    ssm: Optional[object] = None
    mtp: bool = False
    n_encoder_layers: int = 0
    embedding_inputs: bool = False
    # vocab padding so TP shards divide evenly; logits beyond vocab_size masked
    vocab_pad_multiple: int = 256
    max_train_seq: int = 8192
    source: str = ""             # provenance tag [source; tier]

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, self.vocab_pad_multiple)
