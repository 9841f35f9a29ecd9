"""Model configuration dataclasses — the port's own copies of the
reference ``ModelConfig``, ``MoEConfig``, ``MLAConfig`` and
``SSMConfig`` (same fields, same defaults, same derived properties), so
that the port never imports the JAX package.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def depth_cut(cfg: "ModelConfig", n_layers: int) -> "ModelConfig":
    """``cfg`` with only its first ``n_layers`` layers, named so
    (``<name>-<n>l``); every width stays as it is."""
    if not 0 < n_layers <= cfg.n_layers:
        raise ValueError(f"{cfg.name} has {cfg.n_layers} layers, not a cut "
                         f"to {n_layers}")
    return dataclasses.replace(cfg, name=f"{cfg.name}-{n_layers}l",
                               n_layers=n_layers)


@dataclass(frozen=True)
class MoEConfig:
    n_routed_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    # layers [0, first_dense_layers) use a dense FFN instead of MoE
    first_dense_layers: int = 0
    router_aux_coef: float = 0.001


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (deepseek-v3)."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (zamba2) / RWKV6 state-space parameters."""
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64          # SSM head dim (mamba2) / rwkv head size
    # zamba2: one shared attention block applied every `attn_every` mamba layers
    attn_every: int = 6


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
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    mtp: bool = False            # multi-token-prediction head (deepseek-v3)
    # encoder-decoder (whisper): n_layers == decoder layers
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

    @property
    def is_encoder_decoder(self) -> bool:
        return self.n_encoder_layers > 0
