"""Configuration dataclasses — the port's own copies of the reference
``ModelConfig``, ``MoEConfig``, ``MLAConfig``, ``SSMConfig``,
``ShapeConfig`` and ``RunConfig`` (same fields, same defaults, same
derived properties), the shape cells ``SHAPES`` and ``shapes_for`` /
``skip_reason``, so that the port never imports the JAX package.
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
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape."""
        return self.family in ("ssm", "hybrid")

    @property
    def is_encoder_decoder(self) -> bool:
        return self.n_encoder_layers > 0

    def n_params(self) -> int:
        """Analytic parameter count (embedding + blocks + head), the
        reference's formula for formula.

        Two of its counts are known to be wrong, and are kept so that
        the roofline's model FLOPs equal the reference's: zamba2-7b
        comes to 6.68 G against the 19.08 G of its parameter tree (the
        hybrid branch replaces the per-layer sum and leaves out the
        Mamba2 layers' other weights), and deepseek-v3-671b to
        703,796,805,632 against the tree's 670,302,339,072 (ROADMAP
        Queue C, "Properties of the reference that the port copies")."""
        d, h = self.d_model, self.resolved_head_dim
        n_q = self.n_heads * h
        n_kv = self.n_kv_heads * h
        emb = self.padded_vocab * d
        head = 0 if self.tie_embeddings else self.padded_vocab * d
        per_layer = 0
        if self.family == "ssm":                      # rwkv6-style
            per_layer += 6 * d * d                    # r,k,v,g,o + decay proj
            per_layer += d * self.d_ff + self.d_ff * d
        else:
            if self.mla is not None:
                m = self.mla
                per_layer += d * m.q_lora_rank + m.q_lora_rank * self.n_heads * (
                    m.qk_nope_head_dim + m.qk_rope_head_dim)
                per_layer += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                per_layer += m.kv_lora_rank * self.n_heads * (
                    m.qk_nope_head_dim + m.v_head_dim)
                per_layer += self.n_heads * m.v_head_dim * d
            else:
                per_layer += d * (n_q + 2 * n_kv) + n_q * d
            ff_mult = 3 if self.glu else 2
            if self.moe is not None:
                moe_ff = ff_mult * d * self.moe.d_ff_expert
                per_layer += self.moe.n_routed_experts * moe_ff
                per_layer += self.moe.n_shared_experts * moe_ff
                per_layer += d * self.moe.n_routed_experts  # router
            else:
                per_layer += ff_mult * d * self.d_ff
        shared = 0
        if self.family == "hybrid" and self.ssm is not None:
            d_inner = self.ssm.expand * d
            per_layer = 2 * d * d_inner + d_inner * d + d_inner * self.ssm.d_conv
            # zamba2: ONE shared attention+MLP block reused every attn_every
            # layers (weights counted once).
            shared = d * (n_q + 2 * n_kv) + n_q * d + 3 * d * self.d_ff
        total = emb + head + self.n_layers * per_layer + shared
        if self.is_encoder_decoder:
            total += self.n_encoder_layers * per_layer
        return int(total)


@dataclass(frozen=True)
class ShapeConfig:
    name: str                    # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                    # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


@dataclass(frozen=True)
class RunConfig:
    """Everything the launcher needs beyond the model itself, field for
    field the reference's.

    The trainer reads ``remat``, ``optimizer``, ``gradient_compression``
    and the chunk knobs (``q_chunk``, ``kv_chunk``, ``ce_chunk``,
    ``ssm_chunk``), which ``launch.steps`` puts into the model's
    ``Tuning`` together with ``kv_cache_quant`` and
    ``moe_local_dispatch``.  The mesh code (``launch.steps.make_rules``)
    reads ``fsdp`` and ``moe_cap_axis`` (the latter also goes into the
    ``Tuning``, where it is inert: no activation is split).
    ``multi_pod``, ``shard_cache_seq``, ``scan_layers``,
    ``param_dtype``, ``memory_mode``, ``page_bytes``, ``double_buffer``
    and ``use_flash`` are carried as the reference carries them (its
    ``make_rules`` reads the mesh's axes, not ``multi_pod``)."""
    model: ModelConfig
    shape: ShapeConfig
    # distribution
    multi_pod: bool = False
    remat: str = "full"          # none | dots | full
    scan_layers: bool = True
    optimizer: str = "adamw"     # adamw | adafactor
    param_dtype: str = "bfloat16"
    # paper technique knobs (core/)
    memory_mode: str = "DC"      # DM | DC | DevMem
    page_bytes: int = 4096
    double_buffer: bool = True
    # beyond-paper perf knobs (hillclimbing)
    use_flash: bool = True
    shard_cache_seq: bool = False   # context parallelism for decode caches
    gradient_compression: bool = False
    q_chunk: int = 512
    kv_chunk: int = 1024
    ce_chunk: int = 512
    ssm_chunk: int = 16
    kv_cache_quant: bool = False
    moe_cap_axis: str = ""          # "data" shards MoE capacity dim
    moe_local_dispatch: bool = False
    fsdp: bool = True               # False: TP-only weights


def shapes_for(model: ModelConfig) -> list:
    """The shape cells that are runnable for this architecture (the
    others are recorded as skipped, with ``skip_reason``)."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if model.sub_quadratic:
        out.append("long_500k")
    return out


def skip_reason(model: ModelConfig, shape_name: str) -> Optional[str]:
    if shape_name == "long_500k" and not model.sub_quadratic:
        return "pure full-attention arch: 500k dense KV walk per decoded token is not sub-quadratic (DESIGN.md §Arch-applicability)"
    return None
