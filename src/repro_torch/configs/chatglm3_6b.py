"""chatglm3-6b [arXiv:2406.12793; hf]

28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024 — RoPE-2d, GQA.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    qkv_bias=True,
    rope="2d",
    source="arXiv:2406.12793; hf",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b-reduced", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
        vocab_size=256, qkv_bias=True, rope="2d", vocab_pad_multiple=16,
    )
