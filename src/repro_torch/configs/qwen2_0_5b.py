"""qwen2-0.5b [arXiv:2407.10671; hf]

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936 — GQA, QKV bias.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
    source="arXiv:2407.10671; hf",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2-0.5b-reduced", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=256, qkv_bias=True, tie_embeddings=True,
        vocab_pad_multiple=16,
    )
