"""internvl2-2b [arXiv:2404.16821; hf]

LM backbone (InternLM2-1.8B): 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92553 (padded to 92672 for TP). InternViT frontend is a stub per
spec: ``input_specs()`` provides precomputed patch embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    embedding_inputs=True,
    source="arXiv:2404.16821; hf",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="internvl2-2b-reduced", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
        vocab_size=250, embedding_inputs=True, vocab_pad_multiple=16,
    )
