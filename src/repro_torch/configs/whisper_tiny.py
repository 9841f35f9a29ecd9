"""whisper-tiny [arXiv:2212.04356; unverified]

Enc-dec: 4L encoder + 4L decoder, d_model=384 6H (kv=6) d_ff=1536
vocab=51865 (padded 51968). Conv audio frontend is a stub: encoder
inputs are precomputed frame embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,
    n_encoder_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    norm="layernorm",
    act="gelu",
    glu=False,
    rope="none",
    embedding_inputs=True,
    source="arXiv:2212.04356; unverified",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny-reduced", family="audio",
        n_layers=2, n_encoder_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=250, norm="layernorm", act="gelu", glu=False,
        rope="none", embedding_inputs=True, vocab_pad_multiple=16,
    )
