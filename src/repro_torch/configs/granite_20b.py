"""granite-20b [arXiv:2405.04324; hf]

52L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152 — code model.
d_ff = 4*d_model (non-gated MLP, gelu) with multi-query attention.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    norm="layernorm",
    act="gelu",
    glu=False,
    source="arXiv:2405.04324; hf",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="granite-20b-reduced", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, d_ff=256,
        vocab_size=256, norm="layernorm", act="gelu", glu=False,
        vocab_pad_multiple=16,
    )
