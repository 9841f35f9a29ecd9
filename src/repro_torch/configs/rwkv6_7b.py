"""rwkv6-7b (Finch) [arXiv:2404.05892; hf]

32L d_model=4096, attention-free (data-dependent decay linear attention,
head_size=64 -> 64 time-mix heads), d_ff=14336, vocab=65536.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, depth_cut

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,           # d_model / head_size(64)
    n_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    norm="layernorm",
    rope="none",
    ssm=SSMConfig(d_state=64, head_dim=64),
    source="arXiv:2404.05892; hf",
)

# The training cut one H100 holds: depth only, the first 10 layers at
# full width (``rwkv6-7b-10l``).  Values: embed and the untied lm_head
# 268.4 M each, 234.9 M a layer: about 2,886.2 M, 34.6 GB of bf16
# weights and gradients and fp32 AdamW moments (12 bytes a value)
# before activations, as the MoE and MLA training cuts.
TRAINING = depth_cut(CONFIG, 10)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b-reduced", family="ssm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=256, norm="layernorm", rope="none",
        ssm=SSMConfig(d_state=16, head_dim=16), vocab_pad_multiple=16,
    )
