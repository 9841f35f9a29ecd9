"""qwen2-moe-a2.7b [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]

24L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=151936,
MoE: 4 shared + 60 routed experts, top-4 routing.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    qkv_bias=True,
    moe=MoEConfig(n_routed_experts=60, top_k=4, d_ff_expert=1408,
                  n_shared_experts=4),
    source="hf:Qwen/Qwen1.5-MoE-A2.7B; hf",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b-reduced", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=96,
        vocab_size=256, qkv_bias=True,
        moe=MoEConfig(n_routed_experts=8, top_k=2, d_ff_expert=96,
                      n_shared_experts=1),
        vocab_pad_multiple=16,
    )
