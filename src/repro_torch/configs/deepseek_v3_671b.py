"""deepseek-v3-671b [arXiv:2412.19437; hf]

61L d_model=7168 128H (GQA kv=128) d_ff=2048 vocab=129280,
MoE: 1 shared + 256 routed experts, top-8; MLA; MTP head.
"""
from repro_torch.configs.base import (MLAConfig, ModelConfig, MoEConfig,
                                     depth_cut)

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=2048,
    vocab_size=129280,
    moe=MoEConfig(n_routed_experts=256, top_k=8, d_ff_expert=2048,
                  n_shared_experts=1, first_dense_layers=3),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    mtp=True,
    source="arXiv:2412.19437; hf",
)
"""``CONFIG`` is the reference's deepseek-v3-671b, copied as it is.  Against
the published ``deepseek-ai/DeepSeek-V3`` ``config.json`` the reference
simplifies three things, and the port keeps them (ROADMAP Queue C):

- routing is a softmax over the 256 experts and a plain top-8, where the
  published model scores with a sigmoid and routes ``noaux_tc``: 8 expert
  groups, the top 4 groups, then the top 8 experts, the weights scaled by
  ``routed_scaling_factor`` 2.5;
- the first 3 (dense) layers' MLP has ``d_ff`` 2,048 (the expert width),
  where the published ``intermediate_size`` is 18,432;
- RoPE has no YaRN ``rope_scaling`` (theta 10,000 over the 64 rope
  columns).
"""

# The serving cut the H100 holds: depth only, the 3 dense layers and the
# first 2 MoE layers (51.8 GB of bf16 weights at full width).  Width,
# heads, experts, vocabulary and the MLA ranks stay published.
SERVING = depth_cut(CONFIG, 5)

# The training cut the H100 holds: depth only, the 3 dense layers (MLA
# attention, the 2,048-wide MLP) and the MTP head, at full width
# (``deepseek-v3-671b-3l``).  Values: embed and the untied lm_head
# 926.7 M each, 231.2 M a layer, the MTP head 333.9 M: about 2,880.8 M,
# 34.6 GB of bf16 weights and gradients and fp32 AdamW moments (12 bytes
# a value) before activations.  No MoE layer fits beside them: one holds
# 256 x 3 x 7,168 x 2,048 = 11.27 G expert values, about 135 GB at 12
# bytes a value.
TRAINING = depth_cut(CONFIG, 3)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-reduced", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=96,
        vocab_size=256,
        moe=MoEConfig(n_routed_experts=8, top_k=2, d_ff_expert=48,
                      n_shared_experts=1, first_dense_layers=1),
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                      qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16),
        mtp=True,
        vocab_pad_multiple=16,
    )
