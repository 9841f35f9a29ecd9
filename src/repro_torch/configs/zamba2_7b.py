"""zamba2-7b [arXiv:2411.15242; unverified]

Hybrid: 81 Mamba2 layers (d_state=64) with a SHARED full-attention block
(32H, kv=32, d_model=3584) applied every 6 layers; per-layer MLP d_ff=14336;
vocab=32000.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, depth_cut

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, attn_every=6),
    source="arXiv:2411.15242; unverified",
)

# The training cut one H100 holds: depth only, the first 7 layers at
# full width (``zamba2-7b-7l``), the least depth at which the shared
# block runs twice (before layers 0 and 6).  Values: 232.1 M a layer,
# the shared block 51.4 M, embed and the untied lm_head 114.7 M each:
# about 1,905.6 M, 22.9 GB at 12 bytes a value (bf16 weights and
# gradients, fp32 AdamW moments).  Deeper cuts are left alone: under
# autograd each Mamba2 layer keeps the scan's fp32 operands at
# (8, 512, 112, 64), 117 MB each at 8 x 512 tokens.
TRAINING = depth_cut(CONFIG, 7)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b-reduced", family="hybrid",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=256,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32, attn_every=2),
        vocab_pad_multiple=16,
    )
