"""zamba2-1.2b — hybrid Mamba2 + shared attention [arXiv:2411.15242; hf].

Assigned config: 38L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=32000,
ssm_state=64.  Zamba2 interleaves Mamba2 blocks with a *shared*
attention+MLP block applied periodically (the shared block is the
architecture's hallmark: one set of attention weights reused at several
depths).  We lay out 38 layers as 6 groups of (5 Mamba2 + 1 shared-attn
block) + 2 tail Mamba2 layers.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32_000,
    attention="gqa",
    ssm=SSMConfig(d_state=64, head_dim=64, n_groups=1, expand=2, conv_width=4),
    hybrid_groups=6,
    ssm_per_group=5,
    tail_ssm_layers=2,
    rope_theta=10_000.0,
    max_position=1_048_576,     # SSM layers are O(1)-state; attn is 6 blocks
    source="arXiv:2411.15242; hf",
)

SMOKE = CONFIG.replace(
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
    vocab_size=256,
    ssm=SSMConfig(d_state=16, head_dim=16, n_groups=1, expand=2, conv_width=4),
    hybrid_groups=2, ssm_per_group=3, tail_ssm_layers=0, max_position=512,
)
