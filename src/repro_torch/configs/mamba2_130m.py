"""mamba2-130m — pure SSM (SSD) [arXiv:2405.21060; unverified].

Assigned config: 24L d_model=768 (attention-free) vocab=50280, ssm_state=128.
Mamba2-130m: expand=2 (d_inner=1536), headdim=64 (24 SSD heads), ngroups=1.

CrossPool applicability note (DESIGN.md §Arch-applicability): attention-free
=> no KV cache; the KV-pool/virtualizer is inapplicable.  The arch still
participates via the consolidated weights pool and constant-size per-request
SSM state, which the planner treats as fixed-size pages.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50_280,
    attention="none",
    ssm=SSMConfig(d_state=128, head_dim=64, n_groups=1, expand=2, conv_width=4),
    max_position=1_048_576,
    tie_embeddings=True,
    source="arXiv:2405.21060; unverified",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, vocab_size=256,
    ssm=SSMConfig(d_state=16, head_dim=16, n_groups=1, expand=2, conv_width=4),
    max_position=512,
)
