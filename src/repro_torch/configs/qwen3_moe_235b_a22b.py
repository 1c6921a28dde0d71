"""qwen3-moe-235b-a22b — Qwen3 MoE family [hf:Qwen/Qwen3-30B-A3B; hf].

Assigned config: 94L d_model=4096 64H (GQA kv=4) d_ff=1536(per expert)
vocab=151936, MoE 128 experts top-8.  qk_norm per Qwen3; head_dim=128
(Qwen3 decouples head_dim from d_model/n_heads).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151_936,
    attention="gqa",
    qk_norm=True,
    n_experts=128,
    experts_per_token=8,
    rope_theta=1_000_000.0,
    max_position=131_072,
    source="hf:Qwen/Qwen3-30B-A3B (scaled per assignment); hf",
)

# Reduced same-family config for CPU smoke tests.
SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8, d_ff=32,
    vocab_size=256, n_experts=8, experts_per_token=2, max_position=512,
)
