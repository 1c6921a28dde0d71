"""moonshot-v1-16b-a3b — kimi/Moonlight [hf:moonshotai/Moonlight-16B-A3B; hf].

Assigned config: 48L d_model=2048 16H (GQA kv=16 => MHA-like, Type I)
d_ff=1408(per expert) vocab=163840, MoE 64 experts top-6.
(The HF Moonlight checkpoint is DeepSeek-V3-like with shared experts; the
assignment pins the simpler 64e top-6 GQA form, which we follow verbatim.)
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=163_840,
    attention="gqa",
    n_experts=64,
    experts_per_token=6,
    rope_theta=50_000.0,
    max_position=131_072,
    source="hf:moonshotai/Moonlight-16B-A3B; hf",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=32,
    vocab_size=256, n_experts=8, experts_per_token=2, max_position=512,
)
