"""qwen3-14b — dense Qwen3 [hf:Qwen/Qwen3-8B (family); hf].

Assigned config: 40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936,
qk_norm, head_dim=128.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=17_408,
    vocab_size=151_936,
    attention="gqa",
    qk_norm=True,
    rope_theta=1_000_000.0,
    max_position=131_072,
    source="hf:Qwen/Qwen3-8B family; hf",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8, d_ff=128,
    vocab_size=256, max_position=512,
)
