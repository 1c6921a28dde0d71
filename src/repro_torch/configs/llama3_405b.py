"""llama3-405b — dense Llama-3.1 405B [arXiv:2407.21783; unverified].

Assigned config: 126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16_384,
    n_heads=128,
    n_kv_heads=8,
    head_dim=128,
    d_ff=53_248,
    vocab_size=128_256,
    attention="gqa",
    rope_theta=500_000.0,
    max_position=131_072,
    source="arXiv:2407.21783; unverified",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8, d_ff=128,
    vocab_size=256, max_position=512,
)
