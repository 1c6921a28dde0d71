"""gemma3-12b — dense Gemma-3 [hf:google/gemma-3-1b-pt (family); unverified].

Assigned config: 48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144,
5:1 local:global sliding-window pattern, 128k context.  head_dim=256 per
gemma3-12b.  Local window = 1024 tokens.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15_360,
    vocab_size=262_144,
    attention="gqa",
    qk_norm=True,
    sliding_window=1024,
    swa_pattern=6,           # every 6th layer global => 5:1 local:global
    rope_theta=1_000_000.0,
    max_position=131_072,
    tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt family; unverified",
)

SMOKE = CONFIG.replace(
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    vocab_size=256, sliding_window=16, max_position=512,
)
