"""llava-next-34b — VLM backbone [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified].

Assigned config: 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
The transformer BACKBONE only: the anyres vision tiling frontend is a STUB —
``input_specs()`` provides precomputed patch embeddings (anyres tiling of a
672x672 image at 14px patches ≈ 2880 image tokens) that are prepended to the
text sequence.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20_480,
    vocab_size=64_000,
    attention="gqa",
    frontend="vision_patches",
    frontend_tokens=2880,
    rope_theta=5_000_000.0,
    max_position=131_072,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf (backbone scaled per assignment); unverified",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8, d_ff=128,
    vocab_size=256, frontend_tokens=16, max_position=512,
)
