"""minicpm3-4b — dense decoder with MLA [hf:openbmb/MiniCPM3-4B; hf].

Assigned config: 62L d_model=2560 40H d_ff=6400 vocab=73448, MLA attention.
MLA dims per the HF config: q_lora_rank=768, kv_lora_rank=256,
qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64.

This is the paper's Type II flagship: the KV cache stores only
(kv_lora_rank + qk_rope_head_dim) = 288 scalars per token per layer,
independent of the 40 query heads — exactly the KV-head-limited case where
monolithic DP-attention placement wastes capacity (paper §2.2, Fig. 2).
"""
from repro_torch.configs.base import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,      # nominal (assignment lists kv=40); MLA overrides KV layout
    head_dim=64,
    d_ff=6400,
    vocab_size=73_448,
    attention="mla",
    mla=MLAConfig(
        q_lora_rank=768,
        kv_lora_rank=256,
        qk_nope_head_dim=64,
        qk_rope_head_dim=32,
        v_head_dim=64,
    ),
    rope_theta=10_000.0,
    max_position=32_768 * 32,   # long-context serving target via rope scaling
    source="hf:openbmb/MiniCPM3-4B; hf",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
    vocab_size=256,
    mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                  qk_rope_head_dim=8, v_head_dim=16),
    max_position=512,
)
