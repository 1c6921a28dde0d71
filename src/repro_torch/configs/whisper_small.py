"""whisper-small — encoder-decoder audio backbone [arXiv:2212.04356; unverified].

Assigned config: 12L d_model=768 12H (kv=12, MHA) d_ff=3072 vocab=51865.
Encoder-decoder with a conv mel frontend, which is a STUB here:
``input_specs()`` provides precomputed frame embeddings (1500 frames after
the 2x conv downsampling of 30s audio).

Shape notes (DESIGN.md): decode_32k exceeds Whisper's 448 learned positions;
we lower it with sinusoidal positions and note the deviation.  long_500k is
SKIPPED (pure full attention).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,                # decoder layers
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51_865,
    attention="gqa",            # MHA == GQA with n_kv == n_heads
    is_encoder_decoder=True,
    n_encoder_layers=12,
    encoder_seq=1500,
    frontend="audio_frames",
    frontend_tokens=1500,
    mlp_kind="gelu",
    tie_embeddings=True,
    rope_theta=0.0,             # whisper uses learned/sinusoidal positions
    max_position=448,
    source="arXiv:2212.04356; unverified",
)

SMOKE = CONFIG.replace(
    n_layers=2, n_encoder_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    head_dim=16, d_ff=128, vocab_size=256, encoder_seq=32, frontend_tokens=32,
    max_position=448,
)
