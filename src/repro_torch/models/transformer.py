"""Decoder parameters and the full-sequence attention sub-block.

Port of the parts of ``src/repro/models/transformer.py`` the serving
path needs: ``init_params`` (``:106``) for the dense / MoE / VLM decoders
with GQA or MLA attention, and ``_attn_full`` (``:175``).  The param tree
has the reference's shape: per-layer leaves stacked on a leading
``[n_layers]`` axis under ``"layers"``, so ``repro_torch.bridge`` maps a
reference tree onto it leaf for leaf.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers, moe as moe_mod


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _init_layer(gen: torch.Generator, cfg: ModelConfig, dtype) -> Dict:
    zeros = dict(dtype=dtype, device=gen.device)
    p = {
        "ln1": torch.zeros((cfg.d_model,), **zeros),
        "attn": (attn.init_mla(gen, cfg, dtype) if cfg.attention == "mla"
                 else attn.init_gqa(gen, cfg, dtype)),
        "ln2": torch.zeros((cfg.d_model,), **zeros),
    }
    if cfg.family == "moe":
        p["moe"] = moe_mod.init_moe(gen, cfg, dtype)
    else:
        p["mlp"] = layers.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_kind,
                                   dtype)
    return p


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_params(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    """Random decoder params drawn from ``gen`` on ``gen.device``.

    The reference draws from ``jax.random`` keys, which torch cannot
    reproduce: the same config gives the same SHAPES and scales here, not
    the same numbers (tests bridge the reference's own tree instead).
    """
    if cfg.family not in ("dense", "moe", "vlm") or \
            cfg.attention not in ("gqa", "mla"):
        raise NotImplementedError(
            f"{cfg.name}: the port initialises dense/moe/vlm decoders with "
            f"gqa/mla attention only (family {cfg.family})")
    dtype = dtype_of(cfg)
    p: Dict = {
        "embed": layers.init_embed(gen, cfg.vocab_size, cfg.d_model, dtype,
                                   cfg.tie_embeddings),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype,
                                  device=gen.device),
    }
    # one layer at a time: the draw's f32 temporaries stay one layer big
    p["layers"] = _stack([_init_layer(gen, cfg, dtype)
                          for _ in range(cfg.n_layers)])
    return p


def _attn_full(p_l: Dict, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor):
    """Pre-norm full-sequence attention + residual: (x, layer_kv)."""
    h = layers.rms_norm(x, p_l["ln1"], cfg.norm_eps)
    if cfg.attention == "mla":
        out, kv = attn.mla_full(p_l["attn"], cfg, h, positions)
    else:
        out, kv = attn.gqa_full(p_l["attn"], cfg, h, positions)
    return x + out, kv
