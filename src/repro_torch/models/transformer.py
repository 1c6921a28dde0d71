"""Decoder parameters and the full-sequence sub-blocks.

Port of the parts of ``src/repro/models/transformer.py`` the serving
paths need: ``init_params`` (``:106``) for the dense / MoE / VLM decoders
with GQA or MLA attention and for the ssm and hybrid (zamba2) families,
``embed_inputs`` (``:152``), ``_logits`` (``:165``), ``_attn_full``
(``:175``) and the dense branch of ``_ffn_full`` (``:186``).  The param
tree has the reference's shape: per-layer leaves stacked on a leading
axis under ``"layers"`` (and ``"tail"``), the hybrid's ONE shared
attention + MLP block under ``"shared_block"``, so ``repro_torch.bridge``
maps a reference tree onto it leaf for leaf.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers, moe as moe_mod, ssm as ssm_mod


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


def _init_ssm_layer(gen: torch.Generator, cfg: ModelConfig, dtype) -> Dict:
    return {"ln": torch.zeros((cfg.d_model,), dtype=dtype, device=gen.device),
            "ssm": ssm_mod.init_ssm(gen, cfg, dtype)}


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
    decoder = (cfg.family in ("dense", "moe", "vlm")
               and cfg.attention in ("gqa", "mla"))
    if not decoder and cfg.family not in ("ssm", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: the port initialises dense/moe/vlm decoders with "
            f"gqa/mla attention and the ssm/hybrid families only (family "
            f"{cfg.family}, attention {cfg.attention})")
    dtype = dtype_of(cfg)
    p: Dict = {
        "embed": layers.init_embed(gen, cfg.vocab_size, cfg.d_model, dtype,
                                   cfg.tie_embeddings),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype,
                                  device=gen.device),
    }
    # one layer at a time: the draw's f32 temporaries stay one layer big
    if decoder:
        p["layers"] = _stack([_init_layer(gen, cfg, dtype)
                              for _ in range(cfg.n_layers)])
    elif cfg.family == "ssm":
        p["layers"] = _stack([_init_ssm_layer(gen, cfg, dtype)
                              for _ in range(cfg.n_layers)])
    else:
        n_ssm = cfg.hybrid_groups * cfg.ssm_per_group
        p["layers"] = _stack([_init_ssm_layer(gen, cfg, dtype)
                              for _ in range(n_ssm)]) if n_ssm else {}
        if cfg.tail_ssm_layers:
            p["tail"] = _stack([_init_ssm_layer(gen, cfg, dtype)
                                for _ in range(cfg.tail_ssm_layers)])
        # the zamba2 hallmark: ONE shared attention + MLP block, reused by
        # every group
        p["shared_block"] = _init_layer(gen, cfg, dtype)
    return p


def embed_inputs(params: Dict, cfg: ModelConfig, tokens: torch.Tensor
                 ) -> torch.Tensor:
    """tokens [B,S] -> [B,S,D].  The reference's stub modality prefix
    (vlm) and sinusoidal positions (``rope_theta == 0``, whisper) belong
    to families not ported yet."""
    if cfg.rope_theta == 0:
        raise NotImplementedError(f"{cfg.name}: sinusoidal positions are "
                                  f"not ported yet")
    return layers.embed_tokens(params["embed"], tokens)


def _logits(params: Dict, cfg: ModelConfig, x: torch.Tensor
            ) -> torch.Tensor:
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return layers.unembed(params["embed"], x)


def _attn_full(p_l: Dict, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor, impl: str = "xla"):
    """Pre-norm full-sequence attention + residual: (x, layer_kv)."""
    h = layers.rms_norm(x, p_l["ln1"], cfg.norm_eps)
    if cfg.attention == "mla":
        out, kv = attn.mla_full(p_l["attn"], cfg, h, positions)
    else:
        out, kv = attn.gqa_full(p_l["attn"], cfg, h, positions, impl=impl)
    return x + out, kv


def _ffn_full(p_l: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Pre-norm dense MLP + residual (the dense branch of the
    reference's ``_ffn_full``; the MoE layers run in the split path)."""
    if cfg.is_moe:
        raise NotImplementedError(f"{cfg.name}: the fused MoE FFN is not "
                                  f"ported; MoE models run split")
    h = layers.rms_norm(x, p_l["ln2"], cfg.norm_eps)
    return x + layers.apply_mlp(p_l["mlp"], h, cfg.mlp_kind)
