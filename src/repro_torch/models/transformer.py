"""Decoder parameters, the full-sequence sub-blocks and the training
forward.

Port of ``src/repro/models/transformer.py`` except its sliding-window and
audio parts: ``init_params`` (``:106``) for the dense / MoE / VLM decoders
with GQA or MLA attention and for the ssm and hybrid (zamba2) families,
``embed_inputs`` (``:152``), ``_logits`` (``:165``), ``_attn_full``
(``:175``), ``_ffn_full`` (``:186``) and ``forward`` (``:207``).  The param
tree has the reference's shape: per-layer leaves stacked on a leading
axis under ``"layers"`` (and ``"tail"``), the hybrid's ONE shared
attention + MLP block under ``"shared_block"``, so ``repro_torch.bridge``
maps a reference tree onto it leaf for leaf.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

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


def _ffn_full(p_l: Dict, cfg: ModelConfig, x: torch.Tensor,
              moe_path: str = "capacity"):
    """Pre-norm MLP or routed-expert FFN + residual: (x, aux).  MoE layers
    take the capacity path (``apply_moe``) or the grouped-GEMM path
    (``apply_moe_grouped``); a dense layer's aux is 0."""
    h = layers.rms_norm(x, p_l["ln2"], cfg.norm_eps)
    if cfg.is_moe:
        if moe_path not in ("capacity", "grouped"):
            raise ValueError(f"unknown moe_path {moe_path!r}")
        fn = (moe_mod.apply_moe if moe_path == "capacity"
              else moe_mod.apply_moe_grouped)
        f, aux = fn(p_l["moe"], h, cfg)
    else:
        f = layers.apply_mlp(p_l["mlp"], h, cfg.mlp_kind)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + f, aux


def _unstack(tree, n: int):
    """Stacked per-layer leaves [n, ...] -> n per-layer trees of views
    (one ``unbind`` per leaf, so the backward stacks each leaf's n
    gradients once)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in parts} for i in range(n)]
    return torch.unbind(tree)


def _call(body, remat: bool, *args):
    """``body(*args)``, activations recomputed in the backward when
    ``remat`` (the reference's ``jax.checkpoint`` of the scan body)."""
    if remat:
        return checkpoint(body, *args, use_reentrant=False)
    return body(*args)


def forward(params: Dict, cfg: ModelConfig, tokens: torch.Tensor, *,
            impl: str = "xla", moe_path: str = "capacity",
            remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward (training): (logits [B,S,V], aux scalar f32).

    Port of ``transformer.py:207-300`` for the dense / vlm / moe decoders
    (GQA or MLA attention; MoE by ``moe_path``, the aux loss averaged
    over the layers) and the ssm and hybrid stacks.  ``remat=True``
    recomputes each layer's (each hybrid group's) activations in the
    backward.  Sliding-window attention and the audio family are not
    ported and raise; the vlm stub-embedding prefix is not ported either
    (text tokens only).
    """
    fam = cfg.family
    if fam not in ("dense", "vlm", "moe", "ssm", "hybrid"):
        raise NotImplementedError(f"{cfg.name}: family {fam} is not ported")
    if cfg.sliding_window:
        raise NotImplementedError(f"{cfg.name}: sliding-window attention "
                                  f"is not ported")
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    x = embed_inputs(params, cfg, tokens)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def block(xc, p_l):
        xc, _ = _attn_full(p_l, cfg, xc, positions, impl)
        return _ffn_full(p_l, cfg, xc, moe_path)

    def ssm_block(xc, p_l):
        h = layers.rms_norm(xc, p_l["ln"], cfg.norm_eps)
        out, _ = ssm_mod.ssm_full(p_l["ssm"], cfg, h)
        return xc + out

    if fam in ("dense", "vlm", "moe"):
        for p_l in _unstack(params["layers"], cfg.n_layers):
            x, a = _call(block, remat, x, p_l)
            aux = aux + a
        return _logits(params, cfg, x), aux / max(cfg.n_layers, 1)
    if fam == "ssm":
        for p_l in _unstack(params["layers"], cfg.n_layers):
            x = _call(ssm_block, remat, x, p_l)
        return _logits(params, cfg, x), aux

    per = cfg.ssm_per_group
    ssm_layers = _unstack(params["layers"], cfg.hybrid_groups * per)

    def group(xc, group_layers):
        for p_l in group_layers:
            xc = ssm_block(xc, p_l)
        xc, _ = _attn_full(params["shared_block"], cfg, xc, positions, impl)
        xc, _ = _ffn_full(params["shared_block"], cfg, xc)
        return xc

    for g in range(cfg.hybrid_groups):
        x = _call(group, remat, x, ssm_layers[g * per:(g + 1) * per])
    if cfg.tail_ssm_layers:
        for p_l in _unstack(params["tail"], cfg.tail_ssm_layers):
            x = ssm_block(x, p_l)
    return _logits(params, cfg, x), aux
