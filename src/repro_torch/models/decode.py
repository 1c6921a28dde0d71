"""Decode-side programs of the fused fallback families: cache init,
prefill (cache seeding) and the one-token step.

Port of the ssm and hybrid branches of ``src/repro/models/decode.py``
(``init_cache`` :38, ``prefill`` :124 with ``_prefill_hybrid`` :254,
``decode_step`` :285 with ``_decode_hybrid`` :408).  The reference scans
over stacked layers and returns a new cache; here a Python loop runs the
layers and the cache is updated IN PLACE, so a caller may pass views of
a larger cache (the engine passes one batch slot).  The other families
raise ``NotImplementedError``: the split path serves dense/moe/vlm, and
the audio and sliding-window families are not ported yet.

Cache layouts (T = max context length in the cache):
  ssm    : {"h": [L,B,H,P,N] f32, "conv": [L,B,W-1,conv]}
  hybrid : ssm stacks for the grouped layers ({"h", "conv"}) and the tail
           ({"tail_h", "tail_conv"}) + the shared attention block's
           {"k", "v": [G,B,T,KV,hd]}
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers, ssm as ssm_mod
from repro_torch.models import transformer as tfm


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in ("ssm", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: the fused dense-cache path of the {cfg.family} "
            f"family is not ported (dense/moe/vlm run the split path; "
            f"audio and sliding-window models are not ported yet)")


def _pick(tree: Dict, i: int) -> Dict:
    """Layer ``i`` of a stacked param tree."""
    return {k: _pick(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device) -> Dict:
    _check_family(cfg)
    st = ssm_mod.init_ssm_state(cfg, batch, device)

    def stack(n: int, leaf: torch.Tensor) -> torch.Tensor:
        return torch.zeros((n,) + leaf.shape, dtype=leaf.dtype,
                           device=device)

    if cfg.family == "ssm":
        return {"h": stack(cfg.n_layers, st["h"]),
                "conv": stack(cfg.n_layers, st["conv"])}
    G, KV, hd = cfg.hybrid_groups, cfg.n_kv_heads, cfg.head_dim
    n_ssm = G * cfg.ssm_per_group
    kv = torch.zeros((G, batch, max_len, KV, hd), dtype=tfm.dtype_of(cfg),
                     device=device)
    c = {"h": stack(n_ssm, st["h"]), "conv": stack(n_ssm, st["conv"]),
         "k": kv, "v": torch.zeros_like(kv)}
    if cfg.tail_ssm_layers:
        c["tail_h"] = stack(cfg.tail_ssm_layers, st["h"])
        c["tail_conv"] = stack(cfg.tail_ssm_layers, st["conv"])
    return c


def _ssm_full_layer(p_l: Dict, cfg: ModelConfig, x: torch.Tensor,
                    hs: torch.Tensor, convs: torch.Tensor, i: int
                    ) -> torch.Tensor:
    """One pre-norm SSD layer over the sequence; its final state replaces
    entry ``i`` of the cache stacks."""
    out, st = ssm_mod.ssm_full(p_l["ssm"], cfg,
                               layers.rms_norm(x, p_l["ln"], cfg.norm_eps))
    hs[i].copy_(st["h"])
    convs[i].copy_(st["conv"])
    return x + out


def _ssm_decode_layer(p_l: Dict, cfg: ModelConfig, x: torch.Tensor,
                      hs: torch.Tensor, convs: torch.Tensor, i: int
                      ) -> torch.Tensor:
    out, st = ssm_mod.ssm_decode(
        p_l["ssm"], cfg, layers.rms_norm(x, p_l["ln"], cfg.norm_eps),
        {"h": hs[i], "conv": convs[i]})
    hs[i].copy_(st["h"])
    convs[i].copy_(st["conv"])
    return x + out


def prefill(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
            cache: Dict, *, impl: str = "xla",
            logit_index: Optional[int] = None) -> Tuple[torch.Tensor, Dict]:
    """tokens [B,S] -> (logits [B,V] at ``logit_index`` (default and
    upper limit: the last position), the cache seeded in place).  Every
    position runs, padding included: the SSM states continue from the
    whole sequence, as the reference's do."""
    _check_family(cfg)
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    x = tfm.embed_inputs(params, cfg, tokens)
    if cfg.family == "ssm":
        for i in range(cfg.n_layers):
            x = _ssm_full_layer(_pick(params["layers"], i), cfg, x,
                                cache["h"], cache["conv"], i)
    else:
        shared = params["shared_block"]
        per = cfg.ssm_per_group
        for g in range(cfg.hybrid_groups):
            for i in range(g * per, (g + 1) * per):
                x = _ssm_full_layer(_pick(params["layers"], i), cfg, x,
                                    cache["h"], cache["conv"], i)
            x, (k, v) = tfm._attn_full(shared, cfg, x, positions, impl)
            x, _ = tfm._ffn_full(shared, cfg, x)
            cache["k"][g, :, :S] = k
            cache["v"][g, :, :S] = v
        for i in range(cfg.tail_ssm_layers):
            x = _ssm_full_layer(_pick(params["tail"], i), cfg, x,
                                cache["tail_h"], cache["tail_conv"], i)
    # clamped into the sequence, as the reference's dynamic slice is
    at = S - 1 if logit_index is None else min(logit_index, S - 1)
    return tfm._logits(params, cfg, x[:, at:at + 1])[:, 0], cache


def decode_step(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Dict, lengths: torch.Tensor, *, impl: str = "xla"
                ) -> Tuple[torch.Tensor, Dict]:
    """tokens [B] next ids; lengths [B] current context lengths (the new
    token's KV goes to that index).  Returns (logits [B,V], the cache
    updated in place)."""
    _check_family(cfg)
    x = tfm.embed_inputs(params, cfg, tokens[:, None])
    if cfg.family == "ssm":
        for i in range(cfg.n_layers):
            x = _ssm_decode_layer(_pick(params["layers"], i), cfg, x,
                                  cache["h"], cache["conv"], i)
    else:
        shared = params["shared_block"]
        per = cfg.ssm_per_group
        for g in range(cfg.hybrid_groups):
            for i in range(g * per, (g + 1) * per):
                x = _ssm_decode_layer(_pick(params["layers"], i), cfg, x,
                                      cache["h"], cache["conv"], i)
            h = layers.rms_norm(x, shared["ln1"], cfg.norm_eps)
            x = x + attn.gqa_decode(shared["attn"], cfg, h, cache["k"][g],
                                    cache["v"][g], lengths, impl=impl)
            x, _ = tfm._ffn_full(shared, cfg, x)
        for i in range(cfg.tail_ssm_layers):
            x = _ssm_decode_layer(_pick(params["tail"], i), cfg, x,
                                  cache["tail_h"], cache["tail_conv"], i)
    return tfm._logits(params, cfg, x)[:, 0], cache
