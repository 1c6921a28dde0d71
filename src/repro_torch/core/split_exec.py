"""Split layer execution: attention sub-block vs FFN sub-block per layer.

Port of ``src/repro/core/split_exec.py`` (paper §4): the attention stage
returns the post-attention hidden states and the pre-FFN norm, the FFN
stage consumes them with weights gathered out of the SHARED slab arena,
and ``combine`` resumes the residual stream.

The attention stage reads and writes KV through the virtualizer's shared
paged pool (``(x, pool, page_tables, lengths)``); the FFN stage takes
``(arena, slot_table, ffn_input, layer)`` and unpacks the layer's slabs —
no per-model FFN tree exists on the device.  Supported families: dense /
moe / vlm with GQA or MLA attention.  The prefix cache's suffix prefill
(DESIGN.md §11) has its own stages: ``suffix_attn`` attends over the
cached prefix KV read from the pool plus the suffix's fresh KV at the
producing pass's extent, ``suffix_ffn`` runs the FFN with the producing
pass's expert capacity and the prefix's slot offsets, and
``prefill_route`` recomputes the router's top-k choice so a prompt's
routing can be captured.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.virtualizer import ModelView
from repro_torch.core.weight_pool import ModelArenaView
from repro_torch.models import attention as attn
from repro_torch.models import layers, moe as moe_mod
from repro_torch.models import transformer as tfm


class StageFns(NamedTuple):
    embed: Callable          # (params, tokens [B])            -> x [B,1,D]
    attn_stage: Callable     # (params, x, pool, page_tables [L,B,P],
    #                           lengths [B], layer)
    #                           -> (x_resid, ffn_input, pool)
    ffn_stage: Callable      # (arena [S,slab], slot_table [L,spl],
    #                           ffn_input, layer)              -> ffn_out
    combine: Callable        # (x_resid, ffn_out)              -> x
    logits: Callable         # (params, x)                     -> [B,V]
    prefill_embed: Callable  # (params, tokens [B,S])          -> x [B,S,D]
    prefill_attn: Callable   # (params, x [B,S,D], layer)
    #                           -> (x_resid, ffn_input, layer_kv)
    prefill_logits: Callable  # (params, x [B,S,D],
    #                           logit_index int | [B])         -> [B,V]
    n_layers: int
    suffix_attn: Optional[Callable] = None
    # (params, x [B,S_suf,D], prefix_rows [L, fork, *kv_shape],
    #  positions [B,S_suf], layer, kv_extent) -> (x, ffn_input, layer_kv)
    suffix_ffn: Optional[Callable] = None
    # (arena, slot_table, ffn_input, layer, slot_offsets [L,E] | None,
    #  capacity) -> ffn_out
    prefill_route: Optional[Callable] = None
    # (arena, slot_table, ffn_input, layer) -> experts [B,S,k] (MoE only)


def _layer_params(params: Dict, layer: int) -> Dict:
    def pick(tree):
        return {k: pick(v) if isinstance(v, dict) else v[layer]
                for k, v in tree.items()}
    return pick(params["layers"])


def supports_split(cfg: ModelConfig) -> bool:
    """Whether a model runs the split (paged-pool) decode path."""
    return (cfg.family in ("dense", "moe", "vlm")
            and not cfg.attn_free
            and cfg.swa_pattern == 0
            and cfg.attention in ("gqa", "mla"))


def make_stage_fns(cfg: ModelConfig, view: ModelView,
                   w_view: ModelArenaView) -> StageFns:
    """Stage functions over the shared paged pool + the weights arena;
    ``view`` fixes the page geometry, ``w_view`` the slab geometry."""
    if not supports_split(cfg):
        raise ValueError(
            f"split execution supports dense/moe/vlm with gqa/mla attention; "
            f"{cfg.name} ({cfg.family}) uses the fused path")
    tpp = view.tokens_per_page

    def embed(params, tokens):
        return layers.embed_tokens(params["embed"], tokens[:, None])

    def attn_stage(params, x, pool, page_tables, lengths, layer):
        p_l = _layer_params(params, layer)
        table = page_tables[layer]
        h = layers.rms_norm(x, p_l["ln1"], cfg.norm_eps)
        decode = (attn.mla_paged_decode if cfg.attention == "mla"
                  else attn.gqa_paged_decode)
        out, pool = decode(p_l["attn"], cfg, h, pool, table, lengths,
                           tokens_per_page=tpp)
        x = x + out
        # the proxy boundary: the pre-FFN norm runs on the KV side, the
        # normalized hidden states are what crosses to the weights side
        ffn_in = layers.rms_norm(x, p_l["ln2"], cfg.norm_eps)
        return x, ffn_in, pool

    def ffn_stage(arena, slot_table, ffn_in, layer):
        p_l = w_view.unpack_layer(arena, slot_table[layer])
        if not cfg.is_moe:
            return layers.apply_mlp(p_l["mlp"], ffn_in, cfg.mlp_kind)
        B, S = ffn_in.shape[0], ffn_in.shape[1]
        if B > 1 and S > 1:
            # coalesced prefill: each request's prompt is routed on its
            # own, so expert capacity is per request and a [B,S] pass
            # equals B separate [1,S] passes (the reference vmaps this)
            return torch.cat([moe_mod.apply_moe(p_l["moe"], ffn_in[i:i + 1],
                                                cfg)[0]
                              for i in range(B)])
        return moe_mod.apply_moe(p_l["moe"], ffn_in, cfg)[0]

    def combine(x, ffn_out):
        return x + ffn_out

    def logits(params, x):
        x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
        return layers.unembed(params["embed"], x)[:, 0]

    def prefill_embed(params, tokens):
        return layers.embed_tokens(params["embed"], tokens)

    def prefill_attn(params, x, layer):
        p_l = _layer_params(params, layer)
        B, S = x.shape[0], x.shape[1]
        positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
        x, layer_kv = tfm._attn_full(p_l, cfg, x, positions)
        ffn_in = layers.rms_norm(x, p_l["ln2"], cfg.norm_eps)
        return x, ffn_in, layer_kv

    def prefill_logits(params, x, logit_index):
        # ``logit_index`` is an int (one shared unpadded length) or a [B]
        # tensor (a coalesced batch, one true length per row)
        if isinstance(logit_index, int):
            x_last = x[:, logit_index:logit_index + 1]
        else:
            idx = logit_index.long().to(x.device)[:, None, None]
            x_last = x.gather(1, idx.expand(-1, 1, x.shape[-1]))
        x_last = layers.rms_norm(x_last, params["final_norm"], cfg.norm_eps)
        return layers.unembed(params["embed"], x_last)[:, 0]

    # ---- the prefix cache's suffix prefill (DESIGN.md §11) --------------
    # The cached prefix KV (read from the pool) is concatenated with the
    # suffix's fresh KV at the PRODUCING pass's reduction extent; the FFN
    # keeps the producing pass's expert capacity and starts each expert's
    # slots behind the prefix's routed pairs, so every suffix row is the
    # full pass's row.

    def suffix_attn(params, x, prefix_rows, positions, layer, kv_extent):
        p_l = _layer_params(params, layer)
        rows = prefix_rows[layer]
        if cfg.attention == "mla":
            r = cfg.mla.kv_lora_rank
            prefix_a, prefix_b = rows[None, :, :r], rows[None, :, r:]
            suffix = attn.mla_suffix
        else:
            prefix_a, prefix_b = rows[None, :, 0], rows[None, :, 1]
            suffix = attn.gqa_suffix
        h = layers.rms_norm(x, p_l["ln1"], cfg.norm_eps)
        out, layer_kv = suffix(p_l["attn"], cfg, h, positions, prefix_a,
                               prefix_b, kv_extent)
        x = x + out
        ffn_in = layers.rms_norm(x, p_l["ln2"], cfg.norm_eps)
        return x, ffn_in, layer_kv

    def suffix_ffn(arena, slot_table, ffn_in, layer, slot_offsets,
                   capacity):
        p_l = w_view.unpack_layer(arena, slot_table[layer])
        if not cfg.is_moe:
            return layers.apply_mlp(p_l["mlp"], ffn_in, cfg.mlp_kind)
        # a suffix group is one row, so the plain dispatch is the
        # producing pass's
        offset = None if slot_offsets is None else slot_offsets[layer]
        return moe_mod.apply_moe(p_l["moe"], ffn_in, cfg, capacity=capacity,
                                 slot_offset=offset)[0]

    prefill_route = None
    if cfg.is_moe:
        def prefill_route(arena, slot_table, ffn_in, layer):
            # the router lives in the layer's "rest" unit: its slabs only
            p_l = w_view.unpack_layer(arena, slot_table[layer], kind="rest")
            B, S, d = ffn_in.shape
            _, experts, _ = moe_mod.route(p_l["moe"], ffn_in.reshape(-1, d),
                                          cfg)
            return experts.reshape(B, S, cfg.experts_per_token)

    return StageFns(embed, attn_stage, ffn_stage, combine, logits,
                    prefill_embed, prefill_attn, prefill_logits,
                    cfg.n_layers, suffix_attn, suffix_ffn, prefill_route)


def split_params(params: Dict, cfg: ModelConfig) -> Tuple[Dict, Dict]:
    """Partition a param tree into (kv_pool_params, weights_pool_params):
    FFN/MoE weights go to the weights pool; embeddings, norms and
    attention stay with the KV pool."""
    ffn_keys = ("mlp", "moe")

    def walk(src, kv_dst, w_dst, path=()):
        for k, v in src.items():
            p = path + (k,)
            if isinstance(v, dict):
                kv_sub, w_sub = {}, {}
                walk(v, kv_sub, w_sub, p)
                if kv_sub:
                    kv_dst[k] = kv_sub
                if w_sub:
                    w_dst[k] = w_sub
            else:
                is_ffn = any(key in p for key in ffn_keys)
                (w_dst if is_ffn else kv_dst)[k] = v

    kv_tree: Dict = {}
    w_tree: Dict = {}
    walk(params, kv_tree, w_tree)
    return kv_tree, w_tree


def merge_params(kv_tree: Dict, w_tree: Dict) -> Dict:
    out: Dict = {}

    def walk(src, dst):
        for k, v in src.items():
            if isinstance(v, dict):
                walk(v, dst.setdefault(k, {}))
            else:
                dst[k] = v

    walk(kv_tree, out)
    walk(w_tree, out)
    return out
