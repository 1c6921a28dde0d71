"""Decode-side programs of the dense-cache Model path: cache init, prefill
(cache seeding) and the one-token step, for every family.

Port of ``src/repro/models/decode.py`` (``init_cache`` :39, ``prefill``
:121 with ``_prefill_swa`` :212 and ``_prefill_hybrid`` :254,
``decode_step`` :291 with ``_decode_swa`` :375 and ``_decode_hybrid``
:408).  The reference scans over stacked layers and returns a new cache;
here a Python loop runs the layers and the cache is updated IN PLACE, so
a caller may pass views of a larger cache (the engine passes one batch
slot of the ssm / hybrid caches).  ``impl`` picks the attention route as
the reference's does: ``"flash"`` prefill and ``"paged"`` decode take the
hand-written kernels where the reference reaches its Pallas kernels (the
GQA self-attention layers, gemma3's ring included: ``attention.py``
``ring_count``), ``"xla"`` the masked softmax.  Sliding-window prefill
layers, cross-attention, the whisper encoder and MLA read through the
masked softmax on every route, as the reference's XLA does.

Cache layouts (T = max context length in the cache):
  gqa dense/moe/vlm : {"k","v": [L,B,T,KV,hd]}
  mla               : {"latent": [L,B,T,r], "rope": [L,B,T,rp]}
  gemma3 swa        : local ring  {"lk","lv": [G,P-1,B,W,KV,hd],
                                   "lpos": [G,P-1,B,W] int32, -1 = empty}
                      global full {"gk","gv": [G,B,T,KV,hd]}
  ssm               : {"h": [L,B,H,P,N] f32, "conv": [L,B,W-1,conv]}
  hybrid            : ssm stacks for the grouped layers ({"h", "conv"}) and
                      the tail ({"tail_h", "tail_conv"}) + the shared
                      attention block's {"k", "v": [G,B,T,KV,hd]}
  audio             : self {"k","v": [L,B,T,KV,hd]} + static cross
                      {"ck","cv": [L,B,Tenc,KV,hd]}
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers, ssm as ssm_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.hooks import IDENTITY_HOOKS, Hooks


def _pick(tree: Dict, i: int) -> Dict:
    """Layer ``i`` of a stacked param tree."""
    return {k: _pick(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _layer(params: Dict, i: int, hooks: Hooks, top: str = "layers") -> Dict:
    """Layer ``i`` of the stack ``params[top]``, its leaves gathered where
    the serve step's ``hooks.params`` gathers them (the attention and SSM
    leaves under DP attention)."""
    return hooks.params.gather(_pick(params[top], i), top)


def _audio_layer(params: Dict, cfg: ModelConfig, i: int, cache: Dict,
                 hooks: Hooks) -> Dict:
    """Whisper decoder layer ``i`` with its whole ``self`` / ``cross``
    weights cut to the heads its cache layers hold (``attention.
    rank_heads``: this rank's under monolithic Type I)."""
    p_l = _layer(params, i, hooks)
    return dict(p_l, **{k: attn.rank_heads(p_l[k], cfg, cache[c].shape[-2],
                                           hooks.tp)
                        for k, c in (("self", "k"), ("cross", "ck"))})


def _prefill_rows(cache: torch.Tensor, t: torch.Tensor, offset: int
                  ) -> None:
    """A prefill's rows ``t`` [B,S,...] into a cache layer [B,T_loc,...]
    that holds the sequence's positions ``[offset, offset + T_loc)``:
    its rows ``[offset, offset + T_loc) & [0, S)``, from the cache's
    first row (``offset`` 0 and T_loc >= S: rows ``[0, S)``)."""
    n = min(t.shape[1] - offset, cache.shape[1])
    if n > 0:
        cache[:, :n] = t[:, offset:offset + n]


def _write_prefill(cache_k: torch.Tensor, cache_v: torch.Tensor, kv,
                   hooks: Hooks, dst=None, src=None,
                   offset: Optional[int] = None) -> None:
    """A prefill's K / V [B,S,n,hd] into a cache layer [B,T_loc,KV,hd]:
    the rows of the positions it holds (``_prefill_rows``; ``offset``
    defaults to ``hooks.kv_offset``, this rank's slice of a sequence-
    sharded cache, and is 0 for one that holds its rows whole), or the
    ring slots ``dst`` from positions ``src``; the heads as the cache
    holds them (``attention.cache_heads``)."""
    offset = hooks.kv_offset if offset is None else offset
    for cache, t in zip((cache_k, cache_v), kv):
        t = attn.cache_heads(t, cache.shape[2], hooks.tp)
        if dst is None:
            _prefill_rows(cache, t, offset)
        else:
            cache[:, dst] = t[:, src].to(cache.dtype)


def kv_dtype_of(cfg: ModelConfig, kv_dtype: Optional[str]) -> torch.dtype:
    """The cache's element type: the model's (None), fp8-e4m3 ("f8": half
    the cache bytes, dequantized at attention) or a torch dtype's name."""
    if kv_dtype is None:
        return tfm.dtype_of(cfg)
    if kv_dtype == "f8":
        return torch.float8_e4m3fn
    return getattr(torch, kv_dtype)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device,
               kv_dtype: Optional[str] = None) -> Dict:
    dt = kv_dtype_of(cfg, kv_dtype)
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    fam = cfg.family
    if fam in ("dense", "vlm", "moe"):
        if cfg.attention == "mla":
            m = cfg.mla
            return {"latent": zeros(L, batch, max_len, m.kv_lora_rank),
                    "rope": zeros(L, batch, max_len, m.qk_rope_head_dim)}
        if cfg.swa_pattern > 0:
            G, P = cfg.n_layers // cfg.swa_pattern, cfg.swa_pattern
            W = min(cfg.sliding_window, max_len)
            return {"lk": zeros(G, P - 1, batch, W, KV, hd),
                    "lv": zeros(G, P - 1, batch, W, KV, hd),
                    "lpos": torch.full((G, P - 1, batch, W), -1,
                                       dtype=torch.int32, device=device),
                    "gk": zeros(G, batch, max_len, KV, hd),
                    "gv": zeros(G, batch, max_len, KV, hd)}
        return {"k": zeros(L, batch, max_len, KV, hd),
                "v": zeros(L, batch, max_len, KV, hd)}
    if fam == "audio":
        return {"k": zeros(L, batch, max_len, KV, hd),
                "v": zeros(L, batch, max_len, KV, hd),
                "ck": zeros(L, batch, cfg.encoder_seq, KV, hd),
                "cv": zeros(L, batch, cfg.encoder_seq, KV, hd)}
    if fam not in ("ssm", "hybrid"):
        raise ValueError(f"unknown family {fam}")

    st = ssm_mod.init_ssm_state(cfg, batch, device)

    def stack(n: int, leaf: torch.Tensor) -> torch.Tensor:
        return zeros(n, *leaf.shape, dtype=leaf.dtype)

    if fam == "ssm":
        return {"h": stack(L, st["h"]), "conv": stack(L, st["conv"])}
    G = cfg.hybrid_groups
    n_ssm = G * cfg.ssm_per_group
    c = {"h": stack(n_ssm, st["h"]), "conv": stack(n_ssm, st["conv"]),
         "k": zeros(G, batch, max_len, KV, hd),
         "v": zeros(G, batch, max_len, KV, hd)}
    if cfg.tail_ssm_layers:
        c["tail_h"] = stack(cfg.tail_ssm_layers, st["h"])
        c["tail_conv"] = stack(cfg.tail_ssm_layers, st["conv"])
    return c


def _ssm_full_layer(p_l: Dict, cfg: ModelConfig, x: torch.Tensor,
                    hs: torch.Tensor, convs: torch.Tensor, i: int,
                    hooks: Hooks) -> torch.Tensor:
    """One pre-norm SSD layer over the sequence; its final state replaces
    entry ``i`` of the cache stacks."""
    out, st = ssm_mod.ssm_full(p_l["ssm"], cfg,
                               layers.rms_norm(x, p_l["ln"], cfg.norm_eps),
                               hooks=hooks)
    hs[i].copy_(st["h"])
    convs[i].copy_(st["conv"])
    return x + hooks.act(out)


def _ssm_decode_layer(p_l: Dict, cfg: ModelConfig, x: torch.Tensor,
                      hs: torch.Tensor, convs: torch.Tensor, i: int,
                      hooks: Hooks) -> torch.Tensor:
    out, st = ssm_mod.ssm_decode(
        p_l["ssm"], cfg, layers.rms_norm(x, p_l["ln"], cfg.norm_eps),
        {"h": hs[i], "conv": convs[i]}, hooks=hooks)
    hs[i].copy_(st["h"])
    convs[i].copy_(st["conv"])
    return x + hooks.act(out)


def prefill(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
            cache: Dict, *, embeddings: Optional[torch.Tensor] = None,
            encoder_frames: Optional[torch.Tensor] = None,
            impl: str = "xla", logit_index: Optional[int] = None,
            hooks: Hooks = IDENTITY_HOOKS) -> Tuple[torch.Tensor, Dict]:
    """tokens [B,S_txt] (after the stub ``embeddings`` [B,S_emb,D] prefix
    of a vlm; whisper's ``encoder_frames`` [B,T_enc,D]) -> (logits [B,V]
    at ``logit_index`` (default and upper limit: the last position), the
    cache seeded in place).  Every position runs, padding included: the
    caches and SSM states hold the whole sequence, as the reference's
    do."""
    fam = cfg.family
    B = tokens.shape[0]
    S = tokens.shape[1] + (embeddings.shape[1] if embeddings is not None
                           else 0)
    positions = tfm.positions_of(B, S, tokens.device)
    x = tfm.embed_inputs(params, cfg, tokens, embeddings, positions, hooks)
    if fam in ("dense", "vlm", "moe"):
        if cfg.swa_pattern > 0:
            x = _prefill_swa(params, cfg, x, positions, cache, impl, hooks)
        elif cfg.attention == "mla":
            for i in range(cfg.n_layers):
                p_l = _layer(params, i, hooks)
                x, (lat, rope) = tfm._attn_full(p_l, cfg, x, positions,
                                                hooks=hooks)
                x, _ = tfm._ffn_full(p_l, cfg, x, hooks=hooks)
                _prefill_rows(cache["latent"][i], lat, hooks.kv_offset)
                _prefill_rows(cache["rope"][i], rope, hooks.kv_offset)
        else:
            for i in range(cfg.n_layers):
                p_l = _layer(params, i, hooks)
                x, kv = tfm._attn_full(p_l, cfg, x, positions, impl,
                                       hooks=hooks)
                x, _ = tfm._ffn_full(p_l, cfg, x, hooks=hooks)
                _write_prefill(cache["k"][i], cache["v"][i], kv, hooks)
    elif fam == "audio":
        enc_out = tfm.encode(params, cfg, encoder_frames, hooks)
        for i in range(cfg.n_layers):
            x, kv, cross = tfm._decoder_layer(
                _audio_layer(params, cfg, i, cache, hooks), cfg, x,
                positions, enc_out, impl, hooks)
            _write_prefill(cache["k"][i], cache["v"][i], kv, hooks)
            _write_prefill(cache["ck"][i], cache["cv"][i], cross, hooks,
                           offset=0)
    elif fam == "ssm":
        for i in range(cfg.n_layers):
            x = _ssm_full_layer(_layer(params, i, hooks), cfg, x,
                                cache["h"], cache["conv"], i, hooks)
    elif fam == "hybrid":
        shared = hooks.params.gather(params["shared_block"], "shared_block")
        per = cfg.ssm_per_group
        for g in range(cfg.hybrid_groups):
            for i in range(g * per, (g + 1) * per):
                x = _ssm_full_layer(_layer(params, i, hooks), cfg, x,
                                    cache["h"], cache["conv"], i, hooks)
            x, kv = tfm._attn_full(shared, cfg, x, positions, impl,
                                   hooks=hooks)
            x, _ = tfm._ffn_full(shared, cfg, x, hooks=hooks)
            _write_prefill(cache["k"][g], cache["v"][g], kv, hooks)
        for i in range(cfg.tail_ssm_layers):
            x = _ssm_full_layer(_layer(params, i, hooks, "tail"), cfg, x,
                                cache["tail_h"], cache["tail_conv"], i, hooks)
    else:
        raise ValueError(f"unknown family {fam}")
    # clamped into the sequence, as the reference's dynamic slice is
    at = S - 1 if logit_index is None else min(logit_index, S - 1)
    return tfm._logits(params, cfg, x[:, at:at + 1], hooks)[:, 0], cache


def ring_layout(S: int, W: int) -> np.ndarray:
    """[W] position each ring slot holds after a prefill of S tokens, -1
    where none (``decode.py:220-223``): slot w holds the latest position
    p < S with p % W == w, if it is within the last W."""
    slot_pos = np.array([S - 1 - ((S - 1 - w) % W) for w in range(W)])
    return np.where(slot_pos >= max(0, S - W), slot_pos, -1)


def _prefill_swa(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor, cache: Dict, impl: str,
                 hooks: Hooks) -> torch.Tensor:
    """gemma3: groups of (P-1 local ring layers + 1 global layer).  Local
    layers take the window-masked softmax (the reference's XLA route);
    global layers the flash kernel under ``impl="flash"``.  A local ring
    keeps its old rows where no position lands (S < W) and takes the
    static layout's positions, -1 included."""
    G, P = cfg.n_layers // cfg.swa_pattern, cfg.swa_pattern
    B, S = x.shape[:2]
    W = cache["lk"].shape[3]
    slot_pos = ring_layout(S, W)
    filled = np.flatnonzero(slot_pos >= 0)        # host-known: no sync
    dst = torch.as_tensor(filled, device=x.device)
    src = torch.as_tensor(slot_pos[filled], device=x.device)
    ring_pos = torch.as_tensor(slot_pos, dtype=torch.int32, device=x.device)
    for g in range(G):
        for j in range(P - 1):
            p_l = _layer(params, g * P + j, hooks)
            x, kv = tfm._attn_full(p_l, cfg, x, positions, impl,
                                   window=cfg.sliding_window, hooks=hooks)
            x, _ = tfm._ffn_full(p_l, cfg, x, hooks=hooks)
            _write_prefill(cache["lk"][g, j], cache["lv"][g, j], kv, hooks,
                           dst, src)
            cache["lpos"][g, j] = ring_pos
        p_g = _layer(params, g * P + P - 1, hooks)
        x, kv = tfm._attn_full(p_g, cfg, x, positions, impl, hooks=hooks)
        x, _ = tfm._ffn_full(p_g, cfg, x, hooks=hooks)
        _write_prefill(cache["gk"][g], cache["gv"][g], kv, hooks)
    return x


def decode_step(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Dict, lengths: Union[int, torch.Tensor], *,
                impl: str = "xla", hooks: Hooks = IDENTITY_HOOKS
                ) -> Tuple[torch.Tensor, Dict]:
    """tokens [B] next ids; lengths [B] (or one int for every row) current
    context lengths (the new token's KV goes to that index).  Returns
    (logits [B,V], the cache updated in place).  ``hooks`` reach every
    site the reference's do (``decode.py:291-443``)."""
    fam = cfg.family
    B = tokens.shape[0]
    lengths = torch.as_tensor(lengths, device=tokens.device)
    if lengths.dim() == 0:
        lengths = lengths.expand(B)
    pos = lengths[:, None]
    x = tfm.embed_inputs(params, cfg, tokens[:, None], None,
                         pos if cfg.rope_theta == 0 else None, hooks)
    if fam in ("dense", "vlm", "moe"):
        if cfg.swa_pattern > 0:
            x = _decode_swa(params, cfg, x, cache, lengths, impl, hooks)
        else:
            for i in range(cfg.n_layers):
                p_l = _layer(params, i, hooks)
                h = layers.rms_norm(x, p_l["ln1"], cfg.norm_eps)
                if cfg.attention == "mla":
                    out = attn.mla_decode(p_l["attn"], cfg, h,
                                          cache["latent"][i],
                                          cache["rope"][i], lengths,
                                          hooks=hooks)
                else:
                    out = attn.gqa_decode(p_l["attn"], cfg, h,
                                          cache["k"][i], cache["v"][i],
                                          lengths, impl=impl, hooks=hooks)
                x = x + hooks.act(out)
                x, _ = tfm._ffn_full(p_l, cfg, x, hooks=hooks)
    elif fam == "audio":
        for i in range(cfg.n_layers):
            p_l = _audio_layer(params, cfg, i, cache, hooks)
            h = layers.rms_norm(x, p_l["ln1"], cfg.norm_eps)
            x = x + hooks.act(attn.gqa_decode(
                p_l["self"], cfg, h, cache["k"][i], cache["v"][i], lengths,
                impl=impl, hooks=hooks))
            h = layers.rms_norm(x, p_l["ln2"], cfg.norm_eps)
            out, _ = attn.gqa_full(p_l["cross"], cfg, h, pos,
                                   kv_override=(cache["ck"][i],
                                                cache["cv"][i]),
                                   causal=False, hooks=hooks)
            x, _ = tfm._ffn_full(p_l, cfg, x + hooks.act(out), hooks=hooks,
                                 ln="ln3")
    elif fam == "ssm":
        for i in range(cfg.n_layers):
            x = _ssm_decode_layer(_layer(params, i, hooks), cfg, x,
                                  cache["h"], cache["conv"], i, hooks)
    elif fam == "hybrid":
        shared = hooks.params.gather(params["shared_block"], "shared_block")
        per = cfg.ssm_per_group
        for g in range(cfg.hybrid_groups):
            for i in range(g * per, (g + 1) * per):
                x = _ssm_decode_layer(_layer(params, i, hooks), cfg, x,
                                      cache["h"], cache["conv"], i, hooks)
            h = layers.rms_norm(x, shared["ln1"], cfg.norm_eps)
            x = x + hooks.act(attn.gqa_decode(
                shared["attn"], cfg, h, cache["k"][g], cache["v"][g],
                lengths, impl=impl, hooks=hooks))
            x, _ = tfm._ffn_full(shared, cfg, x, hooks=hooks)
        for i in range(cfg.tail_ssm_layers):
            x = _ssm_decode_layer(_layer(params, i, hooks, "tail"), cfg, x,
                                  cache["tail_h"], cache["tail_conv"], i,
                                  hooks)
    else:
        raise ValueError(f"unknown family {fam}")
    return tfm._logits(params, cfg, x, hooks)[:, 0], cache


def _decode_swa(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                cache: Dict, lengths: torch.Tensor, impl: str, hooks: Hooks
                ) -> torch.Tensor:
    """gemma3's step: every local ring's position slot written at once
    and the ring count taken once (the rings' positions are the same in
    every local layer), then per group P-1 ``swa_decode`` layers and one
    global ``gqa_decode`` layer."""
    G, P = cfg.n_layers // cfg.swa_pattern, cfg.swa_pattern
    attn.ring_write_positions(cache["lpos"], lengths)
    count = attn.ring_count(cache["lpos"][0, 0])
    for g in range(G):
        for j in range(P - 1):
            p_l = _layer(params, g * P + j, hooks)
            h = layers.rms_norm(x, p_l["ln1"], cfg.norm_eps)
            x = x + hooks.act(attn.swa_decode(
                p_l["attn"], cfg, h, cache["lk"][g, j], cache["lv"][g, j],
                cache["lpos"][g, j], lengths, count, impl=impl, hooks=hooks))
            x, _ = tfm._ffn_full(p_l, cfg, x, hooks=hooks)
        p_g = _layer(params, g * P + P - 1, hooks)
        h = layers.rms_norm(x, p_g["ln1"], cfg.norm_eps)
        x = x + hooks.act(attn.gqa_decode(
            p_g["attn"], cfg, h, cache["gk"][g], cache["gv"][g], lengths,
            impl=impl, hooks=hooks))
        x, _ = tfm._ffn_full(p_g, cfg, x, hooks=hooks)
    return x
