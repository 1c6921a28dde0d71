"""Attention for the serving paths: GQA and MLA (MiniCPM3 style).

Port of the parts of ``src/repro/models/attention.py`` the serving paths
run: whole-sequence attention for prefill (``gqa_full`` with the
reference's ``impl`` routes, ``mla_full``), one-token decode against the
shared paged pool (``gqa_paged_decode`` / ``mla_paged_decode``,
``attention.py:256-334``) for the split-execution path, and one-token
decode against a contiguous per-model cache (``write_kv_cache`` /
``gqa_decode``, ``:193-253``) for the fused fallback families.  Decode
writes the new token's KV IN PLACE (into the pool, or the cache layer)
and reads the KV back through the hand-written kernels.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import layers

NEG_INF = -1e30


def causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor) -> torch.Tensor:
    """Boolean [.., S, T] mask: True = attend."""
    return q_pos[..., :, None] >= k_pos[..., None, :]


# ---------------------------------------------------------------------------
# Core grouped attention
# ---------------------------------------------------------------------------

def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: Optional[torch.Tensor], scale: float
                   ) -> torch.Tensor:
    """Grouped-query attention with f32 scores and softmax.

    q: [B,S,H,D]; k/v: [B,T,KV,D]; mask: broadcastable to [B,KV,G,S,T].
    Returns [B,S,H,Dv] in v's dtype.
    """
    B, S, H, D = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, D)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * scale
    if mask is not None:
        scores = torch.where(mask, scores,
                             torch.tensor(NEG_INF, device=scores.device))
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(B, S, H, v.shape[-1])


# ---------------------------------------------------------------------------
# GQA (covers MHA: KV==H, and MQA: KV==1)
# ---------------------------------------------------------------------------

def init_gqa(gen: torch.Generator, cfg: ModelConfig, dtype) -> Dict:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": layers.dense_init(gen, (d, H * hd), dtype),
        "wk": layers.dense_init(gen, (d, KV * hd), dtype),
        "wv": layers.dense_init(gen, (d, KV * hd), dtype),
        "wo": layers.dense_init(gen, (H * hd, d), dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=dtype, device=gen.device)
        p["k_norm"] = torch.zeros((hd,), dtype=dtype, device=gen.device)
    return p


def _project_qkv(p: Dict, cfg: ModelConfig, x: torch.Tensor):
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (x @ p["wk"]).reshape(B, S, KV, hd)
    v = (x @ p["wv"]).reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = layers.head_rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = layers.head_rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def gqa_full(p: Dict, cfg: ModelConfig, x: torch.Tensor,
             positions: torch.Tensor, *, impl: str = "xla"
             ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Whole-sequence causal self-attention.

    ``impl="flash"`` runs the flash prefill kernel (``ops.flash_attention``)
    as the reference's does (``attention.py:122-129``; the port has no
    sliding window or cross-attention, the reference's other conditions);
    any other ``impl`` the masked softmax of ``attention_core``.
    Returns (output [B,S,D_model], (k, v) [B,S,KV,hd] for the cache).
    """
    q, k, v = _project_qkv(p, cfg, x)
    if cfg.rope_theta > 0:
        sin, cos = layers.rope_sin_cos(positions, cfg.head_dim, cfg.rope_theta)
        q = layers.apply_rope(q, sin, cos)
        k = layers.apply_rope(k, sin, cos)
    scale = cfg.head_dim ** -0.5
    if impl == "flash":
        out = kops.flash_attention(q, k, v, scale=scale)
    else:
        mask = causal_mask(positions, positions)[:, None, None, :, :]
        out = attention_core(q, k, v, mask, scale)
    B, S = x.shape[:2]
    out = out.reshape(B, S, cfg.n_heads * cfg.head_dim)
    return out @ p["wo"], (k, v)


def write_kv_cache(cache_k: torch.Tensor, cache_v: torch.Tensor,
                   k_new: torch.Tensor, v_new: torch.Tensor,
                   lengths: torch.Tensor) -> None:
    """Insert one new KV per sequence at its own index, IN PLACE.

    cache [B,T,KV,hd]; new [B,1,KV,hd]; lengths [B].  A row whose length
    is T or more writes nothing, as the reference's masked ``where``
    (``attention.py:210-215``): its index is clamped and the old row
    written back, so no index leaves the cache and nothing reads back to
    the host.
    """
    B, T = cache_k.shape[:2]
    rows = torch.arange(B, device=cache_k.device)
    idx = lengths.clamp(max=T - 1).long()
    keep = (lengths < T)[:, None, None]
    for cache, new in ((cache_k, k_new), (cache_v, v_new)):
        cache[rows, idx] = torch.where(keep, new[:, 0].to(cache.dtype),
                                       cache[rows, idx])


def gqa_decode(p: Dict, cfg: ModelConfig, x: torch.Tensor,
               cache_k: torch.Tensor, cache_v: torch.Tensor,
               lengths: torch.Tensor, *, impl: str = "xla") -> torch.Tensor:
    """One-token decode against a contiguous cache layer.

    x [B,1,D]; cache [B,T,KV,hd], updated in place; lengths [B] current
    context lengths (the new token goes to that index).  ``impl="paged"``
    reads the KV through the contiguous decode kernel
    (``ops.decode_attention`` over ``lengths + 1`` tokens), any other
    ``impl`` through the masked softmax.  Returns out [B,1,D].
    """
    B = x.shape[0]
    T = cache_k.shape[1]
    q, k, v = _project_qkv(p, cfg, x)
    pos = lengths[:, None]
    if cfg.rope_theta > 0:
        sin, cos = layers.rope_sin_cos(pos, cfg.head_dim, cfg.rope_theta)
        q = layers.apply_rope(q, sin, cos)
        k = layers.apply_rope(k, sin, cos)
    write_kv_cache(cache_k, cache_v, k, v, lengths)
    scale = cfg.head_dim ** -0.5
    if impl == "paged":
        out = kops.decode_attention(q, cache_k, cache_v, lengths + 1,
                                    scale=scale)
    else:
        kv_pos = torch.arange(T, device=x.device)[None, :]
        mask = (kv_pos <= pos)[:, None, None, None, :]        # [B,1,1,1,T]
        out = attention_core(q, cache_k, cache_v, mask, scale)
    out = out.reshape(B, 1, cfg.n_heads * cfg.head_dim)
    return out @ p["wo"]


def _write_page(page_table: torch.Tensor, lengths: torch.Tensor,
                tokens_per_page: int) -> torch.Tensor:
    """Page id receiving each row's new token; -1 past the table horizon
    (the reference reads that entry out of range and then discards it)."""
    chunk = lengths // tokens_per_page
    inside = chunk < page_table.shape[1]
    idx = chunk.clamp(max=page_table.shape[1] - 1).long()
    page = page_table.gather(1, idx[:, None])[:, 0]
    return torch.where(inside, page, torch.full_like(page, -1))


def gqa_paged_decode(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                     pool: torch.Tensor, page_table: torch.Tensor,
                     lengths: torch.Tensor, *, tokens_per_page: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token GQA decode against the shared paged KV pool.

    x: [B,1,D]; pool: [n_pages, page_elems] (the untyped flat pool);
    page_table: [B, max_pages] int32 for THIS layer (-1 = unmapped);
    lengths: [B] current context length — the new token's K/V is written
    at (page_table[b, lengths[b] // tpp], lengths[b] % tpp) and attention
    reads lengths+1 tokens back through the page table.  The pool is
    updated in place; (out [B,1,D], pool) is returned.
    """
    B = x.shape[0]
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    per_tok = 2 * KV * hd
    pos = lengths[:, None]
    q, k, v = _project_qkv(p, cfg, x)
    if cfg.rope_theta > 0:
        sin, cos = layers.rope_sin_cos(pos, cfg.head_dim, cfg.rope_theta)
        q = layers.apply_rope(q, sin, cos)
        k = layers.apply_rope(k, sin, cos)
    kv_tok = torch.stack([k[:, 0], v[:, 0]], dim=1).reshape(B, per_tok)
    page = _write_page(page_table, lengths, tokens_per_page)
    kops.paged_kv_write(pool, kv_tok, page, lengths % tokens_per_page)
    out = kops.paged_decode_attention(
        q, pool, page_table, lengths + 1, tokens_per_page=tokens_per_page,
        n_kv=KV, scale=cfg.head_dim ** -0.5)
    out = out.reshape(B, 1, cfg.n_heads * cfg.head_dim).to(x.dtype)
    return out @ p["wo"], pool


# ---------------------------------------------------------------------------
# MLA — Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3)
# ---------------------------------------------------------------------------

def init_mla(gen: torch.Generator, cfg: ModelConfig, dtype) -> Dict:
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    p = {}
    if m.q_lora_rank:
        p["wdq"] = layers.dense_init(gen, (d, m.q_lora_rank), dtype)
        p["q_ln"] = torch.zeros((m.q_lora_rank,), dtype=dtype,
                                device=gen.device)
        p["wuq"] = layers.dense_init(gen, (m.q_lora_rank, H * qk_dim), dtype)
    else:
        p["wuq"] = layers.dense_init(gen, (d, H * qk_dim), dtype)
    p["wdkv"] = layers.dense_init(
        gen, (d, m.kv_lora_rank + m.qk_rope_head_dim), dtype)
    p["kv_ln"] = torch.zeros((m.kv_lora_rank,), dtype=dtype,
                             device=gen.device)
    p["wuk"] = layers.dense_init(
        gen, (m.kv_lora_rank, H * m.qk_nope_head_dim), dtype)
    p["wuv"] = layers.dense_init(gen, (m.kv_lora_rank, H * m.v_head_dim),
                                 dtype)
    p["wo"] = layers.dense_init(gen, (H * m.v_head_dim, d), dtype)
    return p


def _mla_queries(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor):
    """Returns (q_nope [B,S,H,nope], q_rope [B,S,H,rope]) with RoPE."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    if m.q_lora_rank:
        cq = layers.rms_norm(x @ p["wdq"], p["q_ln"], cfg.norm_eps)
        q = (cq @ p["wuq"]).reshape(B, S, H, qk_dim)
    else:
        q = (x @ p["wuq"]).reshape(B, S, H, qk_dim)
    q_nope = q[..., : m.qk_nope_head_dim]
    q_rope = q[..., m.qk_nope_head_dim:]
    sin, cos = layers.rope_sin_cos(positions, m.qk_rope_head_dim,
                                   cfg.rope_theta)
    return q_nope, layers.apply_rope(q_rope, sin, cos)


def _mla_latent(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor):
    """Compressed KV: (latent [B,S,r] post-norm, k_rope [B,S,rope]
    post-RoPE) — together the entire KV cache of a token."""
    m = cfg.mla
    ckv = x @ p["wdkv"]
    latent = layers.rms_norm(ckv[..., : m.kv_lora_rank], p["kv_ln"],
                             cfg.norm_eps)
    k_rope = ckv[..., m.kv_lora_rank:]
    sin, cos = layers.rope_sin_cos(positions, m.qk_rope_head_dim,
                                   cfg.rope_theta)
    k_rope = layers.apply_rope(k_rope[:, :, None, :], sin, cos)[:, :, 0, :]
    return latent, k_rope


def mla_full(p: Dict, cfg: ModelConfig, x: torch.Tensor,
             positions: torch.Tensor
             ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Whole-sequence MLA in the expanded (prefill) form."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    q_nope, q_rope = _mla_queries(p, cfg, x, positions)
    latent, k_rope = _mla_latent(p, cfg, x, positions)
    k_nope = (latent @ p["wuk"]).reshape(B, S, H, m.qk_nope_head_dim)
    v = (latent @ p["wuv"]).reshape(B, S, H, m.v_head_dim)
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    mask = causal_mask(positions, positions)[:, None, None, :, :]
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, H, m.qk_rope_head_dim)], dim=-1)
    out = attention_core(q, k, v, mask, scale)
    out = out.reshape(B, S, H * m.v_head_dim)
    return out @ p["wo"], (latent, k_rope)


def mla_paged_decode(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                     pool: torch.Tensor, page_table: torch.Tensor,
                     lengths: torch.Tensor, *, tokens_per_page: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token absorbed-MLA decode against the shared paged KV pool.

    The per-token page row is [latent (r) | rope key (rp)] — the same
    untyped pool the GQA models page into, reinterpreted (Type II).
    """
    m = cfg.mla
    B = x.shape[0]
    H = cfg.n_heads
    pos = lengths[:, None]
    q_nope, q_rope = _mla_queries(p, cfg, x, pos)
    latent_new, rope_new = _mla_latent(p, cfg, x, pos)
    kv_tok = torch.cat([latent_new[:, 0], rope_new[:, 0]], dim=-1)
    page = _write_page(page_table, lengths, tokens_per_page)
    kops.paged_kv_write(pool, kv_tok, page, lengths % tokens_per_page)
    # absorb W_uk into q; score against [latent | rope] rows directly
    wuk = p["wuk"].reshape(m.kv_lora_rank, H, m.qk_nope_head_dim)
    q_lat = torch.einsum("bshn,rhn->bshr", q_nope, wuk)
    q_cat = torch.cat([q_lat, q_rope], dim=-1)            # [B,1,H,r+rp]
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    ctx = kops.paged_mla_decode_attention(
        q_cat, pool, page_table, lengths + 1,
        tokens_per_page=tokens_per_page, latent_dim=m.kv_lora_rank,
        scale=scale)
    wuv = p["wuv"].reshape(m.kv_lora_rank, H, m.v_head_dim)
    out = torch.einsum("bshr,rhv->bshv", ctx, wuv)
    out = out.reshape(B, 1, H * m.v_head_dim).to(x.dtype)
    return out @ p["wo"], pool
