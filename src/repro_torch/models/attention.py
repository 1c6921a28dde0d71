"""Attention variants: GQA/MHA/MQA, MLA (MiniCPM3 style), sliding window.

Port of ``src/repro/models/attention.py``: whole-sequence attention for
prefill and training (``gqa_full`` with the reference's ``impl`` routes,
its window, cross-attention and non-causal forms; ``mla_full``), the
prefix cache's suffix-only prefill (``gqa_suffix`` / ``mla_suffix``),
one-token decode against the shared paged pool (``gqa_paged_decode`` /
``mla_paged_decode``, ``attention.py:256-334``) for the split-execution
path, and one-token decode against a contiguous per-model cache for the
dense-cache Model path (``write_kv_cache`` / ``gqa_decode`` :193-253,
the sliding-window ring ``swa_decode`` :341 and the absorbed
``mla_decode`` :496).  Decode writes the new token's KV IN PLACE (into
the pool, or the cache layer) and reads the KV back through the
hand-written kernels where the reference reaches its Pallas kernels
(``impl="paged"``); an fp8 cache is read through the masked softmax,
dequantized to bfloat16 as the reference's is.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import layers
from repro_torch.models.hooks import IDENTITY_HOOKS, LOCAL, Hooks

NEG_INF = -1e30


def causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                window: int = 0) -> torch.Tensor:
    """Boolean [.., S, T] mask: True = attend.  ``window`` > 0 adds
    locality (a key less than ``window`` positions back)."""
    m = q_pos[..., :, None] >= k_pos[..., None, :]
    if window > 0:
        m = m & (q_pos[..., :, None] - k_pos[..., None, :] < window)
    return m


def _project_out(out: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``out @ w`` with JAX's type promotion: the bfloat16 context read
    from an fp8 cache meets a float32 model's weight in float32."""
    return out.to(torch.promote_types(out.dtype, w.dtype)) @ w


# ---------------------------------------------------------------------------
# Core grouped attention
# ---------------------------------------------------------------------------

def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: Optional[torch.Tensor], scale: float
                   ) -> torch.Tensor:
    """Grouped-query attention with f32 scores and softmax.

    q: [B,S,H,D]; k/v: [B,T,KV,D]; mask: broadcastable to [B,KV,G,S,T].
    Returns [B,S,H,Dv] in v's dtype (bfloat16 for an fp8 cache, which is
    dequantized first, as the reference's ``attention.py:49-51``).
    """
    if k.element_size() == 1:
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
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
             positions: torch.Tensor, *, window: int = 0,
             kv_positions: Optional[torch.Tensor] = None,
             kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
             causal: bool = True, impl: str = "xla",
             hooks: Hooks = IDENTITY_HOOKS
             ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Whole-sequence self-attention, or cross-attention over
    ``kv_override`` (k, v [B,T,KV,hd], taken as they are: no RoPE).

    The reference's routes (``attention.py:122-129``): a causal call with
    ``impl="flash"``, no window and no override runs the flash prefill
    kernel (``ops.flash_attention``); a windowed, cross or other causal
    call the masked softmax of ``attention_core`` over ``kv_positions``
    (default: ``positions``); a non-causal call (the whisper encoder,
    cross-attention) ``attention_core`` unmasked.  Under the sharded
    step's ``hooks.tp`` it runs on this rank's query heads, each reading
    its group's KV head from this rank's KV heads or the gathered ones
    (``n_kv_heads`` below the model axis: a rank holds part of a head;
    the helpers below); ``kv_override`` then holds this rank's KV heads
    (``rank_heads`` cuts a whole layer's) or every head.
    Returns (output [B,S,D_model], (k, v) for the cache: this rank's KV
    heads when the projections split on whole heads, else every head;
    ``cache_heads`` gathers them for a cache that holds every head).
    """
    tp = hooks.tp
    if tp.size > 1 and kv_positions is not None:
        raise NotImplementedError("tensor-parallel attention over "
                                  "kv_positions")
    B, S = x.shape[:2]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, h0 = _tp_heads(x, p["wq"], H, hd, tp)
    nq = q.shape[2]
    if kv_override is None:
        k, k0 = _tp_heads(x, p["wk"], KV, hd, tp)
        v, _ = _tp_heads(x, p["wv"], KV, hd, tp)
    else:
        k, v = kv_override
        k0 = tp.index * k.shape[2] if k.shape[2] < KV else 0
    if cfg.qk_norm:
        q = layers.head_rms_norm(
            q, tp.enter(p["q_norm"]) if nq < H else p["q_norm"], cfg.norm_eps)
        if kv_override is None:
            k = layers.head_rms_norm(
                k, tp.enter(p["k_norm"]) if k.shape[2] < KV else p["k_norm"],
                cfg.norm_eps)
    kv_pos = positions if kv_positions is None else kv_positions
    if cfg.rope_theta > 0:
        sin, cos = layers.rope_sin_cos(positions, hd, cfg.rope_theta)
        q = layers.apply_rope(q, sin, cos)
        if kv_override is None:
            sin, cos = layers.rope_sin_cos(kv_pos, hd, cfg.rope_theta)
            k = layers.apply_rope(k, sin, cos)
    kv = (k, v)                 # this rank's KV heads (or all), cached
    # each of this rank's query heads reads its group's KV head
    G = H // KV
    lo, hi = h0 // G, (h0 + nq - 1) // G
    if lo == hi or (h0 % G == 0 and nq % G == 0):
        want = list(range(lo, hi + 1))            # whole groups
    else:
        want = [(h0 + i) // G for i in range(nq)]  # one KV head a query
    k = _heads_for(k, k0, want, KV, nq < H, tp)
    v = _heads_for(v, k0, want, KV, nq < H, tp)
    q = hooks.attn_q(q)
    k, v = hooks.kv(k), hooks.kv(v)
    scale = hd ** -0.5
    if not causal:
        out = attention_core(q, k, v, None, scale)
    elif impl == "flash" and window == 0 and kv_override is None:
        out = kops.flash_attention(q, k, v, scale=scale)
    else:
        mask = causal_mask(positions, kv_pos, window)[:, None, None, :, :]
        out = attention_core(q, k, v, mask, scale)
    y, partial = _tp_out(out.reshape(B, S, nq * hd), p["wo"], nq, H, tp)
    return hooks.attn_out(tp.seq_out(y, partial)), kv


# ---------------------------------------------------------------------------
# tensor parallel: this rank's heads (the sharded training step)
# ---------------------------------------------------------------------------
#
# The train rules split every projection's head columns (``wq``, ``wk``,
# ``wv``, ``wuq``, ``wuk``, ``wuv``; MLA's ``wdq`` / ``wdkv`` latents)
# and ``wo``'s rows over ``model`` where the width divides (``safe_spec``).
# The input is replicated over ``hooks.tp``; a split projection gives
# this rank's heads when its split falls on whole heads, and is gathered
# (the whole heads on every rank) when it falls inside one, as the
# partitioner does.  The attention runs on this rank's query heads; the
# output projection's partial sums are reduced (``tp.seq_out``).  At one
# rank every helper is the plain projection of the whole heads.

def _tp_cols(x: torch.Tensor, w: torch.Tensor, width: int, tp
             ) -> torch.Tensor:
    """``x @ w`` with all ``width`` columns on every rank."""
    if w.shape[-1] == width:
        return x @ w
    return tp.gather(tp.enter(x) @ w, -1)


def _tp_heads(x: torch.Tensor, w: torch.Tensor, n_heads: int,
              head_dim: int, tp) -> Tuple[torch.Tensor, int]:
    """``x @ w`` as heads: (this rank's [B,S,n/tp,hd], its first head)
    when ``w``'s columns split on whole heads, else (all [B,S,n,hd], 0)."""
    B, S = x.shape[:2]
    if w.shape[-1] == n_heads * head_dim or n_heads % tp.size:
        return _tp_cols(x, w, n_heads * head_dim, tp).reshape(
            B, S, n_heads, head_dim), 0
    n = n_heads // tp.size
    return (tp.enter(x) @ w).reshape(B, S, n, head_dim), tp.index * n


def _heads_for(t: torch.Tensor, t0: int, want, n_total: int,
               split_consumer: bool, tp) -> torch.Tensor:
    """The heads ``want`` (global indices, in order) of ``t`` [B,T,n,D],
    which holds heads ``[t0, t0 + n)``.  Heads this rank does not hold
    are gathered; a replicated ``t`` read by this rank's heads only
    (``split_consumer``) enters the tensor-parallel region."""
    n = t.shape[2]
    if n < n_total:
        if want == list(range(t0, t0 + n)):
            return t
        if t0 <= want[0] and want[-1] < t0 + n:
            return t[:, :, [h - t0 for h in want]]
        t = tp.gather(t, 2)
    elif split_consumer:
        t = tp.enter(t)
    return t if want == list(range(n_total)) else t[:, :, want]


def _tp_out(out: torch.Tensor, wo: torch.Tensor, n_q: int, n_heads: int,
            tp) -> Tuple[torch.Tensor, bool]:
    """The output projection of ``n_q`` heads' context [B,S,n_q*dv]:
    (partial sums, True) when ``wo``'s rows split, else (the output,
    False)."""
    if wo.shape[0] < n_heads * (out.shape[-1] // n_q):
        if n_q == n_heads:
            out = tp.split(out, -1)
        return _project_out(out, wo), True
    if n_q < n_heads:
        out = tp.gather(out, -1)
    return _project_out(out, wo), False


def _w_heads(w: torch.Tensor, n_heads: int, head_dim: int, tp
             ) -> torch.Tensor:
    """A projection ``w`` [rows, cols] as heads [rows, n, head_dim]: this
    rank's heads when its columns split on whole heads (``_tp_heads``'s),
    else every head (gathered when the split falls inside one)."""
    if w.shape[-1] != n_heads * head_dim and n_heads % tp.size:
        w = tp.gather(w, -1)
    return w.reshape(w.shape[0], -1, head_dim)


def rank_heads(p: Dict, cfg: ModelConfig, n_cache: int, tp) -> Dict:
    """A GQA layer whose weights the rules keep whole (whisper's decoder
    ``self`` / ``cross``), cut to this rank's heads when its cache holds
    ``n_cache`` < ``n_kv_heads`` of them (monolithic Type I splits the
    cache's heads over ``tp``): ``wq`` / ``wk`` / ``wv``'s columns and
    ``wo``'s rows of this rank's heads, views of the whole leaves, the cut
    the rules give a placed layer; else ``p``."""
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if n_cache == KV or p["wk"].shape[-1] != KV * hd:
        return p
    G, i = H // KV, tp.index
    qc = slice(i * n_cache * G * hd, (i + 1) * n_cache * G * hd)
    kc = slice(i * n_cache * hd, (i + 1) * n_cache * hd)
    return dict(p, wq=p["wq"][:, qc], wk=p["wk"][:, kc], wv=p["wv"][:, kc],
                wo=p["wo"][qc])


def cache_heads(t: torch.Tensor, n_cache: int, tp) -> torch.Tensor:
    """``t`` [B,S,n,D] (this rank's heads, or every head) as a cache of
    ``n_cache`` heads holds them: gathered over ``tp`` when the cache
    holds every head and ``t`` this rank's (crosspool keeps every head
    of its rank's slice of the sequence)."""
    return t if t.shape[2] == n_cache else tp.gather(t, 2)


def _pad_to_extent(arr: torch.Tensor, extent: int) -> torch.Tensor:
    """Zero-pad or truncate axis 1 to exactly ``extent`` rows
    (``attention.py:135``).  The suffix passes pin their KV reduction
    extent to the PRODUCING pass's bucket, so softmax sums run over the
    same span: pad rows are masked (exact 0 weight) and truncated rows
    are pad rows no real query attends."""
    T = arr.shape[1]
    if T >= extent:
        return arr[:, :extent]
    pad = arr.new_zeros((arr.shape[0], extent - T) + tuple(arr.shape[2:]))
    return torch.cat([arr, pad], dim=1)


def gqa_suffix(p: Dict, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor, prefix_k: torch.Tensor,
               prefix_v: torch.Tensor, kv_extent: int
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Suffix-only prefill attention against a cached prompt prefix
    (``attention.py:153-188``).

    x: [B,S_suf,D] post-norm hidden of the UNCACHED suffix tokens;
    positions: [B,S_suf] absolute (``fork + i``); prefix_k / prefix_v:
    [B,fork,KV,hd] read from the pool (post-RoPE, the full pass's rows);
    ``kv_extent``: the producing pass's prefill bucket.  The suffix K/V
    rows are the full pass's (same per-row math), the concatenated KV is
    cut or zero-padded to the full pass's extent, and the causal mask
    over absolute positions masks every row that differs.  Takes the
    plain ``attention_core``, the route the split path's full prefill
    takes.  Returns (out [B,S_suf,D_model], (k_suf, v_suf) for the
    pool)."""
    q, k, v = _project_qkv(p, cfg, x)
    if cfg.rope_theta > 0:
        sin, cos = layers.rope_sin_cos(positions, cfg.head_dim,
                                       cfg.rope_theta)
        q = layers.apply_rope(q, sin, cos)
        k = layers.apply_rope(k, sin, cos)
    k_all = _pad_to_extent(torch.cat([prefix_k.to(k.dtype), k], dim=1),
                           kv_extent)
    v_all = _pad_to_extent(torch.cat([prefix_v.to(v.dtype), v], dim=1),
                           kv_extent)
    kv_pos = torch.arange(kv_extent, device=x.device)[None, :]
    mask = causal_mask(positions, kv_pos)[:, None, None, :, :]
    out = attention_core(q, k_all, v_all, mask, cfg.head_dim ** -0.5)
    B, S = x.shape[:2]
    out = out.reshape(B, S, cfg.n_heads * cfg.head_dim)
    return out @ p["wo"], (k, v)


def write_kv_cache(cache_k: torch.Tensor, cache_v: torch.Tensor,
                   k_new: torch.Tensor, v_new: torch.Tensor,
                   lengths: torch.Tensor) -> None:
    """Insert one new KV per sequence at its own index, IN PLACE.

    cache [B,T,...]; new [B,1,...]; lengths [B] (the GQA layer's
    [B,T,KV,hd] and the MLA latent / rope rows [B,T,r] alike), counted
    from this cache's first row.  A row whose index lies outside
    ``[0, T)`` writes nothing, as the reference's masked ``where``
    (``attention.py:210-215``): its index is clamped and the old row
    written back, so no index leaves the cache and nothing reads back to
    the host.  A negative index is a token that precedes this cache: a
    sequence-sharded cache holds a slice of the context
    (``Hooks.kv_offset``), and only the shard that owns the position
    writes it.
    """
    B, T = cache_k.shape[:2]
    rows = torch.arange(B, device=cache_k.device)
    idx = lengths.clamp(min=0, max=T - 1).long()
    keep = ((lengths >= 0) & (lengths < T)).view(
        (B,) + (1,) * (cache_k.dim() - 2))
    for cache, new in ((cache_k, k_new), (cache_v, v_new)):
        cache[rows, idx] = torch.where(keep, new[:, 0].to(cache.dtype),
                                       cache[rows, idx])


def gqa_decode(p: Dict, cfg: ModelConfig, x: torch.Tensor,
               cache_k: torch.Tensor, cache_v: torch.Tensor,
               lengths: torch.Tensor, *, impl: str = "xla",
               hooks: Hooks = IDENTITY_HOOKS) -> torch.Tensor:
    """One-token decode against a contiguous cache layer.

    x [B,1,D]; cache [B,T,KV,hd], updated in place; lengths [B] current
    context lengths (the new token goes to that index, less
    ``hooks.kv_offset`` when the cache is this rank's slice of the
    sequence).  ``hooks.decode_attn`` (crosspool's sequence-sharded
    attention, ``attention.py:244-246``) reads the KV when set;
    otherwise ``impl="paged"`` reads it through the contiguous decode
    kernel (``ops.decode_attention`` over ``lengths + 1`` tokens), any
    other ``impl`` through the masked softmax.  Under the sharded serve
    step's ``hooks.tp`` the heads are ``_decode_qkv``'s and ``wo``'s
    partial sums are reduced.  Returns out [B,1,D].
    """
    T = cache_k.shape[1]
    pos = lengths[:, None]
    q, k, v = _decode_qkv(p, cfg, x, pos, cache_k.shape[2], hooks.tp)
    write_kv_cache(cache_k, cache_v, k, v, _local(lengths, hooks))
    cache_k, cache_v = hooks.kv(cache_k), hooks.kv(cache_v)
    scale = cfg.head_dim ** -0.5
    if hooks.decode_attn is not None:
        out = hooks.decode_attn(q, cache_k, cache_v, lengths + 1)
    elif impl == "paged":
        out = kops.decode_attention(q, cache_k, cache_v, lengths + 1,
                                    scale=scale)
    else:
        kv_pos = torch.arange(T, device=x.device)[None, :]
        mask = (kv_pos <= pos)[:, None, None, None, :]        # [B,1,1,1,T]
        out = attention_core(q, cache_k, cache_v, mask, scale)
    return _decode_out(out, p, cfg, hooks)


def _decode_qkv(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                pos: torch.Tensor, n_cache: int, tp):
    """The new token's q, k, v [B,1,n,hd] (RoPE at ``pos`` [B,1]) as the
    heads of a cache layer of ``n_cache`` KV heads: this rank's query
    heads over its KV heads (monolithic Type I: the cache holds this
    rank's KV heads), or every head where the cache holds every KV head.
    Crosspool splits the cache's sequence over ``kv_seq_axes`` and keeps
    every head of a rank's slice (the reference's cache rules), and the
    kernel takes a contiguous cache only (a head slice of it is not): so
    the one token's heads are gathered over ``tp`` (small), the rank that
    owns its position writes the whole row, every head attends over this
    rank's slice (``hooks.decode_attn`` combines the slices), and
    ``_decode_out`` takes this rank's rows of ``wo``."""
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, _ = _tp_heads(x, p["wq"], H, hd, tp)
    k, _ = _tp_heads(x, p["wk"], KV, hd, tp)
    v, _ = _tp_heads(x, p["wv"], KV, hd, tp)
    if cfg.qk_norm:
        q = layers.head_rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = layers.head_rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.rope_theta > 0:
        sin, cos = layers.rope_sin_cos(pos, hd, cfg.rope_theta)
        q = layers.apply_rope(q, sin, cos)
        k = layers.apply_rope(k, sin, cos)
    if n_cache == KV:
        return (cache_heads(q, H, tp), cache_heads(k, KV, tp),
                cache_heads(v, KV, tp))
    if k.shape[2] != n_cache:
        raise ValueError(f"a cache of {n_cache} KV heads against this "
                         f"rank's {k.shape[2]}")
    return q, k, v


def _decode_out(out: torch.Tensor, p: Dict, cfg: ModelConfig,
                hooks: Hooks) -> torch.Tensor:
    """The output projection of a decode's context [B,1,n,hd] (this
    rank's heads or every head), ``wo``'s partial sums reduced over
    ``hooks.tp``."""
    B, _, n, hd = out.shape
    y, partial = _tp_out(out.reshape(B, 1, n * hd), p["wo"], n,
                         cfg.n_heads, hooks.tp)
    return hooks.attn_out(hooks.tp.reduce(y) if partial else y)


def _local(lengths: torch.Tensor, hooks: Hooks) -> torch.Tensor:
    """Cache index of the new token in this rank's slice of the cache."""
    return lengths - hooks.kv_offset if hooks.kv_offset else lengths


def ring_write_positions(cache_pos: torch.Tensor, cur: torch.Tensor
                         ) -> None:
    """Record position ``cur`` [B] in ring slot ``cur % W`` of
    ``cache_pos`` [..., B, W] IN PLACE (every leading index at once: the
    gemma3 decode writes its local layers' rings in one op)."""
    B, W = cache_pos.shape[-2:]
    rows = torch.arange(B, device=cache_pos.device)
    cache_pos[..., rows, (cur % W).long()] = cur.to(cache_pos.dtype)


def ring_count(cache_pos: torch.Tensor) -> torch.Tensor:
    """[B] int32: the ring slots holding a position (``cache_pos >= 0``).

    After a prefill and the decode steps that follow it (each step's
    ``cur`` one past the last, the first at most the prefilled length S),
    these slots are exactly the ones the reference attends to
    (``attention.py:370``, ``valid = (pos >= 0) & (pos > cur - W)``), and
    they are the prefix ``[0, n)`` of the ring:
      * prefill fills slots ``[0, min(S, W))`` (slot w holds the latest
        position ``p < S`` with ``p % W == w``) and marks the rest -1;
        decode writes slot ``cur % W``, which is ``cur`` itself while
        ``cur < W``, so the filled slots stay a prefix until all W are;
      * every filled slot holds a position above ``cur - W``: a prefill
        position ``p >= S - W > cur - W`` while ``cur < S``; once
        ``cur >= S``, any older position ``p <= cur - W`` shares its slot
        with ``p + W <= cur``, which a later decode step wrote over it;
        a decode position ``p <= cur - W`` likewise.
    Attention depends only on which slots it reads, not their order, so
    the contiguous decode kernel over ``n`` tokens computes the
    reference's masked softmax.  Pad positions of a bucket prefilled past
    the real prompt (``cur < S``) are positive and held: the reference
    attends to them, and so does ``[0, n)``.
    """
    return (cache_pos >= 0).sum(-1, dtype=torch.int32)


def swa_decode(p: Dict, cfg: ModelConfig, x: torch.Tensor,
               cache_k: torch.Tensor, cache_v: torch.Tensor,
               cache_pos: torch.Tensor, cur_len: torch.Tensor,
               count: torch.Tensor, *, impl: str = "xla",
               hooks: Hooks = IDENTITY_HOOKS) -> torch.Tensor:
    """One-token decode against a sliding-window ring (gemma3's local
    layers, ``attention.py:341-375``).

    x [B,1,D]; cache_k / cache_v [B,W,KV,hd], updated IN PLACE: the new
    token's K/V go to slot ``cur_len % W``.  cache_pos [B,W] (absolute
    positions, -1 = empty) already holds this step's position: the caller
    writes it with ``ring_write_positions`` and takes ``count`` =
    ``ring_count(cache_pos)``, once for every local layer.
    ``impl="paged"`` reads the ring through the contiguous decode kernel
    (``ops.decode_attention``) over its first ``count`` slots
    (``ring_count`` says why those are the reference's slots); any other
    ``impl`` through the reference's masked softmax.  The heads under
    ``hooks.tp`` are ``gqa_decode``'s.  Returns out [B,1,D].
    """
    B, W = cache_pos.shape
    pos = cur_len[:, None]
    q, k, v = _decode_qkv(p, cfg, x, pos, cache_k.shape[2], hooks.tp)
    rows = torch.arange(B, device=x.device)
    slot = (cur_len % W).long()
    cache_k[rows, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[rows, slot] = v[:, 0].to(cache_v.dtype)
    cache_k, cache_v = hooks.kv(cache_k), hooks.kv(cache_v)
    scale = cfg.head_dim ** -0.5
    if impl == "paged":
        out = kops.decode_attention(q, cache_k, cache_v, count, scale=scale)
    else:
        valid = (cache_pos >= 0) & (cache_pos > pos - W)          # [B,W]
        out = attention_core(q, cache_k, cache_v,
                             valid[:, None, None, None, :], scale)
    return _decode_out(out, p, cfg, hooks)


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


def mla_full(p: Dict, cfg: ModelConfig, x: torch.Tensor,
             positions: torch.Tensor, *, hooks: Hooks = IDENTITY_HOOKS
             ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Whole-sequence MLA in the expanded (prefill) form.  Under the
    sharded training step's ``hooks.tp`` it runs on this rank's heads:
    the q and KV latents (``wdq`` / ``wdkv``'s columns split over
    ``model``) are gathered whole, since their norms read every column;
    ``wuq`` / ``wuk`` / ``wuv`` give this rank's heads (``_tp_heads``)."""
    tp = hooks.tp
    m = cfg.mla
    B, S, _ = x.shape
    H, nope, rp = cfg.n_heads, m.qk_nope_head_dim, m.qk_rope_head_dim
    q_nope, q_rope, h0, latent, k_rope = _mla_project(p, cfg, x, positions,
                                                      tp)
    nq = q_nope.shape[2]
    latent, k_rope = hooks.kv(latent), hooks.kv(k_rope)
    want = list(range(h0, h0 + nq))
    k_nope, hk = _tp_heads(latent, p["wuk"], H, nope, tp)
    v, hv = _tp_heads(latent, p["wuv"], H, m.v_head_dim, tp)
    k_nope = _heads_for(k_nope, hk, want, H, nq < H, tp)
    v = _heads_for(v, hv, want, H, nq < H, tp)
    kr = tp.enter(k_rope) if nq < H else k_rope
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, kr[:, :, None, :].expand(B, S, nq, rp)], dim=-1)
    mask = causal_mask(positions, positions)[:, None, None, :, :]
    out = attention_core(q, k, v, mask, (nope + rp) ** -0.5)
    y, partial = _tp_out(out.reshape(B, S, nq * m.v_head_dim), p["wo"], nq,
                         H, tp)
    return hooks.attn_out(tp.seq_out(y, partial)), (latent, k_rope)


def _mla_project(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor, tp):
    """MLA's projections of ``x`` [B,S,D] at ``positions``: (q_nope,
    q_rope (RoPE'd) [B,S,n,.] of this rank's heads from the first, h0;
    the latent [B,S,r] post-norm and the rope key [B,S,rp] post-RoPE,
    whole).  ``wdq`` / ``wdkv``'s latent columns split over ``tp`` are
    gathered (the norms read every column, and every head reads the
    cache's whole latent)."""
    m = cfg.mla
    H, nope, rp = cfg.n_heads, m.qk_nope_head_dim, m.qk_rope_head_dim
    r = m.kv_lora_rank
    if m.q_lora_rank:
        cq = layers.rms_norm(_tp_cols(x, p["wdq"], m.q_lora_rank, tp),
                             p["q_ln"], cfg.norm_eps)
        q, h0 = _tp_heads(cq, p["wuq"], H, nope + rp, tp)
    else:
        q, h0 = _tp_heads(x, p["wuq"], H, nope + rp, tp)
    sin, cos = layers.rope_sin_cos(positions, rp, cfg.rope_theta)
    q_nope, q_rope = q[..., :nope], layers.apply_rope(q[..., nope:], sin, cos)
    ckv = _tp_cols(x, p["wdkv"], r + rp, tp)
    latent = layers.rms_norm(ckv[..., :r], p["kv_ln"], cfg.norm_eps)
    k_rope = layers.apply_rope(ckv[..., None, r:], sin, cos)[:, :, 0, :]
    return q_nope, q_rope, h0, latent, k_rope


def mla_suffix(p: Dict, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor, prefix_latent: torch.Tensor,
               prefix_rope: torch.Tensor, kv_extent: int
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Suffix-only expanded-form MLA against a cached prompt prefix
    (``attention.py:454-491``): prefix_latent [B,fork,r] / prefix_rope
    [B,fork,rp] are the pool's rows (post-norm latent, post-RoPE key).
    The same argument as ``gqa_suffix``: the ``latent @ wuk`` / ``@ wuv``
    expansions are per row, so padded rows only give masked scores.
    Returns (out, (latent_suf, rope_suf) for the pool)."""
    m = cfg.mla
    B, S = x.shape[:2]
    H = cfg.n_heads
    q_nope, q_rope, _, latent, k_rope = _mla_project(p, cfg, x, positions,
                                                     LOCAL)
    latent_all = _pad_to_extent(
        torch.cat([prefix_latent.to(latent.dtype), latent], dim=1),
        kv_extent)
    rope_all = _pad_to_extent(
        torch.cat([prefix_rope.to(k_rope.dtype), k_rope], dim=1), kv_extent)
    k_nope = (latent_all @ p["wuk"]).reshape(B, kv_extent, H,
                                             m.qk_nope_head_dim)
    v = (latent_all @ p["wuv"]).reshape(B, kv_extent, H, m.v_head_dim)
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    kv_pos = torch.arange(kv_extent, device=x.device)[None, :]
    mask = causal_mask(positions, kv_pos)[:, None, None, :, :]
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, rope_all[:, :, None, :].expand(
        B, kv_extent, H, m.qk_rope_head_dim)], dim=-1)
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
    q_nope, q_rope, _, latent_new, rope_new = _mla_project(p, cfg, x, pos,
                                                           LOCAL)
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


def mla_decode(p: Dict, cfg: ModelConfig, x: torch.Tensor,
               cache_latent: torch.Tensor, cache_rope: torch.Tensor,
               lengths: torch.Tensor, *, hooks: Hooks = IDENTITY_HOOKS
               ) -> torch.Tensor:
    """One-token absorbed-MLA decode against a contiguous latent cache
    (``attention.py:496-552``; the reference's route is XLA einsums, so
    this is plain torch).

    x [B,1,D]; cache_latent [B,T,r] and cache_rope [B,T,rp], updated IN
    PLACE at ``lengths`` [B] (less ``hooks.kv_offset``: see
    ``gqa_decode``).  Attention reads only the compressed rows: ``W_uk``
    is absorbed into q, ``W_uv`` applied to the latent context, which
    ``hooks.decode_attn_mla`` computes when set (``attention.py:531-534``).
    Under the sharded serve step's ``hooks.tp`` the heads are this
    rank's (``_mla_project``; ``wuk`` / ``wuv`` / ``wo`` by their local
    shapes) and ``wo``'s partial sums are reduced; the sequence-split
    override's combine sums over ranks that must hold the same heads, so
    every head's absorbed query is gathered before it and this rank's
    heads are taken after.  Returns out [B,1,D].
    """
    m = cfg.mla
    tp = hooks.tp
    B, T = cache_latent.shape[:2]
    H = cfg.n_heads
    pos = lengths[:, None]
    q_nope, q_rope, h0, latent_new, rope_new = _mla_project(p, cfg, x, pos,
                                                            tp)
    nq = q_nope.shape[2]
    write_kv_cache(cache_latent, cache_rope, latent_new, rope_new,
                   _local(lengths, hooks))
    cache_latent, cache_rope = hooks.kv(cache_latent), hooks.kv(cache_rope)
    wuk = _w_heads(p["wuk"], H, m.qk_nope_head_dim, tp)
    q_lat = torch.einsum("bshn,rhn->bshr", q_nope, wuk)
    if hooks.decode_attn_mla is not None:
        ctx = hooks.decode_attn_mla(cache_heads(q_lat, H, tp),
                                    cache_heads(q_rope, H, tp), cache_latent,
                                    cache_rope, lengths + 1)
        ctx = ctx[:, :, h0:h0 + nq]
    else:
        latent, rope = cache_latent, cache_rope
        if latent.element_size() == 1:          # fp8 latent cache
            latent, rope = latent.to(torch.bfloat16), rope.to(torch.bfloat16)
        scores = (torch.einsum("bshr,btr->bhst", q_lat.float(),
                               latent.float())
                  + torch.einsum("bshp,btp->bhst", q_rope.float(),
                                 rope.float()))
        scores = scores * (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
        kv_pos = torch.arange(T, device=x.device)[None, None, None, :]
        scores = torch.where(kv_pos <= pos[:, None, :, None], scores,
                             torch.tensor(NEG_INF, device=scores.device))
        w = torch.softmax(scores, dim=-1).to(latent.dtype)
        ctx = torch.einsum("bhst,btr->bshr", w, latent)
    wuv = _w_heads(p["wuv"], H, m.v_head_dim, tp)
    ctx = ctx.to(torch.promote_types(ctx.dtype, wuv.dtype))
    return _decode_out(torch.einsum("bshr,rhv->bshv", ctx, wuv), p, cfg,
                       hooks)
