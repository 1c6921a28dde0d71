"""Plain PyTorch versions of the kernels, and the sequential SSD oracle.

Counterparts of ``src/repro/kernels/ref.py``: the CPU path of the
attention kernel wrappers, and the yardsticks the CUDA kernels are held
against on the card.  The decode versions run ordinary masked softmax
attention (the paged ones after gathering the pages a table names into a
dense cache), with one guard the JAX oracle leaves implicit: value rows
at positions ``>= length`` are zeroed before the weighted sum, as the
kernels do, so garbage (even NaN) past a length cannot leak into the
output through ``0 * garbage``.  On finite inputs that is exactly the
oracle's arithmetic.  ``moe_gemm`` and ``moe_gemm_wgrad`` are the
grouped expert GEMM's forward and weight gradient.  ``ssd_scan`` is the
per-token recurrence the chunked SSD scan (``ssd_chunked``, the SSD
kernel's plain version) is tested against.  ``paged_kv_write`` is the
pool write's indexed store.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def _zero_past(v: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """v [B,T,...] with rows where ``valid`` [B,T] is False set to 0."""
    return torch.where(valid[:, :, None, None], v,
                       torch.zeros((), dtype=v.dtype, device=v.device))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """Causal grouped attention with the prefix offset ``T - S``.

    q [B,S,H,D]; k/v [B,T,KV,D] -> [B,S,H,D] (``ref.py:21``).
    """
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, D)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * scale
    q_pos = torch.arange(S, device=q.device)[:, None]
    k_pos = torch.arange(T, device=q.device)[None, :]
    mask = (q_pos + (T - S)) >= k_pos
    scores = torch.where(mask, scores,
                         torch.tensor(NEG_INF, device=scores.device))
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(B, S, H, D)


def decode_attention(q: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, lengths: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """One-token decode over a contiguous cache (``ref.py:43``).

    q [B,1,H,D]; cache [B,T,KV,D]; lengths [B] valid prefix -> [B,1,H,D].
    """
    B, _, H, D = q.shape
    T, KV = cache_k.shape[1], cache_k.shape[2]
    valid = (torch.arange(T, device=q.device)[None, :]
             < lengths.to(q.device)[:, None])                  # [B,T]
    v = _zero_past(cache_v, valid)
    qg = q.reshape(B, 1, KV, H // KV, D)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(),
                          cache_k.float()) * scale
    scores = torch.where(valid[:, None, None, None, :], scores,
                         torch.tensor(NEG_INF, device=scores.device))
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(B, 1, H, D)


def _gather_valid(page_table: torch.Tensor, lengths: torch.Tensor,
                  page_size: int):
    """(safe page ids [B,P], valid [B,T] positions < length)."""
    B, max_pages = page_table.shape
    safe = page_table.clamp(min=0).long()
    pos = torch.arange(max_pages * page_size, device=page_table.device)
    valid = pos[None, :] < lengths.to(page_table.device)[:, None]
    return safe, valid


def paged_decode_attention(q: torch.Tensor, kv_pages: torch.Tensor,
                           page_table: torch.Tensor, lengths: torch.Tensor,
                           scale: float) -> torch.Tensor:
    """Decode attention reading K/V through a page table.

    q:          [B,1,H,D]
    kv_pages:   [N_pages, page_size, 2, KV, D]  (typed view of the pool)
    page_table: [B, max_pages] int physical page ids (-1 = unmapped)
    lengths:    [B] tokens valid per sequence
    """
    B, _, H, D = q.shape
    page_size, KV = kv_pages.shape[1], kv_pages.shape[3]
    T = page_table.shape[1] * page_size
    safe, valid = _gather_valid(page_table, lengths, page_size)
    gathered = kv_pages[safe]                       # [B,P,ps,2,KV,D]
    k = gathered[:, :, :, 0].reshape(B, T, KV, D)
    v = _zero_past(gathered[:, :, :, 1].reshape(B, T, KV, D), valid)
    qg = q.reshape(B, 1, KV, H // KV, D)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * scale
    scores = torch.where(valid[:, None, None, None, :], scores,
                         torch.tensor(NEG_INF, device=scores.device))
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(B, 1, H, D)


def paged_mla_decode_attention(q: torch.Tensor, kv_pages: torch.Tensor,
                               page_table: torch.Tensor,
                               lengths: torch.Tensor, latent_dim: int,
                               scale: float) -> torch.Tensor:
    """Absorbed-MLA decode attention through a page table.

    q:          [B,1,H, r+rp]  absorbed query [q_latent | q_rope]
    kv_pages:   [N_pages, page_size, r+rp]  (typed view of the pool)
    page_table: [B, max_pages] int physical page ids (-1 = unmapped)
    lengths:    [B] tokens valid per sequence
    Returns the latent context [B,1,H,latent_dim].
    """
    B, _, H, e = q.shape
    page_size = kv_pages.shape[1]
    T = page_table.shape[1] * page_size
    safe, valid = _gather_valid(page_table, lengths, page_size)
    rows = kv_pages[safe].reshape(B, T, e)          # [B,T, r+rp]
    scores = torch.einsum("bshe,bte->bhst", q.float(), rows.float()) * scale
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.tensor(NEG_INF, device=scores.device))
    w = torch.softmax(scores, dim=-1).to(rows.dtype)
    values = torch.where(valid[:, :, None], rows[..., :latent_dim],
                         torch.zeros((), dtype=rows.dtype, device=rows.device))
    return torch.einsum("bhst,btr->bshr", w, values)


def paged_kv_write(pool: torch.Tensor, kv_flat: torch.Tensor,
                   pages: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """Store token rows ``kv_flat`` [n, e] at ``(pages, slots)`` of the
    flat pool [n_pages, page_elems], IN PLACE, dropping rows whose page id
    is below 0.  Selecting the kept rows reads the mask back to the host
    (one synchronisation on a card): the kernel's yardstick, not a path
    the card runs."""
    e = kv_flat.shape[-1]
    keep = pages >= 0
    rows = pages[keep].long()
    cols = (slots[keep].long() * e)[:, None] \
        + torch.arange(e, device=pool.device)[None, :]
    pool.index_put_((rows[:, None], cols), kv_flat[keep].to(pool.dtype))
    return pool


def _segments(group_sizes: torch.Tensor):
    """(expert, first row, end row) of every non-empty group, read on the
    host (a plain version may synchronise)."""
    ends = torch.cumsum(group_sizes.long(), 0).tolist()
    starts = [0] + ends[:-1]
    return [(e, s, t) for e, (s, t) in enumerate(zip(starts, ends)) if t > s]


def moe_gemm(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor
             ) -> torch.Tensor:
    """Token-sorted grouped matmul ``out[i] = x[i] @ w[expert_of(i)]``
    (``ref.py:115``).

    x [N,K] sorted by expert; w [E,K,M] (any strides: the dgrad passes
    ``w.transpose(1, 2)``); group_sizes [E].  Computed one expert segment
    at a time in f32 (the reference's ``w[expert_of]`` would build an
    [N,K,M] tensor), rounded to x's dtype.  Rows past ``sum(group_sizes)``
    are 0, as the kernels leave them (the reference clamps them to the
    last expert; ``apply_moe_grouped`` never produces such rows).
    """
    out = torch.zeros((x.shape[0], w.shape[2]), dtype=x.dtype,
                      device=x.device)
    for e, s, t in _segments(group_sizes):
        out[s:t] = (x[s:t].float() @ w[e].float()).to(x.dtype)
    return out


def moe_gemm_wgrad(x: torch.Tensor, dy: torch.Tensor,
                   group_sizes: torch.Tensor) -> torch.Tensor:
    """The weight gradient of ``moe_gemm``: ``dw[e] = x[rows of e]^T @
    dy[rows of e]`` in f32, in x's dtype; x [N,K], dy [N,M] -> [E,K,M].
    An expert with no rows gets zeros."""
    E = group_sizes.shape[0]
    dw = torch.zeros((E, x.shape[1], dy.shape[1]), dtype=x.dtype,
                     device=x.device)
    for e, s, t in _segments(group_sizes):
        dw[e] = (x[s:t].float().T @ dy[s:t].float()).to(x.dtype)
    return dw


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B_: torch.Tensor, C_: torch.Tensor,
             h0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD by the sequential per-token recurrence (``ref.py:133``).

    x [B,S,H,P]; dt [B,S,H] (post-softplus); A [H] (negative); B_/C_
    [B,S,G,N] (G groups broadcast onto H); h0 [B,H,P,N] or None.
    Returns (y [B,S,H,P] in x's dtype, h_final [B,H,P,N] f32).
    """
    Bb, S, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    Bh = B_.float().repeat_interleave(H // G, dim=2)        # [B,S,H,N]
    Ch = C_.float().repeat_interleave(H // G, dim=2)
    h = (torch.zeros((Bb, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    xf, dtf, Af = x.float(), dt.float(), A.float()
    ys = []
    for t in range(S):
        dA = torch.exp(dtf[:, t] * Af[None, :])             # [B,H]
        h = h * dA[..., None, None] + (dtf[:, t, :, None, None]
                                       * xf[:, t, :, :, None]
                                       * Bh[:, t, :, None, :])
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ch[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), h
