"""Plain PyTorch versions of the paged decode kernels.

Counterparts of ``src/repro/kernels/ref.py:63-113``: the CPU path of the
kernel wrappers, and the yardstick the CUDA kernels are held against on
the card.  They gather the pages a table names into a dense cache and
run ordinary masked softmax attention, with one guard the JAX oracle
leaves implicit: value rows at positions ``>= length`` are zeroed before
the weighted sum, as the kernels do, so garbage (even NaN) in a mapped
page's unused slots cannot leak into the output through ``0 * garbage``.
On finite inputs that is exactly the oracle's arithmetic.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


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
    v = gathered[:, :, :, 1].reshape(B, T, KV, D)
    v = torch.where(valid[:, :, None, None], v, torch.zeros((), dtype=v.dtype,
                                                           device=v.device))
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
