"""Sequence-sharded decode attention (flash-decoding style) over
``torch.distributed``.

Port of ``src/repro/sharding/seq_attention.py``, the mechanism behind the
paper's Fig. 2b: instead of DP attention (where a request only sees one
replica's KV capacity), the KV cache of ONE request is sharded along the
*sequence* axis across the KV-pool ranks.  Each rank computes a partial
softmax (m_i, l_i, o_i) in float32 over its slice and the partials are
combined with a log-sum-exp reduction:

    m   = max_i m_i
    out = sum_i exp(m_i - m) * o_i  /  sum_i exp(m_i - m) * l_i

The reference's body runs under ``shard_map`` and combines with
``lax.pmax`` / ``lax.psum``; here each rank calls the function on its
local shards and the combine is one ``all_reduce(MAX)`` of m and one
``all_reduce(SUM)`` of the weighted o and l (packed together).  Both move
O(B * H * D) bytes, independent of the context length.  The local body is
plain torch, as the reference's is plain jnp.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.launch.mesh import Mesh

NEG_INF = -1e30


def _shard_offset(mesh: Mesh, kv_axes: Tuple[str, ...], local_t: int) -> int:
    """Global token offset of this rank's KV slice (row-major over the
    axes, ``seq_attention.py:47-53``)."""
    return mesh.index(kv_axes) * local_t


def _combine(mesh: Mesh, kv_axes, o_i: torch.Tensor, m_i: torch.Tensor,
             l_i: torch.Tensor) -> torch.Tensor:
    """LSE-combine partial attention across the kv shard axes.
    o_i [..., R]; m_i, l_i [...]."""
    m = mesh.all_reduce(m_i.clone(), kv_axes, op="max")
    w = torch.exp(m_i - m)
    packed = torch.cat([o_i * w[..., None], (l_i * w)[..., None]], dim=-1)
    packed = mesh.all_reduce(packed, kv_axes, op="sum")
    num, den = packed[..., :-1], packed[..., -1]
    return num / torch.clamp(den, min=1e-20)[..., None]


def make_seq_decode_attn(mesh: Mesh, kv_axes: Tuple[str, ...],
                         batch_axes: Optional[Tuple[str, ...]], scale: float):
    """GQA/MQA decode attention with KV sequence-sharded over ``kv_axes``.

    Returns fn(q [B,1,H,D], cache_k [B,T_loc,KV,D], cache_v, lengths [B])
    -> out [B,1,H,D] on this rank's local shards: its batch rows (split
    over ``batch_axes`` by the caller, which this function never reads)
    and its T_loc cache rows.  ``lengths`` counts valid tokens (incl.
    the current one) of the WHOLE sequence.
    """
    del batch_axes                   # the caller passes local rows

    def local(q, k, v, lengths):
        Bl, _, H, D = q.shape
        Tl, KV = k.shape[1], k.shape[2]
        G = H // KV
        offset = _shard_offset(mesh, kv_axes, Tl)
        qg = q.reshape(Bl, KV, G, D).float()
        s = torch.einsum("bkgd,btkd->bkgt", qg, k.float()) * scale
        pos = offset + torch.arange(Tl, device=q.device)
        mask = pos[None, None, None, :] < lengths[:, None, None, None]
        s = s.masked_fill(~mask, NEG_INF)
        m_i = s.amax(dim=-1)                                  # [B,KV,G]
        p = torch.exp(s - m_i[..., None]).masked_fill(~mask, 0.0)
        l_i = p.sum(dim=-1)
        o_i = torch.einsum("bkgt,btkd->bkgd", p, v.float())
        out = _combine(mesh, kv_axes, o_i, m_i, l_i)          # [B,KV,G,D]
        return out.reshape(Bl, 1, H, D).to(q.dtype)

    return local


def make_seq_mla_decode_attn(mesh: Mesh, kv_axes: Tuple[str, ...],
                             batch_axes: Optional[Tuple[str, ...]],
                             scale: float):
    """MLA (absorbed-form) decode attention, latent cache sequence-sharded.

    fn(q_lat [B,1,H,r], q_rope [B,1,H,p], cache_latent [B,T_loc,r],
       cache_rope [B,T_loc,p], lengths [B]) -> ctx_lat [B,1,H,r], on local
    shards as ``make_seq_decode_attn``.  The context is returned in
    latent space (r), so the collective payload is B*H*(r+1): the Type II
    KV-head-limited case stays communication-light.
    """
    del batch_axes

    def local(q_lat, q_rope, latent, rope, lengths):
        Tl = latent.shape[1]
        offset = _shard_offset(mesh, kv_axes, Tl)
        latent_f = latent.float()
        s = (torch.einsum("bshr,btr->bhst", q_lat.float(), latent_f)
             + torch.einsum("bshp,btp->bhst", q_rope.float(),
                            rope.float())) * scale         # [B,H,1,T]
        s = s[:, :, 0, :]                                      # [B,H,T]
        pos = offset + torch.arange(Tl, device=q_lat.device)
        mask = pos[None, None, :] < lengths[:, None, None]
        s = s.masked_fill(~mask, NEG_INF)
        m_i = s.amax(dim=-1)                                   # [B,H]
        p = torch.exp(s - m_i[..., None]).masked_fill(~mask, 0.0)
        l_i = p.sum(dim=-1)
        o_i = torch.einsum("bht,btr->bhr", p, latent_f)
        out = _combine(mesh, kv_axes, o_i, m_i, l_i)           # [B,H,R]
        return out[:, None].to(q_lat.dtype)                    # [B,1,H,R]

    return local
