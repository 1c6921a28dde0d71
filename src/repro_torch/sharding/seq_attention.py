"""Sequence-sharded decode attention (flash-decoding style) over
``torch.distributed``.

Port of ``src/repro/sharding/seq_attention.py``, the mechanism behind the
paper's Fig. 2b: instead of DP attention (where a request only sees one
replica's KV capacity), the KV cache of ONE request is sharded along the
*sequence* axis across the KV-pool ranks.  Each rank attends over its
slice, giving its normalised output o_i and the log-sum-exp lse_i of its
scores (float32), and the slices are combined:

    m   = max_i lse_i
    w_i = exp(lse_i - m)
    out = sum_i w_i * o_i  /  sum_i w_i

A slice that holds no token of a row gives lse_i = -inf and o_i = 0, and
adds nothing.  This is the reference's combine of (m_i, l_i, o_i)
partials written on the normalised form (lse_i = m_i + log l_i, o_i =
acc_i / l_i), so a rank's slice can be read by the contiguous decode
kernel, which returns exactly (o_i, lse_i).  The combine is one
``all_gather`` of every slice's (o_i, lse_i), packed together, after
which each rank sums them in the axis order: one collective a layer of
O(n * B * H * D) bytes, independent of the context length, and every
rank's result equal bit for bit.

The GQA local body reads its slice through ``ops.decode_attention(...,
return_lse=True)``, which routes a CUDA tensor to the contiguous decode
kernel and a CPU tensor to its plain version; the MLA local body is plain
on every device, as the reference's is (the paged MLA kernel reads packed
pages, not the contiguous ``latent`` / ``rope`` leaves).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import Mesh

NEG_INF = -1e30


def _shard_offset(mesh: Mesh, kv_axes: Tuple[str, ...], local_t: int) -> int:
    """Global token offset of this rank's KV slice (row-major over the
    axes, ``seq_attention.py:47-53``)."""
    return mesh.index(kv_axes) * local_t


def combine(mesh: Mesh, kv_axes, o_i: torch.Tensor,
            lse_i: torch.Tensor) -> torch.Tensor:
    """LSE-combine the slices' normalised outputs ``o_i`` [..., R] by
    their log-sum-exps ``lse_i`` [...] (float32; -inf where a slice holds
    no token) over the kv shard axes: float32 [..., R]."""
    packed = torch.cat([o_i.float(), lse_i[..., None]], dim=-1)
    parts = mesh.all_gather(packed[None], kv_axes, dim=0)   # [n, ..., R+1]
    o, lse = parts[..., :-1], parts[..., -1]
    m = lse.amax(dim=0)
    # a row no slice holds a token of (length 0) weighs nothing anywhere
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.exp(lse - m)
    num, den = (w[..., None] * o).sum(dim=0), w.sum(dim=0)
    return num / torch.clamp(den, min=1e-20)[..., None]


def _normalised(s: torch.Tensor, mask: torch.Tensor, v: torch.Tensor,
                einsum: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain body of a slice: (o [..., R] normalised, lse [...]) of the
    masked float32 scores ``s`` [..., T] (lse = m + log l; o = 0 and lse =
    -inf where the slice holds no token of the row)."""
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None]).masked_fill(~mask, 0.0)
    l_ = p.sum(dim=-1)
    o = torch.einsum(einsum, p, v.float())
    held = l_ > 0
    o = o / torch.where(held, l_, torch.ones_like(l_))[..., None]
    lse = torch.where(held, m + torch.log(torch.where(held, l_, 1.0)),
                      torch.full_like(m, float("-inf")))
    return o, lse


def make_seq_decode_attn(mesh: Mesh, kv_axes: Tuple[str, ...],
                         batch_axes: Optional[Tuple[str, ...]], scale: float):
    """GQA/MQA decode attention with KV sequence-sharded over ``kv_axes``.

    Returns fn(q [B,1,H,D], cache_k [B,T_loc,KV,D], cache_v, lengths [B])
    -> out [B,1,H,D] on this rank's local shards: its batch rows (split
    over ``batch_axes`` by the caller, which this function never reads)
    and its T_loc cache rows.  ``lengths`` counts valid tokens (incl.
    the current one) of the WHOLE sequence; the slice reads
    ``clamp(lengths - offset, 0, T_loc)`` of its own rows through
    ``ops.decode_attention(..., return_lse=True)``.
    """
    del batch_axes                   # the caller passes local rows

    def local(q, k, v, lengths):
        B, _, H, D = q.shape
        Tl = k.shape[1]
        offset = _shard_offset(mesh, kv_axes, Tl)
        held = (lengths - offset).clamp(min=0, max=Tl)
        if k.element_size() == 1:       # an fp8 cache: dequantized exactly
            k, v = k.to(q.dtype), v.to(q.dtype)
        o, lse = kops.decode_attention(q, k, v, held.to(torch.int32),
                                       scale=scale, return_lse=True)
        o = o.reshape(B, H, D)
        out = combine(mesh, kv_axes, o, lse)
        return out.reshape(B, 1, H, D).to(q.dtype)

    return local


def make_seq_mla_decode_attn(mesh: Mesh, kv_axes: Tuple[str, ...],
                             batch_axes: Optional[Tuple[str, ...]],
                             scale: float):
    """MLA (absorbed-form) decode attention, latent cache sequence-sharded.

    fn(q_lat [B,1,H,r], q_rope [B,1,H,p], cache_latent [B,T_loc,r],
       cache_rope [B,T_loc,p], lengths [B]) -> ctx_lat [B,1,H,r], on local
    shards as ``make_seq_decode_attn``.  The context is returned in
    latent space (r), so the collective payload is B*H*(r+1): the Type II
    KV-head-limited case stays communication-light.  The local body is
    plain on every device.
    """
    del batch_axes

    def local(q_lat, q_rope, latent, rope, lengths):
        Tl = latent.shape[1]
        offset = _shard_offset(mesh, kv_axes, Tl)
        s = (torch.einsum("bshr,btr->bhst", q_lat.float(), latent.float())
             + torch.einsum("bshp,btp->bhst", q_rope.float(),
                            rope.float())) * scale         # [B,H,1,T]
        s = s[:, :, 0, :]                                      # [B,H,T]
        pos = offset + torch.arange(Tl, device=q_lat.device)
        mask = pos[None, None, :] < lengths[:, None, None]
        o, lse = _normalised(s, mask, latent, "bht,btr->bhr")
        out = combine(mesh, kv_axes, o, lse)                   # [B,H,R]
        return out[:, None].to(q_lat.dtype)                    # [B,1,H,R]

    return local
