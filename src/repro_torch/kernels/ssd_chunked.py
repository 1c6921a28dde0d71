"""Chunked Mamba2 SSD (state-space duality) in plain PyTorch.

Port of ``src/repro/kernels/ssd_chunked.py``: the whole-sequence form the
reference's XLA route runs (``kernels/ops.py:128``), and here the plain
version of the SSD scan kernel (``csrc/ssd_scan.cu``) — the CPU path of
``kernels.ops.ssd_scan`` and the yardstick on the card.  O(S/chunk) steps
with matmuls inside, against the O(S) recurrence of ``ref.ssd_scan``.

Math (arXiv:2405.21060 §6): within a chunk of length L with per-step log
decay a_t = dt_t * A and inclusive cumsum La_t:

  intra:  Y[t] += sum_{s<=t} (C_t.B_s) exp(La_t - La_s) dt_s x_s
  state:  S_c   = sum_s exp(La_L - La_s) dt_s (B_s ⊗ x_s)
  recur:  h_{c+1} = exp(La_L) h_c + S_c
  inter:  Y[t] += C_t . (exp(La_t) h_c)
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def ssd_scan_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                     B_: torch.Tensor, C_: torch.Tensor, chunk: int = 64,
                     h0: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same contract as ``ref.ssd_scan``; S must be divisible by
    ``chunk``.  x [B,S,H,P]; dt [B,S,H]; A [H]; B_/C_ [B,S,G,N];
    h0 [B,H,P,N].  Returns (y [B,S,H,P] in x's dtype, h_final f32)."""
    Bb, S, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    rep = H // G
    if S % chunk:
        raise ValueError(f"seq {S} not divisible by chunk {chunk}")
    nc = S // chunk
    f32 = torch.float32
    xc = x.to(f32).reshape(Bb, nc, chunk, H, P)
    dtc = dt.to(f32).reshape(Bb, nc, chunk, H)
    Bc = B_.to(f32).repeat_interleave(rep, dim=2).reshape(Bb, nc, chunk, H, N)
    Cc = C_.to(f32).repeat_interleave(rep, dim=2).reshape(Bb, nc, chunk, H, N)

    a = dtc * A.to(f32)[None, None, None, :]             # [B,nc,L,H]
    La = torch.cumsum(a, dim=2)                          # inclusive cumsum
    La_total = La[:, :, -1, :]                           # [B,nc,H]

    # intra-chunk: decay[l,s] = exp(La_l - La_s) for s<=l else 0.  The
    # double where keeps exp away from the upper triangle, where the
    # difference is positive and can overflow (``ssd_chunked.py:54-57``).
    diff = La[:, :, :, None, :] - La[:, :, None, :, :]   # [B,nc,L,L,H]
    idx = torch.arange(chunk, device=x.device)
    tri = (idx[:, None] >= idx[None, :])[None, None, :, :, None]
    decay = torch.where(tri, torch.exp(torch.where(tri, diff, 0.0)), 0.0)
    scores = torch.einsum("bclhn,bcshn->bclsh", Cc, Bc) * decay
    y_intra = torch.einsum("bclsh,bcsh,bcshp->bclhp", scores, dtc, xc)

    # per-chunk end states
    decay_to_end = torch.exp(La_total[:, :, None, :] - La)   # [B,nc,L,H]
    S_c = torch.einsum("bcsh,bcshn,bcshp->bchpn", dtc * decay_to_end, Bc, xc)

    # inter-chunk recurrence: the state at each chunk's START
    h = (torch.zeros((Bb, H, P, N), dtype=f32, device=x.device)
         if h0 is None else h0.to(f32))
    starts = []
    for c in range(nc):
        starts.append(h)
        h = h * torch.exp(La_total[:, c])[..., None, None] + S_c[:, c]
    h_starts = torch.stack(starts, dim=1)                # [B,nc,H,P,N]

    C_dec = Cc * torch.exp(La)[..., None]                # [B,nc,L,H,N]
    y_inter = torch.einsum("bclhn,bchpn->bclhp", C_dec, h_starts)
    y = (y_intra + y_inter).reshape(Bb, S, H, P).to(x.dtype)
    return y, h


def ssd_decode_step(h: torch.Tensor, x_t: torch.Tensor, dt_t: torch.Tensor,
                    A: torch.Tensor, B_t: torch.Tensor, C_t: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token SSD recurrence (the decode path).

    h [B,H,P,N] f32; x_t [B,H,P]; dt_t [B,H]; B_t/C_t [B,G,N].
    Returns (y_t [B,H,P] in x_t's dtype, h_next).
    """
    H, G = x_t.shape[1], B_t.shape[1]
    Bh = B_t.float().repeat_interleave(H // G, dim=1)    # [B,H,N]
    Ch = C_t.float().repeat_interleave(H // G, dim=1)
    dtf = dt_t.float()
    dA = torch.exp(dtf * A[None, :])                     # [B,H]
    h_next = (h * dA[..., None, None]
              + dtf[..., None, None] * x_t.float()[..., :, None]
              * Bh[..., None, :])
    y = torch.einsum("bhpn,bhn->bhp", h_next, Ch).to(x_t.dtype)
    return y, h_next
