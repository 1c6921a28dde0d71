"""Mamba2 (SSD) block: in_proj -> causal conv1d -> SSD scan -> gated out_proj.

Port of ``src/repro/models/ssm.py``.  The recurrent state ``h [B,H,P,N]``
(f32) plus the conv tail are this family's whole per-request cache:
constant size, whatever the context length.  The whole-sequence scan goes
through ``kernels.ops.ssd_scan`` (the SSD kernel on a card, the chunked
plain version on the CPU); decode runs the one-token recurrence.

The two convolutions differ in dtype, as the reference's do: the prefill
conv sums in the model dtype (``ssm.py:72``), the decode conv in f32 and
rounds back (``:139-143``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ssd_chunked import ssd_decode_step
from repro_torch.models import layers


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.d_inner(cfg.d_model)
    nh = s.n_heads(cfg.d_model)
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    return s, d_in, nh, conv_dim, s.d_state


def init_ssm(gen: torch.Generator, cfg: ModelConfig, dtype) -> Dict:
    """Random block params drawn from ``gen``; ``A_log``, ``D`` and
    ``dt_bias`` stay f32 whatever the model dtype (``ssm.py:41-43``)."""
    s, d_in, nh, conv_dim, N = _dims(cfg)
    d = cfg.d_model
    dev = gen.device
    # in_proj emits [z (gate), x, B, C, dt] concatenated
    proj_out = 2 * d_in + 2 * s.n_groups * N + nh
    return {
        "in_proj": layers.dense_init(gen, (d, proj_out), dtype),
        "conv_w": layers.dense_init(gen, (s.conv_width, conv_dim), dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, device=dev)),
        "D": torch.ones((nh,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((nh,), dtype=torch.float32, device=dev),
        "norm": torch.zeros((d_in,), dtype=dtype, device=dev),
        "out_proj": layers.dense_init(gen, (d_in, d), dtype),
    }


def _split_proj(proj: torch.Tensor, cfg: ModelConfig):
    s, d_in, nh, _, N = _dims(cfg)
    gN = s.n_groups * N
    return torch.split(proj, [d_in, d_in, gN, gN, nh], dim=-1)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d, summed in x's dtype.

    x [B,S,C]; w [W,C]; tail [B,W-1,C] previous context (decode chaining).
    Returns (y [B,S,C], new_tail [B,W-1,C]).
    """
    W = w.shape[0]
    if tail is None:
        tail = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype,
                           device=x.device)
    xp = torch.cat([tail, x], dim=1)                     # [B,S+W-1,C]
    S = x.shape[1]
    y = xp[:, 0:S] * w[0][None, None, :]
    for i in range(1, W):
        y = y + xp[:, i:i + S] * w[i][None, None, :]
    new_tail = xp[:, -(W - 1):] if W > 1 else tail
    return y + b[None, None, :], new_tail


def _scan_inputs(xbc: torch.Tensor, dt: torch.Tensor, p: Dict,
                 cfg: ModelConfig, lead: Tuple[int, ...]):
    """(x heads, B groups, C groups, dt after softplus, A) from the conv
    output and the raw dt projection; ``lead`` is (B,) or (B, S)."""
    s, d_in, nh, _, N = _dims(cfg)
    xs, B_, C_ = torch.split(xbc, [d_in, s.n_groups * N, s.n_groups * N],
                             dim=-1)
    xh = xs.reshape(*lead, nh, s.head_dim)
    Bh = B_.reshape(*lead, s.n_groups, N)
    Ch = C_.reshape(*lead, s.n_groups, N)
    dtv = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])                           # [H]
    return xh, Bh, Ch, dtv, A


def scan_chunk(S: int, chunk_size: int) -> int:
    """The largest chunk that divides S (``ssm.py:105-110``)."""
    for cand in (chunk_size, 128, 64, 32, 16, 8, 4, 2, 1):
        if cand <= S and S % cand == 0:
            return cand
    return 1


def _gate_out(y: torch.Tensor, z: torch.Tensor, p: Dict, cfg: ModelConfig
              ) -> torch.Tensor:
    y = layers.rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return y @ p["out_proj"]


def ssm_full(p: Dict, cfg: ModelConfig, x: torch.Tensor,
             state: Optional[Dict] = None) -> Tuple[torch.Tensor, Dict]:
    """Whole-sequence SSD block.  x [B,S,D] -> (out [B,S,D], final state
    ``{"h": [B,H,P,N] f32, "conv": [B,W-1,conv_dim]}``); ``state`` seeds
    the scan and the conv (or None)."""
    s, d_in, nh, conv_dim, N = _dims(cfg)
    B, S, _ = x.shape
    z, xs, B_, C_, dt = _split_proj(x @ p["in_proj"], cfg)
    xbc = torch.cat([xs, B_, C_], dim=-1)                # [B,S,conv_dim]
    xbc, conv_tail = _causal_conv(xbc, p["conv_w"], p["conv_b"],
                                  state["conv"] if state is not None else None)
    xh, Bh, Ch, dtv, A = _scan_inputs(F.silu(xbc), dt, p, cfg, (B, S))
    h0 = state["h"] if state is not None else None
    # the kernel takes contiguous operands; on the CPU this changes nothing
    y, h_final = kops.ssd_scan(xh.contiguous(), dtv, A, Bh.contiguous(),
                               Ch.contiguous(),
                               chunk=scan_chunk(S, s.chunk_size), h0=h0)
    y = y + xh * p["D"][None, None, :, None]             # skip connection
    y = y.reshape(B, S, d_in).to(x.dtype)
    return _gate_out(y, z, p, cfg), {"h": h_final, "conv": conv_tail}


def init_ssm_state(cfg: ModelConfig, batch: int, device) -> Dict:
    s, d_in, nh, conv_dim, N = _dims(cfg)
    conv_dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    return {
        "h": torch.zeros((batch, nh, s.head_dim, N), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, s.conv_width - 1, conv_dim),
                            dtype=conv_dtype, device=device),
    }


def ssm_decode(p: Dict, cfg: ModelConfig, x: torch.Tensor, state: Dict
               ) -> Tuple[torch.Tensor, Dict]:
    """Single-token SSD recurrence.  x [B,1,D] -> (out [B,1,D], new
    state); the conv window sums in f32 and rounds back to x's dtype."""
    s, d_in, nh, conv_dim, N = _dims(cfg)
    B = x.shape[0]
    z, xs, B_, C_, dt = _split_proj(x[:, 0] @ p["in_proj"], cfg)
    xbc = torch.cat([xs, B_, C_], dim=-1)                # [B,conv_dim]
    # roll the conv window: the tail holds the last W-1 inputs
    tail = state["conv"]
    window = torch.cat([tail, xbc[:, None, :].to(tail.dtype)],
                       dim=1)                            # [B,W,C]
    y = torch.einsum("bwc,wc->bc", window.float(), p["conv_w"].float()) \
        + p["conv_b"].float()
    new_tail = window[:, 1:]
    xbc = F.silu(y).to(x.dtype)
    xh, Bh, Ch, dtv, A = _scan_inputs(xbc, dt, p, cfg, (B,))
    y_t, h_next = ssd_decode_step(state["h"], xh, dtv, A, Bh, Ch)
    y_t = y_t + xh * p["D"][None, :, None]
    y_t = y_t.reshape(B, d_in).to(x.dtype)
    out = _gate_out(y_t, z, p, cfg)[:, None, :]
    return out, {"h": h_next, "conv": new_tail}
