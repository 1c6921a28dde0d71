"""Mamba2 (SSD) block: in_proj -> causal conv1d -> SSD scan -> gated out_proj.

Port of ``src/repro/models/ssm.py``.  The recurrent state ``h [B,H,P,N]``
(f32) plus the conv tail are this family's whole per-request cache:
constant size, whatever the context length.  Under the sharded step's
hooks the block runs on this rank's heads (the section below).  The whole-sequence scan goes
through ``kernels.ops.ssd_scan`` (the SSD kernel on a card, the chunked
plain version on the CPU), differentiable on both (on a card its backward
is the kernel ``ssd_scan_bwd``); decode runs the one-token recurrence.

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
from repro_torch.models.hooks import IDENTITY_HOOKS, Hooks


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.d_inner(cfg.d_model)
    nh = s.n_heads(cfg.d_model)
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    return s, d_in, nh, conv_dim, s.d_state


def init_ssm(gen: torch.Generator, cfg: ModelConfig, dtype) -> Dict:
    """Random block params drawn from ``gen``; ``A_log``, ``D`` and
    ``dt_bias`` stay f32 whatever the model dtype (``ssm.py:41-43``)."""
    s, d_in, nh, conv_dim, _ = _dims(cfg)
    d = cfg.d_model
    dev = gen.device
    return {
        "in_proj": layers.dense_init(gen, (d, proj_width(cfg)), dtype),
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
                 cfg: ModelConfig, lead: Tuple[int, ...], heads, tp):
    """(x heads, B groups, C groups, dt after softplus, A, D) of the
    ``heads`` (first, count) this rank runs, from the conv output and the
    raw dt projection (both every channel); ``lead`` is (B,) or (B, S).
    Of a split, the replicated inputs enter the tensor-parallel region
    (``tp.enter``) where this rank's heads are taken from them."""
    s, d_in, nh, _, N = _dims(cfg)
    h0, n = heads
    gN = s.n_groups * N
    hp = p
    if n < nh:
        xbc, dt = tp.enter(xbc), tp.enter(dt)
        hp = {k: tp.enter(p[k])[h0:h0 + n] for k in ("A_log", "D",
                                                     "dt_bias")}
    xs, B_, C_ = torch.split(xbc, [d_in, gN, gN], dim=-1)
    Bh = B_.reshape(*lead, s.n_groups, N)
    Ch = C_.reshape(*lead, s.n_groups, N)
    if n < nh:
        xs = xs[..., h0 * s.head_dim:(h0 + n) * s.head_dim]
        dt = dt[..., h0:h0 + n]
        if s.n_groups > 1:          # the groups of this rank's heads
            g0 = h0 * s.n_groups // nh
            g1 = (h0 + n - 1) * s.n_groups // nh + 1
            Bh, Ch = Bh[..., g0:g1, :], Ch[..., g0:g1, :]
    xh = xs.reshape(*lead, n, s.head_dim)
    dtv = F.softplus(dt.float() + hp["dt_bias"])
    A = -torch.exp(hp["A_log"])                          # [H]
    return xh, Bh, Ch, dtv, A, hp["D"]


def scan_chunk(S: int, chunk_size: int) -> int:
    """The largest chunk that divides S (``ssm.py:105-110``)."""
    for cand in (chunk_size, 128, 64, 32, 16, 8, 4, 2, 1):
        if cand <= S and S % cand == 0:
            return cand
    return 1


# ---------------------------------------------------------------------------
# the sharded step's split (``models/hooks.py``): what is split is read from
# the leaves' local shapes, and at one rank every helper is the plain op
# ---------------------------------------------------------------------------
#
# The serve and train rules split ``in_proj``'s packed columns (z | x | B |
# C | dt), ``conv_w``'s channels and ``out_proj``'s rows over the same axes
# (``hooks.ssm``, else ``tp``), and the state's heads over ``tp``.  A
# contiguous column cut falls across the five parts and across the heads,
# so this rank's columns of the product are gathered into every column
# (for the rows of the boundary: crosspool's weights pool multiplies the
# rows of every ``data`` group), the depthwise conv runs on every channel
# (``conv_w``, one layer's ``W x conv_dim``, rides the same gather; the
# conv cache keeps every channel), and this rank's heads are taken from
# it.  The gated norm spans every head.  ``out_proj``'s rows line up with
# this rank's heads when both split over ``tp`` alone: the norm's sum of
# squares is then summed over ``tp`` in float32; else the heads' output is
# gathered, normed whole and this rank's rows taken.  The output's
# partial sums are completed in float32 and rounded once.

def proj_width(cfg: ModelConfig) -> int:
    """``in_proj``'s columns: z | x | B | C | dt."""
    s, d_in, nh, _, N = _dims(cfg)
    return 2 * d_in + 2 * s.n_groups * N + nh


def _heads(cfg: ModelConfig, w_in: torch.Tensor, tp) -> Tuple[int, int]:
    """(first, count) of the heads this rank runs: its share over ``tp``
    when ``in_proj``'s columns are split and the heads divide, else every
    head (the state's cache holds the same: ``Strategy.ssm_heads``)."""
    nh = _dims(cfg)[2]
    if w_in.shape[-1] == proj_width(cfg) or nh % tp.size:
        return 0, nh
    n = nh // tp.size
    return tp.index * n, n


def _gather_last(pool, parts):
    """Each tensor of ``parts`` with its last dimension gathered over
    ``pool`` (rank ``i``'s columns at the ``i``-th place), in ONE
    collective: the parts travel as one flat row."""
    if len(parts) == 1:
        return [pool.gather(parts[0], -1)]
    flat = pool.gather(torch.cat([t.reshape(1, -1) for t in parts], 1), 0)
    out, o = [], 0
    for t in parts:
        g = flat[:, o:o + t.numel()].reshape(pool.size, *t.shape)
        out.append(g.movedim(0, -2).reshape(*t.shape[:-1], -1))
        o += t.numel()
    return out


def _project_in(p: Dict, cfg: ModelConfig, x: torch.Tensor, hooks: Hooks
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(``x @ in_proj`` with every column, for ``x``'s rows [B, ..., D];
    ``conv_w`` [W, conv_dim] with every channel): a rank's columns of the
    product and its channels of ``conv_w`` (34 KB a zamba2 layer) are
    gathered together."""
    w, cw = p["in_proj"], p["conv_w"]
    pool = hooks.ssm or hooks.tp
    split_w = cw.shape[-1] < _dims(cfg)[3]
    if w.shape[-1] == proj_width(cfg):
        return x @ w, pool.gather(cw, -1) if split_w else cw
    part = pool.enter(hooks.boundary_in(x)) @ w
    if not split_w:
        return hooks.boundary_out(pool.gather(part, -1)), cw
    proj, cw = _gather_last(pool, [part, cw.to(part.dtype)])
    return hooks.boundary_out(proj), cw.to(p["conv_w"].dtype)


def _gate_out(y: torch.Tensor, z: torch.Tensor, p: Dict, cfg: ModelConfig,
              hooks: Hooks, heads) -> torch.Tensor:
    """The gated RMSNorm of ``y`` [.., n*P] (this rank's heads) by ``z``
    (every channel) and the output projection, in the residual's layout
    (``tp.seq_out``).  Where ``out_proj``'s rows are not this rank's
    heads, every head's output is gathered first and normed whole."""
    s, d_in, nh, _, _ = _dims(cfg)
    tp, w = hooks.tp, p["out_proj"]
    h0, n = heads
    aligned = n < nh and w.shape[0] == y.shape[-1]
    if n < nh and not aligned:
        y, n = tp.gather(y, -1), nh
    if n == nh:
        y = layers.rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    else:
        c = slice(h0 * s.head_dim, (h0 + n) * s.head_dim)
        g = (y * F.silu(tp.enter(z)[..., c])).float()
        var = tp.sum(g.square().sum(-1, keepdim=True)) / d_in
        y = (g * torch.rsqrt(var + cfg.norm_eps)
             * (1.0 + tp.enter(p["norm"])[c].float())).to(y.dtype)
    if w.shape[0] == d_in:
        return tp.seq_out(y @ w, False)
    pool = hooks.ssm or hooks.tp
    if not aligned:
        # out_proj's rows of every row of the boundary
        y = pool.split(hooks.boundary_in(y), -1)
    out = y.float() @ w.float()
    out = tp.seq_out(out, True) if pool is tp else pool.reduce(out)
    out = out.to(torch.promote_types(y.dtype, w.dtype))
    return out if aligned else hooks.boundary_out(out)


def ssm_full(p: Dict, cfg: ModelConfig, x: torch.Tensor,
             state: Optional[Dict] = None, *, hooks: Hooks = IDENTITY_HOOKS
             ) -> Tuple[torch.Tensor, Dict]:
    """Whole-sequence SSD block.  x [B,S,D] -> (out [B,S,D], final state
    ``{"h": [B,H,P,N] f32, "conv": [B,W-1,conv_dim]}``); ``state`` seeds
    the scan and the conv (or None).  Under the sharded step's hooks the
    scan runs on this rank's heads (``h`` holds them; the conv tail every
    channel) and ``out`` is in the residual's layout."""
    s, d_in, nh, conv_dim, N = _dims(cfg)
    B, S, _ = x.shape
    proj, conv_w = _project_in(p, cfg, x, hooks)
    z, xs, B_, C_, dt = _split_proj(proj, cfg)
    xbc = torch.cat([xs, B_, C_], dim=-1)                # [B,S,conv_dim]
    xbc, conv_tail = _causal_conv(xbc, conv_w, p["conv_b"],
                                  state["conv"] if state is not None else None)
    heads = _heads(cfg, p["in_proj"], hooks.tp)
    xh, Bh, Ch, dtv, A, D = _scan_inputs(F.silu(xbc), dt, p, cfg, (B, S),
                                         heads, hooks.tp)
    h0 = state["h"] if state is not None else None
    # the kernel takes contiguous operands; on the CPU this changes nothing
    y, h_final = kops.ssd_scan(xh.contiguous(), dtv, A, Bh.contiguous(),
                               Ch.contiguous(),
                               chunk=scan_chunk(S, s.chunk_size), h0=h0)
    y = y + xh * D[None, None, :, None]                  # skip connection
    y = y.reshape(B, S, heads[1] * s.head_dim).to(x.dtype)
    return _gate_out(y, z, p, cfg, hooks, heads), {
        "h": hooks.kv_state(h_final), "conv": conv_tail}


def init_ssm_state(cfg: ModelConfig, batch: int, device) -> Dict:
    s, d_in, nh, conv_dim, N = _dims(cfg)
    conv_dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    return {
        "h": torch.zeros((batch, nh, s.head_dim, N), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, s.conv_width - 1, conv_dim),
                            dtype=conv_dtype, device=device),
    }


def ssm_decode(p: Dict, cfg: ModelConfig, x: torch.Tensor, state: Dict, *,
               hooks: Hooks = IDENTITY_HOOKS) -> Tuple[torch.Tensor, Dict]:
    """Single-token SSD recurrence.  x [B,1,D] -> (out [B,1,D], new
    state); the conv window sums in f32 and rounds back to x's dtype.
    Under the sharded step's hooks ``state["h"]`` holds this rank's heads
    (``ssm_full``'s)."""
    s, d_in, nh, conv_dim, N = _dims(cfg)
    B = x.shape[0]
    proj, conv_w = _project_in(p, cfg, x[:, 0], hooks)
    z, xs, B_, C_, dt = _split_proj(proj, cfg)
    xbc = torch.cat([xs, B_, C_], dim=-1)                # [B,conv_dim]
    # roll the conv window: the tail holds the last W-1 inputs
    tail = state["conv"]
    window = torch.cat([tail, xbc[:, None, :].to(tail.dtype)],
                       dim=1)                            # [B,W,C]
    y = torch.einsum("bwc,wc->bc", window.float(), conv_w.float()) \
        + p["conv_b"].float()
    new_tail = window[:, 1:]
    xbc = F.silu(y).to(x.dtype)
    heads = _heads(cfg, p["in_proj"], hooks.tp)
    if state["h"].shape[1] != heads[1]:
        raise ValueError(f"a state of {state['h'].shape[1]} heads against "
                         f"this rank's {heads[1]}")
    xh, Bh, Ch, dtv, A, D = _scan_inputs(xbc, dt, p, cfg, (B,), heads,
                                         hooks.tp)
    y_t, h_next = ssd_decode_step(state["h"], xh, dtv, A, Bh, Ch)
    y_t = y_t + xh * D[None, :, None]
    y_t = y_t.reshape(B, heads[1] * s.head_dim).to(x.dtype)
    out = _gate_out(y_t, z, p, cfg, hooks, heads)[:, None, :]
    return out, {"h": hooks.kv_state(h_next), "conv": new_tail}
