"""Shared primitive layers: norms, RoPE, MLPs, embeddings, initializers.

Port of ``src/repro/models/layers.py``.  Weights keep the reference's
``[in, out]`` layout (``x @ w``), so a bridged JAX tree computes the same
function here.  Randomness comes from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, dtype, in_axis: int = 0
               ) -> torch.Tensor:
    """LeCun-normal over the input dimension (f32 draw, then cast)."""
    std = 1.0 / math.sqrt(max(shape[in_axis], 1))
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return w.mul_(std).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return w.mul_(0.02).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMSNorm with f32 statistics, scaling by ``(1 + weight)`` (the
    reference's zero-centred weight, ``layers.py:32-38``)."""
    dtype = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (1.0 + weight.float())).to(dtype)


def head_rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6
                  ) -> torch.Tensor:
    """Per-head qk-norm (Qwen3 style): normalizes the head_dim axis."""
    return rms_norm(x, weight, eps)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_sin_cos(positions: torch.Tensor, dim: int, theta: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """sin/cos tables for integer positions.  Returns [..., dim//2]."""
    exponent = torch.arange(0, dim, 2, dtype=torch.float32,
                            device=positions.device) / dim
    # theta stays a host scalar: a device copy of it would be a host
    # upload inside every decode step (and no CUDA graph can hold one)
    inv_freq = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32),
                               exponent)
    angles = positions.float()[..., None] * inv_freq
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor
               ) -> torch.Tensor:
    """Rotate the two HALVES of the trailing dim (not even/odd pairs — the
    reference's code, ``layers.py:58-70``, whatever its docstring says).

    ``x``: [..., S, H, D]; ``sin``/``cos``: [..., S, D//2].
    """
    dtype = x.dtype
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    s = sin[..., None, :]
    c = cos[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(dtype)


def sinusoidal_positions(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """Whisper-style absolute sinusoidal position embeddings [..., dim]
    in f32 (``layers.py:73``): sines of the first half, cosines of the
    second."""
    half = dim // 2
    log_timescale = math.log(10_000.0) / max(half - 1, 1)
    inv = torch.exp(-log_timescale * torch.arange(
        half, dtype=torch.float32, device=positions.device))
    scaled = positions.float()[..., None] * inv
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=-1)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, kind: str,
             dtype) -> dict:
    if kind == "swiglu":
        return {
            "wg": dense_init(gen, (d_model, d_ff), dtype),
            "wu": dense_init(gen, (d_model, d_ff), dtype),
            "wd": dense_init(gen, (d_ff, d_model), dtype),
        }
    if kind == "gelu":
        return {
            "wi": dense_init(gen, (d_model, d_ff), dtype),
            "wo": dense_init(gen, (d_ff, d_model), dtype),
        }
    raise ValueError(f"unknown mlp kind {kind}")


def apply_mlp(params: dict, x: torch.Tensor, kind: str, hook=None,
              down=None) -> torch.Tensor:
    """Position-wise MLP (SwiGLU, or GELU with the tanh approximation as
    ``jax.nn.gelu(approximate=True)``, ``layers.py:111``).  ``hook`` sees
    the hidden (the reference's ``ffn_hidden`` site); ``down(h, w)``
    (``Hooks.ffn_down``), when given, is the down projection."""
    if kind == "swiglu":
        h = F.silu(x @ params["wg"]) * (x @ params["wu"])
        w = params["wd"]
    elif kind == "gelu":
        h = F.gelu(x @ params["wi"], approximate="tanh")
        w = params["wo"]
    else:
        raise ValueError(f"unknown mlp kind {kind}")
    if hook is not None:
        h = hook(h)
    return down(h, w) if down is not None else h @ w


def apply_mlp_split(params: dict, x: torch.Tensor, kind: str, hidden: int,
                    tp, hook=None, down=None) -> Tuple[torch.Tensor, bool]:
    """``apply_mlp`` over this rank's part of the hidden dimension (the
    rules' ``w[gui]`` columns and ``w[do]`` rows): (partial sums over
    ``tp``, True), or, when ``down`` (``Hooks.ffn_down``) completes the
    product over the axes the hidden splits on, (the output, False); a
    whole MLP (``hidden`` not split) gives (the output, False).  ``x``
    is replicated over the split."""
    w_in = params["wg"] if kind == "swiglu" else params["wi"]
    if w_in.shape[-1] == hidden:
        return apply_mlp(params, x, kind, hook=hook, down=down), False
    return (apply_mlp(params, tp.enter(x), kind, hook=hook, down=down),
            down is None)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def init_embed(gen: torch.Generator, vocab: int, d_model: int, dtype,
               tie: bool) -> dict:
    p = {"tok": embed_init(gen, (vocab, d_model), dtype)}
    if not tie:
        p["head"] = dense_init(gen, (d_model, vocab), dtype)
    return p


def embed_tokens(params: dict, tokens: torch.Tensor,
                 vocab: Optional[int] = None, tp=None) -> torch.Tensor:
    """The rows of ``tokens`` [B,S].  A table split over the vocabulary
    on ``tp`` (the train rules' ``embed/tok`` (TP, FSDP): this rank's
    [V/tp, D], ids ``[index * V/tp, (index + 1) * V/tp)``, below
    ``vocab`` rows) gives 0 for the ids it does not own, and the parts
    are summed over ``tp`` (``models/hooks.py``)."""
    tok = params["tok"]
    n = tok.shape[0]
    if vocab is None or n == vocab:
        return tok[tokens.long()]
    ids = tokens.long() - tp.index * n
    own = (ids >= 0) & (ids < n)
    rows = tok[ids.clamp(0, n - 1)]
    return tp.reduce(torch.where(own[..., None], rows,
                                 torch.zeros((), dtype=rows.dtype,
                                             device=rows.device)))


def unembed(params: dict, x: torch.Tensor, vocab: Optional[int] = None,
            tp=None) -> torch.Tensor:
    """Logits (the tied table read transposed); over this rank's part of
    the vocabulary [.., V/tp] when the head splits on ``tp`` (``embed/
    head`` (FSDP, TP)), ``x`` replicated over ``tp``."""
    w = params["head"] if "head" in params else params["tok"].T
    if vocab is None or w.shape[-1] == vocab:
        return x @ w
    return tp.enter(x) @ w
