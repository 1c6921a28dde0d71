"""Shared primitive layers: norms, RoPE, MLPs, embeddings, initializers.

Port of ``src/repro/models/layers.py``.  Weights keep the reference's
``[in, out]`` layout (``x @ w``), so a bridged JAX tree computes the same
function here.  Randomness comes from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import math
from typing import Tuple

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
    inv_freq = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                            device=positions.device),
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


def apply_mlp(params: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    """Position-wise MLP (SwiGLU, or GELU with the tanh approximation as
    ``jax.nn.gelu(approximate=True)``, ``layers.py:111``)."""
    if kind == "swiglu":
        h = F.silu(x @ params["wg"]) * (x @ params["wu"])
        return h @ params["wd"]
    if kind == "gelu":
        h = F.gelu(x @ params["wi"], approximate="tanh")
        return h @ params["wo"]
    raise ValueError(f"unknown mlp kind {kind}")


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def init_embed(gen: torch.Generator, vocab: int, d_model: int, dtype,
               tie: bool) -> dict:
    p = {"tok": embed_init(gen, (vocab, d_model), dtype)}
    if not tie:
        p["head"] = dense_init(gen, (d_model, vocab), dtype)
    return p


def embed_tokens(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["tok"][tokens.long()]


def unembed(params: dict, x: torch.Tensor) -> torch.Tensor:
    if "head" in params:
        return x @ params["head"]
    return x @ params["tok"].T
