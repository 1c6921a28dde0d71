"""Mixture-of-Experts FFN: top-k router + expert dispatch.

Port of the capacity path of ``src/repro/models/moe.py`` (the path the
serving engine runs) and of its grouped-GEMM path (``apply_moe_grouped``,
which training reaches through ``forward(moe_path="grouped")``).  Expert
weights are stacked ``[E, ...]`` — the layout the weights arena slices
into per-expert slab units.  On the capacity path each expert processes
at most ``C`` tokens (``expert_capacity``); pairs past an expert's
capacity fall back to the residual path (dropped from the FFN).  The
grouped path drops nothing.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import layers

#: Leaves of ``init_moe`` stacked over the leading expert axis ``[E, ...]``.
#: The weights arena slices these per expert into slab units
#: (``repro_torch.core.weight_pool``); everything else in the tree (router,
#: shared experts) is per-layer.  Keep in sync with :func:`init_moe`.
EXPERT_STACKED_LEAVES = ("wg", "wu", "wd")


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype) -> Dict:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {
        "router": layers.dense_init(gen, (d, E), torch.float32),
        "wg": layers.dense_init(gen, (E, d, f), dtype, in_axis=1),
        "wu": layers.dense_init(gen, (E, d, f), dtype, in_axis=1),
        "wd": layers.dense_init(gen, (E, f, d), dtype, in_axis=1),
    }
    if cfg.n_shared_experts:
        p["shared"] = layers.init_mlp(gen, d, cfg.n_shared_experts * f,
                                      "swiglu", dtype)
    return p


def expert_capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Per-expert token capacity C, rounded up to a multiple of 8 once it
    exceeds 8 (``moe.py:51-56``)."""
    c = math.ceil(n_tokens * cfg.experts_per_token * cfg.capacity_factor
                  / cfg.n_experts)
    return max(8, ((c + 7) // 8) * 8) if c > 8 else max(c, 1)


def route(p: Dict, x: torch.Tensor, cfg: ModelConfig
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing. x: [N,D] -> (gates [N,k], experts [N,k] int32,
    router_probs [N,E]).

    Ties: ``jax.lax.top_k`` returns equal values lowest index first, while
    ``torch.topk`` leaves their order unspecified.  A STABLE descending
    sort keeps equal probabilities in index order, so the first k columns
    are exactly the reference's choice, ties included.
    """
    logits = x.float() @ p["router"]                         # [N,E]
    probs = torch.softmax(logits, dim=-1)
    gates, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    gates, experts = gates[:, :k], experts[:, :k]
    gates = gates / gates.sum(dim=-1, keepdim=True)          # renormalize
    return gates, experts.to(torch.int32), probs


def dispatch_indices(experts: torch.Tensor, n_experts: int, capacity: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each (token, k) pair's slot within its expert.

    experts: [N,k].  Returns (slot [N,k] int32, keep [N,k] bool — False
    past capacity).  The slot of pair (n,j) is the number of EARLIER
    pairs routed to the same expert, counted in row-major (n, j) order —
    an exclusive cumsum, which decides which pairs are dropped.
    """
    N, k = experts.shape
    flat = experts.reshape(-1).long()                        # [N*k]
    onehot = F.one_hot(flat, n_experts).to(torch.int32)      # [N*k, E]
    pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    slot = pos.gather(1, flat[:, None])[:, 0]
    keep = slot < capacity
    return slot.reshape(N, k), keep.reshape(N, k)


def apply_moe(p: Dict, x: torch.Tensor, cfg: ModelConfig, *,
              capacity: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routed expert FFN.  x: [B,S,D] (or [N,D]).  Returns (out same
    shape, aux — the Switch load-balance loss)."""
    orig_shape = x.shape
    d = cfg.d_model
    xf = x.reshape(-1, d)                                    # [N,D]
    N = xf.shape[0]
    E, k = cfg.n_experts, cfg.experts_per_token
    C = capacity or expert_capacity(N, cfg)

    gates, experts, probs = route(p, xf, cfg)                # [N,k]x2, [N,E]
    slot, keep = dispatch_indices(experts, E, C)

    # ---- dispatch: scatter tokens into [E, C, D] ---------------------------
    flat_expert = experts.reshape(-1).long()                 # [N*k]
    flat_keep = keep.reshape(-1)
    flat_dst = torch.where(flat_keep, flat_expert * C + slot.reshape(-1),
                           torch.full_like(flat_expert, E * C))
    token_ids = torch.arange(N, device=x.device).repeat_interleave(k)
    buf = torch.zeros((E * C + 1, d), dtype=xf.dtype, device=x.device)
    buf[flat_dst] = xf[token_ids]                            # row E*C: dropped
    expert_in = buf[: E * C].reshape(E, C, d)

    # ---- expert computation (stacked SwiGLU over the E axis) ---------------
    h = F.silu(torch.bmm(expert_in, p["wg"])) * torch.bmm(expert_in, p["wu"])
    expert_out = torch.bmm(h, p["wd"])                       # [E,C,D]

    # ---- combine: gather back, weight by gates, f32 segment sum ------------
    flat_out = expert_out.reshape(E * C, d)
    safe_dst = flat_dst.clamp(max=E * C - 1)
    y_pairs = flat_out[safe_dst] * (gates.reshape(-1) * flat_keep)[:, None]
    # pairs are token-major (``token_ids`` repeats each token k times in
    # order), so the reference's segment sum over token ids is a sum over
    # the k axis: same terms, no atomics, deterministic on the card
    y = y_pairs.float().reshape(N, k, d).sum(dim=1).to(x.dtype)

    if cfg.n_shared_experts:
        y = y + layers.apply_mlp(p["shared"], xf, "swiglu")
    return y.reshape(orig_shape), _aux_loss(experts, probs, cfg)


def _aux_loss(experts: torch.Tensor, probs: torch.Tensor, cfg: ModelConfig
              ) -> torch.Tensor:
    """The Switch load-balance loss ``E * sum_e f_e * P_e / k``."""
    E, k = cfg.n_experts, cfg.experts_per_token
    pair_onehot = F.one_hot(experts.long(), E).float()       # [N,k,E]
    frac_tokens = pair_onehot.sum(dim=1).mean(dim=0)
    return E * torch.sum(frac_tokens * probs.mean(dim=0)) / k


def apply_moe_grouped(p: Dict, x: torch.Tensor, cfg: ModelConfig
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-sorted grouped-GEMM MoE (``moe.py:309-344``): no capacity,
    no drop.  x: [B,S,D] (or [N,D]).  Returns (out same shape, aux).

    The (token, k) pairs are sorted by expert with a STABLE argsort (as
    ``jnp.argsort``), so rows within an expert keep the reference's order;
    the group sizes are counted on the device (``torch.bincount`` would
    read a max back to the host) and the three expert products run through
    ``ops.moe_gemm``.  The combine unsorts the gated rows with the inverse
    permutation and sums each token's k rows in f32: the reference's
    segment sum, with no atomics.
    """
    orig_shape = x.shape
    d = cfg.d_model
    xf = x.reshape(-1, d)
    N = xf.shape[0]
    E, k = cfg.n_experts, cfg.experts_per_token

    gates, experts, probs = route(p, xf, cfg)
    flat_expert = experts.reshape(-1).long()                 # [N*k]
    order = torch.argsort(flat_expert, stable=True)
    token_ids = torch.arange(N, device=x.device).repeat_interleave(k)[order]
    x_sorted = xf[token_ids]                                 # [N*k, D]
    group_sizes = F.one_hot(flat_expert, E).sum(0).to(torch.int32)

    h = F.silu(kops.moe_gemm(x_sorted, p["wg"], group_sizes)) \
        * kops.moe_gemm(x_sorted, p["wu"], group_sizes)
    out_sorted = kops.moe_gemm(h, p["wd"], group_sizes)      # [N*k, D]

    w_sorted = gates.reshape(-1)[order]
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(N * k, device=x.device)
    y_pairs = (out_sorted * w_sorted[:, None]).float()[inverse]
    y = y_pairs.reshape(N, k, d).sum(dim=1).to(x.dtype)
    if cfg.n_shared_experts:
        y = y + layers.apply_mlp(p["shared"], xf, "swiglu")
    return y.reshape(orig_shape), _aux_loss(experts, probs, cfg)
