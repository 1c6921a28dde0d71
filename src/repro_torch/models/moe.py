"""Mixture-of-Experts FFN: top-k router + expert dispatch.

Port of the capacity path of ``src/repro/models/moe.py`` (the path the
serving engine runs) and of its grouped-GEMM path (``apply_moe_grouped``,
which training reaches through ``forward(moe_path="grouped")``).  Expert
weights are stacked ``[E, ...]`` — the layout the weights arena slices
into per-expert slab units.  On the capacity path each expert processes
at most ``C`` tokens (``expert_capacity``); pairs past an expert's
capacity fall back to the residual path (dropped from the FFN).  The
grouped path drops nothing.  ``make_moe_a2a`` is the expert-parallel
dispatch of the sharded step (experts split over ranks, one all-to-all
each way); ``hooks`` (``models/hooks.py``) reach the reference's sites.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import layers
from repro_torch.models.hooks import IDENTITY_HOOKS, Hooks

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


def dispatch_indices(experts: torch.Tensor, n_experts: int, capacity: int,
                     offset: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each (token, k) pair's slot within its expert.

    experts: [N,k].  Returns (slot [N,k] int32, keep [N,k] bool — False
    past capacity).  The slot of pair (n,j) is the number of EARLIER
    pairs routed to the same expert, counted in row-major (n, j) order —
    an exclusive cumsum, which decides which pairs are dropped.

    ``offset`` ([E] int) pre-counts pairs routed to each expert by tokens
    that come BEFORE this call's tokens in the same sequence: the suffix
    prefill passes the cached prefix's routed-pair counts, so the
    suffix's slots (and so its drops) land where a full-prompt pass puts
    them (``moe.py:69-94``).
    """
    N, k = experts.shape
    flat = experts.reshape(-1).long()                        # [N*k]
    onehot = F.one_hot(flat, n_experts).to(torch.int32)      # [N*k, E]
    pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    slot = pos.gather(1, flat[:, None])[:, 0]
    if offset is not None:
        slot = slot + offset.to(device=slot.device, dtype=slot.dtype)[flat]
    keep = slot < capacity
    return slot.reshape(N, k), keep.reshape(N, k)


def apply_moe(p: Dict, x: torch.Tensor, cfg: ModelConfig, *,
              capacity: Optional[int] = None,
              slot_offset: Optional[torch.Tensor] = None,
              hooks: Hooks = IDENTITY_HOOKS
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routed expert FFN.  x: [B,S,D] (or [N,D]).  Returns (out same
    shape, aux — the Switch load-balance loss).

    ``slot_offset`` ([E]) shifts each expert's dispatch slots as if that
    many pairs were routed there already (``dispatch_indices``); with the
    producing pass's ``capacity`` it is the prefix-cached suffix prefill.
    A pair pushed past capacity is dropped by the keep mask and adds 0."""
    orig_shape = x.shape
    d = cfg.d_model
    xf = x.reshape(-1, d)                                    # [N,D]
    N = xf.shape[0]
    E, k = cfg.n_experts, cfg.experts_per_token
    C = capacity or expert_capacity(N, cfg)

    gates, experts, probs = route(p, xf, cfg)                # [N,k]x2, [N,E]
    slot, keep = dispatch_indices(experts, E, C, offset=slot_offset)

    # ---- dispatch: scatter tokens into [E, C, D] ---------------------------
    flat_expert = experts.reshape(-1).long()                 # [N*k]
    flat_keep = keep.reshape(-1)
    flat_dst = torch.where(flat_keep, flat_expert * C + slot.reshape(-1),
                           torch.full_like(flat_expert, E * C))
    token_ids = torch.arange(N, device=x.device).repeat_interleave(k)
    buf = torch.zeros((E * C + 1, d), dtype=xf.dtype, device=x.device)
    buf[flat_dst] = xf[token_ids]                            # row E*C: dropped
    expert_in = hooks.moe_inputs(buf[: E * C].reshape(E, C, d))

    # ---- expert computation (stacked SwiGLU over the E axis) ---------------
    h = F.silu(torch.bmm(expert_in, p["wg"])) * torch.bmm(expert_in, p["wu"])
    h = hooks.moe_hidden(h)
    expert_out = hooks.moe_inputs(torch.bmm(h, p["wd"]))     # [E,C,D]

    # ---- combine: gather back, weight by gates, f32 segment sum ------------
    flat_out = expert_out.reshape(E * C, d)
    safe_dst = flat_dst.clamp(max=E * C - 1)
    y_pairs = flat_out[safe_dst] * (gates.reshape(-1) * flat_keep)[:, None]
    # pairs are token-major (``token_ids`` repeats each token k times in
    # order), so the reference's segment sum over token ids is a sum over
    # the k axis: same terms, no atomics, deterministic on the card
    y = y_pairs.float().reshape(N, k, d).sum(dim=1).to(x.dtype)

    if cfg.n_shared_experts:
        y = y + _shared(p, xf, hooks)
    return y.reshape(orig_shape), _aux_loss(experts, probs, cfg)


def _shared(p: Dict, xf: torch.Tensor, hooks: Hooks) -> torch.Tensor:
    """The always-on shared experts (DeepSeek-style), one SwiGLU MLP."""
    return layers.apply_mlp(p["shared"], xf, "swiglu", hook=hooks.ffn_hidden,
                            down=hooks.ffn_down)


def _aux_loss(experts: torch.Tensor, probs: torch.Tensor, cfg: ModelConfig
              ) -> torch.Tensor:
    """The Switch load-balance loss ``E * sum_e f_e * P_e / k``."""
    E, k = cfg.n_experts, cfg.experts_per_token
    pair_onehot = F.one_hot(experts.long(), E).float()       # [N,k,E]
    frac_tokens = pair_onehot.sum(dim=1).mean(dim=0)
    return E * torch.sum(frac_tokens * probs.mean(dim=0)) / k


def make_moe_a2a(mesh, cfg: ModelConfig, *, expert_axis: str = "data",
                 tp_axis: str = "model", batch_axes=None,
                 capacity_mult: float = 1.25, f8_dispatch: bool = False,
                 shared=None):
    """Explicit all-to-all expert dispatch over ``torch.distributed``
    (``moe.py:161-308``; the reference runs it under ``shard_map``).

    The MegaScale-Infer-style schedule, written out: tokens sharded over
    ``expert_axis`` | experts sharded over the same axis | per-(src,dst)
    send slots under ``C2`` | ONE ``all_to_all`` out for the tokens and
    one for their expert ids (each (token, k) pair travels once) | local
    capacity dispatch to this rank's experts under ``C3`` (``f`` split
    over ``tp_axis``) | ``all_reduce`` over tp of the token-space partial
    sums | ONE ``all_to_all`` back | the weighted combine.  A pair
    dropped at either capacity adds 0.

    Returns fn(params_moe, x [B_loc,S,d]) -> (out, aux) on this rank's
    local shards: x its batch rows (split over ``batch_axes``, by default
    ``expert_axis``), ``wg`` / ``wu`` [E_loc, d, f_loc] and ``wd``
    [E_loc, f_loc, d].  ``f8_dispatch`` sends the tokens as fp8-e4m3
    (their bytes, viewed as uint8: the collective moves bytes) and
    dequantizes before the GEMMs.  ``shared`` (fn(params_shared, x2d) ->
    y2d) applies the shared experts in the caller's layout; by default
    they run here, on this rank's rows, with whole weights.
    """
    n_shards = mesh.shape[expert_axis]
    E, k, d = cfg.n_experts, cfg.experts_per_token, cfg.d_model
    if E % n_shards:
        raise ValueError(f"{E} experts do not split over {n_shards} shards")
    E_loc = E // n_shards
    del batch_axes                   # the caller passes local rows

    def local(p: Dict, x: torch.Tensor):
        Bl, S, _ = x.shape
        xf = x.reshape(-1, d)
        Nl = xf.shape[0]
        gates, experts, probs = route(p, xf, cfg)             # [Nl,k]
        owner = (experts // E_loc).reshape(-1).long()         # dst shard
        local_eid = (experts % E_loc).reshape(-1)
        # send slot within the (this shard -> dst) buffer
        C2 = max(8, int(math.ceil(Nl * k / n_shards * capacity_mult)))
        onehot = F.one_hot(owner, n_shards).to(torch.int32)
        slot = (torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
                ).gather(1, owner[:, None])[:, 0]
        keep = slot < C2
        dst = torch.where(keep, owner * C2 + slot,
                          torch.full_like(owner, n_shards * C2))
        tok_ids = torch.arange(Nl, device=x.device).repeat_interleave(k)

        xmit = torch.float8_e4m3fn if f8_dispatch else x.dtype
        send_x = torch.zeros((n_shards * C2 + 1, d), dtype=xmit,
                             device=x.device)
        send_x[dst] = xf[tok_ids].to(xmit)                    # row n*C2: drop
        send_meta = torch.full((n_shards * C2 + 1,), -1, dtype=torch.int32,
                               device=x.device)
        send_meta[dst] = local_eid.to(torch.int32)
        send_x, send_meta = send_x[:-1], send_meta[:-1]
        if f8_dispatch:
            recv_x = mesh.all_to_all(send_x.view(torch.uint8), expert_axis
                                     ).view(xmit).to(x.dtype)
        else:
            recv_x = mesh.all_to_all(send_x, expert_axis)
        recv_meta = mesh.all_to_all(send_meta, expert_axis)

        # local capacity dispatch to this shard's E_loc experts
        R = n_shards * C2
        valid = recv_meta >= 0
        eid = torch.where(valid, recv_meta, torch.zeros_like(recv_meta)
                          ).long()
        C3 = max(8, int(math.ceil(R / max(E_loc, 1) * capacity_mult)))
        oh = F.one_hot(eid, E_loc).to(torch.int32) \
            * valid[:, None].to(torch.int32)
        pos = (torch.cumsum(oh, dim=0, dtype=torch.int32) - oh
               ).gather(1, eid[:, None])[:, 0]
        keep3 = valid & (pos < C3)
        dst3 = torch.where(keep3, eid * C3 + pos,
                           torch.full_like(eid, E_loc * C3))
        buf = torch.zeros((E_loc * C3 + 1, d), dtype=x.dtype,
                          device=x.device)
        buf[dst3] = recv_x
        ein = buf[:-1].reshape(E_loc, C3, d)
        h = F.silu(torch.bmm(ein, p["wg"])) * torch.bmm(ein, p["wu"])
        out = torch.bmm(h, p["wd"])                           # partial (f/tp)

        # undo the local dispatch and send back PARTIAL sums: the tp sum
        # commutes with the linear combine, so it runs on the token-space
        # output below, not the padded expert space
        flat = out.to(x.dtype).reshape(E_loc * C3, d)
        back = torch.where(keep3[:, None],
                           flat[dst3.clamp(max=E_loc * C3 - 1)],
                           torch.zeros((), dtype=x.dtype, device=x.device))
        ret = mesh.all_to_all(back, expert_axis)
        y_pairs = torch.where(keep[:, None], ret[dst.clamp(max=R - 1)],
                              torch.zeros((), dtype=x.dtype,
                                          device=x.device))
        w_pairs = gates.reshape(-1) * keep
        # pairs are token-major: the segment sum is a sum over k, in f32
        y = (y_pairs * w_pairs[:, None]).float().reshape(Nl, k, d).sum(1)
        # summed over tp in the model dtype: half the payload; the f32
        # accumulation above already took the gate-weighted k-sum
        y = mesh.all_reduce(y.to(x.dtype), tp_axis)

        # the load-balance loss takes GLOBAL token fractions x GLOBAL
        # router probabilities: average the factors over the expert axis
        pair_onehot = F.one_hot(experts.long(), E).float()
        factors = torch.stack([pair_onehot.sum(dim=1).mean(dim=0),
                               probs.mean(dim=0)])
        factors = mesh.all_reduce(factors, expert_axis) / n_shards
        aux = E * torch.sum(factors[0] * factors[1]) / k
        return y.reshape(Bl, S, d), aux

    def apply(p: Dict, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        y, aux = local(p, x)
        if cfg.n_shared_experts:
            x2 = x.reshape(-1, d)
            y2 = (shared(p["shared"], x2) if shared is not None
                  else layers.apply_mlp(p["shared"], x2, "swiglu"))
            y = y + y2.reshape(x.shape)
        return y, aux

    return apply


def apply_moe_grouped(p: Dict, x: torch.Tensor, cfg: ModelConfig, *,
                      hooks: Hooks = IDENTITY_HOOKS
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
        y = y + _shared(p, xf, hooks)
    return y.reshape(orig_shape), _aux_loss(experts, probs, cfg)
