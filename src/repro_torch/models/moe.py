"""Mixture-of-Experts FFN: top-k router + expert dispatch.

Port of the capacity path of ``src/repro/models/moe.py`` (the path the
serving engine runs) and of its grouped-GEMM path (``apply_moe_grouped``,
which training reaches through ``forward(moe_path="grouped")``).  Expert
weights are stacked ``[E, ...]`` — the layout the weights arena slices
into per-expert slab units.  On the capacity path each expert processes
at most ``C`` tokens (``expert_capacity``); pairs past an expert's
capacity fall back to the residual path (dropped from the FFN).  The
grouped path drops nothing.  ``hooks`` (``models/hooks.py``) reach the
reference's sites; the expert-parallel dispatch of the sharded step
(``moe.py:161-308``, experts split over ranks, one all-to-all each way)
is ``sharding/moe_a2a.py``.
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
              hooks: Hooks = IDENTITY_HOOKS,
              row_mask: Optional[torch.Tensor] = None,
              real_rows: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routed expert FFN.  x: [B,S,D] (or [N,D]).  Returns (out same
    shape, aux — the Switch load-balance loss).

    ``slot_offset`` ([E]) shifts each expert's dispatch slots as if that
    many pairs were routed there already (``dispatch_indices``); with the
    producing pass's ``capacity`` it is the prefix-cached suffix prefill.
    A pair pushed past capacity is dropped by the keep mask and adds 0.
    Under the sharded step's hooks (and ``row_mask``) see ``_routed``."""
    return _routed(p, x, cfg, "capacity", capacity, slot_offset, hooks,
                   row_mask, real_rows)


def apply_moe_grouped(p: Dict, x: torch.Tensor, cfg: ModelConfig, *,
                      hooks: Hooks = IDENTITY_HOOKS,
                      row_mask: Optional[torch.Tensor] = None,
                      real_rows: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-sorted grouped-GEMM MoE (``moe.py:309-344``): no capacity,
    no drop.  x: [B,S,D] (or [N,D]).  Returns (out same shape, aux).

    The (token, k) pairs are sorted by expert with a STABLE argsort (as
    ``jnp.argsort``), so rows within an expert keep the reference's order;
    the group sizes are counted on the device (``torch.bincount`` would
    read a max back to the host) and the three expert products run through
    ``ops.moe_gemm``.  The combine unsorts the gated rows with the inverse
    permutation and sums each token's k rows in f32: the reference's
    segment sum, with no atomics.  Under the sharded step's hooks (and
    ``row_mask``) see ``_routed``.
    """
    return _routed(p, x, cfg, "grouped", None, None, hooks, row_mask,
                   real_rows)


def _routed(p: Dict, x: torch.Tensor, cfg: ModelConfig, moe_path: str,
            capacity: Optional[int], slot_offset: Optional[torch.Tensor],
            hooks: Hooks, row_mask: Optional[torch.Tensor] = None,
            real_rows: Optional[int] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The body of ``apply_moe`` (``moe_path="capacity"``) and
    ``apply_moe_grouped`` (``"grouped"``).

    Under the sharded training step's hooks the experts split over
    ``hooks.tp`` (the train rules' ``*moe/w[gu]`` / ``wd`` on ``model``:
    this rank holds experts ``[e0, e0 + E_loc)``, ``E_loc =
    wg.shape[0]``) and the (micro)batch's rows over ``hooks.dp``; x is
    this rank's rows, replicated over tp.  Every rank routes all of its
    rows (the router is replicated) and runs its own experts' pairs: on
    the capacity path the slots of the whole batch's pairs (``C =
    expert_capacity(N_global)``, each expert's slots counted after the
    lower-indexed batch ranks' pairs), so the drops are the reference's;
    on the grouped path one ``moe_gemm`` per projection over the pairs
    sorted local experts first, the others' rows past the groups (the
    kernel leaves them 0).  The combine is summed over tp and the
    load-balance loss takes its means over the global batch.  At one
    rank every step is the unsharded one.

    ``row_mask`` ([B] bool; x [B,S,D]) marks the real rows of a batch the
    train cell padded to whole rows a rank (pad rows come after every
    real row in the global order), ``real_rows`` of them over every batch
    rank.  A pad row's pairs count in no expert's slots, take no slot
    (``keep`` false) and on the grouped path sort past the groups; the
    capacity is ``expert_capacity`` of the real tokens (the dispatch
    buffer keeps the padded batch's C, which is no smaller); the
    load-balance loss averages over the real tokens.

    Under the sharded serve step's hooks the experts split over
    ``hooks.experts`` (crosspool's ``data``; monolithic's ``model`` is
    ``tp``) and, on the capacity path, their ``f`` over ``tp``
    (crosspool): a down product over this rank's ``f`` is taken in
    float32, and ``hooks.moe_sum`` completes the routed and shared
    partial sums over the weights pool at once, rounded once."""
    tp, dp = hooks.tp, hooks.dp
    ep = tp if hooks.experts is None else hooks.experts
    orig_shape = x.shape
    d = cfg.d_model
    xf = x.reshape(-1, d)                                    # [N,D]
    N = xf.shape[0]
    E, k = cfg.n_experts, cfg.experts_per_token
    E_loc = p["wg"].shape[0]
    split = E_loc < E
    e0 = ep.index * E_loc if split else 0

    gates, experts, probs = route(p, xf, cfg)                # [N,k]x2, [N,E]
    x_in = ep.enter(xf) if split else xf
    gate = (ep.enter(gates) if split else gates).reshape(-1)  # [N*k]
    flat = experts.reshape(-1).long()                        # [N*k]
    local = flat - e0
    mine = (local >= 0) & (local < E_loc) if split else None
    token_ids = torch.arange(N, device=x.device).repeat_interleave(k)
    valid = real = n_real = None
    if row_mask is not None:
        valid = row_mask[:, None].expand(x.shape[:-1]).reshape(-1)  # [N]
        real = valid.repeat_interleave(k)                    # [N*k]
        n_real = real_rows * (N // row_mask.shape[0])        # global tokens

    if moe_path == "capacity":
        C = capacity or expert_capacity(N * dp.size, cfg)
        C_keep = (expert_capacity(n_real, cfg)
                  if real is not None and capacity is None else C)
        if dp.size > 1 or real is not None:
            onehot = F.one_hot(flat, E)
            if real is not None:
                onehot = onehot * real[:, None]
            lower = dp.gather(onehot.sum(0)[None], 0)[:dp.index].sum(0)
            slot_offset = lower if slot_offset is None \
                else slot_offset + lower
        slot, keep = dispatch_indices(experts, E, C_keep, offset=slot_offset)
        # ---- dispatch: scatter tokens into [E_loc, C, D] -------------------
        keep = keep.reshape(-1) if mine is None else keep.reshape(-1) & mine
        if real is not None:
            keep = keep & real
        dst = torch.where(keep, local * C + slot.reshape(-1),
                          torch.full_like(flat, E_loc * C))
        buf = torch.zeros((E_loc * C + 1, d), dtype=xf.dtype,
                          device=x.device)
        buf[dst] = x_in[token_ids]                           # last row: drop
        expert_in = hooks.moe_inputs(buf[: E_loc * C].reshape(E_loc, C, d))
        # ---- expert computation (stacked SwiGLU over the E axis) -----------
        h = F.silu(torch.bmm(expert_in, p["wg"])) \
            * torch.bmm(expert_in, p["wu"])
        h = hooks.moe_hidden(h)
        if p["wd"].shape[1] < cfg.d_ff:      # partial over this rank's f
            down = torch.bmm(h.float(), p["wd"].float())
        else:
            down = torch.bmm(h, p["wd"])
        expert_out = hooks.moe_inputs(down)                  # [E_loc,C,D]
        # ---- combine: gather back, weight by gates --------------------------
        y_pairs = expert_out.reshape(E_loc * C, d)[
            dst.clamp(max=E_loc * C - 1)] * (gate * keep)[:, None]
    elif moe_path == "grouped":
        key = local if mine is None else torch.where(
            mine, local, torch.full_like(local, E_loc))
        if real is not None:            # pad rows' pairs past the groups
            key = torch.where(real, key, torch.full_like(key, E_loc))
        order = torch.argsort(key, stable=True)
        x_sorted = x_in[token_ids[order]]                    # [N*k, D]
        group_sizes = F.one_hot(key, E_loc + 1)[:, :E_loc].sum(0).to(
            torch.int32)
        h = F.silu(kops.moe_gemm(x_sorted, p["wg"], group_sizes)) \
            * kops.moe_gemm(x_sorted, p["wu"], group_sizes)
        out_sorted = kops.moe_gemm(h, p["wd"], group_sizes)  # [N*k, D]
        inverse = torch.empty_like(order)
        inverse[order] = torch.arange(N * k, device=x.device)
        y_pairs = (out_sorted * gate[order][:, None])[inverse]
    else:
        raise ValueError(f"unknown moe_path {moe_path!r}")
    # pairs are token-major (``token_ids`` repeats each token k times in
    # order), so the reference's segment sum over token ids is a sum over
    # the k axis: same terms, no atomics, deterministic on the card
    y = y_pairs.float().reshape(N, k, d).sum(dim=1)
    aux = _aux_loss(experts, probs, cfg, dp, valid, n_real)
    if hooks.moe_sum is not None:
        ys = None
        if cfg.n_shared_experts:
            ys = layers.apply_mlp(p["shared"], xf, "swiglu",
                                  hook=hooks.ffn_hidden, down=_f32_down)
        return hooks.moe_sum(y, ys).to(x.dtype).reshape(orig_shape), aux
    y = y.to(x.dtype)

    partial = split
    if cfg.n_shared_experts:
        # the always-on shared experts (DeepSeek-style), one SwiGLU MLP
        ys, s_partial = layers.apply_mlp_split(
            p["shared"], xf, "swiglu", cfg.n_shared_experts * cfg.d_ff, tp,
            hook=hooks.ffn_hidden, down=hooks.ffn_down)
        if s_partial != partial:          # sum whole outputs only
            y, ys = (ep.reduce(y), ys) if partial else (y, tp.reduce(ys))
            partial = False
        y = y + ys
    if partial:
        y = ep.reduce(y)
    return y.reshape(orig_shape), aux


def _f32_down(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A down projection's (partial) product in float32."""
    return h.float() @ w.float()


def _aux_loss(experts: torch.Tensor, probs: torch.Tensor, cfg: ModelConfig,
              dp=None, valid: Optional[torch.Tensor] = None,
              n_real: Optional[int] = None) -> torch.Tensor:
    """The Switch load-balance loss ``E * sum_e f_e * P_e / k``.  With
    ``dp`` (rows split over the batch axes) both means are the global
    batch's: the sums are reduced over ``dp`` before the product.  With
    ``valid`` ([N] bool: a padded batch's real tokens, ``n_real`` of them
    over every batch rank) both means are over the real tokens alone."""
    E, k = cfg.n_experts, cfg.experts_per_token
    pair_onehot = F.one_hot(experts.long(), E).float()       # [N,k,E]
    one_rank = dp is None or dp.size == 1
    if valid is None and one_rank:
        frac_tokens = pair_onehot.sum(dim=1).mean(dim=0)
        return E * torch.sum(frac_tokens * probs.mean(dim=0)) / k
    total = (lambda t: t) if one_rank else dp.sum
    n = experts.shape[0] * dp.size if valid is None else n_real
    if valid is not None:
        pair_onehot = pair_onehot * valid[:, None, None]
        probs = probs * valid[:, None]
    frac_tokens = total(pair_onehot.sum(dim=(0, 1))) / n
    return E * torch.sum(frac_tokens * (total(probs.sum(dim=0)) / n)) / k
