"""Explicit all-to-all expert dispatch over ``torch.distributed``: the
expert-parallel MoE of the sharded steps (port of
``src/repro/models/moe.py:161-308``, which the reference runs under
``shard_map``).  The routing is ``models/moe.py``'s; the collectives
are ``sharding/collectives.py``'s.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers
from repro_torch.models.moe import route
from repro_torch.sharding.collectives import AxisGroup


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

    The collectives are autograd-aware (``sharding/collectives.py``): the
    all-to-alls' backward sends the gradients back the same way, the
    tokens and gates enter the tp region (``f`` split), the combine's tp
    sum is the reduction, and the load-balance factors are summed over
    the expert axis both ways, so the training step differentiates it.
    """
    ep, tp = AxisGroup(mesh, expert_axis), AxisGroup(mesh, tp_axis)
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
        x_in, gates_in = (tp.enter(xf), tp.enter(gates)) \
            if p["wg"].shape[-1] < cfg.d_ff else (xf, gates)
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
        send_x[dst] = x_in[tok_ids].to(xmit)                  # row n*C2: drop
        send_meta = torch.full((n_shards * C2 + 1,), -1, dtype=torch.int32,
                               device=x.device)
        send_meta[dst] = local_eid.to(torch.int32)
        send_x, send_meta = send_x[:-1], send_meta[:-1]
        if f8_dispatch:
            recv_x = mesh.all_to_all(send_x.view(torch.uint8), expert_axis
                                     ).view(xmit).to(x.dtype)
        else:
            recv_x = ep.all_to_all(send_x)
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
        ret = ep.all_to_all(back)
        y_pairs = torch.where(keep[:, None], ret[dst.clamp(max=R - 1)],
                              torch.zeros((), dtype=x.dtype,
                                          device=x.device))
        w_pairs = gates_in.reshape(-1) * keep
        # pairs are token-major: the segment sum is a sum over k, in f32
        y = (y_pairs * w_pairs[:, None]).float().reshape(Nl, k, d).sum(1)
        # summed over tp in the model dtype: half the payload; the f32
        # accumulation above already took the gate-weighted k-sum
        y = tp.reduce(y.to(x.dtype))

        # the load-balance loss takes GLOBAL token fractions x GLOBAL
        # router probabilities: average the factors over the expert axis
        pair_onehot = F.one_hot(experts.long(), E).float()
        factors = torch.stack([pair_onehot.sum(dim=1).mean(dim=0),
                               probs.mean(dim=0)])
        factors = ep.sum(factors) / n_shards
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
