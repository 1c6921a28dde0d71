"""Discrete-event decode simulator: Static Partition vs kvcached vs CrossPool.

Port of ``src/repro/runtime/simulator.py``.  The engine
(``runtime/engine.py``) runs the real CrossPool code on a card; this
simulator models the paper's five-GPU A100 testbed so the three *systems*
can be compared at the paper's scale (Fig. 6 capacity, Fig. 7 TBT).  It
is pure Python over the configs and ``runtime.request.Request``: no
tensor, no device.  Costs are napkin math over the testbed's hardware:

  decode step time = max(weight-read, kv-read, flops) + control overhead
    weight-read = active_param_bytes / (HBM_bw * gpus_in_group)
    kv-read     = sum_ctx * kappa / (HBM_bw * gpus_holding_kv)
    control     = per-layer host dispatch (baselines) vs persistent-kernel
                  dispatch (crosspool), + inter-pool hidden-state transfer

Contention is physical: a decode step exclusively occupies its
placement's GPUs; colocated models queue on shared GPUs (kvcached's
tail-latency mechanism per paper §5.3).  CrossPool splits each step into
an attention stage (KV-pool GPU) and an FFN stage (weights-pool GPUs)
which pipeline across models (§3.2), so the pools contend far less.

The constants below are the paper's A100 testbed (§5.1), kept as they
are so the port's numbers equal the reference's; none is a measured
figure of the card the port runs on.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.runtime.request import Request

# --- the paper's A100-40G testbed (§5.1), not a measured figure ------------
HBM_BW = 1.55e12                  # bytes/s
PEAK_FLOPS = 312e12               # bf16
NVLINK_BW = 300e9                 # bytes/s effective per direction
HBM_BYTES = 40e9
HOST_DISPATCH = 30e-6             # per CUDA-graph launch from host
PERSISTENT_DISPATCH = 60e-6       # once per token (control lowered)


@dataclass
class SystemPlacement:
    """One system's decode-side placement on the 5-GPU testbed."""

    system: str                                 # static | kvcached | crosspool
    gpu_sets: Dict[str, Tuple[int, ...]]        # model -> GPUs for its step
    kv_visible: Dict[str, float]                # bytes one request can reach
    kv_pool_bytes: Dict[str, float]             # per model budget (shared ok)
    shared_pool: bool                           # pool shared across models?
    kv_gpus: Dict[str, Tuple[int, ...]]         # GPUs holding a request's KV
    pipelined: bool = False                     # layer-wise pipeline
    lowered: bool = False                       # persistent-kernel control
    ffn_gpus: Dict[str, Tuple[int, ...]] = field(default_factory=dict)
    # K decode tokens per host dispatch (multi-step fused decode).  Only
    # meaningful with ``lowered`` — the host-driven path stays K=1, which
    # mirrors EngineMode.decode_steps_per_dispatch in the real engine.
    decode_steps: int = 1


def _ffn_read_bytes(cfg: ModelConfig, batch: int) -> float:
    """FFN weight bytes touched per decode step.

    MoE: ~min(E, batch*topk) DISTINCT experts activate per layer (cold-model
    batches are small, so most expert weights stay untouched — this is the
    memory-side reason cold MoE serving is weight-read-bound)."""
    if cfg.is_moe:
        expert_bytes = 3 * cfg.d_model * cfg.d_ff * 2
        distinct = min(cfg.n_experts,
                       batch * cfg.experts_per_token) + cfg.n_shared_experts
        return cfg.n_layers * distinct * expert_bytes
    return cfg.param_counts()["ffn"] * 2


def crosspool_stage_times(cfg: ModelConfig, batch: int, sum_ctx: int,
                          placement: SystemPlacement
                          ) -> Tuple[float, float, float, float]:
    """(attn_stage, transfer, ffn_stage, control) for one decode step."""
    name = cfg.name
    n_kv = len(placement.kv_gpus[name])
    n_ffn = len(placement.ffn_gpus[name])
    counts = cfg.param_counts()
    attn_bytes = (counts["total"] - counts["ffn"]) * 2       # non-FFN weights
    attn_read = attn_bytes / (HBM_BW * n_kv)
    kv_read = sum_ctx * cfg.kv_bytes_per_token() / (HBM_BW * n_kv)
    ffn_read = _ffn_read_bytes(cfg, batch) / (HBM_BW * n_ffn)
    xfer = 2 * cfg.n_layers * batch * cfg.d_model * 2 / NVLINK_BW
    if placement.lowered:
        # one persistent-kernel dispatch commits K tokens; its launch cost
        # amortizes to 1/K per token (the stage reads themselves don't)
        control = PERSISTENT_DISPATCH / max(placement.decode_steps, 1)
    else:
        control = HOST_DISPATCH * 2 * cfg.n_layers
    return attn_read + kv_read, xfer, ffn_read, control


def decode_step_time(cfg: ModelConfig, batch: int, sum_ctx: int,
                     placement: SystemPlacement) -> float:
    """One decode iteration for a model's running batch."""
    name = cfg.name
    kappa = cfg.kv_bytes_per_token()
    n_step = len(placement.gpu_sets[name])
    n_kv = len(placement.kv_gpus[name])

    if placement.system == "crosspool":
        attn_stage, xfer, ffn_stage, control = crosspool_stage_times(
            cfg, batch, sum_ctx, placement)
        if placement.pipelined:
            # steady-state: the longer stage hides the shorter one
            compute = max(attn_stage, ffn_stage) + xfer
        else:
            compute = attn_stage + ffn_stage + xfer
        return compute + control

    # monolithic systems: whole model on the step GPUs
    counts = cfg.param_counts()
    w_bytes = (counts["total"] - counts["ffn"]) * 2 + _ffn_read_bytes(cfg,
                                                                      batch)
    w_read = w_bytes / (HBM_BW * n_step)
    kv_read = sum_ctx * kappa / (HBM_BW * n_kv)
    flops = 2 * cfg.active_param_counts() * batch / (PEAK_FLOPS * n_step)
    control = HOST_DISPATCH * cfg.n_layers
    return max(w_read + kv_read, flops) + control


def prefill_time(cfg: ModelConfig, prompt: int,
                 placement: SystemPlacement) -> float:
    n = len(placement.gpu_sets[cfg.name])
    flops = 2 * cfg.active_param_counts() * prompt
    return flops / (PEAK_FLOPS * n) + 2e-3


# ---------------------------------------------------------------------------
# Placements for the paper's Table 2 testbed
# ---------------------------------------------------------------------------

def paper_placements(models: Dict[str, ModelConfig],
                     system: str, *, pipelined: bool = True,
                     lowered: bool = True, decode_steps: int = 1,
                     hbm_bytes: Optional[float] = None) -> SystemPlacement:
    """The paper's 5-GPU placements (Table 2), parameterized by system.

    models: ordered dict of the colocation trio {Q, G, D}-analogues.
    ``hbm_bytes`` defaults to auto-sizing the testbed to the paper's weight
    occupancy (~77% of total HBM holds weights, §5.1: 154 GB on 200 GB) —
    our stand-in trio is bigger than the paper's 30B models, so the same
    occupancy ratio, not the same absolute GB, is what transfers.
    """
    names = list(models)
    q, g, d = names[0], names[1], names[2]

    def wbytes(n):
        return models[n].param_counts()["total"] * 2

    def ffn_b(n):
        return models[n].param_counts()["ffn"] * 2

    hbm = hbm_bytes or sum(wbytes(n) for n in names) / 5 / 0.77

    if system == "static":
        gpu_sets = {q: (0, 1), g: (2, 3), d: (4,)}
        kv_pool = {n: max(len(gpu_sets[n]) * hbm - wbytes(n), 0.0)
                   for n in names}
        # a request sees its replica's slice (tp = min(kv_heads, gpus))
        kv_vis = {}
        for n in names:
            cfg = models[n]
            G = len(gpu_sets[n])
            kvh = 1 if cfg.attention == "mla" else max(cfg.n_kv_heads, 1)
            stripe = min(kvh, G)
            kv_vis[n] = kv_pool[n] / G * stripe
        return SystemPlacement("static", gpu_sets, kv_vis, kv_pool,
                               shared_pool=False, kv_gpus=gpu_sets)

    if system == "kvcached":
        gpu_sets = {q: (0, 1, 2, 3), g: (1, 2, 3, 4), d: (0, 4)}
        total = max(5 * hbm - sum(wbytes(n) for n in names), 0.0)
        free_per_gpu = total / 5
        kv_pool = {n: total for n in names}
        kv_vis = {}
        for n in names:
            cfg = models[n]
            G = len(gpu_sets[n])
            # DP attention for KV-head-limited models: one request's KV is
            # confined to its rank's stripe (paper §2.2 / Fig. 2a)
            kvh = 1 if cfg.attention == "mla" else max(cfg.n_kv_heads, 1)
            stripe = min(kvh, G)
            kv_vis[n] = free_per_gpu * stripe
        return SystemPlacement("kvcached", gpu_sets, kv_vis, kv_pool,
                               shared_pool=True, kv_gpus=gpu_sets)

    if system == "crosspool":
        kv_gpu = (0,)
        w_gpus = (1, 2, 3, 4)
        non_ffn = sum(wbytes(n) - ffn_b(n) for n in names)
        pool = max(hbm - non_ffn, 0.0)
        gpu_sets = {n: kv_gpu + w_gpus for n in names}
        return SystemPlacement(
            "crosspool", gpu_sets,
            kv_visible={n: pool for n in names},
            kv_pool_bytes={n: pool for n in names},
            shared_pool=True,
            kv_gpus={n: kv_gpu for n in names},
            ffn_gpus={n: w_gpus for n in names},
            pipelined=pipelined, lowered=lowered,
            decode_steps=decode_steps if lowered else 1)

    raise ValueError(system)


# ---------------------------------------------------------------------------
# Event-driven decode simulation (Fig. 7)
# ---------------------------------------------------------------------------

class DecodeSimulator:
    def __init__(self, models: Dict[str, ModelConfig],
                 placement: SystemPlacement, *, max_batch: int = 8):
        self.models = models
        self.pl = placement
        self.max_batch = max_batch

    def run(self, requests: List[Request]) -> Dict:
        pl = self.pl
        gpu_free = [0.0] * 5
        pool_used = {n: 0.0 for n in self.models}   # bytes (shared aliases)
        shared_used = 0.0
        running: Dict[str, List[Request]] = {n: [] for n in self.models}
        queued: Dict[str, List[Request]] = {n: [] for n in self.models}
        rejected: List[Request] = []

        events: List[Tuple[float, int, str, object]] = []
        for r in requests:
            heapq.heappush(events, (r.arrival_time, r.request_id, "arrive", r))
        step_busy = {n: False for n in self.models}
        eid = 10 ** 9

        def kv_need(r: Request) -> float:
            cfg = self.models[r.model]
            return (r.prompt_tokens + r.max_new_tokens) * \
                cfg.kv_bytes_per_token() + cfg.state_bytes_per_request()

        def try_admit(r: Request, now: float) -> bool:
            nonlocal shared_used
            need = kv_need(r)
            if need > pl.kv_visible[r.model]:
                return False                     # can never fit: reject
            used = shared_used if pl.shared_pool else pool_used[r.model]
            budget = pl.kv_pool_bytes[r.model]
            if used + need > budget:
                queued[r.model].append(r)
                return True
            if pl.shared_pool:
                shared_used += need
            else:
                pool_used[r.model] += need
            running[r.model].append(r)
            r.admit_time = now
            return True

        def release(r: Request) -> None:
            nonlocal shared_used
            need = kv_need(r)
            if pl.shared_pool:
                shared_used -= need
            else:
                pool_used[r.model] -= need

        def schedule_step(model: str, now: float) -> None:
            nonlocal eid
            if step_busy[model] or not running[model]:
                return
            batch = running[model][: self.max_batch]
            cfg = self.models[model]
            sum_ctx = sum(r.context_length for r in batch)
            prefill_extra = sum(
                prefill_time(cfg, r.prompt_tokens, pl) for r in batch
                if r.generated == 0 and r.first_token_time == 0.0)
            step_busy[model] = True
            eid += 1
            if pl.system == "crosspool" and pl.pipelined:
                # stage-level resource occupancy: attention holds only the
                # KV-pool GPU(s); FFN holds only the weights-pool GPUs — so
                # another model's attention overlaps this model's FFN
                # (paper Fig. 4).
                t_attn, xfer, t_ffn, ctrl = crosspool_stage_times(
                    cfg, len(batch), sum_ctx, pl)
                kv_g = pl.kv_gpus[model]
                start = max([now] + [gpu_free[g] for g in kv_g])
                a_end = start + t_attn + ctrl / 2 + prefill_extra
                for g in kv_g:
                    gpu_free[g] = a_end
                heapq.heappush(events, (a_end + xfer / 2, eid, "attn_done",
                                        (model, batch, t_ffn, xfer, ctrl)))
                return
            gpus = pl.gpu_sets[model]
            start = max([now] + [gpu_free[g] for g in gpus])
            dt = decode_step_time(cfg, len(batch), sum_ctx, pl) + prefill_extra
            end = start + dt
            for g in gpus:
                gpu_free[g] = end
            heapq.heappush(events, (end, eid, "step_done", (model, batch)))

        while events:
            now, _, kind, payload = heapq.heappop(events)
            if kind == "arrive":
                r: Request = payload
                if not try_admit(r, now):
                    rejected.append(r)
                    continue
                schedule_step(r.model, now)
            elif kind == "attn_done":
                model, batch, t_ffn, xfer, ctrl = payload
                w_g = pl.ffn_gpus[model]
                start = max([now] + [gpu_free[g] for g in w_g])
                end = start + t_ffn + ctrl / 2 + xfer / 2
                for g in w_g:
                    gpu_free[g] = end
                eid += 1
                heapq.heappush(events, (end, eid, "step_done", (model, batch)))
            elif kind == "step_done":
                model, batch = payload
                step_busy[model] = False
                done = []
                for r in batch:
                    if r.generated == 0:
                        r.first_token_time = now
                    r.generated += 1
                    r.token_times.append(now)
                    if r.done:
                        done.append(r)
                for r in done:
                    running[model].remove(r)
                    release(r)
                    r.finish_time = now
                    # admit queued
                    while queued[model]:
                        nxt = queued[model][0]
                        need = kv_need(nxt)
                        used = shared_used if pl.shared_pool else \
                            pool_used[model]
                        if used + need <= pl.kv_pool_bytes[model]:
                            queued[model].pop(0)
                            try_admit(nxt, now)
                        else:
                            break
                schedule_step(model, now)

        tbt = [g for r in requests for g in r.tbt_samples()]
        per_model_tbt = {
            n: [g for r in requests if r.model == n for g in r.tbt_samples()]
            for n in self.models}
        return {
            "tbt": tbt,
            "per_model_tbt": per_model_tbt,
            "rejected": len(rejected),
            "finished": sum(1 for r in requests if r.finish_time > 0),
            "tokens_out": sum(r.generated for r in requests),
        }


# ---------------------------------------------------------------------------
# Capacity scan (Fig. 6)
# ---------------------------------------------------------------------------

def max_rps_for_context(models: Dict[str, ModelConfig],
                        placement: SystemPlacement, ctx: int,
                        output_tokens: int = 256) -> float:
    """Little's-law estimate of the max aggregate RPS at context ``ctx``.

    N_fit concurrent requests of this context fit in the (visible) KV pool;
    each resides for ~output_tokens decode steps; max rate = N_fit / T_res.
    A vertical drop to 0 marks the capacity cliff (request can never fit).
    """
    total = 0.0
    for n, cfg in models.items():
        kappa = cfg.kv_bytes_per_token()
        need = ctx * kappa + cfg.state_bytes_per_request()
        if need == 0:
            continue
        if need > placement.kv_visible[n]:
            continue                                # cliff for this model
        n_fit = max(int(placement.kv_pool_bytes[n] // need), 0)
        if placement.shared_pool:
            n_fit = max(n_fit // len(models), 1) if n_fit else 0
        if n_fit == 0:
            continue
        step = decode_step_time(cfg, min(n_fit, 8), ctx * min(n_fit, 8),
                                placement)
        t_res = output_tokens * step
        total += n_fit / t_res
    return total
