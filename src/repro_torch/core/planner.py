"""KV-cache planner: Eq. (1)-(2) trace-driven Monte Carlo pool sizing.

Port of ``src/repro/core/planner.py`` (paper §3.1, C1): given per-model
workload samples and arrival rates, size ONE shared KV-cache pool for the
P95/P99 of *aggregate active* KV demand at a random observation time, and
split one device-byte budget between the KV page pool and the weights
arena.  Host-only numpy, line for line the reference's: the Monte Carlo
draws from ``np.random.default_rng(seed)`` in the same order, so the same
specs and seed give the same plan in both packages — which is what makes
the elastic rebalancer's decisions equal the reference's.

Eq. (1): at request age u, active KV tokens grow linearly through decode:
    Q_i(u) = (O_p,i + O_d,i * u / T_i) * 1{0 <= u < T_i}
    K_M(t) = sum_i kappa(M) * Q_i(t - A_i)
Eq. (2): K_pool(t) = sum_M K_M(t).

Sampling draws whole trace ROWS (prompt, output, service-time) jointly, so
the empirical correlations between the three are preserved.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.virtualizer import DEFAULT_PAGE_BYTES
from repro_torch.core.weight_pool import (DEFAULT_SLAB_BYTES, slabs_for_config,
                                          static_ffn_bytes)


@dataclass(frozen=True)
class WorkloadSpec:
    """Per-model offered workload: joint samples + Poisson arrival rate."""

    model: ModelConfig
    arrival_rate: float                      # requests/s (lambda_M)
    prompt_tokens: np.ndarray                # [n] joint trace rows
    output_tokens: np.ndarray                # [n]
    decode_time: np.ndarray                  # [n] seconds resident in KV pool

    def sample_rows(self, rng: np.random.Generator, k: int) -> np.ndarray:
        idx = rng.integers(0, len(self.prompt_tokens), k)
        return idx


@dataclass(frozen=True)
class ModelPlan:
    """Parallelism + paging plan for one colocated model."""

    name: str
    kv_bytes_per_token: int                  # kappa(M), all layers
    tokens_per_page: int                     # per-layer page granularity
    pages_per_token: float                   # amortized, all layers
    attention_type: str                      # "type1" | "type2" | "attn_free"
    # "head_tp" | "seq_sharded" | "state"
    attention_strategy: str
    state_pages_per_request: int             # SSM constant-size state
    expected_active_kv_bytes: float          # mean aggregate for this model


@dataclass(frozen=True)
class PoolPlan:
    """Planner output: enforceable online budget + per-model plans."""

    page_bytes: int
    pool_page_budget: int
    pool_bytes: float
    quantile: float
    mean_active_bytes: float
    per_model: Dict[str, ModelPlan]
    horizon_s: float

    def summary(self) -> str:
        lines = [f"pool budget: {self.pool_page_budget} pages "
                 f"({self.pool_bytes / 2 ** 30:.2f} GiB) at "
                 f"P{self.quantile * 100:.0f} "
                 f"(mean {self.mean_active_bytes / 2 ** 30:.2f} GiB)"]
        for name, p in self.per_model.items():
            lines.append(
                f"  {name}: kappa={p.kv_bytes_per_token}B/token "
                f"{p.attention_type}/{p.attention_strategy} "
                f"tokens/page={p.tokens_per_page}")
        return "\n".join(lines)


def active_kv_timeline(spec: WorkloadSpec, rng: np.random.Generator,
                       horizon_s: float, dt: float = 1.0,
                       kappa: Optional[int] = None) -> np.ndarray:
    """Simulate K_M(t) over ``horizon_s`` seconds on a dt grid (Eq. 1)."""
    kappa = spec.model.kv_bytes_per_token() if kappa is None else kappa
    n_arrivals = rng.poisson(spec.arrival_rate * horizon_s)
    t_grid = np.arange(0.0, horizon_s, dt)
    usage = np.zeros_like(t_grid)
    if n_arrivals == 0:
        return usage
    arrivals = rng.uniform(0.0, horizon_s, n_arrivals)
    rows = spec.sample_rows(rng, n_arrivals)
    o_p = spec.prompt_tokens[rows].astype(np.float64)
    o_d = spec.output_tokens[rows].astype(np.float64)
    t_res = np.maximum(spec.decode_time[rows].astype(np.float64), dt)
    state_const = spec.model.state_bytes_per_request()
    for a, p, d, tr in zip(arrivals, o_p, o_d, t_res):
        u = t_grid - a
        live = (u >= 0) & (u < tr)
        q = (p + d * np.minimum(u / tr, 1.0)) * live            # Eq. (1)
        usage += kappa * q + state_const * live
    return usage


def plan_pool(specs: Sequence[WorkloadSpec], *,
              page_bytes: int = DEFAULT_PAGE_BYTES,
              quantile: float = 0.99, horizon_s: float = 3600.0,
              n_trials: int = 8, seed: int = 0, model_axis: int = 16,
              headroom: float = 1.05, dt: float = 2.0) -> PoolPlan:
    """Monte Carlo P-quantile sizing of the shared pool (Eq. 2).

    ``n_trials`` independent hour-long traces are simulated and the
    (quantile) of the pooled aggregate over all sampled observation times is
    the provisioning target, rounded up to pages with ``headroom``.
    """
    rng = np.random.default_rng(seed)
    samples: List[np.ndarray] = []
    for _ in range(n_trials):
        total = None
        for spec in specs:
            u = active_kv_timeline(spec, rng, horizon_s, dt=dt)
            total = u if total is None else total + u           # Eq. (2)
        samples.append(total)
    pooled = np.concatenate(samples)
    # cp: allow(CP005) the provisioning quantile of Eq. (2), a planner
    target = float(np.quantile(pooled, quantile)) * headroom  # input
    budget_pages = int(math.ceil(target / page_bytes)) or 1

    per_model: Dict[str, ModelPlan] = {}
    for spec in specs:
        cfg = spec.model
        kappa = cfg.kv_bytes_per_token()
        per_layer = (kappa // max(cfg.n_decoder_attn_layers, 1)
                     if kappa else 0)
        tpp = max(page_bytes // per_layer, 1) if per_layer else 0
        if cfg.attn_free:
            atype, astrat = "attn_free", "state"
        elif cfg.attention == "mla" or cfg.n_kv_heads < model_axis:
            atype, astrat = "type2", "seq_sharded"
        else:
            atype, astrat = "type1", "head_tp"
        mean_active = float(np.mean(
            active_kv_timeline(spec, np.random.default_rng(seed + 1),
                               min(horizon_s, 600.0), dt=dt)))
        per_model[cfg.name] = ModelPlan(
            name=cfg.name,
            kv_bytes_per_token=kappa,
            tokens_per_page=tpp,
            pages_per_token=(cfg.n_decoder_attn_layers / tpp) if tpp else 0.0,
            attention_type=atype,
            attention_strategy=astrat,
            state_pages_per_request=int(
                math.ceil(cfg.state_bytes_per_request() / page_bytes)),
            expected_active_kv_bytes=mean_active,
        )

    return PoolPlan(
        page_bytes=page_bytes,
        pool_page_budget=budget_pages,
        pool_bytes=budget_pages * page_bytes,
        quantile=quantile,
        mean_active_bytes=float(np.mean(pooled)),
        per_model=per_model,
        horizon_s=horizon_s,
    )


@dataclass(frozen=True)
class DeviceBytesPlan:
    """How one device-byte budget splits between the two pools.

    ``page_budget`` bounds the shared KV pool and ``slot_budget`` bounds
    the weights arena — together they are the ONLY knobs that set device
    bytes for the paged families, so this split IS the device memory plan.
    """

    total_bytes: int
    page_bytes: int
    slab_bytes: int
    page_budget: int                       # KV pool pages
    slot_budget: int                       # weights arena slabs
    kv_target_bytes: float                 # planner's P-quantile KV demand
    weight_target_bytes: float             # expected-resident arena demand
    resident_probability: Dict[str, float]  # P(model active at random t)

    def summary(self) -> str:
        kv_b = self.page_budget * self.page_bytes
        w_b = self.slot_budget * self.slab_bytes
        lines = [f"device split: {kv_b / 2 ** 30:.2f} GiB KV "
                 f"({self.page_budget} pages) + {w_b / 2 ** 30:.2f} GiB "
                 f"weights arena ({self.slot_budget} slabs) "
                 f"of {self.total_bytes / 2 ** 30:.2f} GiB"]
        for name, p in self.resident_probability.items():
            lines.append(f"  {name}: P(resident)={p:.3f}")
        return "\n".join(lines)


def split_device_budget(specs: Sequence[WorkloadSpec], total_bytes: int, *,
                        page_bytes: int = DEFAULT_PAGE_BYTES,
                        slab_bytes: int = DEFAULT_SLAB_BYTES,
                        quantile: float = 0.99, horizon_s: float = 3600.0,
                        residency_s: float = 300.0, n_trials: int = 4,
                        coresident: int = 1, seed: int = 0) -> DeviceBytesPlan:
    """Split one device-byte budget into ``page_budget`` vs ``slot_budget``.

    KV demand is the Eq. (2) Monte Carlo P-quantile (:func:`plan_pool`).
    Weights demand uses the arrival rates: a cold model is resident
    whenever it served a request within the last ``residency_s`` seconds
    (the engine keeps weights mapped while requests are in flight and
    evicts LRU), so under Poisson arrivals
    ``P(resident) = 1 - exp(-lambda_M * residency_s)`` and the expected
    arena working set is ``sum_M P(resident) * slabs(M)``.

    The weights floor is the ``coresident`` largest models together.  With
    prefill ALSO running through the arena, an activated model stays
    pinned from prompt phase to completion, so a deployment that should
    never queue a cold model's prefill behind a decoding one wants
    ``coresident=2`` (the arena-aware admission controller queues the
    burst at the front door when the floor is 1).  Both targets are scaled
    proportionally when they exceed ``total_bytes``; the floor never
    shrinks below the single largest model.
    """
    kv_plan = plan_pool(specs, page_bytes=page_bytes, quantile=quantile,
                        horizon_s=horizon_s, n_trials=n_trials, seed=seed)
    kv_target = float(kv_plan.pool_bytes)

    p_res: Dict[str, float] = {}
    w_target = 0.0
    sizes: List[int] = []
    for spec in specs:
        cfg = spec.model
        p = 1.0 - math.exp(-spec.arrival_rate * residency_s)
        p_res[cfg.name] = p
        slabs = slabs_for_config(cfg, slab_bytes)
        w_target += p * slabs * slab_bytes
        sizes.append(slabs * slab_bytes)
    sizes.sort(reverse=True)
    w_floor = sum(sizes[:max(coresident, 1)])
    w_target = max(w_target, float(w_floor))
    if total_bytes < w_floor + page_bytes:
        raise ValueError(
            f"total_bytes={total_bytes} cannot hold the largest model's "
            f"weights ({w_floor} B) plus one KV page — no plan from this "
            f"budget can serve; raise total_bytes or shrink the model set")

    want = kv_target + w_target
    if want > total_bytes:
        scale = total_bytes / want
        kv_target *= scale
        w_target = max(w_target * scale, float(w_floor))
        kv_target = min(kv_target, total_bytes - w_target)
    else:
        kv_target += total_bytes - want     # spare bytes buy KV headroom

    return DeviceBytesPlan(
        total_bytes=total_bytes,
        page_bytes=page_bytes,
        slab_bytes=slab_bytes,
        page_budget=max(int(kv_target // page_bytes), 1),
        slot_budget=max(int(math.ceil(w_target / slab_bytes)), 1),
        kv_target_bytes=kv_target,
        weight_target_bytes=w_target,
        resident_probability=p_res,
    )


def replan_split(specs: Sequence[WorkloadSpec], total_bytes: int, *,
                 page_bytes: int = DEFAULT_PAGE_BYTES,
                 slab_bytes: int = DEFAULT_SLAB_BYTES,
                 quantile: float = 0.95, window_s: float = 30.0,
                 residency_s: Optional[float] = None,
                 coresident: int = 1, seed: int = 0,
                 cached_token_fraction: float = 0.0) -> DeviceBytesPlan:
    """Windowed ONLINE re-run of the Eq. (1)-(2) split (DESIGN.md §8).

    Same machinery as :func:`split_device_budget`, parameterized for the
    elastic rebalancer's step-boundary cadence instead of offline
    provisioning: the ``specs`` come from the telemetry window (observed
    arrival rates + joint rows of recently completed requests), the
    Monte Carlo horizon is a few windows rather than an hour, and the
    trial count is small — the hysteresis/cooldown dampers absorb the
    extra estimator variance.  Deterministic for a fixed ``seed`` and
    fixed specs, which is what makes rebalance decisions replayable on a
    recorded trace.

    ``cached_token_fraction`` makes the re-plan prefix-cache aware
    (DESIGN.md §11): that fraction of observed prompt tokens was served
    from SHARED radix-tree pages at zero marginal page cost, so each
    spec's prompt demand is scaled down by it before the split — a
    cache-heavy window frees device bytes for the weights side instead
    of re-reserving KV the tree already holds once.
    """
    horizon = max(4.0 * window_s, 20.0)
    f = min(max(cached_token_fraction, 0.0), 0.95)
    if f > 0.0:
        specs = [dataclasses.replace(
            s, prompt_tokens=np.maximum(s.prompt_tokens * (1.0 - f), 1.0))
            for s in specs]
    return split_device_budget(
        specs, total_bytes, page_bytes=page_bytes, slab_bytes=slab_bytes,
        quantile=quantile, horizon_s=horizon,
        residency_s=residency_s if residency_s is not None
        else max(window_s, 1.0),
        n_trials=2, coresident=coresident, seed=seed)


def worst_case_weight_bytes(specs: Sequence[WorkloadSpec]) -> int:
    """Static baseline: every colocated model's FFN device-resident."""
    return sum(static_ffn_bytes(s.model) for s in specs)


def worst_case_pages(specs: Sequence[WorkloadSpec], page_bytes: int,
                     horizon_s: float = 3600.0) -> int:
    """Static-partition comparison point: per-model worst-case reservation.

    Each model reserves its own P100 concurrent demand — the 'reserve peak
    KV per model' baseline the paper argues wastes memory (§1).
    """
    total = 0
    for spec in specs:
        rng = np.random.default_rng(1234)
        u = active_kv_timeline(spec, rng, horizon_s)
        total += int(math.ceil(u.max() / page_bytes))
    return max(total, 1)
