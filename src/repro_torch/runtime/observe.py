"""Synthetic request traces and the repo's one quantile.

A copy of the trace generators and ``percentile`` of the reference's
``runtime/observe.py``: the same numpy draws in the same order, so a
seed gives the same requests in both packages.  The reference module's
metrics registry, tracer and SLO monitor are not part of the port yet.

Trace shapes (paper §5.1):

* ShareGPT: log-normal-ish with medians of a few hundred tokens and a
  heavy tail (median prompt ~220, median output ~180, p99 ~2k).
* LongAlign-10k: context lengths spread 1k..64k with substantial mass
  beyond 8k, outputs a few hundred tokens.

Arrivals are Poisson at a configurable per-model RPS (paper: 0.2-1.0).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.runtime.request import Request


def percentile(values: Sequence[float], q: float) -> float:
    """``np.percentile`` (linear interpolation), NaN on empty."""
    values = np.asarray(values, float).reshape(-1)
    if values.size == 0:
        return float("nan")
    return float(np.percentile(values, q))


@dataclass(frozen=True)
class TraceStats:
    prompt_tokens: np.ndarray
    output_tokens: np.ndarray


def sharegpt_like(n: int, rng: np.random.Generator,
                  clip: int = 4096) -> TraceStats:
    prompt = np.clip(rng.lognormal(mean=5.4, sigma=0.9, size=n), 8,
                     clip).astype(int)
    output = np.clip(rng.lognormal(mean=5.2, sigma=0.8, size=n), 8,
                     clip).astype(int)
    return TraceStats(prompt, output)


def longalign_like(n: int, rng: np.random.Generator,
                   max_ctx: int = 65536) -> TraceStats:
    """Context lengths across 1k..64k bins with heavy long-tail mass."""
    bins = np.array([1024, 2048, 4096, 8192, 16384, 32768, 65536])
    weights = np.array([0.18, 0.2, 0.2, 0.16, 0.12, 0.09, 0.05])
    hi = rng.choice(bins, size=n, p=weights / weights.sum())
    prompt = (hi * rng.uniform(0.55, 1.0, size=n)).astype(int)
    prompt = np.minimum(prompt, max_ctx - 512)
    output = np.clip(rng.lognormal(5.0, 0.7, size=n), 16, 512).astype(int)
    return TraceStats(prompt, output)


def poisson_arrivals(rate: float, horizon_s: float,
                     rng: np.random.Generator) -> np.ndarray:
    n = rng.poisson(rate * horizon_s)
    return np.sort(rng.uniform(0.0, horizon_s, n))


def make_requests(models: List[str], *, rps_per_model: float,
                  horizon_s: float, kind: str = "sharegpt",
                  seed: int = 0, scale_tokens: float = 1.0,
                  max_new_cap: Optional[int] = None) -> List[Request]:
    """Interleaved multi-model request stream sorted by arrival time.

    ``scale_tokens`` shrinks token counts for small engine runs while
    preserving the distribution shape.
    """
    rng = np.random.default_rng(seed)
    reqs: List[Request] = []
    rid = 0
    for model in models:
        arrivals = poisson_arrivals(rps_per_model, horizon_s, rng)
        stats = (sharegpt_like(len(arrivals), rng) if kind == "sharegpt"
                 else longalign_like(len(arrivals), rng))
        for t, p, o in zip(arrivals, stats.prompt_tokens,
                           stats.output_tokens):
            p = max(int(p * scale_tokens), 1)
            o = max(int(o * scale_tokens), 1)
            if max_new_cap:
                o = min(o, max_new_cap)
            reqs.append(Request(rid, model, p, o, float(t)))
            rid += 1
    reqs.sort(key=lambda r: r.arrival_time)
    return reqs
