"""Windowed per-model demand telemetry feeding the elastic rebalancer.

Port of ``src/repro/runtime/telemetry.py`` (DESIGN.md §8): the ONLINE
twin of the offline planner.  It watches the live session — page
occupancy, slab pressure, admission-queue depth, arrival and completion
streams — and rebuilds the planner's own input type
(:class:`~repro_torch.core.planner.WorkloadSpec`) from a sliding window,
so the step-boundary re-plan runs the same Eq. (1)-(2) machinery on what
the session observed.

  * observation is passive and host-only: one ``observe`` call per
    session step reads counters the pools already keep;
  * a completed request contributes its (prompt, output, service time)
    together, as the offline trace rows do;
  * everything is deterministic given the event stream (EWMAs and ring
    buffers, no clock of its own, no randomness), so the rebalancer's
    decisions replay identically on a recorded stream.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ElasticConfig, ModelConfig
from repro_torch.core.planner import WorkloadSpec


@dataclass
class CompletedRow:
    """One finished request's joint workload row (the Eq. 1 sample)."""

    model: str
    prompt_tokens: int
    output_tokens: int
    service_s: float               # admission -> finish residency in the pool
    finish_time: float


class DemandTelemetry:
    """Sliding-window observer of the session's per-model demand."""

    def __init__(self, models: Dict[str, ModelConfig],
                 cfg: Optional[ElasticConfig] = None):
        self.models = dict(models)
        self.cfg = cfg or ElasticConfig()
        a = self.cfg.ewma_alpha
        if not 0.0 < a <= 1.0:
            raise ValueError(f"ewma_alpha must be in (0, 1], got {a}")
        # event streams (pruned to the window on observe)
        self.arrivals: Dict[str, Deque[float]] = collections.defaultdict(
            collections.deque)
        self.completed: Deque[CompletedRow] = collections.deque()
        # step-sampled EWMAs (the smoothed pressure signals)
        self.kv_occupancy_ewma = 0.0
        self.slab_occupancy_ewma = 0.0
        self.queue_depth_ewma = 0.0
        # instantaneous snapshot of the last observe()
        self.last: Dict[str, float] = {}
        self.steps_observed = 0
        self._t0: Optional[float] = None

    # ------------------------------------------------------------------
    # event hooks (called by the engine)
    # ------------------------------------------------------------------
    def note_arrival(self, model: str, now: float) -> None:
        if self._t0 is None:
            self._t0 = now
        self.arrivals[model].append(now)

    def note_finish(self, model: str, prompt_tokens: int,
                    output_tokens: int, admit_time: float,
                    finish_time: float) -> None:
        self.completed.append(CompletedRow(
            model=model, prompt_tokens=max(int(prompt_tokens), 1),
            output_tokens=max(int(output_tokens), 1),
            service_s=max(finish_time - admit_time, 1e-3),
            finish_time=finish_time))

    # ------------------------------------------------------------------
    # per-step observation
    # ------------------------------------------------------------------
    def observe(self, now: float, virt, arena, admission) -> None:
        """Sample the pools once per session step and fold the EWMAs."""
        self.steps_observed += 1
        horizon = now - self.cfg.window_s
        for q in self.arrivals.values():
            while q and q[0] < horizon:
                q.popleft()
        while self.completed and self.completed[0].finish_time < horizon:
            self.completed.popleft()

        a = self.cfg.ewma_alpha
        kv_occ = virt.mapped_pages / max(virt.page_budget, 1)
        slab_occ = (arena.resident_slabs / max(arena.slot_budget, 1)
                    if arena is not None else 0.0)
        queued = admission.queued_count() if admission is not None else 0
        self.kv_occupancy_ewma += a * (kv_occ - self.kv_occupancy_ewma)
        self.slab_occupancy_ewma += a * (slab_occ - self.slab_occupancy_ewma)
        self.queue_depth_ewma += a * (queued - self.queue_depth_ewma)
        self.last = {
            "now": now,
            "kv_occupancy": kv_occ,
            "slab_occupancy": slab_occ,
            "queued": float(queued),
            "swapped_pages": float(virt.swapped_now),
        }

    # ------------------------------------------------------------------
    # the planner bridge
    # ------------------------------------------------------------------
    def window_elapsed(self, now: float) -> float:
        if self._t0 is None:
            return 0.0
        return min(max(now - self._t0, 0.0), self.cfg.window_s)

    def arrival_rate(self, model: str, now: float) -> float:
        n = len(self.arrivals.get(model, ()))
        if n == 0:
            return 0.0
        # floor the denominator at 1 s: at the head of a burst the window
        # has barely elapsed, and n / epsilon would be a meaningless rate
        return n / max(self.window_elapsed(now), 1.0)

    def _rows_for(self, model: str) -> List[CompletedRow]:
        return [r for r in self.completed if r.model == model]

    def window_specs(self, now: float, live_requests: Optional[Dict] = None
                     ) -> List[WorkloadSpec]:
        """Per-model :class:`WorkloadSpec`s from the window.

        A model's joint samples are its completed rows in the window PLUS
        its live (slotted / waiting / queued) requests: the prompt is
        known, the output is the declared ``max_new_tokens`` and the
        service time is the window so far.  Live demand also floors the
        arrival rate, so a starved queue whose arrivals aged out of the
        window still reads as demand.  ``live_requests`` maps model ->
        [(prompt_tokens, max_new_tokens)].  Models with no signal are
        omitted."""
        specs: List[WorkloadSpec] = []
        for name, cfg in self.models.items():
            rows = self._rows_for(name)
            live = (live_requests or {}).get(name) or []
            if not rows and not live:
                continue
            horizon = max(self.window_elapsed(now), 1.0)
            prompt = np.asarray([r.prompt_tokens for r in rows]
                                + [max(p, 1) for p, _ in live], float)
            output = np.asarray([r.output_tokens for r in rows]
                                + [max(o, 1) for _, o in live], float)
            service = np.asarray([r.service_s for r in rows]
                                 + [horizon] * len(live), float)
            rate = max(self.arrival_rate(name, now), len(live) / horizon)
            if rate <= 0.0:
                continue
            specs.append(WorkloadSpec(
                model=cfg, arrival_rate=rate, prompt_tokens=prompt,
                output_tokens=output, decode_time=service))
        return specs

    # ------------------------------------------------------------------
    def snapshot(self) -> Dict[str, float]:
        """The pressure signals, for the engine's stats."""
        out = {
            "kv_occupancy_ewma": self.kv_occupancy_ewma,
            "slab_occupancy_ewma": self.slab_occupancy_ewma,
            "queue_depth_ewma": self.queue_depth_ewma,
            "window_completions": float(len(self.completed)),
            "window_arrivals": float(
                sum(len(q) for q in self.arrivals.values())),
            "steps_observed": float(self.steps_observed),
        }
        out.update({f"last_{k}": v for k, v in self.last.items()})
        return out


def arrival_rates(telemetry: DemandTelemetry, now: float
                  ) -> Dict[str, Tuple[float, int]]:
    """(rate, windowed-arrival count) per model — report helper."""
    return {m: (telemetry.arrival_rate(m, now),
                len(telemetry.arrivals.get(m, ())))
            for m in telemetry.models}
