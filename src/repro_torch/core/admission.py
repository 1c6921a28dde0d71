"""Admission control: per-model queues enforcing the pools' budgets.

Port of ``src/repro/core/admission.py`` (paper §3.1): "if the pool page
budget is exhausted, admission control queues or rejects new requests
instead of interrupting active decode requests."  Admission is
ARENA-AWARE: a cold model's request also needs its slabs reachable
without revoking a model that is pinned or has requests in flight, so a
burst of cold-model arrivals queues at the front door instead of
thrashing the arena's LRU.  Admission takes the request's arena pin;
``finish`` drops it.

Every verdict reads the live page and slab budgets (the elastic
rebalancer resizes the pools in place) and holds ``reserve_pages`` free
pages back: the swap tier's fault-in headroom.  The reference's
prefix-cache discount is not ported yet.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

from repro_torch.core.virtualizer import KVVirtualizer
from repro_torch.core.weight_pool import OutOfSlabsError, WeightArena


@dataclass
class PendingRequest:
    request_id: int
    model: str
    prompt_tokens: int
    expected_output: int
    arrival_time: float
    enqueue_time: float = 0.0


@dataclass
class ModelAdmissionStats:
    """Per-model admitted/queued/rejected counters."""

    admitted: int = 0
    queued: int = 0
    rejected: int = 0


@dataclass
class AdmissionStats:
    admitted: int = 0
    queued: int = 0
    rejected: int = 0
    queue_wait_total: float = 0.0
    # admissions deferred purely by weights-arena pressure (cold-model burst)
    weight_pressure_queued: int = 0
    # admissions deferred by KV-page pressure
    page_pressure_queued: int = 0
    per_model: Dict[str, ModelAdmissionStats] = field(default_factory=dict)

    def bump(self, model: str, outcome: str) -> None:
        """Count one admission outcome globally AND for ``model``."""
        setattr(self, outcome, getattr(self, outcome) + 1)
        m = self.per_model.setdefault(model, ModelAdmissionStats())
        setattr(m, outcome, getattr(m, outcome) + 1)


class AdmissionController:
    """Queue-or-reject front door for the shared KV pool + weights arena."""

    def __init__(self, virtualizer: KVVirtualizer, *,
                 arena: Optional[WeightArena] = None,
                 max_queue_per_model: int = 64,
                 reserve_output_tokens: bool = True):
        self.virt = virtualizer
        self.arena = arena
        self.max_queue = max_queue_per_model
        self.reserve_output = reserve_output_tokens
        self.queues: Dict[str, Deque[PendingRequest]] = \
            collections.defaultdict(collections.deque)
        # admitted-but-unfinished request count per model
        self.inflight: Dict[str, int] = collections.defaultdict(int)
        self._last_block: str = ""      # "pages" | "weights" | "" (admitted)
        # the elastic rebalancer's pressure signal: free pages held back
        # from admission (fault-in headroom for pages in the swap tier)
        self.reserve_pages: int = 0
        self.stats = AdmissionStats()

    def offer(self, req: PendingRequest, now: float) -> str:
        """Returns 'admitted' | 'queued' | 'rejected'."""
        if self.try_admit(req):
            self.stats.bump(req.model, "admitted")
            return "admitted"
        if len(self.queues[req.model]) < self.max_queue:
            req.enqueue_time = now
            self.queues[req.model].append(req)
            self.stats.bump(req.model, "queued")
            if self._last_block == "weights":
                self.stats.weight_pressure_queued += 1
            elif self._last_block == "pages":
                self.stats.page_pressure_queued += 1
            return "queued"
        self.stats.bump(req.model, "rejected")
        return "rejected"

    # ------------------------------------------------------------------
    def _weights_pressure_ok(self, model: str) -> bool:
        """Whether admitting ``model`` fits the arena without revoking
        weights another admitted request still needs."""
        arena = self.arena
        if arena is None or model not in arena.views:
            return True
        if arena.is_resident(model):
            return True
        need = arena.views[model].total_slabs
        if need > arena.slot_budget:
            # a budget error, not pressure: fail loudly, never queue forever
            raise OutOfSlabsError(
                f"model {model!r} needs {need} slabs but the arena budget "
                f"is {arena.slot_budget}; raise slot_budget or drop the "
                f"model from the colocation set")
        reachable = arena.free_slabs + sum(
            arena.views[name].total_slabs
            for name in arena.residency
            if name not in arena.pins and not self.inflight.get(name))
        # slabs already promised to OTHER admitted cold models that have
        # not activated yet
        promised = sum(
            arena.views[name].total_slabs
            for name, count in self.inflight.items()
            if count and name != model and name in arena.views
            and not arena.is_resident(name))
        return need <= reachable - promised

    def try_admit(self, req: PendingRequest) -> bool:
        """Admit iff BOTH budgets hold: KV pages for the prompt (+ reserved
        output), ``reserve_pages`` held back, AND arena reachability for a
        cold model.  Takes the request's arena pin on success."""
        expect = req.expected_output if self.reserve_output else 0
        if self.virt.admission_deficit(req.model, req.prompt_tokens, expect,
                                       reserve=self.reserve_pages) > 0:
            self._last_block = "pages"
            return False
        if not self._weights_pressure_ok(req.model):
            self._last_block = "weights"
            return False
        self._last_block = ""
        self.virt.register_request(req.request_id, req.model,
                                   req.prompt_tokens)
        self.inflight[req.model] += 1
        if self.arena is not None and req.model in self.arena.views:
            self.arena.pin(req.model)
        return True

    def finish(self, model: str) -> None:
        """One of ``model``'s admitted requests completed or was aborted:
        its pin drops."""
        n = self.inflight.get(model, 0) - 1
        if n <= 0:
            self.inflight.pop(model, None)
        else:
            self.inflight[model] = n
        if self.arena is not None and model in self.arena.views:
            self.arena.unpin(model)

    def cancel_queued(self, request_id: int) -> bool:
        """Remove a still-queued request (it holds no resources)."""
        for q in self.queues.values():
            for pending in q:
                if pending.request_id == request_id:
                    q.remove(pending)
                    return True
        return False

    def drain(self, now: float) -> List[PendingRequest]:
        """Admit queued requests that now fit (FIFO per model, round-robin
        across models so one model cannot starve the others)."""
        admitted: List[PendingRequest] = []
        progress = True
        while progress:
            progress = False
            for model in list(self.queues):
                q = self.queues[model]
                if not q:
                    continue
                head = q[0]
                if self.try_admit(head):
                    q.popleft()
                    self.stats.queue_wait_total += now - head.enqueue_time
                    self.stats.bump(model, "admitted")
                    admitted.append(head)
                    progress = True
        return admitted

    def queued_count(self) -> int:
        return sum(len(q) for q in self.queues.values())
