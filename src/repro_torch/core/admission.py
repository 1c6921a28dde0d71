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
pages back: the swap tier's fault-in headroom.

With a prefix cache attached (``cache``), admission is cache-aware
(DESIGN.md §11): a request's matched prefix maps the tree's pages
read-only, so device-resident cached chunks are a page DISCOUNT, and the
tree's unshared LRU chunks are shed before a request is queued.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

import numpy as np

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
    # prefix-cache inputs, filled by the engine: real prompt ids (None =
    # synthetic, never cached), the request's opt-out and its prefill
    # bucket (half of the cache key)
    prompt_ids: Optional[np.ndarray] = None
    cache: bool = True
    bucket: int = 0
    # prefix-cache outputs, set by ``try_admit`` on success: the fork (the
    # cached tokens mapped from the tree) and the cached prefix's
    # captured MoE routing [fork, L, k] (None for a dense model)
    cached_tokens: int = 0
    prefix_routes: Optional[np.ndarray] = None


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
        # the prefix cache (``core.prefix_cache.PrefixCache``) or None
        self.cache = None
        self.stats = AdmissionStats()
        # the observability sink (``core.hooks.CoreHooks``) or None; its
        # calls sit one for one beside the ``stats.bump`` sites
        self.hooks = None

    def offer(self, req: PendingRequest, now: float) -> str:
        """Returns 'admitted' | 'queued' | 'rejected'."""
        if self.try_admit(req):
            self.stats.bump(req.model, "admitted")
            if self.hooks is not None:
                self.hooks.admission(req.model, "admitted", "")
            return "admitted"
        if len(self.queues[req.model]) < self.max_queue:
            req.enqueue_time = now
            self.queues[req.model].append(req)
            self.stats.bump(req.model, "queued")
            if self._last_block == "weights":
                self.stats.weight_pressure_queued += 1
            elif self._last_block == "pages":
                self.stats.page_pressure_queued += 1
            if self.hooks is not None:
                self.hooks.admission(req.model, "queued", self._last_block)
            return "queued"
        self.stats.bump(req.model, "rejected")
        if self.hooks is not None:
            self.hooks.admission(req.model, "rejected", "")
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
        cold model.  Takes the request's arena pin on success.

        With a prefix cache, an eligible request (real ids, in its
        bucket) first probes the tree (reference ``admission.py:176``):
        the fork is ``min(matched, prompt - 1)`` (the suffix pass makes
        the first token's logits), device-resident full chunks are a
        discount, a swapped fork chunk a surcharge.  On a deficit the
        tree sheds that many pages and the discount is taken again from
        the chunks' new state.  Only once both budgets hold are swapped
        chunks faulted in and the request registered on them."""
        expect = req.expected_output if self.reserve_output else 0
        cache = self.cache
        view = self.virt.views.get(req.model)
        eligible = (cache is not None and req.cache
                    and req.prompt_ids is not None
                    and view is not None and view.n_kv_layers > 0
                    and 0 < req.prompt_tokens <= req.bucket)
        fork, nodes, n_full, rem = 0, [], 0, 0
        if eligible:
            matched, nodes = cache.match_prefix(req.model, req.bucket,
                                                req.prompt_ids)
            fork = min(matched, req.prompt_tokens - 1)
            if fork > 0 and self.virt.configs[req.model].is_moe and any(
                    n.routes is None for n in nodes):
                fork = 0      # an MoE suffix needs the routing to replay
            n_full, rem = divmod(fork, view.tokens_per_page) if fork \
                else (0, 0)

        def discount() -> int:
            if fork == 0:
                return 0
            resident = sum(1 for n in nodes[:n_full] if not n.swapped)
            cow_swapped = rem and nodes[n_full].swapped
            return view.n_kv_layers * (resident - (1 if cow_swapped else 0))

        def deficit() -> int:
            return self.virt.admission_deficit(
                req.model, req.prompt_tokens, expect,
                reserve=self.reserve_pages, discount_pages=discount())

        short = deficit()
        if short > 0 and cache is not None:
            # the tree's unshared LRU pages are reclaimable: shed them
            # before cache retention queues a request a cache-off engine
            # would admit (the shed may swap chunks this match uses)
            cache.shed(short)
            short = deficit()
        if short > 0:
            self._last_block = "pages"
            return False
        if not self._weights_pressure_ok(req.model):
            self._last_block = "weights"
            return False
        self._last_block = ""
        if fork > 0:
            used = nodes[:n_full + (1 if rem else 0)]
            cache.fault_chunks(used)
            self.virt.register_request_with_prefix(
                req.request_id, req.model, req.prompt_tokens,
                [n.pages for n in nodes[:n_full]],
                nodes[n_full].pages if rem else None)
            routes = [n.routes for n in used]
            if routes and all(r is not None for r in routes):
                req.prefix_routes = np.concatenate(routes, axis=0)[:fork]
        else:
            self.virt.register_request(req.request_id, req.model,
                                       req.prompt_tokens)
        req.cached_tokens = fork
        if eligible:
            # once per registration: a queued retry that fails the budget
            # never counts twice
            cache.record_admission(req.model, req.prompt_tokens, fork)
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
                    if self.hooks is not None:
                        self.hooks.admission(model, "admitted", "")
                        self.hooks.admission_wait(
                            model, now - head.enqueue_time)
                    admitted.append(head)
                    progress = True
        return admitted

    def queued_count(self) -> int:
        return sum(len(q) for q in self.queues.values())
