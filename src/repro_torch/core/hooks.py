"""Observability hook points for the core pool layer (DESIGN.md §10).

A copy of the reference's ``core/hooks.py``: the same 17 hooks, the same
ordering contract.

The pools (``virtualizer``, ``weight_pool``), the admission controller
and the elastic rebalancer each hold an optional ``hooks`` attribute.
When it is ``None`` (the default) every hook site is a single
``is not None`` check — the disabled path does no calls and no
allocations.  When a :class:`CoreHooks` implementation is attached
(``repro_torch.runtime.observe.EngineObserver`` is the canonical one), the core
layer reports its state transitions WITHOUT importing anything from the
runtime layer — this module is the whole dependency surface.

Hook ordering guarantees (what an implementation may rely on):

  * hooks fire AFTER the state change they describe has fully applied
    (counters read through the owning object are already consistent);
  * hooks fire on the engine host thread, never from inside a decode
    graph's capture or warm-up (those touch no host bookkeeping) —
    implementations may allocate and may read host state only (a
    device read inside a block dispatch would stall it), and may raise
    only at the cost of aborting the step;
  * a hook is never invoked with a zero-sized change (``kv_swap_out(0)``
    etc. are elided at the call site).
"""
from __future__ import annotations


class CoreHooks:
    """No-op base: every method is a hook point, override what you need."""

    # --- KV virtualizer (swap tier + reserve/commit + live resize) -----
    def kv_swap_out(self, pages: int) -> None:
        """``pages`` page rows moved device -> host swap tier."""

    def kv_swap_in(self, pages: int) -> None:
        """``pages`` page rows faulted host -> device (``ensure_resident``)."""

    def kv_reserved(self, pages: int) -> None:
        """``pages`` pre-mapped for a decode block (``reserve_decode_block``)."""

    def kv_trimmed(self, pages: int) -> None:
        """Unused reserved ``pages`` returned (``commit_decode_block``)."""

    def kv_resize(self, old_pages: int, new_pages: int,
                  swapped_out: int, moved: int) -> None:
        """The page pool was live-resized (elastic boundary move)."""

    # --- weights arena -------------------------------------------------
    def arena_activate(self, model: str, slabs: int) -> None:
        """A cold model's ``slabs`` were mapped into the arena."""

    def arena_evict(self, model: str, slabs: int) -> None:
        """A resident model's ``slabs`` were returned to the free list."""

    def arena_upload(self, model: str, slabs: int) -> None:
        """``slabs`` slab rows were uploaded host -> device."""

    def arena_resize(self, old_slots: int, new_slots: int,
                     evicted: int, moved: int) -> None:
        """The arena was live-resized (elastic boundary move)."""

    # --- admission front door ------------------------------------------
    def admission(self, model: str, outcome: str, blocker: str) -> None:
        """One admission verdict: ``outcome`` in admitted/queued/rejected,
        ``blocker`` in ''/'pages'/'weights' (what deferred a queue)."""

    def admission_wait(self, model: str, seconds: float) -> None:
        """A queued request drained after ``seconds`` at the front door."""

    # --- prefix cache (DESIGN.md §11) ----------------------------------
    def cache_hit(self, model: str, tokens: int) -> None:
        """A cache-eligible admission reused ``tokens`` cached prompt
        tokens (fires once per admitted request with a non-empty match)."""

    def cache_miss(self, model: str) -> None:
        """A cache-eligible admission found no reusable prefix."""

    def cache_evict(self, pages: int) -> None:
        """``pages`` device pages left the tree's hold (LRU eviction, or
        a shed to the second-chance swap tier)."""

    def cache_fault(self, pages: int) -> None:
        """``pages`` shed pages faulted back from the swap tier on a
        second-chance hit."""

    # --- elastic rebalancer --------------------------------------------
    def rebalance(self, decision) -> None:
        """One applied boundary move (a ``RebalanceDecision``)."""

    # --- SLO engine (DESIGN.md §13) ------------------------------------
    def slo_breach(self, breach) -> None:
        """A multi-rate burn-rate breach (a ``runtime.observe.SLOBreach``;
        held loosely typed so the core layer stays runtime-import-free).
        Fires once per (model, metric) on the breaching EDGE — re-arms
        only after the condition clears."""


class CompositeHooks(CoreHooks):
    """Fan one hook stream out to several sinks, in attachment order.

    The engine uses this when more than one consumer wants the core
    events (e.g. the ``EngineObserver`` plus the shadow sanitizer,
    ``repro_torch.analysis.sanitizer.PoolSanitizer``).  Sinks are invoked in
    order; a raising sink aborts the step like any single hook would
    (the sanitizer RELIES on that — a detected violation must surface,
    not be swallowed so later sinks still run)."""

    def __init__(self, *sinks: CoreHooks):
        self.sinks = [s for s in sinks if s is not None]

    def _fan(self, name, *args):
        for s in self.sinks:
            getattr(s, name)(*args)

    def kv_swap_out(self, pages):
        self._fan("kv_swap_out", pages)

    def kv_swap_in(self, pages):
        self._fan("kv_swap_in", pages)

    def kv_reserved(self, pages):
        self._fan("kv_reserved", pages)

    def kv_trimmed(self, pages):
        self._fan("kv_trimmed", pages)

    def kv_resize(self, old_pages, new_pages, swapped_out, moved):
        self._fan("kv_resize", old_pages, new_pages, swapped_out, moved)

    def arena_activate(self, model, slabs):
        self._fan("arena_activate", model, slabs)

    def arena_evict(self, model, slabs):
        self._fan("arena_evict", model, slabs)

    def arena_upload(self, model, slabs):
        self._fan("arena_upload", model, slabs)

    def arena_resize(self, old_slots, new_slots, evicted, moved):
        self._fan("arena_resize", old_slots, new_slots, evicted, moved)

    def admission(self, model, outcome, blocker):
        self._fan("admission", model, outcome, blocker)

    def admission_wait(self, model, seconds):
        self._fan("admission_wait", model, seconds)

    def cache_hit(self, model, tokens):
        self._fan("cache_hit", model, tokens)

    def cache_miss(self, model):
        self._fan("cache_miss", model)

    def cache_evict(self, pages):
        self._fan("cache_evict", pages)

    def cache_fault(self, pages):
        self._fan("cache_fault", pages)

    def rebalance(self, decision):
        self._fan("rebalance", decision)

    def slo_breach(self, breach):
        self._fan("slo_breach", breach)
