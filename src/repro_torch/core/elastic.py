"""Elastic pool rebalancer: online KV<->weights boundary repartitioning.

Port of ``src/repro/core/elastic.py`` (DESIGN.md §8).  The paper's
premise is that KV demand is transient and workload-determined while
weights demand is stable, so the split between ``KVVirtualizer.pool`` and
``WeightArena`` moves ONLINE: at session step boundaries a windowed
Eq. (1)-(2) estimate (``planner.replan_split`` over
``runtime.telemetry`` specs) re-splits the SAME total device-byte budget,
and the pools are live-resized — one grows, the other shrinks — in page
and slab increments.

Safety rules:

  * **byte conservation**: ``page_budget * page_bytes + slot_budget *
    slab_bytes`` never exceeds the budget captured at construction; a
    grow is applied only after the matching shrink freed the bytes;
  * **shrinks never kill in-flight work**: the KV pool shrinks through
    the virtualizer's host swap tier (protected = slotted requests are
    exempt) and the arena through LRU eviction of idle unpinned models —
    both raise, leaving state consistent, if the floor is violated;
  * **damped decisions**: hysteresis, cooldown and a per-move rate limit
    keep a bursty signal from thrashing the boundary.  Decisions are
    deterministic for a fixed observation stream (the Monte Carlo
    re-plan runs on a fixed seed), and equal the reference's.

A move gives the pool or the arena a new tensor: the engine captures
every moved decode graph again right after it (``runtime/engine.py``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.configs.base import ElasticConfig
from repro_torch.core.planner import replan_split
from repro_torch.core.virtualizer import KVVirtualizer, OutOfPagesError
from repro_torch.core.weight_pool import OutOfSlabsError, WeightArena


@dataclass(frozen=True)
class RebalanceDecision:
    """One applied boundary move (surfaced as a session RebalanceEvent)."""

    step: int
    now: float
    old_page_budget: int
    new_page_budget: int
    old_slot_budget: int
    new_slot_budget: int
    swapped_out: int               # KV pages pushed to the host swap tier
    evicted_models: int            # arena models LRU-evicted by the shrink
    moved_pages: int               # survivors compacted by the pool gather
    moved_slabs: int
    reason: str                    # "kv_demand" | "weight_demand"

    @property
    def kv_grew(self) -> bool:
        return self.new_page_budget > self.old_page_budget

    def to_record(self) -> Dict[str, object]:
        """Stable record form (the reference's flight-record schema,
        DESIGN.md §13): what a decision sequence is compared by."""
        return {
            "step": self.step,
            "now": self.now,
            "page_budget": [self.old_page_budget, self.new_page_budget],
            "slot_budget": [self.old_slot_budget, self.new_slot_budget],
            "swapped_out": self.swapped_out,
            "evicted_models": self.evicted_models,
            "moved_pages": self.moved_pages,
            "moved_slabs": self.moved_slabs,
            "reason": self.reason,
        }


class ElasticRebalancer:
    """Step-boundary driver of the live KV<->weights repartition."""

    def __init__(self, virt: KVVirtualizer, arena: Optional[WeightArena],
                 *, admission=None, telemetry=None,
                 cfg: Optional[ElasticConfig] = None, seed: int = 0):
        self.virt = virt
        self.arena = arena
        self.admission = admission
        self.telemetry = telemetry
        self.cfg = cfg or ElasticConfig()
        self.seed = seed
        # the conserved budget: whatever the session started with
        self.total_bytes = virt.page_budget * virt.page_bytes
        if arena is not None:
            self.total_bytes += arena.slot_budget * arena.slab_bytes
        self._step = 0
        self._last_applied = -(10 ** 9)
        self.events: List[RebalanceDecision] = []
        # decision counters (report / determinism tests)
        self.evaluations = 0
        self.skipped_hysteresis = 0
        self.skipped_cooldown = 0
        self.skipped_no_signal = 0
        self.aborted = 0
        # the observability sink (``core.hooks.CoreHooks``) or None: fires
        # once per APPLIED decision, after both pools finished resizing
        self.hooks = None
        # the prefix cache (``core.prefix_cache.PrefixCache``) or None:
        # its hit-token fraction discounts the re-plan's KV demand, since
        # cached prompt tokens map shared tree pages (DESIGN.md §11)
        self.cache = None

    # ------------------------------------------------------------------
    # floors and clamps
    # ------------------------------------------------------------------
    def _page_floor(self, protected) -> int:
        """Pages a shrink must retain: every protected (slotted) request's
        mapping grown to cover its REMAINING declared output — the same
        reservation admission made, so no later decode step of an
        in-flight request can exhaust the shrunk budget ("shrinks never
        kill in-flight requests" must hold for the request's whole
        lifetime, not just its next token).

        ``protected`` maps request id -> remaining output tokens (a bare
        id sequence is accepted with a 1-token reservation).
        """
        floor = self.cfg.min_page_budget
        remaining = (protected if hasattr(protected, "get")
                     else {rid: 1 for rid in protected})
        held = 0
        for rid, left in remaining.items():
            req = self.virt.requests.get(rid)
            if req is None:
                continue
            view = self.virt.views[req.model]
            if view.n_kv_layers:
                chunks = math.ceil(max(req.tokens + max(left, 1), 1)
                                   / view.tokens_per_page)
                held += chunks * view.n_kv_layers
            held += len(req.state_pages)
        return max(floor, held, 1)

    def _slot_floor(self) -> int:
        if self.arena is None:
            return 0
        return self.arena.min_slot_budget()

    def _clamp(self, target_pages: int, protected
               ) -> Optional[Tuple[int, int]]:
        """Conservation + floors + rate limit -> (pages, slots) or None."""
        pb = self.virt.page_bytes
        sb = self.arena.slab_bytes if self.arena is not None else 0
        cur_pages = self.virt.page_budget
        cur_slots = self.arena.slot_budget if self.arena is not None else 0
        page_floor = self._page_floor(protected)
        slot_floor = self._slot_floor()
        if self.arena is None or sb == 0:
            return None                     # nothing to trade against
        # rate limit BOTH pools' moves, then respect floors + conservation
        frac = self.cfg.max_step_fraction
        max_page_move = max(int(frac * cur_pages), 1)
        pages = min(max(target_pages, cur_pages - max_page_move),
                    cur_pages + max_page_move)
        page_ceiling = (self.total_bytes - slot_floor * sb) // pb
        pages = int(min(max(pages, page_floor), page_ceiling))
        if pages < page_floor:
            return None                     # floors don't fit the budget
        max_slot_move = max(int(frac * cur_slots), 1)
        slots = int((self.total_bytes - pages * pb) // sb)
        slots = min(max(slots, cur_slots - max_slot_move),
                    cur_slots + max_slot_move)
        slots = max(slots, slot_floor)
        # conservation under the (possibly slot-rate-limited) arena size;
        # min() keeps the page move inside its own rate limit too
        pages = int(min(pages, (self.total_bytes - slots * sb) // pb))
        if pages < page_floor:
            return None
        return pages, slots

    # ------------------------------------------------------------------
    # the decision
    # ------------------------------------------------------------------
    def would_evaluate(self) -> bool:
        """Whether the NEXT ``step`` call reaches the re-plan (mirrors the
        interval/cooldown gates at the top of :meth:`step` exactly — keep
        the two in sync).  Lets the engine skip assembling the protected /
        live-request views on the steps that would discard them."""
        cfg = self.cfg
        if not cfg.enabled or self.telemetry is None or self.arena is None:
            return False
        nxt = self._step + 1
        if nxt % max(cfg.interval_steps, 1) != 0:
            return False
        return nxt - self._last_applied >= cfg.cooldown_steps

    def step(self, now: float, *, protected=(),
             live_requests: Optional[Dict] = None
             ) -> Optional[RebalanceDecision]:
        """Evaluate (and maybe apply) one rebalance at a step boundary.

        ``protected`` is the slotted-request reservation — a mapping of
        request id -> remaining output tokens (or a bare id sequence for
        a 1-token reservation).  Called once per session step; the
        interval / cooldown / hysteresis dampers decide whether anything
        actually moves.  Returns the applied decision, or None.
        """
        self._step += 1
        cfg = self.cfg
        if not cfg.enabled or self.telemetry is None or self.arena is None:
            return None
        # fault-in headroom: pages in the host swap tier will need free
        # device pages on their next touch — hold that many back from
        # admission so a fresh burst cannot starve the fault path
        if self.admission is not None:
            self.admission.reserve_pages = (
                self.virt.swapped_now + max(cfg.headroom_pages, 0))
        if self._step % max(cfg.interval_steps, 1) != 0:
            return None
        if self._step - self._last_applied < cfg.cooldown_steps:
            self.skipped_cooldown += 1
            return None
        self.evaluations += 1
        specs = self.telemetry.window_specs(now, live_requests)
        if not specs:
            self.skipped_no_signal += 1
            return None
        cached_frac = 0.0
        if self.cache is not None and self.cache.prompt_tokens_seen:
            cached_frac = (self.cache.hit_tokens
                           / self.cache.prompt_tokens_seen)
        try:
            plan = replan_split(
                specs, self.total_bytes, page_bytes=self.virt.page_bytes,
                slab_bytes=self.arena.slab_bytes if self.arena else 0,
                quantile=cfg.quantile, window_s=cfg.window_s,
                seed=self.seed, cached_token_fraction=cached_frac)
        except (ValueError, ZeroDivisionError):
            self.skipped_no_signal += 1
            return None
        clamped = self._clamp(plan.page_budget, protected)
        if clamped is None:
            self.skipped_no_signal += 1
            return None
        new_pages, new_slots = clamped
        cur_pages = self.virt.page_budget
        cur_slots = self.arena.slot_budget
        rel = max(abs(new_pages - cur_pages) / max(cur_pages, 1),
                  abs(new_slots - cur_slots) / max(cur_slots, 1))
        if rel < cfg.hysteresis or (new_pages == cur_pages
                                    and new_slots == cur_slots):
            self.skipped_hysteresis += 1
            return None
        return self._apply(now, new_pages, new_slots, protected)

    def _apply(self, now: float, new_pages: int, new_slots: int,
               protected) -> Optional[RebalanceDecision]:
        """Shrink-before-grow application of one boundary move."""
        cur_pages = self.virt.page_budget
        cur_slots = self.arena.slot_budget
        swapped = evicted = moved_p = moved_s = 0
        try:
            # shrinks FIRST: the bytes must be free before either grow
            if new_pages < cur_pages:
                r = self.virt.resize(new_pages, protected=protected)
                swapped, moved_p = r["swapped_out"], r["moved"]
            if new_slots < cur_slots:
                r = self.arena.resize(new_slots)
                evicted, moved_s = r["evicted"], r["moved"]
            if new_pages > cur_pages:
                self.virt.resize(new_pages, protected=protected)
            if new_slots > cur_slots:
                self.arena.resize(new_slots)
        except (OutOfPagesError, OutOfSlabsError):
            # floors were computed optimistically and the pool disagreed
            # (e.g. protected pages grew between floor calc and apply);
            # state is still consistent — record and stand down
            self.aborted += 1
            return None
        finally:
            # a shrink may just have populated the swap tier: refresh the
            # admission reserve NOW, not at the next step's evaluation, so
            # the very next front-door drain already protects the
            # displaced requests' fault-in headroom
            if self.admission is not None:
                self.admission.reserve_pages = (
                    self.virt.swapped_now + max(self.cfg.headroom_pages, 0))
        self._last_applied = self._step
        decision = RebalanceDecision(
            step=self._step, now=now,
            old_page_budget=cur_pages, new_page_budget=new_pages,
            old_slot_budget=cur_slots, new_slot_budget=new_slots,
            swapped_out=swapped, evicted_models=evicted,
            moved_pages=moved_p, moved_slabs=moved_s,
            reason="kv_demand" if new_pages > cur_pages
            else "weight_demand")
        self.events.append(decision)
        if self.hooks is not None:
            self.hooks.rebalance(decision)
        return decision

    # ------------------------------------------------------------------
    def snapshot(self) -> Dict[str, float]:
        return {
            "total_bytes": float(self.total_bytes),
            "rebalances": float(len(self.events)),
            "evaluations": float(self.evaluations),
            "skipped_hysteresis": float(self.skipped_hysteresis),
            "skipped_cooldown": float(self.skipped_cooldown),
            "skipped_no_signal": float(self.skipped_no_signal),
            "aborted": float(self.aborted),
            "page_budget": float(self.virt.page_budget),
            "slot_budget": float(self.arena.slot_budget
                                 if self.arena is not None else 0),
        }
