"""Runtime shadow-sanitizer for the disaggregated pools (DESIGN.md §12).

Port of ``src/repro/analysis/sanitizer.py``: the same rules over the
port's host-side pool state (free lists, page tables, refcounts, the
swap tier's slots, slab residencies, pins).  It reads no device tensor,
so an audit never waits on the card.

``PoolSanitizer`` is a ``core.hooks.CoreHooks`` implementation that
mirrors every page/slab/refcount/swap/reserve transition the pools
report and cross-checks the pools' actual state against the accounting
invariants the prose rules promise — the ASan analogue for the
CrossPool memory model.  MemServe-style elastic pools break precisely
here: a page freed twice, a refcount that drifts from its holder count,
a swap slot aliased by two requests — all silent until a later request
reads someone else's KV.

Two layers of checking:

  * **per-event** (every hook call): shadow counters accumulate the
    hook payloads and reconcile against the owning pool's own stat
    counters (SAN07).  The hook contract says counters are consistent
    when the hook fires, so any drift means a counter was bumped
    without its hook (or vice versa) — the runtime complement of lint
    rule CP003.
  * **structural** (``audit()``, called by the engine at quiescent
    points — end of ``submit``/``step`` — and by tests directly): a
    full walk of the free lists, request page tables, prefix-tree
    holds, swap tier, refcounts, arena residencies and admission pins.
    Structural audits do NOT run inside hook callbacks: a hook fires
    when its OWNING object is consistent, but a cross-object handoff
    (e.g. the prefix tree swapping a chunk out through the
    virtualizer) is mid-flight at that instant by design.

Rule ids (each raises :class:`PoolSanitizerError` with ``.rule`` set):

  SAN01  page aliasing / double-free (a page both free and mapped, a
         duplicated free-list entry, or a `-1` padding sentinel inside
         a request's own table)
  SAN02  page-conservation violation (free + mapped != budget)
  SAN03  refcount drift (``page_refs`` != actual holder count)
  SAN04  swap-tier accounting violation (slot aliased/leaked, or
         ``swapped_now`` != swapped entries)
  SAN05  reserve/commit pairing violation (ragged layer tables, or a
         table shorter than the committed token count needs)
  SAN06  unpin-before-finish (a model with admitted in-flight requests
         lost its arena pin)
  SAN07  hook/counter adjacency drift (shadow sums != pool counters)
  SAN08  arena slab aliasing or conservation violation

Attach via ``EngineConfig(sanitize=True)`` or ``CROSSPOOL_SANITIZE=1``;
detached, the engine does zero extra work.
"""
from __future__ import annotations

import math
from typing import Dict, List

from repro_torch.core.hooks import CoreHooks
from repro_torch.core.virtualizer import _SWAP_BASE, _swap_decode


class PoolSanitizerError(RuntimeError):
    """One violated pool invariant; ``.rule`` is the SANxx id."""

    def __init__(self, rule: str, message: str):
        self.rule = rule
        super().__init__(f"{rule}: {message}")


class PoolSanitizer(CoreHooks):
    """Shadow state + invariant auditor over the live pool objects."""

    def __init__(self, virt, arena=None, admission=None, cache=None):
        self.virt = virt
        self.arena = arena
        # NB: named ``adm`` — ``self.admission`` would shadow the
        # ``admission`` hook method inherited from CoreHooks
        self.adm = admission
        self.cache = cache
        self.events = 0                 # hook events seen
        self.audits = 0                 # structural audits run
        # shadow accumulators (filled from hook payloads only)
        self.shadow: Dict[str, int] = {
            "kv_swap_out": 0, "kv_swap_in": 0, "kv_reserved": 0,
            "kv_trimmed": 0, "kv_resizes": 0,
            "arena_activations": 0, "arena_evictions": 0,
            "arena_resizes": 0, "cache_evict_pages": 0,
            "cache_fault_pages": 0, "rebalances": 0,
        }
        # baseline: attach may happen after pool construction, so shadow
        # sums reconcile against the DELTA of each counter
        self._base: Dict[str, int] = {
            "swap_out_pages": virt.swap_out_pages,
            "swap_in_pages": virt.swap_in_pages,
            "resizes": virt.resizes,
        }
        if arena is not None:
            self._base.update({
                "activations": arena.activations,
                "evictions": arena.evictions,
                "arena_resizes": arena.resizes,
            })

    # ------------------------------------------------------------------
    # failure reporting
    # ------------------------------------------------------------------
    def _fail(self, rule: str, message: str) -> None:
        raise PoolSanitizerError(rule, message)

    # ------------------------------------------------------------------
    # hook points: shadow accumulation + counter reconciliation (SAN07)
    # ------------------------------------------------------------------
    def _reconcile(self, what: str, counter: int, base_key: str,
                   shadow_key: str) -> None:
        expect = self._base.get(base_key, 0) + self.shadow[shadow_key]
        if counter != expect:
            self._fail(
                "SAN07",
                f"{what}: pool counter is {counter} but hooks account for "
                f"{expect} (base {self._base.get(base_key, 0)} + shadow "
                f"{self.shadow[shadow_key]}) — a mutation bypassed its "
                f"hook, or a hook fired without its counter")

    def kv_swap_out(self, pages: int) -> None:
        self.events += 1
        self.shadow["kv_swap_out"] += pages
        self._reconcile("kv swap-out pages", self.virt.swap_out_pages,
                        "swap_out_pages", "kv_swap_out")

    def kv_swap_in(self, pages: int) -> None:
        self.events += 1
        self.shadow["kv_swap_in"] += pages
        self._reconcile("kv swap-in pages", self.virt.swap_in_pages,
                        "swap_in_pages", "kv_swap_in")

    def kv_reserved(self, pages: int) -> None:
        self.events += 1
        self.shadow["kv_reserved"] += pages

    def kv_trimmed(self, pages: int) -> None:
        self.events += 1
        self.shadow["kv_trimmed"] += pages
        if self.shadow["kv_trimmed"] > self.shadow["kv_reserved"]:
            self._fail(
                "SAN05",
                f"commit_decode_block trimmed "
                f"{self.shadow['kv_trimmed']} pages but only "
                f"{self.shadow['kv_reserved']} were ever reserved — "
                f"unpaired reserve/commit")

    def kv_resize(self, old_pages: int, new_pages: int, swapped_out: int,
                  moved: int) -> None:
        self.events += 1
        self.shadow["kv_resizes"] += 1
        self._reconcile("kv resizes", self.virt.resizes, "resizes",
                        "kv_resizes")
        if self.virt.page_budget != new_pages:
            self._fail(
                "SAN07",
                f"kv_resize reported new budget {new_pages} but the pool "
                f"holds {self.virt.page_budget}")

    def arena_activate(self, model: str, slabs: int) -> None:
        self.events += 1
        self.shadow["arena_activations"] += 1
        if self.arena is not None:
            self._reconcile("arena activations", self.arena.activations,
                            "activations", "arena_activations")

    def arena_evict(self, model: str, slabs: int) -> None:
        self.events += 1
        self.shadow["arena_evictions"] += 1
        if self.arena is not None:
            self._reconcile("arena evictions", self.arena.evictions,
                            "evictions", "arena_evictions")

    def arena_resize(self, old_slots: int, new_slots: int, evicted: int,
                     moved: int) -> None:
        self.events += 1
        self.shadow["arena_resizes"] += 1
        if self.arena is not None:
            self._reconcile("arena resizes", self.arena.resizes,
                            "arena_resizes", "arena_resizes")

    def cache_evict(self, pages: int) -> None:
        self.events += 1
        self.shadow["cache_evict_pages"] += pages

    def cache_fault(self, pages: int) -> None:
        self.events += 1
        self.shadow["cache_fault_pages"] += pages

    def rebalance(self, decision) -> None:
        self.events += 1
        self.shadow["rebalances"] += 1

    # remaining hooks only count events (no reconcilable pool counter)
    def arena_upload(self, model: str, slabs: int) -> None:
        self.events += 1

    def admission(self, model: str, outcome: str, blocker: str) -> None:
        self.events += 1

    def admission_wait(self, model: str, seconds: float) -> None:
        self.events += 1

    def cache_hit(self, model: str, tokens: int) -> None:
        self.events += 1

    def cache_miss(self, model: str) -> None:
        self.events += 1

    # ------------------------------------------------------------------
    # structural audit (quiescent points)
    # ------------------------------------------------------------------
    def audit(self) -> None:
        """Full invariant walk; raises on the first violation."""
        self.audits += 1
        self._audit_kv()
        self._audit_swap_tier()
        self._audit_reservations()
        if self.arena is not None:
            self._audit_arena()
            self._audit_pins()

    # -- KV pages -------------------------------------------------------
    def _holders(self) -> Dict[int, int]:
        """device page id -> number of live holders (request table
        entries + one for a prefix-tree hold)."""
        holders: Dict[int, int] = {}
        for rid, req in self.virt.requests.items():
            for tab in list(req.tables) + [req.state_pages]:
                for p in tab:
                    if p == -1:
                        self._fail(
                            "SAN01",
                            f"request {rid} has a -1 entry in its own "
                            f"table — the batch-padding sentinel must "
                            f"never be mapped")
                    if p >= 0:
                        holders[p] = holders.get(p, 0) + 1
        cache = self.cache or self.virt.cache_provider
        if cache is not None:
            for p in cache.device_pages():
                holders[p] = holders.get(p, 0) + 1
        return holders

    def _audit_kv(self) -> None:
        virt = self.virt
        free = virt.free_list
        budget = virt.page_budget
        free_set = set(free)
        if len(free_set) != len(free):
            dup = sorted(p for p in free_set if free.count(p) > 1)
            self._fail("SAN01",
                       f"double-free: page(s) {dup} appear more than once "
                       f"on the free list")
        bad = [p for p in free if not 0 <= p < budget]
        if bad:
            self._fail("SAN01",
                       f"free list holds out-of-range page id(s) {bad} "
                       f"(budget {budget})")
        holders = self._holders()
        aliased = sorted(free_set & holders.keys())
        if aliased:
            self._fail("SAN01",
                       f"page(s) {aliased} are simultaneously free and "
                       f"mapped — use-after-free in the making")
        oob = sorted(p for p in holders if not 0 <= p < budget)
        if oob:
            self._fail("SAN01",
                       f"mapped page id(s) {oob} outside [0, {budget})")
        if len(free_set) + len(holders) != budget:
            self._fail(
                "SAN02",
                f"page conservation broken: {len(free_set)} free + "
                f"{len(holders)} mapped != budget {budget} "
                f"(leaked or conjured pages)")
        # refcounts: page_refs must equal the holder count for every
        # mapped page; _refs may only name mapped, actually-shared pages
        for p, n in holders.items():
            refs = virt.page_refs(p)
            if refs != n:
                self._fail(
                    "SAN03",
                    f"refcount drift on page {p}: page_refs={refs} but "
                    f"{n} live holder(s) map it")
        stale = sorted(p for p in virt._refs if p not in holders)
        if stale:
            self._fail("SAN03",
                       f"_refs tracks page(s) {stale} that no holder maps")

    # -- swap tier ------------------------------------------------------
    def _swapped_slots(self) -> List[int]:
        slots: List[int] = []
        for req in self.virt.requests.values():
            for _, _, slot in req.swapped_entries():
                slots.append(slot)
        cache = self.cache or self.virt.cache_provider
        if cache is not None and hasattr(cache, "_walk"):
            for node in cache._walk():
                if node.swapped:
                    slots.extend(_swap_decode(p) for p in node.pages
                                 if p <= _SWAP_BASE)
        return slots

    def _audit_swap_tier(self) -> None:
        virt = self.virt
        used = self._swapped_slots()
        used_set = set(used)
        if len(used_set) != len(used):
            dup = sorted(s for s in used_set if used.count(s) > 1)
            self._fail("SAN04",
                       f"swap slot(s) {dup} aliased by multiple entries")
        free_set = set(virt.swap_free)
        if len(free_set) != len(virt.swap_free):
            self._fail("SAN04", "duplicate entries on the swap free list")
        both = sorted(used_set & free_set)
        if both:
            self._fail("SAN04",
                       f"swap slot(s) {both} simultaneously free and used")
        cap = 0 if virt.swap_buffer is None else len(virt.swap_buffer)
        oob = sorted(s for s in used_set | free_set if not 0 <= s < cap)
        if oob:
            self._fail("SAN04",
                       f"swap slot id(s) {oob} outside the {cap}-slot tier")
        if virt.swapped_now != len(used):
            self._fail(
                "SAN04",
                f"swapped_now={virt.swapped_now} but {len(used)} swapped "
                f"entries exist across requests and the prefix tree")

    # -- reserve/commit pairing ----------------------------------------
    def _audit_reservations(self) -> None:
        for rid, req in self.virt.requests.items():
            view = self.virt.views[req.model]
            if not view.n_kv_layers:
                continue
            lens = {len(t) for t in req.tables}
            if len(lens) > 1:
                self._fail(
                    "SAN05",
                    f"request {rid} has ragged layer tables {sorted(lens)} "
                    f"— a reserve or trim touched only some layers")
            have = len(req.tables[0]) if req.tables else 0
            need = math.ceil(max(req.tokens, 1) / view.tokens_per_page)
            if have < need:
                self._fail(
                    "SAN05",
                    f"request {rid} committed {req.tokens} tokens needing "
                    f"{need} chunks/layer but maps only {have} — a commit "
                    f"outran its reservation")

    # -- arena ----------------------------------------------------------
    def _audit_arena(self) -> None:
        arena = self.arena
        resident: Dict[int, str] = {}
        for name, res in arena.residency.items():
            for s in res.slots.ravel():
                s = int(s)
                if s in resident:
                    self._fail(
                        "SAN08",
                        f"slab {s} mapped by both {resident[s]!r} and "
                        f"{name!r}")
                resident[s] = name
        free = arena.free_list
        free_set = set(free)
        if len(free_set) != len(free):
            self._fail("SAN08", "duplicate entries on the arena free list")
        both = sorted(free_set & resident.keys())
        if both:
            self._fail("SAN08",
                       f"slab(s) {both} simultaneously free and resident")
        oob = sorted(s for s in free_set | resident.keys()
                     if not 0 <= s < arena.slot_budget)
        if oob:
            self._fail("SAN08",
                       f"slab id(s) {oob} outside [0, {arena.slot_budget})")
        if len(free_set) + len(resident) != arena.slot_budget:
            self._fail(
                "SAN08",
                f"slab conservation broken: {len(free_set)} free + "
                f"{len(resident)} resident != budget {arena.slot_budget}")

    def _audit_pins(self) -> None:
        if self.adm is None:
            return
        for model, count in self.adm.inflight.items():
            if count <= 0 or model not in self.arena.views:
                continue
            pins = self.arena.pins.get(model, 0)
            if pins < count:
                self._fail(
                    "SAN06",
                    f"model {model!r} has {count} admitted in-flight "
                    f"request(s) but only {pins} arena pin(s) — an unpin "
                    f"ran before finish, its weights are evictable "
                    f"mid-request")

    # ------------------------------------------------------------------
    def report(self) -> Dict[str, int]:
        return {"events": self.events, "audits": self.audits,
                **self.shadow}
