"""KV-cache virtualizer: paged virtualization of one shared physical pool.

Port of ``src/repro/core/virtualizer.py`` (DESIGN.md §2-3, §9).  The pool
is ONE pre-allocated device tensor of fixed-size pages, and "mapping" is
page-table bookkeeping on the host:

  * fast path (per token, on device): the attention kernels read K/V
    through a page table, writes go to (page, slot) coordinates — no
    allocation on the critical path;
  * slow path (per ~page, on host): ``register_request`` /
    ``extend_request`` / ``reserve_decode_block`` / ``commit_decode_block``
    / ``release_request`` update the free list and the per-request page
    tables.  The host bookkeeping is a line-for-line port, so the same
    operation sequence gives the same tables and free list as the
    reference.

The pool is untyped (flat elements of one dtype): each model views a page
as ``tokens_per_page`` tokens of ONE layer's K+V (or MLA latent+rope).
Where the reference donates the pool to a jitted scatter and rebinds the
result, the port writes into the pool tensor in place.

Elasticity (DESIGN.md §8): ``resize`` grows or shrinks ``page_budget``
at step boundaries, and a **host swap tier** (a pinned CPU tensor on a
card) makes shrinking safe for in-flight requests: the coldest pages of
the longest-idle requests move to the host (``swap_out``), survivors are
compacted into the retained prefix of a new pool tensor with ONE
``index_select``, and swapped pages fault back in on next touch
(``ensure_resident``).  A swapped table entry is encoded in place as
``-2 - host_slot``; ``-1`` stays the batch-table padding sentinel.  A
resize gives the pool a new tensor, so a decode graph captured over the
old one must be captured again (``core/control.py``).

Not ported yet: prefix sharing (refcounts) and the prefix cache's
second-chance tier.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.errors import PoolAccountingError, check
from repro_torch.kernels.ops import paged_kv_write

#: Page size shared by the virtualizer, the pools and the engine (16 KiB).
DEFAULT_PAGE_BYTES = 16 * 1024


class OutOfPagesError(RuntimeError):
    pass


__all__ = ["KVVirtualizer", "OutOfPagesError", "PoolAccountingError"]


@dataclass
class ModelView:
    """How one model interprets physical pages."""

    name: str
    per_token_elems: int          # one layer's K+V (or latent) elems per token
    tokens_per_page: int
    n_kv_layers: int
    kv_shape: Tuple[int, ...]     # per-token per-layer logical shape

    def pages_for(self, tokens: int) -> int:
        """Physical pages to hold ``tokens`` across all KV layers."""
        if self.tokens_per_page == 0:
            return 0
        per_layer = math.ceil(tokens / self.tokens_per_page)
        return per_layer * self.n_kv_layers


def make_view(cfg: ModelConfig, page_elems: int) -> ModelView:
    if cfg.attn_free:
        return ModelView(cfg.name, 0, 0, 0, ())
    if cfg.attention == "mla":
        m = cfg.mla
        per_tok = m.kv_lora_rank + m.qk_rope_head_dim
        shape = (per_tok,)
    else:
        per_tok = 2 * cfg.n_kv_heads * cfg.head_dim
        shape = (2, cfg.n_kv_heads, cfg.head_dim)
    tpp = page_elems // per_tok
    if tpp == 0:
        raise ValueError(
            f"{cfg.name}: per-token KV ({per_tok} elems) exceeds page size "
            f"({page_elems} elems); increase page_bytes")
    return ModelView(cfg.name, per_tok, tpp, cfg.n_decoder_attn_layers, shape)


#: Swapped page-table encoding: entry ``-2 - host_slot``.  ``-1`` stays
#: the batch-table padding sentinel, so any entry <= _SWAP_BASE is a
#: swapped page and ``_SWAP_BASE - entry`` recovers the host slot.
_SWAP_BASE = -2


def _swap_encode(host_slot: int) -> int:
    return _SWAP_BASE - host_slot


def _swap_decode(entry: int) -> int:
    return _SWAP_BASE - entry


@dataclass
class RequestPages:
    """Per-request mapping: tables[layer][chunk] -> physical page id.

    Entries >= 0 are device pages; entries <= -2 encode pages swapped to
    the host tier (``_swap_encode``), counted by ``n_swapped``."""

    request_id: int
    model: str
    tokens: int = 0
    tables: List[List[int]] = field(default_factory=list)   # [layer][chunk]
    state_pages: List[int] = field(default_factory=list)    # SSM constant state
    # globally monotonic mapping revision: unique per registration AND per
    # page-mapping change, so a reused request id never aliases a stale
    # cached batch table
    rev: int = -1
    last_touch: int = 0            # idle clock (swap victim order)
    n_swapped: int = 0             # table entries currently in the host tier

    def device_entries(self):
        """Yield (table, index, page) for every device-resident entry."""
        for tab in self.tables:
            for i, p in enumerate(tab):
                if p >= 0:
                    yield tab, i, p
        for i, p in enumerate(self.state_pages):
            if p >= 0:
                yield self.state_pages, i, p

    def swapped_entries(self):
        """Yield (table, index, host_slot) for every swapped entry."""
        for tab in self.tables:
            for i, p in enumerate(tab):
                if p <= _SWAP_BASE:
                    yield tab, i, _swap_decode(p)
        for i, p in enumerate(self.state_pages):
            if p <= _SWAP_BASE:
                yield self.state_pages, i, _swap_decode(p)


# ---------------------------------------------------------------------------
# device ops on the flat pool (all in place)
# ---------------------------------------------------------------------------

def _pool_pair_scatter(pool: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                       pages: torch.Tensor, slots: torch.Tensor, *,
                       n_tokens: int, batch_index: int, mla: bool
                       ) -> torch.Tensor:
    """Pack one batch row of a layer's ``(a, b)`` KV pair into token rows
    — MLA concatenates [latent | rope], GQA stacks [k, v] — and store them
    at ``(pages, slots)``."""
    a = a[batch_index, :n_tokens]
    b = b[batch_index, :n_tokens]
    kv = torch.cat([a, b], dim=-1) if mla else torch.stack([a, b], dim=1)
    return paged_kv_write(pool, kv.reshape(n_tokens, -1), pages, slots)


def _pool_row_scatter(pool: torch.Tensor, ids: torch.Tensor,
                      rows: torch.Tensor) -> torch.Tensor:
    """Overwrite whole page rows ``pool[ids] = rows`` (in place)."""
    return pool.index_copy_(0, ids.long(), rows.to(pool.dtype))


def _pool_row_gather(pool: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Copy whole page rows ``pool[ids]`` out into a new tensor."""
    return pool.index_select(0, ids.long())


class KVVirtualizer:
    """Host-side pager over one device-resident physical pool."""

    def __init__(self, models: Dict[str, ModelConfig], *,
                 page_budget: int, page_bytes: int = DEFAULT_PAGE_BYTES,
                 dtype=torch.bfloat16, allocate_device_pool: bool = True,
                 device="cuda"):
        self.page_bytes = page_bytes
        self.dtype = dtype
        self.device = torch.device(device)
        itemsize = torch.empty((), dtype=dtype).element_size()
        self.page_elems = page_bytes // itemsize
        self.page_budget = page_budget
        self.views = {n: make_view(c, self.page_elems)
                      for n, c in models.items()}
        self.configs = dict(models)
        self.free_list: List[int] = list(range(page_budget - 1, -1, -1))
        self.requests: Dict[int, RequestPages] = {}
        self.pool: Optional[torch.Tensor] = None
        if allocate_device_pool:
            self.pool = torch.zeros((page_budget, self.page_elems),
                                    dtype=dtype, device=self.device)
        # incremental device page-table cache: key -> {buf, revs, dev}
        self._batch_cache: Dict[tuple, dict] = {}
        self._rev_counter = 0
        # host swap tier: page rows a shrink evicted live here until the
        # next touch faults them back in (allocated lazily, grows 2x;
        # pinned when the pool is on a card)
        self.swap_buffer: Optional[torch.Tensor] = None
        self.swap_free: List[int] = []
        self._touch_clock = 0
        # stats
        self.peak_mapped = 0
        self.map_events = 0
        self.unmap_events = 0
        self.swap_out_pages = 0
        self.swap_in_pages = 0
        self.resizes = 0
        self.swapped_now = 0           # entries currently in the host tier

    # ------------------------------------------------------------------
    # accounting
    # ------------------------------------------------------------------
    @property
    def mapped_pages(self) -> int:
        return self.page_budget - len(self.free_list)

    @property
    def free_pages(self) -> int:
        return len(self.free_list)

    def can_admit(self, model: str, prompt_tokens: int,
                  expected_output: int = 0, reserve: int = 0) -> bool:
        """``reserve`` pages are held back from admission: the elastic
        rebalancer's fault-in headroom for the swap tier."""
        return self.admission_deficit(model, prompt_tokens, expected_output,
                                      reserve) == 0

    def admission_deficit(self, model: str, prompt_tokens: int,
                          expected_output: int = 0, reserve: int = 0) -> int:
        """Pages MISSING for this admission (0 = admissible), with
        ``reserve`` free pages held back."""
        view = self.views[model]
        cfg = self.configs[model]
        need = view.pages_for(prompt_tokens + expected_output) \
            if view.n_kv_layers else 0
        need += math.ceil(cfg.state_bytes_per_request() / self.page_bytes)
        return max(need - (self.free_pages - max(reserve, 0)), 0)

    # ------------------------------------------------------------------
    # slow path: map / unmap
    # ------------------------------------------------------------------
    def _next_rev(self) -> int:
        self._rev_counter += 1
        return self._rev_counter

    def _take(self, n: int) -> List[int]:
        """Atomically pop ``n`` pages: raises BEFORE mutating any state."""
        if n > len(self.free_list):
            raise OutOfPagesError(
                f"need {n} pages, {len(self.free_list)} free "
                f"(budget {self.page_budget})")
        pages = [self.free_list.pop() for _ in range(n)]
        self.map_events += n
        self.peak_mapped = max(self.peak_mapped, self.mapped_pages)
        return pages

    def register_request(self, request_id: int, model: str,
                         prompt_tokens: int) -> RequestPages:
        """Map pages for a request's prompt KV (+ SSM state), atomically:
        the total page count is taken in ONE ``_take``."""
        view = self.views[model]
        cfg = self.configs[model]
        chunks = math.ceil(max(prompt_tokens, 1) / view.tokens_per_page) \
            if view.n_kv_layers else 0
        state_pages = math.ceil(cfg.state_bytes_per_request()
                                / self.page_bytes)
        pages = self._take(chunks * view.n_kv_layers + state_pages)
        req = RequestPages(request_id, model)
        for layer in range(view.n_kv_layers):
            req.tables.append(pages[layer * chunks:(layer + 1) * chunks])
        if state_pages:
            req.state_pages = pages[view.n_kv_layers * chunks:]
        req.tokens = prompt_tokens
        req.rev = self._next_rev()
        self.requests[request_id] = req
        self.touch(request_id)
        return req

    def pages_needed_for_extend(self, request_id: int,
                                new_tokens: int = 1) -> int:
        """Pages an ``extend_request`` would map, without mutating."""
        req = self.requests[request_id]
        view = self.views[req.model]
        if not view.n_kv_layers:
            return 0
        have = len(req.tables[0])
        need = math.ceil(max(req.tokens + new_tokens, 1)
                         / view.tokens_per_page)
        return max(need - have, 0) * view.n_kv_layers

    def extend_request(self, request_id: int, new_tokens: int = 1) -> None:
        """Grow a request by ``new_tokens``; maps pages on demand, in ONE
        ``_take`` for every layer (atomic)."""
        req = self.requests[request_id]
        view = self.views[req.model]
        if view.n_kv_layers:
            have = len(req.tables[0])
            need = math.ceil(max(req.tokens + new_tokens, 1)
                             / view.tokens_per_page)
            delta = need - have
            if delta > 0:
                pages = self._take(delta * view.n_kv_layers)
                for layer, tab in enumerate(req.tables):
                    tab.extend(pages[layer * delta:(layer + 1) * delta])
                req.rev = self._next_rev()
        req.tokens += new_tokens
        self.touch(request_id)

    def reserve_decode_block(self, request_id: int, k: int = 1) -> int:
        """Pre-map pages covering the next ``k`` decode tokens WITHOUT
        committing them (multi-step decode, DESIGN.md §9): every layer
        table is extended to cover ``tokens + k`` while ``req.tokens``
        stays put until ``commit_decode_block``.  Atomic; returns the
        number of pages mapped."""
        req = self.requests[request_id]
        view = self.views[req.model]
        if not view.n_kv_layers:
            self.touch(request_id)
            return 0
        check(req.n_swapped == 0,
              f"request {request_id} has swapped pages; call ensure_resident "
              f"before reserving a decode block")
        have = len(req.tables[0])
        need = math.ceil(max(req.tokens + k, 1) / view.tokens_per_page)
        delta = need - have
        if delta <= 0:
            self.touch(request_id)
            return 0
        pages = self._take(delta * view.n_kv_layers)
        for layer, tab in enumerate(req.tables):
            tab.extend(pages[layer * delta:(layer + 1) * delta])
        req.rev = self._next_rev()
        self.touch(request_id)
        return len(pages)

    def commit_decode_block(self, request_id: int, n_committed: int) -> int:
        """Commit ``n_committed`` tokens of a reserved block and return
        the unused reserved pages — in reverse order, so the free list
        keeps handing out the lowest ids first.  Returns the count."""
        req = self.requests[request_id]
        view = self.views[req.model]
        req.tokens += n_committed
        if not view.n_kv_layers:
            self.touch(request_id)
            return 0
        keep = math.ceil(max(req.tokens, 1) / view.tokens_per_page)
        if len(req.tables[0]) <= keep:
            self.touch(request_id)
            return 0
        trimmed = 0
        for tab in req.tables:
            extra = tab[keep:]
            del tab[keep:]
            for p in reversed(extra):
                if p <= _SWAP_BASE:      # a reserved page swapped meanwhile
                    self.swap_free.append(_swap_decode(p))
                    req.n_swapped -= 1
                    self.swapped_now -= 1
                else:
                    self.free_list.append(p)
            trimmed += len(extra)
        self.unmap_events += trimmed
        req.rev = self._next_rev()
        self.touch(request_id)
        return trimmed

    def release_request(self, request_id: int) -> None:
        req = self.requests.pop(request_id)
        n = 0
        for _, _, page in req.device_entries():
            self.free_list.append(page)
            n += 1
        for _, _, slot in req.swapped_entries():
            self.swap_free.append(slot)
            self.swapped_now -= 1
            n += 1
        self.unmap_events += n

    # ------------------------------------------------------------------
    # elastic boundary: host swap tier + live resize (DESIGN.md §8)
    # ------------------------------------------------------------------
    def touch(self, request_id: int) -> None:
        """Mark a request recently used (swap victims are least-recent)."""
        self._touch_clock += 1
        self.requests[request_id].last_touch = self._touch_clock

    def _swap_slots(self, n: int) -> List[int]:
        """Take ``n`` host-tier slots, growing the swap buffer on demand
        (zero-padded, the old rows copied on the host)."""
        while len(self.swap_free) < n:
            old = 0 if self.swap_buffer is None else len(self.swap_buffer)
            cap = max(old * 2, n, 16)
            buf = torch.zeros((cap, self.page_elems), dtype=self.dtype,
                              pin_memory=self.device.type == "cuda")
            if self.swap_buffer is not None:
                buf[:old] = self.swap_buffer
            self.swap_buffer = buf
            self.swap_free.extend(range(cap - 1, old - 1, -1))
        return [self.swap_free.pop() for _ in range(n)]

    def _ids(self, ids: Sequence[int]) -> torch.Tensor:
        """Page ids as a tensor on the pool's device."""
        return torch.tensor(list(ids), dtype=torch.int64, device=self.device)

    def swap_out(self, request_id: int, max_pages: Optional[int] = None
                 ) -> int:
        """Move up to ``max_pages`` of a request's device pages to the host
        tier (coldest — lowest token chunks — first); returns the count.

        The freed device ids go straight back to the free list, the table
        entries take the swapped encoding and the request's revision
        bumps.  Page contents move with the page (one device gather, one
        synchronous copy to the host), so a later fault-in is bit for bit
        invisible to attention."""
        req = self.requests[request_id]
        victims: List[Tuple[List[int], int, int]] = []
        view = self.views[req.model]
        chunks = len(req.tables[0]) if req.tables else 0
        # chunk-major: the lowest (oldest-token) chunk of every layer goes
        # first, so partial swaps shed the coldest KV across layers evenly
        for c in range(chunks):
            for layer in range(view.n_kv_layers):
                p = req.tables[layer][c]
                if p >= 0:
                    victims.append((req.tables[layer], c, p))
        for i, p in enumerate(req.state_pages):
            if p >= 0:
                victims.append((req.state_pages, i, p))
        if max_pages is not None:
            victims = victims[:max_pages]
        if not victims:
            return 0
        slots = self._swap_slots(len(victims))
        if self.pool is not None:
            rows = _pool_row_gather(self.pool,
                                    self._ids(p for _, _, p in victims))
            self.swap_buffer.index_copy_(0, torch.tensor(slots), rows.cpu())
        for (tab, i, page), slot in zip(victims, slots):
            tab[i] = _swap_encode(slot)
            self.free_list.append(page)
        req.rev = self._next_rev()
        req.n_swapped += len(victims)
        self.swapped_now += len(victims)
        self.swap_out_pages += len(victims)
        return len(victims)

    def ensure_resident(self, request_id: int) -> int:
        """Fault a request's swapped pages back onto the device (the swap
        tier's "next touch"); returns how many were faulted.  Atomic: the
        device pages come from ONE ``_take``, so ``OutOfPagesError`` leaves
        the tables, the swap tier and the free list untouched.  Returns at
        once, with no device work, when nothing is swapped."""
        req = self.requests[request_id]
        if req.n_swapped == 0:
            return 0
        entries = list(req.swapped_entries())
        pages = self._take(len(entries))
        if self.pool is not None:
            rows = self.swap_buffer.index_select(
                0, torch.tensor([s for _, _, s in entries]))
            _pool_row_scatter(self.pool, self._ids(pages),
                              rows.to(self.device))
        for (tab, i, slot), page in zip(entries, pages):
            tab[i] = page
            self.swap_free.append(slot)
        req.rev = self._next_rev()
        req.n_swapped = 0
        self.swapped_now -= len(entries)
        self.swap_in_pages += len(entries)
        self.touch(request_id)
        return len(entries)

    def swap_out_idle(self, need: int, protected=()) -> int:
        """Free ``need`` device pages by swapping the coldest pages of the
        longest-idle requests (skipping ``protected`` ids); returns how
        many were actually freed."""
        freed = 0
        protected = set(protected)
        order = sorted(self.requests.values(), key=lambda r: r.last_touch)
        for req in order:
            if freed >= need:
                break
            if req.request_id in protected:
                continue
            freed += self.swap_out(req.request_id, need - freed)
        return freed

    def resize(self, new_budget: int, protected=()) -> Dict[str, int]:
        """Grow or shrink the pool to ``new_budget`` pages at a step
        boundary (reference ``virtualizer.py:791``).

        Growing copies the pool into the prefix of a larger, zero-padded
        tensor and puts the new ids at the FRONT of the free list.
        Shrinking swaps out the coldest pages of the longest-idle
        (non-``protected``) requests until the survivors fit, then
        compacts them into the retained prefix with ONE ``index_select``
        into a new tensor and remaps every table (all revisions bump; the
        batch-table cache drops).  Raises ``OutOfPagesError`` — with no
        state change beyond completed swaps — when the protected requests
        alone exceed the new budget.  On a card the device is
        synchronised first: the old pool's memory is freed here."""
        new_budget = int(new_budget)
        check(new_budget >= 1, f"page budget must be >= 1, got {new_budget}")
        old_budget = self.page_budget
        if new_budget == old_budget:
            return {"page_budget": old_budget, "swapped_out": 0, "moved": 0}
        if self.pool is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if new_budget > old_budget:
            if self.pool is not None:
                pad = torch.zeros((new_budget - old_budget, self.page_elems),
                                  dtype=self.pool.dtype, device=self.device)
                self.pool = torch.cat([self.pool, pad])
            # new ids go to the FRONT of the (pop-from-the-end) free list,
            # so existing low ids keep being preferred
            self.free_list = list(range(new_budget - 1, old_budget - 1, -1)) \
                + self.free_list
            self.page_budget = new_budget
            self.resizes += 1
            return {"page_budget": new_budget, "swapped_out": 0, "moved": 0}

        # --- shrink ----------------------------------------------------
        swapped = 0
        if self.mapped_pages > new_budget:
            swapped = self.swap_out_idle(self.mapped_pages - new_budget,
                                         protected)
        if self.mapped_pages > new_budget:
            raise OutOfPagesError(
                f"cannot shrink to {new_budget} pages: {self.mapped_pages} "
                f"still mapped after swapping {swapped} (protected "
                f"requests hold too many pages)")
        # compact survivors into [0, new_budget): requests by id, then
        # layer-major table order
        old_ids: List[int] = []
        mapping: Dict[int, int] = {}
        entries: List[Tuple[List[int], int, int]] = []
        for rid in sorted(self.requests):
            for tab, i, page in self.requests[rid].device_entries():
                entries.append((tab, i, page))
                if page not in mapping:
                    mapping[page] = len(old_ids)
                    old_ids.append(page)
        k = len(old_ids)
        if self.pool is not None:
            self.pool = _pool_row_gather(
                self.pool, self._ids(old_ids + [0] * (new_budget - k)))
        for tab, i, page in entries:
            tab[i] = mapping[page]
        for req in self.requests.values():
            req.rev = self._next_rev()
        self._batch_cache.clear()
        self.free_list = list(range(new_budget - 1, k - 1, -1))
        self.page_budget = new_budget
        self.resizes += 1
        return {"page_budget": new_budget, "swapped_out": swapped,
                "moved": k}

    # ------------------------------------------------------------------
    # fast path: device views
    # ------------------------------------------------------------------
    def _batch_entry(self, model: str,
                     request_ids: Sequence[Optional[int]],
                     max_pages: int) -> dict:
        """The cached [n_layers, B, max_pages] int32 host table of a batch
        of slots (``None`` slots map to all ``-1`` rows), cached per
        (model, slot assignment, max_pages): only the rows whose page
        mapping changed are rewritten, in place, and then the device copy
        is dropped.  Raises for a row with swapped pages: the kernels read
        any id < 0 as "no page", so a swapped entry in a table would drop
        KV silently."""
        view = self.views[model]
        for rid in request_ids:
            if rid is not None and rid in self.requests:
                check(self.requests[rid].n_swapped == 0,
                      f"request {rid} has swapped pages; call "
                      f"ensure_resident before building batch tables")
        key = (model,
               tuple(-1 if r is None else r for r in request_ids),
               max_pages)
        revs = tuple(
            -1 if rid is None or rid not in self.requests
            else self.requests[rid].rev
            for rid in request_ids)
        entry = self._batch_cache.get(key)
        if entry is not None and entry["revs"] == revs:
            return entry
        if entry is None:
            buf = np.full((view.n_kv_layers, len(request_ids), max_pages),
                          -1, np.int32)
            old_revs: tuple = (None,) * len(request_ids)
        else:
            buf, old_revs = entry["buf"], entry["revs"]
        for i, rid in enumerate(request_ids):
            if old_revs[i] == revs[i]:
                continue
            buf[:, i, :] = -1
            if rid is not None and rid in self.requests:
                for layer, tab in enumerate(self.requests[rid].tables):
                    m = min(len(tab), max_pages)
                    buf[layer, i, :m] = tab[:m]
        if len(self._batch_cache) > 64:     # bound stale slot assignments
            self._batch_cache.clear()
        entry = {"buf": buf, "revs": revs, "dev": None}
        self._batch_cache[key] = entry
        return entry

    def batch_tables_host(self, model: str,
                          request_ids: Sequence[Optional[int]],
                          max_pages: int) -> np.ndarray:
        """[n_layers, B, max_pages] int32 host table for a batch of slots
        (what a decode graph copies in).  Rewritten in place on later
        mapping changes: copy it before keeping it past the next call."""
        return self._batch_entry(model, request_ids, max_pages)["buf"]

    def batch_tables(self, model: str,
                     request_ids: Sequence[Optional[int]],
                     max_pages: int) -> torch.Tensor:
        """The device copy of ``batch_tables_host``, made again only when a
        row's page mapping changed."""
        entry = self._batch_entry(model, request_ids, max_pages)
        if entry["dev"] is None:
            # torch.tensor COPIES: torch.from_numpy aliases, and on the
            # CPU ``.to(device)`` would hand back that alias — but the host
            # table is mutated in place on later mapping changes, which
            # would corrupt tables already handed to earlier steps
            entry["dev"] = torch.tensor(entry["buf"], device=self.device)
        return entry["dev"]

    def _token_coords(self, req: RequestPages, view: ModelView,
                      tokens: np.ndarray, layer: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """(pages, slots) int32 arrays for token indices of one layer."""
        check(req.n_swapped == 0,
              f"request {req.request_id} has swapped pages; call "
              f"ensure_resident before writing KV")
        chunk = tokens // view.tokens_per_page
        slots = (tokens % view.tokens_per_page).astype(np.int32)
        tab = np.asarray(req.tables[layer], np.int32)
        return tab[chunk], slots

    def write_prompt_layer(self, pool: torch.Tensor, model: str,
                           request_id: int, layer: int, layer_kv,
                           n_tokens: int, batch_index: int = 0,
                           start: int = 0) -> torch.Tensor:
        """Store ONE layer's prompt KV from full-sequence attention
        outputs: ``(k, v)`` each ``[B,S,KV,hd]`` for GQA or ``(latent,
        rope)`` ``[B,S,·]`` for MLA, tokens ``[start, start + n_tokens)``
        of row ``batch_index``.  Writes into ``pool`` in place and
        returns it."""
        view = self.views[model]
        req = self.requests[request_id]
        a, b = layer_kv
        toks = np.arange(start, start + n_tokens)
        pages, slots = self._token_coords(req, view, toks, layer)
        return _pool_pair_scatter(
            pool, a, b, torch.from_numpy(pages).to(pool.device),
            torch.from_numpy(slots).to(pool.device), n_tokens=n_tokens,
            batch_index=batch_index, mla=len(view.kv_shape) == 1)

    # ------------------------------------------------------------------
    def utilization(self) -> Dict[str, float]:
        frag = 0.0
        for req in self.requests.values():
            view = self.views[req.model]
            if not view.n_kv_layers:
                continue
            used = req.tokens * view.per_token_elems * view.n_kv_layers
            held = sum(len(t) for t in req.tables) * self.page_elems
            frag += held - used
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        return {
            "mapped_pages": self.mapped_pages,
            "free_pages": self.free_pages,
            "peak_mapped": self.peak_mapped,
            "internal_frag_bytes": frag * itemsize,
            # elastic-boundary signals (DESIGN.md §8)
            "page_budget": self.page_budget,
            "occupancy": self.mapped_pages / max(self.page_budget, 1),
            "swapped_pages": self.swapped_now,
            "swap_out_pages": self.swap_out_pages,
            "swap_in_pages": self.swap_in_pages,
            "swap_tier_bytes": (0 if self.swap_buffer is None
                                else self.swap_buffer.numel() * itemsize),
            "resizes": self.resizes,
        }
