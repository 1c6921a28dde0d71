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

Prefix sharing (DESIGN.md §11): a page may have several holders — the
radix tree (``core/prefix_cache.py``) and every request that maps a
cached chunk read-only — counted in a sparse refcount dict (absent =
one holder); a page is freed only at refcount 0.  A request that forks
mid-chunk gets a private copy of the fork page in every layer
(``register_request_with_prefix``), so decode writes past the fork never
touch the shared original.  Tree pages shed to the swap tier as a second
chance (``swap_pages_out`` / ``fault_pages_in``), and the tree is the
``cache_provider`` that idle swap and compaction consult.
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
        # per-page holder counts of shared pages (prefix sharing): absent
        # = refcount 1, so the cache-off path never touches the dict
        self._refs: Dict[int, int] = {}
        # the prefix cache (``core.prefix_cache.PrefixCache``): it holds
        # device pages outside any request table, which idle swap and
        # compaction must see (``shed`` / ``device_pages`` / ``remap``)
        self.cache_provider = None
        # the observability sink (``core.hooks.CoreHooks``) or None; every
        # hook fires AFTER the stat counter beside it has been updated
        self.hooks = None

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
                  expected_output: int = 0, reserve: int = 0,
                  discount_pages: int = 0) -> bool:
        """``reserve`` pages are held back from admission: the elastic
        rebalancer's fault-in headroom for the swap tier.
        ``discount_pages``: the prefix cache's credit (see
        ``admission_deficit``)."""
        return self.admission_deficit(model, prompt_tokens, expected_output,
                                      reserve, discount_pages) == 0

    def admission_deficit(self, model: str, prompt_tokens: int,
                          expected_output: int = 0, reserve: int = 0,
                          discount_pages: int = 0) -> int:
        """Pages MISSING for this admission (0 = admissible), with
        ``reserve`` free pages held back.  ``discount_pages`` is the
        prefix cache's net credit: pages the request maps read-only from
        device-resident cached chunks instead of taking them from the
        free list (negative when a swapped copy-on-write source must be
        faulted in on top of the cold need)."""
        view = self.views[model]
        cfg = self.configs[model]
        need = view.pages_for(prompt_tokens + expected_output) \
            if view.n_kv_layers else 0
        need = max(need - discount_pages, 0)
        need += math.ceil(cfg.state_bytes_per_request() / self.page_bytes)
        return max(need - (self.free_pages - max(reserve, 0)), 0)

    # ------------------------------------------------------------------
    # per-page refcounts (prefix sharing, DESIGN.md §11)
    # ------------------------------------------------------------------
    def page_refs(self, page: int) -> int:
        return self._refs.get(page, 1)

    def retain_page(self, page: int) -> None:
        """Add one holder to a device page (the prefix tree or a sharing
        request); a page fresh from ``_take`` has an implicit count of 1."""
        check(page >= 0, f"cannot retain non-device entry {page}")
        self._refs[page] = self._refs.get(page, 1) + 1

    def _unref(self, page: int) -> bool:
        """Drop one holder; True when that was the last one (the caller
        returns the page to the free list)."""
        c = self._refs.get(page, 1) - 1
        if c == 0:
            self._refs.pop(page, None)
            return True
        if c == 1:
            self._refs.pop(page, None)    # back to the implicit sole owner
        else:
            self._refs[page] = c
        return False

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

    def register_request_with_prefix(
            self, request_id: int, model: str, prompt_tokens: int,
            shared_chunks: Sequence[Sequence[int]],
            cow_chunk: Optional[Sequence[int]] = None) -> RequestPages:
        """Map a request whose leading prompt chunks are cached
        (reference ``virtualizer.py:393``).

        ``shared_chunks[c][layer]``: device ids of cached FULL chunks,
        mapped read-only (one more holder each).  ``cow_chunk[layer]``:
        the fork chunk's source pages, copied into FRESH pages of every
        layer (copy-on-write: the request writes its suffix into its own
        copy, the cached original is never written).  Every id must be
        device-resident: the caller faults swapped chunks in first.
        Atomic like ``register_request``: all fresh pages come from ONE
        ``_take``, and retains and the copy happen only after it."""
        view = self.views[model]
        cfg = self.configs[model]
        L = view.n_kv_layers
        chunks = math.ceil(max(prompt_tokens, 1) / view.tokens_per_page) \
            if L else 0
        n_shared = len(shared_chunks)
        check(n_shared + (1 if cow_chunk is not None else 0) <= chunks,
              f"prefix covers {n_shared} shared chunks"
              f"{' + a copy-on-write chunk' if cow_chunk is not None else ''}"
              f" but the prompt only spans {chunks}")
        state_pages = math.ceil(cfg.state_bytes_per_request()
                                / self.page_bytes)
        fresh_per_layer = chunks - n_shared
        pages = self._take(fresh_per_layer * L + state_pages)
        req = RequestPages(request_id, model)
        for layer in range(L):
            fresh = pages[layer * fresh_per_layer:
                          (layer + 1) * fresh_per_layer]
            req.tables.append(
                [shared_chunks[c][layer] for c in range(n_shared)] + fresh)
        if state_pages:
            req.state_pages = pages[L * fresh_per_layer:]
        for c in range(n_shared):
            for layer in range(L):
                self.retain_page(shared_chunks[c][layer])
        if cow_chunk is not None:
            # chunk ``n_shared`` of every layer is the private fork copy:
            # one row gather + one row scatter, byte for byte
            srcs = [int(cow_chunk[layer]) for layer in range(L)]
            check(all(s >= 0 for s in srcs),
                  f"copy-on-write source chunk is not device-resident: "
                  f"{srcs}")
            if self.pool is not None:
                dsts = [req.tables[layer][n_shared] for layer in range(L)]
                _pool_row_scatter(self.pool, self._ids(dsts),
                                  _pool_row_gather(self.pool,
                                                   self._ids(srcs)))
        req.tokens = prompt_tokens
        req.rev = self._next_rev()
        self.requests[request_id] = req
        self.touch(request_id)
        return req

    def gather_prompt_rows(self, model: str, request_id: int,
                           n_tokens: int) -> torch.Tensor:
        """KV rows of tokens ``[0, n_tokens)`` of EVERY layer, read through
        the request's own page table: ``[n_kv_layers, n_tokens,
        *kv_shape]``, one gather (reference ``virtualizer.py:453``).
        Shared pages are read in place."""
        view = self.views[model]
        req = self.requests[request_id]
        check(req.n_swapped == 0,
              f"request {request_id} has swapped pages; call ensure_resident "
              f"before gathering prefix KV")
        toks = np.arange(n_tokens)
        chunk = toks // view.tokens_per_page
        pages = np.stack([np.asarray(req.tables[layer], np.int64)[chunk]
                          for layer in range(view.n_kv_layers)])
        slots = toks % view.tokens_per_page
        # the pool as [pages, tokens_per_page, per_token] (a view: each
        # page's slack elements are skipped, nothing is copied)
        typed = self.pool.as_strided(
            (self.page_budget, view.tokens_per_page, view.per_token_elems),
            (self.page_elems, view.per_token_elems, 1))
        out = typed[torch.from_numpy(pages).to(self.device),
                    torch.from_numpy(slots).to(self.device)[None, :]]
        return out.reshape((view.n_kv_layers, n_tokens) + view.kv_shape)

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
        if self.hooks is not None:
            self.hooks.kv_reserved(len(pages))
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
        if self.hooks is not None and trimmed:
            self.hooks.kv_trimmed(trimmed)
        return trimmed

    def release_request(self, request_id: int) -> None:
        req = self.requests.pop(request_id)
        n = 0
        for _, _, page in req.device_entries():
            # a shared page survives until its LAST holder (other sharing
            # requests or the prefix tree) lets go
            if self._unref(page):
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
                # a shared page never swaps through one of its requests:
                # the other holders (the tree, sharing requests) read it
                if p >= 0 and self.page_refs(p) == 1:
                    victims.append((req.tables[layer], c, p))
        for i, p in enumerate(req.state_pages):
            if p >= 0:
                victims.append((req.state_pages, i, p))
        if max_pages is not None:
            victims = victims[:max_pages]
        if not victims:
            return 0
        slots = self._to_swap([p for _, _, p in victims])
        for (tab, i, page), slot in zip(victims, slots):
            tab[i] = _swap_encode(slot)
            self.free_list.append(page)
        req.rev = self._next_rev()
        req.n_swapped += len(victims)
        self.swapped_now += len(victims)
        self.swap_out_pages += len(victims)
        if self.hooks is not None:
            self.hooks.kv_swap_out(len(victims))
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
        self._from_swap([s for _, _, s in entries], pages)
        for (tab, i, slot), page in zip(entries, pages):
            tab[i] = page
            self.swap_free.append(slot)
        req.rev = self._next_rev()
        req.n_swapped = 0
        self.swapped_now -= len(entries)
        self.swap_in_pages += len(entries)
        self.touch(request_id)
        if self.hooks is not None:
            self.hooks.kv_swap_in(len(entries))
        return len(entries)

    def _to_swap(self, pages: Sequence[int]) -> List[int]:
        """Copy device pages into fresh host-tier slots (one device
        gather, one synchronous copy to the host); returns the slots."""
        slots = self._swap_slots(len(pages))
        if self.pool is not None:
            rows = _pool_row_gather(self.pool, self._ids(pages))
            self.swap_buffer.index_copy_(0, torch.tensor(slots), rows.cpu())
        return slots

    def _from_swap(self, slots: Sequence[int], pages: Sequence[int]) -> None:
        """Copy host-tier slots back into device pages."""
        if self.pool is not None:
            rows = self.swap_buffer.index_select(0, torch.tensor(list(slots)))
            _pool_row_scatter(self.pool, self._ids(pages),
                              rows.to(self.device))

    def swap_pages_out(self, pages: Sequence[int]) -> List[int]:
        """Move table-less device pages (prefix-tree chunks) to the host
        tier; returns their swapped encodings in order (reference
        ``virtualizer.py:710``).  The caller holds every page ALONE
        (refcount 1, in no request table): the second-chance shed.
        Contents move with the page, so a later fault-in is bit-exact."""
        if not pages:
            return []
        check(all(p >= 0 and self.page_refs(p) == 1 for p in pages),
              f"swap_pages_out requires sole-owned device pages: "
              f"{list(pages)}")
        slots = self._to_swap(pages)
        self.free_list.extend(pages)
        self.swapped_now += len(pages)
        self.swap_out_pages += len(pages)
        if self.hooks is not None:
            self.hooks.kv_swap_out(len(pages))
        return [_swap_encode(s) for s in slots]

    def fault_pages_in(self, encoded: Sequence[int]) -> List[int]:
        """Fault host-tier pages back onto the device (a second-chance
        cache hit); returns the fresh device ids in order.  Atomic: ONE
        ``_take``, so ``OutOfPagesError`` leaves the swap tier intact."""
        if not encoded:
            return []
        check(all(e <= _SWAP_BASE for e in encoded),
              f"fault_pages_in takes swapped encodings only: "
              f"{list(encoded)}")
        slots = [_swap_decode(e) for e in encoded]
        pages = self._take(len(slots))
        self._from_swap(slots, pages)
        self.swap_free.extend(slots)
        self.swapped_now -= len(slots)
        self.swap_in_pages += len(slots)
        if self.hooks is not None:
            self.hooks.kv_swap_in(len(slots))
        return pages

    def release_cached_page(self, entry: int) -> bool:
        """Drop the prefix tree's hold on one entry (a device id or a
        swapped encoding); True when a DEVICE page was freed."""
        if entry <= _SWAP_BASE:
            self.swap_free.append(_swap_decode(entry))
            self.swapped_now -= 1
            return False
        if self._unref(entry):
            self.free_list.append(entry)
            self.unmap_events += 1
            return True
        return False

    def swap_out_idle(self, need: int, protected=()) -> int:
        """Free ``need`` device pages by swapping the coldest pages of the
        longest-idle requests (skipping ``protected`` ids); returns how
        many were actually freed.  The prefix cache sheds FIRST: its
        refcount-1 LRU chunks hold no work in flight."""
        freed = 0
        if self.cache_provider is not None and need > 0:
            freed = self.cache_provider.shed(need)
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
            if self.hooks is not None:
                self.hooks.kv_resize(old_budget, new_budget, 0, 0)
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
        # layer-major table order, then tree-held pages in no table; a
        # shared page moves ONCE (one new id for all its holders)
        old_ids: List[int] = []
        mapping: Dict[int, int] = {}
        entries: List[Tuple[List[int], int, int]] = []
        for rid in sorted(self.requests):
            for tab, i, page in self.requests[rid].device_entries():
                entries.append((tab, i, page))
                if page not in mapping:
                    mapping[page] = len(old_ids)
                    old_ids.append(page)
        if self.cache_provider is not None:
            for page in self.cache_provider.device_pages():
                if page not in mapping:
                    mapping[page] = len(old_ids)
                    old_ids.append(page)
        k = len(old_ids)
        if self.pool is not None:
            self.pool = _pool_row_gather(
                self.pool, self._ids(old_ids + [0] * (new_budget - k)))
        for tab, i, page in entries:
            tab[i] = mapping[page]
        self._refs = {mapping[p]: c for p, c in self._refs.items()
                      if p in mapping}
        if self.cache_provider is not None:
            self.cache_provider.remap(mapping)
        for req in self.requests.values():
            req.rev = self._next_rev()
        self._batch_cache.clear()
        self.free_list = list(range(new_budget - 1, k - 1, -1))
        self.page_budget = new_budget
        self.resizes += 1
        if self.hooks is not None:
            self.hooks.kv_resize(old_budget, new_budget, swapped, k)
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
    def accounting_snapshot(self) -> Dict[str, int]:
        """Integer holder-class partition of the page budget (reference
        ``virtualizer.py:1048``), with the refcount summary: pages with
        more than one holder and their total holder count."""
        live = set()
        for req in self.requests.values():
            for _, _, page in req.device_entries():
                live.add(page)
        return {
            "page_budget": self.page_budget,
            "free_pages": self.free_pages,
            "mapped_pages": self.mapped_pages,
            "request_pages": len(live),
            "swapped_now": self.swapped_now,
            "peak_mapped": self.peak_mapped,
            "swap_out_pages": self.swap_out_pages,
            "swap_in_pages": self.swap_in_pages,
            "resizes": self.resizes,
            "shared_pages": sum(1 for c in self._refs.values() if c > 1),
            "ref_total": sum(self._refs.values()),
        }

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
