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

Not ported yet (they raise ``NotImplementedError``): the host swap tier
and ``resize`` (the elastic boundary, DESIGN.md §8) and prefix sharing.
Without a swap tier every mapped page is device-resident.
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


@dataclass
class RequestPages:
    """Per-request mapping: tables[layer][chunk] -> physical page id."""

    request_id: int
    model: str
    tokens: int = 0
    tables: List[List[int]] = field(default_factory=list)   # [layer][chunk]
    state_pages: List[int] = field(default_factory=list)    # SSM constant state
    # globally monotonic mapping revision: unique per registration AND per
    # page-mapping change, so a reused request id never aliases a stale
    # cached batch table
    rev: int = -1
    last_touch: int = 0

    def device_entries(self):
        """Yield (table, index, page) for every mapped entry."""
        for tab in self.tables:
            for i, p in enumerate(tab):
                yield tab, i, p
        for i, p in enumerate(self.state_pages):
            yield self.state_pages, i, p


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
        self._touch_clock = 0
        # stats
        self.peak_mapped = 0
        self.map_events = 0
        self.unmap_events = 0

    # ------------------------------------------------------------------
    # accounting
    # ------------------------------------------------------------------
    @property
    def mapped_pages(self) -> int:
        return self.page_budget - len(self.free_list)

    @property
    def free_pages(self) -> int:
        return len(self.free_list)

    def admission_deficit(self, model: str, prompt_tokens: int,
                          expected_output: int = 0) -> int:
        """Pages MISSING for this admission (0 = admissible)."""
        view = self.views[model]
        cfg = self.configs[model]
        need = view.pages_for(prompt_tokens + expected_output) \
            if view.n_kv_layers else 0
        need += math.ceil(cfg.state_bytes_per_request() / self.page_bytes)
        return max(need - self.free_pages, 0)

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
            self.free_list.extend(reversed(extra))
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
        self.unmap_events += n

    # ------------------------------------------------------------------
    # elastic boundary (not ported yet)
    # ------------------------------------------------------------------
    def touch(self, request_id: int) -> None:
        """Mark a request recently used."""
        self._touch_clock += 1
        self.requests[request_id].last_touch = self._touch_clock

    def ensure_resident(self, request_id: int) -> int:
        """Fault swapped pages back in; returns how many were faulted.
        The port has no swap tier yet, so every page is resident: 0."""
        check(request_id in self.requests, f"unknown request {request_id}")
        return 0

    def swap_out(self, request_id: int, max_pages: Optional[int] = None
                 ) -> int:
        raise NotImplementedError("the host swap tier is not ported yet")

    def resize(self, new_budget: int, protected=()) -> Dict[str, int]:
        raise NotImplementedError("elastic pool resize is not ported yet")

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
        is dropped."""
        view = self.views[model]
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
            "page_budget": self.page_budget,
            "occupancy": self.mapped_pages / max(self.page_budget, 1),
        }
