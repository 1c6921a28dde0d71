"""Radix-tree prefix cache over the shared KV pool (DESIGN.md §11).

Port of ``src/repro/core/prefix_cache.py``.  Committed prompt KV stays
in the tree after the producing request finishes, keyed by token
content, and a later request with the same prefix maps those pages
READ-ONLY instead of prefilling them again.

Layout:

  * one trie per ``(model, prefill bucket)``: the bucket fixes the
    prefill pass's shapes (the attention's reduction extent and the MoE
    expert capacity), so only a same-bucket consumer reproduces the
    producer's prefix KV and routing;
  * a node is exactly ``tokens_per_page`` tokens (one chunk: the same
    page of every layer), keyed by its token tuple, and carries PARTIAL
    tail leaves (< ``tokens_per_page`` tokens) for prompts that end
    mid-page.  A node holds its per-layer page ids, the captured MoE
    routing of its tokens (consumers rebuild the full pass's expert-slot
    offsets from it) and an LRU stamp;
  * sharing is by refcount: ``insert`` retains the producing request's
    pages, a consumer retains full chunks read-only and copies the fork
    chunk (``KVVirtualizer.register_request_with_prefix``), and a page
    is freed only at refcount 0;
  * eviction is LRU by leaf.  With ``second_chance`` a shed chunk's pages
    move to the host swap tier instead of being dropped, and a later
    match faults them back bit for bit (``fault_chunks``).

Each counter below has its observability hook (``core/hooks.py``)
beside it: ``cache_hit`` / ``cache_miss`` per cache-eligible admission,
``cache_evict`` per shed or evicted chunk, ``cache_fault`` per
second-chance fault, each after the counter moved.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import CacheConfig
from repro_torch.core.errors import check
from repro_torch.core.virtualizer import _SWAP_BASE, KVVirtualizer


@dataclass
class _Chunk:
    """One radix-tree node: a page-granular run of prompt tokens."""

    tokens: Tuple[int, ...]
    pages: List[int] = field(default_factory=list)   # [layer] id / swap-enc
    routes: Optional[np.ndarray] = None              # [n_tokens, L, k] int32
    children: Dict[Tuple[int, ...], "_Chunk"] = field(default_factory=dict)
    partials: List["_Chunk"] = field(default_factory=list)
    parent: Optional["_Chunk"] = None
    last_touch: int = 0

    @property
    def n_tokens(self) -> int:
        return len(self.tokens)

    @property
    def swapped(self) -> bool:
        return bool(self.pages) and self.pages[0] <= _SWAP_BASE

    @property
    def is_leaf(self) -> bool:
        return not self.children and not self.partials


def _lcp(a: Sequence[int], b: Sequence[int]) -> int:
    """Length of the longest common prefix of two token sequences."""
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n


class PrefixCache:
    """The engine's prefix index; it registers itself as the
    virtualizer's ``cache_provider`` so compaction and idle swap see the
    pages it holds."""

    def __init__(self, virt: KVVirtualizer, cfg: Optional[CacheConfig] = None,
                 models: Optional[Sequence[str]] = None):
        self.virt = virt
        self.cfg = cfg or CacheConfig()
        # cacheable = the split-execution models (their prompt KV lives in
        # pool pages); the fallback families always miss
        self.models = set(models if models is not None else virt.views)
        self._roots: Dict[Tuple[str, int], _Chunk] = {}
        # device page ids the tree holds, in lockstep with node.pages
        self._device_pages: set = set()
        self._clock = 0
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0
        self.prompt_tokens_seen = 0
        self.inserted_chunks = 0
        self.evicted_pages = 0
        self.shed_pages = 0
        self.faulted_pages = 0
        # the observability sink (``core.hooks.CoreHooks``) or None
        self.hooks = None
        virt.cache_provider = self

    # ------------------------------------------------------------------
    # the provider protocol (KVVirtualizer.cache_provider)
    # ------------------------------------------------------------------
    def device_pages(self) -> List[int]:
        """Tree-held device page ids, in a deterministic order."""
        return sorted(self._device_pages)

    def remap(self, mapping: Dict[int, int]) -> None:
        """Apply a compaction's old -> new page numbering."""
        for node in self._walk():
            node.pages = [mapping[p] if p >= 0 else p for p in node.pages]
        self._device_pages = {mapping[p] for p in self._device_pages}

    def _retire(self, node: _Chunk) -> bool:
        """Shed one chunk no live request maps: its pages go to the swap
        tier (second chance) or, for a leaf, out of the tree.  Returns
        False when the chunk was left alone (an interior chunk without
        the second chance)."""
        n = len(node.pages)
        if self.cfg.second_chance:
            self._device_pages.difference_update(node.pages)
            node.pages = self.virt.swap_pages_out(node.pages)
            self.shed_pages += n
        elif node.is_leaf:
            self._drop_node(node)
            self.evicted_pages += n
        else:
            return False
        if self.hooks is not None:
            self.hooks.cache_evict(n)
        return True

    def _sheddable(self, node: _Chunk) -> bool:
        return (bool(node.pages) and not node.swapped
                and all(self.virt.page_refs(p) == 1 for p in node.pages))

    def shed(self, need: int) -> int:
        """Free ``need`` device pages by retiring LRU leaves first, then
        older interior chunks, skipping any chunk a live request still
        maps.  Returns pages freed."""
        freed = 0
        for node in self._lru_candidates():
            if freed >= need:
                break
            if not self._sheddable(node):
                continue
            n = len(node.pages)
            if self._retire(node):
                freed += n
        return freed

    # ------------------------------------------------------------------
    # match / fault / insert / evict
    # ------------------------------------------------------------------
    def match_prefix(self, model: str, bucket: int, ids: np.ndarray
                     ) -> Tuple[int, List[_Chunk]]:
        """Longest cached prefix of ``ids`` under ``(model, bucket)``:
        (matched token count, the chunks covering it in order).  The last
        chunk may cover the match only partly (its page is the consumer's
        copy-on-write source).  Swapped chunks are NOT faulted here: the
        caller decides after its budget check."""
        root = self._roots.get((model, bucket))
        if root is None or model not in self.models:
            return 0, []
        tpp = self.virt.views[model].tokens_per_page
        ids = [int(t) for t in np.asarray(ids).reshape(-1)]
        node, matched, out = root, 0, []
        while len(ids) - matched >= tpp:
            child = node.children.get(tuple(ids[matched:matched + tpp]))
            if child is None:
                break
            out.append(child)
            matched += tpp
            self._touch(child)
            node = child
        # the best partial continuation: an exact-prefix partial tail OR
        # the leading slots of a diverging full chunk (both CoW sources)
        rest = ids[matched:matched + tpp]
        best, best_node = 0, None
        for key, child in node.children.items():
            n = _lcp(key, rest)
            if n > best:
                best, best_node = n, child
        for p in node.partials:
            n = _lcp(p.tokens, rest)
            if n > best:
                best, best_node = n, p
        if best_node is not None:
            out.append(best_node)
            matched += best
            self._touch(best_node)
        return matched, out

    def fault_chunks(self, chunks: Sequence[_Chunk]) -> int:
        """Fault swapped chunks' pages back onto the device (the
        second-chance hit); returns pages faulted.  Atomic per chunk."""
        n = 0
        for node in chunks:
            if not node.swapped:
                continue
            node.pages = self.virt.fault_pages_in(node.pages)
            self._device_pages.update(node.pages)
            n += len(node.pages)
        if n:
            self.faulted_pages += n
            if self.hooks is not None:
                self.hooks.cache_fault(n)
        return n

    def record_admission(self, model: str, prompt_tokens: int,
                         cached_tokens: int) -> None:
        """Count one cache-eligible admission (after its registration
        succeeded, so a queued retry never counts twice)."""
        self.prompt_tokens_seen += prompt_tokens
        if cached_tokens > 0:
            self.hits += 1
            self.hit_tokens += cached_tokens
            if self.hooks is not None:
                self.hooks.cache_hit(model, cached_tokens)
        else:
            self.misses += 1
            if self.hooks is not None:
                self.hooks.cache_miss(model)

    def _new_node(self, parent: _Chunk, tokens: Tuple[int, ...],
                  pages: Sequence[int], routes) -> _Chunk:
        node = _Chunk(tokens=tokens, pages=list(pages), routes=routes,
                      parent=parent)
        for p in node.pages:
            self.virt.retain_page(p)
        self._device_pages.update(node.pages)
        return node

    def insert(self, model: str, bucket: int, ids: np.ndarray,
               chunk_pages: Sequence[Sequence[int]],
               routes: Optional[np.ndarray] = None) -> int:
        """Index a committed prompt: walk or create full-chunk nodes over
        ``ids`` and retain the producing request's pages for every NEW
        node.  ``chunk_pages[c][layer]`` is the request's table entry of
        chunk ``c``; ``routes`` the captured per-token MoE routing
        ``[len(ids), L, k]`` (None for a dense model).

        A sub-page tail becomes a partial leaf: it replaces an existing
        partial that is a strict prefix of it, is skipped when an
        existing partial covers it, and sits beside diverging ones.
        Returns the number of chunks created."""
        if model not in self.models or len(ids) == 0:
            return 0
        tpp = self.virt.views[model].tokens_per_page
        ids = [int(t) for t in np.asarray(ids).reshape(-1)]
        root = self._roots.setdefault((model, bucket), _Chunk(tokens=()))
        n_full, rem = len(ids) // tpp, len(ids) % tpp

        def routes_of(lo: int, hi: Optional[int]):
            return None if routes is None else np.asarray(routes[lo:hi])

        node, created, path = root, 0, []
        for c in range(n_full):
            key = tuple(ids[c * tpp:(c + 1) * tpp])
            child = node.children.get(key)
            if child is None:
                child = self._new_node(node, key, chunk_pages[c],
                                       routes_of(c * tpp, (c + 1) * tpp))
                node.children[key] = child
                created += 1
            self._touch(child)
            path.append(child)
            node = child
        if rem:
            tail = tuple(ids[n_full * tpp:])
            covered = next((p for p in node.partials
                            if p.n_tokens >= rem and p.tokens[:rem] == tail),
                           None)
            if covered is None:
                # superset wins: drop every partial this tail extends (its
                # pages stay with their live holders)
                for p in list(node.partials):
                    if p.n_tokens < rem and tail[:p.n_tokens] == p.tokens:
                        self._release_node_pages(p)
                        node.partials.remove(p)
                covered = self._new_node(node, tail, chunk_pages[n_full],
                                         routes_of(n_full * tpp, None))
                node.partials.append(covered)
                created += 1
            self._touch(covered)
            path.append(covered)
        self.inserted_chunks += created
        self._enforce_cap(protect=set(id(n) for n in path))
        return created

    def evict(self, need_pages: int, protect: Optional[set] = None) -> int:
        """Drop LRU leaves outright until ``need_pages`` device pages left
        the tree's hold (a page a live request still maps survives with
        it).  Returns pages released."""
        protect = protect or set()
        dropped = 0
        progress = True
        while dropped < need_pages and progress:
            progress = False
            for node in self._lru_candidates(leaves_only=True):
                if dropped >= need_pages:
                    break
                if id(node) in protect:
                    continue
                n_dev = sum(1 for p in node.pages if p >= 0)
                self._drop_node(node)
                dropped += n_dev
                self.evicted_pages += n_dev
                if n_dev and self.hooks is not None:
                    self.hooks.cache_evict(n_dev)
                progress = True
        return dropped

    # ------------------------------------------------------------------
    @property
    def device_pages_held(self) -> int:
        return len(self._device_pages)

    def snapshot(self) -> Dict[str, float]:
        return {
            "hits": float(self.hits),
            "misses": float(self.misses),
            "hit_tokens": float(self.hit_tokens),
            "prompt_tokens_seen": float(self.prompt_tokens_seen),
            "hit_token_fraction": (
                self.hit_tokens / self.prompt_tokens_seen
                if self.prompt_tokens_seen else 0.0),
            "inserted_chunks": float(self.inserted_chunks),
            "device_pages_held": float(self.device_pages_held),
            "evicted_pages": float(self.evicted_pages),
            "shed_pages": float(self.shed_pages),
            "faulted_pages": float(self.faulted_pages),
        }

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------
    def _touch(self, node: _Chunk) -> None:
        self._clock += 1
        node.last_touch = self._clock

    def _walk(self) -> List[_Chunk]:
        out: List[_Chunk] = []
        stack = list(self._roots.values())
        while stack:
            n = stack.pop()
            if n.tokens:
                out.append(n)
            stack.extend(n.children.values())
            stack.extend(n.partials)
        return out

    def _lru_candidates(self, leaves_only: bool = False) -> List[_Chunk]:
        """Chunks in retirement order: LRU leaves first, then LRU interior
        chunks (an interior chunk goes only after everything below it)."""
        nodes = self._walk()
        leaves = sorted((n for n in nodes if n.is_leaf),
                        key=lambda n: n.last_touch)
        if leaves_only:
            return leaves
        inner = sorted((n for n in nodes if not n.is_leaf),
                       key=lambda n: n.last_touch)
        return leaves + inner

    def _release_node_pages(self, node: _Chunk) -> None:
        for p in node.pages:
            if p >= 0:
                self._device_pages.discard(p)
            self.virt.release_cached_page(p)
        node.pages = []

    def _drop_node(self, node: _Chunk) -> None:
        """Remove a LEAF from the tree, releasing its page holds."""
        check(node.is_leaf, "only leaves are evictable")
        self._release_node_pages(node)
        parent = node.parent
        if parent is not None:
            parent.children.pop(node.tokens, None)
            if node in parent.partials:
                parent.partials.remove(node)

    def _enforce_cap(self, protect: set) -> None:
        """Keep the tree's DEVICE pages under ``max_pages_fraction`` of the
        live page budget: shed (second chance) or evict LRU chunks, never
        the path just inserted."""
        cap = int(self.cfg.max_pages_fraction * self.virt.page_budget)
        guard = 0
        while self.device_pages_held > cap and guard < 10_000:
            guard += 1
            before = self.device_pages_held
            for node in self._lru_candidates():
                if self.device_pages_held <= cap:
                    break
                if id(node) not in protect and self._sheddable(node):
                    self._retire(node)
            if self.device_pages_held == before:
                break           # everything left is shared or protected
