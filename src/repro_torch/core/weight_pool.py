"""Weights-pool virtualizer: an expert-slab arena for cold models' FFN.

Port of ``src/repro/core/weight_pool.py`` (DESIGN.md §5-6).  Device
FFN/MoE bytes of every colocated model come out of ONE pre-allocated
uint8 arena ``[slot_budget, slab_bytes]``:

  * every model's FFN tree is cut into per-layer slab units — one unit
    per expert plus one "rest" unit per layer (router, or the whole dense
    MLP) — and packed into HOST master slabs with ``Tensor.view(uint8)``:
    the same bytes ``build_view_and_slabs`` packs, kept in pinned memory
    when the arena lives on a card;
  * ``activate`` / ``evict`` move slab ids between the free list and
    per-model slot tables, atomically (victims planned first, one take);
  * ``unpack_layer`` is one ``index_select`` of a layer's slab rows, then
    slices and ``Tensor.view(dtype)`` bitcasts — bit-for-bit the packed
    host bytes;
  * uploads copy host slabs into the arena IN PLACE (the reference
    donates and rebinds).  On a card they run on a side stream: each
    layer's copy records an event and that layer's FFN waits on it (on
    whichever stream runs the FFN), so the FFN reads the arena only after
    its slabs have landed (DESIGN.md §6) while the copy overlaps the
    attention issued before it;
  * each model's device slot table is ONE tensor of fixed shape,
    refreshed in place when an activation or a compaction maps new slabs,
    so a captured decode step keeps a valid address across evict,
    re-activate and resize;
  * ``resize`` moves the arena's slot budget at a step boundary (the
    elastic boundary, DESIGN.md §8): a grow copies the arena into a
    larger zero-padded tensor, a shrink evicts idle models LRU and
    compacts the survivors with one ``index_select``.  Either way the
    arena tensor is a new one, so a decode graph captured over the old
    one must be captured again (``core/control.py``).
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.errors import check
from repro_torch.models.moe import EXPERT_STACKED_LEAVES

#: Slab granularity of the weights arena (1 MiB).
DEFAULT_SLAB_BYTES = 1 << 20


class OutOfSlabsError(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# Static layout: how one model's FFN tree maps onto slabs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LeafSpec:
    """One weight tensor inside a slab unit."""

    path: Tuple[str, ...]          # e.g. ("moe", "wg") / ("mlp", "wd")
    dtype: torch.dtype
    shape: Tuple[int, ...]         # per-unit shape (no layer/expert axes)
    offset: int                    # byte offset inside the unit
    nbytes: int


@dataclass(frozen=True)
class UnitSpec:
    """A fixed-size allocation unit: one expert, or one layer's rest."""

    kind: str                      # "expert" | "rest"
    count: int                     # units of this kind per layer (E or 1)
    leaves: Tuple[LeafSpec, ...]
    unit_bytes: int
    slabs_per_unit: int
    slab_offset: int               # first slab of this kind in a layer row


def _leaf_paths(tree: Dict, prefix: Tuple[str, ...] = ()
                ) -> List[Tuple[Tuple[str, ...], torch.Tensor]]:
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.extend(_leaf_paths(v, prefix + (k,)))
        else:
            out.append((prefix + (k,), v))
    return out


def _is_expert_leaf(path: Tuple[str, ...], cfg: ModelConfig) -> bool:
    """Leaves stacked over the expert axis: moe/{wg,wu,wd} [L,E,...]."""
    return (cfg.is_moe and len(path) == 2 and path[0] == "moe"
            and path[1] in EXPERT_STACKED_LEAVES)


def _build_specs(kind: str, leaves, count: int, per_unit_axes: int,
                 slab_bytes: int, slab_offset: int) -> Optional[UnitSpec]:
    """Lay ``leaves`` out back-to-back inside one unit; ``per_unit_axes``
    leading axes (layer, expert) are stripped from each stacked shape."""
    if not leaves:
        return None
    specs, off = [], 0
    for path, arr in leaves:
        shape = tuple(arr.shape[per_unit_axes:])
        nbytes = math.prod(shape) * arr.element_size()
        specs.append(LeafSpec(path, arr.dtype, shape, off, nbytes))
        off += nbytes
    return UnitSpec(kind, count, tuple(specs), off,
                    max(1, math.ceil(off / slab_bytes)), slab_offset)


@dataclass
class ModelArenaView:
    """Static slab geometry of one model + the unpacker."""

    name: str
    n_layers: int
    units: Tuple[UnitSpec, ...]
    slabs_per_layer: int
    slab_bytes: int

    @property
    def total_slabs(self) -> int:
        return self.n_layers * self.slabs_per_layer

    def unpack_layer(self, arena: torch.Tensor, row: torch.Tensor,
                     kind: Optional[str] = None) -> Dict:
        """Rebuild one layer's FFN param tree from the arena.

        ``arena``: [slot_budget, slab_bytes] uint8; ``row``:
        [slabs_per_layer] slab ids.  ONE ``index_select`` for the whole
        layer, then slices and ``view(dtype)`` bitcasts (views, no further
        copies).  A leaf's byte offset is a multiple of its itemsize by
        construction, which ``view(dtype)`` requires.  ``kind`` ("rest"
        or "expert") gathers that unit's slabs only: the prefix cache's
        route capture reads the router without the experts.
        """
        if kind is None:
            rows = arena.index_select(0, row.long())   # [slabs_per_layer, .]
        out: Dict = {}
        for u in self.units:
            if kind is not None and u.kind != kind:
                continue
            span = slice(u.slab_offset,
                         u.slab_offset + u.count * u.slabs_per_unit)
            chunk = (rows[span] if kind is None
                     else arena.index_select(0, row[span].long()))
            chunk = chunk.view(u.count, u.slabs_per_unit * self.slab_bytes)
            for leaf in u.leaves:
                val = chunk[:, leaf.offset:leaf.offset + leaf.nbytes] \
                    .view(leaf.dtype)
                # expert units keep their stacked [E, ...] axis; rest units
                # are per-layer tensors with no unit axis
                val = val.reshape(((u.count,) if u.kind == "expert" else ())
                                  + leaf.shape)
                dst = out
                for k in leaf.path[:-1]:
                    dst = dst.setdefault(k, {})
                dst[leaf.path[-1]] = val
        return out


def build_view_and_slabs(name: str, cfg: ModelConfig, w_tree: Dict, *,
                         slab_bytes: int, pin_memory: bool = False
                         ) -> Tuple[ModelArenaView, torch.Tensor]:
    """Decompose a split FFN tree into (static view, packed host slabs).

    ``w_tree`` is ``split_exec.split_params``' weights-pool half with
    layer-stacked leaves (on any device).  Returns the view plus the
    packed HOST master ``[n_layers, slabs_per_layer, slab_bytes]`` uint8
    — byte for byte what the reference packs from the same values.
    """
    layer_leaves = _leaf_paths(w_tree["layers"])
    n_layers = layer_leaves[0][1].shape[0]
    expert = [(p, a) for p, a in layer_leaves if _is_expert_leaf(p, cfg)]
    rest = [(p, a) for p, a in layer_leaves if not _is_expert_leaf(p, cfg)]

    units: List[UnitSpec] = []
    off = 0
    eu = _build_specs("expert", expert, cfg.n_experts, 2, slab_bytes, off)
    if eu is not None:
        units.append(eu)
        off += eu.count * eu.slabs_per_unit
    ru = _build_specs("rest", rest, 1, 1, slab_bytes, off)
    if ru is not None:
        units.append(ru)
        off += ru.slabs_per_unit
    view = ModelArenaView(name, n_layers, tuple(units), off, slab_bytes)

    slabs = torch.zeros((n_layers, view.slabs_per_layer, slab_bytes),
                        dtype=torch.uint8, pin_memory=pin_memory)
    by_path = dict(layer_leaves)
    for u in view.units:
        span = slabs[:, u.slab_offset:
                     u.slab_offset + u.count * u.slabs_per_unit]
        # a view (never a copy), so the writes below land in ``slabs``
        span = span.view(n_layers, u.count, u.slabs_per_unit * slab_bytes)
        for leaf in u.leaves:
            arr = by_path[leaf.path].contiguous()
            # [L, count, unit_elems * itemsize] raw bytes of this leaf
            raw = arr.reshape(n_layers, u.count, -1).view(torch.uint8)
            span[:, :, leaf.offset:leaf.offset + leaf.nbytes].copy_(raw)
    return view, slabs


# ---------------------------------------------------------------------------
# Analytic accounting (planner — no weights needed)
# ---------------------------------------------------------------------------

def _cfg_itemsize(cfg: ModelConfig) -> int:
    return 4 if cfg.dtype == "float32" else 2


def slabs_for_config(cfg: ModelConfig, slab_bytes: int = DEFAULT_SLAB_BYTES
                     ) -> int:
    """Arena slabs a fully resident model needs, from the config alone
    (the geometry of ``build_view_and_slabs``: per layer, E expert units
    of 3 matrices + one rest unit, or the whole dense MLP)."""
    d, isz = cfg.d_model, _cfg_itemsize(cfg)
    n_mats = 3 if cfg.mlp_kind == "swiglu" else 2
    if cfg.is_moe:
        expert_bytes = 3 * d * cfg.d_ff * isz
        rest_bytes = d * cfg.n_experts * 4                 # f32 router
        if cfg.n_shared_experts:
            rest_bytes += 3 * d * cfg.n_shared_experts * cfg.d_ff * isz
        per_layer = (cfg.n_experts * math.ceil(expert_bytes / slab_bytes)
                     + math.ceil(rest_bytes / slab_bytes))
    else:
        per_layer = math.ceil(n_mats * d * cfg.d_ff * isz / slab_bytes)
    return cfg.n_layers * per_layer


def static_ffn_bytes(cfg: ModelConfig) -> int:
    """Per-model-static baseline: the model's full FFN bytes resident."""
    return cfg.param_counts()["ffn"] * _cfg_itemsize(cfg)


# ---------------------------------------------------------------------------
# The arena
# ---------------------------------------------------------------------------

@dataclass
class Residency:
    """One resident model's mapping into the arena."""

    slots: np.ndarray              # [n_layers, slabs_per_layer] int32
    uploaded: np.ndarray           # [n_layers] bool (per-layer streaming)
    last_used: int = 0             # LRU clock tick
    rev: int = -1                  # bumped per activation (table cache key)


def _runs(ids: np.ndarray) -> List[Tuple[int, int, int]]:
    """Maximal runs of consecutive ids: (first id, source index, length)."""
    out = []
    start = 0
    for i in range(1, len(ids) + 1):
        if i == len(ids) or ids[i] != ids[i - 1] + 1:
            out.append((int(ids[start]), start, i - start))
            start = i
    return out


class WeightArena:
    """Host-side slab allocator over one device-resident weights arena."""

    def __init__(self, *, slab_bytes: int = DEFAULT_SLAB_BYTES,
                 device="cuda"):
        self.slab_bytes = slab_bytes
        self.device = torch.device(device)
        self.slot_budget = 0
        self.arena: Optional[torch.Tensor] = None
        self.free_list: List[int] = []
        self.views: Dict[str, ModelArenaView] = {}
        self.host_slabs: Dict[str, torch.Tensor] = {}
        self.residency: Dict[str, Residency] = {}
        self.pins: Dict[str, int] = {}
        self._clock = 0
        self._rev_counter = 0
        # per model: the static device slot table and the activation rev
        # its contents were copied from
        self._tables: Dict[str, torch.Tensor] = {}
        self._table_rev: Dict[str, int] = {}
        # uploads run on a side stream on a card; (model, layer) -> the
        # event its FFN waits on before reading the arena
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        self._pending: Dict[Tuple[str, int], torch.cuda.Event] = {}
        # stats
        self.activations = 0
        self.evictions = 0
        self.layer_uploads = 0
        self.resizes = 0
        # the observability sink (``core.hooks.CoreHooks``) or None; every
        # hook fires AFTER the stat counter beside it has been updated
        self.hooks = None

    # ------------------------------------------------------------------
    # registration / allocation
    # ------------------------------------------------------------------
    def add_model(self, name: str, cfg: ModelConfig, w_tree: Dict) -> None:
        """Register a cold model: pack its host master slabs and build the
        static view.  No device memory is touched."""
        view, slabs = build_view_and_slabs(
            name, cfg, w_tree, slab_bytes=self.slab_bytes,
            pin_memory=self._copy_stream is not None)
        self.views[name] = view
        self.host_slabs[name] = slabs

    def finalize(self, slot_budget: Optional[int] = None, *,
                 allocate: bool = True) -> None:
        """Fix the budget (default: every registered model resident) and
        allocate the device arena."""
        if slot_budget is None:
            slot_budget = max(
                sum(v.total_slabs for v in self.views.values()), 1)
        self.slot_budget = slot_budget
        self.free_list = list(range(slot_budget - 1, -1, -1))
        if allocate:
            self.arena = torch.zeros((slot_budget, self.slab_bytes),
                                     dtype=torch.uint8, device=self.device)

    # ------------------------------------------------------------------
    # accounting
    # ------------------------------------------------------------------
    @property
    def free_slabs(self) -> int:
        return len(self.free_list)

    @property
    def resident_slabs(self) -> int:
        return self.slot_budget - len(self.free_list)

    def device_bytes(self) -> int:
        """Device FFN bytes: fixed by ``slot_budget`` alone."""
        return self.slot_budget * self.slab_bytes

    def is_resident(self, name: str) -> bool:
        return name in self.residency

    def pinned_slabs(self) -> int:
        """Slabs the elastic rebalancer can never reclaim: every pinned
        model's full footprint, resident or promised (admission pins a
        cold model before its activation maps slots)."""
        return sum(self.views[n].total_slabs
                   for n in self.pins if n in self.views)

    def min_slot_budget(self) -> int:
        """Smallest budget a shrink may target: the pinned footprints, and
        never below the largest registered model (a smaller arena could
        never serve that model)."""
        largest = max((v.total_slabs for v in self.views.values()),
                      default=1)
        return max(self.pinned_slabs(), largest, 1)

    def residency_by_model(self) -> Dict[str, int]:
        """Resident slab count per model."""
        return {name: int(res.slots.size)
                for name, res in self.residency.items()}

    def utilization(self) -> Dict[str, float]:
        return {
            "slot_budget": self.slot_budget,
            "resident_slabs": self.resident_slabs,
            "free_slabs": self.free_slabs,
            "resident_models": len(self.residency),
            "activations": self.activations,
            "evictions": self.evictions,
            "layer_uploads": self.layer_uploads,
            "device_bytes": self.device_bytes(),
            "occupancy": self.resident_slabs / max(self.slot_budget, 1),
            "pinned_slabs": self.pinned_slabs(),
            "resizes": self.resizes,
        }

    # ------------------------------------------------------------------
    # slow path: activate / evict (atomic)
    # ------------------------------------------------------------------
    def _next_rev(self) -> int:
        self._rev_counter += 1
        return self._rev_counter

    def touch(self, name: str) -> None:
        if name in self.residency:
            self._clock += 1
            self.residency[name].last_used = self._clock

    def pin(self, name: str) -> None:
        self.pins[name] = self.pins.get(name, 0) + 1

    def unpin(self, name: str) -> None:
        n = self.pins.get(name, 0) - 1
        if n <= 0:
            self.pins.pop(name, None)
        else:
            self.pins[name] = n
        self.touch(name)

    def _take(self, n: int) -> List[int]:
        """Atomically pop ``n`` slabs: raises BEFORE mutating any state."""
        if n > len(self.free_list):
            raise OutOfSlabsError(
                f"need {n} slabs, {len(self.free_list)} free "
                f"(budget {self.slot_budget})")
        return [self.free_list.pop() for _ in range(n)]

    def _plan_evictions(self, need: int) -> List[str]:
        """LRU victims whose slabs make ``need`` fit — WITHOUT evicting;
        raises (no state change) when evicting every idle model is not
        enough."""
        if need <= self.free_slabs:
            return []
        victims: List[str] = []
        would_free = self.free_slabs
        idle = sorted((r.last_used, n) for n, r in self.residency.items()
                      if n not in self.pins)
        for _, n in idle:
            victims.append(n)
            would_free += self.views[n].total_slabs
            if would_free >= need:
                return victims
        raise OutOfSlabsError(
            f"activation needs {need} slabs; only {would_free} reachable "
            f"after evicting all idle models (budget {self.slot_budget}, "
            f"pinned: {sorted(self.pins)})")

    def activate(self, name: str, *, upload: bool = True) -> Residency:
        """Make a cold model resident: map its slabs (evicting idle LRU
        models under pressure) and optionally upload every layer.  Atomic
        like the reference; ``upload=False`` maps slots only."""
        if name in self.residency:
            self.touch(name)
            return self.residency[name]
        view = self.views[name]
        for victim in self._plan_evictions(view.total_slabs):
            self.evict(victim)
        slabs = self._take(view.total_slabs)
        res = Residency(
            slots=np.asarray(slabs, np.int32).reshape(
                view.n_layers, view.slabs_per_layer),
            uploaded=np.zeros(view.n_layers, bool),
            rev=self._next_rev())
        self.residency[name] = res
        self.activations += 1
        self.touch(name)
        if self.hooks is not None:
            self.hooks.arena_activate(name, view.total_slabs)
        if upload:
            self.ensure_model_uploaded(name)
        return res

    def evict(self, name: str) -> None:
        """Return an idle model's slabs to the free list (host masters
        stay, so re-activation reproduces the identical weights)."""
        if name in self.pins:
            raise ValueError(f"cannot evict pinned model {name!r}")
        res = self.residency.pop(name)
        self.free_list.extend(int(s) for s in res.slots.ravel())
        self._table_rev.pop(name, None)
        for layer in range(len(res.uploaded)):
            self._pending.pop((name, layer), None)
        self.evictions += 1
        if self.hooks is not None:
            self.hooks.arena_evict(name, res.slots.size)

    # ------------------------------------------------------------------
    # elastic boundary: live resize (DESIGN.md §8)
    # ------------------------------------------------------------------
    def resize(self, new_budget: int) -> Dict[str, int]:
        """Grow or shrink ``slot_budget`` at a step boundary (reference
        ``weight_pool.py:507``).

        Growing copies the arena into the prefix of a larger, zero-padded
        tensor and puts the fresh ids at the FRONT of the (pop-from-the-
        end) free list, so low slabs keep being preferred.  Shrinking
        evicts idle unpinned models LRU until the survivors fit, then
        compacts every survivor into the retained prefix with ONE
        ``index_select`` into a new tensor and bumps each residency's rev;
        the static slot tables are refreshed in place.  Raises
        ``OutOfSlabsError`` when the pinned residents alone do not fit,
        with no state change beyond completed evictions.

        On a card the device is synchronised first: FFN stages on the
        weights stream and uploads on the copy stream may still read or
        write the old tensor, whose memory is freed here.
        """
        new_budget = int(new_budget)
        check(new_budget >= 1, f"slot budget must be >= 1, got {new_budget}")
        old_budget = self.slot_budget
        if new_budget == old_budget:
            return {"slot_budget": old_budget, "evicted": 0, "moved": 0}
        if self.arena is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if new_budget > old_budget:
            if self.arena is not None:
                pad = torch.zeros((new_budget - old_budget, self.slab_bytes),
                                  dtype=self.arena.dtype, device=self.device)
                self.arena = torch.cat([self.arena, pad])
            self.free_list = list(range(new_budget - 1, old_budget - 1, -1)) \
                + self.free_list
            self.slot_budget = new_budget
            self.resizes += 1
            if self.hooks is not None:
                self.hooks.arena_resize(old_budget, new_budget, 0, 0)
            return {"slot_budget": new_budget, "evicted": 0, "moved": 0}

        # --- shrink: evict idle LRU until the survivors fit -------------
        evicted = 0
        while self.resident_slabs > new_budget:
            idle = sorted((r.last_used, n) for n, r in self.residency.items()
                          if n not in self.pins)
            if not idle:
                raise OutOfSlabsError(
                    f"cannot shrink arena to {new_budget} slabs: "
                    f"{self.resident_slabs} resident and every resident "
                    f"model is pinned (pinned: {sorted(self.pins)})")
            self.evict(idle[0][1])
            evicted += 1
        # compact survivors into [0, new_budget) in name order
        old_ids: List[int] = []
        for name in sorted(self.residency):
            old_ids.extend(int(s) for s in self.residency[name].slots.ravel())
        k = len(old_ids)
        perm = np.zeros(new_budget, np.int64)
        perm[:k] = old_ids
        if self.arena is not None:
            self.arena = self.arena.index_select(
                0, torch.from_numpy(perm).to(self.device))
        next_id = 0
        for name in sorted(self.residency):
            res = self.residency[name]
            n = res.slots.size
            res.slots = np.arange(next_id, next_id + n,
                                  dtype=np.int32).reshape(res.slots.shape)
            res.rev = self._next_rev()
            next_id += n
            if name in self._tables:
                self.slot_table(name)          # refreshed in place
        self.free_list = list(range(new_budget - 1, k - 1, -1))
        self.slot_budget = new_budget
        self.resizes += 1
        if self.hooks is not None:
            self.hooks.arena_resize(old_budget, new_budget, evicted, k)
        return {"slot_budget": new_budget, "evicted": evicted, "moved": k}

    # ------------------------------------------------------------------
    # uploads (slow path, overlapped with compute on a card)
    # ------------------------------------------------------------------
    def _upload_layers(self, name: str, layers: Sequence[int]) -> None:
        res = self.residency[name]
        host = self.host_slabs[name]
        side = self._copy_stream
        if side is not None:
            # slabs may be reused from an evicted model whose FFN reads are
            # still queued on the compute stream: copy only after them
            side.wait_stream(torch.cuda.current_stream(self.device))
        for layer in layers:
            rows = host[layer]
            if self.arena is not None:
                with torch.cuda.stream(side) if side is not None \
                        else contextlib.nullcontext():
                    for first, src, n in _runs(res.slots[layer]):
                        self.arena[first:first + n].copy_(
                            rows[src:src + n], non_blocking=True)
                    if side is not None:
                        event = torch.cuda.Event()
                        event.record(side)
                        self._pending[(name, layer)] = event
            res.uploaded[layer] = True
            self.layer_uploads += 1
        if self.hooks is not None and len(layers):
            self.hooks.arena_upload(
                name, len(layers) * self.views[name].slabs_per_layer)

    def wait_layer(self, name: str, layer: int, stream=None) -> None:
        """Order ``stream`` (default: the current stream), the one that
        will read the slabs, after ``layer``'s upload if one is in flight:
        the FFN reads the arena only once its slabs landed."""
        event = self._pending.pop((name, layer), None)
        if event is not None:
            (stream or torch.cuda.current_stream(self.device)) \
                .wait_event(event)

    def prefetch_layer(self, name: str, layer: int) -> None:
        """Issue the (async) upload of one layer's slabs; no-op if already
        uploaded or out of range — prefill calls this for layer L+1 while
        layer L's attention is in flight."""
        res = self.residency.get(name)
        if res is None or layer < 0 or layer >= len(res.uploaded) \
                or res.uploaded[layer]:
            return
        self._upload_layers(name, [layer])

    def ensure_model_uploaded(self, name: str) -> None:
        """Upload every not-yet-streamed layer."""
        res = self.residency[name]
        missing = np.flatnonzero(~res.uploaded)
        if len(missing):
            self._upload_layers(name, [int(m) for m in missing])

    def acquire(self, name: str) -> Tuple[torch.Tensor, torch.Tensor]:
        """(arena tensor, slot table) with ``name`` resident, uploaded and
        its uploads ordered before whatever the caller issues next — the
        one residency protocol every decode step goes through."""
        self.activate(name)
        self.ensure_model_uploaded(name)
        for layer in range(self.views[name].n_layers):
            self.wait_layer(name, layer)
        return self.arena, self.slot_table(name)

    # ------------------------------------------------------------------
    # fast path: device slot tables
    # ------------------------------------------------------------------
    def static_table(self, name: str) -> torch.Tensor:
        """The model's one device slot table [n_layers, slabs_per_layer]
        int32: the same tensor for the arena's lifetime, whatever the
        residency (its contents are valid once ``slot_table`` has run
        after the model's latest activation)."""
        table = self._tables.get(name)
        if table is None:
            view = self.views[name]
            table = torch.zeros((view.n_layers, view.slabs_per_layer),
                                dtype=torch.int32, device=self.device)
            self._tables[name] = table
        return table

    def slot_table(self, name: str) -> torch.Tensor:
        """The model's static device slot table, refreshed in place (a
        stream-ordered copy) when its activation rev changed."""
        res = self.residency.get(name)
        if res is None:
            raise KeyError(f"model {name!r} is not resident in the arena")
        table = self.static_table(name)
        if self._table_rev.get(name) != res.rev:
            # ``res.slots`` is never written after the activation that made
            # it, so the copy may read it asynchronously
            table.copy_(torch.from_numpy(res.slots), non_blocking=True)
            self._table_rev[name] = res.rev
        return table
