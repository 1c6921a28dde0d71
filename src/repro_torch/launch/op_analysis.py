"""One rank's step counted on ``meta`` tensors: port of
``src/repro/launch/hlo_analysis.py``.

The reference compiles a cell and parses the partitioned HLO text: the
dot FLOPs of every computation times the trip count of the while body it
sits in (XLA's ``cost_analysis`` counts a body once, so it multiplies by
``depth_trips_for``), and the result-shape bytes of every collective.
The port has no compiler and no program text.  It runs the step itself,
once, on ``meta`` tensors at one rank's shard shapes
(``sharding/spec.py`` ``shard_shape``), and counts what runs:

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` (matmuls, batched
  matmuls, convolutions, attention; elementwise ops count nothing, as the
  reference's dot-only count).  Every layer executes, so no trip factor
  is needed.
* Collective bytes by kind and their count: the step's collectives run
  over a stand-in mesh (``launch/mesh.py`` ``Mesh.stand_in``), which
  returns each result's shape on ``meta`` and adds its bytes: the
  per-device result-shape payload the reference sums from the HLO.
* Bytes accessed: each op's tensor inputs and outputs, summed over the
  ops (view ops excluded, nothing fused): the counterpart of
  ``cost_analysis()``'s "bytes accessed".
* Temp bytes: the peak of the bytes of the tensors the step made and
  still holds, in place of ``memory_analysis().temp_size_in_bytes``.

``code_bytes`` (the size of a compiled program) has no meaning here and
is left out, and so are the HLO text parsers: the graph audit
(``analysis/graph_audit.py``) checks a fused step's donation, host
transfers and dispatch structure on the step itself.

Where a kernel wrapper is reached, a ``meta`` tensor takes its plain
version (``kernels/build.py`` ``plain_route``): shapes only, nothing
computes.  A step that reads a device value to the host fails loudly on
``meta``; that is a finding about the step, not a place for a fallback.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.launch.mesh import COLLECTIVES, Mesh


@dataclass
class ModuleStats:
    """The reference's ``ModuleStats`` fields, and what a run adds."""
    flops: float
    collective_bytes: Dict[str, int]
    collective_total: int
    coll_count: int
    bytes_accessed: float = 0.0
    temp_bytes: int = 0


def to_meta(tree):
    """``tree`` (dicts, lists, tuples and NamedTuples of tensors) with
    every tensor replaced by an uninitialised ``meta`` tensor of its shape
    and dtype (``requires_grad`` kept)."""
    if isinstance(tree, torch.Tensor):
        out = torch.empty(tree.shape, dtype=tree.dtype, device="meta")
        return out.requires_grad_(tree.requires_grad)
    if isinstance(tree, dict):
        return {k: to_meta(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_meta(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_meta(v) for v in tree)
    return tree


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class _Counter(TorchDispatchMode):
    """Bytes accessed and the high-water mark of the storages the step
    made.  An op's output on a storage none of its inputs is on (a view,
    an in-place op and ``out=`` alias one) is a storage the step made,
    held until the last tensor on it dies; what existed before the step
    (a param, the cache, a closure's tensor) is never counted."""

    def __init__(self):
        super().__init__()
        self.held: Dict[int, list] = {}     # key -> [bytes, live tensors]
        self.live = 0
        self.peak = 0
        self.bytes = 0

    def _drop(self, key: int) -> None:
        entry = self.held[key]
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self.held[key]

    def _hold(self, t: torch.Tensor) -> None:
        key = _storage_key(t)
        if key not in self.held:
            size = t.untyped_storage().nbytes()
            self.held[key] = [size, 0]
            self.live += size
            self.peak = max(self.peak, self.live)
        self.held[key][1] += 1
        weakref.finalize(t, self._drop, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        ins = [t for t in tree_leaves((args, kwargs or {}))
               if isinstance(t, torch.Tensor)]
        out = func(*args, **(kwargs or {}))
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not getattr(func, "is_view", False):
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        aliased = {_storage_key(t) for t in ins}
        for t in outs:
            if _storage_key(t) not in aliased:
                self._hold(t)
        return out


def analyze_step(fn: Callable, *args, mesh: Optional[Mesh] = None,
                 **kwargs) -> ModuleStats:
    """Run ``fn(*args, **kwargs)`` once on ``meta`` (every tensor of the
    arguments is moved there by ``to_meta``) and count it.  ``mesh`` is
    the stand-in mesh the step's hooks were built on
    (``Mesh.stand_in``): its collectives' bytes are the step's (none
    without it).  Grad mode is the caller's: a serve step runs under
    ``torch.no_grad()``, a train step with grad enabled."""
    args, kwargs = to_meta(args), to_meta(kwargs)
    if mesh is not None:
        mesh.counted = {}
    counter = _Counter()
    flops = FlopCounterMode(display=False)
    with flops, counter:
        out = fn(*args, **kwargs)
        del out
    counted = dict(mesh.counted) if mesh is not None else {}
    coll = {k: int(counted.get(k, 0)) for k in COLLECTIVES}
    return ModuleStats(
        flops=float(flops.get_total_flops()), collective_bytes=coll,
        collective_total=sum(coll.values()),
        coll_count=int(counted.get("count", 0)),
        bytes_accessed=float(counter.bytes), temp_bytes=int(counter.peak))


def analyze_fused_step(step, pool, *, inputs=None, batch: int = 0,
                       max_pages: int = 0) -> ModuleStats:
    """Count one block of a fused decode step (``core/control.py``
    ``PagedFusedStep`` / ``MultiStepFusedStep``: K tokens, every layer)
    on ``meta``: a twin of the step whose non-FFN params are ``meta``
    runs its body over ``meta`` copies of the pool, the arena and the
    slot table.  ``inputs``: the body's static inputs (default: the
    inactive ones of ``batch`` rows and ``max_pages`` table columns, the
    captured graph's when the step has one).  The paged attention calls
    take their plain version there: the whole table's tokens, where the
    kernel reads only each row's length."""
    import copy
    import dataclasses

    pooled = step.pooled
    abuf, table = pooled.arena.acquire(pooled.cfg.name)
    if inputs is None:
        if step.graph is not None:
            _, batch, max_pages = step.graph.static["page_tables"].shape
        inputs = step.inactive_inputs(batch, max_pages, "meta")
    twin = copy.copy(step)
    twin.pooled = dataclasses.replace(pooled,
                                      kv_params=to_meta(pooled.kv_params))
    twin.nonfinite_logits = None
    twin.graph = None
    with torch.no_grad():
        return analyze_step(twin.body, pool, abuf, table, **inputs)
