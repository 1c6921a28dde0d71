"""Disaggregated memory pools: the engine-level objects.

Port of ``src/repro/core/pools.py``.  ``KVCachePool`` owns every
colocated model's non-FFN params and the shared physical KV page pool
(the virtualizer); ``WeightsPool`` owns the ONE slab arena holding every
model's FFN/MoE weights, with the host master copies packed beside it.
In the port both pools live on one device; hidden states are the only
tensors that cross between the two halves of a layer.  Under the
host-driven lowering on a card the halves run on two streams (attention
on the KV stream, FFN on the weights stream) and ``transfer`` is the
boundary between them, the counterpart of the reference's
``jax.device_put`` (``src/repro/core/pools.py:124``).

The fused fallback families (ssm, hybrid) never enter the arena: they get
``stage_fns=None``, their pool pages account for budget only, and their
whole param tree, on the device once, is their ``kv_params``: the engine
serves them from it with a dense per-model cache (``runtime/engine.py``,
as the reference's ``pools.py:41-51,174-188``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import split_exec
from repro_torch.core.virtualizer import (DEFAULT_PAGE_BYTES, KVVirtualizer,
                                          ModelView)
from repro_torch.core.weight_pool import (DEFAULT_SLAB_BYTES, ModelArenaView,
                                          OutOfSlabsError, WeightArena)


@dataclass
class PooledModel:
    cfg: ModelConfig
    # on the device: embeddings, norms, attention (a fallback model's
    # whole tree)
    kv_params: Dict
    view: ModelView            # how this model types the shared pages
    # how its FFN tree maps onto arena slabs (None: fallback families)
    w_view: Optional[ModelArenaView]
    arena: WeightArena         # the ONE shared weights arena
    stage_fns: Optional[split_exec.StageFns]     # None: fallback families


class WeightsPool:
    """Consolidated FFN weights of all colocated cold models: ONE slab
    arena sized by ``slot_budget`` plus the packed host masters."""

    def __init__(self, device, *, slab_bytes: int = DEFAULT_SLAB_BYTES):
        self.device = torch.device(device)
        self.arena = WeightArena(slab_bytes=slab_bytes, device=self.device)

    def add_model(self, name: str, cfg: ModelConfig, w_params: Dict) -> None:
        if not split_exec.supports_split(cfg):
            raise ValueError(f"{cfg.name}: the fused fallback families "
                             f"never enter the arena")
        self.arena.add_model(name, cfg, w_params)

    def finalize(self, slot_budget: Optional[int] = None, *,
                 allocate: bool = True) -> None:
        self.arena.finalize(slot_budget, allocate=allocate)


def _to_device(tree: Dict, device: torch.device) -> Dict:
    return {k: _to_device(v, device) if isinstance(v, dict)
            else v.to(device) for k, v in tree.items()}


class KVCachePool:
    """Attention-side pool: non-FFN params + the shared paged KV space."""

    def __init__(self, device, models: Dict[str, ModelConfig], *,
                 page_budget: int, page_bytes: int = DEFAULT_PAGE_BYTES,
                 pool_dtype=torch.bfloat16,
                 allocate_device_pool: bool = True):
        self.device = torch.device(device)
        self.attn_params: Dict[str, Dict] = {}
        self.virtualizer = KVVirtualizer(
            models, page_budget=page_budget, page_bytes=page_bytes,
            dtype=pool_dtype, allocate_device_pool=allocate_device_pool,
            device=self.device)

    def add_model(self, name: str, kv_params: Dict) -> None:
        self.attn_params[name] = _to_device(kv_params, self.device)

    def resize(self, page_budget: int, protected=()):
        """Elastic entry: live-resize the shared page pool (DESIGN.md §8)."""
        return self.virtualizer.resize(page_budget, protected=protected)


def transfer(x: torch.Tensor, stream) -> torch.Tensor:
    """The pool boundary: hand ``x``, produced on the current stream, to
    ``stream``.  The producer records an event, ``stream`` waits on it,
    and ``x.record_stream(stream)`` keeps the caching allocator from
    giving ``x``'s block to another tensor before ``stream``'s reads are
    done.  ``stream=None`` (one stream, or the CPU) hands ``x`` back."""
    if stream is None:
        return x
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(x.device))
    stream.wait_event(event)
    x.record_stream(stream)
    return x


def build_pools(models: Dict[str, ModelConfig], params: Dict[str, Dict], *,
                device, page_budget: int,
                page_bytes: int = DEFAULT_PAGE_BYTES,
                pool_dtype=torch.bfloat16,
                slot_budget: Optional[int] = None,
                slab_bytes: int = DEFAULT_SLAB_BYTES,
                activate_resident: bool = True):
    """Split every model's params across the two pools (one device).

    ``params`` is CONSUMED: each split model's FFN half is packed into the
    arena's host masters and its entry is dropped from ``params``, so no
    full tree outlives this call; a fallback model's whole tree goes to
    the device as its ``kv_params``.  The device page pool and the arena
    are allocated only when some model runs split.  ``slot_budget=None``
    sizes the arena so every split model fits resident at once;
    ``activate_resident`` activates models in registration order until
    the budget is full.
    """
    any_split = any(split_exec.supports_split(c) for c in models.values())
    kv_pool = KVCachePool(device, models, page_budget=page_budget,
                          page_bytes=page_bytes, pool_dtype=pool_dtype,
                          allocate_device_pool=any_split)
    w_pool = WeightsPool(device, slab_bytes=slab_bytes)
    for name, cfg in models.items():
        if not split_exec.supports_split(cfg):
            kv_pool.add_model(name, params.pop(name))
            continue
        kv_tree, w_tree = split_exec.split_params(params.pop(name), cfg)
        kv_pool.add_model(name, kv_tree)
        w_pool.add_model(name, cfg, w_tree)
        del kv_tree, w_tree                # free the device FFN tree now
    w_pool.finalize(slot_budget, allocate=any_split)
    if activate_resident:
        for name in w_pool.arena.views:
            try:
                w_pool.arena.activate(name)
            except OutOfSlabsError:
                break                      # the rest activate on demand
    pooled: Dict[str, PooledModel] = {}
    for name, cfg in models.items():
        view = kv_pool.virtualizer.views[name]
        w_view = w_pool.arena.views.get(name)
        pooled[name] = PooledModel(
            cfg=cfg, kv_params=kv_pool.attn_params[name], view=view,
            w_view=w_view, arena=w_pool.arena,
            stage_fns=(split_exec.make_stage_fns(cfg, view, w_view)
                       if w_view is not None else None))
    return kv_pool, w_pool, pooled
