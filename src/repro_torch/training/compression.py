"""Error-feedback int8 gradient compression (port of
``src/repro/training/compression.py``).

    q      = quantize(g + e)        # per-tensor symmetric int8
    e'     = (g + e) - dequant(q)   # residual carried to the next step
    g_used = dequant(q)
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.hooks import WHOLE, WholeParams
from repro_torch.training.tree import (leaves, leaves_with_path, map_tree,
                                      unflatten)


def _quantize(x: torch.Tensor, amax: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8; ``amax``: the whole tensor's max |x|
    when ``x`` is a shard of it (default: ``x``'s own)."""
    xf = x.float()
    if amax is None:
        amax = xf.abs().max()
    scale = amax.clamp(min=1e-12) / 127.0
    # torch.round rounds half to even, as jnp.round
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_feedback(params: Dict) -> Dict:
    return map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compress_grads(grads: Dict, error_fb: Dict,
                   shards: WholeParams = WHOLE) -> Tuple[Dict, Dict]:
    """Returns (grads_to_use, new_error_feedback).  Under the sharded
    step's ``shards`` (``Hooks.params``; the trees this rank's shards)
    each tensor's scale is the whole tensor's: its max |g + e| is
    reduced (MAX) over the axes the leaf is split on.  The maxima come
    first, then one leaf at a time: no whole tree of ``g + e`` is held."""
    flat = leaves_with_path(grads)
    fb = leaves(error_fb)
    amax = shards.leaf_stats({"/".join(path): (g.float() + e).abs().max()
                              for (path, g), e in zip(flat, fb)}, "max")
    used, new_e = [], []
    for (path, g), e in zip(flat, fb):
        total = g.float() + e
        deq = _dequantize(*_quantize(total, amax["/".join(path)]))
        used.append(deq.to(g.dtype))
        new_e.append(total - deq)
    return unflatten(grads, used), unflatten(error_fb, new_e)
