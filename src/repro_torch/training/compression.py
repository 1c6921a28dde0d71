"""Error-feedback int8 gradient compression (port of
``src/repro/training/compression.py``).

    q      = quantize(g + e)        # per-tensor symmetric int8
    e'     = (g + e) - dequant(q)   # residual carried to the next step
    g_used = dequant(q)
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.training.tree import map_tree


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    xf = x.float()
    scale = xf.abs().max().clamp(min=1e-12) / 127.0
    # torch.round rounds half to even, as jnp.round
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_feedback(params: Dict) -> Dict:
    return map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compress_grads(grads: Dict, error_fb: Dict) -> Tuple[Dict, Dict]:
    """Returns (grads_to_use, new_error_feedback)."""
    used, new_e = {}, {}
    for k, g in grads.items():
        if isinstance(g, dict):
            used[k], new_e[k] = compress_grads(g, error_fb[k])
            continue
        total = g.float() + error_fb[k]
        deq = _dequantize(*_quantize(total))
        used[k], new_e[k] = deq.to(g.dtype), total - deq
    return used, new_e
