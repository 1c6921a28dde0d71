"""AdamW over param trees, with configurable moment dtype (port of
``src/repro/training/optimizer.py``).

The reference's arithmetic, step for step: ``count`` is incremented
before the schedule is read, the learning rate warms up linearly
(``lr * min(step / warmup, 1)``), gradients are clipped by their global
norm in f32 (``+ 1e-12``), both bias corrections are f32, and weight
decay applies only to leaves with two or more dimensions.  Where the
reference returns new trees, ``update`` writes params and moments IN
PLACE under ``torch.no_grad()`` (the card never holds two copies of the
state) and returns the same tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.models.hooks import WHOLE, WholeParams
from repro_torch.training.tree import leaves, leaves_with_path, map_tree


class AdamWState(NamedTuple):
    count: torch.Tensor          # int32 scalar on the params' device
    m: Dict
    v: Dict


def global_norm(grads: Dict, shards: WholeParams = WHOLE) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32.  Under the sharded
    step's ``shards`` (``Hooks.params``; ``grads`` this rank's shards) it
    is the norm of the whole gradient: each leaf's sum of squares is
    summed over the axes the leaf is split on and counted once over those
    it is replicated on."""
    sq = shards.leaf_stats({"/".join(path): torch.sum(torch.square(g.float()))
                            for path, g in leaves_with_path(grads)}, "sum")
    return torch.sqrt(sum(sq.values()))


def _store(dst: torch.Tensor, value: torch.Tensor) -> None:
    """Write an f32 result back into ``dst`` unless it already is it."""
    if value is not dst:
        dst.copy_(value)


@dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: str = "float32"        # "float32" | "bfloat16"
    grad_clip: float = 1.0
    warmup_steps: int = 100

    def _mdt(self) -> torch.dtype:
        return (torch.bfloat16 if self.moment_dtype == "bfloat16"
                else torch.float32)

    def init(self, params: Dict) -> AdamWState:
        device = leaves(params)[0].device
        zeros = lambda p: torch.zeros(p.shape, dtype=self._mdt(),  # noqa: E731
                                      device=p.device)
        return AdamWState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            m=map_tree(zeros, params), v=map_tree(zeros, params))

    def schedule(self, step: torch.Tensor) -> torch.Tensor:
        warm = torch.clamp(step / max(self.warmup_steps, 1), max=1.0)
        return self.lr * warm

    @torch.no_grad()
    def update(self, grads: Dict, state: AdamWState, params: Dict,
               gnorm: Optional[torch.Tensor] = None
               ) -> Tuple[Dict, AdamWState]:
        """One step; ``params`` and the moments are updated in place and
        returned.  ``gnorm``: the gradient's global norm when the caller
        has it (a sharded step's is the whole gradient's,
        ``global_norm(grads, shards)``)."""
        count = state.count + 1
        if gnorm is None:
            gnorm = global_norm(grads)
        scale = torch.clamp(self.grad_clip / (gnorm + 1e-12), max=1.0)
        lr = self.schedule(count)
        b1c = 1.0 - self.b1 ** count.float()
        b2c = 1.0 - self.b2 ** count.float()
        for g, m, v, p in zip(leaves(grads), leaves(state.m),
                              leaves(state.v), leaves(params)):
            g = g.float() * scale
            m32 = m.float().mul_(self.b1).add_(g, alpha=1 - self.b1)
            v32 = v.float().mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            step = (m32 / b1c).div_(torch.sqrt(v32 / b2c).add_(self.eps))
            if p.ndim >= 2:                       # decay matrices only
                step.add_(p.float(), alpha=self.weight_decay)
            _store(p, p.float().sub_(step.mul_(lr)))
            _store(m, m32)
            _store(v, v32)
        return params, AdamWState(count, state.m, state.v)
