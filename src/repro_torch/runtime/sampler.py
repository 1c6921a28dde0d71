"""Token sampling (port of ``src/repro/runtime/sampler.py``, greedy only).

The single sampling entry point of the runtime: the prefill first-token
pick and the multi-step decode both call ``sample``, on the device.
Temperature sampling draws from ``jax.random`` in the reference and can
only match it in distribution; it is not ported yet.
"""
from __future__ import annotations

import torch


def sample(logits: torch.Tensor, *, temperature: float = 0.0) -> torch.Tensor:
    """logits [B,V] -> token ids [B] int32.  Greedy ``argmax`` returns the
    FIRST maximal index, as ``jnp.argmax`` does."""
    if temperature > 0.0:
        raise NotImplementedError("temperature sampling is not ported yet")
    return torch.argmax(logits, dim=-1).to(torch.int32)
