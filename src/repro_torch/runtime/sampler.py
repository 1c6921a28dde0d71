"""Token sampling: greedy, temperature and top-k (port of
``src/repro/runtime/sampler.py``).

The single sampling entry point of the runtime:

* ``sample`` — the host-visible path: the prefill first-token pick, the
  host-driven (lowering=OFF) decode commit and the pipeline scheduler's
  write-back;
* ``sample_on_device`` — the fused multi-step decode: the same policy
  with the inner step index folded into the seed, so the K tokens of one
  dispatch draw independent samples and replaying a dispatch with the same
  seed reproduces them.

Temperature sampling is Gumbel-max: ``argmax(logits / T + g)`` with ``g =
-log(-log(u))`` is a draw from ``softmax(logits / T)``, as
``jax.random.categorical`` draws.  The noise comes from a
``torch.Generator``, whose numbers are not JAX's: the port can only match
the reference in distribution.  ``gumbel_noise`` draws it outside any
CUDA graph (into a captured step's static buffer before each replay), and
``sample_with_noise`` is the part a graph holds.  Greedy is ``argmax``,
which returns the FIRST maximal index, as ``jnp.argmax`` does.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

_MIX = 0x9E3779B97F4A7C15
_MASK = (1 << 63) - 1


def fold_in(seed: int, step: int) -> int:
    """A generator seed for inner step ``step`` of a dispatch seeded with
    ``seed`` (the counterpart of ``jax.random.fold_in``)."""
    return ((int(seed) * _MIX) ^ (int(step) + 1) * 0xBF58476D1CE4E5B9) & _MASK


def gumbel_noise(shape: Sequence[int], generator: torch.Generator, *,
                 device=None, out: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Standard Gumbel noise of ``shape`` in float32 from ``generator``
    (into ``out`` when given)."""
    if out is None:
        out = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    out.uniform_(generator=generator)
    tiny = torch.finfo(torch.float32).tiny
    return out.clamp_(min=tiny).log_().neg_().log_().neg_()


def sample_with_noise(logits: torch.Tensor, noise: Optional[torch.Tensor],
                      *, temperature: float = 0.0, top_k: int = 0
                      ) -> torch.Tensor:
    """logits [B,V] -> token ids [B] int32, given Gumbel ``noise`` [B,V]
    (unused when greedy).  Top-k keeps the k largest scaled logits (ties
    at the k-th value included, as the reference's ``>=`` keeps them)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits.float() / temperature
    if top_k > 0:
        kth = torch.topk(scaled, top_k, dim=-1).values[:, -1:]
        scaled = torch.where(scaled >= kth, scaled,
                             torch.full_like(scaled, float("-inf")))
    return torch.argmax(scaled + noise, dim=-1).to(torch.int32)


def sample(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
           *, temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """logits [B,V] -> token ids [B] int32."""
    if temperature <= 0.0:
        return sample_with_noise(logits, None)
    if generator is None:
        raise ValueError("temperature sampling needs a torch.Generator")
    noise = gumbel_noise(logits.shape, generator, device=logits.device)
    return sample_with_noise(logits, noise, temperature=temperature,
                             top_k=top_k)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of inner step ``step`` of a dispatch seeded with
    ``seed``, on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(fold_in(seed, step))
    return gen


def sample_on_device(logits: torch.Tensor, seed: int, step: int, *,
                     temperature: float = 0.0, top_k: int = 0
                     ) -> torch.Tensor:
    """In-dispatch sampling for the multi-step fused decode: ``step`` (the
    inner step index) is folded into ``seed``, so a dispatch replayed with
    the same seed reproduces its K tokens.  Greedy never draws."""
    if temperature <= 0.0:
        return sample_with_noise(logits, None)
    return sample(logits, step_generator(seed, step, logits.device),
                  temperature=temperature, top_k=top_k)
