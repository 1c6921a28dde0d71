"""Decode and prefill control over the shared pools.

Port of the lowering=ON half of ``src/repro/core/control.py``:

* ``StreamingPrefill`` — the prompt phase: per layer, full-sequence
  attention, the async upload of layer L+1's weight slabs behind it, the
  layer's prompt KV written into the shared paged pool, then the FFN
  gathered out of the arena once layer L's slabs have landed.
* ``MultiStepFusedStep`` — K decode tokens per host call with greedy
  sampling on the device.  The reference compiles this into one
  ``lax.scan`` program; here it runs EAGERLY — a Python loop over the K
  inner steps and over the layers, every op on the device, the pool
  updated in place.  Capturing it as a CUDA graph is later work.

Not ported yet: the host-driven lowering (``HostDrivenStep``), the
single-step ``PagedFusedStep`` (K=1 runs the multi-step class) and the
prefix-cache ``suffix`` pass.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.pools import PooledModel
from repro_torch.runtime.sampler import sample


def logit_index(true_len: Union[int, Sequence[int]], device=None
                ) -> Union[int, torch.Tensor]:
    """Last-prompt-position index for ``prefill_logits``: an int when every
    row shares one unpadded length, a [B] int32 tensor for a coalesced
    batch where each row carries its own."""
    if isinstance(true_len, int):
        return true_len - 1
    return torch.tensor([int(n) - 1 for n in true_len], dtype=torch.int32,
                        device=device)


class StreamingPrefill:
    """Arena-bounded prompt-phase execution with streamed weight uploads
    (DESIGN.md §6)."""

    def __init__(self, pooled: PooledModel):
        self.pooled = pooled

    def __call__(self, tokens: torch.Tensor, true_len, pool: torch.Tensor,
                 writer=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens [B,S] prompt ids; ``true_len`` the unpadded length (an
        int, or one per row); ``writer(layer, layer_kv, pool) -> pool``
        stores one layer's prompt KV in the shared pool.  Returns
        (logits [B,V], pool)."""
        name = self.pooled.cfg.name
        arena = self.pooled.arena
        fns = self.pooled.stage_fns
        p_kv = self.pooled.kv_params
        arena.activate(name, upload=False)
        arena.prefetch_layer(name, 0)        # first FFN never stalls long
        x = fns.prefill_embed(p_kv, tokens)
        for layer in range(fns.n_layers):
            x, ffn_in, layer_kv = fns.prefill_attn(p_kv, x, layer)
            # layer L+1's slabs upload while layer L's attention runs
            arena.prefetch_layer(name, layer + 1)
            if writer is not None:
                pool = writer(layer, layer_kv, pool)
            arena.wait_layer(name, layer)
            ffn_out = fns.ffn_stage(arena.arena, arena.slot_table(name),
                                    ffn_in, layer)
            x = fns.combine(x, ffn_out)
        return fns.prefill_logits(p_kv, x,
                                  logit_index(true_len, tokens.device)), pool


class MultiStepFusedStep:
    """Multi-step decode: K tokens per host call, sampled on the device.

    Per-row freezing is the reference's (``control.py:393-416``, DESIGN.md
    §9): ``done0 = steps_left <= 0`` freezes inactive batch rows from step
    0; a row that samples its ``eos_id`` or exhausts its step budget flips
    ``done`` — later inner steps re-run its forward with frozen ``(token,
    length)``, emit -1, and its extra KV write lands on a -1 table entry
    (dropped) or in a reserved page that attention never reads and that
    ``commit_decode_block`` returns.  Valid tokens are a strict prefix of
    each ``[K]`` row.

    ``nonfinite_logits`` (the caller's device int64 scalar) counts logits
    that were NaN or infinite; it is added to on the device, so counting
    never syncs the step.
    """

    def __init__(self, pooled: PooledModel, k: int,
                 nonfinite_logits: torch.Tensor):
        if k < 1:
            raise ValueError(f"decode steps per dispatch must be >= 1, "
                             f"got {k}")
        self.pooled = pooled
        self.k = int(k)
        self.nonfinite_logits = nonfinite_logits

    def __call__(self, tokens: torch.Tensor, pool: torch.Tensor,
                 page_tables: torch.Tensor, lengths: torch.Tensor,
                 steps_left: torch.Tensor,
                 eos_ids: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens [B]; pool; page_tables [L,B,P] PRE-EXTENDED to cover K
        tokens; lengths [B]; steps_left [B] int32 per-row budget (0
        freezes the row); eos_ids [B] int32, -1 disables EOS.  Returns
        (token ids [K,B] int32, -1 past each row's valid prefix, pool)."""
        name = self.pooled.cfg.name
        fns = self.pooled.stage_fns
        p_kv = self.pooled.kv_params
        arena, slot_table = self.pooled.arena.acquire(name)
        if eos_ids is None:
            eos_ids = torch.full_like(tokens, -1)
        minus_one = torch.full_like(tokens, -1)
        toks, lens = tokens, lengths
        done = steps_left <= 0
        out = []
        for t in range(self.k):
            x = fns.embed(p_kv, toks)
            for layer in range(fns.n_layers):
                x, ffn_in, pool = fns.attn_stage(p_kv, x, pool, page_tables,
                                                 lens, layer)
                x = fns.combine(x, fns.ffn_stage(arena, slot_table, ffn_in,
                                                 layer))
            logits = fns.logits(p_kv, x)
            self.nonfinite_logits += (~torch.isfinite(logits)).sum()
            sampled = sample(logits)
            out.append(torch.where(done, minus_one, sampled))
            hit_eos = (~done) & (eos_ids >= 0) & (sampled == eos_ids)
            toks = torch.where(done, toks, sampled)
            lens = torch.where(done, lens, lens + 1)
            done = done | hit_eos | (steps_left <= t + 1)
        return torch.stack(out), pool
