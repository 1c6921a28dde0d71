"""Layer-wise pipeline scheduler: two in-flight batches across two pools.

Port of ``src/repro/core/pipeline.py`` (paper §3.2, Fig. 4): the
scheduler holds up to two in-flight batches, each with its own model id,
layer cursor and completion state.  While batch B1 runs attention for a
layer in the KV-cache pool, B2's previous-layer hidden states go through
the FFN in the weights pool.  There is no global layer barrier: batches
may come from different models with different layer counts; when one
finishes its slot is refilled (early exit + refill).

Both pools share one card here, so the "two pools" are two CUDA streams:
attention stages (and every pool write) run on the calling stream, the
KV stream; FFN stages run on ``w_stream``, the weights stream, with the
hidden states crossing by ``pools.transfer`` (an event each way).  Stages
of one batch stay ordered by those events; stages of two batches on the
two streams overlap on the card.  Every batch reads and writes KV through
the ONE shared pool, each through its own page tables, and FFN weights
come from the ONE shared arena: while a batch's layer-L attention is in
flight, layer L+1's slabs are prefetched into the arena.

The scheduler also takes PREFILL batches (``InflightBatch(prefill=True)``):
full-sequence attention per layer, each layer's prompt KV stored through
the batch's ``kv_writer``, the FFN through the same arena.  It advances
one token per decode batch pass: the K-token blocks live in the fused
lowering (``control.MultiStepFusedStep``); the two are alternative
lowerings of an engine step, never composed.

The issue order is the reference's round robin, one stage per live slot
per cycle, so ``stage_log`` equals the reference's on the same batches.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core.control import logit_index, run_ffn
from repro_torch.core.pools import PooledModel, transfer


@dataclass
class InflightBatch:
    """One batch's layer-granular execution state (the paper's state
    machine: model id, layer cursor, completion).  KV lives in the shared
    pool; the batch owns only its page-table view of it.

    ``prefill=True`` runs the prompt-phase stages instead: ``tokens`` is
    ``[B, S]`` prompt ids, ``page_tables``/``lengths`` are unused, each
    layer's KV goes to ``kv_writer(layer, layer_kv, pool) -> pool``, and
    ``logits`` is taken at the unpadded last position (``true_len - 1``).
    """

    batch_id: int
    model: str
    tokens: torch.Tensor              # [B] next-token ids ([B,S] prefill)
    page_tables: Optional[torch.Tensor] = None   # [L, B, max_pages] int32
    lengths: Optional[torch.Tensor] = None       # [B] context lengths
    layer: int = 0                    # layer cursor
    phase: str = "embed"              # embed -> attn -> ffn -> combine -> done
    x: Optional[torch.Tensor] = None  # residual stream
    ffn_in: Optional[torch.Tensor] = None
    ffn_out: Optional[torch.Tensor] = None
    logits: Optional[torch.Tensor] = None
    prefill: bool = False
    # unpadded prompt length: an int, or one per row of a coalesced batch
    true_len: object = 0
    kv_writer: Optional[Callable] = None

    @property
    def done(self) -> bool:
        return self.phase == "done"


class LayerPipelineScheduler:
    """Interleaves attention and FFN stages of two in-flight batches."""

    def __init__(self, pooled: Dict[str, PooledModel], w_stream=None):
        self.pooled = pooled
        self.w_stream = w_stream
        # the ONE shared weights arena (every pooled model carries it)
        self.arena = next((pm.arena for pm in pooled.values()
                           if pm.arena is not None), None)
        #: (batch id, model, "attn" | "ffn", layer) of every issued stage
        self.stage_log: List[Tuple[int, str, str, int]] = []

    # ------------------------------------------------------------------
    def _advance(self, b: InflightBatch, pool: torch.Tensor
                 ) -> torch.Tensor:
        """Issue exactly one stage of one batch (no host read).  Returns
        the shared pool."""
        fns = self.pooled[b.model].stage_fns
        p_kv = self.pooled[b.model].kv_params
        arena = self.arena
        if b.phase == "embed":
            # map the model's slabs (upload streams in layer by layer);
            # layer 0 is pulled eagerly so the first FFN never stalls
            arena.activate(b.model, upload=False)
            arena.prefetch_layer(b.model, 0)
            b.x = (fns.prefill_embed if b.prefill else fns.embed)(p_kv,
                                                                   b.tokens)
            b.phase = "attn"
        elif b.phase == "attn":
            if b.prefill:
                b.x, ffn_in, layer_kv = fns.prefill_attn(p_kv, b.x, b.layer)
                if b.kv_writer is not None:     # prompt KV -> shared pool
                    pool = b.kv_writer(b.layer, layer_kv, pool)
            else:
                b.x, ffn_in, pool = fns.attn_stage(
                    p_kv, b.x, pool, b.page_tables, b.lengths, b.layer)
            # layer L+1's slab upload issues while layer L's attention is
            # in flight
            arena.prefetch_layer(b.model, b.layer + 1)
            b.ffn_in = transfer(ffn_in, self.w_stream)       # A-to-F
            self.stage_log.append((b.batch_id, b.model, "attn", b.layer))
            b.phase = "ffn"
        elif b.phase == "ffn":
            arena.prefetch_layer(b.model, b.layer)   # no-op once prefetched
            b.ffn_out = run_ffn(self.pooled[b.model], b.ffn_in, b.layer,
                                self.w_stream)
            self.stage_log.append((b.batch_id, b.model, "ffn", b.layer))
            b.phase = "combine"
        elif b.phase == "combine":
            b.x = fns.combine(b.x, b.ffn_out)
            b.ffn_in = b.ffn_out = None
            b.layer += 1
            if b.layer >= fns.n_layers:
                b.logits = (fns.prefill_logits(
                    p_kv, b.x, logit_index(b.true_len, b.x.device))
                    if b.prefill else fns.logits(p_kv, b.x))
                b.phase = "done"                              # early exit
            else:
                b.phase = "attn"
        return pool

    # ------------------------------------------------------------------
    def run(self, batches: List[InflightBatch], pool: torch.Tensor, *,
            refill: Optional[Callable[[], Optional[InflightBatch]]] = None,
            max_inflight: int = 2
            ) -> Tuple[List[InflightBatch], torch.Tensor]:
        """Drive batches to completion, keeping ``max_inflight`` slots
        busy.  ``pool`` is the shared physical KV pool; ``refill`` is
        polled whenever a slot frees.  Returns (completed batches in
        completion order, the pool)."""
        queue = list(batches)
        slots: List[Optional[InflightBatch]] = [None] * max_inflight
        finished: List[InflightBatch] = []

        def fill(i):
            if queue:
                slots[i] = queue.pop(0)
            elif refill is not None:
                slots[i] = refill()
            else:
                slots[i] = None

        for i in range(max_inflight):
            fill(i)
        # round robin: one stage per live slot per cycle, so batch A's FFN
        # (weights stream) is issued right after batch B's attention (KV
        # stream) and both streams' queues stay populated
        while any(s is not None for s in slots):
            for i, s in enumerate(slots):
                if s is None:
                    continue
                pool = self._advance(s, pool)
                if s.done:
                    finished.append(s)
                    fill(i)
        return finished, pool

    def run_serial(self, batches: List[InflightBatch], pool: torch.Tensor
                   ) -> Tuple[List[InflightBatch], torch.Tensor]:
        """Pipeline OFF baseline: one batch at a time, stages still split
        across the two streams (transfers exposed)."""
        return self.run(batches, pool, max_inflight=1)

    def overlap_fraction(self) -> float:
        """Fraction of adjacent issued stages that alternate pools — a
        proxy for how much attention/FFN overlap the schedule exposes."""
        if len(self.stage_log) < 2:
            return 0.0
        alt = sum(1 for a, b in zip(self.stage_log, self.stage_log[1:])
                  if a[2] != b[2])
        return alt / (len(self.stage_log) - 1)
