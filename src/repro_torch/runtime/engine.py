"""CrossPool serving engine: an online, continuously-batched session API.

Port of ``src/repro/runtime/engine.py`` in both lowering modes:

  submit(request) -> AdmissionController verdict on the returned handle
  step(now)
        -> drain the front-door queue
        -> PrefillBatcher: coalesce admitted same-model arrivals into ONE
           [B, S] StreamingPrefill pass per (model, prompt-bucket) group;
           prompt KV lands in the SHARED paged pool
        -> decode:
             lowering=True:  one ``MultiStepFusedStep`` call per active
               model, K tokens each, greedy sampling on the device — on a
               card ONE CUDA-graph replay per block (with pipeline=True
               every model's replay is issued before any is read back);
             lowering=False: ``HostDrivenStep``, K=1, per-layer stages
               from the host (FFN stages on a second stream on a card);
               with pipeline=True the ``LayerPipelineScheduler``
               interleaves two models' stages, prefill groups of distinct
               models included
        -> completions: release slot + pages + weight pin
  cancel(handle) -> frees KV pages and drops the weight pin at once
  drain() -> step until quiescent

Every split model (dense / moe / vlm) reads KV through ONE pool (device
KV bytes fixed by ``page_budget``) and FFN weights through ONE slab arena
(device FFN bytes fixed by ``slot_budget``); the engine holds no full
param tree for them.  The fused fallback families the split path does
not take (ssm and hybrid here) serve as the reference's do
(``engine.py:197-221``): a full device param tree and a dense per-model
cache, one prefill per request into its batch slot, K=1 decode of every
slot, and page accounting after each step.  Their prefill and decode take
the kernel routes (``impl="flash"`` / ``"paged"``, and the SSD scan); on
a card their decode step is one CUDA-graph replay too, in both lowering
modes (the reference jits it in both).

The engine runs on ``device="cuda"`` unless told otherwise and raises
when no card is present; ``device="cpu"`` runs the plain PyTorch
versions of the kernels and no graphs.  On a card every decode graph is
captured when the engine is built (a failed capture raises; nothing runs
the eager body instead), into one memory pool the engine's graphs share.

With ``config.elastic`` the KV/weights split is no longer frozen
(DESIGN.md §8): per-step telemetry feeds a windowed Eq. (1)-(2) re-plan,
and at the step boundary, after completions, the rebalancer may resize
the two pools — the KV pool shrinks through the host swap tier (cold
pages of idle requests fault back in on next touch), the arena by
evicting idle models, total device bytes conserved.  A move gives the
pool or the arena a new tensor, so every split model's decode graph is
captured again right there, before its next replay.

What is not ported yet raises ``NotImplementedError`` at construction:
the prefix cache, SLO monitoring, the flight recorder, the sanitizer,
observers, and the audio and sliding-window families.
"""
from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import (DEFAULT_DECODE_STEPS_PER_DISPATCH,
                                      EngineConfig, ModelConfig)
from repro_torch.core import split_exec
from repro_torch.core.admission import (AdmissionController, AdmissionStats,
                                        PendingRequest)
from repro_torch.core.control import (DecodeGraph, HostDrivenStep,
                                      MultiStepFusedStep, StreamingPrefill)
from repro_torch.core.elastic import ElasticRebalancer
from repro_torch.core.pipeline import InflightBatch, LayerPipelineScheduler
from repro_torch.core.pools import build_pools
from repro_torch.core.virtualizer import (DEFAULT_PAGE_BYTES, KVVirtualizer,
                                          OutOfPagesError)
from repro_torch.core.weight_pool import DEFAULT_SLAB_BYTES, OutOfSlabsError
from repro_torch.models.model import build_model
from repro_torch.models.transformer import init_params
from repro_torch.runtime.request import Phase, Request
from repro_torch.runtime.sampler import sample
from repro_torch.runtime.session import (HandleState, PrefillBatcher,
                                         PrefillGroup, RebalanceEvent,
                                         RequestHandle, TokenEvent)
from repro_torch.runtime.telemetry import DemandTelemetry


@dataclass
class EngineMode:
    pipeline: bool = True
    lowering: bool = True          # fused step vs host-driven per-layer
    # decode tokens committed per host dispatch (DESIGN.md §9)
    decode_steps_per_dispatch: int = DEFAULT_DECODE_STEPS_PER_DISPATCH


@dataclass
class EngineStats:
    tokens_out: int = 0
    wall_s: float = 0.0
    tbt: List[float] = field(default_factory=list)
    ttft: List[float] = field(default_factory=list)
    step_times: Dict[str, List[float]] = field(default_factory=dict)
    slow_steps: int = 0            # straggler-mitigation counter
    cancelled: int = 0             # requests cancelled through the session
    # batch size of every executed prefill pass (B > 1 = coalesced)
    prefill_batch_sizes: List[int] = field(default_factory=list)
    # (model, batch size, bucket, seconds) of every prefill pass
    prefill_times: List[Tuple[str, int, int, float]] = field(
        default_factory=list)
    admission: Optional[AdmissionStats] = None
    weights_pool: Dict[str, float] = field(default_factory=dict)
    # applied elastic boundary moves (empty when elastic is off)
    rebalance_events: List[RebalanceEvent] = field(default_factory=list)
    # telemetry + rebalancer snapshot folded in by finalize()
    elastic: Dict[str, float] = field(default_factory=dict)

    @property
    def throughput(self) -> float:
        return self.tokens_out / self.wall_s if self.wall_s else 0.0


def resolve_device(device) -> torch.device:
    """The engine's device: ``cuda`` must have a card; nothing falls back
    to the CPU unless the caller asked for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card is present; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class ModelRunner:
    """Per-model batch slots.

    ``paged`` (split models): NO per-model KV allocation and no param
    tree — prefill streams prompt KV into the virtualizer's pages layer by
    layer, decode reads and writes through page tables, FFN weights come
    from the arena.  Fallback families (``pooled.stage_fns is None``):
    the model's whole device tree (``pooled.kv_params``) and a dense cache
    of ``max_batch`` slots, as the reference's (``engine.py:197-221``).

    On a card the decode step is captured when the runner is built: the
    split models' ``MultiStepFusedStep`` under lowering=True, the fallback
    families' ``decode_body`` always (``graph``).  Host mode
    (lowering=False) decodes split models one token at a time through the
    engine's ``HostDrivenStep`` or its scheduler.
    """

    def __init__(self, name: str, cfg: ModelConfig, virt: KVVirtualizer, *,
                 max_batch: int, max_ctx: int, mode: EngineMode, pooled,
                 prefill_step: Optional[StreamingPrefill] = None,
                 graph_pool=None):
        self.name = name
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_ctx = max_ctx
        self.virt = virt
        self.device = virt.device
        self.paged = pooled.stage_fns is not None
        self.lengths = np.zeros(max_batch, np.int32)
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.next_tokens = np.zeros(max_batch, np.int32)
        #: NaN / infinite logits seen by this model's prefill and decode
        #: (a device counter: read it once a run is over)
        self.nonfinite_logits = torch.zeros((), dtype=torch.int64,
                                            device=self.device)
        self.fused: Optional[MultiStepFusedStep] = None
        self.decode_graph: Optional[DecodeGraph] = None
        on_card = self.device.type == "cuda"
        if self.paged:
            self.prefill_step = prefill_step
            self.view = virt.views[name]
            self.max_pages = max(
                1, math.ceil(max_ctx / self.view.tokens_per_page))
            # host-driven lowering keeps the per-token dispatch train, so
            # K > 1 is fused-only (``engine.py:190-196``)
            self.decode_steps = (max(1, int(mode.decode_steps_per_dispatch))
                                 if mode.lowering else 1)
            if mode.lowering:
                self.fused = MultiStepFusedStep(
                    pooled, k=self.decode_steps,
                    nonfinite_logits=self.nonfinite_logits,
                    graph_pool=graph_pool)
                if on_card:
                    self.fused.capture(max_batch, self.max_pages, virt.pool)
        else:
            self.params = pooled.kv_params
            self.decode_steps = 1          # the dense-cache path stays K=1
            self.model = build_model(cfg)
            self.cache = self.model.init_cache(max_batch, max_ctx,
                                               self.device)
            if on_card:
                i32 = dict(dtype=torch.int32, device=self.device)
                self.decode_graph = DecodeGraph(
                    self.decode_body,
                    dict(tokens=torch.zeros(max_batch, **i32),
                         lengths=torch.zeros(max_batch, **i32),
                         active=torch.zeros(max_batch, dtype=torch.bool,
                                            device=self.device)),
                    restore=[*self.cache.values(), self.nonfinite_logits],
                    pool=graph_pool)

    # ------------------------------------------------------------------
    @property
    def graph(self) -> Optional[DecodeGraph]:
        """This model's decode graph (None on the CPU and for split models
        in host mode)."""
        return self.fused.graph if self.fused is not None \
            else self.decode_graph

    def free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    @property
    def active(self) -> bool:
        return any(s is not None for s in self.slots)

    def _active_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is not None]

    def _tensor(self, array: np.ndarray) -> torch.Tensor:
        """A device COPY of a host array (``torch.tensor`` never aliases,
        and the host arrays keep changing between steps)."""
        return torch.tensor(array, device=self.device)

    # ------------------------------------------------------------------
    # prefill: one [B, S] pass per coalesced group
    # ------------------------------------------------------------------
    def _group_writer(self, group: PrefillGroup):
        """Per-layer pool writer storing EVERY row's prompt KV into its
        own request's pages."""

        def writer(layer, layer_kv, pool):
            for i, (req, n_w) in enumerate(zip(group.requests,
                                               group.n_writes)):
                pool = self.virt.write_prompt_layer(
                    pool, self.name, req.request_id, layer, layer_kv, n_w,
                    batch_index=i)
            return pool

        return writer

    def _commit_prefill(self, req: Request, tok: int) -> int:
        slot = self.free_slot()
        if slot is None:
            raise RuntimeError(f"{self.name}: no free batch slot")
        self.slots[slot] = req
        self.lengths[slot] = req.prompt_tokens
        self.next_tokens[slot] = tok
        req.phase = Phase.DECODE
        req.output_ids.append(tok)       # the prefill-sampled first token
        return slot

    def _commit_group(self, group: PrefillGroup, logits: torch.Tensor
                      ) -> List[int]:
        self.nonfinite_logits += (~torch.isfinite(logits)).sum()
        toks = sample(logits).cpu().numpy()
        return [self._commit_prefill(req, int(toks[i]))
                for i, req in enumerate(group.requests)]

    def _check_room(self, group: PrefillGroup) -> None:
        free = sum(1 for s in self.slots if s is None)
        if group.batch_size > free:
            raise RuntimeError(f"{self.name}: group of {group.batch_size} "
                               f"for {free} free slots")

    def prefill_group(self, group: PrefillGroup) -> List[int]:
        """Execute one coalesced prompt pass (fallback families: one pass
        per row) and commit each row to a batch slot; returns the slots
        in row order."""
        self._check_room(group)
        if not self.paged:
            return [self._prefill_row(ids, req)
                    for ids, req in zip(group.ids, group.requests)]
        for req in group.requests:
            self.virt.ensure_resident(req.request_id)
        logits, self.virt.pool = self.prefill_step(
            self._tensor(group.tokens()), group.true_lens(), self.virt.pool,
            self._group_writer(group))
        return self._commit_group(group, logits)

    def make_prefill_batch(self, group: PrefillGroup,
                           batch_id: int) -> InflightBatch:
        """Package one group's prompt phase for the layer-wise scheduler
        (it interleaves with other models' stages)."""
        self._check_room(group)
        for req in group.requests:
            self.virt.ensure_resident(req.request_id)
        return InflightBatch(
            batch_id=batch_id, model=self.name,
            tokens=self._tensor(group.tokens()), prefill=True,
            true_len=group.true_lens(), kv_writer=self._group_writer(group))

    def apply_prefill_result(self, batch: InflightBatch,
                             group: PrefillGroup) -> List[int]:
        return self._commit_group(group, batch.logits)

    def _prefill_row(self, ids: np.ndarray, req: Request) -> int:
        """Fallback families: the whole bucket (padding included) into the
        request's batch slot of the dense cache, logits read at the last
        real token (``engine.py:197-210,378-388``)."""
        slot = self.free_slot()
        one = {k: c[:, slot:slot + 1] for k, c in self.cache.items()}
        logits, _ = self.model.prefill(
            self.params, self._tensor(ids[None, :]), one, impl="flash",
            logit_index=req.prompt_tokens - 1)
        self.nonfinite_logits += (~torch.isfinite(logits)).sum()
        return self._commit_prefill(req, int(sample(logits)[0]))

    # ------------------------------------------------------------------
    # decode: issue (no read-back) / commit (read back + bookkeeping)
    # ------------------------------------------------------------------
    def _reserve_decode_block(self) -> Tuple[List[int], np.ndarray]:
        """Pre-map every active request's pages for this dispatch's block
        of ``min(K, remaining output, context headroom)`` tokens — atomic
        across the batch (DESIGN.md §9)."""
        act = self._active_slots()
        steps = np.zeros(self.max_batch, np.int32)
        for i in act:
            self.virt.ensure_resident(self.slots[i].request_id)
        for i in act:
            req = self.slots[i]
            steps[i] = max(1, min(self.decode_steps,
                                  req.max_new_tokens - req.generated,
                                  self.max_ctx - int(self.lengths[i])))
        need = sum(self.virt.pages_needed_for_extend(
            self.slots[i].request_id, int(steps[i])) for i in act)
        if need > self.virt.free_pages:
            raise OutOfPagesError(
                f"{self.name}: decode block needs {need} pages, "
                f"{self.virt.free_pages} free — raise page_budget")
        for i in act:
            self.virt.reserve_decode_block(self.slots[i].request_id,
                                           int(steps[i]))
        return act, steps

    def _rids(self) -> List[Optional[int]]:
        return [s.request_id if s is not None else None for s in self.slots]

    def _eos_ids(self) -> np.ndarray:
        eos = np.full(self.max_batch, -1, np.int32)
        for i, req in enumerate(self.slots):
            if req is not None and req.eos_id is not None:
                eos[i] = req.eos_id
        return eos

    def prepare_step(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                    List[int], np.ndarray]:
        """(tokens, page_tables [L,B,P], lengths, active slots, per-slot
        step budget [max_batch]) on the device, for a host-driven step."""
        act, steps = self._reserve_decode_block()
        tables = self.virt.batch_tables(self.name, self._rids(),
                                        self.max_pages)
        return (self._tensor(self.next_tokens), tables,
                self._tensor(self.lengths), act, steps)

    def decode_body(self, tokens: torch.Tensor, lengths: torch.Tensor,
                    active: torch.Tensor) -> torch.Tensor:
        """Fallback families: one decode step of every slot (the dense
        cache updated in place), the non-finite logits of the ``active``
        rows counted, greedy tokens [1, B] int32.  What the fallback graph
        holds; eager on the CPU."""
        logits, _ = self.model.decode_step(self.params, tokens, self.cache,
                                           lengths, impl="paged")
        self.nonfinite_logits += (~torch.isfinite(logits)
                                  & active[:, None]).sum()
        return sample(logits)[None, :]

    def issue_decode(self, host_step: Optional[HostDrivenStep] = None
                     ) -> Tuple[torch.Tensor, List[int], np.ndarray]:
        """Run one decode block for all slots; returns (token ids [K, B]
        on the device, not read back yet; active slots; step budgets).
        Fallback families decode one token for EVERY slot, inactive ones
        included, as the reference's (``engine.py:489-495``).  On a card
        a lowering=True block (and every fallback step) is ONE graph
        replay, its inputs copied in from host arrays: the block makes no
        host read."""
        if not self.paged:
            act = self._active_slots()
            active = np.zeros(self.max_batch, bool)
            active[act] = True
            inputs = dict(tokens=self.next_tokens, lengths=self.lengths,
                          active=active)
            if self.decode_graph is not None:
                toks = self.decode_graph(**inputs)
            else:
                toks = self.decode_body(**{k: self._tensor(v)
                                           for k, v in inputs.items()})
            steps = np.zeros(self.max_batch, np.int32)
            steps[act] = 1
            return toks, act, steps
        if host_step is not None:
            # lowering=False: per-layer host dispatches, K=1, logits
            # sampled by the runtime's one sampler
            tokens, tables, lengths, act, steps = self.prepare_step()
            logits, self.virt.pool = host_step(tokens, self.virt.pool,
                                               tables, lengths)
            self.nonfinite_logits += (~torch.isfinite(logits)).sum()
            return sample(logits)[None, :], act, steps
        act, steps = self._reserve_decode_block()
        tables = self.virt.batch_tables_host(self.name, self._rids(),
                                             self.max_pages)
        toks, self.virt.pool = self.fused(
            self.next_tokens, self.virt.pool, tables, self.lengths, steps,
            self._eos_ids())
        return toks, act, steps

    def commit_decode(self, pending) -> Tuple[np.ndarray, np.ndarray,
                                              List[int]]:
        """Read a block back and commit it: token/length state and the
        page-table commit (unused reserved pages return to the pool).
        Returns (tokens [B, K], per-slot valid counts, active slots)."""
        toks_dev, act, _ = pending
        toks = toks_dev.cpu().numpy().T                     # [B, K]
        counts = np.zeros(self.max_batch, np.int64)
        for i in act:
            row = toks[i]
            n = int((row >= 0).sum())
            counts[i] = n
            if n:
                self.lengths[i] += n
                self.next_tokens[i] = row[n - 1]
            rid = self.slots[i].request_id
            if self.paged:
                self.virt.commit_decode_block(rid, n)
            else:
                # fallback families: page accounting AFTER the step (their
                # KV lives in the dense cache; pages track budget only)
                self.virt.extend_request(rid, n)
        return toks, counts, act

    # ------------------------------------------------------------------
    def make_inflight_batch(self, batch_id: int
                            ) -> Tuple[InflightBatch, List[int]]:
        """Package this model's slots for the layer-wise scheduler."""
        tokens, tables, lengths, act, _ = self.prepare_step()
        return InflightBatch(batch_id=batch_id, model=self.name,
                             tokens=tokens, page_tables=tables,
                             lengths=lengths), act

    def apply_pipeline_result(self, batch: InflightBatch, act: List[int]
                              ) -> Tuple[np.ndarray, np.ndarray, List[int]]:
        """Write back a batch the scheduler completed (its KV is already
        in the pool): one token per active slot (host mode is K=1)."""
        self.nonfinite_logits += (~torch.isfinite(batch.logits)).sum()
        return self.commit_decode((sample(batch.logits)[None, :], act, None))

    def release(self, slot: int) -> Request:
        req = self.slots[slot]
        self.slots[slot] = None
        return req


class CrossPoolEngine:
    """The serving session: ``submit`` / ``step`` / ``cancel`` / ``drain``.

    ``params`` (optional) maps model name -> param tree in the layout of
    ``repro_torch.models.transformer.init_params`` (tests pass the
    reference's trees through ``repro_torch.bridge``); the engine splits
    them into the pools and keeps no full tree.  Without it each model's
    weights are drawn on the engine's device from
    ``torch.Generator(seed + i)``, in model order.
    """

    def __init__(self, models: Dict[str, ModelConfig], *,
                 page_budget: int, page_bytes: int = DEFAULT_PAGE_BYTES,
                 slot_budget: Optional[int] = None,
                 slab_bytes: int = DEFAULT_SLAB_BYTES,
                 max_batch: int = 4, max_ctx: int = 256,
                 config: Optional[EngineConfig] = None, seed: int = 0,
                 observer=None,
                 params: Optional[Dict[str, Dict]] = None,
                 device="cuda"):
        config = config or EngineConfig()
        for name, value in (
                ("the prefix cache",
                 config.cache is not None and config.cache.enabled),
                ("the sanitizer", config.sanitize
                 or os.environ.get("CROSSPOOL_SANITIZE", "") == "1"),
                ("SLO monitoring", config.slo is not None),
                ("the flight recorder",
                 config.flightrec is not None and config.flightrec.enabled),
                ("engine observers", observer is not None)):
            if value:
                raise NotImplementedError(f"{name}: not ported yet")
        self.mode = config.mode or EngineMode()
        for name, cfg in models.items():
            if not split_exec.supports_split(cfg) \
                    and cfg.family not in ("ssm", "hybrid"):
                raise NotImplementedError(
                    f"{name} ({cfg.family}"
                    f"{', sliding window' if cfg.swa_pattern else ''}): its "
                    f"fused fallback path is not ported yet")
        self.device = resolve_device(device)
        self.models = models
        self.max_ctx = max_ctx
        # synthetic prompt ids: the reference's numpy stream, same draws
        self.rng = np.random.default_rng(seed)

        if params is None:
            params = {}
            for i, (n, c) in enumerate(models.items()):
                gen = torch.Generator(device=self.device)
                gen.manual_seed(seed + i)
                params[n] = init_params(gen, c)
        else:
            missing = set(models) - set(params)
            if missing:
                raise KeyError(f"params missing for {sorted(missing)}")
            params = dict(params)      # build_pools consumes its argument
        # the pool dtype is the lowest common denominator of the models
        pool_dtype = (torch.float32
                      if any(c.dtype == "float32" for c in models.values())
                      else torch.bfloat16)
        self.kv_pool, self.w_pool, self.pooled = build_pools(
            models, params, device=self.device, page_budget=page_budget,
            page_bytes=page_bytes, pool_dtype=pool_dtype,
            slot_budget=slot_budget, slab_bytes=slab_bytes,
            # models become resident when their first request reaches a
            # batch slot (cold-model activation)
            activate_resident=False)
        self.virt = self.kv_pool.virtualizer
        # an all-fallback engine has no device pool and no arena
        any_split = any(p.stage_fns is not None for p in self.pooled.values())
        self.arena = self.w_pool.arena if any_split else None
        self.admission = AdmissionController(self.virt, arena=self.arena)
        # the elastic boundary (DESIGN.md §8): windowed demand telemetry
        # and the step-boundary rebalancer, both None on a frozen split
        self.telemetry: Optional[DemandTelemetry] = None
        self.rebalancer: Optional[ElasticRebalancer] = None
        if config.elastic is not None and self.arena is not None:
            self.telemetry = DemandTelemetry(models, config.elastic)
            self.rebalancer = ElasticRebalancer(
                self.virt, self.arena, admission=self.admission,
                telemetry=self.telemetry, cfg=config.elastic, seed=seed)
        on_card = self.device.type == "cuda"
        # host mode on a card: FFN stages run on the weights stream
        self.w_stream = (torch.cuda.Stream(self.device)
                         if on_card and not self.mode.lowering else None)
        self.host_steps: Optional[Dict[str, HostDrivenStep]] = None
        self.scheduler: Optional[LayerPipelineScheduler] = None
        if not self.mode.lowering:
            self.host_steps = {
                n: HostDrivenStep(self.pooled[n], self.w_stream)
                for n in models if self.pooled[n].stage_fns is not None}
            self.scheduler = LayerPipelineScheduler(self.pooled,
                                                    self.w_stream)
        # the engine's decode graphs share one memory pool (they replay
        # one at a time on one stream)
        graph_pool = torch.cuda.graph_pool_handle() if on_card else None
        self.runners = {
            n: ModelRunner(n, c, self.virt, max_batch=max_batch,
                           max_ctx=max_ctx, mode=self.mode,
                           pooled=self.pooled[n],
                           prefill_step=StreamingPrefill(self.pooled[n],
                                                         self.w_stream)
                           if self.pooled[n].stage_fns is not None else None,
                           graph_pool=graph_pool)
            for n, c in models.items()
        }
        self.stats = EngineStats(step_times={n: [] for n in models},
                                 admission=self.admission.stats)

        # --- session state -------------------------------------------------
        self.now = 0.0
        self.batcher = PrefillBatcher()
        self.handles: Dict[int, RequestHandle] = {}
        self.waiting: List[Request] = []     # admitted, no batch slot yet
        self._submitted: Dict[int, Request] = {}
        self._window: set = set()            # request ids in the stats window
        self._events: List[TokenEvent] = []
        self._in_step = False
        self._deferred_cancels: List[RequestHandle] = []

    # ------------------------------------------------------------------
    # the session API
    # ------------------------------------------------------------------
    def advance(self, now: float) -> float:
        """Move the session clock forward (it never runs backwards)."""
        self.now = max(self.now, float(now))
        return self.now

    def submit(self, req: Request, on_token=None) -> RequestHandle:
        """Offer one request to the front door at the engine's current
        time; the admission verdict is on the returned handle."""
        if req.request_id in self._submitted:
            raise ValueError(f"request id {req.request_id} already "
                             f"submitted")
        self._submitted[req.request_id] = req
        self._window.add(req.request_id)
        if self.telemetry is not None:
            self.telemetry.note_arrival(req.model, self.now)
        outcome = self._admit(req, self.now)
        if outcome == "admitted":
            req.admit_time = self.now
            self.waiting.append(req)
            state = HandleState.ADMITTED
        elif outcome == "queued":
            state = HandleState.QUEUED
        else:
            state = HandleState.REJECTED
        handle = RequestHandle(request=req, admission=outcome, state=state,
                               on_token=on_token, _engine=self)
        self.handles[req.request_id] = handle
        return handle

    def step(self, now: Optional[float] = None) -> List[TokenEvent]:
        """One engine step: drain -> batched prefill -> decode ->
        completions.  Returns the tokens generated this step."""
        if now is not None:
            self.now = max(self.now, float(now))
        self._events = []
        self._in_step = True
        try:
            self._step_phases()
        finally:
            self._in_step = False
            deferred, self._deferred_cancels = self._deferred_cancels, []
            for handle in deferred:     # reentrant cancels, now safe
                self.cancel(handle)
        return self._events

    def _drain_front_door(self) -> None:
        for p in self.admission.drain(self.now):
            req = self._submitted[p.request_id]
            req.admit_time = self.now
            self.handles[req.request_id].state = HandleState.ADMITTED
            self.waiting.append(req)

    def _step_phases(self) -> None:
        self._drain_front_door()
        groups, self.waiting = self.batcher.plan(
            self.waiting, self.runners, self.rng, self._try_activate)
        if groups:
            self.now = self._prefill_groups(groups, self.now)
        active = [n for n, r in self.runners.items() if r.active]
        if self.mode.pipeline and len(active) >= 2:
            self.now = self._decode_pipelined(active, self.now)
        else:
            for n in active:
                self.now = self._decode_model(n, self.now)
        for runner in self.runners.values():
            for slot, req in enumerate(runner.slots):
                if req is not None and req.done:
                    runner.release(slot)
                    self._finish(req, self.now)
        # the elastic boundary: no block is in flight, so page tables,
        # slot tables and decode graphs can all be remapped here
        if self.telemetry is not None:
            self._observe_and_rebalance()

    def _observe_and_rebalance(self) -> None:
        """Fold this step into the telemetry window and let the
        rebalancer repartition the device-byte boundary if the windowed
        Eq. (1)-(2) estimate says so (reference ``engine.py:971``); then
        capture again every decode graph whose pool or arena moved."""
        self.telemetry.observe(self.now, self.virt, self.arena,
                               self.admission)
        protected: Dict[int, int] = {}
        live: Optional[Dict[str, list]] = None
        if self.rebalancer.would_evaluate():
            # slotted requests with their REMAINING declared output: the
            # KV shrink floor reserves their whole lifetime, as admission
            # did
            protected = {
                req.request_id: max(req.max_new_tokens - req.generated, 1)
                for runner in self.runners.values()
                for req in runner.slots if req is not None}
            live = {}
            for req in self.waiting:
                live.setdefault(req.model, []).append(
                    (req.prompt_tokens, req.max_new_tokens))
            for runner in self.runners.values():
                for req in runner.slots:
                    if req is not None:
                        live.setdefault(req.model, []).append(
                            (req.prompt_tokens, req.max_new_tokens))
            # queued requests are exactly what the old split could not
            # admit: the clearest demand signal
            for q in self.admission.queues.values():
                for p in q:
                    live.setdefault(p.model, []).append(
                        (p.prompt_tokens, p.expected_output))
        decision = self.rebalancer.step(self.now, protected=protected,
                                        live_requests=live)
        # an aborted move may have resized one pool already: the check is
        # by address, whatever the decision
        for runner in self.runners.values():
            if runner.fused is not None:
                runner.fused.recapture(self.virt.pool)
        if decision is None:
            return
        # the budgets just changed: re-drain the front door now, so a
        # session whose load was all queued behind the old split makes
        # progress this step
        self._drain_front_door()
        self.stats.rebalance_events.append(RebalanceEvent(
            step=decision.step, time=decision.now,
            page_budget=(decision.old_page_budget, decision.new_page_budget),
            slot_budget=(decision.old_slot_budget, decision.new_slot_budget),
            kv_delta_bytes=(decision.new_page_budget
                            - decision.old_page_budget)
            * self.virt.page_bytes,
            swapped_out=decision.swapped_out,
            evicted_models=decision.evicted_models,
            reason=decision.reason))

    def cancel(self, handle: Union[RequestHandle, int]) -> bool:
        """Abort a submitted request, returning its resources in one host
        transaction; a cancel from inside a step (an ``on_token``
        callback) is deferred to the step boundary."""
        if isinstance(handle, int):
            handle = self.handles[handle]
        if handle.state.terminal:
            return False
        if self._in_step:
            if handle not in self._deferred_cancels:
                self._deferred_cancels.append(handle)
            return True
        req = handle.request
        if handle.state is HandleState.QUEUED:
            self.admission.cancel_queued(req.request_id)
        else:
            if handle.state is HandleState.DECODING:
                runner = self.runners[req.model]
                for slot, r in enumerate(runner.slots):
                    if r is req:
                        runner.release(slot)
                        break
            else:                            # ADMITTED: waiting for a slot
                self.waiting = [r for r in self.waiting
                                if r.request_id != req.request_id]
            self.virt.release_request(req.request_id)
            self.admission.finish(req.model)
        req.phase = Phase.CANCELLED
        req.finish_time = self.now
        handle.state = HandleState.CANCELLED
        self.stats.cancelled += 1
        return True

    def drain(self, *, max_steps: int = 10_000) -> EngineStats:
        """Step until every submitted request finished (or nothing can
        make progress / ``max_steps``); returns the finalized stats."""
        steps = 0
        while (self.waiting or self.admission.queued_count()
               or self._any_active()):
            if steps >= max_steps:
                break
            steps += 1
            events = self.step()
            if not events and not self.waiting and not self._any_active():
                break     # only queued requests remain: no progress possible
        return self.finalize()

    def finalize(self) -> EngineStats:
        """Fold per-request latency samples into the stats snapshot."""
        self.stats.wall_s = self.now
        self.stats.tbt = [t for rid in self._window
                          for t in self._submitted[rid].tbt_samples()]
        if self.arena is not None:
            self.stats.weights_pool = self.arena.utilization()
        if self.telemetry is not None:
            self.stats.elastic = self.telemetry.snapshot()
            self.stats.elastic.update(self.rebalancer.snapshot())
        return self.stats

    def run(self, requests: List[Request], *,
            max_steps: int = 10_000) -> EngineStats:
        """Serve a pre-generated trace to completion: submits arrivals
        when due and calls ``step``."""
        pending = sorted(requests, key=lambda r: r.arrival_time)
        steps = 0
        while (pending or self.waiting or self.admission.queued_count()
               or self._any_active()):
            if steps >= max_steps:
                break
            steps += 1
            if not self.waiting and not self._any_active() and pending:
                self.advance(pending[0].arrival_time)
            due = [r for r in pending if r.arrival_time <= self.now]
            pending = [r for r in pending if r.arrival_time > self.now]
            for r in due:
                self.submit(r)
            events = self.step()
            if (not events and not self.waiting and not pending
                    and not self._any_active()):
                break
        return self.finalize()

    # ------------------------------------------------------------------
    def _any_active(self) -> bool:
        return any(r.active for r in self.runners.values())

    def _try_activate(self, req: Request) -> bool:
        """Residency gate for the prefill batcher: map a cold model's
        slabs (no upload — prefill streams them in) and fault the
        request's swapped pages back in; False keeps the request waiting
        (until pinned models finish, or pages free up).  Fallback
        families never enter the arena."""
        if self.arena is None or not self.runners[req.model].paged:
            return True
        try:
            self.arena.activate(req.model, upload=False)
        except OutOfSlabsError:
            if self.arena.views[req.model].total_slabs \
                    > self.arena.slot_budget:
                raise
            return False
        # pages a shrink pushed to the host tier while the request waited
        # fault back in HERE, where deferral is graceful: one free page
        # for each swapped entry, or the request keeps waiting
        if self.virt.requests[req.request_id].n_swapped \
                > self.virt.free_pages:
            return False
        self.virt.ensure_resident(req.request_id)
        return True

    def _admit(self, req: Request, now: float) -> str:
        pending = PendingRequest(req.request_id, req.model,
                                 req.prompt_tokens, req.max_new_tokens, now)
        outcome = self.admission.offer(pending, now)
        if outcome == "rejected":
            req.phase = Phase.REJECTED
        return outcome

    def _finish(self, req: Request, now: float) -> None:
        req.phase = Phase.FINISHED
        req.finish_time = now
        if self.telemetry is not None:
            self.telemetry.note_finish(req.model, req.prompt_tokens,
                                       req.generated, req.admit_time, now)
        self.virt.release_request(req.request_id)
        self.admission.finish(req.model)      # drops the weight pin too
        handle = self.handles.get(req.request_id)
        if handle is not None:
            handle.state = HandleState.FINISHED

    # ------------------------------------------------------------------
    def _record_step(self, name: str, dt: float) -> None:
        log = self.stats.step_times[name]
        if len(log) > 8 and dt > np.median(log) * 4.0:
            self.stats.slow_steps += 1     # straggler flag
        log.append(dt)

    def _emit(self, event: TokenEvent) -> None:
        self._events.append(event)
        handle = self.handles.get(event.request_id)
        if handle is not None and handle.on_token is not None:
            handle.on_token(event)

    def _book_tokens(self, runner: ModelRunner, toks: np.ndarray,
                     counts: np.ndarray, act: List[int], start: float,
                     dt: float) -> None:
        """Fan one committed decode block out into per-token events; the
        block's wall time is spread over each row's tokens."""
        for i in act:
            req = runner.slots[i]
            n = int(counts[i])
            for t in range(n):
                tok = int(toks[i, t])
                req.generated += 1
                req.output_ids.append(tok)
                when = start + dt * (t + 1) / n
                req.token_times.append(when)
                self.stats.tokens_out += 1
                if req.eos_id is not None and tok == req.eos_id:
                    req.eos_seen = True
                self._emit(TokenEvent(
                    request_id=req.request_id, model=req.model,
                    token=tok, index=req.generated - 1, time=when,
                    done=req.done))

    def _book_first_token(self, req: Request, now: float) -> None:
        req.first_token_time = now
        req.token_times.append(now)
        req.generated += 1
        self.stats.tokens_out += 1
        self.stats.ttft.append(now - req.arrival_time)
        handle = self.handles.get(req.request_id)
        if handle is not None:
            handle.state = HandleState.DECODING
        self._emit(TokenEvent(
            request_id=req.request_id, model=req.model,
            token=req.output_ids[-1], index=0, time=now, first=True,
            done=req.done))

    # ------------------------------------------------------------------
    def _host_step(self, name: str) -> Optional[HostDrivenStep]:
        if self.host_steps is None:
            return None
        return self.host_steps.get(name)

    def _prefill_groups(self, groups: List[PrefillGroup],
                        now: float) -> float:
        """Execute the coalesced groups.  In host-driven pipeline mode the
        first group of each of two or more models interleaves through the
        layer-wise scheduler (model A's layer-L attention beside model B's
        FFN); everything else runs the sequential streaming path, one
        [B, S] pass per group, each ending with its first tokens read back
        (so ``dt`` is device time too)."""
        self.stats.prefill_batch_sizes.extend(g.batch_size for g in groups)
        if self.scheduler is not None and self.mode.pipeline:
            first: Dict[str, PrefillGroup] = {}
            rest: List[PrefillGroup] = []
            for g in groups:
                # suffix groups stay on the streaming path (the scheduler
                # has no suffix stage)
                if (self.runners[g.model].paged and g.model not in first
                        and g.fork == 0):
                    first[g.model] = g
                else:
                    rest.append(g)
            if len(first) >= 2:
                now = self._prefill_pipelined(list(first.values()), now)
                groups = rest
        for g in groups:
            t0 = time.perf_counter()
            self.runners[g.model].prefill_group(g)
            dt = time.perf_counter() - t0
            now += dt
            self.stats.prefill_times.append((g.model, g.batch_size,
                                             g.bucket, dt))
            for req in g.requests:
                self._book_first_token(req, now)
        return now

    def _prefill_pipelined(self, groups: List[PrefillGroup],
                           now: float) -> float:
        """Concurrent cold-model prompt phases through the scheduler."""
        t0 = time.perf_counter()
        batches = [self.runners[g.model].make_prefill_batch(g, i)
                   for i, g in enumerate(groups)]
        done, self.virt.pool = self.scheduler.run(batches, self.virt.pool,
                                                  max_inflight=2)
        by_model = {g.model: g for g in groups}
        for b in done:
            self.runners[b.model].apply_prefill_result(b, by_model[b.model])
        dt = time.perf_counter() - t0
        now += dt
        for b in done:
            g = by_model[b.model]
            self.stats.prefill_times.append((g.model, g.batch_size,
                                             g.bucket, dt))
            for req in g.requests:
                self._book_first_token(req, now)
        return now

    def _decode_model(self, name: str, now: float) -> float:
        runner = self.runners[name]
        t0 = time.perf_counter()
        toks, counts, act = runner.commit_decode(
            runner.issue_decode(self._host_step(name)))
        dt = time.perf_counter() - t0
        self._record_step(name, dt)
        self._book_tokens(runner, toks, counts, act, now, dt)
        return now + dt

    def _decode_pipelined(self, active: List[str], now: float) -> float:
        """Two or more models stepped with overlapping execution.

        lowering=True: every active model's decode block (one replay on a
        card) is issued before any is read back (the shared pool threads
        through them in order).  lowering=False: the layer-wise scheduler
        interleaves the models' attention and FFN stages (paper Fig. 4)."""
        if not self.mode.lowering:
            return self._decode_pipelined_host(active, now)
        t0 = time.perf_counter()
        issued = [(n, self.runners[n].issue_decode()) for n in active]
        dt_all = 0.0
        for n, pending in issued:
            runner = self.runners[n]
            toks, counts, act = runner.commit_decode(pending)
            dt_all = time.perf_counter() - t0
            self._book_tokens(runner, toks, counts, act, now, dt_all)
        for n in active:
            self._record_step(n, dt_all / len(active))
        return now + dt_all

    def _decode_pipelined_host(self, active: List[str], now: float) -> float:
        """The layer-wise two-batch pipeline over the two pools; fallback
        families step after it, one replay each."""
        t0 = time.perf_counter()
        paged = [n for n in active if self.runners[n].paged]
        fallback = [n for n in active if not self.runners[n].paged]
        batches, acts = [], {}
        for i, n in enumerate(paged):
            batch, acts[n] = self.runners[n].make_inflight_batch(i)
            batches.append(batch)
        done, self.virt.pool = self.scheduler.run(batches, self.virt.pool,
                                                  max_inflight=2)
        results = [(b.model, self.runners[b.model].apply_pipeline_result(
            b, acts[b.model])) for b in done]
        dt_all = time.perf_counter() - t0
        for n, (toks, counts, act) in results:
            self._book_tokens(self.runners[n], toks, counts, act, now,
                              dt_all)
            self._record_step(n, dt_all / max(len(paged), 1))
        now += dt_all
        for n in fallback:          # families outside split execution
            now = self._decode_model(n, now)
        return now
