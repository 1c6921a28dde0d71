"""CrossPool serving engine: an online, continuously-batched session API.

Port of ``src/repro/runtime/engine.py`` under its default lowering
(control lowering ON, any K decode tokens per dispatch):

  submit(request) -> AdmissionController verdict on the returned handle
  step(now)
        -> drain the front-door queue
        -> PrefillBatcher: coalesce admitted same-model arrivals into ONE
           [B, S] StreamingPrefill pass per (model, prompt-bucket) group;
           prompt KV lands in the SHARED paged pool
        -> decode: one ``MultiStepFusedStep`` call per active model, K
           tokens each, greedy sampling on the device (with pipeline=True
           every model's block is issued before any is read back)
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
the kernel routes (``impl="flash"`` / ``"paged"``, and the SSD scan).

The engine runs on ``device="cuda"`` unless told otherwise and raises
when no card is present; ``device="cpu"`` runs the plain PyTorch
versions of the kernels.  What is not ported yet raises
``NotImplementedError`` at construction: ``lowering=False`` (the
host-driven step and the layer pipeline scheduler), the elastic
rebalancer, the prefix cache, SLO monitoring, the flight recorder, the
sanitizer, observers, and the audio and sliding-window families.
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
from repro_torch.core.control import MultiStepFusedStep, StreamingPrefill
from repro_torch.core.pools import build_pools
from repro_torch.core.virtualizer import (DEFAULT_PAGE_BYTES, KVVirtualizer,
                                          OutOfPagesError)
from repro_torch.core.weight_pool import DEFAULT_SLAB_BYTES, OutOfSlabsError
from repro_torch.models.model import build_model
from repro_torch.models.transformer import init_params
from repro_torch.runtime.request import Phase, Request
from repro_torch.runtime.sampler import sample
from repro_torch.runtime.session import (HandleState, PrefillBatcher,
                                         PrefillGroup, RequestHandle,
                                         TokenEvent)


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
    """

    def __init__(self, name: str, cfg: ModelConfig, virt: KVVirtualizer, *,
                 max_batch: int, max_ctx: int, mode: EngineMode, pooled,
                 prefill_step: Optional[StreamingPrefill] = None):
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
        if self.paged:
            self.prefill_step = prefill_step
            self.view = virt.views[name]
            self.max_pages = max(
                1, math.ceil(max_ctx / self.view.tokens_per_page))
            self.decode_steps = max(1, int(mode.decode_steps_per_dispatch))
            self.fused = MultiStepFusedStep(
                pooled, k=self.decode_steps,
                nonfinite_logits=self.nonfinite_logits)
        else:
            self.params = pooled.kv_params
            self.decode_steps = 1          # the dense-cache path stays K=1
            self.model = build_model(cfg)
            self.cache = self.model.init_cache(max_batch, max_ctx,
                                               self.device)

    # ------------------------------------------------------------------
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

    def prefill_group(self, group: PrefillGroup) -> List[int]:
        """Execute one coalesced prompt pass (fallback families: one pass
        per row) and commit each row to a batch slot; returns the slots
        in row order."""
        free = sum(1 for s in self.slots if s is None)
        if group.batch_size > free:
            raise RuntimeError(f"{self.name}: group of {group.batch_size} "
                               f"for {free} free slots")
        if not self.paged:
            return [self._prefill_row(ids, req)
                    for ids, req in zip(group.ids, group.requests)]
        for req in group.requests:
            self.virt.ensure_resident(req.request_id)
        logits, self.virt.pool = self.prefill_step(
            self._tensor(group.tokens()), group.true_lens(), self.virt.pool,
            self._group_writer(group))
        self.nonfinite_logits += (~torch.isfinite(logits)).sum()
        toks = sample(logits).cpu().numpy()
        return [self._commit_prefill(req, int(toks[i]))
                for i, req in enumerate(group.requests)]

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

    def _eos_ids(self) -> np.ndarray:
        eos = np.full(self.max_batch, -1, np.int32)
        for i, req in enumerate(self.slots):
            if req is not None and req.eos_id is not None:
                eos[i] = req.eos_id
        return eos

    def issue_decode(self) -> Tuple[torch.Tensor, List[int], np.ndarray]:
        """Run one decode block for all slots; returns (token ids [K, B]
        on the device, not read back yet; active slots; step budgets).
        Fallback families decode one token for EVERY slot, inactive ones
        included, as the reference's (``engine.py:489-495``)."""
        if not self.paged:
            act = self._active_slots()
            logits, _ = self.model.decode_step(
                self.params, self._tensor(self.next_tokens), self.cache,
                self._tensor(self.lengths), impl="paged")
            self.nonfinite_logits += (~torch.isfinite(logits[act])).sum()
            steps = np.zeros(self.max_batch, np.int32)
            steps[act] = 1
            return sample(logits)[None, :], act, steps
        act, steps = self._reserve_decode_block()
        rids = [s.request_id if s is not None else None for s in self.slots]
        tables = self.virt.batch_tables(self.name, rids, self.max_pages)
        toks, self.virt.pool = self.fused(
            self._tensor(self.next_tokens), self.virt.pool, tables,
            self._tensor(self.lengths), self._tensor(steps),
            self._tensor(self._eos_ids()))
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
                ("the elastic rebalancer", config.elastic is not None),
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
        if not self.mode.lowering:
            raise NotImplementedError(
                "lowering=False (HostDrivenStep and the layer pipeline "
                "scheduler) is not ported yet")
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
        self.runners = {
            n: ModelRunner(n, c, self.virt, max_batch=max_batch,
                           max_ctx=max_ctx, mode=self.mode,
                           pooled=self.pooled[n],
                           prefill_step=StreamingPrefill(self.pooled[n])
                           if self.pooled[n].stage_fns is not None else None)
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
        slabs (no upload — prefill streams them in); False keeps the
        request waiting until pinned models finish.  Fallback families
        never enter the arena."""
        if self.arena is None or not self.runners[req.model].paged:
            return True
        try:
            self.arena.activate(req.model, upload=False)
        except OutOfSlabsError:
            if self.arena.views[req.model].total_slabs \
                    > self.arena.slot_budget:
                raise
            return False
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
    def _prefill_groups(self, groups: List[PrefillGroup],
                        now: float) -> float:
        """One [B, S] streaming pass per group, in order; each pass ends
        with its first tokens read back, so ``dt`` is device time too."""
        self.stats.prefill_batch_sizes.extend(g.batch_size for g in groups)
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

    def _decode_model(self, name: str, now: float) -> float:
        runner = self.runners[name]
        t0 = time.perf_counter()
        toks, counts, act = runner.commit_decode(runner.issue_decode())
        dt = time.perf_counter() - t0
        self._record_step(name, dt)
        self._book_tokens(runner, toks, counts, act, now, dt)
        return now + dt

    def _decode_pipelined(self, active: List[str], now: float) -> float:
        """Every active model's decode block is issued before any is read
        back (the shared pool threads through the chain in order)."""
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
