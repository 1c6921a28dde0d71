"""Session flight recorder: the engine's black box (DESIGN.md §13).

Port of ``src/repro/runtime/flightrec.py``: the same record schema and
``RECORD_VERSION``, so a record from either package reads the same.
Everything it holds is host state (ops, the clock stream, pool
counters, token ids read back by the commits), so recording reads no
device tensor.

The recorder captures everything that DETERMINES a session — the causal
input stream — plus enough derived state to audit a replay:

  * **ops** — submits (full request fields, prompt ids included),
    ``step``/``advance`` virtual-clock reads, cancels (with their
    in-step flag), ``reset_stats`` calls, and test-harness corruption
    injections.  Replaying the ops bit-exactly reproduces the session.
  * **clock** — every wall-clock dt the engine folded into virtual time
    (one entry per dispatch, tagged by site).  On replay the engine
    consumes this stream instead of ``time.perf_counter`` — the ONLY
    nondeterministic input the engine has.
  * informational events — applied rebalance decisions, cache
    hit/evict/fault, swap traffic, admission verdicts, K-block commits,
    SLO breaches.  Derived, so a replay must REPRODUCE them; the
    replayer diffs the whole event ring.
  * **snapshots** — periodic pool accounting at quiescent step
    boundaries (page holder classes, slab residency, refcounts,
    cache tree), and one final snapshot at dump time.
  * **streams** — per-request token ids and virtual emission times,
    accumulated at the emission site so ``reset_stats()`` pruning
    cannot lose them.

Everything bounded is a ring with a per-kind drop counter; the replayer
refuses a record whose *causal* kinds dropped (informational drops only
degrade the diff).  The recorder is a :class:`CoreHooks` sink attached
BEFORE the sanitizer, so a raising audit cannot hide the event that
tripped it.  Pure observation: attaching a recorder never changes
engine behavior, which is what makes "record the original, re-record
the replay, diff the records" a sound equality check.
"""
from __future__ import annotations

import collections
import dataclasses
import json
from typing import Any, Deque, Dict, List, Optional

import numpy as np

from repro_torch.configs.base import (
    CacheConfig,
    ElasticConfig,
    EngineConfig,
    FlightRecorderConfig,
    MLAConfig,
    ModelConfig,
    SLObjective,
    SLOConfig,
    SSMConfig,
)
from repro_torch.core.hooks import CoreHooks

RECORD_VERSION = 1

# op kinds whose loss makes a record non-replayable (vs. merely degrading
# the informational diff)
CAUSAL_KINDS = ("op", "clock")


class ReplayDivergence(RuntimeError):
    """A replayed session stopped matching its record's causal structure
    (clock stream exhausted or tag-mismatched) — the state diverged
    before the output diff could even run."""


# ---------------------------------------------------------------------------
# config (de)serialization — the record header must round-trip through
# JSON into an engine constructed bit-identically
# ---------------------------------------------------------------------------


def model_config_to_dict(cfg: ModelConfig) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def model_config_from_dict(d: Dict[str, Any]) -> ModelConfig:
    d = dict(d)
    if d.get("mla") is not None:
        d["mla"] = MLAConfig(**d["mla"])
    if d.get("ssm") is not None:
        d["ssm"] = SSMConfig(**d["ssm"])
    return ModelConfig(**d)


def slo_config_to_dict(cfg: Optional[SLOConfig]) -> Optional[Dict[str, Any]]:
    if cfg is None:
        return None
    return {
        "objectives": {m: dataclasses.asdict(o)
                       for m, o in cfg.objectives.items()},
        "window_s": cfg.window_s,
        "short_window_s": cfg.short_window_s,
        "burn_rate_threshold": cfg.burn_rate_threshold,
    }


def slo_config_from_dict(d: Optional[Dict[str, Any]]) -> Optional[SLOConfig]:
    if d is None:
        return None
    return SLOConfig(
        objectives={m: SLObjective(**o) for m, o in d["objectives"].items()},
        window_s=d["window_s"],
        short_window_s=d["short_window_s"],
        burn_rate_threshold=d["burn_rate_threshold"],
    )


def engine_header(*, models, page_budget, page_bytes, slot_budget,
                  slab_bytes, max_batch, max_ctx, seed, mode, elastic,
                  cache, sanitize, slo, flightrec) -> Dict[str, Any]:
    """Everything the replayer needs to rebuild the engine.  Model order
    matters (params are drawn from ``torch.Generator(seed + i)`` in dict
    order) and JSON objects preserve it."""
    return {
        "models": {name: model_config_to_dict(cfg)
                   for name, cfg in models.items()},
        "page_budget": page_budget,
        "page_bytes": page_bytes,
        "slot_budget": slot_budget,
        "slab_bytes": slab_bytes,
        "max_batch": max_batch,
        "max_ctx": max_ctx,
        "seed": seed,
        "mode": dataclasses.asdict(mode),
        "elastic": dataclasses.asdict(elastic) if elastic is not None else None,
        "cache": dataclasses.asdict(cache) if cache is not None else None,
        "sanitize": bool(sanitize),
        "slo": slo_config_to_dict(slo),
        "flightrec": dataclasses.asdict(flightrec),
    }


def engine_config_from_header(h: Dict[str, Any], *,
                              dump_path: Optional[str] = None) -> EngineConfig:
    """Header -> :class:`EngineConfig` (EngineMode is reconstructed by
    the replayer, which may import the runtime layer)."""
    fr = dict(h["flightrec"])
    fr["dump_path"] = dump_path
    return EngineConfig(
        elastic=ElasticConfig(**h["elastic"]) if h["elastic"] else None,
        cache=CacheConfig(**h["cache"]) if h["cache"] else None,
        sanitize=h["sanitize"],
        slo=slo_config_from_dict(h["slo"]),
        flightrec=FlightRecorderConfig(**fr),
    )


def request_to_dict(req) -> Dict[str, Any]:
    ids = req.prompt_ids
    return {
        "request_id": req.request_id,
        "model": req.model,
        "prompt_tokens": req.prompt_tokens,
        "max_new_tokens": req.max_new_tokens,
        "arrival_time": req.arrival_time,
        "prompt_ids": (None if ids is None
                       else np.asarray(ids).astype(int).tolist()),
        "eos_id": req.eos_id,
        "cache": bool(req.cache),
    }


# ---------------------------------------------------------------------------
# pool snapshots
# ---------------------------------------------------------------------------


def pool_snapshot(virt, arena=None, cache=None) -> Dict[str, Any]:
    """One quiescent-boundary pool snapshot: KV pages partitioned by
    holder class, slab residency by model, swap depth, cache tree.  All
    integer counters over deterministic state — a replay reproduces it
    bit-exactly, so the replayer diffs snapshots too."""
    kv = virt.accounting_snapshot()
    tree = int(cache.device_pages_held) if cache is not None else 0
    kv["tree_pages"] = tree
    return {
        "kv": kv,
        "arena": (None if arena is None else {
            "slot_budget": arena.slot_budget,
            "resident_slabs": arena.resident_slabs,
            "free_slabs": arena.free_slabs,
            "resident": arena.residency_by_model(),
        }),
        "cache": cache.snapshot() if cache is not None else None,
    }


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------


class FlightRecorder(CoreHooks):
    """Bounded black-box recorder; also a pool-hook sink.

    Constructed by the engine (``EngineConfig(flightrec=...)``) with
    references to the pools so on-demand/auto dumps can snapshot final
    accounting.  All methods are cheap appends; the engine guards every
    call site with one ``is not None`` check so the recorder-off path
    does no work and no allocation.
    """

    def __init__(self, cfg: FlightRecorderConfig, *, header: Dict[str, Any],
                 virt=None, arena=None, cache=None):
        self.cfg = cfg
        self.header = header
        self.virt = virt
        self.arena = arena
        self.cache = cache
        self.ring: Deque[Dict[str, Any]] = collections.deque(
            maxlen=max(int(cfg.ring_size), 1))
        self.snapshots: Deque[Dict[str, Any]] = collections.deque(
            maxlen=max(int(cfg.max_snapshots), 1))
        self.dropped: collections.Counter = collections.Counter()
        self.streams: Dict[int, Dict[str, Any]] = {}
        self.failure: Optional[Dict[str, Any]] = None
        self.step = 0                  # stamped onto every ring entry
        self.dumps = 0
        self._breach_dumped = False

    # -- ring ----------------------------------------------------------
    def _push(self, kind: str, **fields) -> None:
        ring = self.ring
        if len(ring) == ring.maxlen:
            self.dropped[ring[0]["kind"]] += 1
        entry = {"kind": kind, "step": self.step}
        entry.update(fields)
        ring.append(entry)

    # -- causal input ops (driven by the engine session API) -----------
    def record_step(self, step: int, now: float) -> None:
        self.step = step
        self._push("op", op="step", now=now)

    def record_op(self, op: str, **fields) -> None:
        self._push("op", op=op, **fields)

    def record_submit(self, req, now: float) -> None:
        self._push("op", op="submit", now=now, request=request_to_dict(req))

    def record_cancel(self, rid: int, now: float, *, in_step: bool) -> None:
        self._push("op", op="cancel", rid=rid, now=now, in_step=in_step)

    def record_dt(self, tag: str, dt: float) -> None:
        self._push("clock", tag=tag, dt=dt)

    # -- derived events (diffed on replay, not re-driven) ---------------
    def record_commit(self, rid: int, model: str, tokens: int,
                      dt: float, *, first: bool = False) -> None:
        self._push("commit", rid=rid, model=model, tokens=tokens, dt=dt,
                   first=first)

    def note_token(self, rid: int, model: str, token: int,
                   when: float) -> None:
        stream = self.streams.get(rid)
        if stream is None:
            stream = self.streams[rid] = {
                "model": model, "tokens": [], "times": []}
        stream["tokens"].append(int(token))
        stream["times"].append(float(when))

    # -- pool hook overrides (informational ring events) ----------------
    def kv_swap_out(self, pages):
        self._push("kv_swap_out", pages=pages)

    def kv_swap_in(self, pages):
        self._push("kv_swap_in", pages=pages)

    def kv_resize(self, old_pages, new_pages, swapped_out, moved):
        self._push("kv_resize", old=old_pages, new=new_pages,
                   swapped_out=swapped_out, moved=moved)

    def arena_activate(self, model, slabs):
        self._push("arena_activate", model=model, slabs=slabs)

    def arena_evict(self, model, slabs):
        self._push("arena_evict", model=model, slabs=slabs)

    def arena_resize(self, old_slots, new_slots, evicted, moved):
        self._push("arena_resize", old=old_slots, new=new_slots,
                   evicted=evicted, moved=moved)

    def admission(self, model, outcome, blocker):
        self._push("admission", model=model, outcome=outcome,
                   blocker=blocker)

    def cache_hit(self, model, tokens):
        self._push("cache_hit", model=model, tokens=tokens)

    def cache_evict(self, pages):
        self._push("cache_evict", pages=pages)

    def cache_fault(self, pages):
        self._push("cache_fault", pages=pages)

    def rebalance(self, decision):
        self._push("rebalance", decision=decision.to_record())

    def slo_breach(self, breach):
        self._push("slo_breach", model=breach.model, metric=breach.metric,
                   long_burn=breach.long_burn, short_burn=breach.short_burn)
        if (self.cfg.dump_path and self.cfg.dump_on_breach
                and not self._breach_dumped):
            # deferred to the step boundary (engine calls
            # maybe_breach_dump): a mid-step dump would capture pool state
            # the replayed step — which always runs to completion — can
            # never land on, breaking the bit-exact diff
            self._breach_dumped = True

    def maybe_breach_dump(self) -> bool:
        """Quiescent-boundary half of the breach auto-dump: called by the
        engine after step-end bookkeeping and the sanitizer audit."""
        if self._breach_dumped and self.dumps == 0 and self.cfg.dump_path:
            self.dump(self.cfg.dump_path)
            return True
        return False

    # (kv_reserved/kv_trimmed/arena_upload/admission_wait/cache_miss are
    # deliberately NOT ringed: high-volume and fully derivable.)

    # -- snapshots -------------------------------------------------------
    def snapshot_due(self, step: int) -> bool:
        return step % max(int(self.cfg.snapshot_interval_steps), 1) == 0

    def snapshot(self, step: int, now: float, snap: Dict[str, Any]) -> None:
        entry = {"step": step, "now": now}
        entry.update(snap)
        self.snapshots.append(entry)

    # -- failure + dump --------------------------------------------------
    def note_failure(self, step: int, err: BaseException) -> None:
        """Stamp the failing step and auto-dump (once stamped, the record
        is an incident artifact: the replayer asserts the SAME error type
        and sanitizer rule at the SAME step)."""
        self.failure = {
            "step": step,
            "type": type(err).__name__,
            "rule": getattr(err, "rule", None),
            "error": str(err),
        }
        if self.cfg.dump_path:
            self.dump(self.cfg.dump_path)

    def to_record(self) -> Dict[str, Any]:
        return {
            "version": RECORD_VERSION,
            "engine": self.header,
            "events": list(self.ring),
            "dropped": dict(self.dropped),
            "snapshots": list(self.snapshots),
            "streams": {str(rid): stream
                        for rid, stream in self.streams.items()},
            "failure": self.failure,
            "final": (pool_snapshot(self.virt, self.arena, self.cache)
                      if self.virt is not None else None),
        }

    def dump(self, path: Optional[str] = None) -> str:
        path = path or self.cfg.dump_path
        if not path:
            raise ValueError("no dump path: pass one or set "
                             "FlightRecorderConfig.dump_path")
        with open(path, "w") as f:
            json.dump(self.to_record(), f)
        self.dumps += 1
        return str(path)


# ---------------------------------------------------------------------------
# record accessors (shared by the replayer and tests)
# ---------------------------------------------------------------------------


def record_ops(record: Dict[str, Any]) -> List[Dict[str, Any]]:
    return [e for e in record["events"] if e["kind"] == "op"]


def record_clock(record: Dict[str, Any]) -> List[tuple]:
    return [(e["tag"], e["dt"]) for e in record["events"]
            if e["kind"] == "clock"]


def causal_drops(record: Dict[str, Any]) -> Dict[str, int]:
    dropped = record.get("dropped", {})
    return {k: v for k, v in dropped.items() if k in CAUSAL_KINDS and v}


# ---------------------------------------------------------------------------
# corruption injection (test/debug surface)
# ---------------------------------------------------------------------------

INJECTION_KINDS = ("double_free", "refcount_drift")


def inject_corruption(engine, kind: str) -> None:
    """Deliberately corrupt pool state AND record the injection as a
    causal op, so a replay re-applies it and trips the SAME sanitizer
    rule at the SAME step — how a dumped incident record proves the
    replayer reproduces failures, not just healthy runs."""
    if engine.recorder is not None:
        engine.recorder.record_op("inject", corruption=kind, now=engine.now)
    virt = engine.virt
    if kind == "double_free":
        if not virt.free_list:
            raise ValueError("double_free needs a non-empty free list")
        # page now on the free list while still free -> SAN01
        virt.free_list.append(virt.free_list[0])
    elif kind == "refcount_drift":
        if not virt.requests:
            raise ValueError("refcount_drift needs a live request")
        req = next(iter(virt.requests.values()))
        for _, _, page in req.device_entries():
            # explicit refcount with no matching holders -> SAN03
            virt._refs[page] = 7
            break
        else:
            raise ValueError("refcount_drift needs a device-resident page")
    else:
        raise ValueError(
            f"unknown injection {kind!r}; known: {INJECTION_KINDS}")
