"""Engine observability: metrics registry, span tracer, observer facade.

Port of ``src/repro/runtime/observe.py``: pure host Python over numpy,
so the same operations give the same Prometheus text, snapshot and
Chrome trace in both packages.

Three layers, composable bottom-up (DESIGN.md §10):

* :class:`MetricsRegistry` — counters / gauges / histograms with label
  sets, Prometheus text exposition and a JSON-able snapshot, plus a
  bounded structured-event log (``log_event`` / ``recent_events``) that
  backs ``engine.report()``'s last-N rebalance lines.  Histograms keep
  their raw samples, so ``percentile`` over a histogram is EXACTLY
  ``np.percentile`` over the same values — the benchmarks read their
  P50/P99 from here and must agree bit-for-bit with per-request lists.
* :class:`SpanTracer` — Chrome trace-event JSON (Perfetto-loadable)
  recorder.  Tracks (one per request, one per model, one for the engine
  step loop) map to tids; the clock is INJECTED so tests drive a fake
  monotonic clock and assert exact span sequences deterministically.
* :class:`EngineObserver` — the facade the engine wires in.  It extends
  :class:`~repro_torch.core.hooks.CoreHooks`, so attaching the SAME object to
  the virtualizer / arena / admission / rebalancer gives the core layer
  a reporting channel without importing the runtime.

The disabled path is ``engine.observer is None``: every instrumentation
site in the step loop is a single ``is not None`` check, so a session
without an observer allocates nothing and calls nothing — token streams
are bit-exact with or without observation (the observer never touches
RNG, device state, or the virtual clock, and reads no device tensor).
"""
from __future__ import annotations

import bisect
import collections
import json
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.configs.base import SLOConfig
from repro_torch.core.hooks import CoreHooks
from repro_torch.runtime.request import Request

__all__ = [
    "percentile", "summarize", "MetricsRegistry", "SpanTracer",
    "EngineObserver", "Counter", "Gauge", "Histogram",
    "SLOBreach", "SLOMonitor",
    "TraceStats", "sharegpt_like", "longalign_like", "poisson_arrivals",
    "make_requests",
]


def percentile(values: Sequence[float], q: float) -> float:
    """The repo's ONE quantile: ``np.percentile`` (linear interpolation),
    NaN on empty — every benchmark and report quotes this."""
    values = np.asarray(values, float).reshape(-1)
    if values.size == 0:
        return float("nan")
    return float(np.percentile(values, q))


def summarize(values: Sequence[float],
              qs: Sequence[float] = (50, 95, 99)) -> Dict[str, float]:
    """{'p50': ..., 'p95': ..., 'p99': ...} over one sample list."""
    return {f"p{q:g}": percentile(values, q) for q in qs}


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------

#: Default histogram buckets (seconds) — engine dispatch / latency scale.
LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5)


class _CounterChild:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v


class _GaugeChild:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, v: float = 1.0) -> None:
        self.value += v


class _HistogramChild:
    __slots__ = ("bounds", "bucket_counts", "sum", "samples")

    def __init__(self, bounds: Tuple[float, ...]):
        self.bounds = bounds
        self.bucket_counts = [0] * (len(bounds) + 1)   # last = +Inf
        self.sum = 0.0
        self.samples: List[float] = []

    def observe(self, v: float) -> None:
        v = float(v)
        self.bucket_counts[bisect.bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.samples.append(v)

    @property
    def count(self) -> int:
        return len(self.samples)

    def percentile(self, q: float) -> float:
        return percentile(self.samples, q)

    def reset(self) -> None:
        self.bucket_counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.samples.clear()


class _Metric:
    """One named metric family; per-label-set children on demand."""

    kind = "untyped"
    child_cls = _CounterChild

    def __init__(self, name: str, help: str, labelnames: Tuple[str, ...]):
        self.name = name
        self.help = help
        self.labelnames = labelnames
        self._children: Dict[Tuple[str, ...], object] = {}

    def _make_child(self):
        return self.child_cls()

    def labels(self, *values: str):
        """Get-or-create the child for one label-value tuple.  Call sites
        on hot paths cache the returned child — it is a plain slotted
        object, so the per-event cost is one attribute bump."""
        assert len(values) == len(self.labelnames), \
            (self.name, self.labelnames, values)
        key = tuple(str(v) for v in values)
        child = self._children.get(key)
        if child is None:
            child = self._children[key] = self._make_child()
        return child

    @property
    def children(self) -> Dict[Tuple[str, ...], object]:
        return self._children

    def _label_str(self, key: Tuple[str, ...],
                   extra: Tuple[Tuple[str, str], ...] = ()) -> str:
        pairs = [f'{n}="{v}"' for n, v in zip(self.labelnames, key)]
        pairs += [f'{n}="{v}"' for n, v in extra]
        return "{" + ",".join(pairs) + "}" if pairs else ""


class Counter(_Metric):
    kind = "counter"
    child_cls = _CounterChild

    def inc(self, v: float = 1.0) -> None:
        assert not self.labelnames, f"{self.name}: use .labels(...)"
        self.labels().inc(v)

    @property
    def value(self) -> float:
        return sum(c.value for c in self._children.values())

    def expose(self, out: List[str]) -> None:
        for key, c in self._children.items():
            out.append(f"{self.name}{self._label_str(key)} {c.value:g}")

    def snap(self):
        return [{"labels": dict(zip(self.labelnames, k)), "value": c.value}
                for k, c in self._children.items()]


class Gauge(_Metric):
    kind = "gauge"
    child_cls = _GaugeChild

    def set(self, v: float) -> None:
        assert not self.labelnames, f"{self.name}: use .labels(...)"
        self.labels().set(v)

    @property
    def value(self) -> float:
        assert not self.labelnames, f"{self.name}: use .labels(...)"
        return self.labels().value

    expose = Counter.expose
    snap = Counter.snap


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help: str, labelnames: Tuple[str, ...],
                 buckets: Tuple[float, ...] = LATENCY_BUCKETS):
        super().__init__(name, help, labelnames)
        self.buckets = tuple(sorted(float(b) for b in buckets))

    def _make_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, v: float) -> None:
        assert not self.labelnames, f"{self.name}: use .labels(...)"
        self.labels().observe(v)

    def all_samples(self) -> List[float]:
        """Every observation across label sets, in observation order per
        child — the benchmarks' shared sample source."""
        out: List[float] = []
        for c in self._children.values():
            out.extend(c.samples)
        return out

    def percentile(self, q: float) -> float:
        return percentile(self.all_samples(), q)

    @property
    def count(self) -> int:
        return sum(c.count for c in self._children.values())

    def reset(self) -> None:
        for c in self._children.values():
            c.reset()

    def expose(self, out: List[str]) -> None:
        for key, c in self._children.items():
            cum = 0
            for b, n in zip(self.buckets, c.bucket_counts):
                cum += n
                ls = self._label_str(key, (("le", f"{b:g}"),))
                out.append(f"{self.name}_bucket{ls} {cum}")
            ls = self._label_str(key, (("le", "+Inf"),))
            out.append(f"{self.name}_bucket{ls} {c.count}")
            out.append(f"{self.name}_sum{self._label_str(key)} {c.sum:g}")
            out.append(f"{self.name}_count{self._label_str(key)} {c.count}")

    def snap(self):
        return [{"labels": dict(zip(self.labelnames, k)),
                 "count": c.count, "sum": c.sum,
                 "p50": c.percentile(50), "p99": c.percentile(99)}
                for k, c in self._children.items()]


class MetricsRegistry:
    """Named metric families + a bounded structured-event log.

    ``prometheus_text()`` is the scrape format; ``snapshot()`` the
    JSON-able form (histogram snapshots carry exact p50/p99).  Metric
    creation is get-or-create so multiple wiring sites can share one
    family; kind/label mismatches are programming errors and assert.
    """

    def __init__(self, *, event_log_size: int = 64):
        self._metrics: Dict[str, _Metric] = {}
        self._events: Dict[str, collections.deque] = \
            collections.defaultdict(
                lambda: collections.deque(maxlen=event_log_size))
        self._events_dropped: collections.Counter = collections.Counter()

    def _get_or_create(self, cls, name: str, help: str,
                       labelnames: Sequence[str], **kw):
        m = self._metrics.get(name)
        if m is not None:
            assert m.kind == cls.kind and m.labelnames == tuple(labelnames), \
                (name, m.kind, m.labelnames)
            return m
        m = self._metrics[name] = cls(name, help, tuple(labelnames), **kw)
        return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Tuple[float, ...] = LATENCY_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    # -- structured events (report()'s last-N source) -------------------
    def log_event(self, kind: str, **fields) -> None:
        dq = self._events[kind]
        if dq.maxlen is not None and len(dq) == dq.maxlen:
            # bounded log about to silently truncate: count the drop so
            # recent_events() consumers can detect it (surfaced by
            # engine.report() and crosspool_events_dropped_total)
            self._events_dropped[kind] += 1
            self.counter("crosspool_events_dropped_total",
                         "structured events lost to the bounded log",
                         ("kind",)).labels(kind).inc()
        dq.append(dict(fields))

    def recent_events(self, kind: str, n: Optional[int] = None
                      ) -> List[Dict]:
        ev = list(self._events.get(kind, ()))
        return ev if n is None else ev[-n:]

    def events_dropped(self, kind: Optional[str] = None):
        """Per-kind count of events lost to the bounded log — the whole
        dict, or one kind's count."""
        if kind is not None:
            return self._events_dropped.get(kind, 0)
        return dict(self._events_dropped)

    # -- exposition ------------------------------------------------------
    def prometheus_text(self) -> str:
        out: List[str] = []
        for m in self._metrics.values():
            if m.help:
                out.append(f"# HELP {m.name} {m.help}")
            out.append(f"# TYPE {m.name} {m.kind}")
            m.expose(out)
        return "\n".join(out) + "\n"

    def snapshot(self) -> Dict[str, Dict]:
        return {m.name: {"kind": m.kind, "help": m.help, "values": m.snap()}
                for m in self._metrics.values()}

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.prometheus_text())


# ---------------------------------------------------------------------------
# span tracer (Chrome trace-event JSON, Perfetto-loadable)
# ---------------------------------------------------------------------------

class SpanTracer:
    """Records begin/end/instant/complete events onto named tracks.

    A track is a Perfetto "thread": first use allocates a tid and emits
    the ``thread_name`` metadata event.  Timestamps come from the
    injected ``clock`` (monotonic seconds; default ``time.perf_counter``)
    rebased to the tracer's construction, so tests inject a fake
    deterministic clock and real runs get wall time.  B/E events nest
    per track — callers keep per-track begin/end balanced (the engine's
    phase and request lifecycles are strictly bracketed).
    """

    PID = 1

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self._clock = clock
        self._t0 = clock()
        self.events: List[Dict] = []
        self._tids: Dict[str, int] = {}

    def now_us(self) -> float:
        return (self._clock() - self._t0) * 1e6

    def _tid(self, track: str) -> int:
        tid = self._tids.get(track)
        if tid is None:
            tid = self._tids[track] = len(self._tids) + 1
            self.events.append({
                "name": "thread_name", "ph": "M", "pid": self.PID,
                "tid": tid, "args": {"name": track}})
        return tid

    def begin(self, track: str, name: str, cat: str = "engine",
              **args) -> None:
        self.events.append({
            "name": name, "cat": cat, "ph": "B", "ts": self.now_us(),
            "pid": self.PID, "tid": self._tid(track), "args": args})

    def end(self, track: str, name: str, cat: str = "engine",
            **args) -> None:
        self.events.append({
            "name": name, "cat": cat, "ph": "E", "ts": self.now_us(),
            "pid": self.PID, "tid": self._tid(track), "args": args})

    def complete(self, track: str, name: str, dur_s: float,
                 cat: str = "engine", **args) -> None:
        """An X event ENDING now whose duration was measured host-side.
        The start clamps at the trace origin: a duration can exceed the
        tracer-clock elapsed time (first-compile slices, fake clocks)
        and Perfetto rejects negative timestamps."""
        dur_us = max(float(dur_s), 0.0) * 1e6
        self.events.append({
            "name": name, "cat": cat, "ph": "X",
            "ts": max(self.now_us() - dur_us, 0.0), "dur": dur_us,
            "pid": self.PID, "tid": self._tid(track), "args": args})

    def instant(self, track: str, name: str, cat: str = "engine",
                **args) -> None:
        self.events.append({
            "name": name, "cat": cat, "ph": "i", "s": "t",
            "ts": self.now_us(), "pid": self.PID,
            "tid": self._tid(track), "args": args})

    def counter(self, track: str, name: str, **values: float) -> None:
        """A Perfetto counter sample (ph "C"): one multi-series counter
        track per (track tid, name); Perfetto renders the series stacked,
        which is exactly the holder-class partition view the pool
        timelines want."""
        self.events.append({
            "name": name, "ph": "C", "ts": self.now_us(),
            "pid": self.PID, "tid": self._tid(track),
            "args": {k: float(v) for k, v in values.items()}})

    # -- export ----------------------------------------------------------
    def chrome_trace(self) -> Dict:
        return {"traceEvents": list(self.events), "displayTimeUnit": "ms"}

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)

    # -- test helpers ----------------------------------------------------
    def track_events(self, track: str) -> List[Dict]:
        tid = self._tids.get(track)
        if tid is None:
            return []
        return [e for e in self.events
                if e.get("tid") == tid and e["ph"] != "M"]

    def span_names(self, track: str) -> List[Tuple[str, str]]:
        """[(ph, name), ...] on one track — the deterministic sequence
        the tracer tests assert against."""
        return [(e["ph"], e["name"]) for e in self.track_events(track)]


# ---------------------------------------------------------------------------
# the observer facade
# ---------------------------------------------------------------------------

class EngineObserver(CoreHooks):
    """Metrics + tracer, wired through the engine AND the core hooks.

    One instance per engine.  The engine calls the lifecycle methods
    below from its step loop (each site guarded by ``observer is not
    None``); the pools call the :class:`CoreHooks` overrides.  Latency
    observations (TTFT/TBT/dispatch seconds) use ENGINE virtual time so
    they match ``EngineStats`` exactly; trace timestamps use the
    tracer's own clock so Perfetto shows host wall time.
    """

    ENGINE_TRACK = "engine/step-loop"

    def __init__(self, clock: Callable[[], float] = time.perf_counter,
                 registry: Optional[MetricsRegistry] = None):
        self.metrics = registry if registry is not None else MetricsRegistry()
        self.tracer = SpanTracer(clock=clock)
        m = self.metrics
        # admission front door
        self.admission_total = m.counter(
            "crosspool_admission_total",
            "front-door verdicts", ("model", "outcome"))
        self._adm_blocked = m.counter(
            "crosspool_admission_blocked_total",
            "queued verdicts by blocking resource", ("blocker",))
        self._adm_wait = m.histogram(
            "crosspool_admission_wait_seconds",
            "queue wait of drained requests", ("model",))
        # KV pool
        self._kv_mapped = m.gauge("crosspool_kv_pages_mapped",
                                  "device pages currently mapped")
        self._kv_budget = m.gauge("crosspool_kv_page_budget",
                                  "live KV pool size (pages)")
        self._kv_swapped = m.gauge("crosspool_kv_pages_swapped",
                                   "pages held in the host swap tier")
        self._kv_occ = m.gauge("crosspool_kv_occupancy",
                               "mapped / budget")
        swap = m.counter("crosspool_kv_swap_pages_total",
                         "pages moved across the swap tier", ("dir",))
        self._swap_out = swap.labels("out")
        self._swap_in = swap.labels("in")
        self._kv_reserved = m.counter(
            "crosspool_kv_reserved_pages_total",
            "pages pre-mapped for decode blocks")
        self._kv_trimmed = m.counter(
            "crosspool_kv_trimmed_pages_total",
            "unused reserved pages returned at commit")
        self._pool_resizes = m.counter(
            "crosspool_pool_resizes_total",
            "live pool resizes", ("pool",))
        # weights arena
        self._arena_resident = m.gauge("crosspool_arena_slabs_resident",
                                       "arena slabs mapped")
        self._arena_budget = m.gauge("crosspool_arena_slot_budget",
                                     "live arena size (slabs)")
        self._arena_occ = m.gauge("crosspool_arena_occupancy",
                                  "resident / budget")
        self._arena_act = m.counter("crosspool_arena_activations_total",
                                    "cold-model activations", ("model",))
        self._arena_evict = m.counter("crosspool_arena_evictions_total",
                                      "LRU evictions", ("model",))
        self._arena_upload = m.counter(
            "crosspool_arena_uploaded_slabs_total",
            "slabs uploaded host->device", ("model",))
        # prefix cache (DESIGN.md §11)
        self._cache_lookups = m.counter(
            "crosspool_prefix_cache_lookups_total",
            "cache-eligible admissions by outcome", ("model", "outcome"))
        self._cache_hit_tokens = m.counter(
            "crosspool_prefix_cache_hit_tokens_total",
            "prompt tokens served from the radix tree", ("model",))
        self._cache_evicted = m.counter(
            "crosspool_prefix_cache_evicted_pages_total",
            "device pages shed/evicted from the tree")
        self._cache_faulted = m.counter(
            "crosspool_prefix_cache_faulted_pages_total",
            "shed pages faulted back on a second-chance hit")
        # rebalancer
        self._rebalance = m.counter("crosspool_rebalance_total",
                                    "applied boundary moves", ("reason",))
        self._rebalance_swap = m.counter(
            "crosspool_rebalance_swapped_pages_total",
            "pages pushed to the swap tier by shrinks")
        self._rebalance_evict = m.counter(
            "crosspool_rebalance_evicted_models_total",
            "models evicted by arena shrinks")
        # request lifecycle + latency (windowed: reset_window clears)
        self._queue_depth = m.gauge("crosspool_queue_depth",
                                    "front-door queued requests")
        self._waiting = m.gauge("crosspool_waiting_requests",
                                "admitted requests without a batch slot")
        self.requests_total = m.counter("crosspool_requests_total",
                                        "terminal outcomes",
                                        ("model", "outcome"))
        self.tokens_total = m.counter("crosspool_tokens_total",
                                      "tokens emitted", ("model",))
        self.ttft = m.histogram("crosspool_ttft_seconds",
                                "time to first token", ("model",))
        self.tbt = m.histogram("crosspool_tbt_seconds",
                               "time between tokens", ("model",))
        self.prefill_seconds = m.histogram(
            "crosspool_prefill_dispatch_seconds",
            "wall time of one prefill pass", ("model",))
        self.decode_seconds = m.histogram(
            "crosspool_decode_dispatch_seconds",
            "wall time of one decode dispatch", ("model",))
        self.prefill_batch = m.histogram(
            "crosspool_prefill_batch_size",
            "rows per executed prefill pass",
            buckets=(1, 2, 4, 8, 16))
        self._batcher_deferrals = m.counter(
            "crosspool_batcher_deferrals_total",
            "requests kept waiting by the batcher", ("model", "reason"))
        # hot-path per-model child caches
        self._tok_children: Dict[str, _CounterChild] = {}
        self._tbt_children: Dict[str, _HistogramChild] = {}
        # request-track bookkeeping: rid -> (track, open span name | None)
        self._req_spans: Dict[int, Tuple[str, Optional[str]]] = {}
        self._steps = 0

    # ------------------------------------------------------------------
    # engine step loop
    # ------------------------------------------------------------------
    def step_begin(self, now: float) -> None:
        self._steps += 1
        self.tracer.begin(self.ENGINE_TRACK, "step",
                          step=self._steps, engine_time=now)

    def step_end(self) -> None:
        self.tracer.end(self.ENGINE_TRACK, "step")

    def phase_begin(self, name: str) -> None:
        self.tracer.begin(self.ENGINE_TRACK, name, cat="phase")

    def phase_end(self, name: str) -> None:
        self.tracer.end(self.ENGINE_TRACK, name, cat="phase")

    # ------------------------------------------------------------------
    # request lifecycle (engine virtual time in args; tracer clock in ts)
    # ------------------------------------------------------------------
    def _track(self, req) -> str:
        return f"req/{req.model}#{req.request_id}"

    def _open(self, req, span: str, **args) -> None:
        track = self._track(req)
        self._req_spans[req.request_id] = (track, span)
        self.tracer.begin(track, span, cat="request", **args)

    def _close(self, req) -> None:
        entry = self._req_spans.get(req.request_id)
        if entry is None or entry[1] is None:
            return
        track, span = entry
        self.tracer.end(track, span, cat="request")
        self._req_spans[req.request_id] = (track, None)

    def request_submitted(self, req, outcome: str) -> None:
        track = self._track(req)
        self.tracer.instant(track, "submit", cat="request",
                            outcome=outcome, prompt=req.prompt_tokens,
                            max_new=req.max_new_tokens)
        if outcome == "admitted":
            self._open(req, "admitted")
        elif outcome == "queued":
            self._open(req, "queued")
        else:
            self._req_spans[req.request_id] = (track, None)
            self.requests_total.labels(req.model, "rejected").inc()

    def request_admitted(self, req) -> None:
        """A queued request drained at a later step boundary."""
        self._close(req)
        self._open(req, "admitted")

    def prefill(self, model: str, batch_size: int, dt: float) -> None:
        self.prefill_seconds.labels(model).observe(dt)
        self.prefill_batch.labels().observe(batch_size)
        self.tracer.complete(f"model/{model}", "prefill", dt,
                             cat="dispatch", batch=batch_size)

    def first_token(self, req, ttft: float) -> None:
        """Prefill committed: the request's admitted span becomes its
        decode span, and the TTFT sample lands (engine virtual time —
        identical to the ``EngineStats.ttft`` entry)."""
        self.ttft.labels(req.model).observe(ttft)
        self._tok_child(req.model).inc()
        self._close(req)
        self._open(req, "decode", ttft=ttft)

    def _tok_child(self, model: str) -> _CounterChild:
        c = self._tok_children.get(model)
        if c is None:
            c = self._tok_children[model] = self.tokens_total.labels(model)
        return c

    def _tbt_child(self, model: str) -> _HistogramChild:
        c = self._tbt_children.get(model)
        if c is None:
            c = self._tbt_children[model] = self.tbt.labels(model)
        return c

    def token(self, req, gap: float) -> None:
        """One decode token: TBT gap in engine virtual time (matches the
        ``tbt_samples()`` pairwise diff exactly)."""
        self._tbt_child(req.model).observe(gap)
        self._tok_child(req.model).inc()

    def decode_block(self, req, n_tokens: int, dt: float) -> None:
        """One committed K-block for one request (an X slice inside the
        request's decode span)."""
        self.tracer.complete(self._track(req), "decode_block", dt,
                             cat="request", tokens=n_tokens)

    def decode_dispatch(self, model: str, dt: float) -> None:
        self.decode_seconds.labels(model).observe(dt)
        self.tracer.complete(f"model/{model}", "decode", dt, cat="dispatch")

    def request_finished(self, req) -> None:
        self._close(req)
        self.tracer.instant(self._track(req), "finished", cat="request",
                            tokens=req.generated)
        self.requests_total.labels(req.model, "finished").inc()

    def request_cancelled(self, req) -> None:
        self._close(req)
        self.tracer.instant(self._track(req), "cancelled", cat="request",
                            tokens=req.generated)
        self.requests_total.labels(req.model, "cancelled").inc()

    def batcher_deferral(self, model: str, reason: str) -> None:
        self._batcher_deferrals.labels(model, reason).inc()

    # ------------------------------------------------------------------
    # per-step pool sampling (gauges; runs BEFORE DemandTelemetry.observe,
    # so the exported gauges and telemetry's EWMAs read the same step)
    # ------------------------------------------------------------------
    def sample(self, virt, arena, admission, waiting: int) -> None:
        self._kv_mapped.set(virt.mapped_pages)
        self._kv_budget.set(virt.page_budget)
        self._kv_swapped.set(getattr(virt, "swapped_now", 0))
        self._kv_occ.set(virt.mapped_pages / max(virt.page_budget, 1))
        if arena is not None:
            self._arena_resident.set(arena.resident_slabs)
            self._arena_budget.set(arena.slot_budget)
            self._arena_occ.set(
                arena.resident_slabs / max(arena.slot_budget, 1))
        self._queue_depth.set(admission.queued_count())
        self._waiting.set(waiting)

    def pool_counters(self, snap: Dict) -> None:
        """Per-step Perfetto counter tracks from one pool snapshot
        (``runtime.flightrec.pool_snapshot``): KV pages by holder class,
        slabs by model, swap-tier depth, cache tree pages — the visual
        attribution layer for elastic decisions (DESIGN.md §13)."""
        kv = snap["kv"]
        self.tracer.counter("pool/kv", "kv_pages",
                            free=kv["free_pages"],
                            request=kv["request_pages"],
                            tree=kv["tree_pages"])
        self.tracer.counter("pool/kv", "swap_tier",
                            swapped=kv["swapped_now"])
        arena = snap.get("arena")
        if arena is not None:
            series = {"free": float(arena["free_slabs"])}
            series.update(arena["resident"])
            self.tracer.counter("pool/arena", "slabs", **series)
        cache = snap.get("cache")
        if cache is not None:
            self.tracer.counter("pool/cache", "tree_pages",
                                held=cache["device_pages_held"])

    # gauge accessors for DemandTelemetry's gauge-fed EWMAs
    def kv_occupancy(self) -> float:
        return self._kv_occ.value

    def slab_occupancy(self) -> float:
        return self._arena_occ.value

    def queue_depth(self) -> float:
        return self._queue_depth.value

    # ------------------------------------------------------------------
    # windowing
    # ------------------------------------------------------------------
    def reset_window(self) -> None:
        """Clear the WINDOWED histograms (latency/dispatch/batch-size) on
        ``engine.reset_stats()``; lifetime counters and gauges keep
        accumulating, mirroring the admission controller's counters."""
        for h in (self.ttft, self.tbt, self.prefill_seconds,
                  self.decode_seconds, self.prefill_batch):
            h.reset()

    # ------------------------------------------------------------------
    # CoreHooks overrides (called by the pools)
    # ------------------------------------------------------------------
    def kv_swap_out(self, pages: int) -> None:
        self._swap_out.inc(pages)
        self.tracer.instant("pool/kv", "swap_out", cat="pool", pages=pages)

    def kv_swap_in(self, pages: int) -> None:
        self._swap_in.inc(pages)
        self.tracer.instant("pool/kv", "swap_in", cat="pool", pages=pages)

    def kv_reserved(self, pages: int) -> None:
        self._kv_reserved.inc(pages)

    def kv_trimmed(self, pages: int) -> None:
        self._kv_trimmed.inc(pages)

    def kv_resize(self, old_pages: int, new_pages: int,
                  swapped_out: int, moved: int) -> None:
        self._pool_resizes.labels("kv").inc()
        self._kv_budget.set(new_pages)
        self.tracer.instant("pool/kv", "resize", cat="pool",
                            old=old_pages, new=new_pages,
                            swapped_out=swapped_out, moved=moved)

    def arena_activate(self, model: str, slabs: int) -> None:
        self._arena_act.labels(model).inc()
        self.tracer.instant("pool/arena", "activate", cat="pool",
                            model=model, slabs=slabs)

    def arena_evict(self, model: str, slabs: int) -> None:
        self._arena_evict.labels(model).inc()
        self.tracer.instant("pool/arena", "evict", cat="pool",
                            model=model, slabs=slabs)

    def arena_upload(self, model: str, slabs: int) -> None:
        self._arena_upload.labels(model).inc(slabs)

    def arena_resize(self, old_slots: int, new_slots: int,
                     evicted: int, moved: int) -> None:
        self._pool_resizes.labels("arena").inc()
        self._arena_budget.set(new_slots)
        self.tracer.instant("pool/arena", "resize", cat="pool",
                            old=old_slots, new=new_slots,
                            evicted=evicted, moved=moved)

    def admission(self, model: str, outcome: str, blocker: str) -> None:
        self.admission_total.labels(model, outcome).inc()
        if blocker:
            self._adm_blocked.labels(blocker).inc()

    def admission_wait(self, model: str, seconds: float) -> None:
        self._adm_wait.labels(model).observe(seconds)

    def cache_hit(self, model: str, tokens: int) -> None:
        self._cache_lookups.labels(model, "hit").inc()
        self._cache_hit_tokens.labels(model).inc(tokens)
        self.tracer.instant("pool/cache", "hit", cat="cache",
                            model=model, tokens=tokens)

    def cache_miss(self, model: str) -> None:
        self._cache_lookups.labels(model, "miss").inc()

    def cache_evict(self, pages: int) -> None:
        self._cache_evicted.inc(pages)
        self.tracer.instant("pool/cache", "evict", cat="cache", pages=pages)

    def cache_fault(self, pages: int) -> None:
        self._cache_faulted.inc(pages)
        self.tracer.instant("pool/cache", "fault", cat="cache", pages=pages)

    def rebalance(self, decision) -> None:
        self._rebalance.labels(decision.reason).inc()
        self._rebalance_swap.inc(decision.swapped_out)
        self._rebalance_evict.inc(decision.evicted_models)
        self.tracer.instant(self.ENGINE_TRACK, "rebalance", cat="elastic",
                            reason=decision.reason,
                            pages=(decision.old_page_budget,
                                   decision.new_page_budget),
                            slabs=(decision.old_slot_budget,
                                   decision.new_slot_budget))

    def slo_breach(self, breach) -> None:
        """Breach instant on the engine track (the counter and the
        structured event are bumped by :class:`SLOMonitor` itself, which
        shares this observer's registry — bumping here too would double
        count)."""
        self.tracer.instant(self.ENGINE_TRACK, "slo_breach", cat="slo",
                            model=breach.model, metric=breach.metric,
                            long_burn=breach.long_burn,
                            short_burn=breach.short_burn)


# ---------------------------------------------------------------------------
# SLO engine: multi-rate burn-rate evaluation (DESIGN.md §13)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SLOBreach:
    """One burn-rate breach edge for one (model, metric) objective."""

    model: str
    metric: str            # "ttft" | "tbt" | "queue_wait"
    threshold_s: float
    target: float
    long_burn: float       # budget-burn multiple over the long window
    short_burn: float      # ... over the short (fast) window
    window_value: float    # target-quantile of the long window (seconds)
    now: float             # engine virtual time of the evaluation


# (SLObjective field, metric key) pairs the monitor tracks
_SLO_METRICS = (("ttft_ms", "ttft"),
                ("tbt_p99_ms", "tbt"),
                ("queue_wait_ms", "queue_wait"))


def _bad_fraction(values: Sequence[float], threshold_s: float) -> float:
    """Fraction of samples STRICTLY over the threshold: a sample exactly
    at the objective is within SLO."""
    if not values:
        return 0.0
    return sum(1 for v in values if v > threshold_s) / len(values)


class SLOMonitor:
    """Windowed multi-rate burn-rate evaluation over latency samples.

    The engine feeds raw samples (``note``) in virtual time — the same
    values the registry histograms receive, so the monitor's windowed
    quantiles agree with ``np.percentile`` over the raw histogram
    samples exactly.  ``evaluate(now)`` prunes each (model, metric)
    window and fires an :class:`SLOBreach` on the breaching EDGE: both
    the long and the short window must burn the error budget faster
    than ``burn_rate_threshold`` (each with at least one sample), and
    the pair re-arms only after the condition clears.  Breaches land in
    the shared registry (``crosspool_slo_breaches_total`` + an
    ``slo_breach`` structured event) here, and are fanned to the hook
    sinks (observer trace, flight recorder) by the engine.

    Evaluation is pure arithmetic over deques of ``(time, value)`` —
    deterministic given the session's input stream, so a replayed
    session reproduces the exact breach sequence.
    """

    def __init__(self, cfg: SLOConfig,
                 registry: Optional[MetricsRegistry] = None):
        self.cfg = cfg
        self.metrics = registry if registry is not None else MetricsRegistry()
        self._breaches = self.metrics.counter(
            "crosspool_slo_breaches_total",
            "multi-rate burn-rate breach edges", ("model", "metric"))
        # (model, metric) -> (threshold_s, target)
        self._objectives: Dict[Tuple[str, str], Tuple[float, float]] = {}
        for model, obj in cfg.objectives.items():
            for attr, metric in _SLO_METRICS:
                thr_ms = getattr(obj, attr)
                if thr_ms is not None:
                    self._objectives[(model, metric)] = (
                        float(thr_ms) / 1e3, float(obj.target))
        self._samples: Dict[Tuple[str, str], collections.deque] = {
            key: collections.deque() for key in self._objectives}
        self._active: Set[Tuple[str, str]] = set()
        self.evaluations = 0

    def note(self, metric: str, model: str, value_s: float,
             now: float) -> None:
        """One latency sample in engine virtual time; untracked
        (model, metric) pairs are dropped at the cost of one dict get."""
        q = self._samples.get((model, metric))
        if q is not None:
            q.append((float(now), float(value_s)))

    def _burns(self, key, now: float):
        """(long_burn, short_burn, long_values, short_n) after pruning
        the window; ``None`` when the long window is empty."""
        thr, target = self._objectives[key]
        q = self._samples[key]
        horizon = now - self.cfg.window_s
        while q and q[0][0] < horizon:
            q.popleft()
        if not q:
            return None
        budget = max(1.0 - target, 1e-9)
        long_vals = [v for _, v in q]
        fast_horizon = now - self.cfg.short_window_s
        short_vals = [v for t, v in q if t >= fast_horizon]
        long_burn = _bad_fraction(long_vals, thr) / budget
        short_burn = _bad_fraction(short_vals, thr) / budget
        return long_burn, short_burn, long_vals, len(short_vals)

    def evaluate(self, now: float) -> List[SLOBreach]:
        """Edge-triggered breach scan; called by the engine once per
        step (and callable directly in tests)."""
        self.evaluations += 1
        out: List[SLOBreach] = []
        for key, (thr, target) in self._objectives.items():
            burns = self._burns(key, now)
            if burns is None:
                self._active.discard(key)
                continue
            long_burn, short_burn, long_vals, short_n = burns
            breaching = (short_n > 0
                         and long_burn > self.cfg.burn_rate_threshold
                         and short_burn > self.cfg.burn_rate_threshold)
            if not breaching:
                self._active.discard(key)
                continue
            if key in self._active:
                continue
            self._active.add(key)
            model, metric = key
            breach = SLOBreach(
                model=model, metric=metric, threshold_s=thr, target=target,
                long_burn=long_burn, short_burn=short_burn,
                window_value=percentile(long_vals, target * 100.0), now=now)
            self._breaches.labels(model, metric).inc()
            self.metrics.log_event(
                "slo_breach", model=model, metric=metric,
                threshold_ms=thr * 1e3, long_burn=long_burn,
                short_burn=short_burn,
                window_value_ms=breach.window_value * 1e3, time=now)
            out.append(breach)
        return out

    def status(self, now: float) -> Dict[Tuple[str, str], Dict[str, float]]:
        """Read-only window view per objective (no pruning, no edges):
        sample count, bad fraction, burn rates, and the target-quantile
        of the long window — the reporting surface."""
        out = {}
        for key, (thr, target) in self._objectives.items():
            q = self._samples[key]
            long_vals = [v for t, v in q if t >= now - self.cfg.window_s]
            short_vals = [v for t, v in q
                          if t >= now - self.cfg.short_window_s]
            budget = max(1.0 - target, 1e-9)
            out[key] = {
                "n": len(long_vals),
                "threshold_s": thr,
                "target": target,
                "bad_fraction": _bad_fraction(long_vals, thr),
                "long_burn": _bad_fraction(long_vals, thr) / budget,
                "short_burn": _bad_fraction(short_vals, thr) / budget,
                "window_value": (percentile(long_vals, target * 100.0)
                                 if long_vals else float("nan")),
                "breaching": key in self._active,
            }
        return out

    def breach_count(self) -> int:
        return int(self._breaches.value)

    def reset(self) -> None:
        """Drop every window and re-arm every edge — wired to
        ``engine.reset_stats()`` so windowed SLO state matches the
        windowed histograms."""
        for q in self._samples.values():
            q.clear()
        self._active.clear()

    def report_line(self, now: float) -> str:
        n_breaching = sum(1 for key in self._objectives
                          if key in self._active)
        return (f"slo: {len(self._objectives)} objectives, "
                f"{self.breach_count()} breach edges, "
                f"{n_breaching} currently breaching")


# ---------------------------------------------------------------------------
# workload trace synthesis (formerly runtime/trace.py)
# ---------------------------------------------------------------------------
#
# The same numpy draws in the same order as the reference, so a seed
# gives the same requests in both packages.  The traces' marginal token
# statistics match the published dataset summaries:
#
# * ShareGPT (Vicuna conversations): prompt/output token counts are
#   log-normal-ish with medians of a few hundred tokens and a heavy tail
#   (median prompt ~220, median output ~180, p99 ~2k) — the "balanced
#   input/output" workload of paper §5.1.
# * LongAlign-10k: context lengths spread 1k..64k with substantial mass
#   beyond 8k (the long-context scalability workload of Fig. 6), outputs
#   a few hundred tokens.
#
# Arrivals are Poisson at a configurable per-model RPS (paper: 0.2-1.0).


@dataclass(frozen=True)
class TraceStats:
    prompt_tokens: np.ndarray
    output_tokens: np.ndarray


def sharegpt_like(n: int, rng: np.random.Generator,
                  clip: int = 4096) -> TraceStats:
    prompt = np.clip(rng.lognormal(mean=5.4, sigma=0.9, size=n), 8,
                     clip).astype(int)
    output = np.clip(rng.lognormal(mean=5.2, sigma=0.8, size=n), 8,
                     clip).astype(int)
    return TraceStats(prompt, output)


def longalign_like(n: int, rng: np.random.Generator,
                   max_ctx: int = 65536) -> TraceStats:
    """Context lengths across 1k..64k bins with heavy long-tail mass."""
    bins = np.array([1024, 2048, 4096, 8192, 16384, 32768, 65536])
    weights = np.array([0.18, 0.2, 0.2, 0.16, 0.12, 0.09, 0.05])
    hi = rng.choice(bins, size=n, p=weights / weights.sum())
    prompt = (hi * rng.uniform(0.55, 1.0, size=n)).astype(int)
    prompt = np.minimum(prompt, max_ctx - 512)
    output = np.clip(rng.lognormal(5.0, 0.7, size=n), 16, 512).astype(int)
    return TraceStats(prompt, output)


def poisson_arrivals(rate: float, horizon_s: float,
                     rng: np.random.Generator) -> np.ndarray:
    n = rng.poisson(rate * horizon_s)
    return np.sort(rng.uniform(0.0, horizon_s, n))


def make_requests(models: List[str], *, rps_per_model: float,
                  horizon_s: float, kind: str = "sharegpt",
                  seed: int = 0, scale_tokens: float = 1.0,
                  max_new_cap: Optional[int] = None) -> List[Request]:
    """Interleaved multi-model request stream sorted by arrival time.

    ``scale_tokens`` shrinks token counts for small engine runs while
    preserving the distribution shape.
    """
    rng = np.random.default_rng(seed)
    reqs: List[Request] = []
    rid = 0
    for model in models:
        arrivals = poisson_arrivals(rps_per_model, horizon_s, rng)
        stats = (sharegpt_like(len(arrivals), rng) if kind == "sharegpt"
                 else longalign_like(len(arrivals), rng))
        for t, p, o in zip(arrivals, stats.prompt_tokens,
                           stats.output_tokens):
            p = max(int(p * scale_tokens), 1)
            o = max(int(o * scale_tokens), 1)
            if max_new_cap:
                o = min(o, max_new_cap)
            reqs.append(Request(rid, model, p, o, float(t)))
            rid += 1
    reqs.sort(key=lambda r: r.arrival_time)
    return reqs
