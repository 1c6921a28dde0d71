"""The port's observability layer against the JAX package's.

* registry, tracer and SLO monitor: one operation sequence through
  ``repro.runtime.observe`` and ``repro_torch.runtime.observe`` under one
  fake clock gives identical Prometheus text, snapshot JSON and Chrome
  trace; histogram percentiles are ``np.percentile``; the SLO breach
  edges of a hypothesis-drawn sample stream are the reference's;
* the engine: a live JAX engine and the port's engine (the elastic
  burst, an arena sized for one model so a request queues, an SLO that
  breaches, the sanitizer and the flight recorder on) fed one synthetic
  dispatch-time stream give the same metrics snapshot, span-name
  sequence on every track, Chrome trace, ``report()`` and token
  streams, in both lowering modes; the port's metrics equal its
  ``EngineStats``; with everything detached the streams and virtual
  times are bit-exact;
* the core hooks: under random virtualizer / swap / resize / reserve
  ops, prefix-cache ops and arena moves, both packages fire the same
  hook stream, and the port's sanitizer audits clean after every op;
  ``CROSSPOOL_SANITIZE=1`` attaches it;
* the serve CLI with ``--metrics-out``, ``--trace-out``, ``--slo`` and
  ``--flight-record-out`` writes files that parse, and ``launch/report``
  renders the reference's tables.

Tolerance: equality everywhere — the registries hold the same floats
folded from the same dt stream, and the pool counters are integers.
"""
import dataclasses
import json
import math

import jax
import numpy as np
import pytest
from hypothesis import example, given, settings, strategies as st

from repro.analysis.sanitizer import (PoolSanitizer as JSanitizer,
                                      PoolSanitizerError as JSanitizerError)
from repro.configs import ElasticConfig as JElastic
from repro.configs import EngineConfig as JConfig
from repro.configs import FlightRecorderConfig as JRec
from repro.configs import SLObjective as JObjective
from repro.configs import SLOConfig as JSLO
from repro.configs import get_smoke_config
from repro.core import virtualizer as j_virt
from repro.core import weight_pool as j_wp
from repro.core.hooks import CoreHooks as JHooks
from repro.core.weight_pool import slabs_for_config
from repro.launch import report as j_report
from repro.launch import serve as j_serve
from repro.models import build_model
from repro.runtime import observe as j_obs
from repro.runtime.engine import CrossPoolEngine as JEngine
from repro.runtime.engine import EngineMode as JMode
from repro.runtime.flightrec import record_clock
from repro.runtime.request import Request as JRequest
from repro_torch.analysis.sanitizer import PoolSanitizer, PoolSanitizerError
from repro_torch.bridge import params_to_torch
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs.base import (ElasticConfig, EngineConfig,
                                      FlightRecorderConfig, SLObjective,
                                      SLOConfig)
from repro_torch.core import virtualizer as t_virt
from repro_torch.core import weight_pool as t_wp
from repro_torch.core.hooks import CompositeHooks, CoreHooks
from repro_torch.launch import replay as replay_mod
from repro_torch.launch import report as t_report
from repro_torch.launch import serve
from repro_torch.runtime import observe as t_obs
from repro_torch.runtime.engine import CrossPoolEngine, EngineMode
from repro_torch.runtime.request import Request
from test_elastic import _check_invariants
from test_torch_elastic import _trees, _virt_pair
from test_torch_flightrec import synthetic_clock
from test_torch_prefix_cache import _OPS as CACHE_OPS
from test_torch_prefix_cache import _pair as _cache_pair
from torch_threads import one_torch_thread  # noqa: F401

MOE, MLA, MOON = "qwen3-moe-235b-a22b", "minicpm3-4b", "moonshot-v1-16b-a3b"
MODELS = (MLA, MOE)


class FakeClock:
    """Deterministic monotonic clock: +1 ms per reading."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        self.t += 0.001
        return self.t


def _dumps(obj) -> str:
    """JSON text for an equality check (NaN-safe: NaN != NaN)."""
    return json.dumps(obj, sort_keys=True)


# ---------------------------------------------------------------------------
# (a) registry, tracer and SLO monitor
# ---------------------------------------------------------------------------

def _registry_ops(mod):
    reg = mod.MetricsRegistry(event_log_size=4)
    c = reg.counter("reqs_total", "requests", ("model", "outcome"))
    c.labels("a", "ok").inc()
    c.labels("a", "ok").inc(2.5)
    c.labels("b", "err").inc()
    reg.counter("plain_total").inc(3)
    g = reg.gauge("occupancy", "mapped / budget")
    g.set(0.25)
    reg.gauge("depth", "", ("pool",)).labels("kv").set(7)
    h = reg.histogram("lat_seconds", "latency", ("model",))
    for i, v in enumerate([0.0005, 0.003, 0.004, 0.2, 3.0, 0.01, 0.01]):
        h.labels("ab"[i % 2]).observe(v)
    reg.histogram("batch", buckets=(1, 2, 4)).observe(3)
    reg.histogram("empty", "never observed", ("m",)).labels("x")
    for i in range(7):                      # 3 over the bound: dropped
        reg.log_event("rebalance", step=i, reason="kv_demand")
    reg.log_event("slo_breach", model="a", time=0.5)
    return reg


def test_registry_text_and_snapshot_equal_reference():
    j, t = _registry_ops(j_obs), _registry_ops(t_obs)
    assert t.prometheus_text() == j.prometheus_text()
    assert _dumps(t.snapshot()) == _dumps(j.snapshot())
    assert t.events_dropped() == j.events_dropped() == {"rebalance": 3}
    assert t.recent_events("rebalance", 2) == j.recent_events("rebalance", 2)
    assert t.get("lat_seconds").all_samples() == \
        j.get("lat_seconds").all_samples()


@settings(max_examples=40, deadline=None)
@given(values=st.lists(st.floats(-1e3, 1e3), max_size=40),
       q=st.floats(0.0, 100.0))
def test_histogram_percentile_is_numpy(values, q):
    reg = t_obs.MetricsRegistry()
    h = reg.histogram("x_seconds", "", ("m",))
    for v in values:
        h.labels("m").observe(v)
    got = h.percentile(q)
    want = float(np.percentile(values, q)) if values else float("nan")
    assert got == want or (math.isnan(got) and math.isnan(want))
    assert _dumps(t_obs.summarize(values)) == _dumps(j_obs.summarize(values))


def _tracer_ops(mod):
    tr = mod.SpanTracer(clock=FakeClock())
    tr.begin("engine", "step", step=1)
    tr.begin("engine", "prefill", cat="phase")
    tr.complete("model/a", "prefill", 0.004, cat="dispatch", batch=2)
    tr.complete("model/a", "early", 5.0)      # clamps at the origin
    tr.end("engine", "prefill", cat="phase")
    tr.instant("req/a#0", "submit", cat="request", outcome="admitted")
    tr.counter("pool/kv", "kv_pages", free=3, request=5, tree=0)
    tr.end("engine", "step")
    return tr


def test_tracer_chrome_trace_equals_reference():
    j, t = _tracer_ops(j_obs), _tracer_ops(t_obs)
    assert t.chrome_trace() == j.chrome_trace()
    for track in ("engine", "model/a", "req/a#0", "pool/kv", "absent"):
        assert t.span_names(track) == j.span_names(track)


_SLO_STREAM = st.lists(
    st.tuples(st.floats(0.0, 0.4),                 # time step (s)
              st.sampled_from(["a", "b", "c"]),    # model (c: untracked)
              st.sampled_from(["ttft", "tbt", "queue_wait"]),
              st.floats(0.0, 0.2),                 # sample (s)
              st.booleans()),                      # evaluate after it
    max_size=60)


@settings(max_examples=30, deadline=None)
@given(stream=_SLO_STREAM, reset_at=st.integers(0, 60))
def test_slo_breach_edges_equal_reference(stream, reset_at):
    objectives = dict(a=dict(ttft_ms=50.0, tbt_p99_ms=20.0, target=0.9),
                      b=dict(queue_wait_ms=100.0, target=0.99))
    kw = dict(window_s=2.0, short_window_s=0.5, burn_rate_threshold=2.0)
    j = j_obs.SLOMonitor(JSLO(objectives={
        m: JObjective(**o) for m, o in objectives.items()}, **kw))
    t = t_obs.SLOMonitor(SLOConfig(objectives={
        m: SLObjective(**o) for m, o in objectives.items()}, **kw))
    now = 0.0
    for i, (dt, model, metric, value, evaluate) in enumerate(stream):
        now += dt
        if i == reset_at:
            j.reset()
            t.reset()
        j.note(metric, model, value, now)
        t.note(metric, model, value, now)
        if evaluate:
            assert [dataclasses.asdict(b) for b in t.evaluate(now)] == \
                [dataclasses.asdict(b) for b in j.evaluate(now)]
            assert _dumps({str(k): v for k, v in t.status(now).items()}) \
                == _dumps({str(k): v for k, v in j.status(now).items()})
    assert t.report_line(now) == j.report_line(now)
    assert t.breach_count() == j.breach_count()
    assert _dumps(t.metrics.snapshot()) == _dumps(j.metrics.snapshot())
    assert t.metrics.recent_events("slo_breach") == \
        j.metrics.recent_events("slo_breach")


def test_trace_generators_equal_reference():
    kw = dict(rps_per_model=0.8, horizon_s=20.0, seed=3, scale_tokens=0.2,
              max_new_cap=16)
    for kind in ("sharegpt", "longalign"):
        j = j_obs.make_requests(list(MODELS), kind=kind, **kw)
        t = t_obs.make_requests(list(MODELS), kind=kind, **kw)
        assert [(r.request_id, r.model, r.prompt_tokens, r.max_new_tokens,
                 r.arrival_time) for r in t] == \
            [(r.request_id, r.model, r.prompt_tokens, r.max_new_tokens,
              r.arrival_time) for r in j]


# ---------------------------------------------------------------------------
# (b) the engine against a live JAX engine
# ---------------------------------------------------------------------------

ENGINE_KW = dict(page_budget=24, page_bytes=4096, slab_bytes=4096,
                 max_batch=4, max_ctx=64, seed=0)
ELASTIC = dict(interval_steps=1, cooldown_steps=1, hysteresis=0.05,
               window_s=60.0, min_page_budget=8, quantile=0.95)


def _slot_budget():
    """An arena for the larger model alone: the other model's requests
    queue on weight pressure until the first drains."""
    return max(slabs_for_config(get_smoke_config(n).replace(
        dtype="float32"), 4096) for n in MODELS)


def _config(pkg, lowering):
    Cfg, Mode, Elastic, Rec, SLO, Obj = (
        (JConfig, JMode, JElastic, JRec, JSLO, JObjective) if pkg == "j"
        else (EngineConfig, EngineMode, ElasticConfig, FlightRecorderConfig,
              SLOConfig, SLObjective))
    return Cfg(mode=Mode(pipeline=True, lowering=lowering,
                         decode_steps_per_dispatch=4),
               elastic=Elastic(**ELASTIC), sanitize=True,
               slo=SLO(objectives={MLA: Obj(ttft_ms=10.0, tbt_p99_ms=1.2),
                                   MOE: Obj(queue_wait_ms=1.0)},
                       window_s=4.0, short_window_s=1.0),
               flightrec=Rec(ring_size=65536, snapshot_interval_steps=3))


def _trace(Req):
    """The elastic burst (six minicpm3 prompts at time 0 on a 24-page
    pool) and two qwen3-moe requests arriving during it."""
    rng = np.random.default_rng(11)
    vocab = get_smoke_config(MLA).vocab_size
    reqs = [Req(i, MLA, 16, 3, 0.0, prompt_ids=rng.integers(0, vocab, 16))
            for i in range(6)]
    return reqs + [Req(6, MOE, 9, 4, 0.01), Req(7, MOE, 5, 2, 0.03)]


@pytest.fixture(scope="module")
def params():
    models = {n: get_smoke_config(n).replace(dtype="float32")
              for n in MODELS}
    return {n: jax.tree.map(np.asarray,
                            build_model(c).init(jax.random.PRNGKey(i)))
            for i, (n, c) in enumerate(models.items())}


def _port_engine(params, lowering, observer=None, config=None):
    tm = {n: t_smoke(n).replace(dtype="float32") for n in MODELS}
    return CrossPoolEngine(
        tm, config=config or _config("t", lowering), observer=observer,
        device="cpu", slot_budget=_slot_budget(),
        params={n: params_to_torch(p) for n, p in params.items()},
        **ENGINE_KW)


@pytest.fixture(scope="module", params=[True, False],
                ids=["lowered", "host"])
def observed(request, params):
    """One session through a live JAX engine and the port's, everything
    attached, one synthetic dt stream; then the port bare on the same
    stream.  Returns a dict of both sides."""
    lowering = request.param
    jm = {n: get_smoke_config(n).replace(dtype="float32") for n in MODELS}
    j_obs_ = j_obs.EngineObserver(clock=FakeClock())
    je = JEngine(jm, config=_config("j", lowering), observer=j_obs_,
                 slot_budget=_slot_budget(), **ENGINE_KW)
    synthetic_clock(je)
    j_reqs = _trace(JRequest)
    j_stats = je.run(j_reqs)
    stream = record_clock(json.loads(json.dumps(je.recorder.to_record())))

    t_obs_ = t_obs.EngineObserver(clock=FakeClock())
    te = _port_engine(params, lowering, observer=t_obs_)
    te.attach_replay_clock(stream)
    t_reqs = _trace(Request)
    t_stats = te.run(t_reqs)
    assert not te._replay_dts

    bare = _port_engine(params, lowering, config=EngineConfig(
        mode=EngineMode(pipeline=True, lowering=lowering,
                        decode_steps_per_dispatch=4),
        elastic=ElasticConfig(**ELASTIC)))
    bare.attach_replay_clock(stream)
    b_reqs = _trace(Request)
    bare.run(b_reqs)
    return dict(je=je, jo=j_obs_, j_reqs=j_reqs, j_stats=j_stats,
                te=te, to=t_obs_, t_reqs=t_reqs, t_stats=t_stats,
                bare=bare, b_reqs=b_reqs)


def test_session_covers_queue_breach_and_rebalance(observed):
    te, t_stats = observed["te"], observed["t_stats"]
    assert te.admission.stats.queued > 0, "nothing queued"
    assert t_stats.rebalance_events, "the burst never rebalanced"
    assert te.slo.breach_count() > 0, "no SLO breach edge"
    assert te.sanitizer.audits > 0 and te.sanitizer.events > 0
    assert t_stats.tokens_out == sum(r.max_new_tokens
                                     for r in observed["t_reqs"])


def test_streams_equal_jax(observed):
    assert [r.output_ids for r in observed["t_reqs"]] == \
        [r.output_ids for r in observed["j_reqs"]]
    assert [r.token_times for r in observed["t_reqs"]] == \
        [r.token_times for r in observed["j_reqs"]]


def test_metrics_snapshot_equals_jax(observed):
    to, jo = observed["to"], observed["jo"]
    assert _dumps(to.metrics.snapshot()) == _dumps(jo.metrics.snapshot())
    assert to.metrics.prometheus_text() == jo.metrics.prometheus_text()
    assert observed["te"].metrics.recent_events("rebalance") == \
        observed["je"].metrics.recent_events("rebalance")


def test_span_sequences_equal_jax(observed):
    """Every track's (phase, name) sequence, and under the shared fake
    clock the whole Chrome trace."""
    to, jo = observed["to"], observed["jo"]
    assert list(to.tracer._tids) == list(jo.tracer._tids)
    for track in jo.tracer._tids:
        assert to.tracer.span_names(track) == jo.tracer.span_names(track), \
            track
    assert to.tracer.chrome_trace() == jo.tracer.chrome_trace()


def test_flight_record_with_moves_equals_jax(observed):
    """The same session's flight records: the rebalance decisions, swap
    and resize events, snapshots, streams and final accounting."""
    t_rec = json.loads(json.dumps(observed["te"].recorder.to_record()))
    j_rec = json.loads(json.dumps(observed["je"].recorder.to_record()))
    assert any(e["kind"] == "rebalance" for e in t_rec["events"])
    for part in ("events", "snapshots", "streams", "final", "dropped"):
        assert t_rec[part] == j_rec[part], part


def test_report_equals_jax(observed):
    text = observed["te"].report()
    assert text == observed["je"].report()
    assert "move @step" in text and "breach @" in text


def test_metrics_match_engine_stats(observed):
    """The port's histograms hold exactly its ``EngineStats`` samples."""
    te, to, stats = observed["te"], observed["to"], observed["t_stats"]
    assert to.tokens_total.value == stats.tokens_out
    assert sorted(to.ttft.all_samples()) == sorted(stats.ttft)
    assert sorted(to.tbt.all_samples()) == sorted(stats.tbt)
    assert sorted(to.prefill_batch.all_samples()) == \
        sorted(stats.prefill_batch_sizes)
    assert sorted(to.decode_seconds.all_samples()) == sorted(
        dt for log in stats.step_times.values() for dt in log)
    adm = te.admission.stats
    for (model, outcome), child in to.admission_total.children.items():
        assert child.value == getattr(adm.per_model[model], outcome)
    assert to.requests_total.value == len(observed["t_reqs"])
    assert to._kv_occ.value == \
        te.virt.mapped_pages / max(te.virt.page_budget, 1)


def _validate_chrome_trace(trace: dict) -> None:
    """What Perfetto / chrome://tracing ingest: B/E balanced per track,
    one ``thread_name`` per tid, named before use, no negative time."""
    assert set(trace) == {"traceEvents", "displayTimeUnit"}
    named, depth = set(), {}
    for e in trace["traceEvents"]:
        assert e["ph"] in {"B", "E", "X", "i", "M", "C"}, e
        if e["ph"] == "M":
            assert e["tid"] not in named
            named.add(e["tid"])
            continue
        assert e["tid"] in named and e["ts"] >= 0
        if e["ph"] == "B":
            depth[e["tid"]] = depth.get(e["tid"], 0) + 1
        elif e["ph"] == "E":
            depth[e["tid"]] -= 1
            assert depth[e["tid"]] >= 0
    assert all(d == 0 for d in depth.values()), depth


def test_chrome_trace_schema_and_request_span_trees(observed):
    to = observed["to"]
    _validate_chrome_trace(json.loads(json.dumps(to.tracer.chrome_trace())))
    for r in observed["t_reqs"]:
        seq = [(ph, n) for ph, n in
               to.tracer.span_names(f"req/{r.model}#{r.request_id}")
               if ph != "X"]
        head = [("i", "submit")] + ([("B", "queued"), ("E", "queued")]
                                    if ("B", "queued") in seq else [])
        assert seq == head + [("B", "admitted"), ("E", "admitted"),
                              ("B", "decode"), ("E", "decode"),
                              ("i", "finished")], r.request_id
    steps = to.tracer.span_names(t_obs.EngineObserver.ENGINE_TRACK)
    for phase in ("admission_drain", "batcher", "prefill", "dispatch",
                  "commit", "completions", "rebalance"):
        assert ("B", phase) in steps and ("E", phase) in steps, phase


def test_detached_session_is_bit_exact(observed):
    """Observer, SLO, sanitizer and recorder off: nothing is attached to
    the pools, and the streams and virtual times are the instrumented
    run's."""
    bare = observed["bare"]
    assert bare.observer is None and bare.recorder is None
    assert bare.sanitizer is None and bare.slo is None
    assert bare.virt.hooks is None and bare.arena.hooks is None
    assert bare.admission.hooks is None
    assert bare.rebalancer.hooks is None
    assert [(r.output_ids, r.token_times) for r in observed["b_reqs"]] == \
        [(r.output_ids, r.token_times) for r in observed["t_reqs"]]
    assert bare.metrics.recent_events("rebalance") == \
        observed["te"].metrics.recent_events("rebalance")


def _signals(telemetry):
    return (telemetry.kv_occupancy_ewma, telemetry.slab_occupancy_ewma,
            telemetry.queue_depth_ewma, telemetry.last,
            telemetry.steps_observed)


def test_gauge_fed_telemetry_equals_detached_and_jax(observed):
    """The elastic engine hands its observer to telemetry, which folds
    the observer's gauges: the EWMAs and the last sample equal (``==``)
    those of the same run with no observer (sampled from the pools) and
    the live JAX engine's (gauge-fed too)."""
    te, bare, je = observed["te"], observed["bare"], observed["je"]
    assert te.telemetry.gauges is te.observer
    assert bare.telemetry.gauges is None
    assert je.telemetry.gauges is observed["jo"]
    assert te.telemetry.steps_observed > 0
    assert _signals(te.telemetry) == _signals(bare.telemetry)
    assert _signals(te.telemetry) == _signals(je.telemetry)


@pytest.mark.parametrize("with_arena", [True, False],
                         ids=["arena", "no-arena"])
def test_telemetry_gauge_fed_matches_direct_sampling(with_arena):
    """The counterpart of the reference's test of the same name: over one
    pool sequence the gauge-fed EWMAs and ``last`` equal direct sampling
    (``==``) in each package, and the port's equal the reference's."""
    from types import SimpleNamespace

    from repro.runtime.telemetry import DemandTelemetry as JTelemetry
    from repro_torch.runtime.telemetry import DemandTelemetry as TTelemetry
    out = {}
    for pkg, tel, obs, elastic, smoke in (
            ("j", JTelemetry, j_obs, JElastic, get_smoke_config),
            ("t", TTelemetry, t_obs, ElasticConfig, t_smoke)):
        models = {MLA: smoke(MLA).replace(dtype="float32")}
        direct = tel(models, elastic())
        observer = obs.EngineObserver(clock=FakeClock())
        fed = tel(models, elastic(), gauges=observer)
        for step in range(6):
            virt = SimpleNamespace(mapped_pages=(7 * step) % 11,
                                   page_budget=10 + step,
                                   swapped_now=step % 3)
            arena = SimpleNamespace(resident_slabs=3 + 2 * step,
                                    slot_budget=17) if with_arena else None
            admission = SimpleNamespace(queued_count=lambda: 5 - step)
            direct.observe(float(step), virt, arena, admission)
            observer.sample(virt, arena, admission, waiting=step)
            fed.observe(float(step), virt, arena, admission)
            assert _signals(fed) == _signals(direct), (pkg, step)
        out[pkg] = _signals(fed)
    assert out["t"] == out["j"]


def test_sanitize_env_var_attaches_the_sanitizer(params, monkeypatch):
    monkeypatch.setenv("CROSSPOOL_SANITIZE", "1")
    engine = _port_engine(params, True, config=EngineConfig())
    assert isinstance(engine.sanitizer, PoolSanitizer)
    assert engine.virt.hooks is engine.sanitizer
    engine.submit(Request(0, MLA, 7, 2, 0.0))
    engine.drain()
    assert engine.sanitizer.audits >= 2


# ---------------------------------------------------------------------------
# (c) the core hooks and the sanitizer under random operations
# ---------------------------------------------------------------------------

class _Log:
    """A hook sink that logs every call (either package's protocol)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append(
            (name, tuple(a.to_record() if hasattr(a, "to_record") else a
                         for a in args)))


def _every_hook_is_a_core_hook():
    names = {n for n in vars(JHooks) if not n.startswith("_")}
    assert names == {n for n in vars(CoreHooks) if not n.startswith("_")}
    assert len(names) == 17
    return names


def test_composite_hooks_fan_out_in_order():
    names = _every_hook_is_a_core_hook()
    a, b = _Log(), _Log()
    fan = CompositeHooks(a, None, b)
    for name in sorted(names):
        n_args = getattr(CoreHooks, name).__code__.co_argcount - 1
        getattr(fan, name)(*range(n_args))
    assert a.calls == b.calls and len(a.calls) == len(names)


@settings(max_examples=15, deadline=None)
@given(ops=st.lists(
    st.tuples(st.sampled_from(["register", "extend", "release", "swap",
                               "fault", "grow", "shrink", "reserve",
                               "commit"]),
              st.sampled_from([MOE, MLA, MOON]),
              st.integers(1, 600)),
    min_size=1, max_size=30))
@example(ops=[("register", MOE, 32), ("commit", MOE, 1)])   # SAN05 in both
def test_virtualizer_hooks_equal_reference_and_audit_clean(ops):
    """``test_torch_elastic``'s swap / resize sequence with decode-block
    reserve / commit added: both packages fire the same hooks with the
    same payloads, and the port's sanitizer (after the log in the
    fan-out) reconciles every counter and audits clean after each op,
    except after a commit that outruns its reservation, where both
    packages' sanitizers raise the same SAN05."""
    jv, tv = _virt_pair(64)
    j_log, t_log = _Log(), _Log()
    sanitizer, j_sanitizer = PoolSanitizer(tv), JSanitizer(jv)
    jv.hooks = CompositeHooks(j_log, j_sanitizer)
    tv.hooks = CompositeHooks(t_log, sanitizer)
    live, next_id = [], 0
    for op, model, arg in ops:
        if op == "register" or not live:
            op = "register"
        rid = live[0] if live else next_id
        # a commit past the pages its reservation mapped is a fault no
        # engine makes: the sanitizer must name it (SAN05), and the pool
        # is left corrupt, so the sequence ends there
        outruns = op == "commit" and _commit_outruns(tv, rid, arg % 3)
        outs = []
        for v, err in ((jv, j_virt.OutOfPagesError),
                       (tv, t_virt.OutOfPagesError)):
            try:
                if op == "register":
                    v.register_request(next_id, model, arg)
                elif op == "extend":
                    v.extend_request(rid, arg)
                elif op == "release":
                    v.release_request(rid)
                elif op == "swap":
                    v.swap_out(rid, max_pages=arg)
                elif op == "fault":
                    v.ensure_resident(rid)
                elif op == "grow":
                    v.resize(v.page_budget + (arg % 64) + 1)
                elif op == "shrink":
                    v.resize(max(v.page_budget - (arg % 64) - 1, 1))
                elif op == "reserve":
                    v.ensure_resident(rid)
                    v.reserve_decode_block(rid, 1 + arg % 40)
                else:
                    v.commit_decode_block(rid, arg % 3)
                outs.append("ok")
            except err:
                outs.append("oom")
        assert outs[0] == outs[1], (op, outs)
        if op == "register" and outs[0] == "ok":
            live.append(next_id)
            next_id += 1
        elif op == "release":
            live.remove(rid)
        assert t_log.calls == j_log.calls
        if outruns:
            with pytest.raises(JSanitizerError, match="SAN05") as want:
                j_sanitizer.audit()
            with pytest.raises(PoolSanitizerError, match="SAN05") as got:
                sanitizer.audit()
            assert str(got.value) == str(want.value)
            break
        _check_invariants(tv)
        sanitizer.audit()
    assert sanitizer.events == len(t_log.calls)


def _commit_outruns(virt, rid: int, n: int) -> bool:
    """Whether committing ``n`` tokens of ``rid`` needs more chunks a
    layer than its tables map (what a reservation would have mapped)."""
    req = virt.requests[rid]
    view = virt.views[req.model]
    return bool(view.n_kv_layers) and len(req.tables[0]) < math.ceil(
        max(req.tokens + n, 1) / view.tokens_per_page)


@settings(max_examples=12, deadline=None)
@given(CACHE_OPS, st.integers(0, 2 ** 30), st.booleans())
def test_cache_hooks_equal_reference_and_audit_clean(ops, seed,
                                                     second_chance):
    """``test_torch_prefix_cache``'s produce / share / shed / evict /
    release / fault sequence: the same hook stream in both packages
    (virtualizer and tree on one sink), and the port's sanitizer audits
    the shared pages, refcounts and the swap tier clean after each op."""
    rng = np.random.default_rng(seed)
    jv, jc, tv, tc = _cache_pair(second_chance=second_chance)
    j_log, t_log = _Log(), _Log()
    sanitizer = PoolSanitizer(tv, cache=tc)
    jv.hooks = jc.hooks = j_log
    tv.hooks = tc.hooks = CompositeHooks(t_log, sanitizer)
    base = rng.integers(0, 4, 48).astype(np.int32)
    live, next_rid = [], 0
    for op, arg in ops:
        model = (MOE, MLA)[arg % 2]
        n = 4 + arg % 29
        ids = np.concatenate([base[:min(n, 48)], rng.integers(
            0, 4, n - min(n, 48)).astype(np.int32)])
        for virt, cache in ((jv, jc), (tv, tc)):
            try:
                if op == "produce":
                    virt.register_request(next_rid, model, len(ids))
                    view = virt.views[model]
                    rp = virt.requests[next_rid]
                    cache.insert(model, 64, ids, [
                        [rp.tables[la][c] for la in range(view.n_kv_layers)]
                        for c in range(-(-len(ids) // view.tokens_per_page))])
                elif op == "share":
                    matched, nodes = cache.match_prefix(model, 64, ids)
                    fork = min(matched, len(ids) - 1)
                    tpp = virt.views[model].tokens_per_page
                    full, rem = fork // tpp, fork % tpp
                    if fork > 0:
                        cache.fault_chunks(nodes[:full + (1 if rem else 0)])
                        virt.register_request_with_prefix(
                            next_rid, model, len(ids),
                            [nd.pages for nd in nodes[:full]],
                            nodes[full].pages if rem else None)
                    else:
                        virt.register_request(next_rid, model, len(ids))
                    cache.record_admission(model, len(ids), fork)
                elif op == "shed":
                    cache.shed(1 + arg % 8)
                elif op == "evict":
                    cache.evict(1 + arg % 8)
                elif op == "fault":
                    cache.fault_chunks(cache.match_prefix(model, 64, ids)[1])
                elif live:
                    virt.release_request(live[arg % len(live)])
            except (t_virt.OutOfPagesError, j_virt.OutOfPagesError):
                pass
        if op in ("produce", "share") and next_rid in tv.requests:
            live.append(next_rid)
            next_rid += 1
        elif op in ("produce", "share"):
            next_rid += 1
        elif op == "release" and live:
            live.pop(arg % len(live))
        assert t_log.calls == j_log.calls
        sanitizer.audit()
    assert tc.snapshot() == jc.snapshot()


def test_arena_hooks_equal_reference():
    """Activate / evict / upload / resize (the elastic arena sequence):
    the same hook stream, with the counters reconciled by the sanitizer
    at every call."""
    from repro.configs import PAPER_COLOC_SET
    j_arena = j_wp.WeightArena(slab_bytes=2048)
    t_arena = t_wp.WeightArena(slab_bytes=2048, device="cpu")
    for name in PAPER_COLOC_SET:
        jcfg, jw, tw = _trees(name, "float32")
        j_arena.add_model(name, jcfg, jw)
        t_arena.add_model(name, t_smoke(name).replace(dtype="float32"), tw)
    j_arena.finalize()
    t_arena.finalize()
    j_log, t_log = _Log(), _Log()
    tv = _virt_pair(8)[1]
    sanitizer = PoolSanitizer(tv, arena=t_arena)
    j_arena.hooks = j_log
    t_arena.hooks = CompositeHooks(t_log, sanitizer)
    for arena in (j_arena, t_arena):
        arena.activate(MOE)
        arena.activate(MLA, upload=False)
        arena.prefetch_layer(MLA, 0)
        arena.ensure_model_uploaded(MLA)
        arena.pin(MLA)
        floor = arena.min_slot_budget()
        arena.resize(floor)                       # evicts moe, compacts
        arena.resize(floor + arena.views[MOON].total_slabs + 3)
        arena.activate(MOON)
    assert t_log.calls == j_log.calls
    assert {c[0] for c in t_log.calls} == {
        "arena_activate", "arena_evict", "arena_upload", "arena_resize"}
    sanitizer.audit()


# ---------------------------------------------------------------------------
# (d) the CLIs
# ---------------------------------------------------------------------------

def test_serve_cli_observability_flags(tmp_path, capsys):
    metrics, trace = tmp_path / "m.prom", tmp_path / "t.json"
    record = tmp_path / "rec.json"
    serve.main(["--device", "cpu", "--horizon", "4", "--max-new", "3",
                "--metrics-out", str(metrics), "--trace-out", str(trace),
                "--slo", "*:ttft_ms=1,tbt_p99_ms=1",
                "--flight-record-out", str(record)])
    out = capsys.readouterr().out
    assert "slo: 6 objectives" in out and "flight record ->" in out
    text = metrics.read_text()
    assert "# TYPE crosspool_tokens_total counter" in text
    assert "crosspool_ttft_seconds_bucket" in text
    assert "crosspool_slo_breaches_total" in text
    _validate_chrome_trace(json.loads(trace.read_text()))
    rec = replay_mod.load_record(str(record))
    assert rec["streams"] and rec["engine"]["slo"]["objectives"]


@pytest.mark.parametrize("specs", [
    ["*:ttft_ms=200,tbt_p99_ms=50"],
    [f"{MOE}:queue_wait_ms=500,target=0.99", "*:ttft_ms=10",
     f"{MLA}:tbt_p99_ms=2"],
])
def test_parse_slo_specs_equals_reference(specs):
    names = [MOE, MOON, MLA]
    got = serve.parse_slo_specs(specs, names)
    want = j_serve.parse_slo_specs(specs, names)
    assert {m: dataclasses.asdict(o) for m, o in got.objectives.items()} \
        == {m: dataclasses.asdict(o) for m, o in want.objectives.items()}
    with pytest.raises(SystemExit):
        serve.parse_slo_specs(["nobody:ttft_ms=1"], names)


def test_report_cli_tables_equal_reference(tmp_path, capsys):
    cell = dict(arch="qwen3-14b", shape="decode_32k", strategy="crosspool",
                ok=True, lower_s=3.2, compile_s=11.0,
                memory=dict(argument_bytes=3 * 2 ** 30, temp_bytes=None),
                roofline=dict(
                    collective_breakdown={"count": 4, "all-gather": 2 ** 24,
                                          "all-reduce": 0},
                    t_compute=1.5e-3, t_memory=2e-3, t_collective=0.0,
                    dominant="memory", useful_flops_ratio=0.81,
                    roofline_fraction=0.44))
    lines = [cell, dict(arch="x", shape="y", skipped=True, reason="too big"),
             dict(arch="z", shape="y", strategy="s", ok=False, error="boom")]
    path = tmp_path / "cells.jsonl"
    path.write_text("\n".join(json.dumps(c) for c in lines) + "\n")
    records = t_report.load(str(path))
    assert t_report.dryrun_table(records) == j_report.dryrun_table(records)
    assert t_report.roofline_table(records) == \
        j_report.roofline_table(records)
    t_report.main([str(path), "--kind", "roofline"])
    assert "**memory**" in capsys.readouterr().out
