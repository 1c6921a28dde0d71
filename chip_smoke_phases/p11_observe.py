"""Phase 11 of ``chip_smoke.py``: observability and forensics (DESIGN.md
§10, §12-13) on phase 5's configuration and trace: (a) with an
``EngineObserver``, the flight recorder, the sanitizer and an SLO whose
minicpm3 TTFT objective (``OBSERVE_SLO``) breaches; gates: building the
engine (graph warm-ups, captures) fires no hook, exact launch counts and
one replay per block, the metrics equal ``EngineStats`` (tokens, TTFT
and TBT samples), every request's span tree complete, an audit at every
step, one breach edge and its dump, no causal drop; the same trace on a
bare engine fed the recorded dt stream gives the same streams and
virtual timestamps; then, both engines warm, four pairs in alternating
order, attached against bare, for tokens/s (the audits' share of each
pair's gap beside it), and one block dispatch (with its span, an audit
and a pool snapshot) under ``set_sync_debug_mode("error")``; (b) the
record replayed in a fresh engine, bit-exact, its breach included; (c) a
lowering-off record (pipeline on, FFN stages on the weights stream)
replayed bit-exactly; (d) each ``inject_corruption`` kind trips the
sanitizer, dumps an incident record, and its replay trips the same rule
at the same step ((c) and (d) on the models at ``RECORD_DEPTH`` layers,
published widths); (e) ``CROSSPOOL_SANITIZE=1`` through phase 9's elastic
burst (its first ``SANITIZED_BURST`` requests) and forced cycle and a phase 10 conversation with shared pages, a
shed and a fault: every audit clean. It prints the tokens/s pairs and
their median ratio, audit ms (median, max), ring events and drops, the
record's bytes, the trace's events and the replays' wall time.
"""
from __future__ import annotations

import gc
import json
import time

from chip_smoke_phases.common import (BURST_MODEL, ROOT, SERVE_K,
                                      SERVE_MAX_NEW, log, read_launches,
                                      reset_launches)
from chip_smoke_phases.p05_serve import check_coloc, graph_report
from chip_smoke_phases.p09_elastic import forced_cycle, serve_elastic
from chip_smoke_phases.p10_cache import (cache_accounting, cache_engine,
                                         check_hits, conversations,
                                         shared_and_swapped)


#: phase 11: the TTFT objective (ms) that must breach; the other models'
#: objectives never do
OBSERVE_SLO = {"minicpm3-4b": 1.0}
#: 11c's and 11d's engines: the colocated models at published widths, this
#: many layers each (each engine packs its models' weights into the
#: host's slab master, ~6 s at phase 5's depths)
RECORD_DEPTH = 1
#: 11e's elastic burst: the first this many of phase 9's 8 requests
#: (each move recaptures every model's decode graph, ~1 s); the pool must
#: still grow under the sanitizer (``elastic_moves`` checks it)
SANITIZED_BURST = 4


def audit_timer(store: list):
    """Time every ``PoolSanitizer.audit`` of any engine into ``store``
    (ms); returns the function that puts the method back."""
    from repro_torch.analysis.sanitizer import PoolSanitizer
    inner = PoolSanitizer.audit

    def timed(self):
        t0 = time.perf_counter()
        inner(self)
        store.append((time.perf_counter() - t0) * 1e3)
    PoolSanitizer.audit = timed

    def restore():
        PoolSanitizer.audit = inner
    return restore


def observe_engine(torch, models, *, observed, dump_path=None):
    """Phase 5's engine (16384 pages, ``max_batch`` 4, ``max_ctx`` 1024,
    K = ``SERVE_K``, seed 0) with,
    when ``observed``, an ``EngineObserver``, the flight recorder (its
    breach dump to ``dump_path``), the sanitizer and ``OBSERVE_SLO``;
    bare otherwise.  Returns (engine, observer)."""
    from repro_torch.configs.base import (EngineConfig, FlightRecorderConfig,
                                          SLObjective, SLOConfig)
    from repro_torch.runtime.engine import CrossPoolEngine, EngineMode
    from repro_torch.runtime.observe import EngineObserver
    mode = EngineMode(decode_steps_per_dispatch=SERVE_K)
    observer = EngineObserver() if observed else None
    config = EngineConfig(mode=mode)
    if observed:
        config = EngineConfig(
            mode=mode, sanitize=True,
            slo=SLOConfig(objectives={
                n: SLObjective(ttft_ms=OBSERVE_SLO.get(n, 1e9))
                for n in models}),
            flightrec=FlightRecorderConfig(ring_size=1 << 20,
                                           snapshot_interval_steps=4,
                                           dump_path=dump_path))
    engine = CrossPoolEngine(models, page_budget=16384, max_batch=4,
                             max_ctx=1024, seed=0, device="cuda",
                             config=config, observer=observer)
    return engine, observer


def observe_requests(np, models, first_id=0, n=8, new=SERVE_MAX_NEW):
    """Phase 5's trace: ``n`` requests at time 0 round-robin over the
    models, prompts of 200-900 tokens (the same draws for every
    ``first_id``)."""
    from repro_torch.runtime.request import Request
    rng = np.random.default_rng(0)
    names = list(models)
    return [Request(first_id + i, names[i % len(names)],
                    int(rng.integers(200, 901)), new, 0.0)
            for i in range(n)]


def observe_run(torch, engine, reqs) -> float:
    """Submit ``reqs`` at once, drain, and return the wall seconds (the
    card synchronised at both ends); every request must finish."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    engine.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for r in reqs:
        if len(r.output_ids) != r.max_new_tokens:
            raise AssertionError(f"observe: request {r.request_id} emitted "
                                 f"{len(r.output_ids)} of "
                                 f"{r.max_new_tokens} tokens")
    return wall


def span_trees(observer, reqs) -> None:
    """Every request's track in the Chrome trace: submit, (queued,)
    admitted, decode with its K-block slices, finished; the step track
    balanced with every phase."""
    from repro_torch.runtime.observe import EngineObserver
    for r in reqs:
        names = observer.tracer.span_names(f"req/{r.model}#{r.request_id}")
        seq = [x for x in names if x[0] != "X"]
        head = [("i", "submit")] + ([("B", "queued"), ("E", "queued")]
                                    if ("B", "queued") in seq else [])
        if seq != head + [("B", "admitted"), ("E", "admitted"),
                          ("B", "decode"), ("E", "decode"),
                          ("i", "finished")] \
                or ("X", "decode_block") not in names:
            raise AssertionError(f"observe: request {r.request_id}'s span "
                                 f"tree is incomplete: {names}")
    steps = observer.tracer.span_names(EngineObserver.ENGINE_TRACK)
    for phase in ("step", "admission_drain", "batcher", "prefill",
                  "dispatch", "commit", "completions", "rebalance"):
        if steps.count(("B", phase)) != steps.count(("E", phase)) \
                or ("B", phase) not in steps:
            raise AssertionError(f"observe: phase {phase} unbalanced or "
                                 f"missing on the step track")


def observed_dispatch_is_sync_free(torch, engine) -> None:
    """With the observer, recorder and sanitizer attached: one decode
    block of every model in flight, its ``dispatch`` span around it, then
    an audit and a pool snapshot, all under
    ``set_sync_debug_mode("error")``.  Leaves the engine mid-block."""
    from repro_torch.runtime.flightrec import pool_snapshot
    obs = engine.observer
    pending = []
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for runner in engine.runners.values():
            if runner.active:
                obs.phase_begin("dispatch")
                pending.append(runner.issue_decode())
                obs.phase_end("dispatch")
        engine.sanitizer.audit()
        obs.pool_counters(pool_snapshot(engine.virt, engine.arena,
                                        engine.cache))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if not pending:
        raise AssertionError("observe: no model had a block to dispatch")


def observe_replay(torch, record, label) -> dict:
    """Replay ``record`` in a fresh engine on the card; it must be
    bit-exact.  Returns the report's figures and the wall seconds (the
    engine's build included)."""
    from repro_torch.launch import replay as replay_mod
    t0 = time.perf_counter()
    report = replay_mod.replay(record, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not report.ok:
        raise AssertionError(f"{label}: replay not bit-exact: "
                             f"{report.mismatches}")
    log(f"{label}: {report.summary()} in {wall:.1f} s (engine build "
        f"included)")
    gc.collect()
    torch.cuda.empty_cache()
    return dict(ok=report.ok, steps=report.steps, tokens=report.tokens,
                ops=report.ops, failure_reproduced=report.failure_reproduced,
                wall_s=wall)


def observe_instrumented(torch, np, kops, models, card) -> dict:
    """11a-b: phase 5's trace with everything attached, then bare on the
    recorded dt stream, then alternating pairs for tokens/s, the
    sync-free dispatch, and the record's replay."""
    from repro_torch.runtime import flightrec
    out = {}
    dump = ROOT / "build" / "observe_breach.json"
    dump.unlink(missing_ok=True)
    audits: list = []
    restore = audit_timer(audits)
    try:
        t0 = time.perf_counter()
        engine, obs = observe_engine(torch, models, observed=True,
                                     dump_path=str(dump))
        bare, _ = observe_engine(torch, models, observed=False)
        torch.cuda.synchronize()
        log(f"observe: two engines built in {time.perf_counter() - t0:.1f} "
            f"s (instrumented and bare)")
        if engine.sanitizer.events:
            raise AssertionError(f"observe: building the engine (graph "
                                 f"warm-ups and captures) fired "
                                 f"{engine.sanitizer.events} hooks")
        # (a) everything attached: the main path's launch counts from 0
        reqs = observe_requests(np, models)
        del audits[:]
        reset_launches(kops)
        wall_obs = observe_run(torch, engine, reqs)
        launches = read_launches(kops)
        stats = engine.finalize()
        record = json.loads(json.dumps(engine.recorder.to_record()))
        graph_report(engine, stats, "observe")
        check_coloc(launches, stats, engine)
        if obs.tokens_total.value != stats.tokens_out \
                or sorted(obs.ttft.all_samples()) != sorted(stats.ttft) \
                or sorted(obs.tbt.all_samples()) != sorted(stats.tbt):
            raise AssertionError("observe: the metrics disagree with "
                                 "EngineStats")
        span_trees(obs, reqs)
        steps = record["events"][-1]["step"]
        if engine.sanitizer.audits < steps or not audits:
            raise AssertionError(f"observe: {engine.sanitizer.audits} "
                                 f"audits for {steps} steps")
        breaches = [e for e in record["events"] if e["kind"] == "slo_breach"]
        if not breaches or not dump.exists() or any(
                e["model"] not in OBSERVE_SLO for e in breaches):
            raise AssertionError(f"observe: breaches {breaches}, dump "
                                 f"written: {dump.exists()}")
        if flightrec.causal_drops(record):
            raise AssertionError("observe: the ring dropped causal events")
        # the same trace bare, on the recorded dt stream
        b_reqs = observe_requests(np, models)
        bare.attach_replay_clock(flightrec.record_clock(record))
        wall_bare = observe_run(torch, bare, b_reqs)
        if [(r.output_ids, r.token_times) for r in b_reqs] != \
                [(r.output_ids, r.token_times) for r in reqs]:
            raise AssertionError("observe: the bare engine's streams or "
                                 "virtual times differ on the same dt "
                                 "stream")
        bare._replay_dts = None
        log(f"observe: streams and virtual timestamps equal bare "
            f"(instrumented {wall_obs:.2f} s, bare {wall_bare:.2f} s); "
            f"metrics equal EngineStats; {len(reqs)} span trees complete; "
            f"{len(breaches)} SLO breach edge(s) "
            f"({', '.join(sorted({e['model'] for e in breaches}))}), dump "
            f"{dump.stat().st_size} bytes")
        # tokens/s, everything attached against bare: the gate runs above
        # warmed both engines; four timed pairs on the same two engines
        # (new request ids each), the order alternating, attached first
        # and bare first twice each; each pair's wall gap beside the
        # attached run's summed audit time
        tokens = sum(r.max_new_tokens for r in reqs)
        pairs, audit_ms = [], []
        for i in range(1, 5):
            walls = {}
            order = ("obs", "bare") if i % 2 else ("bare", "obs")
            for which in order:
                n_audits = len(audits)
                walls[which] = observe_run(
                    torch, bare if which == "bare" else engine,
                    observe_requests(np, models, 100 * i))
                if which == "obs":
                    audit_ms.append(sum(audits[n_audits:]))
            pairs.append((walls["obs"], walls["bare"]))
        ratios = [b / o for o, b in pairs]
        mid = sorted(ratios)
        med = (mid[1] + mid[2]) / 2
        for i, (o, b) in enumerate(pairs):
            first = "attached" if i % 2 == 0 else "bare"
            log(f"observe [{card}]: pair {i} ({first} first): "
                f"{tokens / o:.1f} tokens/s everything attached, "
                f"{tokens / b:.1f} bare, ratio {ratios[i]:.4f}; wall gap "
                f"{(o - b) * 1e3:.1f} ms, audits {audit_ms[i]:.1f} ms")
        log(f"observe [{card}]: median tokens/s ratio attached / bare "
            f"{med:.4f} (4 pairs)")
        a_sorted = sorted(audits)
        audit_med, audit_max = a_sorted[len(a_sorted) // 2], a_sorted[-1]
        log(f"observe [{card}]: sanitizer audit at page_budget "
            f"{engine.virt.page_budget}: median {audit_med:.3f} ms, max "
            f"{audit_max:.3f} ms over {len(a_sorted)} audits")
        size = len(json.dumps(record))
        n_trace = len(obs.tracer.events)
        log(f"observe: ring {len(record['events'])} events, drops "
            f"{record['dropped']}; record {size} bytes; trace "
            f"{n_trace} events (the attached engine's five runs)")
        # a block dispatch with everything attached makes no host read
        for r in observe_requests(np, models, 900, n=3, new=16):
            engine.submit(r)
        engine.step()
        engine.step()
        observed_dispatch_is_sync_free(torch, engine)
        log("observe: a block dispatch with the observer, recorder and "
            "sanitizer attached makes no host read")
        out.update(tokens_per_s_pairs=[(tokens / o, tokens / b)
                                       for o, b in pairs],
                   pair_audit_ms=audit_ms, ratios=ratios, ratio_median=med,
                   audit_ms_median=audit_med,
                   audit_ms_max=audit_max, audits=len(a_sorted),
                   ring_events=len(record["events"]),
                   ring_drops=record["dropped"], record_bytes=size,
                   trace_events=n_trace, breaches=len(breaches),
                   launches=launches)
    finally:
        restore()
    del engine, bare, obs
    gc.collect()
    torch.cuda.empty_cache()
    # (b) the record replayed in a fresh engine: the breach with it
    out["replay"] = observe_replay(torch, record, "observe replay (b)")
    return out


def observe_host_record(torch, np, models) -> dict:
    """11c: a short lowering-off record (pipeline on, K=1: FFN stages on
    the weights stream) and its replay."""
    from repro_torch.configs.base import EngineConfig, FlightRecorderConfig
    from repro_torch.runtime.engine import CrossPoolEngine, EngineMode
    engine = CrossPoolEngine(
        models, page_budget=16384, max_batch=4, max_ctx=1024, seed=0,
        device="cuda", config=EngineConfig(
            mode=EngineMode(lowering=False, pipeline=True),
            flightrec=FlightRecorderConfig(ring_size=1 << 20)))
    wall = observe_run(torch, engine, observe_requests(np, models, n=4,
                                                       new=8))
    record = json.loads(json.dumps(engine.recorder.to_record()))
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    log(f"observe host (c): 4 requests served in {wall:.2f} s")
    return observe_replay(torch, record, "observe host replay (c)")


def observe_incidents(torch, np, models) -> dict:
    """11d: each corruption kind injected mid-decode: the step raises
    ``PoolSanitizerError``, the incident dump is written, and its replay
    trips the same rule at the same step."""
    from repro_torch.analysis.sanitizer import PoolSanitizerError
    from repro_torch.launch import replay as replay_mod
    from repro_torch.runtime import flightrec
    out = {}
    for kind in flightrec.INJECTION_KINDS:
        path = ROOT / "build" / f"incident_{kind}.json"
        path.unlink(missing_ok=True)
        engine, _ = observe_engine(torch, models, observed=True,
                                   dump_path=str(path))
        for r in observe_requests(np, models, n=2, new=16):
            engine.submit(r)
        engine.step()
        engine.step()
        flightrec.inject_corruption(engine, kind)
        try:
            engine.step()
        except PoolSanitizerError as err:
            rule, step = err.rule, engine._step_index
        else:
            raise AssertionError(f"observe: {kind} did not trip the "
                                 f"sanitizer")
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        if not path.exists():
            raise AssertionError(f"observe: {kind}: no incident dump")
        record = replay_mod.load_record(str(path))
        if (record["failure"]["rule"], record["failure"]["step"]) != \
                (rule, step):
            raise AssertionError(f"observe: {kind}: the dump says "
                                 f"{record['failure']}")
        rep = observe_replay(torch, record, f"observe incident {kind} (d)")
        if not rep["failure_reproduced"]:
            raise AssertionError(f"observe: {kind}: failure not reproduced")
        log(f"observe: {kind} trips {rule} at step {step}; the dump "
            f"({path.stat().st_size} bytes) replays to the same rule and "
            f"step")
        out[kind] = dict(rule=rule, step=step, replay=rep)
    return out


def observe_sanitized_paths(torch, np, kops, models) -> dict:
    """11e: the sanitizer on (``CROSSPOOL_SANITIZE=1``) through phase 9's
    elastic burst and forced cycle and phase 10's multi-turn conversation
    with its shared pages, shed and fault; every audit clean."""
    import os
    audits: list = []
    restore = audit_timer(audits)
    os.environ["CROSSPOOL_SANITIZE"] = "1"
    out = {}
    try:
        figures, _, engine = serve_elastic(torch, np, kops, models, True,
                                           "cuda", n_burst=SANITIZED_BURST)
        if engine.sanitizer is None or not engine.sanitizer.audits:
            raise AssertionError("observe: the elastic engine ran without "
                                 "the sanitizer")
        out["elastic"] = dict(moves=figures["moves"],
                              audits=engine.sanitizer.audits,
                              events=engine.sanitizer.events)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        out["cycle"] = forced_cycle(torch, np, models[BURST_MODEL], True,
                                    "cuda", sanitize=True)
        engine = cache_engine(torch, {BURST_MODEL: models[BURST_MODEL]},
                              "cuda")
        rng = np.random.default_rng(10)
        records = conversations(np, engine, BURST_MODEL, 1, rng, turns=2)
        check_hits(records, "observe cache")
        shared = shared_and_swapped(torch, np, engine, BURST_MODEL, rng,
                                    records[-1]["rid_off"] + 1)
        cache_accounting(engine, "observe cache")
        out["cache"] = dict(audits=engine.sanitizer.audits,
                            events=engine.sanitizer.events,
                            shed_pages=shared["shed_pages"],
                            faulted_pages=shared["faulted_pages"])
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        del os.environ["CROSSPOOL_SANITIZE"]
        restore()
    out["audits"] = len(audits)
    log(f"observe (e): sanitizer clean through the elastic burst "
        f"({out['elastic']['moves']} moves, {out['elastic']['audits']} "
        f"audits), the forced cycle and the cache conversation "
        f"({out['cache']['shed_pages']} pages shed, "
        f"{out['cache']['faulted_pages']} faulted; "
        f"{out['cache']['audits']} audits); {len(audits)} audits in all")
    return out


def observe_phase(torch, np, kops, models, card) -> dict:
    """Phase 11: observability and forensics on the serve configuration."""
    t0 = time.perf_counter()
    out = dict(card=card)
    out.update(observe_instrumented(torch, np, kops, models, card))
    shallow = {n: c.replace(n_layers=RECORD_DEPTH) for n, c in models.items()}
    out["host"] = observe_host_record(torch, np, shallow)
    out["incidents"] = observe_incidents(torch, np, shallow)
    out["sanitized"] = observe_sanitized_paths(torch, np, kops, models)
    out["wall_s"] = time.perf_counter() - t0
    log(f"observe [{card}]: replay wall {out['replay']['wall_s']:.1f} s "
        f"(b), {out['host']['wall_s']:.1f} s (c); phase wall "
        f"{out['wall_s']:.1f} s")
    return out


def run(ctx) -> None:
    """Observability and forensics on the serve configuration."""
    from repro_torch.launch.serve import coloc_models
    log(f"observe: phase 5's trace with the observer, recorder, sanitizer "
        f"and SLO {OBSERVE_SLO} attached, K={SERVE_K}")
    ctx.out[11] = dict(observe=observe_phase(
        ctx.torch, ctx.np, ctx.kops, coloc_models(full_width=True),
        ctx.card))
