"""Phase 9 of ``chip_smoke.py``: the elastic KV<->weights boundary
(DESIGN.md §8) on the colocated set at published widths, bf16, depths
cut to ``FULL_WIDTH_DEPTHS``, ``max_ctx`` 4096, K=4: minicpm3 is the
burst target (dense FFN: its tokens do not depend on batch composition),
qwen3-moe and moonshot are registered and idle, so their slabs are the
slack. An elastic engine (``ELASTIC``, 1024 pages of 16 KiB to start)
and a frozen one with the same budgets each serve 8 minicpm3 requests at
time 0 (prompts of 1500-3000 tokens, 32 new tokens), then 2 qwen3-moe
and 2 moonshot requests after them (130-200 tokens: each model's pair
prefills and decodes together on both engines). The elastic engine
carries an observer, whose gauges feed its telemetry. Gates: at least
one KV grow, the gauge-fed telemetry's EWMAs equal to a direct-sampled
``DemandTelemetry``'s at every step, bit for bit, device bytes conserved
on every move, every request's token count, no page left mapped, the
frozen engine's greedy streams, every split model's decode graph
captured again exactly once per move that moved its pool or arena (and
nothing replayed over a moved buffer), exact launch
counts of the paged kernels and the pool write (a capture's warm-up runs
the body once), and after the moves a replay equals the eager body and a
block dispatch makes no host read. Then the forced cycle on minicpm3
alone (4 requests of 2000 tokens, lowering on and off): a shrink that
swaps and compacts, a swap-out of the active requests, a grow and the
fault-in; every step's logits equal the unperturbed run's bit for bit,
and a replay over the moved pool without a new capture raises. It prints
the moves, ms per pool grow, pool shrink and arena shrink, ms per
recapture of each model, swap-out and fault-in ms and GB/s, peak device
memory and the burst's tokens/s and TTFT p50, elastic against frozen;
"""
from __future__ import annotations

import gc
import time

from chip_smoke_phases.common import (BURST_MODEL, SERVE_K, SERVE_MAX_NEW, log,
                                      read_launches, reset_launches, sync)
from chip_smoke_phases.p04_small import (block_is_sync_free,
                                         replay_matches_eager)
from chip_smoke_phases.p05_serve import (check_coloc, graph_report,
                                         replays_and_captures)


#: phase 9: the elastic engine's knobs, its starting page budget (16 KiB
#: pages) and context
ELASTIC = dict(interval_steps=1, cooldown_steps=1, hysteresis=0.05,
               window_s=60.0, min_page_budget=256)
ELASTIC_PAGES, ELASTIC_CTX = 1024, 4096


def timed_resizes(torch, engine, moves: list) -> dict:
    """Wrap the engine's pool and arena ``resize`` (what the rebalancer
    calls) to log (pool, grow or shrink, old, new, ms, result) of each,
    the device synchronised around it; wrap the rebalancer's ``step`` to
    count the steps after which the pool or the arena had moved, in the
    returned dict's ``moved_steps``."""
    def wrap(owner, attr, pool_name):
        fn = getattr(owner, pool_name)

        def call(new_budget, **kw):
            old = getattr(owner, attr)
            sync(torch, engine.device)
            t0 = time.perf_counter()
            out = fn(new_budget, **kw)
            sync(torch, engine.device)
            moves.append(dict(pool=attr, kind="grow" if new_budget > old
                              else "shrink", old=old, new=int(new_budget),
                              ms=(time.perf_counter() - t0) * 1e3,
                              result=out))
            return out
        setattr(owner, pool_name, call)

    wrap(engine.virt, "page_budget", "resize")
    wrap(engine.arena, "slot_budget", "resize")
    step = engine.rebalancer.step

    state = dict(moved_steps=0)

    def counted(*args, **kw):
        before = (engine.virt.pool.data_ptr(), engine.arena.arena.data_ptr())
        out = step(*args, **kw)
        if (engine.virt.pool.data_ptr(),
                engine.arena.arena.data_ptr()) != before:
            state["moved_steps"] += 1
        return out
    engine.rebalancer.step = counted
    return state


def elastic_requests(np, models):
    """The burst (8 minicpm3 requests, prompts of 1500-3000 tokens) and
    the tail (2 qwen3-moe, 2 moonshot, 130-200 tokens), 32 new tokens
    each, every prompt's ids given (an engine draws synthetic ids in the
    order it plans prefills, which differs between the two engines).
    The tail fits the frozen engine's 1024 pages at once (a moonshot
    page holds 2 tokens of a layer: ~370 pages a request) and one prompt
    bucket, so on both engines each MoE model prefills and decodes its
    two requests together: an MoE model's tokens depend on what else is
    in its batch (expert capacity)."""
    from repro_torch.runtime.request import Request
    rng = np.random.default_rng(9)
    others = [n for n in models if n != BURST_MODEL]

    def req(i, name, lo, hi):
        n = int(rng.integers(lo, hi + 1))
        return Request(i, name, n, SERVE_MAX_NEW, 0.0, prompt_ids=rng.integers(
            0, models[name].vocab_size, n).astype(np.int32))
    burst = [req(i, BURST_MODEL, 1500, 3000) for i in range(8)]
    tail = [req(100 + i, others[i // 2], 130, 200) for i in range(4)]
    return burst, tail


def gauges_match_direct(engine) -> dict:
    """Wrap the elastic engine's telemetry, which folds its observer's
    gauges, so that each ``observe`` also feeds a ``DemandTelemetry``
    without gauges the same pools; after each, the two EWMAs and last
    samples must be equal, bit for bit.  The returned dict counts the
    steps compared under ``"steps"``."""
    from repro_torch.runtime.telemetry import DemandTelemetry
    fed = engine.telemetry
    if fed.gauges is None or fed.gauges is not engine.observer:
        raise AssertionError("elastic: telemetry is not fed by the engine's "
                             "observer")
    direct = DemandTelemetry(fed.models, fed.cfg)
    observe, state = fed.observe, dict(steps=0)

    def signals(t):
        return (t.kv_occupancy_ewma, t.slab_occupancy_ewma,
                t.queue_depth_ewma, t.last)

    def both(now, virt, arena, admission):
        observe(now, virt, arena, admission)
        direct.observe(now, virt, arena, admission)
        if signals(fed) != signals(direct):
            raise AssertionError(f"elastic: at step {state['steps']} the "
                                 f"gauge-fed telemetry reads {signals(fed)}"
                                 f", direct sampling {signals(direct)}")
        state["steps"] += 1
    fed.observe = both
    return state


def serve_elastic(torch, np, kops, models, elastic, device, n_burst=8):
    """One engine (``elastic`` or frozen) serves the burst (its first
    ``n_burst`` requests), then the tail; returns its figures, the
    requests and the engine.  The elastic engine carries an
    ``EngineObserver``, whose gauges feed its telemetry
    (``gauges_match_direct``)."""
    from repro_torch.configs.base import ElasticConfig, EngineConfig
    from repro_torch.runtime.engine import CrossPoolEngine, EngineMode
    from repro_torch.runtime.observe import EngineObserver, percentile
    label = "elastic" if elastic else "frozen"
    engine = CrossPoolEngine(
        models, page_budget=ELASTIC_PAGES, max_batch=4, max_ctx=ELASTIC_CTX,
        seed=0, device=device, observer=EngineObserver() if elastic else None,
        config=EngineConfig(
            mode=EngineMode(decode_steps_per_dispatch=SERVE_K),
            elastic=ElasticConfig(**ELASTIC) if elastic else None))
    moves: list = []
    state = timed_resizes(torch, engine, moves) if elastic else None
    gauged = gauges_match_direct(engine) if elastic else None
    burst, tail = elastic_requests(np, models)
    burst = burst[:n_burst]
    captures = {n: replays_and_captures(r)[1]
                for n, r in engine.runners.items()}
    sync(torch, device)
    reset_launches(kops)
    t0 = time.perf_counter()
    for r in burst:
        engine.submit(r)
    stats = engine.drain()
    sync(torch, device)
    wall = time.perf_counter() - t0
    ttft = percentile(stats.ttft, 50) * 1e3
    burst_tokens = stats.tokens_out
    for r in tail:
        engine.submit(r)
    stats = engine.drain()
    sync(torch, device)
    launches = read_launches(kops)
    for r in burst + tail:
        if r.generated != r.max_new_tokens or \
                len(r.output_ids) != r.max_new_tokens:
            raise AssertionError(f"{label}: request {r.request_id} "
                                 f"({r.model}) emitted {len(r.output_ids)} "
                                 f"of {r.max_new_tokens} tokens")
    if engine.virt.mapped_pages or engine.virt.swapped_now:
        raise AssertionError(f"{label}: {engine.virt.mapped_pages} pages "
                             f"still mapped, {engine.virt.swapped_now} "
                             f"swapped")
    bad = sum(int(r.nonfinite_logits) for r in engine.runners.values())
    if bad:
        raise AssertionError(f"{label}: {bad} non-finite logits")
    figures = dict(burst_tokens=burst_tokens, burst_wall_s=wall,
                   burst_tokens_per_s=burst_tokens / wall,
                   burst_ttft_p50_ms=ttft, page_budget=engine.virt.page_budget,
                   slot_budget=engine.arena.slot_budget)
    if engine.device.type == "cuda":
        graph_report(engine, stats, f"elastic {label}")
        check_coloc(launches, stats, engine, captures)
        figures["launches"] = launches
    log(f"elastic {label}: burst of {len(burst)} {BURST_MODEL} requests "
        f"(prompts {[r.prompt_tokens for r in burst]}): {burst_tokens} "
        f"tokens in {wall:.2f} s = {burst_tokens / wall:.1f} tokens/s, "
        f"TTFT p50 {ttft:.1f} ms; then {len(tail)} requests of "
        f"{', '.join(sorted({r.model for r in tail}))}; pages "
        f"{ELASTIC_PAGES} -> {engine.virt.page_budget}")
    if elastic:
        if not gauged["steps"]:
            raise AssertionError("elastic: telemetry observed no step")
        figures["gauge_fed_steps"] = gauged["steps"]
        log(f"elastic: the observer's gauges fed telemetry over "
            f"{gauged['steps']} steps, its EWMAs equal to direct sampling "
            f"bit for bit at each")
        figures.update(elastic_moves(engine, stats, moves, captures,
                                     state["moved_steps"]))
        # what a capture pays before it starts: one full collection
        # (``DecodeGraph``) on the heap the serving process has here
        t1 = time.perf_counter()
        gc.collect()
        figures["gc_collect_ms"] = (time.perf_counter() - t1) * 1e3
        log(f"elastic: one gc.collect() here takes "
            f"{figures['gc_collect_ms']:.1f} ms")
    return figures, burst + tail, engine


def elastic_moves(engine, stats, moves, captures, moved_steps) -> dict:
    """The elastic engine's gates: a KV grow, bytes conserved on every
    move, one new capture of every split model's graph per step that
    moved the pool or the arena (``captures``: before the run)."""
    events = stats.rebalance_events
    if not any(e.kv_delta_bytes > 0 for e in events):
        raise AssertionError("elastic: the burst never grew the KV pool")
    total = engine.rebalancer.total_bytes
    for e in events:
        got = (e.page_budget[1] * engine.virt.page_bytes
               + e.slot_budget[1] * engine.arena.slab_bytes)
        if got > total:
            raise AssertionError(f"elastic: move at step {e.step} holds "
                                 f"{got} B of a {total} B budget")
    recaptures = {}
    for name, runner in engine.runners.items():
        if runner.fused is None:
            continue
        new = runner.fused.captures - captures[name]
        if engine.device.type == "cuda" and new != moved_steps:
            raise AssertionError(f"elastic: {name} captured {new} times for "
                                 f"{moved_steps} moves")
        recaptures[name] = [t * 1e3 for t in runner.fused.capture_s[-new:]] \
            if new else []
    out = dict(moves=len(events), moved_steps=moved_steps,
               aborted=engine.rebalancer.aborted,
               events=[dict(step=e.step, page_budget=e.page_budget,
                            slot_budget=e.slot_budget,
                            swapped_out=e.swapped_out,
                            evicted_models=e.evicted_models, reason=e.reason)
                       for e in events],
               resizes=[{k: v for k, v in m.items() if k != "result"}
                        for m in moves], recapture_ms=recaptures)
    for pool, kind in (("page_budget", "grow"), ("page_budget", "shrink"),
                       ("slot_budget", "shrink"), ("slot_budget", "grow")):
        ms = [m["ms"] for m in moves if m["pool"] == pool
              and m["kind"] == kind]
        what = ("pool " if pool == "page_budget" else "arena ") + kind
        out[what.replace(" ", "_") + "_ms"] = ms
        if ms:
            log(f"elastic: {len(ms)} {what}s, ms each "
                f"{[round(t, 3) for t in ms]}")
    log(f"elastic: {len(events)} moves applied ({moved_steps} steps "
        f"moved a buffer, {engine.rebalancer.aborted} aborted); "
        f"{[(e.page_budget, e.slot_budget, e.reason) for e in events]}")
    for name, ms in recaptures.items():
        log(f"elastic: {name} decode graph captured again {len(ms)} times, "
            f"ms each {[round(t, 1) for t in ms]}")
    return out


def after_moves_check(torch, np, engine) -> None:
    """On the elastic engine, after its moves: two more minicpm3 requests
    take a step, a block dispatch makes no host read, and a replay
    equals the eager body."""
    from repro_torch.runtime.request import Request
    rng = np.random.default_rng(4)
    vocab = engine.models[BURST_MODEL].vocab_size
    for i in range(2):
        engine.submit(Request(200 + i, BURST_MODEL, 300 + 50 * i,
                              SERVE_MAX_NEW, 0.0, prompt_ids=rng.integers(
                                  0, vocab, 300 + 50 * i).astype(np.int32)))
    engine.step()
    block_is_sync_free(torch, engine)
    replay_matches_eager(torch, engine)
    log("elastic: after the moves a block dispatch makes no host read and a "
        "replay equals the eager body")


def forced_cycle(torch, np, cfg, lowering: bool, device,
                 sanitize: bool = False) -> dict:
    """minicpm3 alone: 4 requests of 2000 tokens prefilled, 6 greedy decode
    steps of ``PagedFusedStep`` (lowering on: one replay each on a card)
    or ``HostDrivenStep`` (off: FFN stages on a second stream).  The
    perturbed run, before step 2: a shrink to half the mapped pages
    (swapping the longest-idle requests' coldest pages, compacting the
    rest), a swap-out of everything left, a grow back and the fault-in.
    Every step's logits must equal the unperturbed run's bit for bit, and
    with lowering on a replay over the moved pool must raise until the
    graph is released.  With ``sanitize`` a ``PoolSanitizer`` rides the
    virtualizer's hooks and audits after every step and every move.
    Returns the cycle's times."""
    from repro_torch.core.control import (HostDrivenStep, PagedFusedStep,
                                          StreamingPrefill)
    from repro_torch.core.pools import build_pools
    from repro_torch.core.virtualizer import KVVirtualizer
    from repro_torch.models.transformer import init_params
    name, B, S, steps, cycle_at, budget = cfg.name, 4, 2000, 6, 2, 4096
    on_card = torch.device(device).type == "cuda"
    gen = torch.Generator(device=device).manual_seed(7)
    _, _, pooled = build_pools({name: cfg}, {name: init_params(gen, cfg)},
                               device=device, page_budget=8,
                               pool_dtype=torch.bfloat16)
    w_stream = torch.cuda.Stream() if on_card and not lowering else None
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                            device=device, dtype=torch.int32)
    times: dict = {}
    audited: dict = {}

    def timed(what, fn, nbytes=None):
        sync(torch, device)
        t0 = time.perf_counter()
        out = fn()
        sync(torch, device)
        ms = (time.perf_counter() - t0) * 1e3
        times[what] = dict(ms=ms)
        if nbytes is not None:
            times[what].update(bytes=nbytes, gb_per_s=nbytes / ms / 1e6)
        return out

    def run(perturb):
        virt = KVVirtualizer({name: cfg}, page_budget=budget, device=device)
        audit = None
        if sanitize:
            from repro_torch.analysis.sanitizer import PoolSanitizer
            virt.hooks = PoolSanitizer(virt)
            audit = virt.hooks.audit
        view = virt.views[name]
        max_pages = -(-(S + steps) // view.tokens_per_page)
        for b in range(B):
            virt.register_request(b, name, S)

        def writer(layer, layer_kv, pool):
            for b in range(B):
                pool = virt.write_prompt_layer(pool, name, b, layer,
                                               layer_kv, S, batch_index=b)
            return pool
        logits, virt.pool = StreamingPrefill(pooled[name], w_stream)(
            prompts, S, virt.pool, writer)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        step = (PagedFusedStep(pooled[name]) if lowering
                else HostDrivenStep(pooled[name], w_stream))
        out = []
        for t in range(steps):
            if perturb and t == cycle_at:
                page = virt.page_bytes
                # the captured pool stays allocated through the cycle:
                # freed, the caching allocator may hand its address back
                # to the regrown pool, of the captured size, and a replay
                # there is valid, not stale (``moved_graph_check`` holds
                # both cases at one address)
                captured = virt.pool
                r = timed("pool shrink with compaction", lambda: virt.resize(
                    virt.mapped_pages // 2))
                times["pool shrink with compaction"].update(
                    moved_pages=r["moved"], swapped_pages=r["swapped_out"])
                n = sum(1 for b in range(B)
                        for _ in virt.requests[b].device_entries())
                timed("swap-out", lambda: [virt.swap_out(b)
                                           for b in range(B)], n * page)
                timed("pool grow", lambda: virt.resize(budget))
                n = virt.swapped_now
                if audit is not None:
                    audit()
                timed("fault-in", lambda: [virt.ensure_resident(b)
                                           for b in range(B)], n * page)
                if lowering and on_card:
                    try:
                        step(tok, virt.pool, virt.batch_tables(
                            name, list(range(B)), max_pages),
                            torch.full((B,), S, dtype=torch.int32))
                    except RuntimeError as e:
                        if "moved or changed shape" not in str(e):
                            raise
                    else:
                        raise AssertionError("a replay over the moved pool "
                                             "did not raise")
                    step.release()
                del captured
            for b in range(B):
                virt.ensure_resident(b)
                virt.extend_request(b, 1)
            tables = virt.batch_tables(name, list(range(B)), max_pages)
            lengths = torch.full((B,), S + t, dtype=torch.int32,
                                 device=device)
            got, virt.pool = step(tok, virt.pool, tables, lengths)
            if audit is not None:
                audit()
            out.append(got.clone())
            tok = torch.argmax(got, dim=-1).to(torch.int32)
        if lowering and on_card:
            times["recapture"] = dict(ms=step.capture_s[-1] * 1e3,
                                      captures=step.captures)
        if audit is not None:
            audited.update(audits=virt.hooks.audits,
                           events=virt.hooks.events)
        return out

    want = run(False)
    got = run(True)
    for t, (a, b) in enumerate(zip(want, got)):
        if not torch.equal(a, b):
            raise AssertionError(f"forced cycle lowering={lowering}: step "
                                 f"{t} differs from the unperturbed run")
    log(f"elastic forced cycle {name} lowering={lowering}: {steps} steps "
        f"equal the unperturbed run bit for bit; "
        + "; ".join(f"{k} {v['ms']:.3f} ms"
                    + (f" ({v['bytes'] / 2**20:.1f} MiB, "
                       f"{v['gb_per_s']:.2f} GB/s)" if "bytes" in v else "")
                    for k, v in times.items()))
    if audited:
        log(f"elastic forced cycle {name} lowering={lowering}: sanitizer "
            f"clean over {audited['audits']} audits and "
            f"{audited['events']} hook events")
        times["sanitizer"] = audited
    return times


def elastic_phase(torch, np, kops, models, device="cuda",
                  card: str = "") -> dict:
    """Phase 9: the elastic engine against the frozen one, the checks
    after the moves, and the forced cycle in both lowering modes; the
    summary lines carry ``card`` (nvidia-smi's name and power limit)."""
    t0 = time.perf_counter()
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    out = {}
    streams = {}
    for elastic in (True, False):
        label = "elastic" if elastic else "frozen"
        figures, reqs, engine = serve_elastic(torch, np, kops, models,
                                              elastic, device)
        streams[label] = [r.output_ids for r in reqs]
        if elastic and engine.device.type == "cuda":
            after_moves_check(torch, np, engine)
        out[label] = figures
        del engine, reqs
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    if streams["elastic"] != streams["frozen"]:
        bad = [i for i, (a, b) in enumerate(zip(streams["elastic"],
                                                streams["frozen"])) if a != b]
        raise AssertionError(f"elastic: requests {bad} emit other tokens "
                             f"than on the frozen engine")
    log("elastic: every request's greedy stream equals the frozen engine's")
    out["cycle"] = {f"lowering={lo}": forced_cycle(
        torch, np, models[BURST_MODEL], lo, device) for lo in (True, False)}
    tag = f"elastic [{card}]"
    if torch.device(device).type == "cuda":
        out["max_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
        log(f"{tag}: max memory allocated {out['max_memory_gib']:.2f} GiB")
    e, f = out["elastic"], out["frozen"]
    log(f"{tag}: {e['moves']} moves applied; pool grow ms "
        f"{e['pool_grow_ms']}; pool shrink ms {e['pool_shrink_ms']}; arena "
        f"shrink ms {e['arena_shrink_ms']}; arena grow ms "
        f"{e['arena_grow_ms']}")
    for name, ms in e["recapture_ms"].items():
        log(f"{tag}: recapture {name} ms {ms}")
    for mode, times in out["cycle"].items():
        log(f"{tag}: forced cycle {mode}: {times}")
    log(f"{tag}: burst {e['burst_tokens_per_s']:.1f} tokens/s, TTFT p50 "
        f"{e['burst_ttft_p50_ms']:.1f} ms; frozen "
        f"{f['burst_tokens_per_s']:.1f} tokens/s, TTFT p50 "
        f"{f['burst_ttft_p50_ms']:.1f} ms")
    out["card"] = card
    out["wall_s"] = time.perf_counter() - t0
    log(f"{tag}: phase wall {out['wall_s']:.1f} s")
    return out


def run(ctx) -> None:
    """The elastic boundary: burst, moves, recaptures, forced cycle."""
    from repro_torch.launch.serve import coloc_models
    log(f"elastic: published widths, depths cut to FULL_WIDTH_DEPTHS, "
        f"max_ctx {ELASTIC_CTX}, K={SERVE_K}, {ELASTIC_PAGES} pages to start")
    elastic = elastic_phase(ctx.torch, ctx.np, ctx.kops,
                            coloc_models(full_width=True), card=ctx.card)
    ctx.out[9] = dict(elastic=elastic,
                      e_launches=elastic["elastic"]["launches"])
