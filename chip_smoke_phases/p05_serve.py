"""Phase 5 of ``chip_smoke.py``: ``CrossPoolEngine(device="cuda")`` over
the paper's three colocated models at their published widths, bf16,
depths cut to ``FULL_WIDTH_DEPTHS``: 8 requests, prompts of 200-900
tokens, 32 new tokens each, K=4. Every request must finish with its
token count, every page must return, no logit may be NaN, each model's
decode graph must have replayed exactly once per block, and the paged
GQA and MLA kernels and the pool write must have launched exactly as
often as the path runs them (per layer: K per replay, and one write per
prompt row); (5a) the profiled decode step's roofline
(``launch/roofline.py`` on the H100's peaks: each model's block counted
on ``meta`` by ``op_analysis.analyze_fused_step``, K x the analytic
minimum bytes) printed beside its wall and busy times, the bound at most
the busy time; the graph audit (``analysis/graph_audit.py``) of each
model's fused step clean (no foreign read of 64 KiB or more, the pool
updated in place, no host read under ``set_sync_debug_mode ("error")``,
calls per body and per replay = K x layers), and two planted bodies (a
host read, a pool clone) flagged CPA03 and CPA02; before the audit, one
decode block of the first model through ``ModelRunner.decode_once`` (one
replay, its exact launches, each row's count, the tokens and the pool
bytes equal to the eager body's from the same state); then (5h) the same
requests under ``lowering=False`` with the layer pipeline scheduler and
without it, with the same checks (one token per host-driven step),
printing the scheduler's stage count and ``overlap_fraction``;
"""
from __future__ import annotations

import gc
import time

from chip_smoke_phases.common import (PORT_KERNELS, SERVE_K, SERVE_MAX_NEW,
                                      log, read_launches, reset_launches,
                                      sync)
from chip_smoke_phases.p03_kernels import bound, check


def serve_phase(torch, np, kops, models, *, k, page_budget, label, check,
                lowering=True, pipeline=True, audit=False):
    """``CrossPoolEngine(device="cuda")`` over ``models`` (bf16): 8
    requests at time 0, prompts of 200-900 tokens, 32 new tokens each,
    ``max_batch=4``, ``max_ctx=1024``, ``k`` tokens per dispatch, in the
    given engine mode.  Launch counts are 0 just before the run and read
    just after it; each model's decode graph must have replayed once per
    block; ``check(launches, stats, engine)`` adds the phase's own checks.
    With ``audit`` (5a) the profiled decode step's roofline is held
    against its busy time (``decode_roofline``) and the engine's fused
    steps go through the graph audit (``graph_audit_phase``).  Returns
    (launches, figures)."""
    from repro_torch.configs.base import EngineConfig
    from repro_torch.runtime.engine import CrossPoolEngine, EngineMode
    from repro_torch.runtime.observe import percentile
    from repro_torch.runtime.request import Request

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = CrossPoolEngine(
        models, page_budget=page_budget, max_batch=4, max_ctx=1024, seed=0,
        device="cuda",
        config=EngineConfig(mode=EngineMode(
            lowering=lowering, pipeline=pipeline,
            decode_steps_per_dispatch=k)))
    torch.cuda.synchronize()
    arena = (f"arena {engine.arena.device_bytes() / 2**30:.2f} GiB"
             if engine.arena is not None else "no arena")
    pool_mib = engine.virt.page_budget * engine.virt.page_bytes / 2**20
    pool = (f"pool {pool_mib:.0f} MiB" if engine.virt.pool is not None
            else "no device page pool")
    log(f"{label}: engine built in {time.perf_counter() - t0:.1f} s "
        f"(weights drawn on the card, {arena}, {pool})")
    rng = np.random.default_rng(0)
    names = list(models)
    reqs = [Request(i, names[i % len(names)], int(rng.integers(200, 901)),
                    SERVE_MAX_NEW, 0.0) for i in range(8)]
    # the main path's run: launch counts start at 0 here
    reset_launches(kops)
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    stats = engine.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(kops)
    for r in reqs:
        if r.generated != r.max_new_tokens or \
                len(r.output_ids) != r.max_new_tokens:
            raise AssertionError(f"request {r.request_id} ({r.model}) "
                                 f"emitted {len(r.output_ids)} of "
                                 f"{r.max_new_tokens} tokens")
    if engine.virt.mapped_pages != 0:
        raise AssertionError(f"{engine.virt.mapped_pages} pages still mapped")
    bad = sum(int(r.nonfinite_logits) for r in engine.runners.values())
    if bad:
        raise AssertionError(f"{bad} non-finite logits")
    graphs = graph_report(engine, stats, label)
    check(launches, stats, engine)
    schedule = {}
    if engine.scheduler is not None:
        schedule = dict(stages=len(engine.scheduler.stage_log),
                        overlap_fraction=engine.scheduler.overlap_fraction())
        log(f"{label}: the scheduler issued {schedule['stages']} stages, "
            f"overlap_fraction {schedule['overlap_fraction']:.4f}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"{label}: {len(reqs)} requests, prompts "
        f"{[r.prompt_tokens for r in reqs]}, {stats.tokens_out} tokens in "
        f"{wall:.2f} s wall = {stats.tokens_out / wall:.1f} tokens/s")
    log(f"{label}: TBT p50 {percentile(stats.tbt, 50) * 1e3:.2f} ms, "
        f"p99 {percentile(stats.tbt, 99) * 1e3:.2f} ms; TTFT p50 "
        f"{percentile(stats.ttft, 50) * 1e3:.1f} ms")
    for model, B, bucket, dt in stats.prefill_times:
        log(f"{label}: prefill {model} B={B} bucket {bucket}: "
            f"{dt * 1e3:.1f} ms")
    log(f"{label}: launches {launches}; max memory allocated {peak:.2f} GiB")
    # read before the profiled step, which adds requests to the same stats
    figures = dict(
        tokens=stats.tokens_out, wall_s=wall,
        tokens_per_s=stats.tokens_out / wall,
        tbt_p50_ms=percentile(stats.tbt, 50) * 1e3,
        tbt_p99_ms=percentile(stats.tbt, 99) * 1e3,
        ttft_p50_ms=percentile(stats.ttft, 50) * 1e3,
        prefill=[dict(model=m, B=B, bucket=b, ms=dt * 1e3)
                 for m, B, b, dt in stats.prefill_times],
        max_memory_gib=peak, graphs=graphs, **schedule)
    t0 = time.perf_counter()
    figures["profile"] = profile_decode_step(torch, engine, names,
                                             engine.runners[names[0]]
                                             .decode_steps, roofline=audit)
    if audit:
        figures["decode_once"] = decode_once_block(torch, np, kops, engine,
                                                   names[0])
        t1 = time.perf_counter()
        figures["audit"] = graph_audit_phase(torch, engine)
        figures["audit"]["seconds"] = time.perf_counter() - t1
        figures["phase_5a_s"] = (figures["profile"]["roofline"]["seconds"]
                                 + figures["audit"]["seconds"])
        log(f"{label}: profile, roofline and audit took "
            f"{time.perf_counter() - t0:.1f} s")
    return launches, figures


def decode_once_block(torch, np, kops, engine, name) -> dict:
    """One decode block of ``name`` through ``ModelRunner.decode_once``:
    2 requests (prompts of 300 and 400 tokens) are submitted and one
    engine step prefills them; every active row must count its whole step
    budget, and the tokens and the pool bytes must equal the eager body's
    (``MultiStepFusedStep.body``) run from the state before the block,
    the pool put back; on a card the block must be one graph replay that
    launches the paged attention kernel and the pool write K x layers
    times each.  The two requests are cancelled after it."""
    from repro_torch.runtime.request import Request

    device = engine.device
    runner = engine.runners[name]
    k = runner.decode_steps
    reqs = [Request(300 + i, name, 300 + 100 * i, 2 * k + 1, 0.0)
            for i in range(2)]
    for r in reqs:
        engine.submit(r)
    engine.step()
    sync(torch, device)
    act = runner._active_slots()
    budget = {i: min(k, runner.slots[i].max_new_tokens
                     - runner.slots[i].generated,
                     runner.max_ctx - int(runner.lengths[i])) for i in act}
    tokens, lengths = runner.next_tokens.copy(), runner.lengths.copy()
    eos = runner._eos_ids()
    before = engine.virt.pool.clone()
    replays = runner.fused.replays
    reset_launches(kops)
    toks, counts, slots = runner.decode_once()
    sync(torch, device)
    launches = read_launches(kops)
    kernel = ("paged_mla_decode_attention" if runner.cfg.attention == "mla"
              else "paged_decode_attention")
    want = {kernel: runner.cfg.n_layers * k,
            "paged_kv_write": runner.cfg.n_layers * k}
    if device.type == "cuda" and (
            any(launches[n] != v for n, v in want.items())
            or runner.fused.replays != replays + 1):
        raise AssertionError(f"decode_once {name}: launches "
                             f"{ {n: launches[n] for n in want} }, replays "
                             f"+{runner.fused.replays - replays}; expected "
                             f"{want} and one replay")
    if list(slots) != list(act) or toks.shape != (runner.max_batch, k) or \
            any(int(counts[i]) != budget[i] for i in act):
        raise AssertionError(f"decode_once {name}: slots {slots} of {act}, "
                             f"tokens {toks.shape}, counts {counts.tolist()}"
                             f" for budgets {budget}")
    after = engine.virt.pool.clone()
    steps = np.zeros(runner.max_batch, np.int32)
    for i in act:
        steps[i] = budget[i]
    tables = engine.virt.batch_tables_host(name, runner._rids(),
                                           runner.max_pages)
    engine.virt.pool.copy_(before)
    arena, table = runner.fused.pooled.arena.acquire(name)
    eager = runner.fused.body(
        engine.virt.pool, arena, table,
        *[torch.tensor(a, device=device)
          for a in (tokens, tables, lengths, steps, eos)]).cpu().numpy().T
    if not np.array_equal(toks, eager):
        raise AssertionError(f"decode_once {name}: tokens {toks.tolist()} "
                             f"differ from the eager body's "
                             f"{eager.tolist()}")
    if not torch.equal(engine.virt.pool, after):
        raise AssertionError(f"decode_once {name}: the pool differs from "
                             f"the eager body's")
    del before, after
    for r in reqs:
        engine.cancel(r.request_id)
    if engine.virt.mapped_pages != 0:
        raise AssertionError(f"decode_once {name}: "
                             f"{engine.virt.mapped_pages} pages still mapped")
    log(f"decode_once {name}: launches {want} in one replay, counts "
        f"{[int(counts[i]) for i in act]}: tokens and pool bytes equal the "
        f"eager body's")
    return dict(model=name, launches=want, rows=len(act),
                counts=[int(counts[i]) for i in act])


def replays_and_captures(runner):
    """(replays, captures) of a model's decode graphs, over every capture
    (an elastic move captures a split model's graph again)."""
    if runner.fused is not None:
        return runner.fused.replays, runner.fused.captures
    graph = runner.decode_graph
    return (graph.replays, 1) if graph is not None else (0, 0)


def graph_report(engine, stats, label) -> dict:
    """Per model: graph captures, replays, decode blocks and host
    dispatches per block; a model with a decode graph must have replayed
    it exactly once per block."""
    from repro_torch.core.control import dispatch_count
    out = {}
    for name, runner in engine.runners.items():
        blocks = len(stats.step_times[name])
        graph = runner.graph
        if graph is not None:
            replays, captures = replays_and_captures(runner)
            if replays != blocks:
                raise AssertionError(f"{name}: {replays} graph replays "
                                     f"for {blocks} decode blocks")
            row = dict(captures=captures, replays=replays, blocks=blocks,
                       host_dispatches_per_block=dispatch_count(
                           runner.cfg.n_layers, True),
                       launches_per_replay=graph.launches_per_replay)
        else:
            row = dict(captures=0, replays=0, blocks=blocks,
                       host_dispatches_per_block=dispatch_count(
                           runner.cfg.n_layers, False))
        out[name] = row
        log(f"{label}: {name}: {row['captures']} graph captures, "
            f"{row['replays']} replays for {blocks} decode blocks, "
            f"{row['host_dispatches_per_block']} host dispatches per block"
            + (f", kernel launches per replay {row['launches_per_replay']}"
               if graph is not None else ""))
    return out


def expected_split_launches(stats, engine, captures_before=None) -> dict:
    """What the split path must have launched: per layer of a model, one
    paged attention call (GQA or MLA) and one pool write per decoded token
    (K per replay, or one per host-driven step), and one pool write per
    prompt row of each prefill pass (a prefix-cache suffix pass writes
    its rows with one call too).  ``captures_before`` (model -> captures
    when the counts were set to 0): each capture since ran the body once
    eagerly, K more tokens' launches."""
    want = {"paged_decode_attention": 0, "paged_mla_decode_attention": 0,
            "paged_kv_write": 0}
    for name, runner in engine.runners.items():
        n_layers = runner.cfg.n_layers
        kernel = ("paged_mla_decode_attention" if runner.cfg.attention == "mla"
                  else "paged_decode_attention")
        if runner.graph is not None:
            replays, captures = replays_and_captures(runner)
            warm_ups = captures - (captures_before or {}).get(name, captures)
            tokens = (replays + warm_ups) * runner.decode_steps
        else:
            tokens = len(stats.step_times[name])
        rows = sum(B for m, B, *_ in stats.prefill_times if m == name)
        want[kernel] += n_layers * tokens
        want["paged_kv_write"] += n_layers * (tokens + rows)
    return want


def check_coloc(launches, stats, engine, captures_before=None) -> None:
    """Exact launch counts of the split path (``expected_split_launches``)
    over the three colocated models."""
    want = expected_split_launches(stats, engine, captures_before)
    for name, n in want.items():
        if launches[name] != n or n <= 0:
            raise AssertionError(f"{name} launched {launches[name]} times on "
                                 f"the split path, expected {n}")
    log(f"split path: launches exactly as expected: {want}")


def check_fallback(launches, stats, engine) -> None:
    """Each fallback kernel launched exactly as often as the path runs
    it: per zamba2 prompt one flash prefill per shared-attention group
    and one SSD scan per SSM layer (mamba2: per layer), per zamba2 decode
    step one contiguous decode per group."""
    cfgs = {r.cfg.name: r.cfg for r in engine.runners.values()}
    zamba, mamba = cfgs["zamba2-1.2b"], cfgs["mamba2-130m"]
    rows = {n: sum(B for m, B, *_ in stats.prefill_times if m == n)
            for n in cfgs}
    steps = len(stats.step_times["zamba2-1.2b"])
    want = {
        "flash_attention": zamba.hybrid_groups * rows["zamba2-1.2b"],
        "ssd_scan": (zamba.n_ssm_layers * rows["zamba2-1.2b"]
                     + mamba.n_layers * rows["mamba2-130m"]),
        "decode_attention": zamba.hybrid_groups * steps,
    }
    for name, n in want.items():
        if launches[name] != n or n <= 0:
            raise AssertionError(f"{name} launched {launches[name]} times on "
                                 f"the fallback path, expected {n}")
    log(f"serve fallback: launches as expected for {rows} prompt rows and "
        f"{steps} zamba2 decode steps: {want}")


def device_summary(prof, wall, label):
    """Device busy time, the 10 largest kernels and every kernel of the
    port (``csrc/``) of one profiled window."""
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA" and e.self_device_time_total]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"profile: {label}: wall {wall * 1e3:.1f} ms, device busy "
        f"{busy_ms:.1f} ms ({busy_ms / (wall * 1e3):.1%})")

    def row(e):
        ms = e.self_device_time_total / 1e3
        return dict(kernel=e.key[:90], calls=e.count, ms=ms)
    top = [row(e) for e in sorted(kernels,
                                  key=lambda e: -e.self_device_time_total)]
    port = [r for r in top if any(n in r["kernel"] for n in PORT_KERNELS)]
    for r in top[:10]:
        log(f"profile: {r['ms']:9.3f} ms {r['calls']:5d}x  {r['kernel']}")
    for r in port:
        log(f"profile:   port {r['ms']:9.3f} ms {r['calls']:5d}x  "
            f"{r['kernel']}")
    shares = {}
    for what, tag in (("SSD scan", "ssd_"), ("paged MLA", "mla_")):
        ms = sum(r["ms"] for r in port if tag in r["kernel"])
        shares[what] = ms
        if ms:
            log(f"profile: {label}: {what} kernels {ms:.3f} ms = "
                f"{ms / busy_ms:.1%} of device busy time")
    return dict(wall_ms=wall * 1e3, device_busy_ms=busy_ms, top=top[:10],
                port=port, ssd_ms=shares["SSD scan"],
                mla_ms=shares["paged MLA"])


def profile_decode_step(torch, engine, names, k, roofline=False):
    """Where the device time goes: 4 fresh requests (500 prompt tokens
    each) are submitted, then one engine step that prefills them (and
    decodes a first block) and one engine step that decodes a K-token
    block for every model run under ``torch.profiler``; with
    ``roofline`` the decode step's bound beside its times
    (``decode_roofline``)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime.request import Request

    reqs = [Request(100 + i, names[i % len(names)], 500, 2 * k + 1,
                    0.0) for i in range(4)]
    for r in reqs:
        engine.submit(r)
    torch.cuda.synchronize()
    out = {}
    for label in ("prefill step", "decode step"):
        if roofline:
            # the rows each model decodes in the profiled block, and their
            # context lengths as it starts
            active = {n: r.lengths[r._active_slots()].copy()
                      for n, r in engine.runners.items()}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out[label] = device_summary(
            prof, wall, f"one {label} (K={k}, {len(names)} models)")
    if roofline:
        out["roofline"] = decode_roofline(torch, engine, active, k,
                                          out["decode step"])
    engine.drain()
    if engine.virt.mapped_pages != 0:
        raise AssertionError("pages still mapped after the profiled run")
    return out


def decode_token_bytes(cfg, shape) -> float:
    """The least bytes one decode token of ``shape``'s rows reads and
    writes on one card: ``analytic_bytes_estimate`` (every active weight,
    the KV of the context, the state), less the input embedding table,
    of which a step reads only its rows' own (a tied table is the head
    too, and is read whole)."""
    from repro_torch.launch import roofline as rf

    out = rf.analytic_bytes_estimate(cfg, shape, 1)
    if not cfg.tie_embeddings:
        out += (shape.global_batch - cfg.vocab_size) * cfg.d_model * 2
    return out


def decode_roofline(torch, engine, active, k, summary) -> dict:
    """(5a) The roofline of the profiled decode step on the H100's peaks
    (``launch/roofline.py``, ``launch/mesh.py``).  For each model: its
    block's FLOPs counted on ``meta`` (``op_analysis.analyze_fused_step``
    at the captured graph's shapes: K tokens, every layer, the plain
    paged attention over the whole table) and K times one token's
    minimum bytes (``decode_token_bytes``; the weights, far larger than
    the L2, are read again at every inner step).  The models' blocks
    run one after another on one card, so the step's bound is the larger
    of the summed compute and memory terms.  Gated: the bound is at most
    the step's device busy time (a bound above a measured time means the
    count is wrong)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import roofline as rf
    from repro_torch.launch.op_analysis import analyze_fused_step

    t0 = time.perf_counter()
    rows, t_compute, t_memory = {}, 0.0, 0.0
    for name, lens in active.items():
        if not len(lens):
            continue
        runner = engine.runners[name]
        stats = analyze_fused_step(runner.fused, engine.virt.pool,
                                   batch=runner.max_batch,
                                   max_pages=runner.max_pages)
        shape = ShapeConfig(f"decode block K={k}", int(lens.mean()),
                            len(lens), "decode")
        report = rf.RooflineReport(
            arch=name, shape=shape.name, mesh="one card",
            strategy="split engine", chips=1, flops_per_device=stats.flops,
            bytes_per_device=stats.bytes_accessed,
            bytes_model=k * decode_token_bytes(runner.cfg, shape),
            collective_per_device=0.0, collective_breakdown={},
            model_flops=k * rf.model_flops_estimate(runner.cfg, shape))
        rows[name] = dict(report.to_dict(), rows=len(lens),
                          mean_context=float(lens.mean()),
                          bound_ms=report.bound_time * 1e3,
                          temp_bytes=stats.temp_bytes)
        t_compute += report.t_compute
        t_memory += report.t_memory
        log(f"roofline: {name} block of {k} x {len(lens)} rows at context "
            f"{float(lens.mean()):.1f}: {stats.flops:.4e} FLOPs, "
            f"{report.bytes_model:.4e} B minimum ({stats.bytes_accessed:.4e}"
            f" B accessed unfused): compute {report.t_compute * 1e3:.4f} ms"
            f", memory {report.t_memory * 1e3:.4f} ms (unfused "
            f"{report.t_memory_hlo * 1e3:.4f}) -> {report.dominant}")
    bound = max(t_compute, t_memory) * 1e3
    busy, wall = summary["device_busy_ms"], summary["wall_ms"]
    log(f"roofline: the decode step's bound {bound:.4f} ms (compute "
        f"{t_compute * 1e3:.4f}, memory {t_memory * 1e3:.4f}) against "
        f"device busy {busy:.3f} ms and wall {wall:.3f} ms: "
        f"{bound / busy:.2%} of busy, {bound / wall:.2%} of wall")
    if not 0 < bound <= busy:
        raise AssertionError(f"the decode step's bound {bound:.4f} ms is "
                             f"not within its busy time {busy:.3f} ms: "
                             f"the count is wrong")
    return dict(models=rows, bound_ms=bound,
                t_compute_ms=t_compute * 1e3, t_memory_ms=t_memory * 1e3,
                busy_ms=busy, wall_ms=wall, share_of_busy=bound / busy,
                share_of_wall=bound / wall,
                seconds=time.perf_counter() - t0)


def graph_audit_phase(torch, engine) -> dict:
    """(5a) The graph audit (``analysis/graph_audit.py``) over phase 5's
    engine: each model's fused step, at its captured graph's batch and
    table width on inactive inputs, under
    ``set_sync_debug_mode("error")``, must give no finding; its figures
    are printed.  Then two planted bodies on the first model, one that
    reads a token to the host (CPA03) and one that clones the pool
    (CPA02), must each be flagged on the card."""
    from repro_torch.analysis import graph_audit as ga

    pool, out = engine.virt.pool, {}
    for name, runner in engine.runners.items():
        found, fig = ga.audit_fused_step(
            runner.fused, pool, batch=runner.max_batch,
            max_pages=runner.max_pages, target=name)
        log(f"audit: {name}: largest foreign read {fig['largest_foreign_read']}"
            f" B ({fig['foreign_reads']} foreign storages); the body's "
            f"largest allocation {fig['largest_allocation'] / 2**20:.1f} MiB"
            f", its own peak {fig['own_peak_bytes'] / 2**20:.1f} MiB, beside"
            f" the pool's {fig['pool_bytes'] / 2**20:.1f} MiB and the "
            f"arena's {fig['arena_bytes'] / 2**20:.1f} MiB; host reads "
            f"{fig['host_reads']}; {fig['dispatches_per_block']} dispatch a"
            f" block; calls per body {fig['calls_per_body']}, per replay "
            f"{fig['calls_per_replay']}, claim {fig['claim']}")
        if found:
            raise AssertionError(f"audit: {name}: "
                                 + "; ".join(str(f) for f in found))
        out[name] = fig
    name, runner = next(iter(engine.runners.items()))
    step, batch, max_pages = runner.fused, runner.max_batch, runner.max_pages
    if step.graph is not None:
        _, batch, max_pages = step.graph.static["page_tables"].shape
    planted = {}
    for check in ("CPA03", "CPA02"):
        found, _ = ga.audit_fused_step(
            ga.planted(step, check), pool, batch=batch, max_pages=max_pages,
            target=f"{name} planted {check}")
        got = sorted({f.check for f in found})
        if check not in got:
            raise AssertionError(f"audit: the planted {check} body was not "
                                 f"flagged ({got})")
        planted[check] = [str(f) for f in found]
        log(f"audit: planted {check} flagged: {planted[check]}")
    return dict(models=out, planted=planted)


def run(ctx) -> None:
    """Serve the colocated split path, then the same requests under the
    host-driven lowering, with and without the layer pipeline
    scheduler."""
    from repro_torch.launch.serve import FULL_WIDTH_DEPTHS, coloc_models
    torch, np, kops = ctx.torch, ctx.np, ctx.kops
    log("serve: published widths, depths cut to "
        + ", ".join(f"{n} {d} layers" for n, d in FULL_WIDTH_DEPTHS.items()))
    launches, serve = serve_phase(
        torch, np, kops, coloc_models(full_width=True), k=SERVE_K,
        page_budget=16384, label="serve", check=check_coloc, audit=True)
    ctx.seconds["5a audit and roofline"] = serve["phase_5a_s"]
    log(f"phase 5a audit and roofline: {serve['phase_5a_s']:.1f} s, within "
        f"phase 5 ({ctx.card})")
    gc.collect()                 # request handles point back at the engine
    torch.cuda.empty_cache()
    host = {}
    for pipeline in (True, False):
        label = f"serve host pipeline={pipeline}"
        log(f"{label}: lowering=False, K=1")
        _, host[label] = serve_phase(
            torch, np, kops, coloc_models(full_width=True), k=1,
            page_budget=16384, label=label, check=check_coloc,
            lowering=False, pipeline=pipeline)
        gc.collect()
        torch.cuda.empty_cache()
    ctx.out[5] = dict(launches=launches, serve=serve, host=host)
