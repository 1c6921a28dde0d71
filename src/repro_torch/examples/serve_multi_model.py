"""End-to-end CrossPool serving example (the paper's scenario).

Pipeline: workload traces -> KV-cache planner (Eq. 1-2 Monte Carlo
sizing) -> shared pool + virtualizer -> admission control -> the CrossPool
engine colocating three cold MoE/MLA models -> decode with batched
requests -> TBT / throughput / pool-utilization report.

  python -m repro_torch.examples.serve_multi_model --rps 1.0 --horizon 8
  python -m repro_torch.examples.serve_multi_model --device cpu

Port of ``examples/serve_multi_model.py``, with the same flags and
checks, plus ``--device`` (the card unless ``cpu`` is given; without a
card it raises).  ``--online`` drives the session API instead of the
offline ``run()`` wrapper: requests are submitted one by one as their
Poisson arrival time comes due, tokens stream through per-request
callbacks, and same-model arrivals coalesce into [B, S] prefill passes
between decode steps.  A record written by ``--slo-demo`` replays with
``python -m repro_torch.launch.replay RECORD_PATH`` on the device it was
made on.
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np

from repro_torch.configs import (ElasticConfig, EngineConfig,
                                 FlightRecorderConfig, PAPER_COLOC_SET,
                                 SLObjective, SLOConfig, get_smoke_config)
from repro_torch.core.planner import (WorkloadSpec, plan_pool,
                                      split_device_budget, worst_case_pages,
                                      worst_case_weight_bytes)
from repro_torch.core.weight_pool import slabs_for_config
from repro_torch.runtime import observe as trace_mod
from repro_torch.runtime.engine import (CrossPoolEngine, EngineMode,
                                        resolve_device)
from repro_torch.runtime.observe import EngineObserver, percentile


def serve_online(engine, reqs):
    """Drive the session API from the trace's arrival clock: submit each
    request when due, step between arrivals, stream tokens via callbacks.
    Returns (handles, finalized stats)."""
    first_events = []
    handles = []
    pending = sorted(reqs, key=lambda r: r.arrival_time)
    steps = 0
    while pending or engine.busy:
        if steps >= 10_000:
            break
        steps += 1
        # idle with future arrivals: advance the clock to the next one,
        # BEFORE submitting, so admission stamps the arrival time
        if not engine.busy and pending:
            engine.advance(pending[0].arrival_time)
        now = engine.now
        due = [r for r in pending if r.arrival_time <= now]
        pending = [r for r in pending if r.arrival_time > now]
        for r in due:
            handles.append(engine.submit(
                r, on_token=lambda e: first_events.append(e)
                if e.first else None))
        events = engine.step()
        if not events and not pending and not engine.busy:
            break          # only unserviceable queued requests remain
    for e in first_events[:3]:
        print(f"  stream: request {e.request_id} ({e.model}) first token "
              f"{e.token} at t={e.time:.3f}s")
    return handles, engine.finalize()


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rps", type=float, default=1.0)
    ap.add_argument("--horizon", type=float, default=8.0)
    ap.add_argument("--quantile", type=float, default=0.99)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--online", action="store_true",
                    help="drive the submit/step session API from the "
                         "arrival trace instead of the offline run() wrapper")
    ap.add_argument("--elastic", action="store_true",
                    help="enable the online KV<->weights boundary "
                         "rebalancer (windowed re-plan + host KV swap "
                         "tier; DESIGN.md §8)")
    ap.add_argument("--slo-demo", default=None, metavar="RECORD_PATH",
                    help="postmortem demo (DESIGN.md §13): attach "
                         "deliberately unmeetable latency SLOs so the "
                         "burn-rate monitor breaches mid-run, auto-dumping "
                         "a flight record here; replay it with "
                         "`python -m repro_torch.launch.replay "
                         "RECORD_PATH`")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write Prometheus-text metrics here after the run")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome trace-event JSON here after the "
                         "run (open in Perfetto / chrome://tracing)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch "
                         "versions of the kernels")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    observer = (EngineObserver()
                if args.metrics_out or args.trace_out else None)

    models = {n: get_smoke_config(n) for n in PAPER_COLOC_SET}

    # --- 1. offline: plan the shared KV pool from workload samples --------
    specs = []
    for i, (name, cfg) in enumerate(models.items()):
        r = np.random.default_rng(i)
        specs.append(WorkloadSpec(
            model=cfg, arrival_rate=args.rps,
            prompt_tokens=r.integers(4, 48, 300),
            output_tokens=r.integers(2, args.max_new + 1, 300),
            decode_time=r.uniform(0.05, 1.0, 300)))
    plan = plan_pool(specs, page_bytes=4096, quantile=args.quantile,
                     horizon_s=120.0, n_trials=3)
    worst = worst_case_pages(specs, 4096, horizon_s=120.0)
    print("=== planner ===")
    print(plan.summary())
    print(f"static worst-case would need {worst} pages "
          f"({worst / max(plan.pool_page_budget, 1):.1f}x the pooled budget)")

    # split one device-byte budget between the KV pool and the weights
    # arena from the arrival rates; at these smoke rates every model is
    # expected resident, so the arena sizes to the full colocation set.
    # coresident=2 floors the arena at the two largest models together:
    # with prefill ALSO through the arena, a cold model's prompt phase can
    # then always map alongside the model currently decoding.
    slab_bytes = 1 << 16
    all_resident = sum(slabs_for_config(c, slab_bytes)
                       for c in models.values()) * slab_bytes
    total = int(1.25 * (plan.pool_bytes + all_resident))
    dev_plan = split_device_budget(specs, total, page_bytes=4096,
                                   slab_bytes=slab_bytes, horizon_s=120.0,
                                   n_trials=3, coresident=2)
    print(dev_plan.summary())
    print(f"per-model-static weights baseline: "
          f"{worst_case_weight_bytes(specs) / 2 ** 20:.1f} MiB device FFN")

    # --- 2. online: serve through the planned budgets ---------------------
    page_budget = max(dev_plan.page_budget, 512)   # smoke-scale floor
    print(f"engine budgets: {page_budget} pages, "
          f"{dev_plan.slot_budget} slabs")
    # --slo-demo: objectives no smoke run can meet (sub-microsecond TTFT /
    # TBT) so the multi-rate burn monitor breaches within the first window
    # and the flight recorder auto-dumps a postmortem record
    slo = (SLOConfig(objectives={n: SLObjective(ttft_ms=1e-3, tbt_p99_ms=1e-3)
                                 for n in models},
                     window_s=4.0, short_window_s=0.5)
           if args.slo_demo else None)
    flightrec = (FlightRecorderConfig(dump_path=args.slo_demo,
                                      snapshot_interval_steps=2)
                 if args.slo_demo else None)
    engine = CrossPoolEngine(
        models, page_budget=page_budget,
        page_bytes=4096, slot_budget=dev_plan.slot_budget,
        slab_bytes=slab_bytes, max_batch=4, max_ctx=64,
        config=EngineConfig(
            mode=EngineMode(pipeline=True, lowering=True),
            elastic=ElasticConfig(window_s=max(args.horizon, 4.0))
            if args.elastic else None,
            slo=slo, flightrec=flightrec),
        observer=observer, device=device)
    reqs = trace_mod.make_requests(
        list(models), rps_per_model=args.rps, horizon_s=args.horizon,
        kind="sharegpt", scale_tokens=0.05, max_new_cap=args.max_new)
    for r in reqs:
        r.prompt_tokens = max(min(r.prompt_tokens, 48), 2)
    print(f"\n=== serving {len(reqs)} requests over {len(models)} cold "
          f"models ({'online submit/step' if args.online else 'batch run()'})"
          f" ===")
    if args.online:
        handles, stats = serve_online(engine, reqs)
        by_state = {}
        for h in handles:
            by_state[h.state.value] = by_state.get(h.state.value, 0) + 1
        coalesced = [b for b in stats.prefill_batch_sizes if b > 1]
        print(f"handles: {by_state}; prefill passes "
              f"{len(stats.prefill_batch_sizes)} "
              f"({len(coalesced)} coalesced, max B = "
              f"{max(stats.prefill_batch_sizes, default=0)})")
        if stats.elastic:
            print(f"elastic: kv occupancy EWMA "
                  f"{stats.elastic['kv_occupancy_ewma']:.3f}, slab "
                  f"{stats.elastic['slab_occupancy_ewma']:.3f}, "
                  f"{int(stats.elastic.get('rebalances', 0))} rebalances, "
                  f"swap {engine.virt.swap_out_pages} out / "
                  f"{engine.virt.swap_in_pages} in")
    else:
        stats = engine.run(reqs)

    finished = [r for r in reqs if r.finish_time > 0]
    print(f"finished {len(finished)}/{len(reqs)}  tokens {stats.tokens_out}  "
          f"throughput {stats.throughput:.1f} tok/s")
    print(f"TBT p50/p95/p99 = {percentile(stats.tbt, 50) * 1e3:.1f} / "
          f"{percentile(stats.tbt, 95) * 1e3:.1f} / "
          f"{percentile(stats.tbt, 99) * 1e3:.1f} ms")
    print(f"TTFT p95 = {percentile(stats.ttft, 95) * 1e3:.1f} ms")
    print("=== engine report ===")
    print(engine.report())
    # prefill-phase device FFN bytes come from the ARENA (no full-tree
    # column left): every paged runner serves prompt AND decode through
    # (arena, slot_table), so device FFN bytes are phase-invariant
    w = engine.arena.utilization()
    print(f"device FFN bytes, prefill phase = decode phase = "
          f"{w['device_bytes'] / 2 ** 20:.1f} MiB "
          f"(slot_budget {w['slot_budget']} x {slab_bytes} B slabs)")
    assert all(getattr(r, "params", None) is None
               for r in engine.runners.values() if r.paged), \
        "a paged runner still holds a full param tree"
    assert stats.tokens_out > 0
    if args.slo_demo:
        rec = engine.recorder
        assert engine.slo.breach_count() > 0, \
            "SLO demo thresholds should be unmeetable"
        assert rec.dumps > 0, "breach should have auto-dumped a flight record"
        print(f"SLO breaches: {engine.slo.breach_count()} "
              f"({engine.slo.report_line(engine.now)})")
        print(f"flight record auto-dumped on first breach -> "
              f"{args.slo_demo} ({len(rec.ring)} events, "
              f"{len(rec.snapshots)} snapshots)")
        cpu = "" if device.type == "cuda" else " --device cpu"
        print(f"postmortem: python -m repro_torch.launch.replay "
              f"{args.slo_demo}{cpu}")
    if observer is not None:
        if args.metrics_out:
            observer.metrics.write(args.metrics_out)
            print(f"metrics -> {args.metrics_out}")
        if args.trace_out:
            observer.tracer.write(args.trace_out)
            print(f"trace -> {args.trace_out} "
                  f"({len(observer.tracer.events)} events)")
    print("serve_multi_model OK")


if __name__ == "__main__":
    main()
