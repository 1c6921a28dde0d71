"""Serving launcher: the ported CrossPool engine over the paper's trio.

  python -m repro_torch.launch.serve --device cuda --rps 0.5 --horizon 10
  python -m repro_torch.launch.serve --device cuda --full-width --max-new 32
  python -m repro_torch.launch.serve --device cpu        # small, on the CPU
  python -m repro_torch.launch.serve --device cpu --no-lowering
  python -m repro_torch.launch.serve --device cpu --elastic

Port of the engine path of ``src/repro/launch/serve.py``: colocates
``PAPER_COLOC_SET`` (at smoke scale by default, or with ``--full-width``
at the configs' published widths with the depths of
``FULL_WIDTH_DEPTHS``), serves a synthetic ShareGPT-like trace and
reports decode TBT percentiles and pool statistics.  Runs on the card
unless ``--device cpu`` is given.  ``--no-lowering`` serves through the
host-driven step (per-layer dispatches, K=1) and, with the default
``--pipeline``, the layer pipeline scheduler.  ``--elastic`` turns on
the online KV<->weights rebalancer (``ElasticConfig()``, DESIGN.md §8).
The reference's other flags (dry-run, prefix cache, observability, SLO,
flight recorder) belong to parts not ported yet and raise.
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional

from repro_torch.configs import PAPER_COLOC_SET, get_config, get_smoke_config
from repro_torch.configs.base import ElasticConfig, EngineConfig, ModelConfig

#: Depth each coloc model is cut to at published width: weights of about
#: 12.5, 5.9 and 1.2 GB in bf16 (embeddings included), ~20 GB together.
FULL_WIDTH_DEPTHS: Dict[str, int] = {
    "qwen3-moe-235b-a22b": 2,
    "moonshot-v1-16b-a3b": 4,
    "minicpm3-4b": 4,
}

_NOT_PORTED = ("arch", "shape", "strategy", "dry_run", "multi_pod", "cache",
               "metrics_out", "trace_out", "slo", "flight_record_out")


def coloc_models(full_width: bool) -> Dict[str, ModelConfig]:
    """The paper's colocation set (bf16): smoke configs, or published
    widths at the reduced depths of ``FULL_WIDTH_DEPTHS``."""
    return {n: (get_config(n).replace(n_layers=FULL_WIDTH_DEPTHS[n])
                if full_width else get_smoke_config(n))
            for n in PAPER_COLOC_SET}


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch "
                         "versions of the kernels")
    ap.add_argument("--full-width", action="store_true",
                    help="published widths, depths cut to "
                         "FULL_WIDTH_DEPTHS, max_ctx 1024")
    ap.add_argument("--rps", type=float, default=0.5)
    ap.add_argument("--horizon", type=float, default=10.0)
    ap.add_argument("--pipeline", action="store_true", default=True)
    ap.add_argument("--no-pipeline", dest="pipeline", action="store_false")
    ap.add_argument("--lowering", action="store_true", default=True)
    ap.add_argument("--no-lowering", dest="lowering", action="store_false")
    ap.add_argument("--page-budget", type=int, default=8192)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--decode-steps", type=int, default=1,
                    help="K tokens committed per fused decode dispatch")
    # the reference's other surfaces: accepted so they fail loudly
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--strategy", default=None)
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--elastic", action="store_true",
                    help="enable the online KV<->weights rebalancer")
    ap.add_argument("--cache", action="store_true")
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--trace-out", default=None)
    ap.add_argument("--slo", action="append", default=None)
    ap.add_argument("--flight-record-out", default=None)
    args = ap.parse_args(argv)

    given = [f"--{k.replace('_', '-')}" for k in _NOT_PORTED
             if getattr(args, k)]
    if given:
        raise NotImplementedError(f"{', '.join(given)}: not ported yet")

    from repro_torch.runtime import observe as trace_mod
    from repro_torch.runtime.engine import CrossPoolEngine, EngineMode
    from repro_torch.runtime.observe import percentile

    models = coloc_models(args.full_width)
    max_ctx = 1024 if args.full_width else 128
    engine = CrossPoolEngine(
        models, page_budget=args.page_budget, max_batch=4, max_ctx=max_ctx,
        device=args.device,
        config=EngineConfig(
            mode=EngineMode(pipeline=args.pipeline, lowering=args.lowering,
                            decode_steps_per_dispatch=args.decode_steps),
            elastic=ElasticConfig() if args.elastic else None))
    reqs = trace_mod.make_requests(
        list(models), rps_per_model=args.rps, horizon_s=args.horizon,
        kind="sharegpt", scale_tokens=1.0 if args.full_width else 0.1,
        max_new_cap=args.max_new)
    if args.full_width:
        # published-width prompts fit the context with their outputs
        for r in reqs:
            r.prompt_tokens = min(r.prompt_tokens, max_ctx - r.max_new_tokens)
    print(f"serving {len(reqs)} requests across {len(models)} cold models "
          f"on {engine.device} (pipeline={args.pipeline}, "
          f"lowering={args.lowering}, "
          f"decode_steps={args.decode_steps}, "
          f"full_width={args.full_width}, elastic={args.elastic})")
    stats = engine.run(reqs)
    print(f"tokens out: {stats.tokens_out}  virtual wall: {stats.wall_s:.2f}s "
          f"throughput: {stats.throughput:.1f} tok/s")
    print(f"TBT p50/p95/p99: {percentile(stats.tbt, 50) * 1e3:.1f} / "
          f"{percentile(stats.tbt, 95) * 1e3:.1f} / "
          f"{percentile(stats.tbt, 99) * 1e3:.1f} ms")
    print(f"admission: {engine.admission.stats}")
    print(f"pool: {engine.virt.utilization()}")
    if engine.rebalancer is not None:
        print(f"elastic: {len(stats.rebalance_events)} moves applied; "
              f"{engine.rebalancer.snapshot()}")
    print(f"straggler steps flagged: {stats.slow_steps}")


if __name__ == "__main__":
    main()
