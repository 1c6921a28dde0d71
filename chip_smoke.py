#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --phases 3,15    # phases 1-2, then only these

Drives the port (``src/repro_torch``) on the card and fails (exit code
other than 0) if any phase fails.  Each phase is a module of
``chip_smoke_phases/``, whose docstring says what it runs and what it
gates:

1. card (``p01_card``) — the card's name and power limit; TF32 off;
2. build (``p02_build``) — every kernel source with nvcc, all at once;
3. kernels — each kernel against its plain PyTorch version, timed beside
   its bound and a library call;
4. small — float32 smoke models on the card against the CPU, bf16 smoke
   serving and the decode graphs;
5. serve — the colocated split path at published widths (lowering on,
   then off); 5a the graph audit and the decode step's roofline;
6. serve fallback — zamba2-1.2b and mamba2-130m at their full configs;
7. train — moonshot at published widths through the grouped MoE path;
   7b-7c mamba2-130m and zamba2-1.2b through the SSD kernels;
8. moe gemm — the grouped GEMM at phase 7's shapes and router load;
9. elastic — the elastic KV <-> weights boundary;
10. cache — the radix-tree prefix cache;
11. observe — observability and forensics on phase 5's trace;
12. families — gemma3-12b and whisper-small through the Model path;
13. examples — one 32768-token request through the pool, the examples;
14. sharding — the sharded step at one rank, a request's KV over four;
15. sharded train — the train cell at one rank and over (2, 2);
16. sharded serve — the serve cell with every leaf placed, four ranks;
17. sharded families — the ssm, hybrid and audio archs, four ranks.

Phases 14-17 run in one one-rank NCCL group; their four-rank runs are
processes sharing the card over gloo (one-card rehearsals).  Every
phase's seconds are printed (``phase N ...: s``) and kept under
``"phase_seconds"`` in ``build/chip_smoke.json``.  ``--phases`` runs
phases 1 and 2 and then the named ones (numbers, or labels with ``_``
for spaces) and the phases whose results they read (8 reads 7's router
load), says which on a line of its own and prints no ``kernels`` line.

Phases 3 and 13 hold the paged GQA and MLA kernels in bf16 to the same
row limit as rows 3-4: each output row's relative RMS error within 1e-2
(``BF16_ROW_RMS``) on top of the elementwise 2e-2.  Launch counts are
set to 0 just before each serve, train or cache run and read just after
it; the engine captures its decode graphs when it is built, before
that, and each replay adds the kernel launches its capture recorded.
A run of every phase prints a JSON line with every kernel's numbers,
then, as its last line, ``{"ok": true, "device": {...}}``.  The full
kernel table, the serve and train figures and the profiles go to
``build/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
for _path in (ROOT / "src", ROOT):
    if str(_path) not in sys.path:
        sys.path.insert(0, str(_path))

import chip_smoke_phases as phases  # noqa: E402
from chip_smoke_phases.common import Run, close_group, log  # noqa: E402

#: build/chip_smoke.json's keys: (phase, key of its results)
REPORT_KEYS = {
    "serve": (5, "serve"), "serve_host": (5, "host"),
    "serve_fallback": (6, "f_serve"), "train": (7, "train"),
    "train_ssm": (7, "ssm_train"), "ssm_cell": (17, "ssm_cell"),
    "elastic": (9, "elastic"), "cache": (10, "cache"),
    "observe": (11, "observe"), "families": (12, "families"),
    "examples": (13, "examples"), "sharding": (14, "sharding"),
    "sharded_train": (15, "sharded_train"),
    "sharded_serve": (16, "sharded_serve"),
    "sharded_families": (17, "sharded_families")}
#: the rows of every timed kernel call: (phase, key)
TIME_KEYS = ((3, "rows"), (3, "f_rows"), (3, "b_rows"), (8, "m_rows"),
             (3, "w_rows"), (3, "lse_rows"))


def parse_args(argv=None) -> list:
    """The phase numbers this run takes (``phases.select``); an unknown
    phase is a usage error."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=None,
                    help="comma list of phases to run after 1-2 (numbers "
                         "or labels, e.g. 3,sharded_train); default: all")
    args = ap.parse_args(argv)
    try:
        return phases.select(args.phases)
    except ValueError as err:
        ap.error(str(err))


def main(argv=None) -> int:
    chosen = parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref

    t_start = time.perf_counter()
    card = phases.module(1).run(torch)
    run = Run(torch, np, kops, ref, card)
    seconds, last = run.seconds, [t_start]

    def mark(phase: str) -> None:
        """Print and keep the seconds since the previous mark."""
        now = time.perf_counter()
        seconds[phase] = now - last[0]
        last[0] = now
        log(f"phase {phase}: {seconds[phase]:.1f} s ({card})")
    phases.module(2).run(run)
    mark("1-2 card and build")
    try:
        for n in chosen[2:]:
            phases.module(n).run(run)
            gc.collect()
            torch.cuda.empty_cache()
            mark(phases.label(n))
    finally:
        close_group(run)
    mark("close")

    whole = chosen == phases.select()
    kernels = None
    if whole:
        from chip_smoke_phases.report import kernels as kernel_entries
        kernels = kernel_entries(run.out)
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        dict({"card": card, "phases": chosen,
              "kernel_times": [r for n, key in TIME_KEYS if n in run.out
                               for r in run.out[n][key]],
              "phase_seconds": seconds, "kernels": kernels},
             **{key: run.out[n][part] for key, (n, part)
                in REPORT_KEYS.items() if n in run.out}),
        indent=1, default=str))
    mark("json")
    log("phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                      for k, v in seconds.items()))
    wall = time.perf_counter() - t_start
    if whole:
        log(f"chip_smoke: all 17 phases in {wall:.1f} s ({card})")
        print(json.dumps({"kernels": kernels}))
    else:
        log(f"chip_smoke: phases run: {', '.join(map(str, chosen))} of 17, "
            f"in {wall:.1f} s ({card}); a subset prints no kernels line")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
