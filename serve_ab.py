#!/usr/bin/env python3
"""Serve throughput of trees of this repo, or of engine modes, on one
card, alternated.

    python3 serve_ab.py PARENT . . PARENT
    python3 serve_ab.py --no-fallback .@host-serial .@host .@host .@host-serial

Each argument is a checkout of the repo (for example the parent commit
unpacked with ``git archive`` into ``build/parent``), optionally followed
by ``@MODE``, the engine mode of its split-path phase:

    fused         lowering on,  pipeline on   (the default)
    fused-serial  lowering on,  pipeline off
    host          lowering off, pipeline on   (the layer pipeline scheduler)
    host-serial   lowering off, pipeline off

These are the four rows of the paper's Table 3 ablation.  For each
argument, in the order given, a fresh process builds that tree's kernels
and runs the serve phases of its ``chip_smoke.py`` (5: the colocated split
path at published widths, in the given mode; 6: zamba2 + mamba2 through
the dense-cache fallback, unless ``--no-fallback``), with their checks,
each twice: the first run takes the process's first-use costs (library
loading, cuBLAS handles, allocator growth), which a mode that captures
CUDA graphs would otherwise pay at engine construction, outside the
timed window, and a mode that does not inside it; the second is timed.
It prints one ``AB`` line per phase: tokens/s, TBT p50 / p99 and TTFT
p50.  Then it prints the mean tokens/s of each (tree, mode, phase).  A
tree whose ``serve_phase`` takes no engine mode runs only ``fused``.
Both phases are host-bound and wander tens of percent between runs, so
two trees or modes are compared only within one call, in the order A, B,
B, A.
"""
from __future__ import annotations

import re
import subprocess
import sys
from collections import defaultdict

LINE = re.compile(r"^AB (\S+) (.+): ([0-9.]+) tok/s")
MODES = {"fused": (True, True), "fused-serial": (True, False),
         "host": (False, True), "host-serial": (False, False)}


def one(root: str, mode: str, fallback: bool) -> None:
    """The serve phases of the tree at ``root``, in this process."""
    import gc

    sys.path[:0] = [root + "/src", root]
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.serve import coloc_models

    lowering, pipeline = MODES[mode]
    kw = {} if mode == "fused" else dict(lowering=lowering,
                                         pipeline=pipeline)
    build.build_all()
    phases = [("serve", coloc_models(full_width=True),
               cs.SERVE_K if lowering else 1, 16384, cs.check_coloc, kw)]
    if fallback:
        phases.append(("serve fallback",
                       {n: get_config(n) for n in cs.FALLBACK_MODELS}, 1,
                       32768, cs.check_fallback, {}))
    for label, models, k, budget, check, extra in phases:
        for _ in range(2):                 # a warm-up run, then the timed one
            _, fig = cs.serve_phase(torch, np, kops, models, k=k,
                                    page_budget=budget, label=label,
                                    check=check, **extra)
            gc.collect()
            torch.cuda.empty_cache()
        print(f"AB {root}@{mode} {label}: {fig['tokens_per_s']:.1f} tok/s "
              f"TBT p50 {fig['tbt_p50_ms']:.2f} ms p99 "
              f"{fig['tbt_p99_ms']:.2f} ms TTFT p50 "
              f"{fig['ttft_p50_ms']:.1f} ms", flush=True)


def main(argv) -> int:
    if len(argv) == 4 and argv[0] == "--one":
        one(argv[1], argv[2], argv[3] == "1")
        return 0
    fallback = "--no-fallback" not in argv
    argv = [a for a in argv if a != "--no-fallback"]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    runs = defaultdict(list)
    for arg in argv:
        root, _, mode = arg.partition("@")
        mode = mode or "fused"
        if mode not in MODES:
            print(f"unknown mode {mode!r}; one of {sorted(MODES)}",
                  file=sys.stderr)
            return 2
        res = subprocess.run([sys.executable, __file__, "--one", root, mode,
                              "1" if fallback else "0"],
                             capture_output=True, text=True)
        lines = [m for m in map(LINE.match, res.stdout.splitlines()) if m]
        for m in lines:
            print(m.string, flush=True)
            runs[(m.group(1), m.group(2))].append(float(m.group(3)))
        if res.returncode != 0 or len(lines) != 1 + fallback:
            print(res.stdout[-4000:] + res.stderr[-4000:], file=sys.stderr)
            return 1
    for (root, label), vals in runs.items():
        print(f"mean {root} {label}: {sum(vals) / len(vals):.1f} tok/s over "
              f"{len(vals)} runs ({', '.join(f'{v:.1f}' for v in vals)})")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
