#!/usr/bin/env python3
"""Serve throughput of two trees of this repo on one card, alternated.

    python3 serve_ab.py PARENT . . PARENT

``PARENT`` is another checkout of the repo (for example the parent
commit unpacked with ``git archive`` into ``build/parent``).  For each
tree, in the order given, a fresh process builds that tree's kernels and
runs the two serve phases of its ``chip_smoke.py`` (5: the colocated
split path at published widths; 6: zamba2 + mamba2 through the
dense-cache fallback), with their checks, and prints one ``AB`` line per
phase: tokens/s, TBT p50 and TTFT p50.  Then it prints each tree's mean
tokens/s per phase.  Both phases are host-bound and wander tens of
percent between runs, so two trees are compared only within one call,
in the order parent, change, change, parent.
"""
from __future__ import annotations

import re
import subprocess
import sys
from collections import defaultdict

LINE = re.compile(r"^AB (\S+) (.+): ([0-9.]+) tok/s")


def one(root: str) -> None:
    """Both serve phases of the tree at ``root``, in this process."""
    import gc

    sys.path[:0] = [root + "/src", root]
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.serve import coloc_models

    build.build_all()
    for label, models, k, budget, check in (
            ("serve", coloc_models(full_width=True), cs.SERVE_K, 16384,
             cs.check_coloc),
            ("serve fallback", {n: get_config(n) for n in cs.FALLBACK_MODELS},
             1, 32768, cs.check_fallback)):
        _, fig = cs.serve_phase(torch, np, kops, models, k=k,
                                page_budget=budget, label=label, check=check)
        print(f"AB {root} {label}: {fig['tokens_per_s']:.1f} tok/s TBT p50 "
              f"{fig['tbt_p50_ms']:.2f} ms TTFT p50 {fig['ttft_p50_ms']:.1f}",
              flush=True)
        gc.collect()
        torch.cuda.empty_cache()


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        one(argv[1])
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    runs = defaultdict(list)
    for root in argv:
        res = subprocess.run([sys.executable, __file__, "--one", root],
                             capture_output=True, text=True)
        lines = [m for m in map(LINE.match, res.stdout.splitlines()) if m]
        for m in lines:
            print(m.string, flush=True)
            runs[(m.group(1), m.group(2))].append(float(m.group(3)))
        if res.returncode != 0 or len(lines) != 2:
            print(res.stdout[-4000:] + res.stderr[-4000:], file=sys.stderr)
            return 1
    for (root, label), vals in runs.items():
        print(f"mean {root} {label}: {sum(vals) / len(vals):.1f} tok/s over "
              f"{len(vals)} runs ({', '.join(f'{v:.1f}' for v in vals)})")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
