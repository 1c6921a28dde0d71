"""Phase 2 of ``chip_smoke.py``: compiles every kernel source of
``src/repro_torch/kernels/csrc`` with nvcc (one process each, all
started together), loads them and prints each one's ``-Xptxas -v``
report."""
from __future__ import annotations

import time

from chip_smoke_phases.common import log


def run(ctx) -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"build: {', '.join(p.name for p in libs.values())} in "
        f"{time.perf_counter() - t0:.1f} s")
    for src, lib in libs.items():
        log(f"build log {src}:")
        log(lib.with_suffix(".so.log").read_text().strip())
