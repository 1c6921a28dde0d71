"""The phases of ``chip_smoke.py``, one module each.

``PHASES`` lists them in the order the script runs them: (number, label,
module, the phases whose results it reads).  Phases 1 and 2 (the card,
the kernels' build) run in every run; ``select`` picks the rest.  Each
phase module's ``run(ctx)`` takes the run's state (``common.Run``) and
leaves its results under ``ctx.out[number]``.
"""
from __future__ import annotations

import importlib

PHASES = (
    (1, "card", "p01_card", ()),
    (2, "build", "p02_build", ()),
    (3, "kernels", "p03_kernels", ()),
    (4, "small", "p04_small", ()),
    (5, "serve", "p05_serve", ()),
    (6, "serve fallback", "p06_serve_fallback", ()),
    (7, "train", "p07_train", ()),
    (8, "moe gemm", "p08_moe_gemm", (7,)),        # phase 7's router load
    (9, "elastic", "p09_elastic", ()),
    (10, "cache", "p10_cache", ()),
    (11, "observe", "p11_observe", ()),
    (12, "families", "p12_families", ()),
    (13, "examples", "p13_examples", ()),
    (14, "sharding", "p14_sharding", ()),
    (15, "sharded train", "p15_sharded_train", ()),
    (16, "sharded serve", "p16_sharded_serve", ()),
    (17, "sharded families", "p17_sharded_families", ()),
)
_BY_NUMBER = {n: (label, mod, needs) for n, label, mod, needs in PHASES}


def label(n: int) -> str:
    return f"{n} {_BY_NUMBER[n][0]}"


def module(n: int):
    return importlib.import_module(f"chip_smoke_phases.{_BY_NUMBER[n][1]}")


def select(spec=None) -> list:
    """The phase numbers a run takes, in order: every phase for ``spec``
    None, else phases 1 and 2, the phases ``spec`` names (a comma list of
    numbers or labels with ``_`` for spaces, as ``3,sharded_train``) and
    the phases they need.  An unknown name raises ``ValueError``."""
    if spec is None:
        return [n for n, *_ in PHASES]
    names = {str(n): n for n, *_ in PHASES}
    names.update({lab.replace(" ", "_"): n for n, lab, *_ in PHASES})
    want = {1, 2}

    def add(n: int) -> None:
        if n not in want:
            want.add(n)
            for m in _BY_NUMBER[n][2]:
                add(m)
    for part in (p.strip() for p in spec.split(",")):
        if part not in names:
            raise ValueError(f"unknown phase {part!r}: the phases are "
                             + ", ".join(f"{n} ({lab.replace(' ', '_')})"
                                         for n, lab, *_ in PHASES))
        add(names[part])
    return sorted(want)
