"""Typed errors for the pool-accounting layer (a copy of the reference's
``core/errors.py``, DESIGN.md §12).

``PoolAccountingError`` replaces bare ``assert``s on the virtualizer's
and arena's accounting paths: asserts vanish under ``python -O``.  A
dedicated type also tells an accounting-contract violation apart from
capacity exhaustion (``OutOfPagesError`` / ``OutOfSlabsError``), which is
an expected, recoverable outcome.
"""
from __future__ import annotations


class PoolAccountingError(RuntimeError):
    """An internal pool-accounting invariant was violated.

    Unlike ``OutOfPagesError``/``OutOfSlabsError`` (capacity verdicts a
    caller may catch and retry), this signals a CONTRACT bug — e.g. a
    table write on a swapped request, a retain of a non-device entry, or
    a resize below the 1-page floor — and survives ``python -O``.
    """


def check(cond: bool, message: str) -> None:
    """``assert`` replacement for accounting paths: raises
    :class:`PoolAccountingError` (never elided by ``-O``)."""
    if not cond:
        raise PoolAccountingError(message)
