"""Test-suite bootstrap.

Prefers the real ``hypothesis`` (installed in CI via requirements-dev.txt);
falls back to the deterministic stub in ``_hypothesis_fallback`` so the
property tests still collect and run in hermetic environments.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

try:
    import hypothesis  # noqa: F401
except ImportError:
    import _hypothesis_fallback
    _hypothesis_fallback.install()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips where there is none")
