"""Checking the pools' invariants and the port's own code, ported.

* ``repro_torch.analysis.sanitizer`` — the shadow-sanitizer
  (``PoolSanitizer``): it mirrors every page / slab / refcount / swap /
  reserve transition the pools report through their hooks and audits the
  pools' host-side state at step boundaries (SAN01..SAN08).
* ``repro_torch.analysis.lint`` — the invariant lint (CP001..CP007) over
  ``src/repro_torch``, with the reference's rules in their torch meaning.
* ``repro_torch.analysis.graph_audit`` — the audit of the fused decode
  bodies and their CUDA graphs (CPA01..CPA04), the counterpart of the
  reference's ``jaxpr_audit``.
"""
from repro_torch.analysis.sanitizer import PoolSanitizer, PoolSanitizerError

__all__ = ["PoolSanitizer", "PoolSanitizerError"]
