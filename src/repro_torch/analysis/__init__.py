"""Runtime checking of the pools' invariants, ported.

* ``repro_torch.analysis.sanitizer`` — the shadow-sanitizer
  (``PoolSanitizer``): it mirrors every page / slab / refcount / swap /
  reserve transition the pools report through their hooks and audits the
  pools' host-side state at step boundaries (SAN01..SAN08).

The reference's static legs (the repo lint and the jaxpr audit) check
JAX programs and have no counterpart here.
"""
from repro_torch.analysis.sanitizer import PoolSanitizer, PoolSanitizerError

__all__ = ["PoolSanitizer", "PoolSanitizerError"]
