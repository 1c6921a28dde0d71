"""PyTorch/CUDA port of the CrossPool serving system.

A second package beside the JAX reference ``repro``: the same subpackage
layout (each port module maps to one reference module), written in
PyTorch, with the reference's Pallas TPU kernels replaced by CUDA C++
kernels written by hand for Hopper (``repro_torch.kernels.csrc``).  The
package imports ``torch`` and numpy only — never ``jax`` and nothing of
``repro`` — so it runs on a machine that has no JAX at all.

Entry points (``runtime.engine.CrossPoolEngine``, ``launch.serve``) run
on ``cuda`` by default and raise when no card is present unless the
caller passes ``device="cpu"``; on the CPU every kernel wrapper takes
its plain PyTorch version.
"""
