"""Kernel layer: hand-written CUDA kernels (``csrc/``, built by
``build``), their ctypes wrappers, the plain PyTorch versions (``ref``,
``ssd_chunked``) and the dispatcher (``ops``)."""
