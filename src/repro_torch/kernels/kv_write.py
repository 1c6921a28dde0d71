"""The pool write: the CUDA kernel's binding and wrapper.

The kernel lives in ``csrc/kv_write.cu`` (see the note there for what it
computes, its bound and why it is a kernel), built at first use by
``repro_torch.kernels.build``.  On a CUDA tensor ``paged_kv_write``
launches it or raises; only a pool that lies on the CPU takes the plain
PyTorch version (``ref.paged_kv_write``), and a pool on ``meta`` (the op
analysis) is returned as it is: which rows drop is data, and a write in
place changes no shape.  The wrapper makes no host read
and allocates nothing beyond the cast of the rows to the pool's type, so
a call can be captured in a CUDA graph.  Launches are counted in
``paged_kv_write.launches``, one per call that reaches the card (a call
with no rows launches nothing).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.build import launch

SOURCE = build.CSRC / "kv_write.cu"


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel, with its typed entry point."""
    lib = build.load(SOURCE.name)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.paged_kv_write.argtypes = [ptr] * 4 + [i32, i32, i64, i64, i32, ptr]
    lib.paged_kv_write.restype = ctypes.c_int
    return lib


def vector_bytes(*sizes: int) -> int:
    """The widest store (16, 8, 4, 2 or 1 bytes) dividing every size and
    address in ``sizes``."""
    vec = 16
    while vec > 1 and any(s % vec for s in sizes):
        vec //= 2
    return vec


@build.recorded
def paged_kv_write(pool: torch.Tensor, kv_flat: torch.Tensor,
                   pages: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """Store per-token KV rows into the flat page pool, IN PLACE.

    pool:    [n_pages, page_elems]  the shared physical pool
    kv_flat: [n, per_token_elems]   one row per token (one layer's K+V,
                                    or MLA latent+rope)
    pages:   [n] int physical page ids (< 0 = drop the row)
    slots:   [n] int token slot within the page

    Rows whose page id is negative (unmapped / inactive batch slots) are
    dropped, as the reference's ``mode="drop"`` scatter drops them
    (``src/repro/kernels/ops.py:79-104``); kept rows are stored bit for
    bit in the pool's type.  Where the reference donates the pool and
    rebinds the returned buffer, this writes into ``pool`` and returns the
    same tensor.
    """
    if build.plain_route(pool):
        if pool.is_meta:
            # shapes only: which rows drop is data, and the write in
            # place changes no shape
            return pool
        return ref.paged_kv_write(pool, kv_flat, pages, slots)
    if pool.device.type != "cuda":
        raise ValueError(f"no pool write kernel for {pool.device}")
    n, e = kv_flat.shape
    if pool.dim() != 2 or not pool.is_contiguous():
        raise ValueError("pool must be a contiguous [n_pages, page_elems] "
                         "tensor")
    for name, t in (("kv_flat", kv_flat), ("pages", pages), ("slots", slots)):
        if t.device != pool.device:
            raise ValueError(f"{name} is on {t.device}, the pool on "
                             f"{pool.device}")
    if pages.shape != (n,) or slots.shape != (n,):
        raise ValueError(f"pages and slots must be [{n}], got "
                         f"{tuple(pages.shape)} and {tuple(slots.shape)}")
    if n == 0:
        return pool
    rows = kv_flat.to(pool.dtype).contiguous()
    itemsize = pool.element_size()
    row_bytes, page_bytes = e * itemsize, pool.shape[1] * itemsize
    vec = vector_bytes(row_bytes, page_bytes, pool.data_ptr(),
                       rows.data_ptr())
    launch(load_library().paged_kv_write, pool.device, pool, rows,
           pages.to(torch.int32).contiguous(),
           slots.to(torch.int32).contiguous(), n, pool.shape[0], page_bytes,
           row_bytes, vec)
    paged_kv_write.launches += 1
    return pool


paged_kv_write.launches = 0
