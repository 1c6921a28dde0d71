"""Decode attention: the CUDA kernels' bindings and wrappers.

The kernels live in ``csrc/paged_attention.cu`` (see the note there for
what they replace, their bound and their design), built at first use by
``repro_torch.kernels.build`` and wrapped here:

* ``paged_decode_attention``       -> ``paged_gqa_decode``
* ``paged_mla_decode_attention``   -> ``paged_mla_decode``
* ``contiguous_decode_attention``  -> ``contiguous_gqa_decode``

The paged wrappers take the FLAT pool ``[n_pages, page_elems]`` and the
page geometry instead of a typed page view: the kernels compute every
address themselves, so no per-call copy of the pool is ever made.  The
contiguous wrapper takes the dense-cache layer ``[B, T, KV, D]`` of the
fallback families as it is.  On a CUDA tensor a wrapper launches its
kernel or raises; only a tensor that lies on the CPU takes the plain
PyTorch version (``repro_torch.kernels.ref``).  Each wrapper counts its
kernel launches in its ``launches`` attribute.  The kernels have no
backward: a CUDA call under grad mode with an input that requires grad
raises (``build.refuse_grad``).

Like the TPU kernels (``src/repro/kernels/paged_attention.py:92,183,284``)
the wrappers fold ``scale`` into q once and round it back to q's dtype
before the launch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.build import DTYPE_CODES, launch

SOURCE = build.CSRC / "paged_attention.cu"


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels, with typed entry points."""
    lib = build.load(SOURCE.name)
    ptrs = [ctypes.c_void_p] * 5
    ints = [ctypes.c_int] * 6
    for fn in (lib.paged_gqa_decode, lib.paged_mla_decode):
        fn.argtypes = ptrs + ints + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.contiguous_gqa_decode.argtypes = ([ctypes.c_void_p] * 5
                                          + [ctypes.c_int] * 6
                                          + [ctypes.c_void_p])
    lib.contiguous_gqa_decode.restype = ctypes.c_int
    return lib


def _check_launch_inputs(q, pool, page_table, lengths, per_tok: int,
                         tokens_per_page: int) -> None:
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    if pool.dtype != q.dtype:
        raise TypeError(f"q is {q.dtype} but the pool is {pool.dtype}")
    for name, t in (("pool", pool), ("page_table", page_table),
                    ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if pool.dim() != 2 or not pool.is_contiguous():
        raise ValueError("pool must be a contiguous [n_pages, page_elems] "
                         "tensor")
    if tokens_per_page * per_tok > pool.shape[1]:
        raise ValueError(f"{tokens_per_page} tokens of {per_tok} elements "
                         f"do not fit a {pool.shape[1]}-element page")
    if page_table.dim() != 2 or page_table.shape[0] != q.shape[0] \
            or lengths.shape != (q.shape[0],):
        raise ValueError("page_table must be [B, max_pages] and lengths [B]")


def _launch(fn, q, pool, page_table, lengths, out, dims) -> None:
    launch(fn, q.device, q, pool, page_table.to(torch.int32).contiguous(),
           lengths.to(torch.int32).contiguous(), out, *dims,
           DTYPE_CODES[q.dtype])


def _scaled(q: torch.Tensor, scale: float) -> torch.Tensor:
    """Fold ``scale`` into q once and round back to q's dtype."""
    return (q.float() * scale).to(q.dtype).contiguous()


def paged_decode_attention(q: torch.Tensor, pool: torch.Tensor,
                           page_table: torch.Tensor, lengths: torch.Tensor,
                           *, tokens_per_page: int, n_kv: int,
                           scale: float) -> torch.Tensor:
    """One-token GQA decode through the page table.

    q [B,1,H,D]; pool [n_pages, page_elems] flat, token rows
    ``[2, n_kv, D]``; page_table [B, max_pages] int (-1 = unmapped);
    lengths [B] valid tokens.  Returns [B,1,H,D] in q's dtype.
    """
    B, _, H, D = q.shape
    per_tok = 2 * n_kv * D
    if q.device.type == "cpu":
        n_pages = pool.shape[0]
        typed = pool[:, :tokens_per_page * per_tok].reshape(
            n_pages, tokens_per_page, 2, n_kv, D)
        return ref.paged_decode_attention(q, typed, page_table, lengths,
                                          scale)
    if q.device.type != "cuda":
        raise ValueError(f"no paged attention kernel for {q.device}")
    if H % n_kv:
        raise ValueError(f"{H} query heads do not group over {n_kv} kv heads")
    _check_launch_inputs(q, pool, page_table, lengths, per_tok,
                         tokens_per_page)
    build.refuse_grad("paged_decode_attention", q, pool)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(load_library().paged_gqa_decode, _scaled(q, scale), pool,
            page_table, lengths, out,
            (B, H, n_kv, D, page_table.shape[1], tokens_per_page,
             pool.shape[1]))
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def paged_mla_decode_attention(q: torch.Tensor, pool: torch.Tensor,
                               page_table: torch.Tensor,
                               lengths: torch.Tensor, *,
                               tokens_per_page: int, latent_dim: int,
                               scale: float) -> torch.Tensor:
    """One-token absorbed-MLA decode through the page table.

    q [B,1,H,r+rp] = [q_latent | q_rope]; pool [n_pages, page_elems] flat,
    token rows ``[r + rp]``.  Returns the latent context [B,1,H,r].
    """
    B, _, H, e = q.shape
    if q.device.type == "cpu":
        n_pages = pool.shape[0]
        typed = pool[:, :tokens_per_page * e].reshape(
            n_pages, tokens_per_page, e)
        return ref.paged_mla_decode_attention(q, typed, page_table, lengths,
                                              latent_dim, scale)
    if q.device.type != "cuda":
        raise ValueError(f"no paged attention kernel for {q.device}")
    _check_launch_inputs(q, pool, page_table, lengths, e, tokens_per_page)
    build.refuse_grad("paged_mla_decode_attention", q, pool)
    out = torch.empty((B, 1, H, latent_dim), dtype=q.dtype, device=q.device)
    _launch(load_library().paged_mla_decode, _scaled(q, scale), pool,
            page_table, lengths, out,
            (B, H, latent_dim, e - latent_dim, page_table.shape[1],
             tokens_per_page, pool.shape[1]))
    paged_mla_decode_attention.launches += 1
    return out


paged_mla_decode_attention.launches = 0


def contiguous_decode_attention(q: torch.Tensor, cache_k: torch.Tensor,
                                cache_v: torch.Tensor, lengths: torch.Tensor,
                                *, scale: float) -> torch.Tensor:
    """One-token GQA decode over a contiguous cache.

    q [B,1,H,D]; cache_k / cache_v [B,T,KV,D] (one dense-cache layer);
    lengths [B] valid tokens (clamped to T).  Returns [B,1,H,D] in q's
    dtype.
    """
    if q.device.type == "cpu":
        return ref.decode_attention(q, cache_k, cache_v, lengths, scale)
    if q.device.type != "cuda":
        raise ValueError(f"no decode attention kernel for {q.device}")
    B, _, H, D = q.shape
    T, KV = cache_k.shape[1], cache_k.shape[2]
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    for name, t in (("cache_k", cache_k), ("cache_v", cache_v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError(f"{name} is {t.dtype} on {t.device}, q is "
                            f"{q.dtype} on {q.device}")
        if t.shape != (B, T, KV, D) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [B,T,KV,D] "
                             f"tensor, got {tuple(t.shape)}")
    if H % KV:
        raise ValueError(f"{H} query heads do not group over {KV} kv heads")
    if lengths.shape != (B,) or lengths.device != q.device:
        raise ValueError("lengths must be [B] on q's device")
    build.refuse_grad("decode_attention", q, cache_k, cache_v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    launch(load_library().contiguous_gqa_decode, q.device,
           _scaled(q, scale), cache_k, cache_v,
           lengths.to(torch.int32).contiguous(), out, B, H, KV, D, T,
           DTYPE_CODES[q.dtype])
    contiguous_decode_attention.launches += 1
    return out


contiguous_decode_attention.launches = 0
