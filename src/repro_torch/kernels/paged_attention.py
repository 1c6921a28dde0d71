"""Decode attention: the CUDA kernels' bindings and wrappers.

The kernels live in ``csrc/paged_attention.cu`` (see the note there for
what they replace, their bound and their design), built at first use by
``repro_torch.kernels.build`` and wrapped here:

* ``paged_decode_attention``       -> ``paged_gqa_decode_bf16`` / ``_f32``
* ``paged_mla_decode_attention``   -> ``paged_mla_decode_bf16`` / ``_f32``
* ``contiguous_decode_attention``  -> ``contiguous_gqa_decode_bf16`` /
                                      ``_f32``

The paged wrappers take the FLAT pool ``[n_pages, page_elems]`` and the
page geometry instead of a typed page view: the kernels compute every
address themselves, so no per-call copy of the pool is ever made.  The
contiguous wrapper takes the dense-cache layer ``[B, T, KV, D]`` of the
fallback families as it is.  On a CUDA tensor a wrapper launches its
kernel or raises; only a tensor that lies on the CPU takes the plain
PyTorch version (``repro_torch.kernels.ref``).  Each wrapper counts its
calls that reach the card in its ``launches`` attribute (one per call,
however many CUDA launches the call makes).  The kernels have no
backward: a CUDA call under grad mode with an input that requires grad
raises (``build.refuse_grad``).

The GQA routes follow the dtype.  bfloat16 takes the split-KV kernels
(flash-decoding): ``kv_splits`` cuts the context into runs of whole
``TILE``-token tiles from host-known shapes only, the partials go to f32
buffers from ``torch.empty`` and a second small kernel merges them, so a
call makes no host read and can be captured in a CUDA graph.  Within it,
a kv head's ``G = H / KV`` query heads run on tensor cores when ``G >=
8`` and on CUDA cores otherwise (``rows_per_block``; head dims in
``check_bf16_geometry``: at 256, gemma3's, only ``G <= 2``).  float32 takes the
first design (one block per kv head and batch row, CUDA cores), which holds
the card-vs-CPU checks at 2e-5.  The MLA route follows the dtype too:
bfloat16 takes the same split-KV structure with 16 heads a block on
tensor cores over the latent row all heads share (``mla_split_plan``,
widths in ``check_mla_geometry``), float32 the first design.  Every route
folds ``scale`` into q in the kernel (f32 product rounded to q's dtype),
as the TPU wrappers do (``src/repro/kernels/paged_attention.py:92,183,
284``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.build import DTYPE_CODES, launch

SOURCE = build.CSRC / "paged_attention.cu"
#: tokens per tile of the split-KV kernels; a split covers whole tiles
TILE = 64
#: most splits of one row's context
MAX_SPLITS = 128
#: blocks per SM the split count aims at
BLOCKS_PER_SM = 2
#: head dims the bf16 GQA kernels are instantiated for: every one on CUDA
#: cores, and 16-128 on tensor cores (``mma.sync.m16n8k16`` steps k by
#: 16); 8 is the smoke configs' head dim, 256 gemma3's
HEAD_DIMS = (8, 16, 32, 64, 128, 256)
TENSOR_CORE_HEAD_DIMS = (16, 32, 64, 128)
#: head dims whose CUDA-core bodies serve at most 2 query heads a block
#: (4 heads' q and accumulator rows of 256 would not fit the registers):
#: G <= 2, as gemma3's G = 2
TWO_ROW_HEAD_DIMS = (256,)
#: (latent, rope) widths the bf16 MLA kernel is instantiated for: minicpm3
#: at its published width, the small float32 check's and the smoke config's
MLA_WIDTHS = ((256, 32), (64, 16), (16, 8))
#: query heads one bf16 MLA block serves (the 16 rows of ``mma.sync``)
MLA_ROWS = 16


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels, with typed entry points."""
    lib = build.load(SOURCE.name)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.paged_gqa_decode_bf16.argtypes = (
        [ptr] * 8 + [i32] * 7 + [ctypes.c_longlong, i32, i32,
                                 ctypes.c_float, ptr])
    lib.contiguous_gqa_decode_bf16.argtypes = (
        [ptr] * 8 + [i32] * 8 + [ctypes.c_float, ptr])
    lib.paged_gqa_decode_f32.argtypes = (
        [ptr] * 5 + [i32] * 6 + [ctypes.c_longlong, ctypes.c_float, ptr])
    lib.contiguous_gqa_decode_f32.argtypes = (
        [ptr] * 5 + [i32] * 5 + [ctypes.c_float, ptr])
    lib.paged_mla_decode_bf16.argtypes = (
        [ptr] * 8 + [i32] * 6 + [ctypes.c_longlong, i32, i32,
                                 ctypes.c_float, ptr])
    lib.paged_mla_decode_f32.argtypes = (
        [ptr] * 5 + [i32] * 6 + [ctypes.c_longlong, ctypes.c_float, ptr])
    for fn in (lib.paged_gqa_decode_bf16, lib.contiguous_gqa_decode_bf16,
               lib.paged_gqa_decode_f32, lib.contiguous_gqa_decode_f32,
               lib.paged_mla_decode_bf16, lib.paged_mla_decode_f32):
        fn.restype = ctypes.c_int
    return lib


def rows_per_block(group: int) -> int:
    """Query heads one bf16 GQA block serves, from the group size ``G =
    H / KV``: 16 for ``G >= 8`` (tensor cores: the heads are the 16 rows
    of ``mma.sync``; a larger G takes several blocks), else 1, 2 or 4
    (bf16x2 products on CUDA cores)."""
    if group >= 8:
        return 16
    return group if group <= 2 else 4


def n_tiles(max_tokens: int) -> int:
    """``TILE``-token tiles covering ``max_tokens`` (at least one)."""
    return max(1, -(-max_tokens // TILE))


def kv_splits(batch: int, kv_blocks: int, max_tokens: int,
              sm_count: int) -> int:
    """How many splits the bf16 GQA kernels cut a row's context into.

    ``kv_blocks`` blocks serve one batch row before the split (kv heads x
    head groups); ``max_tokens`` is what the table can address (``max_pages
    x tokens_per_page``, or the cache's T).  Aims at ``BLOCKS_PER_SM``
    blocks per SM in all, with at least one tile per split and at most
    ``MAX_SPLITS``.  Only host-known shapes enter: never the lengths,
    which live on the card, so a call needs no host read and its launch
    shape is fixed.
    """
    want = -(-BLOCKS_PER_SM * sm_count // max(1, batch * kv_blocks))
    return max(1, min(want, n_tiles(max_tokens), MAX_SPLITS))


def split_plan(batch: int, heads: int, n_kv: int, max_tokens: int,
               sm_count: int) -> Tuple[int, int]:
    """(query heads per block, splits) of a bf16 GQA decode call."""
    group = heads // n_kv
    rows = rows_per_block(group)
    return rows, kv_splits(batch, n_kv * -(-group // rows), max_tokens,
                           sm_count)


def check_bf16_geometry(heads: int, n_kv: int, head_dim: int) -> None:
    """Raise ``ValueError`` unless the bf16 GQA kernels are instantiated
    for ``heads`` query heads over ``n_kv`` kv heads of ``head_dim``."""
    if n_kv <= 0 or heads % n_kv:
        raise ValueError(f"{heads} query heads do not group over {n_kv} kv "
                         f"heads")
    rows = rows_per_block(heads // n_kv)
    tensor_cores = rows == 16
    dims = TENSOR_CORE_HEAD_DIMS if tensor_cores else HEAD_DIMS
    if head_dim not in dims:
        raise ValueError(
            f"bf16 GQA kernels take head dims {dims} on "
            f"{'tensor' if tensor_cores else 'CUDA'} cores (G = "
            f"{heads // n_kv}), got {head_dim}")
    if head_dim in TWO_ROW_HEAD_DIMS and rows > 2:
        raise ValueError(f"bf16 GQA kernels at head dim {head_dim} take "
                         f"groups G <= 2, got G = {heads // n_kv}")


def mla_split_plan(batch: int, heads: int, max_tokens: int,
                   sm_count: int) -> Tuple[int, int]:
    """(head groups, splits) of a bf16 MLA decode call: every head reads
    the same latent row, so a block serves ``MLA_ROWS`` heads and the
    split count aims at ``BLOCKS_PER_SM`` blocks per SM over the
    ``batch x head groups`` blocks, from shapes alone."""
    groups = -(-heads // MLA_ROWS)
    return groups, kv_splits(batch, groups, max_tokens, sm_count)


def check_mla_geometry(latent_dim: int, rope_dim: int) -> None:
    """Raise ``ValueError`` unless the bf16 MLA kernel is instantiated for
    ``latent_dim + rope_dim`` rows whose value is the ``latent_dim``
    prefix."""
    if (latent_dim, rope_dim) not in MLA_WIDTHS:
        raise ValueError(f"the bf16 MLA kernel takes (latent, rope) widths "
                         f"{MLA_WIDTHS}, got ({latent_dim}, {rope_dim})")


def split_start(split: int, splits: int, max_tokens: int) -> int:
    """First token of ``split``: split s covers the tiles [s * n / splits,
    (s + 1) * n / splits) of the n = ``n_tiles(max_tokens)``, as the
    kernel computes it."""
    return split * n_tiles(max_tokens) // splits * TILE


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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


def _gqa_route(q: torch.Tensor, kv: torch.Tensor, n_kv: int) -> str:
    """The GQA kernel body for these inputs ("bf16" or "f32"); raises on
    what neither takes."""
    H, D = q.shape[2], q.shape[3]
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    if H % n_kv:
        raise ValueError(f"{H} query heads do not group over {n_kv} kv heads")
    if q.dtype == torch.float32:
        return "f32"
    check_bf16_geometry(H, n_kv, D)
    if kv.data_ptr() % 16:
        raise ValueError("the KV must start on 16 bytes (cp.async)")
    return "bf16"


def _partials(B: int, H: int, splits: int, D: int, device):
    """The f32 partials (acc [B,H,splits,D], m and l [B,H,splits]) of a
    split-KV call, from ``torch.empty``; none for one split."""
    if splits == 1:
        return None, None, None
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.empty((B, H, splits, D), **f32),
            torch.empty((B, H, splits), **f32),
            torch.empty((B, H, splits), **f32))


def _split_launch(fn, q, kv, lengths, n_kv, max_tokens, geometry,
                  scale) -> torch.Tensor:
    """Launch a bf16 split-KV entry point: ``kv`` are its KV pointer
    arguments (and table), ``geometry`` its shape arguments after the
    rows.  Allocates ``out`` and, for more than one split, the f32
    partials, with ``torch.empty`` only; reads nothing back."""
    B, _, H, D = q.shape
    rows, splits = split_plan(B, H, n_kv, max_tokens,
                              _sm_count(q.device.index))
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    parts = _partials(B, H, splits, D, q.device)
    launch(fn, q.device, q.contiguous(), *kv,
           lengths.to(torch.int32).contiguous(), out, *parts, B, H, n_kv, D,
           rows, *geometry, splits, n_tiles(max_tokens), float(scale))
    return out


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
    route = _gqa_route(q, pool, n_kv)
    _check_launch_inputs(q, pool, page_table, lengths, per_tok,
                         tokens_per_page)
    build.refuse_grad("paged_decode_attention", q, pool)
    lib, max_pages = load_library(), page_table.shape[1]
    table = page_table.to(torch.int32).contiguous()
    if route == "bf16":
        if pool.shape[1] % 8:
            raise ValueError("bf16 pages must hold a multiple of 8 elements")
        out = _split_launch(lib.paged_gqa_decode_bf16, q, (pool, table),
                            lengths, n_kv, max_pages * tokens_per_page,
                            (max_pages, tokens_per_page, pool.shape[1]),
                            scale)
    else:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        launch(lib.paged_gqa_decode_f32, q.device, q.contiguous(), pool,
               table, lengths.to(torch.int32).contiguous(), out, B, H, n_kv,
               D, max_pages, tokens_per_page, pool.shape[1], float(scale))
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
    bf16 takes the split-KV tensor-core kernel (``mla_split_plan``; widths
    in ``MLA_WIDTHS``), float32 the first design.
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
    rope_dim, max_pages = e - latent_dim, page_table.shape[1]
    args = (q.contiguous(), pool, page_table.to(torch.int32).contiguous(),
            lengths.to(torch.int32).contiguous())
    out = torch.empty((B, 1, H, latent_dim), dtype=q.dtype, device=q.device)
    if q.dtype == torch.bfloat16:
        check_mla_geometry(latent_dim, rope_dim)
        if pool.data_ptr() % 16 or pool.shape[1] % 8:
            raise ValueError("bf16 pages must start on 16 bytes and hold a "
                             "multiple of 8 elements (cp.async)")
        max_tokens = max_pages * tokens_per_page
        _, splits = mla_split_plan(B, H, max_tokens,
                                   _sm_count(q.device.index))
        launch(load_library().paged_mla_decode_bf16, q.device, *args, out,
               *_partials(B, H, splits, latent_dim, q.device), B, H,
               latent_dim, rope_dim, max_pages, tokens_per_page,
               pool.shape[1], splits, n_tiles(max_tokens), float(scale))
    else:
        launch(load_library().paged_mla_decode_f32, q.device, *args, out, B,
               H, latent_dim, rope_dim, max_pages, tokens_per_page,
               pool.shape[1], float(scale))
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
    route = _gqa_route(q, cache_k, KV)
    for name, t in (("cache_k", cache_k), ("cache_v", cache_v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError(f"{name} is {t.dtype} on {t.device}, q is "
                            f"{q.dtype} on {q.device}")
        if t.shape != (B, T, KV, D) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [B,T,KV,D] "
                             f"tensor, got {tuple(t.shape)}")
    if route == "bf16" and cache_v.data_ptr() % 16:
        raise ValueError("cache_v must start on 16 bytes (cp.async)")
    if lengths.shape != (B,) or lengths.device != q.device:
        raise ValueError("lengths must be [B] on q's device")
    build.refuse_grad("decode_attention", q, cache_k, cache_v)
    lib = load_library()
    if route == "bf16":
        out = _split_launch(lib.contiguous_gqa_decode_bf16, q,
                            (cache_k, cache_v), lengths, KV, T, (T,), scale)
    else:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        launch(lib.contiguous_gqa_decode_f32, q.device, q.contiguous(),
               cache_k, cache_v, lengths.to(torch.int32).contiguous(), out,
               B, H, KV, D, T, float(scale))
    contiguous_decode_attention.launches += 1
    return out


contiguous_decode_attention.launches = 0
