"""Decode attention: the CUDA kernels' bindings and wrappers.

The kernels live in ``csrc/paged_attention.cu`` (see the note there for
what they replace, their bound and their design), built at first use by
``repro_torch.kernels.build`` and wrapped here:

* ``paged_decode_attention``       -> ``paged_gqa_decode``
* ``paged_mla_decode_attention``   -> ``paged_mla_decode``
* ``contiguous_decode_attention``  -> ``contiguous_gqa_decode``

each taking float32 or bfloat16 through a dtype code.  The paged wrappers
take the FLAT pool ``[n_pages, page_elems]`` and the page geometry
instead of a typed page view: the kernels compute every address
themselves, so no per-call copy of the pool is ever made.  The
contiguous wrapper takes the dense-cache layer ``[B, T, KV, D]`` of the
fallback families as it is, and with ``return_lse`` also returns each
row's log-sum-exp of its scaled scores (float32, written by the kernel:
the merge where the call splits, the split kernel where it does not).  On a CUDA tensor a wrapper launches its
kernel or raises; only a tensor that lies on the CPU (or on ``meta``:
shapes only, ``build.plain_route``) takes the plain PyTorch version
(``repro_torch.kernels.ref``).  Each wrapper counts its
calls that reach the card in its ``launches`` attribute (one per call,
however many CUDA launches the call makes).  The kernels have no
backward: a CUDA call under grad mode with an input that requires grad
raises (``build.refuse_grad``).

Every route is split-KV (flash-decoding): ``kv_splits`` cuts the context
into runs of whole ``TILE``-token tiles from host-known shapes only, the
partials go to f32 buffers from ``torch.empty`` and a second small
kernel merges them, so a call makes no host read and can be captured in
a CUDA graph.  bfloat16 GQA runs a kv head's ``G = H / KV`` query heads
on tensor cores when ``G >= 8`` and on CUDA cores otherwise
(``rows_per_block``; head dims in ``check_bf16_geometry``: at 256,
gemma3's, only ``G <= 2``); bfloat16 MLA serves 16 heads a block on
tensor cores over the latent row all heads share (``mla_split_plan``,
widths in ``check_mla_geometry``).  float32 takes one body on CUDA cores
(f32 FFMA, no TF32, which holds the card-vs-CPU checks at 2e-5) for GQA,
contiguous and MLA alike: MLA is one kv head for all H heads, its value
the key row's latent prefix (``F32_ROWS`` heads a block, widths in
``check_f32_geometry``).  A width no route is instantiated for raises
``ValueError``.  Every route folds ``scale`` into q in the kernel (f32
product rounded to q's dtype), as the TPU wrappers do
(``src/repro/kernels/paged_attention.py:92,183,284``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

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
#: (latent, rope) widths the MLA kernels are instantiated for (bf16 and
#: f32): minicpm3 at its published width, the small float32 check's and
#: the smoke config's
MLA_WIDTHS = ((256, 32), (64, 16), (16, 8))
#: query heads one bf16 MLA block serves (the 16 rows of ``mma.sync``)
MLA_ROWS = 16
#: query heads one f32 block serves (``rows_per_block``); a larger group
#: takes several blocks, each staging the KV once for its rows
F32_ROWS = (1, 4, 16)


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels, with typed entry points."""
    lib = build.load(SOURCE.name)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.paged_gqa_decode.argtypes = (
        [ptr] * 8 + [i32] * 7 + [ctypes.c_longlong, i32, i32,
                                 ctypes.c_float, i32, ptr])
    lib.contiguous_gqa_decode.argtypes = (
        [ptr] * 9 + [i32] * 8 + [ctypes.c_float, i32, ptr])
    lib.paged_mla_decode.argtypes = (
        [ptr] * 8 + [i32] * 7 + [ctypes.c_longlong, i32, i32,
                                 ctypes.c_float, i32, ptr])
    for fn in (lib.paged_gqa_decode, lib.contiguous_gqa_decode,
               lib.paged_mla_decode):
        fn.restype = ctypes.c_int
    return lib


def rows_per_block(group: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Query heads one GQA block serves, from the group size ``G = H /
    KV``.  bf16: 16 for ``G >= 8`` (tensor cores: the heads are the 16
    rows of ``mma.sync``; a larger G takes several blocks), else 1, 2 or 4
    (bf16x2 products on CUDA cores).  float32: the least of ``F32_ROWS``
    that holds G, 16 for any larger G (several blocks)."""
    if dtype == torch.float32:
        return next((r for r in F32_ROWS if r >= group), F32_ROWS[-1])
    if group >= 8:
        return 16
    return group if group <= 2 else 4


def n_tiles(max_tokens: int) -> int:
    """``TILE``-token tiles covering ``max_tokens`` (at least one)."""
    return max(1, -(-max_tokens // TILE))


def kv_splits(batch: int, kv_blocks: int, max_tokens: int,
              sm_count: int) -> int:
    """How many splits the split-KV kernels cut a row's context into.

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
               sm_count: int, dtype: torch.dtype = torch.bfloat16
               ) -> Tuple[int, int]:
    """(query heads per block, splits) of a GQA decode call in ``dtype``,
    or of a float32 MLA call (``n_kv = 1``: all heads read one row)."""
    group = heads // n_kv
    rows = rows_per_block(group, dtype)
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


def check_f32_geometry(heads: int, n_kv: int, key_dim: int,
                       value_dim: Optional[int] = None) -> None:
    """Raise ``ValueError`` unless the float32 kernel is instantiated for
    ``heads`` query heads over ``n_kv`` kv heads with key rows of
    ``key_dim`` and value rows of ``value_dim`` (GQA: both the head dim,
    one of ``HEAD_DIMS``; MLA: ``n_kv = 1``, ``key_dim = r + rp`` and
    ``value_dim = r`` with (r, rp) one of ``MLA_WIDTHS``).  Any group
    size runs (``F32_ROWS`` heads a block)."""
    if n_kv <= 0 or heads <= 0 or heads % n_kv:
        raise ValueError(f"{heads} query heads do not group over {n_kv} kv "
                         f"heads")
    if value_dim is None or value_dim == key_dim:
        if key_dim not in HEAD_DIMS:
            raise ValueError(f"the f32 GQA kernel takes head dims "
                             f"{HEAD_DIMS}, got {key_dim}")
        return
    if n_kv != 1 or (value_dim, key_dim - value_dim) not in MLA_WIDTHS:
        raise ValueError(f"the f32 MLA kernel takes one kv head and (latent, "
                         f"rope) widths {MLA_WIDTHS}, got {n_kv} kv heads "
                         f"and ({value_dim}, {key_dim - value_dim})")


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


def _check_gqa(q: torch.Tensor, kv: torch.Tensor, n_kv: int) -> None:
    """Raise unless a GQA kernel is instantiated for ``q``'s heads, head
    dim and dtype over ``n_kv`` kv heads and ``kv`` starts on 16 bytes."""
    H, D = q.shape[2], q.shape[3]
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    if q.dtype == torch.float32:
        check_f32_geometry(H, n_kv, D)
    else:
        check_bf16_geometry(H, n_kv, D)
    if kv.data_ptr() % 16:
        raise ValueError("the KV must start on 16 bytes (cp.async)")


def _check_pages(pool: torch.Tensor) -> None:
    if pool.data_ptr() % 16 or pool.shape[1] * pool.element_size() % 16:
        raise ValueError("pages must start on 16 bytes and hold a multiple "
                         "of 16 bytes (cp.async)")


def _partials(B: int, H: int, splits: int, D: int, device):
    """The f32 partials (acc [B,H,splits,D], m and l [B,H,splits]) of a
    split-KV call, from ``torch.empty``; none for one split."""
    if splits == 1:
        return None, None, None
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.empty((B, H, splits, D), **f32),
            torch.empty((B, H, splits), **f32),
            torch.empty((B, H, splits), **f32))


def _split_launch(fn, q, kv, lengths, widths, plan, max_tokens, geometry,
                  scale, out_dim: int, lse=()) -> torch.Tensor:
    """Launch a split-KV entry point: ``kv`` are its KV pointer arguments
    (and table), ``widths`` its shape arguments before the rows, ``plan``
    (rows, splits), ``geometry`` its shape arguments after the rows,
    ``lse`` the pointer arguments after the partials (the contiguous
    entry point's lse output, or None).  Allocates ``out`` [B,1,H,out_dim]
    and, for more than one split, the f32 partials, with ``torch.empty``
    only; reads nothing back."""
    B, _, H, _ = q.shape
    rows, splits = plan
    out = torch.empty((B, 1, H, out_dim), dtype=q.dtype, device=q.device)
    launch(fn, q.device, q.contiguous(), *kv,
           lengths.to(torch.int32).contiguous(), out,
           *_partials(B, H, splits, out_dim, q.device), *lse, B, H, *widths,
           rows, *geometry, splits, n_tiles(max_tokens), float(scale),
           DTYPE_CODES[q.dtype])
    return out


@build.recorded
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
    if build.plain_route(q):
        n_pages = pool.shape[0]
        typed = pool[:, :tokens_per_page * per_tok].reshape(
            n_pages, tokens_per_page, 2, n_kv, D)
        return ref.paged_decode_attention(q, typed, page_table, lengths,
                                          scale)
    if q.device.type != "cuda":
        raise ValueError(f"no paged attention kernel for {q.device}")
    _check_gqa(q, pool, n_kv)
    _check_launch_inputs(q, pool, page_table, lengths, per_tok,
                         tokens_per_page)
    _check_pages(pool)
    build.refuse_grad("paged_decode_attention", q, pool)
    max_pages = page_table.shape[1]
    max_tokens = max_pages * tokens_per_page
    plan = split_plan(B, H, n_kv, max_tokens, _sm_count(q.device.index),
                      q.dtype)
    out = _split_launch(load_library().paged_gqa_decode, q,
                        (pool, page_table.to(torch.int32).contiguous()),
                        lengths, (n_kv, D), plan, max_tokens,
                        (max_pages, tokens_per_page, pool.shape[1]), scale, D)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


@build.recorded
def paged_mla_decode_attention(q: torch.Tensor, pool: torch.Tensor,
                               page_table: torch.Tensor,
                               lengths: torch.Tensor, *,
                               tokens_per_page: int, latent_dim: int,
                               scale: float) -> torch.Tensor:
    """One-token absorbed-MLA decode through the page table.

    q [B,1,H,r+rp] = [q_latent | q_rope]; pool [n_pages, page_elems] flat,
    token rows ``[r + rp]``.  Returns the latent context [B,1,H,r].
    bf16 takes the split-KV tensor-core kernel (``mla_split_plan``),
    float32 the f32 split-KV body with one kv head for all H heads; both
    take the widths in ``MLA_WIDTHS``.
    """
    B, _, H, e = q.shape
    if build.plain_route(q):
        n_pages = pool.shape[0]
        typed = pool[:, :tokens_per_page * e].reshape(
            n_pages, tokens_per_page, e)
        return ref.paged_mla_decode_attention(q, typed, page_table, lengths,
                                              latent_dim, scale)
    if q.device.type != "cuda":
        raise ValueError(f"no paged attention kernel for {q.device}")
    _check_launch_inputs(q, pool, page_table, lengths, e, tokens_per_page)
    rope_dim, max_pages = e - latent_dim, page_table.shape[1]
    max_tokens = max_pages * tokens_per_page
    sm = _sm_count(q.device.index)
    if q.dtype == torch.bfloat16:
        check_mla_geometry(latent_dim, rope_dim)
        plan = MLA_ROWS, mla_split_plan(B, H, max_tokens, sm)[1]
    else:
        check_f32_geometry(H, 1, e, latent_dim)
        plan = split_plan(B, H, 1, max_tokens, sm, q.dtype)
    _check_pages(pool)
    build.refuse_grad("paged_mla_decode_attention", q, pool)
    out = _split_launch(load_library().paged_mla_decode, q,
                        (pool, page_table.to(torch.int32).contiguous()),
                        lengths, (latent_dim, rope_dim), plan, max_tokens,
                        (max_pages, tokens_per_page, pool.shape[1]), scale,
                        latent_dim)
    paged_mla_decode_attention.launches += 1
    return out


paged_mla_decode_attention.launches = 0


@build.recorded
def contiguous_decode_attention(q: torch.Tensor, cache_k: torch.Tensor,
                                cache_v: torch.Tensor, lengths: torch.Tensor,
                                *, scale: float, return_lse: bool = False):
    """One-token GQA decode over a contiguous cache.

    q [B,1,H,D]; cache_k / cache_v [B,T,KV,D] (one dense-cache layer);
    lengths [B] valid tokens (clamped to T).  Returns [B,1,H,D] in q's
    dtype; with ``return_lse``, (that, lse [B,H] float32): each row's
    log-sum-exp of its scaled scores, -inf for a row of length 0 (the
    sequence-sharded decode combines the slices of a split cache by it).
    Each call counts in ``launches``, and one with ``return_lse`` in
    ``lse_launches`` too.
    """
    if build.plain_route(q):
        return ref.decode_attention(q, cache_k, cache_v, lengths, scale,
                                    return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"no decode attention kernel for {q.device}")
    B, _, H, D = q.shape
    T, KV = cache_k.shape[1], cache_k.shape[2]
    _check_gqa(q, cache_k, KV)
    for name, t in (("cache_k", cache_k), ("cache_v", cache_v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError(f"{name} is {t.dtype} on {t.device}, q is "
                            f"{q.dtype} on {q.device}")
        if t.shape != (B, T, KV, D) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [B,T,KV,D] "
                             f"tensor, got {tuple(t.shape)}")
    if cache_v.data_ptr() % 16:
        raise ValueError("cache_v must start on 16 bytes (cp.async)")
    if lengths.shape != (B,) or lengths.device != q.device:
        raise ValueError("lengths must be [B] on q's device")
    build.refuse_grad("decode_attention", q, cache_k, cache_v)
    plan = split_plan(B, H, KV, T, _sm_count(q.device.index), q.dtype)
    lse = (torch.empty((B, H), dtype=torch.float32, device=q.device)
           if return_lse else None)
    out = _split_launch(load_library().contiguous_gqa_decode, q,
                        (cache_k, cache_v), lengths, (KV, D), plan, T, (T,),
                        scale, D, (lse,))
    contiguous_decode_attention.launches += 1
    if not return_lse:
        return out
    contiguous_decode_attention.lse_launches += 1
    return out, lse


contiguous_decode_attention.launches = 0
contiguous_decode_attention.lse_launches = 0
