"""Grouped expert GEMM: the CUDA kernels' bindings, wrappers and autograd.

The kernels live in ``csrc/moe_gemm.cu`` (see the note there for what
they replace, their bound and their design), built at first use by
``repro_torch.kernels.build``:

* ``moe_gemm``        -> ``moe_gemm`` (the forward)
* ``moe_gemm_dgrad``  -> ``moe_gemm`` with the weight read transposed
  (the input gradient)
* ``moe_gemm_wgrad``  -> ``moe_gemm_wgrad`` (the weight gradient)

``moe_gemm`` is differentiable: a ``torch.autograd.Function`` whose
backward runs the same kernel with the weight read transposed for ``dx``
and the wgrad kernel for ``dw``.  On a CUDA tensor each wrapper launches
its kernel or raises; only a tensor that lies on the CPU takes the plain
PyTorch version (``repro_torch.kernels.ref``), backward included.  A
``meta`` tensor raises too: the plain version reads the group sizes on
the host, so it has no shape-only form.
Launches of the one GEMM kernel are counted in ``moe_gemm.launches``
(forward and input gradient alike), of the wgrad kernel in
``moe_gemm_wgrad.launches``.

bf16 runs one persistent ``wgmma`` body for all three (``gemm_plan``,
``gemm_route``, ``gemm_items`` and ``wgrad_items`` mirror its launch
plan, its route and its work lists for the tests; the wrappers never
call them); float32 keeps its CUDA-core bodies (``wgrad_plan``,
``wgrad_chunks``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Tuple

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.build import DTYPE_CODES, launch

SOURCE = build.CSRC / "moe_gemm.cu"
#: the float32 weight gradient's dw tile edge and the most rows one block
#: reduces (``csrc/moe_gemm.cu`` ``wg::kTile``, ``wg::kChunk``)
WGRAD_TILE = 128
WGRAD_CHUNK = 1024
#: the bf16 bodies (``csrc/moe_gemm.cu`` ``tc``): output rows of a tile
#: (two warpgroups of wgmma's 64), reduction depth of a ring stage,
#: warps, the TMA box's columns (128 bytes: the swizzle's span), and the
#: dynamic shared memory a block may take
GEMM_ROWS, GEMM_DEPTH, GEMM_WARPS, GEMM_BOX_COLS = 128, 64, 8, 64
SMEM_LIMIT = 232448
ROUTES = ("guarded", "tma")
#: the bf16 body's three uses (the C entry's op codes 0, 1, 2)
OPS = ("forward", "dgrad", "wgrad")


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels, with typed entry points."""
    lib = build.load(SOURCE.name)
    lib.moe_gemm.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                             + [ctypes.c_void_p])
    lib.moe_gemm.restype = ctypes.c_int
    lib.moe_gemm_wgrad.argtypes = ([ctypes.c_void_p] * 5
                                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.moe_gemm_wgrad.restype = ctypes.c_int
    lib.moe_gemm_route.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
    lib.moe_gemm_route.restype = ctypes.c_int
    lib.moe_gemm_plan.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.moe_gemm_plan.restype = ctypes.c_int
    return lib


def tile_edge(n: int) -> int:
    """A bf16 tile's width along ``n``: 256 where that pads ``n`` no more
    than 128 does, else 128 (1408: 11 tiles of 128, not 6 of 256)."""
    return 256 if -(-n // 256) * 256 == -(-n // 128) * 128 else 128


def tile_of(op: str, route: str, cols: int, kdim: int = 0
            ) -> Tuple[int, int]:
    """(rows, cols) of the bf16 body's output tile.  Forward and dgrad:
    128 rows (their rows are ragged), 256 columns wherever ``cols`` > 128
    (a wider tile reads fewer bytes from L2 a product).  Weight gradient:
    ``tile_edge`` of dw's columns and, where that is 128, of its rows
    (``kdim``).  At most 128 x 256 (128 f32 accumulators a thread);
    128 x 128 on the guarded route."""
    if op not in OPS:
        raise ValueError(f"op must be one of {OPS}, got {op!r}")
    if route == "guarded":
        return 128, 128
    if op != "wgrad":
        return 128, 256 if cols > 128 else 128
    bn = tile_edge(cols)
    return (tile_edge(kdim) if bn == 128 else 128), bn


def gemm_plan(dtype: torch.dtype, route: str, op: str, cols: int,
              experts: int, kdim: int = 0) -> dict:
    """The launch plan of the bf16 body for ``op`` (``OPS``) on ``route``
    at output width ``cols`` (the forward's M, the dgrad's K, dw's M),
    dw rows ``kdim`` (the weight gradient's K) and ``experts``: the
    launcher's constants in ``csrc/moe_gemm.cu``, mirrored.
    ``kernel_plan`` reads the same from the built library."""
    if dtype != torch.bfloat16:
        raise ValueError(f"no bf16 grouped GEMM plan for {dtype}")
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    bm, bn = tile_of(op, route, cols, kdim)
    stage = (bm + bn) * GEMM_DEPTH * 2
    stages = 2 if route == "guarded" else 5 if stage <= 32768 else 3
    table = 4 * (2 * experts + 4)
    smem = 1024 + stages * stage + bm * bn * 2 + 20 * stages + table
    if smem > SMEM_LIMIT:
        raise ValueError(f"no bf16 grouped GEMM plan for {experts} experts")
    # TMA boxes (rows; 64 columns each): A, B, the output's warpgroup half
    a_rows, b_rows = {"forward": (bm, GEMM_DEPTH), "dgrad": (bm, bn),
                      "wgrad": (GEMM_DEPTH, GEMM_DEPTH)}[op]
    return dict(rows=bm, cols=bn, depth=GEMM_DEPTH, stages=stages,
                warps=GEMM_WARPS,
                smem_bytes=smem,
                blocks_per_sm=1, consumer_warpgroups=2, wgmma_m=64,
                wgmma_n=bn, wgmma_k=16, warpgroup_rows=bm // 2,
                box_cols=GEMM_BOX_COLS, swizzle_bytes=128,
                stage_bytes=stage, out_bytes=bm * bn * 2,
                table_bytes=table,
                box_rows=(a_rows, b_rows, bm // 2))


def kernel_plan(op: str, route: str, cols: int, experts: int,
                kdim: int = 0) -> dict:
    """The plan the built library reports for the same bf16 body (rows,
    cols, depth, stages, warps, smem_bytes): ``gemm_plan`` must agree."""
    out = (ctypes.c_int * 6)()
    if load_library().moe_gemm_plan(OPS.index(op), ROUTES.index(route),
                                    max(kdim, 1), cols, experts, out):
        raise ValueError(f"no bf16 grouped GEMM plan for {op}, cols={cols}, "
                         f"experts={experts}")
    return dict(zip(("rows", "cols", "depth", "stages", "warps",
                     "smem_bytes"), out))


def gemm_route(dtype: torch.dtype, rows: int, k: int, m: int,
               *pointers: int) -> str:
    """The route a bf16 call takes: ``"tma"`` where there are rows, every
    row of k or m elements is a multiple of 16 bytes (the TMA's global
    strides) and every base pointer lies on a 16-byte boundary, else
    ``"guarded"`` (the element loader into the same layout).  ``k`` and
    ``m`` are x's and out's row lengths (the weight gradient's K and M).
    The launcher's rule, mirrored; ``kernel_route`` asks the library."""
    if dtype != torch.bfloat16:
        raise ValueError(f"no bf16 route for {dtype}")
    ok = rows > 0 and k % 8 == 0 and m % 8 == 0
    return "tma" if ok and all(p % 16 == 0 for p in pointers) else "guarded"


def kernel_route(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> str:
    """The route the built library takes for a bf16 call on these
    operands: a = x (or dy) [rows, k], b the weight (or dy), c the output
    whose rows (or dw's rows) hold m elements."""
    rows, k = a.shape
    m = c.shape[-1]
    return ROUTES[load_library().moe_gemm_route(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), rows, k, m)]


def gemm_items(group_sizes, rows: int, cols: int) -> List[Tuple[int, int,
                                                                 int, int]]:
    """The bf16 forward's (and input gradient's) work list as the blocks
    build it on the card, in item order: (group, first row, rows, first
    column) of every output tile.  Groups are the experts in order, then
    the rows past the groups (group E, written as 0); each group's rows
    are cut into 128-row tiles, and one column's row tiles run together.
    Block b takes items b, b + grid, ...  A host mirror for tests: the
    wrapper never calls it."""
    bn = tile_of("forward", "tma", cols)[1]
    sizes = [int(v) for v in group_sizes]
    sizes.append(max(rows - sum(sizes), 0))
    out, start = [], 0
    for g, n in enumerate(sizes):
        tiles = -(-n // GEMM_ROWS)
        for c in range(-(-cols // bn) if tiles else 0):
            for j in range(tiles):
                out.append((g, start + j * GEMM_ROWS,
                            min(GEMM_ROWS, n - j * GEMM_ROWS), c * bn))
        start += n
    return out


def wgrad_order(group_sizes) -> List[int]:
    """The experts in the order the bf16 weight gradient takes them:
    most rows first, ties by index."""
    sizes = [int(v) for v in group_sizes]
    return sorted(range(len(sizes)), key=lambda e: (-sizes[e], e))


def wgrad_items(group_sizes, k: int, m: int) -> List[Tuple[int, int, int,
                                                           int, int]]:
    """The bf16 weight gradient's work list (TMA route) in item order:
    (expert, first dw row, first dw column, first row, rows) of every dw
    tile (``tile_of``), the experts heaviest first (``wgrad_order``); an
    expert with no rows keeps its tiles, written as zeros.  Each block takes its own
    index first, then the next item of a counter the wrapper zeroes, so a
    block that finishes early takes the lighter tiles left.  A host
    mirror for tests: the wrapper never calls it."""
    bm, bn = tile_of("wgrad", "tma", m, k)
    sizes = [int(v) for v in group_sizes]
    starts = [sum(sizes[:e]) for e in range(len(sizes))]
    return [(e, kt * bm, mt * bn, starts[e], sizes[e])
            for e in wgrad_order(sizes)
            for kt in range(-(-k // bm))
            for mt in range(-(-m // bn))]


def _offsets(group_sizes: torch.Tensor) -> torch.Tensor:
    """[E] group sizes -> [E+1] int32 row offsets, on the device (the
    host never reads them)."""
    zero = torch.zeros(1, dtype=torch.int32, device=group_sizes.device)
    return torch.cat([zero, torch.cumsum(group_sizes, 0, dtype=torch.int32)])


def _check(tensors, dtype, device) -> None:
    if dtype not in DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {dtype}")
    for name, t, shape in tensors:
        if t.dtype != dtype or t.device != device:
            raise TypeError(f"{name} must be {dtype} on {device}, got "
                            f"{t.dtype} on {t.device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape} tensor, "
                             f"got {tuple(t.shape)}")


def _gemm(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
          transpose: bool) -> torch.Tensor:
    """x [N,K] @ w[e] (w [E,K,M]), or with ``transpose`` x [N,M] @ w[e]^T
    (w read through its strides, never copied), per expert segment ->
    [N,M] (or [N,K]) in x's dtype."""
    if x.device.type == "cpu":
        return ref.moe_gemm(x, w.transpose(1, 2) if transpose else w,
                            group_sizes)
    if x.device.type != "cuda":
        raise ValueError(f"no grouped GEMM kernel for {x.device}")
    E, K, M = w.shape
    k_in, m_out = (M, K) if transpose else (K, M)
    N = x.shape[0]
    _check((("x", x, (N, k_in)), ("w", w, (E, K, M))), x.dtype, x.device)
    if group_sizes.shape != (E,) or group_sizes.device != x.device:
        raise ValueError(f"group_sizes must be [{E}] on {x.device}")
    out = torch.empty((N, m_out), dtype=x.dtype, device=x.device)
    launch(load_library().moe_gemm, x.device, x, w, _offsets(group_sizes),
           out, N, k_in, m_out, E, int(transpose), DTYPE_CODES[x.dtype])
    moe_gemm.launches += 1
    return out


@build.recorded
def moe_gemm_dgrad(dy: torch.Tensor, w: torch.Tensor,
                   group_sizes: torch.Tensor) -> torch.Tensor:
    """The input gradient of ``moe_gemm``: dy [N,M], w [E,K,M] ->
    dx [N,K] with ``dx[i] = dy[i] @ w[expert_of(i)]^T``; the forward
    kernel reading w transposed, counted in ``moe_gemm.launches``."""
    return _gemm(dy, w, group_sizes, transpose=True)


def wgrad_plan(rows: int, k: int, m: int, experts: int) -> Tuple[int, int]:
    """(dw tiles, chunk slots) of a float32 weight-gradient launch, from
    the shapes alone: the grid's two axes.  Every expert's rows are cut
    into ``max(1, ceil(n_e / WGRAD_CHUNK))`` chunks, at most ``rows /
    WGRAD_CHUNK + experts`` in all; the host never reads the sizes."""
    tiles = -(-k // WGRAD_TILE) * -(-m // WGRAD_TILE)
    return tiles, -(-rows // WGRAD_CHUNK) + experts


def wgrad_chunks(group_sizes, chunk: int = WGRAD_CHUNK
                 ) -> List[Tuple[int, int, int, int]]:
    """The float32 weight gradient's work list as the kernel builds it on
    the card, in slot order: (expert, index within the expert, first row,
    rows) for every chunk; an empty expert keeps one chunk of no rows.  A
    host mirror for tests: the wrapper never calls it."""
    out, start = [], 0
    for e, n in enumerate(int(v) for v in group_sizes):
        for j in range(max(1, -(-n // chunk))):
            out.append((e, j, start + j * chunk, min(chunk, n - j * chunk)))
        start += n
    return out


def moe_gemm_wgrad_chunked(x: torch.Tensor, dy: torch.Tensor,
                           group_sizes, chunk: int = WGRAD_CHUNK
                           ) -> torch.Tensor:
    """The float32 weight gradient in the kernel's order, in plain
    PyTorch: each chunk of ``wgrad_chunks`` summed on its own, the chunks
    of an expert added into dw[e] one after another (chunk 0 stores).
    Sums in f32, returns x's dtype."""
    E, K, M = len(group_sizes), x.shape[1], dy.shape[1]
    dw = torch.empty((E, K, M), dtype=torch.float32, device=x.device)
    for e, j, row0, n in wgrad_chunks(group_sizes, chunk):
        part = x[row0:row0 + n].float().T @ dy[row0:row0 + n].float()
        dw[e] = part if j == 0 else dw[e] + part
    return dw.to(x.dtype)


@build.recorded
def moe_gemm_wgrad(x: torch.Tensor, dy: torch.Tensor,
                   group_sizes: torch.Tensor) -> torch.Tensor:
    """The weight gradient of ``moe_gemm``: x [N,K], dy [N,M] ->
    dw [E,K,M] with ``dw[e] = x[rows of e]^T @ dy[rows of e]`` (f32 sums,
    x's dtype); an expert with no rows gets zeros.  float32 reduces each
    expert's rows in chunks (``wgrad_plan``) added in a fixed order, so
    two calls give the same bits; the kernel orders them through an int32
    flag per (expert, dw tile), zeroed here.  bf16 sums each dw tile in
    one block (one f32 sum an output: the same bits every call); its
    blocks take the tiles heaviest expert first from an int32 counter,
    zeroed here (``wgrad_items``)."""
    if x.device.type == "cpu":
        return ref.moe_gemm_wgrad(x, dy, group_sizes)
    if x.device.type != "cuda":
        raise ValueError(f"no grouped GEMM kernel for {x.device}")
    (N, K), M, E = x.shape, dy.shape[1], group_sizes.shape[0]
    _check((("x", x, (N, K)), ("dy", dy, (N, M))), x.dtype, x.device)
    if group_sizes.device != x.device or group_sizes.dim() != 1:
        raise ValueError(f"group_sizes must be [E] on {x.device}")
    dw = torch.empty((E, K, M), dtype=x.dtype, device=x.device)
    # float32: a flag per (expert, dw tile); bf16: the work list's
    # counter; zeros on the card (no host read)
    flags = torch.zeros((E, wgrad_plan(N, K, M, E)[0])
                        if x.dtype == torch.float32 else (1,),
                        dtype=torch.int32, device=x.device)
    launch(load_library().moe_gemm_wgrad, x.device, x, dy,
           _offsets(group_sizes), dw, flags, N, K, M, E,
           DTYPE_CODES[x.dtype])
    moe_gemm_wgrad.launches += 1
    return dw


moe_gemm_wgrad.launches = 0


class _GroupedGemm(torch.autograd.Function):
    """out = moe_gemm(x, w); dx by the same kernel reading w transposed,
    dw by the wgrad kernel."""

    @staticmethod
    def forward(ctx, x, w, group_sizes):
        ctx.save_for_backward(x, w, group_sizes)
        return _gemm(x, w, group_sizes, transpose=False)

    @staticmethod
    def backward(ctx, dy):
        x, w, group_sizes = ctx.saved_tensors
        dy = dy.contiguous()
        dx = (moe_gemm_dgrad(dy, w, group_sizes)
              if ctx.needs_input_grad[0] else None)
        dw = (moe_gemm_wgrad(x, dy, group_sizes)
              if ctx.needs_input_grad[1] else None)
        return dx, dw, None


@build.recorded
def moe_gemm(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor
             ) -> torch.Tensor:
    """Token-sorted grouped matmul ``out[i] = x[i] @ w[expert_of(i)]``.

    x [N,K] sorted by expert; w [E,K,M]; group_sizes [E] int (on x's
    device) -> [N,M] in x's dtype, summed in f32.  Rows past
    ``sum(group_sizes)`` are 0.  Differentiable in x and w.
    """
    return _GroupedGemm.apply(x, w, group_sizes)


moe_gemm.launches = 0
