"""Mamba2 SSD chunked scan: the CUDA kernels' binding and wrapper.

The kernels live in ``csrc/ssd_scan.cu`` (see the note there for what
they replace, their bound and their design): the forward (chunk states,
state passing and outputs, three launches behind one entry point) and
the backward (four launches behind one entry point: the chunk states
beside E_c = sum_t exp(La_t) dy_t ⊗ C_t, both state passes, one block per
source tile walking its target tiles, every product on tensor cores in
3xTF32, and the ordered sums), built at first use by
``repro_torch.kernels.build``.  On a CUDA tensor ``ssd_scan`` launches
them or raises; under grad mode it goes through ``_SSDScan``, a
``torch.autograd.Function`` whose backward is ``ssd_scan_bwd``.  Only a
tensor that lies on the CPU (or on ``meta``: shapes only,
``build.plain_route``) takes the plain PyTorch version, the chunked
form the reference's XLA route runs
(``repro_torch.kernels.ssd_chunked.ssd_scan_chunked``, differentiated by
autograd).  Launches are counted in ``ssd_scan.launches`` and
``ssd_scan_bwd.launches``, one per call.

The backward keeps nothing of the forward but its inputs: it recomputes
La, the decays and the states at the chunks' starts, so a layer holds no
bytes for it beyond x, dt, A, B, C and h0.  ``bwd_plan``, ``bwd_work``
and ``bwd_regions`` mirror on the host how the backward is launched
(grids, shared memory, the tile pairs in launch order, the workspace's
regions) for the tests; the wrappers never call them, and
``kernel_bwd_plan`` reads the library's own report.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import DTYPE_CODES, launch
from repro_torch.kernels.ssd_chunked import (ssd_scan_chunked,
                                             ssd_scan_chunked_bwd)

SOURCE = build.CSRC / "ssd_scan.cu"
#: ``csrc/ssd_scan.cu``'s constants: threads a block, the shared memory
#: the launcher holds a block to, positions a backward tile, <dS, h>
#: partials a chunk, kernel C's U region (dS, h or the two 64 x 64
#: weighted score tiles) and its row and column sums (floats)
THREADS, SMEM_LIMIT = 256, 220 * 1024
BWD_ROWS, HDOT_PARTS = 64, 32
BWD_U_FLOATS, BWD_RED_FLOATS = 8192, 11 * 64
#: the tensor-core product every product of kernels A and C takes (m, n,
#: k): mma.sync.m16n8k8 in TF32, an f32 operand as big + small halves
BWD_MMA = (16, 8, 8)
BWD_LAUNCHES = ("chunk states and E", "state passes", "tile pairs",
                "ordered sums")
BWD_REGIONS = ("La", "decays", "chunk states, then dS", "E",
               "states at chunk starts", "<dS, h> by slice", "direct ddt",
               "dt Q by source tile", "dLa by tile pair", "dB by head",
               "dC by tile pair")


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel, with typed entry points."""
    lib = build.load(SOURCE.name)
    lib.ssd_chunked_scan.argtypes = ([ctypes.c_void_p] * 9
                                     + [ctypes.c_int] * 8
                                     + [ctypes.c_void_p])
    lib.ssd_chunked_scan.restype = ctypes.c_int
    lib.ssd_chunked_scan_bwd.argtypes = ([ctypes.c_void_p] * 15
                                         + [ctypes.c_int] * 8
                                         + [ctypes.c_void_p])
    lib.ssd_chunked_scan_bwd.restype = ctypes.c_int
    lib.ssd_scan_supported.argtypes = [ctypes.c_int] * 3
    lib.ssd_scan_supported.restype = ctypes.c_int
    lib.ssd_scan_bwd_plan.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.ssd_scan_bwd_plan.restype = ctypes.c_int
    for name in ("ssd_scan_workspace", "ssd_scan_bwd_workspace"):
        getattr(lib, name).argtypes = [ctypes.c_int] * 6
        getattr(lib, name).restype = ctypes.c_longlong
    return lib


def _round4(v: int) -> int:
    return (v + 3) & ~3


def _pad16(v: int) -> int:
    return 16 if v < 16 else v


def bw_width(w: int) -> int:
    """A backward tile's width for ``w`` columns: at least 32 (the f32
    swizzle's span)."""
    return max(32, w)


def state_smem_bytes(P, N, L, psplit, elem) -> int:
    """Kernel 1's shared memory (``state_smem_bytes``)."""
    psp, np_ = _pad16(P // psplit), _pad16(N)
    pad = 0 if elem == 2 else 4
    stages = 4 if elem == 2 else 2
    tiles = stages * 64 * (psp + np_ + 2 * pad) + (2 * 64 * psp
                                                   if elem == 2 else 0)
    return 4 * 2 * _round4(L) + elem * tiles


def out_smem_bytes(P, N, L, elem) -> int:
    """Kernel 3's shared memory (``out_smem_bytes``)."""
    pp, np_ = _pad16(P), _pad16(N)
    ldn, ldp = (np_, pp) if elem == 2 else (np_ + 4, pp + 4)
    src = 64 * (ldn + ldp)
    h = 2 * pp * np_ if elem == 2 else pp * ldn
    scores = 0 if elem == 2 else 4 * 64 * (64 + 4)
    return (2 * 4 * _round4(L)
            + elem * (64 * ldn + src + (src if elem == 2 and src > h else h))
            + scores)


def pair_floats(P, N, L, stages) -> int:
    """Kernel C's shared memory (floats): the source tiles, ``stages``
    target buffers (dy and C), U, La and the row / column sums."""
    return (BWD_ROWS * (bw_width(P) + bw_width(N)) * (1 + stages)
            + BWD_U_FLOATS + _round4(L) + BWD_RED_FLOATS)


def pair_stages(P, N, L, elem) -> int:
    """Kernel C's target buffers: two for f32 where they fit, else one."""
    return 2 if elem == 4 and 4 * pair_floats(P, N, L, 2) <= SMEM_LIMIT \
        else 1


def supported(P, N, L) -> bool:
    """``ssd_scan_supported``: the shapes the kernels take."""
    if P <= 0 or N <= 0 or L <= 0:
        return False
    if THREADS % P or THREADS % N or P > 128 or P * N > THREADS * 32:
        return False
    return (all(state_smem_bytes(P, N, L, 1, e) <= SMEM_LIMIT
                and out_smem_bytes(P, N, L, e) <= SMEM_LIMIT
                for e in (4, 2))
            and 4 * state_bwd_floats(P, N, L) <= SMEM_LIMIT
            and 4 * pair_floats(P, N, L, 1) <= SMEM_LIMIT)


def state_bwd_floats(P, N, L) -> int:
    """Kernel A's shared memory (floats): its two tiles, La, weights."""
    return BWD_ROWS * (bw_width(P) + bw_width(N)) + 2 * _round4(L)


def bwd_regions(batch, seq, heads, P, N, L) -> List[Tuple[str, int]]:
    """The backward's workspace regions (name, floats), in order, each
    rounded to 16 bytes (``bwd_regions``)."""
    bhs, nc = batch * heads, seq // L
    nt = -(-L // BWD_ROWS)
    tr, pairs = min(L, BWD_ROWS), nt * (nt + 1) // 2
    sizes = (bhs * seq, bhs * nc, bhs * nc * P * N, bhs * nc * P * N,
             bhs * nc * P * N, bhs * nc * HDOT_PARTS, bhs * seq,
             bhs * nc * nt, bhs * nc * pairs * tr, bhs * seq * N,
             bhs * nc * pairs * tr * N)
    return [(name, _round4(s)) for name, s in zip(BWD_REGIONS, sizes)]


def bwd_workspace(batch, seq, heads, P, N, L) -> int:
    """``ssd_scan_bwd_workspace``: the regions' floats."""
    return sum(s for _, s in bwd_regions(batch, seq, heads, P, N, L))


def bwd_plan(batch, seq, heads, P, G, N, L, dtype: torch.dtype) -> Dict:
    """How ``ssd_chunked_scan_bwd`` launches at these shapes: the
    launcher's arithmetic in ``csrc/ssd_scan.cu`` (``bwd_plan``),
    mirrored.  ``launches``: name, grid, threads, dynamic shared bytes of
    each of the four; ``widths``: kernels A and C's tile widths (P and N
    padded); kernel C's ``target_tiles`` a chunk, ``partial_rows`` of a
    tile pair's partials, ``stages`` (target buffers), ``slices`` (kernel
    B's blocks a head x batch row), ``mma`` and the TF32 ``passes`` of
    each product of kernels A and C (3 for two f32 operands, 2 for an f32
    weighted score or state against a bf16 tile, 1 for two bf16 tiles).
    ``kernel_bwd_plan`` reads the same from the built library."""
    if dtype not in DTYPE_CODES:
        raise TypeError(f"the kernels take float32 or bfloat16, not {dtype}")
    if not supported(P, N, L) or seq % L or heads % G:
        raise ValueError(f"no SSD backward plan for P={P} N={N} chunk {L} "
                         f"S={seq} H={heads} G={G}")
    elem = torch.empty((), dtype=dtype).element_size()
    nc, bhs = seq // L, batch * heads
    nt = -(-L // BWD_ROWS)
    stages = pair_stages(P, N, L, elem)
    slices = -(-P * N // THREADS)
    sums = -(-batch * seq * G * N // (THREADS * (1 if N % 4 else 4)))
    f32 = elem == 4
    return dict(
        launches=[
            dict(name=BWD_LAUNCHES[0], grid=(2 * nc, heads, batch),
                 threads=THREADS, smem_bytes=4 * state_bwd_floats(P, N, L)),
            dict(name=BWD_LAUNCHES[1], grid=(slices, bhs, 1),
                 threads=THREADS, smem_bytes=0),
            dict(name=BWD_LAUNCHES[2], grid=(nt * nc * bhs, 1, 1),
                 threads=THREADS,
                 smem_bytes=4 * pair_floats(P, N, L, stages)),
            dict(name=BWD_LAUNCHES[3], grid=(heads + sums, 1, 1),
                 threads=THREADS, smem_bytes=0)],
        widths=(bw_width(P), bw_width(N)), target_tiles=nt,
        partial_rows=min(L, BWD_ROWS), stages=stages, slices=slices,
        mma=BWD_MMA,
        passes={"C.B": 3 if f32 else 1, "dy.x": 3 if f32 else 1,
                "M1.dy": 3 if f32 else 2, "M2.C": 3 if f32 else 2,
                "M2^T.B": 3 if f32 else 2, "state terms": 3 if f32 else 2,
                "S, E": 3 if f32 else 2},
        regions=bwd_regions(batch, seq, heads, P, N, L))


def bwd_work(L, nc, bhs) -> List[Tuple[int, int, int, int]]:
    """Kernel C's tile pairs (head x batch row, chunk, source tile,
    target tile) in launch order: block ``i`` takes source tile ``i //
    (nc bhs)`` of chunk ``i % nc`` of row ``(i // nc) % bhs`` and walks its
    target tiles from the diagonal on."""
    nt = -(-L // BWD_ROWS)
    out = []
    for i in range(nt * nc * bhs):
        si, rem = divmod(i, nc * bhs)
        bh, c = divmod(rem, nc)
        out += [(bh, c, si, tj) for tj in range(si, nt)]
    return out


def kernel_bwd_plan(batch, seq, heads, P, G, N, L, dtype: torch.dtype
                    ) -> Dict:
    """The plan the built library reports (``ssd_scan_bwd_plan``) in
    ``bwd_plan``'s keys (launches, widths, target_tiles, partial_rows,
    stages, slices, regions), which ``bwd_plan`` must match."""
    out = (ctypes.c_longlong * (26 + len(BWD_REGIONS)))()
    if load_library().ssd_scan_bwd_plan(batch, seq, heads, P, G, N, L,
                                        DTYPE_CODES[dtype], out):
        raise ValueError(f"no SSD backward plan for P={P} N={N} chunk {L}")
    v = list(out)
    launches = [dict(name=name, grid=tuple(v[5 * i:5 * i + 3]),
                     threads=v[5 * i + 3], smem_bytes=v[5 * i + 4])
                for i, name in enumerate(BWD_LAUNCHES)]
    return dict(launches=launches, widths=(v[20], v[21]),
                target_tiles=v[22], partial_rows=v[23], stages=v[24],
                slices=v[25],
                regions=list(zip(BWD_REGIONS, v[26:])))


def _checked(x, dt, A, B_, C_, h0, chunk, **more) -> ctypes.CDLL:
    """Raise on what the kernels do not take; ``more``: further f32 or
    x-typed operands by name, (tensor, shape, dtype).  Returns the
    library."""
    if x.device.type != "cuda":
        raise ValueError(f"no SSD scan kernel for {x.device}")
    Bb, S, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {x.dtype}")
    if S % chunk or H % G:
        raise ValueError(f"needs chunk | S and G | H (S={S}, chunk={chunk}, "
                         f"H={H}, G={G})")
    f32 = torch.float32
    operands = [("x", x, (Bb, S, H, P), x.dtype), ("dt", dt, (Bb, S, H), f32),
                ("A", A, (H,), f32), ("B_", B_, (Bb, S, G, N), x.dtype),
                ("C_", C_, (Bb, S, G, N), x.dtype),
                ("h0", h0, (Bb, H, P, N), f32)]
    operands += [(name, *spec) for name, spec in more.items()]
    for name, t, shape, dtype in operands:
        if t is None:
            continue
        if t.dtype != dtype or t.device != x.device:
            raise TypeError(f"{name} must be {dtype} on {x.device}, got "
                            f"{t.dtype} on {t.device}")
        if t.shape != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape} tensor, "
                             f"got {tuple(t.shape)}")
    lib = load_library()
    if not lib.ssd_scan_supported(P, N, chunk):
        raise ValueError(f"SSD kernel does not take head_dim {P}, state {N},"
                         f" chunk {chunk}")
    return lib


def _forward(x, dt, A, B_, C_, h0, chunk):
    """One launch of the forward kernels."""
    lib = _checked(x, dt, A, B_, C_, h0, chunk)
    Bb, S, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    y = torch.empty_like(x)
    h_out = torch.empty((Bb, H, P, N), dtype=torch.float32, device=x.device)
    # La, the chunks' decays and their states: the three kernels' scratch
    work = torch.empty(lib.ssd_scan_workspace(Bb, S, H, P, N, chunk),
                       dtype=torch.float32, device=x.device)
    launch(lib.ssd_chunked_scan, x.device, x, dt, A, B_, C_, h0, y, h_out,
           work, Bb, S, H, P, G, N, chunk, DTYPE_CODES[x.dtype])
    ssd_scan.launches += 1
    return y, h_out


class _SSDScan(torch.autograd.Function):
    """The SSD scan on the card, differentiable: the forward kernels, and
    the backward kernels on the saved inputs."""

    @staticmethod
    def forward(ctx, x, dt, A, B_, C_, h0, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, B_, C_, h0)
        ctx.chunk = chunk
        return _forward(x, dt, A, B_, C_, h0, chunk)

    @staticmethod
    def backward(ctx, dy, dh):
        x, dt, A, B_, C_, h0 = ctx.saved_tensors
        if dy is None:                   # only h_final reaches the loss
            dy = torch.zeros_like(x)
        dx, ddt, dA, dB, dC, dh0 = ssd_scan_bwd(x, dt, A, B_, C_, h0, dy, dh,
                                                chunk=ctx.chunk)
        return dx, ddt, dA, dB, dC, (None if h0 is None else dh0), None


@build.recorded
def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B_: torch.Tensor, C_: torch.Tensor, *, chunk: int = 64,
             h0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same contract as ``ref.ssd_scan``: x [B,S,H,P]; dt [B,S,H] f32;
    A [H] f32; B_/C_ [B,S,G,N] in x's dtype; h0 [B,H,P,N] f32 or None;
    S divisible by ``chunk``.  Returns (y [B,S,H,P], h_final f32),
    differentiable in every input on either device."""
    if build.plain_route(x):
        return ssd_scan_chunked(x, dt, A, B_, C_, chunk=chunk, h0=h0)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, dt, A, B_, C_, h0)):
        return _SSDScan.apply(x, dt, A, B_, C_, h0, chunk)
    return _forward(x, dt, A, B_, C_, h0, chunk)


ssd_scan.launches = 0


@build.recorded
def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B_: torch.Tensor, C_: torch.Tensor,
                 h0: Optional[torch.Tensor], dy: torch.Tensor,
                 dh: Optional[torch.Tensor], *, chunk: int = 64
                 ) -> Tuple[torch.Tensor, ...]:
    """The SSD scan's backward at ``ssd_scan``'s inputs: dy is y's
    gradient, dh h_final's (None: none reaches it).  Returns (dx, ddt, dA,
    dB, dC, dh0) as ``ssd_chunked.ssd_scan_chunked_bwd``: dx, dB, dC in
    x's dtype, ddt, dA, dh0 f32 (dh0 also for h0 None).  A CPU tensor
    takes that plain version; on the card the kernels' sums run in a
    fixed order, so two calls give the same bits."""
    if build.plain_route(x):
        return ssd_scan_chunked_bwd(x, dt, A, B_, C_, h0, dy, dh,
                                    chunk=chunk)
    # the gradients of a reshape or a sum may come in strided
    dy = dy.contiguous()
    dh = None if dh is None else dh.contiguous()
    Bb, S, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    lib = _checked(x, dt, A, B_, C_, h0, chunk,
                   dy=(dy, x.shape, x.dtype),
                   dh=(dh, (Bb, H, P, N), torch.float32))
    dx, dB, dC = (torch.empty_like(t) for t in (x, B_, C_))
    ddt, dA = torch.empty_like(dt), torch.empty_like(A)
    dh0 = torch.empty((Bb, H, P, N), dtype=torch.float32, device=x.device)
    work = torch.empty(lib.ssd_scan_bwd_workspace(Bb, S, H, P, N, chunk),
                       dtype=torch.float32, device=x.device)
    launch(lib.ssd_chunked_scan_bwd, x.device, x, dt, A, B_, C_, h0, dy, dh,
           dx, ddt, dA, dB, dC, dh0, work, Bb, S, H, P, G, N, chunk,
           DTYPE_CODES[x.dtype])
    ssd_scan_bwd.launches += 1
    return dx, ddt, dA, dB, dC, dh0


ssd_scan_bwd.launches = 0
