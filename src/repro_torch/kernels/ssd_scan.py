"""Mamba2 SSD chunked scan: the CUDA kernels' binding and wrapper.

The kernels live in ``csrc/ssd_scan.cu`` (see the note there for what
they replace, their bound and their design): the forward (chunk states,
state passing and outputs, three launches behind one entry point) and
the backward (the forward's states again, a reverse pass over the chunks,
the per-chunk gradients from the targets' and the sources' side and a
fixed-order reduction: six launches behind one entry point), built at
first use by ``repro_torch.kernels.build``.  On a CUDA tensor ``ssd_scan``
launches them or raises; under grad mode it goes through ``_SSDScan``, a
``torch.autograd.Function`` whose backward is ``ssd_scan_bwd``.  Only a
tensor that lies on the CPU takes the plain PyTorch version, the chunked
form the reference's XLA route runs
(``repro_torch.kernels.ssd_chunked.ssd_scan_chunked``, differentiated by
autograd).  Launches are counted in ``ssd_scan.launches`` and
``ssd_scan_bwd.launches``, one per call.

The backward keeps nothing of the forward but its inputs: it recomputes
La, the decays and the states at the chunks' starts (two of the
forward's kernels), so a layer holds no bytes for it beyond x, dt, A, B,
C and h0.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import DTYPE_CODES, launch
from repro_torch.kernels.ssd_chunked import (ssd_scan_chunked,
                                             ssd_scan_chunked_bwd)

SOURCE = build.CSRC / "ssd_scan.cu"


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
    for name in ("ssd_scan_workspace", "ssd_scan_bwd_workspace"):
        getattr(lib, name).argtypes = [ctypes.c_int] * 6
        getattr(lib, name).restype = ctypes.c_longlong
    return lib


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


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B_: torch.Tensor, C_: torch.Tensor, *, chunk: int = 64,
             h0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same contract as ``ref.ssd_scan``: x [B,S,H,P]; dt [B,S,H] f32;
    A [H] f32; B_/C_ [B,S,G,N] in x's dtype; h0 [B,H,P,N] f32 or None;
    S divisible by ``chunk``.  Returns (y [B,S,H,P], h_final f32),
    differentiable in every input on either device."""
    if x.device.type == "cpu":
        return ssd_scan_chunked(x, dt, A, B_, C_, chunk=chunk, h0=h0)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, dt, A, B_, C_, h0)):
        return _SSDScan.apply(x, dt, A, B_, C_, h0, chunk)
    return _forward(x, dt, A, B_, C_, h0, chunk)


ssd_scan.launches = 0


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
    if x.device.type == "cpu":
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
