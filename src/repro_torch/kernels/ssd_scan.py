"""Mamba2 SSD chunked scan: the CUDA kernels' binding and wrapper.

The kernels live in ``csrc/ssd_scan.cu`` (see the note there for what
they replace, their bound and their design: chunk states, state passing
and outputs, three launches behind one entry point), built at first use
by ``repro_torch.kernels.build``.  On a CUDA tensor ``ssd_scan`` launches
them or raises; only a tensor that lies on the CPU takes the plain PyTorch
version, the chunked form the reference's XLA route runs
(``repro_torch.kernels.ssd_chunked.ssd_scan_chunked``).  Launches are
counted in ``ssd_scan.launches``, one per call.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import DTYPE_CODES, launch
from repro_torch.kernels.ssd_chunked import ssd_scan_chunked

SOURCE = build.CSRC / "ssd_scan.cu"


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel, with typed entry points."""
    lib = build.load(SOURCE.name)
    lib.ssd_chunked_scan.argtypes = ([ctypes.c_void_p] * 9
                                     + [ctypes.c_int] * 8
                                     + [ctypes.c_void_p])
    lib.ssd_chunked_scan.restype = ctypes.c_int
    lib.ssd_scan_supported.argtypes = [ctypes.c_int] * 3
    lib.ssd_scan_supported.restype = ctypes.c_int
    lib.ssd_scan_workspace.argtypes = [ctypes.c_int] * 6
    lib.ssd_scan_workspace.restype = ctypes.c_longlong
    return lib


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B_: torch.Tensor, C_: torch.Tensor, *, chunk: int = 64,
             h0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same contract as ``ref.ssd_scan``: x [B,S,H,P]; dt [B,S,H] f32;
    A [H] f32; B_/C_ [B,S,G,N] in x's dtype; h0 [B,H,P,N] f32 or None;
    S divisible by ``chunk``.  Returns (y [B,S,H,P], h_final f32)."""
    if x.device.type == "cpu":
        return ssd_scan_chunked(x, dt, A, B_, C_, chunk=chunk, h0=h0)
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
    for name, t, shape, dtype in (
            ("x", x, (Bb, S, H, P), x.dtype), ("dt", dt, (Bb, S, H), f32),
            ("A", A, (H,), f32), ("B_", B_, (Bb, S, G, N), x.dtype),
            ("C_", C_, (Bb, S, G, N), x.dtype)) + (
            (("h0", h0, (Bb, H, P, N), f32),) if h0 is not None else ()):
        if t.dtype != dtype or t.device != x.device:
            raise TypeError(f"{name} must be {dtype} on {x.device}, got "
                            f"{t.dtype} on {t.device}")
        if t.shape != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape} tensor, "
                             f"got {tuple(t.shape)}")
    build.refuse_grad("ssd_scan", x, dt, A, B_, C_, h0)
    lib = load_library()
    if not lib.ssd_scan_supported(P, N, chunk):
        raise ValueError(f"SSD kernel does not take head_dim {P}, state {N},"
                         f" chunk {chunk}")
    y = torch.empty_like(x)
    h_out = torch.empty((Bb, H, P, N), dtype=f32, device=x.device)
    # La, the chunks' decays and their states: the three kernels' scratch
    work = torch.empty(lib.ssd_scan_workspace(Bb, S, H, P, N, chunk),
                       dtype=f32, device=x.device)
    launch(lib.ssd_chunked_scan, x.device, x, dt, A, B_, C_, h0, y, h_out,
           work, Bb, S, H, P, G, N, chunk, DTYPE_CODES[x.dtype])
    ssd_scan.launches += 1
    return y, h_out


ssd_scan.launches = 0
