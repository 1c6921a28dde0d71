"""Flash prefill attention: the CUDA kernel's binding and wrapper.

The kernel lives in ``csrc/flash_attention.cu`` (see the note there for
what it replaces, its bound and its design), built at first use by
``repro_torch.kernels.build``.  On a CUDA tensor ``flash_attention``
launches it or raises; only a tensor that lies on the CPU takes the plain
PyTorch version (``repro_torch.kernels.ref.flash_attention``).  Launches
are counted in ``flash_attention.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.build import DTYPE_CODES, launch

SOURCE = build.CSRC / "flash_attention.cu"
#: head dims the kernel is instantiated for
HEAD_DIMS = (16, 32, 64, 128)


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel, with a typed entry point."""
    lib = build.load(SOURCE.name)
    lib.flash_prefill.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                                  + [ctypes.c_float, ctypes.c_int,
                                     ctypes.c_void_p])
    lib.flash_prefill.restype = ctypes.c_int
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float) -> torch.Tensor:
    """Causal GQA attention with the prefix offset ``T - S``.

    q [B,S,H,D]; k/v [B,T,KV,D] with T >= S -> [B,S,H,D] in q's dtype.
    """
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention kernel for {q.device}")
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if T < S or H % KV:
        raise ValueError(f"needs T >= S and KV dividing H (S={S}, T={T}, "
                         f"H={H}, KV={KV})")
    for name, t, shape in (("q", q, (B, S, H, D)), ("k", k, (B, T, KV, D)),
                           ("v", v, (B, T, KV, D))):
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError(f"{name} is {t.dtype} on {t.device}, q is "
                            f"{q.dtype} on {q.device}")
        if t.shape != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape} tensor, "
                             f"got {tuple(t.shape)}")
    build.refuse_grad("flash_attention", q, k, v)
    out = torch.empty_like(q)
    launch(load_library().flash_prefill, q.device, q, k, v, out, B, S, T, H,
           KV, D, float(scale), DTYPE_CODES[q.dtype])
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
