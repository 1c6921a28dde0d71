"""Flash prefill attention: the CUDA kernel's binding and wrapper.

The kernel lives in ``csrc/flash_attention.cu`` (see the note there for
what it replaces, its bound and its design), built at first use by
``repro_torch.kernels.build``.  On a CUDA tensor ``flash_attention``
launches it or raises; only a tensor that lies on the CPU takes the plain
PyTorch version (``repro_torch.kernels.ref.flash_attention``).  The route
follows the dtype: bfloat16 runs the tensor-core body
(``flash_prefill_bf16``), float32 the CUDA-core body
(``flash_prefill_f32``, which holds the card-vs-CPU checks at 2e-5).
Launches (one per call, either route) are counted in
``flash_attention.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.build import launch

SOURCE = build.CSRC / "flash_attention.cu"
#: head dims the kernel is instantiated for
HEAD_DIMS = (16, 32, 64, 128)


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel, with a typed entry point."""
    lib = build.load(SOURCE.name)
    for fn in (lib.flash_prefill_bf16, lib.flash_prefill_f32):
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


#: the kernel body for each dtype: tensor cores for bfloat16, CUDA cores
#: for float32
ENTRIES = {torch.bfloat16: "flash_prefill_bf16",
           torch.float32: "flash_prefill_f32"}


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
    if q.dtype not in ENTRIES:
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
        if q.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"{name} must start on 16 bytes (cp.async)")
    build.refuse_grad("flash_attention", q, k, v)
    out = torch.empty_like(q)
    launch(getattr(load_library(), ENTRIES[q.dtype]), q.device, q, k, v, out,
           B, S, T, H, KV, D, float(scale))
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
