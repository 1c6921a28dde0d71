"""Flash prefill attention: the CUDA kernel's binding, wrapper and plan.

The kernel lives in ``csrc/flash_attention.cu`` (see the note there for
what it replaces, its bound and its design), built at first use by
``repro_torch.kernels.build``.  On a CUDA tensor ``flash_attention``
launches it or raises; only a tensor that lies on the CPU (or on
``meta``: shapes only, ``build.plain_route``) takes the plain PyTorch
version (``repro_torch.kernels.ref.flash_attention``).  The body
follows the dtype:

* bfloat16 (``flash_prefill_bf16``): FlashAttention-3 shaped, bound by the
  tensor cores' 989 TFLOP/s: a producer warp feeds a ring of K / V tiles
  by TMA (tensor maps built on the host at each call), two consumer
  warpgroups of 64 query rows run S = Q K^T and O += P V on ``wgmma``
  with P kept in registers;
* float32 (``flash_prefill_f32``, which holds the card-vs-CPU checks at
  2e-5): FFMA only, bound by the 67 TFLOP/s FP32 peak: 32-row q tiles
  taken in mirrored pairs (a heavy tile and its light mirror a block, so
  every block does the same causal work), a ``cp.async`` ring of K / V
  rounds, four column warps a round with their own online softmax, merged
  in a fixed order (two calls give the same bits).

``flash_plan`` is the launch plan of each body (the launcher's own
constants, which ``flash_prefill_plan`` of the library reports).  Launches
(one per call, either body) are counted in ``flash_attention.launches``.
A float32 tensor that does not start on 16 bytes (the ``cp.async``
copies' unit) is copied to one that does before the launch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.build import DTYPE_CODES, launch

SOURCE = build.CSRC / "flash_attention.cu"
#: head dims each body is instantiated for (256: gemma3's global layers;
#: 8, the smoke configs' head dim, only in float32: wgmma's products take
#: 16 at least)
HEAD_DIMS = {torch.bfloat16: (16, 32, 64, 128, 256),
             torch.float32: (8, 16, 32, 64, 128, 256)}
#: shared memory one block may use on an H100 (227 KB)
SMEM_LIMIT = 232448
#: shared memory of one SM, of which resident blocks share 1 KB less each
SM_SMEM = 233472


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel, with typed entry points."""
    lib = build.load(SOURCE.name)
    for fn in (lib.flash_prefill_bf16, lib.flash_prefill_f32):
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.flash_prefill_plan.argtypes = [ctypes.c_int, ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_int)]
    lib.flash_prefill_plan.restype = ctypes.c_int
    return lib


#: the kernel body for each dtype: wgmma for bfloat16, FFMA for float32
ENTRIES = {torch.bfloat16: "flash_prefill_bf16",
           torch.float32: "flash_prefill_f32"}


def flash_plan(head_dim: int, dtype: torch.dtype) -> dict:
    """The launch plan of the ``dtype`` body at ``head_dim``, as its
    launcher computes it: ``rows`` of a q tile, ``key_tile`` (keys of a
    ring stage), ``stages``, ``warps``, ``smem_bytes`` (dynamic shared
    memory of a block) and ``blocks_per_sm`` (the residency the launch
    bounds ask for); bfloat16 adds the wgmma and TMA shapes, float32 the
    thread tiles."""
    D = head_dim
    if D not in HEAD_DIMS.get(dtype, ()):
        raise ValueError(f"no flash body for head dim {D} in {dtype}")
    if dtype == torch.bfloat16:
        key_tile = 64 if D == 256 else 128
        stages = 2 if D >= 128 else 3
        box_cols = min(D, 64)
        return dict(
            rows=128, key_tile=key_tile, stages=stages, warps=8,
            smem_bytes=(1024 + 128 * D * 2 + 2 * stages * key_tile * D * 2
                        + 8 * (1 + 4 * stages)),
            blocks_per_sm=1, consumer_warpgroups=2, wgmma_m=64, wgmma_k=16,
            qk_n=key_tile, pv_n=D, box_cols=box_cols,
            swizzle_bytes=2 * box_cols, thread_regs=255)
    warp_keys = 16 if D <= 128 else 8
    key_tile = 4 * warp_keys
    blocks = 2 if D <= 64 else 1
    merge = 4 * 32 * (D + 6)

    def smem(stages):
        ring = stages * key_tile * (2 * D + 4)
        return 4 * (32 * (D + 4) + max(ring, merge) + 8 * 16 * warp_keys)

    # three stages where they fit at the residency asked for, else two
    stages = 3 if blocks * (smem(3) + 1024) <= SM_SMEM else 2
    return dict(rows=32, key_tile=key_tile, stages=stages, warps=8,
                smem_bytes=smem(stages), blocks_per_sm=blocks,
                q_tiles_per_block=2, row_warps=2, column_warps=4,
                warp_keys=warp_keys, thread_rows=4,
                thread_keys=warp_keys // 8, thread_cols=D // 8)


def kernel_plan(head_dim: int, dtype: torch.dtype) -> dict:
    """The plan the built library reports for the same body (rows,
    key_tile, stages, warps, smem_bytes): ``flash_plan`` must agree."""
    out = (ctypes.c_int * 5)()
    if load_library().flash_prefill_plan(DTYPE_CODES[dtype], head_dim,
                                         out):
        raise ValueError(f"the library has no flash body for head dim "
                         f"{head_dim} in {dtype}")
    return dict(zip(("rows", "key_tile", "stages", "warps", "smem_bytes"),
                    out))


@build.recorded
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float) -> torch.Tensor:
    """Causal GQA attention with the prefix offset ``T - S``.

    q [B,S,H,D]; k/v [B,T,KV,D] with T >= S -> [B,S,H,D] in q's dtype.
    """
    if build.plain_route(q):
        return ref.flash_attention(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention kernel for {q.device}")
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    if q.dtype not in ENTRIES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    if D not in HEAD_DIMS[q.dtype]:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS[q.dtype]} for "
                         f"{q.dtype}")
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
            raise ValueError(f"{name} must start on 16 bytes (TMA)")
    build.refuse_grad("flash_attention", q, k, v)
    if q.dtype == torch.float32:
        q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone()
                   for t in (q, k, v))
    out = torch.empty_like(q)
    launch(getattr(load_library(), ENTRIES[q.dtype]), q.device, q, k, v, out,
           B, S, T, H, KV, D, float(scale))
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
