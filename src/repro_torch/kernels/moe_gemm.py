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
PyTorch version (``repro_torch.kernels.ref``), backward included.
Launches of the one GEMM kernel are counted in ``moe_gemm.launches``
(forward and input gradient alike), of the wgrad kernel in
``moe_gemm_wgrad.launches``.
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
    return lib


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


def moe_gemm_wgrad(x: torch.Tensor, dy: torch.Tensor,
                   group_sizes: torch.Tensor) -> torch.Tensor:
    """The weight gradient of ``moe_gemm``: x [N,K], dy [N,M] ->
    dw [E,K,M] with ``dw[e] = x[rows of e]^T @ dy[rows of e]`` (f32 sums,
    x's dtype); an expert with no rows gets zeros.  float32 reduces each
    expert's rows in chunks (``wgrad_plan``) added in a fixed order, so
    two calls give the same bits; the kernel orders them through an int32
    flag per (expert, dw tile), zeroed here."""
    if x.device.type == "cpu":
        return ref.moe_gemm_wgrad(x, dy, group_sizes)
    if x.device.type != "cuda":
        raise ValueError(f"no grouped GEMM kernel for {x.device}")
    (N, K), M, E = x.shape, dy.shape[1], group_sizes.shape[0]
    _check((("x", x, (N, K)), ("dy", dy, (N, M))), x.dtype, x.device)
    if group_sizes.device != x.device or group_sizes.dim() != 1:
        raise ValueError(f"group_sizes must be [E] on {x.device}")
    dw = torch.empty((E, K, M), dtype=x.dtype, device=x.device)
    flags = (torch.zeros((E, wgrad_plan(N, K, M, E)[0]), dtype=torch.int32,
                         device=x.device)
             if x.dtype == torch.float32 else None)
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


def moe_gemm(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor
             ) -> torch.Tensor:
    """Token-sorted grouped matmul ``out[i] = x[i] @ w[expert_of(i)]``.

    x [N,K] sorted by expert; w [E,K,M]; group_sizes [E] int (on x's
    device) -> [N,M] in x's dtype, summed in f32.  Rows past
    ``sum(group_sizes)`` are 0.  Differentiable in x and w.
    """
    return _GroupedGemm.apply(x, w, group_sizes)


moe_gemm.launches = 0
