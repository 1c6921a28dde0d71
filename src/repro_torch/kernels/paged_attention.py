"""Paged decode attention: the CUDA kernels' build, binding and wrappers.

The kernels live in ``csrc/paged_attention.cu`` (see the note there for
what they replace, their bound and their design).  This module compiles
that file with ``nvcc`` into a shared library with a plain C interface on
first use, loads it with ``ctypes`` and wraps each entry point:

* ``paged_decode_attention``      -> ``paged_gqa_decode``
* ``paged_mla_decode_attention``  -> ``paged_mla_decode``

Both wrappers take the FLAT pool ``[n_pages, page_elems]`` and the page
geometry instead of a typed page view: the kernels compute every address
themselves, so no per-call copy of the pool is ever made.  On a CUDA
tensor a wrapper launches its kernel or raises; only a tensor that lies
on the CPU takes the plain PyTorch version (``repro_torch.kernels.ref``),
sliced to the typed view there.  Each wrapper counts its kernel launches
in its ``launches`` attribute.

Like the TPU kernels (``src/repro/kernels/paged_attention.py:183,284``)
the wrappers fold ``scale`` into q once and round it back to q's dtype
before the launch.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"
#: Build outputs go to ``build/`` at the root of the checkout.
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    return str(Path(home) / "bin" / "nvcc")


def build_library(build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``csrc/paged_attention.cu`` (once per source content) and
    return the shared library's path; the compiler's log (``-Xptxas -v``:
    registers, shared memory, spills per kernel) is kept beside it as
    ``<library>.log``.  Raises when there is no card or the build fails."""
    if not torch.cuda.is_available():
        raise RuntimeError("the paged attention kernels need a CUDA card; "
                           "pass CPU tensors to use the plain versions")
    src = SOURCE.read_bytes()
    digest = hashlib.sha1(src).hexdigest()[:12]
    lib = Path(build_dir) / f"libpaged_attention-{digest}.so"
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stdout}\n{proc.stderr}")
    lib.with_suffix(".so.log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)     # atomic: a concurrent build never loads half
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels, with typed entry points."""
    lib = ctypes.CDLL(str(build_library()))
    ptrs = [ctypes.c_void_p] * 5
    ints = [ctypes.c_int] * 6
    for fn in (lib.paged_gqa_decode, lib.paged_mla_decode):
        fn.argtypes = ptrs + ints + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check_launch_inputs(q, pool, page_table, lengths, per_tok: int,
                         tokens_per_page: int) -> None:
    if q.dtype not in _DTYPE_CODES:
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


def _launch(fn, q, pool, page_table, lengths, out, dims) -> None:
    table = page_table.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), pool.data_ptr(), table.data_ptr(),
                 lens.data_ptr(), out.data_ptr(), *dims,
                 _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")


def _scaled(q: torch.Tensor, scale: float) -> torch.Tensor:
    """Fold ``scale`` into q once and round back to q's dtype."""
    return (q.float() * scale).to(q.dtype).contiguous()


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
    if H % n_kv:
        raise ValueError(f"{H} query heads do not group over {n_kv} kv heads")
    _check_launch_inputs(q, pool, page_table, lengths, per_tok,
                         tokens_per_page)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(load_library().paged_gqa_decode, _scaled(q, scale), pool,
            page_table, lengths, out,
            (B, H, n_kv, D, page_table.shape[1], tokens_per_page,
             pool.shape[1]))
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
    out = torch.empty((B, 1, H, latent_dim), dtype=q.dtype, device=q.device)
    _launch(load_library().paged_mla_decode, _scaled(q, scale), pool,
            page_table, lengths, out,
            (B, H, latent_dim, e - latent_dim, page_table.shape[1],
             tokens_per_page, pool.shape[1]))
    paged_mla_decode_attention.launches += 1
    return out


paged_mla_decode_attention.launches = 0
