"""Build and load the hand-written CUDA kernels of ``csrc/``.

Every ``csrc/*.cu`` file is compiled on its own with ``nvcc`` into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), named by the hash of its source, the ``csrc/*.cuh``
headers it includes and the flags, and kept in
``build/`` at the root of the checkout; the compiler's ``-Xptxas -v``
report (registers, shared memory and spills per kernel) is kept beside
it as ``<library>.log``.  ``load`` opens a library with ``ctypes``;
``build_all`` compiles every source at once, one ``nvcc`` process each;
``launch`` calls an entry point on the current stream; ``refuse_grad``
guards the kernels that have no backward.  Nothing here runs without a
card: a kernel is built at its first launch.

``plain_route`` is the one rule every wrapper routes by: a tensor on the
CPU takes the plain PyTorch version, and so does a ``meta`` tensor
(shapes only: the op analysis, ``launch/op_analysis.py``, counts a step
there and nothing computes); a CUDA tensor launches the kernel or
raises.  ``recorded`` wraps each wrapper for the graph audit
(``analysis/graph_audit.py``): inside ``recording(recorder)`` the
recorder sees every call, on both routes, with its tensor arguments;
there is none unless an audit runs.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
#: Build outputs go to ``build/`` at the root of the checkout.
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
#: dtype codes of the C entry points (the kernels take f32 or bf16).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: ``--split-compile=0`` optimizes a source's kernels on every core
#: (``ssd_scan.cu``'s 40-odd template instances: ``build_all`` 79.4 ->
#: 37.2 s in ``chip_smoke.py``'s build on an H100 host of 8 cores)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile=0")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    return str(Path(home) / "bin" / "nvcc")


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path(source: Path, build_dir: Path = BUILD_DIR) -> Path:
    """Where ``source`` builds to: keyed by its content, the content of the
    ``csrc/`` headers it includes, and the flags."""
    text = Path(source).read_bytes()
    headers = re.findall(rb'^#include "([^"]+)"', text, re.MULTILINE)
    digest = hashlib.sha1(
        text + b"".join((CSRC / h.decode()).read_bytes() for h in headers)
        + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return Path(build_dir) / f"lib{Path(source).stem}-{digest}.so"


def _require_card() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("the hand-written kernels need a CUDA card; pass "
                           "CPU tensors to use the plain versions")


def _start(source: Path, build_dir: Path):
    """(library path, None if it is built already, else (tmp path, the
    running nvcc process)); nvcc writes its report to ``<library>.log``."""
    lib = library_path(source, build_dir)
    if lib.exists():
        return lib, None
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    with open(lib.with_suffix(".so.log"), "w") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    return lib, (tmp, proc)


def _finish(lib: Path, job) -> Path:
    if job is None:
        return lib
    tmp, proc = job
    if proc.wait() != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(proc.args)}\n"
                           f"{lib.with_suffix('.so.log').read_text()}")
    os.replace(tmp, lib)     # atomic: a concurrent build never loads half
    return lib


def build_library(source: Path, build_dir: Path = BUILD_DIR) -> Path:
    """Compile one source (once per content) and return the library's
    path.  Raises when there is no card or the build fails."""
    _require_card()
    return _finish(*_start(Path(source), build_dir))


def build_all(build_dir: Path = BUILD_DIR) -> Dict[str, Path]:
    """Compile every ``csrc/*.cu`` source, all ``nvcc`` processes started
    together; returns {source name: library path}."""
    _require_card()
    started = [(src.name, _start(src, build_dir)) for src in sources()]
    for _, (_, job) in started:          # every nvcc ends before any raises
        if job is not None:
            job[1].wait()
    return {name: _finish(lib, job) for name, (lib, job) in started}


def plain_route(t: torch.Tensor) -> bool:
    """Whether a wrapper given ``t`` takes its plain version: ``t`` on
    the CPU or on ``meta``.  Any device but these and ``cuda`` raises in
    the wrapper."""
    return t.device.type in ("cpu", "meta")


#: the recorder that sees every wrapper call (the graph audit's), or None
_recorder = None


@contextlib.contextmanager
def recording(recorder):
    """Inside the block every wrapper call runs inside
    ``recorder.kernel(name, args, kwargs)`` (a context manager)."""
    global _recorder
    _recorder = recorder
    try:
        yield recorder
    finally:
        _recorder = None


def recorded(fn):
    """A kernel wrapper that the recorder sees (the module docstring);
    with none it is ``fn`` behind one check."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if _recorder is None:
            return fn(*args, **kwargs)
        with _recorder.kernel(fn.__name__, args, kwargs):
            return fn(*args, **kwargs)
    return wrapper


def refuse_grad(name: str, *tensors) -> None:
    """Raise where a kernel that has no backward would be reached under
    grad mode with an input that requires grad: its output would carry no
    ``grad_fn`` and silently cut the graph."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward; call it under "
            f"torch.no_grad() or with inputs that do not require grad")


def launch(fn, device: torch.device, *args) -> None:
    """Call one C entry point on ``device``'s current stream (passed
    last); tensors go as their data pointers.  Raises if the launch
    failed."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a
                   for a in args], stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")


@functools.cache
def load(source_name: str) -> ctypes.CDLL:
    """Build (if needed) and open ``csrc/<source_name>``."""
    return ctypes.CDLL(str(build_library(CSRC / source_name)))
