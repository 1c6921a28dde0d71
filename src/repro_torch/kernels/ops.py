"""The kernel layer's public entry points.

The route is chosen by where the tensors live, not by a setting: a CPU
tensor takes the plain PyTorch version, a CUDA tensor launches the
hand-written kernel or raises (there is no fallback between the two); a
``meta`` tensor (shapes only, the op analysis) takes the plain version
where it has a shape-only form (``build.plain_route``).

* ``paged_decode_attention`` / ``paged_mla_decode_attention`` — the CUDA
  kernels of ``csrc/paged_attention.cu`` through their ctypes wrappers
  (``repro_torch.kernels.paged_attention``);
* ``decode_attention`` — one-token GQA decode over a contiguous cache
  (the fallback families' dense cache), the contiguous kernel of the same
  file; with ``return_lse`` it also returns each row's log-sum-exp (the
  sequence-sharded decode's local body, ``sharding/seq_attention.py``);
* ``flash_attention`` — causal GQA prefill (``csrc/flash_attention.cu``);
* ``ssd_scan`` — the Mamba2 SSD chunked scan (``csrc/ssd_scan.cu``); its
  CPU version is the chunked form the reference's XLA route runs; it is
  differentiable, its backward runs ``ssd_scan_bwd`` (the backward kernels
  of the same file; their CPU version is autograd of the chunked form);
* ``moe_gemm`` / ``moe_gemm_dgrad`` / ``moe_gemm_wgrad`` — the
  token-sorted grouped expert GEMM of the grouped MoE path and its input
  and weight gradients (``csrc/moe_gemm.cu``); ``moe_gemm`` is
  differentiable, its backward runs the other two;
* ``paged_kv_write`` — the pool write, the row scatter of
  ``csrc/kv_write.cu`` (not a TPU kernel: the reference's is an XLA
  scatter); it drops rows whose page id is below 0 on the card itself,
  so it makes no host read.

Each kernel entry point counts its launches in ``<name>.launches``;
``KERNELS`` lists them (a CUDA graph adds a capture's counts back on
every replay: ``core/control.py`` ``DecodeGraph``).  The
attention kernels have no backward and raise when reached under grad
mode with an input that requires grad (training takes the plain
attention, as the reference's ``"xla"`` route does).
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention import (  # noqa: F401  (re-export)
    flash_attention)
from repro_torch.kernels.kv_write import (  # noqa: F401  (re-export)
    paged_kv_write)
from repro_torch.kernels.paged_attention import (  # noqa: F401  (re-export)
    contiguous_decode_attention as decode_attention, paged_decode_attention,
    paged_mla_decode_attention)
from repro_torch.kernels.moe_gemm import (  # noqa: F401  (re-export)
    moe_gemm, moe_gemm_dgrad, moe_gemm_wgrad)
from repro_torch.kernels.ssd_scan import (  # noqa: F401  (re-export)
    ssd_scan, ssd_scan_bwd)

#: every kernel entry point with a launch counter
KERNELS = (paged_decode_attention, paged_mla_decode_attention,
           decode_attention, flash_attention, ssd_scan, ssd_scan_bwd,
           moe_gemm, moe_gemm_wgrad, paged_kv_write)
