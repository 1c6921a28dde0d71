"""The kernel layer's public entry points.

The route is chosen by where the tensors live, not by a setting: a CPU
tensor takes the plain PyTorch version, a CUDA tensor launches the
hand-written kernel or raises (there is no fallback between the two).

* ``paged_decode_attention`` / ``paged_mla_decode_attention`` — the CUDA
  kernels of ``csrc/paged_attention.cu`` through their ctypes wrappers
  (``repro_torch.kernels.paged_attention``);
* ``decode_attention`` — one-token GQA decode over a contiguous cache
  (the fallback families' dense cache), the contiguous kernel of the same
  file;
* ``flash_attention`` — causal GQA prefill (``csrc/flash_attention.cu``);
* ``ssd_scan`` — the Mamba2 SSD chunked scan (``csrc/ssd_scan.cu``); its
  CPU version is the chunked form the reference's XLA route runs;
* ``moe_gemm`` / ``moe_gemm_dgrad`` / ``moe_gemm_wgrad`` — the
  token-sorted grouped expert GEMM of the grouped MoE path and its input
  and weight gradients (``csrc/moe_gemm.cu``); ``moe_gemm`` is
  differentiable, its backward runs the other two;
* ``paged_kv_write`` — the pool write, one indexed store (no kernel of
  its own on either side).

Each kernel entry point counts its launches in ``<name>.launches``.  The
attention and SSD kernels have no backward and raise when reached under
grad mode with an input that requires grad.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import (  # noqa: F401  (re-export)
    flash_attention)
from repro_torch.kernels.paged_attention import (  # noqa: F401  (re-export)
    contiguous_decode_attention as decode_attention, paged_decode_attention,
    paged_mla_decode_attention)
from repro_torch.kernels.moe_gemm import (  # noqa: F401  (re-export)
    moe_gemm, moe_gemm_dgrad, moe_gemm_wgrad)
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: F401  (re-export)


def paged_kv_write(pool: torch.Tensor, kv_flat: torch.Tensor,
                   pages: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """Store per-token KV rows into the flat page pool, IN PLACE.

    pool:    [n_pages, page_elems]  the shared physical pool
    kv_flat: [n, per_token_elems]   one row per token (one layer's K+V,
                                    or MLA latent+rope)
    pages:   [n] int physical page ids (< 0 = drop the row)
    slots:   [n] int token slot within the page

    Rows whose page id is negative (unmapped / inactive batch slots) are
    dropped, as the reference's ``mode="drop"`` scatter drops them
    (``src/repro/kernels/ops.py:79-104``).  Where the reference donates the
    pool and rebinds the returned buffer, this writes into ``pool`` with
    ``index_put_`` and returns the same tensor.  Selecting the kept rows
    reads the mask back to the host (one synchronisation on a card).
    """
    e = kv_flat.shape[-1]
    keep = pages >= 0
    rows = pages[keep].long()
    cols = (slots[keep].long() * e)[:, None] \
        + torch.arange(e, device=pool.device)[None, :]
    pool.index_put_((rows[:, None], cols), kv_flat[keep].to(pool.dtype))
    return pool
