"""Bridge a reference param tree into the port's layout.

The reference draws its weights from ``jax.random`` keys, which torch
cannot reproduce; to compute the same function in both packages, a test
converts the reference's tree (its leaves turned into numpy arrays by the
caller) into torch tensors here.  The tree keeps its exact structure and
JAX's ``[in, out]`` weight layout — the port multiplies ``x @ w`` as the
reference does, so nothing is transposed.  bfloat16 leaves (numpy's
``ml_dtypes`` extension type) are carried over by their raw 16-bit words,
so no value is rounded on the way.  Each leaf keeps its own dtype: the
SSM blocks' ``A_log``, ``D`` and ``dt_bias`` stay float32 inside a
bfloat16 tree, as the reference keeps them.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def to_torch(arr: np.ndarray) -> torch.Tensor:
    """One numpy leaf -> a CPU torch tensor with the same bits (a copy)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


def params_to_torch(tree: Dict) -> Dict:
    """Nested dict of numpy leaves -> the same nesting of torch tensors."""
    return {k: params_to_torch(v) if isinstance(v, dict)
            else to_torch(np.asarray(v)) for k, v in tree.items()}
