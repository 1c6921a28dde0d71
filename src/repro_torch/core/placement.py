"""Placement capacity models: Static Partition vs kvcached vs CrossPool.

Port of ``src/repro/core/placement.py``: analytic models of how much KV
capacity each placement exposes, behind the Fig. 2 (KV availability
fraction) and Fig. 6 (context-length scalability) reproductions.  Pure
Python over ``configs.base``; no tensor and no device is involved.

All three placements get the SAME hardware budget (n_gpus x hbm_bytes)
and must hold the same model weights; they differ in where weights sit
and which fraction of the remaining KV memory one request can reach.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class Hardware:
    """The model's input hardware.  The defaults are the paper's testbed
    (five A100-40G GPUs, bf16 weights), kept so the port's numbers equal
    the reference's; they are not a figure of the card the port runs on."""

    n_gpus: int = 5
    hbm_bytes: float = 40e9            # A100-40G testbed of the paper
    bytes_per_param: int = 2


@dataclass(frozen=True)
class PlacementResult:
    system: str
    # per-model: (kv_bytes_visible_to_one_request, total_kv_bytes)
    per_model: Dict[str, Tuple[float, float]]

    def max_context(self, cfg: ModelConfig) -> int:
        vis, _ = self.per_model[cfg.name]
        kappa = cfg.kv_bytes_per_token()
        return int(vis // kappa) if kappa else 1 << 30


def _weights_bytes(cfg: ModelConfig, hw: Hardware) -> float:
    return cfg.param_counts()["total"] * hw.bytes_per_param


def _ffn_bytes(cfg: ModelConfig, hw: Hardware) -> float:
    return cfg.param_counts()["ffn"] * hw.bytes_per_param


def _tp_width(cfg: ModelConfig, gpus: int) -> int:
    """TP degree a monolithic engine uses: min(kv_heads, gpus)  (paper
    §2.2: DP attention beyond the KV-head count)."""
    if cfg.attn_free:
        return gpus
    if cfg.attention == "mla":
        return 1
    return min(cfg.n_kv_heads, gpus)


def static_partition(models: Sequence[ModelConfig], hw: Hardware,
                     gpus_per_model: Sequence[int]) -> PlacementResult:
    """Each model owns a fixed GPU subset; weights + KV colocated there."""
    per = {}
    for cfg, g in zip(models, gpus_per_model):
        budget = g * hw.hbm_bytes - _weights_bytes(cfg, hw)
        budget = max(budget, 0.0)
        tp = _tp_width(cfg, g)
        replicas = max(g // tp, 1)
        visible = budget / replicas        # one request -> one replica
        per[cfg.name] = (visible, budget)
    return PlacementResult("static", per)


def kvcached(models: Sequence[ModelConfig], hw: Hardware) -> PlacementResult:
    """Elastic colocated pool (Chimera/kvcached): weights are stored once,
    KV memory is elastically shared — but weights and KV stay in ONE pool
    per GPU, and a request under DP attention only reaches its own rank
    group's KV (paper §2.2 / Fig. 2a): visible fraction =
    min(kv_heads, G) / G."""
    total_hbm = hw.n_gpus * hw.hbm_bytes
    weights = sum(_weights_bytes(cfg, hw) for cfg in models)
    kv_total = max(total_hbm - weights, 0.0)
    per = {}
    for cfg in models:
        frac = kv_availability_fraction(
            1 if cfg.attention == "mla" else cfg.n_kv_heads,
            hw.n_gpus, disaggregated=False) if not cfg.attn_free else 1.0
        per[cfg.name] = (kv_total * frac, kv_total)
    return PlacementResult("kvcached", per)


def crosspool(models: Sequence[ModelConfig], hw: Hardware,
              kv_gpus: int = 1) -> PlacementResult:
    """The paper: FFN weights of ALL models consolidated on
    (n - kv_gpus) weight-pool GPUs; attention + non-FFN weights + the
    shared KV pool on ``kv_gpus``; KV is sequence-shared so one request
    sees the whole pool."""
    non_ffn = sum(_weights_bytes(c, hw) - _ffn_bytes(c, hw) for c in models)
    ffn = sum(_ffn_bytes(c, hw) for c in models)
    weight_pool_hbm = (hw.n_gpus - kv_gpus) * hw.hbm_bytes
    if ffn > weight_pool_hbm:
        raise ValueError(f"FFN weights {ffn / 1e9:.1f}GB exceed weights pool "
                         f"{weight_pool_hbm / 1e9:.1f}GB")
    kv_total = max(kv_gpus * hw.hbm_bytes - non_ffn, 0.0)
    per = {c.name: (kv_total, kv_total) for c in models}
    return PlacementResult("crosspool", per)


def kv_availability_fraction(n_kv_heads: int, n_gpus: int,
                             disaggregated: bool) -> float:
    """Fig. 2: fraction of total KV capacity visible to a single request."""
    if disaggregated:
        return 1.0
    tp = min(max(n_kv_heads, 1), n_gpus)
    replicas = n_gpus // tp
    return 1.0 / max(replicas, 1)
