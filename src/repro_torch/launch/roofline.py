"""The roofline of one step: port of ``src/repro/launch/roofline.py``.

Three terms per (arch x shape x mesh), in seconds, on one NVIDIA H100
SXM5's published peaks (``launch/mesh.py``):

  compute    = FLOPs_per_device / bf16 peak
  memory     = analytic minimum bytes_per_device / HBM rate
  collective = collective_bytes_per_device / NVLink rate (one direction)

The FLOPs and the collective bytes are counted by running one rank's step
on ``meta`` tensors (``launch/op_analysis.py`` ``analyze_step``): every
layer executes, so the reference's trip-count multiplication of while
bodies is not needed.  The reference's ``collective_bytes`` (a parser of
the partitioned HLO text) has no torch meaning: the stand-in mesh counts
each collective's result bytes as the step runs, the same per-device
payload.  ``bytes_per_device`` is the op analysis's bytes accessed (every
op's inputs and outputs, nothing fused), kept beside the analytic
``bytes_model`` as the reference keeps XLA's.  A production mesh spans
nodes whose links are slower than NVLink, so there the collective term is
a lower bound.

``model_flops_estimate``, ``analytic_bytes_estimate`` and ``trip_factor``
are the reference's, line for line: they read only the config.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    strategy: str
    chips: int
    flops_per_device: float
    bytes_per_device: float                  # bytes accessed (unfused)
    bytes_model: float                       # analytic minimum HBM traffic
    collective_per_device: float
    collective_breakdown: Dict[str, int]
    model_flops: float                       # 6*N*D (or active) for train;
    #                                          2*N_active*tokens for serving
    peak_flops: float = PEAK_FLOPS_BF16
    hbm_bw: float = HBM_BW
    link_bw: float = NVLINK_BW

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / self.peak_flops

    @property
    def t_memory_hlo(self) -> float:
        """The bytes-accessed term (the reference's name: its figure is
        XLA's; here every op's inputs and outputs, nothing fused)."""
        return self.bytes_per_device / self.hbm_bw

    @property
    def t_memory(self) -> float:
        """Memory term: analytic minimum traffic (weights + KV + optimizer
        + activations actually touched per step, per device)."""
        return self.bytes_model / self.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.collective_per_device / self.link_bw

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / total counted FLOPs — remat/redundancy waste."""
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the bound term that is useful model compute —
        (model_flops/chips/peak) / bound_time."""
        if self.bound_time == 0:
            return 0.0
        ideal = self.model_flops / self.chips / self.peak_flops
        return ideal / self.bound_time

    def to_dict(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "strategy": self.strategy, "chips": self.chips,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "bytes_model": self.bytes_model,
            "collective_per_device": self.collective_per_device,
            "collective_breakdown": self.collective_breakdown,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_memory_hlo": self.t_memory_hlo,
            "t_collective": self.t_collective, "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops_estimate(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Useful FLOPs per executed step.

    train: 6 * N_active * tokens  (fwd 2ND + bwd 4ND)
    prefill: 2 * N_active * tokens (+ attention quadratic term)
    decode: 2 * N_active * batch (one token each) + attention context reads
    """
    n_active = cfg.active_param_counts()
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        base = 6.0 * n_active * tokens
    elif shape.kind == "prefill":
        base = 2.0 * n_active * tokens
        # causal attention score+value FLOPs: 2 * 2 * B * S^2/2 * H * hd
        if not cfg.attn_free:
            base += (2.0 * shape.global_batch * shape.seq_len ** 2 / 2
                     * cfg.n_heads * cfg.head_dim * 2)
    else:  # decode: one token per sequence
        base = 2.0 * n_active * shape.global_batch
        if not cfg.attn_free:
            base += (4.0 * shape.global_batch * shape.seq_len
                     * cfg.n_heads * cfg.head_dim)
    return base


def analytic_bytes_estimate(cfg: ModelConfig, shape: ShapeConfig,
                            chips: int, microbatches: int = 1,
                            kv_itemsize: int = 2) -> float:
    """Minimum per-device HBM traffic per executed step (napkin math).

    decode : active weights read once + full KV cache read + 1-token write
    prefill: weights + KV written + O(tokens*d) activation traffic
    train  : weights read fwd+bwd (2x2B) + f32 grads written (4B) + AdamW
             state read+write (m,v: 2x2xmb) + params update (2x2B)
             + saved scan carries (remat: one [B,S,D] per layer per mb)
    All divided by ``chips`` (weights/KV/activations are all sharded over
    the mesh under every strategy used here).
    """
    n_active = cfg.active_param_counts()
    n_total = cfg.param_counts()["total"]
    B, S = shape.global_batch, shape.seq_len
    kappa = cfg.kv_bytes_per_token() * kv_itemsize / 2
    state = cfg.state_bytes_per_request()

    if shape.kind == "decode":
        # SWA archs only keep window-KV on local layers
        if cfg.swa_pattern > 0:
            g = cfg.n_global_attn_layers
            loc = cfg.n_layers - g
            per_layer = kappa / max(cfg.n_decoder_attn_layers, 1)
            kv = B * (g * S + loc * min(cfg.sliding_window, S)) * per_layer
        else:
            kv = B * S * kappa
        # weight read: non-FFN fully + DISTINCT experts for MoE
        counts = cfg.param_counts()
        w = (counts["total"] - counts["ffn"]) * 2
        if cfg.is_moe:
            expert_bytes = 3 * cfg.d_model * cfg.d_ff * 2
            distinct = min(cfg.n_experts, B * cfg.experts_per_token) \
                + cfg.n_shared_experts
            w += cfg.n_layers * distinct * expert_bytes
        else:
            w += counts["ffn"] * 2
        return (w + kv + B * state) / chips

    if shape.kind == "prefill":
        kv = B * S * kappa
        act = B * S * cfg.d_model * 2 * cfg.n_layers * 4
        return (2 * n_active + kv + act) / chips

    # train
    mdt = 2 if n_total > 5e10 else 4          # moment dtype bytes
    weights = 2 * n_total * 2                 # fwd + bwd reads (bf16)
    grads = 4 * n_total                       # f32 grad write
    opt = n_total * (2 * 2 * mdt + 2 * 2)     # m,v r/w + param r/w
    carries = B * S * cfg.d_model * 2 * cfg.n_layers  # remat-saved inputs
    act = B * S * cfg.d_model * 2 * cfg.n_layers * 6  # recompute traffic
    return (weights * max(microbatches, 1) + grads + opt + carries + act) \
        / chips


def trip_factor(cfg: ModelConfig, shape: ShapeConfig,
                microbatches: int = 1) -> int:
    """How many times the dominant scan body executes per step.

    XLA cost analysis counts while bodies once; the per-layer scan body runs
    L times (enc+dec for whisper), and the gradient-accumulation scan
    multiplies by ``microbatches`` for train cells.  Nested structures
    (gemma3 groups, zamba2 hybrid) still total ~n_layers body executions.
    The op analysis needs no such factor (every layer executes); this is
    the reference's, kept line for line.
    """
    L = cfg.n_layers
    if cfg.family == "audio":
        L += cfg.n_encoder_layers
    if shape.kind == "train":
        L *= max(microbatches, 1)
    return max(L, 1)


def build_report(*, arch: str, shape: ShapeConfig, mesh_name: str,
                 strategy: str, chips: int, stats, cfg: ModelConfig,
                 microbatches: int = 1, kv_itemsize: int = 2
                 ) -> RooflineReport:
    """The report of one cell from its op analysis (``stats``, an
    ``op_analysis.ModuleStats`` of one rank's step) and the config's
    analytic terms."""
    coll = dict(stats.collective_bytes)
    coll["count"] = stats.coll_count
    return RooflineReport(
        arch=arch, shape=shape.name, mesh=mesh_name, strategy=strategy,
        chips=chips,
        flops_per_device=stats.flops,
        bytes_per_device=float(stats.bytes_accessed),
        bytes_model=analytic_bytes_estimate(cfg, shape, chips, microbatches,
                                            kv_itemsize),
        collective_per_device=float(stats.collective_total),
        collective_breakdown=coll,
        model_flops=model_flops_estimate(cfg, shape),
    )
