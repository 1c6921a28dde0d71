"""Config dataclasses for the CrossPool reproduction.

A single :class:`ModelConfig` covers every assigned architecture family:
dense / MoE decoders (GQA, MQA, MLA attention), sliding-window patterns
(gemma3), pure SSM (mamba2), hybrid SSM+shared-attention (zamba2),
encoder-decoder audio backbones (whisper) and VLM backbones (llava).

Configs are *data*: the model zoo in ``repro.models`` interprets them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Mapping, Optional, Tuple

# ---------------------------------------------------------------------------
# Runtime defaults
# ---------------------------------------------------------------------------

# Decode tokens committed per host dispatch when control lowering is ON
# (``runtime.engine.EngineMode.decode_steps_per_dispatch``).  1 preserves
# the seed single-step behaviour; >1 enables the persistent multi-step
# decode path (``core.control.MultiStepFusedStep``) which amortises the
# host dispatch + sampling round-trip across K tokens.  Host-driven
# lowering (the ablation baseline) always runs K=1.
DEFAULT_DECODE_STEPS_PER_DISPATCH = 1

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3 style).

    The KV cache stores only the compressed latent (``kv_lora_rank``) plus a
    shared rotary key (``qk_rope_head_dim``) per token — this is the paper's
    Type II ("KV-head-limited") flagship case.
    """

    q_lora_rank: int = 0          # 0 = no query compression
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64

    @property
    def kv_bytes_per_token_factor(self) -> int:
        """Cached scalars per token per layer (latent + rope key)."""
        return self.kv_lora_rank + self.qk_rope_head_dim


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 SSD configuration (state-space duality, arXiv:2405.21060)."""

    d_state: int = 128
    head_dim: int = 64
    n_groups: int = 1
    expand: int = 2
    conv_width: int = 4
    chunk_size: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description for one model.

    ``family`` selects the block layout:
      * ``dense``  — attention + dense SwiGLU FFN each layer
      * ``moe``    — attention + top-k routed expert FFN each layer
      * ``ssm``    — Mamba2 SSD block each layer (attention-free)
      * ``hybrid`` — Mamba2 blocks with periodic *shared* attention blocks
      * ``vlm``    — dense decoder backbone; vision frontend is a stub
      * ``audio``  — encoder-decoder backbone; audio frontend is a stub
    """

    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128

    # --- attention flavour ---------------------------------------------
    attention: str = "gqa"            # "gqa" | "mla" | "none"
    qk_norm: bool = False
    mla: Optional[MLAConfig] = None
    # sliding-window pattern: every ``swa_pattern``-th layer is global,
    # the rest use a local window of ``sliding_window`` tokens (gemma3 5:1).
    sliding_window: int = 0
    swa_pattern: int = 0

    # --- MoE -------------------------------------------------------------
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    router_jitter: float = 0.0
    capacity_factor: float = 1.25

    # --- SSM / hybrid ----------------------------------------------------
    ssm: Optional[SSMConfig] = None
    # hybrid layout: groups of (ssm_per_group SSM layers + 1 shared attn
    # block).  ``n_layers`` = hybrid_groups * (ssm_per_group + 1) + tail_ssm.
    hybrid_groups: int = 0
    ssm_per_group: int = 0
    tail_ssm_layers: int = 0

    # --- encoder-decoder ---------------------------------------------------
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 0               # e.g. whisper: 1500 mel frames

    # --- modality frontend (STUB: precomputed embeddings as inputs) -------
    frontend: str = "none"             # "none" | "audio_frames" | "vision_patches"
    frontend_tokens: int = 0           # prepended embedding tokens per request

    # --- misc --------------------------------------------------------------
    mlp_kind: str = "swiglu"           # "swiglu" (3-matrix) | "gelu" (2-matrix)
    max_position: int = 131072
    rope_theta: float = 1_000_000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    source: str = ""                   # provenance note ([hf:...] / [arXiv:...])

    # ------------------------------------------------------------------
    # Derived quantities
    # ------------------------------------------------------------------
    @property
    def attn_free(self) -> bool:
        return self.attention == "none"

    @property
    def q_dim(self) -> int:
        if self.attention == "mla":
            assert self.mla is not None
            return self.n_heads * (self.mla.qk_nope_head_dim + self.mla.qk_rope_head_dim)
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def kv_bytes_per_token(self, bytes_per_el: int = 2) -> int:
        """Per-token KV-cache bytes across ALL layers (paper's kappa(M)).

        This drives the planner (Eq. 1): MLA caches the latent only; SWA
        layers cache at most ``sliding_window`` tokens (counted as full rate
        here and clipped by window in the capacity model); SSM layers cache
        nothing per token (constant-size state handled separately).
        """
        if self.attention == "mla":
            assert self.mla is not None
            per_layer = self.mla.kv_bytes_per_token_factor
            return per_layer * self.n_decoder_attn_layers * bytes_per_el
        if self.attn_free:
            return 0
        per_layer = 2 * self.n_kv_heads * self.head_dim  # K and V
        return per_layer * self.n_decoder_attn_layers * bytes_per_el

    def state_bytes_per_request(self, bytes_per_el: int = 2) -> int:
        """Constant per-request state (SSM recurrent state + conv cache)."""
        if self.ssm is None:
            return 0
        d_in = self.ssm.d_inner(self.d_model)
        nh = self.ssm.n_heads(self.d_model)
        per_layer = nh * self.ssm.head_dim * self.ssm.d_state  # h state
        per_layer += (d_in + 2 * self.ssm.n_groups * self.ssm.d_state) * (
            self.ssm.conv_width - 1
        )  # conv cache
        return per_layer * self.n_ssm_layers * bytes_per_el

    @property
    def n_decoder_attn_layers(self) -> int:
        """Number of decoder layers that keep a growing KV cache."""
        if self.family == "hybrid":
            return self.hybrid_groups  # one shared attention block per group
        if self.family == "ssm":
            return 0
        return self.n_layers

    @property
    def n_ssm_layers(self) -> int:
        if self.family == "ssm":
            return self.n_layers
        if self.family == "hybrid":
            return self.hybrid_groups * self.ssm_per_group + self.tail_ssm_layers
        return 0

    @property
    def n_global_attn_layers(self) -> int:
        """Layers whose KV grows with full context (for long-ctx capacity)."""
        if self.swa_pattern > 0:
            return self.n_layers // self.swa_pattern
        return self.n_decoder_attn_layers

    @property
    def supports_long_context(self) -> bool:
        """True if attention cost/memory is sub-quadratic in context.

        Pure full-attention archs skip the ``long_500k`` shape (DESIGN.md).
        """
        if self.family in ("ssm", "hybrid"):
            return True
        if self.swa_pattern > 0:        # only 1/pattern layers are global
            return True
        if self.attention == "mla":     # compressed latent KV
            return True
        return False

    # ------------------------------------------------------------------
    # Parameter counting (for Table 1 and roofline MODEL_FLOPS)
    # ------------------------------------------------------------------
    def param_counts(self) -> dict:
        """Analytic parameter counts split by module group."""
        d = self.d_model
        counts = {"embed": self.vocab_size * d, "attn": 0, "ffn": 0, "ssm": 0,
                  "norm": 0, "head": 0 if self.tie_embeddings else self.vocab_size * d}

        def attn_params() -> int:
            if self.attention == "mla":
                m = self.mla
                q_in = m.q_lora_rank if m.q_lora_rank else d
                p = 0
                if m.q_lora_rank:
                    p += d * m.q_lora_rank + m.q_lora_rank  # down proj + norm
                p += q_in * self.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                p += d * (m.kv_lora_rank + m.qk_rope_head_dim) + m.kv_lora_rank
                p += m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
                p += self.n_heads * m.v_head_dim * d
                return p
            p = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            if self.qk_norm:
                p += 2 * self.head_dim
            return p

        def dense_ffn_params(ff: int) -> int:
            n_mats = 3 if self.mlp_kind == "swiglu" else 2
            return n_mats * d * ff

        def moe_ffn_params() -> int:
            p = self.n_experts * 3 * d * self.d_ff
            p += d * self.n_experts  # router
            if self.n_shared_experts:
                p += self.n_shared_experts * 3 * d * self.d_ff
            return p

        def ssm_params() -> int:
            s = self.ssm
            d_in = s.d_inner(d)
            nh = s.n_heads(d)
            conv_dim = d_in + 2 * s.n_groups * s.d_state
            p = d * (2 * d_in + 2 * s.n_groups * s.d_state + nh)  # in_proj
            p += conv_dim * s.conv_width                          # conv1d
            p += nh * 2                                           # A_log, D
            p += nh                                               # dt_bias
            p += d_in                                             # norm
            p += d_in * d                                         # out_proj
            return p

        if self.family in ("dense", "vlm"):
            counts["attn"] = self.n_layers * attn_params()
            counts["ffn"] = self.n_layers * dense_ffn_params(self.d_ff)
            counts["norm"] = self.n_layers * 2 * d + d
        elif self.family == "moe":
            counts["attn"] = self.n_layers * attn_params()
            counts["ffn"] = self.n_layers * moe_ffn_params()
            counts["norm"] = self.n_layers * 2 * d + d
        elif self.family == "ssm":
            counts["ssm"] = self.n_layers * ssm_params()
            counts["norm"] = self.n_layers * d + d
        elif self.family == "hybrid":
            counts["ssm"] = self.n_ssm_layers * ssm_params()
            counts["attn"] = self.hybrid_groups * attn_params()   # shared-per-group
            counts["ffn"] = self.hybrid_groups * dense_ffn_params(self.d_ff)
            counts["norm"] = self.n_layers * 2 * d + d
        elif self.family == "audio":
            counts["attn"] = (self.n_encoder_layers + 2 * self.n_layers) * attn_params()
            counts["ffn"] = (self.n_encoder_layers + self.n_layers) * dense_ffn_params(self.d_ff)
            counts["norm"] = (self.n_encoder_layers + self.n_layers) * 3 * d + 2 * d
        else:
            raise ValueError(f"unknown family {self.family}")
        counts["total"] = sum(counts.values())
        return counts

    def active_param_counts(self) -> int:
        """Active parameters per token (MoE uses top-k experts only)."""
        c = self.param_counts()
        if not self.is_moe:
            return c["total"]
        d = self.d_model
        active_ffn = self.n_layers * (
            (self.experts_per_token + self.n_shared_experts) * 3 * d * self.d_ff
            + d * self.n_experts
        )
        return c["total"] - c["ffn"] + active_ffn

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Elastic pool rebalancing (DESIGN.md §8)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ElasticConfig:
    """Knobs for the online KV<->weights boundary rebalancer.

    Like :class:`ModelConfig`, this is pure data: ``repro.core.elastic``
    interprets it.  The split between the KV page pool and the weight
    slab arena is re-estimated from a sliding telemetry window (windowed
    Eq. 1-2) every ``interval_steps`` session steps; a move is applied
    only when it clears ``hysteresis`` AND ``cooldown_steps`` have passed
    since the last one, and never moves more than ``max_step_fraction``
    of either pool at once — three dampers that keep a bursty signal from
    thrashing the boundary.
    """

    enabled: bool = True
    interval_steps: int = 4          # re-plan cadence (session steps)
    window_s: float = 30.0           # telemetry window feeding the re-plan
    hysteresis: float = 0.15         # min fractional budget change to act
    cooldown_steps: int = 8          # min steps between APPLIED moves
    ewma_alpha: float = 0.25         # occupancy-EWMA smoothing factor
    quantile: float = 0.95           # windowed Eq. (2) sizing quantile
    max_step_fraction: float = 0.5   # max fraction of a pool moved at once
    min_page_budget: int = 16        # absolute KV-pool floor (pages)
    headroom_pages: int = 0          # admission reserve while shrinking


# ---------------------------------------------------------------------------
# Prefix caching (DESIGN.md §11)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CacheConfig:
    """Knobs for the radix-tree prefix cache over the shared KV pool.

    Pure data, interpreted by ``repro_torch.core.prefix_cache`` and the
    engine.  Disabled by default: with ``enabled=False`` the engine is
    byte-for-byte the pre-cache engine (no tree, no refcounts, no extra
    device work).

    ``max_pages_fraction`` bounds the DEVICE pages the tree may retain
    beyond live requests (as a fraction of the live page budget); inserts
    past the bound evict LRU leaves first.  ``second_chance`` reuses the
    elastic host swap tier as a second-chance cache tier: pages evicted
    from the device are swapped out instead of dropped, and a later match
    faults them back bit-exactly instead of re-prefilling.
    """

    enabled: bool = False
    max_pages_fraction: float = 0.5
    second_chance: bool = True


# ---------------------------------------------------------------------------
# Service-level objectives (DESIGN.md §13)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SLObjective:
    """Per-model latency objectives, in milliseconds.

    ``None`` fields are not monitored.  ``target`` is the availability
    target for every monitored metric on this model: a sample is "bad"
    when it strictly exceeds the threshold (exact equality is within
    SLO), and the error budget is ``1 - target``.
    """

    ttft_ms: Optional[float] = None       # time to first token
    tbt_p99_ms: Optional[float] = None    # inter-token gap (tail objective)
    queue_wait_ms: Optional[float] = None  # admission front-door wait
    target: float = 0.99


@dataclass(frozen=True)
class SLOConfig:
    """Declarative SLOs, evaluated by ``runtime.observe.SLOMonitor``.

    Multi-rate burn-rate alerting (the SRE-workbook shape): a breach
    fires only when BOTH the long window and the short window burn the
    error budget faster than ``burn_rate_threshold`` — the long window
    keeps alerts significant, the short window makes them reset quickly
    once the condition clears.  Windows are in engine virtual time.
    """

    objectives: Mapping[str, SLObjective] = dataclasses.field(
        default_factory=dict)           # model name -> objectives
    window_s: float = 30.0              # long (significance) window
    short_window_s: float = 3.0         # fast (recency) window
    burn_rate_threshold: float = 1.0    # budget-burn multiple to alert at


# ---------------------------------------------------------------------------
# Flight recorder (DESIGN.md §13)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FlightRecorderConfig:
    """Knobs for the session flight recorder (``runtime.flightrec``).

    The recorder keeps a bounded ring of every causal input (submits,
    clock reads, cancels, injections) plus informational pool events,
    periodic pool snapshots at quiescent step boundaries, and the full
    per-request token streams.  ``dump_path`` is the auto-dump target on
    a pool accounting failure or the first SLO breach; ``None`` means
    on-demand dumps only (``engine.recorder.dump(path)``).
    """

    enabled: bool = True
    ring_size: int = 4096               # bounded event ring (drops counted)
    snapshot_interval_steps: int = 8    # pool snapshot cadence (steps)
    max_snapshots: int = 128            # bounded snapshot ring
    dump_path: Optional[str] = None     # auto-dump target (JSON)
    dump_on_breach: bool = True         # dump on first SLO breach too


# ---------------------------------------------------------------------------
# Unified engine construction surface
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class EngineConfig:
    """One bundle for ``CrossPoolEngine(config=...)`` — the canonical
    construction surface (the loose ``mode=`` / ``elastic=`` kwargs that
    accreted across PRs 4-7 remain as deprecated aliases for one release).

    ``mode`` is the engine's ``EngineMode`` (held loosely typed here so the
    config layer stays import-free of the runtime); ``elastic`` enables the
    online KV<->weights rebalancer; ``cache`` configures the radix-tree
    prefix cache.  ``None`` fields mean "engine default".

    ``sanitize`` attaches the pool shadow-sanitizer
    (``repro_torch.analysis.sanitizer.PoolSanitizer``): every hook event is
    reconciled against the pool counters and a full structural audit runs
    at each step boundary — pure checking, no behavior change.  The
    ``CROSSPOOL_SANITIZE=1`` environment variable forces it on regardless
    (how CI runs the whole tier-1 suite sanitized).
    """

    mode: Optional[object] = None            # runtime.engine.EngineMode
    elastic: Optional[ElasticConfig] = None
    cache: Optional[CacheConfig] = None
    sanitize: bool = False
    slo: Optional[SLOConfig] = None          # burn-rate SLO monitoring
    flightrec: Optional[FlightRecorderConfig] = None  # session black box


# ---------------------------------------------------------------------------
# Input shapes (assigned shape set)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned (seq_len, global_batch) workload cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether an (arch x shape) cell runs, with the reason if skipped."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "pure full-attention arch: 500k decode is quadratic-KV (DESIGN.md skip list)"
    return True, ""
