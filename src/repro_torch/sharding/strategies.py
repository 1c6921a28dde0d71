"""Pooling/parallelism strategies: how (arch x shape x mesh) maps to
shardings.  Port of ``src/repro/sharding/strategies.py``.

Three strategies:

* ``train``      — DP over (pod,data) + FSDP weight sharding over the same
                   axes + TP over ``model`` (attention heads / FFN hidden /
                   expert axis).  Used by ``train_4k`` cells.
* ``monolithic`` — the kvcached-style serving baseline (paper §2.2): TP
                   over ``model`` *within* a replica, weights replicated
                   across ``data`` replicas, DP attention for
                   KV-head-limited models.  KV + weights colocated per
                   replica.
* ``crosspool``  — the paper: FFN/expert weights consolidated ONCE across
                   the whole mesh (weights pool); KV caches
                   sequence-sharded so a single request sees the aggregate
                   KV capacity of the pool (KV-cache pool); attention
                   executes where KV lives; the boundary exchanges hidden
                   states only.

A Strategy emits (a) path-pattern rules for params and caches (the
reference's tables, verbatim), (b) :class:`Hooks` and (c) input specs.

The reference hands its rules to the partitioner, which places every
leaf and derives the collectives.  The port's sharded steps write the
collectives out (``sharding/collectives.py``).

The training step (``launch/dryrun.py`` ``build_train_cell``, the
``train`` strategy) places EVERY leaf by the train rules, params, AdamW's
moments and the error-feedback tree alike, and its hooks carry
(``hooks()``):

* FSDP over the pool axes: each layer's leaves are all-gathered on their
  pool dims inside the rematerialised layer (``ParamShards.gather``; the
  backward reduce-scatters their gradients), the embedding and the head
  where they are read;
* TP over ``model`` (``Hooks.tp``): attention heads with ``wo``'s partial
  sums reduced, the MLP hidden, the experts (the combine reduced), the
  SSM's projections and heads (``models/ssm.py``), the vocabulary of the
  embedding, the head and the loss; with ``perf.seq_parallel`` the
  residual stream's S over ``model`` (whisper's decoder stream; its
  encoder runs on a ``tp`` that is not sequence-parallel, so the
  encoder's frames stay whole);
* the batch over the batch axes (``Hooks.dp``): the MoE's capacity slots
  and load-balance means over the whole (micro)batch, the gradients'
  mean (``ParamShards.grad_mean``); the global norm and the int8 scales
  of the whole tensors (``ParamShards.leaf_stats``);
* with ``perf.moe_a2a``, the experts over ``data`` through
  ``make_moe_a2a``.

The serve step (``launch/dryrun.py`` ``build_serve_cell``, monolithic and
crosspool) places EVERY param leaf by the serve rules, and its hooks
carry (``hooks()``):

* attention heads over ``model`` (``Hooks.tp``): this rank's query and
  KV heads, ``wo``'s partial sums reduced; a step whose cache holds
  every KV head (crosspool) gathers the heads it writes (a prefill's
  K / V, a decode's new token), and the sequence-sharded decode gathers
  every head's query before its combine; whisper's encoder likewise;
* the vocabulary of the embedding and the head over ``model``: the
  lookup masks the ids a rank does not own and sums, and the step returns
  this rank's vocabulary shard of its rows' logits (``dryrun.greedy``
  takes the split argmax); a vocabulary that does not divide (whisper's
  51865) stays whole;
* the FFN's weights pool: the dense FFN's hidden over ``model``
  (monolithic) or over ``tp_all`` (crosspool), completed by ``ffn_down``;
  the routed experts over ``model`` (monolithic) or over ``data`` with
  ``f`` over ``model`` (crosspool, ``Hooks.experts``), their partial sums
  and a shared expert's completed at once by ``moe_sum``; the capacity's
  slots over the rows still split at the FFN (``Hooks.dp``), so the drops
  are the whole batch's; with ``perf.moe_a2a`` (crosspool) the experts
  go through ``make_moe_a2a``;
* the SSM's projections in the same pool (``in_proj``'s columns,
  ``conv_w``'s channels, ``out_proj``'s rows over ``model`` or over
  ``tp_all``: ``Hooks.ssm``) and the state's heads over ``model``
  (``ssm_heads``; ``models/ssm.py`` says how a rank's columns meet its
  heads);
* monolithic DP attention (``_dpa_axes``, rows over ``data`` and
  ``model``): the attention and SSM leaves gathered over ``model`` where
  a layer reads them (``Hooks.params``), and the rows of the rank's
  ``model`` group gathered into the embedding, the FFN and the head and
  this rank's taken back (``Hooks.rows``, ``boundary_in`` / ``out``);
* the KV-cache pool (``step_cache_rules``): a cache leaf's batch rows
  over the step's row axes (``row_axes``); under monolithic Type I the
  KV heads of ``k`` / ``v`` (gemma3's ``gk`` / ``gv`` and ring ``lk`` /
  ``lv``, whisper's cross ``ck`` / ``cv``) over ``model``, a layer whose
  weights the rules keep whole (whisper's decoder ``self`` / ``cross``)
  cut to this rank's heads where it reads them; the SSM state ``h`` /
  ``tail_h``'s heads over ``model`` (``conv`` / ``tail_conv`` keep their
  rows only); under crosspool (``seq_split``: prefill and decode, Type I
  and Type II alike, wherever ``kv_seq_axes`` spans more than one rank)
  the sequence of ``k`` / ``v`` / ``latent`` / ``rope`` / ``gk`` / ``gv``
  over ``kv_seq_axes`` with every head whole, as the reference's table
  names them: a prefill writes this rank's rows of the prompt's K / V
  (``Hooks.kv_offset``), a decode writes the new token on the rank that
  owns its position and reads the split cache through the sequence-
  sharded attention (``sharding/seq_attention.py``).  The leaves the
  reference's ``*`` patterns catch only by accident keep the port's
  placement: ``conv`` (by ``*v``), ``tail_h`` (by ``*h``), gemma3's ring
  ``lk`` / ``lv`` and whisper's cross ``ck`` / ``cv``, whose named rules
  are rows only (the reference's ``strategies.py:249-253``).
"""
from __future__ import annotations

import fnmatch
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.mesh import Mesh
from repro_torch.models import layers
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.hooks import Hooks, WholeParams
from repro_torch.sharding import moe_a2a, seq_attention
from repro_torch.sharding.collectives import AxisGroup
from repro_torch.sharding.spec import (PartitionSpec, RuleSet, axis_size,
                                       batch_axes, dims_on, local_slices,
                                       path_str, pool_axes, safe_spec,
                                       spec_axes)
from repro_torch.training.tree import leaves_with_path, unflatten

#: cache leaves whose sequence dimension the sequence-sharded decode reads
SEQ_SPLIT_LEAVES = ("k", "v", "latent", "rope", "gk", "gv")
#: gemma3's ring leaves keep the batch on axis 2 ([G,P-1,B,W,...]); every
#: other cache leaf on axis 1 ([L,B,...])
RING_LEAVES = ("lk", "lv", "lpos")
#: the routed experts' leaves, over ``data`` under the train ``moe_a2a``
EXPERT_LEAVES = ("*moe/w[gu]", "*moe/wd")
#: the attention and SSM leaves monolithic DP attention gathers where it
#: reads them
DPA_GATHERED = ("*attn/*", "*ssm/*")
#: cache leaves whose KV heads monolithic Type I splits over ``model``
KV_HEAD_LEAVES = ("k", "v", "gk", "gv", "lk", "lv", "ck", "cv")
#: the SSM state's leaves ([L,B,H,P,N]), their heads over ``model`` where
#: the step splits them (``Strategy.ssm_heads``)
SSM_HEAD_LEAVES = ("h", "tail_h")


@dataclass(frozen=True)
class PerfOpts:
    """Hillclimb levers for the §Perf iteration loop."""

    seq_parallel: bool = False      # shard the residual stream's S over
    #                                 'model' (Megatron-SP)
    compress_grads: bool = False    # error-feedback int8 DP reduction
    microbatches: Optional[int] = None  # override TRAIN_MICROBATCHES
    kv_seq_override: Optional[Tuple[str, ...]] = None  # decode KV shard axes
    moe_a2a: bool = False           # explicit all-to-all expert dispatch
    #                                 (+ for train: experts sharded on 'data')
    kv_dtype: Optional[str] = None  # "f8" = fp8-e4m3 KV cache (2x memory)
    f8_dispatch: bool = False       # fp8 a2a dispatch transport (2x payload)


class ParamShards(WholeParams):
    """Every leaf of a train state placed by ``specs`` ({path: spec of
    the whole leaf}) on a live mesh: the ``Hooks.params`` of the sharded
    training step (the interface is ``models/hooks.py``'s).

    ``gather`` all-gathers a tree's leaves on their pool-axis dims (the
    FSDP dims; the backward reduce-scatters the gradient), except the
    leaves matching ``expert_parallel``, which the all-to-all dispatch
    consumes as shards (with ``only``, just the leaves matching it: the
    serve step's attention under DP attention, ``pool`` = ``model``).
    ``grad_mean`` sums each leaf's gradient over the batch axes it is
    replicated on (one all-reduce per set of axes) and divides every leaf
    by the batch axes' width: the mean over the real tokens, also for a
    batch the train cell padded (a rank's loss is then its real tokens'
    share of the global mean times that width,
    ``train_step.make_loss_fn``: the weighting by real tokens comes before
    the backward, where the load-balance loss's global sums need it too).
    ``leaf_stats`` reduces a per-leaf statistic over the axes the leaf is
    split on."""

    def __init__(self, mesh: Mesh, specs, pool: Tuple[str, ...],
                 batch: Tuple[str, ...], expert_parallel=(), only=None):
        self.mesh, self.specs = mesh, specs
        self.pool, self.batch = pool, batch
        self.expert_parallel = tuple(expert_parallel)
        self.only = only

    def _split(self, path: str) -> Tuple[str, ...]:
        """The axes (of more than one rank) the leaf at ``path`` splits
        over."""
        return tuple(a for a in spec_axes(self.mesh, self.specs[path])
                     if self.mesh.shape[a] > 1)

    def gather(self, tree, path: str):
        if isinstance(tree, dict):
            return {k: self.gather(v, f"{path}/{k}") for k, v in tree.items()}
        if any(fnmatch.fnmatch(path, p) for p in self.expert_parallel) or (
                self.only is not None
                and not any(fnmatch.fnmatch(path, p) for p in self.only)):
            return tree
        spec = self.specs[path]
        # a layer of a stacked leaf has lost the layer dim
        spec = spec[len(spec) - tree.dim():]
        for dim, axes in dims_on(self.mesh, spec, self.pool):
            tree = AxisGroup(self.mesh, axes).gather_sum(tree, dim)
        return tree

    def _all_reduce(self, values: dict, axes_of, op: str) -> dict:
        """``values`` ({key: tensor}) all-reduced over ``axes_of(key)``:
        one flat buffer per (axes, dtype)."""
        groups: dict = {}
        for key, v in values.items():
            axes = axes_of(key)
            if axes:
                groups.setdefault((axes, v.dtype), []).append(key)
        out = dict(values)
        for (axes, _), keys in groups.items():
            buf = torch.cat([values[k].reshape(-1) for k in keys])
            self.mesh.all_reduce(buf, axes, op)
            parts = buf.split([values[k].numel() for k in keys])
            out.update({k: part.view_as(values[k])
                        for k, part in zip(keys, parts)})
        return out

    @torch.no_grad()
    def grad_mean(self, grads):
        flat = {path_str(p): g for p, g in leaves_with_path(grads)}
        summed = self._all_reduce(
            flat, lambda k: tuple(a for a in self.batch
                                  if self.mesh.shape[a] > 1
                                  and a not in self._split(k)), "sum")
        n = axis_size(self.mesh, self.batch)
        return unflatten(grads, [g / n if n > 1 else g
                                 for g in summed.values()])

    @torch.no_grad()
    def leaf_stats(self, stats: dict, op: str = "sum") -> dict:
        return self._all_reduce(stats, self._split, op)


class PlacedRules:
    """What the sharded step places: ``keep(path, rule_spec, shape)``
    turns the rules' spec of a leaf into the step's (``RuleSet``'s
    interface)."""

    def __init__(self, rules: RuleSet, keep):
        self.rules = rules
        self.keep = keep

    def spec_for(self, mesh: Mesh, path: str, shape) -> PartitionSpec:
        spec = self.rules.spec_for(mesh, path, shape)
        return PartitionSpec(*self.keep(path, spec, tuple(shape)))


@dataclass(frozen=True)
class Strategy:
    name: str
    mesh: Mesh = field(compare=False)
    cfg: ModelConfig
    shape: ShapeConfig
    perf: PerfOpts = PerfOpts()

    # ------------------------------------------------------------------
    # axis helpers
    # ------------------------------------------------------------------
    @property
    def bax(self) -> Tuple[str, ...]:
        return tuple(batch_axes(self.mesh))

    @property
    def pool(self) -> Tuple[str, ...]:
        """Expert/FSDP placement axes.  Training: FSDP spans (pod, data).
        Serving: the ``pod`` axis is a pure replica axis (§7 Related)."""
        if self.name == "train":
            return tuple(pool_axes(self.mesh))
        return ("data",)

    @property
    def tp_all(self) -> Tuple[str, ...]:
        """Pool-wide axis tuple (dense weights pool); excludes ``pod`` for
        serving strategies (pod = replica axis)."""
        if self.name == "train":
            return tuple(self.mesh.axis_names)
        return tuple(a for a in self.mesh.axis_names if a != "pod")

    @property
    def model_size(self) -> int:
        return self.mesh.shape["model"]

    @property
    def batch_sharded(self) -> bool:
        return self.shape.global_batch % axis_size(self.mesh, self.bax) == 0 \
            and self.shape.global_batch >= axis_size(self.mesh, self.bax)

    @property
    def kv_seq_axes(self) -> Tuple[str, ...]:
        """Axes the KV sequence dim shards over under crosspool: ``model``
        when the batch occupies the data axes; the ENTIRE mesh for a
        batch-1 long-context request (the paper's headline)."""
        if self.perf.kv_seq_override is not None:
            return self.perf.kv_seq_override
        if not self.batch_sharded:
            return self.tp_all
        return ("model",)

    @property
    def type_ii(self) -> bool:
        """KV-head-limited (paper §2.2): fewer KV heads than TP width."""
        if self.cfg.attention == "mla":
            return True
        if self.cfg.attn_free:
            return False
        return self.cfg.n_kv_heads < self.model_size

    # ------------------------------------------------------------------
    # parameter rules
    # ------------------------------------------------------------------
    def param_rules(self) -> RuleSet:
        FSDP = self.pool          # ZeRO-style weight sharding axes
        TP = "model"
        POOL = self.pool
        ALL = self.tp_all

        if self.name == "train":
            if self.perf.moe_a2a:
                # data-EP: experts live with the batch axis, a2a dispatch
                moe_rules = [
                    ("*moe/router", (None, None)),
                    ("*moe/w[gu]", ("data", None, TP)),
                    ("*moe/wd", ("data", TP, None)),
                ]
            else:
                moe_rules = [
                    ("*moe/router", (FSDP, None)),
                    ("*moe/w[gu]", (TP, FSDP, None)),  # [L,E,d,f]: E@model
                    ("*moe/wd", (TP, None, FSDP)),
                ]
            rules = [
                ("embed/tok", (TP, FSDP)),
                ("embed/head", (FSDP, TP)),
                ("*attn/wq", (FSDP, TP)),
                ("*attn/wk", (FSDP, TP)),
                ("*attn/wv", (FSDP, TP)),
                ("*attn/wo", (TP, FSDP)),
                ("*attn/wuq", (FSDP, TP)),
                ("*attn/wdq", (FSDP, TP)),
                ("*attn/wdkv", (FSDP, TP)),
                ("*attn/wuk", (FSDP, TP)),
                ("*attn/wuv", (FSDP, TP)),
                ("*mlp/w[gui]", (FSDP, TP)),
                ("*mlp/w[do]", (TP, FSDP)),
                *moe_rules,
                ("*moe/shared/w[gu]", (FSDP, TP)),
                ("*moe/shared/wd", (TP, FSDP)),
                ("*ssm/in_proj", (FSDP, TP)),
                ("*ssm/out_proj", (TP, FSDP)),
                ("*ssm/conv_w", (None, TP)),
            ]
        elif self.name == "monolithic":
            # kvcached-style: TP inside a replica, replicated over data
            rules = [
                ("embed/tok", (TP, None)),
                ("embed/head", (None, TP)),
                ("*attn/wq", (None, TP)),
                ("*attn/wk", (None, TP)),
                ("*attn/wv", (None, TP)),
                ("*attn/wo", (TP, None)),
                ("*attn/wuq", (None, TP)),
                ("*attn/wdq", (None, TP)),
                ("*attn/wdkv", (None, TP)),
                ("*attn/wuk", (None, TP)),
                ("*attn/wuv", (None, TP)),
                ("*mlp/w[gui]", (None, TP)),
                ("*mlp/w[do]", (TP, None)),
                ("*moe/router", (None, None)),
                ("*moe/w[gu]", (TP, None, None)),   # E over model, replicated@data
                ("*moe/wd", (TP, None, None)),
                ("*moe/shared/w[gu]", (None, TP)),
                ("*moe/shared/wd", (TP, None)),
                ("*ssm/in_proj", (None, TP)),
                ("*ssm/out_proj", (TP, None)),
                ("*ssm/conv_w", (None, TP)),
            ]
        elif self.name == "crosspool":
            # weights pool consolidates FFN/expert weights across the WHOLE
            # mesh; attention (KV pool) stays TP over model.
            rules = [
                ("embed/tok", (TP, None)),
                ("embed/head", (None, TP)),
                ("*attn/wq", (None, TP)),
                ("*attn/wk", (None, TP)),
                ("*attn/wv", (None, TP)),
                ("*attn/wo", (TP, None)),
                ("*attn/wuq", (None, TP)),
                ("*attn/wdq", (None, TP)),
                ("*attn/wdkv", (None, TP)),
                ("*attn/wuk", (None, TP)),
                ("*attn/wuv", (None, TP)),
                # consolidated MoE weights pool: E over (pod,data), f over model
                ("*moe/router", (None, None)),
                ("*moe/w[gu]", (POOL, None, TP)),
                ("*moe/wd", (POOL, TP, None)),
                ("*moe/shared/w[gu]", (None, ALL)),
                ("*moe/shared/wd", (ALL, None)),
                # dense FFN weights pool: hidden dim across the whole mesh
                ("*mlp/w[gui]", (None, ALL)),
                ("*mlp/w[do]", (ALL, None)),
                ("*ssm/in_proj", (None, ALL)),
                ("*ssm/out_proj", (ALL, None)),
                ("*ssm/conv_w", (None, ALL)),
            ]
        else:
            raise ValueError(f"unknown strategy {self.name}")
        return RuleSet(rules, default=())

    # ------------------------------------------------------------------
    # cache rules
    # ------------------------------------------------------------------
    def cache_rules(self) -> RuleSet:
        B = self.bax if self.batch_sharded else None
        TP = "model"
        if self.name == "crosspool":
            KT = self.kv_seq_axes
            rules = [
                ("k", (B, KT, None, None)),         # [L,B,T,KV,hd]
                ("v", (B, KT, None, None)),
                ("latent", (B, KT, None)),          # MLA [L,B,T,r]
                ("rope", (B, KT, None)),
                ("gk", (B, KT, None, None)),        # gemma3 global [G,B,T,KV,hd]
                ("gv", (B, KT, None, None)),
                ("lk", (B, None, None, None)),      # ring [G,P-1,B,W,KV,hd]
                ("lv", (B, None, None, None)),
                ("lpos", (B, None)),
                ("ck", (B, None, None, None)),      # whisper cross (static)
                ("cv", (B, None, None, None)),
                ("h", (B, TP, None, None)),         # SSM state [L,B,H,P,N]
                ("tail_h", (B, TP, None, None)),
                ("conv", (B, None, None)),
                ("tail_conv", (B, None, None)),
            ]
        else:
            # monolithic: Type II -> DP attention (batch over data x model),
            # Type I -> KV heads over model, batch over data.
            if self.type_ii:
                dpa = self._dpa_axes()
                rules = [
                    ("k", (dpa, None, None, None)),
                    ("v", (dpa, None, None, None)),
                    ("latent", (dpa, None, None)),
                    ("rope", (dpa, None, None)),
                    ("gk", (dpa, None, None, None)),
                    ("gv", (dpa, None, None, None)),
                    ("lk", (dpa, None, None, None)),
                    ("lv", (dpa, None, None, None)),
                    ("lpos", (dpa, None)),
                    ("ck", (dpa, None, None, None)),
                    ("cv", (dpa, None, None, None)),
                    ("h", (dpa, None, None, None)),
                    ("tail_h", (dpa, None, None, None)),
                    ("conv", (dpa, None, None)),
                    ("tail_conv", (dpa, None, None)),
                ]
            else:
                rules = [
                    ("k", (B, None, TP, None)),
                    ("v", (B, None, TP, None)),
                    ("latent", (B, None, None)),
                    ("rope", (B, None, None)),
                    ("gk", (B, None, TP, None)),
                    ("gv", (B, None, TP, None)),
                    ("lk", (B, None, TP, None)),
                    ("lv", (B, None, TP, None)),
                    ("lpos", (B, None)),
                    ("ck", (B, None, TP, None)),
                    ("cv", (B, None, TP, None)),
                    ("h", (B, TP, None, None)),
                    ("tail_h", (B, TP, None, None)),
                    ("conv", (B, None, None)),
                    ("tail_conv", (B, None, None)),
                ]
        # patterns match the LAST path component
        rules = [("*" + name, spec) for name, spec in rules]
        return RuleSet(rules, default=())

    def _dpa_axes(self) -> Optional[Tuple[str, ...]]:
        """DP-attention batch axes for the monolithic baseline."""
        cand = self.bax + ("model",)
        if self.shape.global_batch % axis_size(self.mesh, cand) == 0:
            return cand
        return self.bax if self.batch_sharded else None

    # ------------------------------------------------------------------
    # what the port's sharded step places (see the module docstring)
    # ------------------------------------------------------------------
    @property
    def row_axes(self) -> Optional[Tuple[str, ...]]:
        """Axes the serve step's batch rows split over: the caches' batch
        axes (DP attention's under monolithic Type II)."""
        if self.name == "monolithic" and self.type_ii:
            return self._dpa_axes()
        return self.bax if self.batch_sharded else None

    @property
    def seq_split(self) -> bool:
        """Whether the step's attention cache is sequence-sharded over
        ``kv_seq_axes`` (every crosspool step, prefill and decode, Type I
        and Type II, of an arch whose cache holds a sequence, over more
        than one rank: the reference's cache rules; at one rank the plain
        attention reads the whole cache)."""
        return self.name == "crosspool" and not self.cfg.attn_free \
            and axis_size(self.mesh, self.kv_seq_axes) > 1

    @property
    def a2a(self) -> bool:
        """Whether the step's routed experts take ``make_moe_a2a``
        (``:318-323``; the reference's monolithic hooks leave it out)."""
        return (self.name in ("crosspool", "train") and self.perf.moe_a2a
                and self.cfg.is_moe and self.batch_sharded
                and self.cfg.n_experts % self.mesh.shape["data"] == 0)

    @property
    def head_split(self) -> bool:
        """Whether the serve step's cache splits its KV heads over
        ``model`` (monolithic Type I, ``cache_rules``)."""
        return self.name == "monolithic" and not self.type_ii

    @property
    def ssm_heads(self) -> bool:
        """Whether the serve step splits the SSM state's heads over
        ``model`` (the cache rules' ``h`` / ``tail_h``): where ``in_proj``'s
        columns split and the rows do not split over ``model`` (under DP
        attention a rank runs every head of its own rows)."""
        return (self.name != "train" and self.model_size > 1
                and bool(self._ssm_split_axes())
                and "model" not in self.mesh.axes_of(self.row_axes))

    def step_cache_rules(self) -> PlacedRules:
        """Batch rows over ``row_axes``, under ``seq_split`` the sequence
        over ``kv_seq_axes``, under ``head_split`` the KV
        heads over ``model`` and under ``ssm_heads`` the SSM state's: the
        cache rules' B, KT and TP entries, placed by the leaf's own layout.
        (The rules' patterns match the last path component with a leading
        ``*``, so ``*v`` also catches ``conv``, ``lv`` and ``cv``, ``*k``
        ``lk`` and ``ck``, and ``*h`` ``tail_h``: the reference's tables,
        kept verbatim, give those leaves the k/v (h) spec, aligned to other
        dimensions; so crosspool's ``ck`` / ``cv`` keep their rows only
        here, where the reference's table would put ``k``'s sequence split
        on them.)"""
        def keep(path, spec, shape):
            name = path.split("/")[-1]
            b = 2 if name in RING_LEAVES else 1
            want = [None] * len(shape)
            want[b] = self.row_axes
            if self.seq_split and name in SEQ_SPLIT_LEAVES:
                want[b + 1] = self.kv_seq_axes
            if self.head_split and name in KV_HEAD_LEAVES:
                want[-2] = "model"
            if self.ssm_heads and name in SSM_HEAD_LEAVES:
                want[b + 1] = "model"
            return safe_spec(self.mesh, shape, want)
        return PlacedRules(self.cache_rules(), keep)

    # ------------------------------------------------------------------
    # hooks
    # ------------------------------------------------------------------
    def _scale(self) -> float:
        if self.cfg.attention == "mla" and self.cfg.mla:
            return (self.cfg.mla.qk_nope_head_dim
                    + self.cfg.mla.qk_rope_head_dim) ** -0.5
        if self.cfg.head_dim:
            return self.cfg.head_dim ** -0.5
        return 1.0                      # attn-free: never used

    def _split_axes(self, path: str, shape, dims) -> Tuple[str, ...]:
        """The mesh axes (of more than one rank, in the mesh's order) the
        step's rules split ``dims`` of the leaf at ``path`` over."""
        spec = self.param_rules().spec_for(self.mesh, path, shape)
        used = {a for d in dims for a in self.mesh.axes_of(spec[d])}
        return tuple(a for a in self.mesh.axis_names
                     if a in used and self.mesh.shape[a] > 1)

    def _ffn_split_axes(self) -> Tuple[str, ...]:
        """Axes the decoder stack's dense FFN (a MoE's shared experts)
        splits its hidden over in the step: the last dim of its up
        projection."""
        cfg = self.cfg
        if cfg.is_moe:
            if not cfg.n_shared_experts:
                return ()
            path, f = "layers/moe/shared/wg", cfg.n_shared_experts * cfg.d_ff
        elif cfg.family in ("dense", "vlm", "audio", "hybrid"):
            w = "wg" if cfg.mlp_kind == "swiglu" else "wi"
            top = "shared_block" if cfg.family == "hybrid" else "layers"
            path, f = f"{top}/mlp/{w}", cfg.d_ff
        else:
            return ()
        shape = (cfg.d_model, f) if cfg.family == "hybrid" \
            else (cfg.n_layers, cfg.d_model, f)
        return self._split_axes(path, shape, (-1,))

    def _ssm_split_axes(self) -> Tuple[str, ...]:
        """Axes the SSM's projections split over in the step: the last dim
        of ``in_proj`` (``conv_w`` and ``out_proj`` split over the same)."""
        cfg = self.cfg
        if cfg.family not in ("ssm", "hybrid"):
            return ()
        return self._split_axes(
            "layers/ssm/in_proj",
            (cfg.n_layers, cfg.d_model, ssm_mod.proj_width(cfg)), (-1,))

    def _ssm_pool_axes(self) -> Tuple[str, ...]:
        """Axes the SSM's split projections are gathered and reduced over
        in the step: ``in_proj``'s (``_ssm_split_axes``), or, where its
        width does not split (mamba2's 3352 columns, zamba2's 8384, over
        256 ranks), those of ``conv_w``'s channels and ``out_proj``'s
        rows, which may still split (both over the same rule's axes)."""
        axes = self._ssm_split_axes()
        if axes or self.cfg.family not in ("ssm", "hybrid"):
            return axes
        cfg = self.cfg
        _, d_in, _, conv_dim, _ = ssm_mod._dims(cfg)
        used = set(self._split_axes(
            "layers/ssm/conv_w", (cfg.n_layers, cfg.ssm.conv_width, conv_dim),
            (-1,)))
        used.update(self._split_axes(
            "layers/ssm/out_proj", (cfg.n_layers, d_in, cfg.d_model), (1,)))
        return tuple(a for a in self.mesh.axis_names if a in used)

    def _expert_axes(self) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
        """(the axes the routed experts split over, the axes their ``f``
        splits over) in the step: monolithic (model, ()), crosspool
        (data, model)."""
        cfg = self.cfg
        shape = (cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff)
        return (self._split_axes("layers/moe/wg", shape, (1,)),
                self._split_axes("layers/moe/wg", shape, (3,)))

    def hooks(self) -> Hooks:
        """The step's hooks on a live mesh: the collectives the
        reference's partitioner derives, written out (the module
        docstring)."""
        m, cfg = self.mesh, self.cfg
        if m.coord is None:
            raise ValueError("Strategy.hooks() needs a live mesh")
        if self.name == "train":
            return self._train_hooks()
        rows = self.row_axes
        split = self._ffn_split_axes()
        ssm_split = self._ssm_pool_axes()

        def ffn_down(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
            # this rank's partial product in float32, summed over the
            # weights pool, rounded once: the one rounding of the whole
            # product (a partial rounded to bf16 on each rank would add
            # the pool's width in rounding errors)
            y = h.float() @ w.float()
            return m.all_reduce(y, split).to(torch.promote_types(h.dtype,
                                                                 w.dtype))

        def gather(x: torch.Tensor) -> torch.Tensor:
            return m.all_gather(x, rows, 0)

        def own_rows(x: torch.Tensor) -> torch.Tensor:
            return x[local_slices(m, x.shape, (rows,))]

        moe_apply = None
        if self.a2a:
            wg = self.param_rules().spec_for(
                m, "layers/moe/wg",
                (cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff))

            def pool_shared(p, x2):
                y = layers.apply_mlp(p, gather(x2), "swiglu",
                                     down=ffn_down if split else None)
                return own_rows(y)
            moe_apply = moe_a2a.make_moe_a2a(
                m, cfg, expert_axis="data", tp_axis=wg[-1],
                batch_axes=self.bax, f8_dispatch=self.perf.f8_dispatch,
                shared=pool_shared)

        # the pool boundary: crosspool's weights pool multiplies every row
        # (a split hidden or SSM projection needs them all; the capacity
        # MoE's experts live on other ranks); the a2a dispatch moves its
        # own tokens; under monolithic DP attention the rows of the rank's
        # model group meet its split FFN
        whole = tuple(a for a in m.axes_of(rows) if m.shape[a] > 1)
        if self.name == "crosspool":
            bnd = whole if moe_apply is None and (
                split or ssm_split or cfg.is_moe) else ()
        else:
            bnd = ("model",) if "model" in whole else ()
        hooks = {"tp": AxisGroup(m, "model")}
        if bnd:
            hooks.update(
                boundary_in=lambda x: m.all_gather(x, bnd, 0),
                boundary_out=lambda x: x[local_slices(m, x.shape, (bnd,))])
        if bnd == ("model",):
            hooks["rows"] = hooks["tp"]
            hooks["params"] = ParamShards(m, self.param_specs(), ("model",),
                                          (), only=DPA_GATHERED)
        elif ssm_split and ssm_split != ("model",):
            hooks["ssm"] = AxisGroup(m, ssm_split)
        if cfg.is_moe and moe_apply is None:
            left = tuple(a for a in whole if a not in bnd)
            if left:
                hooks["dp"] = AxisGroup(m, left)
            ep, f_ax = self._expert_axes()
            if ep and ep != ("model",):
                hooks["experts"] = AxisGroup(m, ep)
            routed = tuple(a for a in m.axis_names if a in ep + f_ax)
            if routed or split:
                def moe_sum(y: torch.Tensor, ys: Optional[torch.Tensor]
                            ) -> torch.Tensor:
                    # float32 partials over the pool, summed once
                    if ys is not None and split == routed:
                        return m.all_reduce(y + ys, routed)
                    y = m.all_reduce(y, routed)
                    return y if ys is None else y + m.all_reduce(ys, split)
                hooks["moe_sum"] = moe_sum
        decode_attn = decode_attn_mla = None
        kv_offset = 0
        if self.seq_split:
            # this rank's slice of a cache of ``shape.seq_len`` rows
            KT = self.kv_seq_axes
            n_kv = axis_size(m, KT)
            if self.shape.seq_len % n_kv:
                raise ValueError(f"cache length {self.shape.seq_len} does "
                                 f"not split over {KT} ({n_kv})")
            kv_offset = m.index(KT) * (self.shape.seq_len // n_kv)
        if self.seq_split and self.shape.is_decode:
            if cfg.attention == "mla":
                decode_attn_mla = seq_attention.make_seq_mla_decode_attn(
                    m, KT, rows, self._scale())
            else:
                decode_attn = seq_attention.make_seq_decode_attn(
                    m, KT, rows, self._scale())
        return Hooks(
            ffn_down=ffn_down if split else None,
            decode_attn=decode_attn, decode_attn_mla=decode_attn_mla,
            moe_apply=moe_apply, kv_offset=kv_offset, **hooks)

    def param_specs(self) -> dict:
        """{path: the rules' spec} of every param leaf (from the config's
        shapes alone)."""
        rules = self.param_rules()
        return {path_str(p): rules.spec_for(self.mesh, path_str(p),
                                            tuple(leaf.shape))
                for p, leaf in leaves_with_path(tfm.param_shapes(self.cfg))}

    def _train_hooks(self) -> Hooks:
        """The hooks of the sharded training step (the module docstring):
        the reference's ``act`` / ``attn_q`` / ``kv`` / ``ffn_hidden`` /
        ``moe_*`` / ``logits`` constraints (``:326-343``), as the
        collectives its partitioner derives from them."""
        cfg, m = self.cfg, self.mesh
        seq = (self.perf.seq_parallel
               and self.shape.seq_len % self.model_size == 0)
        tp, dp = AxisGroup(m, "model", seq=seq), AxisGroup(m, self.bax)
        moe_apply, expert_parallel = None, ()
        if cfg.is_moe and self.perf.moe_a2a:
            if not self.a2a:
                raise NotImplementedError(
                    f"{cfg.name}: the train moe_a2a variant needs the batch "
                    f"and the {cfg.n_experts} experts split over data")

            def shared(p, x2):
                y, partial = layers.apply_mlp_split(
                    p, x2, "swiglu", cfg.n_shared_experts * cfg.d_ff, tp)
                return tp.reduce(y) if partial else y
            moe_apply = moe_a2a.make_moe_a2a(
                m, cfg, expert_axis="data", tp_axis="model",
                batch_axes=self.bax, f8_dispatch=self.perf.f8_dispatch,
                shared=shared)
            expert_parallel = EXPERT_LEAVES
        return Hooks(params=ParamShards(m, self.param_specs(), self.pool,
                                        self.bax, expert_parallel),
                     tp=tp, dp=dp, moe_apply=moe_apply)

    # ------------------------------------------------------------------
    # input specs
    # ------------------------------------------------------------------
    def input_sharding(self, ndim: int) -> PartitionSpec:
        B = self.bax if self.batch_sharded else None
        return PartitionSpec(*((B,) + (None,) * (ndim - 1)))

    def scalar_sharding(self) -> PartitionSpec:
        return PartitionSpec()


def make_strategy(name: str, mesh: Mesh, cfg: ModelConfig,
                  shape: ShapeConfig,
                  perf: Optional[PerfOpts] = None) -> Strategy:
    if name == "auto":
        if shape.kind == "train":
            name = "train"
        elif shape.kind == "prefill":
            # paper §4: prefill runs on separate temporal-multiplexing
            # engines, NOT through the disaggregated pools — the
            # hidden-state boundary cost scales with batch*tokens and only
            # decode's tiny token counts amortize it.
            name = "monolithic"
        else:
            name = "crosspool"
    return Strategy(name, mesh, cfg, shape, perf or PerfOpts())
