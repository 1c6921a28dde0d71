"""Sharding hooks: the seam between the models and the distribution layer.

Port of ``src/repro/models/hooks.py``.  The models are written
sharding-agnostic; a :class:`Hooks` instance injects the distribution
layer at the logical points that matter for the paper's disaggregation:

* ``boundary_in`` / ``boundary_out`` — the CrossPool *pool boundary*:
  hidden states leaving the KV-cache pool (attention layout) for the
  weights pool (FFN layout) and back.  In the reference these are
  ``with_sharding_constraint`` closures and the partitioner emits the
  hidden-state transfer; here the sharded step (``launch/dryrun.py``
  ``build_serve_cell``) passes the collectives themselves: ``boundary_in``
  gathers the batch rows every rank of the weights pool multiplies,
  ``boundary_out`` takes this rank's rows back.
* ``kv`` — KV-cache placement; ``ffn_hidden`` / ``moe_*`` — weights-pool
  internal layouts.  Identity in the port: a rank holds its local shard
  already, so there is nothing to constrain.

Two fields have no field of their own in the reference, because its
partitioner derives them from the shardings; the explicit SPMD step has
to carry them:

* ``ffn_down`` — fn(h, w) -> the down projection of an FFN whose hidden
  dimension is split over the weights pool: each rank's ``h @ wd`` is a
  partial sum, which the reference's partitioner completes with a
  reduction after the product (``None``: the plain ``h @ w``).
* ``kv_offset`` — the global token index of this rank's first cache row
  when the cache's sequence dimension is split: a prefill writes the
  prompt's rows from that position on, and the new token's KV is
  written only by the rank that owns position ``lengths``.

The sharded training step (``launch/dryrun.py`` ``build_train_cell``)
places every leaf by the train rules, so the models also compute on
split weights.  Three more fields carry what its partitioner derives:

* ``params`` — the leaves' placement (:class:`WholeParams` here,
  ``sharding/strategies.py`` ``ParamShards`` in the step):
  ``gather(tree, path)`` is the per-layer FSDP gather of the leaves under
  ``path`` (the forward all-gathers a leaf's dims on the pool axes, the
  backward reduce-scatters its gradient); ``grad_mean(grads)`` is the
  data-parallel mean; ``leaf_stats`` reduces a per-leaf statistic over
  the axes the leaf is split on (the global norm, the int8 scale).
* ``tp`` — the collectives over ``model`` (:class:`LocalAxis` here,
  ``sharding/collectives.py`` ``AxisGroup`` in the step).  The models
  read what is split from their weights' local shapes: attention on this
  rank's heads with the output projection's partial sums reduced,
  experts over ``model`` with the combine reduced, the embedding and the
  head over the vocabulary (a lookup masks the ids the rank does not
  own; the loss reduces the max, the sum of exponentials and the gold
  logit), and, with ``tp.seq``, the residual stream's sequence split
  (``seq_in`` gathers it before a block, ``seq_out`` reduce-scatters the
  block's partial sums).
* ``dp`` — the collectives over the batch axes: the statistics the MoE
  routing takes over the whole (micro)batch (the capacity's slot
  offsets, the load-balance loss's means).

The sharded serve step (``build_serve_cell``) places every param leaf
by the serving rules and reuses ``params`` (the attention and SSM
leaves gathered under DP attention), ``tp`` (heads and vocabulary over
``model``) and ``dp`` (the capacity's slot offsets); four more fields
carry the rest:

* ``rows`` — the collectives over ``model`` when the batch rows split
  over it (monolithic DP attention): the vocabulary-split embedding and
  head gather the rows of the rank's ``model`` group, and the head
  returns this rank's rows over the whole vocabulary.
* ``experts`` — the collectives over the axes the routed experts split
  over when they are not ``tp``'s (crosspool's experts over ``data``,
  ``f`` over ``model``); ``None``: ``tp``.
* ``moe_sum`` — fn(routed [N,D] f32, shared [N,D] f32 or None) -> [N,D]
  f32: the experts' partial sums (split experts, split ``f``, a split
  shared expert) completed over the weights pool, in float32, so the
  FFN's output is rounded once (``None``: the unsharded combine).
* ``ssm`` — the collectives over the axes the SSM's projections split
  over (``in_proj``'s columns, ``conv_w``'s channels, ``out_proj``'s
  rows) when they are not ``tp``'s (crosspool's weights pool over
  ``tp_all``); ``None``: ``tp``.  The SSM state's heads split over
  ``tp`` (``models/ssm.py``).

Everything defaults to identity (offset 0) so the models run standalone
on one device, bit for bit as without the seam.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional


def _identity(x):
    return x


class LocalAxis:
    """A mesh axis of one rank: every collective is the identity.  The
    sharded step's ``AxisGroup`` (``sharding/collectives.py``) has these
    methods and the ones only a split reaches (``sum``, ``gather_sum``,
    ``max``, ``all_to_all``); its docstring gives each one's forward and
    backward."""

    size = 1
    index = 0
    seq = False          # the residual stream's sequence split over it

    def enter(self, x):
        return x

    def reduce(self, x):
        return x

    def gather(self, x, dim: int):
        return x

    def split(self, x, dim: int):
        return x

    def reduce_scatter(self, x, dim: int):
        return x

    def argmax(self, x):
        # the split argmax at one rank: torch.argmax's first maximum is
        # cp: allow(CP002) the sampler's greedy rule (runtime/sampler.py)
        return x.argmax(-1)

    # -- the sequence-parallel residual stream ([B, S, D], S on dim 1) ----
    def seq_in(self, x):
        """A block's input: the whole sequence (the backward takes this
        rank's part; split consumers ``enter`` it)."""
        return self.gather(x, 1) if self.seq else x

    def seq_out(self, y, partial: bool):
        """A block's output back to the residual layout: ``partial``
        sums are reduced (scattered over S under ``seq``); a whole output
        is split over S under ``seq``."""
        if partial:
            return self.reduce_scatter(y, 1) if self.seq else self.reduce(y)
        return self.split(y, 1) if self.seq else y

    def seq_weight(self, w):
        """A replicated weight that meets the S-split residual (a norm's):
        its gradient is partial there."""
        return self.enter(w) if self.seq else w

    def whole_seq(self):
        """These collectives with the residual stream whole (``seq``
        off): a block that reads its own stream unsplit (whisper's
        encoder under sequence parallelism)."""
        return self


class WholeParams:
    """Every leaf whole on every rank: nothing to gather or reduce."""

    def gather(self, tree, path: str):
        return tree

    def grad_mean(self, grads):
        return grads

    def leaf_stats(self, stats: dict, op: str = "sum") -> dict:
        """{path: this rank's statistic of the leaf} -> the statistic of
        the whole leaf."""
        return stats


LOCAL = LocalAxis()
WHOLE = WholeParams()


@dataclass(frozen=True)
class Hooks:
    act: Callable = _identity          # residual stream [B,S,D]
    attn_q: Callable = _identity       # query tensor [B,S,H,hd]
    attn_out: Callable = _identity     # attention output [B,S,D]
    kv: Callable = _identity           # KV-cache tensors (any per-layer layout)
    kv_state: Callable = _identity     # SSM recurrent state
    boundary_in: Callable = _identity  # hidden entering the weights pool
    boundary_out: Callable = _identity  # hidden returning to the KV-cache pool
    ffn_hidden: Callable = _identity   # dense MLP hidden [B,S,F]
    moe_inputs: Callable = _identity   # dispatched expert inputs [E,C,D]
    moe_hidden: Callable = _identity   # expert hidden [E,C,F]
    logits: Callable = _identity       # LM head output [B,S,V]
    # --- algorithm overrides (crosspool sequence-sharded decode) -----------
    # fn(q [B,1,H,D], cache_k, cache_v, lengths_incl [B]) -> out [B,1,H,D]
    decode_attn: Optional[Callable] = None
    # fn(q_lat, q_rope, cache_latent, cache_rope, lengths_incl) -> ctx_lat
    decode_attn_mla: Optional[Callable] = None
    # fn(moe_params, x [B,S,D]) -> (out, aux): explicit all-to-all dispatch
    moe_apply: Optional[Callable] = None
    # --- what the reference's partitioner derives (see the docstring) ------
    # fn(h [..,F_loc], w [F_loc,D]) -> out [..,D]: the split FFN's product
    ffn_down: Optional[Callable] = None
    kv_offset: int = 0                 # first cache row's token index
    # --- the sharded training step (see the docstring) ---------------------
    params: WholeParams = WHOLE        # FSDP gather, DP mean, leaf statistics
    tp: LocalAxis = LOCAL              # collectives over 'model'
    dp: LocalAxis = LOCAL              # collectives over the batch axes
    # --- the sharded serve step (see the docstring) ------------------------
    rows: LocalAxis = LOCAL            # 'model' when the rows split over it
    experts: Optional[LocalAxis] = None  # the routed experts' split (tp)
    # fn(routed f32, shared f32 | None) -> f32: the pool's partial sums
    moe_sum: Optional[Callable] = None
    ssm: Optional[LocalAxis] = None    # the SSM projections' split (tp)


IDENTITY_HOOKS = Hooks()
