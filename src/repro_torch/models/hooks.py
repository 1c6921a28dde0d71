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
  when the cache's sequence dimension is split; the new token's KV is
  written only by the rank that owns position ``lengths``.

Everything defaults to identity (offset 0) so the models run standalone
on one device, bit for bit as without the seam.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional


def _identity(x):
    return x


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


IDENTITY_HOOKS = Hooks()
