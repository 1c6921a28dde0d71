"""Online serving session primitives: handles, token events, prefill batching.

The engine's front-end is event-driven (DESIGN.md §7): callers ``submit``
requests one at a time and drive ``step`` — there is no offline trace.
This module holds the request-level objects that API hands out:

* :class:`RequestHandle` — the caller's view of one submitted request.
  The admission controller's verdict (admit / queue / reject — the
  front door's backpressure) is visible on the handle immediately after
  ``submit`` instead of being buried in engine internals, and per-token
  streaming arrives through the handle's ``on_token`` callback.
* :class:`TokenEvent` — one generated token: which request, which
  position in its stream, at what engine time, and whether it is the
  first (TTFT) or last (stream-done) token.  The event contract is
  per-token even when the engine commits K tokens per dispatch
  (DESIGN.md §9): a committed K-block fans out as K events with
  timestamps interpolated across the block's wall time, so streaming
  callbacks and TBT accounting never see the block structure.
* :class:`RebalanceEvent` — one applied elastic boundary move (the
  session-facing view of ``core.elastic.RebalanceDecision``): how many
  device bytes moved between the KV page pool and the weight arena, and
  what it cost (pages swapped to the host tier, models evicted).
* :class:`PrefillBatcher` — the arrival-coalescing phase of the step
  loop.  Admitted same-model requests whose prompts quantize to the SAME
  bucket are packed into one ``[B, S]`` :class:`PrefillGroup` and execute
  as a single streaming-prefill pass; per-request expert routing keeps a
  coalesced pass bit-exact with B separate ``[1, S]`` passes (see
  ``split_exec.make_stage_fns``).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.runtime.request import Request


class HandleState(enum.Enum):
    """Lifecycle of a submitted request, as seen through its handle.

    ``QUEUED`` and ``REJECTED`` surface the admission controller's
    backpressure; ``ADMITTED`` means pages are mapped and the weight pin
    is held but the request has not reached a batch slot yet;
    ``DECODING`` covers prefill-committed through last token.
    """

    QUEUED = "queued"
    ADMITTED = "admitted"
    DECODING = "decoding"
    FINISHED = "finished"
    REJECTED = "rejected"
    CANCELLED = "cancelled"

    @property
    def terminal(self) -> bool:
        return self in (HandleState.FINISHED, HandleState.REJECTED,
                        HandleState.CANCELLED)


@dataclass
class TokenEvent:
    """One generated token, as surfaced by ``step``/``on_token``."""

    request_id: int
    model: str
    token: int
    index: int                  # 0-based position in the output stream
    time: float                 # engine virtual time of emission
    first: bool = False         # the TTFT token (sampled by prefill)
    done: bool = False          # stream complete with this token


@dataclass(frozen=True)
class RebalanceEvent:
    """One applied elastic KV<->weights boundary move (DESIGN.md §8).

    Emitted at the step boundary that applied it; ``kv_delta_bytes`` is
    positive when the KV pool grew at the arena's expense.  The sum of
    the two pools' device bytes is invariant across events (byte
    conservation is the rebalancer's contract).
    """

    step: int
    time: float                  # engine virtual time of application
    page_budget: Tuple[int, int]     # (old, new) KV pool pages
    slot_budget: Tuple[int, int]     # (old, new) arena slabs
    kv_delta_bytes: int
    swapped_out: int             # pages pushed to the host swap tier
    evicted_models: int          # idle models LRU-evicted from the arena
    reason: str                  # "kv_demand" | "weight_demand"


@dataclass
class RequestHandle:
    """Caller-side view of one submitted request.

    ``admission`` is the front door's verdict at submit time ("admitted"
    / "queued" / "rejected") and never changes; ``state`` tracks the live
    lifecycle (a queued request that later drains moves to ``ADMITTED``).
    """

    request: Request
    admission: str
    state: HandleState
    on_token: Optional[Callable[[TokenEvent], None]] = None
    # prefix-cache outcome, set at admission (DESIGN.md §11): how many
    # leading prompt tokens were served from the radix tree (0 for
    # cache-off, cache-ineligible — synthetic prompts — or a cold miss)
    cached_tokens: int = 0
    cache_hit: bool = False
    _engine: object = field(default=None, repr=False)

    @property
    def request_id(self) -> int:
        return self.request.request_id

    @property
    def model(self) -> str:
        return self.request.model

    @property
    def tokens(self) -> List[int]:
        """Tokens streamed so far (grows between ``step`` calls)."""
        return list(self.request.output_ids)

    @property
    def done(self) -> bool:
        return self.state.terminal

    def cancel(self) -> bool:
        """Cancel through the owning engine (see ``CrossPoolEngine.cancel``)."""
        return self._engine.cancel(self)


# ---------------------------------------------------------------------------
# prefill coalescing
# ---------------------------------------------------------------------------

#: Prompt-length quantization ladder shared with the seed engine: a prompt
#: occupies the smallest bucket >= its length (capped at max_ctx), so the
#: compiled prefill programs see a handful of static shapes.
PREFILL_BUCKETS = (16, 32, 64, 128, 256, 512)


def prompt_bucket(n: int, max_ctx: int) -> int:
    for b in PREFILL_BUCKETS:
        if n <= b and b <= max_ctx:
            return b
    return max_ctx


@dataclass
class PrefillGroup:
    """Same-model, same-bucket requests coalesced into one [B, S] pass.

    ``ids[i]`` is row i's prompt (synthetic or real, already truncated to
    the bucket); ``n_writes[i]`` is how many of those tokens are real —
    the row's prompt-KV write length and logit position.
    """

    model: str
    bucket: int
    requests: List[Request] = field(default_factory=list)
    ids: List[np.ndarray] = field(default_factory=list)
    n_writes: List[int] = field(default_factory=list)
    # prefix-cache suffix group (DESIGN.md §11): ``fork`` > 0 marks a B=1
    # group whose first ``fork`` prompt tokens are mapped from the radix
    # tree — ``ids[0]`` then holds only the SUFFIX, padded to
    # ``suffix_bucket``, while ``bucket`` stays the FULL prompt's bucket
    # (the cache key and the suffix pass's KV reduction extent)
    fork: int = 0
    suffix_bucket: int = 0

    @property
    def batch_size(self) -> int:
        return len(self.requests)

    def tokens(self) -> np.ndarray:
        """[B, bucket] int32 prompt ids."""
        return np.stack(self.ids).astype(np.int32)

    def true_lens(self):
        """Per-row unpadded lengths: host int for B=1 (the seed trace
        shape), a list for a genuinely coalesced batch."""
        if len(self.n_writes) == 1:
            return self.n_writes[0]
        return list(self.n_writes)


class PrefillBatcher:
    """Select admitted requests for this step and coalesce their prompts.

    Selection mirrors the seed engine's loop exactly — requests are considered
    in waiting order, capped per model by the runner's free batch slots,
    and a cold model that cannot activate under arena pressure stays
    waiting — then selected requests are grouped by (model, bucket) in
    first-seen order.  Prompt ids are drawn (or taken from
    ``request.prompt_ids``) at SELECTION time in waiting order, so the
    id stream is independent of how groups later execute (sequentially,
    batched, or interleaved through the pipeline scheduler).
    """

    def __init__(self, observer=None):
        # optional runtime.observe.EngineObserver: counts WHY a waiting
        # request was deferred this step (batch slots full vs. residency
        # gate) — None is the zero-overhead default
        self.observer = observer

    def plan(self, waiting: List[Request], runners: Dict[str, object],
             rng: np.random.Generator,
             try_activate: Callable[[Request], bool],
             forks: Optional[Dict[int, int]] = None,
             ) -> Tuple[List[PrefillGroup], List[Request]]:
        """Returns (groups in first-seen order, still-waiting requests).

        ``try_activate(request)`` is the engine's residency gate: weight
        slabs mapped for the model AND any host-swapped KV pages faulted
        back in for the request — False keeps the request waiting (pins
        drop and pages free as other requests finish).

        ``forks`` maps request_id -> cached-prefix length for prefix-cache
        hits: such a request becomes its own B=1 SUFFIX group (keyed by
        its id so it never coalesces — its shapes are fork-specific) whose
        ids cover only the uncached tail, padded to the tail's bucket."""
        groups: Dict[Tuple, PrefillGroup] = {}
        still: List[Request] = []
        taken: Dict[str, int] = {}
        obs = self.observer
        for req in waiting:
            runner = runners[req.model]
            free = sum(1 for s in runner.slots if s is None)
            if free == 0 or taken.get(req.model, 0) >= free:
                still.append(req)
                if obs is not None:
                    obs.batcher_deferral(req.model, "slots")
                continue
            if not try_activate(req):
                still.append(req)
                if obs is not None:
                    obs.batcher_deferral(req.model, "residency")
                continue
            taken[req.model] = taken.get(req.model, 0) + 1
            bucket = prompt_bucket(req.prompt_tokens, runner.max_ctx)
            fork = (forks or {}).get(req.request_id, 0)
            if fork > 0:
                real = np.asarray(req.prompt_ids, np.int32).reshape(-1)
                n_suf = req.prompt_tokens - fork
                s_bucket = prompt_bucket(n_suf, runner.max_ctx)
                ids = np.zeros(s_bucket, np.int32)
                ids[:n_suf] = real[fork:req.prompt_tokens]
                g = PrefillGroup(req.model, bucket, fork=fork,
                                 suffix_bucket=s_bucket)
                groups[(req.model, bucket, req.request_id)] = g
                g.requests.append(req)
                g.ids.append(ids)
                g.n_writes.append(n_suf)
                continue
            ids, n_write = self._prompt_ids(req, runner.cfg, bucket, rng)
            key = (req.model, bucket)
            g = groups.get(key)
            if g is None:
                g = groups[key] = PrefillGroup(req.model, bucket)
            g.requests.append(req)
            g.ids.append(ids)
            g.n_writes.append(n_write)
        return list(groups.values()), still

    @staticmethod
    def _prompt_ids(req: Request, cfg, bucket: int,
                    rng: np.random.Generator) -> Tuple[np.ndarray, int]:
        """(row ids [bucket], real-token count).  Prompts longer than the
        bucket are truncated to it, exactly as the seed dense prefill's
        fixed-width cache slice did."""
        if req.prompt_ids is not None:
            real = np.asarray(req.prompt_ids, np.int32).reshape(-1)
            # pages were mapped and the batch-slot length will be set from
            # ``prompt_tokens`` — a mismatched id array would scatter KV
            # past the mapped pages (or attend over never-written ones)
            assert len(real) == req.prompt_tokens, (
                f"request {req.request_id}: prompt_ids length {len(real)} "
                f"!= prompt_tokens {req.prompt_tokens}")
            n = min(req.prompt_tokens, bucket)
            ids = np.zeros(bucket, np.int32)
            ids[:n] = real[:n]
            return ids, n
        ids = rng.integers(0, cfg.vocab_size, bucket).astype(np.int32)
        return ids, min(req.prompt_tokens, bucket)
