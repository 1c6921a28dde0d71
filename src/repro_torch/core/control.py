"""Control lowering: host-driven vs device-resident decode step execution.

Port of ``src/repro/core/control.py``.  The paper's §3.3 persistent
kernels keep the per-layer control loop on the device; the reference
compiles a decode step into ONE XLA program.  Here the same step body is
captured ONCE as a CUDA graph and replayed once per dispatch
(``DecodeGraph``): the host issues one replay per K-token block, the
layers, the attention->FFN ping-pong and the K inner steps all live in
the graph.  On the CPU there are no graphs and the same body runs
eagerly; it is the same code, not a fallback.

* ``StreamingPrefill`` — the prompt phase: per layer, full-sequence
  attention, the async upload of layer L+1's weight slabs behind it, the
  layer's prompt KV written into the shared paged pool, then the FFN
  gathered out of the arena once layer L's slabs have landed.  It can
  capture the prompt's MoE routing, and ``suffix`` prefills only the
  uncached tail of a prefix-cache hit (DESIGN.md §11).
* ``PagedFusedStep`` — lowering ON, one token: embed, every layer's paged
  attention + FFN, the logits and an optional ``postprocess`` in one
  replay.
* ``MultiStepFusedStep`` — lowering ON, K tokens per replay with sampling
  inside the graph.
* ``HostDrivenStep`` — lowering OFF (Table 3's baseline): every layer
  issues its attention stage and its FFN stage from the host, 2L+2
  dispatches a token.  On a card the FFN stages run on a second stream,
  the weights stream, and hidden states cross by ``pools.transfer``.
"""
from __future__ import annotations

import gc
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.pools import PooledModel, transfer
from repro_torch.kernels import ops as kops
from repro_torch.runtime.sampler import (gumbel_noise, sample_with_noise,
                                         step_generator)


def logit_index(true_len: Union[int, Sequence[int]], device=None
                ) -> Union[int, torch.Tensor]:
    """Last-prompt-position index for ``prefill_logits``: an int when every
    row shares one unpadded length, a [B] int32 tensor for a coalesced
    batch where each row carries its own."""
    if isinstance(true_len, (int, np.integer)):
        return int(true_len) - 1
    return torch.tensor([int(n) - 1 for n in true_len], dtype=torch.int32,
                        device=device)


def run_ffn(pooled: PooledModel, ffn_in: torch.Tensor, layer: int,
            w_stream=None, ffn: Optional[Callable] = None) -> torch.Tensor:
    """The weights-pool half of one layer: wait for the layer's slabs,
    gather them out of the arena and run the FFN (``ffn(arena,
    slot_table, ffn_in, layer)``, the model's ``ffn_stage`` unless
    given).  With ``w_stream`` (the host-driven lowering on a card) it
    runs on that stream: ``ffn_in`` must have crossed to it already
    (``transfer``, A-to-F) and the output crosses back (F-to-A), so the
    result is ready for the calling (KV) stream either way."""
    name, arena = pooled.cfg.name, pooled.arena
    ffn = ffn or pooled.stage_fns.ffn_stage
    if w_stream is None:
        arena.wait_layer(name, layer)
        return ffn(arena.arena, arena.slot_table(name), ffn_in, layer)
    kv_stream = torch.cuda.current_stream(ffn_in.device)
    with torch.cuda.stream(w_stream):
        arena.wait_layer(name, layer, w_stream)
        out = ffn(arena.arena, arena.slot_table(name), ffn_in, layer)
        return transfer(out, kv_stream)


class StreamingPrefill:
    """Arena-bounded prompt-phase execution with streamed weight uploads
    (DESIGN.md §6).  ``w_stream``: where the FFN stages run (host mode on
    a card), as ``run_ffn``.

    With ``capture_routes`` (an MoE model) a pass also records each
    layer's top-k expert choice, read back ONCE at the end (a prefill
    may read the device, a decode body never does):
    ``captured_routes`` [S, L, k] numpy int32, None otherwise."""

    def __init__(self, pooled: PooledModel, w_stream=None):
        self.pooled = pooled
        self.w_stream = w_stream
        self.captured_routes: Optional[np.ndarray] = None

    def _run(self, tokens: torch.Tensor, logit_idx, pool: torch.Tensor,
             writer, attn: Callable, ffn: Callable, capture_routes: bool
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The per-layer loop both passes share: ``attn(x, layer) -> (x,
        ffn_in, layer_kv)`` on the KV side, ``ffn`` on the weights side
        (as ``run_ffn``'s)."""
        name = self.pooled.cfg.name
        arena = self.pooled.arena
        fns = self.pooled.stage_fns
        p_kv = self.pooled.kv_params
        route = fns.prefill_route if capture_routes else None
        captured: List[torch.Tensor] = []
        self.captured_routes = None
        arena.activate(name, upload=False)
        arena.prefetch_layer(name, 0)        # first FFN never stalls long

        def ffn_and_route(abuf, table, h, layer):
            if route is not None:
                captured.append(route(abuf, table, h, layer))
            return ffn(abuf, table, h, layer)

        x = fns.prefill_embed(p_kv, tokens)
        for layer in range(fns.n_layers):
            x, ffn_in, layer_kv = attn(x, layer)
            # layer L+1's slabs upload while layer L's attention runs
            arena.prefetch_layer(name, layer + 1)
            if writer is not None:
                pool = writer(layer, layer_kv, pool)
            x = fns.combine(x, run_ffn(
                self.pooled, transfer(ffn_in, self.w_stream), layer,
                self.w_stream, ffn_and_route))
        logits = fns.prefill_logits(p_kv, x, logit_idx)
        if captured:
            # [L][1,S,k] -> [S, L, k]: one read-back for the whole pass
            self.captured_routes = torch.stack(
                [c[0] for c in captured], dim=1).cpu().numpy()
        return logits, pool

    def __call__(self, tokens: torch.Tensor, true_len, pool: torch.Tensor,
                 writer=None, *, capture_routes: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens [B,S] prompt ids; ``true_len`` the unpadded length (an
        int, or one per row); ``writer(layer, layer_kv, pool) -> pool``
        stores one layer's prompt KV in the shared pool.  Returns
        (logits [B,V], pool)."""
        fns, p_kv = self.pooled.stage_fns, self.pooled.kv_params
        return self._run(
            tokens, logit_index(true_len, tokens.device), pool, writer,
            lambda x, layer: fns.prefill_attn(p_kv, x, layer),
            fns.ffn_stage, capture_routes)

    def suffix(self, tokens: torch.Tensor, true_suffix_len: int, fork: int,
               kv_extent: int, prefix_rows: torch.Tensor, pool: torch.Tensor,
               writer=None, slot_offsets: Optional[np.ndarray] = None,
               capacity: int = 0, capture_routes: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Prefill ONLY the uncached suffix of a prompt (reference
        ``control.py:227``).

        tokens: [1, S_suf] suffix ids zero-padded to the suffix bucket;
        ``true_suffix_len`` its unpadded length (the logits row);
        ``fork`` the cached prefix's length; ``kv_extent`` the PRODUCING
        pass's prefill bucket; ``prefix_rows`` the ``[n_kv_layers, fork,
        *kv_shape]`` stack of ``KVVirtualizer.gather_prompt_rows``;
        ``writer`` stores the suffix's KV from token ``fork`` on (through
        the same pool write as a full pass); ``slot_offsets`` [L, E] the
        prefix's routed-pair counts and ``capacity`` the producing pass's
        expert capacity (MoE).  The offsets go to the device once.
        Returns (logits [1, V], pool)."""
        fns, p_kv = self.pooled.stage_fns, self.pooled.kv_params
        if fns.suffix_attn is None:
            raise ValueError(f"{self.pooled.cfg.name} has no suffix path")
        device = tokens.device
        B, S_suf = tokens.shape
        positions = (torch.arange(S_suf, device=device)[None, :]
                     + int(fork)).expand(B, S_suf)
        offsets = None if slot_offsets is None else torch.tensor(
            np.asarray(slot_offsets, np.int32), device=device)
        return self._run(
            tokens, logit_index(true_suffix_len, device), pool, writer,
            lambda x, layer: fns.suffix_attn(p_kv, x, prefix_rows, positions,
                                             layer, int(kv_extent)),
            lambda abuf, table, h, layer: fns.suffix_ffn(
                abuf, table, h, layer, offsets, int(capacity)),
            capture_routes)


# ---------------------------------------------------------------------------
# lowering ON: one CUDA graph replay per dispatch
# ---------------------------------------------------------------------------

class DecodeGraph:
    """One CUDA graph of a decode body, replayed once per dispatch.

    ``body(**static)`` returns one tensor.  Construction runs it once
    eagerly on a side stream (kernels are built at their first call and
    cached attributes set, which a capture must not do), puts the tensors
    of ``restore`` back as they were, then captures it into ``pool`` (a
    ``torch.cuda.graph_pool_handle()`` an engine shares among its decode
    graphs; they replay on one stream) with its result copied into
    ``output``, a tensor of its own outside that pool.  A call copies its
    inputs into the static buffers (host arrays through pinned staging, so
    nothing is read back) and replays: ``output`` then holds the result
    until the next call.

    The kernel wrappers count launches on the host, so a capture adds to
    ``kops.KERNELS``' counters once and a replay never: the capture's
    increase is taken back and added on every replay
    (``launches_per_replay``).
    """

    def __init__(self, body: Callable[..., torch.Tensor],
                 static: Dict[str, torch.Tensor], *,
                 restore: Sequence[torch.Tensor] = (), pool=None):
        device = next(iter(static.values())).device
        self.static = static
        self.staging = {k: torch.empty(v.shape, dtype=v.dtype,
                                       pin_memory=True)
                        for k, v in static.items()}
        self._staged: Optional[torch.cuda.Event] = None
        self.replays = 0
        saved = [t.clone() for t in restore]
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            warm = body(**static)
        torch.cuda.current_stream(device).wait_stream(side)
        self.output = torch.empty_like(warm)
        for t, s in zip(restore, saved):
            t.copy_(s)
        del warm, saved
        before = [f.launches for f in kops.KERNELS]
        self.graph = torch.cuda.CUDAGraph()
        # a dead object collected mid-capture (an earlier engine's graphs,
        # events or pinned buffers) would make CUDA calls that invalidate
        # the capture: collect first, and not again until it has ended
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, pool=pool):
                self.output.copy_(body(**static))
        finally:
            if collecting:
                gc.enable()
        self._deltas = [(f, f.launches - n)
                        for f, n in zip(kops.KERNELS, before)
                        if f.launches != n]
        for f, n in zip(kops.KERNELS, before):
            f.launches = n                # the capture launched nothing

    @property
    def launches_per_replay(self) -> Dict[str, int]:
        """Kernel launches one replay makes, by wrapper name."""
        return {f.__name__: n for f, n in self._deltas}

    def load(self, name: str, value) -> None:
        """Copy one input into its static buffer: a host array or CPU
        tensor through its pinned staging buffer (no host read), a device
        tensor directly; stream-ordered either way."""
        dst = self.static[name]
        src = torch.from_numpy(value) if isinstance(value, np.ndarray) \
            else value
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{name}: got {tuple(src.shape)}, the graph "
                             f"was captured for {tuple(dst.shape)}")
        if src.device.type == "cpu":
            stage = self.staging[name]
            stage.copy_(src)
            dst.copy_(stage, non_blocking=True)
        else:
            dst.copy_(src)

    def __call__(self, **inputs) -> torch.Tensor:
        if self._staged is not None:
            # the staging buffers are free again once the last copy-in ran
            # (long ago in a serving loop, which reads every block back)
            self._staged.synchronize()
        for name, value in inputs.items():
            self.load(name, value)
        self._staged = torch.cuda.Event()
        self._staged.record()
        self.graph.replay()
        for f, n in self._deltas:
            f.launches += n
        self.replays += 1
        return self.output


def _device_input(value, device) -> torch.Tensor:
    """An eager body's input on ``device`` (a host array is copied)."""
    if isinstance(value, np.ndarray):
        return torch.tensor(value, device=device)
    return value.to(device)


def _buffers(pool: torch.Tensor, arena: torch.Tensor) -> Tuple:
    """What a captured graph bakes in of the pool and the arena: their
    addresses and their shapes (a buffer of another size may come back
    at a freed one's address)."""
    return (pool.data_ptr(), tuple(pool.shape),
            arena.data_ptr(), tuple(arena.shape))


class _FusedStep:
    """What the fused steps share: ``body(pool, arena, slot_table,
    **inputs)`` runs eagerly on the CPU and as one replay of its CUDA
    graph on a card.  The graph is captured for one batch size and one
    page-table width (``capture``; at the first call otherwise) over the
    pool and arena it was given; a call with a pool or arena that moved
    or changed shape since raises (a stale address would be a wrong
    answer, not a crash).  After an elastic resize moved either, ``recapture`` (or
    ``release`` and the next call) captures the same body anew over the
    new tensors.  ``captures`` and ``replays`` count over every graph the
    step has had."""

    def __init__(self, pooled: PooledModel,
                 nonfinite_logits: Optional[torch.Tensor] = None,
                 graph_pool=None):
        self.pooled = pooled
        self.nonfinite_logits = nonfinite_logits
        self.graph_pool = graph_pool
        self.graph: Optional[DecodeGraph] = None
        #: the captured (pool, arena) buffers: addresses and shapes
        self._bufs: Optional[Tuple] = None
        self.captures = 0
        self.replays = 0
        #: host seconds of each capture (warm-up included)
        self.capture_s: List[float] = []

    def _count_nonfinite(self, logits: torch.Tensor) -> None:
        if self.nonfinite_logits is not None:
            self.nonfinite_logits += (~torch.isfinite(logits)).sum()

    def inactive_inputs(self, batch: int, max_pages: int, device
                        ) -> Dict[str, torch.Tensor]:
        """Static inputs of a block whose rows are all empty: no page is
        mapped (every table entry -1), so the capture's warm-up run writes
        nothing into the pool."""
        n_tables = self.pooled.view.n_kv_layers
        i32 = dict(dtype=torch.int32, device=device)
        return dict(tokens=torch.zeros(batch, **i32),
                    page_tables=torch.full((n_tables, batch, max_pages), -1,
                                           **i32),
                    lengths=torch.zeros(batch, **i32))

    def capture(self, batch: int, max_pages: int, pool: torch.Tensor
                ) -> None:
        """Capture the body for ``batch`` rows and ``max_pages`` table
        columns over ``pool`` and the model's static slot table."""
        t0 = time.perf_counter()
        name, arena = self.pooled.cfg.name, self.pooled.arena
        abuf, table = arena.arena, arena.static_table(name)
        restore = [] if self.nonfinite_logits is None \
            else [self.nonfinite_logits]
        self.graph = DecodeGraph(
            lambda **kw: self.body(pool, abuf, table, **kw),
            self.inactive_inputs(batch, max_pages, pool.device),
            restore=restore, pool=self.graph_pool)
        self._bufs = _buffers(pool, abuf)
        self.captures += 1
        self.capture_s.append(time.perf_counter() - t0)

    def release(self) -> None:
        """Drop the graph; its memory goes back to the shared graph pool
        now, before any new capture takes from it.  The next call (or
        ``recapture``) captures anew."""
        if self.graph is not None:
            self.graph.graph.reset()
        self.graph = None
        self._bufs = None

    def recapture(self, pool: torch.Tensor) -> bool:
        """If the pool or the arena moved since the capture (an elastic
        resize), capture again for the same batch and table width over
        the current tensors; returns whether it did."""
        if self.graph is None or self._bufs == _buffers(
                pool, self.pooled.arena.arena):
            return False
        _, batch, max_pages = self.graph.static["page_tables"].shape
        self.release()
        self.capture(batch, max_pages, pool)
        return True

    def _dispatch(self, pool: torch.Tensor, inputs: Dict) -> torch.Tensor:
        # residency, uploads and their ordering stay outside any graph
        abuf, table = self.pooled.arena.acquire(self.pooled.cfg.name)
        if pool.device.type != "cuda":
            return self.body(pool, abuf, table, **{
                k: _device_input(v, pool.device) for k, v in inputs.items()})
        if self.graph is None:
            _, batch, max_pages = inputs["page_tables"].shape
            self.capture(batch, max_pages, pool)
        if _buffers(pool, abuf) != self._bufs:
            raise RuntimeError(
                f"{self.pooled.cfg.name}: the KV pool or the weights arena "
                f"moved or changed shape since the decode graph was "
                f"captured")
        self.replays += 1
        return self.graph(**inputs)


class PagedFusedStep(_FusedStep):
    """Device-resident control (lowering ON) over the shared paged pool,
    one token: embed, every layer's paged attention + FFN and the logits
    (then ``postprocess``, e.g. greedy sampling) in ONE replay (reference
    ``control.py:289``)."""

    def __init__(self, pooled: PooledModel,
                 postprocess: Optional[Callable] = None, *,
                 nonfinite_logits: Optional[torch.Tensor] = None,
                 graph_pool=None):
        super().__init__(pooled, nonfinite_logits, graph_pool)
        self.postprocess = postprocess

    def body(self, pool, arena, slot_table, tokens, page_tables, lengths
             ) -> torch.Tensor:
        """The eager step: the pool is written in place; returns the
        logits [B,V] (or what ``postprocess`` makes of them)."""
        fns, p_kv = self.pooled.stage_fns, self.pooled.kv_params
        x = fns.embed(p_kv, tokens)
        for layer in range(fns.n_layers):
            x, ffn_in, pool = fns.attn_stage(p_kv, x, pool, page_tables,
                                             lengths, layer)
            x = fns.combine(x, fns.ffn_stage(arena, slot_table, ffn_in,
                                             layer))
        logits = fns.logits(p_kv, x)
        self._count_nonfinite(logits)
        return self.postprocess(logits) if self.postprocess else logits

    def __call__(self, tokens, pool: torch.Tensor, page_tables, lengths
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens [B]; pool; page_tables [L,B,P]; lengths [B] (host arrays
        or tensors).  Returns (logits [B,V] or ``postprocess(logits)``,
        pool).  On a card the first is the graph's output buffer, valid
        until the next call."""
        return self._dispatch(pool, dict(tokens=tokens,
                                         page_tables=page_tables,
                                         lengths=lengths)), pool


class MultiStepFusedStep(_FusedStep):
    """Multi-step decode: K tokens per host dispatch, sampled on the
    device, one replay a block (reference ``control.py:344``).

    Per-row freezing is the reference's (``control.py:393-416``, DESIGN.md
    §9): ``done0 = steps_left <= 0`` freezes inactive batch rows from step
    0; a row that samples its ``eos_id`` or exhausts its step budget flips
    ``done`` — later inner steps re-run its forward with frozen ``(token,
    length)``, emit -1, and its extra KV write lands on a -1 table entry
    (dropped) or in a reserved page that attention never reads and that
    ``commit_decode_block`` returns.  Valid tokens are a strict prefix of
    each ``[K]`` row.

    ``temperature > 0`` (with optional ``top_k``) draws Gumbel noise for
    the K inner steps from ``(seed, step)`` before the replay, into the
    graph's static buffer, and takes the argmax inside the graph; greedy
    draws nothing.  ``nonfinite_logits`` (the caller's device int64
    scalar) counts logits that were NaN or infinite, on the device.
    """

    def __init__(self, pooled: PooledModel, k: int,
                 nonfinite_logits: Optional[torch.Tensor] = None, *,
                 temperature: float = 0.0, top_k: int = 0,
                 graph_pool=None):
        if k < 1:
            raise ValueError(f"decode steps per dispatch must be >= 1, "
                             f"got {k}")
        super().__init__(pooled, nonfinite_logits, graph_pool)
        self.k = int(k)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.vocab = pooled.kv_params["embed"]["tok"].shape[0]

    def inactive_inputs(self, batch, max_pages, device):
        static = super().inactive_inputs(batch, max_pages, device)
        static["steps_left"] = torch.zeros(batch, dtype=torch.int32,
                                           device=device)
        static["eos_ids"] = torch.full((batch,), -1, dtype=torch.int32,
                                       device=device)
        if self.temperature > 0.0:
            static["noise"] = torch.zeros((self.k, batch, self.vocab),
                                          dtype=torch.float32, device=device)
        return static

    def draw_noise(self, seed: int, batch: int, device) -> torch.Tensor:
        """[K,B,V] Gumbel noise, inner step t from ``(seed, t)``."""
        return torch.stack([
            gumbel_noise((batch, self.vocab),
                         step_generator(seed, t, device), device=device)
            for t in range(self.k)])

    def body(self, pool, arena, slot_table, tokens, page_tables, lengths,
             steps_left, eos_ids, noise=None) -> torch.Tensor:
        """The eager block: the pool is written in place; returns token ids
        [K,B] int32, -1 past each row's valid prefix."""
        fns, p_kv = self.pooled.stage_fns, self.pooled.kv_params
        minus_one = torch.full_like(tokens, -1)
        toks, lens = tokens, lengths
        done = steps_left <= 0
        out = []
        for t in range(self.k):
            x = fns.embed(p_kv, toks)
            for layer in range(fns.n_layers):
                x, ffn_in, pool = fns.attn_stage(p_kv, x, pool, page_tables,
                                                 lens, layer)
                x = fns.combine(x, fns.ffn_stage(arena, slot_table, ffn_in,
                                                 layer))
            logits = fns.logits(p_kv, x)
            self._count_nonfinite(logits)
            sampled = sample_with_noise(
                logits, None if noise is None else noise[t],
                temperature=self.temperature, top_k=self.top_k)
            out.append(torch.where(done, minus_one, sampled))
            hit_eos = (~done) & (eos_ids >= 0) & (sampled == eos_ids)
            toks = torch.where(done, toks, sampled)
            lens = torch.where(done, lens, lens + 1)
            done = done | hit_eos | (steps_left <= t + 1)
        return torch.stack(out)

    def __call__(self, tokens, pool: torch.Tensor, page_tables, lengths,
                 steps_left, eos_ids=None, seed: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens [B]; pool; page_tables [L,B,P] PRE-EXTENDED to cover K
        tokens; lengths [B]; steps_left [B] int32 per-row budget (0
        freezes the row); eos_ids [B] int32, -1 disables EOS (host arrays
        or tensors); ``seed`` keys the draws of a temperature dispatch.
        Returns (token ids [K,B] int32, -1 past each row's valid prefix,
        pool).  On a card the first is the graph's output buffer, valid
        until the next call."""
        batch = len(tokens)
        if eos_ids is None:
            eos_ids = torch.full((batch,), -1, dtype=torch.int32)
        inputs = dict(tokens=tokens, page_tables=page_tables,
                      lengths=lengths, steps_left=steps_left,
                      eos_ids=eos_ids)
        if self.temperature > 0.0:
            inputs["noise"] = self.draw_noise(seed, batch, pool.device)
        return self._dispatch(pool, inputs), pool


# ---------------------------------------------------------------------------
# lowering OFF: per-layer host dispatch across the two pools
# ---------------------------------------------------------------------------

class HostDrivenStep:
    """Per-layer host dispatch across the two pools (lowering OFF,
    reference ``control.py:51``): the attention stages run on the calling
    (KV) stream, the FFN stages on ``w_stream`` when one is given (a
    card), with ``transfer`` at each crossing."""

    def __init__(self, pooled: PooledModel, w_stream=None):
        self.pooled = pooled
        self.w_stream = w_stream
        self.result: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def __call__(self, tokens: torch.Tensor, pool: torch.Tensor,
                 page_tables: torch.Tensor, lengths: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens [B]; pool [n_pages, page_elems]; page_tables [L,B,P];
        lengths [B].  Returns (logits [B,V], the pool, updated in
        place)."""
        for _ in self.stage_generator(tokens, pool, page_tables, lengths):
            pass
        return self.result

    def stage_generator(self, tokens, pool, page_tables, lengths):
        """Yield one pipeline stage at a time: ("attn"|"ffn", layer) after
        issuing that stage, then ("logits", -1); ``self.result`` then
        holds (logits, pool)."""
        fns, p_kv = self.pooled.stage_fns, self.pooled.kv_params
        self.pooled.arena.acquire(self.pooled.cfg.name)
        x = fns.embed(p_kv, tokens)
        for layer in range(fns.n_layers):
            x, ffn_in, pool = fns.attn_stage(p_kv, x, pool, page_tables,
                                             lengths, layer)
            yield ("attn", layer)
            ffn_out = run_ffn(self.pooled, transfer(ffn_in, self.w_stream),
                              layer, self.w_stream)
            yield ("ffn", layer)
            x = fns.combine(x, ffn_out)
        yield ("logits", -1)
        self.result = (fns.logits(p_kv, x), pool)


def dispatch_count(n_layers: int, fused: bool,
                   decode_steps: int = 1) -> int:
    """Host dispatches to commit ``decode_steps`` decode tokens (the
    ablation's control metric).  Fused lowering commits the whole K-token
    block in ONE dispatch (one graph replay); host-driven mode pays the
    full per-layer dispatch train per token."""
    if fused:
        return 1
    # embed + (attn + ffn + combine + 2 transfers) per layer + logits
    return (2 + n_layers * 5) * decode_steps
