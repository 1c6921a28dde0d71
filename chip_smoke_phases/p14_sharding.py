"""Phase 14 of ``chip_smoke.py``: the sharding layer on
``torch.distributed``: (a) on a one-rank NCCL group, moonshot-v1-16b-a3b
at published widths (bf16, as many of its 48 layers as 40% of the free
memory holds): 4 prompts of 1024 tokens prefilled through
``build_serve_cell`` under ``make_strategy("auto")`` (monolithic,
flash), then 8 decode steps under crosspool with the all-to-all expert
dispatch on the contiguous kernel route, against the unsharded Model
path with the same params: greedy tokens equal, logits within the row
limit, flash launched once per layer a prefill and contiguous decode
once per layer a step in both runs, ms a decode step both ways; (b)
minicpm3-4b at its published config (62 layers), one request whose
32768-token latent / rope cache comes from a seeded generator, split
over four processes sharing the card over gloo (crosspool on a (1, 4)
mesh: the sequence-sharded MLA decode, each rank 8192 tokens of the
cache, its heads of the attention, a quarter of the vocabulary and of
the dense FFN): ``POOL_STEPS`` decode steps fed the same decode's tokens
at one rank on the whole cache, in bf16 (every rank exits 0 with finite
logits and a quarter of the one rank's cache bytes; the token and logit
agreement printed) and then in float32 with the gate: tokens equal,
logits within the row limit; its times are a one-card rehearsal.
"""
from __future__ import annotations

import gc
import json
import time
from pathlib import Path

from chip_smoke_phases.common import (BF16_ROW_RMS, _spawn_ranks,
                                      check_counts, log, open_group,
                                      read_launches, reset_launches, row_error,
                                      rows_close_or_raise, sync)


#: the share of the card's free memory phase 14a's weights may take: the
#: init stacks the per-layer leaves, so it holds them twice at its peak
SHARD_MEMORY_SHARE = 0.4
#: phase 14a: moonshot at published widths through the sharded step on a
#: one-rank NCCL group; the decode's capacity factor gives the capacity
#: route 8 slots an expert for 4 tokens (4 x 6 x 20 / 64 = 7.5), the same
#: as the all-to-all's local dispatch (``C3``), so neither drops a pair
SHARD_MODEL, SHARD_BATCH, SHARD_PROMPT, SHARD_STEPS = (
    "moonshot-v1-16b-a3b", 4, 1024, 8)
SHARD_DECODE_CAPACITY = 20.0
#: phase 14b: minicpm3-4b at its published config, one request's cache of
#: POOL_CTX tokens split over POOL_RANKS processes sharing the card (gloo),
#: POOL_STEPS decode steps (a four-rank step of the 62 layers takes ~4 s
#: of gloo staging)
POOL_MODEL, POOL_CTX, POOL_RANKS, POOL_STEPS = "minicpm3-4b", 32768, 4, 2
#: seconds phase 14b's ranks may take, start to end
POOL_TIMEOUT = 300
#: phase 14b's equality gate runs the model in float32: in bf16 the
#: four-rank and one-rank decodes round their partial sums in another
#: order, and a one-ulp difference in one layer's output grows, layer by
#: layer, past the row limit and into other greedy tokens (the bf16 run
#: beside it measures how far; PERF.md)
POOL_GATE_DTYPE = "float32"


def _fit_depth(torch, cfg) -> int:
    """The most layers of ``cfg`` whose whole tree fits
    ``SHARD_MEMORY_SHARE`` of the card's free memory (phase 14a's rule)."""
    from repro_torch.launch import dryrun
    from repro_torch.training.tree import leaves
    one = dryrun.param_shapes(cfg.replace(n_layers=1))
    two = dryrun.param_shapes(cfg.replace(n_layers=2))
    nbytes = [sum(t.numel() * t.element_size() for t in leaves(p))
              for p in (one, two)]
    layer, rest = nbytes[1] - nbytes[0], 2 * nbytes[0] - nbytes[1]
    free = torch.cuda.mem_get_info()[0]
    return min(cfg.n_layers, int((free * SHARD_MEMORY_SHARE - rest) // layer))


def _seeded_params(torch, model, device, seed=0):
    return model.init(torch.Generator(device=device).manual_seed(seed))


def _cell_shape(kind, seq_len, batch):
    from dataclasses import replace
    from repro_torch.configs import SHAPES_BY_NAME
    name = {"prefill": "prefill_32k", "decode": "decode_32k"}[kind]
    return replace(SHAPES_BY_NAME[name], seq_len=seq_len, global_batch=batch)


def _decode_steps(torch, step, params, cache, tokens, lengths, steps,
                  device, forced=None, greedy=None):
    """``steps`` decode steps of ``step(params, tok, cache, lengths)``:
    greedy (``greedy(logits)``, default the argmax), or fed ``forced[i]``
    at step i (the other run's tokens).  Returns (logits per step [steps,
    B, V] float32, greedy tokens [steps, B], ms a step); the card is
    synchronised around the run."""
    logits_all, toks = [], []
    tok = tokens
    sync(torch, device)
    t0 = time.perf_counter()
    for i in range(steps):
        logits, _ = step(params, tok, cache, lengths)
        logits_all.append(logits.float())
        toks.append((logits.argmax(-1) if greedy is None
                     else greedy(logits)).to(torch.int32))
        tok = toks[-1] if forced is None else forced[i]
        lengths = lengths + 1
    sync(torch, device)
    ms = (time.perf_counter() - t0) * 1e3 / steps
    return torch.stack(logits_all), torch.stack(toks), ms


def _agree(torch, what, got_logits, got_toks, want_logits, want_toks):
    """Greedy tokens equal and every logit row within ``BF16_ROW_RMS``;
    returns the largest row error."""
    if not torch.equal(got_toks, want_toks):
        raise AssertionError(f"{what}: greedy tokens differ: "
                             f"{got_toks.tolist()} vs {want_toks.tolist()}")
    return rows_close_or_raise(what, got_logits, want_logits)


def sharding_one_rank(torch, kops, device="cuda", cfg=None, depth=None):
    """(14a) The sharded step on a one-rank group at published widths:
    moonshot (bf16, as many layers as ``SHARD_MEMORY_SHARE`` of the free
    memory holds), ``SHARD_BATCH`` prompts of ``SHARD_PROMPT`` tokens.
    The prefill goes through ``build_serve_cell`` under
    ``make_strategy("auto")`` (monolithic) with ``impl="flash"``, then
    ``SHARD_STEPS`` decode steps under crosspool with
    ``PerfOpts(moe_a2a=True)`` on the contiguous kernel route; the same
    params through the unsharded Model path (identity hooks) give the
    reference: greedy tokens equal (the sharded decode is fed the
    reference's tokens), logits within ``BF16_ROW_RMS``, and rows 3-4
    launched once per layer a prefill / a step in both runs.  Needs an
    initialized one-rank process group."""
    from dataclasses import replace
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.model import build_model
    from repro_torch.sharding.strategies import PerfOpts, make_strategy
    from repro_torch.training.tree import leaves

    on_card = torch.device(device).type == "cuda"
    cfg = cfg or get_config(SHARD_MODEL)
    if depth is None:
        depth = _fit_depth(torch, cfg)
    cfg = cfg.replace(n_layers=depth)
    cfg_dec = cfg.replace(capacity_factor=SHARD_DECODE_CAPACITY)
    B, S, steps = SHARD_BATCH, SHARD_PROMPT, SHARD_STEPS
    T = S + steps
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = _seeded_params(torch, model, device)
    sync(torch, device)
    n_params = sum(t.numel() for t in leaves(params))
    log(f"sharding 14a: {SHARD_MODEL} published widths, {depth} of "
        f"{get_config(SHARD_MODEL).n_layers} layers ({cfg.dtype}, "
        f"{n_params / 1e9:.3f} B params drawn in "
        f"{time.perf_counter() - t0:.1f} s), B={B} prompts of {S} tokens, "
        f"{steps} decode steps; decode capacity factor "
        f"{SHARD_DECODE_CAPACITY}")
    gen = torch.Generator(device=device).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device=device, dtype=torch.int32)
    lengths = torch.full((B,), S, dtype=torch.int32, device=device)

    # the reference: the unsharded Model path, identity hooks
    cache = model.init_cache(B, T, device)
    reset_launches(kops)
    ref0, _ = model.prefill(params, tokens, cache, impl="flash")
    sync(torch, device)
    pre_ref = read_launches(kops)
    model_dec = build_model(cfg_dec)

    def unsharded(p, tok, c, lens):
        return model_dec.decode_step(p, tok, c, lens, impl="paged")
    reset_launches(kops)
    ref_logits, ref_toks, ref_ms = _decode_steps(
        torch, unsharded, params, cache, ref0.argmax(-1).to(torch.int32),
        lengths, steps, device)
    dec_ref = read_launches(kops)
    del cache

    # the sharded step on a (1, 1) mesh over the live group
    mesh = Mesh((1, 1), ("data", "model"), live=True)
    st_pre = make_strategy("auto", mesh, cfg, _cell_shape("prefill", T, B))
    st_dec = make_strategy("auto", mesh, cfg_dec,
                           _cell_shape("decode", T, B),
                           PerfOpts(moe_a2a=True))
    if (st_pre.name, st_dec.name, st_dec.a2a) != \
            ("monolithic", "crosspool", True):
        raise AssertionError(f"sharding 14a: strategies {st_pre.name} / "
                             f"{st_dec.name}, a2a {st_dec.a2a}")
    prefill = dryrun.build_serve_cell(cfg, st_pre.shape, st_pre,
                                      impl="flash")
    cache = dryrun.shard_cache(st_pre, model.init_cache(B, T, device))
    reset_launches(kops)
    got0, cache = prefill(dryrun.shard_params(st_pre, params),
                          dryrun.local_rows(st_pre, tokens), cache)
    sync(torch, device)
    pre = read_launches(kops)
    step = dryrun.build_serve_cell(cfg_dec, st_dec.shape, st_dec,
                                   impl="paged")
    reset_launches(kops)
    logits, toks, ms = _decode_steps(
        torch, step, dryrun.shard_params(st_dec, params),
        dryrun.shard_cache(st_dec, cache), got0.argmax(-1).to(torch.int32),
        dryrun.local_rows(st_dec, lengths), steps, device,
        forced=ref_toks)
    dec = read_launches(kops)
    err_pre = _agree(torch, "sharding 14a prefill", got0.float()[None],
                     got0.argmax(-1)[None], ref0.float()[None],
                     ref0.argmax(-1)[None])
    err_dec = _agree(torch, "sharding 14a decode", logits, toks, ref_logits,
                     ref_toks)
    if on_card:
        for label, got in (("unsharded prefill", pre_ref),
                           ("sharded prefill", pre)):
            check_counts(f"sharding 14a {label}", got,
                         {"flash_attention": depth, "decode_attention": 0})
        for label, got in (("unsharded decode", dec_ref),
                           ("sharded decode", dec)):
            check_counts(f"sharding 14a {label}", got,
                         {"flash_attention": 0,
                          "decode_attention": depth * steps})
    out = dict(model=SHARD_MODEL, depth=depth, params=n_params, batch=B,
               prompt=S, steps=steps, decode_capacity=SHARD_DECODE_CAPACITY,
               strategies=[st_pre.name, st_dec.name],
               decode_ms_sharded=ms, decode_ms_unsharded=ref_ms,
               max_row_rms_prefill=err_pre, max_row_rms_decode=err_dec,
               tokens=ref_toks.tolist(),
               launches_prefill_unsharded=pre_ref, launches_prefill=pre,
               launches_decode_unsharded=dec_ref, launches_decode=dec)
    log(f"sharding 14a: tokens equal over {steps} steps, logit rows within "
        f"{max(err_pre, err_dec):.3g} (limit {BF16_ROW_RMS}); decode "
        f"{ms:.2f} ms/step sharded, {ref_ms:.2f} unsharded; launches: "
        f"prefill flash {pre['flash_attention']} (unsharded "
        f"{pre_ref['flash_attention']}), decode contiguous "
        f"{dec['decode_attention']} ({dec_ref['decode_attention']})")
    return out


def _pool_shards(torch, mesh, cfg, ctx, device):
    """minicpm3's params (seed 0) and a ``ctx``-token latent / rope cache
    (seed 1) for B = 1, drawn whole on ``device`` (the same numbers in
    every process), then cut to this rank's shards under crosspool on
    ``mesh``.  Returns (strategy, params, cache)."""
    from repro_torch.launch import dryrun
    from repro_torch.models.model import build_model
    from repro_torch.sharding.strategies import make_strategy
    model = build_model(cfg)
    params = _seeded_params(torch, model, device)
    gen = torch.Generator(device=device).manual_seed(1)
    cache = model.init_cache(1, ctx, device)
    for leaf in cache.values():
        leaf.copy_(torch.randn(leaf.shape, generator=gen, device=device,
                               dtype=torch.float32))
    st = make_strategy("auto", mesh, cfg, _cell_shape("decode", ctx, 1))
    return st, dryrun.shard_params(st, params), dryrun.shard_cache(st, cache)


def _pool_decode(torch, st, params, cache, cfg, tok0, device, forced=None):
    """``POOL_STEPS`` decode steps of the request from ``ctx -
    POOL_STEPS`` tokens: the cache ends full."""
    from repro_torch.launch import dryrun
    step = dryrun.build_serve_cell(cfg, st.shape, st)
    lengths = torch.full((1,), st.shape.seq_len - POOL_STEPS,
                         dtype=torch.int32, device=device)
    return _decode_steps(torch, step, params, cache, tok0, lengths,
                         POOL_STEPS, device, forced=forced,
                         greedy=lambda logits: dryrun.greedy(st, logits))


def _pool_rank(rank, tmp, device, runs):
    """One of phase 14b's ranks (in its gloo group): for each of
    ``runs`` ((cfg, gate)) in turn, draws the model and the cache (one
    rank at a time, so one whole tree is alive on the card at once),
    keeps its shards, then decodes fed the one-rank run's tokens and
    writes what it measured (its logits gathered over the vocabulary
    split); with ``gate`` its greedy tokens and logit rows must agree
    with the one-rank run's."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh
    mesh = Mesh((1, POOL_RANKS), ("data", "model"), live=True)
    for i, (cfg, gate) in enumerate(runs):
        ref = torch.load(f"{tmp}/pool_ref{i}.pt")
        for r in range(POOL_RANKS):
            if r == rank:
                st, params, cache = _pool_shards(torch, mesh, cfg,
                                                 ref["ctx"], device)
                gc.collect()                 # the whole trees go here
                if device == "cuda":
                    torch.cuda.empty_cache()
            dist.barrier()
        logits, toks, ms = _pool_decode(
            torch, st, params, cache, cfg, ref["tok0"].to(device), device,
            forced=ref["tokens"].to(device))
        # the whole rows from the ranks' vocabulary shards (gloo, host)
        logits = mesh.all_gather(logits.cpu(), "model", -1)
        toks = toks.cpu()
        if gate:
            _agree(torch, f"sharding 14b {cfg.dtype} rank {rank}", logits,
                   toks, ref["logits"], ref["tokens"])
        out = dict(rank=rank, coord=list(mesh.coord), ms=ms,
                   max_row_rms=row_error(logits, ref["logits"]),
                   tokens_equal=int((toks == ref["tokens"]).sum()),
                   finite=bool(torch.isfinite(logits).all()),
                   seq_split=st.seq_split, kv_offset=st.hooks().kv_offset,
                   param_bytes=dryrun.resident_bytes(params),
                   cache_bytes=dryrun.resident_bytes(cache))
        with open(f"{tmp}/pool_rank{rank}_{i}.json", "w") as f:
            json.dump(out, f)
        del st, params, cache, logits
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        dist.barrier()


def sharding_pools(torch, tmp, runs, device="cuda", ctx=POOL_CTX) -> list:
    """(14b) One request's KV over the pool, for each of ``runs`` ((cfg,
    gate)): minicpm3-4b at its published config (62 layers) in
    ``cfg.dtype``, one request (B = 1) whose ``ctx``-token latent / rope
    cache comes from a seeded generator, crosspool on a (1,
    ``POOL_RANKS``) mesh (Type II: the sequence-sharded MLA decode),
    ``POOL_RANKS`` processes sharing the card over gloo on CUDA tensors,
    spawned once for every run.  Each rank holds its ``ctx /
    POOL_RANKS``-token slice of the cache and its share of every param
    leaf (the serve rules: heads, vocabulary, the dense FFN).  The
    reference is the same decode at one rank on the whole cache (this
    process, its one-rank group): ``POOL_STEPS`` greedy steps, fed to
    the ranks.  Every rank must exit 0 with finite logits and a quarter
    of the one-rank run's cache bytes; with ``gate`` its tokens must
    equal the one-rank run's and its logit rows stay within
    ``BF16_ROW_RMS``, else the agreement is measured and printed.  Times
    are a one-card gloo rehearsal, not a multi-card figure.  Needs an
    initialized one-rank process group (the reference's).  Returns one
    dict a run."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh

    t0 = time.perf_counter()
    mesh = Mesh((1, 1), ("data", "model"), live=True)
    ones = []
    for i, (cfg, _) in enumerate(runs):
        st, params, cache = _pool_shards(torch, mesh, cfg, ctx, device)
        tok0 = torch.randint(0, cfg.vocab_size, (1,), device=device,
                             generator=torch.Generator(device=device)
                             .manual_seed(2), dtype=torch.int32)
        logits, toks, ms = _pool_decode(torch, st, params, cache, cfg, tok0,
                                        device)
        one = dict(ms=ms, param_bytes=dryrun.resident_bytes(params),
                   cache_bytes=dryrun.resident_bytes(cache),
                   seq_split=st.seq_split)
        torch.save(dict(ctx=ctx, tok0=tok0.cpu(), tokens=toks.cpu(),
                        logits=logits.cpu()), f"{tmp}/pool_ref{i}.pt")
        del params, cache, logits
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        log(f"sharding 14b {cfg.dtype}: {POOL_MODEL} ({cfg.n_layers} "
            f"layers), one request of {ctx} tokens; one rank: {ms:.2f} "
            f"ms/step, params {one['param_bytes'] / 2**30:.3f} GiB, cache "
            f"{one['cache_bytes'] / 2**30:.3f} GiB; tokens "
            f"{toks[:, 0].tolist()}")
        ones.append((one, toks[:, 0].tolist()))
    t1 = time.perf_counter()
    _spawn_ranks(_pool_rank, (tmp, device, runs), POOL_RANKS, POOL_TIMEOUT,
                 "sharding 14b", device)
    spawn_s = time.perf_counter() - t1
    outs = []
    for i, ((cfg, gate), (one, toks)) in enumerate(zip(runs, ones)):
        label = f"sharding 14b {cfg.dtype}"
        ranks = [json.loads(Path(f"{tmp}/pool_rank{r}_{i}.json").read_text())
                 for r in range(POOL_RANKS)]
        for r in ranks:
            if r["cache_bytes"] * POOL_RANKS != one["cache_bytes"] \
                    or not (r["seq_split"] and r["finite"]):
                raise AssertionError(f"{label} rank {r['rank']}: cache "
                                     f"{r['cache_bytes']} bytes against "
                                     f"{one['cache_bytes']} at one rank, "
                                     f"finite logits {r['finite']}")
            log(f"{label} rank {r['rank']} (coord {r['coord']}, tokens from "
                f"{r['kv_offset']}): params {r['param_bytes'] / 2**30:.3f} "
                f"GiB ({r['param_bytes'] / one['param_bytes']:.3f} of one "
                f"rank's), cache {r['cache_bytes'] / 2**30:.3f} GiB "
                f"(1/{POOL_RANKS}); {r['ms']:.2f} ms/step (one-card gloo "
                f"rehearsal); greedy tokens equal to one rank's at "
                f"{r['tokens_equal']} of {POOL_STEPS} steps, logit rows "
                f"within {r['max_row_rms']:.3g}")
        outs.append(dict(model=POOL_MODEL, dtype=cfg.dtype,
                         layers=cfg.n_layers, context=ctx, gate=gate,
                         ranks=ranks, one_rank=one, tokens=toks,
                         spawn_seconds=spawn_s,
                         seconds=time.perf_counter() - t0))
        log(f"{label}: {POOL_RANKS} ranks exited 0"
            + (", tokens equal to one rank's" if gate else ""))
    log(f"sharding 14b: {len(runs)} runs' one-rank references and one spawn "
        f"of {POOL_RANKS} ranks in {time.perf_counter() - t0:.1f} s (the "
        f"spawn {spawn_s:.1f} s)")
    return outs


def run(ctx) -> None:
    """(a) the sharded step at one rank over NCCL, at published widths;
    (b) one 32768-token request's KV over four ranks sharing the card
    over gloo: the published bf16 config, measured, then the equality
    gate in float32 (``POOL_GATE_DTYPE``), both in one spawn."""
    from repro_torch.configs import get_config
    torch = ctx.torch
    tmp = open_group(ctx)
    out = {"one_rank": sharding_one_rank(torch, ctx.kops)}
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(POOL_MODEL)
    out["pool"], out["pool_gate"] = sharding_pools(
        torch, tmp, [(cfg, False), (cfg.replace(dtype=POOL_GATE_DTYPE),
                                    True)])
    ctx.out[14] = dict(sharding=out, sh=out["one_rank"])
