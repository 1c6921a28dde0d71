"""Phase 10 of ``chip_smoke.py``: the radix-tree prefix cache (DESIGN.md
§11): each colocated model alone at published width, bf16, ``max_ctx``
1024, K=4, the cache on: one warm-up and ``CACHE_CONVERSATIONS``
measured conversations of 3 turns (a 400-token first prompt, 4 new
tokens a turn, an 8-token delta; one prompt bucket), each turn served
with the cache and opted out of it. Gates: every warm turn hits the
previous turn's prompt, the tree holds exactly the mapped pages after
the drain, no NaN logit, exact launch counts of the paged kernels and
the pool write (suffix writes counted), one replay per block, a warm
turn's block dispatch with no host read, layer-0 KV rows of the suffix
within 2e-2 + 2e-2|x| of cache-off's; two requests on one 64-token head
in one step (shared pages), then the whole tree shed to the pinned tier
and the next turn's hit faulting it back with its bytes unchanged. It
prints per warm turn the first-token logits' and layer-0 KV's max |d|
against cache-off, token agreement, TTFT (wall, submit to first token)
and prefill ms on and off. Then the same on float32 smoke configs on the
card (cache on and off) and on the CPU: the streams must be equal;
"""
from __future__ import annotations

import gc
import time

from chip_smoke_phases.common import (SERVE_K, log, read_launches,
                                      reset_launches, sync)
from chip_smoke_phases.p04_small import block_is_sync_free
from chip_smoke_phases.p05_serve import (device_summary,
                                         expected_split_launches, graph_report,
                                         replays_and_captures)


#: phase 10: the multi-turn conversation's shape (first prompt, new
#: tokens a turn, delta a turn, turns), measured conversations after one
#: warm-up, and the shared head of the shared-page pair
CACHE_PROMPT, CACHE_NEW, CACHE_DELTA, CACHE_TURNS = 400, 4, 8, 3
CACHE_CONVERSATIONS = 3
CACHE_HEAD = 64


def cache_engine(torch, models, device, *, params=None, page_budget=16384,
                 page_bytes=None, max_ctx=1024):
    """An engine with the prefix cache on (K = ``SERVE_K``, lowering on),
    its runners' prefill commit wrapped to keep each request's first-token
    logits and layer-0 prompt KV rows (``engine.probe``) for the
    comparisons below."""
    from repro_torch.configs.base import CacheConfig, EngineConfig
    from repro_torch.runtime.engine import CrossPoolEngine, EngineMode
    kw = {} if page_bytes is None else dict(page_bytes=page_bytes,
                                            slab_bytes=4096)
    engine = CrossPoolEngine(
        models, page_budget=page_budget, max_batch=4, max_ctx=max_ctx,
        seed=0, device=device, params=params,
        config=EngineConfig(
            mode=EngineMode(decode_steps_per_dispatch=SERVE_K),
            cache=CacheConfig(enabled=True)), **kw)
    engine.probe = {}
    for name, runner in engine.runners.items():
        def commit(group, logits, runner=runner, name=name,
                   inner=runner._commit_group):
            for i, req in enumerate(group.requests):
                rows = engine.virt.gather_prompt_rows(
                    name, req.request_id, req.prompt_tokens)[0]
                engine.probe[req.request_id] = (logits[i].float().cpu(),
                                                rows.float().cpu())
            return inner(group, logits)
        runner._commit_group = commit
    return engine


def serve_together(engine, specs):
    """Submit ``specs`` [(request id, model, ids, cache?, new tokens)] at
    once and step until all finish.  Returns one dict per request: the
    stream, the cache outcome, wall TTFT (submit to first token, ms) and
    the prefill passes' ms."""
    from repro_torch.runtime.request import Request
    first, handles = {}, []

    def on_token(ev):
        if ev.first:
            first[ev.request_id] = time.perf_counter()
    n_pass = len(engine.stats.prefill_times)
    t0 = time.perf_counter()
    for rid, model, ids, cache, new in specs:
        req = Request(rid, model, len(ids), new, 0.0, prompt_ids=ids,
                      cache=cache)
        handles.append((engine.submit(req, on_token=on_token), req))
    for _ in range(64):
        engine.step()
        if all(h.done for h, _ in handles):
            break
    prefill_ms = [dt * 1e3 for *_, dt in engine.stats.prefill_times[n_pass:]]
    out = []
    for h, req in handles:
        if not h.done or len(req.output_ids) != req.max_new_tokens:
            raise AssertionError(f"cache: request {req.request_id} emitted "
                                 f"{len(req.output_ids)} of "
                                 f"{req.max_new_tokens} tokens")
        out.append(dict(stream=list(req.output_ids), cached=h.cached_tokens,
                        hit=h.cache_hit, prompt=req.prompt_tokens,
                        ttft_ms=(first[req.request_id] - t0) * 1e3,
                        prefill_ms=prefill_ms))
    return out


def conversations(np, engine, model, n_conv, rng, *, first_rid=0,
                  prompt=None, new=None, delta=None, turns=None):
    """``n_conv`` conversations of ``turns`` turns on one model, each
    turn served with the cache (``on``) and then opted out of it
    (``off``, a full prefill) on the same prompt; the next prompt is this
    one, the cache-off turn's tokens and a random delta (the shape of
    ``benchmarks/multiturn_cache.py``).  Returns one record per turn."""
    prompt = prompt or CACHE_PROMPT
    new, delta, turns = new or CACHE_NEW, delta or CACHE_DELTA, \
        turns or CACHE_TURNS
    vocab = engine.models[model].vocab_size
    rid, out = first_rid, []
    for c in range(n_conv):
        ids = rng.integers(0, vocab, prompt).astype(np.int32)
        for t in range(turns):
            on = serve_together(engine, [(rid, model, ids, True,
                                                 new)])[0]
            off = serve_together(engine, [(rid + 1, model, ids, False,
                                                  new)])[0]
            out.append(dict(conv=c, turn=t, on=on, off=off, rid_on=rid,
                            rid_off=rid + 1, fork=on["cached"], ids=ids,
                            prev=out[-1]["on"]["prompt"] if t else 0))
            rid += 2
            ids = next_turn(np, out[-1], rng.integers(0, vocab, delta))
    return out


def check_hits(records, label) -> None:
    """Every warm turn hits the previous turn's prompt (the tree indexes
    committed prompt KV, not output); every first turn misses."""
    for r in records:
        want = r["prev"]
        if r["on"]["cached"] != want or r["on"]["hit"] != (want > 0) \
                or r["off"]["cached"] != 0:
            raise AssertionError(
                f"{label}: conversation {r['conv']} turn {r['turn']} cached "
                f"{r['on']['cached']} tokens, expected {want} (cache-off "
                f"{r['off']['cached']})")


def turn_numbers(engine, r) -> dict:
    """One warm turn against its cache-off twin: max |d| of the first-token
    logits and of the layer-0 KV rows past the fork (which must lie within
    the bf16 kernel tolerance, 2e-2 + 2e-2 |x|), token agreement, TTFT and
    prefill ms on and off."""
    lo, ro = engine.probe[r["rid_on"]]
    lf, rf = engine.probe[r["rid_off"]]
    fork = r["fork"]
    d_kv = (ro[fork:] - rf[fork:]).abs()
    if (d_kv > 2e-2 + 2e-2 * rf[fork:].abs()).any():
        raise AssertionError(f"cache: layer-0 KV rows the suffix wrote are "
                             f"off by {d_kv.max().item():.3g} (tolerance "
                             f"2e-2 + 2e-2|x|)")
    a, b = r["on"]["stream"], r["off"]["stream"]
    return dict(turn=r["turn"], fork=fork, prompt=r["on"]["prompt"],
                logits_max_abs=(lo - lf).abs().max().item(),
                kv0_max_abs=d_kv.max().item(),
                token_agreement=sum(x == y for x, y in zip(a, b)) / len(a),
                ttft_on_ms=r["on"]["ttft_ms"], ttft_off_ms=r["off"]["ttft_ms"],
                prefill_on_ms=sum(r["on"]["prefill_ms"]),
                prefill_off_ms=sum(r["off"]["prefill_ms"]))


def shared_and_swapped(torch, np, engine, model, rng, first_rid) -> dict:
    """A producer puts a 64-token head into the tree; two requests with
    that head are admitted in one step (their decode reads shared pages)
    and served beside their cache-off twins; then the whole tree is shed
    to the pinned tier and the next turn's hit faults it back: the pages
    must hold their bytes from before the shed, bit for bit.  Returns the
    pair's streams and the fault figures."""
    vocab = engine.models[model].vocab_size
    head = rng.integers(0, vocab, CACHE_HEAD).astype(np.int32)
    rid = first_rid

    def prompt(n):
        return np.concatenate([head, rng.integers(0, vocab, n)
                               .astype(np.int32)])
    serve_together(engine, [(rid, model, prompt(56), True, 4)])
    pa, pb = prompt(40), prompt(50)      # all in the 128 bucket
    on = serve_together(engine, [(rid + 1, model, pa, True, 8),
                                        (rid + 2, model, pb, True, 8)])
    off = serve_together(engine, [(rid + 3, model, pa, False, 8),
                                         (rid + 4, model, pb, False, 8)])
    if [o["cached"] for o in on] != [CACHE_HEAD, CACHE_HEAD]:
        raise AssertionError(f"cache: the pair cached "
                             f"{[o['cached'] for o in on]} tokens, expected "
                             f"{CACHE_HEAD} each")
    cache, virt = engine.cache, engine.virt
    nodes = [n for n in cache._walk() if n.pages and not n.swapped]
    before = {id(n): virt.pool[n.pages].clone() for n in nodes}
    held = cache.device_pages_held
    shed = cache.shed(held)
    if shed != held or cache.device_pages_held != 0:
        raise AssertionError(f"cache: shed {shed} of {held} tree pages")
    nxt = np.concatenate([pa, np.asarray(on[0]["stream"], np.int32),
                          rng.integers(0, vocab, 8).astype(np.int32)])
    faulted0 = cache.faulted_pages
    from repro_torch.runtime.request import Request
    t0 = time.perf_counter()
    h = engine.submit(Request(rid + 5, model, len(nxt), 4, 0.0,
                              prompt_ids=nxt))
    sync(torch, engine.device)
    fault_ms = (time.perf_counter() - t0) * 1e3
    faulted = cache.faulted_pages - faulted0
    back = [n for n in nodes if not n.swapped]
    if h.cached_tokens != len(pa) or not back or faulted == 0:
        raise AssertionError(f"cache: the turn after the shed cached "
                             f"{h.cached_tokens} tokens (expected {len(pa)}),"
                             f" {faulted} pages faulted")
    for n in back:
        if not torch.equal(virt.pool[n.pages], before[id(n)]):
            raise AssertionError("cache: a faulted tree page differs from "
                                 "its bytes before the shed")
    for _ in range(16):
        engine.step()
        if h.done:
            break
    if not h.done:
        raise AssertionError("cache: the refaulted turn did not finish")
    log(f"cache {model}: two requests on one {CACHE_HEAD}-token head "
        f"(shared pages) streams {[o['stream'] for o in on]} (cache-off "
        f"{[o['stream'] for o in off]}); {shed} tree pages shed to the "
        f"pinned tier, {faulted} faulted back bit for bit "
        f"({fault_ms:.1f} ms admission with the fault)")
    return dict(pair_on=[o["stream"] for o in on],
                pair_off=[o["stream"] for o in off], shed_pages=shed,
                faulted_pages=faulted, admission_with_fault_ms=fault_ms,
                next_rid=rid + 6)


def next_turn(np, record, delta):
    """The turn after ``record``: its prompt, its cache-off tokens and
    ``delta``."""
    return np.concatenate([record["ids"], np.asarray(record["off"]["stream"],
                                                     np.int32),
                           np.asarray(delta, np.int32)])


def profile_warm_prefill(torch, np, engine, model, record, rid) -> dict:
    """Where a warm turn's prefill time goes: the turn after ``record``,
    served with the cache (a suffix pass) and opted out of it (a full
    pass), its ``prefill_group`` call alone under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime.request import Request
    ids = next_turn(np, record, np.arange(100, 100 + CACHE_DELTA))
    runner = engine.runners[model]
    out = {}
    for label, cache, r in (("cache on", True, rid), ("cache off", False,
                                                      rid + 1)):
        h = engine.submit(Request(r, model, len(ids), 1, 0.0, prompt_ids=ids,
                                  cache=cache))
        what = (f"{model} warm-turn prefill, {label} ({h.cached_tokens} of "
                f"{len(ids)} tokens cached)")

        def profiled(group, inner=runner.prefill_group, what=what,
                     label=label):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                slots = inner(group)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            out[label] = device_summary(prof, wall, what)
            return slots
        runner.prefill_group = profiled
        try:
            engine.step()
        finally:
            del runner.prefill_group          # the class's method again
        if not h.done or label not in out:
            raise AssertionError(f"cache {model}: the profiled turn did not "
                                 f"finish in its prefill step")
    return out


def cache_accounting(engine, label) -> None:
    """After a drain: the tree holds exactly the mapped pages, and every
    page is free or mapped."""
    held, mapped = engine.cache.device_pages_held, engine.virt.mapped_pages
    if held != mapped or engine.virt.free_pages + mapped \
            != engine.virt.page_budget:
        raise AssertionError(f"{label}: tree holds {held} pages, {mapped} "
                             f"mapped, {engine.virt.free_pages} free of "
                             f"{engine.virt.page_budget}")


def cache_full_width(torch, np, kops, models) -> dict:
    """Each colocated model alone at published width (bf16, ``max_ctx``
    1024, K = 4, lowering on, the cache on): one warm-up conversation,
    then ``CACHE_CONVERSATIONS`` measured ones, each turn cache-on and
    cache-off; the shared-page pair and the shed-and-refault turn.  Hard
    gates: hits, page accounting, no NaN logit, exact launch counts
    summed over the three runs, one replay per block, a sync-free block
    dispatch; per warm turn the logit and layer-0 KV differences, token
    agreement, TTFT and prefill ms, on and off."""
    out, total, want = {}, {}, {}
    for name, cfg in models.items():
        t0 = time.perf_counter()
        engine = cache_engine(torch, {name: cfg}, "cuda")
        torch.cuda.synchronize()
        log(f"cache {name}: engine built in {time.perf_counter() - t0:.1f} s")
        rng = np.random.default_rng(10)
        captures = {n: replays_and_captures(r)[1]
                    for n, r in engine.runners.items()}
        reset_launches(kops)
        t_phase = time.perf_counter()
        records = conversations(np, engine, name, 1 + CACHE_CONVERSATIONS,
                                rng)
        check_hits(records, f"cache {name}")
        shared = shared_and_swapped(torch, np, engine, name, rng,
                                    records[-1]["rid_off"] + 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_phase
        profiles = profile_warm_prefill(torch, np, engine, name, records[-1],
                                        shared["next_rid"])
        launches = read_launches(kops)
        stats = engine.finalize()
        graph_report(engine, stats, f"cache {name}")
        for k, v in expected_split_launches(stats, engine, captures).items():
            want[k] = want.get(k, 0) + v
        for k in want:
            total[k] = total.get(k, 0) + launches[k]
        cache_accounting(engine, f"cache {name}")
        bad = sum(int(r.nonfinite_logits) for r in engine.runners.values())
        if bad:
            raise AssertionError(f"cache {name}: {bad} non-finite logits")
        warm = [turn_numbers(engine, r) for r in records
                if r["conv"] > 0 and r["turn"] > 0]
        for w in warm:
            log(f"cache {name} turn {w['turn']} (fork {w['fork']} of "
                f"{w['prompt']}): logits max|d| {w['logits_max_abs']:.4g}, "
                f"layer-0 KV max|d| {w['kv0_max_abs']:.4g}, token agreement "
                f"{w['token_agreement']:.2f}; TTFT {w['ttft_on_ms']:.2f} ms "
                f"on / {w['ttft_off_ms']:.2f} off, prefill "
                f"{w['prefill_on_ms']:.2f} / {w['prefill_off_ms']:.2f} ms")
        # a warm turn (a hit) mid-decode: one block dispatch, no host read
        last = records[-1]
        ids = next_turn(np, last, np.arange(CACHE_DELTA))
        from repro_torch.runtime.request import Request
        h = engine.submit(Request(shared["next_rid"] + 2, name, len(ids), 16,
                                  0.0, prompt_ids=ids))
        engine.step()
        if h.cached_tokens < last["on"]["prompt"] or h.done:
            raise AssertionError(f"cache {name}: the sync-free check's turn "
                                 f"cached {h.cached_tokens} tokens")
        block_is_sync_free(torch, engine)
        out[name] = dict(warm_turns=warm, shared=shared, wall_s=wall,
                         profiles=profiles,
                         snapshot=engine.cache.snapshot(),
                         hits=[r["on"]["cached"] for r in records])
        log(f"cache {name}: {len(records)} turns on and off in {wall:.1f} s; "
            f"{engine.cache.snapshot()}")
        del engine, records
        gc.collect()
        torch.cuda.empty_cache()
    for k, n in want.items():
        if total[k] != n or n <= 0:
            raise AssertionError(f"cache: {k} launched {total[k]} times, "
                                 f"expected {n}")
    log(f"cache: launches exactly as expected, suffix writes counted: {want}")
    out["launches"] = total
    return out


def cache_exact(torch, np) -> dict:
    """Float32 smoke configs of the colocated set: the same conversations
    and the shared-page pair on the card (cache on and off) and on the
    CPU (cache on) give equal streams."""
    from repro_torch.configs import PAPER_COLOC_SET, get_smoke_config
    from repro_torch.models.transformer import init_params
    models = {n: get_smoke_config(n).replace(dtype="float32")
              for n in PAPER_COLOC_SET}
    streams = {}
    for device in ("cuda", "cpu"):
        params = {n: init_params(torch.Generator().manual_seed(i), c)
                  for i, (n, c) in enumerate(models.items())}
        engine = cache_engine(torch, models, device, params=params,
                              page_budget=4096, page_bytes=4096)
        rng = np.random.default_rng(12)
        got, rid = {}, 0
        for name in models:
            recs = conversations(np, engine, name, 1, rng, first_rid=rid)
            check_hits(recs, f"cache f32 {device} {name}")
            rid = recs[-1]["rid_off"] + 1
            shared = shared_and_swapped(torch, np, engine, name, rng, rid)
            rid = shared["next_rid"] + 1
            got[name] = dict(
                on=[r["on"]["stream"] for r in recs] + shared["pair_on"],
                off=[r["off"]["stream"] for r in recs] + shared["pair_off"])
        cache_accounting(engine, f"cache f32 {device}")
        streams[device] = got
        del engine
        gc.collect()
    for name in models:
        card, cpu = streams["cuda"][name], streams["cpu"][name]
        if not card["on"] == card["off"] == cpu["on"]:
            raise AssertionError(f"cache f32 {name}: card cache-on "
                                 f"{card['on']}, cache-off {card['off']}, "
                                 f"CPU {cpu['on']}")
    log("cache f32 smoke: card cache-on streams equal card cache-off and the "
        "CPU's, shared-page pair included")
    return streams


def cache_phase(torch, np, kops, models) -> dict:
    t0 = time.perf_counter()
    out = cache_full_width(torch, np, kops, models)
    out["exact"] = cache_exact(torch, np)
    out["wall_s"] = time.perf_counter() - t0
    log(f"cache: phase wall {out['wall_s']:.1f} s")
    return out


def run(ctx) -> None:
    """The prefix cache: multi-turn conversations, cache on and off."""
    from repro_torch.launch.serve import coloc_models
    log(f"cache: each colocated model alone at published width, bf16, "
        f"max_ctx 1024, K={SERVE_K}: {CACHE_CONVERSATIONS} conversations "
        f"after a warm-up, {CACHE_TURNS} turns of {CACHE_PROMPT} + "
        f"{CACHE_NEW} new + {CACHE_DELTA} delta tokens")
    cache = cache_phase(ctx.torch, ctx.np, ctx.kops,
                        coloc_models(full_width=True))
    ctx.out[10] = dict(cache=cache, c_launches=cache["launches"])
