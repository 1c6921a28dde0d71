"""Phase 4 of ``chip_smoke.py``: float32 smoke-size models on the card
against the CPU (plain versions): the colocated set and zamba2 + mamba2;
prefill and one decode step give the same logits within 1e-4 (the
colocated set's float32 decode step must launch the paged GQA and MLA
kernels); then the same smoke models in bf16, as the serve CLI runs them
by default, served through the engine; then the decode graphs: for the
smoke coloc set in float32 and bf16 at K = 1 and 4, and zamba2 + mamba2
in both, a block's graph replay gives the same tokens and pool (or dense
cache) bytes as the step body called eagerly from the same state; a
block dispatch (copy-in to replay) makes no host read under
``set_sync_debug_mode("error")``; a model evicted from the arena and re-
activated on other slabs serves the same tokens through its graph; and
after the pool, then the arena, moved (a resize), a replay raises until
the graph is captured again, then equals the eager body;
"""
from __future__ import annotations


from chip_smoke_phases.common import (FALLBACK_MODELS, SERVE_K, log,
                                      read_launches, reset_launches)


def small_phase(torch, kops):
    """Float32 smoke models on the card against the CPU (plain versions):
    the same params, prompt and one decode step give the same logits.
    Returns the card pass's launches (the float32 decode kernels must
    have run)."""
    from repro_torch.configs import PAPER_COLOC_SET, get_smoke_config
    from repro_torch.core.control import StreamingPrefill
    from repro_torch.core.pools import build_pools
    from repro_torch.models.transformer import init_params

    models = {n: get_smoke_config(n).replace(dtype="float32")
              for n in PAPER_COLOC_SET}
    params = {}
    for i, (n, c) in enumerate(models.items()):
        gen = torch.Generator()
        gen.manual_seed(i)
        params[n] = init_params(gen, c)
    prompt = torch.randint(0, 256, (1, 37), generator=torch.Generator()
                           .manual_seed(7), dtype=torch.int32)
    logits, launches = {}, {}
    for device in ("cuda", "cpu"):
        reset_launches(kops)
        kv_pool, _, pooled = build_pools(
            models, dict(params), device=device, page_budget=128,
            page_bytes=4096, pool_dtype=torch.float32, slab_bytes=4096)
        virt = kv_pool.virtualizer
        for rid, name in enumerate(models):
            fns, p_kv = pooled[name].stage_fns, pooled[name].kv_params
            virt.register_request(rid, name, prompt.shape[1])

            def writer(layer, kv, pool, name=name, rid=rid):
                return virt.write_prompt_layer(pool, name, rid, layer, kv,
                                               prompt.shape[1])

            first, virt.pool = StreamingPrefill(pooled[name])(
                prompt.to(device), prompt.shape[1], virt.pool, writer)
            virt.reserve_decode_block(rid, 1)
            tables = virt.batch_tables(name, [rid], 4)
            arena, slots = pooled[name].arena.acquire(name)
            x = fns.embed(p_kv, first.argmax(-1).to(torch.int32))
            lens = torch.tensor([prompt.shape[1]], dtype=torch.int32,
                                device=device)
            for layer in range(fns.n_layers):
                x, ffn_in, virt.pool = fns.attn_stage(p_kv, x, virt.pool,
                                                      tables, lens, layer)
                x = fns.combine(x, fns.ffn_stage(arena, slots, ffn_in, layer))
            logits[(device, name)] = (first.cpu(), fns.logits(p_kv, x).cpu())
        if device == "cuda":
            launches = read_launches(kops)
    for kernel in ("paged_decode_attention", "paged_mla_decode_attention"):
        if not launches[kernel]:
            raise AssertionError(f"small: the float32 decode step never "
                                 f"launched {kernel}")
    log(f"small: float32 decode launches on the card: "
        f"paged_decode_attention {launches['paged_decode_attention']}, "
        f"paged_mla_decode_attention "
        f"{launches['paged_mla_decode_attention']}")
    for name in models:
        for phase, got, want in zip(("prefill", "decode"),
                                    logits[("cuda", name)],
                                    logits[("cpu", name)]):
            err = (got - want).abs().max().item()
            if not err <= 1e-4:
                raise AssertionError(f"{name} {phase} logits: card vs CPU "
                                     f"max abs err {err:.3g} > 1e-4")
            log(f"small {name} {phase}: card vs CPU logits max abs err "
                f"{err:.3g} (tolerance 1e-4)")
    return launches


def smoke_serve_phase(torch):
    """The serve CLI's default models, the smoke colocated set in bf16
    (head dim 8), and zamba2 + mamba2 smoke in bf16 through the engine
    on the card: every request gets its tokens, every page comes back, no
    logit is NaN, and the path's kernels launched."""
    from repro_torch.configs import PAPER_COLOC_SET, get_smoke_config
    from repro_torch.configs.base import EngineConfig
    from repro_torch.kernels import ops as kops
    from repro_torch.runtime.engine import CrossPoolEngine, EngineMode
    from repro_torch.runtime.request import Request

    for names, k, kernels in (
            (PAPER_COLOC_SET, SERVE_K, ("paged_decode_attention",
                                        "paged_mla_decode_attention")),
            (FALLBACK_MODELS, 1, ("flash_attention", "decode_attention",
                                  "ssd_scan"))):
        models = {n: get_smoke_config(n) for n in names}
        engine = CrossPoolEngine(
            models, page_budget=512, page_bytes=4096, slab_bytes=4096,
            max_batch=2, max_ctx=64, device="cuda",
            config=EngineConfig(mode=EngineMode(decode_steps_per_dispatch=k)))
        counts = {f: getattr(kops, f).launches for f in kernels}
        reqs = [Request(i, names[i % len(names)], 5 + 7 * i, 6, 0.0)
                for i in range(6)]
        for r in reqs:
            engine.submit(r)
        engine.drain()
        got = [len(r.output_ids) for r in reqs]
        bad = sum(int(r.nonfinite_logits) for r in engine.runners.values())
        idle = [f for f, n in counts.items() if getattr(kops, f).launches <= n]
        if got != [6] * 6 or engine.virt.mapped_pages or bad or idle:
            raise AssertionError(
                f"bf16 smoke serve of {names}: tokens {got}, "
                f"{engine.virt.mapped_pages} pages mapped, {bad} non-finite "
                f"logits, never launched: {idle}")
        log(f"small bf16 serve {', '.join(names)}: {len(reqs)} requests "
            f"of 6 tokens, dtypes "
            f"{sorted({c.dtype for c in models.values()})}, pages returned")


def fallback_small_phase(torch):
    """Float32 smoke zamba2 and mamba2 through the dense-cache path on the
    card (flash prefill, SSD scan, contiguous decode) against the CPU
    (plain versions): prefill and one decode step, logits within 1e-4."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import build_model
    from repro_torch.training.tree import map_tree

    prompt = torch.randint(0, 256, (2, 48), generator=torch.Generator()
                           .manual_seed(7), dtype=torch.int32)
    nxt = torch.tensor([3, 250], dtype=torch.int32)
    lengths = torch.tensor([48, 30], dtype=torch.int32)
    for i, name in enumerate(FALLBACK_MODELS):
        model = build_model(get_smoke_config(name).replace(dtype="float32"))
        params = model.init(torch.Generator().manual_seed(i))
        out = {}
        for device in ("cuda", "cpu"):
            p = map_tree(lambda t: t.to(device, copy=True), params)
            cache = model.init_cache(2, 64, device)
            first, _ = model.prefill(p, prompt.to(device), cache,
                                     impl="flash", logit_index=40)
            step, _ = model.decode_step(p, nxt.to(device), cache,
                                        lengths.to(device), impl="paged")
            out[device] = (first.cpu(), step.cpu())
        for phase, got, want in zip(("prefill", "decode"), out["cuda"],
                                    out["cpu"]):
            err = (got - want).abs().max().item()
            if not err <= 1e-4:
                raise AssertionError(f"{name} {phase} logits: card vs CPU "
                                     f"max abs err {err:.3g} > 1e-4")
            log(f"small {name} {phase}: card vs CPU logits max abs err "
                f"{err:.3g} (tolerance 1e-4)")


def train_small_phase(torch):
    """One float32 smoke train step on the card against the CPU (plain
    versions): qwen3-moe on both MoE paths (the grouped one through the
    three grouped-GEMM kernels) and minicpm3 (MLA).  Loss, grad norm and
    updated params within 1e-4 of each leaf's scale, max(1, max|leaf|)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import build_model
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.train_step import TrainState, make_train_step
    from repro_torch.training.tree import leaves, map_tree

    for i, (name, moe_path) in enumerate((
            ("qwen3-moe-235b-a22b", "capacity"),
            ("qwen3-moe-235b-a22b", "grouped"), ("minicpm3-4b", "capacity"))):
        cfg = get_smoke_config(name).replace(dtype="float32")
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(i))
        tokens = torch.randint(0, cfg.vocab_size, (4, 32),
                               generator=torch.Generator().manual_seed(9))
        out = {}
        for device in ("cuda", "cpu"):
            # a copy each: the step updates the params in place
            p = map_tree(lambda t: t.to(device, copy=True), params)
            opt = AdamW(lr=3e-3, warmup_steps=10)
            step = make_train_step(model, opt, remat=False,
                                   extra_inputs=lambda b, m=moe_path: {
                                       "moe_path": m})
            state, metrics = step(TrainState(p, opt.init(p)),
                                  {"tokens": tokens.to(device)})
            out[device] = ([metrics["loss"], metrics["grad_norm"]]
                           + leaves(state.params))
        worst = 0.0
        for got, want in zip(out["cuda"], out["cpu"]):
            got, want = got.detach().cpu(), want.detach()
            scale = max(1.0, float(want.abs().max()))
            err = float((got - want).abs().max())
            if not err <= 1e-4 * scale:
                raise AssertionError(f"train {name} {moe_path}: card vs CPU "
                                     f"max abs err {err:.3g} > 1e-4 x scale "
                                     f"{scale:.3g}")
            worst = max(worst, err / scale)
        log(f"small train {name} {moe_path}: loss {float(out['cpu'][0]):.5f},"
            f" card vs CPU (loss, grad norm, {len(out['cpu']) - 2} updated "
            f"leaves) within {worst:.3g} of each leaf's scale "
            f"(tolerance 1e-4)")


def smoke_engine(torch, names, dtype, k=1, lowering=True, pipeline=True,
                 steps=1):
    """Smoke configs of ``names`` in ``dtype`` served on the card: 4
    requests at time 0 (prompts 5-26 tokens, 6 new tokens each, given
    ids), ``steps`` engine steps taken (prefill and first blocks)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import EngineConfig
    from repro_torch.models.transformer import init_params
    from repro_torch.runtime.engine import CrossPoolEngine, EngineMode
    from repro_torch.runtime.request import Request

    models = {n: get_smoke_config(n).replace(dtype=dtype) for n in names}
    params = {n: init_params(torch.Generator().manual_seed(i), c)
              for i, (n, c) in enumerate(models.items())}
    engine = CrossPoolEngine(
        models, page_budget=512, page_bytes=4096, slab_bytes=4096,
        max_batch=2, max_ctx=64, params=params, device="cuda",
        config=EngineConfig(mode=EngineMode(
            lowering=lowering, pipeline=pipeline,
            decode_steps_per_dispatch=k)))
    reqs = [Request(i, names[i % len(names)], 5 + 7 * i, 6, 0.0,
                    prompt_ids=list(range(3 + i, 8 + 8 * i)))
            for i in range(4)]
    for r in reqs:
        engine.submit(r)
    for _ in range(steps):
        engine.step()
    return engine, reqs


def replay_matches_eager(torch, engine) -> None:
    """For every model with requests in flight: its next decode block as
    one graph replay, then the decode body called eagerly from the same
    state (the pool, or the dense cache, put back first): the same tokens
    and the same pool or cache bytes.  Leaves the engine mid-block: build
    another to serve on."""
    import numpy as np

    def dev(a):
        return torch.tensor(a, device="cuda")

    for name, runner in engine.runners.items():
        if not runner.active:
            continue
        if runner.paged:
            act, steps = runner._reserve_decode_block()
            tables = engine.virt.batch_tables_host(
                name, runner._rids(), runner.max_pages).copy()
            args = (runner.next_tokens.copy(), tables, runner.lengths.copy(),
                    steps, runner._eos_ids())
            state = {"pool": engine.virt.pool}
            before = {"pool": engine.virt.pool.clone()}
            toks, _ = runner.fused(args[0], engine.virt.pool, *args[1:])
        else:
            active = np.zeros(runner.max_batch, bool)
            active[runner._active_slots()] = True
            args = (runner.next_tokens.copy(), runner.lengths.copy(), active)
            state = runner.cache
            before = {k: v.clone() for k, v in state.items()}
            toks = runner.decode_graph(tokens=args[0], lengths=args[1],
                                       active=args[2])
        got = toks.clone()
        got_state = {k: v.clone() for k, v in state.items()}
        for k, v in state.items():
            v.copy_(before[k])
        if runner.paged:
            arena, table = runner.fused.pooled.arena.acquire(name)
            want = runner.fused.body(engine.virt.pool, arena, table,
                                     *[dev(a) for a in args])
        else:
            want = runner.decode_body(*[dev(a) for a in args])
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: the graph replay's tokens "
                                 f"{got.tolist()} differ from the eager "
                                 f"body's {want.tolist()}")
        bad = [k for k, v in state.items() if not torch.equal(got_state[k],
                                                              v)]
        if bad:
            raise AssertionError(f"{name}: the graph replay and the eager "
                                 f"body leave different {bad} bytes")


def block_is_sync_free(torch, engine) -> None:
    """One decode block of every model with requests in flight, from the
    copy-in to the replay, under ``set_sync_debug_mode("error")``; the
    read-back comes after.  Leaves the engine mid-block."""
    pending = []
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for runner in engine.runners.values():
            if runner.active:
                pending.append(runner.issue_decode())
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if not pending:
        raise AssertionError("no model had a block to dispatch")


def graph_phase(torch):
    """The decode graphs on the smoke models: a replay equals the eager
    body (coloc set in float32 and bf16 at K = 1 and 4; zamba2 + mamba2 in
    both dtypes), a block dispatch makes no host read (coloc bf16 at K = 4
    and the fallback pair), and a graph survives an evict and re-activate
    of its model."""
    from repro_torch.configs import PAPER_COLOC_SET
    for names, ks in ((PAPER_COLOC_SET, (1, 4)), (FALLBACK_MODELS, (1,))):
        for dtype in ("float32", "bfloat16"):
            for k in ks:
                engine, _ = smoke_engine(torch, names, dtype, k)
                replay_matches_eager(torch, engine)
                state = "pool" if names == PAPER_COLOC_SET else "dense cache"
                log(f"graph check {', '.join(names)} {dtype} K={k}: the "
                    f"replay equals the eager body (tokens, {state} bytes)")
                del engine
        engine, _ = smoke_engine(torch, names, "bfloat16", max(ks))
        block_is_sync_free(torch, engine)
        log(f"graph check {', '.join(names)} bf16 K={max(ks)}: a block "
            f"dispatch makes no host read under "
            f"set_sync_debug_mode('error')")
        del engine
    evict_check(torch)
    moved_graph_check(torch)


def moved_graph_check(torch) -> None:
    """A decode graph over a pool or an arena that a resize moved: its
    replay raises until ``recapture`` captures it anew, and then a replay
    equals the eager body (smoke coloc set, float32, K = 4).  First, at
    the captured address: a pool of another size there (a view one page
    shorter) raises too, and the captured buffer under another tensor
    object (a view of equal shape) replays and equals the eager body."""
    from repro_torch.configs import PAPER_COLOC_SET
    engine, _ = smoke_engine(torch, PAPER_COLOC_SET, "float32", 4)

    def refused(what):
        runner = next(r for r in engine.runners.values() if r.active)
        try:
            runner.issue_decode()
        except RuntimeError as e:
            if "moved or changed shape" not in str(e):
                raise
        else:
            raise AssertionError(f"a replay over {what} did not raise")

    pool = engine.virt.pool
    engine.virt.pool = pool[:-1]
    refused("a shorter pool at the captured address")
    engine.virt.pool = pool.view(pool.shape)
    if any(r.fused.recapture(engine.virt.pool)
           for r in engine.runners.values()):
        raise AssertionError("an equal view of the captured pool was "
                             "captured again")
    replay_matches_eager(torch, engine)
    log("graph check: at the captured address a shorter pool raises, and "
        "an equal view of the captured pool replays and equals the eager "
        "body")
    for what, resize in (
            ("pool", lambda: engine.virt.resize(engine.virt.page_budget + 64)),
            ("arena", lambda: engine.arena.resize(
                engine.arena.slot_budget + 4))):
        resize()
        refused(f"the moved {what}")
        for r in engine.runners.values():
            if not r.fused.recapture(engine.virt.pool):
                raise AssertionError(f"{r.name}: no new capture after the "
                                     f"{what} moved")
        replay_matches_eager(torch, engine)
        log(f"graph check: after the {what} moved a replay raises, and once "
            f"captured again it equals the eager body")


def evict_check(torch) -> list:
    """A graph survives its model's evict and re-activate: the same request
    served again after the model came back on other slabs gives the same
    tokens, and a replay there still equals the eager body."""
    import numpy as np
    from repro_torch.configs import PAPER_COLOC_SET
    from repro_torch.runtime.request import Request
    name = PAPER_COLOC_SET[0]
    engine, reqs = smoke_engine(torch, PAPER_COLOC_SET, "float32", 4,
                                steps=0)
    engine.drain()
    first = [r.output_ids for r in reqs]
    arena = engine.arena
    old = arena.residency[name].slots.copy()
    arena.evict(name)
    again = [Request(10 + r.request_id, r.model, r.prompt_tokens,
                     r.max_new_tokens, 0.0, prompt_ids=r.prompt_ids)
             for r in reqs]
    for r in again:
        engine.submit(r)
    engine.drain()
    new = arena.residency[name].slots
    if np.array_equal(old, new):
        raise AssertionError(f"{name} came back on the same slabs")
    if [r.output_ids for r in again] != first:
        raise AssertionError(f"{name}: after evict and re-activate the "
                             f"graph serves other tokens")
    for r in again[:2]:
        engine.submit(Request(20 + r.request_id, r.model, r.prompt_tokens,
                              r.max_new_tokens, 0.0, prompt_ids=r.prompt_ids))
    engine.step()
    replay_matches_eager(torch, engine)
    log(f"graph check {name}: evicted and re-activated on other slabs, the "
        f"same tokens {first[0]}, and a replay equals the eager body")
    return first


def run(ctx) -> None:
    """Small models, card against CPU."""
    torch = ctx.torch
    small_launches = small_phase(torch, ctx.kops)
    fallback_small_phase(torch)
    smoke_serve_phase(torch)
    train_small_phase(torch)
    graph_phase(torch)
    ctx.out[4] = dict(small_launches=small_launches)
