#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port (``src/repro_torch``) on the card and fails (exit code
other than 0) if any phase fails:

1. card    — prints the card's name and power limit (nvidia-smi) and
             turns TF32 off for float32 matmuls and convolutions;
2. build   — compiles the paged attention kernels from
             ``src/repro_torch/kernels/csrc`` with nvcc and loads them;
3. kernels — holds each kernel against its plain PyTorch version at the
             head geometries of the three colocated models (bf16 within
             2e-2, float32 within 2e-5 on a small shape), with ragged
             lengths, unmapped (-1) table entries and NaN garbage beyond
             every length; then times kernel, plain version and one
             ``scaled_dot_product_attention`` call over the gathered KV
             (a yardstick only: the port never calls it) at contexts 1k
             and 8k, B=1 and B=4, beside the bandwidth bound;
4. small   — float32 smoke-size models on the card against the CPU
             (plain versions): prefill and one decode step give the same
             logits within 1e-4;
5. serve   — ``CrossPoolEngine(device="cuda")`` over the paper's three
             colocated models at their published widths, bf16, depths
             cut to ``FULL_WIDTH_DEPTHS``: 8 requests, prompts of
             200-900 tokens, 32 new tokens each, K=4.  Every request must
             finish with its token count, every page must return, no
             logit may be NaN, and both kernels must have launched.

It prints a JSON line with every kernel's numbers, then, as its last
line, ``{"ok": true, "device": {...}}``.  The full kernel table, the
serve figures and the profile go to ``build/chip_smoke.json``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM, published
BF16_FLOPS = 989e12             # H100 SXM dense bf16 tensor-core peak
CONTEXTS = (1024, 8192)
BATCHES = (1, 4)
SERVE_K = 4
SERVE_MAX_NEW = 32


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def time_ms(torch, fn, iters: int = 20) -> float:
    """Median device time of one call, L2 flushed before each call (the
    decode step finds a layer's KV cold)."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in zip(starts, ends))
    return times[len(times) // 2]


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

class Case:
    """One kernel geometry: GQA (H, KV, D) or MLA (H, r, rp) over pages of
    ``tpp`` tokens in a flat pool of ``page_elems``-element pages."""

    def __init__(self, name, kind, tpp, page_elems, H, KV=0, D=0, r=0, rp=0):
        self.name, self.kind, self.tpp, self.page_elems = \
            name, kind, tpp, page_elems
        self.H, self.KV, self.D, self.r, self.rp = H, KV, D, r, rp
        self.per_tok = 2 * KV * D if kind == "gqa" else r + rp
        self.q_dim = D if kind == "gqa" else r + rp
        self.out_dim = D if kind == "gqa" else r
        self.scale = (D ** -0.5 if kind == "gqa" else (r + rp) ** -0.5)


def make_inputs(torch, case, lengths, max_pages, dtype, gen, garbage):
    """(q, pool, table, lengths) with every valid token random and, when
    ``garbage``, NaN everywhere else: slots past a length, mapped pages
    past it, unmapped pages and page slack."""
    B = len(lengths)
    need = [math.ceil(n / case.tpp) for n in lengths]
    n_pages = B * max_pages + 4
    if garbage:
        pool = torch.full((n_pages, case.page_elems), float("nan"),
                          dtype=dtype, device="cuda")
    else:
        pool = torch.randn((n_pages, case.page_elems), generator=gen,
                           device="cuda").to(dtype)
    perm = torch.randperm(n_pages, generator=gen, device="cuda").tolist()
    table = torch.full((B, max_pages), -1, dtype=torch.int32)
    for b in range(B):
        ids = perm[b * max_pages:(b + 1) * max_pages]
        # row 0 keeps mapped pages past its length (they hold garbage and
        # must be skipped); the other rows leave them unmapped (-1)
        n_map = max_pages if b == 0 else need[b]
        table[b, :n_map] = torch.tensor(ids[:n_map], dtype=torch.int32)
        for p in range(need[b] if garbage else 0):
            n_tok = min(case.tpp, lengths[b] - p * case.tpp)
            vals = torch.randn((n_tok * case.per_tok,), generator=gen,
                               device="cuda").to(dtype)
            pool[ids[p], :n_tok * case.per_tok] = vals
    q = torch.randn((B, 1, case.H, case.q_dim), generator=gen,
                    device="cuda").to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, pool, table.cuda(), lens


def run_kernel(kops, case, q, pool, table, lens):
    if case.kind == "gqa":
        return kops.paged_decode_attention(
            q, pool, table, lens, tokens_per_page=case.tpp, n_kv=case.KV,
            scale=case.scale)
    return kops.paged_mla_decode_attention(
        q, pool, table, lens, tokens_per_page=case.tpp, latent_dim=case.r,
        scale=case.scale)


def run_plain(ref, case, q, pool, table, lens):
    n = pool.shape[0]
    typed = pool[:, :case.tpp * case.per_tok]
    if case.kind == "gqa":
        typed = typed.reshape(n, case.tpp, 2, case.KV, case.D)
        return ref.paged_decode_attention(q, typed, table, lens, case.scale)
    typed = typed.reshape(n, case.tpp, case.per_tok)
    return ref.paged_mla_decode_attention(q, typed, table, lens, case.r,
                                          case.scale)


def check(torch, kops, ref, case, lengths, max_pages, dtype, tol, gen):
    q, pool, table, lens = make_inputs(torch, case, lengths, max_pages,
                                       dtype, gen, garbage=True)
    got = run_kernel(kops, case, q, pool, table, lens).float()
    want = run_plain(ref, case, q, pool, table, lens).float()
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{case.name}: kernel output is not finite")
    err = (got - want).abs()
    bad = err > tol + tol * want.abs()
    if bad.any():
        raise AssertionError(
            f"{case.name} {dtype}: kernel disagrees with the plain version "
            f"(max abs err {err.max().item():.3g}, tolerance {tol})")
    return err.max().item()


def sdpa_call(torch, case, q, pool, table, lens):
    """One ``scaled_dot_product_attention`` over KV gathered beforehand
    (full lengths): the library yardstick."""
    B, ctx = q.shape[0], int(lens[0])
    n = pool.shape[0]
    rows = pool[:, :case.tpp * case.per_tok].reshape(
        n, case.tpp, case.per_tok)[table.long()].reshape(
        B, -1, case.per_tok)[:, :ctx]
    qh = q.transpose(1, 2)                                   # [B,H,1,dq]
    if case.kind == "gqa":
        kv = rows.reshape(B, ctx, 2, case.KV, case.D)
        k = kv[:, :, 0].transpose(1, 2).contiguous()          # [B,KV,T,D]
        v = kv[:, :, 1].transpose(1, 2).contiguous()
    else:
        k = rows[:, None].contiguous()                        # [B,1,T,E]
        v = rows[:, None, :, :case.r].contiguous()            # [B,1,T,r]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(qh, k, v, scale=case.scale, enable_gqa=True)


def bound(case, B, ctx, max_pages, itemsize):
    """Least time for the work: bytes (KV read once, q/table/lengths
    read, out written) over HBM rate vs flops over the bf16 peak."""
    nbytes = (B * ctx * case.per_tok * itemsize
              + B * case.H * (case.q_dim + case.out_dim) * itemsize
              + B * max_pages * 4 + B * 4)
    flops = 2 * B * case.H * ctx * (case.q_dim + case.out_dim)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(torch, kops, ref, cases):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    errs = {}
    for case in cases:
        tpp = case.tpp
        whole = tpp * 37                      # ends exactly on a page
        mid = tpp * 20 + max(tpp // 2, 1) if tpp > 1 else 41
        lengths = [1000, whole, mid, 1]
        max_pages = math.ceil(1024 / tpp)
        e = check(torch, kops, ref, case, lengths, max_pages, torch.bfloat16,
                  2e-2, gen)
        errs[case.kind] = max(errs.get(case.kind, 0.0), e)
        log(f"kernel check {case.name} bf16 lengths {lengths}: "
            f"max abs err {e:.3g} (tolerance 2e-2)")
    # float32 on one small shape per kernel
    small = [Case("gqa-small", "gqa", 8, 8 * 2 * 4 * 64, H=16, KV=4, D=64),
             Case("mla-small", "mla", 8, 8 * 80 + 16, H=8, r=64, rp=16)]
    for case in small:
        e = check(torch, kops, ref, case, [37, 16, 1], 8, torch.float32,
                  2e-5, gen)
        log(f"kernel check {case.name} f32 lengths [37, 16, 1]: "
            f"max abs err {e:.3g} (tolerance 2e-5)")
    rows = []
    for case in cases:
        for ctx in CONTEXTS:
            max_pages = math.ceil(ctx / case.tpp)
            for B in BATCHES:
                q, pool, table, lens = make_inputs(
                    torch, case, [ctx] * B, max_pages, torch.bfloat16, gen,
                    garbage=False)
                ms = time_ms(torch, lambda: run_kernel(kops, case, q, pool,
                                                       table, lens))
                plain = time_ms(torch, lambda: run_plain(ref, case, q, pool,
                                                         table, lens))
                lib = time_ms(torch, sdpa_call(torch, case, q, pool, table,
                                               lens))
                b_ms, b_by = bound(case, B, ctx, max_pages, 2)
                rows.append(dict(case=case.name, kind=case.kind, ctx=ctx,
                                 B=B, ms=ms, plain_ms=plain, library_ms=lib,
                                 bound_ms=b_ms, bound_by=b_by))
                log(f"time {case.name} ctx {ctx} B {B}: kernel {ms:.4f} ms, "
                    f"plain {plain:.4f} ms, sdpa {lib:.4f} ms, "
                    f"bound {b_ms:.4f} ms ({b_by})")
                del q, pool, table, lens
    return errs, rows


# ---------------------------------------------------------------------------
# engine phases
# ---------------------------------------------------------------------------

def small_phase(torch):
    """Float32 smoke models on the card against the CPU (plain versions):
    the same params, prompt and one decode step give the same logits."""
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
    logits = {}
    for device in ("cuda", "cpu"):
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


def serve_phase(torch, np, kops):
    from repro_torch.configs.base import EngineConfig
    from repro_torch.launch.serve import FULL_WIDTH_DEPTHS, coloc_models
    from repro_torch.runtime.engine import CrossPoolEngine, EngineMode
    from repro_torch.runtime.observe import percentile
    from repro_torch.runtime.request import Request

    models = coloc_models(full_width=True)
    log("serve: published widths, depths cut to "
        + ", ".join(f"{n} {d} layers" for n, d in FULL_WIDTH_DEPTHS.items()))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = CrossPoolEngine(
        models, page_budget=16384, max_batch=4, max_ctx=1024, seed=0,
        device="cuda",
        config=EngineConfig(mode=EngineMode(
            decode_steps_per_dispatch=SERVE_K)))
    torch.cuda.synchronize()
    log(f"serve: engine built in {time.perf_counter() - t0:.1f} s "
        f"(weights drawn on the card, arena "
        f"{engine.arena.device_bytes() / 2**30:.2f} GiB, pool "
        f"{engine.virt.page_budget * engine.virt.page_bytes / 2**20:.0f} "
        f"MiB)")
    rng = np.random.default_rng(0)
    names = list(models)
    reqs = [Request(i, names[i % len(names)], int(rng.integers(200, 901)),
                    SERVE_MAX_NEW, 0.0) for i in range(8)]
    # the main path's run: launch counts start at 0 here
    kops.paged_decode_attention.launches = 0
    kops.paged_mla_decode_attention.launches = 0
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    stats = engine.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_decode_attention":
                kops.paged_decode_attention.launches,
                "paged_mla_decode_attention":
                kops.paged_mla_decode_attention.launches}
    for r in reqs:
        if r.generated != r.max_new_tokens or \
                len(r.output_ids) != r.max_new_tokens:
            raise AssertionError(f"request {r.request_id} ({r.model}) "
                                 f"emitted {len(r.output_ids)} of "
                                 f"{r.max_new_tokens} tokens")
    if engine.virt.mapped_pages != 0:
        raise AssertionError(f"{engine.virt.mapped_pages} pages still mapped")
    bad = sum(int(r.nonfinite_logits) for r in engine.runners.values())
    if bad:
        raise AssertionError(f"{bad} non-finite logits")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    log(f"serve: {len(reqs)} requests, prompts "
        f"{[r.prompt_tokens for r in reqs]}, {stats.tokens_out} tokens in "
        f"{wall:.2f} s wall = {stats.tokens_out / wall:.1f} tokens/s")
    log(f"serve: TBT p50 {percentile(stats.tbt, 50) * 1e3:.2f} ms, "
        f"p99 {percentile(stats.tbt, 99) * 1e3:.2f} ms; TTFT p50 "
        f"{percentile(stats.ttft, 50) * 1e3:.1f} ms")
    for model, B, bucket, dt in stats.prefill_times:
        log(f"serve: prefill {model} B={B} bucket {bucket}: "
            f"{dt * 1e3:.1f} ms")
    log(f"serve: launches {launches}; max memory allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile = profile_decode_step(torch, engine, names)
    return launches, dict(
        profile=profile, tokens=stats.tokens_out, wall_s=wall,
        tokens_per_s=stats.tokens_out / wall,
        tbt_p50_ms=percentile(stats.tbt, 50) * 1e3,
        tbt_p99_ms=percentile(stats.tbt, 99) * 1e3,
        prefill=[dict(model=m, B=B, bucket=k, ms=dt * 1e3)
                 for m, B, k, dt in stats.prefill_times],
        max_memory_gib=torch.cuda.max_memory_allocated() / 2**30)


def profile_decode_step(torch, engine, names):
    """Where one decode step's device time goes: 4 fresh requests (500
    prompt tokens each) are prefilled, then one engine step — a K-token
    block for every model — runs under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime.request import Request

    reqs = [Request(100 + i, names[i % len(names)], 500, 2 * SERVE_K + 1,
                    0.0) for i in range(4)]
    for r in reqs:
        engine.submit(r)
    engine.step()                              # prefill + a first block
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    engine.drain()
    if engine.virt.mapped_pages != 0:
        raise AssertionError("pages still mapped after the profiled run")
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA" and e.self_device_time_total]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    log(f"profile: one decode step (K={SERVE_K}, 3 models): wall "
        f"{wall * 1e3:.1f} ms, device busy {busy_ms:.1f} ms "
        f"({busy_ms / (wall * 1e3):.1%})")
    rows = []
    for e in top:
        ms = e.self_device_time_total / 1e3
        rows.append(dict(kernel=e.key[:90], calls=e.count, ms=ms))
        log(f"profile: {ms:9.3f} ms {e.count:5d}x  {e.key[:90]}")
    return dict(wall_ms=wall * 1e3, device_busy_ms=busy_ms, top=rows)


# ---------------------------------------------------------------------------

def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.core.virtualizer import DEFAULT_PAGE_BYTES, make_view
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import paged_attention, ref
    from repro_torch.launch.serve import coloc_models

    # 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")

    # 2. build
    t0 = time.perf_counter()
    lib = paged_attention.build_library()
    paged_attention.load_library()
    log(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s")
    log(lib.with_suffix(".so.log").read_text().strip())

    # 3. kernels, at the main path's geometries (bf16 pages of 16 KiB)
    page_elems = DEFAULT_PAGE_BYTES // 2
    cases = []
    for name, cfg in coloc_models(full_width=True).items():
        tpp = make_view(cfg, page_elems).tokens_per_page
        if cfg.attention == "mla":
            cases.append(Case(name, "mla", tpp, page_elems, H=cfg.n_heads,
                              r=cfg.mla.kv_lora_rank,
                              rp=cfg.mla.qk_rope_head_dim))
        else:
            cases.append(Case(name, "gqa", tpp, page_elems, H=cfg.n_heads,
                              KV=cfg.n_kv_heads, D=cfg.head_dim))
    errs, rows = kernel_phase(torch, kops, ref, cases)

    # 4. small models, card against CPU
    small_phase(torch)

    # 5. serve the main path
    launches, serve = serve_phase(torch, np, kops)

    source = "src/repro_torch/kernels/csrc/paged_attention.cu"
    main_shape = {"gqa": ("qwen3-moe-235b-a22b", 1024, 4),
                  "mla": ("minicpm3-4b", 1024, 4)}
    kernels = []
    for kind, name, replaces in (
            ("gqa", "paged_decode_attention",
             "src/repro/kernels/paged_attention.py:121"),
            ("mla", "paged_mla_decode_attention",
             "src/repro/kernels/paged_attention.py:225")):
        geom, ctx, B = main_shape[kind]
        row = next(r for r in rows if r["case"] == geom
                   and r["ctx"] == ctx and r["B"] == B)
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[kind], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": f"{geom} B={B} context {ctx} bf16"})
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "kernel_times": rows, "kernels": kernels,
         "serve": serve}, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
