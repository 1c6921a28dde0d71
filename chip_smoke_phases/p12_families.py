"""Phase 12 of ``chip_smoke.py``: the dense-cache Model path
(``build_model(cfg)``: ``init_cache`` / ``prefill`` / ``decode_step``)
of the families the engine does not serve: (a) contiguous decode and
flash prefill at gemma3's head dim 256 against their plain versions
(bf16 2e-2 and each row's relative RMS error within 1e-2, float32 2e-5;
decode at B = 4, T = 4096 with ragged lengths and NaN past them, and
over a 1024-slot ring with counts below it; flash at S = T = 2048 and T
> S), timed beside their bounds and SDPA; (b) gemma3, whisper and llava
smoke configs in float32, card against CPU: forward, prefill and two
decode steps within 1e-4; (c) gemma3-12b at its full published config
(48 layers, bf16, random weights from a seed): a [4, 2048] prefill and
64 greedy decode steps, a 1000-token prompt whose ring crosses the 1024
window during 48 steps, and a 301-token prompt in a 512 bucket (the
padded-bucket quirk); (d) whisper-small at its full config: 4 rows of
1500 encoder frames, a 64-token prompt, 64 decode steps. Gates: no NaN
logit, flash launched once per global layer a prefill (gemma3 8, whisper
12), contiguous decode once per layer a step (48, 12), gemma3's ring
counts at the end equal to min(max(cur + 1, bucket), 1024). It prints
prefill ms, decode ms per step, tokens/s, one profiled decode step (wall
and device busy) and peak memory;
"""
from __future__ import annotations

import gc
import time

from chip_smoke_phases.common import (GEMMA, GEMMA_BATCH, GEMMA_CTX,
                                      GEMMA_PROMPT, GEMMA_RUNS, WHISPER,
                                      check_counts, close_or_raise,
                                      decode_time_row, flash_time_row, log,
                                      read_launches, reset_launches, row_limit,
                                      sync)
from chip_smoke_phases.p03_kernels import fmt_backends
from chip_smoke_phases.p05_serve import device_summary


FAMILY_SMOKES = (GEMMA, WHISPER, "llava-next-34b")
WHISPER_BATCH, WHISPER_PROMPT, WHISPER_STEPS = 4, 64, 64


def families_kernel_phase(torch, kops, ref):
    """(12a) Rows 3 and 4 at gemma3's head geometry (H 16 over KV 8, head
    dim 256) against their plain versions (bf16 2e-2 and a row relative
    RMS error of ``BF16_ROW_RMS``, float32 2e-5):
    contiguous decode over the global cache (B = 4, T = 4096, ragged
    lengths, NaN past them) and over a local ring (W = 1024, counts
    below W), flash prefill at S = T = 2048 and at T > S; then each is
    timed in bf16 beside its bound and the fastest SDPA backend."""
    from repro_torch.configs import get_config
    cfg = get_config(GEMMA)
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    W = cfg.sliding_window
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def decode_case(B, T, lengths, dtype):
        q = randn(B, 1, H, D, dtype=dtype)
        ck, cv = randn(B, T, KV, D, dtype=dtype), randn(B, T, KV, D,
                                                        dtype=dtype)
        for b, n in enumerate(lengths):
            ck[b, n:] = float("nan")
            cv[b, n:] = float("nan")
        return q, ck, cv, torch.tensor(lengths, dtype=torch.int32,
                                       device="cuda")

    errs, rows = {}, []
    cases = (("global", GEMMA_BATCH, GEMMA_CTX, [GEMMA_CTX, 2049, 1, 3000]),
             ("ring", GEMMA_BATCH, W, [W, 1000, 17, 1]))
    for label, B, T, lengths in cases:
        for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 2e-5)):
            q, ck, cv, lens = decode_case(B, T, lengths, dtype)
            e = close_or_raise(
                torch, f"decode gemma3 {label} B={B} T={T} lengths "
                       f"{lengths} {dtype}",
                kops.decode_attention(q, ck, cv, lens, scale=D ** -0.5),
                ref.decode_attention(q, ck, cv, lens, D ** -0.5), tol,
                row_limit(torch, dtype))
            errs["decode_attention"] = max(errs.get("decode_attention", 0), e)
        q, ck, cv, lens = decode_case(B, T, [T] * B, torch.bfloat16)
        rows.append(decode_time_row(
            torch, kops, ref, f"gemma3 {label} B={B} T={T} H={H} KV={KV} "
                              f"D={D} bf16", q, ck, cv, lens, D ** -0.5))

    for B, S, T, dtype, tol in ((GEMMA_BATCH, GEMMA_PROMPT, GEMMA_PROMPT,
                                 torch.bfloat16, 2e-2),
                                (1, GEMMA_PROMPT, GEMMA_PROMPT,
                                 torch.float32, 2e-5),
                                (1, 190, 250, torch.bfloat16, 2e-2),
                                (2, 100, 130, torch.float32, 2e-5)):
        q, k, v = (randn(B, n, h, D, dtype=dtype)
                   for n, h in ((S, H), (T, KV), (T, KV)))
        e = close_or_raise(
            torch, f"flash gemma3 B={B} S={S} T={T} {dtype}",
            kops.flash_attention(q, k, v, scale=D ** -0.5),
            ref.flash_attention(q, k, v, D ** -0.5), tol,
            row_limit(torch, dtype))
        errs["flash_attention"] = max(errs.get("flash_attention", 0), e)
    B, S = GEMMA_BATCH, GEMMA_PROMPT
    q, k, v = (randn(B, S, h, D) for h in (H, KV, KV))
    rows.append(flash_time_row(torch, kops, ref, f"gemma3 B={B} S=T={S} "
                               f"H={H} KV={KV} D={D} bf16", q, k, v,
                               D ** -0.5))
    for r in rows:
        log(f"time {r['kernel']} {r['shape']}: kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), {r['library']} {r['library_ms']:.4f} ms "
            f"(sdpa backends {fmt_backends(r['library_all'])})")
    return errs, rows


def family_inputs(torch, cfg, B, S_txt, gen, device):
    """tokens [B,S_txt] and the modality inputs (a vlm's stub patch
    embeddings, whisper's encoder frames), drawn from ``gen``."""
    kw = {}
    if cfg.frontend == "vision_patches":
        kw["embeddings"] = torch.randn(
            (B, cfg.frontend_tokens, cfg.d_model), generator=gen,
            device=gen.device).to(device)
    if cfg.family == "audio":
        kw["encoder_frames"] = torch.randn(
            (B, cfg.encoder_seq, cfg.d_model), generator=gen,
            device=gen.device).to(device)
    tokens = torch.randint(0, cfg.vocab_size, (B, S_txt), generator=gen,
                           device=gen.device, dtype=torch.int32).to(device)
    return tokens, kw


def families_small_phase(torch, device="cuda"):
    """(12b) gemma3, whisper and llava smoke configs in float32 on the card
    against the CPU (plain versions): forward, prefill (flash; logits read
    5 tokens before the end) and two paged decode steps (one row inside
    the prompt), logits within 1e-4.  gemma3's prompt (40) outruns its window (16)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import build_model
    from repro_torch.training.tree import map_tree

    for i, name in enumerate(FAMILY_SMOKES):
        cfg = get_smoke_config(name).replace(dtype="float32")
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(i))
        tokens, kw = family_inputs(torch, cfg, 2, 40,
                                   torch.Generator().manual_seed(7), "cpu")
        S = tokens.shape[1] + (kw["embeddings"].shape[1]
                               if "embeddings" in kw else 0)
        out = {}
        for dev in (device, "cpu"):
            p = map_tree(lambda t: t.to(dev, copy=True), params)
            dkw = {k: v.to(dev) for k, v in kw.items()}
            fwd, _ = model.forward(p, tokens.to(dev), **dkw)
            cache = model.init_cache(2, S + 8, dev)
            first, _ = model.prefill(p, tokens.to(dev), cache,
                                     impl="flash", logit_index=S - 5, **dkw)
            lengths = torch.tensor([S - 4, S], dtype=torch.int32, device=dev)
            steps, tok = [], first.argmax(-1).to(torch.int32)
            for _ in range(2):
                logits, _ = model.decode_step(p, tok, cache, lengths,
                                              impl="paged")
                steps.append(logits.cpu())
                tok, lengths = logits.argmax(-1).to(torch.int32), lengths + 1
            out[dev] = [fwd.cpu(), first.cpu()] + steps
        for phase, got, want in zip(("forward", "prefill", "decode 1",
                                     "decode 2"), out[device], out["cpu"]):
            err = (got - want).abs().max().item()
            if not err <= 1e-4:
                raise AssertionError(f"{name} {phase} logits: card vs CPU "
                                     f"max abs err {err:.3g} > 1e-4")
            log(f"small {name} {phase} (prefill flash, decode paged): card "
                f"vs CPU logits max abs err {err:.3g} (tolerance 1e-4)")


def decode_run(torch, kops, model, params, cache, tokens, *, steps,
               logit_index=None, device="cuda", **kw):
    """One flash prefill of ``tokens`` (and a modality input ``kw``) and
    ``steps`` greedy paged decode steps from the real lengths
    (``logit_index + 1``, default the bucket), the card synchronised
    around each part; the lengths stay on the card and nothing is read
    back until the end.  Returns (figures, the prefill's launch counts,
    the decode's, the last step's lengths)."""
    B, S = tokens.shape[0], tokens.shape[1]
    S += kw["embeddings"].shape[1] if "embeddings" in kw else 0
    at = S - 1 if logit_index is None else logit_index
    sync(torch, device)
    reset_launches(kops)
    t0 = time.perf_counter()
    logits, _ = model.prefill(params, tokens, cache, impl="flash",
                              logit_index=logit_index, **kw)
    sync(torch, device)
    prefill_s = time.perf_counter() - t0
    pre = read_launches(kops)
    bad = (~torch.isfinite(logits)).sum()
    lengths = torch.full((B,), at + 1, dtype=torch.int32, device=device)
    tok = logits.argmax(-1).to(torch.int32)
    reset_launches(kops)
    t0 = time.perf_counter()
    for _ in range(steps):
        logits, _ = model.decode_step(params, tok, cache, lengths,
                                      impl="paged")
        bad += (~torch.isfinite(logits)).sum()
        tok = logits.argmax(-1).to(torch.int32)
        lengths += 1
    sync(torch, device)
    decode_s = time.perf_counter() - t0
    dec = read_launches(kops)
    figures = dict(batch=B, prompt=S, logit_index=at, steps=steps,
                   prefill_ms=prefill_s * 1e3,
                   decode_ms_per_step=decode_s * 1e3 / steps,
                   tokens_per_s=B * steps / decode_s,
                   nonfinite_logits=int(bad))
    return figures, pre, dec, lengths - 1


def profile_model_step(torch, fn, label) -> dict:
    """Device busy time and the largest kernels of one ``fn()`` call."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return device_summary(prof, wall, label)


def gemma3_full(torch, kops, cfg, device="cuda") -> dict:
    """(12c) gemma3-12b at its full published config, bf16, random weights
    from a seed, ``GEMMA_RUNS``: a [4, 2048] prefill (twice the window;
    flash on the 8 global layers) and 64 greedy paged decode steps; a
    1000-token prompt decoded 48 steps (its ring crosses W = 1024); a
    301-token prompt in a 512 bucket (the pad quirk: the ring keeps the
    pad positions).  Gates: no NaN logit, flash launched 8 times a
    prefill and contiguous decode 48 times a step (8 global + 40 local
    layers), the ring count ``n`` read back at the end equal to
    ``min(max(cur + 1, S), W)``."""
    from repro_torch.models import attention as attn
    from repro_torch.models.model import build_model
    from repro_torch.training.tree import leaves

    model = build_model(cfg)
    W, G = cfg.sliding_window, cfg.n_layers // cfg.swa_pattern
    on_card = device == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=device).manual_seed(0))
    sync(torch, device)
    n_params = sum(t.numel() for t in leaves(params))
    log(f"families: {GEMMA} full config ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, head dim {cfg.head_dim}, window {W}, {cfg.dtype}),"
        f" {n_params / 1e9:.3f} B params drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=device).manual_seed(1)
    out = {"params": n_params}
    for label, B, S, steps, logit_index in GEMMA_RUNS:
        cache = model.init_cache(B, GEMMA_CTX, device)
        tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                               device=device, dtype=torch.int32)
        fig, pre, dec, cur = decode_run(torch, kops, model, params, cache,
                                        tokens, steps=steps,
                                        logit_index=logit_index,
                                        device=device)
        check_counts(f"{GEMMA} {label} prefill", pre,
                     {"flash_attention": G, "decode_attention": 0})
        check_counts(f"{GEMMA} {label} decode", dec,
                     {"flash_attention": 0,
                      "decode_attention": cfg.n_layers * steps})
        n = attn.ring_count(cache["lpos"][0, 0])
        want = torch.clamp(torch.clamp(cur + 1, min=S), max=W)
        if fig["nonfinite_logits"] or not torch.equal(n, want):
            raise AssertionError(
                f"{GEMMA} {label}: {fig['nonfinite_logits']} non-finite "
                f"logits; ring counts {n.tolist()}, expected "
                f"{want.tolist()} (cur {cur.tolist()}, bucket {S})")
        fig.update(ring_counts=n.tolist(), launches_prefill=pre,
                   launches_decode=dec)
        log(f"families: {GEMMA} {label}: B={B} prompt {S} (logits at "
            f"{fig['logit_index']}), {steps} steps: prefill "
            f"{fig['prefill_ms']:.1f} ms, decode "
            f"{fig['decode_ms_per_step']:.2f} ms/step = "
            f"{fig['tokens_per_s']:.1f} tokens/s; launches prefill "
            f"{pre['flash_attention']} flash, decode "
            f"{dec['decode_attention']} contiguous; ring counts "
            f"{n.tolist()}")
        if label == "batch" and on_card:
            # one more step, profiled (its cache row writes land at cur + 1)
            fig["profile_decode"] = profile_model_step(
                torch, lambda: model.decode_step(params, cur.new_zeros(B),
                                                 cache, cur + 1,
                                                 impl="paged"),
                f"one {GEMMA} decode step (B={B}, context "
                f"{int(cur[0]) + 2})")
        out[label] = fig
        del cache
    if on_card:
        out["max_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
        log(f"families: {GEMMA}: max memory allocated "
            f"{out['max_memory_gib']:.2f} GiB")
    return out


def whisper_full(torch, kops, cfg, device="cuda") -> dict:
    """(12d) whisper-small at its full config, bf16: ``WHISPER_BATCH`` rows
    of 1500 encoder frames from a seed, a ``WHISPER_PROMPT``-token prompt,
    ``WHISPER_STEPS`` greedy paged decode steps.  Gates: no NaN logit,
    flash 12 times a prefill (the decoder's self-attention), contiguous
    decode 12 times a step."""
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import dtype_of

    model = build_model(cfg)
    on_card = device == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator(device=device).manual_seed(0))
    B, S, steps = WHISPER_BATCH, WHISPER_PROMPT, WHISPER_STEPS
    tokens, kw = family_inputs(
        torch, cfg, B, S, torch.Generator(device=device).manual_seed(1),
        device)
    kw = {k: v.to(dtype_of(cfg)) for k, v in kw.items()}
    cache = model.init_cache(B, S + steps + 1, device)
    fig, pre, dec, cur = decode_run(torch, kops, model, params, cache,
                                    tokens, steps=steps, device=device, **kw)
    check_counts(f"{WHISPER} prefill", pre,
                 {"flash_attention": cfg.n_layers, "decode_attention": 0})
    check_counts(f"{WHISPER} decode", dec,
                 {"flash_attention": 0,
                  "decode_attention": cfg.n_layers * steps})
    if fig["nonfinite_logits"]:
        raise AssertionError(f"{WHISPER}: {fig['nonfinite_logits']} "
                             f"non-finite logits")
    fig.update(launches_prefill=pre, launches_decode=dec)
    log(f"families: {WHISPER} full config: B={B}, {cfg.encoder_seq} frames, "
        f"prompt {S}, {steps} steps: prefill {fig['prefill_ms']:.1f} ms, "
        f"decode {fig['decode_ms_per_step']:.2f} ms/step = "
        f"{fig['tokens_per_s']:.1f} tokens/s; launches prefill "
        f"{pre['flash_attention']} flash, decode {dec['decode_attention']} "
        f"contiguous")
    if on_card:
        fig["profile_decode"] = profile_model_step(
            torch, lambda: model.decode_step(params, cur.new_zeros(B), cache,
                                             cur + 1, impl="paged"),
            f"one {WHISPER} decode step (B={B}, context {int(cur[0]) + 2})")
        fig["max_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
        log(f"families: {WHISPER}: max memory allocated "
            f"{fig['max_memory_gib']:.2f} GiB")
    return fig


def families_phase(torch, kops, ref) -> dict:
    """Phase 12: (a) kernels at head dim 256, (b) smoke families card vs
    CPU, (c) gemma3-12b and (d) whisper-small at full configs."""
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    errs, rows = families_kernel_phase(torch, kops, ref)
    families_small_phase(torch)
    out = dict(kernel_errs=errs, kernel_rows=rows)
    out["gemma3"] = gemma3_full(torch, kops, get_config(GEMMA))
    gc.collect()
    torch.cuda.empty_cache()
    out["whisper"] = whisper_full(torch, kops, get_config(WHISPER))
    out["seconds"] = time.perf_counter() - t0
    log(f"families: phase 12 took {out['seconds']:.1f} s")
    return out


def run(ctx) -> None:
    """The dense-cache Model path: gemma3 and whisper at full configs."""
    ctx.out[12] = dict(families=families_phase(ctx.torch, ctx.kops,
                                               ctx.ref))
