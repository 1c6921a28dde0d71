"""Phase 13 of ``chip_smoke.py``: (a) one long-context request through the
shared pool at full width: minicpm3-4b's published config in a bf16
``KVVirtualizer`` of 73,728 16 KiB pages, 32768 tokens of all 62 layers
written from a dense MLA cache with ``write_prompt_from_cache`` (one
pool write), then layer 0 anew with ``write_tokens``; the whole pool
must equal a plain scatter of the same rows through ``page_table_array``
bit for bit, and ``typed_pages`` must be a view; the
long_context_pooling example's float32 packed-latent call of the paged
GQA kernel (head dim 256, one kv head for 40 query heads) over layer 0
within 2e-5 of its plain version, and the paged MLA kernel in bf16 over
the last layer's typed pages (2e-2 and the row RMS limit), each launched
exactly once and timed beside its bound, its plain version and SDPA;
then the admission burst at published widths (moonshot, 4 x 32768 tokens
into 48 GiB of pages: the shared pool must admit more than a static
third); (b) the four examples (``repro_torch.examples``) through their
``main`` at the reference's settings: quickstart for qwen3-moe,
moonshot, minicpm3 and qwen3-14b, serve_multi_model ``--online --elastic
--slo-demo`` (its flight record must replay BIT-EXACT on the card),
train_moe's 100 steps and long_context_pooling. Gates: each prints its
``OK`` line; each quickstart launches its prefill's and decode's kernels
(flash, contiguous and paged decode for a GQA arch, paged MLA decode for
minicpm3) and, for a MoE arch, the grouped GEMM with its weight
gradient; train_moe launches both. It prints each example's wall time
and launches.
"""
from __future__ import annotations

import gc
import math
import time

from chip_smoke_phases.common import (BF16_ROW_RMS, KERNELS, ROOT, bound_ms,
                                      close_or_raise, library_sdpa, log,
                                      read_launches, reset_launches,
                                      rows_close_or_raise, sync, time_ms)
from chip_smoke_phases.p03_kernels import Case, bound, fmt_backends, sdpa_call


#: phase 13: the long-context request (model, tokens, pool pages of 16
#: KiB), the archs quickstart runs on the card and train_moe's steps (its
#: loss falls below 0.8x the first ten steps' by step ~50; one
#: checkpoint lands at step 100)
LONG_MODEL, LONG_CTX, LONG_PAGES = "minicpm3-4b", 32768, 73728
TRAIN_MOE_STEPS = 100
#: phase 13a's admission burst at published widths: 4 requests of 32768
#: tokens (a LongAlign-like length, one of Fig. 6's bins) against a 48
#: GiB pool of 16 KiB pages, host bookkeeping only
FULL_WIDTH_BURST = dict(total_pages=3 * 2 ** 20, page_bytes=16384,
                        long_ctx=32768)
EXAMPLE_ARCHS = ("qwen3-moe-235b-a22b", "moonshot-v1-16b-a3b", "minicpm3-4b",
                 "qwen3-14b")


# ---------------------------------------------------------------------------


def long_context_phase(torch, kops, ref, device="cuda") -> dict:
    """(13a) One long-context request through the shared pool at full
    width: minicpm3 at its published config (62 layers, 40 heads,
    latent 256 + rope 32: 288 bf16 scalars a token a layer), a bf16
    ``KVVirtualizer`` of ``LONG_PAGES`` 16 KiB pages, one request of
    ``LONG_CTX`` tokens.  Every layer's KV goes in from a dense MLA cache
    with ``write_prompt_from_cache`` (one pool write), then layer 0's
    anew with ``write_tokens``; the whole pool must equal a plain scatter
    of the same rows through ``page_table_array`` bit for bit.  The
    long_context_pooling example's float32 packed-latent call of row 1
    (head dim 256, one kv head for 40 query heads) over layer 0 within
    2e-5 of its plain version, and row 2 in bf16 over the last layer's
    ``typed_pages`` (2e-2 and the row RMS limit), each launched exactly
    once and timed beside its bound.  Then the admission burst at
    published widths (moonshot, ``FULL_WIDTH_BURST``): the shared pool
    admits more than a static third.  ``device="cpu"`` with ``LONG_*``
    made small rehearses it (launch counts stay 0 there)."""
    import numpy as np
    from repro_torch.configs import PAPER_COLOC_SET, get_config
    from repro_torch.core.virtualizer import DEFAULT_PAGE_BYTES, KVVirtualizer
    from repro_torch.examples import long_context_pooling as lcp
    on_card = device == "cuda"
    cfg = get_config(LONG_MODEL)
    r, rp, H, L = (cfg.mla.kv_lora_rank, cfg.mla.qk_rope_head_dim,
                   cfg.n_heads, cfg.n_layers)
    e = r + rp
    page_elems = DEFAULT_PAGE_BYTES // 2
    tpp = page_elems // e
    max_pages = math.ceil(LONG_CTX / tpp)
    out = dict(model=LONG_MODEL, context=LONG_CTX, page_budget=LONG_PAGES,
               tokens_per_page=tpp, pages=max_pages, layers=L)
    log(f"long context: {LONG_MODEL} published config ({L} layers, H={H}, "
        f"r={r}, rope {rp}), one request of {LONG_CTX} tokens = {L} x "
        f"{max_pages} = {L * max_pages} pages of {tpp} tokens, pool "
        f"{LONG_PAGES} pages ({LONG_PAGES * DEFAULT_PAGE_BYTES / 1e9:.2f} "
        f"GB bf16)")
    if on_card:
        torch.cuda.reset_peak_memory_stats()      # 13a's own peak
    virt = KVVirtualizer({LONG_MODEL: cfg}, page_budget=LONG_PAGES,
                         page_bytes=DEFAULT_PAGE_BYTES, device=device)
    virt.register_request(0, LONG_MODEL, prompt_tokens=LONG_CTX)
    gen = torch.Generator(device=device).manual_seed(13)
    cache = {name: torch.randn((L, 1, LONG_CTX, dim), generator=gen,
                               device=device).to(torch.bfloat16)
             for name, dim in (("latent", r), ("rope", rp))}
    rng = np.random.default_rng(0)
    kv0 = torch.from_numpy(rng.normal(size=(LONG_CTX, e))).to(torch.bfloat16)

    reset_launches(kops)
    t0 = time.perf_counter()
    virt.write_prompt_from_cache(LONG_MODEL, 0, cache, LONG_CTX)
    sync(torch, device)
    out["prompt_write_s"] = time.perf_counter() - t0
    virt.write_tokens(LONG_MODEL, 0, 0, 0, kv0)
    writes = read_launches(kops)["paged_kv_write"]
    if on_card and writes != 2:
        raise AssertionError(f"long context: {writes} pool writes, want 2 "
                             f"(one for all layers, one for layer 0)")
    out["launches_write"] = writes

    # the plain scatter: each layer's rows at (its page table, slot)
    tables = [virt.page_table_array([0], layer, max_pages=max_pages)
              for layer in range(L)]
    want_pool = torch.zeros_like(virt.pool)
    want_typed = want_pool[:, :tpp * e].view(-1, tpp, e)
    t = torch.arange(LONG_CTX, device=virt.device)
    for layer in range(L):
        rows = kv0.to(virt.device) if layer == 0 else torch.cat(
            [cache["latent"][layer, 0], cache["rope"][layer, 0]], dim=-1)
        want_typed[tables[layer][0, t // tpp].long(), t % tpp] = rows
    if not torch.equal(virt.pool, want_pool):
        bad = (virt.pool != want_pool).any(dim=1).sum().item()
        raise AssertionError(f"long context: {bad} pool pages differ from a "
                             f"plain scatter of the {L} layers' rows")
    log(f"long context: write_prompt_from_cache ({L} layers x {LONG_CTX} "
        f"tokens, one pool write) in {out['prompt_write_s']:.2f} s wall, "
        f"then write_tokens of layer 0: the pool equals a plain scatter "
        f"through page_table_array bit for bit")
    del want_pool, want_typed, cache

    typed = virt.typed_pages(LONG_MODEL)
    if typed.data_ptr() != virt.pool.data_ptr():
        raise AssertionError("typed_pages is not a view of the pool")
    lengths = torch.tensor([LONG_CTX], dtype=torch.int32, device=virt.device)

    # row 1: the example's float32 packed-latent call, over layer 0
    packed = lcp.packed_latent(typed, r)
    flat = packed.reshape(packed.shape[0], -1)
    q = torch.from_numpy(rng.normal(size=(1, 1, H, r))).float().to(
        virt.device)
    scale = r ** -0.5
    table1 = tables[0]

    def row1():
        return kops.paged_decode_attention(
            q, flat, table1, lengths, tokens_per_page=tpp, n_kv=1,
            scale=scale)
    before = kops.paged_decode_attention.launches
    got1 = row1()
    out["launches_row1"] = kops.paged_decode_attention.launches - before
    if on_card and out["launches_row1"] != 1:
        raise AssertionError("long context row 1: not launched exactly once")
    out["row1_max_abs_err"] = close_or_raise(
        torch, f"long context row 1 f32 (D={r}, G={H}, {LONG_CTX} tokens)",
        got1, ref.paged_decode_attention(q, packed, table1, lengths, scale),
        2e-5)

    # row 2 in bf16 over the last layer's typed pages
    q2 = torch.randn((1, 1, H, e), generator=gen, device=device).to(
        torch.bfloat16)
    case = Case(LONG_MODEL, "mla", tpp, page_elems, H=H, r=r, rp=rp)
    table2 = tables[L - 1]

    def row2():
        return kops.paged_mla_decode_attention(
            q2, virt.pool, table2, lengths, tokens_per_page=tpp,
            latent_dim=r, scale=case.scale)
    before = kops.paged_mla_decode_attention.launches
    got2 = row2()
    out["launches_row2"] = kops.paged_mla_decode_attention.launches - before
    if on_card and out["launches_row2"] != 1:
        raise AssertionError("long context row 2: not launched exactly once")
    want2 = ref.paged_mla_decode_attention(q2, typed, table2, lengths, r,
                                           case.scale)
    what = f"long context row 2 bf16 (layer {L - 1}, {LONG_CTX} tokens)"
    out["row2_max_abs_err"] = close_or_raise(torch, what, got2, want2, 2e-2,
                                             row_rms=BF16_ROW_RMS)
    out["row2_row_rms"] = rows_close_or_raise(what, got2, want2)

    if on_card:
        nbytes = (2 * LONG_CTX * r * 4 + q.numel() * 4 * 2
                  + max_pages * 4 + 4)
        b1, by1 = bound_ms(nbytes, 2 * H * LONG_CTX * 2 * r, fp32=True)
        rows = {"row1": dict(
            kernel="paged_decode_attention", dtype="float32",
            shape=f"{LONG_MODEL} packed latent B=1 ctx {LONG_CTX} H={H} "
                  f"KV=1 D={r} f32",
            ms=time_ms(torch, row1),
            plain_ms=time_ms(torch, lambda: ref.paged_decode_attention(
                q, packed, table1, lengths, scale)),
            bound_ms=b1, bound_by=by1)}
        k1 = packed[table1[0].long()][:, :, 0, 0].reshape(
            1, 1, -1, r)[:, :, :LONG_CTX].contiguous()
        lib1, name1, all1 = library_sdpa(
            torch, lambda: torch.nn.functional.scaled_dot_product_attention(
                q.transpose(1, 2), k1, k1, scale=scale, enable_gqa=True))
        rows["row1"].update(library_ms=lib1, library=name1,
                            library_all=all1)
        b2, by2 = bound(case, 1, LONG_CTX, max_pages, 2)
        lib2, name2, all2 = library_sdpa(
            torch, sdpa_call(torch, case, q2, virt.pool, table2, lengths))
        rows["row2"] = dict(
            kernel="paged_mla_decode_attention", dtype="bfloat16",
            shape=f"{LONG_MODEL} B=1 ctx {LONG_CTX} H={H} r={r} rp={rp} "
                  f"bf16",
            ms=time_ms(torch, row2),
            plain_ms=time_ms(torch, lambda: ref.paged_mla_decode_attention(
                q2, typed, table2, lengths, r, case.scale)),
            bound_ms=b2, bound_by=by2, library_ms=lib2, library=name2,
            library_all=all2)
        for key, row in rows.items():
            log(f"time long context {key} {row['shape']}: kernel "
                f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
                f"{row['library']} {row['library_ms']:.4f} ms, bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']}); sdpa "
                f"backends {fmt_backends(row['library_all'])}")
        out["rows"] = rows
        out["max_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del virt, typed, packed, flat
    gc.collect()

    models = {n: get_config(n) for n in PAPER_COLOC_SET}
    burst = lcp.admission_burst(models, **FULL_WIDTH_BURST)
    if not burst["admitted_shared"] > burst["admitted_static"]:
        raise AssertionError(f"long context burst: shared pool admitted "
                             f"{burst['admitted_shared']}, a static third "
                             f"{burst['admitted_static']}")
    kappa = models[lcp.BURST_MODEL].kv_bytes_per_token()
    log(f"long context burst at published widths: 4 x "
        f"{FULL_WIDTH_BURST['long_ctx']} tokens of {lcp.BURST_MODEL} "
        f"({kappa} B a token, {burst['need']} pages each) into "
        f"{FULL_WIDTH_BURST['total_pages']} pages: the shared pool "
        f"admits {burst['admitted_shared']}/4, a static third "
        f"({burst['static_share']} pages) {burst['admitted_static']}/4")
    out["burst"] = burst
    return out


def run_example(torch, kops, label, main, argv) -> dict:
    """One example's ``main(argv)`` on the card with every launch counter
    set to 0 just before and read just after: its wall time, launches,
    result, and its output (which must end with its ``OK`` line)."""
    import contextlib
    import io
    reset_launches(kops)
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    lines = text.rstrip().splitlines()
    if not lines or not lines[-1].endswith(" OK"):
        raise AssertionError(f"example {label}: no OK line; output ends "
                             f"{lines[-5:]}")
    launches = read_launches(kops)
    log(f"example {label}: {lines[-1]} in {wall:.1f} s wall; launches "
        + ", ".join(f"{k} {v}" for k, v in launches.items() if v))
    for line in lines[-6:-1]:
        log(f"  {label} | {line}")
    return dict(argv=argv, wall_s=wall, launches=launches, output=text,
                result=result if isinstance(result, dict) else None,
                max_memory_gib=torch.cuda.max_memory_allocated() / 2**30)


def examples_phase(torch, kops) -> dict:
    """(13b) The four examples on the card through their ``main`` at the
    reference's settings: quickstart for ``EXAMPLE_ARCHS``,
    serve_multi_model online + elastic with the SLO demo (its record
    replays bit for bit on the card), train_moe's 100 steps, and
    long_context_pooling.  Each quickstart must launch its prefill's and
    decode's kernels (flash, contiguous decode and paged decode for a GQA
    arch, paged MLA decode for an MLA one) and, for a MoE arch, row 5
    and its weight gradient; rows 1, 2 and 5 must each be launched."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.examples import (long_context_pooling, quickstart,
                                      serve_multi_model, train_moe)
    from repro_torch.launch import replay
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    record = build / "slo_flight.json"
    record.unlink(missing_ok=True)
    out = {}
    for arch in EXAMPLE_ARCHS:
        got = run_example(torch, kops, f"quickstart {arch}", quickstart.main,
                          ["--arch", arch])
        cfg = get_smoke_config(arch)
        want = (["paged_mla_decode_attention"] if cfg.mla is not None else
                ["flash_attention", "decode_attention",
                 "paged_decode_attention"])
        if cfg.family == "moe":
            want += ["moe_gemm", "moe_gemm_wgrad"]
        missing = [n for n in want if not got["launches"][n]]
        if missing:
            raise AssertionError(f"quickstart {arch}: {missing} never "
                                 f"launched")
        out[f"quickstart {arch}"] = got
    out["serve_multi_model"] = run_example(
        torch, kops, "serve_multi_model", serve_multi_model.main,
        ["--online", "--elastic", "--slo-demo", str(record),
         "--metrics-out", str(build / "metrics.prom"),
         "--trace-out", str(build / "trace.json")])
    if not record.exists():
        raise AssertionError("serve_multi_model: the SLO demo wrote no "
                             "flight record")
    t0 = time.perf_counter()
    rc = replay.main([str(record), "-q"])
    if rc != 0:
        raise AssertionError("serve_multi_model: the SLO demo's record did "
                             "not replay bit for bit on the card")
    log(f"example serve_multi_model: flight record {record.name} "
        f"({record.stat().st_size} B) replayed BIT-EXACT on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    ckpt = build / "train_moe_ckpt"
    out["train_moe"] = run_example(torch, kops, "train_moe", train_moe.main,
                                   ["--steps", str(TRAIN_MOE_STEPS),
                                    "--ckpt-dir", str(ckpt)])
    out["long_context_pooling"] = run_example(
        torch, kops, "long_context_pooling", long_context_pooling.main, [])
    total = {k: sum(r["launches"][k] for r in out.values())
             for k in KERNELS}
    for name in ("paged_decode_attention", "paged_mla_decode_attention",
                 "moe_gemm", "moe_gemm_wgrad"):
        if not total[name]:
            raise AssertionError(f"examples: {name} was never launched")
    for name in ("moe_gemm", "moe_gemm_wgrad"):
        if not out["train_moe"]["launches"][name]:
            raise AssertionError(f"train_moe: {name} was never launched")
    if out["long_context_pooling"]["launches"]["paged_decode_attention"] \
            != 1:
        raise AssertionError("long_context_pooling: paged decode not "
                             "launched exactly once")
    out["launches"] = total
    return out


def examples_long_phase(torch, kops, ref) -> dict:
    """Phase 13: (a) the long-context pool at full width, (b) the four
    examples on the card."""
    t0 = time.perf_counter()
    out = {"long_context": long_context_phase(torch, kops, ref)}
    torch.cuda.empty_cache()
    out["examples"] = examples_phase(torch, kops)
    out["seconds"] = time.perf_counter() - t0
    log(f"examples: phase 13 took {out['seconds']:.1f} s")
    return out


def run(ctx) -> None:
    """The long-context pool at full width, then the four examples."""
    examples = examples_long_phase(ctx.torch, ctx.kops, ctx.ref)
    ctx.out[13] = dict(examples=examples,
                       ex_launches=examples["examples"]["launches"],
                       long_rows=examples["long_context"]["rows"])
