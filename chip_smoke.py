#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port (``src/repro_torch``) on the card and fails (exit code
other than 0) if any phase fails:

1. card    — prints the card's name and power limit (nvidia-smi) and
             turns TF32 off for float32 matmuls and convolutions;
2. build   — compiles every kernel source of
             ``src/repro_torch/kernels/csrc`` with nvcc (one process
             each, all started together), loads them and prints each
             one's ``-Xptxas -v`` report;
3. kernels — holds each kernel against its plain PyTorch version:
             the paged decode kernels at the head geometries of the three
             colocated models (bf16 within 2e-2, float32 within 2e-5 on
             a small shape), with ragged lengths, unmapped (-1) table
             entries past and inside lengths and NaN garbage beyond every
             length, lengths 0 and 1, on and beside a split boundary,
             ending mid-page and one row at context 32768 (GQA and MLA),
             and the smoke configs' geometries (GQA head dim 8, MLA
             r = 16, rp = 8);
             a CUDA-graph replay of the paged GQA and of the paged MLA
             call with new lengths against an eager call, and the GQA and
             MLA wrappers under
             ``set_sync_debug_mode("error")``; flash prefill (S = T up to
             4096, T > S, S and T off the tile, every head dim),
             contiguous decode (ragged lengths with 0 and a split
             boundary, NaN past them) and the SSD scan (float32 within
             1e-3, bf16 ``y`` within 2e-2, ``h`` within 1e-3, with and
             without ``h0``) at the zamba2 / mamba2 geometries, and at
             64 chunks (S = 4096, chunk 64), a chunk of 8, G = 2 and
             B = 2 with ``h0``; the pool write (``paged_kv_write``) bit
             for bit against its plain version (-1 pages, an id past the
             pool, f32 rows into a bf16 pool, an odd row width, 512 rows)
             and under ``set_sync_debug_mode("error")``; then times
             kernel, plain version and, for attention, one
             ``scaled_dot_product_attention`` call on the same data under
             each SDPA backend that takes it (a yardstick only: the port
             never calls it; the fastest is ``library_ms``), beside the
             bound (the SSD scan at S = 1024 and 512);
4. small   — float32 smoke-size models on the card against the CPU
             (plain versions): the colocated set and zamba2 + mamba2;
             prefill and one decode step give the same logits within
             1e-4; then the same smoke models in bf16, as the serve CLI
             runs them by default, served through the engine; then the
             decode graphs: for the smoke coloc set in float32 and bf16
             at K = 1 and 4, and zamba2 + mamba2 in both, a block's graph
             replay gives the same tokens and pool (or dense cache) bytes
             as the step body called eagerly from the same state; a
             block dispatch (copy-in to replay) makes no host read under
             ``set_sync_debug_mode("error")``; and a model evicted from
             the arena and re-activated on other slabs serves the same
             tokens through its graph;
5. serve   — ``CrossPoolEngine(device="cuda")`` over the paper's three
             colocated models at their published widths, bf16, depths
             cut to ``FULL_WIDTH_DEPTHS``: 8 requests, prompts of
             200-900 tokens, 32 new tokens each, K=4.  Every request must
             finish with its token count, every page must return, no
             logit may be NaN, each model's decode graph must have
             replayed exactly once per block, and the paged GQA and MLA
             kernels and the pool write must have launched exactly as
             often as the path runs them (per layer: K per replay, and
             one write per prompt row); then (5h) the same requests under
             ``lowering=False`` with the layer pipeline scheduler and
             without it, with the same checks (one token per host-driven
             step), printing the scheduler's stage count and
             ``overlap_fraction``;
6. serve   — the same engine over zamba2-1.2b and mamba2-130m at their
   fallback  FULL published configs (no depth cut), bf16, through the
             dense-cache fallback path: 8 requests (4 per model), the
             same prompts and outputs, K=1.  The same checks, and flash
             prefill (6 per zamba2 prompt), the SSD scan (32 per zamba2
             and 24 per mamba2 prompt) and contiguous decode (6 per
             zamba2 decode step, one graph replay each) must have
             launched that many times;
7. train   — ``make_train_step`` on moonshot-v1-16b-a3b at its published
             widths, depth cut to ``TRAIN_DEPTH``, float32, through the
             grouped-GEMM MoE path: 5 AdamW steps on one fixed batch of
             8 x 512 ``SyntheticLM`` tokens.  Every loss and grad norm
             must be finite, the last loss below the first, and the
             grouped GEMM must have launched exactly 6 times per layer
             per step (3 forward, 3 input gradients) and its wgrad kernel
             3 times; the router's load of the last step (the group sizes
             of each layer) is recorded;
8. moe gemm — holds the grouped GEMM (forward, input and weight
             gradients) against its plain versions, float32 within 1e-4
             and bf16 within 2e-2, at both shapes phase 7 gives it
             (gate/up: K = d_model, M = d_ff; down: K = d_ff, M = d_model)
             with each layer's recorded load, with that load's 4 least
             loaded experts emptied, with every expert boundary one row
             past a 128-row tile edge, with one expert holding 90% of
             the rows, and on a small shape with empty experts and rows
             off 16 bytes; then times it at the gate/up shape and layer
             0's load, and the weight gradient at the skewed load too.

Phase 4 also runs one float32 smoke train step of qwen3-moe (both MoE
paths) and minicpm3 on the card against the CPU (loss, grad norm and
updated params within 1e-4 of each leaf's scale, max(1, max|leaf|)).

The profile of phase 6's prefill step prints the SSD scan's share of
the device time, the profiles of phase 5 paged MLA's.  Launch counts
are set to 0 just before each serve or train phase and read just after
it; the engine captures its decode graphs when it is built, before that,
and each replay adds the kernel launches its capture recorded.  It prints a JSON line with every kernel's numbers,
then, as its last line, ``{"ok": true, "device": {...}}``.  The full
kernel table, the serve and train figures and the profiles go to
``build/chip_smoke.json``.
"""
from __future__ import annotations

import gc
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
FP32_FLOPS = 67e12              # H100 SXM float32 peak (CUDA cores)
CONTEXTS = (1024, 8192)
BATCHES = (1, 4)
#: ~1 ms of spin (torch.cuda._sleep cycles) ahead of each timed call
SPIN_CYCLES = 2_000_000
#: the __global__ functions of ``csrc/``, as the profiler names them
PORT_KERNELS = ("flash_prefill", "split_decode_kernel", "merge_splits_kernel",
                "paged_gqa_decode_kernel", "paged_mla_decode_kernel",
                "mla_split_decode_kernel", "mla_merge_splits_kernel",
                "ssd_chunk_state_kernel", "ssd_state_pass_kernel",
                "ssd_chunk_output_kernel", "moe_gemm")
SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION",
                 "MATH")
SERVE_K = 4
SERVE_MAX_NEW = 32
FALLBACK_MODELS = ("zamba2-1.2b", "mamba2-130m")
#: every kernel entry point, by the name its launch counter is read under
KERNELS = ("paged_decode_attention", "paged_mla_decode_attention",
           "flash_attention", "decode_attention", "ssd_scan", "moe_gemm",
           "moe_gemm_wgrad", "paged_kv_write")
#: phase 7: moonshot at published widths, this many layers, float32
TRAIN_MODEL = "moonshot-v1-16b-a3b"
TRAIN_DEPTH = 2
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 5
#: phase 8 times these kernels at these of its shapes and loads
TIMED_LOADS = {"gate/up layer 0": ("moe_gemm", "moe_gemm_dgrad",
                                   "moe_gemm_wgrad"),
               "gate/up skewed load": ("moe_gemm_wgrad",)}


def log(msg: str) -> None:
    print(msg, flush=True)


def reset_launches(kops) -> None:
    for name in KERNELS:
        getattr(kops, name).launches = 0


def read_launches(kops) -> dict:
    return {name: getattr(kops, name).launches for name in KERNELS}


def bound_ms(nbytes: float, flops: float, fp32: bool = False):
    """(least time in ms, what bounds it): bytes over the HBM rate vs
    flops over the peak of the work's type: the bf16 tensor-core peak, or
    the float32 peak for float32 work (``fp32``)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (FP32_FLOPS if fp32 else BF16_FLOPS) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def time_ms(torch, fn, iters: int = 20) -> float:
    """Median device time of one call, L2 flushed before each call (the
    decode step finds a layer's KV cold).  A spin kernel after the flush
    keeps the card busy while the host enqueues the timed call, so the
    two events bracket the call's device time, not the host's enqueue
    time (a call that takes microseconds on the card takes longer than
    that to enqueue)."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in zip(starts, ends))
    return times[len(times) // 2]


def library_sdpa(torch, call):
    """(fastest ms, its backend, every backend's ms or why it refused) of
    ``call`` — one ``scaled_dot_product_attention`` call — under each SDPA
    backend that accepts its inputs: the library yardstick, never called
    by the port."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    times = {}
    for name in SDPA_BACKENDS:
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            times[name] = f"torch {torch.__version__} has no {name}"
            continue

        def run(backend=backend):
            with sdpa_kernel(backend):
                return call()
        try:                          # a yardstick, not a kernel of the port
            run()
            torch.cuda.synchronize()
        except RuntimeError as err:
            times[name] = f"refused: {str(err).splitlines()[0][:100]}"
            continue
        times[name] = time_ms(torch, run)
    ok = {k: v for k, v in times.items() if isinstance(v, float)}
    best = min(ok, key=ok.get)
    return ok[best], f"sdpa {best.lower()}", times


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


def make_inputs(torch, case, lengths, max_pages, dtype, gen, garbage,
                holes=()):
    """(q, pool, table, lengths) with every valid token random and, when
    ``garbage``, NaN everywhere else: slots past a length, mapped pages
    past it, unmapped pages and page slack.  ``holes``: (row, page index)
    pairs unmapped (-1) inside the row's length, their pages NaN."""
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
            if (b, p) in holes:
                continue
            n_tok = min(case.tpp, lengths[b] - p * case.tpp)
            vals = torch.randn((n_tok * case.per_tok,), generator=gen,
                               device="cuda").to(dtype)
            pool[ids[p], :n_tok * case.per_tok] = vals
    for b, p in holes:
        table[b, p] = -1
    q = torch.randn((B, 1, case.H, case.q_dim), generator=gen,
                    device="cuda").to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, pool, table.cuda(), lens


def without_holes(case, table, lengths, holes):
    """What the plain version must see to compute what the kernel does:
    each hole (a whole page unmapped inside a length, which the kernel
    skips) taken out of its row, the row's later pages moved up and its
    length cut by one page."""
    table, lengths = table.clone(), lengths.clone()
    for b in {b for b, _ in holes}:
        gone = sorted(p for r, p in holes if r == b)
        assert all((p + 1) * case.tpp < int(lengths[b]) for p in gone)
        keep = [p for p in range(table.shape[1]) if p not in gone]
        row = table[b, keep]
        table[b] = -1
        table[b, :len(keep)] = row
        lengths[b] -= len(gone) * case.tpp
    return table, lengths


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


def check(torch, kops, ref, case, lengths, max_pages, dtype, tol, gen,
          holes=()):
    q, pool, table, lens = make_inputs(torch, case, lengths, max_pages,
                                       dtype, gen, garbage=True, holes=holes)
    got = run_kernel(kops, case, q, pool, table, lens).float()
    want = run_plain(ref, case, q, pool,
                     *without_holes(case, table, lens, holes)).float()
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
    return bound_ms(nbytes, flops)


def split_boundary(torch, case, B, max_pages) -> int:
    """First token of the second split of the bf16 GQA or MLA kernel for
    B rows over this table: a length equal to it ends exactly on a
    boundary."""
    from repro_torch.kernels import paged_attention as pa
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    tokens = max_pages * case.tpp
    if case.kind == "gqa":
        _, splits = pa.split_plan(B, case.H, case.KV, tokens, sm)
    else:
        _, splits = pa.mla_split_plan(B, case.H, tokens, sm)
    return pa.split_start(1, splits, tokens)


def kernel_phase(torch, kops, ref, cases):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    errs = {}

    def run_check(case, lengths, max_pages, dtype, tol, holes=(), note=""):
        e = check(torch, kops, ref, case, lengths, max_pages, dtype, tol,
                  gen, holes)
        errs[case.kind] = max(errs.get(case.kind, 0.0), e)
        log(f"kernel check {case.name} {str(dtype)[6:]} lengths {lengths}"
            f"{note}: max abs err {e:.3g} (tolerance {tol})")

    for case in cases:
        tpp = case.tpp
        whole = tpp * 37                      # ends exactly on a page
        mid = tpp * 20 + max(tpp // 2, 1) if tpp > 1 else 41
        max_pages = math.ceil(1024 / tpp)
        run_check(case, [1000, whole, mid, 1], max_pages, torch.bfloat16,
                  2e-2)
        # the split kernel's edges: length 0 and 1, on a split boundary
        # and one token either side of it, ending mid-page
        edge = split_boundary(torch, case, 6, max_pages)
        lengths = [0, 1, edge, edge - 1, edge + 1,
                   tpp * min(50, max_pages - 3) + max(1, tpp // 2)]
        run_check(case, lengths, max_pages, torch.bfloat16, 2e-2,
                  note=f" (split boundary {edge})")
        # unmapped (-1) pages inside a length are skipped
        holes = ((0, 3), (1, 10), (1, 11))
        run_check(case, [1000, 700], max_pages, torch.bfloat16, 2e-2,
                  holes=holes, note=f" (-1 pages at (row, page) {holes})")
        # one row at a long context: many tiles per split
        run_check(case, [32768 - 3], math.ceil(32768 / tpp), torch.bfloat16,
                  2e-2)
    # float32 on one small shape per kernel
    small = [Case("gqa-small", "gqa", 8, 8 * 2 * 4 * 64, H=16, KV=4, D=64),
             Case("mla-small", "mla", 8, 8 * 80 + 16, H=8, r=64, rp=16)]
    for case in small:
        run_check(case, [37, 16, 1], 8, torch.float32, 2e-5)
    run_check(small[0], [0, 37, 30], 8, torch.float32, 2e-5,
              holes=((1, 1),), note=" (-1 page at (row, page) (1, 1))")
    # the smoke configs' GQA geometry (head dim 8, CUDA cores), bf16: what
    # the serve CLI runs by default
    d8 = Case("gqa-smoke-d8", "gqa", 8, 8 * 2 * 2 * 8, H=8, KV=2, D=8)
    run_check(d8, [0, 1, 37, 64], 8, torch.bfloat16, 2e-2)
    # ... and its MLA geometry (r + rp = 24: the score's k padded to 32)
    mla_smoke = Case("mla-smoke", "mla", 8, 8 * 24 + 8, H=4, r=16, rp=8)
    run_check(mla_smoke, [0, 1, 37, 64], 8, torch.bfloat16, 2e-2)
    run_check(mla_smoke, [300, 65, 64, 63], 40, torch.bfloat16, 2e-2,
              note=" (several splits)")
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
                lib, lib_name, lib_all = library_sdpa(
                    torch, sdpa_call(torch, case, q, pool, table, lens))
                b_ms, b_by = bound(case, B, ctx, max_pages, 2)
                rows.append(dict(case=case.name, kind=case.kind, ctx=ctx,
                                 B=B, ms=ms, plain_ms=plain, library_ms=lib,
                                 library=lib_name, library_all=lib_all,
                                 bound_ms=b_ms, bound_by=b_by))
                log(f"time {case.name} ctx {ctx} B {B}: kernel {ms:.4f} ms, "
                    f"plain {plain:.4f} ms, {lib_name} {lib:.4f} ms, "
                    f"bound {b_ms:.4f} ms ({b_by}); sdpa backends "
                    f"{fmt_backends(lib_all)}")
                del q, pool, table, lens
    return errs, rows


def fmt_backends(times) -> str:
    return ", ".join(f"{k.lower()} {v:.4f}" if isinstance(v, float)
                     else f"{k.lower()} {v}" for k, v in times.items())


def capture_check(torch, kops, cases):
    """The bf16 GQA and MLA decode wrappers read nothing back to the host
    (they run under ``set_sync_debug_mode("error")``), and a paged GQA
    call and a paged MLA call, each captured in a CUDA graph and replayed
    after new lengths are written in place, equal an eager call on those
    lengths."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    gqa = next(c for c in cases if c.kind == "gqa")
    mla = next(c for c in cases if c.kind == "mla")
    paged = []
    for case in (gqa, mla):
        max_pages = math.ceil(1024 / case.tpp)
        paged.append((case, make_inputs(torch, case, [1000, 1024, 333, 64],
                                        max_pages, torch.bfloat16, gen,
                                        garbage=True)))
    ck = torch.randn((2, 512, 2, 64), generator=gen, device="cuda").to(
        torch.bfloat16)
    qc = torch.randn((2, 1, 8, 64), generator=gen, device="cuda").to(
        torch.bfloat16)
    clens = torch.tensor([512, 77], dtype=torch.int32, device="cuda")

    def calls():
        return ([run_kernel(kops, case, *inputs) for case, inputs in paged]
                + [kops.decode_attention(qc, ck, ck, clens, scale=0.125)])
    calls()                                  # built, attributes set
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        calls()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls()
    torch.cuda.current_stream().wait_stream(side)
    for case, inputs in paged:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = run_kernel(kops, case, *inputs)
        inputs[3].copy_(torch.tensor([700, 1, 0, 64], dtype=torch.int32))
        graph.replay()
        want = run_kernel(kops, case, *inputs)
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError(f"graph replay of the {case.name} decode "
                                 f"call after new lengths differs from an "
                                 f"eager call")
    log(f"kernel check {gqa.name} and {mla.name}: no host sync under "
        f"set_sync_debug_mode('error') (paged GQA, paged MLA, contiguous); "
        f"a CUDA-graph replay of each paged call with new lengths "
        f"[700, 1, 0, 64] equals eager")


def close_or_raise(torch, what, got, want, tol) -> float:
    """Max abs error of ``got`` against ``want``; raises past
    ``tol + tol * |want|`` or on a non-finite output."""
    got, want = got.float(), want.float()
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: kernel output is not finite")
    err = (got - want).abs()
    if (err > tol + tol * want.abs()).any():
        raise AssertionError(f"{what}: kernel disagrees with the plain "
                             f"version (max abs err {err.max().item():.3g},"
                             f" tolerance {tol})")
    log(f"kernel check {what}: max abs err {err.max().item():.3g} "
        f"(passes |err| <= {tol} + {tol} * |plain|)")
    return err.max().item()


def fallback_kernel_phase(torch, kops, ref, ssd_scan_chunked):
    """Flash prefill, contiguous decode and the SSD scan at the fallback
    path's geometries: checks, then times (bf16, the path's dtype)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import paged_attention as pa
    zamba = get_config("zamba2-1.2b")
    mamba = get_config("mamba2-130m")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    H, KV, D = zamba.n_heads, zamba.n_kv_heads, zamba.head_dim
    errs, rows = {}, []

    # flash prefill: zamba2 heads, S = T in {256, 1024, 4096}, B = 1
    for S in (256, 1024, 4096):
        for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 2e-5)):
            if dtype == torch.float32 and S > 1024:
                continue
            q, k, v = (randn(1, S, n, D, dtype=dtype) for n in (H, KV, KV))
            e = close_or_raise(
                torch, f"flash zamba2 S={S} {dtype}",
                kops.flash_attention(q, k, v, scale=D ** -0.5),
                ref.flash_attention(q, k, v, D ** -0.5), tol)
            errs["flash_attention"] = max(errs.get("flash_attention", 0), e)
        q, k, v = (randn(1, S, n, D) for n in (H, KV, KV))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        pairs = S * (S + 1) // 2
        b_ms, b_by = bound_ms(4 * S * H * D * 2, 4 * H * D * pairs)
        lib, lib_name, lib_all = library_sdpa(torch, lambda: sdpa(
            qt, kt, vt, is_causal=True, scale=D ** -0.5, enable_gqa=True))
        rows.append(dict(
            kernel="flash_attention", shape=f"zamba2 B=1 S={S} bf16",
            ms=time_ms(torch, lambda: kops.flash_attention(
                q, k, v, scale=D ** -0.5)),
            plain_ms=time_ms(torch, lambda: ref.flash_attention(
                q, k, v, D ** -0.5)),
            library_ms=lib, library=lib_name, library_all=lib_all,
            bound_ms=b_ms, bound_by=b_by))
    # the tensor-core route's edges: T > S (an offset that is no multiple
    # of the tile), S and T off the tile, every head dim, GQA groups
    for B, S, T, Hh, Kh, Dh in ((1, 100, 1000, 8, 2, 64),
                                (2, 77, 77, 4, 4, 16),
                                (1, 190, 250, 8, 2, 16),
                                (1, 190, 250, 8, 2, 32),
                                (1, 190, 250, 8, 2, 64),
                                (1, 190, 250, 8, 2, 128)):
        q, k, v = (randn(B, n, h, Dh) for n, h in ((S, Hh), (T, Kh), (T, Kh)))
        e = close_or_raise(
            torch, f"flash B={B} S={S} T={T} H={Hh} KV={Kh} D={Dh} bf16",
            kops.flash_attention(q, k, v, scale=Dh ** -0.5),
            ref.flash_attention(q, k, v, Dh ** -0.5), 2e-2)
        errs["flash_attention"] = max(errs["flash_attention"], e)

    # contiguous decode: zamba2 heads, T = 1024, B in {1, 4}
    T = 1024
    for B in (1, 4):
        for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 2e-5)):
            q = randn(B, 1, H, D, dtype=dtype)
            ck, cv = randn(B, T, KV, D, dtype=dtype), randn(B, T, KV, D,
                                                            dtype=dtype)
            lengths = [T, 517, 1, 300][:B]
            for b, n in enumerate(lengths):
                ck[b, n:] = float("nan")
                cv[b, n:] = float("nan")
            lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
            e = close_or_raise(
                torch, f"decode zamba2 B={B} T={T} lengths {lengths} {dtype}",
                kops.decode_attention(q, ck, cv, lens, scale=D ** -0.5),
                ref.decode_attention(q, ck, cv, lens, D ** -0.5), tol)
            errs["decode_attention"] = max(errs.get("decode_attention", 0), e)
        q, ck, cv = randn(B, 1, H, D), randn(B, T, KV, D), randn(B, T, KV, D)
        lens = torch.full((B,), T, dtype=torch.int32, device="cuda")
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, ck, cv))
        b_ms, b_by = bound_ms(2 * B * T * KV * D * 2 + 2 * B * H * D * 2
                              + 4 * B, 4 * B * H * T * D)
        lib, lib_name, lib_all = library_sdpa(torch, lambda: sdpa(
            qt, kt, vt, scale=D ** -0.5, enable_gqa=True))
        rows.append(dict(
            kernel="decode_attention", shape=f"zamba2 B={B} T={T} bf16",
            ms=time_ms(torch, lambda: kops.decode_attention(
                q, ck, cv, lens, scale=D ** -0.5)),
            plain_ms=time_ms(torch, lambda: ref.decode_attention(
                q, ck, cv, lens, D ** -0.5)),
            library_ms=lib, library=lib_name, library_all=lib_all,
            bound_ms=b_ms, bound_by=b_by))
    # the split kernel's edges on the contiguous cache: length 0 and 1,
    # on a split boundary and one past it, and past T (clamped)
    B = 6
    _, splits = pa.split_plan(
        B, H, KV, T, torch.cuda.get_device_properties(0).multi_processor_count)
    edge = pa.split_start(1, splits, T)
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 2e-5)):
        lengths = [0, 1, edge, edge + 1, 700, T + 5]
        q = randn(B, 1, H, D, dtype=dtype)
        ck, cv = randn(B, T, KV, D, dtype=dtype), randn(B, T, KV, D,
                                                        dtype=dtype)
        for b, n in enumerate(lengths):
            ck[b, n:] = float("nan")
            cv[b, n:] = float("nan")
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        e = close_or_raise(
            torch, f"decode zamba2 B={B} T={T} lengths {lengths} {dtype}",
            kops.decode_attention(q, ck, cv, lens, scale=D ** -0.5),
            ref.decode_attention(q, ck, cv, lens, D ** -0.5), tol)
        errs["decode_attention"] = max(errs["decode_attention"], e)

    # SSD scan: zamba2 and mamba2 at S = 1024, chunk 256
    def ssd_inputs(B, S, Hs, P, G, N, dtype, with_h0, shift=2.0):
        x = randn(B, S, Hs, P, dtype=dtype)
        dt = torch.nn.functional.softplus(
            randn(B, S, Hs, dtype=torch.float32) - shift)
        A = -torch.exp(torch.linspace(0.0, 2.77, Hs, device="cuda"))
        Bm, Cm = randn(B, S, G, N, dtype=dtype), randn(B, S, G, N,
                                                       dtype=dtype)
        h0 = randn(B, Hs, P, N, dtype=torch.float32) if with_h0 else None
        return x, dt, A, Bm, Cm, h0

    def ssd_check(what, L, x, dt, A, Bm, Cm, h0, tol):
        y, h = kops.ssd_scan(x, dt, A, Bm, Cm, chunk=L, h0=h0)
        wy, wh = ssd_scan_chunked(x, dt, A, Bm, Cm, chunk=L, h0=h0)
        e = close_or_raise(torch, what + " y", y, wy, tol)
        close_or_raise(torch, what + " h", h, wh, 1e-3)
        errs["ssd_scan"] = max(errs.get("ssd_scan", 0), e)

    geoms = {}
    for label, cfg in (("zamba2", zamba), ("mamba2", mamba)):
        s = cfg.ssm
        geoms[label] = (s.n_heads(cfg.d_model), s.head_dim, s.n_groups,
                        s.d_state)
    S, L = 1024, 256
    for label, (Hs, P, G, N) in geoms.items():
        for dtype, tol in ((torch.float32, 1e-3), (torch.bfloat16, 2e-2)):
            for with_h0 in (False, True):
                ssd_check(f"ssd {label} S={S} chunk {L} {dtype} h0={with_h0}",
                          L, *ssd_inputs(1, S, Hs, P, G, N, dtype, with_h0),
                          tol)
    # the chunk-parallel design's edges: 64 chunks, a chunk off the mma
    # tile, two groups, two batch rows with h0
    Hz, Pz, _, Nz = geoms["zamba2"]
    Hm, Pm, _, Nm = geoms["mamba2"]
    for B, S_, Hs, P, G, N, L_, with_h0, note in (
            (1, 4096, Hm, Pm, 1, Nm, 64, True, "64 chunks"),
            (1, 40, 4, Pz, 1, Nz, 8, True, "chunk 8"),
            (1, 512, 8, Pz, 2, Nz, 128, False, "G=2"),
            (2, 512, Hz, Pz, 1, Nz, 256, True, "B=2 with h0")):
        for dtype, tol in ((torch.float32, 1e-3), (torch.bfloat16, 2e-2)):
            ssd_check(f"ssd {note}: B={B} S={S_} H={Hs} P={P} G={G} N={N} "
                      f"chunk {L_} {dtype} h0={with_h0}", L_,
                      *ssd_inputs(B, S_, Hs, P, G, N, dtype, with_h0), tol)
    # timed at the path's two prompt sizes: 200-900-token prompts mostly
    # run the 512 bucket, the profiled 1024 bucket is the largest
    for S in (1024, 512):
        for label, (Hs, P, G, N) in geoms.items():
            x, dt, A, Bm, Cm, _ = ssd_inputs(1, S, Hs, P, G, N,
                                             torch.bfloat16, False, 0.0)
            nbytes = (2 * S * Hs * P * 2 + S * Hs * 4 + Hs * 4
                      + 2 * S * G * N * 2 + Hs * P * N * 4)
            flops = Hs * (S // L) * (L * L * (N + P) + 4 * L * N * P)
            b_ms, b_by = bound_ms(nbytes, flops)
            rows.append(dict(
                kernel="ssd_scan", shape=f"{label} H={Hs} P={P} N={N} "
                                         f"S={S} chunk {L} bf16",
                ms=time_ms(torch, lambda: kops.ssd_scan(x, dt, A, Bm, Cm,
                                                        chunk=L)),
                plain_ms=time_ms(torch, lambda: ssd_scan_chunked(
                    x, dt, A, Bm, Cm, chunk=L)),
                library_ms=None, bound_ms=b_ms, bound_by=b_by))
    for r in rows:
        lib = ("library none (no single PyTorch call computes it)"
               if r["library_ms"] is None else
               f"{r['library']} {r['library_ms']:.4f} ms (sdpa backends "
               f"{fmt_backends(r['library_all'])})")
        log(f"time {r['kernel']} {r['shape']}: kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), {lib}")
    return errs, rows


def with_empty_experts(np, sizes, n_empty: int = 4):
    """``sizes`` with the rows of its ``n_empty`` least loaded experts
    moved onto the most loaded one: the same rows, some experts empty."""
    out = sizes.copy()
    idle = np.argsort(out, kind="stable")[:n_empty]
    busiest = int(np.argmax(out))
    out[busiest] += out[idle].sum()
    out[idle] = 0
    return out


def off_tile_edges(np, n, experts, tile=128):
    """``n`` rows over ``experts`` whose every boundary falls one row past
    a ``tile``-row edge (the grouped GEMM's row tile)."""
    per = n // experts // tile * tile
    sizes = np.full(experts, per, np.int32)
    sizes[0] += 1
    sizes[-1] = n - int(sizes[:-1].sum())
    return sizes


def skewed(np, n, experts, share=0.9):
    """``n`` rows with one expert holding at least ``share`` of them."""
    rest = int(n * (1 - share)) // (experts - 1)
    sizes = np.full(experts, rest, np.int32)
    sizes[experts // 2] = n - rest * (experts - 1)
    return sizes


def library_grouped_mm(torch, a, b, offs):
    """(``torch._grouped_mm`` call, None) on these operands, or (None, the
    reason it cannot run them): the library yardstick, never called by the
    port."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None, f"torch {torch.__version__} has no torch._grouped_mm"
    try:
        fn(a, b, offs=offs)
        torch.cuda.synchronize()
    except (RuntimeError, TypeError, ValueError) as err:
        return None, f"torch._grouped_mm refuses {a.dtype}: " \
                     f"{str(err).splitlines()[0][:120]}"
    return (lambda: fn(a, b, offs=offs)), None


def moe_kernel_phase(torch, np, kops, ref, loads):
    """Phase 8: the grouped GEMM at the shapes phase 7 gives it (x
    [8*512*top-6, K], w [E, K, M] with (K, M) = (d_model, d_ff) for gate
    and up, (d_ff, d_model) for down) with the router's ``loads`` (one
    [E] array per layer), the first of them with 4 experts emptied, and a
    small ragged shape with empty experts: forward, input gradient and
    weight gradient against the plain versions (float32 within 1e-4, bf16
    within 2e-2).  Then timed in both types at the gate/up shape and
    ``loads[0]`` (the weight gradient at the skewed load too,
    ``TIMED_LOADS``), beside the bound and one ``torch._grouped_mm`` call
    where the card's torch takes the type.  Inputs at the model's scales:
    x unit normal, w LeCun normal (as ``init_moe``), dy unit normal over
    sqrt(rows per expert), so that every sum is O(1) as in training (with
    unit weights a K = 2048 sum carries f32 rounding of ~1e-4 in any
    order)."""
    from repro_torch.configs import get_config
    cfg = get_config(TRAIN_MODEL)
    N = TRAIN_BATCH * TRAIN_SEQ * cfg.experts_per_token
    D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    errs, rows = {"moe_gemm": 0.0, "moe_gemm_wgrad": 0.0}, []
    shapes = [(f"{proj} layer {i}", N, k, m, sizes)
              for i, sizes in enumerate(loads)
              for proj, k, m in (("gate/up", D, F), ("down", F, D))]
    shapes += [(f"{proj} layer 0, 4 experts emptied", N, k, m,
                with_empty_experts(np, loads[0]))
               for proj, k, m in (("gate/up", D, F), ("down", F, D))]
    shapes += [(f"{proj} {name} load", N, k, m, sizes)
               for name, sizes in (("off-tile-edge", off_tile_edges(np, N, E)),
                                   ("skewed", skewed(np, N, E)))
               for proj, k, m in (("gate/up", D, F), ("down", F, D))]
    shapes.append(("small", 77, 48, 130, np.array([30, 0, 0, 40, 0],
                                                  np.int32)))
    for label, n, k, m, sizes in shapes:
        gs = torch.from_numpy(sizes).cuda()
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            x = torch.randn((n, k), generator=gen, device="cuda").to(dtype)
            w = (torch.randn((len(sizes), k, m), generator=gen,
                             device="cuda") * k ** -0.5).to(dtype)
            dy = (torch.randn((n, m), generator=gen, device="cuda")
                  * (len(sizes) / n) ** 0.5).to(dtype)
            what = f"moe_gemm {label} N={n} K={k} M={m} E={len(sizes)} " \
                   f"{dtype}"
            e1 = close_or_raise(torch, what + " forward",
                                kops.moe_gemm(x, w, gs),
                                ref.moe_gemm(x, w, gs), tol)
            e2 = close_or_raise(torch, what + " dgrad",
                                kops.moe_gemm_dgrad(dy, w, gs),
                                ref.moe_gemm(dy, w.transpose(1, 2), gs), tol)
            e3 = close_or_raise(torch, what + " wgrad",
                                kops.moe_gemm_wgrad(x, dy, gs),
                                ref.moe_gemm_wgrad(x, dy, gs), tol)
            if dtype == torch.float32:
                errs["moe_gemm"] = max(errs["moe_gemm"], e1, e2)
                errs["moe_gemm_wgrad"] = max(errs["moe_gemm_wgrad"], e3)
            timed = TIMED_LOADS.get(label)
            if timed is None:
                continue
            itemsize = x.element_size()
            fp32 = dtype == torch.float32
            offs = torch.cumsum(gs, 0, dtype=torch.int32)
            flops = 2.0 * int(sizes.sum()) * k * m
            # forward and dgrad read only the experts that have rows; wgrad
            # writes every expert's gradient
            busy = int((sizes > 0).sum())
            for kernel, call, plain, lib_args, nbytes in (
                    ("moe_gemm",
                     lambda: kops.moe_gemm(x, w, gs),
                     lambda: ref.moe_gemm(x, w, gs), (x, w),
                     (n * k + busy * k * m + n * m) * itemsize + (E + 1) * 4),
                    ("moe_gemm_dgrad",
                     lambda: kops.moe_gemm_dgrad(dy, w, gs),
                     lambda: ref.moe_gemm(dy, w.transpose(1, 2), gs),
                     (dy, w.transpose(1, 2)),
                     (n * m + busy * k * m + n * k) * itemsize + (E + 1) * 4),
                    ("moe_gemm_wgrad",
                     lambda: kops.moe_gemm_wgrad(x, dy, gs),
                     lambda: ref.moe_gemm_wgrad(x, dy, gs), (x.T, dy),
                     (n * k + n * m + E * k * m) * itemsize + (E + 1) * 4)):
                if kernel not in timed:
                    continue
                lib, why = library_grouped_mm(torch, *lib_args, offs)
                b_ms, b_by = bound_ms(nbytes, flops, fp32=fp32)
                rows.append(dict(
                    kernel=kernel, shape=f"N={n} K={k} M={m} E={E} "
                                         f"{str(dtype)[6:]}",
                    load=label, dtype=str(dtype)[6:], ms=time_ms(torch, call),
                    plain_ms=time_ms(torch, plain),
                    library_ms=None if lib is None else time_ms(torch, lib),
                    library_note=why, bound_ms=b_ms, bound_by=b_by))
            del x, w, dy
    for r in rows:
        lib = (f"{r['library_ms']:.4f} ms" if r["library_ms"] is not None
               else f"none ({r['library_note']})")
        log(f"time {r['kernel']} {r['shape']} ({r['load']}): kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, _grouped_mm "
            f"{lib}, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
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


class LoadRecorder:
    """Stands in for the kernel ops inside ``models.moe``: records the
    group sizes (the router's load) of every grouped-GEMM call and passes
    each call on unchanged, so the launch counts stay the kernels' own."""

    def __init__(self, kops):
        self.kops, self.sizes = kops, []

    def __getattr__(self, name):
        return getattr(self.kops, name)

    def moe_gemm(self, x, w, group_sizes):
        self.sizes.append(group_sizes)
        return self.kops.moe_gemm(x, w, group_sizes)


def train_phase(torch, np, kops):
    """Phase 7: moonshot at published widths, ``TRAIN_DEPTH`` layers,
    float32, ``AdamW(lr=3e-3, warmup_steps=10)`` as ``launch/train.py``,
    no remat, the grouped MoE path; ``TRAIN_STEPS`` steps on one fixed
    batch.  Returns (launches, figures, the last step's router load: one
    [E] int32 array per layer)."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.model import build_model
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)
    from repro_torch.training.tree import leaves

    cfg = get_config(TRAIN_MODEL).replace(n_layers=TRAIN_DEPTH,
                                          dtype="float32")
    model = build_model(cfg)
    opt = AdamW(lr=3e-3, warmup_steps=10)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(model, opt,
                             torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(p.numel() for p in leaves(state.params))
    step = make_train_step(model, opt, remat=False,
                           extra_inputs=lambda b: {"moe_path": "grouped"})
    data = SyntheticLM(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH))
    batch = {"tokens": torch.from_numpy(next(data.batches())["tokens"])
             .cuda()}
    torch.cuda.synchronize()
    log(f"train: {TRAIN_MODEL} at published widths, {TRAIN_DEPTH} layers, "
        f"float32, {n_params / 1e9:.3f} B params, state built in "
        f"{time.perf_counter() - t0:.1f} s")
    # the main path's run: launch counts start at 0 here
    reset_launches(kops)
    losses, gnorms, times = [], [], []
    moe.kops = recorder = LoadRecorder(kops)
    try:
        for i in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))     # waits for the step
            gnorms.append(float(metrics["grad_norm"]))
            times.append(time.perf_counter() - t0)
            log(f"train step {i}: loss {losses[-1]:.5f} ce "
                f"{float(metrics['ce']):.5f} aux "
                f"{float(metrics['aux']):.5f} grad norm {gnorms[-1]:.4f}, "
                f"{times[-1] * 1e3:.1f} ms")
    finally:
        moe.kops = kops
    torch.cuda.synchronize()
    launches = read_launches(kops)
    # three grouped GEMMs per layer share one load; the last step's
    loads = [g.cpu().numpy() for g in
             recorder.sizes[-3 * TRAIN_DEPTH::3]]
    for i, sizes in enumerate(loads):
        log(f"train: router load of layer {i} in the last step (rows per "
            f"expert): {sizes.tolist()}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not all(math.isfinite(v) for v in losses + gnorms):
        raise AssertionError(f"train: non-finite loss or grad norm "
                             f"{losses} {gnorms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: loss did not fall on the fixed batch "
                             f"{losses}")
    want = {"moe_gemm": 6 * TRAIN_DEPTH * TRAIN_STEPS,
            "moe_gemm_wgrad": 3 * TRAIN_DEPTH * TRAIN_STEPS}
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"train: {name} launched {launches[name]} "
                                 f"times, expected {n}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    steady = sorted(times[1:])[len(times[1:]) // 2]
    log(f"train: launches {launches} (expected {want}); median step "
        f"after the first {steady * 1e3:.1f} ms = {tokens / steady:.0f} "
        f"tokens/s; max memory allocated {peak:.2f} GiB")
    figures = dict(model=TRAIN_MODEL, layers=TRAIN_DEPTH, params=n_params,
                   batch=TRAIN_BATCH, seq=TRAIN_SEQ, losses=losses,
                   grad_norms=gnorms, step_ms=[t * 1e3 for t in times],
                   median_step_ms=steady * 1e3, tokens_per_s=tokens / steady,
                   max_memory_gib=peak, loads=[s.tolist() for s in loads])
    figures["profile"] = profile_train_step(torch, step, state, batch)
    return launches, figures, loads


def serve_phase(torch, np, kops, models, *, k, page_budget, label, check,
                lowering=True, pipeline=True):
    """``CrossPoolEngine(device="cuda")`` over ``models`` (bf16): 8
    requests at time 0, prompts of 200-900 tokens, 32 new tokens each,
    ``max_batch=4``, ``max_ctx=1024``, ``k`` tokens per dispatch, in the
    given engine mode.  Launch counts are 0 just before the run and read
    just after it; each model's decode graph must have replayed once per
    block; ``check(launches, stats, engine)`` adds the phase's own checks.
    Returns (launches, figures)."""
    from repro_torch.configs.base import EngineConfig
    from repro_torch.runtime.engine import CrossPoolEngine, EngineMode
    from repro_torch.runtime.observe import percentile
    from repro_torch.runtime.request import Request

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = CrossPoolEngine(
        models, page_budget=page_budget, max_batch=4, max_ctx=1024, seed=0,
        device="cuda",
        config=EngineConfig(mode=EngineMode(
            lowering=lowering, pipeline=pipeline,
            decode_steps_per_dispatch=k)))
    torch.cuda.synchronize()
    arena = (f"arena {engine.arena.device_bytes() / 2**30:.2f} GiB"
             if engine.arena is not None else "no arena")
    pool_mib = engine.virt.page_budget * engine.virt.page_bytes / 2**20
    pool = (f"pool {pool_mib:.0f} MiB" if engine.virt.pool is not None
            else "no device page pool")
    log(f"{label}: engine built in {time.perf_counter() - t0:.1f} s "
        f"(weights drawn on the card, {arena}, {pool})")
    rng = np.random.default_rng(0)
    names = list(models)
    reqs = [Request(i, names[i % len(names)], int(rng.integers(200, 901)),
                    SERVE_MAX_NEW, 0.0) for i in range(8)]
    # the main path's run: launch counts start at 0 here
    reset_launches(kops)
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    stats = engine.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(kops)
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
    graphs = graph_report(engine, stats, label)
    check(launches, stats, engine)
    schedule = {}
    if engine.scheduler is not None:
        schedule = dict(stages=len(engine.scheduler.stage_log),
                        overlap_fraction=engine.scheduler.overlap_fraction())
        log(f"{label}: the scheduler issued {schedule['stages']} stages, "
            f"overlap_fraction {schedule['overlap_fraction']:.4f}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"{label}: {len(reqs)} requests, prompts "
        f"{[r.prompt_tokens for r in reqs]}, {stats.tokens_out} tokens in "
        f"{wall:.2f} s wall = {stats.tokens_out / wall:.1f} tokens/s")
    log(f"{label}: TBT p50 {percentile(stats.tbt, 50) * 1e3:.2f} ms, "
        f"p99 {percentile(stats.tbt, 99) * 1e3:.2f} ms; TTFT p50 "
        f"{percentile(stats.ttft, 50) * 1e3:.1f} ms")
    for model, B, bucket, dt in stats.prefill_times:
        log(f"{label}: prefill {model} B={B} bucket {bucket}: "
            f"{dt * 1e3:.1f} ms")
    log(f"{label}: launches {launches}; max memory allocated {peak:.2f} GiB")
    # read before the profiled step, which adds requests to the same stats
    figures = dict(
        tokens=stats.tokens_out, wall_s=wall,
        tokens_per_s=stats.tokens_out / wall,
        tbt_p50_ms=percentile(stats.tbt, 50) * 1e3,
        tbt_p99_ms=percentile(stats.tbt, 99) * 1e3,
        ttft_p50_ms=percentile(stats.ttft, 50) * 1e3,
        prefill=[dict(model=m, B=B, bucket=b, ms=dt * 1e3)
                 for m, B, b, dt in stats.prefill_times],
        max_memory_gib=peak, graphs=graphs, **schedule)
    figures["profile"] = profile_decode_step(torch, engine, names,
                                             engine.runners[names[0]]
                                             .decode_steps)
    return launches, figures


def graph_report(engine, stats, label) -> dict:
    """Per model: graph captures, replays, decode blocks and host
    dispatches per block; a model with a decode graph must have replayed
    it exactly once per block."""
    from repro_torch.core.control import dispatch_count
    out = {}
    for name, runner in engine.runners.items():
        blocks = len(stats.step_times[name])
        graph = runner.graph
        if graph is not None:
            if graph.replays != blocks:
                raise AssertionError(f"{name}: {graph.replays} graph replays "
                                     f"for {blocks} decode blocks")
            row = dict(captures=1, replays=graph.replays, blocks=blocks,
                       host_dispatches_per_block=dispatch_count(
                           runner.cfg.n_layers, True),
                       launches_per_replay=graph.launches_per_replay)
        else:
            row = dict(captures=0, replays=0, blocks=blocks,
                       host_dispatches_per_block=dispatch_count(
                           runner.cfg.n_layers, False))
        out[name] = row
        log(f"{label}: {name}: {row['captures']} graph capture, "
            f"{row['replays']} replays for {blocks} decode blocks, "
            f"{row['host_dispatches_per_block']} host dispatches per block"
            + (f", kernel launches per replay {row['launches_per_replay']}"
               if graph is not None else ""))
    return out


def check_coloc(launches, stats, engine) -> None:
    """Exact launch counts of the split path: per layer of a model, one
    paged attention call (GQA or MLA) and one pool write per decoded token
    (K per replay, or one per host-driven step), and one pool write per
    prompt row."""
    want = {"paged_decode_attention": 0, "paged_mla_decode_attention": 0,
            "paged_kv_write": 0}
    for name, runner in engine.runners.items():
        n_layers = runner.cfg.n_layers
        kernel = ("paged_mla_decode_attention" if runner.cfg.attention == "mla"
                  else "paged_decode_attention")
        tokens = (runner.graph.replays * runner.decode_steps
                  if runner.graph is not None
                  else len(stats.step_times[name]))
        rows = sum(B for m, B, *_ in stats.prefill_times if m == name)
        want[kernel] += n_layers * tokens
        want["paged_kv_write"] += n_layers * (tokens + rows)
    for name, n in want.items():
        if launches[name] != n or n <= 0:
            raise AssertionError(f"{name} launched {launches[name]} times on "
                                 f"the split path, expected {n}")
    log(f"split path: launches exactly as expected: {want}")


def check_fallback(launches, stats, engine) -> None:
    """Each fallback kernel launched exactly as often as the path runs
    it: per zamba2 prompt one flash prefill per shared-attention group
    and one SSD scan per SSM layer (mamba2: per layer), per zamba2 decode
    step one contiguous decode per group."""
    cfgs = {r.cfg.name: r.cfg for r in engine.runners.values()}
    zamba, mamba = cfgs["zamba2-1.2b"], cfgs["mamba2-130m"]
    rows = {n: sum(B for m, B, *_ in stats.prefill_times if m == n)
            for n in cfgs}
    steps = len(stats.step_times["zamba2-1.2b"])
    want = {
        "flash_attention": zamba.hybrid_groups * rows["zamba2-1.2b"],
        "ssd_scan": (zamba.n_ssm_layers * rows["zamba2-1.2b"]
                     + mamba.n_layers * rows["mamba2-130m"]),
        "decode_attention": zamba.hybrid_groups * steps,
    }
    for name, n in want.items():
        if launches[name] != n or n <= 0:
            raise AssertionError(f"{name} launched {launches[name]} times on "
                                 f"the fallback path, expected {n}")
    log(f"serve fallback: launches as expected for {rows} prompt rows and "
        f"{steps} zamba2 decode steps: {want}")


def device_summary(prof, wall, label):
    """Device busy time, the 10 largest kernels and every kernel of the
    port (``csrc/``) of one profiled window."""
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA" and e.self_device_time_total]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"profile: {label}: wall {wall * 1e3:.1f} ms, device busy "
        f"{busy_ms:.1f} ms ({busy_ms / (wall * 1e3):.1%})")

    def row(e):
        ms = e.self_device_time_total / 1e3
        return dict(kernel=e.key[:90], calls=e.count, ms=ms)
    top = [row(e) for e in sorted(kernels,
                                  key=lambda e: -e.self_device_time_total)]
    port = [r for r in top if any(n in r["kernel"] for n in PORT_KERNELS)]
    for r in top[:10]:
        log(f"profile: {r['ms']:9.3f} ms {r['calls']:5d}x  {r['kernel']}")
    for r in port:
        log(f"profile:   port {r['ms']:9.3f} ms {r['calls']:5d}x  "
            f"{r['kernel']}")
    shares = {}
    for what, tag in (("SSD scan", "ssd_"), ("paged MLA", "mla_")):
        ms = sum(r["ms"] for r in port if tag in r["kernel"])
        shares[what] = ms
        if ms:
            log(f"profile: {label}: {what} kernels {ms:.3f} ms = "
                f"{ms / busy_ms:.1%} of device busy time")
    return dict(wall_ms=wall * 1e3, device_busy_ms=busy_ms, top=top[:10],
                port=port, ssd_ms=shares["SSD scan"],
                mla_ms=shares["paged MLA"])


def profile_decode_step(torch, engine, names, k):
    """Where the device time goes: 4 fresh requests (500 prompt tokens
    each) are submitted, then one engine step that prefills them (and
    decodes a first block) and one engine step that decodes a K-token
    block for every model run under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime.request import Request

    reqs = [Request(100 + i, names[i % len(names)], 500, 2 * k + 1,
                    0.0) for i in range(4)]
    for r in reqs:
        engine.submit(r)
    torch.cuda.synchronize()
    out = {}
    for label in ("prefill step", "decode step"):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out[label] = device_summary(
            prof, wall, f"one {label} (K={k}, {len(names)} models)")
    engine.drain()
    if engine.virt.mapped_pages != 0:
        raise AssertionError("pages still mapped after the profiled run")
    return out


def profile_train_step(torch, step, state, batch):
    """Where one train step's device time goes, under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return device_summary(prof, wall, "one train step")


# ---------------------------------------------------------------------------
# the pool write and the decode graphs
# ---------------------------------------------------------------------------

def kv_write_phase(torch, kops, ref):
    """The pool write kernel against its plain version (bit for bit: it
    moves bytes), on rows with page ids below 0 and past the pool, rows
    cast from float32 to a bf16 pool, an odd row width (2-byte stores) and
    a prefill-sized batch; sync-free under ``set_sync_debug_mode("error")``;
    timed at the serve decode block's shape (qwen3-moe: 4 rows of 2 x 4 x
    128 bf16 into 16 KiB pages) and at a 512-token prompt's."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)

    def inputs(n_pages, page_elems, n, e, dtype, row_dtype, drop=()):
        pool = torch.randn((n_pages, page_elems), generator=gen,
                           device="cuda").to(dtype)
        rows = torch.randn((n, e), generator=gen, device="cuda").to(row_dtype)
        # distinct (page, slot) targets: two rows on one slot would race
        # in the kernel and in the plain version's scatter alike
        tpp = page_elems // e
        flat = torch.randperm(n_pages * tpp, generator=gen,
                              device="cuda")[:n].to(torch.int32)
        pages, slots = flat // tpp, flat % tpp
        for i, p in drop:
            pages[i] = p
        return pool, rows, pages, slots

    def same(what, pool, rows, pages, slots, plain_pages=None):
        want = ref.paged_kv_write(pool.clone(), rows, plain_pages
                                  if plain_pages is not None else pages,
                                  slots)
        got = kops.paged_kv_write(pool.clone(), rows, pages, slots)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"pool write {what}: kernel differs from "
                                 f"the plain version")
        log(f"kernel check paged_kv_write {what}: equal to the plain version")

    same("qwen3-moe decode B=4, -1 pages", *inputs(
        64, 8192, 4, 1024, torch.bfloat16, torch.bfloat16,
        drop=((1, -1), (3, -1))))
    same("minicpm3 decode B=4, f32 rows into bf16", *inputs(
        64, 8192, 4, 288, torch.bfloat16, torch.float32, drop=((0, -1),)))
    pool, rows, pages, slots = inputs(64, 8192, 6, 21, torch.float32,
                                      torch.float32, drop=((2, -3),))
    dropped = pages.clone()
    pages[4] = 64                  # past the pool: dropped, as mode="drop"
    dropped[4] = -1
    same("odd width, an id past the pool", pool, rows, pages, slots,
         plain_pages=dropped)
    same("prefill 512 rows", *inputs(4096, 8192, 512, 1024, torch.bfloat16,
                                     torch.bfloat16))
    pool, rows, pages, slots = inputs(64, 8192, 4, 1024, torch.bfloat16,
                                      torch.bfloat16, drop=((1, -1),))
    kops.paged_kv_write(pool, rows, pages, slots)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        kops.paged_kv_write(pool, rows, pages, slots)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log("kernel check paged_kv_write: no host read under "
        "set_sync_debug_mode('error') at a batch with -1 pages")
    rows_out = []
    for label, n in (("qwen3-moe decode B=4", 4), ("prefill 512 rows", 512)):
        pool, rows, pages, slots = inputs(16384, 8192, n, 1024,
                                          torch.bfloat16, torch.bfloat16)
        ms = time_ms(torch, lambda: kops.paged_kv_write(pool, rows, pages,
                                                        slots))
        plain = time_ms(torch, lambda: ref.paged_kv_write(pool, rows, pages,
                                                          slots))
        b_ms, b_by = bound_ms(2 * n * 1024 * 2 + 8 * n, 0)
        rows_out.append(dict(kernel="paged_kv_write", shape=label, ms=ms,
                             plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                             library_ms=None))
        log(f"time paged_kv_write {label}: kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms, bound {b_ms:.6f} ms ({b_by}); no one PyTorch "
            f"call drops rows")
    return rows_out


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


# ---------------------------------------------------------------------------

def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.core.virtualizer import DEFAULT_PAGE_BYTES, make_view
    from repro_torch.kernels import build
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_chunked import ssd_scan_chunked
    from repro_torch.launch.serve import FULL_WIDTH_DEPTHS, coloc_models

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

    # 2. build: every source at once
    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"build: {', '.join(p.name for p in libs.values())} in "
        f"{time.perf_counter() - t0:.1f} s")
    for src, lib in libs.items():
        log(f"build log {src}:")
        log(lib.with_suffix(".so.log").read_text().strip())

    # 3. kernels, at the main paths' geometries (bf16 pages of 16 KiB)
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
    capture_check(torch, kops, cases)
    f_errs, f_rows = fallback_kernel_phase(torch, kops, ref,
                                           ssd_scan_chunked)
    w_rows = kv_write_phase(torch, kops, ref)

    # 4. small models, card against CPU
    small_phase(torch)
    fallback_small_phase(torch)
    smoke_serve_phase(torch)
    train_small_phase(torch)
    graph_phase(torch)

    # 5. serve the colocated split path
    log("serve: published widths, depths cut to "
        + ", ".join(f"{n} {d} layers" for n, d in FULL_WIDTH_DEPTHS.items()))
    launches, serve = serve_phase(
        torch, np, kops, coloc_models(full_width=True), k=SERVE_K,
        page_budget=16384, label="serve", check=check_coloc)
    gc.collect()                 # request handles point back at the engine
    torch.cuda.empty_cache()

    # 5h. the same requests under the host-driven lowering, with and
    # without the layer pipeline scheduler
    host = {}
    for pipeline in (True, False):
        label = f"serve host pipeline={pipeline}"
        log(f"{label}: lowering=False, K=1")
        _, host[label] = serve_phase(
            torch, np, kops, coloc_models(full_width=True), k=1,
            page_budget=16384, label=label, check=check_coloc,
            lowering=False, pipeline=pipeline)
        gc.collect()
        torch.cuda.empty_cache()

    # 6. serve the dense-cache fallback path: full published configs
    log(f"serve fallback: {', '.join(FALLBACK_MODELS)} at their full "
        f"published configs, K=1")
    f_launches, f_serve = serve_phase(
        torch, np, kops, {n: get_config(n) for n in FALLBACK_MODELS}, k=1,
        page_budget=32768, label="serve fallback", check=check_fallback)
    gc.collect()
    torch.cuda.empty_cache()

    # 7. train moonshot at published widths through the grouped MoE path
    t_launches, train, loads = train_phase(torch, np, kops)
    gc.collect()
    torch.cuda.empty_cache()

    # 8. the grouped GEMM at phase 7's shapes and router load
    m_errs, m_rows = moe_kernel_phase(torch, np, kops, ref, loads)

    csrc = "src/repro_torch/kernels/csrc/"
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
            "name": name, "route": "cuda",
            "source": csrc + "paged_attention.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[kind], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "library": row["library"],
            "shape": f"{geom} B={B} context {ctx} bf16"})
    for name, source, replaces, shape in (
            ("flash_attention", "flash_attention.cu",
             "src/repro/kernels/flash_attention.py:29",
             "zamba2 B=1 S=1024 bf16"),
            ("decode_attention", "paged_attention.cu",
             "src/repro/kernels/paged_attention.py:35",
             "zamba2 B=4 T=1024 bf16"),
            ("ssd_scan", "ssd_scan.cu", "src/repro/kernels/ssd_scan.py:27",
             "zamba2 H=64 P=64 N=64 S=1024 chunk 256 bf16")):
        row = next(r for r in f_rows if r["kernel"] == name
                   and r["shape"] == shape)
        kernels.append({
            "name": name, "route": "cuda", "source": csrc + source,
            "replaces": replaces, "launches": f_launches[name],
            "max_abs_err": f_errs[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "library": row.get("library"), "shape": shape})
    w_row = next(r for r in w_rows if r["shape"] == "qwen3-moe decode B=4")
    kernels.append({
        "name": "paged_kv_write", "route": "cuda",
        "source": csrc + "kv_write.cu",
        "replaces": "src/repro/kernels/ops.py:79 (an XLA scatter, no "
                    "Pallas kernel)",
        "launches": launches["paged_kv_write"], "max_abs_err": 0.0,
        "ms": w_row["ms"], "plain_ms": w_row["plain_ms"],
        "bound_ms": w_row["bound_ms"], "bound_by": w_row["bound_by"],
        "library_ms": None, "library": None,
        "shape": "qwen3-moe decode B=4 rows of 2 x 4 x 128 bf16"})
    train_shape = next(r["shape"] for r in m_rows
                       if r["dtype"] == "float32")
    for name in ("moe_gemm", "moe_gemm_wgrad"):       # wgrad: its gradient
        row = next(r for r in m_rows if r["kernel"] == name
                   and r["shape"] == train_shape
                   and r["load"] == "gate/up layer 0")
        kernels.append({
            "name": name, "route": "cuda", "source": csrc + "moe_gemm.cu",
            "replaces": "src/repro/kernels/moe_gemm.py:23",
            "launches": t_launches[name],
            "max_abs_err": m_errs[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "library": "torch._grouped_mm" if row["library_ms"] else None,
            "shape": train_shape})
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "kernel_times": rows + f_rows + m_rows + w_rows,
         "kernels": kernels, "serve": serve, "serve_host": host,
         "serve_fallback": f_serve, "train": train}, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
