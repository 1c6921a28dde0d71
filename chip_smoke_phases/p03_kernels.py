"""Phase 3 of ``chip_smoke.py``: holds each kernel against its plain
PyTorch version: the paged decode kernels at the head geometries of the
three colocated models (bf16 within 2e-2, float32 within 2e-5 at the
same geometries, the float32 split boundary and context 32768 included,
and on a small shape), with ragged lengths, unmapped (-1) table entries
past and inside lengths and NaN garbage beyond every length, lengths 0
and 1, on and beside a split boundary, ending mid-page and one row at
context 32768 (GQA and MLA), and the smoke configs' geometries (GQA head
dim 8, MLA r = 16, rp = 8); the prefix cache's tables (qwen3-moe GQA and
minicpm3 MLA, bf16 and float32): two rows sharing their first 24 pages
and ending in different copy-on-write fork pages, and the pool write of
rows from mid-page at a fork (bit for bit, shared and source pages
untouched); a CUDA-graph replay of the paged GQA and of the paged MLA
call with new lengths against an eager call, and the GQA and MLA
wrappers under ``set_sync_debug_mode("error")``; flash prefill (S = T up
to 4096, T > S, S and T off the tile, every head dim), contiguous decode
(ragged lengths with 0 and a split boundary, NaN past them; both in bf16
also each row within a relative RMS error of 1e-2) and the SSD scan
(float32 within 1e-3, bf16 ``y`` within 2e-2, ``h`` within 1e-3, with
and without ``h0``) at the zamba2 / mamba2 geometries, and at 64 chunks
(S = 4096, chunk 64), a chunk of 8, G = 2 and B = 2 with ``h0``; the SSD
scan's backward (``ssd_scan_bwd``) against autograd of the chunked form,
each gradient within 1e-3 (float32) or 2e-2 (bf16) of its scale and
equal bit for bit across two calls, at both geometries (S = 1024, with
and without ``h0`` and ``dh``), the train shape (8 x 512), chunks of 8
and 64 with 8 chunks, G = 2 and a zero ``dh``; the pool write
(``paged_kv_write``) bit for bit against its plain version (-1 pages, an
id past the pool, f32 rows into a bf16 pool, an odd row width, 512 rows)
and under ``set_sync_debug_mode("error")``; contiguous decode's log-sum-
exp output (the sequence-sharded decode's local body) at moonshot's and
gemma3's heads in both dtypes, lengths 0 / 1 / a split boundary +-1 / T,
one split and several (lse within the kernel tolerances and -inf at
length 0, the output equal bit for bit to the call without lse), timed
at a 16b rank's slice of the cache; then times kernel, plain version
and, for attention, one ``scaled_dot_product_attention`` call on the
same data under each SDPA backend that takes it (a yardstick only: the
port never calls it; the fastest is ``library_ms``), beside the bound
(the paged decode kernels also in float32 over 16 KiB f32 pages at B =
4; the SSD scan at S = 1024 and 512 in bf16 and in float32 at the train
shape (8 x 512), its backward at the train shape in float32 and at S =
1024 in bf16, one call of it split by launch under the profiler);
"""
from __future__ import annotations

import math

from chip_smoke_phases.common import (BF16_ROW_RMS, SERVE_SHARD_RUNS,
                                      SERVE_SHARD_SIZES, TRAIN_BATCH,
                                      TRAIN_SEQ, bound_ms, close_or_raise,
                                      decode_time_row, launch_split,
                                      library_sdpa, log, row_limit,
                                      rows_close_or_raise, ssd_bound,
                                      ssd_bwd_bound, sync, time_ms)


CONTEXTS = (1024, 8192)
BATCHES = (1, 4)
#: phase 3: the SSD backward's timed shapes (label, B, S, chunk, dtype),
#: at each of the zamba2 and mamba2 geometries; the first is the train
#: path's call (phases 7b / 7c), the kernel line's row
SSD_BWD_TIMED = (("train shape", TRAIN_BATCH, TRAIN_SEQ, 256, "float32"),
                 ("S=1024", 1, 1024, 256, "bfloat16"))
#: phase 3: row 3's log-sum-exp output checked at moonshot's heads (16b's
#: Type I cache) and gemma3's (head dim 256), (label, H, KV, D), over
#: LSE_BATCH rows and caches of each of LSE_CONTEXTS tokens (several
#: splits; one tile: one split)
LSE_GEOMETRIES = (("moonshot", 16, 16, 128), ("gemma3", 16, 8, 256))
LSE_BATCH = 6
LSE_CONTEXTS = (1024, 64)


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
    """(max abs err, worst row's relative RMS error or None in float32)
    of the kernel against its plain version; raises past ``tol + tol *
    |plain|`` anywhere or, in bf16, past ``BF16_ROW_RMS`` in any row."""
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
    rel = (rows_close_or_raise(f"{case.name} {dtype}", got, want)
           if dtype == torch.bfloat16 else None)
    return err.max().item(), rel


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
    read, out written) over HBM rate vs flops over the peak of the type
    (bf16 tensor cores, or float32 for 4-byte items)."""
    nbytes = (B * ctx * case.per_tok * itemsize
              + B * case.H * (case.q_dim + case.out_dim) * itemsize
              + B * max_pages * 4 + B * 4)
    flops = 2 * B * case.H * ctx * (case.q_dim + case.out_dim)
    return bound_ms(nbytes, flops, fp32=itemsize == 4)


def split_boundary(torch, case, B, max_pages, dtype=None) -> int:
    """First token of the second split of the GQA or MLA kernel in
    ``dtype`` (bf16 by default) for B rows over this table: a length
    equal to it ends exactly on a boundary."""
    from repro_torch.kernels import paged_attention as pa
    dtype = dtype or torch.bfloat16
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    tokens = max_pages * case.tpp
    if case.kind == "gqa":
        _, splits = pa.split_plan(B, case.H, case.KV, tokens, sm, dtype)
    elif dtype == torch.bfloat16:
        _, splits = pa.mla_split_plan(B, case.H, tokens, sm)
    else:
        _, splits = pa.split_plan(B, case.H, 1, tokens, sm, dtype)
    return pa.split_start(1, splits, tokens)


def kernel_phase(torch, kops, ref, cases):
    from repro_torch.core.virtualizer import DEFAULT_PAGE_BYTES
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    errs = {}

    def run_check(case, lengths, max_pages, dtype, tol, holes=(), note=""):
        e, rel = check(torch, kops, ref, case, lengths, max_pages, dtype,
                       tol, gen, holes)
        errs[case.kind] = max(errs.get(case.kind, 0.0), e)
        key = f"{case.kind}_{str(dtype)[6:]}"
        errs[key] = max(errs.get(key, 0.0), e)
        rule = f"tolerance {tol}"
        if rel is not None:
            key = f"{case.kind}_row_rms"
            errs[key] = max(errs.get(key, 0.0), rel)
            rule += f"; row relative RMS err {rel:.3g} <= {BF16_ROW_RMS}"
        log(f"kernel check {case.name} {str(dtype)[6:]} lengths {lengths}"
            f"{note}: max abs err {e:.3g} ({rule})")

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
    # float32 at the path's geometries: the f32 body's split edges, -1
    # pages inside a length, one row at context 32768
    for case in cases:
        tpp = case.tpp
        max_pages = math.ceil(1024 / tpp)
        edge = split_boundary(torch, case, 6, max_pages, torch.float32)
        lengths = [0, 1, edge, edge - 1, edge + 1,
                   tpp * min(50, max_pages - 3) + max(1, tpp // 2)]
        run_check(case, lengths, max_pages, torch.float32, 2e-5,
                  note=f" (f32 split boundary {edge})")
        run_check(case, [1000, 700], max_pages, torch.float32, 2e-5,
                  holes=((0, 3), (1, 10), (1, 11)),
                  note=" (-1 pages inside the lengths)")
        run_check(case, [32768 - 3], math.ceil(32768 / tpp), torch.float32,
                  2e-5)
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
    # bf16 at both batches; float32 at B = 4 over f32 pages of 16 KiB
    timed = [(case, torch.bfloat16, BATCHES) for case in cases]
    f32_elems = DEFAULT_PAGE_BYTES // 4
    timed += [(Case(c.name, c.kind, f32_elems // c.per_tok, f32_elems, H=c.H,
                    KV=c.KV, D=c.D, r=c.r, rp=c.rp), torch.float32, (4,))
              for c in cases]
    for case, dtype, batches in timed:
        itemsize = torch.tensor([], dtype=dtype).element_size()
        for ctx in CONTEXTS:
            max_pages = math.ceil(ctx / case.tpp)
            for B in batches:
                q, pool, table, lens = make_inputs(
                    torch, case, [ctx] * B, max_pages, dtype, gen,
                    garbage=False)
                ms = time_ms(torch, lambda: run_kernel(kops, case, q, pool,
                                                       table, lens))
                plain = time_ms(torch, lambda: run_plain(ref, case, q, pool,
                                                         table, lens))
                lib, lib_name, lib_all = library_sdpa(
                    torch, sdpa_call(torch, case, q, pool, table, lens))
                b_ms, b_by = bound(case, B, ctx, max_pages, itemsize)
                rows.append(dict(case=case.name, kind=case.kind, ctx=ctx,
                                 B=B, dtype=str(dtype)[6:], ms=ms,
                                 plain_ms=plain, library_ms=lib,
                                 library=lib_name, library_all=lib_all,
                                 bound_ms=b_ms, bound_by=b_by))
                log(f"time {case.name} {str(dtype)[6:]} ctx {ctx} B {B}: "
                    f"kernel {ms:.4f} ms, "
                    f"plain {plain:.4f} ms, {lib_name} {lib:.4f} ms, "
                    f"bound {b_ms:.4f} ms ({b_by}); sdpa backends "
                    f"{fmt_backends(lib_all)}")
                del q, pool, table, lens
    return errs, rows


def shared_page_phase(torch, kops, ref, cases):
    """The prefix cache's page tables (phase 3): two batch rows whose
    tables share their first pages (refcount > 1 in the engine) and then
    end in different copy-on-write fork pages — each a copy of the first
    ``fork`` token rows of one tree page, then the row's own tokens — and
    fresh pages.  Paged GQA (qwen3-moe) and paged MLA (minicpm3) against
    their plain versions, bf16 within 2e-2 and float32 within 2e-5; then
    the pool write of rows starting mid-page at a fork, bit for bit,
    with every page outside the row's own left as it was (the shared and
    the copied-from pages are never written).  Returns the max errors."""
    from repro_torch.core.virtualizer import DEFAULT_PAGE_BYTES
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    errs = {}
    geoms = [c for c in cases
             if c.name in ("qwen3-moe-235b-a22b", "minicpm3-4b")]
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 2e-5)):
        elems = DEFAULT_PAGE_BYTES // (2 if dtype == torch.bfloat16 else 4)
        for g in geoms:
            case = Case(g.name, g.kind, elems // g.per_tok, elems, H=g.H,
                        KV=g.KV, D=g.D, r=g.r, rp=g.rp)
            tpp, n_shared = case.tpp, 24
            forks = (max(1, tpp // 3), tpp - 1)
            extra = (37, 3 * tpp + 2)
            lengths = [n_shared * tpp + f + e for f, e in zip(forks, extra)]
            own = [math.ceil((f + e) / tpp) for f, e in zip(forks, extra)]
            n_pages = n_shared + 1 + sum(own) + 8
            ids = torch.randperm(n_pages, generator=gen,
                                 device="cuda").tolist()
            shared, src = ids[:n_shared], ids[n_shared]
            pool = torch.full((n_pages, elems), float("nan"), dtype=dtype,
                              device="cuda")

            def fill(page, lo, hi):
                n = (hi - lo) * case.per_tok
                pool[page, lo * case.per_tok:hi * case.per_tok] = torch.randn(
                    (n,), generator=gen, device="cuda").to(dtype)
            for p in shared + [src]:
                fill(p, 0, tpp)
            max_pages = n_shared + max(own)
            table = torch.full((2, max_pages), -1, dtype=torch.int32)
            nxt = n_shared + 1
            for b in range(2):
                mine = ids[nxt:nxt + own[b]]
                nxt += own[b]
                table[b, :n_shared] = torch.tensor(shared)
                table[b, n_shared:n_shared + own[b]] = torch.tensor(mine)
                pool[mine[0], :forks[b] * case.per_tok] = \
                    pool[src, :forks[b] * case.per_tok]        # the copy
                left = forks[b] + extra[b]
                for i, p in enumerate(mine):
                    lo = forks[b] if i == 0 else 0
                    fill(p, lo, min(tpp, left - i * tpp))
            table = table.cuda()
            lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
            q = torch.randn((2, 1, case.H, case.q_dim), generator=gen,
                            device="cuda").to(dtype)
            got = run_kernel(kops, case, q, pool, table, lens).float()
            want = run_plain(ref, case, q, pool, table, lens).float()
            torch.cuda.synchronize()
            err = (got - want).abs()
            if not torch.isfinite(got).all() or \
                    (err > tol + tol * want.abs()).any():
                raise AssertionError(
                    f"shared pages {case.name} {dtype}: kernel disagrees "
                    f"with the plain version (max abs err "
                    f"{err.max().item():.3g}, tolerance {tol})")
            rule = f"tolerance {tol}"
            if dtype == torch.bfloat16:
                rel = rows_close_or_raise(f"shared pages {case.name} {dtype}",
                                          got, want)
                rule += f"; row relative RMS err {rel:.3g} <= {BF16_ROW_RMS}"
            errs[(case.kind, str(dtype))] = err.max().item()
            log(f"kernel check {case.name} {str(dtype)[6:]} shared pages: "
                f"{n_shared} pages shared by 2 rows, copy-on-write forks at "
                f"slots {forks} of {tpp}, lengths {lengths}: max abs err "
                f"{err.max().item():.3g} ({rule})")
            # the pool write of row 0's suffix, from the fork on
            pos = torch.arange(n_shared * tpp + forks[0], lengths[0],
                               device="cuda")
            pages = table[0].long()[pos // tpp].to(torch.int32)
            slots = (pos % tpp).to(torch.int32)
            rows = torch.randn((len(pos), case.per_tok), generator=gen,
                               device="cuda").to(dtype)
            before = torch.nan_to_num(pool.float(), nan=7.0)
            want = ref.paged_kv_write(pool.clone(), rows, pages, slots)
            got = kops.paged_kv_write(pool.clone(), rows, pages, slots)
            torch.cuda.synchronize()
            if not torch.equal(torch.nan_to_num(got.float(), nan=7.0),
                               torch.nan_to_num(want.float(), nan=7.0)):
                raise AssertionError(f"pool write at a fork {case.name} "
                                     f"{dtype}: kernel differs from the "
                                     f"plain version")
            written = set(table[0, n_shared:n_shared + own[0]].tolist())
            others = [p for p in range(n_pages) if p not in written]
            if not torch.equal(torch.nan_to_num(got.float(), nan=7.0)[others],
                               before[others]):
                raise AssertionError(f"pool write at a fork {case.name}: a "
                                     f"shared or source page was written")
            log(f"kernel check paged_kv_write {case.name} {str(dtype)[6:]}: "
                f"{len(pos)} rows from slot {forks[0]} of a fork page, equal "
                f"to the plain version; shared and source pages untouched")
    return errs


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


def fallback_kernel_phase(torch, kops, ref, ssd_scan_chunked):
    """Flash prefill, contiguous decode and the SSD scan at the fallback
    path's geometries: checks, then times (bf16, the path's dtype)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import paged_attention as pa
    zamba = get_config("zamba2-1.2b")
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
                ref.flash_attention(q, k, v, D ** -0.5), tol,
                row_limit(torch, dtype))
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
    # the wgmma body's edges: T > S (an offset that is no multiple
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
            ref.flash_attention(q, k, v, Dh ** -0.5), 2e-2, BF16_ROW_RMS)
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
                ref.decode_attention(q, ck, cv, lens, D ** -0.5), tol,
                row_limit(torch, dtype))
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
            ref.decode_attention(q, ck, cv, lens, D ** -0.5), tol,
            row_limit(torch, dtype))
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

    geoms = ssd_geometries()
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
            b_ms, b_by = ssd_bound(1, S, Hs, P, G, N, L)
            rows.append(dict(
                kernel="ssd_scan", shape=f"{label} H={Hs} P={P} N={N} "
                                         f"S={S} chunk {L} bf16",
                ms=time_ms(torch, lambda: kops.ssd_scan(x, dt, A, Bm, Cm,
                                                        chunk=L)),
                plain_ms=time_ms(torch, lambda: ssd_scan_chunked(
                    x, dt, A, Bm, Cm, chunk=L)),
                library_ms=None, bound_ms=b_ms, bound_by=b_by))
    # and in float32 at the train path's shape (phases 7b-7d)
    for label, (Hs, P, G, N) in geoms.items():
        x, dt, A, Bm, Cm, _ = ssd_inputs(TRAIN_BATCH, TRAIN_SEQ, Hs, P, G, N,
                                         torch.float32, False, 0.0)
        b_ms, b_by = ssd_bound(TRAIN_BATCH, TRAIN_SEQ, Hs, P, G, N, L, 4)
        rows.append(dict(
            kernel="ssd_scan", shape=f"{label} H={Hs} P={P} N={N} "
                                     f"B={TRAIN_BATCH} S={TRAIN_SEQ} chunk "
                                     f"{L} f32 (train shape)",
            ms=time_ms(torch, lambda: kops.ssd_scan(x, dt, A, Bm, Cm,
                                                    chunk=L)),
            plain_ms=time_ms(torch, lambda: ssd_scan_chunked(
                x, dt, A, Bm, Cm, chunk=L)),
            library_ms=None, bound_ms=b_ms, bound_by=b_by))
        del x, dt, A, Bm, Cm
    for r in rows:
        lib = ("library none (no single PyTorch call computes it)"
               if r["library_ms"] is None else
               f"{r['library']} {r['library_ms']:.4f} ms (sdpa backends "
               f"{fmt_backends(r['library_all'])})")
        log(f"time {r['kernel']} {r['shape']}: kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), {lib}")
    return errs, rows


def ssd_geometries():
    """{label: (H, P, G, N)} of the zamba2 and mamba2 SSD blocks."""
    from repro_torch.configs import get_config
    out = {}
    for label, name in (("zamba2", "zamba2-1.2b"), ("mamba2", "mamba2-130m")):
        cfg = get_config(name)
        s = cfg.ssm
        out[label] = (s.n_heads(cfg.d_model), s.head_dim, s.n_groups,
                      s.d_state)
    return out


def ssd_backward_phase(torch, kops, ssd_scan_chunked_bwd):
    """Row 6b, the SSD scan's backward, against autograd of the chunked
    form on the card: each of dx, ddt, dA, dB, dC, dh0 within 1e-3 (f32)
    or 2e-2 (bf16) of its scale, max(1, max|plain|) (the decays are exp of
    log-decay sums taken in another order, as in the forward's check);
    two calls equal bit for bit.  At the zamba2 and mamba2 geometries at
    S = 1024, chunk 256 (without h0 and dh, and with both), the train
    shape, chunks of 8 and 64 with nc >= 8, and G = 2; dh zero, given and
    absent.  Then times it (``SSD_BWD_TIMED``) beside its bound and the
    plain version, and splits one call's device time by launch
    (``launch_split``).  Returns (the worst error against scale, the
    largest absolute error, timed rows)."""
    geoms = ssd_geometries()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    f32, bf16 = torch.float32, torch.bfloat16

    def inputs(B, S, H, P, G, N, dtype, with_h0, dh, shift=2.0):
        def randn(*shape, dtype=f32):
            return torch.randn(shape, generator=gen, device="cuda").to(dtype)
        x = randn(B, S, H, P, dtype=dtype)
        dt = torch.nn.functional.softplus(randn(B, S, H) - shift)
        A = -torch.exp(torch.linspace(0.0, 2.77, H, device="cuda"))
        Bm, Cm = randn(B, S, G, N, dtype=dtype), randn(B, S, G, N, dtype=dtype)
        h0 = randn(B, H, P, N) if with_h0 else None
        dy = randn(B, S, H, P, dtype=dtype)
        dhv = {None: None, "zero": torch.zeros((B, H, P, N), device="cuda"),
               "given": randn(B, H, P, N)}[dh]
        return x, dt, A, Bm, Cm, h0, dy, dhv

    Hz, Pz, _, Nz = geoms["zamba2"]
    Hm, Pm, _, Nm = geoms["mamba2"]
    cases = []
    for label, (H, P, G, N) in geoms.items():
        for dtype in (f32, bf16):
            cases.append((f"{label} S=1024", 1, 1024, H, P, G, N, 256, dtype,
                          False, None))
            cases.append((f"{label} S=1024", 1, 1024, H, P, G, N, 256, dtype,
                          True, "given"))
        cases.append((f"{label} train shape", TRAIN_BATCH, TRAIN_SEQ, H, P,
                      G, N, 256, f32, False, None))
    for dtype in (f32, bf16):
        cases += [("chunk 8", 1, 64, 4, Pz, 1, Nz, 8, dtype, True, "zero"),
                  ("chunk 64", 1, 512, 8, Pm, 1, Nm, 64, dtype, True,
                   "given"),
                  ("G=2", 2, 512, 8, Pz, 2, Nz, 128, dtype, True, "given")]
    names = ("dx", "ddt", "dA", "dB", "dC", "dh0")
    worst, abs_err = 0.0, 0.0
    for label, B, S, H, P, G, N, L, dtype, with_h0, dh in cases:
        what = (f"ssd backward {label}: B={B} S={S} H={H} P={P} G={G} N={N} "
                f"chunk {L} {dtype} h0={with_h0} dh={dh}")
        tol = 1e-3 if dtype == f32 else 2e-2
        ins = inputs(B, S, H, P, G, N, dtype, with_h0, dh)
        got = kops.ssd_scan_bwd(*ins, chunk=L)
        again = kops.ssd_scan_bwd(*ins, chunk=L)
        want = ssd_scan_chunked_bwd(*ins, chunk=L)
        sync(torch, "cuda")
        errs = []
        for name, g, a, w in zip(names, got, again, want):
            if not torch.equal(g, a):
                raise AssertionError(f"{what}: {name} differs between two "
                                     f"calls")
            g, w = g.float(), w.float()
            if not torch.isfinite(g).all():
                raise AssertionError(f"{what}: {name} is not finite")
            scale = max(1.0, float(w.abs().max()))
            err = float((g - w).abs().max())
            if not err <= tol * scale:
                raise AssertionError(f"{what}: {name} disagrees with the "
                                     f"plain version ({err:.3g} > {tol} x "
                                     f"scale {scale:.3g})")
            errs.append(f"{name} {err / scale:.2g}")
            worst = max(worst, err / scale)
            abs_err = max(abs_err, err)
        log(f"kernel check {what}: max abs err / scale {', '.join(errs)} "
            f"(passes {tol} x max(1, max|plain|)); equal bit for bit across "
            f"two calls")
        del ins, got, again, want
    rows = []
    for label, B, S, L, dtype in SSD_BWD_TIMED:
        dtype = getattr(torch, dtype)
        for geom, (H, P, G, N) in geoms.items():
            ins = inputs(B, S, H, P, G, N, dtype, False, None, 0.0)
            b_ms, b_by = ssd_bwd_bound(B, S, H, P, G, N, L,
                                       ins[0].element_size())
            rows.append(dict(
                kernel="ssd_scan_bwd", label=label,
                shape=f"{geom} H={H} P={P} N={N} B={B} S={S} chunk {L} "
                      f"{str(dtype).split('.')[-1]}",
                ms=time_ms(torch, lambda: kops.ssd_scan_bwd(*ins, chunk=L)),
                plain_ms=time_ms(torch, lambda: ssd_scan_chunked_bwd(
                    *ins, chunk=L)),
                library_ms=None, bound_ms=b_ms, bound_by=b_by,
                split=launch_split(torch, lambda: kops.ssd_scan_bwd(
                    *ins, chunk=L))))
            del ins
    for r in rows:
        log(f"time ssd_scan_bwd {r['shape']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms (autograd of the chunked form, its "
            f"forward included), bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), library none (no single PyTorch call "
            f"computes it); one call by launch: " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in r["split"].items()))
    return worst, abs_err, rows


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


def lse_phase(torch, kops, ref) -> tuple:
    """(3) Row 3's log-sum-exp output, the local body of the crosspool
    decode over a sequence-sharded cache, against the plain version's at
    ``LSE_GEOMETRIES`` in both dtypes: ``LSE_BATCH`` rows of lengths 0, 1,
    one before a split boundary, on it, one past it and T, NaN past each,
    over a cache of each of ``LSE_CONTEXTS`` (several splits: the merge
    writes lse; one tile: the split kernel does).  Gates: lse within
    2e-5 (float32) or 2e-2 (bf16) of the plain version's and -inf at
    length 0, the output within the kernel tolerances (bf16 also the row
    limit) and equal bit for bit to the call without lse.  Then timed at
    a 16b rank's shard (``SERVE_SHARD_SIZES`` over 16b's (2, 2): its rows
    over ``data``, its slice of the sequence over ``model``) beside its
    bound and SDPA.  Returns ({"out": err, "lse": err}, rows)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import paged_attention as pa
    gen = torch.Generator(device="cuda").manual_seed(32)
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    errs = {"out": 0.0, "lse": 0.0}
    B = LSE_BATCH
    for (label, H, KV, D), T, (dtype, tol) in (
            (g, t, d) for g in LSE_GEOMETRIES for t in LSE_CONTEXTS
            for d in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2))):
        _, splits = pa.split_plan(B, H, KV, T, sm, dtype)
        edge = pa.split_start(1, splits, T) if splits > 1 else T // 2
        lengths = [0, 1, edge - 1, edge, edge + 1, T]
        q = torch.randn((B, 1, H, D), generator=gen, device="cuda").to(dtype)
        ck, cv = (torch.randn((B, T, KV, D), generator=gen, device="cuda")
                  .to(dtype) for _ in range(2))
        for b, n in enumerate(lengths):
            ck[b, n:] = float("nan")
            cv[b, n:] = float("nan")
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        shape = (f"{label} B={B} T={T} H={H} KV={KV} D={D} {splits} "
                 f"split{'s' if splits > 1 else ''} lengths {lengths} "
                 f"{str(dtype)[6:]}")
        got, lse = kops.decode_attention(q, ck, cv, lens, scale=D ** -0.5,
                                         return_lse=True)
        want, want_lse = ref.decode_attention(q, ck, cv, lens, D ** -0.5,
                                              return_lse=True)
        sync(torch, "cuda")
        if not (torch.isneginf(lse[0]).all() and not got[0].any()):
            raise AssertionError(f"decode lse {shape}: a row of length 0 "
                                 f"must give lse -inf and output 0")
        errs["lse"] = max(errs["lse"], close_or_raise(
            torch, f"decode lse {shape} lse", lse[1:], want_lse[1:], tol))
        errs["out"] = max(errs["out"], close_or_raise(
            torch, f"decode lse {shape} output", got, want, tol,
            row_limit(torch, dtype)))
        if not torch.equal(got, kops.decode_attention(q, ck, cv, lens,
                                                      scale=D ** -0.5)):
            raise AssertionError(f"decode lse {shape}: the output differs "
                                 f"from the call without lse")
    # a 16b rank's shard: its rows and its slice of the cache, full
    cfg = get_config(SERVE_SHARD_RUNS[2][1])
    (data, model), (batch, prompt, steps) = SERVE_SHARD_RUNS[2][3], \
        SERVE_SHARD_SIZES
    B, T = batch // data, (prompt + steps) // model
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn((B, 1, H, D), generator=gen, device="cuda").to(dtype)
        ck, cv = (torch.randn((B, T, KV, D), generator=gen, device="cuda")
                  .to(dtype) for _ in range(2))
        lens = torch.full((B,), T, dtype=torch.int32, device="cuda")
        rows.append(decode_time_row(
            torch, kops, ref, f"16b rank's slice B={B} T={T} H={H} KV={KV} "
            f"D={D} with lse {str(dtype)[6:]}", q, ck, cv, lens, D ** -0.5,
            lse=True))
    for r in rows:
        log(f"time decode_attention+lse {r['shape']}: kernel {r['ms']:.4f} "
            f"ms, plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), {r['library']} {r['library_ms']:.4f} ms "
            f"(no lse; sdpa backends {fmt_backends(r['library_all'])})")
    return errs, rows


def run(ctx) -> None:
    """The kernels at the main paths' geometries (bf16 pages of 16
    KiB)."""
    from repro_torch.core.virtualizer import DEFAULT_PAGE_BYTES, make_view
    from repro_torch.kernels.ssd_chunked import (ssd_scan_chunked,
                                                 ssd_scan_chunked_bwd)
    from repro_torch.launch.serve import coloc_models
    torch, kops, ref = ctx.torch, ctx.kops, ctx.ref
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
    shared_page_phase(torch, kops, ref, cases)
    capture_check(torch, kops, cases)
    f_errs, f_rows = fallback_kernel_phase(torch, kops, ref,
                                           ssd_scan_chunked)
    b_worst, b_err, b_rows = ssd_backward_phase(torch, kops,
                                                ssd_scan_chunked_bwd)
    w_rows = kv_write_phase(torch, kops, ref)
    lse_errs, lse_rows = lse_phase(torch, kops, ref)
    ctx.out[3] = dict(errs=errs, rows=rows, f_errs=f_errs, f_rows=f_rows,
                      b_worst=b_worst, b_err=b_err, b_rows=b_rows,
                      w_rows=w_rows, lse_errs=lse_errs, lse_rows=lse_rows)
