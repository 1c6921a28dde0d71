#!/usr/bin/env python3
"""Kernels of trees of this repo timed on one card, alternated.

    python3 kernel_ab.py PARENT . . PARENT [--loads build/chip_smoke.json]

Each argument is a checkout of the repo (for example the parent commit
unpacked with ``git archive`` into a directory under ``/tmp``).  For each,
in the order given, a fresh process builds that tree's kernels into the
tree's own ``build/`` and times, through its public wrappers, the calls
the paths make: in float32 row 1 (paged GQA) at the long_context_pooling
example's packed latent and at qwen3-moe's geometry, row 2 (paged MLA) at
minicpm3's, row 3 (contiguous decode) at the sharded serve steps' rank
geometries; row 4 (flash prefill) in float32 at the four rank geometries
of the sharded serve steps and in bf16 at zamba2's S = T = 1024,
gemma3's global layers (D = 256) and the same four ranks; and the grouped
GEMM at phase 7's training shape (N = 24576, K = 2048, M = 1408, E = 64)
in float32 and bf16: row 5w (the weight gradient) under the skewed load
and a router load (phase 7's first layer, read from ``--loads``, a
``chip_smoke.py`` report, else a seeded draw), row 5 (forward and input
gradient) under the router load; row 6b (the SSD scan's backward) at
the zamba2 and mamba2 geometries at phase 3's timed shapes (float32 at
the train shape, 8 x 512, and bf16 at S = 1024, chunk 256) and row 6 (the
forward) in float32 at the train shape.  Inputs come from fixed seeds,
so every tree sees the same ones.  The timing is ``chip_smoke.py``'s
(median of 20, L2 flushed, a spin ahead); each result is also held
against the plain version (2e-5, 2e-2 in bf16, or 1e-4 for float32 row
5; the SSD rows by phase 3's rule, each output within 1e-3 / 2e-2 of
max(1, max|plain|), since their decays are exp of log-decay sums taken
in another order).  Beside
each row 4 call the fastest SDPA backend, beside each row 5 / 5w call
``torch._grouped_mm`` on the same operands, is timed in the same process
(``LIB`` lines; yardsticks the port never calls; the SSD rows have none,
and their ``LIB`` lines say so).

    python3 kernel_ab.py --ablate [--loads build/chip_smoke.json]
    python3 kernel_ab.py --ablate-ssd

times this tree's bf16 grouped GEMM body whole and with its products, its
epilogue or both removed (``ABLATIONS``), on the bf16 row 5 / 5w calls;
or its SSD backward whole and with each of ``SSD_ABLATIONS`` on row 6b's
calls.  It prints one ``AB`` line per call and then each call's time per
tree, and writes every figure, beside the card's name and power limit, to
``build/kernel_ab.json``.  Times move between cards and calls, so trees
are compared only within one call.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

HERE = Path(__file__).resolve().parent
#: f32 pages of 16 KiB, as the pools hold them
PAGE_ELEMS = 4096
#: phase 16's serve shape: a 512-token prompt and 8 steps
RANK_T = 520


def _cases(torch, ref, kops, loads):
    """(label, kernel call, plain call, tolerance) of every timed call."""
    gen = torch.Generator(device="cuda").manual_seed(27)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def paged(B, ctx, per_tok, tpp, page_elems):
        npages = math.ceil(ctx / tpp)
        pool = randn(B * npages + 2, page_elems)
        table = torch.randperm(B * npages + 2, generator=gen, device="cuda")[
            :B * npages].reshape(B, npages).to(torch.int32)
        lens = torch.full((B,), ctx, dtype=torch.int32, device="cuda")
        return pool, table, lens

    out = []
    for label, B, ctx, H, KV, D, tpp in (
            ("row 1 packed latent B=1 ctx 32768 H 40 KV 1 D 256", 1, 32768,
             40, 1, 256, 28),
            ("row 1 qwen3-moe B=4 ctx 1024 H 64 KV 4 D 128", 4, 1024, 64, 4,
             128, PAGE_ELEMS // (2 * 4 * 128))):
        per_tok = 2 * KV * D
        pool, table, lens = paged(B, ctx, per_tok, tpp, tpp * per_tok)
        q = randn(B, 1, H, D)
        typed = pool.reshape(-1, tpp, 2, KV, D)
        out.append((label, lambda q=q, pool=pool, table=table, lens=lens,
                    tpp=tpp, KV=KV, D=D: kops.paged_decode_attention(
                        q, pool, table, lens, tokens_per_page=tpp, n_kv=KV,
                        scale=D ** -0.5),
                    lambda q=q, typed=typed, table=table, lens=lens, D=D:
                    ref.paged_decode_attention(q, typed, table, lens,
                                               D ** -0.5), 2e-5))
    r, rp, tpp = 256, 32, PAGE_ELEMS // 288
    for ctx in (1024, 8192):
        pool, table, lens = paged(4, ctx, r + rp, tpp, PAGE_ELEMS)
        q = randn(4, 1, 40, r + rp)
        typed = pool[:, :tpp * (r + rp)].reshape(-1, tpp, r + rp)
        out.append((f"row 2 minicpm3 B=4 ctx {ctx} H 40 r 256 rp 32",
                    lambda q=q, pool=pool, table=table, lens=lens:
                    kops.paged_mla_decode_attention(
                        q, pool, table, lens, tokens_per_page=tpp,
                        latent_dim=r, scale=(r + rp) ** -0.5),
                    lambda q=q, typed=typed, table=table, lens=lens:
                    ref.paged_mla_decode_attention(q, typed, table, lens, r,
                                                   (r + rp) ** -0.5), 2e-5))
    for label, B, H, KV, D in (("qwen3-14b rank of (1,4)", 4, 10, 2, 128),
                               ("moonshot whole heads", 2, 16, 16, 128),
                               ("zamba2 rank of (1,4)", 4, 8, 8, 64),
                               ("whisper rank of (1,4)", 4, 3, 3, 64)):
        q, ck, cv = (randn(B, 1, H, D), randn(B, RANK_T, KV, D),
                     randn(B, RANK_T, KV, D))
        lens = torch.full((B,), RANK_T, dtype=torch.int32, device="cuda")
        out.append((f"row 3 {label} B={B} T={RANK_T} H {H} KV {KV} D {D}",
                    lambda q=q, ck=ck, cv=cv, lens=lens, D=D:
                    kops.decode_attention(q, ck, cv, lens, scale=D ** -0.5),
                    lambda q=q, ck=ck, cv=cv, lens=lens, D=D:
                    ref.decode_attention(q, ck, cv, lens, D ** -0.5), 2e-5))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for label, B, S, H, KV, D, dtype in (
            ("moonshot rank of (2,2)", 2, 512, 8, 8, 128, torch.float32),
            ("qwen3-14b rank of (1,4)", 4, 512, 10, 2, 128, torch.float32),
            ("zamba2 rank of (1,4)", 4, 512, 8, 8, 64, torch.float32),
            ("whisper rank of (1,4)", 4, 512, 3, 3, 64, torch.float32),
            ("zamba2", 1, 1024, 32, 32, 64, torch.bfloat16),
            ("gemma3 global", 4, 2048, 16, 8, 256, torch.bfloat16),
            ("moonshot rank of (2,2)", 2, 512, 8, 8, 128, torch.bfloat16),
            ("qwen3-14b rank of (1,4)", 4, 512, 10, 2, 128, torch.bfloat16),
            ("zamba2 rank of (1,4)", 4, 512, 8, 8, 64, torch.bfloat16),
            ("whisper rank of (1,4)", 4, 512, 3, 3, 64, torch.bfloat16)):
        q, k, v = (randn(B, S, n, D).to(dtype) for n in (H, KV, KV))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        name = "f32" if dtype == torch.float32 else "bf16"
        out.append((f"row 4 {name} {label} B={B} S=T={S} H {H} KV {KV} "
                    f"D {D}",
                    lambda q=q, k=k, v=v, D=D: kops.flash_attention(
                        q, k, v, scale=D ** -0.5),
                    lambda q=q, k=k, v=v, D=D: ref.flash_attention(
                        q, k, v, D ** -0.5),
                    2e-5 if dtype == torch.float32 else 2e-2,
                    lambda qt=qt, kt=kt, vt=vt, D=D: sdpa(
                        qt, kt, vt, is_causal=True, scale=D ** -0.5,
                        enable_gqa=True)))
    N, K, M, E = 24576, 2048, 1408, 64
    x = randn(N, K)
    dy = randn(N, M) * (E / N) ** 0.5
    w = randn(E, K, M) * K ** -0.5
    rest = int(N * 0.1) // (E - 1)
    skewed = [rest] * E
    skewed[E // 2] = N - rest * (E - 1)
    for dtype, name, tol in ((torch.float32, "f32", 1e-4),
                             (torch.bfloat16, "bf16", 2e-2)):
        xt, dyt, wt = (t.to(dtype) for t in (x, dy, w))
        for load, sizes in (("skewed load", skewed), ("router load", loads)):
            gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
            offs = torch.cumsum(gs, 0, dtype=torch.int32)
            # every tensor bound now: the loops rebind their names
            calls = [("5w wgrad",
                      lambda gs=gs, a=xt, b=dyt: kops.moe_gemm_wgrad(a, b, gs),
                      lambda gs=gs, a=xt, b=dyt: ref.moe_gemm_wgrad(a, b, gs),
                      (xt.T, dyt))]
            if load == "router load":
                calls += [("5 forward",
                           lambda gs=gs, a=xt, b=wt: kops.moe_gemm(a, b, gs),
                           lambda gs=gs, a=xt, b=wt: ref.moe_gemm(a, b, gs),
                           (xt, wt)),
                          ("5 dgrad",
                           lambda gs=gs, a=dyt, b=wt: kops.moe_gemm_dgrad(
                               a, b, gs),
                           lambda gs=gs, a=dyt, b=wt: ref.moe_gemm(
                               a, b.transpose(1, 2), gs),
                           (dyt, wt.transpose(1, 2)))]
            for row, call, plain, lib_args in calls:
                # torch._grouped_mm on the same operands (one() asks
                # p08_moe_gemm.library_grouped_mm): the library yardstick
                label = (f"row {row} {name} N={N} K={K} M={M} E={E} "
                         f"{load}")
                out.append((label, call, plain, tol,
                            ("_grouped_mm", lib_args + (offs,))))
    out += _ssd_cases(torch, kops, gen)
    return out


#: rows 6 / 6b at phase 3's timed shapes (``p03_kernels.SSD_BWD_TIMED``):
#: (label, B, S, dtype, tolerance of max(1, max|plain|)); chunk 256
SSD_SHAPES = (("train shape", 8, 512, "float32", 1e-3),
              ("S=1024", 1, 1024, "bfloat16", 2e-2))
SSD_NO_LIBRARY = ("none", "(no single PyTorch call computes the SSD scan "
                          "or its gradient)")


def _ssd_cases(torch, kops, gen):
    """Row 6b (the SSD scan's backward) at both geometries and both of
    phase 3's timed shapes, and row 6 (the forward) in float32 at the
    train shape, each checked by phase 3's scale-relative rule."""
    from chip_smoke_phases import p03_kernels
    from repro_torch.kernels.ssd_chunked import (ssd_scan_chunked,
                                                 ssd_scan_chunked_bwd)
    out, L = [], 256
    for geom, (H, P, G, N) in p03_kernels.ssd_geometries().items():
        for label, B, S, dtype, tol in SSD_SHAPES:
            dtype = getattr(torch, dtype)

            def randn(*shape, dtype=torch.float32):
                return torch.randn(shape, generator=gen,
                                   device="cuda").to(dtype)
            x, dy = randn(B, S, H, P, dtype=dtype), randn(B, S, H, P,
                                                          dtype=dtype)
            dt = torch.nn.functional.softplus(randn(B, S, H))
            A = -torch.exp(torch.linspace(0.0, 2.77, H, device="cuda"))
            Bm, Cm = (randn(B, S, G, N, dtype=dtype) for _ in range(2))
            ins = (x, dt, A, Bm, Cm, None, dy, None)
            name = str(dtype).split(".")[-1]
            out.append((f"row 6b {geom} {label} B={B} S={S} chunk {L} "
                        f"{name}",
                        lambda ins=ins: kops.ssd_scan_bwd(*ins, chunk=L),
                        lambda ins=ins: ssd_scan_chunked_bwd(*ins, chunk=L),
                        ("scale", tol), SSD_NO_LIBRARY))
            if dtype == torch.float32:
                out.append((f"row 6 {geom} {label} B={B} S={S} chunk {L} "
                            f"{name}",
                            lambda ins=ins: kops.ssd_scan(*ins[:5], chunk=L),
                            lambda ins=ins: ssd_scan_chunked(*ins[:5],
                                                             chunk=L),
                            ("scale", tol), SSD_NO_LIBRARY))
    return out


def _check(torch, root, label, got, want, tol):
    """Hold a result against the plain version: elementwise (tol + tol
    |plain|), or for ("scale", t) each output within t of max(1,
    max|plain|), phase 3's rule for the SSD scan and its gradient.
    Returns the largest absolute error."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    worst = 0.0
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        err = (g - w).abs()
        if isinstance(tol, tuple):
            bad = float(err.max()) > tol[1] * max(1.0, float(w.abs().max()))
        else:
            bad = bool((err > tol + tol * w.abs()).any())
        if not torch.isfinite(g).all() or bad:
            raise AssertionError(f"{root} {label}: kernel disagrees with "
                                 f"the plain version (max abs err "
                                 f"{err.max().item():.3g}, tolerance {tol})")
        worst = max(worst, float(err.max()))
    return worst


def one(root: str, loads_path: str) -> None:
    """Time this tree's kernels in this process; prints ``AB`` lines."""
    sys.path.insert(0, str(Path(root).resolve() / "src"))
    import numpy as np
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    sys.path.insert(0, str(HERE))
    # the timing harness of this tree
    from chip_smoke_phases import common, p08_moe_gemm

    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    if loads_path:
        loads = json.loads(Path(loads_path).read_text())["train"]["loads"][0]
    else:
        rng = np.random.default_rng(7)
        p = np.exp(rng.standard_normal(64))
        loads = rng.multinomial(24576, p / p.sum()).tolist()
    for label, call, plain, tol, *library in _cases(torch, ref, kops,
                                                    loads):
        err = _check(torch, root, label, call(), plain(), tol)
        print(f"AB {label} | {common.time_ms(torch, call):.4f} ms "
              f"err {err:.3g}", flush=True)
        if library and isinstance(library[0], tuple):
            backend, args = library[0]
            if backend == "none":
                print(f"LIB {label} | none {args}", flush=True)
                continue
            lib_call, why = p08_moe_gemm.library_grouped_mm(torch, *args)
            if lib_call is None:
                print(f"LIB {label} | none {why}", flush=True)
            else:
                ms = common.time_ms(torch, lib_call)
                print(f"LIB {label} | {ms:.4f} ms {backend}", flush=True)
        elif library:
            ms, backend, _ = common.library_sdpa(torch, library[0])
            print(f"LIB {label} | {ms:.4f} ms {backend}", flush=True)


#: ablations of the bf16 grouped GEMM body (``--ablate``): each a list
#: of (text of ``csrc/moe_gemm.cu``, its replacement)
_PRODUCTS = """          hopper::wgmma_ss<BN, TA, TB>(acc[ms], desc_a(st, kk, ms),
                                       desc_b(st, kk), s > 0 || kk > 0);"""
_EPILOGUE = ("    if (row_base >= row_lim) continue;        "
             "// no row of this warpgroup")
ABLATIONS = {"whole": [], "no products": [(_PRODUCTS, "          {}")],
             "no epilogue": [(_EPILOGUE, "    continue;")],
             "loads only": [(_PRODUCTS, "          {}"),
                            (_EPILOGUE, "    continue;")]}


def ablate(loads_path: str) -> None:
    """Where the bf16 grouped GEMM's time goes: this tree's
    ``csrc/moe_gemm.cu`` built as it is and with its products, its
    epilogue or both removed (``ABLATIONS``; the results are wrong, only
    the times count), each timed on the bf16 row 5 / 5w calls at phase
    7's shape, the variants in turns and then in reverse.  Prints one
    ``ABL`` line per call."""
    import numpy as np
    import torch
    sys.path.insert(0, str(HERE / "src"))
    sys.path.insert(0, str(HERE))
    from chip_smoke_phases import common
    from repro_torch.kernels import build
    from repro_torch.kernels import moe_gemm as mg
    from repro_torch.kernels import ops as kops

    real = mg.load_library()
    libs = _variants(mg.SOURCE, ABLATIONS, build.BUILD_DIR / "ablate",
                     {fn: getattr(real, fn) for fn in ("moe_gemm",
                                                       "moe_gemm_wgrad")})
    N, K, M, E = 24576, 2048, 1408, 64
    gen = torch.Generator(device="cuda").manual_seed(29)
    x = torch.randn((N, K), generator=gen, device="cuda").bfloat16()
    w = (torch.randn((E, K, M), generator=gen, device="cuda")
         * K ** -0.5).bfloat16()
    dy = (torch.randn((N, M), generator=gen, device="cuda")
          * (E / N) ** 0.5).bfloat16()
    if loads_path:
        router = json.loads(Path(loads_path).read_text())["train"]["loads"][0]
    else:
        rng = np.random.default_rng(7)
        p = np.exp(rng.standard_normal(E))
        router = rng.multinomial(N, p / p.sum()).tolist()
    rest = int(N * 0.1) // (E - 1)
    skewed = [rest] * E
    skewed[E // 2] = N - rest * (E - 1)
    for load, sizes in (("router load", router), ("skewed load", skewed)):
        gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
        calls = [("wgrad", lambda gs=gs: kops.moe_gemm_wgrad(x, dy, gs))]
        if load == "router load":
            calls += [("forward", lambda gs=gs: kops.moe_gemm(x, w, gs)),
                      ("dgrad", lambda gs=gs: kops.moe_gemm_dgrad(dy, w, gs))]
        for call_name, call in calls:
            times = defaultdict(list)
            for name in list(libs) + list(libs)[::-1]:
                mg.load_library = lambda lib=libs[name]: lib
                times[name].append(common.time_ms(torch, call))
            mg.load_library = lambda: real
            print(f"ABL bf16 {call_name} {load} | " + ", ".join(
                f"{name} {a:.4f} / {b:.4f}" for name, (a, b) in
                times.items()), flush=True)


#: ablations of the SSD backward's kernels (``--ablate-ssd``), each a list
#: of (text of ``csrc/ssd_scan.cu``, its replacement): the TF32 split by
#: ``cvt.rna.tf32`` in place of rounding by the bits, one product pass
#: in place of three, no products, one target buffer in place of two
_SPLIT = """    big = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
    small = __float_as_uint(a - __uint_as_float(big));"""
_CVT = """    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(big) : "f"(a));
    const float rest = a - __uint_as_float(big);
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(small) : "f"(rest));"""
_SMALL = tuple(f"        if constexpr (kS{s}) mma_tf32(d, {a}, {b}[2 * h], "
               f"{b}[2 * h + 1]);" for s, a, b in (("A", "as", "bb"),
                                                   ("B", "ab", "bs")))
_BIG = "        mma_tf32(d, ab, bb[2 * h], bb[2 * h + 1]);"
_STAGES = "  return elem == 4 && sizeof(float) * pair_floats(P, N, L, 2) <="
SSD_ABLATIONS = {
    "whole": [], "cvt split": [(_SPLIT, _CVT)],
    "one pass (wrong)": [(_SPLIT, "    big = __float_as_uint(a);\n"
                                  "    small = 0u;")]
    + [(s, "") for s in _SMALL],
    "no products (wrong)": [(s, "") for s in _SMALL] + [(_BIG, "")],
    "one target buffer": [(_STAGES, _STAGES.replace("elem == 4", "false"))]}


def _variants(source, ablations, out, entries):
    """Build each ablation of ``source`` (all nvcc at once) into ``out``
    and load it with ``entries``' argument types: {name: library}."""
    import ctypes
    import shutil
    from repro_torch.kernels import build
    out.mkdir(parents=True, exist_ok=True)
    for header in build.CSRC.glob("*.cuh"):
        shutil.copy(header, out / header.name)
    text, jobs = source.read_text(), {}
    for name, edits in ablations.items():
        variant = text
        for old, new in edits:
            if old not in variant:
                raise ValueError(f"ablation {name!r}: {source.name} no "
                                 f"longer holds {old.strip()[:40]!r}")
            variant = variant.replace(old, new)
        src = out / (source.stem + "_" + "".join(
            ch if ch.isalnum() else "_" for ch in name) + ".cu")
        src.write_text(variant)
        jobs[name] = build._start(src, out)
    libs = {}
    for name, job in jobs.items():
        lib = ctypes.CDLL(str(build._finish(*job)))
        for fn, real in entries.items():
            getattr(lib, fn).argtypes = real.argtypes
            getattr(lib, fn).restype = real.restype
        libs[name] = lib
    return libs


def ablate_ssd() -> None:
    """Where the SSD backward's time goes: this tree's ``csrc/ssd_scan.cu``
    built as it is and with each of ``SSD_ABLATIONS`` (the wrong ones for
    their times only), each timed in turns and then in reverse on row
    6b's calls (zamba2 and mamba2, f32 at 8 x 512 and bf16 at S = 1024),
    beside its tile-pair kernel's time from one profiled call.  Prints one
    ``ABL`` line per call and variant."""
    import torch
    sys.path.insert(0, str(HERE / "src"))
    sys.path.insert(0, str(HERE))
    from chip_smoke_phases import common, p03_kernels
    from repro_torch.kernels import build
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels.ssd_chunked import ssd_scan_chunked_bwd

    real = ssd.load_library()
    libs = _variants(ssd.SOURCE, SSD_ABLATIONS, build.BUILD_DIR / "ablate",
                     {fn: getattr(real, fn) for fn in (
                         "ssd_chunked_scan_bwd", "ssd_scan_supported",
                         "ssd_scan_bwd_workspace")})
    gen = torch.Generator(device="cuda").manual_seed(31)
    for geom, (H, P, G, N) in p03_kernels.ssd_geometries().items():
        for label, B, S, dtype, _ in SSD_SHAPES:
            dtype = getattr(torch, dtype)

            def randn(*shape, dtype=torch.float32):
                return torch.randn(shape, generator=gen,
                                   device="cuda").to(dtype)
            ins = (randn(B, S, H, P, dtype=dtype),
                   torch.nn.functional.softplus(randn(B, S, H)),
                   -torch.exp(torch.linspace(0.0, 2.77, H, device="cuda")),
                   randn(B, S, G, N, dtype=dtype),
                   randn(B, S, G, N, dtype=dtype), None,
                   randn(B, S, H, P, dtype=dtype), None)
            want = ssd_scan_chunked_bwd(*ins, chunk=256)
            runs = defaultdict(list)
            for name in list(libs) + list(libs)[::-1]:
                ssd.load_library = lambda lib=libs[name]: lib

                def call():
                    return kops.ssd_scan_bwd(*ins, chunk=256)
                err = max(float((g.float() - w.float()).abs().max())
                          / max(1.0, float(w.float().abs().max()))
                          for g, w in zip(call(), want))
                pair = sum(ms for k, ms in common.launch_split(torch, call)
                           .items() if "pair" in k)
                runs[name].append((common.time_ms(torch, call), pair, err))
            ssd.load_library = lambda: real
            for name, ((a, pa, e), (b, pb, _)) in runs.items():
                print(f"ABL {geom} {label} {str(dtype)[6:]} {name}: "
                      f"{a:.4f} / {b:.4f} ms, tile pairs {pa:.4f} / "
                      f"{pb:.4f} ms, err / scale {e:.2e}", flush=True)


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        one(argv[1], argv[2])
        return 0
    loads = ""
    if "--loads" in argv:
        i = argv.index("--loads")
        loads, argv = argv[i + 1], argv[:i] + argv[i + 2:]
    if argv == ["--ablate"]:
        ablate(loads)
        return 0
    if argv == ["--ablate-ssd"]:
        ablate_ssd()
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    times, library = defaultdict(list), defaultdict(list)
    for root in argv:
        run = subprocess.run([sys.executable, __file__, "--one", root, loads],
                             capture_output=True, text=True)
        sys.stdout.write(run.stdout)
        if run.returncode:
            sys.stderr.write(run.stderr[-4000:])
            return run.returncode
        for line in run.stdout.splitlines():
            for tag, into in (("AB ", times), ("LIB ", library)):
                if line.startswith(tag) and " | none " not in line:
                    label, rest = line[len(tag):].split(" | ")
                    into[label].append((root, float(rest.split()[0]),
                                        rest.split()[-1]))
    for label, runs in times.items():
        print(f"{label}: " + ", ".join(f"{r} {ms:.4f}" for r, ms, _ in runs)
              + "".join(f"; {'' if b == '_grouped_mm' else 'sdpa '}{b} "
                        f"{ms:.4f}" for _, ms, b in library.get(label, ())))
    out = HERE / "build"
    out.mkdir(exist_ok=True)
    (out / "kernel_ab.json").write_text(json.dumps(
        {"card": card, "trees": argv, "ms": times, "library_ms": library},
        indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
