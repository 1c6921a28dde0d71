"""Phase 8 of ``chip_smoke.py``: holds the grouped GEMM (forward, input and
weight gradients) against its plain versions, float32 within 1e-4 and
bf16 within 2e-2, at both shapes phase 7 gives it (gate/up: K = d_model,
M = d_ff; down: K = d_ff, M = d_model) with each layer's recorded load,
with that load's 4 least loaded experts emptied, with every expert
boundary one row past a 128-row tile edge, with one expert holding 90%
of the rows, and on a small shape with empty experts and rows off 16
bytes (the float32 weight gradient equal bit for bit across two calls at
each); then times it at the gate/up shape and layer 0's load, and the
weight gradient at the skewed load too.
"""
from __future__ import annotations

import re

from chip_smoke_phases.common import (TRAIN_BATCH, TRAIN_MODEL, TRAIN_SEQ,
                                      bound_ms, close_or_raise, log, time_ms)


#: phase 8 times these kernels at these of its shapes and loads
TIMED_LOADS = {"gate/up layer 0": ("moe_gemm", "moe_gemm_dgrad",
                                   "moe_gemm_wgrad"),
               "gate/up skewed load": ("moe_gemm_wgrad",)}


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


def bf16_gemm_report(mgk, D, F, E):
    """Lines on the bf16 grouped GEMM bodies as built: each instance's
    registers and spills from the build's ``-Xptxas -v`` report, and the
    plan (tile, stages, dynamic shared memory) each of phase 8's calls is
    launched with, from the library."""
    from repro_torch.kernels import build
    text = build.library_path(build.CSRC / "moe_gemm.cu").with_suffix(
        ".so.log").read_text()
    out, name, spill = [], None, ""
    for line in text.splitlines():
        found = re.search(r"grouped_gemm_bf16_kernelILi(\d)ELi(\d+)ELi(\d+)"
                          r"ELb(\d)", line)
        if found:
            op, bm, bn, tma = found.groups()
            name = (f"{mgk.OPS[int(op)]} {bm}x{bn} "
                    f"{mgk.ROUTES[int(tma)]}")
        elif name and "spill" in line:
            spill = line.strip()
        elif name and "Used" in line:
            out.append(f"bf16 body {name}: {line.split(':', 1)[1].strip()}; "
                       f"{spill}")
            name = None
    for op, k, m in (("forward", D, F), ("dgrad", F, D), ("wgrad", D, F),
                     ("forward", F, D), ("dgrad", D, F), ("wgrad", F, D)):
        cols = k if op == "dgrad" else m
        plan = mgk.kernel_plan(op, "tma", cols, E, kdim=k)
        out.append(f"bf16 plan {op} K={k} M={m}: {plan}")
    return out


def moe_kernel_phase(torch, np, kops, ref, loads):
    """Phase 8: the grouped GEMM at the shapes phase 7 gives it (x
    [8*512*top-6, K], w [E, K, M] with (K, M) = (d_model, d_ff) for gate
    and up, (d_ff, d_model) for down) with the router's ``loads`` (one
    [E] array per layer), the first of them with 4 experts emptied, and a
    small ragged shape with empty experts: forward, input gradient and
    weight gradient against the plain versions (float32 within 1e-4, bf16
    within 2e-2; the weight gradient in both types also equal bit for bit
    across two calls; each bf16 call's route logged, and the bf16 bodies'
    registers, spills and plans, ``bf16_gemm_report``).  Then timed in both types at the gate/up shape and
    ``loads[0]`` (the weight gradient at the skewed load too,
    ``TIMED_LOADS``), beside the bound and one ``torch._grouped_mm`` call
    where the card's torch takes the type.  Inputs at the model's scales:
    x unit normal, w LeCun normal (as ``init_moe``), dy unit normal over
    sqrt(rows per expert), so that every sum is O(1) as in training (with
    unit weights a K = 2048 sum carries f32 rounding of ~1e-4 in any
    order)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import moe_gemm as mgk
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
            out = kops.moe_gemm(x, w, gs)
            e1 = close_or_raise(torch, what + " forward", out,
                                ref.moe_gemm(x, w, gs), tol)
            dx = kops.moe_gemm_dgrad(dy, w, gs)
            e2 = close_or_raise(torch, what + " dgrad", dx,
                                ref.moe_gemm(dy, w.transpose(1, 2), gs), tol)
            dw = kops.moe_gemm_wgrad(x, dy, gs)
            e3 = close_or_raise(torch, what + " wgrad", dw,
                                ref.moe_gemm_wgrad(x, dy, gs), tol)
            # float32: the chunks of an expert add into dw in a fixed
            # order; bf16: one block sums each dw tile
            if not torch.equal(dw, kops.moe_gemm_wgrad(x, dy, gs)):
                raise AssertionError(f"{what} wgrad: two calls on the "
                                     f"same inputs differ")
            log(f"kernel check {what} wgrad: two calls equal bit for bit")
            if dtype == torch.bfloat16:
                log(f"kernel route {what}: forward "
                    f"{mgk.kernel_route(x, w, out)}, dgrad "
                    f"{mgk.kernel_route(dy, w, dx)}, wgrad "
                    f"{mgk.kernel_route(x, dy, dw)}")
            del out, dx, dw
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
    for line in bf16_gemm_report(mgk, D, F, E):
        log(line)
    for r in rows:
        lib = (f"{r['library_ms']:.4f} ms" if r["library_ms"] is not None
               else f"none ({r['library_note']})")
        log(f"time {r['kernel']} {r['shape']} ({r['load']}): kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, _grouped_mm "
            f"{lib}, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return errs, rows


def run(ctx) -> None:
    """The grouped GEMM at phase 7's shapes and router load."""
    m_errs, m_rows = moe_kernel_phase(ctx.torch, ctx.np, ctx.kops, ctx.ref,
                                      ctx.out[7]["loads"])
    ctx.out[8] = dict(m_errs=m_errs, m_rows=m_rows)
