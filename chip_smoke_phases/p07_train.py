"""Phase 7 of ``chip_smoke.py``: ``make_train_step`` on moonshot-v1-16b-a3b
at its published widths, depth cut to ``TRAIN_DEPTH``, float32, through
the grouped-GEMM MoE path: 5 AdamW steps on one fixed batch of 8 x 512
``SyntheticLM`` tokens. Every loss and grad norm must be finite, the
last loss below the first, and the grouped GEMM must have launched
exactly 6 times per layer per step (3 forward, 3 input gradients) and
its wgrad kernel 3 times; the router's load of the last step (the group
sizes of each layer) is recorded; then (7b) mamba2-130m and (7c)
zamba2-1.2b at their full published configs (24 layers; 38 with the six
shared attention blocks), float32, the same optimizer, steps and 8 x 512
batch, no remat: the first step's gradients on the kernel route against
the plain route (``PlainSSD``: the chunked form by autograd) within 1e-3
of each leaf's scale, then finite losses and grad norms, a falling loss,
``ssd_scan`` and ``ssd_scan_bwd`` launched exactly once a SSM layer a
step (24; 32) and no other kernel; ms a step, tokens/s, peak memory and
one profiled step;
"""
from __future__ import annotations

import gc
import math
import time

from chip_smoke_phases.common import (TRAIN_BATCH, TRAIN_DEPTH, TRAIN_MODEL,
                                      TRAIN_SEQ, TRAIN_STEPS, log,
                                      read_launches, reset_launches, sync)
from chip_smoke_phases.p05_serve import device_summary


#: phases 7b / 7c: the ssm and hybrid archs at their full published
#: configs, float32, phase 7's optimizer, sequence and steps, this many
#: rows a batch; 7d: zamba2's sharded train cell at one rank, at
#: published widths cut to one group of SSM_CELL_DEPTH SSM layers, the
#: shared attention block and one tail SSM layer
SSM_TRAIN_BATCH = {"mamba2-130m": 8, "zamba2-1.2b": 8}


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


class PlainSSD:
    """Stands in for the kernel ops inside ``models.ssm``: the SSD scan's
    plain version (the chunked form, differentiated by autograd) on the
    same card, every other op passed on."""

    def __init__(self, kops):
        self.kops = kops

    def __getattr__(self, name):
        return getattr(self.kops, name)

    @staticmethod
    def ssd_scan(x, dt, A, B_, C_, *, chunk=64, h0=None):
        from repro_torch.kernels.ssd_chunked import ssd_scan_chunked
        return ssd_scan_chunked(x, dt, A, B_, C_, chunk=chunk, h0=h0)


def ssm_forwards(cfg, remat: bool) -> int:
    """``ssd_scan`` launches a train step: one a SSD block, and under
    remat one more for each block the checkpoint recomputes (every layer
    of the ssm family, the hybrid's grouped layers: its tail layers run
    outside a checkpoint, ``models/transformer.py`` ``forward``)."""
    if not remat:
        return cfg.n_ssm_layers
    recomputed = (cfg.n_layers if cfg.family == "ssm"
                  else cfg.hybrid_groups * cfg.ssm_per_group)
    return cfg.n_ssm_layers + recomputed


def ssm_train_phase(torch, kops, name, device="cuda", cfg=None):
    """Phases 7b / 7c: ``name`` at its full published config, float32,
    ``AdamW(lr=3e-3, warmup_steps=10)``, no remat, as ``launch/train.py``;
    ``TRAIN_STEPS`` steps on one fixed ``SSM_TRAIN_BATCH[name]`` x
    ``TRAIN_SEQ`` batch.  First the step's gradients on the kernel route
    against the plain route (``PlainSSD``, with remat to bound its
    memory) from the same params: each leaf within 1e-3 of its scale,
    max(1, max|plain|).  Then the steps: finite losses and grad norms,
    the last loss below the first, ``ssd_scan`` and ``ssd_scan_bwd``
    launched exactly once a SSM layer a step and no other kernel
    (attention trains through its plain version).  Returns figures.
    ``device="cpu"`` with a smoke ``cfg`` rehearses it (launch gates and
    memory are card-only)."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm
    from repro_torch.models.model import build_model
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.train_step import (init_train_state,
                                                 make_grad_fn,
                                                 make_train_step)
    from repro_torch.training.tree import leaves, leaves_with_path

    cfg = cfg or get_config(name).replace(dtype="float32")
    card = torch.device(device).type == "cuda"
    model = build_model(cfg)
    opt = AdamW(lr=3e-3, warmup_steps=10)
    rows = SSM_TRAIN_BATCH[name]
    n_ssm = cfg.n_ssm_layers
    if card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(model, opt,
                             torch.Generator(device=device).manual_seed(0))
    n_params = sum(p.numel() for p in leaves(state.params))
    data = SyntheticLM(DataConfig(cfg.vocab_size, TRAIN_SEQ, rows))
    batch = {"tokens": torch.from_numpy(next(data.batches())["tokens"])
             .to(device)}
    tag = f"train {name}"
    log(f"{tag}: full published config ({cfg.n_layers} layers, {n_ssm} SSM "
        f"blocks, d_model {cfg.d_model}), float32, {n_params / 1e9:.3f} B "
        f"params, batch {rows} x {TRAIN_SEQ}; state built in "
        f"{time.perf_counter() - t0:.1f} s")

    # the first step's gradients: kernel route, then the plain route
    t0 = time.perf_counter()
    _, g_kernel = make_grad_fn(model, remat=False)(state.params, batch)
    ssm.kops = PlainSSD(kops)
    try:
        _, g_plain = make_grad_fn(model, remat=True)(state.params, batch)
    finally:
        ssm.kops = kops
    worst, worst_leaf = 0.0, ""
    for (path, a), b in zip(leaves_with_path(g_kernel), leaves(g_plain)):
        leaf = "/".join(map(str, path))
        scale = max(1.0, float(b.abs().max()))
        err = float((a - b).abs().max())
        if not (math.isfinite(err) and err <= 1e-3 * scale):
            raise AssertionError(f"{tag}: gradient {leaf} on the kernel "
                                 f"route parts from the plain route "
                                 f"({err:.3g} > 1e-3 x scale {scale:.3g})")
        if err / scale >= worst:
            worst, worst_leaf = err / scale, leaf
    log(f"{tag}: first step's gradients, kernel route against the plain "
        f"route, every leaf within {worst:.3g} of its scale ({worst_leaf}; "
        f"tolerance 1e-3) in {time.perf_counter() - t0:.1f} s")
    del g_kernel, g_plain
    gc.collect()
    if card:
        torch.cuda.empty_cache()

    step = make_train_step(model, opt, remat=False)
    # the main path's run: launch counts start at 0 here
    reset_launches(kops)
    losses, gnorms, times = [], [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))     # waits for the step
        gnorms.append(float(metrics["grad_norm"]))
        times.append(time.perf_counter() - t0)
        log(f"{tag} step {i}: loss {losses[-1]:.5f} grad norm "
            f"{gnorms[-1]:.4f}, {times[-1] * 1e3:.1f} ms")
    sync(torch, device)
    launches = read_launches(kops)
    peak = torch.cuda.max_memory_allocated() / 2**30 if card else 0.0
    if not all(math.isfinite(v) for v in losses + gnorms):
        raise AssertionError(f"{tag}: non-finite loss or grad norm {losses} "
                             f"{gnorms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{tag}: loss did not fall on the fixed batch "
                             f"{losses}")
    want = {k: 0 for k in read_launches(kops)}
    want["ssd_scan"] = want["ssd_scan_bwd"] = n_ssm * TRAIN_STEPS
    if card and launches != want:
        raise AssertionError(f"{tag}: launches {launches}, expected {want}")
    tokens = rows * TRAIN_SEQ
    steady = sorted(times[1:])[len(times[1:]) // 2]
    log(f"{tag}: launches {launches} (expected: ssd_scan and ssd_scan_bwd "
        f"{n_ssm} a step); median step after the first {steady * 1e3:.1f} "
        f"ms = {tokens / steady:.0f} tokens/s; max memory allocated "
        f"{peak:.2f} GiB")
    figures = dict(model=name, layers=cfg.n_layers, ssm_layers=n_ssm,
                   params=n_params, batch=rows, seq=TRAIN_SEQ, losses=losses,
                   grad_norms=gnorms, step_ms=[t * 1e3 for t in times],
                   median_step_ms=steady * 1e3, tokens_per_s=tokens / steady,
                   max_memory_gib=peak, launches=launches,
                   grad_vs_plain=worst, grad_vs_plain_leaf=worst_leaf)
    if card:
        figures["profile"] = profile_train_step(torch, step, state, batch)
    return figures


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


def run(ctx) -> None:
    """Train moonshot at published widths through the grouped MoE path;
    then (7b-7c) mamba2-130m and zamba2-1.2b at their full published
    configs through the SSD scan kernel and its backward."""
    torch = ctx.torch
    t_launches, train, loads = train_phase(torch, ctx.np, ctx.kops)
    gc.collect()
    torch.cuda.empty_cache()
    ssm_train = {}
    for name in SSM_TRAIN_BATCH:
        ssm_train[name] = ssm_train_phase(torch, ctx.kops, name)
        gc.collect()
        torch.cuda.empty_cache()
    ctx.out[7] = dict(t_launches=t_launches, train=train, loads=loads,
                      ssm_train=ssm_train)
