"""Phase 17 of ``chip_smoke.py``: the ssm, hybrid and audio archs
(zamba2-1.2b, mamba2-130m, whisper-small) at their full published
configs through the same steps, in bf16 and float32, phase 16's sizes
(whisper over seeded stub encoder frames): (a) the Model path, then the
serve cell over (1, 1) on the same params, bit for bit, and the Model
path once more on every weight matrix moved by one float32 ulp (its row
error); (b) four processes (spawned once) under monolithic (1, 4) and
crosspool (2, 2), every arch in float32 and zamba2 in bf16 too: each
rank's param and cache bytes the rules' exactly (the SSM's projections
over the weights pool, its state's heads over ``model``), ``ssd_scan``
once a SSM layer a prefill and flash / contiguous decode once a GQA
self-attention layer on every rank, in float32 every greedy id equal and
every row within the larger of 1e-4 and 2.5x (a)'s ulp row error (the
SSD scan's decays amplify one ulp), bf16 printed; a control, zamba2 and
mamba2 over (2, 2) with TF32 matmuls, must fail that row limit; (c)
whisper's train cell (float32, ``SHARDED_STEPS`` steps, 2 + 2 layers)
at one rank bit for bit against ``make_train_step``, then over (2, 2) on (b)'s ranks,
plain and under ``seq_parallel`` (the decoder's stream split over
``model``, the encoder's frames whole) (losses within 1e-5 relative,
gradient shards at the first state within 1e-4 of each leaf's scale
of the one rank's, shards within the sign bound, resident bytes the
dry-run's); (d) (7d) zamba2's train cell at published widths cut to
2 + 1 SSM layers and the shared block, and mamba2's cut to 2 layers,
float32, 8 x 512, each at one rank against ``make_train_step`` bit for
bit, ``ssd_scan`` twice a grouped SSM layer and once the tail's (remat
recomputes the groups) and ``ssd_scan_bwd`` once a SSM layer a step in
both; then on (b)'s ranks
zamba2's over (2, 2) and mamba2's over (1, 4), gated as (c) but for the
gradient shards, within 1e-3 of each leaf's scale (phase 7c's SSD
gate), the SSD kernels launched as at one rank, ms a step and peak GiB
a rank printed.
Rows 3, 4 and 6 are timed at a (1, 4) rank's heads. Under
``"sharded_families"``. Every phase's seconds are printed and kept under
``"phase_seconds"``.
"""
from __future__ import annotations

import gc
import json
import math
import time
from pathlib import Path

from chip_smoke_phases.common import (BF16_ROW_RMS, SERVE_SHARD_ROW_RMS,
                                      SERVE_SHARD_SIZES, SHARDED_STEPS,
                                      TRAIN_BATCH, TRAIN_SEQ, WHISPER,
                                      check_counts, close_or_raise, log,
                                      open_group, ssd_bound, time_ms)
from chip_smoke_phases.p07_train import ssm_forwards
from chip_smoke_phases.p14_sharding import _seeded_params
from chip_smoke_phases.p15_sharded_train import (_close_rel, _fresh_state,
                                                 _lr_bound, _train_batch,
                                                 _train_steps,
                                                 grad_shards_rel,
                                                 one_rank_grads)
from chip_smoke_phases.p16_sharded_serve import (_free, _one_rank_cell, _path,
                                                 _serve_agreement, _serve_job,
                                                 _serve_reference,
                                                 _serve_spawn, _ulp_noise_rows,
                                                 local_heads_kernel_rows)


SSM_CELL_DEPTH = 2
#: phase 17: the ssm, hybrid and audio archs at their full published
#: configs, phase 16's sizes: (a) the serve cell at one rank beside the
#: Model path, in each dtype; (b) four ranks on each (strategy, (data,
#: model)), every run in one spawn: float32 for every arch (the gate),
#: bf16 (measured, not gated) for FAMILY_BF16_ARCH alone, which keeps
#: the phase inside its 150 s
FAMILY_SHARD_ARCHS = ("zamba2-1.2b", "mamba2-130m", "whisper-small")
FAMILY_SHARD_MESHES = (("monolithic", (1, 4)), ("crosspool", (2, 2)))
FAMILY_SHARD_DTYPES = ("bfloat16", "float32")
FAMILY_BF16_ARCH = "zamba2-1.2b"
#: 17c: whisper's train cell, float32, at one rank and over (2, 2):
#: batch, tokens, the encoder and decoder depth (None: the published 12
#: each; 2: phase 17's 150 s, as phase 15's moonshot); SHARDED_STEPS
#: steps
AUDIO_TRAIN_BATCH, AUDIO_TRAIN_SEQ, AUDIO_TRAIN_DEPTH = 4, 128, 2
AUDIO_TRAIN_MESH = (2, 2)
#: 17c's four-rank runs of whisper's cell: (label, PerfOpts levers); the
#: decoder's stream split over model under seq_parallel
AUDIO_TRAIN_VARIANTS = (("plain", {}), ("seq_parallel", {"seq_parallel": True}))
#: 17d: the ssm and hybrid train cells over four ranks, (label, the cell's
#: config by ``ssm_cell_cfg``'s arch, (data, model)), each held against its
#: one-rank run (7d's for zamba2)
SSM_SHARD_CELLS = (("zamba2 (2, 2)", "zamba2-1.2b", (2, 2)),
                   ("mamba2 (1, 4)", "mamba2-130m", (1, 4)))
#: 17c's and 17d's limits on a rank's gradient shards against the one
#: rank's, in each leaf's scale (``grad_shards_rel``): whisper's at the
#: sharded train tests' 1e-4; the SSM cells' at phase 7c's 1e-3 for f32
#: SSD gradients, whose scan amplifies a reordered sum (zamba2's A_log
#: reads 1.4e-4 of its scale over (2, 2) on the CPU's smoke config); a
#: misplaced shard reads about 1
AUDIO_GRAD_TOL, SSM_GRAD_TOL = 1e-4, 1e-3
#: 17b's float32 row limit: SERVE_SHARD_ROW_RMS, or this many times the
#: row error one float32 ulp of noise on every weight matrix gives the
#: one-rank Model path (17a measures it), whichever is larger.  The SSD
#: scan's decays are exp(La_i - La_j) of cumulative sums in the hundreds
#: over 512 tokens, so a one-ulp change of dt moves them ~1e-4 relative
#: (the JAX package's chunked form and the kernel alike): a reordered f32
#: sum anywhere upstream does the same.  Sound four-rank runs have read
#: up to 1.2x this witness (mamba2 over (2, 2); PERF.md)
FAMILY_NOISE_FACTOR = 2.5
#: 17b's control: these archs once more in float32 over crosspool (2, 2)
#: with TF32 matmuls (10 mantissa bits); each must FAIL the row limit
#: above, or the limit could not tell a lower-precision split from the
#: float32 rounding it allows
FAMILY_CONTROL_ARCHS = ("zamba2-1.2b", "mamba2-130m")


def ssd_rank_rows(torch, kops, ssd_scan_chunked, geometries):
    """Row 6 at a rank's heads ((label, B, S, H, P, G, N, chunk)): the
    kernel against its plain version (bf16 2e-2 and the row limit), then
    both timed beside the bound (no single PyTorch call computes it)."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    rows, err = [], 0.0

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    for label, B, S, H, P, G, N, L in geometries:
        x = randn(B, S, H, P)
        dt = torch.nn.functional.softplus(randn(B, S, H, dtype=torch.float32))
        A = -torch.exp(torch.linspace(0.0, 2.77, H, device="cuda"))
        Bm, Cm = randn(B, S, G, N), randn(B, S, G, N)
        shape = f"{label} B={B} H={H} P={P} N={N} S={S} chunk {L} bf16"
        y, _ = kops.ssd_scan(x, dt, A, Bm, Cm, chunk=L)
        wy, _ = ssd_scan_chunked(x, dt, A, Bm, Cm, chunk=L)
        err = max(err, close_or_raise(torch, f"ssd {shape}", y, wy, 2e-2,
                                      BF16_ROW_RMS))
        b_ms, b_by = ssd_bound(B, S, H, P, G, N, L)
        rows.append(dict(
            kernel="ssd_scan", shape=shape,
            ms=time_ms(torch, lambda: kops.ssd_scan(x, dt, A, Bm, Cm,
                                                    chunk=L)),
            plain_ms=time_ms(torch, lambda: ssd_scan_chunked(
                x, dt, A, Bm, Cm, chunk=L)),
            library_ms=None, library=None, bound_ms=b_ms, bound_by=b_by))
        r = rows[-1]
        log(f"time ssd_scan {shape}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}), library "
            f"none (no single PyTorch call computes it)")
    return err, rows


def audio_train_cfg():
    from repro_torch.configs import get_config
    cfg = get_config(WHISPER).replace(dtype="float32")
    if AUDIO_TRAIN_DEPTH:
        cfg = cfg.replace(n_layers=AUDIO_TRAIN_DEPTH,
                          n_encoder_layers=AUDIO_TRAIN_DEPTH)
    return cfg


def _train_cell_of(mesh, cfg, seq, batch, levers=None):
    """(strategy, ``build_train_cell``) of a 17c / 17d / 7d cell on
    ``mesh``: ``batch`` x ``seq`` tokens, one microbatch, ``levers``."""
    from dataclasses import replace
    from repro_torch.configs import SHAPES_BY_NAME
    from repro_torch.launch import dryrun
    from repro_torch.sharding.strategies import PerfOpts, make_strategy
    shape = replace(SHAPES_BY_NAME["train_4k"], seq_len=seq,
                    global_batch=batch)
    st = make_strategy("train", mesh, cfg, shape,
                       PerfOpts(microbatches=1, **(levers or {})))
    return st, dryrun.build_train_cell(cfg, shape, st)


def _audio_cell(mesh, cfg, levers=None):
    """(strategy, ``build_train_cell``) of 17c on ``mesh``."""
    return _train_cell_of(mesh, cfg, AUDIO_TRAIN_SEQ, AUDIO_TRAIN_BATCH,
                          levers)


def _audio_batch(torch, cfg, device):
    gen = torch.Generator(device=device).manual_seed(3)
    return {"tokens": torch.randint(0, cfg.vocab_size,
                                    (AUDIO_TRAIN_BATCH, AUDIO_TRAIN_SEQ),
                                    generator=gen, device=device,
                                    dtype=torch.int32),
            "encoder_frames": torch.randn(
                (AUDIO_TRAIN_BATCH, cfg.encoder_seq, cfg.d_model),
                generator=gen, device=device)}


def audio_train_one_rank(torch, kops, tmp, device="cuda", cfg=None) -> dict:
    """(17c, one rank) whisper's train cell over (1, 1) beside
    ``make_train_step`` from the same seeded params and batch, each
    ``SHARDED_STEPS`` steps: losses, grad norms and final params equal bit
    for bit.  The cell's final params, metrics and gradients at the
    first state (``one_rank_grads``) go to ``tmp/audio_ref.pt`` for the
    ranks.  Needs a one-rank process group."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.model import build_model
    from repro_torch.training.train_step import make_train_step
    from repro_torch.training.tree import leaves, leaves_with_path
    cfg = cfg or audio_train_cfg()
    st, cell = _audio_cell(Mesh((1, 1), ("data", "model"), live=True), cfg)
    model = build_model(cfg)
    batch = _audio_batch(torch, cfg, device)
    opt = cell.optimizer
    ref_step = make_train_step(
        model, opt, num_microbatches=1, remat=True,
        extra_inputs=lambda b: {"encoder_frames": b["encoder_frames"]})
    t0 = time.perf_counter()
    state, ref_losses, ref_gnorms, ref_ms, _ = _train_steps(
        torch, kops, ref_step,
        [_fresh_state(opt, _seeded_params(torch, model, device), False)],
        batch, device)
    ref_params = [t.detach().cpu() for t in leaves(state.params)]
    del state
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    state, losses, gnorms, ms, launches = _train_steps(
        torch, kops, cell.step,
        [cell.shard_state(_fresh_state(
            opt, _seeded_params(torch, model, device), False))],
        batch, device)
    final = {"/".join(p): t.detach().cpu()
             for p, t in leaves_with_path(state.params)}
    tag = "sharded train 17c whisper one rank"
    equal = (losses == ref_losses and gnorms == ref_gnorms
             and all(torch.equal(a, b) for a, b in zip(final.values(),
                                                       ref_params)))
    if not equal:
        diff = max(float((a - b).abs().max())
                   for a, b in zip(final.values(), ref_params))
        raise AssertionError(f"{tag}: the cell parts from make_train_step: "
                             f"losses {losses} vs {ref_losses}, params by "
                             f"{diff:.3g}")
    grads = {p: t.cpu() for p, t in one_rank_grads(
        torch, cell, model, batch, device).items()}
    torch.save(dict(losses=losses, gnorms=gnorms, params=final, grads=grads),
               f"{tmp}/audio_ref.pt")
    del state, final, ref_params, grads
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    out = dict(layers=[cfg.n_encoder_layers, cfg.n_layers],
               batch=AUDIO_TRAIN_BATCH, seq=AUDIO_TRAIN_SEQ,
               steps=SHARDED_STEPS, losses=losses, grad_norms=gnorms,
               step_ms=ms, ref_step_ms=ref_ms, launches=launches,
               seconds=time.perf_counter() - t0)
    log(f"{tag}: {cfg.n_encoder_layers} + {cfg.n_layers} layers float32, "
        f"batch {AUDIO_TRAIN_BATCH} x {AUDIO_TRAIN_SEQ} tokens over "
        f"{cfg.encoder_seq} frames: losses {losses}, grad norms {gnorms}, "
        f"params equal to make_train_step's bit for bit; step ms {ms} "
        f"(make_train_step {ref_ms})")
    return out


def ssm_cell_cfg(arch="zamba2-1.2b"):
    """7d's and 17d's configs at published widths, float32: zamba2-1.2b
    as one group of ``SSM_CELL_DEPTH`` SSM layers and the shared
    attention block, then one tail SSM layer; mamba2-130m cut to
    ``SSM_CELL_DEPTH`` layers."""
    from repro_torch.configs import get_config
    cfg = get_config(arch).replace(dtype="float32")
    if cfg.family == "ssm":
        return cfg.replace(n_layers=SSM_CELL_DEPTH)
    return cfg.replace(n_layers=SSM_CELL_DEPTH + 2, hybrid_groups=1,
                       ssm_per_group=SSM_CELL_DEPTH, tail_ssm_layers=1)


def _ssm_cell(mesh, cfg):
    """(strategy, ``build_train_cell``) of 7d / 17d on ``mesh``."""
    return _train_cell_of(mesh, cfg, TRAIN_SEQ, TRAIN_BATCH)


def _ssm_want(cfg) -> dict:
    """7d's and 17d's launches of the SSD kernels in ``SHARDED_STEPS``
    steps of the cell (remat)."""
    return {"ssd_scan": ssm_forwards(cfg, True) * SHARDED_STEPS,
            "ssd_scan_bwd": cfg.n_ssm_layers * SHARDED_STEPS}


def ssm_train_one_rank(torch, kops, device="cuda", cfg=None,
                       tmp=None) -> dict:
    """(7d; 17d's references) an ssm / hybrid train cell
    (``build_train_cell`` over (1, 1), remat as the cell runs it; default
    zamba2's ``ssm_cell_cfg``) beside ``make_train_step`` with remat from
    the same seeded params and ``TRAIN_BATCH`` x ``TRAIN_SEQ`` batch,
    ``SHARDED_STEPS`` steps each: losses, grad norms and final params
    equal bit for bit, and in both ``ssd_scan`` launched as
    ``ssm_forwards`` says with remat (the grouped layers twice: the
    forward and its recompute), ``ssd_scan_bwd`` once a SSM layer a
    step.  With ``tmp``, the cell's final params, metrics and gradients
    at the first state (``one_rank_grads``) go to
    ``tmp/ssm_ref_<arch>.pt`` for 17d's ranks.  Needs a one-rank process
    group."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.model import build_model
    from repro_torch.training.train_step import make_train_step
    from repro_torch.training.tree import leaves, leaves_with_path
    cfg = cfg or ssm_cell_cfg()
    st, cell = _ssm_cell(Mesh((1, 1), ("data", "model"), live=True), cfg)
    model = build_model(cfg)
    batch = _train_batch(torch, cfg, device)
    opt = cell.optimizer
    tag = f"train 7d {cfg.name} cell one rank"
    t0 = time.perf_counter()
    runs = {}
    for label, step, shard in (
            ("make_train_step", make_train_step(model, opt, remat=True),
             lambda s: s),
            ("cell", cell.step, cell.shard_state)):
        state, losses, gnorms, ms, launches = _train_steps(
            torch, kops, step,
            [shard(_fresh_state(opt, _seeded_params(torch, model, device),
                                False))], batch, device)
        runs[label] = dict(losses=losses, gnorms=gnorms, ms=ms,
                           launches=launches,
                           params=[t.detach().cpu()
                                   for t in leaves(state.params)])
        if label == "cell" and tmp is not None:
            torch.save(dict(losses=losses, gnorms=gnorms, params={
                "/".join(p): t.detach().cpu()
                for p, t in leaves_with_path(state.params)}, grads={
                p: t.cpu() for p, t in one_rank_grads(
                    torch, cell, model, batch, device).items()}),
                f"{tmp}/ssm_ref_{cfg.name}.pt")
        del state
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    ref, got = runs["make_train_step"], runs["cell"]
    equal = (got["losses"] == ref["losses"] and got["gnorms"] == ref["gnorms"]
             and all(torch.equal(a, b)
                     for a, b in zip(got["params"], ref["params"])))
    if not equal:
        diff = max(float((a - b).abs().max())
                   for a, b in zip(got["params"], ref["params"]))
        raise AssertionError(f"{tag}: the cell parts from make_train_step: "
                             f"losses {got['losses']} vs {ref['losses']}, "
                             f"params by {diff:.3g}")
    want = _ssm_want(cfg)
    if torch.device(device).type == "cuda":
        for label, run in runs.items():
            seen = {k: run["launches"][k] for k in want}
            if seen != want:
                raise AssertionError(f"{tag}: {label} launched {seen}, "
                                     f"expected {want}")
    out = dict(layers=cfg.n_layers, ssm_layers=cfg.n_ssm_layers,
               batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=SHARDED_STEPS,
               losses=got["losses"], grad_norms=got["gnorms"],
               step_ms=got["ms"], ref_step_ms=ref["ms"],
               launches=got["launches"], ref_launches=ref["launches"],
               seconds=time.perf_counter() - t0)
    log(f"{tag}: {cfg.n_layers} layers ({cfg.n_ssm_layers} SSM) float32, "
        f"batch {TRAIN_BATCH} x {TRAIN_SEQ}: losses {got['losses']}, grad "
        f"norms {got['gnorms']}, params equal to make_train_step's bit for "
        f"bit; launches {got['launches']} (expected {want}); step ms "
        f"{got['ms']} (make_train_step {ref['ms']})")
    return out


def _train_job(label, cfg, mesh, ref, levers=None) -> dict:
    """A train job of 17c / 17d's ranks: ``cfg``'s cell over ``mesh``
    with ``levers``, held against the one-rank run saved as
    ``tmp/<ref>.pt``; its figures under ``label``."""
    return dict(train=cfg, label=label, mesh=mesh, ref=ref,
                levers=levers or {})


def _cell_rank_run(torch, kops, tmp, device, job, st, cell, batch,
                   grad_tol, want=None) -> None:
    """A train job's cell (``st``, ``cell``) on this rank: its gradient
    shards at the seeded params (``cell.grads``) and then its steps on
    the rank's rows of ``batch``, held against the one-rank run: the
    gradient shards within ``grad_tol`` of each leaf's scale
    (``grad_shards_rel``), losses and grad norms within 1e-5 relative,
    the param shards within ``_lr_bound``, resident bytes equal to the
    dry-run's, and on the card the launches ``want``.  Its figures (ms a
    step, peak GiB, launches) go to
    ``tmp/train_rank_<label>_<rank>.json``."""
    from repro_torch.launch import dryrun
    from repro_torch.models.model import build_model
    from repro_torch.sharding.spec import local_slices
    from repro_torch.training.train_step import TrainState
    from repro_torch.training.tree import leaves_with_path
    cfg, mesh = job["train"], st.mesh
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    params = cell.shard_state(TrainState(
        _seeded_params(torch, build_model(cfg), device), None)).params
    gc.collect()
    box = [_fresh_state(cell.optimizer, params, False)]
    del params
    batch = cell.local_batch(batch)
    resident = dryrun.resident_bytes(box[0]) + dryrun.resident_bytes(batch)
    ref = torch.load(f"{tmp}/{job['ref']}.pt", mmap=True)
    tag = f"sharded train {job['label']} rank {mesh.rank}"
    specs = st.param_specs()
    _, grads = cell.grads(box[0].params, batch)
    grad_rel = grad_shards_rel(torch, mesh, specs, grads, ref["grads"],
                               grad_tol, tag)
    del grads
    state, losses, gnorms, ms, launches = _train_steps(
        torch, kops, cell.step, box, batch, device)
    loss_rel = _close_rel(f"{tag} loss", losses, ref["losses"], 1e-5)
    gnorm_rel = _close_rel(f"{tag} grad norm", gnorms, ref["gnorms"], 1e-5)
    err = 0.0
    for path, local in leaves_with_path(state.params):
        path = "/".join(path)
        whole = ref["params"][path]
        want_leaf = whole[local_slices(mesh, whole.shape, specs[path])]
        err = max(err, float((local.detach().cpu() - want_leaf).abs().max()))
    if not err <= _lr_bound(cell.optimizer):
        raise AssertionError(f"{tag}: shards part from the one rank's by "
                             f"{err:.3g}")
    if resident != dryrun.argument_bytes(st):
        raise AssertionError(f"{tag}: {resident} resident bytes, the dry-run "
                             f"says {dryrun.argument_bytes(st)}")
    if on_card and want is not None:
        check_counts(tag, launches, want)
    with open(f"{tmp}/train_rank_{job['label']}_{mesh.rank}.json", "w") as f:
        json.dump(dict(label=job["label"], rank=mesh.rank,
                       coord=list(mesh.coord), losses=losses,
                       loss_rel=loss_rel, grad_norm_rel=gnorm_rel,
                       grad_shard_rel=grad_rel, grad_tol=grad_tol,
                       max_param_diff=err,
                       step_ms=ms, resident_bytes=resident,
                       peak_gib=(torch.cuda.max_memory_allocated() / 2**30
                                 if on_card else 0.0),
                       launches=launches), f)
    del state, ref
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()


def _audio_rank_run(torch, kops, tmp, device, job) -> None:
    """17c on one of 17b's ranks (after its serve runs, in the same gloo
    group): whisper's cell over the job's mesh with its levers
    (``seq_parallel`` splits the decoder's stream), held against the
    one-rank run (``_cell_rank_run``)."""
    from repro_torch.launch.mesh import Mesh
    st, cell = _audio_cell(Mesh(job["mesh"], ("data", "model"), live=True),
                           job["train"], job["levers"])
    _cell_rank_run(torch, kops, tmp, device, job, st, cell,
                   _audio_batch(torch, job["train"], device), AUDIO_GRAD_TOL)


def _ssm_rank_run(torch, kops, tmp, device, job) -> None:
    """17d on one of the ranks: an ssm / hybrid cell (``ssm_cell_cfg``)
    over the job's mesh, held against its one-rank run
    (``_cell_rank_run``), ``ssd_scan`` / ``ssd_scan_bwd`` launched as at
    one rank (``_ssm_want``)."""
    from repro_torch.launch.mesh import Mesh
    cfg = job["train"]
    st, cell = _ssm_cell(Mesh(job["mesh"], ("data", "model"), live=True),
                         cfg)
    _cell_rank_run(torch, kops, tmp, device, job, st, cell,
                   _train_batch(torch, cfg, device), SSM_GRAD_TOL,
                   _ssm_want(cfg))


def _family_row_limit(one) -> float:
    """17b's float32 row limit for an arch whose 17a figures are ``one``:
    the larger of ``SERVE_SHARD_ROW_RMS`` and ``FAMILY_NOISE_FACTOR``
    times its one-ulp row error."""
    return max(SERVE_SHARD_ROW_RMS,
               FAMILY_NOISE_FACTOR * one.get("ulp_noise_rows", 0.0))


def family_shard_phase(torch, kops, tmp, card, device="cuda", cfgs=None,
                       sizes=SERVE_SHARD_SIZES, train_cfg=None,
                       ssm_cfgs=None) -> dict:
    """Phase 17: the ssm, hybrid and audio archs through the sharded steps
    with every leaf placed by the rules.  (a) For each arch and dtype of
    ``cfgs`` ({(arch, dtype): config}; default the published configs) the
    Model path's prefill and decode steps (``_serve_reference``), the
    serve cell at one rank beside them, bit for bit (``_one_rank_cell``),
    and in float32 the one-ulp row error (``_ulp_noise_rows``); (b) four
    ranks (one spawn, gloo on CUDA tensors) for each of
    ``FAMILY_SHARD_MESHES``: each rank's param and cache bytes the
    rules', exact launches, in float32 every greedy id equal to (a)'s and
    every logit row within ``_family_row_limit``, in bf16
    (``FAMILY_BF16_ARCH`` only) measured; on the card, the TF32 control
    runs of ``FAMILY_CONTROL_ARCHS``, each of which must fail that limit;
    (c) whisper's train cell at one rank (bit for bit), then over
    ``AUDIO_TRAIN_MESH`` on (b)'s ranks after their serve runs, once per
    ``AUDIO_TRAIN_VARIANTS`` (plain, ``seq_parallel``); (d) the ssm and
    hybrid train cells (``ssm_cell_cfg``) at one rank (7d: bit for bit
    against ``make_train_step``), then over ``SSM_SHARD_CELLS``' meshes
    on the same ranks; each four-rank cell within 1e-5 of its one-rank
    run (``_cell_rank_run``); then the ranks' kernel geometries.
    ``cfgs``, ``sizes``, ``train_cfg`` and ``ssm_cfgs`` ({arch: config})
    rehearse it on the CPU (``device="cpu"``: launch gates, the control
    and timing are card-only).  The four-rank times are a one-card gloo
    rehearsal."""
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    cfgs = cfgs or {(a, d): get_config(a).replace(dtype=d)
                    for a in FAMILY_SHARD_ARCHS for d in FAMILY_SHARD_DTYPES}
    out = {"card": card, "sizes": dict(zip(("batch", "prompt", "steps"),
                                           sizes)), "one_rank": {},
           "runs": [], "controls": []}
    for (arch, dtype), cfg in cfgs.items():
        one, model, params, inputs, logits, toks = _serve_reference(
            torch, kops, tmp, f"17-{arch}-{dtype}", cfg, sizes, device)
        one["cell"] = _one_rank_cell(torch, kops, cfg, params, inputs, sizes,
                                     logits, toks, device)
        if dtype == "float32":
            one["ulp_noise_rows"] = _ulp_noise_rows(
                torch, model, params, inputs, sizes, logits, toks, device)
        del model, params, inputs, logits, toks
        _free(torch, device)
        out["one_rank"][f"{arch} {dtype}"] = one
        log(f"sharded serve 17a {arch} {cfg.n_layers} layers {dtype} "
            f"({one['params'] / 1e9:.4f} B params, "
            f"{one['param_bytes'] / 2**30:.4f} GiB) at one rank: draw "
            f"{one['draw_s']:.1f} s, Model path prefill "
            f"{one['prefill_ms']:.1f} ms, decode {one['decode_ms']:.2f} "
            f"ms/step; launches {_path(one['launches_prefill'])} a prefill, "
            f"{_path(one['launches_decode'])} in {sizes[2]} steps ({card})")
    train_cfg = train_cfg or audio_train_cfg()
    out["audio_train"] = dict(one_rank=audio_train_one_rank(
        torch, kops, tmp, device, train_cfg))
    # 7d and 17d's other reference: the ssm / hybrid cells at one rank
    ssm_cfgs = ssm_cfgs or {arch: ssm_cell_cfg(arch)
                            for _, arch, _ in SSM_SHARD_CELLS}
    out["ssm_cells"] = {}
    for arch, cfg in ssm_cfgs.items():
        out["ssm_cells"][arch] = dict(one_rank=ssm_train_one_rank(
            torch, kops, device, cfg, tmp))
        _free(torch, device)
    train_jobs = [
        _train_job(f"17c whisper {label}", train_cfg, AUDIO_TRAIN_MESH,
                   "audio_ref", levers)
        for label, levers in AUDIO_TRAIN_VARIANTS] + [
        _train_job(f"17d {label}", ssm_cfgs[arch], mesh,
                   f"ssm_ref_{ssm_cfgs[arch].name}")
        for label, arch, mesh in SSM_SHARD_CELLS]
    jobs = []
    for (arch, dtype), cfg in cfgs.items():
        if dtype == "float32" or arch == FAMILY_BF16_ARCH:
            for strategy, mesh in FAMILY_SHARD_MESHES:
                jobs.append(_serve_job(
                    f"17-{len(jobs)}", f"17-{arch}-{dtype}",
                    (f"17b {arch} {strategy} {dtype}", arch, strategy, mesh,
                     dtype, None), cfg))
    if torch.device(device).type == "cuda":
        strategy, mesh = FAMILY_SHARD_MESHES[1]
        for arch in FAMILY_CONTROL_ARCHS:
            jobs.append(_serve_job(
                f"17-{len(jobs)}", f"17-{arch}-float32",
                (f"17b control {arch} {strategy} float32 with TF32 matmuls",
                 arch, strategy, mesh, "float32", None),
                cfgs[arch, "float32"], tf32=True))
    t1 = time.perf_counter()
    # 17b's runs, then 17c's and 17d's cells, in one spawn
    ranks = _serve_spawn(tmp, device, jobs + train_jobs, sizes,
                         "sharded 17b-d")
    t2 = time.perf_counter()
    for i, job in enumerate(jobs):
        label, arch, strategy, mesh, dtype, _ = job["run"]
        agree = _serve_agreement(torch, tmp, job["id"], job["ref"])
        limit = _family_row_limit(out["one_rank"][f"{arch} {dtype}"])
        agree["row_limit"] = limit
        if job["tf32"]:
            # the control: a lower precision the gate must refuse
            if not agree["max_row_rms"] > limit:
                raise AssertionError(
                    f"sharded serve {label}: logit rows within "
                    f"{agree['max_row_rms']:.3g}, inside the float32 limit "
                    f"{limit:.3g}: the limit cannot tell TF32 from float32")
            log(f"sharded serve {label}: greedy ids equal to one rank's at "
                f"{agree['ids_equal']} of {agree['ids_total']}, logit rows "
                f"within {agree['max_row_rms']:.3g}: fails the float32 "
                f"limit {limit:.3g}, as it must ({card})")
            out["controls"].append(dict(label=label, arch=arch,
                                        strategy=strategy, mesh=list(mesh),
                                        **agree))
            continue
        if not agree["finite"]:
            raise AssertionError(f"sharded serve {label}: non-finite logits")
        if dtype == "float32" and (
                agree["ids_equal"] != agree["ids_total"]
                or agree["max_row_rms"] > limit):
            raise AssertionError(
                f"sharded serve {label}: greedy ids equal at "
                f"{agree['ids_equal']} of {agree['ids_total']}, logit rows "
                f"within {agree['max_row_rms']:.3g} (limit {limit:.3g})")
        rs = [r[i] for r in ranks]
        whole = out["one_rank"][f"{arch} {dtype}"]["param_bytes"]
        for r in rs:
            log(f"sharded serve {label} rank {r['rank']} (coord "
                f"{r['coord']}): params {r['param_bytes'] / 2**30:.4f} GiB "
                f"({r['param_bytes'] / whole:.3f} of the whole), cache "
                f"{r['cache_bytes'] / 2**30:.4f} GiB"
                + (f" (its slice of the sequence; k / v "
                   f"{r['seq_leaf_bytes'] / 2**30:.4f} GiB = the reference "
                   f"table's; the same rank's cache allocated with the "
                   f"sequence whole "
                   f"{r['whole_seq_cache_bytes'] / 2**30:.4f} GiB)"
                   if r["seq_split"] else "")
                + f", resident = the "
                f"rules'; prefill {r['prefill_ms']:.1f} ms, decode "
                f"{r['decode_ms']:.2f} ms/step, peak {r['peak_gib']:.2f} "
                f"GiB; launches {_path(r['launches_prefill'])} a prefill, "
                f"{_path(r['launches_decode'])} in {sizes[2]} steps ({card}; "
                f"a one-card gloo rehearsal)")
        log(f"sharded serve {label}: {job['cfg'].n_layers} layers, over "
            f"{tuple(mesh)}: greedy ids equal to one rank's at "
            f"{agree['ids_equal']} of {agree['ids_total']}, logit rows "
            f"within {agree['max_row_rms']:.3g}"
            + (f" (gated at {limit:.3g})" if dtype == "float32"
               else " (reported)"))
        out["runs"].append(dict(label=label, arch=arch, strategy=strategy,
                                mesh=list(mesh), dtype=dtype,
                                layers=job["cfg"].n_layers, ranks=rs,
                                **agree))
    for job in train_jobs:
        rs = [json.loads(Path(f"{tmp}/train_rank_{job['label']}_{r}.json")
                         .read_text())
              for r in range(math.prod(job["mesh"]))]
        if job["train"].family == "audio":
            out["audio_train"].setdefault("four_ranks", {})[
                job["label"]] = rs
        else:
            arch = job["train"].name
            out["ssm_cells"][arch].update(label=job["label"],
                                          mesh=list(job["mesh"]),
                                          four_ranks=rs)
        for r in rs:
            log(f"sharded train {job['label']} rank {r['rank']} (coord "
                f"{r['coord']}): losses {r['losses']} (rel "
                f"{r['loss_rel']:.3g} of one rank's), grad norms rel "
                f"{r['grad_norm_rel']:.3g}, gradient shards rel "
                f"{r['grad_shard_rel']:.3g} of scale (gate "
                f"{r['grad_tol']:g}), shards within "
                f"{r['max_param_diff']:.3g}; resident "
                f"{r['resident_bytes'] / 2**30:.4f} GiB = the dry-run's, "
                f"peak {r['peak_gib']:.2f} GiB; step ms {r['step_ms']}; "
                f"launches ssd_scan {r['launches']['ssd_scan']}, "
                f"ssd_scan_bwd {r['launches']['ssd_scan_bwd']} ({card}; a "
                f"one-card gloo rehearsal)")
    t3 = time.perf_counter()
    if device == "cuda":
        from repro_torch.kernels import ref
        from repro_torch.kernels.ssd_chunked import ssd_scan_chunked
        from repro_torch.models.ssm import scan_chunk
        B, S, steps = sizes
        n = FAMILY_SHARD_MESHES[0][1][1]          # monolithic (1, model)
        geoms, ssd = [], []
        for (arch, dtype), cfg in cfgs.items():
            if dtype != "bfloat16":
                continue
            label = f"{arch} rank of {n}"
            if cfg.n_heads:
                H, KV = cfg.n_heads // n, cfg.n_kv_heads // n
                geoms.append((label, B, S, S + steps, [(H, KV), (H, KV)],
                              cfg.head_dim))
            if cfg.ssm is not None:
                s = cfg.ssm
                ssd.append((label, B, S, s.n_heads(cfg.d_model) // n,
                            s.head_dim, s.n_groups, s.d_state,
                            scan_chunk(S, s.chunk_size)))
        out["kernel_errs"], out["kernel_rows"] = local_heads_kernel_rows(
            torch, kops, ref, geoms)
        out["kernel_errs"]["ssd_scan"], ssd_rows = ssd_rank_rows(
            torch, kops, ssd_scan_chunked, ssd)
        out["kernel_rows"] += ssd_rows
    out["seconds"] = dict(one_rank=t1 - t0, four_ranks=t2 - t1,
                          kernels=time.perf_counter() - t3,
                          total=time.perf_counter() - t0)
    log(f"sharded families: phase 17 took {out['seconds']['total']:.1f} s "
        f"(17a, 17c and 17d's one rank {t1 - t0:.1f}, 17b-d's four ranks "
        f"{t2 - t1:.1f}, kernel rows {out['seconds']['kernels']:.1f}; "
        f"{card})")
    return out


def run(ctx) -> None:
    """The ssm, hybrid and audio archs through the sharded steps, in
    phase 14's one-rank group."""
    fams = family_shard_phase(ctx.torch, ctx.kops, open_group(ctx),
                              ctx.card)
    ctx.out[17] = dict(sharded_families=fams, ssm_cell=fams["ssm_cells"][
        "zamba2-1.2b"]["one_rank"])
