"""Phase 15 of ``chip_smoke.py``: the sharded training step
(``build_train_cell``) on phase 7's model at published widths
(``SHARDED_DEPTH`` layers, float32, 8 x 512 tokens, the grouped MoE
path, remat, 1 microbatch), ``SHARDED_STEPS`` steps, each of
``SHARDED_VARIANTS``: plain, with ``seq_parallel`` + ``compress_grads``,
and plain on 7 rows, which do not split over data = 2 (the cell pads
them to 8, as the reference's partitioner does, and masks the pad row
out of the loss and the MoE): (a) in phase 14's one-rank NCCL group,
beside ``make_train_step`` on the same params and batch (losses and grad
norms within 1e-5 relative, params within the AdamW sign bound, the
cell's gradients at the first state written to the host's disk for (b),
``moe_gemm`` / ``moe_gemm_wgrad`` launched exactly 9 / 3 times a layer a
step in both, the cell's peak within ``SHARDED_PEAK_SLACK_GIB`` of the
reference's); (b) every variant over a (2, 2) mesh of four processes
(spawned once) sharing the card over gloo, every leaf of params, m and v
split by the train rules: each rank's losses and grad norms within 1e-4
relative of (a)'s, its gradient shards at the first state
(``cell.grads``) within 1e-4 of each leaf's scale of the same slices of
(a)'s gradients (the gate on every element's gradient and on the slice
it lands in: one AdamW step moves an element by the sign of its
gradient alone), its param shards within the sign bound of the same
slices of (a)'s params, its resident bytes equal to the dry-run's (the
state's alone for the padded batch), its launches exact; ms a step,
tokens/s and peak GiB a rank, a one-card rehearsal.  Under
``"sharded_train"`` in ``build/chip_smoke.json``.
"""
from __future__ import annotations

import gc
import json
import math
import time
from pathlib import Path

from chip_smoke_phases.common import (SHARDED_STEPS, TRAIN_BATCH,
                                      TRAIN_MODEL, TRAIN_SEQ, _spawn_ranks,
                                      check_counts, log, open_group,
                                      read_launches, reset_launches, sync)
from chip_smoke_phases.p03_kernels import bound
from chip_smoke_phases.p14_sharding import _seeded_params


#: phase 15's depth: phase 7's model at published widths, 1 of its layers
#: (phase 7 trains 2: each layer's experts are ~2.2 GB of float32 that
#: every four-rank step gathers through the host)
SHARDED_DEPTH = 1
SHARDED_MESH = (2, 2)
SHARDED_MICROBATCHES = 1
#: at one rank the cell's step runs make_train_step's ops: its peak may
#: exceed the reference's by this much at most
SHARDED_PEAK_SLACK_GIB = 0.25
#: 15a's and 15b's runs: (label, PerfOpts levers, batch rows).  The
#: uneven run's 7 rows do not split over data = 2: the cell pads them to
#: 8 (data rank 1 holds 3 real rows and a pad row), as the reference's
#: partitioner does
SHARDED_VARIANTS = (("plain", {}, TRAIN_BATCH),
                    ("seq_parallel+compress_grads",
                     {"seq_parallel": True, "compress_grads": True},
                     TRAIN_BATCH),
                    ("uneven rows", {}, TRAIN_BATCH - 1))
#: seconds phase 15b's ranks may take, start to end, for every variant
SHARDED_TIMEOUT = 400


def _sharded_cfg():
    from repro_torch.configs import get_config
    return get_config(TRAIN_MODEL).replace(n_layers=SHARDED_DEPTH,
                                           dtype="float32")


def _train_cell(mesh, cfg, levers, rows=TRAIN_BATCH):
    """(strategy, ``build_train_cell``) for phase 15 on ``mesh``, a batch
    of ``rows`` x ``TRAIN_SEQ``."""
    from dataclasses import replace
    from repro_torch.configs import SHAPES_BY_NAME
    from repro_torch.launch import dryrun
    from repro_torch.sharding.strategies import PerfOpts, make_strategy
    shape = replace(SHAPES_BY_NAME["train_4k"], seq_len=TRAIN_SEQ,
                    global_batch=rows)
    st = make_strategy("train", mesh, cfg, shape, PerfOpts(
        microbatches=SHARDED_MICROBATCHES, **levers))
    return st, dryrun.build_train_cell(cfg, shape, st, moe_path="grouped")


def _train_batch(torch, cfg, device, rows=TRAIN_BATCH):
    gen = torch.Generator(device=device).manual_seed(3)
    return {"tokens": torch.randint(0, cfg.vocab_size,
                                    (rows, TRAIN_SEQ), generator=gen,
                                    device=device, dtype=torch.int32)}


def _fresh_state(opt, params, compress):
    from repro_torch.training.compression import init_error_feedback
    from repro_torch.training.train_step import TrainState
    return TrainState(params, opt.init(params),
                      init_error_feedback(params) if compress else None)


def _train_steps(torch, kops, step, box, batch, device):
    """``SHARDED_STEPS`` steps from the state in the one-element list
    ``box``, which is emptied: the step replaces the error-feedback tree
    (the params and moments are updated in place), and a caller that kept
    the first state would hold its tree through the run.  Launch counts
    from 0.  Returns (state, losses, grad norms, ms a step, launches)."""
    state = box.pop()
    if torch.device(device).type == "cuda":
        log(f"  {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
            f"before the steps")
    reset_launches(kops)
    losses, gnorms, ms = [], [], []
    for _ in range(SHARDED_STEPS):
        sync(torch, device)
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))        # waits for the step
        gnorms.append(float(metrics["grad_norm"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    sync(torch, device)
    return state, losses, gnorms, ms, read_launches(kops)


def _train_launches(cell) -> dict:
    """Each layer's three grouped GEMMs a microbatch: forward, the
    rematerialised forward, the input gradient; and their weight
    gradients."""
    n = SHARDED_DEPTH * cell.microbatches * SHARDED_STEPS
    return {"moe_gemm": 9 * n, "moe_gemm_wgrad": 3 * n}


def _lr_bound(opt) -> float:
    """Twice the learning rate summed over the steps, + 1e-5: how far an
    element whose gradient changes sign between two runs can part in
    AdamW's first steps.  At one step every run is within it whatever
    its gradients (AdamW's first update is the learning rate times the
    gradient's sign): the gradients have their own gate
    (``grad_shards_rel``)."""
    return 2 * sum(opt.lr * min(t / max(opt.warmup_steps, 1), 1.0)
                   for t in range(1, SHARDED_STEPS + 1)) + 1e-5


def _close_rel(what, got, want, rtol) -> float:
    worst = max(abs(g - w) / max(abs(w), 1e-30) for g, w in zip(got, want))
    if not worst <= rtol:
        raise AssertionError(f"{what}: {got} vs {want} (rel {worst:.3g} > "
                             f"{rtol})")
    return worst


def grad_shards_rel(torch, mesh, specs, grads, whole, rtol, what) -> float:
    """The worst leaf's ``max |shard - want| / max |leaf|`` of a rank's
    gradient shards ``grads`` (``cell.grads``: laid out as the params,
    ``specs`` by "/"-joined path) against ``want``, the same slice of the
    one-rank run's whole gradients ``whole`` (``leaf``: the scale
    ``tests/test_torch_sharding_train.py`` holds a gathered gradient to).
    A shard reduced into the wrong slice, or permuted, parts by about its
    own magnitude.  Raises over ``rtol``."""
    from repro_torch.sharding.spec import local_slices
    from repro_torch.training.tree import leaves_with_path
    worst, at = 0.0, None
    for path, local in leaves_with_path(grads):
        path = "/".join(path)
        leaf = whole[path]
        want = leaf[local_slices(mesh, leaf.shape, specs[path])].to(
            local.device, torch.float32)
        scale = float(leaf.abs().max()) or 1.0
        rel = float((local.detach().float() - want).abs().max()) / scale
        if not rel <= worst:
            worst, at = rel, path
    if not worst <= rtol:
        raise AssertionError(f"{what}: gradient shard {at} parts from the "
                             f"one rank's by {worst:.3g} of its scale > "
                             f"{rtol}")
    return worst


def one_rank_grads(torch, cell, model, batch, device) -> dict:
    """``cell.grads`` (one rank) at a fresh draw of the seeded params:
    the whole gradients by "/"-joined path, detached, where they were
    computed."""
    from repro_torch.training.train_step import TrainState
    from repro_torch.training.tree import leaves_with_path
    params = cell.shard_state(TrainState(
        _seeded_params(torch, model, device), None)).params
    _, grads = cell.grads(params, batch)
    return {"/".join(p): t.detach() for p, t in leaves_with_path(grads)}


def _median_after_first(ms):
    rest = sorted(ms[1:] or ms)
    return rest[len(rest) // 2]


def sharded_train_one_rank(torch, kops, index, tmp, device="cuda",
                           cfg=None) -> tuple:
    """(15a) ``build_train_cell``'s step for ``SHARDED_VARIANTS[index]``
    on a one-rank group beside ``make_train_step``'s, from the same
    seeded params and batch: per-step loss and grad norm within 1e-5
    relative, params within the AdamW sign bound, ``moe_gemm`` /
    ``moe_gemm_wgrad`` launched exactly as ``_train_launches`` says in
    both, and the cell's peak within ``SHARDED_PEAK_SLACK_GIB`` of the
    reference's (at one rank every collective is the identity: a higher
    peak is a tree the step keeps).  The reference run's params go to
    the host before the cell's run draws its own (one state on the card
    at a time).  Returns (its figures, the cell's losses, grad norms and
    final params, which stay where they are, and the file in ``tmp`` of
    its gradients at the first state (``one_rank_grads``, taken after the
    peak is read, on the host: a whole tree a variant on the card would
    leave 15b's ranks short), for 15b).  Needs an initialized one-rank
    process group."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.model import build_model
    from repro_torch.training.train_step import make_train_step
    from repro_torch.training.tree import leaves, leaves_with_path

    label, levers, rows = SHARDED_VARIANTS[index]
    on_card = torch.device(device).type == "cuda"
    cfg = cfg or _sharded_cfg()
    compress = bool(levers.get("compress_grads"))
    st, cell = _train_cell(Mesh((1, 1), ("data", "model"), live=True), cfg,
                           levers, rows)
    model = build_model(cfg)
    batch = _train_batch(torch, cfg, device, rows)
    opt = cell.optimizer
    ref_step = make_train_step(
        model, opt, num_microbatches=cell.microbatches, compress=compress,
        remat=True, extra_inputs=lambda b: {"moe_path": "grouped"})
    t0 = time.perf_counter()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    state, ref_losses, ref_gnorms, ref_ms, ref_launches = _train_steps(
        torch, kops, ref_step,
        [_fresh_state(opt, _seeded_params(torch, model, device), compress)],
        batch, device)
    ref_peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else 0.0
    # detached: a copy of a param that requires grad keeps an autograd
    # edge to the card's tensor, and with it the whole reference run
    ref_params = [t.detach().cpu() for t in leaves(state.params)]
    del state
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    # the same draw again, cut by the train rules
    state, losses, gnorms, ms, launches = _train_steps(
        torch, kops, cell.step,
        [cell.shard_state(_fresh_state(
            opt, _seeded_params(torch, model, device), compress))],
        batch, device)
    peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else 0.0
    t2 = time.perf_counter()
    tag = f"sharded train 15a {label}"
    loss_rel = _close_rel(f"{tag} loss", losses, ref_losses, 1e-5)
    gnorm_rel = _close_rel(f"{tag} grad norm", gnorms, ref_gnorms, 1e-5)
    final = {"/".join(p): t.detach()
             for p, t in leaves_with_path(state.params)}
    param_err = max(float((a - b.to(a.device)).abs().max())
                    for a, b in zip(final.values(), ref_params))
    if not param_err <= _lr_bound(opt):
        raise AssertionError(f"{tag}: params part from make_train_step's by "
                             f"{param_err:.3g} > {_lr_bound(opt):.3g}")
    if not peak <= ref_peak + SHARDED_PEAK_SLACK_GIB:
        raise AssertionError(f"{tag}: the cell's step peaked at {peak:.2f} "
                             f"GiB, make_train_step's at {ref_peak:.2f}")
    want = _train_launches(cell)
    if on_card:
        for run, got in (("make_train_step", ref_launches),
                         ("build_train_cell", launches)):
            check_counts(f"{tag} {run}", got, want)
    grads = f"{tmp}/sharded_train_grads{index}.pt"
    torch.save({p: t.cpu() for p, t in one_rank_grads(
        torch, cell, model, batch, device).items()}, grads)
    ref = dict(losses=losses, gnorms=gnorms, params=final, grads=grads)
    del state, final, ref_params
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    steady = _median_after_first(ms)
    out = dict(label=label, levers=levers, rows=rows,
               microbatches=cell.microbatches,
               steps=SHARDED_STEPS, losses=losses, grad_norms=gnorms,
               ref_losses=ref_losses, ref_grad_norms=ref_gnorms,
               loss_rel=loss_rel, grad_norm_rel=gnorm_rel,
               max_param_diff=param_err, param_bound=_lr_bound(opt),
               step_ms=ms, ref_step_ms=ref_ms, median_step_ms=steady,
               tokens_per_s=rows * TRAIN_SEQ / steady * 1e3,
               peak_gib=peak, ref_peak_gib=ref_peak, launches=launches,
               ref_launches=ref_launches,
               argument_bytes=dryrun.argument_bytes(st),
               seconds={"reference": t1 - t0, "cell": t2 - t1,
                        "check": time.perf_counter() - t2})
    log(f"{tag}: losses {losses} (make_train_step {ref_losses}, rel "
        f"{loss_rel:.3g}), grad norms rel {gnorm_rel:.3g}, params within "
        f"{param_err:.3g}; {steady:.1f} ms/step after the first = "
        f"{out['tokens_per_s']:.0f} tokens/s (make_train_step "
        f"{_median_after_first(ref_ms):.1f}), peak {peak:.2f} GiB "
        f"({ref_peak:.2f}); launches {launches}; seconds "
        + ", ".join(f"{k} {v:.1f}" for k, v in out["seconds"].items()))
    return out, ref


def _train_rank_run(torch, kops, mesh, cfg, index, device, ref) -> dict:
    """One variant on one of phase 15b's ranks: draws the params (one
    rank at a time: one whole tree on the card at once) and keeps its
    shards under the train rules, holds its gradient shards at that
    state (``cell.grads``) against 15a's (``grad_shards_rel``), runs the
    steps, and holds its losses, grad norms, param shards, resident bytes
    and launches against 15a's.  A batch whose rows do not split over
    ``data`` is padded by the cell
    (``row_mask``); its rows are not the dry-run's input bytes (the
    reference's input spec leaves such a batch whole), so the state
    alone is held to the rest of them."""
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    from repro_torch.models.model import build_model
    from repro_torch.sharding.spec import local_slices
    from repro_torch.training.train_step import TrainState
    from repro_torch.training.tree import leaves_with_path
    label, levers, rows = SHARDED_VARIANTS[index]
    on_card = device == "cuda"
    rank = dist.get_rank()
    t0 = time.perf_counter()
    st, cell = _train_cell(mesh, cfg, levers, rows)
    for r in range(mesh.size):
        if r == rank:
            t_draw = time.perf_counter()
            params = cell.shard_state(TrainState(
                _seeded_params(torch, build_model(cfg), device), None)
                ).params
            gc.collect()
            if on_card:
                torch.cuda.empty_cache()
            t_draw = time.perf_counter() - t_draw
        dist.barrier()
    box = [_fresh_state(cell.optimizer, params,
                        bool(levers.get("compress_grads")))]
    del params
    batch = cell.local_batch(_train_batch(torch, cfg, device, rows))
    resident = dryrun.resident_bytes(box[0]) + dryrun.resident_bytes(batch)
    want_bytes = dryrun.argument_bytes(st)
    if "row_mask" in batch:
        resident -= dryrun.resident_bytes(batch)
        want_bytes -= dryrun._input_bytes(st, dryrun.input_specs(cfg,
                                                                  st.shape))
    tag = f"sharded train 15b {label} rank {rank}"
    specs = st.param_specs()
    t_grads = time.perf_counter()
    _, grads = cell.grads(box[0].params, batch)
    whole = torch.load(ref["grads"], mmap=True)
    grad_rel = grad_shards_rel(torch, mesh, specs, grads, whole, 1e-4, tag)
    del grads, whole
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_grads = time.perf_counter() - t_grads
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    state, losses, gnorms, ms, launches = _train_steps(
        torch, kops, cell.step, box, batch, device)
    peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else 0.0
    t2 = time.perf_counter()
    loss_rel = _close_rel(f"{tag} loss", losses, ref["losses"], 1e-4)
    gnorm_rel = _close_rel(f"{tag} grad norm", gnorms, ref["gnorms"], 1e-4)
    param_err = 0.0
    for path, local in leaves_with_path(state.params):
        path = "/".join(path)
        whole = ref["params"][path]
        want = whole[local_slices(mesh, whole.shape, specs[path])]
        param_err = max(param_err, float(
            (local.detach() - want.to(local.device)).abs().max()))
    bound = _lr_bound(cell.optimizer)
    if not param_err <= bound:
        raise AssertionError(f"{tag}: shards part from 15a's by "
                             f"{param_err:.3g} > {bound:.3g}")
    if resident != want_bytes:
        raise AssertionError(f"{tag}: {resident} resident bytes, the dry-run "
                             f"says {want_bytes}")
    if on_card:
        check_counts(tag, launches, _train_launches(cell))
    del state, ref
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    steady = _median_after_first(ms)
    return dict(rank=rank, coord=list(mesh.coord), losses=losses,
                grad_norms=gnorms, loss_rel=loss_rel,
                grad_norm_rel=gnorm_rel, grad_shard_rel=grad_rel,
                max_param_diff=param_err, param_bound=bound, step_ms=ms,
                median_step_ms=steady,
                tokens_per_s=rows * TRAIN_SEQ / steady * 1e3,
                peak_gib=peak, resident_bytes=resident,
                argument_bytes=want_bytes, launches=launches,
                real_rows=int(batch["row_mask"].sum())
                if "row_mask" in batch else len(batch["tokens"]),
                seconds={"setup": t1 - t0 - t_grads, "own draw": t_draw,
                         "grads": t_grads, "steps": t2 - t1,
                         "check": time.perf_counter() - t2})


def _train_rank(rank, tmp, device, cfg, refs):
    """One of phase 15b's ranks (in its gloo group): runs every variant
    (``_train_rank_run``) in turn against its 15a run (``refs``: on the
    card, the parent's tensors through CUDA IPC)."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.mesh import Mesh
    mesh = Mesh(SHARDED_MESH, ("data", "model"), live=True)
    runs = [_train_rank_run(torch, kops, mesh, cfg, i, device, ref)
            for i, ref in enumerate(refs)]
    with open(f"{tmp}/train_rank{rank}.json", "w") as f:
        json.dump(runs, f)


def sharded_train_pool(torch, tmp, refs, device="cuda", cfg=None) -> list:
    """(15b) Every variant's steps over ``SHARDED_MESH``, four processes
    sharing the card over gloo on CUDA tensors (spawned once for all
    variants), every leaf of params, m and v split by the train rules.
    Each rank's per-step losses and grad norms within 1e-4 relative of
    15a's (``refs``: ``sharded_train_one_rank``'s second value, one a
    variant), its gradient shards at the first state within 1e-4 of each
    leaf's scale of the same slices of 15a's gradients
    (``grad_shards_rel``), its param shards within ``_lr_bound`` of the
    same slices of 15a's params, its resident bytes equal to the
    dry-run's per-device argument bytes, its launch counts exact.  The
    times are a one-card gloo rehearsal, not a multi-card figure.
    Returns one entry a variant."""
    cfg = cfg or _sharded_cfg()
    n = math.prod(SHARDED_MESH)
    _spawn_ranks(_train_rank, (tmp, device, cfg, refs), n, SHARDED_TIMEOUT,
                 "sharded train 15b", device)
    ranks = [json.loads(Path(f"{tmp}/train_rank{r}.json").read_text())
             for r in range(n)]
    out = []
    for index, (label, levers, rows) in enumerate(SHARDED_VARIANTS):
        runs = [runs_r[index] for runs_r in ranks]
        for r in runs:
            log(f"sharded train 15b {label} rank {r['rank']} (coord "
                f"{r['coord']}, {r['real_rows']} of its rows real): losses "
                f"rel {r['loss_rel']:.3g}, grad norms "
                f"rel {r['grad_norm_rel']:.3g}, gradient shards rel "
                f"{r['grad_shard_rel']:.3g} of scale (gate 1e-4), shards "
                f"within {r['max_param_diff']:.3g} (bound "
                f"{r['param_bound']:.3g});"
                f" {r['median_step_ms']:.1f} ms/step = "
                f"{r['tokens_per_s']:.0f} tokens/s (one-card gloo "
                f"rehearsal), peak {r['peak_gib']:.2f} GiB; resident "
                f"{r['resident_bytes'] / 2**30:.3f} GiB, dry-run "
                f"{r['argument_bytes'] / 2**30:.3f} GiB; launches "
                f"{r['launches']}; seconds "
                + ", ".join(f"{k} {v:.1f}" for k, v in r["seconds"].items()))
        out.append(dict(label=label, levers=levers, rows=rows,
                        mesh=list(SHARDED_MESH), ranks=runs))
    return out


def sharded_train_phase(torch, kops, tmp, card) -> dict:
    """Phase 15: every variant's 15a (one rank), then 15b (four ranks,
    every variant in one spawn)."""
    t0 = time.perf_counter()
    out = {"card": card, "model": TRAIN_MODEL, "layers": SHARDED_DEPTH,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": SHARDED_STEPS,
           "microbatches": SHARDED_MICROBATCHES}
    ones, refs = [], []
    for index in range(len(SHARDED_VARIANTS)):
        one, ref = sharded_train_one_rank(torch, kops, index, tmp)
        ones.append(one)
        refs.append(ref)
        gc.collect()
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    pools = sharded_train_pool(torch, tmp, refs)
    for ref in refs:
        Path(ref["grads"]).unlink()
    del refs                  # the ranks have let go of the shared blocks
    gc.collect()
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()
    out["runs"] = [{"one_rank": one, "four_ranks": pool}
                   for one, pool in zip(ones, pools)]
    out["seconds_one_rank"] = t1 - t0
    out["seconds_four_ranks"] = time.perf_counter() - t1
    out["seconds"] = time.perf_counter() - t0
    log(f"sharded train: phase 15 took {out['seconds']:.1f} s (15a "
        f"{out['seconds_one_rank']:.1f}, 15b {out['seconds_four_ranks']:.1f};"
        f" {card})")
    return out


def run(ctx) -> None:
    """The sharded training step, in phase 14's one-rank group."""
    ctx.out[15] = dict(sharded_train=sharded_train_phase(
        ctx.torch, ctx.kops, open_group(ctx), ctx.card))
