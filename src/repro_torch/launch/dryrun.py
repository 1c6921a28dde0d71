"""The sharded train and serve steps, and the dry-run's per-device bytes
of every (arch x shape x mesh) cell.

Port of ``src/repro/launch/dryrun.py``.  ``build_train_cell`` and
``build_serve_cell`` are the reference's cell builders: each returns the
step each rank runs SPMD on its local shards with the strategy's hooks,
whose collectives run over ``torch.distributed``
(``sharding/strategies.py`` says how each step places every leaf by the
rules).  The train cell (``train_4k`` shapes, every family) takes ``TRAIN_MICROBATCHES`` and cuts a whole ``TrainState`` and batch
into this rank's part (``TrainCell.shard_state`` / ``local_batch``); the
serve cell is ``decode_step`` for decode shapes and ``prefill`` for
prefill shapes (``shard_params`` / ``shard_cache`` / ``local_rows``, or
``draw_params`` / ``local_cache`` for a model whose whole tree a rank
should never hold), and ``greedy`` reads its logits.

``run_cell`` is the dry-run: it builds the production mesh (shape only)
and the strategy, and reports what each device would hold: the bytes of
every argument leaf under the rules (params, cache at ``kv_dtype``, the
inputs; for train cells the AdamW moments and the error-feedback tree),
from shapes alone: the trees are built on the ``meta`` device, so a
405B-parameter model allocates nothing.  It then runs rank 0's step once
on ``meta`` over a stand-in of the mesh (``analyze_cell``:
``launch/op_analysis.py``) and records the step's ``roofline``
(``launch/roofline.py``, on the H100's peaks), the high-water mark of
the bytes the step makes (``memory.temp_bytes``) and the seconds the
counting took (``analyze_s``).  There is nothing to lower or compile: the
reference's ``lower_s`` / ``compile_s`` and its output and code bytes
have no counterpart.

  python -m repro_torch.launch.dryrun --arch qwen3-14b --shape decode_32k
  python -m repro_torch.launch.dryrun --all --multi-pod --out dryrun.jsonl
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from typing import Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.configs import (ARCH_NAMES, SHAPES_BY_NAME, get_config,
                                 shape_applicable)
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch import roofline as rf
from repro_torch.launch.mesh import make_production_mesh, mesh_chip_count
from repro_torch.launch.op_analysis import ModuleStats, analyze_step
from repro_torch.models import transformer as tfm
from repro_torch.models.hooks import Hooks
from repro_torch.models.model import build_model
from repro_torch.models.transformer import param_shapes
from repro_torch.sharding.collectives import AxisGroup
from repro_torch.sharding.spec import (PartitionSpec, axis_size,
                                       local_slices, path_str,
                                       shard_by_specs, shard_shape,
                                       shard_tree, tree_bytes)
from repro_torch.sharding.strategies import (SEQ_SPLIT_LEAVES, Strategy,
                                             make_strategy)
from repro_torch.training.compression import init_error_feedback
from repro_torch.training.optimizer import AdamW, AdamWState
from repro_torch.training.train_step import TrainState, make_grad_fn, \
    make_train_step
from repro_torch.training.tree import leaves, leaves_with_path

MESH_NAMES = {False: "pod16x16", True: "pod2x16x16"}

#: Gradient-accumulation depth per arch for train_4k (the reference's
#: ``dryrun.py:46-59``, tuned there against its memory analysis).
TRAIN_MICROBATCHES = {
    "llama3-405b": 16,
    "qwen3-moe-235b-a22b": 8,
    "llava-next-34b": 8,
    "gemma3-12b": 4,
    "qwen3-14b": 4,
    "moonshot-v1-16b-a3b": 4,
    "minicpm3-4b": 2,
    "zamba2-1.2b": 2,
    "mamba2-130m": 1,
    "whisper-small": 1,
}


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    """Meta stand-ins for every model input of this cell."""
    B, S = shape.global_batch, shape.seq_len
    dt = tfm.dtype_of(cfg)

    def meta(*dims, dtype):
        return torch.empty(dims, dtype=dtype, device="meta")

    specs: Dict = {}
    if shape.kind in ("train", "prefill"):
        txt = S
        if cfg.frontend == "vision_patches":
            txt = S - cfg.frontend_tokens
            specs["embeddings"] = meta(B, cfg.frontend_tokens, cfg.d_model,
                                       dtype=dt)
        if cfg.family == "audio":
            specs["encoder_frames"] = meta(B, cfg.encoder_seq, cfg.d_model,
                                           dtype=dt)
        specs["tokens"] = meta(B, txt, dtype=torch.int32)
    else:  # decode: one new token against a seq_len-deep cache
        specs["tokens"] = meta(B, dtype=torch.int32)
        specs["lengths"] = meta(dtype=torch.int32)
    return specs


def _input_bytes(strategy: Strategy, specs: Dict) -> int:
    total = 0
    for name, t in specs.items():
        spec = (strategy.scalar_sharding() if name == "lengths"
                else strategy.input_sharding(t.dim()))
        local = [n // axis_size(strategy.mesh, ax)
                 for n, ax in zip(t.shape, tuple(spec) + (None,) * t.dim())]
        total += math.prod(local) * t.element_size()
    return total


def moment_dtype(cfg: ModelConfig) -> str:
    """AdamW's moments: bf16 for the 100B+ configs (``dryrun.py:98``)."""
    return "bfloat16" if cfg.param_counts()["total"] > 5e10 else "float32"


def argument_bytes(strategy: Strategy) -> int:
    """Per-device bytes of the cell's arguments under the rules."""
    cfg, shape, mesh = strategy.cfg, strategy.shape, strategy.mesh
    params = param_shapes(cfg)
    rules = strategy.param_rules()
    total = _input_bytes(strategy, input_specs(cfg, shape))
    if shape.kind == "train":
        total += tree_bytes(rules, mesh, params)
        moment = (torch.bfloat16 if moment_dtype(cfg) == "bfloat16"
                  else torch.float32)
        # the step count (an int32 scalar), then AdamW's m and v
        total += 4 + 2 * tree_bytes(rules, mesh, _retyped(params, moment))
        if strategy.perf.compress_grads:
            total += tree_bytes(rules, mesh, _retyped(params, torch.float32))
        return total
    cache = build_model(cfg).cache_specs(shape.global_batch, shape.seq_len,
                                         strategy.perf.kv_dtype)
    return (total + tree_bytes(rules, mesh, params)
            + tree_bytes(strategy.cache_rules(), mesh, cache))


def _retyped(tree: Dict, dtype: torch.dtype) -> Dict:
    return {k: _retyped(v, dtype) if isinstance(v, dict)
            else torch.empty(v.shape, dtype=dtype, device="meta")
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# The sharded train step
# ---------------------------------------------------------------------------

class TrainCell(NamedTuple):
    """What ``build_train_cell`` returns; every function runs on this
    rank (every rank calls it: the collectives are SPMD)."""
    step: Callable          # (state, batch) -> (state, metrics), in place
    grads: Callable         # (params, batch) -> (metrics, grads)
    optimizer: AdamW
    microbatches: int
    hooks: Hooks
    shard_state: Callable   # whole TrainState -> this rank's shards
    state_specs: Callable   # TrainState -> its tree of partition specs
    local_batch: Callable   # whole batch {name: [B, ...]} -> this rank's rows
    #                         (and ``row_mask`` / ``real_rows`` where it
    #                         pads them)


def build_train_cell(cfg: ModelConfig, shape: ShapeConfig,
                     strategy: Strategy, *, moe_path: str = "capacity",
                     optimizer: Optional[AdamW] = None) -> TrainCell:
    """The reference's ``build_train_cell`` (``dryrun.py:95-138``): AdamW
    with its moment dtype, ``TRAIN_MICROBATCHES`` (or
    ``perf.microbatches``), remat, ``perf.compress_grads``, the stub
    modality inputs, and the strategy's hooks.  Every leaf of the state
    (params, m, v, the error-feedback tree) is placed by the train rules;
    ``local_batch`` gives this rank the rows of each microbatch the
    reference places there (the batch split [G, B/G], each microbatch's
    rows over the batch axes).  Where a microbatch's B/G rows do not
    split over the batch axes, each microbatch is padded at its end to
    whole rows a rank, as the reference's partitioner pads it: the real
    rows come first in global order, a rank may hold pad rows only, and
    the batch gains ``row_mask`` ([rows] bool, this rank's rows) and
    ``real_rows`` (an int: each microbatch's real rows over every batch
    rank), which keep pad rows out of the loss, the MoE's capacity and
    slots and the load-balance loss (``train_step.make_loss_fn``,
    ``moe._routed``): the step computes the unpadded batch's loss and
    gradients.  ``moe_path``
    routes the MoE as
    ``forward``'s (the grouped path runs ``moe_gemm`` over this rank's
    experts).  ``optimizer`` replaces the reference's AdamW (its moment
    dtype kept by the caller).  The stub modality inputs (a vlm's
    ``embeddings``, whisper's ``encoder_frames``) go to ``forward`` as
    the reference's ``extra`` passes them (``dryrun.py:45-48``)."""
    model = build_model(cfg)
    hooks = strategy.hooks()
    optimizer = optimizer or AdamW(moment_dtype=moment_dtype(cfg))
    G = strategy.perf.microbatches or TRAIN_MICROBATCHES.get(cfg.name, 1)
    compress = strategy.perf.compress_grads
    mesh, bax = strategy.mesh, strategy.bax

    def extra(batch):
        kw = {k: batch[k] for k in ("embeddings", "encoder_frames")
              if k in batch}
        return dict(kw, moe_path=moe_path)
    kw = dict(hooks=hooks, num_microbatches=G, remat=True,
              extra_inputs=extra)
    rules = strategy.param_rules()

    def state_specs(state: TrainState) -> TrainState:
        def specs(tree):
            return None if tree is None else rules.tree_specs(mesh, tree)
        opt = state.opt
        return TrainState(specs(state.params), opt and AdamWState(
            PartitionSpec(), specs(opt.m), specs(opt.v)),
            specs(state.error_fb))

    def shard_state(state: TrainState) -> TrainState:
        return shard_by_specs(state_specs(state), mesh, state)

    def local_batch(batch: Dict) -> Dict:
        out, ranks = {}, axis_size(mesh, bax)

        def local(mb):          # [G, rows, ...] -> this rank's [G * r, ...]
            mb = mb[(slice(None),) + local_slices(mesh, mb.shape[1:],
                                                  (bax,))]
            return mb.reshape(-1, *mb.shape[2:])
        for name, x in batch.items():
            B = x.shape[0]
            if B % G:
                raise ValueError(f"batch {B} does not split into {G} "
                                 f"microbatches")
            rows = B // G
            padded = -(-rows // ranks) * ranks
            mb = x.reshape(G, rows, *x.shape[1:])
            if padded != rows:
                mb = torch.cat([mb, mb.new_zeros(
                    (G, padded - rows) + tuple(x.shape[1:]))], 1)
            out[name] = local(mb)
        if padded != rows:
            real = torch.arange(padded, device=x.device) < rows
            out["row_mask"] = local(real.expand(G, padded))
            out["real_rows"] = rows
        return out

    return TrainCell(
        step=make_train_step(model, optimizer, compress=compress, **kw),
        grads=make_grad_fn(model, **kw), optimizer=optimizer,
        microbatches=G, hooks=hooks, shard_state=shard_state,
        state_specs=state_specs, local_batch=local_batch)


# ---------------------------------------------------------------------------
# The sharded serve step
# ---------------------------------------------------------------------------

def shard_params(strategy: Strategy, params: Dict, device=None) -> Dict:
    """This rank's part of a whole param tree, every leaf cut by the
    rules."""
    return shard_tree(strategy.param_rules(), strategy.mesh, params,
                      device=device)


def draw_params(strategy: Strategy, gen: torch.Generator) -> Dict:
    """``shard_params(strategy, build_model(cfg).init(gen))`` without the
    whole tree: the same seeded draw on ``gen.device``, each leaf (a
    stacked leaf one layer at a time) cut to this rank's part as it is
    drawn and the rest freed."""
    cfg, mesh = strategy.cfg, strategy.mesh
    rules = strategy.param_rules()
    shapes = {path_str(p): tuple(leaf.shape)
              for p, leaf in leaves_with_path(param_shapes(cfg))}

    def cut(path: str, leaf: torch.Tensor) -> torch.Tensor:
        spec = rules.spec_for(mesh, path, shapes[path])
        spec = spec[len(spec) - leaf.dim():]    # a layer: no layer dim
        part = leaf[local_slices(mesh, leaf.shape, spec)]
        return part.clone() if part.shape != leaf.shape else part
    return tfm.init_params(gen, cfg, cut=cut)


def shard_cache(strategy: Strategy, cache: Dict, device=None) -> Dict:
    """This rank's part of a whole cache tree (``step_cache_rules``): its
    batch rows, and its slice of the sequence where the step splits it
    (crosspool, prefill and decode alike)."""
    return shard_tree(strategy.step_cache_rules(), strategy.mesh, cache,
                      device=device)


def local_cache(strategy: Strategy, batch: int, max_len: int, device,
                kv_dtype: Optional[str] = None) -> Dict:
    """``shard_cache(strategy, init_cache(...))`` allocated at this
    rank's shapes directly: the whole cache is never built."""
    rules, mesh = strategy.step_cache_rules(), strategy.mesh

    def local(path, leaf):
        if isinstance(leaf, dict):
            return {k: local(f"{path}/{k}" if path else k, v)
                    for k, v in leaf.items()}
        shape = shard_shape(mesh, leaf.shape,
                            rules.spec_for(mesh, path, leaf.shape))
        return torch.full(shape, -1 if path.endswith("lpos") else 0,
                          dtype=leaf.dtype, device=device)
    return local("", build_model(strategy.cfg).cache_specs(batch, max_len,
                                                           kv_dtype))


def local_params(strategy: Strategy, device="meta") -> Dict:
    """This rank's param tree at its shard shapes, uninitialised on
    ``device`` (``meta``: shapes only)."""
    rules, mesh = strategy.param_rules(), strategy.mesh

    def local(path, leaf):
        if isinstance(leaf, dict):
            return {k: local(f"{path}/{k}" if path else k, v)
                    for k, v in leaf.items()}
        shape = shard_shape(mesh, leaf.shape,
                            rules.spec_for(mesh, path, leaf.shape))
        return torch.empty(shape, dtype=leaf.dtype, device=device)
    return local("", param_shapes(strategy.cfg))


def seq_leaf_bytes(strategy: Strategy, cache: Dict) -> int:
    """A rank's bytes of the cache tree ``cache``'s sequence-split leaves
    (``strategies.SEQ_SPLIT_LEAVES``: ``k`` / ``v`` / ``latent`` /
    ``rope`` / ``gk`` / ``gv``) under the reference's own table
    (``strategy.cache_rules()``), which the step's placement
    (``step_cache_rules``) must equal on these leaves.  Meta tensors are
    enough."""
    return tree_bytes(strategy.cache_rules(), strategy.mesh,
                      {k: v for k, v in cache.items()
                       if k in SEQ_SPLIT_LEAVES})


def local_rows(strategy: Strategy, x: torch.Tensor) -> torch.Tensor:
    """This rank's batch rows of an input (tokens, lengths, embeddings)."""
    rows = strategy.row_axes
    return x[local_slices(strategy.mesh, x.shape, (rows,))]


def resident_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree)
               if isinstance(t, torch.Tensor))


def greedy(strategy: Strategy, logits: torch.Tensor) -> torch.Tensor:
    """The greedy ids of the serve step's logits: a vocabulary split over
    ``model`` takes the split argmax (every rank of the ``model`` group
    gets its rows' ids; ties go to the lowest global id, as
    ``torch.argmax``'s); a whole vocabulary is ``logits.argmax(-1)``."""
    if logits.shape[-1] == strategy.cfg.vocab_size:
        # cp: allow(CP002) the dry-run's greedy read: the sampler's first-max rule
        return logits.argmax(-1)
    # cp: allow(CP002) the split argmax (sharding/collectives.py) of that rule
    return AxisGroup(strategy.mesh, "model").argmax(logits)


def build_serve_cell(cfg: ModelConfig, shape: ShapeConfig,
                     strategy: Strategy, *, impl: str = "xla"):
    """decode shapes -> serve_step(params, tokens, cache, lengths);
    prefill shapes -> prefill_fn(params, tokens, cache, **extra).  Both
    run on this rank's local shards (``shard_params`` / ``shard_cache``
    / ``local_rows``) and return (logits, the cache updated in place).
    The logits are this rank's rows (``local_rows``) over this rank's
    vocabulary shard [B_loc, V/model] as the reference's ``logits``
    constraint leaves them (``strategies.py:396``); under monolithic DP
    attention (``:356``), and for a vocabulary that does not split over
    ``model``, over the whole vocabulary [B_loc, V]; ``greedy`` reads
    either.  ``impl`` routes the attention as the Model path's."""
    model = build_model(cfg)
    hooks = strategy.hooks()

    if shape.is_decode:
        def serve_step(params, tokens, cache, lengths):
            return model.decode_step(params, tokens, cache, lengths,
                                     hooks=hooks, impl=impl)
        return serve_step

    def prefill_fn(params, tokens, cache, **extra):
        return model.prefill(params, tokens, cache, hooks=hooks, impl=impl,
                             **extra)
    return prefill_fn


# ---------------------------------------------------------------------------
# The step counted on meta
# ---------------------------------------------------------------------------

def padded_batch(strategy: Strategy, microbatches: int) -> int:
    """The train batch a rank's share of which the op analysis counts:
    the cell's, or, where a microbatch's rows do not split over the batch
    axes (llama3-405b's 16 microbatches of 16 rows over the multi-pod
    mesh's 32), the batch padded to whole rows a rank, as the reference's
    partitioner pads it and as the cell's ``local_batch`` pads it
    (``run_cell`` reports it as ``analyzed_batch``)."""
    per = microbatches * axis_size(strategy.mesh, strategy.bax)
    return -(-strategy.shape.global_batch // per) * per


def analyze_cell(cfg: ModelConfig, shape: ShapeConfig, strategy: Strategy
                 ) -> ModuleStats:
    """Run the cell's step once for rank 0 of ``strategy``'s mesh, which
    must be a stand-in (``Mesh.stand_in``), on ``meta`` tensors at the
    rank's shard shapes, and count it (``op_analysis.analyze_step``): the
    train cell's whole step (every microbatch's forward and backward, the
    AdamW update; a batch whose microbatches do not split over the batch
    axes padded by the cell's own ``local_batch``, as ``padded_batch``
    counts it) with grad enabled, the serve cell's decode step or
    prefill under
    ``torch.no_grad()``."""
    mesh = strategy.mesh
    if not mesh.is_stand_in:
        raise ValueError("analyze_cell needs a stand-in mesh")
    params = local_params(strategy)
    specs = input_specs(cfg, shape)
    if shape.kind == "train":
        cell = build_train_cell(cfg, shape, strategy)
        fb = (init_error_feedback(params) if strategy.perf.compress_grads
              else None)
        state = TrainState(params, cell.optimizer.init(params), fb)
        with torch.enable_grad():
            return analyze_step(cell.step, state, cell.local_batch(specs),
                                mesh=mesh)
    step = build_serve_cell(cfg, shape, strategy)
    cache = local_cache(strategy, shape.global_batch, shape.seq_len, "meta",
                        strategy.perf.kv_dtype)
    rows = {k: local_rows(strategy, v) if v.dim() else v
            for k, v in specs.items()}
    tokens = rows.pop("tokens")
    with torch.no_grad():
        if shape.is_decode:
            return analyze_step(step, params, tokens, cache,
                                rows["lengths"], mesh=mesh)
        return analyze_step(step, params, tokens, cache, mesh=mesh, **rows)


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------

def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             strategy_name: str = "auto", verbose: bool = True,
             perf=None) -> Dict:
    """One cell's record: its per-device argument bytes, and the step
    counted on ``meta`` (``analyze_cell``): ``roofline``,
    ``memory.temp_bytes`` and ``analyze_s`` (seconds to minutes:
    llama3-405b's train cell runs 16 microbatches of 126 layers op by
    op)."""
    cfg = get_config(arch)
    shape = SHAPES_BY_NAME[shape_name]
    mesh_name = MESH_NAMES[multi_pod]
    record: Dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                    "strategy": strategy_name, "ok": False}

    ok, why = shape_applicable(cfg, shape)
    if not ok:
        record.update(skipped=True, reason=why)
        if verbose:
            print(f"[skip] {arch} x {shape_name}: {why}")
        return record

    mesh = make_production_mesh(multi_pod=multi_pod).stand_in(0)
    strategy = make_strategy(strategy_name, mesh, cfg, shape, perf=perf)
    record["strategy"] = strategy.name
    if perf is not None:
        record["perf"] = {k: v for k, v in vars(perf).items()
                          if v not in (None, False)}
    mb = 1
    if shape.kind == "train":
        mb = record["microbatches"] = (strategy.perf.microbatches
                                       or TRAIN_MICROBATCHES.get(arch, 1))
    record.update(ok=True, memory={"argument_bytes": argument_bytes(strategy)})
    if shape.kind == "train" and padded_batch(strategy, mb) \
            != shape.global_batch:
        record["analyzed_batch"] = padded_batch(strategy, mb)
    t0 = time.perf_counter()
    stats = analyze_cell(cfg, shape, strategy)
    analyze_s = time.perf_counter() - t0
    report = rf.build_report(
        arch=arch, shape=shape, mesh_name=mesh_name, strategy=strategy.name,
        chips=mesh_chip_count(mesh), stats=stats, cfg=cfg, microbatches=mb,
        kv_itemsize=1 if strategy.perf.kv_dtype == "f8" else 2)
    record["memory"]["temp_bytes"] = stats.temp_bytes
    record.update(analyze_s=round(analyze_s, 2), roofline=report.to_dict())
    if verbose:
        m, r = record["memory"], record["roofline"]
        print(f"[ok] {arch} x {shape_name} x {mesh_name} ({strategy.name}) "
              f"analyze {analyze_s:.1f}s | args "
              f"{m['argument_bytes'] / 2 ** 30:.2f} GiB temp "
              f"{m['temp_bytes'] / 2 ** 30:.2f} GiB /dev | compute "
              f"{r['t_compute']:.3e}s memory {r['t_memory']:.3e}s "
              f"collective {r['t_collective']:.3e}s -> {r['dominant']}")
    return record


def run_cells(cells, *, multi_pod: bool = False, strategy_name: str = "auto",
              out: Optional[str] = None) -> int:
    """Run ``cells`` [(arch, shape)], print each record line and the
    summary line; returns the number of failed cells."""
    records = []
    failures = 0
    for arch, shape in cells:
        try:
            rec = run_cell(arch, shape, multi_pod=multi_pod,
                           strategy_name=strategy_name)
        except Exception as e:  # a failing cell is a bug in our system
            failures += 1
            rec = {"arch": arch, "shape": shape, "ok": False,
                   "mesh": MESH_NAMES[multi_pod],
                   "error": f"{type(e).__name__}: {e}",
                   "trace": traceback.format_exc()[-2000:]}
            print(f"[FAIL] {arch} x {shape}: {type(e).__name__}: {e}")
        records.append(rec)
        if out:
            with open(out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    n_ok = sum(1 for r in records if r.get("ok"))
    n_skip = sum(1 for r in records if r.get("skipped"))
    print(f"\n== dry-run: {n_ok} ok, {n_skip} skipped, {failures} failed, "
          f"{len(records)} total ==")
    return failures


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_NAMES))
    ap.add_argument("--shape", choices=list(SHAPES_BY_NAME))
    ap.add_argument("--strategy", default="auto",
                    choices=["auto", "train", "crosspool", "monolithic"])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="sweep every (arch x shape) cell")
    ap.add_argument("--out", default=None, help="append JSON records here")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s) for a in ARCH_NAMES for s in SHAPES_BY_NAME]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]
    failures = run_cells(cells, multi_pod=args.multi_pod,
                         strategy_name=args.strategy, out=args.out)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
