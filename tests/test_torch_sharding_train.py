"""The port's sharded training step on four ``gloo`` processes (CPU),
against the JAX package on the same numbers.

Two spawns of 4 ranks (``torch.multiprocessing``, file rendezvous under
the fixture's directory, each bounded by ``TIMEOUT`` seconds), one per
module-scoped fixture; the JAX side runs in this process.  Inputs come
from numpy seeds; params from the reference's own init, bridged.

* forward: the 10 archs' float32 smoke configs on a (2,2) mesh (every
  leaf split by the train rules): the gathered logits within 2e-4 of the
  JAX package's single-device ``forward``
  (``tests/test_sharding.py:235-253``), and whisper's once more under
  ``seq_parallel`` (its decoder's stream split over ``model``, the
  encoder's frames whole);
* loss and gradients (``build_train_cell``'s ``grads`` and ``step``):
  qwen3-moe (capacity and grouped MoE), minicpm3 (MLA), qwen3-14b,
  gemma3 (tied, sliding window), zamba2 (hybrid) and whisper (encoder-
  decoder) on (2,2), mamba2 (ssm) on (1,4) and with ``seq_parallel``,
  whisper with ``seq_parallel``, and the variants
  ``seq_parallel``, ``compress_grads``, 2 microbatches (capacity path:
  the row order), ``moe_a2a`` (experts over data; its capacities at
  8x, drop-free, against the JAX package's drop-free grouped path, as the
  reference's a2a test does), a (1,4) mesh (qwen3-moe's 2 KV heads split
  mid-head) and a (4,1) mesh (FSDP / DP only); and batches whose
  microbatch rows do not split over the batch ranks, which the cell pads
  as the reference's partitioner does (capacity and grouped MoE over
  (4,1) at B = 10, G = 2: a rank with one real row and one with none;
  ``seq_parallel`` with ``compress_grads`` over (2,2) at B = 6, G = 2),
  against the JAX package's step on the unpadded batch.  Loss, ce and aux
  within 1e-5 relative of ``jax.value_and_grad(make_loss_fn(...))``; every
  leaf's gathered gradient within 1e-4 of the leaf's scale; after one
  AdamW step (clip) params and moments within 1e-4 of max(1, scale), as
  ``tests/test_torch_training.py``'s step test.  Compressed gradients
  agree within one int8 quantum (``scale``) per element: ``round(x /
  scale)`` lands on the other side of .5 when the f32 sums round
  otherwise;
* placement: every leaf of params, m, v and the error-feedback tree holds
  exactly its rule's shard, and a rank's resident bytes equal
  ``dryrun.argument_bytes`` for that mesh and shape;
* a sharded ``TrainState`` saved under (2,2) restores onto (4,1);
* on a one-rank group the train hooks leave ``forward`` bit for bit, for
  every family; ``TRAIN_MICROBATCHES`` is the reference's table.
"""
import ast
import functools
import os
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.bridge import params_to_torch
from repro_torch.configs import SHAPES_BY_NAME as T_SHAPES
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh
from repro_torch.sharding import moe_a2a
from repro_torch.models import transformer as ttfm
from repro_torch.models.model import build_model
from repro_torch.sharding.spec import local_slices, path_str, shard_shape
from repro_torch.sharding.strategies import PerfOpts, make_strategy
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import compression as tcomp
from repro_torch.training.optimizer import AdamW
from repro_torch.training.train_step import TrainState
from repro_torch.training.tree import leaves_with_path
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
TIMEOUT = 150           # seconds a spawn's four ranks may take, start to end
FWD_TOL = dict(rtol=2e-4, atol=2e-4)
LR = dict(lr=3e-3, warmup_steps=10)
MOE = "qwen3-moe-235b-a22b"
B, S = 8, 16
LLAVA = "llava-next-34b"
MAMBA, ZAMBA, WHISPER = "mamba2-130m", "zamba2-1.2b", "whisper-small"
GEMMA_S = 32            # past gemma3's smoke window of 16


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _worker(rank: int, tmp: str, job: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            rank=rank, world_size=WORLD)
    payload = torch.load(os.path.join(tmp, "in.pt"), weights_only=False)
    out = JOBS[job](payload)
    torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def _run(tmp, job: str, payload) -> list:
    """Run ``job`` on 4 ranks; returns each rank's result."""
    tmp = str(tmp)
    torch.save(payload, os.path.join(tmp, "in.pt"))
    ctx = mp.start_processes(_worker, args=(tmp, job), nprocs=WORLD,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                pytest.fail(f"{job}: the ranks did not finish in {TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [torch.load(os.path.join(tmp, f"out{r}.pt"), weights_only=False)
            for r in range(WORLD)]


def _shape(batch: int, seq: int):
    return replace(T_SHAPES["train_4k"], seq_len=seq, global_batch=batch)


def _cell(case, mesh, **kw):
    st = make_strategy("train", mesh, case["cfg"], case["shape"],
                       case["perf"])
    return st, dryrun.build_train_cell(case["cfg"], case["shape"], st,
                                       moe_path=case["moe_path"], **kw)


def _forward_job(p):
    out = []
    for case in p["cases"]:
        mesh = Mesh(case["mesh"], ("data", "model"), live=True)
        st, cell = _cell(case, mesh)
        params = cell.shard_state(TrainState(case["params"], None)).params
        batch = cell.local_batch(case["batch"])
        logits, _ = ttfm.forward(params, case["cfg"], batch["tokens"],
                                 embeddings=batch.get("embeddings"),
                                 encoder_frames=batch.get("encoder_frames"),
                                 hooks=cell.hooks)
        out.append(dict(logits=logits, coord=mesh.coord,
                        seq=cell.hooks.tp.seq))
    return out


def _step_job(p):
    out = []
    for case in p["cases"]:
        cfg = case["cfg"]
        mesh = Mesh(case["mesh"], ("data", "model"), live=True)
        opt = AdamW(moment_dtype=dryrun.moment_dtype(cfg), **LR)
        # the a2a dispatch at the capacities of the reference's a2a test
        # (8x): drop-free, so the JAX package's grouped path is its value
        make_a2a = moe_a2a.make_moe_a2a
        moe_a2a.make_moe_a2a = functools.partial(make_a2a, capacity_mult=8.0)
        try:
            st, cell = _cell(case, mesh, optimizer=opt)
        finally:
            moe_a2a.make_moe_a2a = make_a2a
        params = case["params"]
        whole = TrainState(params, opt.init(params),
                           tcomp.init_error_feedback(params)
                           if case["perf"].compress_grads else None)
        state = cell.shard_state(whole)
        specs = cell.state_specs(whole)
        # placement: every leaf holds exactly its rule's shard
        placed = []
        for (path, leaf), (_, local), (_, spec) in zip(
                leaves_with_path(whole), leaves_with_path(state),
                _spec_leaves(specs)):
            if leaf is None:
                continue
            exact = torch.equal(local, leaf[local_slices(mesh, leaf.shape,
                                                         spec)])
            placed.append((path_str(path), tuple(local.shape),
                           shard_shape(mesh, leaf.shape, spec),
                           tuple(leaf.shape), exact))
        batch = cell.local_batch(case["batch"])
        mask = batch.get("row_mask")
        batch_bytes = dryrun.resident_bytes(batch)
        resident = dryrun.resident_bytes(state) + batch_bytes
        metrics, grads = cell.grads(state.params, batch)
        state, step_metrics = cell.step(state, batch)
        out.append(dict(
            coord=mesh.coord, metrics={k: float(v) for k, v in
                                       metrics.items()},
            step_metrics={k: float(v) for k, v in step_metrics.items()},
            grads=_flat(grads), params=_flat(state.params),
            m=_flat(state.opt.m), v=_flat(state.opt.v),
            error_fb=None if state.error_fb is None
            else _flat(state.error_fb),
            specs={k: tuple(v) for k, v in st.param_specs().items()},
            placed=placed, resident=resident, batch_bytes=batch_bytes,
            real_rows=None if mask is None else int(mask.sum()),
            input_bytes=dryrun._input_bytes(st, dryrun.input_specs(
                cfg, case["shape"])),
            argument_bytes=dryrun.argument_bytes(st)))
    if p.get("ckpt"):
        out.append(_ckpt(p["ckpt"]))
    return out


def _ckpt(c):
    """A sharded TrainState under (2,2), saved (rank 0 writes the whole
    leaves), restored onto (4,1)."""
    cfg, shape = c["cfg"], _shape(B, S)
    opt = AdamW()
    whole = TrainState(c["params"], opt.init(c["params"]))
    whole.opt.m["embed"]["tok"].normal_(generator=torch.Generator()
                                        .manual_seed(1))
    mesh_a = Mesh((2, 2), ("data", "model"), live=True)
    cell_a = dryrun.build_train_cell(cfg, shape, make_strategy(
        "train", mesh_a, cfg, shape))
    path = ckpt.save(cell_a.shard_state(whole), 3, c["dir"],
                     specs=cell_a.state_specs(whole), mesh=mesh_a)
    mesh_b = Mesh((4, 1), ("data", "model"), live=True)
    cell_b = dryrun.build_train_cell(cfg, shape, make_strategy(
        "train", mesh_b, cfg, shape))
    restored, step = ckpt.restore(c["dir"], target_tree=whole,
                                  specs=cell_b.state_specs(whole),
                                  mesh=mesh_b)
    expect = cell_b.shard_state(whole)
    equal = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        leaves_with_path(restored), leaves_with_path(expect))
        if a is not None)
    split = sum(a.shape != w.shape for (_, a), (_, w) in zip(
        leaves_with_path(restored), leaves_with_path(whole))
        if a is not None)
    return dict(ckpt=True, step=step, path=path, equal=equal, split=split,
                rank=mesh_b.rank)


JOBS = {"forward": _forward_job, "step": _step_job}


def _flat(tree):
    return {path_str(p): t.detach() for p, t in leaves_with_path(tree)}


def _spec_leaves(specs, prefix=()):
    """(path, spec) of a TrainState's spec tree, leaves in order (a None
    subtree: one None leaf)."""
    if isinstance(specs, dict):
        for k, v in specs.items():
            yield from _spec_leaves(v, prefix + (k,))
    elif hasattr(specs, "_fields"):
        for k, v in zip(specs._fields, specs):
            yield from _spec_leaves(v, prefix + (k,))
    else:
        yield prefix, specs


def _assemble(got, key, path, shape, mesh_shape):
    """The whole leaf ``path`` of ``key`` from every rank's shard."""
    mesh = Mesh(mesh_shape, ("data", "model"))
    full = np.zeros(shape, np.float32)
    for g in got:
        spec = g["specs"][path]
        full[local_slices(mesh, shape, spec, g["coord"])] = \
            g[key][path].float().numpy()
    return full


# ---------------------------------------------------------------------------
# the reference (imported here only: the ranks import no JAX)
# ---------------------------------------------------------------------------

def _np_tree(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


def _j_setup(arch, seq=S, batch_rows=B, **over):
    import jax
    from repro.configs import get_smoke_config
    from repro.models import build_model
    over = dict(over, dtype="float32")
    j_cfg = get_smoke_config(arch).replace(**over)
    model = build_model(j_cfg)
    params = _np_tree(model.init(jax.random.PRNGKey(5)))
    rng = np.random.default_rng(len(arch) + seq)
    txt = seq - (j_cfg.frontend_tokens if arch == LLAVA else 0)
    batch = {"tokens": rng.integers(0, j_cfg.vocab_size,
                                    (batch_rows, txt)).astype(np.int32)}
    if arch == LLAVA:
        batch["embeddings"] = rng.standard_normal(
            (batch_rows, j_cfg.frontend_tokens, j_cfg.d_model)).astype(
                np.float32)
    if arch == WHISPER:
        batch["encoder_frames"] = rng.standard_normal(
            (batch_rows, j_cfg.encoder_seq, j_cfg.d_model)).astype(
                np.float32)
    return j_cfg, model, params, batch, t_smoke(arch).replace(**over)


def _inputs(batch):
    """The modality inputs of a batch, as ``forward`` takes them."""
    return {k: batch[k] for k in ("embeddings", "encoder_frames")
            if k in batch}


FWD_ARCHS = ("llama3-405b", "qwen3-14b", MOE, "moonshot-v1-16b-a3b",
             "gemma3-12b", "minicpm3-4b", LLAVA, MAMBA, ZAMBA, WHISPER)
#: the forward cases on (2,2): (test id, arch, perf levers): every arch,
#: then whisper with its decoder's stream split over model
FWD_CASES = tuple((a, a, {}) for a in FWD_ARCHS) + (
    ("whisper-seq-parallel", WHISPER, {"seq_parallel": True}),)


@pytest.fixture(scope="module")
def forward_runs(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    cases, wants = [], []
    for _, arch, perf in FWD_CASES:
        seq = GEMMA_S if arch in ("gemma3-12b", LLAVA) else S
        j_cfg, model, params, batch, t_cfg = _j_setup(arch, seq)
        want, _ = jax.jit(lambda p, b: model.forward(
            p, b["tokens"], **_inputs(b)))(
                params, {k: jnp.asarray(v) for k, v in batch.items()})
        cases.append(dict(cfg=t_cfg, shape=_shape(B, seq), mesh=(2, 2),
                          perf=PerfOpts(microbatches=1, **perf),
                          moe_path="capacity",
                          params=params_to_torch(params),
                          batch={k: torch.from_numpy(v)
                                 for k, v in batch.items()}))
        wants.append(np.asarray(want))
    got = _run(tmp_path_factory.mktemp("forward"), "forward",
               {"cases": cases})
    return got, wants


@pytest.mark.parametrize("i", range(len(FWD_CASES)),
                         ids=[c[0] for c in FWD_CASES])
def test_sharded_forward_matches_single_device(forward_runs, i):
    """Rows over data, the vocabulary over model: the gathered logits
    equal the JAX package's single-device forward within the reference's
    own sharded test's tolerance; ranks holding the same part agree
    (under ``seq_parallel`` the cell's stream splits over model)."""
    got, wants = forward_runs
    want = wants[i]
    assert all(g[i]["seq"] == bool(FWD_CASES[i][2].get("seq_parallel"))
               for g in got)
    full = np.zeros_like(want)
    seen = {}
    for g in got:
        d, m = g[i]["coord"]
        logits = g[i]["logits"]
        rows, cols = logits.shape[0], logits.shape[-1]
        full[d * rows:(d + 1) * rows, ..., m * cols:(m + 1) * cols] = \
            logits.numpy()
        seen[(d, m)] = True
    assert len(seen) == WORLD and cols * 2 == want.shape[-1]
    np.testing.assert_allclose(full, want, **FWD_TOL)


#: (label, arch, mesh, perf levers, MoE path, reference key)
STEP_CASES = (
    ("qwen3-moe-capacity", MOE, (2, 2), {}, "capacity", "moe-capacity"),
    ("qwen3-moe-grouped", MOE, (2, 2), {}, "grouped", "moe-grouped"),
    ("minicpm3-mla", "minicpm3-4b", (2, 2), {}, "capacity", "minicpm3"),
    ("qwen3-14b-dense", "qwen3-14b", (2, 2), {}, "capacity", "qwen3-14b"),
    ("gemma3-tied-window", "gemma3-12b", (2, 2), {}, "capacity", "gemma3"),
    ("seq-parallel", MOE, (2, 2), {"seq_parallel": True}, "capacity",
     "moe-capacity"),
    ("compress-grads", "qwen3-14b", (2, 2), {"compress_grads": True},
     "capacity", "qwen3-14b"),
    ("microbatches-2", MOE, (2, 2), {"microbatches": 2}, "capacity",
     "moe-capacity-G2"),
    ("moe-a2a", MOE, (2, 2), {"moe_a2a": True}, "capacity", "moe-grouped"),
    ("mesh-1x4", MOE, (1, 4), {}, "capacity", "moe-capacity"),
    ("mesh-4x1", MOE, (4, 1), {}, "capacity", "moe-capacity"),
    ("mamba2-ssm-1x4", MAMBA, (1, 4), {}, "capacity", "mamba2"),
    ("mamba2-seq-parallel", MAMBA, (2, 2), {"seq_parallel": True},
     "capacity", "mamba2"),
    ("zamba2-hybrid", ZAMBA, (2, 2), {}, "capacity", "zamba2"),
    ("whisper-audio", WHISPER, (2, 2), {}, "capacity", "whisper"),
    ("whisper-seq-parallel", WHISPER, (2, 2), {"seq_parallel": True},
     "capacity", "whisper"),
    # microbatches of 5 rows padded to 8 over 4 ranks, and of 3 to 4 over 2
    ("uneven-capacity-4x1", MOE, (4, 1), {"microbatches": 2}, "capacity",
     "moe-capacity-B10-G2"),
    ("uneven-grouped-4x1", MOE, (4, 1), {"microbatches": 2}, "grouped",
     "moe-grouped-B10-G2"),
    ("uneven-seq-parallel-compress", MOE, (2, 2),
     {"microbatches": 2, "seq_parallel": True, "compress_grads": True},
     "capacity", "moe-capacity-B6-G2"),
)

#: each uneven case's real rows a rank (over both microbatches)
UNEVEN_REAL_ROWS = {"uneven-capacity-4x1": [4, 4, 2, 0],
                    "uneven-grouped-4x1": [4, 4, 2, 0],
                    "uneven-seq-parallel-compress": [4, 4, 2, 2]}


def _reference(arch, moe_path, G, seq, batch_rows=B):
    """The JAX package's loss, metrics and gradients (``value_and_grad``
    of ``make_loss_fn``, averaged over G microbatches as its train step
    does), then the step's compression and AdamW update by its own
    functions (``make_train_step``'s body)."""
    import jax
    import jax.numpy as jnp
    from repro.training import compression as jcomp
    from repro.training.optimizer import AdamW as JAdamW
    from repro.training.train_step import make_loss_fn
    j_cfg, model, params, batch, t_cfg = _j_setup(arch, seq, batch_rows)
    extra = (lambda b: dict(_inputs(b), moe_path=moe_path))
    vg = jax.jit(jax.value_and_grad(
        make_loss_fn(model, remat=False, extra_inputs=extra), has_aux=True))
    metrics, grads = None, None
    for i in range(G):
        part = {k: jnp.asarray(np.split(v, G)[i]) for k, v in batch.items()}
        (_, m), g = vg(params, part)
        m = {k: float(v) / G for k, v in m.items()}
        g = jax.tree.map(lambda a: np.asarray(a, np.float32) / G, g)
        metrics = m if metrics is None else {k: metrics[k] + m[k]
                                             for k in m}
        grads = g if grads is None else jax.tree.map(np.add, grads, g)
    opt = JAdamW(**LR)
    update = jax.jit(opt.update)
    out = {"cfg": t_cfg, "params": params, "batch": batch,
           "metrics": metrics, "grads": _np_flat(grads)}
    for compress in (False, True):
        used, fb = grads, None
        if compress:
            used, fb = jcomp.compress_grads(
                grads, jcomp.init_error_feedback(params))
            fb = _np_flat(fb)
        new_p, new_opt = update(used, opt.init(params), params)
        gn = float(np.sqrt(sum(np.sum(np.square(np.asarray(x, np.float64)))
                               for x in jax.tree.leaves(used))))
        out[compress] = dict(params=_np_flat(new_p), m=_np_flat(new_opt.m),
                             v=_np_flat(new_opt.v), grad_norm=gn,
                             used=_np_flat(used), error_fb=fb)
    return out


def _np_flat(tree):
    import jax
    return {"/".join(str(getattr(k, "key", k)) for k in path):
            np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


REFERENCES = {
    "moe-capacity": (MOE, "capacity", 1, S),
    "moe-grouped": (MOE, "grouped", 1, S),
    "moe-capacity-G2": (MOE, "capacity", 2, S),
    "minicpm3": ("minicpm3-4b", "capacity", 1, S),
    "qwen3-14b": ("qwen3-14b", "capacity", 1, S),
    "gemma3": ("gemma3-12b", "capacity", 1, GEMMA_S),
    "mamba2": (MAMBA, "capacity", 1, S),
    "zamba2": (ZAMBA, "capacity", 1, S),
    "whisper": (WHISPER, "capacity", 1, S),
    "moe-capacity-B10-G2": (MOE, "capacity", 2, S, 10),
    "moe-grouped-B10-G2": (MOE, "grouped", 2, S, 10),
    "moe-capacity-B6-G2": (MOE, "capacity", 2, S, 6),
}


@pytest.fixture(scope="module")
def step_runs(tmp_path_factory):
    refs = {key: _reference(*args) for key, args in REFERENCES.items()}
    cases = []
    for label, arch, mesh, perf, moe_path, key in STEP_CASES:
        ref = refs[key]
        cfg = ref["cfg"]
        cases.append(dict(
            cfg=cfg, shape=_shape(len(ref["batch"]["tokens"]),
                                  REFERENCES[key][3]), mesh=mesh,
            perf=PerfOpts(**dict({"microbatches": 1}, **perf)),
            moe_path=moe_path, params=params_to_torch(ref["params"]),
            batch={k: torch.from_numpy(v) for k, v in ref["batch"].items()}))
    tmp = tmp_path_factory.mktemp("step")
    ckpt_case = dict(cfg=refs["qwen3-14b"]["cfg"],
                     params=params_to_torch(refs["qwen3-14b"]["params"]),
                     dir=str(tmp / "ckpt"))
    got = _run(tmp, "step", {"cases": cases, "ckpt": ckpt_case})
    return got, refs


def _leaf_close(got, want, tol, what):
    """Within ``tol`` of the leaf's own scale (max |want|)."""
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale + 1e-12, (what, err, scale)


def _close_scaled(got, want, tol, what):
    """Within ``tol`` of max(1, max |want|)."""
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


@pytest.mark.parametrize("i", range(len(STEP_CASES)),
                         ids=[c[0] for c in STEP_CASES])
def test_sharded_train_step_matches_jax(step_runs, i):
    got, refs = step_runs
    label, arch, mesh, perf, moe_path, key = STEP_CASES[i]
    ref = refs[key]
    compress = bool(perf.get("compress_grads"))
    after = ref[compress]
    ranks = [g[i] for g in got[:WORLD]]
    assert [r["real_rows"] for r in ranks] == UNEVEN_REAL_ROWS.get(
        label, [None] * WORLD)
    for r in ranks:
        for k in ("loss", "ce", "aux"):
            np.testing.assert_allclose(r["metrics"][k], ref["metrics"][k],
                                       rtol=1e-5, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(r["step_metrics"]["grad_norm"],
                                   after["grad_norm"], rtol=1e-5)
    for path, want in ref["grads"].items():
        _leaf_close(_assemble(ranks, "grads", path, want.shape, mesh), want,
                    1e-4, f"grad {path}")
        for key_ in ("params", "m", "v"):
            w = after[key_][path]
            _close_scaled(_assemble(ranks, key_, path, w.shape, mesh), w,
                          1e-4, f"{key_} {path}")
    if compress:
        # g_used = (g + 0) - e': within one quantum of the reference's
        for path, want in after["used"].items():
            fb = _assemble(ranks, "error_fb", path, want.shape, mesh)
            g = _assemble(ranks, "grads", path, want.shape, mesh)
            quantum = float(np.abs(ref["grads"][path]).max()) / 127.0
            assert float(np.abs((g - fb) - want).max()) <= \
                quantum * (1 + 1e-4) + 1e-12, path
            assert float(np.abs(fb - after["error_fb"][path]).max()) <= \
                quantum * (1 + 1e-4) + 1e-12, path


@pytest.mark.parametrize("i", range(len(STEP_CASES)),
                         ids=[c[0] for c in STEP_CASES])
def test_train_state_placed_by_the_rules(step_runs, i):
    """Params, m, v and the error-feedback tree: each leaf's local shard
    is exactly the rule's; a rank's resident bytes (state + its rows)
    equal the dry-run's per-device argument bytes.  A padded batch's
    rows are not the dry-run's input bytes (the reference's input spec
    leaves a batch that does not split over the ranks whole): there the
    state alone is held to them."""
    got, _ = step_runs
    for g in got[:WORLD]:
        r = g[i]
        for path, shape, want, _, exact in r["placed"]:
            assert shape == want and exact, path
        if r["real_rows"] is None:
            assert r["resident"] == r["argument_bytes"]
        else:
            assert r["resident"] - r["batch_bytes"] \
                == r["argument_bytes"] - r["input_bytes"]
        # the embedding, the head and the stacked attention or SSM leaves
        # of the params, m and v are split (they divide on these meshes)
        split = {p for p, shape, _, whole, _ in r["placed"]
                 if shape != whole}
        for kind in ("params", "opt/m", "opt/v"):
            assert f"{kind}/embed/tok" in split
            assert any(p.startswith(f"{kind}/") and (
                "/attn/w" in p or "/ssm/in_proj" in p) for p in split)

def test_sharded_train_state_checkpoint_reshards(step_runs):
    """A sharded TrainState written under (2,2) (rank 0 writes once)
    restores onto (4,1): every rank's leaves equal the new cut."""
    got, _ = step_runs
    rec = [g[-1] for g in got]
    assert all(r["ckpt"] for r in rec)
    assert sorted(r["rank"] for r in rec) == list(range(WORLD))
    assert [r["path"] is not None for r in rec] == [True] + [False] * 3
    for r in rec:
        assert r["step"] == 3 and r["equal"] and r["split"] > 0


# ---------------------------------------------------------------------------
# one rank; the table
# ---------------------------------------------------------------------------

def test_one_rank_train_hooks_are_bit_exact(tmp_path):
    """Over a one-rank group the train hooks leave ``forward`` bit for
    bit as without hooks (a MoE, an MLA, a tied sliding-window arch, and
    the ssm, hybrid and audio archs, whose ``build_train_cell`` builds)."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        mesh = Mesh((1, 1), ("data", "model"), live=True)
        shape = _shape(B, S)
        for arch in (MOE, "minicpm3-4b", "gemma3-12b", MAMBA, ZAMBA,
                     WHISPER):
            cfg = t_smoke(arch).replace(dtype="float32")
            params = build_model(cfg).init(torch.Generator().manual_seed(0))
            gen = torch.Generator().manual_seed(1)
            tokens = torch.randint(0, cfg.vocab_size, (2, S), generator=gen)
            kw = {}
            if arch == WHISPER:
                kw["encoder_frames"] = torch.randn(
                    2, cfg.encoder_seq, cfg.d_model, generator=gen)
            cell = dryrun.build_train_cell(cfg, shape, make_strategy(
                "train", mesh, cfg, shape))
            for path in ("capacity", "grouped"):
                want = ttfm.forward(params, cfg, tokens, moe_path=path, **kw)
                got = ttfm.forward(params, cfg, tokens, moe_path=path,
                                   hooks=cell.hooks, **kw)
                assert all(torch.equal(a, b) for a, b in zip(got, want))
    finally:
        dist.destroy_process_group()


def test_train_microbatches_equal_the_reference(monkeypatch):
    """The table is the reference's (read from its source: importing
    ``repro.launch.dryrun`` sets the process's XLA device count).  The
    step's count on ``meta`` is stubbed: 16 microbatches of 126 layers
    take minutes op by op."""
    from repro_torch.launch.op_analysis import ModuleStats
    monkeypatch.setattr(dryrun, "analyze_cell",
                        lambda *a: ModuleStats(0.0, {}, 0, 0))
    src = (ROOT / "src/repro/launch/dryrun.py").read_text()
    node = next(n for n in ast.parse(src).body
                if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", "") == "TRAIN_MICROBATCHES")
    assert dryrun.TRAIN_MICROBATCHES == ast.literal_eval(node.value)
    rec = dryrun.run_cell("llama3-405b", "train_4k", verbose=False)
    assert rec["microbatches"] == 16
