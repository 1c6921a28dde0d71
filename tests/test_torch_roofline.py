"""The port's step roofline and its counting: ``launch/roofline.py``,
``launch/op_analysis.py``, the stand-in mesh (``launch/mesh.py``), the
dry-run's ``roofline`` record (``launch/dryrun.py``) and the perf
hillclimb (``launch/perf.py``), against the JAX package where it has the same
function.

* ``model_flops_estimate``, ``analytic_bytes_estimate`` and
  ``trip_factor`` equal the reference's with ``==`` for every arch and
  applicable shape, on both production meshes' chip counts and at one
  and several microbatches; ``RooflineReport.to_dict`` has the
  reference's keys; the card's peaks are the H100 SXM's.
* The op analysis's FLOPs equal a hand count of the matmuls of a dense
  smoke decoder's decode and prefill steps (relative 1e-9).
* The stand-in mesh's collective bytes equal the bytes a live four-rank
  ``gloo`` mesh moves for the same sharded steps (a crosspool MoE decode
  step and a train step), rank by rank.
* A ``meta`` tensor takes the plain route of the wrapper that needs it;
  a CUDA-less device other than the CPU and ``meta`` still raises.
* ``run_cell`` gives a finite roofline and temp bytes for qwen3-14b x
  decode_32k and mamba2-130m x train_4k; the report renders it;
  ``perf.run_variant`` runs the baseline and a ``PerfOpts`` variant.
"""
import math
import os
import time
from types import SimpleNamespace

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import ARCH_NAMES, SHAPES, SHAPES_BY_NAME, \
    get_config
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs import shape_applicable
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import build
from repro_torch.kernels import ops as kops
from repro_torch.launch import dryrun, mesh as tmesh, perf, report
from repro_torch.launch import roofline as trf
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.op_analysis import analyze_step, to_meta
from repro_torch.models.model import build_model
from repro_torch.models.transformer import param_shapes
from repro_torch.sharding.strategies import make_strategy
from repro_torch.training.train_step import TrainState
from torch_threads import one_torch_thread  # noqa: F401

WORLD = 4
TIMEOUT = 120


# ---------------------------------------------------------------------------
# the analytic terms against the reference
# ---------------------------------------------------------------------------

CELLS = [(a, s.name) for a in ARCH_NAMES for s in SHAPES
         if shape_applicable(get_config(a), s)[0]]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_analytic_terms_equal_reference(arch, shape):
    from repro.configs import SHAPES_BY_NAME as J_SHAPES
    from repro.configs import get_config as j_config
    from repro.launch import roofline as jrf
    tc, jc = get_config(arch), j_config(arch)
    ts, js = SHAPES_BY_NAME[shape], J_SHAPES[shape]
    assert trf.model_flops_estimate(tc, ts) == \
        jrf.model_flops_estimate(jc, js)
    for mb in (1, dryrun.TRAIN_MICROBATCHES[arch], 16):
        assert trf.trip_factor(tc, ts, mb) == jrf.trip_factor(jc, js, mb)
        for chips in (256, 512):
            for kv in (1, 2):
                assert trf.analytic_bytes_estimate(tc, ts, chips, mb, kv) \
                    == jrf.analytic_bytes_estimate(jc, js, chips, mb, kv)


def test_report_keys_equal_reference():
    from repro.launch import roofline as jrf
    kw = dict(arch="a", shape="s", mesh="m", strategy="x", chips=256,
              flops_per_device=1e12, bytes_per_device=2e9, bytes_model=1e9,
              collective_per_device=3e8, collective_breakdown={"count": 1},
              model_flops=1e14)
    got, want = trf.RooflineReport(**kw), jrf.RooflineReport(**kw)
    assert list(got.to_dict()) == list(want.to_dict())
    assert got.bound_time == max(got.t_compute, got.t_memory,
                                 got.t_collective)
    # the card's peaks, where the reference keeps its TPU's
    assert (got.peak_flops, got.hbm_bw, got.link_bw) == (989e12, 3.35e12,
                                                          450e9)
    assert (tmesh.PEAK_FLOPS_F32, tmesh.PEAK_FLOPS_TF32) == (67e12, 495e12)


# ---------------------------------------------------------------------------
# the op analysis
# ---------------------------------------------------------------------------

def _hand_flops(cfg, rows: int, tokens: int, keys: int, logits: int):
    """Matmul FLOPs of a dense GQA swiglu decoder: per layer the q/k/v/o
    projections and the MLP over ``rows * tokens`` tokens, the scores and
    values over ``keys``; the head over ``logits`` rows."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    n = rows * tokens
    layer = (2 * n * d * (H + 2 * KV) * hd + 2 * n * H * hd * d
             + 3 * 2 * n * d * cfg.d_ff + 4 * rows * H * tokens * keys * hd)
    return cfg.n_layers * layer + 2 * logits * d * cfg.vocab_size


def test_flops_equal_hand_count():
    cfg = t_smoke("qwen3-14b").replace(dtype="float32")
    assert cfg.family == "dense" and cfg.mlp_kind == "swiglu"
    model = build_model(cfg)
    B, S, T = 2, 16, 24
    params = param_shapes(cfg)
    cache = model.init_cache(B, T, "meta")
    with torch.no_grad():
        dec = analyze_step(model.decode_step, params,
                           torch.zeros(B, dtype=torch.int32), cache,
                           torch.full((B,), 5, dtype=torch.int32))
        pre = analyze_step(model.prefill, params,
                           torch.zeros(B, S, dtype=torch.int32), cache)
    assert math.isclose(dec.flops, _hand_flops(cfg, B, 1, T, B),
                        rel_tol=1e-9)
    assert math.isclose(pre.flops, _hand_flops(cfg, B, S, S, B),
                        rel_tol=1e-9)
    assert dec.collective_total == 0 and dec.temp_bytes > 0
    assert pre.bytes_accessed > dec.bytes_accessed > 0


def test_temp_bytes_track_what_the_step_holds():
    def step(x):
        a = x * 2                    # 4 KiB, dropped before b is made
        del a
        b = torch.empty(2048)        # 8 KiB
        c = x[:512] + 1              # 2 KiB; x, the input, is not counted
        return b, c, b.view(2, 1024)
    st = analyze_step(step, torch.zeros(1024))
    assert st.temp_bytes == 8192 + 2048
    assert st.flops == 0


def test_meta_takes_the_plain_route():
    B, H, KV, D, P, ps = 2, 4, 2, 8, 3, 4
    q = torch.empty(B, 1, H, D, device="meta")
    pool = torch.empty(16, ps * 2 * KV * D, device="meta")
    table = torch.empty(B, P, dtype=torch.int32, device="meta")
    lens = torch.empty(B, dtype=torch.int32, device="meta")
    before = kops.paged_decode_attention.launches
    out = kops.paged_decode_attention(q, pool, table, lens,
                                      tokens_per_page=ps, n_kv=KV, scale=1.0)
    assert out.is_meta and out.shape == (B, 1, H, D)
    assert kops.paged_decode_attention.launches == before
    x = torch.empty(1, 16, 2, 4, device="meta")
    y, h = kops.ssd_scan(x, torch.empty(1, 16, 2, device="meta"),
                         torch.empty(2, device="meta"),
                         torch.empty(1, 16, 1, 8, device="meta"),
                         torch.empty(1, 16, 1, 8, device="meta"), chunk=8)
    assert y.is_meta and y.shape == x.shape and h.shape == (1, 2, 4, 8)
    assert kops.paged_kv_write(pool, torch.empty(2, 2 * KV * D,
                                                 device="meta"),
                               table[:, 0], table[:, 0]) is pool
    assert build.plain_route(q) and build.plain_route(torch.zeros(1))


def test_unknown_device_still_raises():
    fake = SimpleNamespace(device=torch.device("xpu"), shape=(1, 1, 2, 8))
    assert not build.plain_route(fake)
    with pytest.raises(ValueError, match="no decode attention kernel"):
        kops.decode_attention(fake, None, None, None, scale=1.0)
    with pytest.raises(ValueError, match="no paged attention kernel"):
        kops.paged_decode_attention(fake, None, None, None,
                                    tokens_per_page=4, n_kv=1, scale=1.0)
    # the grouped GEMM's plain version reads the group sizes on the host:
    # it has no shape-only form, so meta raises there too
    x = torch.empty(4, 8, device="meta")
    with pytest.raises(ValueError, match="no grouped GEMM kernel"):
        kops.moe_gemm(x, torch.empty(2, 8, 8, device="meta"),
                      torch.empty(2, dtype=torch.int32, device="meta"))


# ---------------------------------------------------------------------------
# the stand-in mesh against a live gloo mesh
# ---------------------------------------------------------------------------

DECODE = ShapeConfig("decode", 32, 4, "decode")
TRAIN = ShapeConfig("train", 16, 8, "train")
COLLECTIVE_CASES = (("qwen3-moe-235b-a22b", DECODE, "crosspool"),
                    ("qwen3-14b", TRAIN, "train"))


def _case_args(strategy, cfg, shape, device):
    """The step and its arguments at this rank's shard shapes on
    ``device`` (zeros: the bytes a collective moves do not depend on
    values)."""
    params = dryrun.local_params(strategy, device)
    for p in (v for v in _leaves(params)):
        p.zero_()
    specs = dryrun.input_specs(cfg, shape)
    if shape.kind == "train":
        cell = dryrun.build_train_cell(cfg, shape, strategy)
        state = TrainState(params, cell.optimizer.init(params), None)
        batch = {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
                 for k, v in specs.items()}
        return cell.step, (state, cell.local_batch(batch))
    step = dryrun.build_serve_cell(cfg, shape, strategy)
    cache = dryrun.local_cache(strategy, shape.global_batch, shape.seq_len,
                               device)
    tokens = dryrun.local_rows(strategy, torch.zeros(
        shape.global_batch, dtype=torch.int32, device=device))
    return step, (params, tokens, cache, torch.full(
        tokens.shape, 5, dtype=torch.int32, device=device))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _worker(rank: int, tmp: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            rank=rank, world_size=WORLD)
    out = []
    for arch, shape, strat in COLLECTIVE_CASES:
        cfg = t_smoke(arch).replace(dtype="float32")
        mesh = Mesh((2, 2), ("data", "model"), live=True)
        st = make_strategy(strat, mesh, cfg, shape)
        step, args = _case_args(st, cfg, shape, "cpu")
        mesh.counted = {}
        with torch.set_grad_enabled(shape.kind == "train"):
            step(*args)
        out.append(dict(mesh.counted))
    torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def test_stand_in_bytes_equal_a_live_mesh(tmp_path):
    tmp = str(tmp_path)
    ctx = mp.start_processes(_worker, args=(tmp,), nprocs=WORLD,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                pytest.fail(f"the ranks did not finish in {TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    live = [torch.load(os.path.join(tmp, f"out{r}.pt")) for r in range(WORLD)]
    for i, (arch, shape, strat) in enumerate(COLLECTIVE_CASES):
        cfg = t_smoke(arch).replace(dtype="float32")
        for rank in range(WORLD):
            stand = Mesh((2, 2), ("data", "model")).stand_in(rank)
            st = make_strategy(strat, stand, cfg, shape)
            step, args = _case_args(st, cfg, shape, "meta")
            with torch.set_grad_enabled(shape.kind == "train"):
                stats = analyze_step(step, *args, mesh=stand)
            got = {k: v for k, v in stats.collective_bytes.items() if v}
            got["count"] = stats.coll_count
            assert got == live[rank][i], (arch, rank)
            assert got["count"] > 0
        if shape.kind == "train":
            assert live[0][i].get("reduce-scatter", 0) > 0


# ---------------------------------------------------------------------------
# the dry-run's roofline and the perf hillclimb
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape", [("qwen3-14b", "decode_32k"),
                                        ("mamba2-130m", "train_4k")])
def test_run_cell_records_a_finite_roofline(arch, shape, tmp_path):
    rec = dryrun.run_cell(arch, shape, verbose=False)
    assert rec["ok"] and rec["analyze_s"] >= 0
    r = rec["roofline"]
    for key in ("flops_per_device", "bytes_per_device", "bytes_model",
                "collective_per_device", "t_compute", "t_memory",
                "t_collective", "roofline_fraction"):
        assert math.isfinite(r[key]) and r[key] > 0, key
    assert rec["memory"]["temp_bytes"] > 0
    assert r["chips"] == 256 and r["strategy"] == rec["strategy"]
    path = tmp_path / "cells.jsonl"
    path.write_text(__import__("json").dumps(rec) + "\n")
    table = report.roofline_table(report.load(str(path)))
    assert arch in table and r["dominant"] in table


def test_uneven_microbatches_are_counted_padded():
    """llama3-405b's 16 microbatches of 16 rows do not split over the
    multi-pod mesh's 32 batch ranks: the count pads the batch to a row a
    rank, as the reference's partitioner pads it; the single-pod mesh's
    16 ranks take the cell's own batch."""
    cfg, shape = get_config("llama3-405b"), SHAPES_BY_NAME["train_4k"]
    for multi_pod, want in ((False, 256), (True, 512)):
        mesh = tmesh.make_production_mesh(multi_pod=multi_pod).stand_in(0)
        st = make_strategy("train", mesh, cfg, shape)
        assert dryrun.padded_batch(st, 16) == want
        assert dryrun.padded_batch(st, 8) == 256


def test_uneven_cell_is_counted_through_its_own_padding():
    """The op analysis runs the live cell's ``local_batch``, which pads a
    microbatch whose rows do not split over the batch ranks: qwen3-moe's
    smoke cell at 10 rows in 2 microbatches over (4, 1) counts the FLOPs
    and the collectives of the same cell at 16 rows (the real rows'
    count is the host's: it adds no collective)."""
    from dataclasses import replace
    from repro_torch.sharding.strategies import PerfOpts
    cfg = t_smoke("qwen3-moe-235b-a22b")
    mesh = tmesh.Mesh((4, 1), ("data", "model")).stand_in(0)
    stats = {}
    for rows in (10, 16):
        shape = replace(SHAPES_BY_NAME["train_4k"], seq_len=16,
                        global_batch=rows)
        st = make_strategy("train", mesh, cfg, shape,
                           PerfOpts(microbatches=2))
        assert dryrun.padded_batch(st, 2) == 16
        stats[rows] = dryrun.analyze_cell(cfg, shape, st)
    assert stats[10].flops == stats[16].flops
    assert stats[10].coll_count == stats[16].coll_count


def test_perf_runs_baseline_and_a_variant(tmp_path):
    out = tmp_path / "perf.jsonl"
    base = perf.run_variant("qwen3-14b", "decode_32k", "baseline",
                            multi_pod=False, out=str(out))
    f8 = perf.run_variant("qwen3-14b", "decode_32k", "kv_f8",
                          multi_pod=False, out=str(out))
    assert base["ok"] and f8["ok"] and f8["variant"] == "kv_f8"
    assert f8["roofline"]["bytes_model"] < base["roofline"]["bytes_model"]
    assert f8["memory"]["argument_bytes"] < base["memory"]["argument_bytes"]
    assert len(out.read_text().splitlines()) == 2
    assert to_meta([torch.zeros(1)])[0].is_meta
