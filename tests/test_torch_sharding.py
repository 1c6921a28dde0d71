"""The port's sharding layer against the JAX package, in one process.

Rules: for every architecture x shape x strategy x mesh (the two
production meshes and (2,4), (4,2), (1,4), (1,1)), every param and cache
leaf's partition spec, the strategy's properties and the name
``make_strategy("auto")`` picks equal the reference's with ``==``; the
reference runs on ``jax.sharding.AbstractMesh`` (shapes, no devices), the
port on its shape-only ``Mesh``.  ``shard_shape`` equals
``NamedSharding(...).shard_shape``.  The dry-run's per-device argument
bytes equal the sum of the reference leaves' shard shapes x itemsize
under the reference's rules, on both production meshes; skipped cells
carry the same reason.  ``local_slices`` equals JAX's
``devices_indices_map`` on an 8-device (2,4) mesh (computed in a
subprocess with forced host devices, as ``tests/test_sharding.py``
re-execs).  The hooks seam: the identity hooks change no bit, and the
reference's hook sites are reached.
"""
import json
import math
import os
import subprocess
import sys
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch
from jax._src.named_sharding import DuplicateSpecError
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import ARCH_NAMES, SHAPES_BY_NAME, get_config
from repro.configs import shape_applicable as j_applicable
from repro.models import build_model as j_build_model
from repro.sharding.strategies import PerfOpts as JPerf
from repro.sharding.strategies import make_strategy as j_make_strategy
from repro.training import compression as j_compression
from repro.training.optimizer import AdamW as JAdamW
from repro_torch.configs import SHAPES_BY_NAME as T_SHAPES
from repro_torch.configs import get_config as t_config
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.launch.op_analysis import ModuleStats
from repro_torch.models.hooks import IDENTITY_HOOKS, Hooks
from repro_torch.models.model import build_model as t_build_model
from repro_torch.sharding.spec import local_slices, shard_shape
from repro_torch.sharding.strategies import PerfOpts, make_strategy
from torch_threads import one_torch_thread  # noqa: F401

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "2x4": ((2, 4), ("data", "model")),
    "4x2": ((4, 2), ("data", "model")),
    "1x4": ((1, 4), ("data", "model")),
    "1x1": ((1, 1), ("data", "model")),
}
STRATEGIES = ("auto", "train", "monolithic", "crosspool")
#: the levers that change a rule: the decode KV axes, the expert axis
PERFS = ((None, None), (JPerf(moe_a2a=True), PerfOpts(moe_a2a=True)),
         (JPerf(kv_seq_override=("data", "model")),
          PerfOpts(kv_seq_override=("data", "model"))),
         (JPerf(kv_seq_override=("model",)),
          PerfOpts(kv_seq_override=("model",))))
PROPS = ("name", "bax", "pool", "tp_all", "model_size", "batch_sharded",
         "kv_seq_axes", "type_ii")


def _paths(tree):
    """{"/"-joined path: leaf} of a JAX tree (the reference's path_str)."""
    from repro.sharding.spec import path_str
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {path_str(p): leaf for p, leaf in flat}


def _t_paths(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_t_paths(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = v
    return out


def _jspec(p):
    return tuple(p)


def _shard_or_refused(fn):
    """A shard shape, or "refused" where the spec names an axis twice
    (the KV override over ``data`` beside a batch over ``data``)."""
    try:
        return tuple(fn())
    except (ValueError, DuplicateSpecError):
        return "refused"


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_rules_equal_reference(arch):
    """Every rule, property and strategy name, over every shape x
    strategy x mesh x lever, equals the JAX package's (``==``), and so
    does every leaf's shard shape."""
    j_cfg, t_cfg = get_config(arch), t_config(arch)
    j_params = jax.eval_shape(
        lambda: j_build_model(j_cfg).init(jax.random.PRNGKey(0)))
    j_pp = _paths(j_params)
    t_pp = _t_paths(dryrun.param_shapes(t_cfg))
    assert sorted(j_pp) == sorted(t_pp)        # JAX flattens keys sorted
    assert all(tuple(j_pp[k].shape) == tuple(t_pp[k].shape) for k in j_pp)
    checked = 0
    for shape_name, j_shape in SHAPES_BY_NAME.items():
        # a cell-sized cache would be a 2^35-element tensor on the
        # reference's side too: the rules read shapes, so a short one does
        B, T = j_shape.global_batch, 64
        j_cache = _paths(j_build_model(j_cfg).cache_specs(B, T))
        t_cache = _t_paths(t_build_model(t_cfg).cache_specs(B, T))
        assert sorted(j_cache) == sorted(t_cache)
        t_shape = T_SHAPES[shape_name]
        for mesh_name, (sizes, names) in MESHES.items():
            am = AbstractMesh(sizes, names)
            tm = Mesh(sizes, names)
            for strat in STRATEGIES:
                for j_perf, t_perf in PERFS:
                    js = j_make_strategy(strat, am, j_cfg, j_shape, j_perf)
                    ts = make_strategy(strat, tm, t_cfg, t_shape, t_perf)
                    where = (arch, shape_name, mesh_name, strat, t_perf)
                    for prop in PROPS:
                        assert getattr(js, prop) == getattr(ts, prop), \
                            (where, prop)
                    assert js._dpa_axes() == ts._dpa_axes(), where
                    for j_tree, t_tree, j_rules, t_rules in (
                            (j_pp, t_pp, js.param_rules(), ts.param_rules()),
                            (j_cache, t_cache, js.cache_rules(),
                             ts.cache_rules())):
                        for path, leaf in j_tree.items():
                            shp = tuple(leaf.shape)
                            jp = j_rules.spec_for(am, path, shp)
                            tp = t_rules.spec_for(tm, path, shp)
                            assert _jspec(jp) == tuple(tp), (where, path)
                            assert _shard_or_refused(
                                lambda: NamedSharding(am, jp).shard_shape(
                                    shp)) == _shard_or_refused(
                                lambda: shard_shape(tm, shp, tp)), \
                                (where, path)
                            checked += 1
                    for nd in (1, 2, 3):
                        assert _jspec(js.input_sharding(nd).spec) == \
                            tuple(ts.input_sharding(nd))
    assert checked >= len(SHAPES_BY_NAME) * len(MESHES) * len(STRATEGIES) \
        * len(PERFS) * len(j_pp)


def _ref_argument_bytes(arch, shape_name, multi_pod):
    """The reference's per-device argument bytes of a cell under its own
    rules (``dryrun.py`` ``build_*_cell``'s arguments), from abstract
    shapes: the reference's dry-run module itself is not imported (it
    sets a 512-device XLA flag at import)."""
    cfg, shape = get_config(arch), SHAPES_BY_NAME[shape_name]
    sizes, names = MESHES["2x16x16" if multi_pod else "16x16"]
    am = AbstractMesh(sizes, names)
    st = j_make_strategy("auto", am, cfg, shape)
    model = j_build_model(cfg)
    params = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))

    def nbytes(tree, specs):
        leaves = jax.tree.leaves(tree)
        shardings = jax.tree.leaves(
            specs, is_leaf=lambda x: isinstance(x, NamedSharding))
        assert len(leaves) == len(shardings)
        return sum(math.prod(sh.shard_shape(leaf.shape)) * leaf.dtype.itemsize
                   for leaf, sh in zip(leaves, shardings))

    def spec_bytes(shape_, dtype, spec):
        return math.prod(NamedSharding(am, spec).shard_shape(shape_)) \
            * np.dtype(dtype).itemsize

    B, S = shape.global_batch, shape.seq_len
    dt = np.float32 if cfg.dtype == "float32" else jax.numpy.bfloat16
    total = nbytes(params, st.params_shardings(params))
    if shape.kind in ("train", "prefill"):
        txt = S
        if cfg.frontend == "vision_patches":
            txt = S - cfg.frontend_tokens
            total += spec_bytes((B, cfg.frontend_tokens, cfg.d_model), dt,
                                st.input_sharding(3).spec)
        if cfg.family == "audio":
            total += spec_bytes((B, cfg.encoder_seq, cfg.d_model), dt,
                                st.input_sharding(3).spec)
        total += spec_bytes((B, txt), np.int32, st.input_sharding(2).spec)
    else:
        total += spec_bytes((B,), np.int32, st.input_sharding(1).spec)
        total += spec_bytes((), np.int32, st.scalar_sharding().spec)
    if shape.kind == "train":
        opt = JAdamW(moment_dtype="bfloat16" if cfg.param_counts()["total"]
                     > 5e10 else "float32")
        state = jax.eval_shape(lambda: opt.init(params))
        total += spec_bytes((), np.int32, st.scalar_sharding().spec)
        total += nbytes(state.m, st.params_shardings(params))
        total += nbytes(state.v, st.params_shardings(params))
        if st.perf.compress_grads:
            ef = jax.eval_shape(
                lambda: j_compression.init_error_feedback(params))
            total += nbytes(ef, st.params_shardings(params))
        return total
    cache = model.cache_specs(B, S, kv_dtype=st.perf.kv_dtype)
    return total + nbytes(cache, st.cache_shardings(cache))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_dryrun_bytes_equal_reference_rules(arch, monkeypatch):
    """``memory.argument_bytes`` of every cell on both production meshes
    equals the reference rules' per-device bytes; skips agree.  (The
    step's count on ``meta`` is stubbed: ``test_torch_roofline.py``
    holds it.)"""
    monkeypatch.setattr(dryrun, "analyze_cell",
                        lambda *a: ModuleStats(0.0, {}, 0, 0))
    for multi_pod in (False, True):
        for shape_name in SHAPES_BY_NAME:
            rec = dryrun.run_cell(arch, shape_name, multi_pod=multi_pod,
                                  verbose=False)
            ok, why = j_applicable(get_config(arch),
                                   SHAPES_BY_NAME[shape_name])
            assert rec["mesh"] == ("pod2x16x16" if multi_pod else "pod16x16")
            if not ok:
                assert rec["skipped"] and rec["reason"] == why
                assert not rec["ok"]
                continue
            assert rec["ok"]
            want = _ref_argument_bytes(arch, shape_name, multi_pod)
            assert rec["memory"]["argument_bytes"] == want, \
                (shape_name, multi_pod)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-1.2b"])
def test_ssm_pool_axes_on_the_production_mesh(arch, multi_pod):
    """At published widths ``in_proj``'s columns (3352, 8384) do not
    split over the weights pool, while ``conv_w``'s channels or
    ``out_proj``'s rows do: the crosspool step gathers and reduces the
    SSM over the weights pool, data x model (on two pods too: the pool
    is a pod's)."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    st = make_strategy("crosspool", mesh, t_config(arch),
                       T_SHAPES["decode_32k"])
    assert st._ssm_split_axes() == ()
    assert st._ssm_pool_axes() == ("data", "model")
    assert not st.ssm_heads


def test_production_mesh_has_no_devices():
    m = make_production_mesh(multi_pod=True)
    assert m.shape == {"pod": 2, "data": 16, "model": 16}
    assert m.coord is None and m.size == 512
    assert make_production_mesh().axis_names == ("data", "model")


_SLICES_SCRIPT = r"""
import json, sys
import jax
from dataclasses import replace
from repro.configs import ARCH_NAMES, SHAPES_BY_NAME, get_smoke_config
from repro.models import build_model
from repro.sharding.strategies import make_strategy
from repro.sharding.spec import path_str
assert len(jax.devices()) == 8
mesh = jax.make_mesh((2, 4), ("data", "model"))
coords = {d.id: [int(i) for i in idx]
          for idx, d in __import__("numpy").ndenumerate(mesh.devices)}
shape = replace(SHAPES_BY_NAME["decode_32k"], seq_len=16, global_batch=8)
out = []
for arch in ARCH_NAMES:
    cfg = get_smoke_config(arch).replace(dtype="float32")
    model = build_model(cfg)
    params = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    cache = model.cache_specs(8, 16)
    for strat in ("train", "monolithic", "crosspool"):
        st = make_strategy(strat, mesh, cfg, shape)
        for kind, tree, shs in (("params", params, st.params_shardings(params)),
                                ("cache", cache, st.cache_shardings(cache))):
            flat, _ = jax.tree_util.tree_flatten_with_path(tree)
            sh_flat = jax.tree.leaves(shs, is_leaf=lambda x: hasattr(x, "spec"))
            for (p, leaf), sh in zip(flat, sh_flat):
                idx = sh.devices_indices_map(tuple(leaf.shape))
                out.append([arch, strat, kind, path_str(p), list(leaf.shape),
                            [[coords[d.id], [[s.start, s.stop] for s in sl]]
                             for d, sl in idx.items()]])
json.dump(out, sys.stdout)
"""


def test_local_slices_equal_devices_indices_map():
    """For every device of an 8-device (2,4) mesh, the port's
    ``local_slices`` of every smoke param and cache leaf under the three
    strategies equals JAX's ``devices_indices_map``."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src"),
         env.get("PYTHONPATH", "")])
    r = subprocess.run([sys.executable, "-c", _SLICES_SCRIPT], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    rows = json.loads(r.stdout)
    mesh = Mesh((2, 4), ("data", "model"))
    shape = replace(T_SHAPES["decode_32k"], seq_len=16, global_batch=8)
    n = 0
    strategies = {}
    for arch, strat, kind, path, leaf_shape, per_device in rows:
        key = (arch, strat)
        if key not in strategies:
            cfg = t_smoke(arch).replace(dtype="float32")
            strategies[key] = make_strategy(strat, mesh, cfg, shape)
        st = strategies[key]
        rules = st.param_rules() if kind == "params" else st.cache_rules()
        spec = rules.spec_for(mesh, path, leaf_shape)
        for coord, want in per_device:
            got = local_slices(mesh, leaf_shape, spec, coord)
            got = [[s.start, s.stop] for s in got]
            want = [[0 if a is None else a, dim if b is None else b]
                    for (a, b), dim in zip(want, leaf_shape)]
            assert got == want, (arch, strat, kind, path, coord)
            n += 1
    assert len({(r[0], r[1]) for r in rows}) == 30 and n > 1000


def _seam_inputs(cfg, B=2, S=8):
    g = torch.Generator().manual_seed(1)
    tok = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
    kw = {}
    if cfg.frontend == "vision_patches":
        kw["embeddings"] = torch.randn(B, cfg.frontend_tokens, cfg.d_model,
                                       generator=g)
    if cfg.family == "audio":
        kw["encoder_frames"] = torch.randn(B, cfg.encoder_seq, cfg.d_model,
                                           generator=g)
    return tok, kw, S + (cfg.frontend_tokens if "embeddings" in kw else 0)


def _run(model, params, tok, kw, S, hooks):
    cache = model.init_cache(tok.shape[0], 32, "cpu")
    args = {} if hooks is None else {"hooks": hooks}
    l0, cache = model.prefill(params, tok, cache, **kw, **args)
    l1, cache = model.decode_step(params, l0.argmax(-1), cache, S, **args)
    return [l0, l1] + [cache[k] for k in sorted(cache)]


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_identity_hooks_change_no_bit(arch):
    """prefill + decode_step under ``IDENTITY_HOOKS``, under no hooks
    argument, and under counting identity hooks give the same bits (every
    cache leaf too); the counters show the reference's hook sites are
    reached (``act``, ``kv``, ``logits``, the pool boundary, ...)."""
    cfg = t_smoke(arch).replace(dtype="float32")
    model = t_build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    tok, kw, S = _seam_inputs(cfg)
    calls = {}

    def counting(name):
        def f(x):
            calls[name] = calls.get(name, 0) + 1
            return x
        return f

    names = ("act", "attn_q", "attn_out", "kv", "kv_state", "boundary_in",
             "boundary_out", "ffn_hidden", "moe_inputs", "moe_hidden",
             "logits")

    def down(h, w):
        calls["ffn_down"] = calls.get("ffn_down", 0) + 1
        return h @ w
    counted = Hooks(**{n: counting(n) for n in names}, ffn_down=down)
    base = _run(model, params, tok, kw, S, None)
    for hooks in (IDENTITY_HOOKS, counted):
        got = _run(model, params, tok, kw, S, hooks)
        assert all(torch.equal(a, b) for a, b in zip(base, got))
    want = {"act", "logits"}
    if cfg.family in ("ssm", "hybrid"):
        want |= {"kv_state"}
    if cfg.family != "ssm":
        want |= {"kv", "attn_out", "boundary_in", "boundary_out"}
    if cfg.is_moe:
        want |= {"moe_inputs", "moe_hidden"}
    if not cfg.is_moe or cfg.n_shared_experts:
        if cfg.family != "ssm":
            want |= {"ffn_hidden", "ffn_down"}
    assert want <= set(calls), (want - set(calls))
