"""The port's sharding layer on four ``gloo`` processes (CPU), against the
JAX package on the same numbers.

Each job runs in 4 ranks started with ``torch.multiprocessing`` (spawn;
rendezvous through a file under ``tmp_path``, so parallel test workers
never share a port) and is bounded by ``TIMEOUT`` seconds: a hung
collective fails the test instead of eating the suite's time.  Inputs
come from numpy seeds; params from the reference's own init, bridged.

* collectives: the sequence-sharded GQA decode on a (2,2) mesh
  (``kv_axes=("model",)``, batch over ``data``) and over the whole mesh
  for B = 1 and for B = 2 with slices that hold no token of a row (the
  LSE combine of normalised slices), against
  ``repro.kernels.ref.decode_attention`` at 1e-5; the MLA one against the
  reference test's dense oracle at 1e-5;
  ``make_moe_a2a`` (experts over ``data``, f over ``model``) against
  ``repro.models.moe.apply_moe`` at ``capacity_factor=8.0``: out 2e-5,
  aux 1e-5 relative; ``f8_dispatch`` within the bound of the reference's
  fp8 KV test (``err < 0.1 * scale + 0.5``);
* the split argmax over ``model`` (ties across shards go to the lowest
  global id, as ``torch.argmax``'s);
* the sharded steps (``launch/dryrun.py`` ``build_serve_cell``): the
  smoke minicpm3-4b (Type II), qwen3-moe (with and without ``moe_a2a``;
  also with a shared expert) and zamba2-1.2b, crosspool decode on (1,4)
  and (2,2), monolithic prefill on (4,1), and monolithic DP attention
  (2 KV heads under a model axis of 4) for zamba2 and whisper on (1,4);
  then every arch under both strategies, prefill and decode, on (2,2),
  (1,4) (split heads, DP attention) and (4,1) (``SERVE_CASES``): the
  logits gathered over rows and vocabulary shards against the JAX
  package's single-device ``decode_step`` / ``prefill`` at 2e-4
  (``tests/test_sharding.py:155-156``); every leaf the step places by
  the rules holds exactly the rules' shard on its rank (every param
  leaf, values and bytes; the cache's KV and SSM-state heads); the cache
  bytes are the step's cache rules', and under crosspool (the
  sequence of ``k`` / ``v`` / ``latent`` / ``rope`` / ``gk`` / ``gv``
  split over ``kv_seq_axes``, prefill and decode alike) those leaves'
  bytes are the reference table's (``dryrun.seq_leaf_bytes``);
  ``dryrun.greedy`` equals the gathered argmax;
* crosspool hand-offs (``HANDOFFS``): a prefill writes this rank's slice
  of the sequence into an empty local cache, then decode steps continue
  from it, every step's logits within 2e-4 of the JAX package's
  single-device ``prefill`` + ``decode_step``; one request (B = 1) over
  the whole mesh leaves a slice that holds no token of the row;
* over a one-rank group the serve hooks leave the steps bit for bit as
  without hooks, for every family;
* a checkpoint written under (2,2) restores onto (4,1) with every leaf
  equal (``test_elastic_reshard_across_meshes``).
"""
import functools
import os
import time
from dataclasses import replace

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
from repro_torch.models.model import build_model as t_build_model
from repro_torch.sharding import moe_a2a
from repro_torch.sharding.collectives import AxisGroup
from repro_torch.sharding.seq_attention import (make_seq_decode_attn,
                                                make_seq_mla_decode_attn)
from repro_torch.sharding.spec import (local_slices, path_str, shard_shape,
                                       shard_tree, tree_bytes)
from repro_torch.sharding.strategies import (KV_HEAD_LEAVES,
                                             SEQ_SPLIT_LEAVES,
                                             SSM_HEAD_LEAVES, PerfOpts,
                                             make_strategy)
from repro_torch.training import checkpoint as ckpt
from torch_threads import one_torch_thread  # noqa: F401

WORLD = 4
TIMEOUT = 120           # seconds a job's four ranks may take, start to end
STEP_TOL = dict(rtol=2e-4, atol=2e-4)


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


def _run(tmp_path, job: str, payload) -> list:
    """Run ``job`` on 4 ranks; returns each rank's result."""
    tmp = str(tmp_path)
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


def _rows(mesh, x, axes):
    return x[local_slices(mesh, x.shape, (axes,))]


def _collectives_job(p):
    out = {}
    mesh = Mesh((2, 2), ("data", "model"), live=True)
    # GQA, batch over data, KV sequence over model
    q, k, v, lengths = (torch.from_numpy(p["gqa"][n])
                        for n in ("q", "k", "v", "lengths"))
    fn = make_seq_decode_attn(mesh, ("model",), ("data",), p["gqa"]["scale"])
    kl = k[local_slices(mesh, k.shape, ("data", "model"))]
    vl = v[local_slices(mesh, v.shape, ("data", "model"))]
    out["gqa"] = fn(_rows(mesh, q, "data"), kl, vl,
                    _rows(mesh, lengths, "data"))
    # B = 1: the KV pooled over the whole mesh
    q, k, v, lengths = (torch.from_numpy(p["pool"][n])
                        for n in ("q", "k", "v", "lengths"))
    axes = ("data", "model")
    fn = make_seq_decode_attn(mesh, axes, None, p["pool"]["scale"])
    sl = local_slices(mesh, k.shape, (None, axes))
    out["pool"] = fn(q, k[sl], v[sl], lengths)
    # B = 2 over the whole mesh, slices that hold no token of a row
    q, k, v, lengths = (torch.from_numpy(p["empty"][n])
                        for n in ("q", "k", "v", "lengths"))
    fn = make_seq_decode_attn(mesh, axes, None, p["empty"]["scale"])
    sl = local_slices(mesh, k.shape, (None, axes))
    out["empty"] = fn(q, k[sl], v[sl], lengths)
    # MLA: latent sequence over model
    q_lat, q_rope, latent, rope, lengths = (
        torch.from_numpy(p["mla"][n])
        for n in ("q_lat", "q_rope", "latent", "rope", "lengths"))
    fn = make_seq_mla_decode_attn(mesh, ("model",), ("data",),
                                  p["mla"]["scale"])
    spec = ("data", "model")
    out["mla"] = fn(_rows(mesh, q_lat, "data"), _rows(mesh, q_rope, "data"),
                    latent[local_slices(mesh, latent.shape, spec)],
                    rope[local_slices(mesh, rope.shape, spec)],
                    _rows(mesh, lengths, "data"))
    # the expert all-to-all: experts over data, f over model
    cfg, moe_p, x = p["a2a"]["cfg"], p["a2a"]["params"], p["a2a"]["x"]
    local = {"router": moe_p["router"]}
    for name in ("wg", "wu", "wd"):
        spec = ("data", None, "model") if name != "wd" \
            else ("data", "model", None)
        w = moe_p[name]
        local[name] = w[local_slices(mesh, w.shape, spec)]
    for f8 in (False, True):
        a2a = moe_a2a.make_moe_a2a(mesh, cfg, expert_axis="data",
                                tp_axis="model", batch_axes=("data",),
                                capacity_mult=8.0, f8_dispatch=f8)
        out[f"a2a_f8={f8}"] = a2a(local, _rows(mesh, x, "data"))
    # the split argmax over model: this rank's vocabulary shard
    x = torch.from_numpy(p["argmax"])
    out["argmax"] = AxisGroup(mesh, "model").argmax(
        x[local_slices(mesh, x.shape, (None, "model"))])
    out["coord"] = mesh.coord
    return out


def _steps_job(p):
    out = []
    for case in p["cases"]:
        cfg, shape = case["cfg"], case["shape"]
        mesh = Mesh(case["mesh"], ("data", "model"), live=True)
        st = make_strategy(case["strategy"], mesh, cfg, shape, case["perf"])
        params = dryrun.shard_params(st, case["params"])
        cache = dryrun.shard_cache(st, case["cache"])
        step = dryrun.build_serve_cell(cfg, shape, st)
        tokens = dryrun.local_rows(st, case["tokens"])
        extra = {k: dryrun.local_rows(st, v)
                 for k, v in case.get("extra", {}).items()}
        if shape.is_decode:
            logits, cache = step(params, tokens, cache,
                                 dryrun.local_rows(st, case["lengths"]))
        else:
            logits, cache = step(params, tokens, cache, **extra)
        # every leaf the step places holds its shard: the rules' own for
        # the params, the sequence-split and the head-split caches
        placed = []
        for kind, whole, local, rules, step_rules in (
                ("params", case["params"], params, st.param_rules(),
                 st.param_rules()),
                ("cache", case["cache"], cache, st.cache_rules(),
                 st.step_cache_rules())):
            for path, leaf in _flat(whole):
                spec = step_rules.spec_for(mesh, path, leaf.shape)
                if all(a is None for a in spec):
                    continue
                by_rule = kind == "params" or (
                    st.seq_split and path in SEQ_SPLIT_LEAVES) or (
                    st.head_split and path in KV_HEAD_LEAVES) or (
                    st.ssm_heads and path in SSM_HEAD_LEAVES)
                if by_rule:
                    spec = rules.spec_for(mesh, path, leaf.shape)
                placed.append((kind, path, tuple(_get(local, path).shape),
                               shard_shape(mesh, leaf.shape, spec),
                               tuple(spec)))
        # the rules' cut of every param leaf, by value
        rules = st.param_rules()
        cut = all(torch.equal(
            _get(params, path),
            leaf[local_slices(mesh, leaf.shape,
                              rules.spec_for(mesh, path, leaf.shape))])
            for path, leaf in _flat(case["params"]))
        vocab = logits.shape[-1]
        out.append(dict(logits=logits, coord=mesh.coord, placed=placed,
                        seq_split=st.seq_split, a2a=st.a2a,
                        head_split=st.head_split, type_ii=st.type_ii,
                        ssm_heads=st.ssm_heads,
                        ssm_pool=st._ssm_pool_axes(),
                        cache_bytes=dryrun.resident_bytes(cache),
                        cache_rule_bytes=tree_bytes(
                            st.step_cache_rules(), mesh, case["cache"]),
                        seq_bytes=_seq_bytes(cache),
                        seq_rule_bytes=dryrun.seq_leaf_bytes(st,
                                                             case["cache"]),
                        rows=dryrun.local_rows(st, torch.arange(
                            case["tokens"].shape[0])),
                        vocab0=0 if vocab == cfg.vocab_size
                        else mesh.index("model") * vocab,
                        greedy=dryrun.greedy(st, logits), cut=cut,
                        param_bytes=dryrun.resident_bytes(params),
                        rule_bytes=tree_bytes(st.param_rules(), mesh,
                                              case["params"]),
                        bytes=dryrun.resident_bytes(params)
                        + dryrun.resident_bytes(cache)))
    out.extend(_handoff(case) for case in p["handoffs"])
    return out


def _seq_bytes(cache) -> int:
    """A rank's bytes of its cache's sequence-split leaves."""
    return dryrun.resident_bytes({k: v for k, v in cache.items()
                                  if k in SEQ_SPLIT_LEAVES})


def _handoff(case):
    """A crosspool prefill into an empty local cache (this rank's slice of
    the sequence), then ``HANDOFF_STEPS`` decode steps from it: every
    step's logits, the rank's sequence-split bytes beside the reference
    table's, and the tokens of the row its slice holds at the end."""
    cfg, tokens = case["cfg"], case["tokens"]
    n = tokens.shape[0]
    mesh = Mesh(case["mesh"], ("data", "model"), live=True)
    st_pre, st_dec = (make_strategy("crosspool", mesh, cfg, replace(
        T_SHAPES[name], seq_len=MAX_LEN, global_batch=n))
        for name in ("prefill_32k", "decode_32k"))
    params = dryrun.shard_params(st_pre, case["params"])
    cache = dryrun.local_cache(st_pre, n, MAX_LEN, "cpu")
    extra = {k: dryrun.local_rows(st_pre, v) for k, v in case["extra"].items()}
    first, cache = dryrun.build_serve_cell(cfg, st_pre.shape, st_pre)(
        params, dryrun.local_rows(st_pre, tokens), cache, **extra)
    logits = [first]
    step = dryrun.build_serve_cell(cfg, st_dec.shape, st_dec)
    lengths = dryrun.local_rows(st_dec, torch.full((n,), SEQ,
                                                   dtype=torch.int32))
    for nxt in case["next"]:
        got, cache = step(params, dryrun.local_rows(st_dec, nxt), cache,
                          lengths)
        logits.append(got)
        lengths = lengths + 1
    meta = t_build_model(cfg).cache_specs(n, MAX_LEN)
    t_loc = next(v.shape[2] for k, v in cache.items()
                 if k in SEQ_SPLIT_LEAVES)
    offset = mesh.index(st_dec.kv_seq_axes) * t_loc
    vocab = first.shape[-1]
    return dict(logits=logits, coord=mesh.coord,
                rows=dryrun.local_rows(st_dec, torch.arange(n)),
                vocab0=0 if vocab == cfg.vocab_size
                else mesh.index("model") * vocab,
                seq_split=(st_pre.seq_split, st_dec.seq_split),
                same_place=all(
                    st_pre.step_cache_rules().spec_for(mesh, k, v.shape)
                    == st_dec.step_cache_rules().spec_for(mesh, k, v.shape)
                    for k, v in meta.items()),
                seq_bytes=_seq_bytes(cache),
                seq_rule_bytes=dryrun.seq_leaf_bytes(st_dec, meta),
                whole_seq_bytes=_seq_bytes(meta),
                cache_bytes=dryrun.resident_bytes(cache),
                cache_rule_bytes=tree_bytes(st_dec.step_cache_rules(), mesh,
                                            meta),
                held=max(0, min(SEQ + len(case["next"]) - offset, t_loc)))


def _ckpt_job(p):
    cfg, params, tmp = p["cfg"], p["params"], p["dir"]
    shape = T_SHAPES["train_4k"]
    mesh_a = Mesh((2, 2), ("data", "model"), live=True)
    st_a = make_strategy("train", mesh_a, cfg, shape)
    rules_a = st_a.param_rules()
    local_a = shard_tree(rules_a, mesh_a, params)
    path = ckpt.save(local_a, 1, tmp, specs=rules_a.tree_specs(mesh_a, params),
                     mesh=mesh_a)
    mesh_b = Mesh((4, 1), ("data", "model"), live=True)
    st_b = make_strategy("train", mesh_b, cfg, shape)
    rules_b = st_b.param_rules()
    restored, step = ckpt.restore(tmp, target_tree=params, rules=rules_b,
                                  mesh=mesh_b)
    shapes = {path: (tuple(_get(restored, path).shape),
                     shard_shape(mesh_b, leaf.shape,
                                 rules_b.spec_for(mesh_b, path, leaf.shape)))
              for path, leaf in _flat(params)}
    expect = shard_tree(rules_b, mesh_b, params)
    equal = all(torch.equal(_get(restored, k), _get(expect, k))
                for k, _ in _flat(params))
    return dict(step=step, path=path, shapes=shapes, equal=equal,
                rank=mesh_b.rank)


JOBS = {"collectives": _collectives_job, "steps": _steps_job,
        "ckpt": _ckpt_job}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield path_str(prefix + (k,)), v


def _get(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


# ---------------------------------------------------------------------------
# the reference (imported here only: the ranks import no JAX)
# ---------------------------------------------------------------------------

def _np_tree(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config
    from repro.kernels import ref
    from repro.models import moe as jmoe

    rng = np.random.default_rng(0)
    f32 = np.float32

    def randn(*s):
        return rng.standard_normal(s).astype(f32)

    B, T, H, KV, D = 4, 64, 8, 2, 16
    gqa = dict(q=randn(B, 1, H, D), k=randn(B, T, KV, D),
               v=randn(B, T, KV, D),
               lengths=np.array([5, 64, 33, 17], np.int32), scale=D ** -0.5)
    B, T, H, KV, D = 1, 128, 4, 1, 32
    pool = dict(q=randn(B, 1, H, D), k=randn(B, T, KV, D),
                v=randn(B, T, KV, D), lengths=np.array([100], np.int32),
                scale=D ** -0.5)
    B, T, H, KV, D = 2, 64, 4, 2, 16
    # 16 rows a slice: row 0 lives in the first slice alone, row 1 leaves
    # the last one empty
    empty = dict(q=randn(B, 1, H, D), k=randn(B, T, KV, D),
                 v=randn(B, T, KV, D), lengths=np.array([5, 40], np.int32),
                 scale=D ** -0.5)
    B, T, H, R, Rp = 2, 32, 4, 16, 8
    mla = dict(q_lat=randn(B, 1, H, R), q_rope=randn(B, 1, H, Rp),
               latent=randn(B, T, R), rope=randn(B, T, Rp),
               lengths=np.array([20, 32], np.int32), scale=(R + Rp) ** -0.5)
    over = dict(dtype="float32", n_experts=8, experts_per_token=2,
                capacity_factor=8.0)       # high cf: no drops -> exact
    j_cfg = get_smoke_config("qwen3-moe-235b-a22b").replace(**over)
    t_cfg = t_smoke("qwen3-moe-235b-a22b").replace(**over)
    j_p = jmoe.init_moe(jax.random.PRNGKey(0), j_cfg, jnp.float32)
    x = randn(8, 4, j_cfg.d_model)
    want_y, want_aux = jmoe.apply_moe(j_p, jnp.asarray(x), j_cfg)
    # [4 rows, 16 ids] over model = 2 (ids 0-7 | 8-15): ties inside a
    # shard, across the shards, a maximum in the upper shard only, and
    # the upper shard's first id tied with the lower shard's last
    am = rng.standard_normal((4, 16)).astype(f32)
    am[0, [3, 11]] = 9.0
    am[1, [10, 14]] = 9.0
    am[2, [2, 5, 9]] = 9.0
    am[3, [7, 8]] = 9.0
    payload = dict(gqa=gqa, pool=pool, empty=empty, mla=mla, argmax=am,
                   a2a=dict(cfg=t_cfg, params=params_to_torch(_np_tree(j_p)),
                            x=torch.from_numpy(x)))
    got = _run(tmp_path_factory.mktemp("collectives"), "collectives", payload)

    def j(a):
        return jnp.asarray(a)

    # the dense MLA oracle of the reference's own test
    s = (jnp.einsum("bshr,btr->bhst", j(mla["q_lat"]), j(mla["latent"]))
         + jnp.einsum("bshp,btp->bhst", j(mla["q_rope"]), j(mla["rope"]))) \
        * mla["scale"]
    mask = jnp.arange(mla["latent"].shape[1])[None, None, None, :] \
        < j(mla["lengths"])[:, None, None, None]
    w = jax.nn.softmax(jnp.where(mask, s, -1e30), axis=-1)
    want = dict(
        gqa=ref.decode_attention(j(gqa["q"]), j(gqa["k"]), j(gqa["v"]),
                                 j(gqa["lengths"]), gqa["scale"]),
        pool=ref.decode_attention(j(pool["q"]), j(pool["k"]), j(pool["v"]),
                                  j(pool["lengths"]), pool["scale"]),
        empty=ref.decode_attention(j(empty["q"]), j(empty["k"]),
                                   j(empty["v"]), j(empty["lengths"]),
                                   empty["scale"]),
        mla=jnp.einsum("bhst,btr->bshr", w, j(mla["latent"])),
        argmax=torch.from_numpy(am).argmax(-1),
        a2a=(want_y, want_aux))
    return got, {k: np.asarray(v) if k != "a2a" else
                 (np.asarray(v[0]), float(v[1])) for k, v in want.items()}


def _by_rows(got, key, n_rows, data_size=2):
    """Assemble the full batch from the ranks' row blocks (rows over
    ``data``) and check that ranks holding the same rows agree."""
    blocks = {}
    for g in got:
        d = g["coord"][0]
        out = g[key][0] if isinstance(g[key], tuple) else g[key]
        if d in blocks:
            assert torch.equal(blocks[d], out), "model ranks disagree"
        blocks[d] = out
    return torch.cat([blocks[d] for d in range(data_size)]).numpy()


def test_seq_decode_attention_matches_reference(collectives):
    got, want = collectives
    np.testing.assert_allclose(_by_rows(got, "gqa", 4), want["gqa"],
                               rtol=1e-5, atol=1e-5)


def test_seq_decode_attention_whole_mesh_pool(collectives):
    """B = 1: the KV sequence split over all four ranks."""
    got, want = collectives
    for g in got:
        np.testing.assert_allclose(g["pool"].numpy(), want["pool"],
                                   rtol=1e-5, atol=1e-5)


def test_seq_decode_combine_skips_empty_slices(collectives):
    """The LSE combine of normalised slices: a slice that holds no token
    of a row (lse -inf, o 0) adds nothing."""
    got, want = collectives
    for g in got:
        np.testing.assert_allclose(g["empty"].numpy(), want["empty"],
                                   rtol=1e-5, atol=1e-5)


def test_seq_mla_decode_matches_dense_oracle(collectives):
    got, want = collectives
    np.testing.assert_allclose(_by_rows(got, "mla", 2), want["mla"],
                               rtol=1e-5, atol=1e-5)


def test_moe_a2a_matches_capacity_path(collectives):
    got, want = collectives
    y_want, aux_want = want["a2a"]
    y = _by_rows(got, "a2a_f8=False", 8)
    np.testing.assert_allclose(y, y_want, rtol=2e-5, atol=2e-5)
    for g in got:
        np.testing.assert_allclose(float(g["a2a_f8=False"][1]), aux_want,
                                   rtol=1e-5)


def test_split_argmax_ties_to_the_lowest_id(collectives):
    """``AxisGroup.argmax`` over a vocabulary split on ``model`` gives
    every rank ``torch.argmax``'s ids of the whole rows, ties across the
    shards included."""
    got, want = collectives
    assert want["argmax"].tolist() == [3, 10, 2, 7]
    for g in got:
        assert g["argmax"].tolist() == want["argmax"].tolist()


def test_moe_a2a_f8_dispatch_within_fp8_error(collectives):
    """The fp8 transport stays within the reference fp8 KV test's bound."""
    got, want = collectives
    y_want = want["a2a"][0]
    y = _by_rows(got, "a2a_f8=True", 8)
    assert np.isfinite(y).all()
    err, scale = np.abs(y - y_want).max(), np.abs(y_want).max()
    assert err < 0.1 * scale + 0.5, (err, scale)
    assert err > 0           # the tokens did travel as fp8


# ---------------------------------------------------------------------------
# the sharded steps
# ---------------------------------------------------------------------------

#: (arch, strategy, mesh, perf levers, config overrides)
STEP_CASES = (
    ("minicpm3-4b", "crosspool", (1, 4), {}, {}),
    ("minicpm3-4b", "crosspool", (2, 2), {}, {}),
    ("qwen3-moe-235b-a22b", "crosspool", (1, 4), {}, {}),
    ("qwen3-moe-235b-a22b", "crosspool", (2, 2), {}, {}),
    # the a2a's own capacities (C2, C3) differ from the capacity path's:
    # a high capacity factor keeps both drop-free, as the reference's a2a
    # test does
    ("qwen3-moe-235b-a22b", "crosspool", (1, 4), {"moe_a2a": True},
     {"capacity_factor": 8.0}),
    ("qwen3-moe-235b-a22b", "crosspool", (2, 2), {"moe_a2a": True},
     {"capacity_factor": 8.0}),
    ("qwen3-moe-235b-a22b", "crosspool", (2, 2), {"moe_a2a": True},
     {"capacity_factor": 8.0, "n_shared_experts": 1}),
    ("qwen3-moe-235b-a22b", "crosspool", (2, 2), {},
     {"n_shared_experts": 1}),
    ("zamba2-1.2b", "crosspool", (1, 4), {}, {}),
    ("zamba2-1.2b", "crosspool", (2, 2), {}, {}),
    ("minicpm3-4b", "monolithic", (4, 1), {}, {}),
    ("qwen3-moe-235b-a22b", "monolithic", (4, 1), {}, {}),
    ("zamba2-1.2b", "monolithic", (4, 1), {}, {}),
    # DP attention: the SSM and attention leaves gathered where they are
    # read, the state's rows over data x model with every head
    ("zamba2-1.2b", "monolithic", (1, 4), {}, {"n_kv_heads": 2}),
    ("whisper-small", "monolithic", (1, 4), {}, {"n_kv_heads": 2}),
)
B, SEQ, MAX_LEN = 8, 8, 16
#: the serve step's placement of every param leaf: (arch, strategy, mesh,
#: step).  Each arch runs under both strategies; (1,4) splits the heads of
#: KV = 2 inside them (crosspool: Type II, the sequence-split decode) or
#: takes DP attention (monolithic), (2,2) and (4,1) keep whole KV heads a
#: rank (Type I: monolithic splits the cache's heads, crosspool keeps them
#: whole), and (4,1) puts the experts over data alone.  The ssm, hybrid
#: and audio archs: the SSM projections over model or over data x model
#: (crosspool's pool, whose rows are not a rank's heads on (2,2)), the
#: state's heads over model, whisper's encoder on split heads and its
#: whole decoder attention cut to a rank's cached heads
SERVE_CASES = (
    ("qwen3-moe-235b-a22b", "monolithic", (1, 4), "decode"),
    ("qwen3-moe-235b-a22b", "crosspool", (2, 2), "prefill"),
    ("moonshot-v1-16b-a3b", "monolithic", (2, 2), "decode"),
    ("moonshot-v1-16b-a3b", "crosspool", (1, 4), "decode"),
    ("moonshot-v1-16b-a3b", "crosspool", (4, 1), "prefill"),
    ("qwen3-14b", "monolithic", (1, 4), "prefill"),
    ("qwen3-14b", "crosspool", (2, 2), "decode"),
    ("gemma3-12b", "monolithic", (2, 2), "decode"),
    ("gemma3-12b", "crosspool", (1, 4), "decode"),
    ("llama3-405b", "monolithic", (4, 1), "decode"),
    ("llama3-405b", "crosspool", (1, 4), "prefill"),
    ("minicpm3-4b", "monolithic", (2, 2), "decode"),
    ("minicpm3-4b", "crosspool", (2, 2), "prefill"),
    ("llava-next-34b", "monolithic", (2, 2), "prefill"),
    ("llava-next-34b", "crosspool", (1, 4), "decode"),
    ("mamba2-130m", "monolithic", (1, 4), "prefill"),
    ("mamba2-130m", "crosspool", (2, 2), "decode"),
    ("mamba2-130m", "crosspool", (4, 1), "decode"),
    ("zamba2-1.2b", "monolithic", (2, 2), "decode"),
    ("zamba2-1.2b", "crosspool", (1, 4), "prefill"),
    ("whisper-small", "monolithic", (1, 4), "decode"),
    ("whisper-small", "crosspool", (2, 2), "prefill"),
)
#: crosspool decode where ``in_proj``'s packed columns do not split over
#: the weights pool while ``conv_w``'s channels and ``out_proj``'s rows do
#: (as mamba2's 3352 and zamba2's 8384 columns over 256 ranks): a head of
#: 64 leaves 2 heads, 290 columns, 160 channels and 128 rows, and the pool
#: of (2,2) is all four ranks; (arch, mesh, SSM overrides)
SSM_POOL_CASES = (
    ("mamba2-130m", (2, 2), {"head_dim": 64}),
    ("zamba2-1.2b", (2, 2), {"head_dim": 64}),
)
#: llava's stub patch embeddings ahead of the prompt in its prefill
N_PATCHES = 4
#: crosspool prefill-then-decode hand-offs: (arch, mesh, batch).  On (2,2)
#: with B = 8 the sequence splits over model (the prompt fills the first
#: slice, the decode steps write the second); minicpm3 (MLA) over a model
#: axis of 4 leaves its last slice empty; B = 1 (a batch that does not
#: split) pools the sequence over the whole mesh, its last slice empty
HANDOFFS = (
    ("moonshot-v1-16b-a3b", (2, 2), B),
    ("qwen3-14b", (2, 2), B),
    ("zamba2-1.2b", (2, 2), B),
    ("gemma3-12b", (2, 2), B),
    ("whisper-small", (2, 2), B),
    ("minicpm3-4b", (1, 4), B),
    ("qwen3-14b", (2, 2), 1),
)
HANDOFF_STEPS = 3


@functools.lru_cache(maxsize=None)
def _j_params(j_cfg):
    """The JAX package's params of ``j_cfg`` from ``PRNGKey(3)``, drawn
    once for every case of that config."""
    import jax
    from repro.models import build_model
    return build_model(j_cfg).init(jax.random.PRNGKey(3))


def _reference_case(rng, arch, strat, mesh, kind, perf, over):
    """One sharded-step case on the JAX package's seeded params and its
    single-device logits."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config
    from repro.models import build_model

    over = dict(over, dtype="float32")
    ssm = over.pop("ssm", {})
    j_cfg = get_smoke_config(arch).replace(**over)
    t_cfg = t_smoke(arch).replace(**over)
    if ssm:
        j_cfg = j_cfg.replace(ssm=replace(j_cfg.ssm, **ssm))
        t_cfg = t_cfg.replace(ssm=replace(t_cfg.ssm, **ssm))
    model = build_model(j_cfg)
    params = _j_params(j_cfg)
    tokens = rng.integers(0, j_cfg.vocab_size, (B, SEQ)).astype(np.int32)
    cache = model.init_cache(B, MAX_LEN)
    extra = {}
    if kind == "prefill" and j_cfg.frontend == "vision_patches":
        extra["embeddings"] = rng.standard_normal(
            (B, N_PATCHES, j_cfg.d_model)).astype(np.float32)
    if j_cfg.family == "audio":
        extra["encoder_frames"] = rng.standard_normal(
            (B, j_cfg.encoder_seq, j_cfg.d_model)).astype(np.float32)
    logits, cache_p = model.prefill(
        params, jnp.asarray(tokens), cache,
        **{k: jnp.asarray(v) for k, v in extra.items()})
    shape = replace(T_SHAPES["prefill_32k" if kind == "prefill"
                             else "decode_32k"],
                    seq_len=MAX_LEN, global_batch=B)
    case = dict(cfg=t_cfg, shape=shape,
                mesh=mesh, strategy=strat, perf=PerfOpts(**perf),
                params=params_to_torch(_np_tree(params)))
    if kind == "prefill":
        case.update(tokens=torch.from_numpy(tokens),
                    cache=params_to_torch(_np_tree(cache)),
                    extra={k: torch.from_numpy(v) for k, v in extra.items()})
        return case, np.asarray(logits)
    nxt = rng.integers(0, j_cfg.vocab_size, (B,)).astype(np.int32)
    want, _ = model.decode_step(params, jnp.asarray(nxt), cache_p,
                                jnp.int32(SEQ))
    case.update(tokens=torch.from_numpy(nxt),
                lengths=torch.full((B,), SEQ, dtype=torch.int32),
                cache=params_to_torch(_np_tree(cache_p)))
    return case, np.asarray(want)


def _reference_handoff(rng, arch, mesh, n):
    """One hand-off on the JAX package's seeded params: its single-device
    ``prefill`` of ``n`` prompts of ``SEQ`` tokens into an empty cache of
    ``MAX_LEN``, then ``HANDOFF_STEPS`` ``decode_step``s fed seeded ids;
    the logits of each (prefill first)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config
    from repro.models import build_model
    j_cfg = get_smoke_config(arch).replace(dtype="float32")
    model = build_model(j_cfg)
    params = _j_params(j_cfg)
    tokens = rng.integers(0, j_cfg.vocab_size, (n, SEQ)).astype(np.int32)
    nxt = rng.integers(0, j_cfg.vocab_size,
                       (HANDOFF_STEPS, n)).astype(np.int32)
    extra = {}
    if j_cfg.family == "audio":
        extra["encoder_frames"] = rng.standard_normal(
            (n, j_cfg.encoder_seq, j_cfg.d_model)).astype(np.float32)
    logits, cache = model.prefill(
        params, jnp.asarray(tokens), model.init_cache(n, MAX_LEN),
        **{k: jnp.asarray(v) for k, v in extra.items()})
    wants = [np.asarray(logits)]
    for i in range(HANDOFF_STEPS):
        logits, cache = model.decode_step(params, jnp.asarray(nxt[i]), cache,
                                          jnp.int32(SEQ + i))
        wants.append(np.asarray(logits))
    case = dict(cfg=t_smoke(arch).replace(dtype="float32"), mesh=mesh,
                params=params_to_torch(_np_tree(params)),
                tokens=torch.from_numpy(tokens), next=torch.from_numpy(nxt),
                extra={k: torch.from_numpy(v) for k, v in extra.items()})
    return case, wants


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """Every case of ``STEP_CASES``, ``SERVE_CASES``, ``SSM_POOL_CASES``
    then ``HANDOFFS``, in one spawn."""
    cases, wants = [], []
    rng = np.random.default_rng(0)
    for arch, strat, mesh, perf, over in STEP_CASES:
        kind = "prefill" if strat == "monolithic" else "decode"
        case, want = _reference_case(rng, arch, strat, mesh, kind, perf, over)
        cases.append(case)
        wants.append(want)
    for arch, strat, mesh, kind in SERVE_CASES:
        case, want = _reference_case(rng, arch, strat, mesh, kind, {}, {})
        cases.append(case)
        wants.append(want)
    for arch, mesh, ssm in SSM_POOL_CASES:
        case, want = _reference_case(rng, arch, "crosspool", mesh, "decode",
                                     {}, {"ssm": ssm})
        cases.append(case)
        wants.append(want)
    handoffs = []
    for arch, mesh, n in HANDOFFS:
        case, want = _reference_handoff(rng, arch, mesh, n)
        handoffs.append(case)
        wants.append(want)
    got = _run(tmp_path_factory.mktemp("steps"), "steps",
               {"cases": cases, "handoffs": handoffs})
    return got, wants


def _gathered(got, i, step=None, n_rows=B):
    """Case ``i``'s logits [B, V] (a hand-off's of ``step``) assembled
    from every rank's rows and vocabulary shard; ranks holding the same
    entries agree bit for bit."""
    full = {}
    for rank in got:
        r = rank[i]
        logits = r["logits"] if step is None else r["logits"][step]
        v0, n = r["vocab0"], logits.shape[-1]
        for row, logit in zip(r["rows"].tolist(), logits):
            for j, x in zip(range(v0, v0 + n), logit.tolist()):
                assert full.setdefault((row, j), x) == x, (row, j)
        for kind, path, shape, want, spec in r.get("placed", ()):
            assert shape == want, (kind, path, spec)
    V = 1 + max(j for _, j in full)
    return np.array([[full[(row, j)] for j in range(V)]
                     for row in range(n_rows)], dtype=np.float32)


@pytest.mark.parametrize("i", range(len(STEP_CASES)),
                         ids=[f"{a}-{s}-{m[0]}x{m[1]}"
                              + "".join(f"-{k}" for k in p)
                              + "".join(f"-{k}={v}" for k, v in o.items())
                              for a, s, m, p, o in STEP_CASES])
def test_sharded_step_matches_single_device(steps, i):
    """The gathered logits equal the JAX package's single-device step
    within its own tolerance; every rank's placed leaves hold the rules'
    shard, and ranks with the same rows and vocabulary shard give the
    same logits."""
    got, wants = steps
    logits = _gathered(got, i)
    np.testing.assert_allclose(logits, wants[i], **STEP_TOL)
    arch, strat, mesh, perf, over = STEP_CASES[i]
    placed = {(k, p): spec for k, p, _, _, spec in got[0][i]["placed"]}
    if strat == "crosspool":
        # Type I and Type II (MLA; qwen3-moe's 2 KV heads under a model
        # axis of 4) alike: every crosspool case's kv_seq_axes (model)
        # spans more than one rank, so the cache's sequence splits
        type_ii = arch == "minicpm3-4b" or (
            arch == "qwen3-moe-235b-a22b" and mesh == (1, 4))
        assert got[0][i]["type_ii"] == type_ii
        assert got[0][i]["seq_split"]
        seq = placed[("cache", "latent" if arch == "minicpm3-4b" else "k")]
        assert seq[2] is not None
        for g in got:
            assert g[i]["seq_bytes"] == g[i]["seq_rule_bytes"]
        # the dense weights pool (qwen3-moe has no dense FFN of its own)
        if arch != "qwen3-moe-235b-a22b" or over.get("n_shared_experts"):
            assert any(k == "params" and "/moe/w" not in p
                       for k, p in placed)
        assert got[0][i]["a2a"] == bool(perf.get("moe_a2a"))
        if perf.get("moe_a2a"):
            assert ("params", "layers/moe/wg") in placed
    if mesh != (1, 1):
        assert max(g[i]["bytes"] for g in got) < sum(g[i]["bytes"]
                                                     for g in got)


@pytest.mark.parametrize("i", range(len(SERVE_CASES)),
                         ids=[f"{a}-{s}-{m[0]}x{m[1]}-{k}"
                              for a, s, m, k in SERVE_CASES])
def test_serve_step_places_every_leaf(steps, i):
    """The serve step on every param leaf placed by the serve rules: the
    logits gathered over rows and vocabulary shards within 2e-4 of the
    JAX package's single-device step; every leaf the rules' cut by value
    and the rank's param and cache bytes the rules' exactly; ``greedy``
    the gathered argmax; monolithic Type I holds its KV heads' share of
    the cache (whisper's cross ``ck`` too), crosspool Type I the whole
    heads; the SSM state holds a rank's heads wherever ``model`` splits
    them."""
    got, wants = steps
    j = len(STEP_CASES) + i
    logits = _gathered(got, j)
    np.testing.assert_allclose(logits, wants[j], **STEP_TOL)
    arch, strat, mesh, kind = SERVE_CASES[i]
    argmax = logits.argmax(-1)
    for g in got:
        r = g[j]
        assert r["cut"]
        assert r["param_bytes"] == r["rule_bytes"]
        assert r["cache_bytes"] == r["cache_rule_bytes"]
        # the sequence-split leaves as the reference's table places them
        assert r["seq_split"] == (strat == "crosspool" and mesh[1] > 1
                                  and arch != "mamba2-130m")
        if strat == "crosspool":
            assert r["seq_bytes"] == r["seq_rule_bytes"]
        assert r["greedy"].tolist() == argmax[r["rows"].numpy()].tolist()
        assert r["head_split"] == (strat == "monolithic"
                                   and not r["type_ii"])
        # the vocabulary splits over model, but DP attention returns it
        # whole (the reference's monolithic logits constraint)
        dpa = strat == "monolithic" and r["type_ii"]
        assert (r["logits"].shape[-1] < logits.shape[-1]) == (
            mesh[1] > 1 and not dpa)
    placed = {(k, p): spec for k, p, _, _, spec in got[0][j]["placed"]}
    for name in ("gk" if arch == "gemma3-12b" else "k", "ck"):
        if ("cache", name) in placed:
            assert (placed[("cache", name)][-2] is not None) == \
                got[0][j]["head_split"]
    if ("cache", "h") in placed or got[0][j]["ssm_heads"]:
        assert got[0][j]["ssm_heads"] == (mesh[1] > 1)
        assert (placed[("cache", "h")][2] is not None) == (mesh[1] > 1)
    assert max(g[j]["param_bytes"] for g in got) < sum(
        g[j]["param_bytes"] for g in got)


@pytest.mark.parametrize("i", range(len(SSM_POOL_CASES)),
                         ids=[f"{a}-{m[0]}x{m[1]}"
                              for a, m, _ in SSM_POOL_CASES])
def test_ssm_pool_without_in_proj_split(steps, i):
    """Where ``in_proj`` stays whole, the step gathers ``conv_w``'s
    channels and reduces ``out_proj``'s rows over the axes those leaves
    split over (``Strategy._ssm_pool_axes``: data x model here): the
    gathered logits within 2e-4 of the JAX package's single-device
    ``decode_step``, every leaf the rules' cut and bytes, the state's
    heads whole."""
    got, wants = steps
    j = len(STEP_CASES) + len(SERVE_CASES) + i
    np.testing.assert_allclose(_gathered(got, j), wants[j], **STEP_TOL)
    placed = {(k, p): spec for k, p, _, _, spec in got[0][j]["placed"]}
    assert ("params", "layers/ssm/in_proj") not in placed
    assert placed[("params", "layers/ssm/conv_w")][-1] is not None
    assert placed[("params", "layers/ssm/out_proj")][-2] is not None
    for g in got:
        r = g[j]
        assert r["ssm_pool"] == ("data", "model")
        assert not r["ssm_heads"] and r["cut"]
        assert r["param_bytes"] == r["rule_bytes"]
        assert r["cache_bytes"] == r["cache_rule_bytes"]


@pytest.mark.parametrize("h", range(len(HANDOFFS)),
                         ids=[f"{a}-{m[0]}x{m[1]}-B{n}"
                              for a, m, n in HANDOFFS])
def test_crosspool_prefill_then_decode_split_cache(steps, h):
    """A crosspool prefill writes this rank's slice of the sequence (both
    steps place the cache alike), then decode steps continue from it:
    every step's gathered logits within 2e-4 of the JAX package's
    single-device ``prefill`` + ``decode_step``; a rank's bytes of the
    sequence-split leaves the reference table's, a share of the whole;
    the last slice holds no token of the row where the sequence pools
    over four ranks."""
    got, wants = steps
    i = len(STEP_CASES) + len(SERVE_CASES) + len(SSM_POOL_CASES) + h
    arch, mesh, n = HANDOFFS[h]
    for step, want in enumerate(wants[i]):
        np.testing.assert_allclose(_gathered(got, i, step, n), want,
                                   **STEP_TOL, err_msg=f"step {step}")
    for g in got:
        r = g[i]
        assert r["seq_split"] == (True, True) and r["same_place"]
        assert r["seq_bytes"] == r["seq_rule_bytes"] < r["whole_seq_bytes"]
        assert r["cache_bytes"] == r["cache_rule_bytes"]
    held = sorted(g[i]["held"] for g in got)
    if mesh == (1, 4) or n == 1:
        assert held[0] == 0 and held[-1] > 0, held


def test_one_rank_serve_hooks_are_bit_exact(tmp_path):
    """Over a one-rank group the serve hooks of both strategies leave
    ``prefill`` and ``decode_step`` bit for bit as without hooks (a MoE
    with a shared expert, an MLA, a tied sliding-window arch, and the
    ssm, hybrid and audio archs)."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        mesh = Mesh((1, 1), ("data", "model"), live=True)
        for arch, over in (("qwen3-moe-235b-a22b", {"n_shared_experts": 1}),
                           ("minicpm3-4b", {}), ("gemma3-12b", {}),
                           ("mamba2-130m", {}), ("zamba2-1.2b", {}),
                           ("whisper-small", {})):
            cfg = t_smoke(arch).replace(dtype="float32", **over)
            model = t_build_model(cfg)
            params = model.init(torch.Generator().manual_seed(0))
            gen = torch.Generator().manual_seed(1)
            tokens = torch.randint(0, cfg.vocab_size, (2, SEQ),
                                   generator=gen, dtype=torch.int32)
            extra = {}
            if cfg.family == "audio":
                extra["encoder_frames"] = torch.randn(
                    2, cfg.encoder_seq, cfg.d_model, generator=gen)
            nxt = tokens[:, 0]
            for strat in ("monolithic", "crosspool"):
                runs = []
                for hooked in (False, True):
                    cache = model.init_cache(2, MAX_LEN, "cpu")
                    kw = {}
                    if hooked:
                        kw["hooks"] = make_strategy(
                            strat, mesh, cfg, replace(
                                T_SHAPES["decode_32k"], seq_len=MAX_LEN,
                                global_batch=2)).hooks()
                    first, _ = model.prefill(params, tokens, cache, **kw,
                                             **extra)
                    step, _ = model.decode_step(params, nxt, cache, SEQ,
                                                **kw)
                    runs.append((first, step, cache))
                (a0, a1, ca), (b0, b1, cb) = runs
                assert torch.equal(a0, b0) and torch.equal(a1, b1)
                assert all(torch.equal(ca[k], cb[k]) for k in ca)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# checkpoint resharding
# ---------------------------------------------------------------------------

def test_elastic_reshard_across_meshes(tmp_path):
    """A checkpoint written under a (2,2) mesh (rank 0 writes the gathered
    leaves once) restores onto a (4,1) mesh: every rank's shards equal the
    new rules' cut of the original leaves."""
    import jax
    from repro.configs import get_smoke_config
    from repro.models import build_model

    cfg = get_smoke_config("qwen3-14b").replace(dtype="float32")
    params = params_to_torch(_np_tree(
        build_model(cfg).init(jax.random.PRNGKey(7))))
    d = tmp_path / "ckpt"
    got = _run(tmp_path, "ckpt", dict(
        cfg=t_smoke("qwen3-14b").replace(dtype="float32"), params=params,
        dir=str(d)))
    assert sorted(g["rank"] for g in got) == list(range(WORLD))
    assert [g["path"] is not None for g in got] == [True, False, False, False]
    for g in got:
        assert g["step"] == 1 and g["equal"]
        assert all(a == b for a, b in g["shapes"].values())
    # the restored leaves live under the NEW mesh: some leaf is split 4 ways
    assert any(a != tuple(_get(params, p).shape)
               for p, (a, _) in got[0]["shapes"].items())
    whole, _ = ckpt.restore(str(d), target_tree=params)
    for path, leaf in _flat(params):
        assert torch.equal(_get(whole, path), leaf), path
