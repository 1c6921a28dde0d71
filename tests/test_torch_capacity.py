"""The port's capacity models and the virtualizer's device views against
the JAX package.

(a) ``KVVirtualizer.write_tokens`` / ``write_prompt_from_cache`` /
    ``page_table_array`` / ``typed_pages`` on smoke GQA and MLA configs:
    the pools after the same writes are equal bit for bit, the tables
    equal, the typed view equal and a view; a request with swapped pages
    must be faulted in first.
(b) ``core/placement.py`` on the published configs of the colocation
    set: every function equal with ``==``, and the reference's own claims
    (``tests/test_core.py`` ``TestPlacement``) restated on the port.
(c) ``runtime/simulator.py``: step times, placements, one simulated trace
    and Fig. 6's capacity scan equal with ``==`` (the same float
    arithmetic over the same integers), and the reference's four claims
    (``tests/test_runtime.py`` ``TestSimulator``) restated on the port.
"""
import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import PAPER_COLOC_SET, get_config, get_smoke_config
from repro.core import placement as j_pl
from repro.core import virtualizer as j_virt
from repro.runtime import observe as j_obs
from repro.runtime import simulator as j_sim
from repro_torch.configs import get_config as t_config
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core import placement as t_pl
from repro_torch.core import virtualizer as t_virt
from repro_torch.runtime import observe as t_obs
from repro_torch.runtime import simulator as t_sim
from repro_torch.runtime.observe import percentile
from torch_threads import one_torch_thread  # noqa: F401

MOE, MLA, MOON = "qwen3-moe-235b-a22b", "minicpm3-4b", "moonshot-v1-16b-a3b"
#: Fig. 6's context bins (``benchmarks/fig6_context_scalability.py``)
FIG6_BINS = [1024, 2048, 4096, 8192, 16384, 32768, 65536, 131072, 262144,
             524288, 1_048_576]
SYSTEMS = ("static", "kvcached", "crosspool")
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _bits(x) -> np.ndarray:
    """A pool's raw bits as numpy (bf16 as uint16), either package."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.contiguous().view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    arr = np.asarray(x)
    return arr.view(np.uint16) if arr.dtype.name == "bfloat16" else arr


# ---------------------------------------------------------------------------
# (a) the virtualizer's device views
# ---------------------------------------------------------------------------

def _virt_pair(dtype, budget=96, page_bytes=2048):
    jd, td = DTYPES[dtype]
    jv = j_virt.KVVirtualizer(
        {n: get_smoke_config(n) for n in PAPER_COLOC_SET},
        page_budget=budget, page_bytes=page_bytes, dtype=jd)
    tv = t_virt.KVVirtualizer(
        {n: t_smoke(n) for n in PAPER_COLOC_SET}, page_budget=budget,
        page_bytes=page_bytes, dtype=td, device="cpu")
    return jv, tv


def _dense_cache(cfg, batch, n, rng):
    """A Model-path cache of ``batch`` rows and ``n`` tokens, as numpy."""
    L = cfg.n_layers
    if cfg.attention == "mla":
        m = cfg.mla
        return {"latent": rng.standard_normal(
                    (L, batch, n, m.kv_lora_rank)).astype(np.float32),
                "rope": rng.standard_normal(
                    (L, batch, n, m.qk_rope_head_dim)).astype(np.float32)}
    shape = (L, batch, n, cfg.n_kv_heads, cfg.head_dim)
    return {"k": rng.standard_normal(shape).astype(np.float32),
            "v": rng.standard_normal(shape).astype(np.float32)}


def _same_views(jv, tv, rids, rng):
    np.testing.assert_array_equal(_bits(tv.pool), _bits(jv.pool))
    for model in PAPER_COLOC_SET:
        typed = tv.typed_pages(model)
        assert typed.data_ptr() == tv.pool.data_ptr()
        assert typed.untyped_storage().data_ptr() == \
            tv.pool.untyped_storage().data_ptr()
        np.testing.assert_array_equal(_bits(typed),
                                      _bits(jv.typed_pages(model)))
    if rids:
        view = tv.views[tv.requests[rids[0]].model]
        layer = int(rng.integers(0, view.n_kv_layers))
        max_pages = int(rng.integers(1, 12))
        got = tv.page_table_array(rids, layer, max_pages)
        assert got.dtype == torch.int32 and got.shape == (len(rids),
                                                           max_pages)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jv.page_table_array(rids, layer,
                                                        max_pages)))


@settings(max_examples=12, deadline=None)
@given(dtype=st.sampled_from(sorted(DTYPES)),
       ops=st.lists(st.tuples(st.sampled_from(["prompt", "tokens"]),
                              st.sampled_from(list(PAPER_COLOC_SET)),
                              st.integers(1, 90), st.integers(0, 40)),
                    min_size=1, max_size=5))
def test_pool_writes_and_views_equal_reference(dtype, ops):
    """Random request sizes, prompt seeds and token writes at random
    start offsets (each its own request, mapped for start + n tokens):
    the same pools bit for bit, the same page tables, and typed pages
    equal to the reference's and views of the pool."""
    jv, tv = _virt_pair(dtype)
    rng = np.random.default_rng(len(ops))
    rids = []
    for rid, (kind, model, n, start) in enumerate(ops):
        cfg = get_smoke_config(model)
        view = tv.views[model]
        total = n if kind == "prompt" else start + n
        if view.pages_for(total) > tv.free_pages:
            continue
        for v in (jv, tv):
            v.register_request(rid, model, total)
        rids.append(rid)
        if kind == "prompt":
            batch = int(rng.integers(1, 3))
            row = int(rng.integers(0, batch))
            cache = _dense_cache(cfg, batch, n + 3, rng)
            jv.write_prompt_from_cache(
                model, rid, {k: jnp.asarray(v) for k, v in cache.items()},
                n, batch_index=row)
            tv.write_prompt_from_cache(
                model, rid, {k: torch.from_numpy(v) for k, v in
                             cache.items()}, n, batch_index=row)
        else:
            layer = int(rng.integers(0, view.n_kv_layers))
            kv = rng.standard_normal((n, *view.kv_shape)).astype(np.float32)
            jv.write_tokens(model, layer, rid, start, jnp.asarray(kv))
            tv.write_tokens(model, layer, rid, start, torch.from_numpy(kv))
    _same_views(jv, tv, rids, rng)


def test_writes_go_to_the_resized_pool():
    """A resize (the elastic path) gives the virtualizer a new pool
    tensor; later writes land in it, and both packages compact and write
    the same bytes."""
    jv, tv = _virt_pair("float32", budget=48)
    rng = np.random.default_rng(3)
    for rid, model in enumerate((MOE, MLA)):
        view = tv.views[model]
        kv = rng.standard_normal((30, *view.kv_shape)).astype(np.float32)
        for v, x in ((jv, jnp.asarray(kv)), (tv, torch.from_numpy(kv))):
            v.register_request(rid, model, 60)
            v.write_tokens(model, 0, rid, 0, x)
    old = tv.pool
    for v in (jv, tv):
        v.resize(v.page_budget + 16)
    assert tv.pool is not old
    view = tv.views[MLA]
    kv = rng.standard_normal((25, *view.kv_shape)).astype(np.float32)
    jv.write_tokens(MLA, 1, 1, 30, jnp.asarray(kv))
    tv.write_tokens(MLA, 1, 1, 30, torch.from_numpy(kv))
    _same_views(jv, tv, [0, 1], rng)


def test_swapped_pages_must_be_faulted_in_first():
    """A request with swapped pages refuses every device view until
    ``ensure_resident``, as the reference's writes do (a kernel reads the
    encoded entries as "no page" and would drop that KV silently)."""
    jv, tv = _virt_pair("float32", budget=32)
    view = tv.views[MLA]
    kv = np.ones((4, *view.kv_shape), np.float32)
    cache = _dense_cache(get_smoke_config(MLA), 1, 8, np.random.default_rng(0))
    for v in (jv, tv):
        v.register_request(0, MLA, 40)
        assert v.swap_out(0, max_pages=1) == 1
    with pytest.raises(j_virt.PoolAccountingError):
        jv.write_tokens(MLA, 0, 0, 0, jnp.asarray(kv))
    with pytest.raises(j_virt.PoolAccountingError):
        jv.write_prompt_from_cache(MLA, 0, {k: jnp.asarray(v) for k, v in
                                            cache.items()}, 8)
    with pytest.raises(t_virt.PoolAccountingError):
        tv.write_tokens(MLA, 0, 0, 0, torch.from_numpy(kv))
    with pytest.raises(t_virt.PoolAccountingError):
        tv.write_prompt_from_cache(MLA, 0, {k: torch.from_numpy(v) for k, v
                                            in cache.items()}, 8)
    with pytest.raises(t_virt.PoolAccountingError):
        tv.page_table_array([0], 0, 4)
    for v in (jv, tv):
        assert v.ensure_resident(0) == 1
    jv.write_tokens(MLA, 0, 0, 0, jnp.asarray(kv))
    tv.write_tokens(MLA, 0, 0, 0, torch.from_numpy(kv))
    _same_views(jv, tv, [0], np.random.default_rng(1))


def test_prompt_cache_layers_must_match_the_view():
    _, tv = _virt_pair("float32")
    tv.register_request(0, MOE, 8)
    cache = _dense_cache(get_smoke_config(MOE), 1, 8,
                         np.random.default_rng(0))
    short = {k: torch.from_numpy(v[:1]) for k, v in cache.items()}
    with pytest.raises(t_virt.PoolAccountingError):
        tv.write_prompt_from_cache(MOE, 0, short, 8)


# ---------------------------------------------------------------------------
# (b) placement
# ---------------------------------------------------------------------------

def _coloc(full=True):
    get_j, get_t = (get_config, t_config) if full else (get_smoke_config,
                                                        t_smoke)
    return ([get_j(n) for n in PAPER_COLOC_SET],
            [get_t(n) for n in PAPER_COLOC_SET])


def _testbed(mod, models):
    """The reference test's hardware: weights ~= 77% of HBM (§5.1)."""
    w_total = sum(c.param_counts()["total"] * 2 for c in models)
    return mod.Hardware(n_gpus=5, hbm_bytes=w_total / 5 / 0.77)


def _placements(mod, models, hw):
    return {"static": mod.static_partition(models, hw, [2, 2, 1]),
            "kvcached": mod.kvcached(models, hw),
            "crosspool": mod.crosspool(models, hw, kv_gpus=1)}


@pytest.mark.parametrize("hw_kind", ["testbed", "default"])
def test_placement_equals_reference(hw_kind):
    jm, tm = _coloc()
    if hw_kind == "default":
        jhw, thw = j_pl.Hardware(n_gpus=5, hbm_bytes=400e9), \
            t_pl.Hardware(n_gpus=5, hbm_bytes=400e9)
    else:
        jhw, thw = _testbed(j_pl, jm), _testbed(t_pl, tm)
    assert dataclasses.asdict(thw) == dataclasses.asdict(jhw)
    jp, tp = _placements(j_pl, jm, jhw), _placements(t_pl, tm, thw)
    for system in SYSTEMS:
        assert tp[system].system == jp[system].system == system
        assert tp[system].per_model == jp[system].per_model
        for jc, tc in zip(jm, tm):
            assert tp[system].max_context(tc) == jp[system].max_context(jc)
    for G in (1, 2, 3, 4, 5, 8):
        assert t_pl._tp_width(tm[0], G) == j_pl._tp_width(jm[0], G)


def test_placement_defaults_are_the_paper_testbed():
    assert t_pl.Hardware() == t_pl.Hardware(5, 40e9, 2)
    assert dataclasses.asdict(t_pl.Hardware()) == \
        dataclasses.asdict(j_pl.Hardware())


def test_crosspool_refuses_ffn_past_the_weights_pool():
    jm, tm = _coloc()
    with pytest.raises(AssertionError):
        j_pl.crosspool(jm, j_pl.Hardware(), kv_gpus=1)
    with pytest.raises(ValueError, match="exceed weights pool"):
        t_pl.crosspool(tm, t_pl.Hardware(), kv_gpus=1)


@pytest.mark.parametrize("heads", [1, 2, 3, 4, 8, 16])
@pytest.mark.parametrize("gpus", [1, 4, 5])
def test_kv_availability_fraction_equals_reference(heads, gpus):
    for dis in (False, True):
        assert t_pl.kv_availability_fraction(heads, gpus, dis) == \
            j_pl.kv_availability_fraction(heads, gpus, dis)


def test_placement_claims_hold_on_the_port():
    """``tests/test_core.py`` ``TestPlacement`` on the port: Fig. 2's
    fractions, and the Fig. 6 story (the MLA model sees > 3x more KV
    under CrossPool than kvcached, and a longer context; static's worst
    model fits less context than CrossPool's)."""
    f = t_pl.kv_availability_fraction
    assert (f(4, 4, False), f(2, 4, False), f(1, 4, False),
            f(1, 4, True)) == (1.0, 0.5, 0.25, 1.0)
    _, models = _coloc()
    hw = _testbed(t_pl, models)
    p = _placements(t_pl, models, hw)
    mla = models[2]
    assert p["crosspool"].per_model[mla.name][0] > \
        3 * p["kvcached"].per_model[mla.name][0]
    assert p["crosspool"].max_context(mla) > p["kvcached"].max_context(mla)
    assert min(p["static"].max_context(c) for c in models) \
        < min(p["crosspool"].max_context(c) for c in models)


# ---------------------------------------------------------------------------
# (c) the simulator
# ---------------------------------------------------------------------------

def _sim_models(full=True):
    get_j, get_t = (get_config, t_config) if full else (get_smoke_config,
                                                        t_smoke)
    return ({n: get_j(n) for n in PAPER_COLOC_SET},
            {n: get_t(n) for n in PAPER_COLOC_SET})


PLACEMENT_CASES = [(s, pipe, low, k) for s in SYSTEMS
                   for pipe in (False, True) for low in (False, True)
                   for k in ((1, 4) if s == "crosspool" else (1,))]


def _same_placement(jp, tp):
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)


@pytest.mark.parametrize("system,pipelined,lowered,k", PLACEMENT_CASES)
def test_step_times_and_placements_equal_reference(system, pipelined,
                                                    lowered, k):
    jm, tm = _sim_models()
    kw = dict(pipelined=pipelined, lowered=lowered, decode_steps=k)
    jp = j_sim.paper_placements(jm, system, **kw)
    tp = t_sim.paper_placements(tm, system, **kw)
    _same_placement(jp, tp)
    _same_placement(j_sim.paper_placements(jm, system, hbm_bytes=80e9, **kw),
                    t_sim.paper_placements(tm, system, hbm_bytes=80e9, **kw))
    for name in PAPER_COLOC_SET:
        for batch, ctx in ((1, 512), (4, 4 * 1024), (8, 8 * 32768)):
            assert t_sim.decode_step_time(tm[name], batch, ctx, tp) == \
                j_sim.decode_step_time(jm[name], batch, ctx, jp)
            if system == "crosspool":
                assert t_sim.crosspool_stage_times(tm[name], batch, ctx,
                                                   tp) == \
                    j_sim.crosspool_stage_times(jm[name], batch, ctx, jp)
        for prompt in (1, 300, 32768):
            assert t_sim.prefill_time(tm[name], prompt, tp) == \
                j_sim.prefill_time(jm[name], prompt, jp)


def test_paper_placements_refuse_an_unknown_system():
    _, tm = _sim_models()
    with pytest.raises(ValueError):
        t_sim.paper_placements(tm, "monolith")


def _request_fields(r):
    return (r.request_id, r.model, r.prompt_tokens, r.max_new_tokens,
            r.arrival_time, r.generated, r.admit_time, r.first_token_time,
            r.finish_time, r.token_times)


@pytest.mark.parametrize("system", SYSTEMS)
def test_simulated_trace_equals_reference(system):
    """One trace from each package's ``make_requests`` (asserted equal
    first) through each package's ``DecodeSimulator``: the same outputs
    and the same request timelines, exactly."""
    jm, tm = _sim_models()
    kw = dict(rps_per_model=0.8, horizon_s=60, kind="sharegpt", seed=7)
    j_reqs = j_obs.make_requests(list(jm), **kw)
    t_reqs = t_obs.make_requests(list(tm), **kw)
    assert [_request_fields(r) for r in t_reqs] == \
        [_request_fields(r) for r in j_reqs]
    j_out = j_sim.DecodeSimulator(jm, j_sim.paper_placements(jm, system)
                                  ).run(j_reqs)
    t_out = t_sim.DecodeSimulator(tm, t_sim.paper_placements(tm, system)
                                  ).run(t_reqs)
    assert t_out == j_out
    assert t_out["finished"] > 0
    assert [_request_fields(r) for r in t_reqs] == \
        [_request_fields(r) for r in j_reqs]


@pytest.mark.parametrize("system", SYSTEMS)
def test_capacity_scan_equals_reference(system):
    """Fig. 6: max RPS at every context bin, exactly."""
    jm, tm = _sim_models()
    jp = j_sim.paper_placements(jm, system)
    tp = t_sim.paper_placements(tm, system)
    for ctx in FIG6_BINS:
        for out in (256, 32):
            assert t_sim.max_rps_for_context(tm, tp, ctx, out) == \
                j_sim.max_rps_for_context(jm, jp, ctx, out)


def test_simulator_claims_hold_on_the_port():
    """``tests/test_runtime.py`` ``TestSimulator``'s four claims on the
    port: lowered + pipelined steps beat host-driven ones; CrossPool
    keeps capacity into Fig. 6's long bins (and the MLA model sees > 2x
    kvcached's KV); kvcached's P99 TBT exceeds CrossPool's at 0.8
    RPS/model with static within 2x of CrossPool; and each mechanism
    alone raises simulated throughput, both together most."""
    _, models = _sim_models()
    cfg = models[MOE]
    fast = t_sim.paper_placements(models, "crosspool", pipelined=True,
                                  lowered=True)
    slow = t_sim.paper_placements(models, "crosspool", pipelined=False,
                                  lowered=False)
    assert t_sim.decode_step_time(cfg, 4, 4 * 1024, fast) < \
        t_sim.decode_step_time(cfg, 4, 4 * 1024, slow)

    ctxs = [8192, 65536, 262144, 1_048_576]
    sup = {s: [c for c in ctxs if t_sim.max_rps_for_context(
        models, t_sim.paper_placements(models, s), c) > 0] for s in SYSTEMS}
    assert max(sup["crosspool"]) >= max(sup["kvcached"])
    assert max(sup["crosspool"]) >= max(sup["static"])
    assert t_sim.paper_placements(models, "crosspool").kv_visible[MLA] > \
        2 * t_sim.paper_placements(models, "kvcached").kv_visible[MLA]

    proto = t_obs.make_requests(list(models), rps_per_model=0.8,
                                horizon_s=120, kind="sharegpt", seed=7)

    def p99(system):
        out = t_sim.DecodeSimulator(
            models, t_sim.paper_placements(models, system)).run(
            copy.deepcopy(proto))
        return percentile(out["tbt"], 99)
    p_static, p_kvc, p_xp = (p99(s) for s in SYSTEMS)
    assert p_xp < p_kvc
    assert p_static <= p_xp * 2.0

    proto = t_obs.make_requests(list(models), rps_per_model=0.5,
                                horizon_s=60, kind="sharegpt", seed=9)

    def tokens_per_s(pipelined, lowered):
        reqs = copy.deepcopy(proto)
        t_sim.DecodeSimulator(models, t_sim.paper_placements(
            models, "crosspool", pipelined=pipelined, lowered=lowered)
        ).run(reqs)
        span = max((r.finish_time for r in reqs if r.finish_time),
                   default=1)
        return sum(r.generated for r in reqs) / span
    base = tokens_per_s(False, False)
    only_low, only_pipe = tokens_per_s(False, True), tokens_per_s(True, False)
    assert only_low > base and only_pipe > base
    assert tokens_per_s(True, True) > max(only_low, only_pipe)
