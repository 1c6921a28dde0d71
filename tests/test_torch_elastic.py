"""The port's elastic KV<->weights boundary against the JAX package
(DESIGN.md §8): the planner, the virtualizer's swap tier and resize, the
arena's resize, the telemetry window and the rebalancer make the same
decisions on the same inputs; decode crosses a forced shrink -> swap-out
-> grow -> fault-in cycle bit for bit; and the elastic engine serves a
page-pressure burst with the frozen engine's greedy streams.

Float32 smoke configs on the CPU (the port's plain kernel versions; the
decode graphs and their recapture after a move are card-only, held in
``chip_smoke.py`` phase 9).  Weights come from the reference's init
through ``repro_torch.bridge``.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import PAPER_COLOC_SET, get_config, get_smoke_config
from repro.configs.base import ElasticConfig as JElastic
from repro.configs.base import EngineConfig as JConfig
from repro.core import admission as j_adm
from repro.core import control as j_control
from repro.core import elastic as j_elastic
from repro.core import planner as j_planner
from repro.core import pools as j_pools
from repro.core import virtualizer as j_virt
from repro.core import weight_pool as j_wp
from repro.models import build_model
from repro.runtime import telemetry as j_tel
from repro.runtime.engine import CrossPoolEngine as JEngine
from repro.runtime.engine import EngineMode as JMode
from repro.runtime.request import Request as JRequest
from repro_torch.bridge import params_to_torch
from repro_torch.configs import get_config as t_config
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs.base import ElasticConfig, EngineConfig
from repro_torch.core import admission as t_adm
from repro_torch.core import control as t_control
from repro_torch.core import elastic as t_elastic
from repro_torch.core import planner as t_planner
from repro_torch.core import pools as t_pools
from repro_torch.core import virtualizer as t_virt
from repro_torch.core import weight_pool as t_wp
from repro_torch.runtime import telemetry as t_tel
from repro_torch.runtime.engine import CrossPoolEngine as TEngine
from repro_torch.runtime.engine import EngineMode as TMode
from repro_torch.runtime.request import Request as TRequest
from test_elastic import _check_invariants
from test_torch_pools import _w_trees
from torch_threads import one_torch_thread  # noqa: F401

#: (JAX config, JAX FFN tree, port FFN tree) of one smoke model, drawn once
_trees = functools.cache(_w_trees)

MOE, MLA, MOON = "qwen3-moe-235b-a22b", "minicpm3-4b", "moonshot-v1-16b-a3b"
MAMBA = "mamba2-130m"


# ---------------------------------------------------------------------------
# (a) the planner
# ---------------------------------------------------------------------------

#: (model, full published config?, arrival rate, rows) per spec set
SPEC_SETS = {
    "one-smoke": [(MLA, False, 2.0, 20)],
    "coloc-full": [(MOE, True, 0.5, 12), (MOON, True, 0.1, 8),
                   (MLA, True, 1.0, 30)],
    "with-ssm": [(MLA, False, 4.0, 6), (MAMBA, True, 0.3, 10)],
}


def _specs(which, seed=0):
    """The same spec set for both packages: numpy joint rows from one
    seed, each package's own config."""
    rng = np.random.default_rng(seed)
    j_specs, t_specs = [], []
    for name, full, rate, n in SPEC_SETS[which]:
        rows = (rng.integers(16, 4000, n).astype(float),
                rng.integers(1, 600, n).astype(float),
                rng.uniform(0.5, 40.0, n))
        jc = get_config(name) if full else get_smoke_config(name)
        tc = t_config(name) if full else t_smoke(name)
        j_specs.append(j_planner.WorkloadSpec(jc, rate, *rows))
        t_specs.append(t_planner.WorkloadSpec(tc, rate, *rows))
    return j_specs, t_specs


def _same_plan(got, want):
    """Field by field: the same numbers, not close ones."""
    g, w = dataclasses.asdict(got), dataclasses.asdict(want)
    assert g == w


@pytest.mark.parametrize("which", sorted(SPEC_SETS))
def test_planner_equals_reference(which):
    """``plan_pool``, ``split_device_budget`` and ``replan_split`` give the
    reference's plans on the same specs and seed, and the worst-case
    baselines agree."""
    j_specs, t_specs = _specs(which)
    kw = dict(page_bytes=4096, horizon_s=300.0, n_trials=2, seed=5)
    _same_plan(t_planner.plan_pool(t_specs, **kw),
               j_planner.plan_pool(j_specs, **kw))
    total = 1 << 40                       # 1 TiB: room for the full configs
    kw = dict(page_bytes=16384, slab_bytes=1 << 20, horizon_s=300.0,
              n_trials=2, seed=3, coresident=2)
    _same_plan(t_planner.split_device_budget(t_specs, total, **kw),
               j_planner.split_device_budget(j_specs, total, **kw))
    for frac in (0.0, 0.4):
        kw = dict(page_bytes=16384, slab_bytes=1 << 20, window_s=30.0,
                  seed=7, cached_token_fraction=frac)
        _same_plan(t_planner.replan_split(t_specs, total, **kw),
                   j_planner.replan_split(j_specs, total, **kw))
    assert t_planner.worst_case_weight_bytes(t_specs) == \
        j_planner.worst_case_weight_bytes(j_specs)
    assert t_planner.worst_case_pages(t_specs, 16384, horizon_s=120.0) == \
        j_planner.worst_case_pages(j_specs, 16384, horizon_s=120.0)
    for (jc, tc) in zip(j_specs, t_specs):
        assert t_wp.slabs_for_config(tc.model) == \
            j_wp.slabs_for_config(jc.model)


def test_planner_refuses_a_budget_that_cannot_serve():
    j_specs, t_specs = _specs("coloc-full")
    kw = dict(horizon_s=60.0, n_trials=1)
    with pytest.raises(ValueError):
        j_planner.split_device_budget(j_specs, 1 << 20, **kw)
    with pytest.raises(ValueError):
        t_planner.split_device_budget(t_specs, 1 << 20, **kw)


# ---------------------------------------------------------------------------
# (b) the virtualizer's swap tier and resize
# ---------------------------------------------------------------------------

def _virt_pair(budget):
    models = PAPER_COLOC_SET
    jv = j_virt.KVVirtualizer(
        {n: get_smoke_config(n).replace(dtype="float32") for n in models},
        page_budget=budget, page_bytes=4096, dtype=jnp.float32)
    tv = t_virt.KVVirtualizer(
        {n: t_smoke(n).replace(dtype="float32") for n in models},
        page_budget=budget, page_bytes=4096, dtype=torch.float32,
        device="cpu")
    return jv, tv


def _fill(jv, tv, rid):
    """Write the same random rows into a fresh request's pages of both
    pools, so a move that loses or swaps bytes shows."""
    ids = [p for _, _, p in tv.requests[rid].device_entries()]
    rows = np.random.default_rng(rid).standard_normal(
        (len(ids), tv.page_elems)).astype(np.float32)
    jv.pool = j_virt._pool_row_scatter(jv.pool, jnp.asarray(ids, jnp.int32),
                                       jnp.asarray(rows))
    t_virt._pool_row_scatter(tv.pool, torch.tensor(ids),
                             torch.from_numpy(rows))


def _same_virt(jv, tv):
    assert tv.page_budget == jv.page_budget
    assert tv.free_list == jv.free_list
    assert tv.swap_free == jv.swap_free
    assert tv.swapped_now == jv.swapped_now
    assert tv.utilization() == jv.utilization()
    assert sorted(tv.requests) == sorted(jv.requests)
    j_pool = np.asarray(jv.pool)
    for rid, jr in jv.requests.items():
        tr = tv.requests[rid]
        assert (tr.tokens, tr.tables, tr.state_pages, tr.n_swapped) == \
            (jr.tokens, jr.tables, jr.state_pages, jr.n_swapped)
        ids = [p for _, _, p in jr.device_entries()]
        np.testing.assert_array_equal(tv.pool[ids].numpy(), j_pool[ids])
        slots = [s for _, _, s in jr.swapped_entries()]
        if slots:
            np.testing.assert_array_equal(tv.swap_buffer[slots].numpy(),
                                          jv.swap_buffer[slots])


@settings(max_examples=15, deadline=None)
@given(ops=st.lists(
    st.tuples(st.sampled_from(["register", "extend", "release", "swap",
                               "fault", "grow", "shrink"]),
              st.sampled_from(list(PAPER_COLOC_SET)),
              st.integers(1, 600)),
    min_size=1, max_size=30))
def test_swap_and_resize_sequences_equal_reference(ops):
    """The reference's property sequence (``tests/test_elastic.py``) on
    both packages' virtualizers: after every op the same verdict, tables,
    free list, swap slots, ``utilization()`` and mapped bytes; the port
    also keeps the reference's invariants (no page lost or aliased)."""
    jv, tv = _virt_pair(64)
    live, next_id = [], 0
    for op, model, arg in ops:
        if op == "register" or not live:
            op = "register"
        rid = live[0] if live else next_id
        outs = []
        for v, err in ((jv, j_virt.OutOfPagesError),
                       (tv, t_virt.OutOfPagesError)):
            try:
                if op == "register":
                    v.register_request(next_id, model, arg)
                elif op == "extend":
                    v.extend_request(rid, arg)
                elif op == "release":
                    v.release_request(rid)
                elif op == "swap":
                    v.swap_out(rid, max_pages=arg)
                elif op == "fault":
                    v.ensure_resident(rid)
                elif op == "grow":
                    v.resize(v.page_budget + (arg % 64) + 1)
                else:
                    v.resize(max(v.page_budget - (arg % 64) - 1, 1))
                outs.append("ok")
            except err:
                outs.append("oom")
        assert outs[0] == outs[1], (op, outs)
        if op == "register" and outs[0] == "ok":
            _fill(jv, tv, next_id)
            live.append(next_id)
            next_id += 1
        elif op == "release":
            live.remove(rid)
        _check_invariants(tv)
        _same_virt(jv, tv)
    for rid in live:
        tv.release_request(rid)
    assert tv.free_pages == tv.page_budget and tv.swapped_now == 0


def test_batch_tables_refuse_a_swapped_row():
    """A swapped entry (-2 - slot) must never reach a kernel, which reads
    any id < 0 as "no page": the table build and the block reserve raise
    until the request is faulted back in."""
    _, tv = _virt_pair(16)
    tv.register_request(0, MLA, 20)
    assert tv.swap_out(0, max_pages=1) == 1
    with pytest.raises(t_virt.PoolAccountingError):
        tv.batch_tables_host(MLA, [0, None], 4)
    with pytest.raises(t_virt.PoolAccountingError):
        tv.reserve_decode_block(0, 1)
    assert tv.ensure_resident(0) == 1
    assert (tv.batch_tables_host(MLA, [0, None], 4) >= -1).all()


# ---------------------------------------------------------------------------
# (c) the arena's resize
# ---------------------------------------------------------------------------

def test_arena_resize_sequence_equals_reference():
    """Shrink to the floor (LRU eviction, compaction), a refused shrink
    below the pinned set, grow, re-activate: the same slot ids, free
    list, residency and verdicts as the reference; the survivors' bytes
    equal their host masters, through the slot table refreshed in place."""
    j_arena = j_wp.WeightArena(slab_bytes=2048)
    t_arena = t_wp.WeightArena(slab_bytes=2048, device="cpu")
    for name in PAPER_COLOC_SET:
        jcfg, jw, tw = _trees(name, "float32")
        j_arena.add_model(name, jcfg, jw)
        t_arena.add_model(name, t_smoke(name).replace(dtype="float32"), tw)
    j_arena.finalize()
    t_arena.finalize()
    for arena in (j_arena, t_arena):
        for name in PAPER_COLOC_SET:
            arena.activate(name)
        arena.pin(MLA)
        arena.touch(MOE)
    tables = {n: t_arena.slot_table(n) for n in t_arena.residency}
    floor = t_arena.min_slot_budget()
    assert floor == j_arena.min_slot_budget()
    ops = [floor, floor - 1, floor + t_arena.views[MOON].total_slabs,
           ("activate", MOON), floor + t_arena.views[MOON].total_slabs + 7,
           ("unpin", MLA), floor]
    for op in ops:
        outs = []
        for arena, err in ((j_arena, j_wp.OutOfSlabsError),
                           (t_arena, t_wp.OutOfSlabsError)):
            try:
                if isinstance(op, tuple):
                    getattr(arena, op[0])(op[1])
                    outs.append("ok")
                else:
                    outs.append(arena.resize(op))
            except err:
                outs.append("refused")
        assert outs[0] == outs[1], (op, outs)
        assert t_arena.slot_budget == j_arena.slot_budget
        assert t_arena.free_list == j_arena.free_list
        assert t_arena.utilization() == j_arena.utilization()
        assert t_arena.residency_by_model() == j_arena.residency_by_model()
        for n, res in j_arena.residency.items():
            t_res = t_arena.residency[n]
            np.testing.assert_array_equal(t_res.slots, res.slots)
            np.testing.assert_array_equal(t_res.uploaded, res.uploaded)
            table = t_arena.slot_table(n)
            if n in tables:
                assert table.data_ptr() == tables[n].data_ptr()
            rows = t_arena.arena[table.reshape(-1).long()]
            np.testing.assert_array_equal(
                rows.numpy(), t_arena.host_slabs[n].reshape(
                    -1, t_arena.slab_bytes).numpy())
    assert t_arena.resizes == j_arena.resizes > 0


# ---------------------------------------------------------------------------
# (d) telemetry, admission's reserve and the rebalancer
# ---------------------------------------------------------------------------

def _rebalancer_pair(cfg_kw, seed):
    names = PAPER_COLOC_SET[:2]
    out = []
    for virt_mod, wp, elastic, tel, cfg_cls, smoke, w_tree in (
            (j_virt, j_wp, j_elastic, j_tel, JElastic, get_smoke_config, 1),
            (t_virt, t_wp, t_elastic, t_tel, ElasticConfig, t_smoke, 2)):
        cfg = cfg_cls(**cfg_kw)
        models = {n: smoke(n).replace(dtype="float32") for n in names}
        kw = dict(page_budget=64, page_bytes=4096,
                  allocate_device_pool=False)
        if virt_mod is t_virt:
            kw["device"] = "cpu"
        virt = virt_mod.KVVirtualizer(models, **kw)
        arena = (wp.WeightArena(slab_bytes=4096, device="cpu")
                 if wp is t_wp else wp.WeightArena(slab_bytes=4096))
        for n in names:
            arena.add_model(n, models[n], _trees(n, "float32")[w_tree])
        arena.finalize(allocate=False)
        for n in names:
            arena.activate(n)
        telemetry = tel.DemandTelemetry(models, cfg)
        reb = elastic.ElasticRebalancer(virt, arena, telemetry=telemetry,
                                        cfg=cfg, seed=seed)
        out.append((virt, arena, telemetry, reb))
    return out


def _drive(virt, arena, telemetry, reb, out_of_pages):
    """A recorded observation stream on a virtual clock: arrivals,
    completions, live requests registered (and some released) so shrinks
    must swap, and the slotted set protected."""
    m0, m1 = PAPER_COLOC_SET[:2]
    rng = np.random.default_rng(3)
    now, live, decisions = 0.0, [], []
    for step in range(40):
        now += 0.25
        model = m0 if step % 3 else m1
        if step % 2 == 0:
            telemetry.note_arrival(model, now)
            try:
                virt.register_request(step, model, int(rng.integers(8, 90)))
                live.append(step)
            except out_of_pages:
                pass
        if step % 5 == 4 and live:
            rid = live.pop(0)
            req = virt.requests[rid]
            telemetry.note_finish(req.model, req.tokens,
                                  int(rng.integers(2, 8)), now - 1.0, now)
            virt.release_request(rid)
        telemetry.observe(now, virt, arena, None)
        protected = {rid: 4 for rid in live[-2:]}
        live_req = {}
        for rid in live:
            req = virt.requests[rid]
            live_req.setdefault(req.model, []).append((req.tokens, 16))
        d = reb.step(now, protected=protected, live_requests=live_req)
        decisions.append(None if d is None else d.to_record())
    return decisions


@pytest.mark.parametrize("cfg_kw", [
    dict(interval_steps=2, cooldown_steps=2, hysteresis=0.02,
         window_s=40.0, min_page_budget=4),
    dict(interval_steps=1, cooldown_steps=3, hysteresis=0.1,
         window_s=10.0, min_page_budget=8, max_step_fraction=0.25,
         headroom_pages=2, quantile=0.8),
], ids=["fast", "damped"])
def test_rebalancer_decisions_equal_reference(cfg_kw):
    """Both packages' rebalancers, fed one recorded observation stream,
    apply the same decisions (``to_record()`` equal), leave the same
    pools, and conserve the device bytes on every move."""
    (jv, ja, jt, jr), (tv, ta, tt, tr) = _rebalancer_pair(cfg_kw, seed=7)
    want = _drive(jv, ja, jt, jr, j_virt.OutOfPagesError)
    got = _drive(tv, ta, tt, tr, t_virt.OutOfPagesError)
    assert got == want
    assert any(d is not None for d in got), "the stream never rebalanced"
    assert tr.snapshot() == jr.snapshot()
    assert tt.snapshot() == jt.snapshot()
    assert t_tel.arrival_rates(tt, 10.0) == j_tel.arrival_rates(jt, 10.0)
    assert tv.free_list == jv.free_list and ta.free_list == ja.free_list
    assert tv.swap_free == jv.swap_free
    for d in tr.events:
        assert (d.new_page_budget * tv.page_bytes
                + d.new_slot_budget * ta.slab_bytes) <= tr.total_bytes


def test_admission_reserve_equals_reference():
    """``reserve_pages`` held back from every verdict, offer and drain
    alike, as the reference's."""
    out = []
    for virt_mod, adm, smoke, kw in (
            (j_virt, j_adm, get_smoke_config, {}),
            (t_virt, t_adm, t_smoke, dict(device="cpu"))):
        virt = virt_mod.KVVirtualizer({MLA: smoke(MLA)}, page_budget=24,
                                      page_bytes=4096,
                                      allocate_device_pool=False, **kw)
        ctl = adm.AdmissionController(virt)
        log = []
        for reserve in (0, 10, 20):
            ctl.reserve_pages = reserve
            for i in range(3):
                rid = 10 * reserve + i
                log.append(ctl.offer(adm.PendingRequest(
                    rid, MLA, 20 + 7 * i, 4, 0.0), 0.0))
        ctl.reserve_pages = 0
        virt.release_request(0)
        log.append([p.request_id for p in ctl.drain(1.0)])
        log.append((virt.free_list, ctl.queued_count()))
        log.append(virt.can_admit(MLA, 1, 0, reserve=virt.free_pages))
        out.append(log)
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# (e) decode across a forced shrink -> swap-out -> grow -> fault-in cycle
# ---------------------------------------------------------------------------

B, SEQ, N_STEPS, CYCLE_AT, BUDGET = 2, 8, 5, 2, 256
_REFERENCE = {}


def _cycle_setup(name):
    """The reference's pools and dense prefill cache for ``name`` and the
    JAX paged stream's logits (unperturbed), computed once per model."""
    if name in _REFERENCE:
        return _REFERENCE[name]
    cfg = get_smoke_config(name).replace(dtype="float32")
    model = build_model(cfg)
    params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))
    _, _, jpooled = j_pools.build_pools(
        {name: cfg}, {name: jax.tree.map(jnp.asarray, params)},
        page_budget=BUDGET, page_bytes=4096, pool_dtype=jnp.float32)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, SEQ)).astype(np.int32)
    _, cache = model.prefill(jax.tree.map(jnp.asarray, params),
                             jnp.asarray(tokens), model.init_cache(B, 16))
    cache = {k: np.asarray(v) for k, v in cache.items()}
    virt = j_virt.KVVirtualizer({name: cfg}, page_budget=BUDGET,
                                page_bytes=4096, dtype=jnp.float32)
    for b in range(B):
        virt.register_request(b, name, SEQ)
        virt.write_prompt_from_cache(name, b, {k: jnp.asarray(v) for k, v
                                               in cache.items()}, SEQ,
                                     batch_index=b)
    view = virt.views[name]
    max_pages = max(1, math.ceil(16 / view.tokens_per_page))
    step = j_control.PagedFusedStep(jpooled[name])
    logits, tok = [], jnp.zeros((B,), jnp.int32)
    for t in range(N_STEPS):
        for b in range(B):
            virt.extend_request(b, 1)
        got, virt.pool = step(tok, virt.pool,
                              virt.batch_tables(name, [0, 1], max_pages),
                              jnp.full((B,), SEQ + t, jnp.int32))
        logits.append(np.asarray(got))
        tok = jnp.argmax(got, axis=-1).astype(jnp.int32)
    _REFERENCE[name] = (params, cache, logits, max_pages)
    return _REFERENCE[name]


@pytest.mark.parametrize("lowering", [True, False])
@pytest.mark.parametrize("name", [MOE, MLA])
def test_decode_across_forced_cycle_equals_unperturbed_and_reference(
        name, lowering):
    """Two requests decode greedily; mid-stream the ACTIVE requests are
    swapped out, the pool shrinks (compacting nothing), grows back and
    the pages fault in on next touch.  Every step's logits equal the
    unperturbed port stream bit for bit, and the JAX paged stream's
    within 1e-5 — fused step (lowering on) and host-driven step (off)."""
    params, cache, want, max_pages = _cycle_setup(name)
    tcfg = t_smoke(name).replace(dtype="float32")
    _, _, tpooled = t_pools.build_pools(
        {name: tcfg}, {name: params_to_torch(params)}, device="cpu",
        page_budget=BUDGET, page_bytes=4096, pool_dtype=torch.float32)
    step = (t_control.PagedFusedStep(tpooled[name]) if lowering
            else t_control.HostDrivenStep(tpooled[name]))
    mla = tcfg.attention == "mla"
    pair = [torch.tensor(cache["latent" if mla else "k"]),
            torch.tensor(cache["rope" if mla else "v"])]

    def run(perturb):
        virt = t_virt.KVVirtualizer({name: tcfg}, page_budget=BUDGET,
                                    page_bytes=4096, dtype=torch.float32,
                                    device="cpu")
        for b in range(B):
            virt.register_request(b, name, SEQ)
            for layer in range(tcfg.n_layers):
                virt.write_prompt_layer(virt.pool, name, b, layer,
                                        (pair[0][layer], pair[1][layer]),
                                        SEQ, batch_index=b)
        out, tok = [], np.zeros(B, np.int32)
        for t in range(N_STEPS):
            if perturb and t == CYCLE_AT:
                assert virt.swap_out(0) > 0
                virt.swap_out(1)
                virt.resize(max(virt.mapped_pages + 2, 8))
                assert virt.page_budget < BUDGET and virt.mapped_pages == 0
                virt.resize(BUDGET)
            for b in range(B):
                virt.ensure_resident(b)        # the swap tier's next touch
                virt.extend_request(b, 1)
            got, virt.pool = step(
                torch.from_numpy(tok), virt.pool,
                virt.batch_tables(name, [0, 1], max_pages),
                torch.full((B,), SEQ + t, dtype=torch.int32))
            np.testing.assert_allclose(got.numpy(), want[t], rtol=1e-5,
                                       atol=1e-5)
            out.append(got.clone())
            tok = np.argmax(want[t], axis=-1).astype(np.int32)
        if perturb:
            assert virt.swap_in_pages == virt.swap_out_pages > 0
            assert virt.resizes == 2
        return out

    for t, (a, b) in enumerate(zip(run(False), run(True))):
        assert torch.equal(a, b), f"step {t} diverged across the cycle"


# ---------------------------------------------------------------------------
# (f) the engine
# ---------------------------------------------------------------------------

BURST_MODELS = (MLA, MOE)
BURST_KW = dict(page_budget=24, page_bytes=4096, slab_bytes=4096,
                max_batch=4, max_ctx=64)
BURST_ELASTIC = dict(interval_steps=1, cooldown_steps=1, hysteresis=0.05,
                     window_s=60.0, min_page_budget=8, quantile=0.95)


def _burst(request_cls, n=6):
    """``TestEngineElastic``'s burst: minicpm3 (dense FFN, so its tokens
    do not depend on batch composition), all at time 0."""
    rng = np.random.default_rng(11)
    vocab = get_smoke_config(MLA).vocab_size
    return [request_cls(i, MLA, 16, 3, 0.0,
                        prompt_ids=rng.integers(0, vocab, 16))
            for i in range(n)]


@pytest.fixture(scope="module")
def burst():
    """The models, the reference's params for them (the JAX engine draws
    the same ones), and the streams a live JAX elastic engine emits."""
    jm = {n: get_smoke_config(n).replace(dtype="float32")
          for n in BURST_MODELS}
    params = {n: jax.tree.map(np.asarray,
                              build_model(c).init(jax.random.PRNGKey(i)))
              for i, (n, c) in enumerate(jm.items())}
    je = JEngine(jm, config=JConfig(mode=JMode(pipeline=True, lowering=True),
                                    elastic=JElastic(**BURST_ELASTIC)),
                 **BURST_KW)
    j_reqs = _burst(JRequest)
    je.run(j_reqs)
    assert je.stats.rebalance_events
    return params, [r.output_ids for r in j_reqs]


def _port_engine(params, elastic, lowering, **kw):
    tm = {n: t_smoke(n).replace(dtype="float32") for n in BURST_MODELS}
    return TEngine(tm, config=EngineConfig(
        mode=TMode(pipeline=True, lowering=lowering), elastic=elastic),
        device="cpu", params={n: params_to_torch(p)
                              for n, p in params.items()},
        **dict(BURST_KW, **kw))


@pytest.mark.parametrize("lowering", [True, False])
def test_burst_rebalances_with_frozen_and_reference_streams(burst, lowering):
    """Under the page-pressure burst the port's elastic engine grows the
    KV pool out of the idle arena slack, conserves device bytes on every
    move, returns every page, and emits the port's frozen engine's
    greedy streams and the live JAX elastic engine's."""
    params, want = burst
    eng_e = _port_engine(params, ElasticConfig(**BURST_ELASTIC), lowering)
    eng_f = _port_engine(params, None, lowering)
    reqs_e, reqs_f = _burst(TRequest), _burst(TRequest)
    stats_e = eng_e.run(reqs_e)
    stats_f = eng_f.run(reqs_f)
    assert stats_e.tokens_out == stats_f.tokens_out == 6 * 3
    assert [r.output_ids for r in reqs_e] == [r.output_ids for r in reqs_f]
    assert [r.output_ids for r in reqs_e] == want
    events = stats_e.rebalance_events
    assert any(e.kv_delta_bytes > 0 for e in events), "the burst never grew"
    assert eng_e.virt.page_budget > BURST_KW["page_budget"]
    for e in events:
        assert (e.page_budget[1] * eng_e.virt.page_bytes
                + e.slot_budget[1] * eng_e.arena.slab_bytes) \
            <= eng_e.rebalancer.total_bytes
    assert eng_e.virt.mapped_pages == 0 and eng_e.virt.swapped_now == 0
    assert stats_e.elastic["rebalances"] == len(events)
    assert eng_f.rebalancer is None and not stats_f.rebalance_events


def test_queued_only_load_unblocked_by_rebalance(burst):
    """A request too large for the frozen split queues; with elastic on,
    the queue is the demand signal: the pool grows and the SAME step
    re-drains the front door, so ``run`` keeps making progress."""
    params, _ = burst
    engine = _port_engine(
        params, ElasticConfig(interval_steps=1, cooldown_steps=1,
                              hysteresis=0.05, min_page_budget=4,
                              max_step_fraction=64.0, window_s=60.0),
        True, page_budget=4, page_bytes=1024, max_batch=2)
    req = TRequest(0, MLA, 32, 2, 0.0)
    assert not engine.virt.can_admit(MLA, 32, 2)
    stats = engine.run([req])
    assert engine.rebalancer.events, "queue pressure never rebalanced"
    assert engine.virt.page_budget > 4
    assert req.finish_time > 0 and stats.tokens_out == 2
