"""The port's control layer against the JAX package: the host-driven
lowering and the layer pipeline scheduler, the fused steps, the pool
write and the sampler.

Both frameworks get the same params (the reference's init through
``repro_torch.bridge``), float32 smoke configs, on the CPU (the port's
plain kernel versions; the graphs are card-only and held against the
eager body in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import PAPER_COLOC_SET, get_smoke_config
from repro.configs.base import EngineConfig as JConfig
from repro.core import control as j_control
from repro.core import pipeline as j_pipe
from repro.core import pools as j_pools
from repro.kernels import ops as j_ops
from repro.models import build_model
from repro.runtime import sampler as j_sampler
from repro.runtime.engine import CrossPoolEngine as JEngine
from repro.runtime.engine import EngineMode as JMode
from repro.runtime.request import Request as JRequest
from repro_torch.bridge import params_to_torch
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs.base import EngineConfig
from repro_torch.core import control as t_control
from repro_torch.core import pipeline as t_pipe
from repro_torch.core import pools as t_pools
from repro_torch.kernels import ops as t_ops
from repro_torch.runtime import sampler as t_sampler
from repro_torch.runtime.engine import CrossPoolEngine as TEngine
from repro_torch.runtime.engine import EngineMode as TMode
from repro_torch.runtime.request import Request as TRequest
from test_torch_engine import ENGINE_KW, TRACE
from torch_threads import one_torch_thread  # noqa: F401

MOE, MLA, MOON = "qwen3-moe-235b-a22b", "minicpm3-4b", "moonshot-v1-16b-a3b"
PROMPTS = {MOE: 7, MLA: 5, MOON: 9}
POOL_KW = dict(page_budget=256, page_bytes=4096, slab_bytes=4096)
MAX_PAGES = 8


@pytest.fixture(scope="module")
def coloc():
    """(jax configs, torch configs, the reference's init params as numpy)."""
    jm = {n: get_smoke_config(n).replace(dtype="float32")
          for n in PAPER_COLOC_SET}
    tm = {n: t_smoke(n).replace(dtype="float32") for n in PAPER_COLOC_SET}
    params = {n: jax.tree.map(np.asarray,
                              build_model(c).init(jax.random.PRNGKey(i)))
              for i, (n, c) in enumerate(jm.items())}
    return jm, tm, params


def _pools(coloc):
    """Fresh pools of both packages over the same params, one request
    registered per model: ((virt, pooled) of JAX, (virt, pooled) of the
    port)."""
    jm, tm, params = coloc
    jkv_pool, _, jpooled = j_pools.build_pools(
        jm, {n: jax.tree.map(jnp.asarray, p) for n, p in params.items()},
        pool_dtype=jnp.float32, **POOL_KW)
    tkv_pool, _, tpooled = t_pools.build_pools(
        tm, {n: params_to_torch(p) for n, p in params.items()}, device="cpu",
        pool_dtype=torch.float32, **POOL_KW)
    out = []
    for virt in (jkv_pool.virtualizer, tkv_pool.virtualizer):
        for rid, name in enumerate(PAPER_COLOC_SET):
            virt.register_request(rid, name, PROMPTS[name])
        out.append(virt)
    return (out[0], jpooled), (out[1], tpooled)


def _prompt(name):
    rng = np.random.default_rng(len(name))
    return rng.integers(0, 256, (1, PROMPTS[name])).astype(np.int32)


def _writer(virt, name, rid):
    def writer(layer, layer_kv, pool):
        return virt.write_prompt_layer(pool, name, rid, layer, layer_kv,
                                       PROMPTS[name])
    return writer


def _close(got: torch.Tensor, want, tol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# host-driven lowering and the layer pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pipeline", [True, False])
def test_host_mode_streams_equal_live_jax_engine(coloc, pipeline):
    """lowering=False, pipeline on and off: the TRACE of
    ``test_torch_engine.py`` through both engines (same params and seed)
    gives the same greedy streams, prefill batch sizes and peak page use,
    and every page returns."""
    jm, tm, params = coloc
    je = JEngine(jm, config=JConfig(mode=JMode(lowering=False,
                                               pipeline=pipeline)),
                 **ENGINE_KW)
    te = TEngine(tm, config=EngineConfig(mode=TMode(
        lowering=False, pipeline=pipeline)), device="cpu",
        params={n: params_to_torch(p) for n, p in params.items()},
        **ENGINE_KW)
    j_reqs = [JRequest(*t, 0.0) for t in TRACE]
    t_reqs = [TRequest(*t, 0.0) for t in TRACE]
    for r in j_reqs:
        je.submit(r)
    for r in t_reqs:
        te.submit(r)
    je.drain()
    stats = te.drain()
    assert [r.output_ids for r in t_reqs] == [r.output_ids for r in j_reqs]
    assert stats.tokens_out == sum(r.max_new_tokens for r in t_reqs)
    assert stats.prefill_batch_sizes == je.stats.prefill_batch_sizes
    assert te.virt.peak_mapped == je.virt.peak_mapped
    assert te.virt.mapped_pages == 0 == je.virt.mapped_pages
    assert all(r.decode_steps == 1 for r in te.runners.values())
    if pipeline:        # the scheduler ran both phases in both engines
        assert te.scheduler.stage_log == je.scheduler.stage_log
        assert te.scheduler.stage_log


@pytest.mark.parametrize("max_inflight", [1, 2])
def test_scheduler_stage_log_equals_reference(coloc, max_inflight):
    """Prefill batches of the three models, then one decode batch each,
    through both schedulers: the same stages in the same order, the same
    overlap fraction, and the same logits within 1e-5."""
    (jv, jp), (tv, tp) = _pools(coloc)
    dev = jax.devices()[0]
    js = j_pipe.LayerPipelineScheduler(jp, dev, dev)
    ts = t_pipe.LayerPipelineScheduler(tp)
    names = list(PAPER_COLOC_SET)
    jb = [j_pipe.InflightBatch(i, n, tokens=jnp.asarray(_prompt(n)),
                               prefill=True, true_len=PROMPTS[n],
                               kv_writer=_writer(jv, n, i))
          for i, n in enumerate(names)]
    tb = [t_pipe.InflightBatch(i, n, tokens=torch.from_numpy(_prompt(n)),
                               prefill=True, true_len=PROMPTS[n],
                               kv_writer=_writer(tv, n, i))
          for i, n in enumerate(names)]
    j_done, jv.pool = js.run(jb, jv.pool, max_inflight=max_inflight)
    t_done, tv.pool = ts.run(tb, tv.pool, max_inflight=max_inflight)
    assert [b.model for b in t_done] == [b.model for b in j_done]
    for j, t in zip(j_done, t_done):
        _close(t.logits, j.logits)
    nxt = {b.model: int(np.argmax(np.asarray(b.logits)[0])) for b in j_done}
    jb, tb = [], []
    for i, n in enumerate(names):
        for virt in (jv, tv):
            virt.reserve_decode_block(i, 1)
        jb.append(j_pipe.InflightBatch(
            10 + i, n, tokens=jnp.asarray([nxt[n]], jnp.int32),
            page_tables=jv.batch_tables(n, [i], MAX_PAGES),
            lengths=jnp.asarray([PROMPTS[n]], jnp.int32)))
        tb.append(t_pipe.InflightBatch(
            10 + i, n, tokens=torch.tensor([nxt[n]], dtype=torch.int32),
            page_tables=tv.batch_tables(n, [i], MAX_PAGES),
            lengths=torch.tensor([PROMPTS[n]], dtype=torch.int32)))
    j_done, jv.pool = js.run(jb, jv.pool, max_inflight=max_inflight)
    t_done, tv.pool = ts.run(tb, tv.pool, max_inflight=max_inflight)
    for j, t in zip(j_done, t_done):
        _close(t.logits, j.logits)
    assert ts.stage_log == js.stage_log
    assert len(ts.stage_log) == 2 * 2 * sum(
        tp[n].stage_fns.n_layers for n in names)
    assert ts.overlap_fraction() == js.overlap_fraction()
    _close(tv.pool, jv.pool)


def test_host_driven_step_equals_stage_generator_and_reference(coloc):
    """``HostDrivenStep`` (2L+2 host dispatches a token) gives the
    reference's logits within 1e-5; its stage generator yields the
    reference's stages."""
    (jv, jp), (tv, tp) = _pools(coloc)
    dev = jax.devices()[0]
    name, rid = MOE, 0
    first = {}
    for virt, pooled, prefill, arr in (
            (jv, jp, j_control.StreamingPrefill(jp[name]), jnp.asarray),
            (tv, tp, t_control.StreamingPrefill(tp[name]), torch.from_numpy)):
        logits, virt.pool = prefill(arr(_prompt(name)), PROMPTS[name],
                                    virt.pool, _writer(virt, name, rid))
        first[virt] = logits
        virt.reserve_decode_block(rid, 1)
    tok = int(np.argmax(np.asarray(first[jv])[0]))
    jstep = j_control.HostDrivenStep(jp[name], dev, dev)
    want, jv.pool = jstep(jnp.asarray([tok], jnp.int32), jv.pool,
                          jv.batch_tables(name, [rid], MAX_PAGES),
                          jnp.asarray([PROMPTS[name]], jnp.int32))
    tstep = t_control.HostDrivenStep(tp[name])
    args = (torch.tensor([tok], dtype=torch.int32), tv.pool,
            tv.batch_tables(name, [rid], MAX_PAGES),
            torch.tensor([PROMPTS[name]], dtype=torch.int32))
    stages = list(tstep.stage_generator(*args))
    got, _ = tstep.result
    _close(got, want)
    j_stages = list(jstep.stage_generator(
        jnp.asarray([tok], jnp.int32), jv.pool,
        jv.batch_tables(name, [rid], MAX_PAGES),
        jnp.asarray([PROMPTS[name]], jnp.int32)))
    assert stages == j_stages
    again, _ = tstep(*args)              # the same write, the same logits
    torch.testing.assert_close(again, got, rtol=0, atol=0)


@pytest.mark.parametrize("n_layers,fused,k", [(2, True, 1), (4, True, 4),
                                              (2, False, 1), (4, False, 3)])
def test_dispatch_count_equals_reference(n_layers, fused, k):
    assert t_control.dispatch_count(n_layers, fused, k) \
        == j_control.dispatch_count(n_layers, fused, k)


def test_transfer_on_one_stream_is_the_identity():
    x = torch.ones(3)
    assert t_pools.transfer(x, None) is x


# ---------------------------------------------------------------------------
# lowering ON: the fused steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", PAPER_COLOC_SET)
def test_paged_fused_step_equals_reference_and_multistep(coloc, name):
    """``PagedFusedStep`` (K=1, one replay on a card) gives the reference
    ``PagedFusedStep``'s logits within 1e-5, and ``MultiStepFusedStep(k=1)``
    from the same state samples their argmax and writes the same pool."""
    (jv, jp), (tv, tp) = _pools(coloc)
    rid = PAPER_COLOC_SET.index(name)
    for virt, pooled, prefill, arr in (
            (jv, jp, j_control.StreamingPrefill(jp[name]), jnp.asarray),
            (tv, tp, t_control.StreamingPrefill(tp[name]), torch.from_numpy)):
        _, virt.pool = prefill(arr(_prompt(name)), PROMPTS[name],
                               virt.pool, _writer(virt, name, rid))
        virt.reserve_decode_block(rid, 1)
    tok, length = 17, PROMPTS[name]
    want, _ = j_control.PagedFusedStep(jp[name])(
        jnp.asarray([tok], jnp.int32), jv.pool,
        jv.batch_tables(name, [rid], MAX_PAGES),
        jnp.asarray([length], jnp.int32))
    tables = tv.batch_tables_host(name, [rid], MAX_PAGES).copy()
    pool0 = tv.pool.clone()
    got, _ = t_control.PagedFusedStep(tp[name])(
        np.array([tok], np.int32), tv.pool, tables,
        np.array([length], np.int32))
    _close(got, want)
    multi = t_control.MultiStepFusedStep(tp[name], k=1)
    toks, _ = multi(np.array([tok], np.int32), pool0, tables,
                    np.array([length], np.int32), np.array([1], np.int32))
    assert toks.tolist() == [[int(torch.argmax(got[0]))]]
    torch.testing.assert_close(pool0, tv.pool, rtol=0, atol=0)


def test_temperature_block_replays_from_its_seed(coloc):
    """A K=3 block with temperature and top-k: the same seed gives the
    same tokens, every token is among the step's top k (checked against
    greedy's logits through ``PagedFusedStep`` on a copy of the state)."""
    _, (tv, tp) = _pools(coloc)
    name, rid = MOE, 0
    _, tv.pool = t_control.StreamingPrefill(tp[name])(
        torch.from_numpy(_prompt(name)), PROMPTS[name], tv.pool,
        _writer(tv, name, rid))
    tv.reserve_decode_block(rid, 3)
    tables = tv.batch_tables_host(name, [rid], MAX_PAGES).copy()
    step = t_control.MultiStepFusedStep(tp[name], k=3, temperature=0.8,
                                        top_k=5)
    args = (np.array([17], np.int32), tables,
            np.array([PROMPTS[name]], np.int32), np.array([3], np.int32))
    pool0 = tv.pool.clone()
    out = [step(args[0], tv.pool.clone(), *args[1:], seed=s)[0].tolist()
           for s in (4, 4, 5)]
    assert out[0] == out[1]
    assert all(t >= 0 for row in out[0] for t in row)
    logits, _ = t_control.PagedFusedStep(tp[name])(
        args[0], pool0, tables, args[2])
    top = set(torch.topk(logits[0], 5).indices.tolist())
    assert out[0][0][0] in top and out[2][0][0] in top


# ---------------------------------------------------------------------------
# the pool write and the sampler
# ---------------------------------------------------------------------------

def test_paged_kv_write_drops_like_the_reference_scatter():
    """A bf16 pool, float32 rows, ids below 0 mixed in: the kept rows land
    rounded to the pool's type, the dropped rows nowhere, as the
    reference's ``mode="drop"`` scatter."""
    rng = np.random.default_rng(3)
    pool = rng.standard_normal((7, 96)).astype(np.float32)
    kv = rng.standard_normal((6, 24)).astype(np.float32)
    pages = np.array([2, -1, 6, 0, -5, 2], np.int32)
    slots = np.array([0, 1, 3, 2, 0, 3], np.int32)
    want = j_ops.paged_kv_write(jnp.asarray(pool, jnp.bfloat16),
                                jnp.asarray(kv), jnp.asarray(pages),
                                jnp.asarray(slots))
    t_pool = torch.from_numpy(pool).to(torch.bfloat16)
    out = t_ops.paged_kv_write(t_pool, torch.from_numpy(kv),
                               torch.from_numpy(pages),
                               torch.from_numpy(slots))
    assert out is t_pool
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(want, np.float32))


def _chi2(counts: np.ndarray, probs: np.ndarray) -> float:
    expected = probs * counts.sum()
    keep = expected > 0
    return float(((counts[keep] - expected[keep]) ** 2
                  / expected[keep]).sum())


@pytest.mark.parametrize("top_k", [0, 3])
def test_temperature_sampling_matches_reference_in_distribution(top_k):
    """Temperature 0.7 (and top-3): 20000 draws of the port and of the
    reference's ``sample`` each pass a chi-square test against
    softmax(logits / T) (df 5, bound 25.7: p = 1e-4), and top-k never
    emits a token outside the k largest logits."""
    logits = np.array([1.0, 0.2, -0.5, 2.0, 0.9, -1.5], np.float32)
    n, temp = 20000, 0.7
    probs = np.exp(logits / temp)
    if top_k:
        probs[np.argsort(logits)[:-top_k]] = 0.0
    probs /= probs.sum()
    gen = torch.Generator().manual_seed(11)
    got = t_sampler.sample(torch.from_numpy(np.tile(logits, (n, 1))), gen,
                           temperature=temp, top_k=top_k).numpy()
    want = np.asarray(j_sampler.sample(
        jnp.asarray(np.tile(logits, (n, 1))), jax.random.PRNGKey(11),
        temperature=temp, top_k=top_k))
    for draws in (got, want):
        counts = np.bincount(draws, minlength=len(logits))
        assert _chi2(counts, probs) < 25.7
        if top_k:
            assert set(draws.tolist()) <= set(np.argsort(logits)[-top_k:])


def test_sample_on_device_folds_the_step_into_the_seed():
    """Greedy is the first maximal index; a temperature draw is a function
    of (seed, step): the same pair repeats it, another step draws anew."""
    logits = torch.zeros((64, 50))
    logits[:, 7] = logits[:, 9] = 1.0
    assert t_sampler.sample(logits).tolist() == [7] * 64
    draw = [t_sampler.sample_on_device(logits, 3, step, temperature=1.0)
            for step in (0, 0, 1)]
    assert torch.equal(draw[0], draw[1])
    assert not torch.equal(draw[0], draw[2])
    with pytest.raises(ValueError):
        t_sampler.sample(logits, temperature=1.0)


def test_slot_table_keeps_its_address_across_evict_and_reactivate(coloc):
    """The static device slot table a decode graph captures is refreshed in
    place when its model comes back into the arena on other slabs."""
    _, (_, tp) = _pools(coloc)
    arena = tp[MOE].arena
    table = arena.slot_table(MOE)
    old = table.clone()
    arena.evict(MOE)
    arena.activate(MOE)          # the free list hands the slabs back reversed
    again = arena.slot_table(MOE)
    assert again is table
    np.testing.assert_array_equal(again.numpy(), arena.residency[MOE].slots)
    assert not torch.equal(again, old)
