"""The port's radix-tree prefix cache against the JAX package (DESIGN.md
§11): the tree and the virtualizer's refcounts, second-chance tier and
copy-on-write under random operation sequences; the MoE slot offsets;
the suffix attention and the suffix prefill pass; cache-aware admission;
multi-turn serving (cache-on streams equal cache-off streams and a live
JAX engine's, both lowerings, through shed-then-refault and with two
concurrent requests sharing a prefix); a compaction that renumbers tree
pages; and the serve CLI's ``--cache``.

Float32 smoke configs on the CPU (the port's plain kernel versions).
Weights come from the reference's init through ``repro_torch.bridge``.
"""
import ast
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import get_smoke_config
from repro.configs.base import CacheConfig as JCache
from repro.configs.base import EngineConfig as JConfig
from repro.core import admission as j_adm
from repro.core import control as j_control
from repro.core import pools as j_pools
from repro.core import prefix_cache as j_pc
from repro.core import virtualizer as j_virt
from repro.models import attention as j_attn
from repro.models import build_model
from repro.models import moe as j_moe
from repro.runtime.engine import CrossPoolEngine as JEngine
from repro.runtime.engine import EngineMode as JMode
from repro.runtime.request import Request as JRequest
from repro_torch.bridge import params_to_torch
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs.base import CacheConfig, EngineConfig
from repro_torch.core import admission as t_adm
from repro_torch.core import control as t_control
from repro_torch.core import pools as t_pools
from repro_torch.core import prefix_cache as t_pc
from repro_torch.core import virtualizer as t_virt
from repro_torch.launch import serve
from repro_torch.models import attention as t_attn
from repro_torch.models import moe as t_moe
from repro_torch.runtime.engine import CrossPoolEngine as TEngine
from repro_torch.runtime.engine import EngineMode as TMode
from repro_torch.runtime.request import Request as TRequest
from test_prefix_cache import _check_invariants
from torch_threads import one_torch_thread  # noqa: F401

MOE, MLA = "qwen3-moe-235b-a22b", "minicpm3-4b"
#: 512-byte f32 pages: 4 qwen3-moe tokens, 5 minicpm3 tokens a page, so
#: prompts of a few tokens span full chunks AND a fork chunk
SMALL_PAGES = 512


def _configs(names=(MOE, MLA)):
    return ({n: get_smoke_config(n).replace(dtype="float32") for n in names},
            {n: t_smoke(n).replace(dtype="float32") for n in names})


@functools.cache
def _params(name):
    """The reference's init of one smoke model as numpy (PRNGKey(0): what
    a one-model JAX engine draws for itself)."""
    cfg = get_smoke_config(name).replace(dtype="float32")
    return jax.tree.map(np.asarray, build_model(cfg).init(
        jax.random.PRNGKey(0)))


def _close(got, want, tol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# (a) the tree and the virtualizer under random operation sequences
# ---------------------------------------------------------------------------

def _tree_state(cache):
    return [(n.tokens, list(n.pages), n.last_touch,
             None if n.routes is None else np.asarray(n.routes).tolist())
            for n in cache._walk()]


def _same_state(jv, jc, tv, tc):
    """Tables, refcounts, free lists, swap slots, the tree and
    ``snapshot()`` equal, and the reference's invariants hold on the
    port."""
    assert tv.free_list == jv.free_list
    assert tv.swap_free == jv.swap_free
    assert tv.swapped_now == jv.swapped_now
    assert tv._refs == jv._refs
    assert sorted(tv.requests) == sorted(jv.requests)
    for rid, jr in jv.requests.items():
        tr = tv.requests[rid]
        assert (tr.tokens, tr.tables, tr.n_swapped) == \
            (jr.tokens, jr.tables, jr.n_swapped)
    assert tc.snapshot() == jc.snapshot()
    assert tc.device_pages() == jc.device_pages()
    assert _tree_state(tc) == _tree_state(jc)
    assert tv.accounting_snapshot() == jv.accounting_snapshot()
    _check_invariants(tv, tc)


def _pair(budget=64, fraction=0.4, second_chance=True):
    jm, tm = _configs()
    jv = j_virt.KVVirtualizer(jm, page_budget=budget, page_bytes=4096,
                              allocate_device_pool=False)
    tv = t_virt.KVVirtualizer(tm, page_budget=budget, page_bytes=4096,
                              allocate_device_pool=False, device="cpu")
    kw = dict(enabled=True, max_pages_fraction=fraction,
              second_chance=second_chance)
    return (jv, j_pc.PrefixCache(jv, JCache(**kw)),
            tv, t_pc.PrefixCache(tv, CacheConfig(**kw)))


def _both(fn_j, fn_t):
    """Run one operation on both packages: the same verdict (raised
    ``OutOfPagesError`` or not) and the same result."""
    try:
        want = fn_j()
    except j_virt.OutOfPagesError:
        with pytest.raises(t_virt.OutOfPagesError):
            fn_t()
        return None
    got = fn_t()
    assert got == want
    return got


_OPS = st.lists(
    st.tuples(st.sampled_from(["produce", "share", "shed", "evict",
                               "release", "fault"]),
              st.integers(0, 2 ** 30)),
    min_size=5, max_size=40)


@settings(max_examples=15, deadline=None)
@given(_OPS, st.integers(0, 2 ** 30), st.booleans())
def test_tree_and_virtualizer_equal_reference(ops, seed, second_chance):
    """The reference's property sequence (``tests/test_prefix_cache.py``)
    with a fault operation added, on both packages: after every op the
    same verdict, tables, refcounts, free list, swap slots, tree (tokens,
    pages, LRU stamps, routes) and ``snapshot()``; the port keeps the
    reference's invariants (no leak, no alias, refcount = holders)."""
    rng = np.random.default_rng(seed)
    jv, jc, tv, tc = _pair(second_chance=second_chance)
    base = rng.integers(0, 4, 48).astype(np.int32)
    live = []
    next_rid = [0]

    def ids_for(arg):
        n = 4 + arg % 29
        tail = rng.integers(0, 4, n - min(n, len(base))).astype(np.int32)
        return np.concatenate([base[:min(n, len(base))], tail])

    def produce(virt, cache, model, ids, rid, routes):
        virt.register_request(rid, model, len(ids))
        view = virt.views[model]
        rp = virt.requests[rid]
        n_chunks = -(-len(ids) // view.tokens_per_page)
        return cache.insert(model, 64, ids,
                            [[rp.tables[l][c] for l in range(view.n_kv_layers)]
                             for c in range(n_chunks)], routes)

    def share(virt, cache, model, ids, rid):
        matched, nodes = cache.match_prefix(model, 64, ids)
        fork = min(matched, len(ids) - 1)
        tpp = virt.views[model].tokens_per_page
        n_full, rem = fork // tpp, fork % tpp
        if fork > 0:
            cache.fault_chunks(nodes[:n_full + (1 if rem else 0)])
            virt.register_request_with_prefix(
                rid, model, len(ids), [n.pages for n in nodes[:n_full]],
                nodes[n_full].pages if rem else None)
        else:
            virt.register_request(rid, model, len(ids))
        return fork

    def fault(cache, model, ids):
        _, nodes = cache.match_prefix(model, 64, ids)
        return cache.fault_chunks(nodes)

    for op, arg in ops:
        model = (MOE, MLA)[arg % 2]
        if op in ("produce", "share"):
            ids = ids_for(arg)
            rid = next_rid[0]
            next_rid[0] += 1
            if op == "produce":
                routes = None if model == MLA else rng.integers(
                    0, 8, (len(ids), 2, 2)).astype(np.int32)
                done = _both(lambda: produce(jv, jc, model, ids, rid, routes),
                             lambda: produce(tv, tc, model, ids, rid, routes))
            else:
                done = _both(lambda: share(jv, jc, model, ids, rid),
                             lambda: share(tv, tc, model, ids, rid))
            if done is not None:
                live.append(rid)
        elif op == "shed":
            _both(lambda: jc.shed(1 + arg % 8), lambda: tc.shed(1 + arg % 8))
        elif op == "evict":
            _both(lambda: jc.evict(1 + arg % 8),
                  lambda: tc.evict(1 + arg % 8))
        elif op == "fault":
            ids = ids_for(arg)
            _both(lambda: fault(jc, model, ids), lambda: fault(tc, model, ids))
        elif live:
            rid = live.pop(arg % len(live))
            jv.release_request(rid)
            tv.release_request(rid)
        _same_state(jv, jc, tv, tc)
    for rid in live:
        jv.release_request(rid)
        tv.release_request(rid)
    _both(lambda: jc.evict(jv.page_budget), lambda: tc.evict(tv.page_budget))
    _same_state(jv, jc, tv, tc)
    assert tc.device_pages_held == 0
    assert tv.free_pages + tv.swapped_now == tv.page_budget


def test_fork_copy_and_swapped_bytes_are_exact():
    """With a live pool: a fork chunk is copied into fresh pages of every
    layer (the source untouched by later writes into the copy), and a
    chunk shed to the pinned tier faults back with its bytes unchanged."""
    _, tm = _configs()
    virt = t_virt.KVVirtualizer(tm, page_budget=32, page_bytes=SMALL_PAGES,
                                dtype=torch.float32, device="cpu")
    cache = t_pc.PrefixCache(virt, CacheConfig(enabled=True))
    virt.pool.copy_(torch.from_numpy(np.random.default_rng(0).standard_normal(
        tuple(virt.pool.shape)).astype(np.float32)))
    ids = np.arange(10, dtype=np.int32)                  # MLA: 2 chunks of 5
    virt.register_request(0, MLA, 10)
    rp = virt.requests[0]
    cache.insert(MLA, 16, ids, [[rp.tables[l][c] for l in range(2)]
                                for c in range(2)])
    before = virt.pool.clone()
    matched, nodes = cache.match_prefix(MLA, 16, np.r_[ids[:7], 99, 98])
    assert matched == 7 and [n.n_tokens for n in nodes] == [5, 5]
    virt.register_request_with_prefix(1, MLA, 9, [nodes[0].pages],
                                      nodes[1].pages)
    new = virt.requests[1]
    for layer in range(2):
        assert new.tables[layer][0] == rp.tables[layer][0]       # shared
        src, dst = rp.tables[layer][1], new.tables[layer][1]
        assert src != dst
        assert torch.equal(virt.pool[dst], before[src])          # the copy
        assert virt.page_refs(rp.tables[layer][0]) == 3
    virt.pool[new.tables[0][1]] += 1.0                           # a write
    for layer in range(2):
        assert torch.equal(virt.pool[rp.tables[layer][1]],
                           before[rp.tables[layer][1]])
    virt.release_request(0)
    virt.release_request(1)
    _, nodes = cache.match_prefix(MLA, 16, ids)
    rows = [virt.pool[n.pages].clone() for n in nodes]
    held = cache.device_pages_held
    assert cache.shed(held) == held
    assert cache.device_pages_held == 0 and virt.swapped_now == held
    assert all(n.swapped for n in nodes)
    virt.pool.zero_()                     # nothing left on the device
    assert cache.fault_chunks(nodes) == held
    for n, want in zip(nodes, rows):
        assert torch.equal(virt.pool[n.pages], want)
    _check_invariants(virt, cache)


# ---------------------------------------------------------------------------
# (b) MoE slot offsets and the suffix attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("capacity", [3, 8])
def test_dispatch_indices_with_offset_exact(capacity):
    rng = np.random.default_rng(capacity)
    experts = rng.integers(0, 8, (13, 2)).astype(np.int32)
    offset = rng.integers(0, 6, 8).astype(np.int32)
    for off in (None, offset):
        j_slot, j_keep = j_moe.dispatch_indices(
            jnp.asarray(experts), 8, capacity,
            offset=None if off is None else jnp.asarray(off))
        t_slot, t_keep = t_moe.dispatch_indices(
            torch.from_numpy(experts), 8, capacity,
            offset=None if off is None else torch.from_numpy(off))
        np.testing.assert_array_equal(t_slot.numpy(), np.asarray(j_slot))
        np.testing.assert_array_equal(t_keep.numpy(), np.asarray(j_keep))


@pytest.mark.parametrize("capacity", [4, 16])
def test_apply_moe_with_slot_offset(capacity):
    """A slot offset pushes pairs past capacity (dropped: they add 0):
    within 1e-5 of the reference, with and without the offset."""
    jcfg, tcfg = (c[MOE] for c in _configs((MOE,)))
    p = jax.tree.map(np.asarray, j_moe.init_moe(jax.random.PRNGKey(5), jcfg,
                                                jnp.float32))
    x = np.random.default_rng(1).standard_normal(
        (1, 9, jcfg.d_model)).astype(np.float32)
    offset = np.arange(jcfg.n_experts, dtype=np.int32) % 5
    for off in (None, offset):
        want, _ = j_moe.apply_moe(
            jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg,
            capacity=capacity, slot_offset=None if off is None
            else jnp.asarray(off))
        got, _ = t_moe.apply_moe(
            params_to_torch(p), torch.from_numpy(x), tcfg, capacity=capacity,
            slot_offset=None if off is None else torch.from_numpy(off))
        _close(got, want)


@pytest.mark.parametrize("name", [MOE, MLA])
def test_suffix_attention_equals_reference(name):
    """``gqa_suffix`` / ``mla_suffix`` with a fork mid-page (fork 7) and a
    KV extent past fork + S (16 > 7 + 5): within 1e-5."""
    jcfg, tcfg = (c[name] for c in _configs((name,)))
    p_l = jax.tree.map(lambda a: np.asarray(a[0]),
                       _params(name)["layers"])["attn"]
    rng = np.random.default_rng(2)
    fork, S, extent = 7, 5, 16
    x = rng.standard_normal((1, S, jcfg.d_model)).astype(np.float32)
    pos = (np.arange(S) + fork)[None, :].astype(np.int32)
    if jcfg.attention == "mla":
        m = jcfg.mla
        a = rng.standard_normal((1, fork, m.kv_lora_rank)).astype(np.float32)
        b = rng.standard_normal((1, fork, m.qk_rope_head_dim)) \
            .astype(np.float32)
        j_fn, t_fn = j_attn.mla_suffix, t_attn.mla_suffix
    else:
        shape = (1, fork, jcfg.n_kv_heads, jcfg.head_dim)
        a = rng.standard_normal(shape).astype(np.float32)
        b = rng.standard_normal(shape).astype(np.float32)
        j_fn, t_fn = j_attn.gqa_suffix, t_attn.gqa_suffix
    want, (wa, wb) = j_fn(jax.tree.map(jnp.asarray, p_l), jcfg,
                          jnp.asarray(x), jnp.asarray(pos), jnp.asarray(a),
                          jnp.asarray(b), extent)
    got, (ga, gb) = t_fn(params_to_torch(p_l), tcfg, torch.from_numpy(x),
                         torch.from_numpy(pos), torch.from_numpy(a),
                         torch.from_numpy(b), extent)
    for g, w in ((got, want), (ga, wa), (gb, wb)):
        _close(g, w)


# ---------------------------------------------------------------------------
# (c) the suffix prefill pass
# ---------------------------------------------------------------------------

def _suffix_run(pkg, name, prompt, fork):
    """On one package: request 0 prefills ``prompt`` (bucket 16, routes
    captured); request 1 maps its first ``fork`` tokens (full chunks
    shared, the fork chunk copied) and prefills the rest through
    ``StreamingPrefill.suffix``.  Returns numpy (full logits, suffix
    logits, request 0's rows, request 1's rows, request 0's rows after
    the suffix pass, the suffix's captured routes)."""
    jm, tm = _configs((name,))
    kw = dict(page_budget=64, page_bytes=SMALL_PAGES, slab_bytes=4096)
    if pkg == "jax":
        kv, _, pooled = j_pools.build_pools(
            jm, {name: jax.tree.map(jnp.asarray, _params(name))},
            pool_dtype=jnp.float32, **kw)
        sp = j_control.StreamingPrefill(pooled[name])
        arr = jnp.asarray
    else:
        kv, _, pooled = t_pools.build_pools(
            tm, {name: params_to_torch(_params(name))}, device="cpu",
            pool_dtype=torch.float32, **kw)
        sp = t_control.StreamingPrefill(pooled[name])
        arr = torch.from_numpy
    virt = kv.virtualizer
    cfg = jm[name]
    n = len(prompt)
    moe = cfg.is_moe

    def writer(rid, count, start):
        def write(layer, layer_kv, pool):
            return virt.write_prompt_layer(pool, name, rid, layer, layer_kv,
                                           count, start=start)
        return write

    def numpy(t):
        return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)

    toks = np.zeros((1, 16), np.int32)
    toks[0, :n] = prompt
    virt.register_request(0, name, n)
    full, virt.pool = sp(arr(toks), n, virt.pool, writer(0, n, 0),
                         capture_routes=moe)
    routes = sp.captured_routes
    rows0 = numpy(virt.gather_prompt_rows(name, 0, n))
    tpp = virt.views[name].tokens_per_page
    n_full = fork // tpp
    tabs = virt.requests[0].tables
    virt.register_request_with_prefix(
        1, name, n, [[t[c] for t in tabs] for c in range(n_full)],
        [t[n_full] for t in tabs])
    offsets, capacity = None, 0
    if moe:
        offsets = np.stack([np.bincount(routes[:fork, layer].ravel(),
                                        minlength=cfg.n_experts)
                            .astype(np.int32)
                            for layer in range(cfg.n_layers)])
        capacity = j_moe.expert_capacity(16, cfg)
    suf = np.zeros((1, 16), np.int32)
    suf[0, :n - fork] = prompt[fork:]
    prefix_rows = virt.gather_prompt_rows(name, 1, fork)
    logits, virt.pool = sp.suffix(
        arr(suf), n - fork, fork, 16, prefix_rows, virt.pool,
        writer(1, n - fork, fork), offsets, capacity, capture_routes=moe)
    return (numpy(full), numpy(logits), rows0,
            numpy(virt.gather_prompt_rows(name, 1, n)),
            numpy(virt.gather_prompt_rows(name, 0, n)), sp.captured_routes,
            routes)


@pytest.mark.parametrize("name", [MOE, MLA])
def test_streaming_suffix_equals_full_pass_and_reference(name):
    """The suffix pass (fork 9: two full qwen3-moe chunks of 4 + one
    token, or one minicpm3 chunk of 5 + four; MoE slot offsets from the
    first pass's routes) gives the port's own full pass's logits and
    rows at the same positions, leaves the shared and copied-from rows
    unchanged, and is within 1e-5 of the JAX package's suffix pass."""
    prompt = np.random.default_rng(4).integers(0, 256, 13).astype(np.int32)
    fork = 9
    t_full, t_suf, t_rows0, t_rows1, t_after, t_routes, t_first = \
        _suffix_run("torch", name, prompt, fork)
    j_full, j_suf, _, j_rows1, _, j_routes, _ = \
        _suffix_run("jax", name, prompt, fork)
    _close(t_suf, t_full)
    _close(t_rows1[:, fork:], t_rows0[:, fork:])
    np.testing.assert_array_equal(t_rows1[:, :fork], t_rows0[:, :fork])
    np.testing.assert_array_equal(t_after, t_rows0)   # source never written
    _close(t_suf, j_suf)
    _close(t_rows1, j_rows1)
    if t_routes is not None:
        np.testing.assert_array_equal(t_routes[:13 - fork],
                                      t_first[fork:13])
        np.testing.assert_array_equal(t_routes[:13 - fork],
                                      j_routes[:13 - fork])


# ---------------------------------------------------------------------------
# (d) cache-aware admission
# ---------------------------------------------------------------------------

def _admission_script(pkg):
    """A scripted admission sequence on one package: producers whose
    prompts go into the tree, hits that map them, and an admission whose
    page deficit sheds the tree.  Returns the observable outcomes."""
    adm, virt_mod, pc, cache_cfg = (
        (j_adm, j_virt, j_pc, JCache) if pkg == "jax"
        else (t_adm, t_virt, t_pc, CacheConfig))
    jm, tm = _configs()
    models = jm if pkg == "jax" else tm
    kw = {} if pkg == "jax" else dict(device="cpu")
    virt = virt_mod.KVVirtualizer(models, page_budget=24,
                                  page_bytes=SMALL_PAGES,
                                  allocate_device_pool=False, **kw)
    cache = pc.PrefixCache(virt, cache_cfg(enabled=True,
                                           max_pages_fraction=0.9))
    ctl = adm.AdmissionController(virt)
    ctl.cache = cache
    rng = np.random.default_rng(9)
    head = rng.integers(0, 256, 14).astype(np.int32)
    out = []
    # (request, model, prompt tokens, shares the head?, releases after)
    script = [(0, MOE, 14, True, [0]), (1, MOE, 18, True, []),
              (2, MLA, 11, True, [1, 2]), (3, MOE, 16, True, []),
              (4, MOE, 60, False, [3]), (5, MOE, 17, True, [4, 5])]
    for rid, model, n, shares, release in script:
        tail = rng.integers(0, 256, 64).astype(np.int32)
        ids = (np.concatenate([head, tail]) if shares else tail)[:n]
        p = adm.PendingRequest(rid, model, n, 2, 0.0, prompt_ids=ids,
                               bucket=64)
        verdict = ctl.offer(p, 0.0)
        out.append((verdict, p.cached_tokens,
                    None if p.prefix_routes is None
                    else p.prefix_routes.tolist()))
        if verdict == "admitted":
            view = virt.views[model]
            rp = virt.requests[rid]
            routes = None if model == MLA else (
                np.arange(n * 4).reshape(n, 2, 2) % 8).astype(np.int32)
            cache.insert(model, 64, ids,
                         [[rp.tables[l][c] for l in range(view.n_kv_layers)]
                          for c in range(-(-n // view.tokens_per_page))],
                         routes)
        for victim in release:
            if victim in virt.requests:
                ctl.finish(virt.requests[victim].model)
                virt.release_request(victim)
        out.append((list(virt.free_list), dict(virt._refs),
                    cache.snapshot()))
    drained = [(p.request_id, p.cached_tokens) for p in ctl.drain(0.0)]
    return out, drained, ctl.stats.admitted, ctl.stats.queued


def test_admission_sequence_equals_reference():
    """Verdicts, ``cached_tokens``, ``prefix_routes``, free lists,
    refcounts and the tree's snapshot equal the JAX package's along a
    script with hits and a deficit that forces a shed."""
    got, want = _admission_script("torch"), _admission_script("jax")
    assert got == want
    last = got[0][-1][2]
    assert last["hits"] >= 2 and last["shed_pages"] > 0


# ---------------------------------------------------------------------------
# (e) multi-turn serving: port vs port cache-off vs a live JAX engine
# ---------------------------------------------------------------------------

_STREAMS = {}


def _drive(pkg, model, *, lowering=True, cache_on=True, shed=False,
           concurrent=False, page_bytes=4096):
    """The reference's multi-turn drive (``tests/test_prefix_cache.py``):
    3 turns, a 17-token first prompt, 3 new tokens, a 2-token delta,
    ``max_ctx=32``.  With ``concurrent`` the first turn's conversation
    forks into two, served at once, that share its prompt.  Returns
    (streams, cached tokens per request, engine)."""
    key = (pkg, model, lowering, cache_on, shed, concurrent, page_bytes)
    if key in _STREAMS:
        return _STREAMS[key]
    jm, tm = _configs((model,))
    kw = dict(page_budget=4096, page_bytes=page_bytes, max_batch=2,
              max_ctx=32, seed=0)
    if pkg == "jax":
        eng = JEngine(jm, config=JConfig(
            mode=JMode(pipeline=False, lowering=lowering),
            cache=JCache(enabled=cache_on)), **kw)
        req_cls = JRequest
    else:
        eng = TEngine(tm, config=EngineConfig(
            mode=TMode(pipeline=False, lowering=lowering),
            cache=CacheConfig(enabled=cache_on)), device="cpu",
            params={model: params_to_torch(_params(model))}, **kw)
        req_cls = TRequest
    rng = np.random.default_rng(7)
    vocab = jm[model].vocab_size

    def delta():
        return rng.integers(0, vocab, 2).astype(np.int32)

    prompts = [rng.integers(0, vocab, 17).astype(np.int32)]
    streams, hits = [], []
    for turn in range(3):
        handles = []
        for ids in prompts:
            req = req_cls(request_id=len(streams) + len(handles),
                          model=model, prompt_tokens=len(ids),
                          max_new_tokens=3, arrival_time=0.0,
                          prompt_ids=ids.copy())
            handles.append((eng.submit(req), req))
        for _ in range(30):
            eng.step()
            if all(h.done for h, _ in handles):
                break
        outs = []
        for h, req in handles:
            assert h.done
            outs.append(np.asarray(req.output_ids, np.int32))
            streams.append(list(req.output_ids))
            hits.append(h.cached_tokens)
        if shed and eng.cache is not None:
            # the whole tree to the swap tier between turns: the next hit
            # faults it back (second chance)
            eng.cache.shed(eng.cache.device_pages_held)
        nxt = [np.concatenate([p, o, delta()])
               for p, o in zip(prompts, outs)]
        if concurrent and len(prompts) == 1:
            nxt.append(np.concatenate([prompts[0], outs[0], delta()]))
        prompts = nxt
    _STREAMS[key] = (streams, hits, eng)
    return _STREAMS[key]


@pytest.mark.parametrize("lowering", [True, False])
@pytest.mark.parametrize("model", [MOE, MLA])
def test_multiturn_streams_equal_cache_off_and_jax(model, lowering):
    """Cache-on streams equal cache-off streams and a live JAX engine's
    cache-on streams; every warm turn hits the previous prompt (17, 22:
    the tree holds committed prompt KV, not output); after the drain the
    tree holds exactly the mapped pages."""
    streams, hits, eng = _drive("torch", model, lowering=lowering)
    assert streams == _drive("torch", model, lowering=lowering,
                             cache_on=False)[0]
    assert streams == _drive("jax", model)[0]
    assert hits == [0, 17, 22]
    snap = eng.cache.snapshot()
    assert snap["hits"] == 2 and snap["hit_tokens"] == 39
    assert snap["device_pages_held"] == eng.virt.mapped_pages
    assert eng.virt.free_pages + eng.virt.mapped_pages \
        == eng.virt.page_budget
    assert all(int(r.nonfinite_logits) == 0 for r in eng.runners.values())


def test_shed_then_refault_streams():
    """The tree shed to the swap tier between turns faults back on the
    next hit: the stream stays the cache-off one."""
    streams, hits, eng = _drive("torch", MOE, shed=True)
    assert streams == _drive("torch", MOE, cache_on=False)[0]
    assert streams == _drive("jax", MOE)[0]
    assert hits == [0, 17, 22]
    assert eng.cache.faulted_pages > 0 and eng.cache.shed_pages > 0


@pytest.mark.parametrize("model", [MOE, MLA])
def test_concurrent_requests_sharing_a_prefix(model):
    """Small pages (full chunks shared read-only, refcount > 1), and two
    requests at once on the first turn's prompt: the streams equal
    cache-off and the live JAX engine's, both requests hit."""
    kw = dict(concurrent=True, page_bytes=SMALL_PAGES)
    streams, hits, eng = _drive("torch", model, **kw)
    assert streams == _drive("torch", model, cache_on=False, **kw)[0]
    j_streams, j_hits, _ = _drive("jax", model, **kw)
    assert streams == j_streams and hits == j_hits
    assert hits == [0, 17, 17, 22, 22]
    assert eng.cache.device_pages_held == eng.virt.mapped_pages


# ---------------------------------------------------------------------------
# (f) compaction renumbers tree pages
# ---------------------------------------------------------------------------

def _shrink_run(pkg, shrink):
    """minicpm3: a first request fills the tree; a second one shares its
    first 10 tokens and diverges (so the tree keeps both tails) and,
    after its first step, the pool shrinks: compaction renumbers the
    request's pages first, then the tree's.  Returns (streams, the
    second request's tables, the tree's pages, the free list and the
    refcounts right after the shrink, engine)."""
    jm, tm = _configs((MLA,))
    kw = dict(page_budget=64, page_bytes=4096, max_batch=2, max_ctx=32,
              seed=0)
    if pkg == "jax":
        eng = JEngine(jm, config=JConfig(mode=JMode(pipeline=False),
                                         cache=JCache(enabled=True)), **kw)
        req_cls = JRequest
    else:
        eng = TEngine(tm, config=EngineConfig(
            mode=TMode(pipeline=False), cache=CacheConfig(enabled=True)),
            device="cpu", params={MLA: params_to_torch(_params(MLA))}, **kw)
        req_cls = TRequest
    rng = np.random.default_rng(3)
    first = rng.integers(0, 256, 17).astype(np.int32)
    prompts = [first, np.concatenate(
        [first[:10], rng.integers(0, 256, 9).astype(np.int32)])]
    streams, moved = [], None
    for rid, prompt in enumerate(prompts):
        req = req_cls(request_id=rid, model=MLA, prompt_tokens=len(prompt),
                      max_new_tokens=6, arrival_time=0.0,
                      prompt_ids=prompt.copy())
        h = eng.submit(req)
        for step in range(30):
            eng.step()
            if rid == 1 and step == 0 and shrink:
                eng.virt.resize(12, protected=[1])
                moved = (eng.virt.requests[1].tables,
                         eng.cache.device_pages(), list(eng.virt.free_list),
                         dict(eng.virt._refs))
            if h.done:
                break
        streams.append(list(req.output_ids))
    return streams, moved, eng


def test_shrink_compacts_tree_pages():
    """The compaction's page sequence equals the JAX package's, pages
    only the tree holds were renumbered behind the request's, and decode
    after it equals the unperturbed port's (and the JAX engine's)."""
    streams, moved, eng = _shrink_run("torch", True)
    j_streams, j_moved, _ = _shrink_run("jax", True)
    assert moved == j_moved
    tables, tree_pages = moved[0], moved[1]
    request_pages = {p for t in tables for p in t}
    assert sorted(request_pages) == list(range(len(request_pages)))
    assert set(tree_pages) - request_pages == set(
        range(len(request_pages), len(set(tree_pages) | request_pages)))
    assert streams == _shrink_run("torch", False)[0] == j_streams
    assert eng.cache.device_pages_held == eng.virt.mapped_pages


def test_rebalancer_replans_with_the_cached_fraction():
    """The elastic re-plan discounts KV demand by the tree's hit-token
    fraction: on ``test_torch_elastic``'s recorded stream, with a tree
    that served 60% of prompt tokens, both packages apply the same
    decisions, and they differ from the cache-blind ones."""
    from test_torch_elastic import _drive as drive_rebalancer
    from test_torch_elastic import _rebalancer_pair
    cfg_kw = dict(interval_steps=2, cooldown_steps=2, hysteresis=0.02,
                  window_s=40.0, min_page_budget=4)
    runs = []
    for cached in (True, False):
        (jv, ja, jt, jr), (tv, ta, tt, tr) = _rebalancer_pair(cfg_kw, seed=7)
        if cached:
            for reb, cache in ((jr, j_pc.PrefixCache(jv, JCache(enabled=True))),
                               (tr, t_pc.PrefixCache(tv, CacheConfig(
                                   enabled=True)))):
                cache.prompt_tokens_seen, cache.hit_tokens = 1000, 600
                reb.cache = cache
        want = drive_rebalancer(jv, ja, jt, jr, j_virt.OutOfPagesError)
        got = drive_rebalancer(tv, ta, tt, tr, t_virt.OutOfPagesError)
        assert got == want
        runs.append(got)
    assert runs[0] != runs[1]


# ---------------------------------------------------------------------------
# (g) the serve CLI
# ---------------------------------------------------------------------------

def test_serve_cli_cache_on_the_cpu(capsys):
    serve.main(["--device", "cpu", "--cache", "--horizon", "4",
                "--max-new", "4"])
    out = capsys.readouterr().out
    assert "cache=True" in out
    lines = {line.split(": ", 1)[0]: line.split(": ", 1)[1]
             for line in out.splitlines() if ": {" in line}
    snap = ast.literal_eval(lines["prefix cache"])
    pool = ast.literal_eval(lines["pool"])
    assert snap["device_pages_held"] == pool["mapped_pages"]
    assert pool["free_pages"] + pool["mapped_pages"] == pool["page_budget"]
