"""The port's pools against the reference's: page and slab bookkeeping,
the in-place device ops, the packed host masters and ``unpack_layer``.

The same operation sequence drives both packages' objects; tables, free
lists and verdicts must be identical, bytes must be identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import PAPER_COLOC_SET, get_smoke_config
from repro.core import admission as j_adm
from repro.core import split_exec as j_split
from repro.core import virtualizer as j_virt
from repro.core import weight_pool as j_wp
from repro.models import build_model
from repro_torch.bridge import params_to_torch
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core import admission as t_adm
from repro_torch.core import split_exec as t_split
from repro_torch.core import virtualizer as t_virt
from repro_torch.core import weight_pool as t_wp

MOE, MLA, MOON = "qwen3-moe-235b-a22b", "minicpm3-4b", "moonshot-v1-16b-a3b"


def _models(dtype="float32"):
    return ({n: get_smoke_config(n).replace(dtype=dtype)
             for n in PAPER_COLOC_SET},
            {n: t_smoke(n).replace(dtype=dtype) for n in PAPER_COLOC_SET})


def _virts(budget, allocate=False):
    jm, tm = _models()
    jv = j_virt.KVVirtualizer(jm, page_budget=budget, page_bytes=1024,
                              dtype=jnp.float32,
                              allocate_device_pool=allocate)
    tv = t_virt.KVVirtualizer(tm, page_budget=budget, page_bytes=1024,
                              dtype=torch.float32,
                              allocate_device_pool=allocate, device="cpu")
    return jv, tv


def _same_state(jv, tv):
    assert tv.free_list == jv.free_list
    assert tv.mapped_pages == jv.mapped_pages
    assert tv.peak_mapped == jv.peak_mapped
    assert sorted(tv.requests) == sorted(jv.requests)
    for rid, jr in jv.requests.items():
        tr = tv.requests[rid]
        assert (tr.model, tr.tokens, tr.tables) == \
            (jr.model, jr.tokens, jr.tables)


def _apply(v, op, err_type):
    kind, args = op[0], op[1:]
    try:
        if kind == "register":
            v.register_request(*args)
        elif kind == "extend":
            v.extend_request(*args)
        elif kind == "reserve":
            v.reserve_decode_block(*args)
        elif kind == "commit":
            v.commit_decode_block(*args)
        else:
            v.release_request(*args)
    except err_type:
        return "oom"
    return "ok"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_virtualizer_op_sequences_match(seed):
    """Random register / extend / reserve / commit / release sequences,
    out-of-pages included, leave identical tables and free lists."""
    rng = np.random.default_rng(seed)
    jv, tv = _virts(budget=40)
    live, next_id = {}, 0
    for _ in range(60):
        choice = rng.integers(0, 5)
        if choice == 0 or not live:
            model = PAPER_COLOC_SET[rng.integers(0, 3)]
            op = ("register", next_id, model, int(rng.integers(1, 90)))
        else:
            rid = list(live)[rng.integers(0, len(live))]
            if choice == 1:
                op = ("extend", rid, int(rng.integers(1, 20)))
            elif choice == 2:
                op = ("reserve", rid, int(rng.integers(1, 6)))
            elif choice == 3:
                op = ("commit", rid, int(rng.integers(0, 3)))
            else:
                op = ("release", rid)
        out_j = _apply(jv, op, j_virt.OutOfPagesError)
        out_t = _apply(tv, op, t_virt.OutOfPagesError)
        assert out_t == out_j, op
        if op[0] == "register" and out_j == "ok":
            live[next_id] = op[2]
            next_id += 1
        if op[0] == "release":
            live.pop(op[1])
        _same_state(jv, tv)
        for model in PAPER_COLOC_SET:
            slots = [r for r, m in live.items() if m == model][:3]
            slots += [None] * (3 - len(slots))
            np.testing.assert_array_equal(
                tv.batch_tables(model, slots, 6).numpy(),
                np.asarray(jv.batch_tables(model, slots, 6)))


def test_batch_tables_upload_copies():
    """A table handed to a step never changes when mappings change later
    (``torch.from_numpy`` would alias the cached host buffer)."""
    _, tv = _virts(budget=40)
    tv.register_request(0, MOE, 10)
    first = tv.batch_tables(MOE, [0, None], 4)
    snapshot = first.clone()
    tv.reserve_decode_block(0, 40)
    second = tv.batch_tables(MOE, [0, None], 4)
    assert torch.equal(first, snapshot)
    assert not torch.equal(first, second)


@pytest.mark.parametrize("name", PAPER_COLOC_SET)
def test_write_prompt_layer_matches(name):
    jv, tv = _virts(budget=24, allocate=True)
    jv.register_request(3, name, 21)
    tv.register_request(3, name, 21)
    view = tv.views[name]
    rng = np.random.default_rng(7)
    if len(view.kv_shape) == 1:            # MLA: (latent, rope)
        cfg = tv.configs[name].mla
        a = rng.standard_normal((2, 21, cfg.kv_lora_rank))
        b = rng.standard_normal((2, 21, cfg.qk_rope_head_dim))
    else:
        a = rng.standard_normal((2, 21) + view.kv_shape[1:])
        b = rng.standard_normal((2, 21) + view.kv_shape[1:])
    a, b = a.astype(np.float32), b.astype(np.float32)
    for layer in range(view.n_kv_layers):
        jv.pool = jv.write_prompt_layer(jv.pool, name, 3, layer,
                                        (jnp.asarray(a), jnp.asarray(b)), 17,
                                        batch_index=1, start=2)
        out = tv.write_prompt_layer(tv.pool, name, 3, layer,
                                    (torch.from_numpy(a), torch.from_numpy(b)),
                                    17, batch_index=1, start=2)
        assert out is tv.pool                  # in place
    np.testing.assert_array_equal(tv.pool.numpy(), np.asarray(jv.pool))


def test_pool_row_ops_match():
    rng = np.random.default_rng(8)
    pool = rng.standard_normal((10, 12)).astype(np.float32)
    ids = np.array([7, 2, 5], np.int32)
    rows = rng.standard_normal((3, 12)).astype(np.float32)
    want = np.asarray(j_virt._pool_row_scatter(jnp.asarray(pool),
                                               jnp.asarray(ids),
                                               jnp.asarray(rows)))
    t_pool = torch.from_numpy(pool.copy())
    t_virt._pool_row_scatter(t_pool, torch.from_numpy(ids),
                             torch.from_numpy(rows))
    np.testing.assert_array_equal(t_pool.numpy(), want)
    np.testing.assert_array_equal(
        t_virt._pool_row_gather(t_pool, torch.from_numpy(ids)).numpy(),
        np.asarray(j_virt._pool_row_gather(jnp.asarray(want),
                                           jnp.asarray(ids))))


def test_swap_tier_and_resize_are_not_ported():
    """Named for when the port raised here; the swap tier and resize are
    ported now: a swap-out, a grow, a shrink and the fault-in leave the
    reference's tables and free lists (``tests/test_torch_elastic.py``
    holds the full sequences)."""
    jv, tv = _virts(budget=8)
    for v in (jv, tv):
        v.register_request(0, MOE, 3)
        assert v.ensure_resident(0) == 0
        assert v.swap_out(0) > 0
        v.resize(16)
        v.resize(4)
        assert v.ensure_resident(0) > 0
    _same_state(jv, tv)
    assert tv.swap_free == jv.swap_free
    assert tv.utilization() == jv.utilization()


# ---------------------------------------------------------------------------
# weights arena
# ---------------------------------------------------------------------------

def _w_trees(name, dtype):
    jcfg = get_smoke_config(name).replace(dtype=dtype)
    jp = jax.tree.map(np.asarray, build_model(jcfg).init(
        jax.random.PRNGKey(3)))
    _, jw = j_split.split_params(jp, jcfg)
    _, tw = t_split.split_params(params_to_torch(jp), t_smoke(name)
                                 .replace(dtype=dtype))
    return jcfg, jw, tw


def _bits(t: torch.Tensor) -> np.ndarray:
    raw = t.contiguous().view(torch.uint8) if t.dim() else \
        t.reshape(1).view(torch.uint8)
    return raw.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", PAPER_COLOC_SET)
def test_host_masters_and_unpack_are_byte_exact(name, dtype):
    jcfg, jw, tw = _w_trees(name, dtype)
    tcfg = t_smoke(name).replace(dtype=dtype)
    j_view, j_slabs = j_wp.build_view_and_slabs(name, jcfg, jw,
                                                slab_bytes=2048)
    t_view, t_slabs = t_wp.build_view_and_slabs(name, tcfg, tw,
                                                slab_bytes=2048)
    assert t_view.slabs_per_layer == j_view.slabs_per_layer
    np.testing.assert_array_equal(t_slabs.numpy(), j_slabs)

    arena = t_wp.WeightArena(slab_bytes=2048, device="cpu")
    arena.add_model(name, tcfg, tw)
    arena.finalize(t_view.total_slabs + 5)
    arena.free_list.reverse()              # non-trivial slab placement
    buf, table = arena.acquire(name)
    j_arena = jnp.asarray(np.asarray(buf))
    for layer in range(jcfg.n_layers):
        got = t_view.unpack_layer(buf, table[layer])
        want = j_view.unpack_layer(j_arena, jnp.asarray(table[layer].numpy()))

        def walk(g, w):
            for k in w:
                if isinstance(w[k], dict):
                    walk(g[k], w[k])
                else:
                    assert tuple(g[k].shape) == w[k].shape
                    np.testing.assert_array_equal(
                        _bits(g[k]), np.asarray(w[k]).view(np.uint8).reshape(
                            _bits(g[k]).shape))
        walk(got, want)


def test_arena_activation_sequence_matches():
    """LRU activation under pressure, pins and evictions leave the same
    residency and free list in both arenas."""
    j_arena = j_wp.WeightArena(slab_bytes=2048)
    t_arena = t_wp.WeightArena(slab_bytes=2048, device="cpu")
    for name in PAPER_COLOC_SET:
        jcfg, jw, tw = _w_trees(name, "float32")
        j_arena.add_model(name, jcfg, jw)
        t_arena.add_model(name, t_smoke(name).replace(dtype="float32"), tw)
    need = max(v.total_slabs for v in t_arena.views.values())
    second = sorted(v.total_slabs for v in t_arena.views.values())[-2]
    budget = need + second
    j_arena.finalize(budget)
    t_arena.finalize(budget)
    ops = [("activate", MOE), ("pin", MOE), ("activate", MLA),
           ("activate", MOON), ("unpin", MOE), ("touch", MLA),
           ("activate", MOON), ("evict", MLA), ("activate", MOE)]
    for op, name in ops:
        outs = []
        for arena, err in ((j_arena, j_wp.OutOfSlabsError),
                           (t_arena, t_wp.OutOfSlabsError)):
            try:
                getattr(arena, op)(name)
                outs.append("ok")
            except (err, ValueError, KeyError) as e:
                outs.append(type(e).__name__)
        assert outs[0] == outs[1], (op, name, outs)
        assert t_arena.free_list == j_arena.free_list
        assert sorted(t_arena.residency) == sorted(j_arena.residency)
        for n, res in j_arena.residency.items():
            np.testing.assert_array_equal(t_arena.residency[n].slots,
                                          res.slots)
            np.testing.assert_array_equal(
                t_arena.slot_table(n).numpy(), np.asarray(
                    j_arena.slot_table(n)))
        assert t_arena.pins == j_arena.pins


def test_admission_verdicts_match():
    """Queue-or-reject with KV pressure and arena pressure: the same offers
    get the same verdicts, stats and queues."""
    jm, tm = _models()
    jv = j_virt.KVVirtualizer(jm, page_budget=12, page_bytes=1024,
                              dtype=jnp.float32, allocate_device_pool=False)
    tv = t_virt.KVVirtualizer(tm, page_budget=12, page_bytes=1024,
                              dtype=torch.float32, allocate_device_pool=False,
                              device="cpu")
    ja, ta = j_wp.WeightArena(slab_bytes=2048), t_wp.WeightArena(
        slab_bytes=2048, device="cpu")
    for name in PAPER_COLOC_SET:
        jcfg, jw, tw = _w_trees(name, "float32")
        ja.add_model(name, jcfg, jw)
        ta.add_model(name, tm[name], tw)
    budget = max(v.total_slabs for v in ta.views.values()) + 1
    ja.finalize(budget)
    ta.finalize(budget)
    jc = j_adm.AdmissionController(jv, arena=ja, max_queue_per_model=2)
    tc = t_adm.AdmissionController(tv, arena=ta, max_queue_per_model=2)
    offers = [(0, MOE, 10, 4), (1, MLA, 30, 4), (2, MOE, 60, 8),
              (3, MOON, 9, 2), (4, MOE, 5, 2), (5, MOE, 5, 2),
              (6, MOE, 5, 2), (7, MLA, 3, 1)]
    for i, (rid, model, p, o) in enumerate(offers):
        got = tc.offer(t_adm.PendingRequest(rid, model, p, o, float(i)),
                       float(i))
        want = jc.offer(j_adm.PendingRequest(rid, model, p, o, float(i)),
                        float(i))
        assert got == want, (rid, got, want)
        if i == 4:                  # the first admitted request finishes
            for v, c in ((jv, jc), (tv, tc)):
                v.release_request(0)
                c.finish(MOE)
            assert [p.request_id for p in tc.drain(float(i))] == \
                [p.request_id for p in jc.drain(float(i))]
    for field in ("admitted", "queued", "rejected", "page_pressure_queued",
                  "weight_pressure_queued"):
        assert getattr(tc.stats, field) == getattr(jc.stats, field)
    assert {m: [p.request_id for p in q] for m, q in tc.queues.items()} == \
        {m: [p.request_id for p in q] for m, q in jc.queues.items()}
    assert dict(tc.inflight) == dict(jc.inflight)
    _same_state(jv, tv)
