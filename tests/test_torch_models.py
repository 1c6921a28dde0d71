"""The port's model math against the JAX functions it ports.

Same inputs (numpy, from a seed) and the same params (the reference's own
init, bridged with ``repro_torch.bridge``) go through both packages, on
the float32 smoke configs of the paper's three colocated models; results
agree within 1e-5.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES, PAPER_COLOC_SET, get_smoke_config
from repro.core.pools import build_pools as j_build_pools
from repro.models import attention as jattn
from repro.models import build_model
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro.models.hooks import IDENTITY_HOOKS
from repro_torch.bridge import params_to_torch
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core.pools import build_pools as t_build_pools
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttfm
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
MOE_MODELS = ("qwen3-moe-235b-a22b", "moonshot-v1-16b-a3b")


def _cfgs(name):
    return (get_smoke_config(name).replace(dtype="float32"),
            t_smoke(name).replace(dtype="float32"))


def _params(name, seed=0):
    jcfg, _ = _cfgs(name)
    jp = jax.tree.map(np.asarray, build_model(jcfg).init(
        jax.random.PRNGKey(seed)))
    return jp, params_to_torch(jp)


def _layer(tree, i):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _jit(fn, *static, **kw):
    """The reference function compiled once (its op-by-op eager mode
    compiles every primitive separately, which is what costs time here)."""
    return jax.jit(functools.partial(fn, *static, **kw))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               **tol)


def test_rms_norm_scales_by_one_plus_weight():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 32)).astype(np.float32)
    w = rng.standard_normal(32).astype(np.float32)
    _close(tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6),
           jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))


@pytest.mark.parametrize("dim,theta", [(16, 1e6), (8, 1e4)])
def test_apply_rope_rotates_halves(dim, theta):
    rng = np.random.default_rng(dim)
    x = rng.standard_normal((2, 7, 3, dim)).astype(np.float32)
    pos = rng.integers(0, 500, (2, 7)).astype(np.int32)
    ts, tc = tlayers.rope_sin_cos(torch.from_numpy(pos), dim, theta)
    js, jc = jlayers.rope_sin_cos(jnp.asarray(pos), dim, theta)
    _close(ts, js)
    _close(tlayers.apply_rope(torch.from_numpy(x), ts, tc),
           jlayers.apply_rope(jnp.asarray(x), js, jc))


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_apply_mlp(kind):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 16)).astype(np.float32)
    names = ("wg", "wu", "wd") if kind == "swiglu" else ("wi", "wo")
    shapes = {"wg": (16, 24), "wu": (16, 24), "wd": (24, 16),
              "wi": (16, 24), "wo": (24, 16)}
    p = {n: rng.standard_normal(shapes[n]).astype(np.float32) * 0.3
         for n in names}
    _close(tlayers.apply_mlp(params_to_torch(p), torch.from_numpy(x), kind),
           jlayers.apply_mlp(p, jnp.asarray(x), kind))


@pytest.mark.parametrize("name", MOE_MODELS)
def test_route_dispatch_and_apply_moe(name):
    jcfg, tcfg = _cfgs(name)
    jp, tp = _params(name)
    jm, tm = _layer(jp["layers"]["moe"], 0), _layer(tp["layers"]["moe"], 0)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 5, jcfg.d_model)).astype(np.float32)
    xf = x.reshape(-1, jcfg.d_model)
    tg, te, tpr = tmoe.route(tm, torch.from_numpy(xf), tcfg)
    jg, je, jpr = jax.jit(jmoe.route, static_argnums=2)(
        jm, jnp.asarray(xf), jcfg)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    _close(tg, jg)
    _close(tpr, jpr)
    C = jmoe.expert_capacity(xf.shape[0], jcfg)
    assert tmoe.expert_capacity(xf.shape[0], tcfg) == C
    ts, tk = tmoe.dispatch_indices(te, tcfg.n_experts, C)
    js, jk = jmoe.dispatch_indices(je, jcfg.n_experts, C)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    ty, taux = tmoe.apply_moe(tm, torch.from_numpy(x), tcfg)
    jy, jaux = _jit(jmoe.apply_moe, cfg=jcfg)(jm, jnp.asarray(x))
    _close(ty, jy)
    _close(taux, jaux)


def test_dispatch_drops_in_row_major_order():
    """Capacity drops follow the exclusive cumsum over (n, k) row-major."""
    experts = np.array([[0, 1], [1, 0], [0, 2], [0, 1]], np.int32)
    ts, tk = tmoe.dispatch_indices(torch.from_numpy(experts), 3, 2)
    js, jk = jmoe.dispatch_indices(jnp.asarray(experts), 3, 2)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


def test_route_breaks_ties_like_lax_top_k():
    cfg = t_smoke("moonshot-v1-16b-a3b").replace(dtype="float32")
    p = {"router": torch.zeros((cfg.d_model, cfg.n_experts))}
    _, experts, _ = tmoe.route(p, torch.ones((2, cfg.d_model)), cfg)
    assert experts.tolist() == [[0, 1], [0, 1]]


@pytest.mark.parametrize("n,expect", [(1, 1), (3, 1), (40, 16), (100, 32)])
def test_expert_capacity_rounds_to_eight(n, expect):
    cfg = t_smoke("qwen3-moe-235b-a22b")
    jcfg = get_smoke_config("qwen3-moe-235b-a22b")
    assert tmoe.expert_capacity(n, cfg) == jmoe.expert_capacity(n, jcfg) \
        == expect


@pytest.mark.parametrize("name", PAPER_COLOC_SET)
def test_attn_full(name):
    jcfg, tcfg = _cfgs(name)
    jp, tp = _params(name)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9)[None], (2, 9)).astype(np.int32)
    ty, tkv = ttfm._attn_full(_layer(tp["layers"], 1), tcfg,
                              torch.from_numpy(x), torch.from_numpy(pos))
    jy, jkv = jax.jit(jtfm._attn_full, static_argnums=(1, 4, 5, 6))(
        _layer(jp["layers"], 1), jcfg, jnp.asarray(x), jnp.asarray(pos), 0,
        IDENTITY_HOOKS, "xla")
    _close(ty, jy)
    for a, b in zip(tkv, jkv):
        _close(a, b)


def _pool_setup(rng, B, n_pages, page_elems, tpp, max_pages):
    """A random pool and per-row tables whose pages cover lengths+1."""
    pool = rng.standard_normal((n_pages, page_elems)).astype(np.float32)
    lengths = rng.integers(0, tpp * max_pages - 1, B).astype(np.int32)
    perm = rng.permutation(n_pages)[: B * max_pages].reshape(B, max_pages)
    need = (lengths[:, None] + 1) > np.arange(max_pages)[None, :] * tpp
    table = np.where(need, perm, -1).astype(np.int32)
    return pool, table, lengths


@pytest.mark.parametrize("name", PAPER_COLOC_SET)
def test_paged_decode(name):
    """One decode token through the shared pool: the output and the pool
    after the in-place KV write equal the reference's."""
    jcfg, tcfg = _cfgs(name)
    jp, tp = _params(name)
    rng = np.random.default_rng(4)
    page_elems, B, max_pages = 512, 3, 4
    per_tok = (jcfg.mla.kv_lora_rank + jcfg.mla.qk_rope_head_dim
               if jcfg.attention == "mla"
               else 2 * jcfg.n_kv_heads * jcfg.head_dim)
    tpp = page_elems // per_tok
    pool, table, lengths = _pool_setup(rng, B, 16, page_elems, tpp,
                                       max_pages)
    x = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    jfn, tfn = ((jattn.mla_paged_decode, tattn.mla_paged_decode)
                if jcfg.attention == "mla"
                else (jattn.gqa_paged_decode, tattn.gqa_paged_decode))
    jy, jpool = _jit(jfn, cfg=jcfg, tokens_per_page=tpp)(
        _layer(jp["layers"]["attn"], 0), x=jnp.asarray(x),
        pool=jnp.asarray(pool), page_table=jnp.asarray(table),
        lengths=jnp.asarray(lengths))
    t_pool = torch.from_numpy(pool.copy())
    ty, t_out = tfn(_layer(tp["layers"]["attn"], 0), tcfg,
                    torch.from_numpy(x), t_pool, torch.from_numpy(table),
                    torch.from_numpy(lengths), tokens_per_page=tpp)
    assert t_out is t_pool
    _close(ty, jy)
    _close(t_out, jpool)


@pytest.mark.parametrize("name", PAPER_COLOC_SET)
def test_stage_fns(name):
    """Prefill attention, the paged decode attention stage, the arena FFN
    stage (coalesced prefill and batch decode) and both logits heads, on
    pools built from the same params by each package."""
    jcfg, tcfg = _cfgs(name)
    jp, tp = _params(name)
    kw = dict(page_budget=32, page_bytes=2048, slab_bytes=4096)
    _, j_w, j_pooled = j_build_pools({name: jcfg}, {name: jp},
                                     pool_dtype=jnp.float32, **kw)
    t_kv, _, t_pooled = t_build_pools({name: tcfg}, {name: tp}, device="cpu",
                                      pool_dtype=torch.float32, **kw)
    jf, tf = j_pooled[name].stage_fns, t_pooled[name].stage_fns
    jf = jf._replace(**{k: jax.jit(getattr(jf, k)) for k in (
        "prefill_attn", "ffn_stage", "attn_stage", "logits",
        "prefill_logits")})
    jkv, tkv = j_pooled[name].kv_params, t_pooled[name].kv_params
    j_arena, t_arena = j_pooled[name].arena, t_pooled[name].arena
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)

    jx = jf.prefill_embed(jkv, jnp.asarray(tokens))
    tx = tf.prefill_embed(tkv, torch.from_numpy(tokens))
    for layer in range(jcfg.n_layers):
        jx, j_in, _ = jf.prefill_attn(jkv, jx, layer)
        tx, t_in, _ = tf.prefill_attn(tkv, tx, layer)
        _close(t_in, j_in)
        j_out = jf.ffn_stage(j_arena.arena, j_arena.slot_table(name), j_in,
                             layer)
        t_out = tf.ffn_stage(t_arena.arena, t_arena.slot_table(name), t_in,
                             layer)
        _close(t_out, j_out)
        jx, tx = jf.combine(jx, j_out), tf.combine(tx, t_out)
    idx = np.array([11, 4], np.int32)
    _close(tf.prefill_logits(tkv, tx, torch.from_numpy(idx)),
           jf.prefill_logits(jkv, jx, jnp.asarray(idx)))
    _close(tf.prefill_logits(tkv, tx, 6),
           jf.prefill_logits(jkv, jx, jnp.int32(6)))

    view = t_kv.virtualizer.views[name]
    pool, table, lengths = _pool_setup(rng, 2, 32, 512, view.tokens_per_page,
                                       3)
    tables = np.stack([table] * jcfg.n_layers)
    toks = rng.integers(0, jcfg.vocab_size, 2).astype(np.int32)
    jx = jf.embed(jkv, jnp.asarray(toks))
    tx = tf.embed(tkv, torch.from_numpy(toks))
    j_pool, t_pool = jnp.asarray(pool), torch.from_numpy(pool.copy())
    for layer in range(jcfg.n_layers):
        jx, j_in, j_pool = jf.attn_stage(jkv, jx, j_pool, jnp.asarray(tables),
                                         jnp.asarray(lengths), layer)
        tx, t_in, t_pool = tf.attn_stage(tkv, tx, t_pool,
                                         torch.from_numpy(tables),
                                         torch.from_numpy(lengths), layer)
        _close(t_in, j_in)
        jx = jf.combine(jx, jf.ffn_stage(j_arena.arena,
                                         j_arena.slot_table(name), j_in,
                                         layer))
        tx = tf.combine(tx, tf.ffn_stage(t_arena.arena,
                                         t_arena.slot_table(name), t_in,
                                         layer))
    _close(t_pool, j_pool)
    _close(tf.logits(tkv, tx), jf.logits(jkv, jx))


@pytest.mark.parametrize("name", PAPER_COLOC_SET)
def test_init_params_has_the_reference_layout(name):
    """The port's own init draws a tree of the reference's structure,
    shapes and dtypes (its numbers come from a torch.Generator)."""
    jcfg, tcfg = _cfgs(name)
    jp, _ = _params(name)
    gen = torch.Generator().manual_seed(0)
    tp = ttfm.init_params(gen, tcfg)

    def shapes(tree, conv):
        return {k: shapes(v, conv) if isinstance(v, dict) else conv(v)
                for k, v in tree.items()}

    assert shapes(tp, lambda t: (tuple(t.shape), str(t.dtype)[6:])) == \
        shapes(jp, lambda a: (tuple(a.shape), str(a.dtype)))


def _leaves(tree, prefix=()):
    """{path: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = v
    return out


def _spec(leaf):
    """(shape, torch dtype) of a torch leaf, or of a JAX ShapeDtypeStruct
    through the bridge's dtype map."""
    from repro_torch.bridge import to_torch
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), leaf.dtype
    return tuple(leaf.shape), to_torch(np.zeros(0, leaf.dtype)).dtype


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_and_cache_specs_equal_reference(arch):
    """``Model.param_specs()`` and ``cache_specs(batch, max_len,
    kv_dtype)`` of every arch's smoke config: every leaf's path, shape
    and dtype equal the reference's ``jax.eval_shape`` trees, on
    ``meta``."""
    from repro_torch.models.model import build_model as t_build
    jm, tm = build_model(get_smoke_config(arch)), t_build(t_smoke(arch))
    pairs = [(jm.param_specs(), tm.param_specs())]
    pairs += [(jm.cache_specs(2, 24, kv), tm.cache_specs(2, 24, kv))
              for kv in (None, "float32")]
    for want, got in pairs:
        want, got = _leaves(want), _leaves(got)
        assert sorted(got) == sorted(want)
        assert {p: _spec(v) for p, v in got.items()} == \
            {p: _spec(v) for p, v in want.items()}
        assert all(v.is_meta for v in got.values())


def test_param_specs_of_a_published_config_allocate_nothing():
    """llama3-405b's full param tree as specs: every leaf on ``meta``,
    ~405e9 parameters, no storage."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model as t_build
    specs = _leaves(t_build(get_config("llama3-405b")).param_specs())
    assert all(v.is_meta for v in specs.values())
    assert 4.0e11 < sum(v.numel() for v in specs.values()) < 4.2e11
