"""The port's SSM and hybrid model math against the JAX functions it ports.

Same inputs (numpy, from a seed) and the same params (the reference's own
init, bridged with ``repro_torch.bridge``) go through both packages on
the float32 smoke configs of zamba2-1.2b (hybrid) and mamba2-130m (ssm);
outputs and every cache leaf, the SSM state ``h`` included, agree within
1e-5 (relative, and absolute on the scale of the tensor: through a whole
stack, float32 sums taken in another order than XLA's differ by ~1e-5 on
leaves whose entries reach 30).  The port runs its kernel routes
(``impl="flash"`` prefill, ``impl="paged"`` decode, whose CPU versions
are the plain ones) and the masked-softmax route against the
reference's default XLA route.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import attention as jattn
from repro.models import build_model
from repro.models import ssm as jssm
from repro_torch.bridge import params_to_torch
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.models import attention as tattn
from repro_torch.models.model import build_model as t_build_model
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttfm
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
SSM_MODELS = ("zamba2-1.2b", "mamba2-130m")
# (port prefill impl, port decode impl): the kernel routes and the XLA one
ROUTES = [("flash", "paged"), ("xla", "xla")]


def _cfgs(name, dtype="float32"):
    return (get_smoke_config(name).replace(dtype=dtype),
            t_smoke(name).replace(dtype=dtype))


@functools.lru_cache(maxsize=None)
def _params(name):
    jcfg, _ = _cfgs(name)
    return jax.tree.map(np.asarray,
                        build_model(jcfg).init(jax.random.PRNGKey(0)))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               **tol)


def _close_scaled(got, want):
    """Within 1e-5, relative and absolute on the scale of ``want``."""
    scale = max(1.0, float(np.abs(np.asarray(want)).max()))
    _close(got, want, dict(rtol=1e-5, atol=1e-5 * scale))


def _tree_close(got, want, close=_close):
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k])


def _ssm_layer(name):
    """(jax layer-0 SSD params, torch copy, jax cfg, torch cfg)."""
    jcfg, tcfg = _cfgs(name)
    jp = jax.tree.map(lambda a: a[0], _params(name)["layers"]["ssm"])
    return jp, params_to_torch(jp), jcfg, tcfg


def _state(rng, cfg, B):
    s = cfg.ssm
    nh, d_in = s.n_heads(cfg.d_model), s.d_inner(cfg.d_model)
    conv = d_in + 2 * s.n_groups * s.d_state
    return {"h": rng.standard_normal((B, nh, s.head_dim, s.d_state))
            .astype(np.float32),
            "conv": rng.standard_normal((B, s.conv_width - 1, conv))
            .astype(np.float32)}


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("name", SSM_MODELS)
def test_ssm_full_matches_jax(name, with_state):
    jp, tp, jcfg, tcfg = _ssm_layer(name)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 24, jcfg.d_model)).astype(np.float32)
    st = _state(rng, jcfg, 2) if with_state else None
    want, wst = jax.jit(functools.partial(jssm.ssm_full, cfg=jcfg))(
        jp, x=jnp.asarray(x),
        state=None if st is None else jax.tree.map(jnp.asarray, st))
    got, gst = tssm.ssm_full(
        tp, tcfg, torch.from_numpy(x),
        None if st is None else {k: torch.from_numpy(v)
                                 for k, v in st.items()})
    _close(got, want)
    _tree_close(gst, wst)


@pytest.mark.parametrize("name", SSM_MODELS)
def test_ssm_decode_matches_jax(name):
    jp, tp, jcfg, tcfg = _ssm_layer(name)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 1, jcfg.d_model)).astype(np.float32)
    st = _state(rng, jcfg, 3)
    want, wst = jax.jit(functools.partial(jssm.ssm_decode, cfg=jcfg))(
        jp, x=jnp.asarray(x), state=jax.tree.map(jnp.asarray, st))
    got, gst = tssm.ssm_decode(tp, tcfg, torch.from_numpy(x),
                               {k: torch.from_numpy(v) for k, v in st.items()})
    _close(got, want)
    _tree_close(gst, wst)


@pytest.mark.parametrize("S,want", [(1024, 256), (512, 256), (96, 32),
                                    (24, 8), (7, 1)])
def test_scan_chunk_is_the_largest_dividing_candidate(S, want):
    assert tssm.scan_chunk(S, 256) == want


@pytest.mark.parametrize("prefill_impl,decode_impl", ROUTES)
@pytest.mark.parametrize("name", SSM_MODELS)
def test_prefill_and_decode_steps_match_jax(name, prefill_impl, decode_impl):
    """A bucket-padded prefill read at ``logit_index`` seeds the cache, then
    two decode steps with ragged per-row lengths (one row at the cache's
    end, whose KV write is dropped): logits and every cache leaf match."""
    jcfg, tcfg = _cfgs(name)
    jm, tm = build_model(jcfg), t_build_model(tcfg)
    jp = _params(name)
    tp = params_to_torch(jp)
    B, S, T = 3, 16, 24
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)

    want, jc = jax.jit(functools.partial(jm.prefill, logit_index=11))(
        jp, jnp.asarray(tokens), jm.init_cache(B, T))
    tc = tm.init_cache(B, T, "cpu")
    got, tc2 = tm.prefill(tp, torch.from_numpy(tokens), tc,
                          impl=prefill_impl, logit_index=11)
    assert tc2 is tc
    _close_scaled(got, want)
    _tree_close(tc, jc, _close_scaled)

    j_step = jax.jit(jm.decode_step)
    for step in range(2):
        toks = rng.integers(0, jcfg.vocab_size, B).astype(np.int32)
        lengths = np.array([12 + step, 5, T - 1 + step], np.int32)
        want, jc = j_step(jp, jnp.asarray(toks), jc, jnp.asarray(lengths))
        got, _ = tm.decode_step(tp, torch.from_numpy(toks), tc,
                                torch.from_numpy(lengths), impl=decode_impl)
        _close_scaled(got, want)
        _tree_close(tc, jc, _close_scaled)


def test_write_kv_cache_drops_rows_at_the_end():
    rng = np.random.default_rng(6)
    ck, cv = (rng.standard_normal((3, 5, 2, 4)).astype(np.float32)
              for _ in range(2))
    kn, vn = (rng.standard_normal((3, 1, 2, 4)).astype(np.float32)
              for _ in range(2))
    lengths = np.array([0, 5, 3], np.int32)
    wk, wv = jattn.write_kv_cache(*(jnp.asarray(a) for a in (ck, cv, kn, vn)),
                                  jnp.asarray(lengths))
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    tattn.write_kv_cache(tk, tv, torch.from_numpy(kn), torch.from_numpy(vn),
                         torch.from_numpy(lengths))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(wv))


@pytest.mark.parametrize("name", SSM_MODELS)
def test_init_params_and_bridge_keep_the_reference_tree(name):
    """bf16 trees: the port's init has the reference's structure, shapes
    and dtypes (``A_log``, ``D``, ``dt_bias`` stay f32), and the bridge
    carries the reference's tree over leaf for leaf, bits unchanged."""
    jcfg, tcfg = _cfgs(name, "bfloat16")
    jtree = jax.tree.map(np.asarray,
                         build_model(jcfg).init(jax.random.PRNGKey(1)))
    ttree = ttfm.init_params(torch.Generator().manual_seed(1), tcfg)
    bridged = params_to_torch(jtree)
    j_leaves = jax.tree_util.tree_leaves_with_path(jtree)
    assert len(j_leaves) == len(jax.tree_util.tree_leaves(ttree))
    for path, leaf in j_leaves:
        keys = [k.key for k in path]
        t_leaf, b_leaf = ttree, bridged
        for k in keys:
            t_leaf, b_leaf = t_leaf[k], b_leaf[k]
        want_dtype = (torch.float32 if keys[-1] in ("A_log", "D", "dt_bias")
                      else torch.bfloat16)
        assert t_leaf.dtype == b_leaf.dtype == want_dtype, keys
        assert tuple(t_leaf.shape) == tuple(b_leaf.shape) == leaf.shape, keys
        np.testing.assert_array_equal(b_leaf.float().numpy(),
                                      leaf.astype(np.float32))
