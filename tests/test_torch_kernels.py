"""The port's paged decode kernels against the JAX package.

On the CPU every kernel wrapper takes its plain PyTorch version
(``repro_torch.kernels.ref``); those are held here against the JAX
oracles (``repro.kernels.ref``) and the Pallas kernels in interpret mode
on the sweeps of ``tests/test_kernels.py``, within 2e-5 in float32, with
ragged lengths and unmapped (-1) table entries.  The CUDA kernels
themselves run only on a card (``tests/test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.paged_attention import (paged_decode_attention as
                                           pallas_paged,
                                           paged_mla_decode_attention as
                                           pallas_paged_mla)
from repro_torch.kernels import ops as kops
from repro_torch.kernels import paged_attention as kpa
from repro_torch.kernels import ref as tref

TOL = dict(rtol=2e-5, atol=2e-5)


def _paged_inputs(rng, B, npages, ps, n_phys, row_shape, H, q_dim):
    """q, typed pages, a shuffled page table with -1 past each length, and
    ragged lengths (every one >= 1)."""
    q = rng.standard_normal((B, 1, H, q_dim)).astype(np.float32)
    pages = rng.standard_normal((n_phys, ps) + row_shape).astype(np.float32)
    table = rng.permutation(n_phys)[: B * npages].reshape(B, npages)
    lengths = rng.integers(1, npages * ps + 1, B).astype(np.int32)
    needed = lengths[:, None] > np.arange(npages)[None, :] * ps
    table = np.where(needed, table, -1).astype(np.int32)
    return q, pages, table, lengths


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("B,H,KV,D,ps,npages", [
    (2, 4, 2, 32, 16, 8),
    (1, 8, 1, 16, 8, 12),
    (3, 4, 4, 64, 32, 4),
])
def test_plain_paged_decode_matches_jax_oracle_and_pallas(B, H, KV, D, ps,
                                                         npages):
    rng = np.random.default_rng(B * 100 + H)
    q, pages, table, lengths = _paged_inputs(
        rng, B, npages, ps, B * npages + 3, (2, KV, D), H, D)
    scale = D ** -0.5
    got = tref.paged_decode_attention(_t(q), _t(pages), _t(table),
                                      _t(lengths), scale).numpy()
    want = jref.paged_decode_attention(jnp.asarray(q), jnp.asarray(pages),
                                       jnp.asarray(table),
                                       jnp.asarray(lengths), scale)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    kern = pallas_paged(jnp.asarray(q), jnp.asarray(pages),
                        jnp.asarray(table), jnp.asarray(lengths), scale=scale)
    np.testing.assert_allclose(got, np.asarray(kern), **TOL)


@pytest.mark.parametrize("B,H,r,rp,ps,npages", [
    (2, 4, 16, 8, 8, 4),
    (1, 8, 32, 16, 16, 6),
    (3, 2, 8, 8, 4, 5),
])
def test_plain_paged_mla_matches_jax_oracle_and_pallas(B, H, r, rp, ps,
                                                      npages):
    e = r + rp
    rng = np.random.default_rng(B * 100 + H + r)
    q, pages, table, lengths = _paged_inputs(
        rng, B, npages, ps, B * npages + 3, (e,), H, e)
    scale = e ** -0.5
    got = tref.paged_mla_decode_attention(_t(q), _t(pages), _t(table),
                                          _t(lengths), r, scale).numpy()
    want = jref.paged_mla_decode_attention(
        jnp.asarray(q), jnp.asarray(pages), jnp.asarray(table),
        jnp.asarray(lengths), r, scale)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    kern = pallas_paged_mla(jnp.asarray(q), jnp.asarray(pages),
                            jnp.asarray(table), jnp.asarray(lengths),
                            latent_dim=r, scale=scale)
    np.testing.assert_allclose(got, np.asarray(kern), **TOL)


def _flat(pages, page_elems, fill=7.0):
    """Typed pages -> a flat pool whose pages carry ``fill`` slack."""
    n = pages.shape[0]
    rows = pages.reshape(n, -1)
    flat = np.full((n, page_elems), fill, np.float32)
    flat[:, : rows.shape[1]] = rows
    return flat


@pytest.mark.parametrize("slack", [0, 24])
def test_wrappers_on_cpu_read_the_flat_pool(slack):
    """The kernel entry points take the FLAT pool and its page geometry;
    on the CPU they equal the JAX oracle on the typed view, whatever the
    page slack holds — and they count no launch."""
    rng = np.random.default_rng(slack)
    B, H, KV, D, ps, npages = 2, 4, 2, 16, 8, 5
    q, pages, table, lengths = _paged_inputs(rng, B, npages, ps, 13,
                                             (2, KV, D), H, D)
    flat = _flat(pages, ps * 2 * KV * D + slack)
    before = kops.paged_decode_attention.launches
    got = kops.paged_decode_attention(
        _t(q), _t(flat), _t(table), _t(lengths), tokens_per_page=ps,
        n_kv=KV, scale=D ** -0.5).numpy()
    want = jref.paged_decode_attention(jnp.asarray(q), jnp.asarray(pages),
                                       jnp.asarray(table),
                                       jnp.asarray(lengths), D ** -0.5)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)

    r, rp = 16, 8
    q, pages, table, lengths = _paged_inputs(rng, B, npages, ps, 13,
                                             (r + rp,), H, r + rp)
    flat = _flat(pages, ps * (r + rp) + slack)
    got = kops.paged_mla_decode_attention(
        _t(q), _t(flat), _t(table), _t(lengths), tokens_per_page=ps,
        latent_dim=r, scale=0.3).numpy()
    want = jref.paged_mla_decode_attention(
        jnp.asarray(q), jnp.asarray(pages), jnp.asarray(table),
        jnp.asarray(lengths), r, 0.3)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    assert kops.paged_decode_attention.launches == before


def test_plain_version_ignores_garbage_past_lengths():
    """NaN in slots past a length, in mapped pages past it and in unmapped
    pages never reaches the output (the kernels' 0 * garbage guard)."""
    rng = np.random.default_rng(5)
    B, H, KV, D, ps, npages = 2, 4, 2, 8, 4, 6
    q, pages, table, lengths = _paged_inputs(rng, B, npages, ps, 15,
                                             (2, KV, D), H, D)
    clean = tref.paged_decode_attention(_t(q), _t(pages), _t(table),
                                        _t(lengths), 0.5)
    dirty = pages.copy()
    used = set()
    for b in range(B):
        for p in range(npages):
            page = table[b, p]
            if page < 0:
                continue
            used.add(page)
            for s in range(ps):
                if p * ps + s >= lengths[b]:
                    dirty[page, s] = np.nan
    for page in set(range(15)) - used:
        dirty[page] = np.nan
    got = tref.paged_decode_attention(_t(q), _t(dirty), _t(table),
                                      _t(lengths), 0.5)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, clean, rtol=0, atol=0)


def test_paged_kv_write_matches_jax_and_drops_negative_pages():
    rng = np.random.default_rng(9)
    pool = rng.standard_normal((6, 40)).astype(np.float32)
    kv = rng.standard_normal((5, 8)).astype(np.float32)
    pages = np.array([3, -1, 0, 5, -2], np.int32)
    slots = np.array([1, 2, 4, 0, 3], np.int32)
    want = np.asarray(jops.paged_kv_write(jnp.asarray(pool), jnp.asarray(kv),
                                          jnp.asarray(pages),
                                          jnp.asarray(slots)))
    t_pool = _t(pool.copy())
    out = kops.paged_kv_write(t_pool, _t(kv), _t(pages), _t(slots))
    assert out is t_pool                          # in place
    np.testing.assert_array_equal(out.numpy(), want)


def test_wrapper_rejects_devices_without_a_kernel():
    q = torch.zeros((1, 1, 2, 8), device="meta")
    with pytest.raises(ValueError):
        kops.paged_decode_attention(q, q, q, q, tokens_per_page=1, n_kv=1,
                                    scale=1.0)


def test_kernel_build_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the build would run")
    with pytest.raises(RuntimeError, match="CUDA card"):
        kpa.build_library()
