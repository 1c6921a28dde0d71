"""The port's kernels' plain versions against the JAX package.

On the CPU every kernel wrapper takes its plain PyTorch version
(``repro_torch.kernels.ref``, and the chunked SSD scan of
``repro_torch.kernels.ssd_chunked``); those are held here against the JAX
oracles (``repro.kernels.ref``) and the Pallas kernels in interpret mode
on the sweeps of ``tests/test_kernels.py``: attention within 2e-5 in
float32, with ragged lengths and unmapped (-1) table entries; the SSD
scan within 1e-3 (``tests/test_kernels.py``'s tolerance: the chunked
form sums in another order than the recurrence).  The CUDA kernels
themselves run only on a card (``tests/test_torch_cuda.py``).
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.moe_gemm import moe_gemm as pallas_moe_gemm
from repro.kernels.paged_attention import (contiguous_decode_attention as
                                           pallas_decode,
                                           paged_decode_attention as
                                           pallas_paged,
                                           paged_mla_decode_attention as
                                           pallas_paged_mla)
from repro.kernels.ssd_chunked import ssd_scan_chunked as j_chunked
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd
from repro_torch.bridge import to_torch
from repro_torch.configs import ARCH_NAMES, get_config, get_smoke_config
from repro_torch.core import split_exec
from repro_torch.kernels import build
from repro_torch.kernels import ops as kops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref as tref
from repro_torch.kernels.ssd_chunked import (ssd_decode_step,
                                             ssd_scan_chunked)
from torch_threads import one_torch_thread  # noqa: F401

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
        build.build_all()
    with pytest.raises(RuntimeError, match="CUDA card"):
        build.build_library(build.CSRC / "ssd_scan.cu")


def test_every_source_has_its_own_library():
    """One library per source, named by its content: an edit to one
    source rebuilds that one only."""
    srcs = build.sources()
    assert {p.name for p in srcs} >= {"paged_attention.cu",
                                      "flash_attention.cu", "ssd_scan.cu",
                                      "moe_gemm.cu"}
    libs = {build.library_path(p).name for p in srcs}
    assert len(libs) == len(srcs)
    assert all(build.library_path(p).parent == build.BUILD_DIR for p in srcs)


# ---------------------------------------------------------------------------
# the bf16 GQA decode kernels' split-KV plan and merge (flash-decoding)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch,kv_blocks,max_tokens", [
    (4, 4, 1024),          # qwen3-moe, B=4, 1k context
    (1, 4, 8192),          # qwen3-moe, B=1, 8k
    (1, 4, 32768),
    (4, 32, 1024),         # zamba2's contiguous cache
    (1, 32, 1024),
    (4, 16, 1024),         # moonshot
    (1, 1, 100),           # fewer tiles than SMs
    (64, 8, 4096),         # a large batch: no split
    (1, 1, 10 ** 6),       # capped
])
def test_kv_split_plan(batch, kv_blocks, max_tokens):
    """At least one split, never more than tiles (so no split lies wholly
    past a full context) or ``MAX_SPLITS``, and ``BLOCKS_PER_SM`` blocks
    per SM where the context has the tiles for it; the splits tile the context without gap
    or overlap.  The plan reads no lengths."""
    sm = 132
    splits = pa.kv_splits(batch, kv_blocks, max_tokens, sm)
    tiles = pa.n_tiles(max_tokens)
    assert 1 <= splits <= min(tiles, pa.MAX_SPLITS)
    blocks = batch * kv_blocks * splits
    assert blocks >= min(pa.BLOCKS_PER_SM * sm,
                         batch * kv_blocks * min(tiles, pa.MAX_SPLITS))
    starts = [pa.split_start(s, splits, max_tokens)
              for s in range(splits + 1)]
    assert starts[0] == 0 and starts[-1] >= max_tokens
    assert all(a < b for a, b in zip(starts, starts[1:]))
    assert all(a < max_tokens for a in starts[:-1])
    assert all(a % pa.TILE == 0 for a in starts)
    assert "lengths" not in inspect.signature(pa.kv_splits).parameters


@pytest.mark.parametrize("group,rows", [(1, 1), (2, 2), (3, 4), (4, 4),
                                        (7, 4), (8, 16), (16, 16),
                                        (32, 16)])
def test_rows_per_block_routes_by_group(group, rows):
    """G >= 8 query heads per kv head go to tensor cores (16 rows a
    block), fewer to CUDA cores (1, 2 or 4 a block)."""
    assert pa.rows_per_block(group) == rows


@pytest.mark.parametrize("H,KV,groups", [(64, 4, 1), (16, 16, 1),
                                         (48, 2, 2), (56, 8, 2)])
def test_split_plan_counts_head_groups(H, KV, groups):
    """A kv head whose G query heads exceed a block's rows takes several
    blocks (qwen3-moe G=16: one; G=24: two of 16; llava G=7: two of 4),
    and the split plan counts them; it reads no lengths either."""
    rows, splits = pa.split_plan(2, H, KV, 4096, 132)
    assert rows == pa.rows_per_block(H // KV)
    assert -(-(H // KV) // rows) == groups
    assert splits == pa.kv_splits(2, KV * groups, 4096, 132)
    assert "lengths" not in inspect.signature(pa.split_plan).parameters


@pytest.mark.parametrize("batch,heads,max_tokens,groups", [
    (4, 40, 37 * 28, 3),      # minicpm3 (40 heads: 3 blocks of 16), B=4, 1k
    (1, 40, 37 * 28, 3),      # ... B=1, 1k
    (1, 40, 293 * 28, 3),     # ... B=1, 8k: many tiles
    (4, 40, 293 * 28, 3),
    (6, 12, 73 * 7, 1),       # the small f32 check's geometry
    (2, 4, 8 * 8, 1),         # the smoke config: one tile, one split
    (96, 40, 37 * 28, 3),     # a large batch: no split
])
def test_mla_split_plan(batch, heads, max_tokens, groups):
    """The bf16 MLA kernel serves 16 heads a block (``ceil(H / 16)``
    blocks a row) and splits the context as the GQA kernels do, from
    shapes alone: at least one split, never more than tiles or
    ``MAX_SPLITS``, ``BLOCKS_PER_SM`` blocks per SM where the tiles allow;
    it reads no lengths."""
    sm = 132
    got_groups, splits = pa.mla_split_plan(batch, heads, max_tokens, sm)
    assert got_groups == groups == -(-heads // pa.MLA_ROWS)
    assert splits == pa.kv_splits(batch, groups, max_tokens, sm)
    tiles = pa.n_tiles(max_tokens)
    assert 1 <= splits <= min(tiles, pa.MAX_SPLITS)
    assert batch * groups * splits >= min(pa.BLOCKS_PER_SM * sm,
                                          batch * groups * tiles)
    assert "lengths" not in inspect.signature(pa.mla_split_plan).parameters


def _served_mla_widths():
    """(name, r, rp) of every MLA model the engine serves, at its
    published and its smoke widths."""
    return [(f"{name}-{width}", cfg.mla.kv_lora_rank,
             cfg.mla.qk_rope_head_dim)
            for name in ARCH_NAMES
            for width, cfg in (("full", get_config(name)),
                               ("smoke", get_smoke_config(name)))
            if cfg.attention == "mla" and split_exec.supports_split(cfg)]


@pytest.mark.parametrize("name,r,rp", _served_mla_widths())
def test_bf16_mla_kernel_takes_every_served_width(name, r, rp):
    """The bf16 MLA kernel is instantiated for every MLA model the engine
    serves, published and smoke widths (the serve CLI's default)."""
    pa.check_mla_geometry(r, rp)


@pytest.mark.parametrize("r,rp", [(256, 64), (128, 32), (32, 16), (16, 0),
                                  (8, 8)])
def test_bf16_mla_kernel_refuses_what_it_lacks(r, rp):
    """Widths without an instance raise ``ValueError``; the wrapper never
    falls back to the plain version on a card."""
    with pytest.raises(ValueError):
        pa.check_mla_geometry(r, rp)


def _served_gqa_geometries():
    """(name, H, KV, D) of every GQA model the engine serves, at its
    published and its smoke widths: the split path's families and the
    hybrid's shared attention block."""
    out = []
    for name in ARCH_NAMES:
        for width, cfg in (("full", get_config(name)),
                           ("smoke", get_smoke_config(name))):
            served = (split_exec.supports_split(cfg)
                      or cfg.family == "hybrid")
            if served and cfg.attention == "gqa":
                out.append((f"{name}-{width}", cfg.n_heads, cfg.n_kv_heads,
                            cfg.head_dim))
    return out


@pytest.mark.parametrize("name,H,KV,D", _served_gqa_geometries())
def test_bf16_gqa_kernels_take_every_served_geometry(name, H, KV, D):
    """The bf16 GQA decode kernels are instantiated for every model the
    engine serves in bf16, the smoke configs' head dim 8 included (the
    serve CLI's default models)."""
    pa.check_bf16_geometry(H, KV, D)


@pytest.mark.parametrize("H,KV,D", [(16, 1, 8), (8, 2, 256), (8, 2, 48),
                                    (6, 4, 64)])
def test_bf16_gqa_kernels_refuse_what_they_lack(H, KV, D):
    """Head dim 8 on tensor cores (G >= 8), head dims without an
    instantiation, and heads that do not group over the kv heads."""
    with pytest.raises(ValueError):
        pa.check_bf16_geometry(H, KV, D)


def _split_and_merge(q, k, v, lengths, splits, scale, value_dim=None):
    """Flash-decoding in torch, as the decode kernels compute it: per
    split the (m, l, acc) of its tokens below the length (m = -1e30, l =
    0 for a split with none), then ``out = sum_s e^(m_s - M) acc_s /
    sum_s e^(m_s - M) l_s`` over the splits with l_s > 0, 0 where there
    is none.  q [B,1,H,Dk]; k [B,T,KV,Dk], v [B,T,KV,Dv] dense (MLA: one
    kv head whose value is the key row's latent prefix).  With ``v``
    None the value is read from the key row itself, its first
    ``value_dim`` elements, as the float32 body reads MLA's rows."""
    if v is None:
        v = k[..., :value_dim]
    B, _, H, Dk = q.shape
    T, KV, Dv = k.shape[1], k.shape[2], v.shape[3]
    qs = (q.float() * scale).to(q.dtype).float().reshape(B, KV, H // KV, Dk)
    m = torch.full((B, H, splits), -1e30)
    l = torch.zeros((B, H, splits))
    acc = torch.zeros((B, H, splits, Dv))
    for s in range(splits):
        lo = pa.split_start(s, splits, T)
        for b in range(B):
            hi = min(pa.split_start(s + 1, splits, T), int(lengths[b]), T)
            if lo >= hi:
                continue
            sc = torch.einsum("kgd,tkd->kgt", qs[b], k[b, lo:hi].float())
            mx = sc.amax(-1)
            p = torch.exp(sc - mx[..., None])
            m[b, :, s] = mx.reshape(H)
            l[b, :, s] = p.sum(-1).reshape(H)
            acc[b, :, s] = torch.einsum("kgt,tkd->kgd", p,
                                        v[b, lo:hi].float()).reshape(H, Dv)
    big = torch.where(l > 0, m, torch.full_like(m, -1e30)).amax(-1,
                                                                keepdim=True)
    w = torch.where(l > 0, torch.exp(m - big), torch.zeros_like(m))
    den = (w * l).sum(-1)
    num = (w[..., None] * acc).sum(-2)
    out = torch.where(den[..., None] > 0,
                      num / den.clamp(min=1e-30)[..., None],
                      torch.zeros_like(num))
    return out.reshape(B, 1, H, Dv)


def _gqa_case(rng):
    """(q, typed pages, table, lengths, dense K, dense V, scale, the plain
    version, the JAX oracle) of the GQA split-and-merge check."""
    B, H, KV, D, ps, npages = 5, 8, 2, 16, 16, 40
    q, pages, table, lengths = _paged_inputs(
        rng, B, npages, ps, B * npages + 3, (2, KV, D), H, D)
    lengths[:3] = [0, 1, npages * ps]                 # empty, one, full
    table[2] = rng.permutation(B * npages + 3)[:npages]
    dense = pages[np.maximum(table, 0)].reshape(B, npages * ps, 2, KV, D)
    return (q, pages, table, lengths, dense[:, :, 0], dense[:, :, 1],
            D ** -0.5, tref.paged_decode_attention,
            jref.paged_decode_attention, ())


def _mla_case(rng):
    """The same for MLA: rows [r + rp] whose value is the latent prefix."""
    B, H, r, rp, ps, npages = 5, 12, 32, 16, 7, 90
    q, pages, table, lengths = _paged_inputs(
        rng, B, npages, ps, B * npages + 3, (r + rp,), H, r + rp)
    lengths[:3] = [0, 1, npages * ps]
    table[2] = rng.permutation(B * npages + 3)[:npages]
    dense = pages[np.maximum(table, 0)].reshape(B, npages * ps, 1, r + rp)
    return (q, pages, table, lengths, dense, dense[..., :r],
            (r + rp) ** -0.5, tref.paged_mla_decode_attention,
            jref.paged_mla_decode_attention, (r,))


@pytest.mark.parametrize("kind,splits", [
    pytest.param(kind, s, id=s_id)
    for kind, prefix in (("gqa", ""), ("mla", "mla-"))
    for s in (1, 2, 3, 7, 16) for s_id in (f"{prefix}{s}",)])
def test_split_and_merge_matches_the_plain_version_and_jax(kind, splits):
    """The merge the kernels rely on equals one softmax over the whole
    context (the port's plain version, and the JAX oracle on the rows
    with a token), within 2e-5, for uneven splits, splits with no token
    (past a length, or more splits than tiles) and a row of length 0,
    which writes 0 as the TPU kernel does (the oracle, which has no
    ``l == 0`` guard, averages the rows past the length instead).  For
    MLA the key is the whole row and the value its latent prefix."""
    rng = np.random.default_rng(splits)
    (q, pages, table, lengths, k, v, scale, plain, oracle,
     extra) = (_gqa_case if kind == "gqa" else _mla_case)(rng)
    got = _split_and_merge(_t(q), _t(k), _t(v), _t(lengths), splits, scale)
    want = plain(_t(q), _t(pages), _t(table), _t(lengths), *extra, scale)
    torch.testing.assert_close(got, want, **TOL)
    jax_out = oracle(jnp.asarray(q), jnp.asarray(pages), jnp.asarray(table),
                     jnp.asarray(lengths), *extra, scale)
    np.testing.assert_allclose(got[1:].numpy(), np.asarray(jax_out)[1:],
                               **TOL)
    assert not got[0].any()                           # length 0 -> 0


def _f32_splits():
    """(id, kind, splits): the float32 plan's split counts for the two
    cases' shapes on 132 and 16 SMs, and uneven counts."""
    out = []
    for kind, (B, H, KV, T) in (("gqa", (5, 8, 2, 640)),
                                ("mla", (5, 12, 1, 630))):
        plans = {pa.split_plan(B, H, KV, T, sm, torch.float32)[1]
                 for sm in (132, 16)}
        out += [(f"{kind}-f32-{s}", kind, s) for s in sorted(plans | {3, 7})]
    return out


@pytest.mark.parametrize("name,kind,splits", _f32_splits())
def test_f32_split_and_merge_reads_the_value_from_the_key_row(name, kind,
                                                              splits):
    """The float32 body's form: MLA as one kv head for all H heads, the
    value the key row's latent prefix read from the staged key row (no
    value tensor), GQA with its own value rows; split as the float32 plan
    splits (and unevenly), merged, within 2e-5 of the JAX oracle, with
    splits that hold no token and a row of length 0 (which writes 0)."""
    rng = np.random.default_rng(splits + 100)
    (q, pages, table, lengths, k, v, scale, plain, oracle,
     extra) = (_gqa_case if kind == "gqa" else _mla_case)(rng)
    if kind == "mla":
        got = _split_and_merge(_t(q), _t(k), None, _t(lengths), splits,
                               scale, value_dim=extra[0])
    else:
        got = _split_and_merge(_t(q), _t(k), _t(v), _t(lengths), splits,
                               scale)
    jax_out = oracle(jnp.asarray(q), jnp.asarray(pages), jnp.asarray(table),
                     jnp.asarray(lengths), *extra, scale)
    np.testing.assert_allclose(got[1:].numpy(), np.asarray(jax_out)[1:],
                               **TOL)
    torch.testing.assert_close(
        got, plain(_t(q), _t(pages), _t(table), _t(lengths), *extra, scale),
        **TOL)
    assert not got[0].any()


# ---------------------------------------------------------------------------
# flash prefill and contiguous decode (the fallback families' attention)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,T,H,KV,D", [
    (1, 16, 16, 4, 4, 16),
    (2, 12, 20, 4, 2, 32),           # prefix offset T - S = 8
    (1, 33, 33, 8, 1, 16),           # ragged tiles, MQA
    # the sharded steps' rank geometries, scaled down: S < T with an
    # offset (37, 33) that is no multiple of any tile of either body
    (1, 24, 61, 8, 8, 128),          # moonshot's rank of (2,2)
    (1, 24, 61, 10, 2, 128),         # qwen3-14b's rank of (1,4)
    (1, 20, 53, 16, 8, 256),         # gemma3's global layers
])
def test_plain_flash_matches_jax_oracle_and_pallas(B, S, T, H, KV, D):
    rng = np.random.default_rng(S * 10 + T)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, T, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, T, KV, D)).astype(np.float32)
    scale = D ** -0.5
    before = kops.flash_attention.launches
    got = kops.flash_attention(_t(q), _t(k), _t(v), scale=scale).numpy()
    assert kops.flash_attention.launches == before      # CPU: no kernel
    want = jref.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), scale)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    kern = pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        scale=scale, block_q=8, block_k=8)
    np.testing.assert_allclose(got, np.asarray(kern), **TOL)


@pytest.mark.parametrize("B,T,H,KV,D", [(3, 24, 4, 4, 16), (2, 40, 8, 2, 32),
                                        (1, 9, 4, 1, 16)])
def test_plain_decode_matches_jax_oracle_and_pallas(B, T, H, KV, D):
    rng = np.random.default_rng(B * 7 + T)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    ck = rng.standard_normal((B, T, KV, D)).astype(np.float32)
    cv = rng.standard_normal((B, T, KV, D)).astype(np.float32)
    lengths = rng.integers(1, T + 1, B).astype(np.int32)
    lengths[0] = T
    scale = D ** -0.5
    before = kops.decode_attention.launches
    got = kops.decode_attention(_t(q), _t(ck), _t(cv), _t(lengths),
                                scale=scale).numpy()
    assert kops.decode_attention.launches == before
    want = jref.decode_attention(jnp.asarray(q), jnp.asarray(ck),
                                 jnp.asarray(cv), jnp.asarray(lengths), scale)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    kern = pallas_decode(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
                         jnp.asarray(lengths), scale=scale, block_t=8)
    np.testing.assert_allclose(got, np.asarray(kern), **TOL)


def test_plain_decode_ignores_garbage_past_lengths():
    """NaN in the cache past each length never reaches the output."""
    rng = np.random.default_rng(11)
    B, T, H, KV, D = 3, 16, 4, 2, 8
    q = _t(rng.standard_normal((B, 1, H, D)).astype(np.float32))
    ck = rng.standard_normal((B, T, KV, D)).astype(np.float32)
    cv = rng.standard_normal((B, T, KV, D)).astype(np.float32)
    lengths = np.array([16, 5, 1], np.int32)
    clean = tref.decode_attention(q, _t(ck), _t(cv), _t(lengths), 0.4)
    for b, n in enumerate(lengths):
        ck[b, n:] = np.nan
        cv[b, n:] = np.nan
    got = tref.decode_attention(q, _t(ck), _t(cv), _t(lengths), 0.4)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, clean, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Mamba2 SSD scan
# ---------------------------------------------------------------------------

SSD_TOL = dict(rtol=1e-3, atol=1e-3)


def _ssd_inputs(rng, B, S, H, P, G, N, with_h0):
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H)).astype(np.float32)
    Bm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    h0 = (rng.standard_normal((B, H, P, N)).astype(np.float32)
          if with_h0 else None)
    return x, dt, A, Bm, Cm, h0


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,S,H,P,G,N,chunk", [
    (1, 32, 4, 8, 1, 16, 8),
    (2, 48, 4, 16, 2, 8, 16),
    (1, 24, 6, 4, 3, 4, 24),
])
def test_chunked_ssd_matches_sequential_oracle_and_jax(B, S, H, P, G, N,
                                                       chunk, with_h0):
    """The SSD kernel's plain version (the chunked scan, what
    ``ops.ssd_scan`` runs on the CPU) against the port's sequential
    oracle, the JAX oracle, the JAX chunked form and the Pallas kernel."""
    rng = np.random.default_rng(S + H + with_h0)
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(rng, B, S, H, P, G, N, with_h0)
    t_h0 = None if h0 is None else _t(h0)
    before = kops.ssd_scan.launches
    y, h = kops.ssd_scan(_t(x), _t(dt), _t(A), _t(Bm), _t(Cm), chunk=chunk,
                         h0=t_h0)
    assert kops.ssd_scan.launches == before
    y_seq, h_seq = tref.ssd_scan(_t(x), _t(dt), _t(A), _t(Bm), _t(Cm),
                                 h0=t_h0)
    np.testing.assert_allclose(y.numpy(), y_seq.numpy(), **SSD_TOL)
    np.testing.assert_allclose(h.numpy(), h_seq.numpy(), **SSD_TOL)
    j_in = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm)]
    j_h0 = None if h0 is None else jnp.asarray(h0)
    for want_y, want_h in (jref.ssd_scan(*j_in, h0=j_h0),
                           j_chunked(*j_in, chunk=chunk, h0=j_h0),
                           pallas_ssd(*j_in, chunk=chunk, h0=j_h0)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **SSD_TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **SSD_TOL)
    np.testing.assert_allclose(y_seq.numpy(), np.asarray(jref.ssd_scan(
        *j_in, h0=j_h0)[0]), **TOL)


def test_chunked_ssd_matches_jax_chunked_form():
    """At f32 the port's chunked scan is the reference's XLA route:
    within 1e-5 of ``repro.kernels.ssd_chunked`` (the same sums)."""
    rng = np.random.default_rng(21)
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(rng, 2, 32, 4, 8, 1, 8, True)
    y, h = ssd_scan_chunked(_t(x), _t(dt), _t(A), _t(Bm), _t(Cm), chunk=16,
                            h0=_t(h0))
    wy, wh = j_chunked(*[jnp.asarray(a) for a in (x, dt, A, Bm, Cm)],
                       chunk=16, h0=jnp.asarray(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(wh), **TOL)


def test_chunked_ssd_refuses_a_chunk_that_does_not_divide():
    x = torch.zeros((1, 10, 2, 4))
    with pytest.raises(ValueError):
        ssd_scan_chunked(x, torch.zeros((1, 10, 2)), torch.zeros(2),
                         torch.zeros((1, 10, 1, 4)),
                         torch.zeros((1, 10, 1, 4)), chunk=4)


def test_ssd_decode_step_continues_the_scan():
    """A chunked scan over S tokens, then one decode step, equals the
    sequential recurrence over S + 1 tokens."""
    rng = np.random.default_rng(8)
    x, dt, A, Bm, Cm, _ = _ssd_inputs(rng, 2, 17, 4, 8, 2, 8, False)
    t = [_t(a) for a in (x, dt, A, Bm, Cm)]
    _, h = ssd_scan_chunked(t[0][:, :16], t[1][:, :16], t[2], t[3][:, :16],
                            t[4][:, :16], chunk=8)
    y_t, h_next = ssd_decode_step(h, t[0][:, 16], t[1][:, 16], t[2],
                                  t[3][:, 16], t[4][:, 16])
    y_seq, h_seq = tref.ssd_scan(*t)
    np.testing.assert_allclose(y_t.numpy(), y_seq[:, 16].numpy(), **SSD_TOL)
    np.testing.assert_allclose(h_next.numpy(), h_seq.numpy(), **SSD_TOL)


# ---------------------------------------------------------------------------
# grouped expert GEMM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("N,K,M,E,bn,bm", [
    (256, 64, 128, 4, 64, 64),
    (128, 32, 64, 8, 32, 32),
    (96, 16, 48, 3, 32, 16),             # ragged everything
    (64, 128, 256, 2, 64, 128),
])
def test_plain_moe_gemm_matches_jax_oracle_and_pallas(N, K, M, E, bn, bm,
                                                      dtype):
    """The shapes and groups of ``tests/test_kernels.py`` (some groups
    empty); float32 within 1e-4, bf16 within 2e-2."""
    rng = np.random.default_rng(N + E)
    x = jnp.asarray(rng.standard_normal((N, K)), dtype)
    w = jnp.asarray(rng.standard_normal((E, K, M)), dtype)
    cuts = np.sort(rng.integers(0, N + 1, E - 1))
    sizes = np.diff(np.concatenate([[0], cuts, [N]])).astype(np.int32)
    before = kops.moe_gemm.launches
    got = kops.moe_gemm(to_torch(np.asarray(x)), to_torch(np.asarray(w)),
                        _t(sizes))
    assert kops.moe_gemm.launches == before               # CPU: no kernel
    assert got.dtype == (torch.bfloat16 if dtype == jnp.bfloat16
                         else torch.float32)
    tol = (dict(rtol=2e-2, atol=2e-2) if dtype == jnp.bfloat16
           else dict(rtol=1e-4, atol=1e-4))
    got = got.float().numpy()
    gs = jnp.asarray(sizes)
    for want in (jref.moe_gemm(x, w, gs),
                 pallas_moe_gemm(x, w, gs, block_n=bn, block_m=bm)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32), **tol)


def test_plain_moe_gemm_zeroes_rows_past_the_groups():
    """Rows no expert covers come out 0 (as the kernels write them), and
    the weight gradient of an expert with no rows is 0."""
    rng = np.random.default_rng(2)
    x = _t(rng.standard_normal((10, 4)).astype(np.float32))
    w = _t(rng.standard_normal((3, 4, 5)).astype(np.float32))
    sizes = _t(np.array([3, 0, 4], np.int32))
    out = tref.moe_gemm(x, w, sizes)
    assert not out[7:].any()
    torch.testing.assert_close(out[3:7], x[3:7] @ w[2])
    dw = tref.moe_gemm_wgrad(x, out, sizes)
    assert not dw[1].any()
    torch.testing.assert_close(dw[0], x[:3].T @ out[:3])
