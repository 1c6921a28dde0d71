"""The port on a CUDA card: the hand-written kernels against their plain
PyTorch versions, the engine and the train step on the card against the
CPU.

Every test here needs a card and carries the ``cuda`` marker; without a
card each one skips (the CUDA kernels have no CPU mode).  The file
imports nothing of JAX, so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import PAPER_COLOC_SET, get_smoke_config
from repro_torch.configs.base import EngineConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref as tref
from repro_torch.kernels.ssd_chunked import ssd_scan_chunked
from repro_torch.models.model import build_model
from repro_torch.models.transformer import init_params
from repro_torch.runtime.engine import CrossPoolEngine, EngineMode
from repro_torch.runtime.request import Request
from repro_torch.training.optimizer import AdamW
from repro_torch.training.train_step import TrainState, make_train_step
from repro_torch.training.tree import leaves, map_tree

pytestmark = pytest.mark.cuda
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def smoke():
    """``chip_smoke.py`` at the repo's root: its graph checks."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(rng, B, npages, ps, n_phys, row, H, q_dim, page_elems):
    """q and a flat pool whose unused slots and slack hold NaN, a shuffled
    table (-1 past each length) and ragged lengths."""
    q = rng.standard_normal((B, 1, H, q_dim)).astype(np.float32)
    pool = np.full((n_phys, page_elems), np.nan, np.float32)
    pool[:, : ps * row] = rng.standard_normal((n_phys, ps * row))
    table = rng.permutation(n_phys)[: B * npages].reshape(B, npages)
    lengths = rng.integers(1, npages * ps + 1, B).astype(np.int32)
    lengths[0] = npages * ps                       # one full table
    needed = lengths[:, None] > np.arange(npages)[None, :] * ps
    table = np.where(needed, table, -1).astype(np.int32)
    return [torch.from_numpy(a) for a in (q, pool, table, lengths)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("H,KV,D,ps", [(8, 2, 64, 8), (16, 16, 128, 2),
                                       (64, 4, 128, 8)])
def test_gqa_kernel_matches_plain(cuda, dtype, tol, H, KV, D, ps):
    rng = np.random.default_rng(H + D)
    per_tok = 2 * KV * D
    q, pool, table, lengths = _inputs(rng, 3, 9, ps, 31, per_tok, H, D,
                                      ps * per_tok + 8)
    q, pool = q.to(cuda, dtype), pool.to(cuda, dtype)
    table, lengths = table.to(cuda), lengths.to(cuda)
    before = kops.paged_decode_attention.launches
    got = kops.paged_decode_attention(q, pool, table, lengths,
                                      tokens_per_page=ps, n_kv=KV,
                                      scale=D ** -0.5)
    assert kops.paged_decode_attention.launches == before + 1
    typed = pool[:, : ps * per_tok].reshape(-1, ps, 2, KV, D)
    want = tref.paged_decode_attention(q, typed, table, lengths, D ** -0.5)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("H,r,rp,ps", [(12, 64, 16, 7), (40, 256, 32, 28)])
def test_mla_kernel_matches_plain(cuda, dtype, tol, H, r, rp, ps):
    rng = np.random.default_rng(H + r)
    q, pool, table, lengths = _inputs(rng, 2, 5, ps, 13, r + rp, H, r + rp,
                                      ps * (r + rp) + 8)
    q, pool = q.to(cuda, dtype), pool.to(cuda, dtype)
    table, lengths = table.to(cuda), lengths.to(cuda)
    got = kops.paged_mla_decode_attention(q, pool, table, lengths,
                                          tokens_per_page=ps, latent_dim=r,
                                          scale=0.1)
    typed = pool[:, : ps * (r + rp)].reshape(-1, ps, r + rp)
    want = tref.paged_mla_decode_attention(q, typed, table, lengths, r, 0.1)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)


def _edge_inputs(rng, lengths, npages, ps, H, per_tok, q_dim, holes):
    """q [B,1,H,q_dim], a flat pool of ``per_tok``-element token rows that
    is NaN wherever no valid token lies (past every length, unmapped
    pages, page slack, the pages of ``holes``), a shuffled table and the
    lengths; ``holes`` are (row, page) pairs unmapped (-1) inside the
    row's length."""
    B = len(lengths)
    n_phys = B * npages + 3
    pool = np.full((n_phys, ps * per_tok + 8), np.nan, np.float32)
    table = np.full((B, npages), -1, np.int32)
    ids = rng.permutation(n_phys)
    for b, n in enumerate(lengths):
        for p in range(-(-n // ps)):
            table[b, p] = ids[b * npages + p]
            if (b, p) not in holes:
                k = min(ps, n - p * ps)
                pool[table[b, p], : k * per_tok] = rng.standard_normal(
                    k * per_tok)
    for b, p in holes:
        table[b, p] = -1
    q = rng.standard_normal((B, 1, H, q_dim)).astype(np.float32)
    return q, pool, table, np.array(lengths, np.int32)


def _without_holes(table, lengths, holes, ps):
    """The table and lengths on which the plain version computes what the
    kernel does: each hole (a whole page inside a length, skipped) taken
    out, the row's later pages moved up, its length cut by a page."""
    table, lengths = table.copy(), lengths.copy()
    for b in {b for b, _ in holes}:
        gone = [p for r, p in holes if r == b]
        assert all((p + 1) * ps < lengths[b] for p in gone)
        row = [t for p, t in enumerate(table[b]) if p not in gone]
        table[b] = row + [-1] * len(gone)
        lengths[b] -= len(gone) * ps
    return table, lengths


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("H,KV,D,ps", [(64, 4, 128, 8), (16, 16, 128, 2),
                                       (8, 2, 64, 8), (48, 2, 32, 4),
                                       (8, 2, 8, 4)])
def test_gqa_kernel_edges(cuda, dtype, tol, H, KV, D, ps):
    """The split kernel's edges: lengths 0 and 1, on a split boundary and
    one token either side of it, ending mid-page; unmapped (-1) pages
    inside two lengths; NaN past every length.  Geometries: qwen3-moe
    (tensor cores), moonshot (MHA, CUDA cores), G = 4 (CUDA cores),
    G = 24 (tensor cores, two blocks per kv head) and the smoke configs'
    head dim 8 (CUDA cores)."""
    rng = np.random.default_rng(H * D + ps)
    npages = 512 // ps
    _, splits = pa.split_plan(6, H, KV, npages * ps,
                              torch.cuda.get_device_properties(cuda)
                              .multi_processor_count)
    edge = pa.split_start(1, splits, npages * ps)
    lengths = [0, 1, edge, edge - 1, edge + 1, ps * 50 + max(1, ps // 2)]
    holes = ((3, 1), (5, 2), (5, 4))
    q, pool, table, lengths = _edge_inputs(rng, lengths, npages, ps, H,
                                           2 * KV * D, D, holes)
    plain_table, plain_lengths = _without_holes(table, lengths, holes, ps)
    args = [torch.from_numpy(a).to(cuda) for a in (q, pool, table, lengths,
                                                   plain_table,
                                                   plain_lengths)]
    q, pool = args[0].to(dtype), args[1].to(dtype)
    got = kops.paged_decode_attention(q, pool, args[2], args[3],
                                      tokens_per_page=ps, n_kv=KV,
                                      scale=D ** -0.5)
    typed = pool[:, : ps * 2 * KV * D].reshape(-1, ps, 2, KV, D)
    want = tref.paged_decode_attention(q, typed, args[4], args[5], D ** -0.5)
    assert torch.isfinite(got).all()
    assert not got[0].any()                          # length 0 writes 0
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("H,r,rp,ps", [(40, 256, 32, 28), (12, 64, 16, 7),
                                       (4, 16, 8, 8)])
def test_mla_kernel_edges(cuda, dtype, tol, H, r, rp, ps):
    """The MLA kernels at the GQA kernels' edges: lengths 0 and 1, on the
    bf16 split plan's first boundary and one token either side of it,
    ending mid-page; unmapped (-1) pages inside two lengths; NaN past
    every length.  Geometries: minicpm3 at its published width (40 heads:
    three blocks of 16, the last 8 rows empty), the small f32 check's and
    the smoke config's (r + rp = 24: the score's k padded to 32)."""
    rng = np.random.default_rng(H * r + ps)
    npages = 512 // ps
    _, splits = pa.mla_split_plan(6, H, npages * ps,
                                  torch.cuda.get_device_properties(cuda)
                                  .multi_processor_count)
    edge = pa.split_start(1, splits, npages * ps)
    lengths = [0, 1, edge, edge - 1, edge + 1,
               ps * min(50, npages - 2) + max(1, ps // 2)]
    holes = ((3, 1), (5, 2), (5, 4))
    q, pool, table, lengths = _edge_inputs(rng, lengths, npages, ps, H,
                                           r + rp, r + rp, holes)
    plain_table, plain_lengths = _without_holes(table, lengths, holes, ps)
    args = [torch.from_numpy(a).to(cuda) for a in (q, pool, table, lengths,
                                                   plain_table,
                                                   plain_lengths)]
    q, pool = args[0].to(dtype), args[1].to(dtype)
    scale = (r + rp) ** -0.5
    before = kops.paged_mla_decode_attention.launches
    got = kops.paged_mla_decode_attention(q, pool, args[2], args[3],
                                          tokens_per_page=ps, latent_dim=r,
                                          scale=scale)
    assert kops.paged_mla_decode_attention.launches == before + 1
    typed = pool[:, : ps * (r + rp)].reshape(-1, ps, r + rp)
    want = tref.paged_mla_decode_attention(q, typed, args[4], args[5], r,
                                           scale)
    assert got.shape == (6, 1, H, r) and torch.isfinite(got).all()
    assert not got[0].any()                          # length 0 writes 0
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)


def test_mla_kernel_refuses_what_it_lacks(cuda):
    """bf16 MLA raises on a width it has no instance for, and on a pool
    that cp.async cannot read (a page of an odd number of elements)."""
    table = torch.zeros((1, 2), dtype=torch.int32, device=cuda)
    lens = torch.tensor([5], dtype=torch.int32, device=cuda)
    bf = dict(dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="widths"):
        kops.paged_mla_decode_attention(
            torch.zeros((1, 1, 4, 48), **bf), torch.zeros((4, 4 * 48), **bf),
            table, lens, tokens_per_page=4, latent_dim=32, scale=0.2)
    with pytest.raises(ValueError, match="16 bytes"):
        kops.paged_mla_decode_attention(
            torch.zeros((1, 1, 4, 24), **bf),
            torch.zeros((4, 4 * 24 + 3), **bf), table, lens,
            tokens_per_page=4, latent_dim=16, scale=0.2)


@pytest.mark.parametrize("H,KV,D,ps", [(64, 4, 128, 8), (16, 16, 128, 2)])
def test_gqa_kernel_long_context(cuda, H, KV, D, ps):
    """One row at context 32768 (many tiles per split), bf16."""
    gen = torch.Generator(device=cuda).manual_seed(ps)
    npages = 32768 // ps
    per_tok = 2 * KV * D
    pool = torch.randn((npages + 2, ps * per_tok), generator=gen,
                       device=cuda).to(torch.bfloat16)
    table = torch.randperm(npages + 2, generator=gen, device=cuda)[
        :npages].to(torch.int32)[None]
    lengths = torch.tensor([32768 - 3], dtype=torch.int32, device=cuda)
    q = torch.randn((1, 1, H, D), generator=gen, device=cuda).to(
        torch.bfloat16)
    got = kops.paged_decode_attention(q, pool, table, lengths,
                                      tokens_per_page=ps, n_kv=KV,
                                      scale=D ** -0.5)
    want = tref.paged_decode_attention(
        q, pool.reshape(-1, ps, 2, KV, D), table, lengths, D ** -0.5)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


def test_gqa_decode_is_sync_free_and_capturable(cuda):
    """The bf16 GQA wrappers read nothing back to the host (they run under
    ``set_sync_debug_mode("error")``), and a paged call captured in a
    CUDA graph, replayed after new lengths are written in place, equals
    an eager call on those lengths."""
    rng = np.random.default_rng(0)
    H, KV, D, ps = 64, 4, 128, 8
    q, pool, table, lengths = (torch.from_numpy(a).to(cuda) for a in
                               _edge_inputs(rng, [500, 512, 77, 1], 64, ps,
                                            H, 2 * KV * D, D, ()))
    q, pool = q.to(torch.bfloat16), pool.to(torch.bfloat16)
    kw = dict(tokens_per_page=ps, n_kv=KV, scale=D ** -0.5)
    ck = torch.randn((2, 256, 4, 64), device=cuda).to(torch.bfloat16)
    qc = torch.randn((2, 1, 4, 64), device=cuda).to(torch.bfloat16)
    clens = torch.tensor([256, 30], dtype=torch.int32, device=cuda)

    def calls():
        return (kops.paged_decode_attention(q, pool, table, lengths, **kw),
                kops.decode_attention(qc, ck, ck, clens, scale=0.125))
    calls()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        calls()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = kops.paged_decode_attention(q, pool, table, lengths, **kw)
    lengths.copy_(torch.tensor([300, 0, 77, 1], dtype=torch.int32))
    graph.replay()
    want = kops.paged_decode_attention(q, pool, table, lengths, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    assert not out[1].any()


def test_mla_decode_is_sync_free_and_capturable(cuda):
    """The bf16 MLA wrapper at minicpm3's geometry reads nothing back to
    the host (it runs under ``set_sync_debug_mode("error")``), and a call
    captured in a CUDA graph, replayed after new lengths are written in
    place, equals an eager call on those lengths."""
    rng = np.random.default_rng(1)
    H, r, rp, ps = 40, 256, 32, 28
    q, pool, table, lengths = (torch.from_numpy(a).to(cuda) for a in
                               _edge_inputs(rng, [500, 700, 77, 1], 37, ps,
                                            H, r + rp, r + rp, ()))
    q, pool = q.to(torch.bfloat16), pool.to(torch.bfloat16)
    kw = dict(tokens_per_page=ps, latent_dim=r, scale=(r + rp) ** -0.5)

    def call():
        return kops.paged_mla_decode_attention(q, pool, table, lengths, **kw)
    call()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    lengths.copy_(torch.tensor([300, 0, 77, 1], dtype=torch.int32))
    graph.replay()
    want = call()
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    assert not out[1].any()


def test_kernel_refuses_mismatched_dtypes(cuda):
    q = torch.zeros((1, 1, 4, 8), device=cuda)
    pool = torch.zeros((2, 64), dtype=torch.bfloat16, device=cuda)
    table = torch.zeros((1, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        kops.paged_decode_attention(q, pool, table, table[:, 0],
                                    tokens_per_page=4, n_kv=1, scale=1.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_engine_on_the_card_serves_and_returns_every_page(cuda, dtype):
    """The smoke coloc set served on the card, in float32 and in bf16 (its
    configs' own dtype, which ``python -m repro_torch.launch.serve`` runs
    by default; head dim 8): every request gets its tokens, both kernels
    launch, every page comes back."""
    models = {n: get_smoke_config(n).replace(dtype=dtype)
              for n in PAPER_COLOC_SET}
    params = {}
    for i, (n, c) in enumerate(models.items()):
        params[n] = init_params(torch.Generator().manual_seed(i), c)
    engine = CrossPoolEngine(
        models, page_budget=512, page_bytes=4096, slab_bytes=4096,
        max_batch=2, max_ctx=64, params=params, device=cuda,
        config=EngineConfig(mode=EngineMode(decode_steps_per_dispatch=4)))
    gqa = kops.paged_decode_attention.launches
    mla = kops.paged_mla_decode_attention.launches
    reqs = [Request(i, PAPER_COLOC_SET[i % 3], 5 + 7 * i, 6, 0.0)
            for i in range(6)]
    for r in reqs:
        engine.submit(r)
    engine.drain()
    assert [len(r.output_ids) for r in reqs] == [6] * 6
    assert engine.virt.mapped_pages == 0
    assert kops.paged_decode_attention.launches > gqa
    assert kops.paged_mla_decode_attention.launches > mla
    assert all(int(r.nonfinite_logits) == 0
               for r in engine.runners.values())


# ---------------------------------------------------------------------------
# the fallback families' kernels: flash prefill, contiguous decode, SSD
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,S,T,H,KV,D", [(1, 256, 256, 32, 32, 64),
                                          (2, 100, 130, 16, 4, 128),
                                          (1, 70, 70, 4, 1, 16)])
def test_flash_kernel_matches_plain(cuda, dtype, tol, B, S, T, H, KV, D):
    gen = torch.Generator(device=cuda).manual_seed(S + D)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(dtype)
               for shape in ((B, S, H, D), (B, T, KV, D), (B, T, KV, D)))
    before = kops.flash_attention.launches
    got = kops.flash_attention(q, k, v, scale=D ** -0.5)
    assert kops.flash_attention.launches == before + 1
    want = tref.flash_attention(q, k, v, D ** -0.5)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("B,S,T,H,KV,D", [
    (1, 100, 1000, 8, 2, 64),        # T > S, offset 900: no tile multiple
    (2, 77, 77, 4, 4, 16),           # S = T off the tile
    (1, 190, 250, 8, 2, 16), (1, 190, 250, 8, 2, 32),
    (1, 190, 250, 8, 2, 64), (1, 190, 250, 8, 2, 128),
    (1, 4096, 4096, 32, 32, 64),     # zamba2's heads at S = 4096
])
def test_flash_kernel_edges_bf16(cuda, B, S, T, H, KV, D):
    """The tensor-core route at its edges, bf16 within 2e-2."""
    gen = torch.Generator(device=cuda).manual_seed(S + T + D)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda)
               .to(torch.bfloat16)
               for shape in ((B, S, H, D), (B, T, KV, D), (B, T, KV, D)))
    got = kops.flash_attention(q, k, v, scale=D ** -0.5)
    want = tref.flash_attention(q, k, v, D ** -0.5)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_contiguous_decode_kernel_edges(cuda, dtype, tol):
    """Zamba2's cache (H = KV = 32, D = 64, T = 1024): lengths 0 and 1,
    on a split boundary and one past it, and past T; NaN past each."""
    B, T, H, KV, D = 6, 1024, 32, 32, 64
    _, splits = pa.split_plan(B, H, KV, T,
                              torch.cuda.get_device_properties(cuda)
                              .multi_processor_count)
    edge = pa.split_start(1, splits, T)
    lengths = [0, 1, edge, edge + 1, 700, T + 5]
    gen = torch.Generator(device=cuda).manual_seed(edge)
    q = torch.randn((B, 1, H, D), generator=gen, device=cuda).to(dtype)
    ck, cv = (torch.randn((B, T, KV, D), generator=gen, device=cuda)
              .to(dtype) for _ in range(2))
    for b, n in enumerate(lengths):
        ck[b, n:] = float("nan")
        cv[b, n:] = float("nan")
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    got = kops.decode_attention(q, ck, cv, lens, scale=D ** -0.5)
    want = tref.decode_attention(q, ck, cv, lens, D ** -0.5)
    assert torch.isfinite(got).all() and not got[0].any()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,T,H,KV,D", [(4, 1024, 32, 32, 64),
                                        (3, 77, 8, 2, 128), (2, 50, 8, 2, 8)])
def test_contiguous_decode_kernel_matches_plain(cuda, dtype, tol, B, T, H,
                                                KV, D):
    """Ragged lengths (one full, one past T: clamped) with NaN in the
    cache past every length."""
    gen = torch.Generator(device=cuda).manual_seed(T)
    q = torch.randn((B, 1, H, D), generator=gen, device=cuda).to(dtype)
    ck, cv = (torch.randn((B, T, KV, D), generator=gen, device=cuda)
              .to(dtype) for _ in range(2))
    lengths = torch.randint(1, T, (B,), generator=gen, device=cuda,
                            dtype=torch.int32)
    lengths[0] = T
    lengths[-1] = T + 5
    for b in range(B):
        n = min(int(lengths[b]), T)
        ck[b, n:] = float("nan")
        cv[b, n:] = float("nan")
    before = kops.decode_attention.launches
    got = kops.decode_attention(q, ck, cv, lengths, scale=D ** -0.5)
    assert kops.decode_attention.launches == before + 1
    want = tref.decode_attention(q, ck, cv, lengths, D ** -0.5)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,S,H,P,G,N,chunk", [
    (1, 1024, 64, 64, 1, 64, 256),      # zamba2
    (1, 512, 24, 64, 1, 128, 256),      # mamba2
    (2, 48, 4, 16, 2, 16, 16),          # ragged tiles, two groups
    (1, 4096, 4, 64, 1, 128, 64),       # 64 chunks
    (1, 40, 4, 64, 1, 64, 8),           # a chunk off the mma tile
    (2, 256, 8, 64, 2, 64, 64),         # G = 2, two batch rows
    (1, 48, 2, 8, 1, 4, 16),            # P and N below one mma tile
])
def test_ssd_kernel_matches_plain(cuda, dtype, tol, with_h0, B, S, H, P, G,
                                  N, chunk):
    gen = torch.Generator(device=cuda).manual_seed(S + N)
    x = torch.randn((B, S, H, P), generator=gen, device=cuda).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=gen, device=cuda) - 2.0)
    A = -torch.exp(torch.randn((H,), generator=gen, device=cuda))
    Bm, Cm = (torch.randn((B, S, G, N), generator=gen, device=cuda)
              .to(dtype) for _ in range(2))
    h0 = (torch.randn((B, H, P, N), generator=gen, device=cuda)
          if with_h0 else None)
    before = kops.ssd_scan.launches
    y, h = kops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)
    assert kops.ssd_scan.launches == before + 1
    wy, wh = ssd_scan_chunked(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)
    assert y.dtype == dtype and h.dtype == torch.float32
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    torch.testing.assert_close(y.float(), wy.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(h, wh, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fallback_engine_on_the_card_serves_and_returns_every_page(cuda,
                                                                   dtype):
    """Smoke zamba2 + mamba2 on the card, in float32 and in bf16: every
    request gets its tokens through the three kernels, every page comes
    back."""
    names = ("zamba2-1.2b", "mamba2-130m")
    models = {n: get_smoke_config(n).replace(dtype=dtype) for n in names}
    engine = CrossPoolEngine(models, page_budget=512, page_bytes=4096,
                             max_batch=2, max_ctx=64, device=cuda)
    counts = {f: getattr(kops, f).launches
              for f in ("flash_attention", "decode_attention", "ssd_scan")}
    reqs = [Request(i, names[i % 2], 5 + 7 * i, 6, 0.0) for i in range(5)]
    for r in reqs:
        engine.submit(r)
    engine.drain()
    assert [len(r.output_ids) for r in reqs] == [6] * 5
    assert engine.virt.mapped_pages == 0
    for f, n in counts.items():
        assert getattr(kops, f).launches > n, f
    assert all(int(r.nonfinite_logits) == 0
               for r in engine.runners.values())


# ---------------------------------------------------------------------------
# grouped expert GEMM, the guard on kernels without a backward, training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("N,K,M,sizes", [
    (300, 64, 96, [100, 0, 150, 0, 50]),      # empty experts
    (1000, 256, 200, [0, 0, 0, 333, 333, 334]),
    (77, 48, 130, [70, 0, 0]),                # rows past the groups
    (1000, 64, 136, [129, 127, 255, 1, 257, 231]),  # tile-straddling
    (300, 64, 96, [5, 3, 0, 270, 9, 13]),     # experts under 16 rows
    (64, 36, 130, [10, 54]),                  # 72- and 260-byte bf16 rows
    (4096, 64, 136, [3686, 7, 0, 403]),       # 90% on one expert, one of 7
])
def test_moe_gemm_kernels_match_plain(cuda, dtype, tol, N, K, M, sizes):
    """Forward, input gradient and weight gradient (through autograd)
    against the plain versions; rows no expert covers come out 0."""
    gen = torch.Generator(device=cuda).manual_seed(N + K)
    x, dy = (torch.randn(shape, generator=gen, device=cuda).to(dtype)
             for shape in ((N, K), (N, M)))
    w = torch.randn((len(sizes), K, M), generator=gen, device=cuda).to(dtype)
    gs = torch.tensor(sizes, dtype=torch.int32, device=cuda)
    xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    before = (kops.moe_gemm.launches, kops.moe_gemm_wgrad.launches)
    out = kops.moe_gemm(xg, wg, gs)
    out.backward(dy)
    assert (kops.moe_gemm.launches - before[0],
            kops.moe_gemm_wgrad.launches - before[1]) == (2, 1)
    covered = sum(sizes)
    for got, want in ((out, tref.moe_gemm(x, w, gs)),
                      (xg.grad, tref.moe_gemm(dy, w.transpose(1, 2), gs)),
                      (wg.grad, tref.moe_gemm_wgrad(x, dy, gs))):
        assert got.dtype == dtype and torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
    assert not out[covered:].any() and not xg.grad[covered:].any()


def test_moe_gemm_and_ssd_are_sync_free(cuda):
    """The grouped GEMM's three wrappers and the SSD scan read nothing back
    to the host (they run under ``set_sync_debug_mode("error")``): group
    sizes, offsets and lengths stay on the card."""
    gen = torch.Generator(device=cuda).manual_seed(0)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=cuda).to(dtype)

    x, dy, w = rand(300, 64), rand(300, 96), rand(5, 64, 96)
    gs = torch.tensor([100, 0, 150, 0, 50], dtype=torch.int32, device=cuda)
    xs, dt = rand(2, 128, 4, 64), rand(2, 128, 4, dtype=torch.float32)
    dt = torch.nn.functional.softplus(dt)
    A = -torch.exp(rand(4, dtype=torch.float32))
    Bm, Cm = rand(2, 128, 1, 64), rand(2, 128, 1, 64)
    h0 = rand(2, 4, 64, 64, dtype=torch.float32)

    def calls():
        return (kops.moe_gemm(x, w, gs), kops.moe_gemm_dgrad(dy, w, gs),
                kops.moe_gemm_wgrad(x, dy, gs),
                kops.ssd_scan(xs, dt, A, Bm, Cm, chunk=64, h0=h0))
    calls()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        calls()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_kernels_without_backward_refuse_grad(cuda):
    """Under grad mode with an input that requires grad, the attention and
    SSD kernels raise instead of returning a tensor with no grad_fn; under
    ``torch.no_grad()`` they run."""
    def rand(*shape):
        return torch.randn(shape, device=cuda)

    q = rand(1, 1, 4, 16).requires_grad_(True)
    lens = torch.tensor([5], dtype=torch.int32, device=cuda)
    table = torch.tensor([[0, 1]], dtype=torch.int32, device=cuda)
    x = rand(2, 48, 4, 16).requires_grad_(True)
    dt = torch.nn.functional.softplus(rand(2, 48, 4))
    calls = {
        "paged_decode_attention": lambda: kops.paged_decode_attention(
            q, rand(2, 4 * 2 * 2 * 16), table, lens, tokens_per_page=4,
            n_kv=2, scale=0.25),
        "paged_mla_decode_attention": lambda: (
            kops.paged_mla_decode_attention(
                rand(1, 1, 4, 24).requires_grad_(True), rand(2, 4 * 24),
                table, lens, tokens_per_page=4, latent_dim=16, scale=0.2)),
        "decode_attention": lambda: kops.decode_attention(
            q, rand(1, 8, 2, 16), rand(1, 8, 2, 16), lens, scale=0.25),
        "flash_attention": lambda: kops.flash_attention(
            rand(1, 8, 4, 16).requires_grad_(True), rand(1, 8, 2, 16),
            rand(1, 8, 2, 16), scale=0.25),
        "ssd_scan": lambda: kops.ssd_scan(
            x, dt, -torch.exp(rand(4)), rand(2, 48, 2, 16), rand(2, 48, 2, 16),
            chunk=16),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        with torch.no_grad():
            call()
    torch.cuda.synchronize()


def test_train_step_on_the_card_matches_the_cpu(cuda):
    """One float32 smoke step of qwen3-moe on the grouped path (the three
    grouped-GEMM kernels): loss, grad norm and updated params as on the
    CPU, within 1e-4 of each leaf's scale (max(1, max|leaf|))."""
    cfg = get_smoke_config("qwen3-moe-235b-a22b").replace(dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (4, 16),
                           generator=torch.Generator().manual_seed(1))
    out = {}
    for device in ("cpu", cuda):
        p = map_tree(lambda t: t.detach().clone().to(device), params)
        opt = AdamW(lr=3e-3, warmup_steps=10)
        step = make_train_step(model, opt, remat=False,
                               extra_inputs=lambda b: {"moe_path": "grouped"})
        wgrad = kops.moe_gemm_wgrad.launches
        state, metrics = step(TrainState(p, opt.init(p)),
                              {"tokens": tokens.to(device)})
        if device is cuda:
            assert kops.moe_gemm_wgrad.launches == wgrad + 3 * cfg.n_layers
        out[str(device)] = (metrics, [t.detach().cpu()
                                      for t in leaves(state.params)])
    (m_card, p_card), (m_cpu, p_cpu) = out["cuda"], out["cpu"]
    for k in ("loss", "grad_norm"):
        assert abs(float(m_card[k]) - float(m_cpu[k])) <= \
            1e-4 * max(1.0, abs(float(m_cpu[k])))
    for a, b in zip(p_card, p_cpu):
        scale = max(1.0, float(b.abs().max()))
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * scale)


def test_train_step_refuses_ssm_on_the_card(cuda):
    cfg = get_smoke_config("mamba2-130m").replace(dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    opt = AdamW()
    step = make_train_step(model, opt, remat=False)
    tokens = torch.zeros((2, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        step(TrainState(params, opt.init(params)), {"tokens": tokens})


# ---------------------------------------------------------------------------
# the decode graphs and the pool write
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_replay_equals_eager(cuda, smoke, dtype, k):
    """The smoke coloc set: a decode block's graph replay gives the same
    tokens and pool bytes as the step body called eagerly from the same
    state."""
    engine, _ = smoke.smoke_engine(torch, PAPER_COLOC_SET, dtype, k)
    smoke.replay_matches_eager(torch, engine)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fallback_replay_equals_eager(cuda, smoke, dtype):
    """zamba2 + mamba2 smoke: a decode step's graph replay gives the same
    tokens and dense cache as the eager body from the same state."""
    engine, _ = smoke.smoke_engine(torch, smoke.FALLBACK_MODELS, dtype)
    smoke.replay_matches_eager(torch, engine)


@pytest.mark.parametrize("which", ["coloc", "fallback"])
def test_block_dispatch_is_sync_free(cuda, smoke, which):
    """From the copy-in to the replay, a decode block reads nothing back
    to the host (``set_sync_debug_mode("error")``)."""
    names = PAPER_COLOC_SET if which == "coloc" else smoke.FALLBACK_MODELS
    engine, _ = smoke.smoke_engine(torch, names, "bfloat16", 4)
    smoke.block_is_sync_free(torch, engine)


def test_paged_kv_write_matches_plain_and_is_sync_free(cuda, smoke):
    """Bit for bit the plain version (-1 pages, an id past the pool, rows
    cast to the pool's type, an odd width, 512 rows), no host read."""
    from repro_torch.kernels import ref
    rows = smoke.kv_write_phase(torch, kops, ref)
    assert {r["shape"] for r in rows} == {"qwen3-moe decode B=4",
                                          "prefill 512 rows"}


@pytest.mark.parametrize("pipeline", [True, False])
def test_host_mode_on_the_card_equals_lowering(cuda, smoke, pipeline):
    """float32 smoke coloc set: the host-driven step (FFN stages on the
    weights stream), with and without the layer pipeline, gives the same
    greedy streams as the fused lowering's graph replays."""
    streams = []
    for lowering in (True, False):
        engine, reqs = smoke.smoke_engine(torch, PAPER_COLOC_SET, "float32",
                                          1, lowering=lowering,
                                          pipeline=pipeline, steps=0)
        engine.drain()
        assert engine.virt.mapped_pages == 0
        streams.append([r.output_ids for r in reqs])
    assert streams[0] == streams[1]
    assert all(len(s) == 6 for s in streams[0])


def test_graph_survives_evict_and_reactivate(cuda, smoke):
    """The model's graph, after its slabs were returned and mapped again
    elsewhere, serves the same tokens and still equals the eager body."""
    first = smoke.evict_check(torch)
    assert len(first[0]) == 6
