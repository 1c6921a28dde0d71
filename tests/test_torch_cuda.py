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
from repro_torch.kernels.ssd_chunked import (ssd_scan_chunked,
                                             ssd_scan_chunked_bwd)
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
    """``chip_smoke.py``'s phase modules at the repo's root
    (``chip_smoke_phases``): its graph checks."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke_phases
    from chip_smoke_phases import (common, p03_kernels,  # noqa: F401
                                   p04_small, p13_examples)
    return chip_smoke_phases


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
                              .multi_processor_count, dtype)
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
    sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    _, splits = (pa.mla_split_plan(6, H, npages * ps, sm)
                 if dtype == torch.bfloat16
                 else pa.split_plan(6, H, 1, npages * ps, sm, dtype))
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

def _assert_rows_close(got, want, dtype, limit=1e-2):
    """In bf16, each output row (the last axis) within a relative RMS
    error of ``limit``: the bf16 rounding of a correct kernel's
    probabilities and output, where an elementwise 2e-2 is about as large
    as an attention row over thousands of keys."""
    if dtype != torch.bfloat16:
        return
    got, want = got.float(), want.float()
    rel = (got - want).norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)
    assert rel.max().item() <= limit, rel.max().item()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,S,T,H,KV,D", [(1, 256, 256, 32, 32, 64),
                                          (2, 100, 130, 16, 4, 128),
                                          (1, 70, 70, 4, 1, 16),
                                          (2, 100, 130, 16, 8, 256)])
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
    _assert_rows_close(got, want, dtype)


@pytest.mark.parametrize("B,S,T,H,KV", [(1, 32, 32, 8, 2), (2, 70, 130, 8, 8)])
def test_flash_kernel_head_dim_8_f32(cuda, B, S, T, H, KV):
    """The smoke configs' head dim 8: the float32 route launches within
    2e-5 of the plain version; the bf16 route has no instance and
    raises."""
    gen = torch.Generator(device=cuda).manual_seed(S + 8)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda)
               for shape in ((B, S, H, 8), (B, T, KV, 8), (B, T, KV, 8)))
    before = kops.flash_attention.launches
    got = kops.flash_attention(q, k, v, scale=8 ** -0.5)
    assert kops.flash_attention.launches == before + 1
    torch.testing.assert_close(got, tref.flash_attention(q, k, v, 8 ** -0.5),
                               rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError, match="head dim 8"):
        kops.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                             scale=8 ** -0.5)


@pytest.mark.parametrize("B,S,T,H,KV,D", [
    (1, 100, 1000, 8, 2, 64),        # T > S, offset 900: no tile multiple
    (2, 77, 77, 4, 4, 16),           # S = T off the tile
    (1, 190, 250, 8, 2, 16), (1, 190, 250, 8, 2, 32),
    (1, 190, 250, 8, 2, 64), (1, 190, 250, 8, 2, 128),
    (1, 4096, 4096, 32, 32, 64),     # zamba2's heads at S = 4096
    (1, 190, 250, 16, 8, 256),       # gemma3's global layers
    (2, 2048, 2048, 16, 8, 256),
])
def test_flash_kernel_edges_bf16(cuda, B, S, T, H, KV, D):
    """The tensor-core route at its edges, bf16 within 2e-2 and each row
    within a relative RMS error of 1e-2."""
    gen = torch.Generator(device=cuda).manual_seed(S + T + D)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda)
               .to(torch.bfloat16)
               for shape in ((B, S, H, D), (B, T, KV, D), (B, T, KV, D)))
    got = kops.flash_attention(q, k, v, scale=D ** -0.5)
    want = tref.flash_attention(q, k, v, D ** -0.5)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    _assert_rows_close(got, want, torch.bfloat16)


#: the sharded steps' prefills at a rank's heads (B, S = T, H, KV, D):
#: moonshot of (2,2), qwen3-14b, zamba2 and whisper of (1,4)
RANK_FLASH = [(2, 512, 8, 8, 128), (4, 512, 10, 2, 128), (4, 512, 8, 8, 64),
              (4, 512, 3, 3, 64)]
#: the T > S and ragged edges of ``test_flash_kernel_edges_bf16``
FLASH_EDGES = [(1, 100, 1000, 8, 2, 64), (2, 77, 77, 4, 4, 16),
               (1, 190, 250, 8, 2, 16), (1, 190, 250, 8, 2, 32),
               (1, 190, 250, 8, 2, 64), (1, 190, 250, 8, 2, 128),
               (1, 4096, 4096, 32, 32, 64), (1, 190, 250, 16, 8, 256),
               (2, 2048, 2048, 16, 8, 256)]


def _flash_f32_twice(cuda, B, S, T, H, KV, D):
    """The float32 body on seeded inputs: within 2e-5 of the plain
    version, one launch a call, and two calls equal bit for bit (the
    column warps' partials merge in a fixed order, no atomics)."""
    gen = torch.Generator(device=cuda).manual_seed(B * S + T + H + D)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda)
               for shape in ((B, S, H, D), (B, T, KV, D), (B, T, KV, D)))
    before = kops.flash_attention.launches
    got = kops.flash_attention(q, k, v, scale=D ** -0.5)
    again = kops.flash_attention(q, k, v, scale=D ** -0.5)
    assert kops.flash_attention.launches == before + 2
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, tref.flash_attention(q, k, v, D ** -0.5),
                               rtol=2e-5, atol=2e-5)
    assert torch.equal(got, again)


@pytest.mark.parametrize("B,S,H,KV,D", RANK_FLASH)
def test_flash_f32_rank_geometries(cuda, B, S, H, KV, D):
    _flash_f32_twice(cuda, B, S, S, H, KV, D)


@pytest.mark.parametrize("B,S,T,H,KV,D", FLASH_EDGES)
def test_flash_f32_edges(cuda, B, S, T, H, KV, D):
    _flash_f32_twice(cuda, B, S, T, H, KV, D)


@pytest.mark.parametrize("D", (16, 32, 64, 128, 256))
@pytest.mark.parametrize("B,S,T,H,KV", [(1, 1, 1, 1, 1), (1, 5, 9, 2, 1),
                                        (2, 129, 300, 4, 2),
                                        (3, 255, 255, 2, 2)])
def test_flash_bf16_head_dims_edges(cuda, B, S, T, H, KV, D):
    """The wgmma body at every head dim: one row, a prefix offset, a q
    tile one row past 128 (its second warpgroup reads only TMA fill), S
    one short of two tiles; 2e-2 and each row within the row limit."""
    gen = torch.Generator(device=cuda).manual_seed(S + T + D)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda)
               .to(torch.bfloat16)
               for shape in ((B, S, H, D), (B, T, KV, D), (B, T, KV, D)))
    before = kops.flash_attention.launches
    got = kops.flash_attention(q, k, v, scale=D ** -0.5)
    assert kops.flash_attention.launches == before + 1
    want = tref.flash_attention(q, k, v, D ** -0.5)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    _assert_rows_close(got, want, torch.bfloat16)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_flash_plan_matches_library(cuda, dtype):
    """``flash_plan`` (the host mirror) against the plan the built library
    reports for every head dim of the body."""
    from repro_torch.kernels import flash_attention as fa
    for D in fa.HEAD_DIMS[dtype]:
        plan = fa.flash_plan(D, dtype)
        assert fa.kernel_plan(D, dtype) == {
            key: plan[key] for key in ("rows", "key_tile", "stages",
                                       "warps", "smem_bytes")}, D


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_contiguous_decode_kernel_edges(cuda, dtype, tol):
    """Zamba2's cache (H = KV = 32, D = 64, T = 1024): lengths 0 and 1,
    on a split boundary and one past it, and past T; NaN past each."""
    B, T, H, KV, D = 6, 1024, 32, 32, 64
    _, splits = pa.split_plan(B, H, KV, T,
                              torch.cuda.get_device_properties(cuda)
                              .multi_processor_count, dtype)
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
    _assert_rows_close(got, want, dtype)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,T,H,KV,D", [(4, 1024, 32, 32, 64),
                                        (3, 77, 8, 2, 128), (2, 50, 8, 2, 8),
                                        (4, 4096, 16, 8, 256),
                                        (3, 1024, 8, 8, 256)])
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
    _assert_rows_close(got, want, dtype)


def _nan_past(ck, cv, lengths):
    """NaN in the cache rows past each length."""
    for b, n in enumerate(lengths):
        ck[b, n:] = float("nan")
        cv[b, n:] = float("nan")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,T,H,KV,D", [(6, 1024, 32, 32, 64),
                                        (6, 4096, 16, 8, 256),
                                        (6, 1024, 32, 2, 128),
                                        (6, 64, 16, 16, 128)])
def test_contiguous_decode_lse_matches_plain(cuda, dtype, tol, B, T, H, KV,
                                             D):
    """The log-sum-exp output: lengths 0, 1, one before a split boundary,
    on it, one past it, and T, with NaN past each; several splits (the
    merge writes it) and one (T = 64: the split kernel writes it), head
    dims 64-256.  The output is the call's without lse, bit for bit."""
    sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    _, splits = pa.split_plan(B, H, KV, T, sm, dtype)
    assert (splits == 1) == (T == 64)
    edge = pa.split_start(1, splits, T) if splits > 1 else T // 2
    lengths = [0, 1, edge - 1, edge, edge + 1, T]
    gen = torch.Generator(device=cuda).manual_seed(T + D)
    q = torch.randn((B, 1, H, D), generator=gen, device=cuda).to(dtype)
    ck, cv = (torch.randn((B, T, KV, D), generator=gen, device=cuda)
              .to(dtype) for _ in range(2))
    _nan_past(ck, cv, lengths)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    before = (kops.decode_attention.launches,
              kops.decode_attention.lse_launches)
    got, lse = kops.decode_attention(q, ck, cv, lens, scale=D ** -0.5,
                                     return_lse=True)
    assert (kops.decode_attention.launches,
            kops.decode_attention.lse_launches) == (before[0] + 1,
                                                    before[1] + 1)
    want, want_lse = tref.decode_attention(q, ck, cv, lens, D ** -0.5,
                                           return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (B, H)
    assert torch.isneginf(lse[0]).all() and not got[0].any()
    assert torch.isfinite(lse[1:]).all()
    torch.testing.assert_close(lse[1:], want_lse[1:], rtol=tol, atol=tol)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(got, kops.decode_attention(q, ck, cv, lens,
                                                  scale=D ** -0.5))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_contiguous_decode_replay_equals_eager(cuda, dtype):
    """A contiguous call without lse captured in a CUDA graph, replayed
    after new lengths are written in place, equals the eager call on
    those lengths bit for bit (so does one with lse)."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    B, T, H, KV, D = 4, 1024, 16, 16, 128
    q = torch.randn((B, 1, H, D), generator=gen, device=cuda).to(dtype)
    ck, cv = (torch.randn((B, T, KV, D), generator=gen, device=cuda)
              .to(dtype) for _ in range(2))
    lens = torch.tensor([1024, 17, 0, 512], dtype=torch.int32, device=cuda)
    kw = dict(scale=D ** -0.5)

    def calls():
        return (kops.decode_attention(q, ck, cv, lens, **kw),
                kops.decode_attention(q, ck, cv, lens, return_lse=True,
                                      **kw))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, (out_l, lse) = calls()
    lens.copy_(torch.tensor([300, 0, 77, 1], dtype=torch.int32))
    graph.replay()
    want, (want_l, want_lse) = calls()
    torch.cuda.synchronize()
    assert torch.equal(out, want) and not out[1].any()
    assert torch.equal(out_l, want_l) and torch.equal(lse, want_lse)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_seq_split_local_body_on_the_kernel(cuda, dtype, tol):
    """The sequence-sharded GQA decode's local body on CUDA tensors (the
    contiguous kernel with lse) against the same body on the CPU (the
    kernel's plain version), for each slice of a cache split four ways (a mesh of
    (1, 4) at each coordinate; the combine's collectives of one slice);
    and the slices' (o, lse) combined by hand against the plain decode
    of the whole cache, rows whose last slices hold no token included."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.sharding import seq_attention as sa
    B, T, H, KV, D, n = 4, 1024, 16, 16, 128, 4
    gen = torch.Generator(device=cuda).manual_seed(4)
    q = torch.randn((B, 1, H, D), generator=gen, device=cuda).to(dtype)
    ck, cv = (torch.randn((B, T, KV, D), generator=gen, device=cuda)
              .to(dtype) for _ in range(2))
    lengths = [1024, 300, 256, 1]
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    mesh = Mesh((1, n), ("data", "model"))
    mesh.all_gather = lambda x, axis, dim: x
    local = sa.make_seq_decode_attn(mesh, ("model",), None, D ** -0.5)
    t = T // n
    num = torch.zeros((B, H, D), device=cuda)
    den = torch.zeros((B, H), device=cuda)
    m = torch.full((B, H), float("-inf"), device=cuda)
    parts = []
    for i in range(n):
        mesh.coord = (0, i)
        k, v = ck[:, i * t:(i + 1) * t].contiguous(), \
            cv[:, i * t:(i + 1) * t].contiguous()
        got = local(q, k, v, lens)
        want = local(q.cpu(), k.cpu(), v.cpu(), lens.cpu())
        torch.testing.assert_close(got.cpu().float(), want.float(),
                                   rtol=tol, atol=tol)
        held = (lens - i * t).clamp(0, t)
        o, lse = kops.decode_attention(q, k, v, held, scale=D ** -0.5,
                                       return_lse=True)
        po, plse = tref.decode_attention(q, k, v, held, D ** -0.5,
                                         return_lse=True)
        torch.testing.assert_close(o.float(), po.float(), rtol=tol,
                                   atol=tol)
        torch.testing.assert_close(lse, plse, rtol=tol, atol=tol)
        parts.append((o.reshape(B, H, D).float(), lse))
        m = torch.maximum(m, lse)
    assert torch.isneginf(parts[-1][1][1:]).all()     # rows 1-3: empty
    for o, lse in parts:
        w = torch.exp(lse - m)
        num += w[..., None] * o
        den += w
    whole = tref.decode_attention(q, ck, cv, lens, D ** -0.5)
    torch.testing.assert_close((num / den[..., None]).reshape(B, 1, H, D),
                               whole.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_gemma3_ring_decode_on_the_card(cuda, dtype, tol):
    """gemma3's local layers read their ring (W = 1024) through the
    contiguous kernel over ``ring_count`` slots: rows below, at and
    across the window, against the reference's masked softmax on the
    same ring (the plain ``swa_decode`` route)."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention as attn
    from repro_torch.models import decode as dec
    cfg = get_config("gemma3-12b").replace(d_model=256)
    p = attn.init_gqa(torch.Generator(device=cuda).manual_seed(0), cfg,
                      dtype)
    B, W, KV, D = 4, 1024, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device=cuda).manual_seed(1)
    lk, lv = (torch.randn((B, W, KV, D), generator=gen, device=cuda)
              .to(dtype) for _ in range(2))
    prompts = (200, 1023, 1024, 3000)
    lpos = torch.stack([torch.as_tensor(dec.ring_layout(S, W))
                        for S in prompts]).to(cuda, torch.int32)
    cur = torch.tensor(prompts, dtype=torch.int32, device=cuda)
    x = torch.randn((B, 1, cfg.d_model), generator=gen,
                    device=cuda).to(dtype)
    outs = {}
    for impl in ("paged", "xla"):
        ring = [t.clone() for t in (lk, lv, lpos)]
        attn.ring_write_positions(ring[2], cur)
        before = kops.decode_attention.launches
        outs[impl] = attn.swa_decode(p, cfg, x, *ring, cur,
                                     attn.ring_count(ring[2]), impl=impl)
        assert kops.decode_attention.launches == before + (impl == "paged")
    assert torch.isfinite(outs["paged"]).all()
    torch.testing.assert_close(outs["paged"].float(), outs["xla"].float(),
                               rtol=tol, atol=tol)


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


def _ssd_bwd_inputs(cuda, dtype, B, S, H, P, G, N, with_h0, with_dh, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=cuda).to(dtype)
    x = randn(B, S, H, P, dtype=dtype)
    dt = torch.nn.functional.softplus(randn(B, S, H) - 2.0)
    A = -torch.exp(randn(H))
    Bm, Cm = randn(B, S, G, N, dtype=dtype), randn(B, S, G, N, dtype=dtype)
    h0 = randn(B, H, P, N) if with_h0 else None
    dy = randn(B, S, H, P, dtype=dtype)
    dh = randn(B, H, P, N) if with_dh else None
    return x, dt, A, Bm, Cm, h0, dy, dh


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,S,H,P,G,N,chunk,with_h0,with_dh", [
    (2, 128, 4, 16, 2, 16, 32, True, True),     # G = 2, h0, dh
    (1, 96, 2, 64, 1, 64, 32, False, False),    # no h0, no dh
    (2, 48, 4, 16, 2, 16, 16, True, True),      # ragged against the tile
    (1, 40, 4, 64, 1, 64, 8, True, True),       # chunk 8
    (1, 160, 2, 64, 1, 128, 80, True, False),   # a chunk off 64 rows
    (1, 48, 2, 8, 1, 4, 16, False, True),       # P and N below 16
    (1, 256, 4, 128, 1, 64, 64, True, True),    # P = 128
    (1, 128, 2, 32, 1, 256, 64, True, True),    # N = 256
])
def test_ssd_backward_kernel_matches_plain(cuda, dtype, tol, B, S, H, P, G,
                                           N, chunk, with_h0, with_dh):
    """The backward kernels against autograd of the chunked form on the
    same inputs: each of dx, ddt, dA, dB, dC, dh0 within ``tol`` of its
    scale (max(1, max|plain|)); a second call equal bit for bit."""
    ins = _ssd_bwd_inputs(cuda, dtype, B, S, H, P, G, N, with_h0, with_dh,
                          S + N)
    before = kops.ssd_scan_bwd.launches
    got = kops.ssd_scan_bwd(*ins, chunk=chunk)
    assert kops.ssd_scan_bwd.launches == before + 1
    again = kops.ssd_scan_bwd(*ins, chunk=chunk)
    want = ssd_scan_chunked_bwd(*ins, chunk=chunk)
    x, dt, A, Bm = ins[:4]
    for name, g, a, w, like in zip(("dx", "ddt", "dA", "dB", "dC", "dh0"),
                                   got, again, want,
                                   (x, dt, A, Bm, Bm, dt)):
        assert g.dtype == like.dtype, name
        assert torch.isfinite(g).all(), name
        assert torch.equal(g, a), f"{name} differs between two calls"
        scale = max(1.0, float(w.float().abs().max()))
        err = float((g.float() - w.float()).abs().max())
        assert err <= tol * scale, f"{name}: {err:.3g} > {tol} x {scale:.3g}"


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("B,S,H,P,G,N,chunk", [
    (8, 512, 64, 64, 1, 64, 256),       # zamba2's train shape
    (8, 512, 24, 64, 1, 128, 256),      # mamba2's
    (1, 1024, 64, 64, 1, 64, 256),
    (1, 160, 2, 64, 1, 128, 80),
    (1, 48, 2, 8, 1, 4, 16),
    (1, 128, 2, 32, 1, 256, 64),
    (1, 256, 4, 128, 1, 64, 64),
])
def test_ssd_bwd_plan_matches_library(cuda, dtype, B, S, H, P, G, N, chunk):
    """``bwd_plan`` (the host mirror) against the plan the built library
    reports, and ``bwd_workspace`` against ``ssd_scan_bwd_workspace``."""
    from repro_torch.kernels import ssd_scan as tssd
    got = tssd.kernel_bwd_plan(B, S, H, P, G, N, chunk, dtype)
    want = tssd.bwd_plan(B, S, H, P, G, N, chunk, dtype)
    assert got == {key: want[key] for key in got}
    assert tssd.load_library().ssd_scan_bwd_workspace(
        B, S, H, P, N, chunk) == tssd.bwd_workspace(B, S, H, P, N, chunk)


def test_ssd_scan_under_grad_runs_its_backward_kernel(cuda):
    """Under grad mode ``ssd_scan`` returns tensors with a grad_fn; their
    backward (a strided dy, as a reshape gives it) launches the backward
    kernels once, and its gradients equal autograd of the chunked form
    within 1e-3 of their scale.  Without an input that requires grad it
    runs the forward alone."""
    x, dt, A, Bm, Cm, h0, _, dh = _ssd_bwd_inputs(
        cuda, torch.float32, 2, 64, 4, 16, 2, 16, True, True, 3)
    leaves_in = [t.clone().requires_grad_(True) for t in (x, dt, A, Bm, Cm,
                                                          h0)]
    y, h = kops.ssd_scan(*leaves_in[:5], chunk=16, h0=leaves_in[5])
    assert y.grad_fn is not None and h.grad_fn is not None
    w = torch.randn((64, 2, 4, 16), device=cuda).permute(1, 0, 2, 3)
    before = kops.ssd_scan_bwd.launches
    got = torch.autograd.grad((y * w).sum() + (h * dh).sum(), leaves_in)
    assert kops.ssd_scan_bwd.launches == before + 1
    plain = [t.clone().requires_grad_(True) for t in (x, dt, A, Bm, Cm, h0)]
    wy, wh = ssd_scan_chunked(*plain[:5], chunk=16, h0=plain[5])
    want = torch.autograd.grad((wy * w).sum() + (wh * dh).sum(), plain)
    for g, wg in zip(got, want):
        scale = max(1.0, float(wg.abs().max()))
        assert float((g - wg).abs().max()) <= 1e-3 * scale
    with torch.no_grad():
        y, _ = kops.ssd_scan(*leaves_in[:5], chunk=16, h0=leaves_in[5])
    assert y.grad_fn is None
    assert kops.ssd_scan_bwd.launches == before + 1


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
    """Under grad mode with an input that requires grad, the attention
    kernels raise instead of returning a tensor with no grad_fn; under
    ``torch.no_grad()`` they run.  (The SSD scan has its backward:
    ``test_ssd_scan_under_grad_runs_its_backward_kernel``.)"""
    def rand(*shape):
        return torch.randn(shape, device=cuda)

    q = rand(1, 1, 4, 16).requires_grad_(True)
    lens = torch.tensor([5], dtype=torch.int32, device=cuda)
    table = torch.tensor([[0, 1]], dtype=torch.int32, device=cuda)
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


def _ssm_train_step(device, name, remat, params, tokens):
    """One float32 smoke AdamW step of ``name`` on ``device`` from a copy
    of ``params``: (metrics, updated leaves on the CPU, ssd_scan and
    ssd_scan_bwd launches)."""
    model = build_model(get_smoke_config(name).replace(dtype="float32"))
    p = map_tree(lambda t: t.detach().clone().to(device), params)
    opt = AdamW(lr=3e-3, warmup_steps=10)
    step = make_train_step(model, opt, remat=remat)
    before = kops.ssd_scan.launches, kops.ssd_scan_bwd.launches
    state, metrics = step(TrainState(p, opt.init(p)),
                          {"tokens": tokens.to(device)})
    launches = (kops.ssd_scan.launches - before[0],
                kops.ssd_scan_bwd.launches - before[1])
    return metrics, [t.detach().cpu() for t in leaves(state.params)], launches


def _ssm_launches(cfg, remat):
    """(ssd_scan, ssd_scan_bwd) launches of one train step: a forward and
    a backward a SSD block, and under remat a second forward for every
    block the checkpoint recomputes (the hybrid's tail runs outside it)."""
    if not remat:
        return cfg.n_ssm_layers, cfg.n_ssm_layers
    recomputed = (cfg.n_layers if cfg.family == "ssm"
                  else cfg.hybrid_groups * cfg.ssm_per_group)
    return cfg.n_ssm_layers + recomputed, cfg.n_ssm_layers


@pytest.mark.parametrize("name,remat", [("mamba2-130m", False),
                                        ("zamba2-1.2b", False),
                                        ("zamba2-1.2b", True)])
def test_ssm_train_step_on_the_card_matches_the_cpu(cuda, name, remat):
    """One float32 smoke step of mamba2 / zamba2 on the card (the SSD scan
    kernel and its backward) against the CPU (autograd of the chunked
    form): loss, grad norm and updated params within 1e-4 of each leaf's
    scale (max(1, max|leaf|)).  The forward runs once a SSM layer, twice
    for a recomputed one under remat, the backward once."""
    cfg = get_smoke_config(name).replace(dtype="float32")
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (4, 32),
                           generator=torch.Generator().manual_seed(1))
    m_card, p_card, launches = _ssm_train_step(cuda, name, remat, params,
                                               tokens)
    m_cpu, p_cpu, _ = _ssm_train_step("cpu", name, remat, params, tokens)
    assert launches == _ssm_launches(cfg, remat)
    for k in ("loss", "grad_norm"):
        assert abs(float(m_card[k]) - float(m_cpu[k])) <= \
            1e-4 * max(1.0, abs(float(m_cpu[k])))
    for a, b in zip(p_card, p_cpu):
        scale = max(1.0, float(b.abs().max()))
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * scale)


# ---------------------------------------------------------------------------
# the decode graphs and the pool write
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_replay_equals_eager(cuda, smoke, dtype, k):
    """The smoke coloc set: a decode block's graph replay gives the same
    tokens and pool bytes as the step body called eagerly from the same
    state."""
    engine, _ = smoke.p04_small.smoke_engine(torch, PAPER_COLOC_SET, dtype,
                                             k)
    smoke.p04_small.replay_matches_eager(torch, engine)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fallback_replay_equals_eager(cuda, smoke, dtype):
    """zamba2 + mamba2 smoke: a decode step's graph replay gives the same
    tokens and dense cache as the eager body from the same state."""
    engine, _ = smoke.p04_small.smoke_engine(
        torch, smoke.common.FALLBACK_MODELS, dtype)
    smoke.p04_small.replay_matches_eager(torch, engine)


@pytest.mark.parametrize("which", ["coloc", "fallback"])
def test_block_dispatch_is_sync_free(cuda, smoke, which):
    """From the copy-in to the replay, a decode block reads nothing back
    to the host (``set_sync_debug_mode("error")``)."""
    names = (PAPER_COLOC_SET if which == "coloc"
             else smoke.common.FALLBACK_MODELS)
    engine, _ = smoke.p04_small.smoke_engine(torch, names, "bfloat16", 4)
    smoke.p04_small.block_is_sync_free(torch, engine)


def test_paged_kv_write_matches_plain_and_is_sync_free(cuda, smoke):
    """Bit for bit the plain version (-1 pages, an id past the pool, rows
    cast to the pool's type, an odd width, 512 rows), no host read."""
    from repro_torch.kernels import ref
    rows = smoke.p03_kernels.kv_write_phase(torch, kops, ref)
    assert {r["shape"] for r in rows} == {"qwen3-moe decode B=4",
                                          "prefill 512 rows"}


@pytest.mark.parametrize("pipeline", [True, False])
def test_host_mode_on_the_card_equals_lowering(cuda, smoke, pipeline):
    """float32 smoke coloc set: the host-driven step (FFN stages on the
    weights stream), with and without the layer pipeline, gives the same
    greedy streams as the fused lowering's graph replays."""
    streams = []
    for lowering in (True, False):
        engine, reqs = smoke.p04_small.smoke_engine(
            torch, PAPER_COLOC_SET, "float32", 1, lowering=lowering,
            pipeline=pipeline, steps=0)
        engine.drain()
        assert engine.virt.mapped_pages == 0
        streams.append([r.output_ids for r in reqs])
    assert streams[0] == streams[1]
    assert all(len(s) == 6 for s in streams[0])


def test_graph_survives_evict_and_reactivate(cuda, smoke):
    """The model's graph, after its slabs were returned and mapped again
    elsewhere, serves the same tokens and still equals the eager body."""
    first = smoke.p04_small.evict_check(torch)
    assert len(first[0]) == 6


def test_replay_over_a_moved_buffer_raises_until_recaptured(cuda, smoke):
    """After a resize moved the pool, then the arena, a decode block's
    replay raises; ``recapture`` captures it over the new tensors, and
    then a replay equals the eager body."""
    smoke.p04_small.moved_graph_check(torch)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pool_writes_on_the_card_equal_the_cpu(cuda, dtype):
    """``write_tokens`` (start offsets mid-page) and
    ``write_prompt_from_cache`` (GQA and MLA caches) through the pool
    write kernel give the CPU pool bit for bit; ``page_table_array`` and
    ``typed_pages`` (a view of the pool) agree."""
    from repro_torch.core.virtualizer import KVVirtualizer
    rng = np.random.default_rng(5)
    models = {n: get_smoke_config(n) for n in PAPER_COLOC_SET}
    virts = [KVVirtualizer(models, page_budget=96, page_bytes=2048,
                           dtype=dtype, device=d) for d in ("cuda", "cpu")]
    for rid, name in enumerate(PAPER_COLOC_SET):
        cfg, view = models[name], virts[0].views[name]
        if cfg.attention == "mla":
            m = cfg.mla
            cache = {"latent": rng.standard_normal(
                         (cfg.n_layers, 2, 50, m.kv_lora_rank)),
                     "rope": rng.standard_normal(
                         (cfg.n_layers, 2, 50, m.qk_rope_head_dim))}
        else:
            shape = (cfg.n_layers, 2, 50, cfg.n_kv_heads, cfg.head_dim)
            cache = {"k": rng.standard_normal(shape),
                     "v": rng.standard_normal(shape)}
        kv = rng.standard_normal((37, *view.kv_shape))
        for v, dev in zip(virts, ("cuda", "cpu")):
            v.register_request(rid, name, 90)
            v.write_prompt_from_cache(
                name, rid, {k: torch.from_numpy(x).float().to(dev)
                            for k, x in cache.items()}, 45, batch_index=1)
            v.write_tokens(name, view.n_kv_layers - 1, rid, 45,
                           torch.from_numpy(kv).float().to(dev))
    card, cpu = virts
    assert torch.equal(card.pool.cpu(), cpu.pool)
    for name in PAPER_COLOC_SET:
        typed = card.typed_pages(name)
        assert typed.data_ptr() == card.pool.data_ptr()
        assert torch.equal(typed.cpu(), cpu.typed_pages(name))
    table = card.page_table_array([0, 1, 2], 1, 6)
    assert table.is_cuda and torch.equal(table.cpu(),
                                         cpu.page_table_array([0, 1, 2], 1, 6))


def test_long_context_calls_hold_at_a_smaller_context(cuda, smoke,
                                                      monkeypatch):
    """``chip_smoke.py`` phase 13a at 4096 tokens: minicpm3's published
    geometry through the pool, the f32 packed-latent paged GQA call
    (D = 256, G = 40) within 2e-5 and the bf16 paged MLA call within the
    bf16 gate, each launched once, the all-layer prompt write equal to a
    plain scatter, and the burst at published widths."""
    from repro_torch.kernels import ref
    monkeypatch.setattr(smoke.p13_examples, "LONG_CTX", 4096)
    monkeypatch.setattr(smoke.p13_examples, "LONG_PAGES", 62 * 147 + 64)
    out = smoke.p13_examples.long_context_phase(torch, kops, ref)
    assert np.isfinite(out["row1_max_abs_err"])
    assert out["row2_row_rms"] <= smoke.common.BF16_ROW_RMS
    assert out["launches_row1"] == out["launches_row2"] == 1
    assert out["launches_write"] == 2
    assert out["burst"]["admitted_shared"] > out["burst"]["admitted_static"]


# ---------------------------------------------------------------------------
# the float32 split-KV decode body and the chunked float32 weight gradient
# ---------------------------------------------------------------------------

def _f32_decode_call(cuda, kind, lengths, T, seed):
    """(call, plain, lengths tensor) of one float32 decode wrapper over ``lengths`` (NaN
    past each): "paged" the long_context_pooling example's packed latent
    (H 40 over one kv head of 256, 28-token pages), "contiguous" the same
    heads over a dense cache, "mla" minicpm3's rows (r 256, rp 32)."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    B, H, ps = len(lengths), 40, 28
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=cuda)
    if kind == "contiguous":
        D = 256
        q, ck, cv = randn(B, 1, H, D), randn(B, T, 1, D), randn(B, T, 1, D)
        for b, n in enumerate(lengths):
            ck[b, n:] = float("nan")
            cv[b, n:] = float("nan")
        return (lambda: kops.decode_attention(q, ck, cv, lens,
                                              scale=D ** -0.5),
                lambda: tref.decode_attention(q, ck, cv, lens, D ** -0.5),
                lens)
    per_tok = 2 * 256 if kind == "paged" else 288
    npages = -(-T // ps)
    pool = torch.full((B * npages + 2, ps * per_tok), float("nan"),
                      device=cuda)
    table = torch.randperm(B * npages + 2, generator=gen, device=cuda)[
        :B * npages].reshape(B, npages).to(torch.int32)
    for b, n in enumerate(lengths):
        rows = pool[table[b].long()].reshape(-1, per_tok)
        rows[:n] = randn(n, per_tok)
        pool[table[b].long()] = rows.reshape(npages, -1)
    if kind == "paged":
        q = randn(B, 1, H, 256)
        typed = pool.reshape(-1, ps, 2, 1, 256)
        return (lambda: kops.paged_decode_attention(
                    q, pool, table, lens, tokens_per_page=ps, n_kv=1,
                    scale=256 ** -0.5),
                lambda: tref.paged_decode_attention(q, typed, table, lens,
                                                    256 ** -0.5), lens)
    q = randn(B, 1, H, 288)
    typed = pool.reshape(-1, ps, 288)
    return (lambda: kops.paged_mla_decode_attention(
                q, pool, table, lens, tokens_per_page=ps, latent_dim=256,
                scale=288 ** -0.5),
            lambda: tref.paged_mla_decode_attention(q, typed, table, lens,
                                                    256, 288 ** -0.5), lens)


@pytest.mark.parametrize("kind", ["paged", "contiguous", "mla"])
@pytest.mark.parametrize("lengths,T", [([32768 - 3], 32768),
                                       ([4096, 1001, 1, 0], 4096)])
def test_f32_decode_matches_plain_at_the_packed_latent_geometry(
        cuda, kind, lengths, T):
    """The float32 split-KV body within 2e-5 of the plain version at the
    long_context_pooling example's geometry (40 query heads on one kv head
    of 256: three blocks of 16 rows) and minicpm3's MLA rows: one row at
    context 32768, and ragged rows down to lengths 1 and 0 (which writes
    0), NaN past every length; one counted launch a call."""
    call, plain, _ = _f32_decode_call(cuda, kind, lengths, T, len(lengths))
    counter = {"paged": kops.paged_decode_attention,
               "contiguous": kops.decode_attention,
               "mla": kops.paged_mla_decode_attention}[kind]
    before = counter.launches
    got = call()
    assert counter.launches == before + 1
    want = plain()
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    if lengths[-1] == 0:
        assert not got[-1].any()
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("kind", ["paged", "contiguous", "mla"])
def test_f32_decode_is_sync_free_and_capturable(cuda, kind):
    """The float32 wrappers read nothing back to the host (they run under
    ``set_sync_debug_mode("error")``), and a call captured in a CUDA
    graph, replayed after new lengths are written in place, equals an
    eager call on those lengths."""
    lengths = [4000, 1001, 77, 1]
    call, _, lens = _f32_decode_call(cuda, kind, lengths, 4096, 7)
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
    lens.copy_(torch.tensor([300, 0, 77, 1], dtype=torch.int32))
    graph.replay()
    want = call()
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    assert not out[1].any()


@pytest.mark.parametrize("K,M", [(256, 384), (48, 130)])
def test_f32_wgrad_at_a_skewed_load_is_close_and_repeatable(cuda, K, M):
    """90% of 24576 rows on one expert (22 chunks of that expert added in
    order), an empty expert and rows past the groups: within 1e-4 of the
    plain version, the same bits from two calls, and no host read (under
    ``set_sync_debug_mode("error")``).  M = 130 takes the guarded element
    loader."""
    gen = torch.Generator(device=cuda).manual_seed(K)
    N, E = 24576, 64
    rest = int(N * 0.1) // (E - 1)
    sizes = [rest] * E
    sizes[E // 2] = N - rest * (E - 1) - 300       # 300 rows past the groups
    sizes[3] = 0
    gs = torch.tensor(sizes, dtype=torch.int32, device=cuda)
    x = torch.randn((N, K), generator=gen, device=cuda)
    dy = torch.randn((N, M), generator=gen, device=cuda) * (E / N) ** 0.5
    first = kops.moe_gemm_wgrad(x, dy, gs)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        second = kops.moe_gemm_wgrad(x, dy, gs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = tref.moe_gemm_wgrad(x, dy, gs)
    assert torch.equal(first, second)
    assert not first[3].any()
    torch.testing.assert_close(first, want, rtol=1e-4, atol=1e-4)



# ---------------------------------------------------------------------------
# the bf16 grouped GEMM body (wgmma fed by TMA, persistent)
# ---------------------------------------------------------------------------

MOE_PLAN_SHAPES = [(2048, 1408), (1408, 2048), (64, 96), (136, 200),
                   (48, 130), (256, 384)]


def test_moe_gemm_plan_matches_library(cuda):
    """``gemm_plan`` (the host mirror) against the plan the built library
    reports for every use, route and shape; ``gemm_route`` against the
    route the library takes for aligned and unaligned operands."""
    from repro_torch.kernels import moe_gemm as mg
    for op in mg.OPS:
        for route in mg.ROUTES:
            for k, m in MOE_PLAN_SHAPES:
                cols = k if op == "dgrad" else m
                for experts in (1, 64, 128):
                    plan = mg.gemm_plan(torch.bfloat16, route, op, cols,
                                        experts, kdim=k)
                    assert mg.kernel_plan(op, route, cols, experts,
                                          kdim=k) == {
                        key: plan[key] for key in (
                            "rows", "cols", "depth", "stages", "warps",
                            "smem_bytes")}
    for rows, k, m, offset in ((300, 64, 96, 0), (64, 36, 130, 0),
                               (300, 64, 96, 1), (1000, 136, 200, 0)):
        a = torch.zeros(rows * k + 8, dtype=torch.bfloat16,
                        device=cuda)[offset:offset + rows * k].view(rows, k)
        b = torch.zeros((3, k, m), dtype=torch.bfloat16, device=cuda)
        c = torch.zeros((rows, m), dtype=torch.bfloat16, device=cuda)
        assert mg.kernel_route(a, b, c) == mg.gemm_route(
            torch.bfloat16, rows, k, m, a.data_ptr(), b.data_ptr(),
            c.data_ptr())
    assert mg.kernel_route(a, b, c) == "tma"


def _bf16_moe_inputs(cuda, N, K, M, sizes, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x, dy = (torch.randn(shape, generator=gen, device=cuda)
             for shape in ((N, K), (N, M)))
    w = torch.randn((len(sizes), K, M), generator=gen, device=cuda) \
        * K ** -0.5
    gs = torch.tensor(sizes, dtype=torch.int32, device=cuda)
    return x, dy, w, gs


@pytest.mark.parametrize("N,K,M,sizes", [
    (600, 128, 256, [60, 200, 40, 300]),     # tiles whose second
                                             # warpgroup lies past the expert
    (1000, 136, 200, [129, 500, 0, 371]),    # K, M off the 64 / 128 edges,
                                             # 16-byte aligned (TMA)
    (4200, 128, 256, [10, 4000, 12, 178]),   # under 16 rows beside 4000
    (4200, 136, 200, [7, 4000, 15, 170]),
], ids=["wg-past-expert", "K136-M200", "small-beside-4000",
        "small-beside-4000-K136"])
def test_bf16_moe_gemm_edges(cuda, N, K, M, sizes):
    """The bf16 body's edges on the TMA route, through autograd: forward,
    input gradient and weight gradient within 2e-2 of the plain versions,
    rows past the groups 0, an empty expert's gradient 0."""
    from repro_torch.kernels import moe_gemm as mg
    x, dy, w = (t.to(torch.bfloat16) for t in
                _bf16_moe_inputs(cuda, N, K, M, sizes, N + K)[:3])
    gs = torch.tensor(sizes, dtype=torch.int32, device=cuda)
    xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    out = kops.moe_gemm(xg, wg, gs)
    assert mg.kernel_route(x, w, out) == "tma"
    out.backward(dy)
    covered = sum(sizes)
    for got, want in ((out, tref.moe_gemm(x, w, gs)),
                      (xg.grad, tref.moe_gemm(dy, w.transpose(1, 2), gs)),
                      (wg.grad, tref.moe_gemm_wgrad(x, dy, gs))):
        assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=2e-2)
    assert not out[covered:].any() and not xg.grad[covered:].any()
    for e, n in enumerate(sizes):
        if n == 0:
            assert not wg.grad[e].any()


@pytest.mark.parametrize("K,M", [(128, 256), (136, 200), (36, 130)],
                         ids=["tma", "tma-off-edges", "guarded"])
def test_bf16_moe_gemm_neighbours_of_1e4_do_not_leak(cuda, K, M):
    """Experts of 10, 12 and 178 rows whose neighbours (an expert of 300
    rows, one of 4000 and the rows past the groups) hold 1e4 in x and dy:
    a tile or slice that read a row across an expert's edge would move
    the watched experts' outputs and gradients by ~1e4.  The watched ones
    within 2e-2 of the plain versions, the 1e4 ones within 2e-2 of their
    own scale, the rows past the groups 0."""
    sizes = [300, 10, 4000, 12, 178]
    N = sum(sizes) + 20
    x, dy, w, gs = _bf16_moe_inputs(cuda, N, K, M, sizes, 29)
    off = np.concatenate([[0], np.cumsum(sizes), [N]])
    for e in (0, 2, 5):                       # 5: the rows past the groups
        x[off[e]:off[e + 1]] = 1e4
        dy[off[e]:off[e + 1]] = 1e4
    x, dy, w = (t.to(torch.bfloat16) for t in (x, dy, w))
    got = (kops.moe_gemm(x, w, gs), kops.moe_gemm_dgrad(dy, w, gs),
           kops.moe_gemm_wgrad(x, dy, gs))
    want = (tref.moe_gemm(x, w, gs), tref.moe_gemm(dy, w.transpose(1, 2), gs),
            tref.moe_gemm_wgrad(x, dy, gs))
    for g in got:
        assert torch.isfinite(g).all()
    for e in (1, 3, 4):                       # the watched experts
        rows = slice(off[e], off[e + 1])
        for g, wv in ((got[0][rows], want[0][rows]),
                      (got[1][rows], want[1][rows]), (got[2][e], want[2][e])):
            torch.testing.assert_close(g.float(), wv.float(), rtol=2e-2,
                                       atol=2e-2)
    for e in (0, 2):                          # the 1e4 experts
        rows = slice(off[e], off[e + 1])
        for g, wv in ((got[0][rows], want[0][rows]),
                      (got[1][rows], want[1][rows]), (got[2][e], want[2][e])):
            err = (g.float() - wv.float()).abs().max()
            assert err <= 2e-2 * wv.float().abs().max()
    assert not got[0][off[5]:].any() and not got[1][off[5]:].any()


@pytest.mark.parametrize("K,M", [(256, 384), (48, 130)])
def test_bf16_wgrad_at_a_skewed_load_is_close_and_repeatable(cuda, K, M):
    """90% of 24576 rows on one expert (heaviest first from the counter),
    an empty expert and rows past the groups: within 2e-2 of the plain
    version, the same bits from two calls (one f32 sum an output in one
    block), and no host read (under ``set_sync_debug_mode("error")``).
    M = 130 takes the guarded element loader."""
    gen = torch.Generator(device=cuda).manual_seed(K)
    N, E = 24576, 64
    rest = int(N * 0.1) // (E - 1)
    sizes = [rest] * E
    sizes[E // 2] = N - rest * (E - 1) - 300       # 300 rows past the groups
    sizes[3] = 0
    gs = torch.tensor(sizes, dtype=torch.int32, device=cuda)
    x = torch.randn((N, K), generator=gen, device=cuda).to(torch.bfloat16)
    dy = (torch.randn((N, M), generator=gen, device=cuda)
          * (E / N) ** 0.5).to(torch.bfloat16)
    first = kops.moe_gemm_wgrad(x, dy, gs)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        second = kops.moe_gemm_wgrad(x, dy, gs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = tref.moe_gemm_wgrad(x, dy, gs)
    assert torch.equal(first, second)
    assert not first[3].any()
    torch.testing.assert_close(first.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
