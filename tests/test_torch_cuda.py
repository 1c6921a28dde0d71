"""The port on a CUDA card: the hand-written kernels against their plain
PyTorch versions, and the engine on the card against the CPU.

Every test here needs a card and carries the ``cuda`` marker; without a
card each one skips (the CUDA kernels have no CPU mode).  The file
imports nothing of JAX, so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import PAPER_COLOC_SET, get_smoke_config
from repro_torch.configs.base import EngineConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as tref
from repro_torch.models.transformer import init_params
from repro_torch.runtime.engine import CrossPoolEngine, EngineMode
from repro_torch.runtime.request import Request

pytestmark = pytest.mark.cuda


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


def test_kernel_refuses_mismatched_dtypes(cuda):
    q = torch.zeros((1, 1, 4, 8), device=cuda)
    pool = torch.zeros((2, 64), dtype=torch.bfloat16, device=cuda)
    table = torch.zeros((1, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        kops.paged_decode_attention(q, pool, table, table[:, 0],
                                    tokens_per_page=4, n_kv=1, scale=1.0)


def test_engine_on_the_card_serves_and_returns_every_page(cuda):
    """The float32 smoke coloc set served on the card: every request gets
    its tokens, both kernels launch, every page comes back."""
    models = {n: get_smoke_config(n).replace(dtype="float32")
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
