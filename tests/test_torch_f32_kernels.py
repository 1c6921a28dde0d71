"""The float32 kernels' plans and orders against the JAX package.

On the card, every float32 decode call (paged GQA, contiguous GQA and
paged MLA) runs one split-KV body, and the float32 weight gradient of the
grouped expert GEMM cuts each expert's rows into chunks added in a fixed
order.  Neither kernel runs here; what they rest on does: the geometry
check that decides which calls have an instance (every one the port can
make, nothing else), the split plan and chunk plan computed from shapes
alone, and the chunk list with its order of addition in plain PyTorch,
held against ``jax.grad`` of the JAX package's grouped GEMM.  The merge
of the split-KV partials is held against the JAX oracle in
``tests/test_torch_kernels.py``.
"""
import inspect
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.configs import ARCH_NAMES, get_config, get_smoke_config
from repro_torch.kernels import build
from repro_torch.kernels import moe_gemm as mg
from repro_torch.kernels import paged_attention as pa
from torch_threads import one_torch_thread  # noqa: F401

SM = 132                                   # an H100's SMs


# ---------------------------------------------------------------------------
# the float32 decode body: geometries and split plan
# ---------------------------------------------------------------------------

def _rank_cuts(H, KV):
    """(H, KV) at one rank of a model axis of 1, 2 or 4: the heads cut
    evenly, the kv heads cut with them where they divide, else one kv head
    a rank (a rank's query heads then share one kv head)."""
    out = []
    for m in (1, 2, 4):
        if H % m:
            continue
        h = H // m
        kv = KV // m if KV % m == 0 else 1
        if h % kv == 0:
            out.append((m, h, kv))
    return out


def _f32_geometries():
    """(id, H, KV, key width, value width) of every float32 decode call
    the port can make: every config at its published and smoke widths
    (GQA: the head dim twice; MLA: one kv head, r + rp and r), at every
    rank cut of a model axis of 1, 2 or 4 (qwen3-14b's H 10 / KV 2 and
    whisper's H 3 / KV 3 at a rank of (1, 4) among them), the
    long_context_pooling example's packed latent (40 heads on one kv
    head of 256) and the card checks' small geometries."""
    out = {}
    for name in ARCH_NAMES:
        for width, cfg in (("full", get_config(name)),
                           ("smoke", get_smoke_config(name))):
            if cfg.attention == "gqa":
                H, KV = cfg.n_heads, cfg.n_kv_heads
                kd = vd = cfg.head_dim
            elif cfg.attention == "mla":
                H, KV = cfg.n_heads, 1
                vd = cfg.mla.kv_lora_rank
                kd = vd + cfg.mla.qk_rope_head_dim
            else:
                continue
            for m, h, kv in _rank_cuts(H, KV):
                out[f"{name}-{width}-m{m}"] = (h, kv, kd, vd)
    out["packed-latent"] = (40, 1, 256, 256)
    out["gqa-small"] = (16, 4, 64, 64)
    out["mla-small"] = (8, 1, 80, 64)
    return [(k,) + v for k, v in sorted(out.items())]


@pytest.mark.parametrize("name,H,KV,kd,vd", _f32_geometries())
def test_f32_kernel_takes_every_port_geometry(name, H, KV, kd, vd):
    """``check_f32_geometry`` accepts every float32 geometry the port can
    pass, and the split plan gives it an instantiated row count."""
    pa.check_f32_geometry(H, KV, kd, vd)
    rows, _ = pa.split_plan(2, H, KV, 4096, SM, torch.float32)
    assert rows in pa.F32_ROWS and rows >= min(H // KV, pa.F32_ROWS[-1])


@pytest.mark.parametrize("H,KV,kd,vd", [
    (8, 2, 96, 96),           # a head dim with no instance
    (8, 2, 48, None),
    (6, 4, 64, 64),           # heads that do not group
    (40, 1, 320, 256),        # MLA widths with no instance
    (8, 2, 288, 256),         # MLA over more than one kv head
    (4, 1, 24, 8),
])
def test_f32_kernel_refuses_what_it_lacks(H, KV, kd, vd):
    """A width with no instance raises ``ValueError``; on a card the
    wrapper raises with it and never falls back to the plain version."""
    with pytest.raises(ValueError):
        pa.check_f32_geometry(H, KV, kd, vd)


def test_f32_instances_are_the_checked_ones():
    """The source instantiates ``f32::pick`` for exactly the rows
    (``F32_ROWS``), GQA head dims (``HEAD_DIMS``) and MLA widths
    (``MLA_WIDTHS``) that ``check_f32_geometry`` and the split plan
    accept."""
    src = (build.CSRC / "paged_attention.cu").read_text()
    body = src[src.index("namespace f32 {"):src.index("// namespace f32")]
    rows = {int(r) for r in re.findall(
        r"case (\d+): return launch<KD, VD, kPrefix, \1>", body)}
    dims = {int(d) for d in re.findall(
        r"case (\d+): return pick_rows<\1, \1, false>", body)}
    mla = {(int(v), int(k) - int(v)) for k, v in re.findall(
        r"return pick_rows<(\d+), (\d+), true>", body)}
    assert rows == set(pa.F32_ROWS)
    assert dims == set(pa.HEAD_DIMS)
    assert mla == set(pa.MLA_WIDTHS)


@pytest.mark.parametrize("group,rows", [(1, 1), (2, 4), (3, 4), (4, 4),
                                        (5, 16), (7, 16), (16, 16),
                                        (40, 16)])
def test_f32_rows_per_block(group, rows):
    """A float32 block serves 1, 4 or 16 query heads; a group past 16
    (the packed latent's 40) takes several blocks."""
    assert pa.rows_per_block(group, torch.float32) == rows


@pytest.mark.parametrize("B,H,KV,max_tokens", [
    (1, 40, 1, 32768),        # the packed latent at 32768 tokens
    (1, 40, 1, 32768 // 28 * 28 + 28),
    (4, 40, 1, 1024),         # minicpm3 MLA, B = 4, 1k and 8k
    (4, 40, 1, 8192),
    (4, 10, 2, 520),          # a qwen3-14b rank of (1, 4)
    (4, 8, 8, 520),           # a zamba2 rank
    (4, 3, 3, 520),           # a whisper rank
    (2, 16, 16, 520),         # moonshot's whole heads
    (64, 8, 2, 4096),         # a large batch: no split
])
def test_f32_split_plan_from_shapes(B, H, KV, max_tokens):
    """The float32 split plan reads shapes only (no lengths): at least
    one split, never more than tiles or ``MAX_SPLITS``, and
    ``BLOCKS_PER_SM`` blocks per SM where the tiles allow (so one row of
    the packed latent at 32768 tokens fills the card)."""
    rows, splits = pa.split_plan(B, H, KV, max_tokens, SM, torch.float32)
    groups = -(-(H // KV) // rows)
    tiles = pa.n_tiles(max_tokens)
    assert splits == pa.kv_splits(B, KV * groups, max_tokens, SM)
    assert 1 <= splits <= min(tiles, pa.MAX_SPLITS)
    blocks = B * KV * groups * splits
    assert blocks >= min(pa.BLOCKS_PER_SM * SM,
                         B * KV * groups * min(tiles, pa.MAX_SPLITS))
    if (B, H, KV) == (1, 40, 1) and max_tokens >= 32768:
        assert blocks >= pa.BLOCKS_PER_SM * SM
    assert "lengths" not in inspect.signature(pa.split_plan).parameters


# ---------------------------------------------------------------------------
# the float32 weight gradient: chunk plan and order of addition
# ---------------------------------------------------------------------------

def _router_load(rng, n, experts):
    """A router-like load: ``n`` rows drawn over ``experts`` with uneven
    probabilities (as phase 7's router spreads them)."""
    p = np.exp(rng.standard_normal(experts))
    return rng.multinomial(n, p / p.sum()).astype(np.int32)


def _skewed_load(n, experts, share=0.9):
    """``n`` rows with one expert holding at least ``share`` of them."""
    rest = int(n * (1 - share)) // (experts - 1)
    sizes = np.full(experts, rest, np.int32)
    sizes[experts // 2] = n - rest * (experts - 1)
    return sizes


def _with_empty_and_tail(sizes, tail):
    """``sizes`` with its least loaded expert's rows moved onto the most
    loaded one, and ``tail`` rows of the busiest taken off (rows past
    ``offsets[E]``)."""
    out = sizes.copy()
    idle, busy = int(np.argmin(out)), int(np.argmax(out))
    out[busy] += out[idle] - tail
    out[idle] = 0
    return out


@pytest.mark.parametrize("load", ["router", "skewed"])
def test_wgrad_chunk_order_matches_jax_grad(load):
    """Phase 7's router load and the skewed load (90% of the rows on one
    expert), scaled down to a CPU size (1536 rows, 16 experts, chunks of
    64: the ratio of rows to chunk of 24576 rows in chunks of 1024), each
    with an empty expert and 37 rows past the groups: the chunks summed
    on their own and added into dw[e] in order are within 1e-4 of
    ``jax.grad`` of the JAX package's grouped GEMM.  Its reference
    assumes the groups cover every row, so it gets the covered rows; the
    port's order ignores the tail itself."""
    rng = np.random.default_rng(0 if load == "router" else 1)
    N, K, M, E, chunk, tail = 1536, 24, 40, 16, 64, 37
    sizes = (_router_load(rng, N, E) if load == "router"
             else _skewed_load(N, E))
    sizes = _with_empty_and_tail(sizes, tail)
    covered = int(sizes.sum())
    assert covered == N - tail and (sizes == 0).any()
    x = rng.standard_normal((N, K)).astype(np.float32)
    w = rng.standard_normal((E, K, M)).astype(np.float32) * K ** -0.5
    dy = (rng.standard_normal((N, M)) * (E / N) ** 0.5).astype(np.float32)
    chunks = mg.wgrad_chunks(sizes, chunk)
    assert len(chunks) > E and max(c[1] for c in chunks) >= 1

    def loss(w_):
        return jnp.sum(jref.moe_gemm(jnp.asarray(x[:covered]), w_,
                                     jnp.asarray(sizes))
                       * jnp.asarray(dy[:covered]))
    want = np.asarray(jax.grad(loss)(jnp.asarray(w)))
    got = mg.moe_gemm_wgrad_chunked(torch.from_numpy(x), torch.from_numpy(dy),
                                    torch.from_numpy(sizes), chunk)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    assert not got[int(np.argmin(sizes))].any()       # the empty expert


@pytest.mark.parametrize("load", ["router", "skewed", "one expert", "empty"])
def test_wgrad_chunk_list_covers_every_row_once(load):
    """The work list the kernel builds on the card, mirrored: every
    expert's rows in order, cut into ``max(1, ceil(n / WGRAD_CHUNK))``
    chunks of at most ``WGRAD_CHUNK`` rows (one chunk of no rows for an
    empty expert), never more than the grid's chunk slots, which come
    from the shapes alone (24576 rows, K 2048, M 1408, E 64: phase 7's)."""
    N, K, M, E = 24576, 2048, 1408, 64
    rng = np.random.default_rng(2)
    sizes = {"router": _router_load(rng, N, E),
             "skewed": _skewed_load(N, E),
             "one expert": np.eye(E, dtype=np.int32)[5] * N,
             "empty": np.zeros(E, np.int32)}[load]
    tiles, slots = mg.wgrad_plan(N, K, M, E)
    assert tiles == 16 * 11
    chunks = mg.wgrad_chunks(sizes)
    assert len(chunks) <= slots
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    for e in range(E):
        mine = [c for c in chunks if c[0] == e]
        assert [c[1] for c in mine] == list(range(len(mine)))
        assert len(mine) == max(1, -(-int(sizes[e]) // mg.WGRAD_CHUNK))
        rows = [r for _, _, r0, n in mine for r in range(r0, r0 + n)]
        assert rows == list(range(offsets[e], offsets[e + 1]))
        assert all(0 <= n <= mg.WGRAD_CHUNK for *_, n in mine)
    assert [c[0] for c in chunks] == sorted(c[0] for c in chunks)
    assert "group_sizes" not in inspect.signature(mg.wgrad_plan).parameters


def test_wgrad_chunked_order_equals_the_plain_version_on_the_cpu():
    """The mirror's order and one product per expert agree to float32
    rounding (a row lost or counted twice would move a sum by O(1)):
    the chunk list loses and repeats no row."""
    rng = np.random.default_rng(3)
    sizes = np.array([300, 0, 5, 700, 64], np.int32)
    x = torch.from_numpy(rng.standard_normal((1100, 12)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((1100, 20)).astype(np.float32))
    got = mg.moe_gemm_wgrad_chunked(x, dy, sizes, 64)
    off = np.concatenate([[0], np.cumsum(sizes)])
    for e in range(len(sizes)):
        want = x[off[e]:off[e + 1]].double().T @ dy[off[e]:off[e + 1]].double()
        torch.testing.assert_close(got[e].double(), want, rtol=1e-5,
                                   atol=1e-4)
