"""The bf16 grouped expert GEMM's launch plans, route and work lists.

``repro_torch.kernels.moe_gemm`` mirrors on the host what the bf16 body
of ``csrc/moe_gemm.cu`` is launched with: ``gemm_plan`` (tile, stages,
warps, shared memory; the card test ``test_moe_gemm_plan_matches_library``
holds it against the library's own report), ``gemm_route`` (TMA or the
guarded element loader) and the work lists its persistent blocks build
on the card (``gemm_items`` for the forward and input gradient,
``wgrad_items`` for the weight gradient, heaviest expert first).  Here,
on the CPU, the plans are held to what an H100 allows (227 KB of shared
memory a block, wgmma's 64-row tiles and k steps of 16, N a multiple of
8 up to 256, TMA boxes no wider than their swizzle span, 16-byte global
strides on the TMA route), and the work lists to covering every tile
exactly once at phase 7's shape under the loads of
``tests/test_torch_f32_kernels.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.kernels import moe_gemm as mg

#: an H100's shared memory of one SM, and the 1 KB it reserves a block
SM_SMEM, RESERVED = 233472, 1024
#: phase 7's training shape (moonshot: 8 x 512 tokens, top 6, d_model
#: 2048, d_ff 1408, 64 experts)
N, K, M, E = 24576, 2048, 1408, 64
#: (kdim, cols) of the calls the port makes: phase 7's gate/up and down
#: projections and the card tests' shapes
SHAPES = [(2048, 1408), (1408, 2048), (64, 96), (48, 130), (64, 136),
          (136, 200), (128, 256), (36, 130), (256, 384), (512, 384)]
EXPERTS = sorted({1, 2, 5, 64} | {get_config(a).n_experts
                                  for a in ARCH_NAMES
                                  if get_config(a).n_experts})
CASES = [(op, route, k, m)
         for op in mg.OPS for route in mg.ROUTES for k, m in SHAPES]
IDS = [f"{op}-{route}-K{k}-M{m}" for op, route, k, m in CASES]


def _plan(op, route, k, m, experts=E):
    cols = k if op == "dgrad" else m        # the dgrad writes [N, K]
    return mg.gemm_plan(torch.bfloat16, route, op, cols, experts, kdim=k)


@pytest.mark.parametrize("op,route,k,m", CASES, ids=IDS)
def test_plan_fits_shared_memory(op, route, k, m):
    """Every expert count a config has: one block an SM within 227 KB
    (and the SM's 228 KB with its reserved 1 KB), a ring of >= 2 stages
    of whole A and B slices beside the staged output tile."""
    for experts in EXPERTS:
        plan = _plan(op, route, k, m, experts)
        assert 0 < plan["smem_bytes"] <= mg.SMEM_LIMIT
        assert plan["blocks_per_sm"] * (plan["smem_bytes"] + RESERVED) \
            <= SM_SMEM
        assert plan["stages"] >= 2
        # the ring, the staged output tile, the table and 1 KB of room to
        # align the ring to the swizzle's 1024 bytes
        ring = plan["stages"] * plan["stage_bytes"]
        assert ring + plan["out_bytes"] + plan["table_bytes"] + 1024 \
            < plan["smem_bytes"]
        assert plan["stage_bytes"] == \
            (plan["rows"] + plan["cols"]) * plan["depth"] * 2
        assert plan["out_bytes"] == plan["rows"] * plan["cols"] * 2


@pytest.mark.parametrize("op,route,k,m", CASES, ids=IDS)
def test_plan_takes_wgmma_and_tma_shapes(op, route, k, m):
    plan = _plan(op, route, k, m)
    assert plan["wgmma_m"] == 64 and plan["wgmma_k"] == 16
    assert plan["warps"] == 4 * plan["consumer_warpgroups"]
    assert plan["rows"] == plan["consumer_warpgroups"] * \
        plan["warpgroup_rows"]
    assert plan["warpgroup_rows"] % plan["wgmma_m"] == 0
    assert plan["depth"] % plan["wgmma_k"] == 0
    n = plan["wgmma_n"]
    assert n == plan["cols"] and n % 8 == 0 and 8 <= n <= 256
    # the accumulators of a thread: 64 x N f32 a product over 128 threads
    acc = plan["warpgroup_rows"] // 64 * n // 2
    assert acc <= 128
    # 64-column blocks of 128-byte rows: the box within its swizzle span,
    # every block 1024-byte aligned (the swizzle's period)
    assert plan["box_cols"] * 2 == plan["swizzle_bytes"] == 128
    assert plan["cols"] % plan["box_cols"] == 0
    assert plan["stage_bytes"] % 1024 == 0 and plan["out_bytes"] % 1024 == 0
    assert all(0 < r <= 256 for r in plan["box_rows"])    # TMA box rows
    if route == "guarded":
        assert (plan["rows"], plan["cols"]) == (128, 128)


def test_plan_at_the_training_shape():
    """Phase 7's calls: the forward and dgrad on 128 x 256 tiles (M =
    1408 pads to six of 256), the weight gradient on 256 x 128 dw tiles
    (eleven columns of 128, eight rows of 256); three stages of 48 KB."""
    for op, cols, want in (("forward", M, (128, 256)),
                           ("dgrad", K, (128, 256)),
                           ("wgrad", M, (256, 128))):
        plan = mg.gemm_plan(torch.bfloat16, "tma", op, cols, E, kdim=K)
        assert (plan["rows"], plan["cols"]) == want
        assert plan["stages"] == 3 and plan["stage_bytes"] == 48 << 10
    assert mg.tile_of("wgrad", "tma", K, M) == (128, 256)  # the down proj


@pytest.mark.parametrize("bad", [dict(dtype=torch.float32),
                                 dict(route="cp.async"), dict(op="fwd")])
def test_plan_refuses_what_no_body_takes(bad):
    args = dict(dtype=torch.bfloat16, route="tma", op="forward")
    args.update(bad)
    with pytest.raises(ValueError):
        mg.gemm_plan(args["dtype"], args["route"], args["op"], 256, 4)


@pytest.mark.parametrize("rows,k,m,offset,want", [
    (1000, 2048, 1408, 0, "tma"),      # phase 7
    (1000, 136, 200, 0, "tma"),        # off the 64 / 128 tile edges
    (300, 64, 96, 0, "tma"),
    (64, 36, 130, 0, "guarded"),       # 72- and 260-byte rows
    (77, 48, 130, 0, "guarded"),
    (1000, 2048, 1408, 2, "guarded"),  # a base off a 16-byte boundary
    (1000, 2048, 1408, 8, "guarded"),
    (0, 2048, 1408, 0, "guarded"),     # no rows to map
])
def test_route_from_shapes_and_alignment(rows, k, m, offset, want):
    """The TMA route needs 16-byte global strides (rows of k and m bf16
    elements, multiples of 8) and 16-byte aligned bases; anything else
    takes the guarded element loader."""
    route = mg.gemm_route(torch.bfloat16, rows, k, m, 1 << 20, 1 << 21,
                          (1 << 22) + offset)
    assert route == want
    if route == "tma":
        assert (2 * k) % 16 == 0 and (2 * m) % 16 == 0
    with pytest.raises(ValueError):
        mg.gemm_route(torch.float32, rows, k, m)


# ---------------------------------------------------------------------------
# the work lists, over the loads of tests/test_torch_f32_kernels.py
# ---------------------------------------------------------------------------

def _router_load(rng, n, experts):
    p = np.exp(rng.standard_normal(experts))
    return rng.multinomial(n, p / p.sum()).astype(np.int32)


def _skewed_load(n, experts, share=0.9):
    rest = int(n * (1 - share)) // (experts - 1)
    sizes = np.full(experts, rest, np.int32)
    sizes[experts // 2] = n - rest * (experts - 1)
    return sizes


def _load(name):
    rng = np.random.default_rng(2)
    return {"router": _router_load(rng, N, E),
            "skewed": _skewed_load(N, E),
            "one expert": np.eye(E, dtype=np.int32)[5] * N,
            "empty": np.zeros(E, np.int32),
            "rows past": _skewed_load(N, E) - np.eye(E, dtype=np.int32)[
                E // 2] * 300}[name]


LOADS = ["router", "skewed", "one expert", "empty", "rows past"]


@pytest.mark.parametrize("cols", [M, K])
@pytest.mark.parametrize("load", LOADS)
def test_forward_items_cover_every_tile_once(load, cols):
    """Every output tile of the forward (and dgrad, ``cols`` = K) once:
    each group's rows (the experts, then the rows past the groups) cut
    into 128-row tiles that never straddle two groups, every column tile
    of each, one column's row tiles consecutive; an empty expert has no
    tile."""
    sizes = _load(load)
    items = mg.gemm_items(sizes, N, cols)
    bn = mg.tile_of("forward", "tma", cols)[1]
    ct = -(-cols // bn)
    groups = list(sizes) + [N - int(sizes.sum())]
    starts = np.concatenate([[0], np.cumsum(groups)])
    assert len(items) == sum(-(-int(n) // 128) for n in groups) * ct
    assert len(set((g, r, c) for g, r, _, c in items)) == len(items)
    for g, n in enumerate(groups):
        mine = [it for it in items if it[0] == g]
        for c in range(ct if n else 0):
            col = [it for it in mine if it[3] == c * bn]
            rows = [r for _, r0, cnt, _ in col for r in range(r0, r0 + cnt)]
            assert rows == list(range(starts[g], starts[g + 1]))
            assert all(0 < cnt <= 128 for *_, cnt, _ in col)
            first = items.index(col[0])
            assert items[first:first + len(col)] == col   # consecutive
        assert mine or n == 0
    assert [it[0] for it in items] == sorted(it[0] for it in items)


@pytest.mark.parametrize("load", LOADS)
def test_wgrad_items_cover_every_tile_once_heaviest_first(load):
    """Every dw tile of every expert once, the experts by rows heaviest
    first (ties by index), so the hot expert's tiles start first and the
    light ones fill the SMs that finish early; an expert with no rows
    keeps its tiles (they write its zeros) at the end of the list."""
    sizes = _load(load)
    items = mg.wgrad_items(sizes, K, M)
    bm, bn = mg.tile_of("wgrad", "tma", M, K)
    per = -(-K // bm) * -(-M // bn)
    assert len(items) == E * per
    assert len({(e, k0, m0) for e, k0, m0, *_ in items}) == len(items)
    order = [items[i][0] for i in range(0, len(items), per)]
    assert order == mg.wgrad_order(sizes) and sorted(order) == list(range(E))
    assert all(sizes[a] > sizes[b] or (sizes[a] == sizes[b] and a < b)
               for a, b in zip(order, order[1:]))
    starts = np.concatenate([[0], np.cumsum(sizes)])
    for e, k0, m0, row0, n in items:
        assert (row0, n) == (starts[e], sizes[e])
        assert k0 % bm == 0 and k0 < K and m0 % bn == 0 and m0 < M
    if load == "skewed":
        assert order[0] == E // 2


def test_wrappers_never_call_the_mirrors():
    """The mirrors are for tests: the launch path reads nothing back to
    the host and builds its lists on the card."""
    for fn in (mg._gemm, mg.moe_gemm_wgrad):
        called = set(fn.__code__.co_names)
        assert called.isdisjoint({"gemm_items", "wgrad_items", "wgrad_order",
                                  "gemm_plan", "gemm_route", "tile_of"})
