"""The flash prefill kernel's launch plans against an H100's limits.

``repro_torch.kernels.flash_attention.flash_plan`` is the host mirror of
the constants each body of ``csrc/flash_attention.cu`` is launched with
(the card test ``test_flash_plan_matches_library`` holds it against the
built library's own report).  Here, on the CPU, every head dim of
``HEAD_DIMS`` is held to what the card allows: a block's dynamic shared
memory within 227 KB (and the residency its launch bounds ask for within
the SM's), a ring of at least two stages, registers within the file, and
for bfloat16 the shapes ``wgmma`` and the TMA take (64-row warpgroup
tiles, k steps of 16, N a multiple of 8 up to 256, boxes no wider than
their swizzle span).
"""
import pytest
import torch

from repro_torch.kernels import flash_attention as fa

CASES = [(dtype, D) for dtype, dims in fa.HEAD_DIMS.items() for D in dims]
IDS = [f"{str(dtype)[6:]}-{D}" for dtype, D in CASES]
#: 32-bit registers of one SM
SM_REGISTERS = 65536


@pytest.mark.parametrize("dtype,D", CASES, ids=IDS)
def test_plan_fits_shared_memory(dtype, D):
    plan = fa.flash_plan(D, dtype)
    assert 0 < plan["smem_bytes"] <= fa.SMEM_LIMIT
    # each resident block also holds 1 KB the hardware reserves
    assert plan["blocks_per_sm"] * (plan["smem_bytes"] + 1024) <= fa.SM_SMEM
    assert plan["stages"] >= 2


@pytest.mark.parametrize("dtype,D", CASES, ids=IDS)
def test_plan_ring_holds_whole_tiles(dtype, D):
    """A ring stage holds K and V of one key tile; the stages, the q tile
    and (float32) the merge area and P tiles fit the block's bytes."""
    plan = fa.flash_plan(D, dtype)
    size = 2 if dtype == torch.bfloat16 else 4
    pad = 0 if dtype == torch.bfloat16 else 4
    ring = plan["stages"] * plan["key_tile"] * (2 * D + pad) * size
    q_tile = plan["rows"] * (D + pad) * size
    assert ring + q_tile <= plan["smem_bytes"]
    if dtype == torch.float32:
        merge = plan["column_warps"] * plan["rows"] * (D + 6) * size
        p_tiles = plan["warps"] * 16 * plan["warp_keys"] * size
        assert max(ring, merge) + q_tile + p_tiles == plan["smem_bytes"]


@pytest.mark.parametrize("D", fa.HEAD_DIMS[torch.bfloat16])
def test_bf16_plan_takes_wgmma_and_tma_shapes(D):
    plan = fa.flash_plan(D, torch.bfloat16)
    assert plan["wgmma_m"] == 64 and plan["wgmma_k"] == 16
    assert plan["rows"] == plan["wgmma_m"] * plan["consumer_warpgroups"]
    assert plan["warps"] == 4 * plan["consumer_warpgroups"]
    for n in (plan["qk_n"], plan["pv_n"]):          # S = Q K^T, O += P V
        assert n % 8 == 0 and 8 <= n <= 256
    assert D % plan["wgmma_k"] == 0                # Q K^T steps along D
    assert plan["key_tile"] % plan["wgmma_k"] == 0  # P V steps along keys
    assert plan["swizzle_bytes"] in (32, 64, 128)
    assert plan["box_cols"] * 2 == plan["swizzle_bytes"]   # box <= span
    assert D % plan["box_cols"] == 0
    assert plan["rows"] <= 256 and plan["key_tile"] <= 256  # TMA box rows


@pytest.mark.parametrize("D", fa.HEAD_DIMS[torch.bfloat16])
def test_bf16_plan_registers(D):
    """One block an SM of two warpgroups: every thread may hold
    ``thread_regs`` registers within the SM's file, and holds the O and S
    accumulators and P's bf16 fragments (D / 2 + BK / 2 + BK / 4 a lane)
    with room to spare."""
    plan = fa.flash_plan(D, torch.bfloat16)
    regs = plan["thread_regs"]
    assert regs <= 255
    assert 32 * plan["warps"] * regs <= SM_REGISTERS
    live = D // 2 + plan["key_tile"] // 2 + plan["key_tile"] // 4
    assert live <= regs - 32


@pytest.mark.parametrize("D", fa.HEAD_DIMS[torch.float32])
def test_f32_plan_thread_tiles(D):
    """Two row warps of 16 rows and four column warps of ``warp_keys``
    keys; a thread holds 4 rows x ``thread_keys`` scores and 4 rows x
    ``thread_cols`` outputs, the 8 lanes of a row spanning the warp's keys
    and all D columns; two q tiles a block (a tile and its mirror)."""
    plan = fa.flash_plan(D, torch.float32)
    assert plan["warps"] == plan["row_warps"] * plan["column_warps"]
    assert plan["rows"] == 16 * plan["row_warps"]
    assert plan["key_tile"] == plan["column_warps"] * plan["warp_keys"]
    assert plan["thread_rows"] * 4 == 16            # 4 row groups a warp
    assert plan["thread_keys"] * 8 == plan["warp_keys"]
    assert plan["thread_cols"] * 8 == D
    assert plan["warp_keys"] % 4 == 0               # P read as float4
    assert plan["q_tiles_per_block"] == 2
    # accumulators and a score tile per lane within the 255 of a thread
    # (and 128 where two blocks of 256 threads share an SM)
    live = plan["thread_rows"] * (plan["thread_cols"] + plan["thread_keys"])
    budget = 255 if plan["blocks_per_sm"] == 1 else 128
    assert live <= budget - 48


@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 8), (torch.float32, 48),
                                     (torch.float16, 64)])
def test_plan_refuses_what_no_body_takes(dtype, D):
    with pytest.raises(ValueError, match="no flash body"):
        fa.flash_plan(D, dtype)
