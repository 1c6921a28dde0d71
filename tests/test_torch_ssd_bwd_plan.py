"""The SSD scan backward's launch plan, tile pairs and workspace.

``repro_torch.kernels.ssd_scan`` mirrors on the host how
``csrc/ssd_scan.cu`` launches the backward: ``bwd_plan`` (the four
launches' grids and shared memory, kernel C's tile widths, target tiles,
partial rows, target buffers and the TF32 passes of each product; the card
test ``test_ssd_bwd_plan_matches_library`` holds it against the library's
own report), ``bwd_work`` (kernel C's tile pairs in launch order) and
``bwd_regions`` (the workspace).  Here, on the CPU, at the calls the port
makes (every SSM config of ``ARCH_NAMES``, full and smoke, at the train
path's 8 x 512 and at S = 1024, both dtypes) and at the shapes phase 3 of
``chip_smoke.py`` and the card tests check, the plan is held to what an
H100 allows (227 KB of shared memory a block), to mma.sync's m16n8k8
tiles over the padded widths, the work list to covering every
lower-triangle tile pair exactly once with the heaviest source tiles
first, and the workspace to the sum of its regions.
"""
import pytest
import torch

from repro_torch.configs import ARCH_NAMES, get_config, get_smoke_config
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models.ssm import scan_chunk

#: an H100's shared memory a block
BLOCK_SMEM = 232448
#: (B, S, H, P, G, N, chunk) of phase 3's backward checks and timed calls
#: (zamba2 H 64 P 64 N 64, mamba2 H 24 P 64 N 128) and the card tests
PHASE3 = [(1, 1024, 64, 64, 1, 64, 256), (1, 1024, 24, 64, 1, 128, 256),
          (8, 512, 64, 64, 1, 64, 256), (8, 512, 24, 64, 1, 128, 256),
          (1, 64, 4, 64, 1, 64, 8), (1, 512, 8, 64, 1, 128, 64),
          (2, 512, 8, 64, 2, 64, 128), (2, 128, 4, 16, 2, 16, 32),
          (1, 96, 2, 64, 1, 64, 32), (2, 48, 4, 16, 2, 16, 16),
          (1, 40, 4, 64, 1, 64, 8), (1, 160, 2, 64, 1, 128, 80),
          (1, 48, 2, 8, 1, 4, 16)]


def _config_shapes():
    out = []
    for arch in ARCH_NAMES:
        for tag, cfg in (("", get_config(arch)),
                         ("-smoke", get_smoke_config(arch))):
            if cfg.ssm is None or not cfg.n_ssm_layers:
                continue
            s = cfg.ssm
            for B, S in ((8, 512), (1, 1024)):
                out.append((arch + tag, (B, S, s.n_heads(cfg.d_model),
                                         s.head_dim, s.n_groups, s.d_state,
                                         scan_chunk(S, s.chunk_size))))
    return out


SHAPES = _config_shapes() + [(f"phase3-{i}", s) for i, s in enumerate(PHASE3)]
CASES = [(name, shape, dtype) for name, shape in SHAPES
         for dtype in (torch.float32, torch.bfloat16)]
IDS = [f"{name}-{'x'.join(map(str, s))}-{str(d)[6:]}" for name, s, d in CASES]


@pytest.mark.parametrize("name,shape,dtype", CASES, ids=IDS)
def test_backward_plan(name, shape, dtype):
    B, S, H, P, G, N, L = shape
    assert ssd.supported(P, N, L), f"{name}: the kernels refuse {shape}"
    plan = ssd.bwd_plan(B, S, H, P, G, N, L, dtype)
    f32 = dtype == torch.float32

    # four launches of 256 threads, each within a block's shared memory
    assert [x["name"] for x in plan["launches"]] == list(ssd.BWD_LAUNCHES)
    for launch in plan["launches"]:
        assert launch["threads"] == 256
        assert 0 <= launch["smem_bytes"] <= min(BLOCK_SMEM, ssd.SMEM_LIMIT)
        assert all(0 < g < 2 ** 31 for g in launch["grid"])
    nc, nt = S // L, -(-L // 64)
    assert plan["target_tiles"] == nt
    assert plan["launches"][2]["grid"] == (nt * nc * B * H, 1, 1)
    assert plan["stages"] in ((1, 2) if f32 else (1,))
    assert plan["launches"][2]["smem_bytes"] == 4 * ssd.pair_floats(
        P, N, L, plan["stages"])

    # mma.sync m16n8k8 (TF32) over P and N padded as the kernel pads them:
    # 64-row tiles of four 16-row warp slabs, each warp half a width of
    # whole pairs of 8-column blocks, k steps of 8 within the width
    m, n, k = plan["mma"]
    assert (m, n, k) == (16, 8, 8)
    WP, WN = plan["widths"]
    for width, real in ((WP, P), (WN, N)):
        assert width == max(32, real) and width & (width - 1) == 0
        assert (width // 2) % (2 * n) == 0
        assert -(-real // k) * k <= width
    assert 64 % (4 * m) == 0 and 32 % (2 * n) == 0
    # the U region holds dS or h ([W_P][W_N]) and the two score tiles
    assert WP * WN <= ssd.BWD_U_FLOATS and 2 * 64 * 64 <= ssd.BWD_U_FLOATS
    passes = plan["passes"]
    assert passes["C.B"] == passes["dy.x"] == (3 if f32 else 1)
    assert all(passes[p] == (3 if f32 else 2)
               for p in ("M1.dy", "M2.C", "M2^T.B", "state terms", "S, E"))
    assert plan["launches"][0]["grid"] == (2 * nc, H, B)
    assert plan["launches"][0]["smem_bytes"] == 4 * ssd.state_bwd_floats(
        P, N, L)

    # kernel C's pairs: each lower-triangle (source, target) tile pair of
    # every chunk and head x batch row once, each block walking from its
    # diagonal, the blocks with the most target tiles first
    work = ssd.bwd_work(L, nc, B * H)
    pairs = [(bh, c, si, tj) for bh in range(B * H) for c in range(nc)
             for tj in range(nt) for si in range(tj + 1)]
    assert sorted(work) == sorted(pairs) and len(set(work)) == len(work)
    blocks = [w for w in work if w[2] == w[3]]
    assert len(blocks) == nt * nc * B * H
    tiles = [nt - si for _, _, si, _ in blocks]
    assert tiles == sorted(tiles, reverse=True)

    # the workspace: its regions, 16-byte aligned, add up to it and hold
    # the largest index each kernel writes
    regions = dict(plan["regions"])
    assert list(regions) == list(ssd.BWD_REGIONS)
    assert all(v % 4 == 0 for v in regions.values())
    assert sum(regions.values()) == ssd.bwd_workspace(B, S, H, P, N, L)
    tr, npairs = plan["partial_rows"], nt * (nt + 1) // 2
    assert tr == min(L, 64)
    bhs = B * H
    assert regions["dC by tile pair"] >= bhs * nc * npairs * tr * N
    assert regions["dLa by tile pair"] >= bhs * nc * npairs * tr
    assert regions["<dS, h> by slice"] >= bhs * nc * ssd.HDOT_PARTS
    assert plan["slices"] == -(-P * N // 256) <= ssd.HDOT_PARTS
    assert regions["dB by head"] >= B * S * H * N
