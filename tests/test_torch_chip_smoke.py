"""``chip_smoke.py``'s phase option and its phase modules, on the CPU (the
phases themselves need a card: ``tests/test_torch_engine.py`` runs the
script without one)."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
import chip_smoke_phases as phases  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401


def test_default_runs_every_phase():
    assert chip_smoke.parse_args([]) == list(range(1, 18))
    assert [n for n, *_ in phases.PHASES] == list(range(1, 18))


@pytest.mark.parametrize("spec,want", [
    ("3,15", [1, 2, 3, 15]),
    ("sharded_train", [1, 2, 15]),
    ("8", [1, 2, 7, 8]),                 # phase 8 reads phase 7's load
    ("17, kernels", [1, 2, 3, 17]),
])
def test_a_subset_takes_its_phases_and_what_they_read(spec, want):
    assert chip_smoke.parse_args(["--phases", spec]) == want


@pytest.mark.parametrize("spec", ["18", "0", "kernel", "3,,4", "sharded"])
def test_an_unknown_phase_is_refused(spec, capsys):
    with pytest.raises(SystemExit) as done:
        chip_smoke.parse_args(["--phases", spec])
    assert done.value.code == 2
    assert "unknown phase" in capsys.readouterr().err


@pytest.mark.parametrize("n", range(1, 18))
def test_every_phase_module_has_its_run(n):
    mod = phases.module(n)
    assert callable(mod.run)
    assert mod.__doc__.startswith(f"Phase {n} of ``chip_smoke.py``")


@pytest.mark.parametrize("fault", [None, "permuted", "wrong slice"])
def test_grad_shard_gate_sees_a_misplaced_shard(fault):
    """Phases 15b / 17c-d hold each rank's gradient shards against the
    same slices of the one-rank run's gradients: exact slices pass, and
    a shard permuted along its split dimension or cut from another
    rank's slice fails the gate."""
    import torch
    from dataclasses import replace
    from repro_torch.configs import SHAPES_BY_NAME, get_smoke_config
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding.spec import local_slices, path_str
    from repro_torch.sharding.strategies import make_strategy
    from repro_torch.training.tree import leaves_with_path
    from chip_smoke_phases.p15_sharded_train import grad_shards_rel
    cfg = get_smoke_config("qwen3-moe-235b-a22b").replace(dtype="float32")
    shape = replace(SHAPES_BY_NAME["train_4k"], seq_len=16, global_batch=8)
    mesh = Mesh((2, 2), ("data", "model")).stand_in(0)
    specs = make_strategy("train", mesh, cfg, shape).param_specs()
    gen = torch.Generator().manual_seed(0)
    whole = {path_str(p): torch.randn(tuple(leaf.shape), generator=gen)
             for p, leaf in leaves_with_path(tfm.param_shapes(cfg))}
    shards = {p: g[local_slices(mesh, g.shape, specs[p])].clone()
              for p, g in whole.items()}
    split = [p for p in whole if shards[p].shape != whole[p].shape]
    assert split
    path = max(split, key=lambda p: shards[p].numel())
    dim = next(i for i, (a, b) in enumerate(zip(shards[path].shape,
                                                whole[path].shape)) if a != b)
    if fault == "permuted":
        shards[path] = shards[path].flip(dim)
    elif fault == "wrong slice":
        other = next(c for c in (mesh.coord_of(r) for r in range(4))
                     if local_slices(mesh, whole[path].shape, specs[path], c)
                     != local_slices(mesh, whole[path].shape, specs[path]))
        shards[path] = whole[path][local_slices(
            mesh, whole[path].shape, specs[path], other)].clone()
    if fault is None:
        assert grad_shards_rel(torch, mesh, specs, shards, whole, 1e-5,
                               "exact") == 0.0
    else:
        with pytest.raises(AssertionError, match=f"gradient shard {path}"):
            grad_shards_rel(torch, mesh, specs, shards, whole, 1e-4, fault)
