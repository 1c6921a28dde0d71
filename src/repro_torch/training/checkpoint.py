"""Checkpointing: save/restore with a host-side index, async save (port of
``src/repro/training/checkpoint.py``).

  * every leaf is written as its own ``.npy`` plus a JSON index holding
    the tree structure, shapes, dtypes and step; a failed write leaves the
    previous checkpoint intact (write to a tmp dir + atomic rename), and
    only the last three checkpoints are kept;
  * ``restore(..., device=)`` places every leaf on ``device``; with
    ``rules=`` (a param tree's) or ``specs=`` (any tree's, a sharded
    ``TrainState``'s: ``TrainCell.state_specs``) and a live ``mesh=`` it
    returns this rank's local shards (the reference's ``shardings``
    argument: a checkpoint written under one mesh restores onto
    another);
  * ``save(..., specs=, mesh=)`` from a sharded run gathers the whole
    leaves and rank 0 writes them once;
  * ``save_async`` copies the tensors to the host before its thread
    starts, so training can go on updating them in place while the
    filesystem write completes.

bfloat16 leaves are stored as their 16-bit words (numpy has no bfloat16)
and restored bit for bit.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

import torch.distributed as dist

from repro_torch.sharding.spec import gather_tree, shard_by_specs, shard_tree
from repro_torch.training.tree import leaves_with_path, map_tree

_SEP = "___"
_NONE = _SEP + "__none__"


class _Host:
    """A leaf copied to the host: a numpy array and its dtype's name
    (bf16 kept as its int16 words)."""

    def __init__(self, leaf):
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().to("cpu", copy=True)   # never a view
            self.dtype = str(t.dtype).replace("torch.", "")
            self.arr = (t.view(torch.int16) if t.dtype == torch.bfloat16
                        else t).numpy()
        else:
            self.arr = np.asarray(leaf)
            self.dtype = str(self.arr.dtype)


def _from_host(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    t = torch.from_numpy(arr)
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(device) if device is not None else t


def save(tree, step: int, directory: str, *, specs=None,
         mesh=None) -> Optional[str]:
    """Synchronous atomic checkpoint write.  Returns the final path.

    With a live ``mesh``, ``tree`` holds this rank's shards under
    ``specs`` (a tree of partition specs, ``RuleSet.tree_specs`` of the
    whole tree): every rank gathers the whole leaves, rank 0 writes them
    and returns the path, the others None once it is written."""
    if mesh is not None:
        tree = gather_tree(specs, mesh, tree)
        path = _write(tree, step, directory) if mesh.rank == 0 else None
        dist.barrier()
        return path
    return _write(tree, step, directory)


def _write(tree, step: int, directory: str) -> str:
    tmp = directory + f".tmp-{step}"
    os.makedirs(tmp, exist_ok=True)
    index: Dict[str, Any] = {"step": step, "leaves": {}}
    for path, leaf in leaves_with_path(tree):
        key = _SEP.join(path)
        if leaf is None:
            index["leaves"][key + _NONE] = {"none": True}
            continue
        host = leaf if isinstance(leaf, _Host) else _Host(leaf)
        fname = f"{len(index['leaves']):06d}.npy"
        np.save(os.path.join(tmp, fname), host.arr)
        index["leaves"][key] = {"file": fname,
                                "shape": list(host.arr.shape),
                                "dtype": host.dtype}
    with open(os.path.join(tmp, "index.json"), "w") as f:
        json.dump(index, f)
    final = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(directory, exist_ok=True)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(directory, keep=3)
    return final


def save_async(tree, step: int, directory: str) -> threading.Thread:
    """Snapshot the tensors to the host now; write on a worker thread."""
    snapshot = map_tree(lambda x: None if x is None else _Host(x), tree)
    t = threading.Thread(target=_write, args=(snapshot, step, directory),
                         daemon=True)
    t.start()
    return t


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_")]
    return max(steps) if steps else None


def restore(directory: str, step: Optional[int] = None, *,
            target_tree=None, device=None, rules=None, specs=None,
            mesh=None) -> Tuple[Any, int]:
    """Load a checkpoint (the latest when ``step`` is None) onto
    ``device`` (the CPU when None).

    ``target_tree``: a tree with the expected structure (its leaves'
    values are ignored), rebuilt with the loaded leaves; if None, the
    result is nested dicts keyed by the path parts.  ``rules`` (a
    ``RuleSet``, e.g. a strategy's ``param_rules()``) and a live ``mesh``
    re-lay a dict tree out: each leaf is cut to this rank's shard;
    ``specs`` (a tree of partition specs with the target's structure)
    does the same for any tree.
    """
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "index.json")) as f:
        index = json.load(f)
    flat: Dict[str, Any] = {}
    for key, meta in index["leaves"].items():
        if meta.get("none"):
            flat[key[: -len(_NONE)]] = None
            continue
        flat[key] = _from_host(np.load(os.path.join(path, meta["file"])),
                               meta["dtype"], device)
    if target_tree is None:
        tree = _unflatten(flat)
    else:
        it = iter(_SEP.join(path) for path, _ in
                  leaves_with_path(target_tree))
        tree = map_tree(lambda _: flat[next(it)], target_tree)
    if rules is not None:
        tree = shard_tree(rules, mesh, tree, device=device)
    elif specs is not None:
        tree = shard_by_specs(specs, mesh, tree, device=device)
    return tree, step


def _unflatten(flat: Dict[str, Any]):
    root: Dict = {}
    for key, val in flat.items():
        parts = key.split(_SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return root


def _gc(directory: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(directory) if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)
