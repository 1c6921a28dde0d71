"""Logical-axis rules -> partition specs, and the local shards they give.

Port of ``src/repro/sharding/spec.py``.  Params and caches map to a
:class:`PartitionSpec` (per dimension: ``None``, an axis name or a tuple
of axis names) by *path pattern* rules.  A rule only applies when the
dimension is divisible by the mesh axes it names; otherwise that
dimension falls back to replicated, which keeps every (arch x mesh) cell
placeable (uneven vocab / head counts replicate instead of erroring).

The reference hands specs to the partitioner.  The port runs explicit
SPMD, so it also computes what each rank holds: ``shard_shape``,
``local_slices`` (JAX's row-major order over an axis tuple) and
``shard_tree``.
"""
from __future__ import annotations

import fnmatch
import math
from typing import Iterable, Optional, Sequence, Tuple, Union

from repro_torch.launch.mesh import Mesh
from repro_torch.training.tree import leaves_with_path

AxisName = Union[str, Tuple[str, ...], None]


class PartitionSpec(tuple):
    """Per-dimension axis assignment: a tuple of ``None``, an axis name or
    a tuple of axis names (JAX's ``PartitionSpec``, which also stores a
    one-axis tuple as the bare name and an empty one as ``None``)."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, tuple) and len(e) <= 1:
                return e[0] if e else None
            return e
        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def axis_size(mesh: Mesh, axis: AxisName) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return math.prod(mesh.shape[a] for a in axis)
    return mesh.shape[axis]


def batch_axes(mesh: Mesh) -> AxisName:
    """The pure-DP axes: ('pod','data') on the multi-pod mesh."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def pool_axes(mesh: Mesh) -> AxisName:
    """Axes the consolidated weights pool spans for expert placement."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def safe_spec(mesh: Mesh, shape: Sequence[int], spec: Sequence[AxisName]
              ) -> PartitionSpec:
    """Drop per-dim axes that do not divide the dim size (replicate there)."""
    fixed = []
    for dim, ax in zip(shape, spec):
        if ax is None:
            fixed.append(None)
            continue
        size = axis_size(mesh, ax)
        fixed.append(ax if dim % size == 0 and dim >= size else None)
    return PartitionSpec(*fixed)


def path_str(path: Sequence[str]) -> str:
    """A leaf's path (the keys from the root) as JAX's ``"/"``-joined
    key string."""
    return "/".join(str(p) for p in path)


class RuleSet:
    """Ordered (pattern, spec-builder) rules over param/cache path strings.

    The spec is a per-dim axis tuple aligned to the *trailing* dims of the
    array; leading unlisted dims (e.g. the stacked layer dim) replicate.
    """

    def __init__(self, rules: Iterable[Tuple[str, Sequence[AxisName]]],
                 default: Sequence[AxisName] = ()):
        self.rules = list(rules)
        self.default = tuple(default)

    def spec_for(self, mesh: Mesh, path: str, shape: Sequence[int]
                 ) -> PartitionSpec:
        for pattern, spec in self.rules:
            if fnmatch.fnmatch(path, pattern):
                return self._align(mesh, shape, spec)
        return self._align(mesh, shape, self.default)

    @staticmethod
    def _align(mesh: Mesh, shape: Sequence[int], spec: Sequence[AxisName]
               ) -> PartitionSpec:
        spec = tuple(spec)
        if len(spec) > len(shape):
            spec = spec[len(spec) - len(shape):]
        full = (None,) * (len(shape) - len(spec)) + spec
        return safe_spec(mesh, shape, full)

    def tree_specs(self, mesh: Mesh, tree):
        """The tree's spec per leaf (tensors, meta tensors, or anything
        with a ``shape``)."""
        def walk(node, path):
            if isinstance(node, dict):
                return {k: walk(v, path + (k,)) for k, v in node.items()}
            return self.spec_for(mesh, path_str(path), tuple(node.shape))
        return walk(tree, ())


def spec_axes(mesh: Mesh, spec: Sequence[AxisName]) -> Tuple[str, ...]:
    """The mesh axes ``spec`` splits some dimension over, in the mesh's
    order."""
    used = {a for ax in spec for a in mesh.axes_of(ax)}
    return tuple(a for a in mesh.axis_names if a in used)


def dims_on(mesh: Mesh, spec: Sequence[AxisName], axes: Sequence[str]
            ) -> Tuple[Tuple[int, Tuple[str, ...]], ...]:
    """(dim, its axes among ``axes``) for every dimension ``spec`` splits
    over some of ``axes``: a leaf's FSDP dims for the pool axes, its
    tensor-parallel dim for ``("model",)``."""
    out = []
    for dim, ax in enumerate(spec):
        mine = tuple(a for a in mesh.axes_of(ax) if a in axes)
        if mine:
            out.append((dim, mine))
    return tuple(out)


# ---------------------------------------------------------------------------
# What a rank holds
# ---------------------------------------------------------------------------

def shard_shape(mesh: Mesh, shape: Sequence[int], spec: Sequence[AxisName]
                ) -> Tuple[int, ...]:
    """The per-device shape of an array of ``shape`` under ``spec``
    (``NamedSharding(mesh, spec).shard_shape(shape)``; an axis named by
    two dimensions is refused, as there)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    used = [a for ax in spec for a in mesh.axes_of(ax)]
    if len(used) != len(set(used)):
        raise ValueError(f"spec {spec} uses a mesh axis twice")
    out = []
    for dim, ax in zip(shape, spec):
        n = axis_size(mesh, ax)
        if dim % n:
            raise ValueError(f"dim {dim} does not divide over {ax} ({n})")
        out.append(dim // n)
    return tuple(out)


def local_slices(mesh: Mesh, shape: Sequence[int], spec: Sequence[AxisName],
                 coord: Optional[Sequence[int]] = None
                 ) -> Tuple[slice, ...]:
    """The slice of each dimension the device at ``coord`` (default:
    this rank's) holds: a dimension over an axis tuple splits row-major
    in the tuple's order, as ``devices_indices_map``."""
    local = shard_shape(mesh, shape, spec)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(slice(mesh.index(ax, coord) * n, (mesh.index(ax, coord) + 1)
                       * n) for ax, n in zip(spec, local))


def shard_tree(rules, mesh: Mesh, tree, coord: Optional[Sequence[int]] = None,
               device=None):
    """This rank's local shards of ``tree`` (a nested dict of tensors)
    under ``rules`` (any object with ``spec_for(mesh, path, shape)``),
    moved to ``device`` when given.  A split leaf's shard is a copy, so
    the whole leaf can be freed; a leaf this rank holds whole is the leaf
    itself (no second copy of a replicated weight)."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        spec = rules.spec_for(mesh, path_str(path), tuple(node.shape))
        part = node[local_slices(mesh, node.shape, spec, coord)]
        if part.shape != node.shape:
            part = part.clone()
        return part if device is None else part.to(device)
    return walk(tree, ())


def tree_bytes(rules, mesh: Mesh, tree) -> int:
    """Per-device bytes of ``tree``'s leaves under ``rules``, from shapes
    alone (meta tensors are enough)."""
    total = 0
    for path, leaf in leaves_with_path(tree):
        spec = rules.spec_for(mesh, path_str(path), tuple(leaf.shape))
        total += math.prod(shard_shape(mesh, leaf.shape, spec)) \
            * leaf.element_size()
    return total


def map_specs(fn, specs, tree):
    """``fn(spec, leaf)`` over the leaves of ``tree`` (dicts and
    NamedTuples such as a ``TrainState``; None stays None), ``specs`` a
    tree of :class:`PartitionSpec` with its structure."""
    if isinstance(tree, dict):
        return {k: map_specs(fn, specs[k], v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(map_specs(fn, s, t)
                            for s, t in zip(specs, tree)))
    return None if tree is None else fn(specs, tree)


def gather_tree(specs, mesh: Mesh, tree):
    """The whole leaves back from every rank's shards of ``tree`` (a live
    mesh; every rank calls it): each dimension that ``specs`` (a tree of
    :class:`PartitionSpec` with ``tree``'s structure) splits is
    all-gathered over its axes."""
    def whole(spec, leaf):
        for dim, ax in enumerate(spec):
            if ax is not None:
                leaf = mesh.all_gather(leaf, ax, dim)
        return leaf
    return map_specs(whole, specs, tree)


def shard_by_specs(specs, mesh: Mesh, tree, device=None):
    """This rank's shards of ``tree`` under ``specs`` (``shard_tree``'s
    cut, by a tree of specs: a ``TrainState``'s, ``TrainCell.state_specs``)."""
    def cut(spec, leaf):
        part = leaf[local_slices(mesh, leaf.shape, spec)]
        if part.shape != leaf.shape:
            part = part.clone()
        return part if device is None else part.to(device)
    return map_specs(cut, specs, tree)
