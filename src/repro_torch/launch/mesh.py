"""Device meshes over ``torch.distributed`` (port of
``src/repro/launch/mesh.py``), and the card's roofline constants.

A :class:`Mesh` is the logical grid the sharding rules name: ordered axis
names and sizes, as JAX's.  It is a shape only (no devices) unless a
process group is up and it was made with ``live=True``; then it also
holds this rank's coordinate (row-major over the axes: rank ``r`` of the
world sits where ``r`` unravels, the order ``jax.make_mesh`` gives host
devices) and one process group per axis tuple, and does the collectives
the sharded step writes out.  ``Mesh.stand_in`` gives a shape-only mesh a
rank's coordinate: its collectives move nothing and return their
result's shape, which is how the op analysis (``launch/op_analysis.py``)
counts one rank's step of a 256-rank mesh on one host.

``make_production_mesh`` returns the reference's production shapes,
(data 16, model 16) and (pod 2, data 16, model 16), with no devices: the
dry-run reads per-device bytes from shapes alone, as the reference's
placeholder devices do.

The roofline constants are one NVIDIA H100 SXM5 80 GB's published peaks
(the reference keeps its TPU v5e's here).  ``NVLINK_BW`` is the card's
NVLink 4 rate in one direction; a production mesh of 256 or 512 ranks
spans nodes, whose links are slower, so the roofline's collective term
(bytes over ``NVLINK_BW``) is a lower bound there.
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

AxisName = Union[str, Tuple[str, ...], None]

# NVIDIA H100 SXM5 80 GB, per card (the H100 datasheet's SXM column; the
# tensor-core figures are dense, without sparsity)
PEAK_FLOPS_BF16 = 989e12          # FLOP/s, bf16 tensor cores
PEAK_FLOPS_TF32 = 495e12          # FLOP/s, TF32 tensor cores
PEAK_FLOPS_F32 = 67e12            # FLOP/s, float32 on the CUDA cores
HBM_BW = 3.35e12                  # bytes/s, HBM3
NVLINK_BW = 450e9                 # bytes/s a direction (NVLink 4: 900 GB/s
#                                   both directions together)
#: device memory of an NVIDIA H100 80GB HBM3 as the card reports it
#: (``torch.cuda.get_device_properties(0).total_memory`` under CUDA
#: 12.8): 79.18 GiB
HBM_BYTES = 85_017_493_504

#: the collective kinds a step's bytes are counted under (the reference's
#: HLO opcode names, ``src/repro/launch/roofline.py:30``)
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


class Mesh:
    """Named axes over ``prod(sizes)`` ranks.

    ``coord`` (this rank's index on every axis) and the process groups
    exist only for a live mesh (and ``coord`` for a stand-in); the rules
    and the dry-run's bytes need neither.  ``counted`` (None, or a dict
    the caller sets) adds up each collective's result bytes by kind
    (``COLLECTIVES``) and their number under ``"count"``: the per-device
    payload the reference sums from the partitioned HLO
    (``src/repro/launch/roofline.py:52``).  A group of one rank moves
    nothing and counts nothing.
    """

    def __init__(self, sizes: Sequence[int], axis_names: Sequence[str], *,
                 live: bool = False):
        if len(sizes) != len(axis_names):
            raise ValueError(f"{len(sizes)} sizes for axes {axis_names}")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              (int(n) for n in sizes)))
        self.size = math.prod(self.shape.values())
        self.coord: Optional[Tuple[int, ...]] = None
        self._groups: Dict[Tuple[str, ...], Tuple[object, Tuple[int, ...]]]
        self._groups = {}
        self.counted: Optional[Dict[str, int]] = None
        self.is_stand_in = False
        if live:
            self._connect()

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        kind = (", stand-in" if self.is_stand_in
                else ", live" if self.coord is not None else "")
        return f"Mesh({axes}{kind})"

    def stand_in(self, rank: int = 0) -> "Mesh":
        """This mesh's shape as rank ``rank`` sees it, with no process
        group: ``coord`` is set, so the sharded step's hooks build on it
        (``Strategy.hooks``), and each collective returns an uninitialised
        tensor of its result's shape on the input's device (``meta`` in
        the op analysis: nothing moves, nothing computes) and counts its
        result bytes in ``counted`` (set to {} here)."""
        out = Mesh(tuple(self.shape.values()), self.axis_names)
        out.coord = out.coord_of(rank)
        out.is_stand_in = True
        out.counted = {}
        return out

    def _count(self, kind: str, result: torch.Tensor) -> torch.Tensor:
        if self.counted is not None:
            self.counted[kind] = (self.counted.get(kind, 0)
                                  + result.numel() * result.element_size())
            self.counted["count"] = self.counted.get("count", 0) + 1
        return result

    # -- the live part ------------------------------------------------------
    def _connect(self) -> None:
        """This rank's coordinate and one group per nonempty axis subset.

        Every rank creates every group in the same order (``new_group`` is
        collective over the world)."""
        if not dist.is_initialized():
            raise RuntimeError("a live Mesh needs torch.distributed "
                               "initialized (init_process_group)")
        world = dist.get_world_size()
        if world != self.size:
            raise ValueError(f"mesh {self} needs {self.size} ranks, the "
                             f"world has {world}")
        self.coord = self.coord_of(dist.get_rank())
        for n in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, n):
                rest = [a for a in self.axis_names if a not in axes]
                for fixed in itertools.product(
                        *(range(self.shape[a]) for a in rest)):
                    ranks = self._ranks(axes, dict(zip(rest, fixed)))
                    group = dist.new_group(ranks=list(ranks))
                    if self.rank in ranks:
                        self._groups[axes] = (group, ranks)

    @property
    def rank(self) -> int:
        return self.rank_of(self.coord)

    def coord_of(self, rank: int) -> Tuple[int, ...]:
        out = []
        for a in reversed(self.axis_names):
            out.append(rank % self.shape[a])
            rank //= self.shape[a]
        return tuple(reversed(out))

    def rank_of(self, coord: Sequence[int]) -> int:
        r = 0
        for a, c in zip(self.axis_names, coord):
            r = r * self.shape[a] + c
        return r

    def _ranks(self, axes: Tuple[str, ...], fixed: Dict[str, int]
               ) -> Tuple[int, ...]:
        """The ranks along ``axes`` (row-major in ``axes``' order) with the
        other axes at ``fixed``."""
        out = []
        for sub in itertools.product(*(range(self.shape[a]) for a in axes)):
            c = dict(fixed, **dict(zip(axes, sub)))
            out.append(self.rank_of([c[a] for a in self.axis_names]))
        return tuple(out)

    # -- this rank on an axis tuple ----------------------------------------
    def axes_of(self, axis: AxisName) -> Tuple[str, ...]:
        if axis is None:
            return ()
        return tuple(axis) if isinstance(axis, tuple) else (axis,)

    def axis_size(self, axis: AxisName) -> int:
        return math.prod(self.shape[a] for a in self.axes_of(axis))

    def index(self, axis: AxisName, coord: Optional[Sequence[int]] = None
              ) -> int:
        """Row-major index of ``coord`` (default: this rank's) over the
        axis tuple, in the tuple's order (JAX's order for a dimension
        sharded over several axes)."""
        coord = self.coord if coord is None else tuple(coord)
        pos = dict(zip(self.axis_names, coord))
        idx = 0
        for a in self.axes_of(axis):
            idx = idx * self.shape[a] + pos[a]
        return idx

    def _group(self, axis: AxisName):
        """(group, its ranks in ``axis``' row-major order)."""
        axes = self.axes_of(axis)
        key = tuple(a for a in self.axis_names if a in axes)
        group, _ = self._groups[key]
        fixed = {a: c for a, c in zip(self.axis_names, self.coord)
                 if a not in axes}
        return group, self._ranks(axes, fixed)

    # -- collectives (a group of one rank is the identity) -----------------
    def all_reduce(self, x: torch.Tensor, axis: AxisName,
                   op: str = "sum") -> torch.Tensor:
        """``x`` reduced over the ranks along ``axis`` (in place)."""
        if self.axis_size(axis) == 1:
            return x
        if not self.is_stand_in:
            group, _ = self._group(axis)
            dist.all_reduce(x, op={"sum": dist.ReduceOp.SUM,
                                   "max": dist.ReduceOp.MAX}[op],
                            group=group)
        return self._count("all-reduce", x)

    def all_gather(self, x: torch.Tensor, axis: AxisName, dim: int
                   ) -> torch.Tensor:
        """The shards along ``axis`` concatenated on ``dim``, in the axis
        tuple's row-major order."""
        n = self.axis_size(axis)
        if n == 1:
            return x
        if self.is_stand_in:
            shape = list(x.shape)
            shape[dim] *= n
            return self._count("all-gather", x.new_empty(shape))
        group, ranks = self._group(axis)
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        # all_gather fills by group rank (ascending global rank); put the
        # parts in the axis tuple's order
        by_rank = dict(zip(sorted(ranks), parts))
        return self._count("all-gather",
                           torch.cat([by_rank[r] for r in ranks], dim=dim))

    def reduce_scatter(self, x: torch.Tensor, axis: AxisName, dim: int
                       ) -> torch.Tensor:
        """``x`` summed over the ranks along ``axis``, this rank's chunk of
        ``dim`` (chunks in the axis tuple's row-major order), by
        ``reduce_scatter_tensor``; gloo on a CUDA tensor (not relied on
        there) all-reduces a copy and takes this rank's chunk."""
        n = self.axis_size(axis)
        if n == 1:
            return x
        if self.is_stand_in:
            return self._count("reduce-scatter", x.new_empty(
                x.chunk(n, dim)[self.index(axis)].shape))
        group, ranks = self._group(axis)
        if x.is_cuda and dist.get_backend(group) == "gloo":
            full = x.contiguous().clone()
            dist.all_reduce(full, group=group)
            return self._count("reduce-scatter", full.chunk(n, dim)[
                self.index(axis)].contiguous())
        # the group's chunk i goes to its i-th rank (ascending global
        # rank): order the axis chunks that way
        chunks = x.movedim(dim, 0).chunk(n, 0)
        pos = {r: i for i, r in enumerate(ranks)}
        src = torch.cat([chunks[pos[r]] for r in sorted(ranks)]).contiguous()
        out = torch.empty_like(chunks[0], memory_format=torch.contiguous_format)
        dist.reduce_scatter_tensor(out, src, group=group)
        return self._count("reduce-scatter", out.movedim(0, dim))

    def all_to_all(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Equal chunks of ``x``'s leading dim: chunk ``i`` goes to the
        rank at index ``i`` on ``axis``; the result's chunk ``i`` came
        from it."""
        if self.shape[axis] == 1:
            return x
        out = torch.empty_like(x)
        if not self.is_stand_in:
            group, _ = self._group(axis)
            dist.all_to_all_single(out, x.contiguous(), group=group)
        return self._count("all-to-all", out)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production shapes, no devices."""
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


def make_host_mesh(data: Optional[int] = None, model: int = 1) -> Mesh:
    """A (data, model) mesh over the live world (every rank of the
    initialized process group)."""
    n = dist.get_world_size()
    if data is None:
        data = n // model
    return Mesh((data, model), ("data", "model"), live=True)


def mesh_chip_count(mesh: Mesh) -> int:
    return mesh.size
