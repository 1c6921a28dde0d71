"""Autograd-aware collectives over a live :class:`Mesh`'s axes.

The reference has no such module: its partitioner emits the collectives
of the sharded step and differentiates through them.  The port's
sharded training step writes them out, so each is a
``torch.autograd.Function`` whose backward is the collective's adjoint
under the step's two conventions:

* over ``model`` (tensor parallel, Megatron's): a tensor replicated
  over the axis carries its WHOLE gradient on every rank; a split
  tensor carries the gradient of its own part;
* over the batch axes (data parallel): each rank differentiates the loss
  of its own rows, the gradients are summed over the ranks and divided
  by the width once (``ParamShards.grad_mean``).

The operations (each the identity on a group of one rank, so a
single-device path stays bit for bit as it was):

==================  ===========================  ========================
                    forward                      backward
==================  ===========================  ========================
``enter``           identity                     all-reduce (sum)
``reduce``          all-reduce (sum)             identity
``gather``          all-gather                   this rank's chunk
``split``           this rank's chunk            all-gather
``reduce_scatter``  reduce-scatter (sum)         all-gather
``gather_sum``      all-gather                   reduce-scatter (sum)
``sum``             all-reduce (sum)             all-reduce (sum)
``all_to_all``      all-to-all                   all-to-all
``max``             all-reduce (max), no grad
``argmax``          the split argmax, no grad
==================  ===========================  ========================

``gather_sum`` is the FSDP gather of a weight (and the sequence-
parallel gather into split compute): every rank's gradient of the whole
leaf is a partial sum.  ``sum`` is a statistic over the batch axes that
every rank's loss reads (the MoE load-balance loss).  ``Mesh``'s own
``all_reduce`` / ``all_gather`` stay in place and autograd-blind.
"""
from __future__ import annotations

import torch

from repro_torch.launch.mesh import AxisName, Mesh
from repro_torch.models.hooks import LocalAxis


def _chunk(mesh: Mesh, axis: AxisName, x: torch.Tensor, dim: int
           ) -> torch.Tensor:
    n = mesh.axis_size(axis)
    return x.chunk(n, dim)[mesh.index(axis)].contiguous()


def _all_reduce(mesh: Mesh, axis: AxisName, x: torch.Tensor,
                op: str = "sum") -> torch.Tensor:
    return mesh.all_reduce(x.contiguous().clone(), axis, op)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(ctx.mesh, ctx.axis, g), None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _all_reduce(mesh, axis, x)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _all_reduce(mesh, axis, x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(ctx.mesh, ctx.axis, g), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return mesh.all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _chunk(ctx.mesh, ctx.axis, g, ctx.dim), None, None, None


class _GatherSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return mesh.all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh.reduce_scatter(g, ctx.axis, ctx.dim), None, None,
                None)


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _chunk(mesh, axis, x, dim)

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh.all_gather(g, ctx.axis, ctx.dim), None, None,
                None)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return mesh.reduce_scatter(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh.all_gather(g, ctx.axis, ctx.dim), None, None,
                None)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.all_to_all(x, axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_to_all(g, ctx.axis), None, None


class AxisGroup(LocalAxis):
    """The collectives of the table above over ``axis`` (a name or a
    tuple of names) of a live ``mesh``.  ``seq`` marks the model axis of
    a sequence-parallel step: the residual stream's S splits over it
    (``LocalAxis.seq_in`` / ``seq_out``)."""

    def __init__(self, mesh: Mesh, axis: AxisName, *, seq: bool = False):
        if mesh.coord is None:
            raise ValueError("collectives need a live mesh")
        self.mesh, self.axis = mesh, axis
        self.size = mesh.axis_size(axis)
        self.index = mesh.index(axis)
        self.seq = seq and self.size > 1

    def __repr__(self) -> str:
        return f"AxisGroup({self.axis}, size={self.size}, seq={self.seq})"

    def whole_seq(self):
        return AxisGroup(self.mesh, self.axis) if self.seq else self

    def _one(self) -> bool:
        return self.size == 1

    def enter(self, x):
        return x if self._one() else _Enter.apply(x, self.mesh, self.axis)

    def reduce(self, x):
        return x if self._one() else _Reduce.apply(x, self.mesh, self.axis)

    def sum(self, x):
        return x if self._one() else _Sum.apply(x, self.mesh, self.axis)

    def gather(self, x, dim: int):
        return x if self._one() else _Gather.apply(x, self.mesh, self.axis,
                                                   dim % x.dim())

    def gather_sum(self, x, dim: int):
        return x if self._one() else _GatherSum.apply(
            x, self.mesh, self.axis, dim % x.dim())

    def split(self, x, dim: int):
        return x if self._one() else _Split.apply(x, self.mesh, self.axis,
                                                  dim % x.dim())

    def reduce_scatter(self, x, dim: int):
        return x if self._one() else _ReduceScatter.apply(
            x, self.mesh, self.axis, dim % x.dim())

    def all_to_all(self, x):
        return x if self._one() else _AllToAll.apply(x, self.mesh,
                                                     self.axis)

    @torch.no_grad()
    def max(self, x):
        return x if self._one() else _all_reduce(self.mesh, self.axis, x,
                                                 "max")

    @torch.no_grad()
    def argmax(self, x):
        """The global index of the largest entry of the last dimension,
        split over the axis (this rank's ids ``[index * n, (index + 1) *
        n)``): every rank's maximum and its id are gathered, and ties go
        to the lowest global id, as ``torch.argmax``'s (each rank's
        argmax is its first maximum; the gathered shards are in id
        order)."""
        # cp: allow(CP002) each shard's first maximum: the sampler's rule
        idx = x.argmax(-1)
        if self._one():
            return idx
        val = x.gather(-1, idx[..., None])[..., 0].float()
        gid = (idx + self.index * x.shape[-1]).float()   # exact below 2**24
        both = self.mesh.all_gather(torch.stack([val, gid])[None],
                                    self.axis, 0)        # [size, 2, ...]
        # cp: allow(CP002) the first (lowest-id) shard's maximum wins a tie
        best = both[:, 0].argmax(0, keepdim=True)
        return both[:, 1].gather(0, best)[0].long()
