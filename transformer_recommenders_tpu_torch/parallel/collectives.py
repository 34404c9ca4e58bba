"""Collectives over a mesh axis that autograd differentiates through.

JAX differentiates through ``shard_map``'s collectives by their transposes
(``parallel/train.py``, ``check_vma=False``): a ``psum`` transposes to a
``psum`` of the cotangent, a tiled ``all_gather`` to a ``psum_scatter``.
These functions give the same backward passes over ``torch.distributed``,
on NCCL and on gloo alike (each is one code path whatever the backend):

- :func:`psum`: an all-reduce (sum) over the axis, forward and backward;
- :func:`all_gather`: the ranks' blocks concatenated along dim 0, in
  coordinate order; backward, the reduce-scatter of the cotangent (rank
  ``i`` gets the sum over ranks of block ``i``).

So a loss replicated over N ranks, differentiated on every rank with a
cotangent of ``1 / N``, and its parameter gradients then summed over the
mesh, gives the gradient of the one-device loss: the scheme of
``parallel/train.py``.  ``reduce`` and ``gather`` are the same
collectives for tensors that take no gradient (counts, logs, results).
Each call is a collective: every rank of the axis's group must make it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# the names of torch's single-tensor collectives changed across versions
_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter_single = (getattr(dist, "reduce_scatter_single", None)
                          or dist.reduce_scatter_tensor)


def reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """All-reduce of a copy of ``x`` over ``group`` (no gradient)."""
    out = x.detach().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def gather(x: torch.Tensor, group) -> torch.Tensor:
    """The group's ``x`` concatenated along dim 0 in rank order (no
    gradient).  Bool tensors travel as uint8."""
    x = x.detach().contiguous()
    as_bool = x.dtype == torch.bool
    if as_bool:
        x = x.to(torch.uint8)
    n = dist.get_world_size(group)
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    _all_gather_single(out, x, group=group)
    return out.bool() if as_bool else out


def _reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    x = x.contiguous()
    out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
    _reduce_scatter_single(out, x, group=group)
    return out


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return reduce(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group), None


def psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Sum of ``x`` over ``axis`` of ``mesh``, on every rank of the axis;
    its backward sums the cotangent over the axis (JAX's ``psum``)."""
    return _PSum.apply(x, mesh.group(axis))


def all_gather(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The blocks ``x`` of ``axis``'s ranks concatenated along dim 0 in
    coordinate order; its backward reduce-scatters the cotangent (JAX's
    ``all_gather(..., tiled=True)``)."""
    return _AllGather.apply(x, mesh.group(axis))
