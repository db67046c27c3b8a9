"""Autograd-aware collectives over a process group: a replicated tensor's
slice along one dimension and its inverse, the all-gather.

JAX's ``shard_map`` moves between the replicated and the split layout
with exact transposes; here:

- ``slice_along``: this rank's slice of a tensor replicated over
  ``group``; its backward all-gathers the slices' gradients, so every
  rank holds the whole gradient of the replicated input;
- ``gather_along``: the all-gather of the ranks' slices into the
  replicated tensor; the cotangent of a replicated output is the same on
  every rank, so its backward takes this rank's slice (no reduction);
- ``replicated``: the identity on a tensor replicated over ``group`` whose
  ranks each consume a part of the batch; its backward sums the ranks'
  gradients (JAX's transpose of a replicated input under ``shard_map``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _gather(x, dim: int, group):
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _slice(x, dim: int, group):
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                         f"divide by the group's {n} ranks")
    return x.chunk(n, dim)[r].contiguous()


class _Slice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _slice(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.group), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.dim, ctx.group), None, None


def slice_along(x, dim: int, group):
    """This rank's slice of replicated ``x`` (None group: ``x``)."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    return _Slice.apply(x, dim, group)


def gather_along(x, dim: int, group):
    """The ranks' slices all-gathered along ``dim`` (None group: ``x``)."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    return _Gather.apply(x, dim, group)


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def replicated(x, group):
    """``x`` with its gradient summed over ``group`` (None group: ``x``)."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    return _SumGrad.apply(x, group)


def gather_batch(x):
    """Every rank's ``x`` concatenated along dim 0, in rank order, without
    gradient (the world group)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return x
    with torch.no_grad():
        return _gather(x, 0, None)
