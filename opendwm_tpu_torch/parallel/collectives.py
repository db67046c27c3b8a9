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

``reduce_metric_states`` brings evaluation metrics to the global batch's
state: JAX keeps its arrays global, so its metrics see every row; here
each data rank updates its metrics with its rows, and the states of the
data ranks are gathered and merged (each metric's ``merge``) before
``compute``. It runs whenever the mesh lies over a process group, at
world size 1 too, over the data ranks only: ranks that share rows over a
``tp`` or ``pp`` axis hold the same rows and are not counted twice.
``collective_counts`` counts the collectives it issued, by backend.
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist

from opendwm_tpu_torch.parallel.sharding import data_group, is_distributed

_COLLECTIVES: collections.Counter = collections.Counter()


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


def collective_counts() -> dict:
    """{"<backend>:<collective>": calls} issued by ``reduce_metric_states``
    since the last ``reset_collective_counts``."""
    return dict(_COLLECTIVES)


def reset_collective_counts() -> None:
    _COLLECTIVES.clear()


def _issued(group, name: str) -> None:
    _COLLECTIVES[f"{dist.get_backend(group)}:{name}"] += 1


def gather_states(state: dict, group) -> list:
    """Every rank's ``state`` (a metric's ``state_dict()``) over ``group``,
    in group-rank order: its tensors by one ``all_gather`` a dtype (on the
    card under NCCL), the host leaves (numbers, arrays, per-sample lists)
    by one ``all_gather_object``."""
    n = dist.get_world_size(group)
    device = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend(group) == "nccl" else torch.device("cpu")
    tensors = {k: v for k, v in state.items() if isinstance(v, torch.Tensor)}
    out = [dict() for _ in range(n)]
    by_dtype: dict = {}
    for k, v in tensors.items():
        by_dtype.setdefault(v.dtype, []).append(k)
    for dtype, keys in by_dtype.items():
        flat = torch.cat([tensors[k].detach().reshape(-1).to(device)
                          for k in keys])
        parts = [torch.empty_like(flat) for _ in range(n)]
        dist.all_gather(parts, flat, group=group)
        _issued(group, "all_gather")
        for r, part in enumerate(parts):
            for k, piece in zip(keys, part.split(
                    [tensors[k].numel() for k in keys])):
                out[r][k] = piece.view(tensors[k].shape)
    host = {k: v for k, v in state.items() if k not in tensors}
    if host:
        objects = [None] * n
        dist.all_gather_object(objects, host, group=group)
        _issued(group, "all_gather_object")
        for r, obj in enumerate(objects):
            out[r].update(obj)
    return [{k: o[k] for k in state} for o in out]


def reduce_metric_states(metrics: dict, mesh, batches: int = 1) -> dict:
    """Each metric of ``metrics`` merged, in place, with the states of the
    other data ranks of ``mesh`` (``gather_states`` over
    ``sharding.data_group``, then the metric's ``merge``), so that its
    ``compute`` gives the global batch's score on every rank; ``batches``
    is the number of batches each rank updated with its rows of. Without
    a process group, ``metrics`` as they are. Returns ``metrics``."""
    if not is_distributed(mesh):
        return metrics
    group = data_group(mesh)
    for metric in metrics.values():
        metric.merge(gather_states(metric.state_dict(), group), batches)
    return metrics
