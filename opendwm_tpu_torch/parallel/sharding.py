"""Parameter and batch sharding (``opendwm_tpu/parallel/sharding.py``).

The JAX package shards by declaration: ``param_shardings`` gives each
parameter a ``PartitionSpec`` that puts the **largest dimension that
divides** by the ``fsdp`` axis (ties to the first) over that axis, and jit
inserts the all-gathers and reduce-scatters. Here the same rule picks the
dimension (``fsdp_dim`` / ``tp_dim``), and FSDP2 does the collectives:

- ``"fsdp"`` / ``"hsdp"``: ``fully_shard`` with that dimension as each
  parameter's ``Shard``, over the ``fsdp`` axis, or over the 2-D
  (``dp``, ``fsdp``) mesh where ``dp`` > 1 (HSDP: replicated over ``dp``,
  sharded over ``fsdp``); the gradients are averaged over the data ranks,
  as the global-mean loss of the JAX step gives.
- ``"ddp"``: ``replicate`` (DDP) over the data ranks.

A model that names its repeated blocks (``fsdp_units()``, the DiT's joint
and branch blocks) gets one FSDP unit a block, so only one block's
parameters and gradients are whole at a time; the rest is the root unit.

Parameters that JAX replicates (fewer than ``MIN_SHARD_SIZE`` = 2^16
elements, or no dimension that divides) are still sharded by FSDP2, which
shards every parameter of a module it wraps: the port puts them on their
first dimension (FSDP2 pads a dimension that does not divide). This is a
memory layout only; every parameter is gathered whole before use, so the
results are those of the JAX layout.

``shard_batch`` gives each data rank its slice of every leaf's leading
axis; leaves whose leading axis does not divide by the data-parallel size
stay whole, as JAX replicates them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from opendwm_tpu_torch.parallel.mesh import (
    AXIS_DP,
    AXIS_FSDP,
    AXIS_TP,
    axis_rank,
    axis_size,
    submesh,
)

MIN_SHARD_SIZE = 2 ** 16  # JAX replicates tiny params (norms, biases)


def fsdp_dim(shape, fsdp_size: int,
             min_size: int = MIN_SHARD_SIZE) -> Optional[int]:
    """The dimension JAX's ``_fsdp_spec`` shards over ``fsdp``: the largest
    that divides by ``fsdp_size``, ties to the first; None where it
    replicates (one shard, fewer than ``min_size`` elements, none
    divides)."""
    if fsdp_size <= 1 or math.prod(shape) < min_size:
        return None
    candidates = [(d, i) for i, d in enumerate(shape) if d % fsdp_size == 0]
    if not candidates:
        return None
    return max(candidates, key=lambda t: (t[0], -t[1]))[1]


def tp_dim(shape, tp_size: int) -> Optional[int]:
    """JAX's ``_tp_spec``: the last dimension that divides by ``tp_size``,
    None where it replicates."""
    if tp_size <= 1 or math.prod(shape) < MIN_SHARD_SIZE:
        return None
    for i in reversed(range(len(shape))):
        if shape[i] % tp_size == 0:
            return i
    return None


def _named_shapes(params) -> dict:
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    return {name: tuple(getattr(p, "shape", p)) for name, p in params.items()}


def param_shardings(params, mesh, policy: str = "fsdp",
                    min_shard_size: int = MIN_SHARD_SIZE) -> dict:
    """{name: the sharded dimension or None} of a module's parameters (or a
    {name: tensor or shape} dict) under ``policy``, as JAX's
    ``param_shardings`` places them."""
    shapes = _named_shapes(params)
    if policy == "ddp":
        return {name: None for name in shapes}
    if policy in ("fsdp", "hsdp"):
        size = axis_size(mesh, AXIS_FSDP)
        return {name: fsdp_dim(s, size, min_shard_size)
                for name, s in shapes.items()}
    if policy == "tp":
        size = axis_size(mesh, AXIS_TP)
        return {name: tp_dim(s, size) for name, s in shapes.items()}
    raise ValueError(f"Unknown sharding policy {policy!r}.")


def data_parallel_size(mesh) -> int:
    return axis_size(mesh, AXIS_DP) * axis_size(mesh, AXIS_FSDP)


def data_rank(mesh) -> int:
    """This rank's index among the data ranks ((dp, fsdp) row-major)."""
    return axis_rank(mesh, AXIS_DP) * axis_size(mesh, AXIS_FSDP) + \
        axis_rank(mesh, AXIS_FSDP)


def data_group(mesh):
    """The process group of the data ranks, its ranks in ``data_rank``
    order: the (dp, fsdp) axes flattened (a group of one where both have
    one member, as on a (tp) or (pp) mesh)."""
    sub = submesh(mesh, (AXIS_DP, AXIS_FSDP))
    return (sub._flatten() if sub.ndim > 1 else sub).get_group()


def is_distributed(mesh) -> bool:
    """Whether ``mesh`` lies over a process group (any world size)."""
    from opendwm_tpu_torch.parallel.mesh import SingleDeviceMesh

    return mesh is not None and not isinstance(mesh, SingleDeviceMesh)


def shard_model(model: torch.nn.Module, mesh, policy: str = "fsdp",
                min_shard_size: int = MIN_SHARD_SIZE) -> torch.nn.Module:
    """Apply ``policy`` to ``model`` in place over ``mesh``'s data axes:
    ``fully_shard`` (FSDP, HSDP) or ``replicate`` (DDP); returns it. A
    mesh without a process group leaves the model as it is."""
    if policy not in ("ddp", "fsdp", "hsdp"):
        raise ValueError(f"Unknown sharding policy {policy!r} (the tp "
                         "policy places parameters only, param_shardings; "
                         "the port runs tp as the ring)")
    if not is_distributed(mesh):
        return model
    data_mesh = submesh(mesh, (AXIS_DP, AXIS_FSDP))
    if policy == "ddp":
        from torch.distributed._composable import replicate

        return replicate(model, device_mesh=data_mesh)
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    size = axis_size(mesh, AXIS_FSDP)

    def placement(p):
        dim = fsdp_dim(tuple(p.shape), size, min_shard_size)
        return Shard(0 if dim is None else dim)

    # one FSDP unit per block the model names (its parameters gathered for
    # that block's forward and backward alone), then the rest
    units = model.fsdp_units() if hasattr(model, "fsdp_units") else []
    for unit in units:
        fully_shard(unit, mesh=data_mesh, shard_placement_fn=placement)
    fully_shard(model, mesh=data_mesh, shard_placement_fn=placement)
    return model


def _slice(x, n: int, rank: int):
    if isinstance(x, dict):
        return {k: _slice(v, n, rank) for k, v in x.items()}
    if isinstance(x, (list, tuple)) and not hasattr(x, "shape"):
        return type(x)(_slice(v, n, rank) for v in x)
    shape = getattr(x, "shape", None)
    if shape is None or len(shape) == 0 or shape[0] % n:
        return x
    step = shape[0] // n
    return x[rank * step:(rank + 1) * step]


def shard_batch(batch, mesh):
    """This data rank's slice of the leading axis of every array leaf
    (tensors and numpy arrays, in nested dicts, lists and tuples); leaves
    whose leading axis does not divide by the data-parallel size, scalars
    and other values stay whole."""
    n = data_parallel_size(mesh)
    if n == 1:
        return batch
    return _slice(batch, n, data_rank(mesh))


def local(t):
    """The local shard of a DTensor; any other tensor as it is."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t
