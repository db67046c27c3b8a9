"""A training pipeline's mesh and the placement of its train state
(``shard_state`` / ``state_shardings`` of JAX ``pipelines/ctsd.py:520-537``).

``MeshPlacement`` is mixed into the port's training pipelines (CTSD, the
LiDAR tokenizers, MaskGIT, the LiDAR DiT/UNet). The mesh is the one given
(a ``MeshSpec``, its dict, or a mesh), else ``make_mesh()``: the one
device without a process group, so the single-process path is unchanged.
Over a process group ``shard_state`` applies the policy to the state's
model (``sharding.shard_model``: FSDP2, HSDP or DDP) and rebuilds its
optimizer over the sharded parameters, carrying its moments and the
schedule over, so the moments sit where their parameters do (ZeRO: each
moment is a DTensor placed like its parameter).

A distributed train step takes this data rank's slice of the global batch
(``sharding.shard_batch``). Its randoms are drawn for the whole global
batch from a generator that every rank seeds alike, and each rank keeps
its rows (``rank_draws``), as JAX draws over the global batch and then
shards the draws: so the step at any data-parallel size is the step of
one process on the global batch. Evaluation and preview draw their noise
the same way (``rank_draws``, ``rank_rows``), and the metrics' states are
merged over the data ranks (``collectives.reduce_metric_states``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from opendwm_tpu_torch.parallel.mesh import (
    MeshSpec,
    bind_sequence_parallel,
    make_mesh,
)
from opendwm_tpu_torch.parallel.sharding import (
    MIN_SHARD_SIZE,
    data_parallel_size,
    is_distributed,
    param_shardings,
    shard_batch,
    shard_model,
)


def resolve_mesh(mesh):
    """A pipeline's ``mesh`` argument → a mesh."""
    if mesh is None:
        return make_mesh()
    if isinstance(mesh, dict):
        mesh = MeshSpec(**mesh)
    if isinstance(mesh, MeshSpec):
        return make_mesh(mesh)
    return mesh


def fqns(model, optimizer) -> list:
    """The model's names of the optimizer's parameters, in its order."""
    names = {id(p): n for n, p in model.named_parameters()}
    return [names[id(p)] for g in optimizer.param_groups for p in g["params"]]


def optimizer_state_by_name(model, optimizer) -> dict:
    """``optimizer.state_dict()`` keyed by parameter name (the layout
    ``torch.distributed.checkpoint.state_dict`` reads as a full state)."""
    sd = optimizer.state_dict()
    names = fqns(model, optimizer)
    return {
        "state": {names[i]: st for i, st in sd["state"].items()},
        "param_groups": [{**g, "params": [names[i] for i in g["params"]]}
                         for g in sd["param_groups"]],
    }


def load_full_optimizer_state(model, optimizer, by_name: dict) -> None:
    """Load a full, name-keyed optimizer state into ``optimizer`` (sharded
    or not): each moment is placed like its parameter."""
    from torch.distributed.checkpoint.state_dict import (
        StateDictOptions,
        set_optimizer_state_dict,
    )

    if any(hasattr(p, "placements") for p in model.parameters()):
        set_optimizer_state_dict(
            model, optimizer, by_name,
            options=StateDictOptions(full_state_dict=True))
        return
    names = fqns(model, optimizer)
    index = {n: i for i, n in enumerate(names)}
    optimizer.load_state_dict({
        "state": {index[n]: st for n, st in by_name["state"].items()},
        "param_groups": [{**g, "params": [index[n] for n in g["params"]]}
                         for g in by_name["param_groups"]],
    })


def is_sharded(model) -> bool:
    return getattr(model, "_mesh_policy", None) is not None


class MeshPlacement:
    """The mesh, the sharding policy and the train-state placement of a
    training pipeline (needs ``training_config``, ``optimizer_config`` and
    ``lr_scheduler_config``)."""

    def _set_mesh(self, mesh, policy: str,
                  min_size: Optional[int] = None) -> None:
        if policy not in ("ddp", "fsdp", "hsdp"):
            raise ValueError(f"Unknown sharding policy {policy!r}.")
        self.mesh = mesh
        self.policy = policy
        self.sharding_min_size = MIN_SHARD_SIZE if min_size is None \
            else min_size

    @property
    def mesh(self):
        return self._mesh

    @mesh.setter
    def mesh(self, mesh) -> None:
        """The mesh (``resolve_mesh``); the model's ``sp_axis`` attentions
        are bound to its groups."""
        self._mesh = resolve_mesh(mesh)
        if getattr(self, "model", None) is not None:
            bind_sequence_parallel(self.model, self._mesh)

    @property
    def distributed(self) -> bool:
        return is_distributed(self.mesh)

    def rank_draws(self, draw, rows: int):
        """``draw(global_rows)``, the randoms of the whole global batch,
        then this data rank's slice of them: ``rows`` is the leading size
        of this rank's slice of the batch. One data rank: ``draw(rows)``."""
        n = data_parallel_size(self.mesh)
        if n == 1:
            return draw(rows)
        return shard_batch(draw(rows * n), self.mesh)

    def rank_rows(self, x, rows: int):
        """This data rank's rows of ``x``, a tensor of the whole global
        batch's rows (``rows``: the leading size of this rank's slice of
        the batch). One data rank: ``x``."""
        n = data_parallel_size(self.mesh)
        if x.shape[0] != rows * n:
            raise ValueError(
                f"a draw of {x.shape[0]} rows is not the global batch's "
                f"{rows * n} ({rows} a data rank over {n})")
        return x if n == 1 else shard_batch(x, self.mesh)

    def shard_state(self, state):
        """``state`` placed on the mesh under the policy (in place): its
        model sharded, its optimizer rebuilt over the sharded parameters
        with its moments and schedule carried over. Without a process group,
        or once placed, ``state`` as it is."""
        from opendwm_tpu_torch.pipelines import optim

        model = state.model
        if not self.distributed or is_sharded(model):
            return state
        if state.accumulator is not None and state.accumulator.acc is not None:
            raise ValueError("shard the train state before its first "
                             "accumulated step")
        moments = optimizer_state_by_name(model, state.optimizer) \
            if state.optimizer.state else None
        schedule = state.lr_scheduler.state_dict()
        shard_model(model, self.mesh, self.policy, self.sharding_min_size)
        model._mesh_policy = self.policy
        trainable, _ = optim.split_trainable(
            model, self.training_config.get("freezing_pattern"))
        state.optimizer, state.lr_scheduler = optim.build_optimizer(
            trainable, self.optimizer_config, self.lr_scheduler_config)
        state.lr_scheduler.load_state_dict(schedule)
        if moments is not None:
            load_full_optimizer_state(model, state.optimizer, moments)
        return state

    def state_shardings(self, state) -> dict:
        """Where each piece of ``state`` lies: ``step`` replicated (None);
        ``params`` {name: the sharded dimension or None}; ``opt_state``
        {name: {moment: dimension}}, each moment placed like its parameter
        (``sharding.param_shardings``' rule, as JAX's)."""
        params = param_shardings(state.model, self.mesh, self.policy,
                                 self.sharding_min_size)
        names = {id(p): n for n, p in state.model.named_parameters()}
        opt = {}
        for p, st in state.optimizer.state.items():
            name = names[id(p)]
            opt[name] = {k: params[name] for k, v in st.items()
                         if torch.is_tensor(v) and v.shape == p.shape}
        return {"step": None, "params": params, "opt_state": opt}

    def reduce_metrics(self, metrics: dict) -> dict:
        """Scalar metrics averaged over the ranks (each data rank's loss is
        the mean of its slice of the batch; ranks that share data count
        alike)."""
        if not self.distributed:
            return metrics
        out = {}
        world = dist.get_world_size()
        for k, v in metrics.items():
            if torch.is_tensor(v) and v.numel() == 1 and \
                    v.is_floating_point() and k != "grad_norm":
                v = v.detach().clone().float()
                dist.all_reduce(v)
                v = v / world
            out[k] = v
        return out
