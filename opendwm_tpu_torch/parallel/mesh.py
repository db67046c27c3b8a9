"""Device meshes over ``torch.distributed`` (``opendwm_tpu/parallel/mesh.py``).

The JAX package builds one declarative mesh with the axes

    ("dp", "fsdp", "tp"[, "pp"])

over its devices; DDP is (dp=N, fsdp=1), FSDP (dp=1, fsdp=N), HSDP
(dp=A, fsdp=B), and sequence parallelism rides the ``tp`` axis. Here the
same shape becomes a ``torch.distributed.device_mesh.DeviceMesh`` over the
initialised process group, with the same axis names in the same order (the
innermost axes are the neighbouring ranks). Without a process group the
mesh is the one device (``SingleDeviceMesh``), as JAX's default mesh is on
one chip: every axis has size 1 and no group.

The process group's backend follows the device: NCCL for CUDA tensors,
gloo for CPU tensors (``init_from_env``); it is never switched after a
failure.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
from typing import Optional

import torch
import torch.distributed as dist

from opendwm_tpu_torch.config import register

AXIS_DP = "dp"
AXIS_FSDP = "fsdp"
AXIS_TP = "tp"
AXIS_PP = "pp"
AXES = (AXIS_DP, AXIS_FSDP, AXIS_TP)


@register("MeshSpec",
          aliases=("torch.distributed.device_mesh.init_device_mesh",))
@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh shape; -1 on at most one axis means "all remaining"."""

    dp: int = 1
    fsdp: int = -1
    tp: int = 1
    pp: int = 1  # pipeline stages (parallel/pipeline.py); axis added when >1

    def resolve(self, n_devices: int) -> tuple[int, ...]:
        dims = [self.dp, self.fsdp, self.tp] + (
            [self.pp] if self.pp != 1 else [])
        unknown = [i for i, d in enumerate(dims) if d == -1]
        if len(unknown) > 1:
            raise ValueError("At most one mesh axis may be -1.")
        known = math.prod(d for d in dims if d != -1)
        if unknown:
            if n_devices % known != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes {known}.")
            dims[unknown[0]] = n_devices // known
        if math.prod(dims) != n_devices:
            raise ValueError(
                f"Mesh {tuple(dims)} does not cover {n_devices} devices.")
        return tuple(dims)


class SingleDeviceMesh:
    """The mesh of one process without a process group: every axis of
    ``mesh_dim_names`` has size 1, rank 0 and no group."""

    def __init__(self, mesh_dim_names: tuple[str, ...] = AXES):
        self.mesh_dim_names = tuple(mesh_dim_names)

    @property
    def shape(self) -> tuple[int, ...]:
        return (1,) * len(self.mesh_dim_names)

    def size(self, mesh_dim=None) -> int:
        return 1

    def get_group(self, mesh_dim=None):
        return None

    def get_local_rank(self, mesh_dim=None) -> int:
        return 0

    def __repr__(self) -> str:
        return f"SingleDeviceMesh({self.mesh_dim_names})"


def axes_of(shape: tuple[int, ...]) -> tuple[str, ...]:
    return AXES + ((AXIS_PP,) if len(shape) == 4 else ())


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def default_device_type() -> str:
    """``cuda`` under an NCCL group, else ``cpu``."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return "cuda"
    return "cpu"


def make_mesh(spec: MeshSpec | None = None, device_type: Optional[str] = None):
    """The (dp, fsdp, tp[, pp]) mesh over every rank of the process group,
    or the ``SingleDeviceMesh`` without one."""
    spec = spec or MeshSpec()
    shape = spec.resolve(world_size())
    axes = axes_of(shape)
    if not dist.is_initialized():
        return SingleDeviceMesh(axes)
    from torch.distributed.device_mesh import init_device_mesh

    with torch.device("cpu"):  # its rank table, also under a meta default
        return init_device_mesh(device_type or default_device_type(), shape,
                                mesh_dim_names=axes)


def policy_spec(policy: str, n: int) -> MeshSpec:
    """The mesh shape of a ``distribution_framework`` value over n devices
    (JAX's ``mesh_for_policy``: HSDP splits n into (dp, fsdp) with fsdp the
    power of two at or above sqrt(n) that divides it)."""
    if policy == "ddp":
        return MeshSpec(dp=-1, fsdp=1, tp=1)
    if policy == "fsdp":
        return MeshSpec(dp=1, fsdp=-1, tp=1)
    if policy == "hsdp":
        f = 1
        while f * f <= n:
            f *= 2
        f = min(f, n)
        while n % f:
            f //= 2
        return MeshSpec(dp=n // f, fsdp=f, tp=1)
    raise ValueError(f"Unknown mesh policy {policy!r}.")


def mesh_for_policy(policy: str, device_type: Optional[str] = None):
    """Mesh presets named after the reference's distribution_framework."""
    return make_mesh(policy_spec(policy, world_size()), device_type)


def axis_size(mesh, axis: str) -> int:
    """The size of ``axis`` (1 where the mesh lacks it)."""
    if mesh is None or axis not in mesh.mesh_dim_names:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh, axis: str) -> int:
    if axis_size(mesh, axis) == 1:
        return 0
    return mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    """The process group of ``axis``, None where it has one member."""
    if axis_size(mesh, axis) == 1:
        return None
    return mesh.get_group(axis)


def submesh(mesh, axes: tuple[str, ...]):
    """The ``DeviceMesh`` over ``axes`` (those of size 1 dropped, at least
    one kept)."""
    keep = tuple(a for a in axes if axis_size(mesh, a) > 1) or axes[-1:]
    return mesh[keep if len(keep) > 1 else keep[0]]


def bind_sequence_parallel(module, mesh) -> None:
    """Give every submodule of ``module`` that names an ``sp_axis`` the
    process group of that axis on ``mesh`` as its ``sp_group`` (None where
    the axis has one member: a ring of one rank). Groups are resolved
    here, once, and not per call."""
    for m in module.modules():
        if getattr(m, "sp_axis", None) is not None:
            m.sp_group = axis_group(mesh, m.sp_axis)


def is_launched() -> bool:
    """Whether the process was started by ``torchrun`` (RANK and WORLD_SIZE
    set)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init_from_env(device: torch.device) -> int:
    """Under ``torchrun``: initialise the default process group from its
    environment, NCCL for a CUDA device (bound to LOCAL_RANK) and gloo for
    the CPU; returns the rank. Without ``torchrun``: nothing, 0."""
    if not is_launched():
        return 0
    if not dist.is_initialized():
        if device.type == "cuda":
            local = int(os.environ.get("LOCAL_RANK", 0))
            torch.cuda.set_device(local)
            dist.init_process_group(
                "nccl", device_id=torch.device("cuda", local),
                timeout=datetime.timedelta(minutes=10))
        else:
            dist.init_process_group("gloo")
    return dist.get_rank()
