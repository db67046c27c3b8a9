"""Point-cloud voxelization (``opendwm_tpu/ops/voxelize.py``), in PyTorch.

LiDAR points → a binary occupancy grid ``(D, H, W)`` (z bins, y, x). As in
the JAX package the points arrive padded to a fixed N with a validity mask;
each point's floor index goes into a flat grid with one dump cell at
``D·H·W`` for masked and out-of-range points, and one ``scatter_reduce_``
(``"amax"``) per batch writes the flags, as the JAX ``.at[].max`` does.

The offsets are divided by the steps as tensors on the points' device: on
the card PyTorch turns a division by a Python number into a product with
its reciprocal, which at a step such as 0.15625 moves the floor of a
quotient just below an integer up by one voxel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from opendwm_tpu_torch.config import register


@register("Voxelizer", aliases=("dwm.models.voxelizer.Voxelizer",))
@dataclasses.dataclass(frozen=True)
class Voxelizer:
    x_min: float
    x_max: float
    y_min: float
    y_max: float
    step: float
    z_min: float
    z_max: float
    z_step: float

    @property
    def width(self) -> int:
        return round((self.x_max - self.x_min) / self.step)

    @property
    def height(self) -> int:
        return round((self.y_max - self.y_min) / self.step)

    @property
    def depth(self) -> int:
        return round((self.z_max - self.z_min) / self.z_step)

    @property
    def grid_shape(self) -> tuple[int, int, int]:
        return (self.depth, self.height, self.width)

    def __call__(self, points: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
        """points: (..., N, 3+) xyz[+extras]; mask: (..., N) valid flags.
        Returns (..., D, H, W) float32 occupancy."""
        lead = points.shape[:-2]
        pts = points.reshape(-1, *points.shape[-2:]).float()
        msk = mask.reshape(-1, mask.shape[-1])

        def index(axis: int, lo: float, step: float) -> torch.Tensor:
            step = torch.full((), step, device=pts.device)
            return torch.floor((pts[..., axis] - lo) / step).to(torch.int32)

        iw = index(0, self.x_min, self.step)
        ih = index(1, self.y_min, self.step)
        id_ = index(2, self.z_min, self.z_step)
        d, h, w = self.grid_shape
        valid = (msk.bool() & (iw >= 0) & (iw < w) & (ih >= 0) & (ih < h)
                 & (id_ >= 0) & (id_ < d))
        flat = torch.where(valid, (id_.long() * h + ih) * w + iw,
                           d * h * w)
        grid = torch.zeros(flat.shape[0], d * h * w + 1,
                           dtype=torch.float32, device=points.device)
        grid.scatter_reduce_(1, flat, valid.float(), "amax")
        return grid[:, :-1].reshape(*lead, d, h, w)

    def voxel_coordinates(self, downsample_scale: int = 1,
                          device=None) -> torch.Tensor:
        """World xyz of voxel centers, shaped (D, H, W, 3) (reference
        ``get_voxel_coordinates``). The axes come from numpy's fp32
        ``arange``, as ``jnp.arange`` makes them (torch's differs in the
        last bit)."""

        def centers(lo, hi, step):
            axis = np.arange(lo, hi, step / downsample_scale,
                             dtype=np.float32) + np.float32(step / 2)
            return torch.from_numpy(axis).to(device)

        xs = centers(self.x_min, self.x_max, self.step)
        ys = centers(self.y_min, self.y_max, self.step)
        zs = centers(self.z_min, self.z_max, self.z_step)
        zg, yg, xg = torch.meshgrid(zs, ys, xs, indexing="ij")
        return torch.stack([xg, yg, zg], dim=-1)


def voxels_to_points(voxels: torch.Tensor, voxelizer: Voxelizer):
    """Every voxel center with its occupancy as the mask (the static-shape
    voxel → point conversion of the JAX package): ((..., D·H·W, 3) points,
    (..., D·H·W) bool)."""
    flat = voxelizer.voxel_coordinates(device=voxels.device).reshape(-1, 3)
    lead = voxels.shape[:-3]
    occ = voxels.reshape(*lead, -1)
    return flat.expand(*lead, *flat.shape), occ > 0.5
