"""Voxel occupancy metrics (``opendwm_tpu/metrics/voxel_metrics.py``): the
counts on the grids' device, the per-sample values on the host."""

from __future__ import annotations

import numpy as np
import torch

from opendwm_tpu_torch.config import register
from opendwm_tpu_torch.metrics.general import merge_states


def _grids(gt_voxel, pred_voxel):
    gt = torch.as_tensor(gt_voxel).bool()
    pred = torch.as_tensor(pred_voxel).to(gt.device).bool()
    if gt.ndim == 3:
        gt, pred = gt[None], pred[None]
    return gt, pred


@register("VoxelIoU", aliases=("dwm.metrics.voxel_metrics.VoxelIoU",))
class VoxelIoU:
    """Per-sample intersection over union of occupancy; an empty union is
    NaN, counted as 0 over the finite samples."""

    def __init__(self):
        self.values: list[float] = []

    def update(self, gt_voxel, pred_voxel):
        gt, pred = _grids(gt_voxel, pred_voxel)
        inter = (gt & pred).sum((-3, -2, -1)).reshape(-1).tolist()
        union = (gt | pred).sum((-3, -2, -1)).reshape(-1).tolist()
        for i, u in zip(inter, union):
            self.values.append(float(i) / float(u) if u > 0 else float("nan"))

    def compute(self) -> float:
        vals = np.asarray(self.values)
        finite = np.isfinite(vals)
        return float(np.nan_to_num(vals, nan=0.0).sum() / finite.sum())

    def reset(self):
        self.values.clear()

    def state_dict(self) -> dict:
        return {"values": list(self.values)}

    def merge(self, states: list, batches: int = 1) -> None:
        """The per-sample values of every rank in the one-process order
        (``merge_states``)."""
        self.values = merge_states(states, batches)["values"]


@register("VoxelDiff", aliases=("dwm.metrics.voxel_metrics.VoxelDiff",))
class VoxelDiff:
    """The mean per-sample count of voxels that differ."""

    def __init__(self):
        self.values: list[float] = []

    def update(self, gt_voxel, pred_voxel):
        gt, pred = _grids(gt_voxel, pred_voxel)
        diff = (gt ^ pred).sum((-3, -2, -1)).reshape(-1).tolist()
        self.values.extend(float(x) for x in diff)

    def compute(self) -> float:
        return float(np.mean(self.values))

    def reset(self):
        self.values.clear()

    def state_dict(self) -> dict:
        return {"values": list(self.values)}

    def merge(self, states: list, batches: int = 1) -> None:
        """The per-sample values of every rank in the one-process order
        (``merge_states``)."""
        self.values = merge_states(states, batches)["values"]
