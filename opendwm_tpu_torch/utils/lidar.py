"""LiDAR frame transforms (``opendwm_tpu/utils/lidar.py``), in PyTorch."""

from __future__ import annotations

from typing import Optional

import torch


def transform_points(points: torch.Tensor,
                     transform: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 transform (..., 4, 4) to (..., N, 3) points."""
    rot = transform[..., :3, :3]
    trans = transform[..., :3, 3]
    return points @ rot.transpose(-1, -2) + trans[..., None, :]


def preprocess_points(points: torch.Tensor,
                      lidar_transforms: Optional[torch.Tensor] = None):
    """LiDAR-frame points → the ego frame by the per-frame
    ``lidar_transforms`` (..., 4, 4); unchanged without them."""
    if lidar_transforms is None:
        return points
    return transform_points(points, lidar_transforms)


def postprocess_points(points: torch.Tensor,
                       lidar_transforms: Optional[torch.Tensor] = None):
    """Ego-frame points → the LiDAR frame (``preprocess_points``'s
    inverse)."""
    if lidar_transforms is None:
        return points
    return transform_points(points, torch.linalg.inv(lidar_transforms))
