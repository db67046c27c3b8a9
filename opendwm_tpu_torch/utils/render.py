"""Ray and projection helpers (``opendwm_tpu/utils/render.py``), in
PyTorch; ``get_rays`` is the DiT's (``models/mmdit.py``)."""

from __future__ import annotations

import torch

from opendwm_tpu_torch.models.mmdit import get_rays  # noqa: F401


def project_points_to_image(points: torch.Tensor,
                            camera_intrinsics: torch.Tensor,
                            camera_from_world: torch.Tensor) -> tuple:
    """Points (..., N, 3) → (pixel coords (..., N, 2), depth (..., N), in
    front (depth > 1e-3)) through ``camera_from_world`` (..., 4, 4) and
    ``camera_intrinsics`` (..., 3, 3)."""
    pts_h = torch.cat([points, torch.ones_like(points[..., :1])], -1)
    cam = torch.einsum("...ij,...nj->...ni", camera_from_world,
                       pts_h)[..., :3]
    z = cam[..., 2]
    uvw = torch.einsum("...ij,...nj->...ni", camera_intrinsics, cam)
    uv = uvw[..., :2] / uvw[..., 2:3].clamp(min=1e-6)
    return uv, z, z > 1e-3


def rays_for_pixels(camera_intrinsics: torch.Tensor,
                    camera_to_world: torch.Tensor,
                    pixels: torch.Tensor) -> tuple:
    """World-space rays through the centres of ``pixels`` (N, 2): (the
    origin (3,), unit directions (N, 3))."""
    ones = torch.ones_like(pixels[:, :1])
    pix_h = torch.cat([pixels + 0.5, ones], -1)
    dirs = torch.linalg.inv(camera_intrinsics) @ pix_h.T
    world = camera_to_world[:3, :3] @ dirs
    world = world / torch.linalg.norm(world, dim=0, keepdim=True)
    return camera_to_world[:3, 3], world.T
