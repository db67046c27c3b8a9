"""Depth supervision of the joint image + LiDAR line (HoloDrive)
(``opendwm_tpu/pipelines/depth_loss.py``), in PyTorch.

LiDAR points are projected into every camera with intrinsics normalised
to the unit image square, binned along the frustum depth range, and
supervise the depth net's per-pixel bin logits with cross entropy at the
projected pixels. Points arrive padded with a mask (a fixed N), so the
projection, the gather and the cross entropy run over all of
``(b, t, v, N)`` at once, as in the JAX package.

The geometry runs in fp32 and gives the same bins and pixels on the card
as on the host, bit for bit: the 4 x 4 solve (a handful of matrices) runs
on the host, and every product of matrices and points is a sum of
elementwise products in a fixed order, where a library GEMM sums in an
order of its own on each device (and may round through TF32). The bins are
``round((z - min) / interval)``, a division by a tensor (a division by a
Python float may become a product with its fp32 reciprocal on the card,
which moves a point on a bin's edge), rounded half to even as
``jnp.round``; pixel indices truncate to int32 as the JAX ``astype``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` over the last two axes as elementwise products summed in
    order, the same bits on every device."""
    out = a[..., :, :1] * b[..., :1, :]
    for j in range(1, a.shape[-1]):
        out = out + a[..., :, j:j + 1] * b[..., j:j + 1, :]
    return out


def normalized_intrinsics(camera_intrinsics: torch.Tensor,
                          image_size: torch.Tensor) -> torch.Tensor:
    """Pixel intrinsics scaled to the unit image square, row by row:
    ``[fx/w 0 cx/w; 0 fy/h cy/h; 0 0 1]`` for ``[fx 0 cx; 0 fy cy; 0 0
    1]``; ``image_size`` (..., 2) is (w, h)."""
    w, h = image_size[..., 0], image_size[..., 1]
    one = torch.ones_like(w)
    scale = torch.stack([1.0 / w, one, 1.0 / w, one, 1.0 / h, 1.0 / h,
                         one, one, one], -1).reshape(*w.shape, 3, 3)
    return camera_intrinsics * scale


def frustum_indices(depth_features_shape: tuple, batch: dict,
                    depth_frustum_range) -> tuple:
    """The projection of ``make_depth_loss``: (bins, flat pixel indices,
    validity), each ``(b, t, v, N)``: the bin of each point in each camera
    (int64, not clipped), the row-major pixel of the ``(Hf, Wf)`` logits
    grid it lands on, and whether it supervises (a valid point, in front,
    inside the image, in the bin range)."""
    b, t, v, hf, wf, bins = depth_features_shape
    points = batch["lidar_points"][..., :3].float()
    dev = points.device
    k = normalized_intrinsics(batch["camera_intrinsics"].float(),
                              batch["image_size"].float())
    k_h = torch.zeros(b, t, v, 4, 4, device=dev)
    k_h[..., :3, :3] = k
    k_h[..., 3, 3] = 1.0
    ego = batch["ego_transforms"].float()
    lidar = batch.get("lidar_transforms")
    lidar = torch.eye(4, device=dev).expand(b, t, 1, 4, 4) \
        if lidar is None else lidar.float()
    cam_world = _matmul(ego[:, :, 1:], batch["camera_transforms"].float())
    lidar_world = _matmul(ego[:, :, :1], lidar).expand_as(cam_world)
    camera_from_lidar = torch.linalg.solve(cam_world.cpu(),
                                           lidar_world.cpu()).to(dev)
    frustum = _matmul(k_h, camera_from_lidar)  # (b, t, v, 4, 4)
    pts_h = torch.cat([points, torch.ones_like(points[..., :1])], -1)
    # (b, t, v, N, 4): row i of the frustum transform dotted with each point
    proj = _matmul(pts_h[:, :, None], frustum.transpose(-1, -2))
    z = proj[..., 2]
    zs = z[..., None]
    uv = proj[..., :2] / torch.where(zs.abs() < 1e-6,
                                     torch.full_like(zs, 1e-6), zs)
    lo, _, interval = (torch.tensor(float(x), device=dev)
                       for x in depth_frustum_range)
    fd = torch.round((z - lo) / interval).to(torch.int32)
    valid = (batch["lidar_points_mask"].bool()[:, :, None, :]
             & (z > 1e-3)
             & (uv[..., 0] > 0) & (uv[..., 0] < 1)
             & (uv[..., 1] > 0) & (uv[..., 1] < 1)
             & (fd >= 0) & (fd < bins))
    px = (uv[..., 0] * wf).to(torch.int32).clamp(0, wf - 1)
    py = (uv[..., 1] * hf).to(torch.int32).clamp(0, hf - 1)
    return fd.long(), (py * wf + px).long(), valid


def make_depth_loss(depth_features: torch.Tensor, batch: dict,
                    depth_frustum_range, depth_loss_coef: float = 1.0):
    """``depth_features`` (b, t, v, Hf, Wf, bins) logits; ``batch`` with
    ``lidar_points`` (b, t, N, 3+), ``lidar_points_mask`` (b, t, N),
    ``camera_intrinsics`` (b, t, v, 3, 3), ``image_size`` (b, t, v, 2),
    ``ego_transforms`` (b, t, 1 + v, 4, 4: the LiDAR's, then each
    camera's), ``camera_transforms`` (b, t, v, 4, 4) and optionally
    ``lidar_transforms`` (b, t, 1, 4, 4) → the mean cross entropy over the
    supervising points (0 without one), times ``depth_loss_coef``."""
    b, t, v, hf, wf, bins = depth_features.shape
    fd, flat_idx, valid = frustum_indices(depth_features.shape, batch,
                                          depth_frustum_range)
    n = fd.shape[-1]
    flat_feats = depth_features.reshape(b * t * v, hf * wf, bins)
    logits = torch.gather(
        flat_feats, 1,
        flat_idx.reshape(b * t * v, n, 1).expand(-1, -1, bins),
    ).reshape(b, t, v, n, bins)
    logp = F.log_softmax(logits.float(), -1)
    ce = -torch.gather(logp, -1, fd.clamp(0, bins - 1)[..., None])[..., 0]
    validf = valid.float()
    loss = (ce * validf).sum() / validf.sum().clamp(min=1.0)
    return depth_loss_coef * loss


def depth_bin_to_metric(depth_features: torch.Tensor,
                        depth_frustum_range) -> torch.Tensor:
    """The arg-max bin as metric depth: ``min + bin · interval``."""
    lo, _, interval = depth_frustum_range
    idx = depth_features.argmax(-1).float()
    return lo + idx * interval
