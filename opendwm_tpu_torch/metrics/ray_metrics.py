"""Copilot4D ray-based point-cloud errors
(``opendwm_tpu/metrics/ray_metrics.py``): every ground-truth ray is matched
to the angularly nearest predicted return, whose depth is re-projected
along the ground-truth ray and compared within the evaluation range."""

from __future__ import annotations

import torch

from opendwm_tpu_torch.metrics.pc_metrics import pairwise_sq_dists


def spherical_projection(points: torch.Tensor):
    """(N, 3) → (azimuth, elevation, range)."""
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    d = torch.sqrt(x * x + y * y + z * z)
    return torch.atan2(x, y), torch.atan2(z, y), d


def nanmedian(x: torch.Tensor) -> torch.Tensor:
    """numpy's ``nanmedian``: the mean of the two middle values of an even
    count (``torch.nanmedian`` takes the lower); NaN when all are NaN."""
    v = x[~torch.isnan(x)].sort().values
    n = v.numel()
    if n == 0:
        return torch.tensor(float("nan"), dtype=x.dtype, device=x.device)
    return (v[(n - 1) // 2] + v[n // 2]) / 2


def compute_ray_errors(pred, gt, origin, pred_mask=None, gt_mask=None,
                       pc_range=(-70.0, -70.0, -4.5, 70.0, 70.0, 4.5)):
    """(l1_mean, absrel_mean, l1_median, absrel_median) of predicted (N, 3)
    against ground-truth (M, 3) points seen from ``origin`` (3,)."""
    pred = torch.as_tensor(pred, dtype=torch.float32)
    gt = torch.as_tensor(gt, dtype=torch.float32).to(pred.device)
    origin = torch.as_tensor(origin, dtype=torch.float32).to(pred.device)
    if pred_mask is None:
        pred_mask = torch.ones(pred.shape[0], dtype=torch.bool,
                               device=pred.device)
    if gt_mask is None:
        gt_mask = torch.ones(gt.shape[0], dtype=torch.bool, device=gt.device)
    pred_n, gt_n = pred - origin, gt - origin
    th_p, ph_p, d_p = spherical_projection(pred_n)
    th_g, ph_g, d_g = spherical_projection(gt_n)
    pred_valid = pred_mask & (d_p > 1e-2)
    gt_valid = gt_mask & (d_g > 1e-2)

    ps = torch.stack([th_p, ph_p], -1)
    gs = torch.stack([th_g, ph_g], -1)
    d2 = pairwise_sq_dists(gs, ps).masked_fill(~pred_valid[None],
                                               float("inf"))
    idx = d2.argmin(-1)

    unit = gt_n / torch.clamp(d_g[:, None], min=1e-9)
    interp = origin + d_p[idx][:, None] * unit
    lo = torch.tensor(pc_range[:3], device=gt.device)
    hi = torch.tensor(pc_range[3:], device=gt.device)
    in_range = ((gt >= lo) & (gt <= hi)).all(-1)
    valid = gt_valid & in_range & (d_g > 0.01)

    eucl = torch.linalg.norm(gt - interp, dim=-1)
    absrel = eucl / torch.clamp(d_g, min=1e-9)
    count = torch.clamp(gt_valid.sum(), min=1)
    l1_mean = torch.where(valid, eucl, 0.0).sum() / count
    absrel_mean = torch.where(valid, absrel, 0.0).sum() / count
    nan = float("nan")
    return (l1_mean, absrel_mean,
            nanmedian(torch.where(valid, eucl, nan)),
            nanmedian(torch.where(valid, absrel, nan)))
