"""Point-cloud metrics: Chamfer, MMD, JSD
(``opendwm_tpu/metrics/pc_metrics.py``).

Chamfer clamps both clouds to the evaluation range and averages the two
directed mean nearest-neighbour distances; MMD is a Gaussian-kernel
discrepancy over per-sample BEV histograms; JSD the Jensen-Shannon
distance of the accumulated 2-D occupancy PMFs (100 bins over ±80 m).

The pairwise minimum runs on the points' device in the JAX package's
expanded-square form (``|a|² − 2 a·b + |b|²``, clamped at 0 before the
square root, masked columns +inf), over row chunks of at most
``CHUNK_ELEMS`` distances. The dot products and the squared norms are
summed coordinate by coordinate in one order (``pairwise_sq_dists``), so
that a point's distance to itself is exactly 0, as on the JAX side (a GEMM
for ``a·b`` rounds differently from the norms' sum, and ``torch.cdist``'s
mm path too). The JAX package
computes every (masked) voxel centre of a grid against every other; the
port drops the masked points first, which changes no value (a masked
column never wins a minimum unless all are masked, a masked row's
distance is discarded) and lets a full-width grid's points fit: a 40 x
640 x 640 grid is 16.4M centres.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from opendwm_tpu_torch.config import register
from opendwm_tpu_torch.metrics.general import host, merge_states

CHUNK_ELEMS = 2 ** 28  # fp32 squared distances a chunk of the minimum


def pairwise_sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(|a|² − 2 a·b) + |b|²`` of (N, D) and (M, D) points → (N, M), each
    sum over the coordinates in order, products rounded alone."""
    ab = a[:, :1] * b[:, 0]
    a2, b2 = a[:, 0] * a[:, 0], b[:, 0] * b[:, 0]
    for i in range(1, a.shape[1]):
        ab = ab + a[:, i:i + 1] * b[:, i]
        a2 = a2 + a[:, i] * a[:, i]
        b2 = b2 + b[:, i] * b[:, i]
    return (a2[:, None] - 2 * ab) + b2[None]


def _directed_min_dists(a, b, a_mask=None, b_mask=None,
                        chunk_elems: Optional[int] = None):
    """For each point of ``a`` (N, 3): the distance to the nearest valid
    point of ``b`` (M, 3); +inf when ``b`` has none."""
    chunk_elems = chunk_elems or CHUNK_ELEMS
    n, m = a.shape[0], b.shape[0]
    if m == 0:
        return torch.full((n,), float("inf"), dtype=a.dtype, device=a.device)
    rows = max(1, chunk_elems // m)
    out = []
    for start in range(0, n, rows):
        d2 = pairwise_sq_dists(a[start:start + rows], b)
        if b_mask is not None:
            d2 = d2.masked_fill(~b_mask[None], float("inf"))
        out.append(d2.min(-1).values.clamp(min=0.0).sqrt())
    return torch.cat(out) if out else a.new_zeros((0,))


def chamfer_distance(pred, gt, pred_mask=None, gt_mask=None,
                     pc_range=(-70.0, -70.0, -4.5, 70.0, 70.0, 4.5)):
    """Range-clamped symmetric Chamfer of (N, 3) and (M, 3) points with
    optional validity masks: the mean of the two directed mean distances,
    each 0 when its side has no valid point (a 0-dim tensor)."""
    pred = torch.as_tensor(pred, dtype=torch.float32)
    gt = torch.as_tensor(gt, dtype=torch.float32).to(pred.device)
    lo = torch.tensor(pc_range[:3], device=pred.device)
    hi = torch.tensor(pc_range[3:], device=pred.device)
    masks = []
    for pts, mask in ((pred, pred_mask), (gt, gt_mask)):
        valid = ((pts >= lo) & (pts <= hi)).all(-1)
        if mask is not None:
            valid = valid & torch.as_tensor(mask, device=pts.device).bool()
        masks.append(valid)
    p, g = pred[masks[0]], gt[masks[1]]
    mean_pg = _directed_min_dists(p, g).sum() / max(p.shape[0], 1)
    mean_gp = _directed_min_dists(g, p).sum() / max(g.shape[0], 1)
    return (mean_pg + mean_gp) / 2.0


def point_cloud_to_histogram(points, field_size: float = 160.0,
                             bins: int = 100):
    """The 2-D BEV histogram (bins, bins) of the points' xy; points off the
    field are dropped. The cell size divides as a tensor (a Python-float
    divisor becomes a reciprocal product on the card)."""
    points = torch.as_tensor(points, dtype=torch.float32)
    half = (bins / 2) * (field_size / bins)
    cell = torch.tensor(field_size / bins, device=points.device)
    ij = torch.floor((points[..., :2] + half) / cell).to(torch.int32)
    valid = ((ij >= 0) & (ij < bins)).all(-1)
    flat = torch.where(valid, ij[..., 0] * bins + ij[..., 1], bins * bins)
    hist = torch.bincount(flat.reshape(-1).long(), minlength=bins * bins + 1)
    return hist[:-1].to(torch.float32).reshape(bins, bins)


def gaussian_kernel_mmd(h1: np.ndarray, h2: np.ndarray, sigma: float = 0.5):
    """MMD between two sets of histograms (n, bins²) with the Gaussian
    kernel over the L2 distance of their PMFs (host, numpy)."""

    def disc(a, b):
        d = np.linalg.norm(a[:, None] - b[None], axis=-1)
        return np.mean(np.exp(-(d ** 2) / (2 * sigma ** 2)))

    h1 = h1 / np.maximum(h1.sum(-1, keepdims=True), 1e-12)
    h2 = h2 / np.maximum(h2.sum(-1, keepdims=True), 1e-12)
    return disc(h1, h1) + disc(h2, h2) - 2 * disc(h1, h2)


def jsd_2d(p: np.ndarray, q: np.ndarray) -> float:
    from scipy.spatial.distance import jensenshannon

    p = p / p.sum()
    q = q / q.sum()
    return float(jensenshannon(p.reshape(-1), q.reshape(-1)))


@register(
    "PointCloudChamfer",
    aliases=("dwm.metrics.pc_metrics.PointCloudChamfer",),
)
class PointCloudChamfer:
    """The mean Chamfer over updates; ``inner_dist`` d clamps x and y to
    ±d (the reference's chamfer_30 / chamfer_40)."""

    def __init__(self, inner_dist: Optional[float] = None):
        self.pc_range = (
            (-inner_dist, -inner_dist, -4.5, inner_dist, inner_dist, 4.5)
            if inner_dist else (-70.0, -70.0, -4.5, 70.0, 70.0, 4.5))
        self.values: list[float] = []

    def update(self, pred, gt, pred_mask=None, gt_mask=None):
        self.values.append(float(chamfer_distance(
            pred, gt, pred_mask, gt_mask, pc_range=self.pc_range)))

    def compute(self) -> float:
        vals = np.asarray(self.values)
        vals = vals[np.isfinite(vals)]
        return float(vals.mean()) if len(vals) else float("nan")

    def reset(self):
        self.values.clear()

    def state_dict(self) -> dict:
        return {"values": list(self.values)}

    def merge(self, states: list, batches: int = 1) -> None:
        """The per-sample distances of every rank in the one-process order
        (``merge_states``)."""
        self.values = merge_states(states, batches)["values"]


@register("PointCloudMMD", aliases=("dwm.metrics.pc_metrics.PointCloudMMD",))
class PointCloudMMD:
    def __init__(self, field_size=160.0, bins=100, sigma=0.5):
        self.field_size, self.bins, self.sigma = field_size, bins, sigma
        self.pred_hists: list[np.ndarray] = []
        self.gt_hists: list[np.ndarray] = []

    def update(self, pred, gt):
        for pts, hists in ((pred, self.pred_hists), (gt, self.gt_hists)):
            hists.append(host(point_cloud_to_histogram(
                pts, self.field_size, self.bins)).reshape(-1))

    def compute(self) -> float:
        return float(gaussian_kernel_mmd(np.stack(self.pred_hists),
                                         np.stack(self.gt_hists), self.sigma))

    def reset(self):
        self.pred_hists.clear()
        self.gt_hists.clear()

    def state_dict(self) -> dict:
        return {"pred_hists": list(self.pred_hists),
                "gt_hists": list(self.gt_hists)}

    def merge(self, states: list, batches: int = 1) -> None:
        """The histograms of every rank in the one-process order
        (``merge_states``)."""
        merged = merge_states(states, batches)
        self.pred_hists, self.gt_hists = merged["pred_hists"], \
            merged["gt_hists"]


@register("PointCloudJSD", aliases=("dwm.metrics.pc_metrics.PointCloudJSD",))
class PointCloudJSD:
    def __init__(self, field_size=160.0, bins=100):
        self.field_size, self.bins = field_size, bins
        self.pred_acc = np.zeros((bins, bins))
        self.gt_acc = np.zeros((bins, bins))

    def update(self, pred, gt):
        self.pred_acc += host(point_cloud_to_histogram(
            pred, self.field_size, self.bins))
        self.gt_acc += host(point_cloud_to_histogram(
            gt, self.field_size, self.bins))

    def compute(self) -> float:
        return jsd_2d(self.pred_acc, self.gt_acc)

    def reset(self):
        self.pred_acc[:] = 0
        self.gt_acc[:] = 0

    def state_dict(self) -> dict:
        return {"pred_acc": self.pred_acc.copy(),
                "gt_acc": self.gt_acc.copy()}

    def merge(self, states: list, batches: int = 1) -> None:
        """The histogram sums of every rank, added (``merge_states``)."""
        merged = merge_states(states, batches)
        self.pred_acc, self.gt_acc = merged["pred_acc"], merged["gt_acc"]
