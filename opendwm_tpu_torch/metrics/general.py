"""The running-mean metric (``opendwm_tpu/metrics/general.py``)."""

from __future__ import annotations

import numpy as np
import torch

from opendwm_tpu_torch.config import register


def host(value) -> np.ndarray:
    """A tensor (any device) or array-like as a numpy array."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


@register(
    "CustomMeanMetric",
    aliases=("dwm.metrics.general_metrics.CustomMeanMetrics",),
)
class CustomMeanMetric:
    """The mean of every finite value given to ``update``."""

    def __init__(self):
        self.total = 0.0
        self.count = 0

    def update(self, value):
        arr = host(value).astype(np.float64).reshape(-1)
        finite = np.isfinite(arr)
        self.total += float(arr[finite].sum())
        self.count += int(finite.sum())

    def compute(self) -> float:
        return self.total / self.count if self.count else float("nan")

    def reset(self):
        self.total, self.count = 0.0, 0
