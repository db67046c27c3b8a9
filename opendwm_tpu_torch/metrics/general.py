"""The running-mean metric (``opendwm_tpu/metrics/general.py``) and the
merge of the metrics' running states over data ranks.

Every metric class has ``state_dict()`` (its running state as named
leaves) and ``merge(states, batches)``: given the ``state_dict()`` of
every data rank, in data-rank order, each after the same ``batches``
batches of which every rank saw its own rows, the metric takes the state
one process would hold after seeing all the rows (``merge_states``).
``parallel.collectives.reduce_metric_states`` gathers the states.
"""

from __future__ import annotations

import numpy as np
import torch

from opendwm_tpu_torch.config import register


def merge_states(states: list, batches: int = 1) -> dict:
    """The state one process holds after every data rank's rows, from each
    rank's state dict (data-rank order; each after ``batches`` batches).
    Sums (tensors, numbers, arrays) are added in rank order: tensors on
    the first rank's device in their dtype, host numbers and arrays in
    float64 (ints stay ints). Per-sample lists are put back in the
    one-process order, batch by batch and rank by rank within a batch:
    each rank's list splits into ``batches`` equal runs, its rows of each
    batch."""
    batches = max(1, batches)
    out = {}
    for key, first in states[0].items():
        leaves = [s[key] for s in states]
        if isinstance(first, list):
            runs = []
            for leaf in leaves:
                if len(leaf) % batches:
                    raise ValueError(
                        f"{key}: {len(leaf)} values do not split into "
                        f"{batches} batches")
                step = len(leaf) // batches
                runs.append([leaf[i * step:(i + 1) * step]
                             for i in range(batches)])
            out[key] = [v for i in range(batches) for run in runs
                        for v in run[i]]
        elif isinstance(first, torch.Tensor):
            total = first.clone()
            for leaf in leaves[1:]:
                total += leaf.to(total.device)
            out[key] = total
        elif isinstance(first, np.ndarray):
            out[key] = np.sum(np.stack(leaves).astype(np.float64), 0)
        elif isinstance(first, (bool, np.bool_)) or \
                not isinstance(first, (int, float, np.number)):
            raise TypeError(f"{key}: cannot merge {type(first).__name__}")
        elif isinstance(first, (int, np.integer)):
            out[key] = int(sum(int(v) for v in leaves))
        else:
            total = 0.0
            for v in leaves:
                total += float(v)
            out[key] = total
    return out


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

    def state_dict(self) -> dict:
        return {"total": self.total, "count": self.count}

    def merge(self, states: list, batches: int = 1) -> None:
        """The state of one instance fed every rank's values
        (``merge_states``)."""
        merged = merge_states(states, batches)
        self.total, self.count = merged["total"], merged["count"]
