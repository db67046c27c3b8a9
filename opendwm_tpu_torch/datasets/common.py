"""Collation of dataset items into batches
(``opendwm_tpu/datasets/common.py:CollateFnIgnoring``)."""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from opendwm_tpu_torch.config import register


@register(
    "CollateFnIgnoring", aliases=("dwm.datasets.common.CollateFnIgnoring",)
)
class CollateFnIgnoring:
    """Stack numeric fields into batch arrays; keep the listed keys as raw
    lists (ragged captions, images...) (reference :150-196)."""

    def __init__(self, keys: Optional[list] = None):
        self.keys = set(keys or [])

    def __call__(self, items: list) -> dict:
        out: dict[str, Any] = {}
        for key in items[0]:
            values = [i[key] for i in items]
            if key in self.keys:
                out[key] = values
            elif isinstance(values[0], np.ndarray):
                out[key] = np.stack(values)
            elif isinstance(values[0], (int, float, np.floating, np.integer)):
                out[key] = np.asarray(values)
            else:
                out[key] = values
        return out
