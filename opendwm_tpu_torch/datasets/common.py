"""Dataset common layer: canonical batch contract + host-side helpers
(the port's copy of ``opendwm_tpu/datasets/common.py``).

Mirrors reference src/dwm/datasets/common.py (DatasetAdapter :41-117,
ConcatMotionDataset :119-147, CollateFnIgnoring :150-196, geometry helpers
:199-220, 3dbox line projection/drawing :222-273, caption assembly :275-334,
stub-key schema alignment :337-359) in numpy, as the JAX package does, so
that a reader of the port gives the JAX reader's item bit for bit; ragged
LiDAR points are padded to one shape (``pad_points``).

Canonical batch dict (datasets/README.md:20-51): ``fps`` (b,), ``pts``
(b, t, sensors), ``images``/(3dbox|hdmap)_images`` (b, t, v, H, W, 3) float32
in [0,1], ``lidar_points`` (b, t, N, 3) + ``lidar_points_mask``,
``camera_transforms`` (b, t, v, 4, 4), ``camera_intrinsics`` (b, t, v, 3, 3),
``image_size`` (b, t, v, 2), ``ego_transforms`` (b, t, sensors, 4, 4),
``image_description`` nested lists of strings.
"""

from __future__ import annotations

import bisect
from typing import Any, Callable, Optional, Sequence

import numpy as np

from opendwm_tpu_torch.config import register


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------

def quaternion_to_matrix(q: Sequence[float]) -> np.ndarray:
    """(w, x, y, z) quaternion → 3x3 rotation matrix."""
    w, x, y, z = q
    n = w * w + x * x + y * y + z * z
    s = 0.0 if n < 1e-12 else 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array([
        [1 - (yy + zz), xy - wz, xz + wy],
        [xy + wz, 1 - (xx + zz), yz - wx],
        [xz - wy, yz + wx, 1 - (xx + yy)],
    ])


def get_transform(rotation: Sequence[float], translation: Sequence[float]):
    result = np.eye(4)
    result[:3, :3] = quaternion_to_matrix(rotation)
    result[:3, 3] = np.asarray(translation)
    return result


def make_intrinsic_matrix(fx_fy: Sequence[float], cx_cy: Sequence[float]):
    result = np.diag(list(fx_fy) + [1.0])
    result[:2, 2] = np.asarray(cx_cy)
    return result


def project_line(a, b, near_z: float = 0.05, far_z: float = 512.0):
    """Clip a 3-D camera-space segment to [near_z, far_z] and project
    (reference :222-248). Returns (x0, y0, x1, y1) or None."""
    if (a[2] < near_z and b[2] < near_z) or (a[2] > far_z and b[2] > far_z):
        return None
    ca, cb = a, b
    if a[2] >= near_z and b[2] < near_z:
        r = (near_z - b[2]) / (a[2] - b[2])
        cb = a * r + b * (1 - r)
    elif a[2] < near_z and b[2] >= near_z:
        r = (b[2] - near_z) / (b[2] - a[2])
        ca = a * r + b * (1 - r)
    if a[2] > far_z and b[2] <= far_z:
        r = (far_z - b[2]) / (a[2] - b[2])
        ca = a * r + b * (1 - r)
    elif a[2] <= far_z and b[2] > far_z:
        r = (b[2] - far_z) / (b[2] - a[2])
        cb = a * r + b * (1 - r)
    pa = ca[:2] / ca[2]
    pb = cb[:2] / cb[2]
    return (float(pa[0]), float(pa[1]), float(pb[0]), float(pb[1]))


# 3D box corner template: unit cube corners in homogeneous coords (the
# reference configs carry these; kept here as the default).
BOX_CORNER_TEMPLATES = [
    [-0.5, -0.5, -0.5, 1], [-0.5, -0.5, 0.5, 1],
    [-0.5, 0.5, -0.5, 1], [-0.5, 0.5, 0.5, 1],
    [0.5, -0.5, -0.5, 1], [0.5, -0.5, 0.5, 1],
    [0.5, 0.5, -0.5, 1], [0.5, 0.5, 0.5, 1],
]
BOX_EDGE_INDICES = [
    (0, 1), (0, 2), (1, 3), (2, 3),
    (4, 5), (4, 6), (5, 7), (6, 7),
    (0, 4), (1, 5), (2, 6), (3, 7),
]


def draw_edges_to_image(draw, points, edge_indices, pen_color, pen_width):
    for a, b in edge_indices:
        xy = project_line(points[:, a], points[:, b])
        if xy is not None:
            draw.line(xy, fill=pen_color, width=pen_width)


def draw_3dbox_image(
    draw,
    view_transform: np.ndarray,
    annotations: list,
    get_world_transform: Callable,
    get_label: Callable,
    pen_width: int,
    color_table: dict,
    corner_templates: list = BOX_CORNER_TEMPLATES,
    edge_indices: list = BOX_EDGE_INDICES,
):
    corners = np.asarray(corner_templates).T
    for ann in annotations:
        label = get_label(ann)
        if label in color_table:
            p = view_transform @ get_world_transform(ann) @ corners
            draw_edges_to_image(
                draw, p, edge_indices, tuple(color_table[label]), pen_width
            )


# ---------------------------------------------------------------------------
# Captions
# ---------------------------------------------------------------------------

def align_image_description_crossview(caption_list: list, settings: dict):
    """Force chosen caption keys to the dominant value across views
    (reference :275-291)."""
    for k in settings.get("align_keys", []):
        counts: dict = {}
        for c in caption_list:
            counts[c[k]] = counts.get(c[k], 0) + 1
        dominant = max(counts, key=counts.get)
        for c in caption_list:
            c[k] = dominant
    return caption_list


def make_image_description_string(
    caption_dict: dict, settings: dict, rng: np.random.RandomState
):
    default_keys = [
        "time", "weather", "environment", "objects", "image_description"
    ]
    keys = list(settings.get("selected_keys", default_keys))
    if settings.get("reorder_keys"):
        keys = [keys[i] for i in rng.permutation(len(keys))]
    drops = settings.get("drop_rates", {})
    keys = [k for k in keys if not (k in drops and rng.rand() <= drops[k])]
    return ". ".join(caption_dict[k] for k in keys)


def add_stub_key_data(stub_key_data_dict: Optional[dict], result: dict):
    """Cross-dataset schema alignment (reference :337-359)."""
    if stub_key_data_dict is None:
        return
    for key, data in stub_key_data_dict.items():
        if key not in result:
            if data[0] == "tensor":
                shape, value = data[1], data[2]
                result[key] = value * np.ones(shape, np.float32)
            else:
                result[key] = data[1]


# ---------------------------------------------------------------------------
# Lookup helpers
# ---------------------------------------------------------------------------

class ReadonlyDictIndices:
    """Sorted-key binary-search index over a key column (reference
    src/dwm/common.py:66-131 — the fork-safe substitute for dicts)."""

    def __init__(self, keys: Sequence[str]):
        order = np.argsort(np.asarray(keys, dtype=object))
        self.sorted_keys = [keys[i] for i in order]
        self.sorted_indices = order

    def __getitem__(self, key: str) -> int:
        i = bisect.bisect_left(self.sorted_keys, key)
        if i >= len(self.sorted_keys) or self.sorted_keys[i] != key:
            raise KeyError(key)
        return int(self.sorted_indices[i])

    def get_all_indices(self, key: str) -> list[int]:
        lo = bisect.bisect_left(self.sorted_keys, key)
        hi = bisect.bisect_right(self.sorted_keys, key)
        return [int(self.sorted_indices[i]) for i in range(lo, hi)]


def find_nearest(values: Sequence[float], target: float) -> int:
    """Index of the element nearest to target in a sorted list."""
    i = bisect.bisect_left(values, target)
    if i == 0:
        return 0
    if i >= len(values):
        return len(values) - 1
    return i if values[i] - target < target - values[i - 1] else i - 1


# ---------------------------------------------------------------------------
# Padding (one shape a batch)
# ---------------------------------------------------------------------------

def pad_points(
    point_list: Sequence[np.ndarray], max_points: int
) -> tuple[np.ndarray, np.ndarray]:
    """Ragged per-frame point arrays → (T, max_points, 3) + bool mask."""
    t = len(point_list)
    out = np.zeros((t, max_points, 3), np.float32)
    mask = np.zeros((t, max_points), bool)
    for i, pts in enumerate(point_list):
        pts = np.asarray(pts, np.float32)[:, :3]
        n = min(len(pts), max_points)
        if len(pts) > max_points:
            sel = np.random.default_rng(i).choice(
                len(pts), max_points, replace=False
            )
            pts = pts[sel]
        out[i, :n] = pts[:n]
        mask[i, :n] = True
    return out, mask


# ---------------------------------------------------------------------------
# Adapters & collation
# ---------------------------------------------------------------------------

@register(
    "DatasetAdapter", aliases=("dwm.datasets.common.DatasetAdapter",)
)
class DatasetAdapter:
    """Wraps a dataset with per-key transforms (+renames), and decodes the
    bucket sampler's string indices ``"idx-t-h-w"`` into dynamic sequence
    length / resolution hints (reference :41-117)."""

    def __init__(
        self,
        base_dataset,
        transform_list: Optional[list] = None,
        pop_list: Optional[list] = None,
    ):
        self.base_dataset = base_dataset
        self.transform_list = transform_list or []
        self.pop_list = pop_list or []

    def __len__(self):
        return len(self.base_dataset)

    def __getitem__(self, index):
        if isinstance(index, str):
            parts = index.split("-")
            idx = int(parts[0])
            hints = {
                "sequence_length": int(parts[1]),
                "height": int(parts[2]),
                "width": int(parts[3]),
            }
            item = self.base_dataset[idx]
            item["_bucket"] = hints
        else:
            item = self.base_dataset[index]
        for t in self.transform_list:
            src = t["old_key"] if "old_key" in t else t.get("key")
            dst = t.get("new_key", src)
            fn = t.get("transform")
            value = item[src]
            item[dst] = fn(value) if fn is not None else value
        for k in self.pop_list:
            item.pop(k, None)
        return item


@register(
    "ConcatMotionDataset",
    aliases=("dwm.datasets.common.ConcatMotionDataset",),
)
class ConcatMotionDataset:
    """Ratio-weighted concatenation of datasets (reference :119-147)."""

    def __init__(self, datasets: list, ratios: Optional[list] = None):
        self.datasets = datasets
        ratios = ratios or [1.0] * len(datasets)
        self.sizes = [
            int(len(d) * r) for d, r in zip(datasets, ratios)
        ]
        self.offsets = np.cumsum([0] + self.sizes)

    def __len__(self):
        return int(self.offsets[-1])

    def __getitem__(self, index):
        ds = bisect.bisect_right(self.offsets, index) - 1
        inner = (index - self.offsets[ds]) % len(self.datasets[ds])
        return self.datasets[ds][inner]


@register(
    "CollateFnIgnoring", aliases=("dwm.datasets.common.CollateFnIgnoring",)
)
class CollateFnIgnoring:
    """Stack numeric fields into batch arrays; keep the listed keys as raw
    lists (ragged captions, PIL images...) (reference :150-196)."""

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
