"""Geometry + styling utilities for the LiDAR visualizer
(``opendwm_tpu/utils/lidar_visualizer_utils.py``), on the port's
quaternion helpers.

Capability parity with reference src/dwm/utils/lidar_visualizer_utils.py
(Box geometry :359-455, transform_matrix :171, quaternion_yaw :270) and the
styling/trajectory surface of lidar_visualizer.py — 3D box wireframes with
per-category colors, HD-map polyline densification, ego-trajectory playback
with an interpolated following camera. The reference also embeds a private
copy of the nuScenes/KITTI360 table readers there; this repo's real dataset
adapters (datasets/nuscenes.py, datasets/kitti360.py) already provide those,
so the visualizer consumes their outputs instead of duplicating them.

Everything here is host-side numpy: no step of it runs on the card.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from opendwm_tpu_torch.datasets.common import quaternion_to_matrix
from opendwm_tpu_torch.datasets.kitti360 import quat_slerp


def transform_matrix(
    translation=(0.0, 0.0, 0.0),
    rotation=(1.0, 0.0, 0.0, 0.0),
    inverse: bool = False,
) -> np.ndarray:
    """4x4 homogeneous transform from a translation + wxyz quaternion."""
    tm = np.eye(4)
    rot = quaternion_to_matrix(np.asarray(rotation, float))
    trans = np.asarray(translation, float)
    if inverse:
        tm[:3, :3] = rot.T
        tm[:3, 3] = -rot.T @ trans
    else:
        tm[:3, :3] = rot
        tm[:3, 3] = trans
    return tm


def quaternion_yaw(q) -> float:
    """Yaw (rotation about +z) encoded in a wxyz quaternion."""
    v = quaternion_to_matrix(np.asarray(q, float)) @ np.array([1.0, 0, 0])
    return float(np.arctan2(v[1], v[0]))


class Box:
    """Oriented 3D box: center, wlh size, wxyz orientation quaternion.

    Same contract as the reference Box (corners ordering: first four are
    the +x face — front-top-left, front-top-right, front-bottom-right,
    front-bottom-left — then the -x face in the same winding; bottom
    corners are indices [2, 3, 7, 6]).
    """

    def __init__(
        self,
        center,
        size,
        orientation=(1.0, 0.0, 0.0, 0.0),
        label: Optional[str] = None,
        score: Optional[float] = None,
        velocity=(np.nan, np.nan, np.nan),
        name: Optional[str] = None,
        token: Optional[str] = None,
    ):
        self.center = np.asarray(center, float)
        self.wlh = np.asarray(size, float)
        self.orientation = np.asarray(orientation, float)
        self.label = label
        self.score = score
        self.velocity = np.asarray(velocity, float)
        self.name = name
        self.token = token

    @property
    def rotation_matrix(self) -> np.ndarray:
        return quaternion_to_matrix(self.orientation)

    def translate(self, x) -> None:
        self.center = self.center + np.asarray(x, float)

    def rotate(self, quaternion) -> None:
        q = np.asarray(quaternion, float)
        rot = quaternion_to_matrix(q)
        self.center = rot @ self.center
        self.orientation = _quat_mul(q, self.orientation)
        self.velocity = rot @ self.velocity

    def corners(self, wlh_factor: float = 1.0) -> np.ndarray:
        """(3, 8) corner coordinates in the box frame's parent frame."""
        w, l, h = self.wlh * wlh_factor
        # +x face first (front of the vehicle), top edge before bottom
        x = l / 2 * np.array([1, 1, 1, 1, -1, -1, -1, -1])
        y = w / 2 * np.array([1, -1, -1, 1, 1, -1, -1, 1])
        z = h / 2 * np.array([1, 1, -1, -1, 1, 1, -1, -1])
        corners = self.rotation_matrix @ np.stack([x, y, z])
        return corners + self.center[:, None]

    def bottom_corners(self) -> np.ndarray:
        return self.corners()[:, [2, 3, 7, 6]]


def _quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ])


# ---------------------------------------------------------------------------
# Category styling (nuScenes taxonomy; prefix-matched so Waymo/Argoverse
# labels mapped onto it inherit colors)
# ---------------------------------------------------------------------------

CATEGORY_COLORS = {
    "vehicle.car": (0, 158, 255),
    "vehicle.truck": (60, 90, 255),
    "vehicle.bus": (80, 60, 255),
    "vehicle.construction": (110, 40, 230),
    "vehicle.trailer": (130, 120, 240),
    "vehicle.motorcycle": (255, 60, 60),
    "vehicle.bicycle": (255, 100, 40),
    "vehicle": (0, 120, 255),
    "human.pedestrian": (0, 230, 120),
    "human": (0, 230, 120),
    "movable_object.barrier": (200, 200, 60),
    "movable_object.trafficcone": (255, 160, 0),
    "movable_object": (220, 180, 60),
    "static_object": (160, 160, 160),
    "animal": (160, 230, 60),
}
DEFAULT_BOX_COLOR = (255, 0, 255)

MAP_LINE_COLORS = {
    "lane": (90, 90, 90),
    "lane_divider": (160, 160, 160),
    "road_divider": (200, 120, 40),
    "ped_crossing": (120, 40, 160),
    "drivable_area": (60, 60, 60),
}


def category_color(name: Optional[str]):
    """Longest-prefix category → color lookup."""
    if name:
        best = None
        for prefix in CATEGORY_COLORS:
            if name.startswith(prefix) and (
                best is None or len(prefix) > len(best)
            ):
                best = prefix
        if best is not None:
            return CATEGORY_COLORS[best]
    return DEFAULT_BOX_COLOR


def boxes_to_render(boxes: Sequence[Box]):
    """[(corners (8, 3), styled color)] for the renderers' ``boxes=`` arg."""
    return [
        (box.corners().T, category_color(box.name)) for box in boxes
    ]


def densify_polyline(
    poly: np.ndarray, points_per_meter: float = 3.0
) -> np.ndarray:
    """Resample a polyline to ~uniform spacing (reference line_sets_to_pts:
    map lines become dense point runs so they survive sparse rasterizers)."""
    poly = np.asarray(poly, float)
    if len(poly) < 2:
        return poly
    out = [poly[:1]]
    for a, b in zip(poly[:-1], poly[1:]):
        seg = np.linalg.norm(b - a)
        n = max(1, int(np.ceil(seg * points_per_meter)))
        ts = np.linspace(0.0, 1.0, n + 1)[1:, None]
        out.append(a[None] * (1 - ts) + b[None] * ts)
    return np.concatenate(out, 0)


def filter_points_in_range(
    points: np.ndarray, x_min, x_max, y_min, y_max
) -> np.ndarray:
    pts = np.asarray(points)
    keep = (
        (pts[:, 0] >= x_min) & (pts[:, 0] <= x_max)
        & (pts[:, 1] >= y_min) & (pts[:, 1] <= y_max)
    )
    return pts[keep]


def box_in_range(box: Box, x_min, x_max, y_min, y_max) -> bool:
    x, y = box.center[0], box.center[1]
    return bool(x_min <= x <= x_max and y_min <= y <= y_max)


# ---------------------------------------------------------------------------
# Trajectory playback: interpolated ego poses → following-camera paths
# ---------------------------------------------------------------------------


def interpolate_poses(
    poses: Sequence[dict], steps_between: int = 0
) -> list:
    """Ego-pose playback path. Each pose is {"translation": (3,),
    "rotation": wxyz}; inserts ``steps_between`` slerp/lerp poses between
    consecutive keyframes (reference trajectory playback smoothing)."""
    poses = list(poses)
    if steps_between <= 0 or len(poses) < 2:
        return poses
    out = []
    for a, b in zip(poses[:-1], poses[1:]):
        out.append(a)
        ta = np.asarray(a["translation"], float)
        tb = np.asarray(b["translation"], float)
        for i in range(1, steps_between + 1):
            t = i / (steps_between + 1)
            out.append({
                "translation": ta * (1 - t) + tb * t,
                "rotation": quat_slerp(
                    np.asarray(a["rotation"], float),
                    np.asarray(b["rotation"], float), t,
                ),
            })
    out.append(poses[-1])
    return out


def camera_path_from_trajectory(
    poses: Sequence[dict],
    eye_offset=(-20.0, 0.0, 12.0),
    look_ahead=(10.0, 0.0, 0.0),
) -> list:
    """Per-pose (eye, center) chase-camera path in world coordinates: the
    eye rides behind/above the ego (offset in the ego frame, yaw-only so
    the horizon stays level), looking at a point ahead of the ego."""
    path = []
    for pose in poses:
        trans = np.asarray(pose["translation"], float)
        yaw = quaternion_yaw(pose["rotation"])
        c, s = np.cos(yaw), np.sin(yaw)
        yaw_rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        eye = trans + yaw_rot @ np.asarray(eye_offset, float)
        center = trans + yaw_rot @ np.asarray(look_ahead, float)
        path.append((eye, center))
    return path


def render_trajectory(
    point_frames: Sequence[np.ndarray],
    poses: Sequence[dict],
    boxes_per_frame: Optional[Sequence[Sequence[Box]]] = None,
    lines: Optional[Sequence] = None,
    masks: Optional[Sequence] = None,
    renderer_cls=None,
    **renderer_kwargs,
) -> list:
    """Render a point-cloud sequence with a chase camera following the ego
    trajectory; boxes get category styling. Returns PIL images."""
    from opendwm_tpu_torch.utils.lidar_visualizer import PerspectiveRenderer

    renderer_cls = renderer_cls or PerspectiveRenderer
    path = camera_path_from_trajectory(poses)
    out = []
    for i, pts in enumerate(point_frames):
        eye, center = path[min(i, len(path) - 1)]
        renderer = renderer_cls(
            eye=tuple(eye), center=tuple(center), **renderer_kwargs
        )
        out.append(renderer.render(
            points=pts,
            points_mask=None if masks is None else masks[i],
            boxes=None if boxes_per_frame is None
            else boxes_to_render(boxes_per_frame[i]),
            lines=lines,
        ))
    return out
