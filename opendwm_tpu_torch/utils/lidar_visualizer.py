"""LiDAR visualization (BEV and perspective renderers;
``opendwm_tpu/utils/lidar_visualizer.py``, host-side numpy and PIL).

The reference's visualizer (src/dwm/utils/lidar_visualizer.py, 326+922 LoC)
is an interactive open3d app; open3d is optional, so this module
renders the same content — points, 3D boxes, map lines — to BEV images with
PIL, and exposes an open3d hook that activates when the package exists.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

try:
    from PIL import Image, ImageDraw

    _HAS_PIL = True
except ImportError:  # pragma: no cover
    _HAS_PIL = False

try:
    import open3d  # noqa: F401

    HAS_OPEN3D = True
except ImportError:  # pragma: no cover
    HAS_OPEN3D = False


class BEVRenderer:
    """Top-down renderer: world (x fwd, y left) → image pixels."""

    def __init__(
        self,
        image_size: int = 640,
        meters: float = 100.0,
        background=(0, 0, 0),
    ):
        self.size = image_size
        self.scale = image_size / meters
        self.background = background

    def _to_px(self, xy: np.ndarray) -> np.ndarray:
        cx = cy = self.size / 2
        px = cx + xy[..., 0] * self.scale
        py = cy - xy[..., 1] * self.scale
        return np.stack([px, py], -1)

    def render(
        self,
        points: Optional[np.ndarray] = None,
        points_mask: Optional[np.ndarray] = None,
        boxes: Optional[Sequence] = None,   # [(corners (8,3) or (4,2), color)]
        lines: Optional[Sequence] = None,   # [((N,2) xy polyline, color)]
        point_color=(180, 180, 180),
        height_colormap: bool = True,
    ):
        img = Image.new("RGB", (self.size, self.size), self.background)
        draw = ImageDraw.Draw(img)
        if lines:
            for poly, color in lines:
                px = self._to_px(np.asarray(poly))
                draw.line(
                    [tuple(p) for p in px], fill=tuple(color), width=2
                )
        if points is not None:
            pts = np.asarray(points)
            if points_mask is not None:
                pts = pts[np.asarray(points_mask)]
            px = self._to_px(pts[:, :2])
            keep = (
                (px[:, 0] >= 0) & (px[:, 0] < self.size)
                & (px[:, 1] >= 0) & (px[:, 1] < self.size)
            )
            px = px[keep].astype(int)
            arr = np.array(img)
            if height_colormap and pts.shape[1] > 2:
                z = np.clip((pts[keep][:, 2] + 3) / 6, 0, 1)
                colors = np.stack([
                    (z * 255), np.full_like(z, 120), ((1 - z) * 255)
                ], -1).astype(np.uint8)
                arr[px[:, 1], px[:, 0]] = colors
            else:
                arr[px[:, 1], px[:, 0]] = point_color
            img = Image.fromarray(arr)
            draw = ImageDraw.Draw(img)
        if boxes:
            for corners, color in boxes:
                corners = np.asarray(corners)
                if corners.shape[-1] >= 2:
                    bev = self._to_px(corners[:, :2])
                    hull = bev[:4] if len(bev) >= 4 else bev
                    draw.polygon(
                        [tuple(p) for p in hull], outline=tuple(color),
                        width=2,
                    )
        return img


class PerspectiveRenderer:
    """Offscreen 3D renderer (numpy z-buffer point splatting).

    Mirrors the reference's open3d OffscreenRenderer setup
    (lidar_visualizer.py:251-307): a look-at camera (eye, center, z-up)
    with a vertical FOV, white background, height-colored points, and
    wireframe boxes / map polylines — without the open3d dependency.
    """

    def __init__(
        self,
        width: int = 1600,
        height: int = 900,
        fov_degrees: float = 60.0,
        eye=(-20.0, 0.0, 12.0),
        center=(10.0, 0.0, 0.0),
        up=(0.0, 0.0, 1.0),
        background=(255, 255, 255),
        point_radius: int = 1,
    ):
        self.width, self.height = width, height
        self.background = background
        self.point_radius = point_radius
        f = self.height / (2.0 * np.tan(np.radians(fov_degrees) / 2.0))
        self.intrinsic = np.array(
            [[f, 0, width / 2.0], [0, f, height / 2.0], [0, 0, 1.0]]
        )
        eye, center, up = map(np.asarray, (eye, center, up))
        fwd = center - eye
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross(fwd, up)
        right = right / np.linalg.norm(right)
        down = np.cross(fwd, right)
        # camera frame: x right, y down, z forward (canonical)
        rot = np.stack([right, down, fwd])  # world→camera rotation
        self.cam_from_world = np.eye(4)
        self.cam_from_world[:3, :3] = rot
        self.cam_from_world[:3, 3] = -rot @ eye

    def _project(self, pts: np.ndarray):
        cam = pts @ self.cam_from_world[:3, :3].T + self.cam_from_world[:3, 3]
        z = cam[:, 2]
        uvw = cam @ self.intrinsic.T
        uv = uvw[:, :2] / np.maximum(uvw[:, 2:3], 1e-6)
        return uv, z

    def render(
        self,
        points: Optional[np.ndarray] = None,
        points_mask: Optional[np.ndarray] = None,
        boxes: Optional[Sequence] = None,   # [(corners (8,3), color)]
        lines: Optional[Sequence] = None,   # [((N,3) polyline, color)]
        height_colormap: bool = True,
        point_color=(40, 40, 40),
    ):
        img = Image.new(
            "RGB", (self.width, self.height), tuple(self.background)
        )
        arr = np.array(img)
        if points is not None:
            pts = np.asarray(points)
            if points_mask is not None:
                pts = pts[np.asarray(points_mask)]
            uv, z = self._project(pts[:, :3])
            keep = (
                (z > 0.1)
                & (uv[:, 0] >= 0) & (uv[:, 0] < self.width)
                & (uv[:, 1] >= 0) & (uv[:, 1] < self.height)
            )
            uv, z, pts = uv[keep].astype(int), z[keep], pts[keep]
            if height_colormap:
                t = np.clip((pts[:, 2] + 3) / 6, 0, 1)
                colors = np.stack(
                    [t * 255, 80 + t * 100, (1 - t) * 255], -1
                ).astype(np.uint8)
            else:
                colors = np.tile(
                    np.asarray(point_color, np.uint8), (len(z), 1)
                )
            # painter's order: sort far→near so the final write at each
            # pixel is the nearest point
            order = np.argsort(-z)
            r = self.point_radius
            for du in range(-r + 1, r):
                for dv in range(-r + 1, r):
                    u = np.clip(uv[order, 0] + du, 0, self.width - 1)
                    v = np.clip(uv[order, 1] + dv, 0, self.height - 1)
                    arr[v, u] = colors[order]
        img = Image.fromarray(arr)
        draw = ImageDraw.Draw(img)

        def draw_polyline_3d(poly, color, close=False):
            poly = np.asarray(poly, float)
            uv, z = self._project(poly)
            n = len(poly)
            seg = range(n) if close else range(n - 1)
            for i in seg:
                a, b = i, (i + 1) % n
                if z[a] > 0.1 and z[b] > 0.1:
                    draw.line(
                        (uv[a, 0], uv[a, 1], uv[b, 0], uv[b, 1]),
                        fill=tuple(color), width=2,
                    )

        if lines:
            for poly, color in lines:
                draw_polyline_3d(poly, color)
        if boxes:
            edges = [
                (0, 1), (1, 3), (3, 2), (2, 0),
                (4, 5), (5, 7), (7, 6), (6, 4),
                (0, 4), (1, 5), (2, 6), (3, 7),
            ]
            for corners, color in boxes:
                corners = np.asarray(corners, float)
                uv, z = self._project(corners)
                for a, b in edges:
                    if z[a] > 0.1 and z[b] > 0.1:
                        draw.line(
                            (uv[a, 0], uv[a, 1], uv[b, 0], uv[b, 1]),
                            fill=tuple(color), width=2,
                        )
        return img


def render_sequence(
    point_frames: Sequence[np.ndarray],
    masks: Optional[Sequence] = None,
    perspective: bool = False,
    **kwargs,
) -> list:
    renderer = (
        PerspectiveRenderer(**kwargs) if perspective else BEVRenderer(**kwargs)
    )
    out = []
    for i, pts in enumerate(point_frames):
        mask = masks[i] if masks is not None else None
        out.append(renderer.render(points=pts, points_mask=mask))
    return out
