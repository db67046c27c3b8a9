"""Carla live streaming data adapter (the port's copy of
``opendwm_tpu/datasets/carla_streaming.py``).

Capability parity with reference src/dwm/datasets/carla_streaming.py
(727 LoC): attaches to a running Carla world, collects camera buffers per
tick (:539-562), assembles the same canonical batch dict as the offline
datasets — including 3dbox condition rasters projected from live actor
transforms and HD-map rasters from the OpenDRIVE XML (:230-459) — and turns
weather/sun state into a text prompt (:564-586).

The adapter needs no Carla Python API: it talks to a *client protocol* (duck-typed): anything exposing ``get_world()`` with
``tick() / get_weather() / get_actors() / get_map()`` works — the real
``carla.Client`` when present, or a simulation stub (tests ship
``FakeCarlaClient``). All geometry/rasterization is shared with
datasets.common.
"""

from __future__ import annotations

import math
import xml.etree.ElementTree as ET
from typing import Optional

import numpy as np

from opendwm_tpu_torch.config import register
from opendwm_tpu_torch.datasets.common import (
    BOX_CORNER_TEMPLATES,
    BOX_EDGE_INDICES,
    add_stub_key_data,
    project_line,
)

try:
    from PIL import Image, ImageDraw
except ImportError:  # pragma: no cover
    Image = ImageDraw = None

DEFAULT_COLOR_TABLE = {
    "vehicle": (0, 0, 255),
    "walker.pedestrian": (255, 0, 0),
}
LANE_COLOR = (0, 255, 0)


def weather_to_prompt(weather, environment_description: str) -> str:
    """Sun/precipitation/fog/cloud state → text prompt
    (reference :564-586)."""
    time_prompt = (
        "daytime" if weather.sun_altitude_angle > 5.0
        else "sunset" if weather.sun_altitude_angle > -5 else "night"
    )
    if weather.precipitation > 30:
        weather_prompt = "rainy"
    elif weather.fog_density > 50:
        weather_prompt = "foggy"
    elif weather.cloudiness > 70:
        weather_prompt = "overcast"
    elif weather.cloudiness > 30:
        weather_prompt = "cloudy"
    else:
        weather_prompt = "clear sky"
    return f"{time_prompt}. {weather_prompt}. {environment_description}"


def intrinsics_from_fov(width: int, height: int, fov_deg: float):
    f = width / (2.0 * math.tan(math.radians(fov_deg) / 2.0))
    return np.asarray(
        [[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]], np.float64
    )


def carla_transform_to_matrix(transform) -> np.ndarray:
    """Carla Transform (UE4 left-handed, degrees) → right-handed 4x4.

    Follows the standard Carla convention: x forward, y right (flipped to
    left for the ego frame), z up.
    """
    loc = transform.location
    rot = transform.rotation
    cy, sy = math.cos(math.radians(rot.yaw)), math.sin(math.radians(rot.yaw))
    cp, sp = (
        math.cos(math.radians(rot.pitch)), math.sin(math.radians(rot.pitch))
    )
    cr, sr = (
        math.cos(math.radians(rot.roll)), math.sin(math.radians(rot.roll))
    )
    mat = np.eye(4)
    mat[0, 0] = cp * cy
    mat[0, 1] = cy * sp * sr - sy * cr
    mat[0, 2] = -cy * sp * cr - sy * sr
    mat[1, 0] = cp * sy
    mat[1, 1] = sy * sp * sr + cy * cr
    mat[1, 2] = -sy * sp * cr + cy * sr
    mat[2, 0] = sp
    mat[2, 1] = -cp * sr
    mat[2, 2] = cp * cr
    mat[:3, 3] = [loc.x, loc.y, loc.z]
    # UE4 left-handed → right-handed (flip y)
    flip = np.diag([1.0, -1.0, 1.0, 1.0])
    return flip @ mat @ flip


# camera local frame (x fwd) → image camera frame (z fwd)
CAM_FROM_ACTOR = np.array(
    [[0, 1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0], [0, 0, 0, 1]], np.float64
)


def extract_opendrive_lines(xodr_text: str, samples_per_road: int = 16):
    """Road reference lines from an OpenDRIVE map (straight-line and arc
    geometry records), world-space polylines (reference extract_lines)."""
    root = ET.fromstring(xodr_text)
    lines = []
    for road in root.findall("road"):
        plan = road.find("planView")
        if plan is None:
            continue
        for geom in plan.findall("geometry"):
            x = float(geom.get("x"))
            y = float(geom.get("y"))
            hdg = float(geom.get("hdg"))
            length = float(geom.get("length"))
            arc = geom.find("arc")
            pts = []
            if arc is not None:
                curv = float(arc.get("curvature"))
                for i in range(samples_per_road + 1):
                    s = length * i / samples_per_road
                    ang = hdg + curv * s
                    if abs(curv) > 1e-9:
                        px = x + (math.sin(ang) - math.sin(hdg)) / curv
                        py = y - (math.cos(ang) - math.cos(hdg)) / curv
                    else:
                        px = x + s * math.cos(hdg)
                        py = y + s * math.sin(hdg)
                    pts.append((px, py))
            else:
                pts = [
                    (x + s * math.cos(hdg), y + s * math.sin(hdg))
                    for s in (0.0, length)
                ]
            lines.append(pts)
    return lines


@register(
    "StreamingDataAdapter",
    aliases=("dwm.datasets.carla_streaming.StreamingDataAdapter",),
)
class StreamingDataAdapter:
    def __init__(
        self,
        client,
        sensor_channels: list,
        environment_description: str = "urban street scene.",
        fps: Optional[float] = None,
        image_size: tuple = (448, 256),
        fov_deg: float = 90.0,
        _3dbox_image_settings: Optional[dict] = None,
        hdmap_image_settings: Optional[dict] = None,
        stub_key_data_dict: Optional[dict] = None,
    ):
        self.client = client
        self.sensor_channels = list(sensor_channels)
        self.environment_description = environment_description
        self.image_size = tuple(image_size)
        self.fov_deg = fov_deg
        self._3dbox_image_settings = _3dbox_image_settings or {}
        self.hdmap_image_settings = hdmap_image_settings
        self.stub_key_data_dict = stub_key_data_dict

        self.world = client.get_world()
        self.fps = fps or 10.0
        self.map_lines = (
            extract_opendrive_lines(self.world.get_map().to_opendrive())
            if hdmap_image_settings is not None else []
        )

        self.ego = None
        self.actors = []
        self.cameras = {}
        for actor in self.world.get_actors():
            role = getattr(actor, "attributes", {}).get("role_name", "")
            type_id = getattr(actor, "type_id", "")
            if role == "hero":
                self.ego = actor
            elif type_id.startswith("sensor.camera"):
                self.cameras[role] = actor
            elif type_id.startswith(("vehicle", "walker.pedestrian")):
                self.actors.append(actor)

    # -- per-view transforms ---------------------------------------------------

    def _camera_matrices(self, channel: str):
        w, h = self.image_size
        intr = intrinsics_from_fov(w, h, self.fov_deg)
        cam_actor = self.cameras.get(channel)
        if cam_actor is not None:
            world_from_cam = carla_transform_to_matrix(
                cam_actor.get_transform()
            ) @ np.linalg.inv(CAM_FROM_ACTOR)
        else:
            world_from_cam = np.eye(4)
        return intr, world_from_cam

    def _ego_matrix(self):
        if self.ego is None:
            return np.eye(4)
        return carla_transform_to_matrix(self.ego.get_transform())

    # -- rasters -------------------------------------------------------------------

    def _draw_3dbox(self, image_from_world):
        w, h = self.image_size
        image = Image.new("RGB", (w, h))
        draw = ImageDraw.Draw(image)
        pen_width = self._3dbox_image_settings.get("pen_width", 4)
        color_table = self._3dbox_image_settings.get(
            "color_table", DEFAULT_COLOR_TABLE
        )
        corners = np.asarray(BOX_CORNER_TEMPLATES).T
        for actor in self.actors:
            type_id = actor.type_id
            color = None
            for prefix, c in color_table.items():
                if type_id.startswith(prefix):
                    color = tuple(c)
                    break
            if color is None:
                continue
            ext = actor.bounding_box.extent
            scale = np.diag([2 * ext.x, 2 * ext.y, 2 * ext.z, 1.0])
            world_from_actor = carla_transform_to_matrix(
                actor.get_transform()
            )
            p = image_from_world @ world_from_actor @ scale @ corners
            for a, b in BOX_EDGE_INDICES:
                xy = project_line(p[:, a], p[:, b])
                if xy is not None:
                    draw.line(xy, fill=color, width=pen_width)
        return image

    def _draw_hdmap(self, image_from_world):
        w, h = self.image_size
        image = Image.new("RGB", (w, h))
        draw = ImageDraw.Draw(image)
        pen_width = (self.hdmap_image_settings or {}).get("pen_width", 4)
        for line in self.map_lines:
            pts = np.asarray(
                [[x, y, 0.0, 1.0] for x, y in line]
            ).T
            proj = image_from_world @ pts
            for i in range(proj.shape[1] - 1):
                xy = project_line(proj[:, i], proj[:, i + 1], far_z=80.0)
                if xy is not None:
                    draw.line(xy, fill=LANE_COLOR, width=pen_width)
        return image

    # -- tick ------------------------------------------------------------------------

    def query_data(self) -> dict:
        """One simulator tick → single-frame canonical batch
        (b=1, t=1, v=len(sensor_channels))."""
        self.world.tick()
        v = len(self.sensor_channels)
        w, h = self.image_size

        prompt = weather_to_prompt(
            self.world.get_weather(), self.environment_description
        )
        ego = self._ego_matrix()

        cam_t, cam_k, box_images, hdmap_images = [], [], [], []
        for channel in self.sensor_channels:
            intr, world_from_cam = self._camera_matrices(channel)
            k4 = np.eye(4)
            k4[:3, :3] = intr
            image_from_world = k4 @ np.linalg.inv(world_from_cam)
            cam_k.append(intr)
            cam_t.append(np.linalg.inv(ego) @ world_from_cam)
            if self._3dbox_image_settings is not None:
                box_images.append(self._draw_3dbox(image_from_world))
            if self.hdmap_image_settings is not None:
                hdmap_images.append(self._draw_hdmap(image_from_world))

        item = {
            "fps": np.float32(self.fps),
            "pts": np.zeros((1, 1, v), np.float32),
            "camera_transforms": np.asarray(cam_t, np.float32)[None, None],
            "camera_intrinsics": np.asarray(cam_k, np.float32)[None, None],
            "image_size": np.full((1, 1, v, 2), [w, h], np.float32),
            "ego_transforms": np.broadcast_to(
                ego.astype(np.float32), (1, 1, v + 1, 4, 4)
            ).copy(),
            "image_description": [[[prompt] * v]],
        }
        if box_images:
            item["3dbox_images"] = (
                np.stack(
                    [np.asarray(im, np.float32) / 255.0 for im in box_images]
                )[None, None]
            )
        if hdmap_images:
            item["hdmap_images"] = (
                np.stack(
                    [np.asarray(im, np.float32) / 255.0
                     for im in hdmap_images]
                )[None, None]
            )
        add_stub_key_data(self.stub_key_data_dict, item)
        return item
