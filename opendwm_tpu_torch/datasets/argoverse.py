"""Argoverse 2 Sensor motion dataset (the port's copy of
``opendwm_tpu/datasets/argoverse.py``; pyarrow is imported when the
dataset is constructed).

Capability parity with reference src/dwm/datasets/argoverse.py (900 LoC):
zip-served sensor files discovered by path pattern
(``sensor/{split}/{scene}/sensors/{channel}/{timestamp}.*``), per-channel
timestamp-synchronized segment enumeration, feather tables (pyarrow) for
LiDAR sweeps / calibration / ego poses / annotations (``feather_query``
:190-214), projected 3D-box and HD-map rasters from the per-scene
``log_map_archive`` JSON (:216-507), and the canonical batch dict.

Camera model: Argoverse cameras are +x-forward in the sensor frame; the
standard camera frame conversion is folded into the projection like the
reference does.
"""

from __future__ import annotations

import json
import re
from typing import Optional

import numpy as np

from opendwm_tpu_torch.config import register
from opendwm_tpu_torch.datasets.common import (
    add_stub_key_data,
    find_nearest,
    get_transform,
    pad_points,
    project_line,
)

try:
    from PIL import Image, ImageDraw
except ImportError:  # pragma: no cover
    Image = ImageDraw = None


DEFAULT_3DBOX_COLOR_TABLE = {
    "PEDESTRIAN": (255, 0, 0),
    "BICYCLE": (128, 255, 0),
    "MOTORCYCLE": (0, 255, 128),
    "BUS": (128, 0, 255),
    "REGULAR_VEHICLE": (0, 0, 255),
    "LARGE_VEHICLE": (255, 255, 0),
    "BOX_TRUCK": (255, 255, 0),
    "TRUCK": (255, 255, 0),
    "VEHICULAR_TRAILER": (255, 255, 255),
}
DEFAULT_HDMAP_COLOR_TABLE = {
    "drivable_area": (0, 0, 255),
    "lane": (0, 255, 0),
    "ped_crossing": (255, 0, 0),
}
CORNERS = np.array(
    [[-0.5, -0.5, -0.5, 1], [-0.5, -0.5, 0.5, 1], [-0.5, 0.5, -0.5, 1],
     [-0.5, 0.5, 0.5, 1], [0.5, -0.5, -0.5, 1], [0.5, -0.5, 0.5, 1],
     [0.5, 0.5, -0.5, 1], [0.5, 0.5, 0.5, 1]], np.float64,
).T
EDGES = [
    (0, 1), (0, 2), (1, 3), (2, 3), (0, 4), (1, 5), (2, 6), (3, 7),
    (4, 5), (4, 6), (5, 7), (6, 7),
]
# Sensor frame (+x forward) → camera frame (+z forward).
CAM_FROM_SENSOR = np.array(
    [[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0], [0, 0, 0, 1]], np.float64
)


def feather_query(table: dict, key_column: str, key, columns: list):
    """Binary search a sorted feather column (reference :190-201)."""
    import bisect

    keys = table[key_column]
    i = bisect.bisect_left(keys, key)
    if i >= len(keys) or keys[i] != key:
        raise KeyError(key)
    return [table[c][i] for c in columns]


ROT_KEYS = ["qw", "qx", "qy", "qz"]
TRANS_KEYS = ["tx_m", "ty_m", "tz_m"]


@register(
    "ArgoverseDataset", aliases=("dwm.datasets.argoverse.MotionDataset",)
)
class MotionDataset:
    def __init__(
        self,
        fs,
        sequence_length: int,
        fps_stride_tuples: list,
        sensor_channels: list = ("cameras/ring_front_center",),
        hide_lidar: bool = False,
        enable_synchronization_check: bool = True,
        enable_camera_transforms: bool = False,
        enable_ego_transforms: bool = False,
        _3dbox_image_settings: Optional[dict] = None,
        hdmap_image_settings: Optional[dict] = None,
        _3dbox_bev_settings: Optional[dict] = None,
        hdmap_bev_settings: Optional[dict] = None,
        stub_key_data_dict: Optional[dict] = None,
        max_point_count: int = 32768,
    ):
        try:
            import pyarrow.feather
        except ImportError as e:
            raise ImportError("Argoverse dataset requires pyarrow") from e
        self._read_feather = pyarrow.feather.read_table
        self.fs = fs
        self.sequence_length = sequence_length
        self.sensor_channels = list(sensor_channels)
        self.hide_lidar = hide_lidar
        self.enable_camera_transforms = enable_camera_transforms
        self.enable_ego_transforms = enable_ego_transforms
        self._3dbox_image_settings = _3dbox_image_settings
        self.hdmap_image_settings = hdmap_image_settings
        self._3dbox_bev_settings = _3dbox_bev_settings
        self.hdmap_bev_settings = hdmap_bev_settings
        self.stub_key_data_dict = stub_key_data_dict
        self.max_point_count = max_point_count

        pattern = re.compile(
            r"^sensor/(?P<split>\w+)/(?P<scene>.*)/sensors/"
            r"(?P<channel>{})/(?P<ts>\d+).+$".format(
                "|".join(self.sensor_channels)
            )
        )
        map_pattern = re.compile(
            r"^sensor/(?P<split>\w+)/(?P<scene>.*)/map/"
            r"log_map_archive_.+\.json$"
        )

        self.filenames: dict[str, str] = {}
        self.maps: dict[str, str] = {}
        scene_csd: dict[str, list] = {}
        scene_split: dict[str, str] = {}
        for name in self._list_files():
            m = pattern.match(name)
            if m:
                scene = m.group("scene")
                scene_split[scene] = m.group("split")
                csd = scene_csd.setdefault(
                    scene, [[] for _ in self.sensor_channels]
                )
                rec = {
                    "timestamp": int(m.group("ts")),
                    "sensor": m.group("channel"),
                }
                self.filenames[
                    f"{scene}/{m.group('channel')}/{m.group('ts')}"
                ] = name
                for i, ch in enumerate(self.sensor_channels):
                    if ch == m.group("channel"):
                        csd[i].append(rec)
            mm = map_pattern.match(name)
            if mm:
                self.maps[mm.group("scene")] = name

        for csd in scene_csd.values():
            for sdl in csd:
                sdl.sort(key=lambda r: r["timestamp"])

        self.items = []
        for scene, csd in sorted(scene_csd.items()):
            if any(len(sdl) == 0 for sdl in csd):
                continue
            for fps, stride in fps_stride_tuples:
                for segment in self.enumerate_segments(
                    csd, sequence_length, fps, stride,
                    enable_synchronization_check,
                ):
                    self.items.append({
                        "segment": segment, "fps": fps, "scene": scene,
                        "split": scene_split[scene],
                    })
        self._table_cache: dict[str, dict] = {}

    def _list_files(self):
        if hasattr(self.fs, "_index"):  # czip fast path
            return list(self.fs._index.keys())
        return self.fs.find("")

    @staticmethod
    def enumerate_segments(
        csd, sequence_length, fps, stride, sync_check
    ):
        ch_ts = [[r["timestamp"] for r in sdl] for sdl in csd]
        if fps == 0:
            for t in range(0, len(csd[0]), max(1, stride)):
                ct0 = [
                    find_nearest(ts, csd[0][t]["timestamp"]) for ts in ch_ts
                ]
                if all(
                    t0 + sequence_length <= len(sdl)
                    for t0, sdl in zip(ct0, csd)
                ):
                    yield [
                        [sdl[t0 + i] for t0, sdl in zip(ct0, csd)]
                        for i in range(sequence_length)
                    ]
        else:
            duration_ns = sequence_length / fps * 1e9
            t = csd[0][0]["timestamp"]
            end = csd[0][-1]["timestamp"] - duration_ns
            while t <= end:
                expected = [
                    [t + i / fps * 1e9 for i in range(sequence_length)]
                    for _ in csd
                ]
                candidates = [
                    [sdl[find_nearest(ts, e)] for e in exp]
                    for sdl, ts, exp in zip(csd, ch_ts, expected)
                ]
                max_err = max(
                    abs(c["timestamp"] - e)
                    for cand, exp in zip(candidates, expected)
                    for c, e in zip(cand, exp)
                )
                if not sync_check or max_err <= 0.5e9 / fps:
                    yield [
                        [cand[i] for cand in candidates]
                        for i in range(sequence_length)
                    ]
                t += stride * 1e9

    # -- tables ------------------------------------------------------------------

    def _feather(self, path: str) -> dict:
        if path not in self._table_cache:
            with self.fs.open(path) as f:
                self._table_cache[path] = (
                    self._read_feather(f).to_pydict()
                )
        return self._table_cache[path]

    def _calibration(self, item):
        base = f"sensor/{item['split']}/{item['scene']}/calibration"
        return (
            self._feather(f"{base}/egovehicle_SE3_sensor.feather"),
            self._feather(f"{base}/intrinsics.feather"),
        )

    def _poses(self, item):
        return self._feather(
            f"sensor/{item['split']}/{item['scene']}/city_SE3_egovehicle"
            ".feather"
        )

    def _annotations(self, item):
        try:
            return self._feather(
                f"sensor/{item['split']}/{item['scene']}/annotations.feather"
            )
        except FileNotFoundError:
            return None

    def _pose_at(self, poses: dict, timestamp: int) -> np.ndarray:
        ts = poses["timestamp_ns"]
        i = find_nearest(ts, timestamp)
        return get_transform(
            [poses[k][i] for k in ROT_KEYS],
            [poses[k][i] for k in TRANS_KEYS],
        )

    # -- rasters -----------------------------------------------------------------

    def _image_from_world(self, item, sensor, timestamp, intrinsics,
                          extrinsics, poses):
        fx, fy, cx, cy, w, h = feather_query(
            intrinsics, "sensor_name", sensor.split("/")[-1],
            ["fx_px", "fy_px", "cx_px", "cy_px", "width_px", "height_px"],
        )
        k = np.eye(4)
        k[:3, :3] = [[fx, 0, cx], [0, fy, cy], [0, 0, 1]]
        ego_from_sensor = get_transform(
            feather_query(extrinsics, "sensor_name",
                          sensor.split("/")[-1], ROT_KEYS),
            feather_query(extrinsics, "sensor_name",
                          sensor.split("/")[-1], TRANS_KEYS),
        )
        world_from_ego = self._pose_at(poses, timestamp)
        sensor_from_world = np.linalg.inv(world_from_ego @ ego_from_sensor)
        return (k @ CAM_FROM_SENSOR @ sensor_from_world,
                int(w), int(h))

    def get_3dbox_image(self, item, sensor, timestamp, annotations,
                        intrinsics, extrinsics, poses, settings):
        view, w, h = self._image_from_world(
            item, sensor, timestamp, intrinsics, extrinsics, poses
        )
        world_from_ego = self._pose_at(poses, timestamp)
        image = Image.new("RGB", (w, h))
        if annotations is None:
            return image
        draw = ImageDraw.Draw(image)
        pen_width = settings.get("pen_width", 10)
        color_table = settings.get("color_table", DEFAULT_3DBOX_COLOR_TABLE)
        ts = np.asarray(annotations["timestamp_ns"])
        sel = np.nonzero(ts == timestamp)[0]
        for i in sel:
            cat = annotations["category"][i]
            if cat not in color_table:
                continue
            scale = np.diag([
                annotations["length_m"][i], annotations["width_m"][i],
                annotations["height_m"][i], 1.0,
            ])
            ego_from_ann = get_transform(
                [annotations[k][i] for k in ROT_KEYS],
                [annotations[k][i] for k in TRANS_KEYS],
            )
            p = view @ world_from_ego @ ego_from_ann @ scale @ CORNERS
            color = tuple(color_table[cat])
            for a, b in EDGES:
                xy = project_line(p[:, a], p[:, b])
                if xy is not None:
                    draw.line(xy, fill=color, width=pen_width)
        return image

    def get_hdmap_image(self, item, sensor, timestamp, intrinsics,
                        extrinsics, poses, settings):
        view, w, h = self._image_from_world(
            item, sensor, timestamp, intrinsics, extrinsics, poses
        )
        image = Image.new("RGB", (w, h))
        map_path = self.maps.get(item["scene"])
        if map_path is None:
            return image
        with self.fs.open(map_path) as f:
            city_map = json.load(f)
        draw = ImageDraw.Draw(image)
        pen_width = settings.get("pen_width", 10)
        color_table = settings.get("color_table", DEFAULT_HDMAP_COLOR_TABLE)
        max_distance = settings.get("max_distance", 65.0)

        def draw_polyline(points, color, close=False):
            pts = np.asarray(
                [[p["x"], p["y"], p["z"], 1.0] for p in points]
            ).T
            proj = view @ pts
            m = proj.shape[1]
            rng = range(m) if close else range(m - 1)
            for i in rng:
                xy = project_line(
                    proj[:, i], proj[:, (i + 1) % m], far_z=max_distance
                )
                if xy is not None:
                    draw.line(xy, fill=color, width=pen_width)

        if "lane" in color_table:
            for seg in city_map.get("lane_segments", {}).values():
                for side in ("left_lane_boundary", "right_lane_boundary"):
                    draw_polyline(
                        seg[side], tuple(color_table["lane"])
                    )
        if "ped_crossing" in color_table:
            for pc in city_map.get("pedestrian_crossings", {}).values():
                for edge in ("edge1", "edge2"):
                    draw_polyline(
                        pc[edge], tuple(color_table["ped_crossing"])
                    )
        if "drivable_area" in color_table:
            for da in city_map.get("drivable_areas", {}).values():
                draw_polyline(
                    da["area_boundary"],
                    tuple(color_table["drivable_area"]), close=True,
                )
        return image

    # -- BEV rasters (reference :374-507) -------------------------------------

    DEFAULT_BEV_FROM_EGO = [
        [6.4, 0, 0, 320], [0, -6.4, 0, 320], [0, 0, -6.4, 0], [0, 0, 0, 1],
    ]

    def get_3dbox_bev_image(self, item, timestamp, annotations, settings):
        size = settings.get("image_size", [640, 640])
        pen_width = settings.get("pen_width", 2)
        color_table = settings.get("color_table", DEFAULT_3DBOX_COLOR_TABLE)
        fill = settings.get("fill_box", False)
        bev_from_ego = np.asarray(
            settings.get("bev_from_ego_transform", self.DEFAULT_BEV_FROM_EGO)
        )
        image = Image.new("RGB", tuple(size))
        if annotations is None:
            return image
        draw = ImageDraw.Draw(image)
        ts = np.asarray(annotations["timestamp_ns"])
        for i in np.nonzero(ts == timestamp)[0]:
            cat = annotations["category"][i]
            if cat not in color_table:
                continue
            scale = np.diag([
                annotations["length_m"][i], annotations["width_m"][i],
                annotations["height_m"][i], 1.0,
            ])
            ego_from_ann = get_transform(
                [annotations[k][i] for k in ROT_KEYS],
                [annotations[k][i] for k in TRANS_KEYS],
            )
            p = bev_from_ego @ ego_from_ann @ scale @ CORNERS
            pts = [(p[0, j], p[1, j]) for j in (0, 1, 3, 2)]
            color = tuple(color_table[cat])
            if fill:
                draw.polygon(pts, fill=color)
            else:
                draw.polygon(pts, outline=color, width=pen_width)
        return image

    def get_hdmap_bev_image(self, item, timestamp, poses, settings):
        size = settings.get("image_size", [640, 640])
        pen_width = settings.get("pen_width", 2)
        color_table = settings.get("color_table", DEFAULT_HDMAP_COLOR_TABLE)
        bev_from_ego = np.asarray(
            settings.get("bev_from_ego_transform", self.DEFAULT_BEV_FROM_EGO)
        )
        image = Image.new("RGB", tuple(size))
        map_path = self.maps.get(item["scene"])
        if map_path is None:
            return image
        with self.fs.open(map_path) as f:
            city_map = json.load(f)
        draw = ImageDraw.Draw(image)
        view = bev_from_ego @ np.linalg.inv(self._pose_at(poses, timestamp))

        def draw_polyline(points, color, close=False):
            arr = np.asarray(
                [[p["x"], p["y"], p["z"], 1.0] for p in points]
            ).T
            proj = view @ arr
            pts = [(proj[0, i], proj[1, i]) for i in range(proj.shape[1])]
            if close:
                pts.append(pts[0])
            draw.line(pts, fill=tuple(color), width=pen_width)

        if "lane" in color_table:
            for seg in city_map.get("lane_segments", {}).values():
                for side in ("left_lane_boundary", "right_lane_boundary"):
                    draw_polyline(seg[side], color_table["lane"])
        if "ped_crossing" in color_table:
            for pc in city_map.get("pedestrian_crossings", {}).values():
                for edge in ("edge1", "edge2"):
                    draw_polyline(pc[edge], color_table["ped_crossing"])
        if "drivable_area" in color_table:
            for da in city_map.get("drivable_areas", {}).values():
                draw_polyline(
                    da["area_boundary"], color_table["drivable_area"],
                    close=True,
                )
        return image

    # -- items --------------------------------------------------------------------

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index: int) -> dict:
        item = self.items[index]
        segment = item["segment"]
        cam_idx = [
            i for i, ch in enumerate(self.sensor_channels)
            if ch.startswith("cameras")
        ]
        lidar_idx = [
            i for i, ch in enumerate(self.sensor_channels) if ch == "lidar"
        ]
        t0 = segment[0][0]["timestamp"]
        result: dict = {
            "fps": np.float32(item["fps"]),
            "pts": np.asarray(
                [
                    [(r["timestamp"] - t0) / 1e6 for r in frame]
                    for frame in segment
                ],
                np.float32,
            ),
        }

        images, lidar_list = [], []
        for frame in segment:
            row = []
            for i in cam_idx:
                r = frame[i]
                path = self.filenames[
                    f"{item['scene']}/{r['sensor']}/{r['timestamp']}"
                ]
                with self.fs.open(path) as f:
                    img = Image.open(f)
                    img.load()
                row.append(img)
            if row:
                images.append(row)
            for i in lidar_idx:
                r = frame[i]
                path = self.filenames[
                    f"{item['scene']}/{r['sensor']}/{r['timestamp']}"
                ]
                with self.fs.open(path) as f:
                    table = self._read_feather(f).to_pydict()
                lidar_list.append(
                    np.stack(
                        [table["x"], table["y"], table["z"]], -1
                    ).astype(np.float32)
                )
        if images:
            result["images"] = images
        if lidar_list and not self.hide_lidar:
            pts, mask = pad_points(lidar_list, self.max_point_count)
            result["lidar_points"] = pts
            result["lidar_points_mask"] = mask

        poses = self._poses(item)
        if self.enable_camera_transforms and cam_idx:
            extrinsics, intrinsics = self._calibration(item)
            ct, ci, sizes = [], [], []
            for frame in segment:
                ct.append([]), ci.append([]), sizes.append([])
                for i in cam_idx:
                    sensor = frame[i]["sensor"].split("/")[-1]
                    ego_from_sensor = get_transform(
                        feather_query(extrinsics, "sensor_name", sensor,
                                      ROT_KEYS),
                        feather_query(extrinsics, "sensor_name", sensor,
                                      TRANS_KEYS),
                    )
                    # camera_transforms contract: camera(+z fwd) → ego
                    ct[-1].append(
                        ego_from_sensor @ np.linalg.inv(CAM_FROM_SENSOR)
                    )
                    fx, fy, cx, cy, w, h = feather_query(
                        intrinsics, "sensor_name", sensor,
                        ["fx_px", "fy_px", "cx_px", "cy_px", "width_px",
                         "height_px"],
                    )
                    ci[-1].append(
                        np.asarray([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
                    )
                    sizes[-1].append([float(w), float(h)])
            result["camera_transforms"] = np.asarray(ct, np.float32)
            result["camera_intrinsics"] = np.asarray(ci, np.float32)
            result["image_size"] = np.asarray(sizes, np.float32)

        if self.enable_ego_transforms:
            result["ego_transforms"] = np.stack([
                np.stack([
                    self._pose_at(poses, r["timestamp"]) for r in frame
                ])
                for frame in segment
            ]).astype(np.float32)

        if self._3dbox_image_settings is not None and cam_idx:
            extrinsics, intrinsics = self._calibration(item)
            annotations = self._annotations(item)
            result["3dbox_images"] = [
                [
                    self.get_3dbox_image(
                        item, frame[i]["sensor"], frame[i]["timestamp"],
                        annotations, intrinsics, extrinsics, poses,
                        self._3dbox_image_settings,
                    )
                    for i in cam_idx
                ]
                for frame in segment
            ]
        if self.hdmap_image_settings is not None and cam_idx:
            extrinsics, intrinsics = self._calibration(item)
            result["hdmap_images"] = [
                [
                    self.get_hdmap_image(
                        item, frame[i]["sensor"], frame[i]["timestamp"],
                        intrinsics, extrinsics, poses,
                        self.hdmap_image_settings,
                    )
                    for i in cam_idx
                ]
                for frame in segment
            ]

        # BEV rasters use the lidar (or first-sensor) timestamp per frame.
        ref_idx = lidar_idx[0] if lidar_idx else 0
        if self._3dbox_bev_settings is not None:
            annotations = self._annotations(item)
            result["3dbox_bev_images"] = [
                self.get_3dbox_bev_image(
                    item, frame[ref_idx]["timestamp"], annotations,
                    self._3dbox_bev_settings,
                )
                for frame in segment
            ]
        if self.hdmap_bev_settings is not None:
            result["hdmap_bev_images"] = [
                self.get_hdmap_bev_image(
                    item, frame[ref_idx]["timestamp"], poses,
                    self.hdmap_bev_settings,
                )
                for frame in segment
            ]

        add_stub_key_data(self.stub_key_data_dict, result)
        return result
