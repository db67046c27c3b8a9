"""nuScenes motion dataset (the port's copy of
``opendwm_tpu/datasets/nuscenes.py``).

Capability parity with reference src/dwm/datasets/nuscenes.py (1136 LoC):
loads the 11 relational JSON tables with split pruning + binary-search
indices (:74-174), enumerates temporal segments by (fps, stride) with
timestamp synchronization checks (:222-331), decodes per-frame camera images
and LiDAR .bin point clouds (:385-408), rasterizes projected 3D-box
(:410-478) and HD-map (:508-568) condition images plus their BEV variants
(:649-780), and assembles the canonical batch dict (:931-1135).

Host-side only (numpy + PIL); LiDAR points are padded to
``max_point_count``, one shape a batch.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np

from opendwm_tpu_torch.config import register
from opendwm_tpu_torch.datasets import nuscenes_common
from opendwm_tpu_torch.datasets.common import (
    ReadonlyDictIndices,
    add_stub_key_data,
    align_image_description_crossview,
    find_nearest,
    get_transform,
    make_image_description_string,
    pad_points,
    project_line,
)

try:
    from PIL import Image, ImageDraw
except ImportError:  # pragma: no cover
    Image = ImageDraw = None


TABLE_NAMES = [
    "calibrated_sensor", "category", "ego_pose", "instance", "log", "map",
    "sample", "sample_annotation", "sample_data", "scene", "sensor",
]
PRUNE_TABLE_PLAN = [
    ("sample", "scene_token", "scene"),
    ("sample_data", "sample_token", "sample"),
    ("sample_annotation", "sample_token", "sample"),
]
INDEX_NAMES = [
    "calibrated_sensor.token", "category.token", "ego_pose.token",
    "instance.token", "log.token", "map.token", "sample.token",
    "sample_data.sample_token", "sample_data.token",
    "sample_annotation.sample_token", "sample_annotation.token",
    "scene.token", "sensor.token",
]

DEFAULT_3DBOX_COLOR_TABLE = {
    "human.pedestrian": (255, 0, 0),
    "vehicle.bicycle": (128, 255, 0),
    "vehicle.motorcycle": (0, 255, 128),
    "vehicle.bus": (128, 0, 255),
    "vehicle.car": (0, 0, 255),
    "vehicle.construction": (128, 128, 255),
    "vehicle.emergency": (255, 128, 128),
    "vehicle.trailer": (255, 255, 255),
    "vehicle.truck": (255, 255, 0),
}
DEFAULT_HDMAP_COLOR_TABLE = {
    "drivable_area": (0, 0, 255),
    "lane": (0, 255, 0),
    "ped_crossing": (255, 0, 0),
}
DEFAULT_CORNER_TEMPLATE = [
    [-0.5, -0.5, -0.5, 1], [-0.5, -0.5, 0.5, 1],
    [-0.5, 0.5, -0.5, 1], [-0.5, 0.5, 0.5, 1],
    [0.5, -0.5, -0.5, 1], [0.5, -0.5, 0.5, 1],
    [0.5, 0.5, -0.5, 1], [0.5, 0.5, 0.5, 1],
]
DEFAULT_EDGE_INDICES = [
    (0, 1), (0, 2), (1, 3), (2, 3), (0, 4), (1, 5),
    (2, 6), (3, 7), (4, 5), (4, 6), (5, 7), (6, 7),
    (6, 3), (6, 5),
]
DEFAULT_BEV_FROM_EGO = [
    [6.4, 0, 0, 320],
    [0, -6.4, 0, 320],
    [0, 0, -6.4, 0],
    [0, 0, 0, 1],
]
DEFAULT_BEV_CORNER_TEMPLATE = [
    [-0.5, -0.5, 0, 1], [-0.5, 0.5, 0, 1],
    [0.5, -0.5, 0, 1], [0.5, 0.5, 0, 1],
]
DEFAULT_BEV_EDGE_INDICES = [(0, 2), (2, 3), (3, 1), (1, 0)]


def _convex_hull(points: list) -> list:
    """Andrew's monotone chain; points pre-sorted by x then y."""
    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    lower: list = []
    for p in points:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], p) <= 0:
            lower.pop()
        lower.append(p)
    upper: list = []
    for p in reversed(points):
        while len(upper) >= 2 and cross(upper[-2], upper[-1], p) <= 0:
            upper.pop()
        upper.append(p)
    return lower[:-1] + upper[:-1]


@register("NuScenesDataset", aliases=("dwm.datasets.nuscenes.MotionDataset",))
class MotionDataset:
    """See module docstring. Args follow the reference signature."""

    def __init__(
        self,
        fs,
        dataset_name: str,
        sequence_length: int,
        fps_stride_tuples: list,
        split: Optional[str] = None,
        sensor_channels: list = ("CAM_FRONT",),
        keyframe_only: bool = False,
        enable_synchronization_check: bool = True,
        enable_scene_description: bool = False,
        enable_camera_transforms: bool = False,
        enable_ego_transforms: bool = False,
        _3dbox_image_settings: Optional[dict] = None,
        hdmap_image_settings: Optional[dict] = None,
        _3dbox_bev_settings: Optional[dict] = None,
        hdmap_bev_settings: Optional[dict] = None,
        foreground_region_image_settings: Optional[dict] = None,
        image_description_settings: Optional[dict] = None,
        stub_key_data_dict: Optional[dict] = None,
        max_point_count: int = 32768,
    ):
        self.fs = fs
        self.sequence_length = sequence_length
        self.sensor_channels = list(sensor_channels)
        self.keyframe_only = keyframe_only
        self.enable_scene_description = enable_scene_description
        self.enable_camera_transforms = enable_camera_transforms
        self.enable_ego_transforms = enable_ego_transforms
        self._3dbox_image_settings = _3dbox_image_settings
        self.hdmap_image_settings = hdmap_image_settings
        self._3dbox_bev_settings = _3dbox_bev_settings
        self.hdmap_bev_settings = hdmap_bev_settings
        self.foreground_region_image_settings = (
            foreground_region_image_settings
        )
        self.image_description_settings = image_description_settings
        self.stub_key_data_dict = stub_key_data_dict
        self.max_point_count = max_point_count

        self.tables, self.indices = self.load_tables(
            fs, dataset_name, split
        )

        # map expansion (lazy: only when hdmap settings present)
        self.map_expansion: dict = {}
        self.map_expansion_dict: dict = {}
        for settings in (hdmap_image_settings, hdmap_bev_settings):
            if settings and "map_expansion_paths" in settings:
                for loc, path in settings["map_expansion_paths"].items():
                    if loc in self.map_expansion:
                        continue
                    with fs.open(path) as f:
                        m = json.load(f)
                    self.map_expansion[loc] = m
                    self.map_expansion_dict[loc] = {
                        "node": {n["token"]: n for n in m.get("node", [])},
                        "polygon": {
                            p["token"]: p for p in m.get("polygon", [])
                        },
                    }

        if image_description_settings is not None:
            # caption files are local artifacts, not dataset-relative
            # (reference nuscenes.py:904-918 uses plain open); fall back to
            # the dataset fs for paths packaged alongside the tables.
            def _open_local(path):
                try:
                    return open(path, "r", encoding="utf-8")
                except OSError:
                    return fs.open(path)

            with _open_local(image_description_settings["path"]) as f:
                self.image_descriptions = json.load(f)
            self.image_desc_rs = np.random.RandomState(
                image_description_settings.get("seed", 0)
            )
            # DriveMLM caption files are keyed "{scene}|{channel}|{time}";
            # time_list_dict maps "{scene}|{channel}" → sorted timestamps
            # for nearest-time lookup (reference nuscenes.py:797-806).
            self.time_list_dict = None
            if "time_list_dict_path" in image_description_settings:
                with _open_local(
                    image_description_settings["time_list_dict_path"]
                ) as f:
                    self.time_list_dict = json.load(f)

        # enumerate all (scene, segment) items
        self.items = []
        for scene in self.tables["scene"]:
            samples = self.get_scene_samples(scene)
            channel_sdl = self.get_channel_sample_data(samples)
            if any(len(sdl) == 0 for sdl in channel_sdl):
                continue
            for fps, stride in fps_stride_tuples:
                for segment in self.enumerate_segments(
                    channel_sdl, sequence_length, fps, stride,
                    enable_synchronization_check,
                ):
                    self.items.append(
                        {"segment": segment, "fps": fps, "scene": scene}
                    )

    # -- table machinery ----------------------------------------------------

    def load_tables(self, fs, dataset_name: str, split):
        tables = {
            name: json.loads(
                fs.cat_file(f"{dataset_name}/{name}.json").decode()
            )
            for name in TABLE_NAMES
        }
        if split is not None:
            subset = set(getattr(nuscenes_common, split))
            tables["scene"] = [
                s for s in tables["scene"] if s["name"] in subset
            ]
            for table_name, fk, ref in PRUNE_TABLE_PLAN:
                tokens = set(i["token"] for i in tables[ref])
                tables[table_name] = [
                    i for i in tables[table_name] if i[fk] in tokens
                ]
        indices = {}
        for index_name in INDEX_NAMES:
            table_name, column = index_name.split(".")
            indices[index_name] = ReadonlyDictIndices(
                [i[column] for i in tables[table_name]]
            )
        return tables, indices

    def query(self, table_name: str, key: str, column: str = "token"):
        i = self.indices[f"{table_name}.{column}"][key]
        return self.tables[table_name][i]

    def query_range(self, table_name: str, key: str, column: str = "token"):
        idx = self.indices[f"{table_name}.{column}"].get_all_indices(key)
        return [self.tables[table_name][i] for i in idx]

    def get_scene_samples(self, scene: dict) -> list:
        result = []
        token = scene["first_sample_token"]
        while token != "":
            sample = self.query("sample", token)
            result.append(sample)
            token = sample["next"]
        return result

    def get_sensor(self, sample_data: dict) -> dict:
        cs = self.query(
            "calibrated_sensor", sample_data["calibrated_sensor_token"]
        )
        return self.query("sensor", cs["sensor_token"])

    def get_channel_sample_data(self, samples: list) -> list:
        """Time-ordered sample_data lists per requested sensor channel."""
        out = []
        for channel in self.sensor_channels:
            sdl = []
            for sample in samples:
                for sd in self.query_range(
                    "sample_data", sample["token"], column="sample_token"
                ):
                    if self.keyframe_only and not sd["is_key_frame"]:
                        continue
                    if self.get_sensor(sd)["channel"] == channel:
                        sdl.append(sd)
            sdl.sort(key=lambda i: i["timestamp"])
            out.append(sdl)
        return out

    # -- segment enumeration (reference :222-331) ----------------------------

    @staticmethod
    def enumerate_segments(
        channel_sample_data_list, sequence_length, fps, stride,
        enable_synchronization_check,
    ):
        csdl = channel_sample_data_list
        ch_ts = [[i["timestamp"] for i in sdl] for sdl in csdl]
        ch_kf_ts = [
            [i["timestamp"] for i in sdl if i["is_key_frame"]]
            for sdl in csdl
        ]
        if fps == 0:
            ch_kf_idx = [
                [j for j, i in enumerate(sdl) if i["is_key_frame"]]
                for sdl in csdl
            ]
            for t in range(0, len(csdl[0]), max(1, stride)):
                if stride != 0:
                    ct0 = [
                        find_nearest(tl, csdl[0][t]["timestamp"])
                        for tl in ch_ts
                    ]
                else:
                    ct0 = [
                        kfi[find_nearest(kft, csdl[0][t]["timestamp"])]
                        for kfi, kft in zip(ch_kf_idx, ch_kf_ts)
                    ]
                if (stride != 0 or csdl[0][t]["is_key_frame"]) and all(
                    t0 + sequence_length <= len(sdl)
                    for t0, sdl in zip(ct0, csdl)
                ):
                    yield [
                        [sdl[t0 + i]["token"]
                         for t0, sdl in zip(ct0, csdl)]
                        for i in range(sequence_length)
                    ]
        else:
            def begin_times(sdl):
                s = sdl[-1]["timestamp"] / 1e6 - sequence_length / fps
                if stride == 0:
                    for i in sdl:
                        t = i["timestamp"] / 1e6
                        if i["is_key_frame"] and t <= s:
                            yield t
                else:
                    t = sdl[0]["timestamp"] / 1e6
                    while t <= s:
                        yield t
                        t += stride

            ch_kf = [
                [i for i in sdl if i["is_key_frame"]] for sdl in csdl
            ]
            for t in begin_times(csdl[0]):
                if stride != 0:
                    ct0 = [t * 1e6 for _ in csdl]
                else:
                    ct0 = [
                        kfl[find_nearest(kft, t)]["timestamp"]
                        for kfl, kft in zip(ch_kf, ch_kf_ts)
                    ]
                expected = [
                    [t0 + i / fps * 1e6 for i in range(sequence_length)]
                    for t0 in ct0
                ]
                candidates = [
                    [sdl[find_nearest(ts, e)] for e in exp]
                    for sdl, ts, exp in zip(csdl, ch_ts, expected)
                ]
                max_err = max(
                    abs(c["timestamp"] - e)
                    for cand, exp in zip(candidates, expected)
                    for c, e in zip(cand, exp)
                )
                if not enable_synchronization_check or \
                        max_err <= 500000 / fps:
                    yield [
                        [cand[i]["token"] for cand in candidates]
                        for i in range(sequence_length)
                    ]

    # -- condition rasters ----------------------------------------------------

    def _image_from_world(self, sample_data: dict) -> np.ndarray:
        cs = self.query(
            "calibrated_sensor", sample_data["calibrated_sensor_token"]
        )
        intrinsic = np.eye(4)
        intrinsic[:3, :3] = np.asarray(cs["camera_intrinsic"])
        ego_from_camera = get_transform(cs["rotation"], cs["translation"])
        ego_pose = self.query("ego_pose", sample_data["ego_pose_token"])
        world_from_ego = get_transform(
            ego_pose["rotation"], ego_pose["translation"]
        )
        return intrinsic @ np.linalg.inv(world_from_ego @ ego_from_camera)

    def get_3dbox_image(self, sample_data: dict, settings: dict):
        pen_width = settings.get("pen_width", 8)
        color_table = settings.get("color_table", DEFAULT_3DBOX_COLOR_TABLE)
        corners_t = np.asarray(
            settings.get("corner_templates", DEFAULT_CORNER_TEMPLATE)
        ).T
        edges = settings.get("edge_indices", DEFAULT_EDGE_INDICES)

        image = Image.new(
            "RGB", (sample_data["width"], sample_data["height"])
        )
        if not sample_data["is_key_frame"]:
            return image
        draw = ImageDraw.Draw(image)
        image_from_world = self._image_from_world(sample_data)

        for sa in self.query_range(
            "sample_annotation", sample_data["sample_token"],
            column="sample_token",
        ):
            instance = self.query("instance", sa["instance_token"])
            category = self.query("category", instance["category_token"])
            color = None
            for prefix, c in color_table.items():
                if category["name"].startswith(prefix):
                    color = tuple(c)
                    break
            if color is None:
                continue
            scale = np.diag([sa["size"][1], sa["size"][0], sa["size"][2], 1])
            world_from_ann = get_transform(sa["rotation"], sa["translation"])
            p = image_from_world @ world_from_ann @ scale @ corners_t
            for a, b in edges:
                xy = project_line(p[:, a], p[:, b])
                if xy is not None:
                    draw.line(xy, fill=color, width=pen_width)
        return image

    def _draw_polygon(
        self, polygon, nodes, draw, transform, max_distance, color, width,
        bev=False, solid=False,
    ):
        def poly_pts(tokens):
            arr = np.asarray(
                [[nodes[t]["x"], nodes[t]["y"], 0, 1] for t in tokens]
            ).T
            return transform @ arr

        p = poly_pts(polygon["exterior_node_tokens"])
        if bev:
            pts = [(p[0, i], p[1, i]) for i in range(p.shape[1])]
            draw.polygon(
                pts, fill=color if solid else None,
                outline=None if solid else color, width=width,
            )
        else:
            m = p.shape[1]
            for i in range(m):
                xy = project_line(
                    p[:, i], p[:, (i + 1) % m], far_z=max_distance
                )
                if xy is not None:
                    draw.line(xy, fill=color, width=width)
        for hole in polygon.get("holes", []):
            p = poly_pts(hole["node_tokens"])
            if bev:
                pts = [(p[0, i], p[1, i]) for i in range(p.shape[1])]
                draw.polygon(
                    pts, fill=(0, 0, 0) if solid else None,
                    outline=None if solid else color, width=width,
                )
            else:
                m = p.shape[1]
                for i in range(m):
                    xy = project_line(
                        p[:, i], p[:, (i + 1) % m], far_z=max_distance
                    )
                    if xy is not None:
                        draw.line(xy, fill=color, width=width)

    def _map_for_sample_data(self, sample_data: dict):
        sample = self.query("sample", sample_data["sample_token"])
        scene = self.query("scene", sample["scene_token"])
        log = self.query("log", scene["log_token"])
        loc = log["location"]
        return self.map_expansion.get(loc), self.map_expansion_dict.get(loc)

    def get_foreground_region_image(self, sample_data: dict, settings: dict):
        """Filled projected-box mask marking foreground regions
        (reference :570-620): annotated objects render as solid white convex
        hulls on black."""
        corners_t = np.asarray(
            settings.get("corner_templates", DEFAULT_CORNER_TEMPLATE)
        ).T
        image = Image.new(
            "L", (sample_data["width"], sample_data["height"])
        )
        if not sample_data["is_key_frame"]:
            return image
        draw = ImageDraw.Draw(image)
        image_from_world = self._image_from_world(sample_data)
        for sa in self.query_range(
            "sample_annotation", sample_data["sample_token"],
            column="sample_token",
        ):
            scale = np.diag([sa["size"][1], sa["size"][0], sa["size"][2], 1])
            world_from_ann = get_transform(sa["rotation"], sa["translation"])
            p = image_from_world @ world_from_ann @ scale @ corners_t
            if (p[2] <= 0.05).all():
                continue
            pts = []
            for i in range(p.shape[1]):
                if p[2, i] > 0.05:
                    pts.append((p[0, i] / p[2, i], p[1, i] / p[2, i]))
            if len(pts) >= 3:
                # convex hull of the projected corners
                pts = sorted(pts)
                draw.polygon(_convex_hull(pts), fill=255)
        return image

    def get_hdmap_image(self, sample_data: dict, settings: dict):
        max_distance = settings.get("max_distance", 65.0)
        pen_width = settings.get("pen_width", 8)
        color_table = settings.get("color_table", DEFAULT_HDMAP_COLOR_TABLE)
        image = Image.new(
            "RGB", (sample_data["width"], sample_data["height"])
        )
        m, md = self._map_for_sample_data(sample_data)
        if m is None:
            return image
        draw = ImageDraw.Draw(image)
        image_from_world = self._image_from_world(sample_data)
        nodes, polygons = md["node"], md["polygon"]

        def draw_layer(layer, color, solid=False, bev=False):
            for element in m.get(layer, []):
                tokens = element.get("polygon_tokens") or [
                    element["polygon_token"]
                ]
                for pt in tokens:
                    self._draw_polygon(
                        polygons[pt], nodes, draw, image_from_world,
                        max_distance, tuple(color), pen_width, bev=bev,
                        solid=solid,
                    )

        for layer in ("lane", "drivable_area", "ped_crossing"):
            if layer in color_table and layer in m:
                draw_layer(layer, color_table[layer])
        return image

    def _bev_transform(self, sample_data: dict, settings: dict):
        bev_from_ego = np.asarray(
            settings.get("bev_from_ego_transform", DEFAULT_BEV_FROM_EGO)
        )
        ego_pose = self.query("ego_pose", sample_data["ego_pose_token"])
        world_from_ego = get_transform(
            ego_pose["rotation"], ego_pose["translation"]
        )
        return bev_from_ego @ np.linalg.inv(world_from_ego)

    def get_3dbox_bev_image(self, sample_data: dict, settings: dict):
        pen_width = settings.get("pen_width", 2)
        color_table = settings.get("color_table", DEFAULT_3DBOX_COLOR_TABLE)
        corners_t = np.asarray(
            settings.get("corner_templates", DEFAULT_BEV_CORNER_TEMPLATE)
        ).T
        edges = settings.get("edge_indices", DEFAULT_BEV_EDGE_INDICES)
        fill = settings.get("fill_box", False)
        size = settings.get("image_size", [640, 640])
        image = Image.new("RGB", tuple(size))
        draw = ImageDraw.Draw(image)
        bev_from_world = self._bev_transform(sample_data, settings)
        for sa in self.query_range(
            "sample_annotation", sample_data["sample_token"],
            column="sample_token",
        ):
            instance = self.query("instance", sa["instance_token"])
            category = self.query("category", instance["category_token"])
            color = None
            for prefix, c in color_table.items():
                if category["name"].startswith(prefix):
                    color = tuple(c)
                    break
            if color is None:
                continue
            scale = np.diag([sa["size"][1], sa["size"][0], sa["size"][2], 1])
            world_from_ann = get_transform(sa["rotation"], sa["translation"])
            p = bev_from_world @ world_from_ann @ scale @ corners_t
            pts = [(p[0, i], p[1, i]) for i in range(p.shape[1])]
            if fill:
                hull = [pts[i] for i in (0, 1, 3, 2)]
                draw.polygon(hull, fill=color)
            else:
                for a, b in edges:
                    draw.line(
                        (pts[a][0], pts[a][1], pts[b][0], pts[b][1]),
                        fill=color, width=pen_width,
                    )
        return image

    def get_hdmap_bev_image(self, sample_data: dict, settings: dict):
        pen_width = settings.get("pen_width", 2)
        color_table = settings.get("color_table", DEFAULT_HDMAP_COLOR_TABLE)
        size = settings.get("image_size", [640, 640])
        image = Image.new("RGB", tuple(size))
        m, md = self._map_for_sample_data(sample_data)
        if m is None:
            return image
        draw = ImageDraw.Draw(image)
        bev_from_world = self._bev_transform(sample_data, settings)
        nodes, polygons = md["node"], md["polygon"]
        for layer in ("drivable_area", "lane", "ped_crossing"):
            if layer not in color_table or layer not in m:
                continue
            for element in m[layer]:
                tokens = element.get("polygon_tokens") or [
                    element["polygon_token"]
                ]
                for pt in tokens:
                    self._draw_polygon(
                        polygons[pt], nodes, draw, bev_from_world, 0.0,
                        tuple(color_table[layer]), pen_width, bev=True,
                        solid=settings.get("solid", False),
                    )
        return image

    # -- item assembly ----------------------------------------------------------

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index: int) -> dict:
        item = self.items[index]
        segment = item["segment"]  # (t, channels) of sample_data tokens
        result: dict = {"fps": np.float32(item["fps"])}
        if self.enable_scene_description:
            result["scene_description"] = item["scene"]["description"]

        frames = [
            [self.query("sample_data", token) for token in frame]
            for frame in segment
        ]
        cam_idx = [
            i for i, ch in enumerate(self.sensor_channels)
            if not ch.startswith("LIDAR")
        ]
        lidar_idx = [
            i for i, ch in enumerate(self.sensor_channels)
            if ch.startswith("LIDAR")
        ]

        result["pts"] = np.asarray(
            [[sd["timestamp"] / 1000 for sd in frame] for frame in frames],
            np.float32,
        )

        images, lidar_points = [], []
        for frame in frames:
            view_images = []
            for i in cam_idx:
                sd = frame[i]
                with self.fs.open(sd["filename"]) as f:
                    img = Image.open(f)
                    img.load()
                view_images.append(img)
            if view_images:
                images.append(view_images)
            for i in lidar_idx:
                sd = frame[i]
                data = np.frombuffer(
                    self.fs.cat_file(sd["filename"]), dtype=np.float32
                )
                lidar_points.append(data.reshape(-1, 5)[:, :3].copy())
        if images:
            result["images"] = images
        if lidar_points:
            pts, mask = pad_points(lidar_points, self.max_point_count)
            result["lidar_points"] = pts
            result["lidar_points_mask"] = mask

        if self.enable_camera_transforms and cam_idx:
            ct, ci, isize = [], [], []
            for frame in frames:
                ct.append([]), ci.append([]), isize.append([])
                for i in cam_idx:
                    sd = frame[i]
                    cs = self.query(
                        "calibrated_sensor", sd["calibrated_sensor_token"]
                    )
                    ct[-1].append(
                        get_transform(cs["rotation"], cs["translation"])
                    )
                    ci[-1].append(np.asarray(cs["camera_intrinsic"]))
                    isize[-1].append([sd["width"], sd["height"]])
            result["camera_transforms"] = np.asarray(ct, np.float32)
            result["camera_intrinsics"] = np.asarray(ci, np.float32)
            result["image_size"] = np.asarray(isize, np.float32)
        if self.enable_camera_transforms and lidar_idx:
            lt = []
            for frame in frames:
                lt.append([])
                for i in lidar_idx:
                    sd = frame[i]
                    cs = self.query(
                        "calibrated_sensor", sd["calibrated_sensor_token"]
                    )
                    lt[-1].append(
                        get_transform(cs["rotation"], cs["translation"])
                    )
            result["lidar_transforms"] = np.asarray(lt, np.float32)

        if self.enable_ego_transforms:
            et = []
            for frame in frames:
                et.append([])
                for sd in frame:
                    ego = self.query("ego_pose", sd["ego_pose_token"])
                    et[-1].append(
                        get_transform(ego["rotation"], ego["translation"])
                    )
            result["ego_transforms"] = np.asarray(et, np.float32)

        if self._3dbox_image_settings is not None:
            result["3dbox_images"] = [
                [
                    self.get_3dbox_image(frame[i], self._3dbox_image_settings)
                    for i in cam_idx
                ]
                for frame in frames
            ]
        if self.hdmap_image_settings is not None:
            result["hdmap_images"] = [
                [
                    self.get_hdmap_image(frame[i], self.hdmap_image_settings)
                    for i in cam_idx
                ]
                for frame in frames
            ]
        if self.foreground_region_image_settings is not None:
            result["foreground_region_images"] = [
                [
                    self.get_foreground_region_image(
                        frame[i], self.foreground_region_image_settings
                    )
                    for i in cam_idx
                ]
                for frame in frames
            ]
        if self._3dbox_bev_settings is not None:
            ref = lidar_idx[0] if lidar_idx else 0
            result["3dbox_bev_images"] = [
                self.get_3dbox_bev_image(frame[ref], self._3dbox_bev_settings)
                for frame in frames
            ]
        if self.hdmap_bev_settings is not None:
            ref = lidar_idx[0] if lidar_idx else 0
            result["hdmap_bev_images"] = [
                self.get_hdmap_bev_image(frame[ref], self.hdmap_bev_settings)
                for frame in frames
            ]

        if self.image_description_settings is not None:
            captions = []
            for frame in frames:
                frame_caps = []
                for i in cam_idx:
                    sd = frame[i]
                    if self.time_list_dict is not None:
                        scene_camera = "{}|{}".format(
                            item["scene"]["token"], self.sensor_channels[i]
                        )
                        tl = self.time_list_dict[scene_camera]
                        nearest = tl[find_nearest(tl, sd["timestamp"])]
                        cap = self.image_descriptions.get(
                            f"{scene_camera}|{nearest}", {}
                        )
                    else:
                        key = sd["filename"].split(".")[0].split("/")[-1]
                        cap = self.image_descriptions.get(key, {})
                    frame_caps.append(dict(cap))
                align_image_description_crossview(
                    frame_caps, self.image_description_settings
                )
                captions.append([
                    make_image_description_string(
                        c, self.image_description_settings,
                        self.image_desc_rs,
                    ) if c else ""
                    for c in frame_caps
                ])
            result["image_description"] = captions

        add_stub_key_data(self.stub_key_data_dict, result)
        return result
