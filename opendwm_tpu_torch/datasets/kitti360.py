"""KITTI-360 LiDAR motion dataset (the port's copy of
``opendwm_tpu/datasets/kitti360.py``).

Capability parity with reference src/dwm/datasets/kitti360.py (507 LoC):
velodyne ``.bin`` sweeps served from (zip) filesystems, drive-based
train/val split (drives 0000/0002 = val), sparse GPS pose tables with
quaternion-slerp interpolation to per-frame poses (:203-266), 3D bounding
boxes parsed from the annotation XML and rasterized to BEV layout images
(:268-341), canonical batch assembly with stub alignment (:342-470).

LiDAR-only (the reference keeps camera keys as stubs); points padded to
``max_point_count``, one shape a batch.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from collections import defaultdict
from typing import Optional

import numpy as np

from opendwm_tpu_torch.config import register
from opendwm_tpu_torch.datasets.common import add_stub_key_data, pad_points

try:
    from PIL import Image, ImageDraw
except ImportError:  # pragma: no cover
    Image = ImageDraw = None


# KITTI-360 semantic ids → canonical label names (public label table).
SEMANTIC_ID_TO_LABEL = {
    24: "person", 25: "rider", 26: "car", 27: "truck", 28: "bus",
    29: "caravan", 30: "trailer", 32: "motorcycle", 33: "bicycle",
}
LABEL_MAPPING = {
    "person": "human.pedestrian",
    "rider": "human.pedestrian",
    "car": "vehicle.car",
    "truck": "vehicle.truck",
    "bus": "vehicle.bus",
    "motorcycle": "vehicle.motorcycle",
    "bicycle": "vehicle.bicycle",
    "trailer": "vehicle.trailer",
}
DEFAULT_COLOR_TABLE = {
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
DEFAULT_BEV_FROM_EGO = [
    [6.4, 0, 0, 320], [0, -6.4, 0, 320], [0, 0, -6.4, 0], [0, 0, 0, 1],
]
DEFAULT_GPS_TO_EGO = [
    [1, 0, 0, -0.05], [0, -1, 0, 0.32], [0, 0, -1, 0.60], [0, 0, 0, 1],
]
BEV_CORNERS = np.array(
    [[-0.5, -0.5, -0.5, 1], [-0.5, -0.5, 0.5, 1], [-0.5, 0.5, -0.5, 1],
     [-0.5, 0.5, 0.5, 1], [0.5, -0.5, -0.5, 1], [0.5, -0.5, 0.5, 1],
     [0.5, 0.5, -0.5, 1], [0.5, 0.5, 0.5, 1]], np.float32,
)
BEV_EDGES = [(0, 2), (2, 6), (6, 4), (4, 0)]


def mat_to_quat(r: np.ndarray) -> np.ndarray:
    """Rotation matrix → (w, x, y, z) quaternion (Shepperd's method)."""
    t = np.trace(r)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([
            0.25 * s, (r[2, 1] - r[1, 2]) / s, (r[0, 2] - r[2, 0]) / s,
            (r[1, 0] - r[0, 1]) / s,
        ])
    i = int(np.argmax(np.diag(r)))
    if i == 0:
        s = np.sqrt(1.0 + r[0, 0] - r[1, 1] - r[2, 2]) * 2
        return np.array([
            (r[2, 1] - r[1, 2]) / s, 0.25 * s, (r[0, 1] + r[1, 0]) / s,
            (r[0, 2] + r[2, 0]) / s,
        ])
    if i == 1:
        s = np.sqrt(1.0 - r[0, 0] + r[1, 1] - r[2, 2]) * 2
        return np.array([
            (r[0, 2] - r[2, 0]) / s, (r[0, 1] + r[1, 0]) / s, 0.25 * s,
            (r[1, 2] + r[2, 1]) / s,
        ])
    s = np.sqrt(1.0 - r[0, 0] - r[1, 1] + r[2, 2]) * 2
    return np.array([
        (r[1, 0] - r[0, 1]) / s, (r[0, 2] + r[2, 0]) / s,
        (r[1, 2] + r[2, 1]) / s, 0.25 * s,
    ])


def quat_slerp(q1: np.ndarray, q2: np.ndarray, t: float) -> np.ndarray:
    dot = float(np.sum(q1 * q2))
    if dot < 0:
        q2, dot = -q2, -dot
    if dot > 0.9995:
        out = q1 + t * (q2 - q1)
        return out / np.linalg.norm(out)
    theta0 = np.arccos(dot)
    s0 = np.sin((1 - t) * theta0) / np.sin(theta0)
    s1 = np.sin(t * theta0) / np.sin(theta0)
    return s0 * q1 + s1 * q2


def interpolate_pose(pose1: np.ndarray, pose2: np.ndarray, num_steps: int):
    """num_steps-1 intermediate 4x4 poses: slerp rotation + lerp translation
    (reference :203-266)."""
    from opendwm_tpu_torch.datasets.common import quaternion_to_matrix

    q1 = mat_to_quat(pose1[:3, :3])
    q2 = mat_to_quat(pose2[:3, :3])
    out = []
    for step in range(1, num_steps):
        t = step / num_steps
        pose = np.eye(4)
        pose[:3, :3] = quaternion_to_matrix(quat_slerp(q1, q2, t))
        pose[:3, 3] = pose1[:3, 3] + t * (pose2[:3, 3] - pose1[:3, 3])
        out.append(pose)
    return out


@register(
    "Kitti360Dataset", aliases=("dwm.datasets.kitti360.MotionDataset",)
)
class MotionDataset:
    def __init__(
        self,
        fs,
        dataset_name: str = "",
        sequence_length: int = 2,
        fps_stride_tuples: list = ((0, 1),),
        split: Optional[str] = None,
        enable_ego_transforms: bool = False,
        _3dbox_bev_settings: Optional[dict] = None,
        stub_key_data_dict: Optional[dict] = None,
        max_point_count: int = 32768,
    ):
        self.fs = fs
        self.sequence_length = sequence_length
        self.enable_ego_transforms = enable_ego_transforms
        self._3dbox_bev_settings = _3dbox_bev_settings
        self.stub_key_data_dict = stub_key_data_dict
        self.max_point_count = max_point_count

        full_list = sorted(
            p for p in fs.find("") if p.endswith(".bin")
        )
        if split == "train":
            full_list = [
                p for p in full_list
                if "0000_sync" not in p and "0002_sync" not in p
            ]
        elif split == "val":
            full_list = [
                p for p in full_list
                if "0000_sync" in p or "0002_sync" in p
            ]

        groups: dict[str, list[str]] = defaultdict(list)
        for path in full_list:
            base = next(
                (part for part in path.split("/") if "_sync" in part),
                os.path.dirname(path),
            )
            groups[base].append(path)

        self.poses: dict[str, dict[int, np.ndarray]] = {}
        self.bboxes: dict[str, Optional[ET.Element]] = {}
        for base in groups:
            pose_path = f"data_poses/{base}/poses.txt"
            self.poses[base] = {}
            if fs.exists(pose_path):
                for line in fs.cat_file(pose_path).decode().splitlines():
                    parts = line.split()
                    if len(parts) < 13:
                        continue
                    pose = np.eye(4, dtype=np.float32)
                    pose[:3, :] = np.asarray(
                        parts[1:13], np.float32
                    ).reshape(3, 4)
                    self.poses[base][int(parts[0])] = pose
            bbox_path = f"data_3d_bboxes/train/{base}.xml"
            self.bboxes[base] = None
            if _3dbox_bev_settings is not None and fs.exists(bbox_path):
                with fs.open(bbox_path, "rb") as f:
                    self.bboxes[base] = ET.parse(f).getroot()

        self.segments = []
        for base, files in sorted(groups.items()):
            files = sorted(files)
            for fps, stride in fps_stride_tuples:
                for i in range(
                    0, len(files) - sequence_length + 1, max(1, int(stride))
                ):
                    self.segments.append({
                        "files": files[i: i + sequence_length],
                        "scene": base,
                        "frame_ids": [
                            int(os.path.basename(f).split(".")[0])
                            for f in files[i: i + sequence_length]
                        ],
                        "fps": fps,
                    })

    def __len__(self):
        return len(self.segments)

    # -- pose lookup with interpolation -------------------------------------

    def pose_at(self, scene: str, frame_id: int) -> np.ndarray:
        table = self.poses[scene]
        if frame_id in table:
            return table[frame_id]
        keys = sorted(table.keys())
        if not keys:
            return np.eye(4, dtype=np.float32)
        smaller = [k for k in keys if k < frame_id]
        larger = [k for k in keys if k > frame_id]
        if not larger:
            return table[max(smaller)]
        if not smaller:
            return table[min(larger)]
        lo, hi = max(smaller), min(larger)
        interp = interpolate_pose(table[lo], table[hi], hi - lo)
        return interp[frame_id - lo - 1].astype(np.float32)

    # -- 3dbox BEV raster -----------------------------------------------------

    def get_3dbox_bev_image(self, scene: str, pose: np.ndarray,
                            frame_id: int):
        settings = self._3dbox_bev_settings
        pen_width = settings.get("pen_width", 2)
        bev_size = settings.get("bev_size", [640, 640])
        bev_from_ego = np.asarray(
            settings.get("bev_from_ego_transform", DEFAULT_BEV_FROM_EGO),
            np.float32,
        )
        gps_to_ego = np.asarray(
            settings.get("gps_to_ego", DEFAULT_GPS_TO_EGO), np.float32
        )
        color_table = settings.get("color_table", DEFAULT_COLOR_TABLE)
        fill_box = settings.get("fill_box", False)
        image = Image.new("RGB", tuple(bev_size))
        root = self.bboxes.get(scene)
        if root is None:
            return image
        draw = ImageDraw.Draw(image)
        world_to_gps = np.linalg.inv(pose)
        view = bev_from_ego @ gps_to_ego @ world_to_gps

        for child in root:
            tr = child.find("transform")
            if tr is None:
                continue
            ts_el = child.find("timestamp")
            ts = int(ts_el.text) if ts_el is not None else -1
            if ts not in (-1, frame_id):
                continue
            sem_el = child.find("semanticId")
            sem = int(sem_el.text) if sem_el is not None else -1
            raw_label = SEMANTIC_ID_TO_LABEL.get(sem)
            label = LABEL_MAPPING.get(raw_label)
            if label is None or label not in color_table:
                continue
            data = tr.find("data")
            mat = np.asarray(
                data.text.split(), np.float32
            ).reshape(4, 4)
            verts = (view @ mat @ BEV_CORNERS.T).T[:, :2]
            color = tuple(color_table[label])
            if fill_box:
                draw.polygon([tuple(v) for v in verts[:4]], fill=color)
            else:
                for a, b in BEV_EDGES:
                    draw.line(
                        (verts[a][0], verts[a][1], verts[b][0], verts[b][1]),
                        fill=color, width=pen_width,
                    )
        return image

    # -- item -----------------------------------------------------------------

    def __getitem__(self, index: int) -> dict:
        segment = self.segments[index]
        point_list = []
        for path in segment["files"]:
            raw = self.fs.cat_file(path)
            pts = np.frombuffer(raw, np.float32).reshape(-1, 4)[:, :3]
            point_list.append(pts.copy())
        points, mask = pad_points(point_list, self.max_point_count)

        t = self.sequence_length
        result = {
            "fps": np.float32(segment["fps"]),
            "pts": np.asarray(
                [[i * 100.0] for i in range(t)], np.float32
            ),
            "lidar_points": points,
            "lidar_points_mask": mask,
        }
        # fixed velodyne→ego offset (reference :433-440)
        lt = np.broadcast_to(np.eye(4, dtype=np.float32), (t, 1, 4, 4)).copy()
        lt[..., :3, 3] = np.asarray([0.76, 0.0, 1.43], np.float32)
        result["lidar_transforms"] = lt

        poses = [
            self.pose_at(segment["scene"], fid)
            for fid in segment["frame_ids"]
        ]
        if self.enable_ego_transforms:
            result["ego_transforms"] = np.stack(
                [p[None] for p in poses]
            ).astype(np.float32)

        if self._3dbox_bev_settings is not None:
            result["3dbox_bev_images"] = [
                self.get_3dbox_bev_image(segment["scene"], p, fid)
                for p, fid in zip(poses, segment["frame_ids"])
            ]

        add_stub_key_data(self.stub_key_data_dict, result)
        return result
