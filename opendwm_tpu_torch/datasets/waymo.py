"""Waymo Perception motion dataset (TFRecord-backed; the port's copy of
``opendwm_tpu/datasets/waymo.py``).

Reference src/dwm/datasets/waymo.py (774 LoC) reads Frame protos through the
waymo-open-dataset package with an offline random-access offset index.
This implementation needs no such package: it decodes Frames with
the schema-less wire parser (datasets/tfrecord.py) and the Frame field map
below (waymo-open-dataset dataset.proto / label.proto field numbers).
Supported: images, camera/ego transforms, LiDAR range-image decode to
vehicle-frame points (datasets/waymo_common.py), laser-label 3dbox camera
rasters and BEV rasters.

Run ``tools/dataset_make_info_json`` to build the offset index for real
shards.
"""

from __future__ import annotations

import io
import json
import zlib
from typing import Optional

import numpy as np

from opendwm_tpu_torch.config import register
from opendwm_tpu_torch.datasets import tfrecord as tfr
from opendwm_tpu_torch.datasets import waymo_common as wc
from opendwm_tpu_torch.datasets.common import add_stub_key_data, pad_points

try:
    from PIL import Image, ImageDraw

    _HAS_PIL = True
except ImportError:  # pragma: no cover
    _HAS_PIL = False

# dataset.proto Frame fields
F_CONTEXT = 1
F_TIMESTAMP_MICROS = 2
F_POSE = 3
F_IMAGES = 4
F_LASERS = 5
F_LASER_LABELS = 6
# CameraImage fields
CI_NAME = 1
CI_IMAGE = 2
# Transform fields
TF_MATRIX = 1  # packed doubles, row-major 4x4
# Context fields
CTX_NAME = 1
CTX_CAMERA_CALIBRATIONS = 2
CTX_LASER_CALIBRATIONS = 3
# CameraCalibration fields
CC_NAME = 1
CC_INTRINSIC = 2  # packed doubles [f_u, f_v, c_u, c_v, k1..]
CC_EXTRINSIC = 3  # Transform
CC_WIDTH = 4
CC_HEIGHT = 5
# LaserCalibration fields
LC_NAME = 1
LC_BEAM_INCLINATIONS = 2  # packed doubles, bottom beam first
LC_BEAM_INCLINATION_MIN = 3  # double
LC_BEAM_INCLINATION_MAX = 4  # double
LC_EXTRINSIC = 5  # Transform
# Laser fields
L_NAME = 1
L_RI_RETURN1 = 2
# RangeImage fields
RI_RANGE_IMAGE_COMPRESSED = 2  # zlib(MatrixFloat)
RI_POSE_COMPRESSED = 4         # zlib(MatrixFloat), TOP lidar only
# MatrixFloat / MatrixShape fields
MF_DATA = 1   # packed floats
MF_SHAPE = 2
MS_DIMS = 1   # packed varints
# label.proto Label / Label.Box fields
LB_BOX = 1
LB_TYPE = 3
BOX_CX, BOX_CY, BOX_CZ = 1, 2, 3
BOX_WIDTH, BOX_LENGTH, BOX_HEIGHT, BOX_HEADING = 4, 5, 6, 7

CAMERA_NAMES = {
    1: "FRONT", 2: "FRONT_LEFT", 3: "FRONT_RIGHT", 4: "SIDE_LEFT",
    5: "SIDE_RIGHT",
}
LASER_NAMES = {1: "TOP", 2: "FRONT", 3: "SIDE_LEFT", 4: "SIDE_RIGHT",
               5: "REAR"}
BOX_TYPES = {1: "VEHICLE", 2: "PEDESTRIAN", 3: "SIGN", 4: "CYCLIST"}
DEFAULT_3DBOX_COLOR_TABLE = {
    "PEDESTRIAN": (255, 0, 0), "CYCLIST": (0, 255, 0),
    "VEHICLE": (0, 0, 255),
}
# unit box corners (x fwd, y left, z up), heading about +z
CORNERS = np.array(
    [
        [x, y, z, 1.0]
        for x in (-0.5, 0.5) for y in (-0.5, 0.5) for z in (-0.5, 0.5)
    ]
).T  # (4, 8); order: (---, --+, -+-, -++, +--, +-+, ++-, +++)
EDGES = [
    (0, 1), (0, 2), (1, 3), (2, 3), (4, 5), (4, 6), (5, 7), (6, 7),
    (0, 4), (1, 5), (2, 6), (3, 7),
]

# Waymo camera frame: +x forward. Convert to the canonical camera frame
# (+z forward) like the Argoverse adapter.
CAM_FROM_SENSOR = np.array(
    [[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0], [0, 0, 0, 1]], np.float64
)


def _decode_transform(raw: bytes) -> np.ndarray:
    fields = tfr.parse_protobuf(raw)
    mat = tfr.decode_packed_doubles(fields[TF_MATRIX][0])
    return np.asarray(mat, np.float64).reshape(4, 4)


def _decode_matrix_float(compressed: bytes) -> np.ndarray:
    fields = tfr.parse_protobuf(zlib.decompress(compressed))
    data = np.asarray(
        tfr.decode_packed_floats(fields[MF_DATA][0]), np.float32
    )
    dims = tfr.decode_packed_varints(
        tfr.parse_protobuf(fields[MF_SHAPE][0])[MS_DIMS][0]
    )
    return data.reshape(dims)


def _maybe_scalar_double(fields: dict, key: int, default: float) -> float:
    if key not in fields:
        return default
    return tfr.decode_double(fields[key][0])


def _channel_id(channel: str) -> tuple[str, int]:
    """Map a config channel name to (modality, proto id). Accepts both the
    reference's nuScenes-style names (CAM_FRONT / LIDAR_TOP, reference
    waymo.py:59-70) and bare Waymo names (FRONT / TOP)."""
    if channel.startswith("LIDAR_"):
        name = channel[len("LIDAR_"):]
        return "lidar", {v: k for k, v in LASER_NAMES.items()}[name]
    if channel.startswith("CAM_"):
        channel = channel[len("CAM_"):]
    return "camera", {v: k for k, v in CAMERA_NAMES.items()}[channel]


@register("WaymoDataset", aliases=("dwm.datasets.waymo.MotionDataset",))
class MotionDataset:
    def __init__(
        self,
        fs,
        info_dict_path: str,
        sequence_length: int,
        fps_stride_tuples: list,
        sensor_channels: list = ("FRONT",),
        enable_camera_transforms: bool = False,
        enable_ego_transforms: bool = False,
        _3dbox_image_settings: Optional[dict] = None,
        _3dbox_bev_settings: Optional[dict] = None,
        max_point_count: int = 200000,
        stub_key_data_dict: Optional[dict] = None,
    ):
        self.fs = fs
        self.sequence_length = sequence_length
        self.sensor_channels = list(sensor_channels)
        self.enable_camera_transforms = enable_camera_transforms
        self.enable_ego_transforms = enable_ego_transforms
        self._3dbox_image_settings = _3dbox_image_settings
        self._3dbox_bev_settings = _3dbox_bev_settings
        self.max_point_count = max_point_count
        self.stub_key_data_dict = stub_key_data_dict

        with open(info_dict_path) as f:
            # {shard_filename: [record offsets]}
            self.info = json.load(f)

        self.items = []
        for shard, offsets in self.info.items():
            for fps, stride in fps_stride_tuples:
                # Waymo frames are 10 Hz; index stride derived from fps.
                step = max(1, int(round(10 / fps))) if fps > 0 else 1
                span = (sequence_length - 1) * step + 1
                for start in range(
                    0, len(offsets) - span + 1, max(1, int(stride))
                ):
                    self.items.append({
                        "shard": shard,
                        "offsets": offsets[start: start + span: step],
                        "fps": fps if fps > 0 else 10,
                    })

    def __len__(self):
        return len(self.items)

    def _read_frame(self, shard: str, offset: int) -> dict:
        with self.fs.open(shard, "rb") as f:
            payload = tfr.read_tfrecord_at(f, offset)
        return tfr.parse_protobuf(payload)

    # -- LiDAR ---------------------------------------------------------------

    def _laser_calibrations(self, ctx: dict) -> dict:
        out = {}
        for raw in ctx.get(CTX_LASER_CALIBRATIONS, []):
            lc = tfr.parse_protobuf(raw)
            values = None
            if LC_BEAM_INCLINATIONS in lc:
                values = tfr.decode_packed_doubles(
                    lc[LC_BEAM_INCLINATIONS][0]
                )
            out[lc.get(LC_NAME, [0])[0]] = {
                "values": values,
                "min": _maybe_scalar_double(
                    lc, LC_BEAM_INCLINATION_MIN, 0.0
                ),
                "max": _maybe_scalar_double(
                    lc, LC_BEAM_INCLINATION_MAX, 0.0
                ),
                "extrinsic": _decode_transform(lc[LC_EXTRINSIC][0]),
            }
        return out

    def _lidar_points(self, frame: dict, laser_id: int) -> np.ndarray:
        """Decode one laser's first return to vehicle-frame points
        (reference get_images_and_lidar_points, waymo.py:161-212)."""
        laser = None
        for raw in frame.get(F_LASERS, []):
            candidate = tfr.parse_protobuf(raw)
            if candidate.get(L_NAME, [0])[0] == laser_id:
                laser = candidate
                break
        if laser is None or L_RI_RETURN1 not in laser:
            return np.zeros((0, 3), np.float32)
        ri = tfr.parse_protobuf(laser[L_RI_RETURN1][0])
        range_image = _decode_matrix_float(ri[RI_RANGE_IMAGE_COMPRESSED][0])
        cal = self._laser_calibrations(
            tfr.parse_protobuf(frame[F_CONTEXT][0])
        ).get(laser_id)
        if cal is None:
            return np.zeros((0, 3), np.float32)
        inclination = wc.beam_inclinations(
            cal["values"], cal["min"], cal["max"], range_image.shape[0]
        )
        pixel_pose = frame_pose = None
        if laser_id == 1 and RI_POSE_COMPRESSED in ri:  # TOP lidar
            pixel_pose = _decode_matrix_float(ri[RI_POSE_COMPRESSED][0])
            frame_pose = (
                _decode_transform(frame[F_POSE][0])
                if F_POSE in frame else np.eye(4)
            ).astype(np.float32)
        return wc.range_image_to_points(
            range_image, cal["extrinsic"].astype(np.float32), inclination,
            pixel_pose, frame_pose,
        )

    # -- laser-label rasters ---------------------------------------------------

    def _laser_label_boxes(self, frame: dict) -> list:
        boxes = []
        for raw in frame.get(F_LASER_LABELS, []):
            lb = tfr.parse_protobuf(raw)
            if LB_BOX not in lb:
                continue
            box = tfr.parse_protobuf(lb[LB_BOX][0])

            def d(key, default=0.0):
                return (
                    tfr.decode_double(box[key][0]) if key in box else default
                )

            boxes.append({
                "type": BOX_TYPES.get(lb.get(LB_TYPE, [0])[0], "UNKNOWN"),
                "center": [d(BOX_CX), d(BOX_CY), d(BOX_CZ)],
                "size": [d(BOX_LENGTH), d(BOX_WIDTH), d(BOX_HEIGHT)],
                "heading": d(BOX_HEADING),
            })
        return boxes

    @staticmethod
    def _box_transform(box: dict) -> np.ndarray:
        c, s = np.cos(box["heading"]), np.sin(box["heading"])
        m = np.eye(4)
        m[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]) @ np.diag(
            box["size"]
        )
        m[:3, 3] = box["center"]
        return m

    def get_3dbox_image(self, boxes, calibration, settings):
        """Camera-space 3dbox raster (reference waymo.py:214-260): boxes are
        in the vehicle frame, projected through the camera calibration."""
        w, h = int(calibration["size"][0]), int(calibration["size"][1])
        image = Image.new("RGB", (max(w, 1), max(h, 1)))
        draw = ImageDraw.Draw(image)
        pen_width = settings.get("pen_width", 10)
        color_table = settings.get("color_table", DEFAULT_3DBOX_COLOR_TABLE)
        k = np.eye(4)
        k[:3, :3] = calibration["intrinsic"]
        view = k @ CAM_FROM_SENSOR @ np.linalg.inv(calibration["extrinsic"])
        for box in boxes:
            if box["type"] not in color_table:
                continue
            p = view @ self._box_transform(box) @ CORNERS
            color = tuple(color_table[box["type"]])
            for a, b in EDGES:
                pa, pb = p[:, a], p[:, b]
                if pa[2] <= 0.05 or pb[2] <= 0.05:
                    continue
                draw.line(
                    (
                        pa[0] / pa[2], pa[1] / pa[2],
                        pb[0] / pb[2], pb[1] / pb[2],
                    ),
                    fill=color, width=pen_width,
                )
        return image

    def get_3dbox_bev_image(self, boxes, settings):
        """BEV 3dbox raster (reference waymo.py:373-430)."""
        size = settings.get("image_size", [640, 640])
        pen_width = settings.get("pen_width", 2)
        color_table = settings.get("color_table", DEFAULT_3DBOX_COLOR_TABLE)
        fill = settings.get("fill_box", False)
        bev_from_ego = np.asarray(settings.get(
            "bev_from_ego_transform",
            [[6.4, 0, 0, 320], [0, -6.4, 0, 320], [0, 0, -6.4, 0],
             [0, 0, 0, 1]],
        ))
        image = Image.new("RGB", tuple(size))
        draw = ImageDraw.Draw(image)
        for box in boxes:
            if box["type"] not in color_table:
                continue
            p = bev_from_ego @ self._box_transform(box) @ CORNERS
            # bottom face in corner order (---, -+-, ++-, +--)
            pts = [(p[0, j], p[1, j]) for j in (0, 2, 6, 4)]
            color = tuple(color_table[box["type"]])
            if fill:
                draw.polygon(pts, fill=color)
            else:
                draw.polygon(pts, outline=color, width=pen_width)
        return image

    # -- items -----------------------------------------------------------------

    def __getitem__(self, index: int) -> dict:
        item = self.items[index]
        frames = [
            self._read_frame(item["shard"], off) for off in item["offsets"]
        ]
        channels = [_channel_id(ch) for ch in self.sensor_channels]
        cam_channels = [c for c in channels if c[0] == "camera"]
        lidar_channels = [c for c in channels if c[0] == "lidar"]
        v = len(cam_channels)

        result: dict = {"fps": np.float32(item["fps"])}
        result["pts"] = np.asarray(
            [
                [frame.get(F_TIMESTAMP_MICROS, [0])[0] / 1000.0]
                * max(v, 1)
                for frame in frames
            ],
            np.float32,
        )

        if cam_channels:
            images = []
            for frame in frames:
                by_id = {}
                for raw in frame.get(F_IMAGES, []):
                    ci = tfr.parse_protobuf(raw)
                    by_id[ci.get(CI_NAME, [0])[0]] = ci.get(
                        CI_IMAGE, [b""]
                    )[0]
                row = []
                for _, cam_id in cam_channels:
                    data = by_id.get(cam_id)
                    if data and _HAS_PIL:
                        img = Image.open(io.BytesIO(data)).convert("RGB")
                        img.load()
                        row.append(img)
                    else:
                        row.append(
                            Image.new("RGB", (64, 48), (128, 128, 128))
                        )
                images.append(row)
            result["images"] = images

        if lidar_channels:
            per_frame = [
                np.concatenate(
                    [
                        self._lidar_points(frame, lid)
                        for _, lid in lidar_channels
                    ]
                    or [np.zeros((0, 3), np.float32)]
                )
                for frame in frames
            ]
            pts, mask = pad_points(per_frame, self.max_point_count)
            result["lidar_points"] = pts
            result["lidar_points_mask"] = mask

        calibrations = {}
        if self.enable_camera_transforms or (
            self._3dbox_image_settings is not None and cam_channels
        ):
            ctx = tfr.parse_protobuf(frames[0][F_CONTEXT][0])
            for raw in ctx.get(CTX_CAMERA_CALIBRATIONS, []):
                cc = tfr.parse_protobuf(raw)
                cam_id = cc.get(CC_NAME, [0])[0]
                intr = tfr.decode_packed_doubles(cc[CC_INTRINSIC][0])
                calibrations[cam_id] = {
                    "intrinsic": np.asarray([
                        [intr[0], 0, intr[2]], [0, intr[1], intr[3]],
                        [0, 0, 1],
                    ]),
                    "extrinsic": _decode_transform(cc[CC_EXTRINSIC][0]),
                    "size": [
                        cc.get(CC_WIDTH, [0])[0], cc.get(CC_HEIGHT, [0])[0]
                    ],
                }

        if self.enable_camera_transforms and cam_channels:
            ct, ci_list, sizes = [], [], []
            for _ in frames:
                ct.append([]), ci_list.append([]), sizes.append([])
                for _, cam_id in cam_channels:
                    cal = calibrations.get(cam_id)
                    if cal is None:
                        ct[-1].append(np.eye(4))
                        ci_list[-1].append(np.eye(3))
                        sizes[-1].append([0.0, 0.0])
                        continue
                    ct[-1].append(
                        cal["extrinsic"] @ np.linalg.inv(CAM_FROM_SENSOR)
                    )
                    ci_list[-1].append(cal["intrinsic"])
                    sizes[-1].append([float(s) for s in cal["size"]])
            result["camera_transforms"] = np.asarray(ct, np.float32)
            result["camera_intrinsics"] = np.asarray(ci_list, np.float32)
            result["image_size"] = np.asarray(sizes, np.float32)

        if self.enable_ego_transforms:
            et = []
            for frame in frames:
                pose = (
                    _decode_transform(frame[F_POSE][0])
                    if F_POSE in frame else np.eye(4)
                )
                et.append(np.stack([pose] * max(len(channels), 1)))
            result["ego_transforms"] = np.asarray(et, np.float32)

        if self._3dbox_image_settings is not None and cam_channels:
            result["3dbox_images"] = [
                [
                    self.get_3dbox_image(
                        self._laser_label_boxes(frame),
                        calibrations.get(cam_id) or {
                            "intrinsic": np.eye(3), "extrinsic": np.eye(4),
                            "size": [64, 48],
                        },
                        self._3dbox_image_settings,
                    )
                    for _, cam_id in cam_channels
                ]
                for frame in frames
            ]
        if self._3dbox_bev_settings is not None:
            result["3dbox_bev_images"] = [
                self.get_3dbox_bev_image(
                    self._laser_label_boxes(frame), self._3dbox_bev_settings
                )
                for frame in frames
            ]

        add_stub_key_data(self.stub_key_data_dict, result)
        return result
