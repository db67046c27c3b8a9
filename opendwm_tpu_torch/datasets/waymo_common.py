"""Waymo range-image → cartesian point conversion (host numpy; the port's
copy of ``opendwm_tpu/datasets/waymo_common.py``).

Capability parity with reference src/dwm/datasets/waymo_common.py
(itself a numpy port of the waymo-open-dataset TF utils): each LiDAR
return is stored as an (H, W, C) polar range image — rows are laser beams
(inclinations from calibration), columns sweep azimuth, channel 0 is range
in meters. The TOP lidar additionally carries a per-pixel vehicle pose
(roll/pitch/yaw + translation in world frame) to undo rolling-shutter ego
motion.

Implementation here is a single vectorized pass: build the per-pixel unit
direction grid once, scale by range, then apply sensor→vehicle (and
optionally pixel-pose→world→frame) transforms with einsum.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def beam_inclinations(
    values: Optional[np.ndarray],
    inclination_min: float,
    inclination_max: float,
    height: int,
) -> np.ndarray:
    """Per-row beam inclination, top row first.

    Calibrations either list exact per-beam values (bottom-to-top order in
    the proto) or just a [min, max] span sampled uniformly at row centers.
    """
    if values is not None and len(values) > 0:
        inc = np.asarray(values, np.float32)
    else:
        centers = (np.arange(height, dtype=np.float32) + 0.5) / height
        inc = inclination_min + centers * (inclination_max - inclination_min)
    return inc[::-1]  # proto order is bottom beam first; row 0 = top beam


def _rpy_to_matrix(rpy: np.ndarray) -> np.ndarray:
    """(..., 3) roll/pitch/yaw → (..., 3, 3) rotation, R = Rz·Ry·Rx."""
    roll, pitch, yaw = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    r = np.empty(rpy.shape[:-1] + (3, 3), np.float32)
    r[..., 0, 0] = cy * cp
    r[..., 0, 1] = cy * sp * sr - sy * cr
    r[..., 0, 2] = cy * sp * cr + sy * sr
    r[..., 1, 0] = sy * cp
    r[..., 1, 1] = sy * sp * sr + cy * cr
    r[..., 1, 2] = sy * sp * cr - cy * sr
    r[..., 2, 0] = -sp
    r[..., 2, 1] = cp * sr
    r[..., 2, 2] = cp * cr
    return r


def range_image_to_points(
    range_image: np.ndarray,          # (H, W, C), channel 0 = range [m]
    extrinsic: np.ndarray,            # (4, 4) sensor → vehicle
    inclination: np.ndarray,          # (H,) top row first
    pixel_pose: Optional[np.ndarray] = None,  # (H, W, 6) rpy+xyz, world
    frame_pose: Optional[np.ndarray] = None,  # (4, 4) vehicle → world
) -> np.ndarray:
    """Valid (range > 0) points in the vehicle frame, (N, 3) float32."""
    h, w = range_image.shape[:2]
    rng = range_image[..., 0].astype(np.float32)

    # Column azimuths sweep from +pi (left) to -pi at pixel centers, offset
    # by the sensor's yaw so column azimuth is world-aligned per spec.
    az_correction = float(np.arctan2(extrinsic[1, 0], extrinsic[0, 0]))
    ratios = (np.arange(w, 0, -1, dtype=np.float32) - 0.5) / w
    azimuth = (ratios * 2.0 - 1.0) * np.pi - az_correction

    cos_az, sin_az = np.cos(azimuth)[None, :], np.sin(azimuth)[None, :]
    cos_inc = np.cos(inclination)[:, None]
    sin_inc = np.sin(inclination)[:, None]

    pts = np.stack(
        [
            rng * cos_az * cos_inc,
            rng * sin_az * cos_inc,
            rng * sin_inc,
        ],
        axis=-1,
    )  # (H, W, 3) in sensor frame

    pts = np.einsum("ij,hwj->hwi", extrinsic[:3, :3], pts)
    pts = pts + extrinsic[:3, 3]

    if pixel_pose is not None:
        if frame_pose is None:
            raise ValueError("frame_pose required with pixel_pose")
        rot = _rpy_to_matrix(pixel_pose[..., :3])          # (H, W, 3, 3)
        pts = np.einsum("hwij,hwj->hwi", rot, pts) + pixel_pose[..., 3:6]
        vehicle_from_world = np.linalg.inv(
            frame_pose.astype(np.float64)
        ).astype(np.float32)
        pts = (
            np.einsum("ij,hwj->hwi", vehicle_from_world[:3, :3], pts)
            + vehicle_from_world[:3, 3]
        )

    mask = rng > 0
    return pts[mask].astype(np.float32)
