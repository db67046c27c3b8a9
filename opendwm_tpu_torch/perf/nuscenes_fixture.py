"""Write a nuScenes-format archive at nuScenes' own scale, from a seed.

One scene that the official ``train`` split names (``scene-0001``): the
eleven ``v1.0-trainval/*.json`` tables, ``samples`` keyframes at 2 Hz,
each with a ``LIDAR_TOP`` sweep of ``points`` records of 5 float32 (x, y,
z, intensity, ring: 32 beams from -30.67° to +10.67°, the ground seen
from 1.84 m, everything inside the LiDAR configs' voxelizer box) and
about ``boxes`` annotated objects across nuScenes categories, moving in
the world. The archive is deflated (``ZIP_DEFLATED``), and its
``.info.json`` offset cache is written with the port's ``make_info``, as
the LiDAR configs set ``enable_cached_info``.

    from opendwm_tpu_torch.perf.nuscenes_fixture import write_archive
    info = write_archive(root)            # 40 samples of 34,720 points
    info["archive"], info["info_json"], info["dataset_name"]

``extract`` unpacks the archive into a directory tree, for a reader over
``DirFileSystem``. Host code: numpy, zipfile and json.
"""

from __future__ import annotations

import hashlib
import json
import math
import zipfile
from pathlib import Path

import numpy as np

DATASET_NAME = "v1.0-trainval"
SCENE_NAME = "scene-0001"
LOG_NAME = "n015-2018-07-24-11-22-45+0800"
# the LiDAR configs' voxelizer box, less a margin
BOX_LO = (-49.9, -49.9, -2.99)
BOX_HI = (49.9, 49.9, 2.59)
# nuScenes' LIDAR_TOP extrinsic (a calibrated_sensor row of v1.0-trainval)
LIDAR_TRANSLATION = [0.943713, 0.0, 1.84023]
LIDAR_ROTATION = [0.7077955119163518, -0.006492242056004365,
                  0.010646214713995808, -0.7063073142877817]
# (category, width, length, height, metres a second when it moves)
CATEGORIES = (
    ("vehicle.car", 1.95, 4.62, 1.73, 6.0),
    ("vehicle.truck", 2.52, 6.94, 2.84, 5.0),
    ("vehicle.bus.rigid", 2.95, 11.2, 3.47, 4.0),
    ("vehicle.trailer", 2.90, 12.3, 3.87, 0.0),
    ("vehicle.construction", 2.82, 6.56, 3.20, 0.0),
    ("vehicle.motorcycle", 0.77, 2.11, 1.47, 7.0),
    ("vehicle.bicycle", 0.60, 1.70, 1.28, 3.0),
    ("human.pedestrian.adult", 0.67, 0.73, 1.77, 1.3),
    ("human.pedestrian.child", 0.51, 0.53, 1.38, 1.0),
    ("movable_object.barrier", 2.53, 0.50, 0.98, 0.0),
    ("movable_object.trafficcone", 0.41, 0.41, 1.07, 0.0),
    ("static_object.bicycle_rack", 2.40, 8.50, 1.20, 0.0),
)
START_US = 1532402927647951  # scene-0001's first timestamp, microseconds


def token(kind: str, *keys) -> str:
    """A nuScenes-style 32-hex token, fixed by its kind and keys."""
    return hashlib.md5("/".join(map(str, (kind,) + keys)).encode()
                       ).hexdigest()


def yaw_quaternion(yaw: float) -> list:
    return [math.cos(yaw / 2), 0.0, 0.0, math.sin(yaw / 2)]


def lidar_sweep(rng: np.random.Generator, points: int) -> np.ndarray:
    """(points, 5) float32 in the sensor frame: 32 beams, each return at
    the ground or at an obstacle, whichever is nearer."""
    ring = rng.integers(0, 32, points)
    elevation = np.deg2rad(-30.67 + ring * (41.34 / 31))
    azimuth = rng.uniform(-np.pi, np.pi, points)
    obstacle = rng.uniform(2.5, 70.0, points)
    down = -np.minimum(elevation, -1e-3)
    ground = np.where(elevation < 0, LIDAR_TRANSLATION[2] / np.tan(down),
                      np.inf)
    r = np.minimum(obstacle, ground)
    flat = r * np.cos(elevation)
    xyz = np.stack([flat * np.cos(azimuth), flat * np.sin(azimuth),
                    r * np.sin(elevation)], -1)
    xyz = np.clip(xyz, BOX_LO, BOX_HI)
    intensity = rng.uniform(0, 255, points).round()
    return np.concatenate([xyz, intensity[:, None], ring[:, None]],
                          -1).astype(np.float32)


def tables(samples: int, boxes: int, seed: int) -> tuple[dict, list]:
    """The eleven tables of one scene and the sweeps' (filename, seed)."""
    rng = np.random.default_rng(seed)
    sensor = {"token": token("sensor", "LIDAR_TOP"), "channel": "LIDAR_TOP",
              "modality": "lidar"}
    calibrated = {"token": token("calibrated_sensor", "LIDAR_TOP"),
                  "sensor_token": sensor["token"],
                  "translation": LIDAR_TRANSLATION,
                  "rotation": LIDAR_ROTATION, "camera_intrinsic": []}
    log = {"token": token("log", LOG_NAME), "logfile": LOG_NAME,
           "vehicle": "n015", "date_captured": "2018-07-24",
           "location": "singapore-onenorth"}
    scene_token = token("scene", SCENE_NAME)
    categories = [{"token": token("category", c[0]), "name": c[0],
                   "description": c[0].replace(".", " "), "index": i}
                  for i, c in enumerate(CATEGORIES)]
    ego_speed, ego_yaw = 5.0, 0.12
    sample_rows, sample_data, ego_poses, sweeps = [], [], [], []
    for i in range(samples):
        ts = START_US + i * 500_000
        sample_token = token("sample", i)
        sample_rows.append({
            "token": sample_token, "timestamp": ts,
            "prev": token("sample", i - 1) if i else "",
            "next": token("sample", i + 1) if i + 1 < samples else "",
            "scene_token": scene_token})
        x = 410.0 + ego_speed * 0.5 * i * math.cos(ego_yaw)
        y = 1180.0 + ego_speed * 0.5 * i * math.sin(ego_yaw)
        ego_poses.append({"token": token("ego_pose", i), "timestamp": ts,
                          "rotation": yaw_quaternion(ego_yaw),
                          "translation": [x, y, 0.0]})
        filename = (f"samples/LIDAR_TOP/{LOG_NAME}__LIDAR_TOP__{ts}"
                    ".pcd.bin")
        sample_data.append({
            "token": token("sample_data", i), "sample_token": sample_token,
            "ego_pose_token": token("ego_pose", i),
            "calibrated_sensor_token": calibrated["token"],
            "timestamp": ts, "fileformat": "pcd", "is_key_frame": True,
            "height": 0, "width": 0, "filename": filename,
            "prev": token("sample_data", i - 1) if i else "",
            "next": token("sample_data", i + 1) if i + 1 < samples else ""})
        sweeps.append((filename, seed * 1_000_003 + i))
    instances, annotations = [], []
    start = np.array(ego_poses[0]["translation"][:2])
    heading = np.array([math.cos(ego_yaw), math.sin(ego_yaw)])
    side = np.array([-heading[1], heading[0]])
    for k in range(boxes):
        name, w, length, h, speed = CATEGORIES[k % len(CATEGORIES)]
        along = rng.uniform(-30, ego_speed * 0.5 * samples + 30)
        across = rng.choice([-1, 1]) * rng.uniform(2.0, 25.0)
        yaw = ego_yaw + (0.0 if speed else rng.uniform(-np.pi, np.pi))
        z = h / 2 + rng.normal(0, 0.05)
        velocity = rng.uniform(0.5, 1.0) * speed
        inst = token("instance", k)
        tokens = [token("sample_annotation", k, i) for i in range(samples)]
        instances.append({
            "token": inst, "category_token": categories[
                k % len(CATEGORIES)]["token"],
            "nbr_annotations": samples, "first_annotation_token": tokens[0],
            "last_annotation_token": tokens[-1]})
        for i in range(samples):
            xy = start + heading * (along + velocity * 0.5 * i) + \
                side * across
            annotations.append({
                "token": tokens[i], "sample_token": token("sample", i),
                "instance_token": inst, "visibility_token": "4",
                "attribute_tokens": [],
                "translation": [float(xy[0]), float(xy[1]), float(z)],
                "size": [w, length, h], "rotation": yaw_quaternion(yaw),
                "prev": tokens[i - 1] if i else "",
                "next": tokens[i + 1] if i + 1 < samples else "",
                "num_lidar_pts": int(rng.integers(1, 400)),
                "num_radar_pts": int(rng.integers(0, 10))})
    scene = {"token": scene_token, "log_token": log["token"],
             "nbr_samples": samples, "name": SCENE_NAME,
             "first_sample_token": sample_rows[0]["token"],
             "last_sample_token": sample_rows[-1]["token"],
             "description": "Parked cars, pedestrians crossing, barriers"}
    out = {
        "calibrated_sensor": [calibrated], "category": categories,
        "ego_pose": ego_poses, "instance": instances, "log": [log],
        "map": [{"token": token("map", "singapore-onenorth"),
                 "log_tokens": [log["token"]], "category": "semantic_prior",
                 "filename": "maps/singapore-onenorth.png"}],
        "sample": sample_rows, "sample_annotation": annotations,
        "sample_data": sample_data, "scene": [scene], "sensor": [sensor],
    }
    return out, sweeps


def write_archive(root, samples: int = 40, points: int = 34720,
                  boxes: int = 50, seed: int = 0,
                  name: str = f"{DATASET_NAME}.zip") -> dict:
    """Write ``root/name`` (deflated) and its ``.info.json``; returns the
    paths, the dataset name and the sweeps' member names."""
    from opendwm_tpu_torch.fs.czip import CombinedZipFileSystem

    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    archive = root / name
    rows, sweeps = tables(samples, boxes, seed)
    with zipfile.ZipFile(archive, "w", zipfile.ZIP_DEFLATED) as zf:
        for table, content in rows.items():
            zf.writestr(f"{DATASET_NAME}/{table}.json", json.dumps(content))
        for filename, sweep_seed in sweeps:
            sweep = lidar_sweep(np.random.default_rng(sweep_seed), points)
            zf.writestr(filename, sweep.tobytes())
    info = CombinedZipFileSystem(paths=[str(archive)]).make_info()
    info_json = Path(str(archive) + ".info.json")
    info_json.write_text(json.dumps(info[str(archive)]))
    return {"archive": str(archive), "info_json": str(info_json),
            "dataset_name": DATASET_NAME, "scene": SCENE_NAME,
            "sweeps": [f for f, _ in sweeps], "samples": samples,
            "points": points, "boxes": boxes}


def extract(archive, dest) -> str:
    """Unpack ``archive`` into the directory ``dest``; returns its path."""
    with zipfile.ZipFile(archive) as zf:
        zf.extractall(dest)
    return str(dest)
