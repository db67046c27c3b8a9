"""The port's readers and common layer (``opendwm_tpu_torch/datasets``)
against the JAX package's on the JAX tests' own fixtures, imported from
``tests/test_{nuscenes,waymo_tfrecord,argoverse,kitti360,opendv,
carla_streaming,preview_dataset}.py``: every item of each reader, for the
settings those tests use, the same as the JAX reader's, key for key and
bit for bit (PIL images as arrays), through fsspec's ``dir`` filesystem
(as the JAX tests read) and through the port's own filesystems. Also the
helpers of ``datasets/common.py``, ``kitti360.py``, ``tfrecord.py``,
``carla_streaming.py`` and ``preview.py`` on the same inputs, the nuScenes
archive writer of ``perf/nuscenes_fixture.py`` through the JAX reader,
and the registry's names of every reader."""

import json
import zipfile
from pathlib import Path

import fsspec
import numpy as np
import pytest
from test_argoverse import root as argoverse_root  # noqa: F401
from test_carla_streaming import XODR, FakeClient, make_transform, obj
from test_kitti360 import root as kitti_root  # noqa: F401
from test_nuscenes import dataset_root as nuscenes_root  # noqa: F401
from test_opendv import root as opendv_root  # noqa: F401
from test_preview_dataset import package as preview_package  # noqa: F401
from test_waymo_tfrecord import make_frame, shard  # noqa: F401
from torch_port_helpers import assert_same_item

from opendwm_tpu.datasets import argoverse as j_argoverse
from opendwm_tpu.datasets import carla_streaming as j_carla
from opendwm_tpu.datasets import common as j_common
from opendwm_tpu.datasets import kitti360 as j_kitti
from opendwm_tpu.datasets import nuscenes as j_nuscenes
from opendwm_tpu.datasets import opendv as j_opendv
from opendwm_tpu.datasets import preview as j_preview
from opendwm_tpu.datasets import tfrecord as j_tfrecord
from opendwm_tpu.datasets import waymo as j_waymo
from opendwm_tpu.fs import CombinedZipFileSystem as JaxZip
from opendwm_tpu_torch.config import get_class
from opendwm_tpu_torch.datasets import argoverse as p_argoverse
from opendwm_tpu_torch.datasets import carla_streaming as p_carla
from opendwm_tpu_torch.datasets import common as p_common
from opendwm_tpu_torch.datasets import kitti360 as p_kitti
from opendwm_tpu_torch.datasets import nuscenes as p_nuscenes
from opendwm_tpu_torch.datasets import opendv as p_opendv
from opendwm_tpu_torch.datasets import preview as p_preview
from opendwm_tpu_torch.datasets import tfrecord as p_tfrecord
from opendwm_tpu_torch.datasets import waymo as p_waymo
from opendwm_tpu_torch.fs import CombinedZipFileSystem, DirFileSystem

REPO = Path(__file__).resolve().parents[1]

def assert_same_dataset(port, ref, indices=None, empty=False):
    assert len(port) == len(ref)
    assert empty or len(ref) > 0
    for i in (range(len(ref)) if indices is None else indices):
        assert_same_item(port[i], ref[i], f"item {i}")


def filesystems(root):
    """(port fs, JAX fs) pairs over ``root``: fsspec's ``dir`` for both,
    and the port's DirFileSystem against fsspec's."""
    ref = fsspec.filesystem("dir", path=str(root))
    return [(ref, ref), (DirFileSystem(str(root)), ref)]


# -- nuScenes -----------------------------------------------------------------

NUSCENES_CASES = {
    "full": dict(
        sequence_length=2, fps_stride_tuples=[(0, 1)],
        sensor_channels=["LIDAR_TOP", "CAM_FRONT", "CAM_BACK"],
        enable_scene_description=True, enable_camera_transforms=True,
        enable_ego_transforms=True, _3dbox_image_settings={},
        max_point_count=128),
    "rasters": dict(
        sequence_length=1, fps_stride_tuples=[(0, 1)],
        sensor_channels=["LIDAR_TOP", "CAM_FRONT"],
        _3dbox_image_settings={"pen_width": 2},
        foreground_region_image_settings={},
        _3dbox_bev_settings={"image_size": [200, 160]},
        hdmap_bev_settings={}, hdmap_image_settings={},
        stub_key_data_dict={"x": ["tensor", [2, 3], 0.5], "y": ["v", "s"]},
        max_point_count=64),  # truncates the 100-point sweeps
    "split": dict(sequence_length=1, fps_stride_tuples=[(0, 1)],
                  split="train", sensor_channels=["CAM_FRONT"]),
    "val": dict(sequence_length=1, fps_stride_tuples=[(0, 1)],
                split="val", sensor_channels=["CAM_FRONT"]),
    "fps": dict(sequence_length=2, fps_stride_tuples=[(1, 1), (2, 0.5)],
                sensor_channels=["CAM_FRONT", "LIDAR_TOP"]),
    "keyframes": dict(sequence_length=2, fps_stride_tuples=[(1, 0), (2, 0)],
                      keyframe_only=True, enable_synchronization_check=False,
                      sensor_channels=["CAM_BACK"]),
}


@pytest.mark.parametrize("case", list(NUSCENES_CASES))
def test_nuscenes_items_as_jax(nuscenes_root, case):  # noqa: F811
    kw = NUSCENES_CASES[case]
    for port_fs, ref_fs in filesystems(nuscenes_root):
        port = p_nuscenes.MotionDataset(port_fs, "v1.0-mini", **kw)
        ref = j_nuscenes.MotionDataset(ref_fs, "v1.0-mini", **kw)
        assert_same_dataset(port, ref, empty=case == "val")


def test_nuscenes_time_keyed_captions_as_jax(nuscenes_root,  # noqa: F811
                                             tmp_path):
    caps, times = {}, {}
    for ch in ("CAM_FRONT", "CAM_BACK"):
        sc = f"scene_0|{ch}"
        times[sc] = [1_000_000 * i for i in range(3)]
        for i in range(3):
            caps[f"{sc}|{1_000_000 * i}"] = {
                "time": "day", "weather": ["sunny", "rain"][i % 2],
                "environment": "city", "objects": f"{i} cars",
                "image_description": f"{ch.lower()} frame {i}"}
    (tmp_path / "caps.json").write_text(json.dumps(caps))
    (tmp_path / "times.json").write_text(json.dumps(times))
    kw = dict(sequence_length=2, fps_stride_tuples=[(0, 1)],
              sensor_channels=["CAM_FRONT", "CAM_BACK"],
              image_description_settings={
                  "path": str(tmp_path / "caps.json"),
                  "time_list_dict_path": str(tmp_path / "times.json"),
                  "reorder_keys": True, "align_keys": ["weather"],
                  "drop_rates": {"objects": 0.5}, "seed": 3})
    fs = fsspec.filesystem("dir", path=str(nuscenes_root))
    port = p_nuscenes.MotionDataset(fs, "v1.0-mini", **kw)
    ref = j_nuscenes.MotionDataset(fs, "v1.0-mini", **kw)
    assert_same_dataset(port, ref, [0, 1, 0, 1])  # the caption RNG advances


def test_nuscenes_through_combined_zips(nuscenes_root, tmp_path):  # noqa: F811
    """The fixture packed as nuScenes ships it (the tables deflated in one
    archive, the sweeps and images stored in another), read through the
    port's and the JAX package's CombinedZipFileSystem, the port's with
    the offset cache."""
    tables, blobs = tmp_path / "meta.zip", tmp_path / "blobs.zip"
    with zipfile.ZipFile(tables, "w", zipfile.ZIP_DEFLATED) as zt, \
            zipfile.ZipFile(blobs, "w", zipfile.ZIP_STORED) as zb:
        for path in sorted(nuscenes_root.rglob("*")):
            if path.is_file():
                name = str(path.relative_to(nuscenes_root))
                (zt if name.startswith("v1.0") else zb).write(path, name)
    paths = [str(tables), str(blobs)]
    for archive, meta in CombinedZipFileSystem(paths=paths).make_info(
            ).items():
        with open(archive + ".info.json", "w") as f:
            json.dump(meta, f)
    kw = NUSCENES_CASES["full"]
    port = p_nuscenes.MotionDataset(
        CombinedZipFileSystem(paths=paths, enable_cached_info=True),
        "v1.0-mini", **kw)
    ref = j_nuscenes.MotionDataset(JaxZip(paths=paths), "v1.0-mini", **kw)
    assert_same_dataset(port, ref)


def test_nuscenes_fixture_writer_loads_through_jax(tmp_path):
    """``perf/nuscenes_fixture.py``'s archive (a small one) through the JAX
    reader and the port's, with the LiDAR UNet config's dataset settings:
    the same items; the sweeps truncated to ``max_point_count``."""
    from opendwm_tpu_torch.perf import nuscenes_fixture

    info = nuscenes_fixture.write_archive(tmp_path, samples=12, points=900,
                                          boxes=6)
    cfg = json.loads((REPO / "configs/lidar/lidar_diffusion_unet_temporal_"
                      "ns.json").read_text())["training_dataset"]
    kw = {k: v for k, v in cfg.items() if k not in ("_class_name", "fs")}
    kw["max_point_count"] = 800
    port = p_nuscenes.MotionDataset(
        CombinedZipFileSystem(paths=[info["archive"]],
                              enable_cached_info=True), **kw)
    ref = j_nuscenes.MotionDataset(JaxZip(paths=[info["archive"]]), **kw)
    assert len(ref) == 2  # 6 s at 2 fps from begin times 0 and 2 s
    assert_same_dataset(port, ref)
    item = ref[0]
    assert item["lidar_points"].shape == (4, 800, 3)
    assert item["lidar_points_mask"].all()
    box = np.asarray(item["3dbox_bev_images"][0])
    assert box.shape == (640, 640, 3) and box.any()
    tables = {t["name"] for t in ref.tables["scene"]}
    assert tables == {"scene-0001"}
    assert len(ref.tables["sample_annotation"]) == 12 * 6


# -- Waymo --------------------------------------------------------------------

WAYMO_CASES = {
    "camera": dict(sequence_length=2, fps_stride_tuples=[(10, 1)],
                   sensor_channels=["FRONT"], enable_camera_transforms=True,
                   enable_ego_transforms=True),
    "lidar": dict(sequence_length=1, fps_stride_tuples=[(10, 1)],
                  sensor_channels=["LIDAR_TOP"], max_point_count=16),
    "rasters": dict(sequence_length=1, fps_stride_tuples=[(10, 1)],
                    sensor_channels=["CAM_FRONT"],
                    _3dbox_image_settings={"pen_width": 2},
                    _3dbox_bev_settings={"image_size": [640, 640]}),
}


@pytest.mark.parametrize("case", list(WAYMO_CASES))
def test_waymo_items_as_jax(shard, case):  # noqa: F811
    kw = WAYMO_CASES[case]
    for port_fs, ref_fs in filesystems(shard):
        port = p_waymo.MotionDataset(port_fs, str(shard / "info.json"), **kw)
        ref = j_waymo.MotionDataset(ref_fs, str(shard / "info.json"), **kw)
        assert_same_dataset(port, ref)


def test_tfrecord_wire_format_as_jax(shard):  # noqa: F811
    frame = make_frame(7, (1, 2, 3), with_lidar=True)
    assert p_tfrecord.parse_protobuf(frame) == j_tfrecord.parse_protobuf(
        frame)
    with open(shard / "segment-000.tfrecord", "rb") as f:
        port = list(p_tfrecord.iterate_tfrecord(f))
    with open(shard / "segment-000.tfrecord", "rb") as f:
        assert port == list(j_tfrecord.iterate_tfrecord(f))
        assert p_tfrecord.make_tfrecord_index(f) == \
            j_tfrecord.make_tfrecord_index(f)
    assert p_tfrecord.encode_field(3, 1.5) == j_tfrecord.encode_field(3, 1.5)


# -- Argoverse, KITTI-360, OpenDV -------------------------------------------

ARGOVERSE_CASES = {
    "full": dict(sequence_length=2, fps_stride_tuples=[(0, 1)],
                 sensor_channels=["lidar", "cameras/ring_front_center"],
                 enable_camera_transforms=True, enable_ego_transforms=True,
                 _3dbox_image_settings={"pen_width": 2},
                 hdmap_image_settings={"pen_width": 2},
                 max_point_count=128),
    "bev": dict(sequence_length=1, fps_stride_tuples=[(0, 1)],
                sensor_channels=["lidar"],
                _3dbox_bev_settings={"image_size": [640, 640]},
                hdmap_bev_settings={"image_size": [640, 640]},
                max_point_count=48),
}


@pytest.mark.parametrize("case", list(ARGOVERSE_CASES))
def test_argoverse_items_as_jax(argoverse_root, case):  # noqa: F811
    kw = ARGOVERSE_CASES[case]
    for port_fs, ref_fs in filesystems(argoverse_root):
        assert_same_dataset(p_argoverse.MotionDataset(port_fs, **kw),
                            j_argoverse.MotionDataset(ref_fs, **kw))


KITTI_CASES = {
    "bev": dict(sequence_length=2, fps_stride_tuples=[(0, 1)],
                enable_ego_transforms=True,
                _3dbox_bev_settings={
                    "bev_size": [64, 64], "pen_width": 1,
                    "bev_from_ego_transform": [
                        [3.2, 0, 0, 32], [0, -3.2, 0, 32],
                        [0, 0, -3.2, 0], [0, 0, 0, 1]]},
                max_point_count=64),
    "val": dict(sequence_length=2, fps_stride_tuples=[(0, 1)], split="val"),
    "interpolated": dict(sequence_length=4, fps_stride_tuples=[(0, 1)],
                         enable_ego_transforms=True, max_point_count=40),
}


@pytest.mark.parametrize("case", list(KITTI_CASES))
def test_kitti360_items_as_jax(kitti_root, case):  # noqa: F811
    kw = KITTI_CASES[case]
    for port_fs, ref_fs in filesystems(kitti_root):
        assert_same_dataset(p_kitti.MotionDataset(port_fs, **kw),
                            j_kitti.MotionDataset(ref_fs, **kw))


def test_kitti360_pose_math_as_jax():
    rng = np.random.default_rng(0)
    q = rng.standard_normal(4)
    q /= np.linalg.norm(q)
    r = p_common.quaternion_to_matrix(q)
    np.testing.assert_array_equal(p_kitti.mat_to_quat(r),
                                  j_kitti.mat_to_quat(r))
    q2 = np.array([np.sqrt(0.5), 0, 0, np.sqrt(0.5)])
    for t in (0.0, 0.3, 1.0):
        np.testing.assert_array_equal(p_kitti.quat_slerp(q, q2, t),
                                      j_kitti.quat_slerp(q, q2, t))
    p1, p2 = np.eye(4), np.eye(4)
    p2[:3, :3] = r
    p2[:3, 3] = [3, 1, 0]
    for a, b in zip(p_kitti.interpolate_pose(p1, p2, 4),
                    j_kitti.interpolate_pose(p1, p2, 4)):
        np.testing.assert_array_equal(a, b)


OPENDV_CASES = {
    "decode": dict(meta="meta.json", sequence_length=3,
                   fps_stride_tuples=[(5, 0.5)], split="Train",
                   shuffle_seed=None, enable_fake_camera_transforms=True,
                   enable_fake_3dbox_images=True,
                   enable_fake_hdmap_images=True, image_size=(64, 36)),
    "shuffled": dict(meta="meta.json", sequence_length=2,
                     fps_stride_tuples=[(5, 1.0), (10, 2.0)],
                     shuffle_seed=3, image_size=(32, 32)),
    "gray": dict(meta="missing.json", sequence_length=2,
                 fps_stride_tuples=[(5, 1.0)], shuffle_seed=None,
                 image_size=(32, 32)),
    "mini_batch": dict(meta="meta.json", sequence_length=2,
                       fps_stride_tuples=[(5, 1.0)], mini_batch=3,
                       shuffle_seed=None, image_size=(32, 32)),
}


@pytest.mark.parametrize("case", list(OPENDV_CASES))
def test_opendv_items_as_jax(opendv_root, tmp_path, case):  # noqa: F811
    kw = dict(OPENDV_CASES[case])
    meta = opendv_root / kw.pop("meta")
    if not meta.exists():
        meta = tmp_path / meta.name
        meta.write_text(json.dumps([{
            "videoid": "missing", "path": "missing.mp4", "length": 2.0,
            "fps": 10, "split": "Train"}]))
    for port_fs, ref_fs in filesystems(opendv_root):
        assert_same_dataset(p_opendv.MotionDataset(port_fs, str(meta), **kw),
                            j_opendv.MotionDataset(ref_fs, str(meta), **kw))


# -- CARLA streaming and the preview package ----------------------------------

def test_carla_adapter_as_jax():
    kw = dict(sensor_channels=["CAM_FRONT"], image_size=(64, 48),
              _3dbox_image_settings={"pen_width": 2},
              hdmap_image_settings={"pen_width": 1})
    port = p_carla.StreamingDataAdapter(FakeClient(), **kw)
    ref = j_carla.StreamingDataAdapter(FakeClient(), **kw)
    for _ in range(2):
        assert_same_item(port.query_data(), ref.query_data())
    assert port.world.ticks == ref.world.ticks == 2


def test_carla_helpers_as_jax():
    for w in (obj(sun_altitude_angle=-30, precipitation=60, fog_density=0,
                  cloudiness=0),
              obj(sun_altitude_angle=40, precipitation=0, fog_density=50,
                  cloudiness=90)):
        assert p_carla.weather_to_prompt(w, "city.") == \
            j_carla.weather_to_prompt(w, "city.")
    assert p_carla.extract_opendrive_lines(XODR) == \
        j_carla.extract_opendrive_lines(XODR)
    t = make_transform(1, 2, 3, yaw=90, pitch=10, roll=-5)
    np.testing.assert_array_equal(p_carla.carla_transform_to_matrix(t),
                                  j_carla.carla_transform_to_matrix(t))
    np.testing.assert_array_equal(p_carla.intrinsics_from_fov(64, 48, 70.0),
                                  j_carla.intrinsics_from_fov(64, 48, 70.0))


PREVIEW_CASES = {
    "item": dict(sequence_length=2, fps_stride_tuples=[(0, 1)],
                 sensor_channels=["CAM_FRONT"], use_hdmap=False,
                 image_size=(32, 32)),
    "fps": dict(sequence_length=2, fps_stride_tuples=[(2, 0.5)],
                sensor_channels=["CAM_FRONT"], use_hdmap=False,
                use_3dbox=False, drop_vehicle_color=True,
                image_size=(32, 32)),
}


@pytest.mark.parametrize("case", list(PREVIEW_CASES))
def test_preview_items_as_jax(preview_package, case):  # noqa: F811
    kw = PREVIEW_CASES[case]
    path = str(preview_package / "data.json")
    assert_same_dataset(p_preview.PreviewDataset(path, **kw),
                        j_preview.PreviewDataset(path, **kw))


def test_drop_vehicle_color_as_jax():
    for text in ("a red car drives", "the dark SUV stops", "a red house",
                 "two white trucks and a blue bus"):
        assert p_preview.drop_vehicle_color(text) == \
            j_preview.drop_vehicle_color(text)


# -- the common layer ---------------------------------------------------------

class FakeDataset:
    def __init__(self, n=20):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"index": i, "x": np.full((2, 2), float(i))}


def test_geometry_as_jax():
    rng = np.random.default_rng(4)
    for _ in range(5):
        q, t = rng.standard_normal(4), rng.standard_normal(3)
        for name in ("quaternion_to_matrix",):
            np.testing.assert_array_equal(getattr(p_common, name)(q),
                                          getattr(j_common, name)(q))
        np.testing.assert_array_equal(p_common.get_transform(q, t),
                                      j_common.get_transform(q, t))
        a, b = rng.standard_normal(3) * 3, rng.standard_normal(3) * 3
        assert p_common.project_line(a, b) == j_common.project_line(a, b)
        assert p_common.project_line(a, b, 0.5, 2.0) == \
            j_common.project_line(a, b, 0.5, 2.0)
    np.testing.assert_array_equal(
        p_common.make_intrinsic_matrix([500, 501], [320, 240]),
        j_common.make_intrinsic_matrix([500, 501], [320, 240]))


def test_draw_3dbox_image_as_jax():
    from PIL import Image, ImageDraw

    view = np.eye(4)
    view[:3, :3] = [[50, 0, 32], [0, 50, 24], [0, 0, 1]]
    anns = [{"t": [0.5 * i, 0, 6 + i], "label": "car" if i % 2 else "x"}
            for i in range(4)]
    images = []
    for module in (p_common, j_common):
        image = Image.new("RGB", (64, 48))
        module.draw_3dbox_image(
            ImageDraw.Draw(image), view, anns,
            lambda a: module.get_transform([1, 0, 0, 0], a["t"]),
            lambda a: a["label"], 2, {"car": (0, 0, 255)})
        images.append(image)
    assert_same_item(*images)
    assert np.asarray(images[0]).any()


def test_captions_as_jax():
    settings = {"selected_keys": ["time", "weather", "objects"],
                "reorder_keys": True, "drop_rates": {"weather": 0.5},
                "align_keys": ["time"]}
    caps = [{"time": t, "weather": "sun", "objects": "cars"}
            for t in ("day", "day", "night")]
    assert p_common.align_image_description_crossview(
        [dict(c) for c in caps], settings) == \
        j_common.align_image_description_crossview(
            [dict(c) for c in caps], settings)
    rp, rj = np.random.RandomState(0), np.random.RandomState(0)
    for _ in range(8):
        assert p_common.make_image_description_string(caps[0], settings, rp) \
            == j_common.make_image_description_string(caps[0], settings, rj)


def test_lookups_and_padding_as_jax():
    keys = ["b", "a", "c", "a", "d"]
    port, ref = p_common.ReadonlyDictIndices(keys), \
        j_common.ReadonlyDictIndices(keys)
    for k in ("a", "b", "c", "d"):
        assert port.get_all_indices(k) == ref.get_all_indices(k)
        assert port[k] == ref[k]
    with pytest.raises(KeyError):
        port["e"]
    values = [0.0, 1.5, 3.0, 7.0]
    for t in (-1, 0.7, 0.75, 2.9, 9):
        assert p_common.find_nearest(values, t) == \
            j_common.find_nearest(values, t)
    rng = np.random.default_rng(5)
    clouds = [rng.standard_normal((n, 5)).astype(np.float32)
              for n in (10, 34720 // 64, 3)]
    for a, b in zip(p_common.pad_points(clouds, 256),
                    j_common.pad_points(clouds, 256)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for stub in ({"x": ("tensor", (2, 3), 0.5), "y": ("value", "s")}, None):
        got, want = {"a": 1}, {"a": 1}
        p_common.add_stub_key_data(stub, got)
        j_common.add_stub_key_data(stub, want)
        assert_same_item(got, want)


def test_adapters_and_collate_as_jax():
    kw = dict(transform_list=[{"old_key": "x", "new_key": "y",
                               "transform": lambda v: v * 2}],
              pop_list=["x"])
    port = p_common.DatasetAdapter(FakeDataset(), **kw)
    ref = j_common.DatasetAdapter(FakeDataset(), **kw)
    for index in (3, "4-8-256-448", "0-1-2-3"):
        assert_same_item(port[index], ref[index])
    port = p_common.ConcatMotionDataset([FakeDataset(10), FakeDataset(20)],
                                        [0.5, 1.0])
    ref = j_common.ConcatMotionDataset([FakeDataset(10), FakeDataset(20)],
                                       [0.5, 1.0])
    assert len(port) == len(ref) == 25
    for i in range(25):
        assert_same_item(port[i], ref[i])
    items = [{"x": np.ones((2,)), "caption": "a", "n": 1, "f": 0.5,
              "imgs": [1]},
             {"x": np.zeros((2,)), "caption": "b", "n": 2, "f": 1.5,
              "imgs": [2]}]
    assert_same_item(p_common.CollateFnIgnoring(["caption"])(items),
                     j_common.CollateFnIgnoring(["caption"])(items))


@pytest.mark.parametrize("name,alias", [
    ("NuScenesDataset", "dwm.datasets.nuscenes.MotionDataset"),
    ("WaymoDataset", "dwm.datasets.waymo.MotionDataset"),
    ("ArgoverseDataset", "dwm.datasets.argoverse.MotionDataset"),
    ("Kitti360Dataset", "dwm.datasets.kitti360.MotionDataset"),
    ("OpenDVDataset", "dwm.datasets.opendv.MotionDataset"),
    ("StreamingDataAdapter",
     "dwm.datasets.carla_streaming.StreamingDataAdapter"),
    ("PreviewDataset", "dwm.datasets.preview.PreviewDataset"),
    ("DatasetAdapter", "dwm.datasets.common.DatasetAdapter"),
    ("ConcatMotionDataset", "dwm.datasets.common.ConcatMotionDataset"),
    ("CollateFnIgnoring", "dwm.datasets.common.CollateFnIgnoring"),
    ("VariableVideoBatchSampler",
     "dwm.utils.sampler.VariableVideoBatchSampler"),
])
def test_data_classes_resolve(name, alias):
    cls = get_class(alias)
    assert cls is get_class(name)
    assert cls.__module__.startswith("opendwm_tpu_torch.")
