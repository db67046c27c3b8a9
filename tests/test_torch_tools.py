"""The port's LiDAR and data tools and utilities (``utils/lidar.py``,
``utils/render.py``, ``utils/lidar_visualizer*.py`` and ``tools/``)
against the JAX package's, on the CPU.

Host-side code is held bit for bit (the renderers' pixels, the export
tools' files and records, the archive and tfrecord indexes); the tensor
helpers to 1e-6; ``make_blank_code`` by its ranking: the synthetic LiDAR
tokenizer of ``configs/lidar/lidar_vqvae_synthetic.json`` with the JAX
params (drawn with numpy from ``jax.eval_shape``) through the LiDAR bridge,
on the same synthetic batches, gives the JAX tool's list.
"""

import copy
import io
import json
import tarfile
import zipfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opendwm_tpu.config as jax_config
from opendwm_tpu.tools import dataset_make_info_json as jax_dataset_info
from opendwm_tpu.tools import export_nusc_2_preview_format as jax_preview
from opendwm_tpu.tools import export_nuscenes as jax_export
from opendwm_tpu.tools import fs_make_info_json as jax_fs_info
from opendwm_tpu.tools import make_blank_code as jax_blank
from opendwm_tpu.tools import visualize_lidar as jax_visualize
from opendwm_tpu.utils import lidar as jax_lidar
from opendwm_tpu.utils import lidar_visualizer as jax_vis
from opendwm_tpu.utils import lidar_visualizer_utils as jax_vis_utils
from opendwm_tpu.utils import render as jax_render
from opendwm_tpu_torch import config
from opendwm_tpu_torch.datasets.tfrecord import write_tfrecord
from opendwm_tpu_torch.models.mmdit import get_rays
from opendwm_tpu_torch.tools import (
    dataset_make_info_json,
    export_nusc_2_preview_format,
    export_nuscenes,
    fs_make_info_json,
    make_blank_code,
    visualize_lidar,
)
from opendwm_tpu_torch.utils import (
    lidar,
    lidar_visualizer,
    lidar_visualizer_utils,
    render,
)

from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    flax_init,
    load_lidar,
    one_torch_thread,
)

REPO = Path(__file__).resolve().parents[1]
VQ_CONFIG = REPO / "configs/lidar/lidar_vqvae_synthetic.json"
YAW90 = (np.cos(np.pi / 4), 0.0, 0.0, np.sin(np.pi / 4))
LIDAR_DATASET = {"_class_name": "SyntheticLidarDataset", "size": 6,
                 "sequence_length": 2, "point_count": 64, "pc_range": 6.0,
                 "bev_size": 64}


def _same_images(got: list, want: list) -> None:
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.size == b.size and a.mode == b.mode
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# -- tensor helpers -----------------------------------------------------------

def test_lidar_transforms_match_jax():
    rng = np.random.default_rng(0)
    pts = rng.standard_normal((2, 5, 3)).astype(np.float32)
    tf = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    tf[:, :3, :3] += 0.2 * rng.standard_normal((2, 3, 3))
    tf[:, :3, 3] = rng.standard_normal((2, 3))
    for name in ("preprocess_points", "postprocess_points"):
        want = getattr(jax_lidar, name)(jnp.asarray(pts), jnp.asarray(tf))
        got = getattr(lidar, name)(torch.from_numpy(pts),
                                   torch.from_numpy(tf))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
        assert getattr(lidar, name)(torch.from_numpy(pts)) is not None
    back = lidar.postprocess_points(
        lidar.preprocess_points(torch.from_numpy(pts), torch.from_numpy(tf)),
        torch.from_numpy(tf))
    np.testing.assert_allclose(back.numpy(), pts, atol=1e-5)


def test_render_helpers_match_jax():
    rng = np.random.default_rng(1)
    pts = rng.uniform(-5, 5, (2, 7, 3)).astype(np.float32)
    pts[..., 2] += 8
    k = np.tile(np.array([[40.0, 0, 32], [0, 40, 24], [0, 0, 1]],
                         np.float32), (2, 1, 1))
    pose = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    pose[:, :3, 3] = rng.standard_normal((2, 3))
    want = jax_render.project_points_to_image(*map(jnp.asarray,
                                                   (pts, k, pose)))
    got = render.project_points_to_image(*map(torch.from_numpy,
                                              (pts, k, pose)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    pix = rng.uniform(0, 60, (9, 2)).astype(np.float32)
    want = jax_render.rays_for_pixels(jnp.asarray(k[0]), jnp.asarray(pose[0]),
                                      jnp.asarray(pix))
    got = render.rays_for_pixels(torch.from_numpy(k[0]),
                                 torch.from_numpy(pose[0]),
                                 torch.from_numpy(pix))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    assert render.get_rays is get_rays


# -- the visualizer and its utilities -------------------------------------------

def test_visualizer_utils_match_jax():
    for mod in (jax_vis_utils, lidar_visualizer_utils):
        assert mod.quaternion_yaw(YAW90) == pytest.approx(np.pi / 2)
    np.testing.assert_array_equal(
        lidar_visualizer_utils.transform_matrix((1.0, 2.0, 3.0), YAW90, True),
        jax_vis_utils.transform_matrix((1.0, 2.0, 3.0), YAW90, True))
    boxes = []
    for mod in (lidar_visualizer_utils, jax_vis_utils):
        box = mod.Box((10.0, 0.0, 1.0), (2.0, 4.0, 1.5), YAW90,
                      name="vehicle.car.sedan")
        box.rotate(YAW90)
        box.translate((1.0, -2.0, 0.5))
        boxes.append(box)
    np.testing.assert_array_equal(boxes[0].corners(), boxes[1].corners())
    np.testing.assert_array_equal(boxes[0].bottom_corners(),
                                  boxes[1].bottom_corners())
    for name in ("vehicle.car.sedan", "human.pedestrian.adult", "unknown",
                 None):
        assert lidar_visualizer_utils.category_color(name) == \
            jax_vis_utils.category_color(name)
    poly = np.array([[0.0, 0.0], [3.0, 4.0], [3.0, 5.0]])
    np.testing.assert_array_equal(
        lidar_visualizer_utils.densify_polyline(poly, 2.0),
        jax_vis_utils.densify_polyline(poly, 2.0))
    pts = np.random.default_rng(2).uniform(-10, 10, (50, 3))
    np.testing.assert_array_equal(
        lidar_visualizer_utils.filter_points_in_range(pts, -5, 5, -3, 3),
        jax_vis_utils.filter_points_in_range(pts, -5, 5, -3, 3))
    poses = [{"translation": (0.0, 0.0, 0.0), "rotation": (1.0, 0, 0, 0)},
             {"translation": (4.0, 2.0, 0.0), "rotation": YAW90}]
    got = lidar_visualizer_utils.interpolate_poses(poses, 3)
    want = jax_vis_utils.interpolate_poses(poses, 3)
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["translation"], b["translation"])
        np.testing.assert_array_equal(a["rotation"], b["rotation"])
    for (e1, c1), (e2, c2) in zip(
            lidar_visualizer_utils.camera_path_from_trajectory(got),
            jax_vis_utils.camera_path_from_trajectory(want)):
        np.testing.assert_array_equal(e1, e2)
        np.testing.assert_array_equal(c1, c2)
    frames = [pts[:20], pts[20:]]
    kwargs = dict(width=64, height=48)
    _same_images(
        lidar_visualizer_utils.render_trajectory(
            frames, poses, [[boxes[0]], []], **kwargs),
        jax_vis_utils.render_trajectory(frames, poses, [[boxes[1]], []],
                                        **kwargs))


@pytest.mark.parametrize("perspective", [False, True])
def test_renderers_match_jax(perspective):
    rng = np.random.default_rng(3)
    frames = [rng.uniform(-20, 20, (300, 3)) for _ in range(2)]
    masks = [rng.uniform(size=300) > 0.3 for _ in range(2)]
    kwargs = dict(width=80, height=60) if perspective else \
        dict(image_size=96)
    _same_images(
        lidar_visualizer.render_sequence(frames, masks, perspective,
                                         **kwargs),
        jax_vis.render_sequence(frames, masks, perspective, **kwargs))
    corners = np.array([[x, y, z] for x in (8, 12) for y in (-1, 1)
                        for z in (0, 1.5)])
    line = np.array([[5.0, -2, 0], [15, -2, 0]])
    renderer = (lidar_visualizer.PerspectiveRenderer if perspective
                else lidar_visualizer.BEVRenderer)(**kwargs)
    ref = (jax_vis.PerspectiveRenderer if perspective
           else jax_vis.BEVRenderer)(**kwargs)
    lines = [(line if perspective else line[:, :2], (0, 0, 200))]
    _same_images(
        [renderer.render(frames[0], boxes=[(corners, (0, 200, 0))],
                         lines=lines)],
        [ref.render(frames[0], boxes=[(corners, (0, 200, 0))],
                    lines=lines)])


def test_visualize_lidar_cli_matches_jax(tmp_path):
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"dataset": LIDAR_DATASET}))
    written = {}
    for name, tool in (("port", visualize_lidar), ("jax", jax_visualize)):
        args = tool.create_parser().parse_args([
            "-c", str(cfg), "-o", str(tmp_path / name), "--max-items", "2",
            "--gif", "--image-size", "64"])
        written[name] = [Path(p).name for p in tool.main(args)]
    assert written["port"] == written["jax"]
    assert "0000_000.png" in written["port"] and "0001.gif" in written["port"]
    for name in written["port"]:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name


# -- the data tools -----------------------------------------------------------

def _preview_item(rng):
    t, v, h, w = 3, 2, 16, 24
    return {
        "fps": np.float32(2.0),
        "pts": np.zeros((t, v), np.float32),
        "images": rng.uniform(0, 1, (t, v, h, w, 3)).astype(np.float32),
        "3dbox_images": rng.uniform(0, 1, (t, v, h, w, 3)).astype(
            np.float32),
        "hdmap_images": rng.uniform(0, 1, (t, v, h, w, 3)).astype(
            np.float32),
        "camera_intrinsics": np.broadcast_to(
            np.eye(3, dtype=np.float32) * 500, (t, v, 3, 3)),
        "camera_transforms": np.broadcast_to(np.eye(4, dtype=np.float32),
                                             (t, v, 4, 4)),
        "ego_transforms": np.broadcast_to(np.eye(4, dtype=np.float32),
                                          (t, 1, 4, 4)),
        "image_description": [[f"frame {i} view {j}" for j in range(v)]
                              for i in range(t)],
    }


def _tree_bytes(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_export_preview_format_matches_jax(tmp_path):
    item = _preview_item(np.random.default_rng(0))
    channels = ["CAM_FRONT", "CAM_BACK"]
    export_nusc_2_preview_format.export_item(item, str(tmp_path / "port"),
                                             channels, 1)
    jax_preview.export_item(item, str(tmp_path / "jax"), channels, 1)
    got, want = _tree_bytes(tmp_path / "port"), _tree_bytes(tmp_path / "jax")
    assert got == want and "data.json" in got
    assert export_nusc_2_preview_format.NUSC_CAMERAS == \
        jax_preview.NUSC_CAMERAS


def test_export_nuscenes_batch_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    frames = rng.uniform(-0.1, 1.1, (2, 2, 8, 12, 3)).astype(np.float32)
    ts = np.array([[0.0, 1.5], [500.0, 501.25]], np.float32)
    channels = ["CAM_FRONT", "CAM_BACK"]
    got = export_nuscenes.export_batch(str(tmp_path / "port"), frames,
                                       channels, ts, "gen000")
    want = jax_export.export_batch(str(tmp_path / "jax"), frames, channels,
                                   ts, "gen000")
    assert got == want and len(got) == 4
    assert _tree_bytes(tmp_path / "port") == _tree_bytes(tmp_path / "jax")


def test_index_tools_match_jax(tmp_path, monkeypatch):
    shards = []
    for i in range(2):
        path = tmp_path / f"s{i}.tfrecord"
        with open(path, "wb") as f:
            write_tfrecord(f, [bytes([j]) * (7 * j + i) for j in range(5)])
        shards.append(str(path))
    outs = {}
    for name, tool in (("port", dataset_make_info_json),
                       ("jax", jax_dataset_info)):
        out = tmp_path / f"{name}.json"
        tool.main(shards + ["-o", str(out)])
        outs[name] = json.loads(out.read_text())
    assert outs["port"] == outs["jax"] and len(outs["port"][shards[0]]) == 5

    zpath, tpath = tmp_path / "a.zip", tmp_path / "a.tar"
    with zipfile.ZipFile(zpath, "w") as z:
        z.writestr("x/one.txt", b"1" * 10)
        z.writestr("two.bin", b"\x00" * 300,
                   compress_type=zipfile.ZIP_DEFLATED)
    with tarfile.open(tpath, "w") as t:
        for name, data in (("x/one.txt", b"1" * 10), ("two.bin", b"2" * 700)):
            info = tarfile.TarInfo(name)
            info.size = len(data)
            t.addfile(info, io.BytesIO(data))
    assert fs_make_info_json.make_zip_info(str(zpath)) == \
        jax_fs_info.make_zip_info(str(zpath))
    assert fs_make_info_json.make_tar_info(str(tpath)) == \
        jax_fs_info.make_tar_info(str(tpath))
    fs_make_info_json.main([str(zpath), str(tpath)])
    assert json.loads((tmp_path / "a.tar.info.json").read_text()) == \
        jax_fs_info.make_tar_info(str(tpath))


# -- make_blank_code ------------------------------------------------------------

def _vq_config() -> dict:
    return json.loads(VQ_CONFIG.read_text())["pipeline"]["vq_point_cloud"]


def test_make_blank_code_matches_jax():
    jax_model = jax_config.create_instance_from_config(_vq_config())
    port = config.create_instance_from_config(_vq_config())
    dataset = config.create_instance_from_config(dict(LIDAR_DATASET,
                                                      size=4))
    collate = config.create_instance_from_config(
        {"_class_name": "CollateFnIgnoring"})
    batches = [collate([dataset[2 * i], dataset[2 * i + 1]])
               for i in range(2)]
    keys = ("lidar_points", "lidar_points_mask")
    params = flax_init(jax_model, *(jnp.asarray(batches[0][k]) for k in keys),
                       render_rays=False, seed=5)
    load_lidar(port, params)
    want = jax_blank.find_blank_codes(
        jax_model, params, [{k: jnp.asarray(b[k]) for k in keys}
                            for b in batches], top_k=6)
    tb = [{k: torch.from_numpy(np.asarray(b[k])) for k in keys}
          for b in batches]
    counts = make_blank_code.code_counts(port, tb)
    assert counts.dtype == torch.int64 and int(counts.sum()) == 2 * 4 * 16
    assert make_blank_code.find_blank_codes(port, tb, top_k=6) == want
    # ties rank as numpy's argsort ranks them
    tied = np.array([3, 5, 5, 0, 5, 3])
    assert make_blank_code.rank_codes(torch.from_numpy(tied), 4) == \
        [int(i) for i in np.argsort(-tied)[:4]]


def test_make_blank_code_cli_writes_the_list(tmp_path):
    cfg = {"vq_point_cloud": _vq_config(), "batch_size": 2,
           "generator_seed": 3,
           "validation_dataset": dict(LIDAR_DATASET, size=4),
           "validation_collate_fn": {"_class_name": "CollateFnIgnoring"}}
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    out = tmp_path / "blank.json"
    args = make_blank_code.create_parser().parse_args(
        ["-c", str(path), "-o", str(out), "--device", "cpu", "--top-k", "4"])
    assert args.device == "cpu"
    assert make_blank_code.create_parser().parse_args(
        ["-c", "x", "-o", "y"]).device == "cuda"
    blank = make_blank_code.main(args)
    assert json.loads(out.read_text()) == {"blank_code": blank}
    assert len(blank) == 4 and len(set(blank)) == 4
    # the same seed, the same weights: the same list
    torch.manual_seed(3)
    model = config.create_instance_from_config(copy.deepcopy(
        cfg["vq_point_cloud"]))
    assert model.vector_quantizer.n_e == 64
    assert make_blank_code.main(args) == blank


def test_export_nuscenes_cli_writes_samples(tmp_path):
    """The CLI generates from the synthetic CTSD config's preview batch (2
    blocks, a landed tiny VAE) on the CPU and writes one JPEG and one
    record a frame and channel."""
    from opendwm_tpu_torch.perf import land_eval
    from test_torch_eval_cli import _small_synthetic

    vae = land_eval.land_tiny_vae(tmp_path / "vae")
    cfg = land_eval.with_vae(_small_synthetic(), land_eval.TINY_VAE, vae)
    cfg["preview_dataset"] = dict(cfg["validation_dataset"], size=2)
    cfg["preview_collate_fn"] = cfg["validation_collate_fn"]
    cfg["sensor_channels"] = ["CAM_FRONT", "CAM_BACK"]
    path = land_eval.write_config(cfg, tmp_path / "cfg.json")
    out = tmp_path / "out"
    args = export_nuscenes.create_parser().parse_args(
        ["-c", str(path), "-o", str(out), "--device", "cpu"])
    records = export_nuscenes.main(args)
    frames = cfg["preview_dataset"]["sequence_length"]
    assert len(records) == 2 * frames
    assert json.loads((out / "sample_data.json").read_text()) == records
    for rec in records:
        assert (out / rec["filename"]).stat().st_size > 0
