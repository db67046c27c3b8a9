"""The port's native data plane (``opendwm_tpu_torch/native``): built with
g++ into ``build/native/`` (never beside its source), each entry point
equal to its numpy fallback and to the JAX package's
(``opendwm_tpu/native``) on the JAX test's zip (``tests/test_native.py``)
and on a nuScenes-format sweep."""

import io
import shutil
import zipfile
import zlib

import numpy as np
import pytest
from test_native import make_zip

import opendwm_tpu.native as jnative
from opendwm_tpu_torch import native

HAS_GXX = shutil.which("g++") is not None
needs_gxx = pytest.mark.skipif(not HAS_GXX, reason="no g++ on this host")
MODES = [pytest.param(True, marks=needs_gxx, id="native"),
         pytest.param(False, id="fallback")]


@needs_gxx
def test_builds_into_build_native():
    assert native.available()
    lib = native.library_path()
    assert lib.exists() and lib.parent == native.BUILD_DIR
    assert native.BUILD_DIR.parts[-2:] == ("build", "native")
    assert lib.name.startswith("libdata_plane_") and lib.suffix == ".so"
    # nothing is written inside the package
    assert not list(native.SRC.parent.glob("*.so"))


@pytest.mark.parametrize("use_native", MODES)
def test_zip_scan(use_native):
    data = make_zip()
    entries = native.zip_scan_central_directory(data, use_native=use_native)
    assert entries == native.zip_scan_central_directory(data,
                                                        use_native=False)
    assert entries == jnative.zip_scan_central_directory(data)
    zf = zipfile.ZipFile(io.BytesIO(data))
    assert [e["name"] for e in entries] == [z.filename for z in zf.infolist()]


@pytest.mark.parametrize("use_native", MODES)
def test_inflate(use_native):
    payload = bytes(np.random.default_rng(0).integers(0, 8, 5000,
                                                      dtype=np.uint8))
    comp = zlib.compress(payload)[2:-4]  # raw deflate
    assert native.inflate_raw(comp, 8192, use_native=use_native) == payload
    assert jnative.inflate_raw(comp, 8192) == payload


@pytest.mark.parametrize("use_native", MODES)
@pytest.mark.parametrize("pc_range", [None, (-5, -5, -5, 5, 5, 5)])
def test_decode_lidar_bin(use_native, pc_range):
    rng = np.random.default_rng(1)
    raw = (rng.standard_normal((3000, 5)) * 10).astype(np.float32).tobytes()
    got = native.decode_lidar_bin(raw, 5, 2048, pc_range,
                                  use_native=use_native)
    want = jnative.decode_lidar_bin(raw, 5, 2048, pc_range)
    fallback = native.decode_lidar_bin(raw, 5, 2048, pc_range,
                                       use_native=False)
    for a, b, c in zip(got, want, fallback):
        assert a.dtype == b.dtype == c.dtype
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("use_native", MODES)
def test_voxelize_points_host(use_native):
    rng = np.random.default_rng(2)
    pts = rng.uniform(-6, 6, (500, 3)).astype(np.float32)
    mask = rng.random(500) < 0.8
    args = (-4.0, -4.0, -1.0, 0.5, 0.25, 8, 16, 16)
    grid = native.voxelize_points_host(pts, mask, *args,
                                       use_native=use_native)
    np.testing.assert_array_equal(
        grid, native.voxelize_points_host(pts, mask, *args,
                                          use_native=False))
    np.testing.assert_array_equal(
        grid, jnative.voxelize_points_host(pts, mask, *args))
    assert grid.sum() > 0


@needs_gxx
def test_native_parity_on_a_nuscenes_archive(tmp_path):
    """``perf/data_plane.native_parity`` (the data phase's gate) on a small
    archive of ``perf/nuscenes_fixture.py``."""
    from opendwm_tpu_torch.perf import data_plane, nuscenes_fixture

    info = nuscenes_fixture.write_archive(tmp_path, samples=3, points=700,
                                          boxes=4)
    out = data_plane.native_parity(
        open(info["archive"], "rb").read(), (-50, -50, -3, 50, 50, 2.6),
        (-50.0, -50.0, -3.0, 0.15625, 0.14, 40, 640, 640))
    assert out["native"] and out["scan_equal"] and out["voxelize_equal"]
    assert out["inflated"] == out["entries"] == 11 + 3
    assert out["decoded"] == 6
    assert out["inflate_mismatches"] == out["decode_mismatches"] == 0
    assert out["voxels"] > 0


def test_required_native_raises_without_the_library(monkeypatch):
    monkeypatch.setattr(native, "_load", lambda: None)
    assert not native.available()
    with pytest.raises(RuntimeError, match="did not build"):
        native.inflate_raw(b"", 1, use_native=True)
    assert native.decode_lidar_bin(np.zeros(5, np.float32).tobytes(), 5,
                                   4)[1].sum() == 1
