"""The port's streaming CLI (``opendwm_tpu_torch/streaming.py``) and its
synthetic live source, against the JAX package's where both have the
function (mirrors ``tests/test_streaming_writers.py``), and the CLI run on
``configs/ctsd/ctsd_streaming_synthetic.json`` on the CPU."""

import os
import socket
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from opendwm_tpu import streaming as jax_streaming
from opendwm_tpu.datasets import synthetic as jax_synthetic
from opendwm_tpu_torch import streaming
from opendwm_tpu_torch.datasets.synthetic import SyntheticStreamingAdapter

REPO = Path(__file__).resolve().parents[1]
CONFIG = REPO / "configs/ctsd/ctsd_streaming_synthetic.json"


def free_port():
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_merge_multiview_matches_jax():
    frame = np.random.default_rng(0).uniform(0, 1, (3, 4, 5, 3))
    strip = streaming.merge_multiview_images(frame)
    assert strip.shape == (4, 15, 3)
    np.testing.assert_array_equal(
        strip, jax_streaming.merge_multiview_images(frame))
    np.testing.assert_array_equal(strip[:, 5:10], frame[1])


def test_frame_to_image():
    frame = torch.linspace(-1.5, 1.5, 2 * 4 * 5 * 16).reshape(2, 4, 5, 16)
    image = streaming.frame_to_image(frame)
    assert image.dtype == np.uint8 and image.shape == (4, 10, 3)
    want = np.clip((frame[..., :3].numpy() + 1) / 2, 0, 1)
    want = (streaming.merge_multiview_images(want) * 255).astype(np.uint8)
    np.testing.assert_array_equal(image, want)


def test_png_writer(tmp_path):
    w = streaming.PNGWriter(str(tmp_path))
    w.write(np.zeros((4, 4, 3), np.uint8))
    w.write(np.zeros((4, 4, 3), np.uint8))
    assert sorted(os.listdir(tmp_path)) == [
        "frame_000000.png", "frame_000001.png"]


def test_mjpeg_server_streams_frames():
    port = free_port()
    server = streaming.MJPEGServer(port, fps=10)
    try:
        img = np.zeros((8, 8, 3), np.uint8)
        img[::2] = 255
        server.write(img)
        req = urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=5)
        assert "multipart/x-mixed-replace" in req.headers["Content-Type"]
        server.write(img)  # wake the handler loop
        head = req.read(200)
        assert b"--frame" in head and b"image/jpeg" in head
        assert b"\xff\xd8" in head + req.read(400)  # a JPEG's SOI marker
    finally:
        server.close()


@pytest.mark.parametrize("scheme", ["http://:{}", "mjpeg://:{}/", None,
                                    "rtsp://localhost/x", "file.mp4"])
def test_make_writer_routing_matches_jax(scheme, tmp_path):
    try:
        import av  # noqa: F401
        if scheme and scheme.startswith("rtsp"):
            pytest.skip("PyAV is installed: rtsp:// would open a stream")
    except ImportError:
        pass
    kinds = []
    for mod in (streaming, jax_streaming):
        path = scheme.format(free_port()) if scheme else None
        w = mod.make_writer(path, str(tmp_path), 10, 8, 8)
        kinds.append(type(w).__name__)
        w.close()
    assert kinds[0] == kinds[1]
    want = "MJPEGServer" if scheme and "://:" in scheme else "PNGWriter"
    assert kinds[0] == want


def test_synthetic_adapter_draws_equal_jax():
    ours = SyntheticStreamingAdapter(view_count=3, seed=4)
    ref = jax_synthetic.SyntheticStreamingAdapter(view_count=3, seed=4)
    assert ours.sensor_channels == ref.sensor_channels
    for _ in range(3):
        a, b = ours.query_data(), ref.query_data()
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
    assert ours.tick == 3


def _args(out, *extra):
    return streaming.create_parser().parse_args(
        ["-c", str(CONFIG), "-o", str(out), *extra])


def test_cli_writes_frames_on_cpu(tmp_path, capsys):
    streaming.main(_args(tmp_path, "--device", "cpu", "--max-frames", "2"))
    files = sorted(os.listdir(tmp_path))
    assert files == ["frame_000000.png", "frame_000001.png"]
    # latent_shape (1, 3, 2, 8, 8, 16), no VAE: 2 views of 8 x 8 → 8 x 16
    images = [np.asarray(Image.open(tmp_path / f)) for f in files]
    assert all(im.shape == (8, 16, 3) for im in images)
    assert not np.array_equal(images[0], images[1])
    out = capsys.readouterr().out
    assert "ignoring JAX-only config key jax_platform" in out
    assert "frame 2" in out


def test_cli_needs_a_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        streaming.main(_args(tmp_path, "--max-frames", "1"))
    assert not (tmp_path / "frame_000000.png").exists()


def test_cli_module_entry_point(tmp_path):
    subprocess.run(
        [sys.executable, "-m", "opendwm_tpu_torch.streaming", "-c",
         str(CONFIG), "-o", str(tmp_path), "--max-frames", "1", "--device",
         "cpu"], check=True, timeout=300, cwd=REPO, capture_output=True)
    assert os.listdir(tmp_path) == ["frame_000000.png"]
