"""Realtime streaming CLI of the port (``opendwm_tpu/streaming.py``).

Loop: the data adapter's ``query_data`` → ``send_frame_condition`` →
``receive_frame`` → decode and compose the multiview frame → write it.
Sinks: ``rtsp://`` muxes H.264 through PyAV when it is importable;
``http://:PORT`` or ``mjpeg://:PORT`` serves multipart JPEG from the
standard library; otherwise numbered PNGs in the output directory.

    python -m opendwm_tpu_torch.streaming -c config.json -o out/ \\
        [--device cuda|cpu] [--streaming-path URL] [--max-frames N]

``--device`` defaults to ``cuda`` and raises without a card; it never
falls back to the CPU.

Under ``torchrun`` the pipeline's mesh spans every rank (built after the
process group, as in the other CLIs). Where ``latent_shape``'s batch divides by the data ranks, each rank
serves its rows of the stream (its rows of the global noise and of each
tick's conditions, ``sharding.shard_batch``) and rank 0 writes its row 0,
the global row 0, as the JAX CLI writes ``frame[0]``; where it does not
(batch 1, the usual stream), every rank serves the whole stream, as JAX
replicates it, and rank 0 writes. Other ranks write nothing.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from opendwm_tpu_torch.config import create_instance_from_config, global_state
from opendwm_tpu_torch.parallel.sharding import data_parallel_size, \
    shard_batch
from opendwm_tpu_torch.train import (
    _JAX_ONLY_KEYS,
    _device,
    launch,
    to_device_batch,
)


def merge_multiview_images(frame: np.ndarray) -> np.ndarray:
    """(v, h, w, c) → a horizontal strip (h, v * w, c)."""
    v, h, w, c = frame.shape
    return frame.transpose(1, 0, 2, 3).reshape(h, v * w, c)


def frame_to_image(frame: torch.Tensor) -> np.ndarray:
    """One emitted frame (v, h, w, c) in [-1, 1] (decoded images, or
    latents when no VAE is attached: their first 3 channels) → the uint8
    strip the writers take."""
    frame = frame.float().cpu().numpy()
    if frame.shape[-1] != 3:
        frame = frame[..., :3]
    image = merge_multiview_images(np.clip((frame + 1) / 2, 0, 1))
    return (image * 255).astype(np.uint8)


def create_parser():
    parser = argparse.ArgumentParser(
        description="Stream generated multiview frames from a JSON config "
                    "(PyTorch port).")
    parser.add_argument("-c", "--config-path", required=True)
    parser.add_argument("-o", "--output-path", required=True)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--streaming-path", default=None)
    parser.add_argument("--max-frames", type=int, default=None)
    parser.add_argument("--fps", type=float, default=10.0)
    return parser


class RTSPWriter:
    """H.264 → RTSP mux via PyAV: low-latency x264 settings, one video
    stream."""

    def __init__(self, url: str, fps: float, width: int, height: int):
        import av

        self.container = av.open(url, "w", format="rtsp")
        self.stream = self.container.add_stream(
            "libx264", rate=max(1, round(fps)))
        self.stream.width = width
        self.stream.height = height
        self.stream.pix_fmt = "yuv420p"
        self.stream.options = {"tune": "zerolatency", "preset": "ultrafast"}
        self._av = av

    def write(self, image_uint8: np.ndarray):
        frame = self._av.VideoFrame.from_ndarray(image_uint8, format="rgb24")
        for packet in self.stream.encode(frame):
            self.container.mux(packet)

    def close(self):
        for packet in self.stream.encode():
            self.container.mux(packet)
        self.container.close()


class MJPEGServer:
    """Live stream without dependencies: multipart JPEG over HTTP from the
    standard library, at ``http://<host>:<port>/`` (any browser or
    ffplay). ``write`` publishes a frame; each client gets the newest
    frame at its own pace."""

    def __init__(self, port: int, fps: float = 10.0):
        import http.server
        import threading

        self._lock = threading.Condition()
        self._frame: bytes = b""
        self._seq = 0
        self._fps = fps
        server_self = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib API)
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "multipart/x-mixed-replace; boundary=frame")
                self.end_headers()
                last = -1
                try:
                    while True:
                        with server_self._lock:
                            server_self._lock.wait(1.0)
                            if server_self._seq == last:
                                continue
                            buf, last = server_self._frame, server_self._seq
                        self.wfile.write(
                            b"--frame\r\nContent-Type: image/jpeg\r\n"
                            + f"Content-Length: {len(buf)}\r\n\r\n".encode())
                        self.wfile.write(buf)
                        self.wfile.write(b"\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    pass

            def log_message(self, *a):  # quiet
                pass

        self.httpd = http.server.ThreadingHTTPServer(("", port), Handler)
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def write(self, image_uint8: np.ndarray):
        import io

        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(image_uint8).save(buf, format="JPEG", quality=85)
        with self._lock:
            self._frame = buf.getvalue()
            self._seq += 1
            self._lock.notify_all()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


class PNGWriter:
    """One numbered PNG a frame (always available)."""

    def __init__(self, output_path: str):
        self.dir = output_path
        os.makedirs(output_path, exist_ok=True)
        self.idx = 0

    def write(self, image_uint8: np.ndarray):
        from PIL import Image

        Image.fromarray(image_uint8).save(
            os.path.join(self.dir, f"frame_{self.idx:06d}.png"))
        self.idx += 1

    def close(self):
        pass


def make_writer(streaming_path, output_path, fps, width, height):
    """The sink: rtsp:// → PyAV mux (PNGs when PyAV is missing); http://
    or mjpeg://:port → the MJPEG server; else numbered PNGs."""
    if streaming_path:
        if streaming_path.startswith("rtsp://"):
            try:
                return RTSPWriter(streaming_path, fps, width, height)
            except ImportError:
                print("PyAV unavailable; falling back to MJPEG/PNG")
        if streaming_path.startswith(("http://", "mjpeg://")):
            port = int(streaming_path.rsplit(":", 1)[-1].strip("/"))
            return MJPEGServer(port, fps)
    return PNGWriter(output_path)


def main(args=None):
    args = args or create_parser().parse_args()
    with open(args.config_path) as f:
        config = json.load(f)
    device = _device(args.device)
    rank = launch(device)
    for key in _JAX_ONLY_KEYS:
        if key in config:
            print(f"ignoring JAX-only config key {key}={config[key]!r}",
                  flush=True)
    for key, value in config.get("global_state", {}).items():
        global_state[key] = create_instance_from_config(value)

    seed = config.get("generator_seed", 0)
    torch.manual_seed(seed)
    pipeline = create_instance_from_config(config["pipeline"])
    pipeline.model.to(device).eval()
    adapter = create_instance_from_config(config["data_adapter"])
    latent_shape = tuple(config["latent_shape"])  # (b, T, v, h, w, c)
    window = latent_shape[1]
    generator = torch.Generator(device).manual_seed(seed)
    split = pipeline.splits_stream(latent_shape)
    rows = latent_shape[0] // data_parallel_size(pipeline.mesh) if split \
        else latent_shape[0]  # the rows of the stream this rank serves

    def query():
        data = to_device_batch(adapter.query_data(), device)
        return shard_batch(data, pipeline.mesh) if split else data

    def tile_window(x):
        # single-frame (b, 1, v, ...) conditions → full-window templates
        if x.ndim >= 2 and x.shape[1] == 1:
            return torch.cat([x] * window, 1)
        return x

    first = query()
    cond_template = {
        k: tile_window(v) for k, v in first.items()
        if k in ("encoder_hidden_states", "pooled_projections",
                 "condition_image_tensor")
    } or {"pooled_projections": torch.zeros(
        (rows, window, latent_shape[2], 16), device=device)}
    stream = pipeline.reset_streaming(latent_shape, cond_template, generator)

    if rank == 0:
        os.makedirs(args.output_path, exist_ok=True)
    frame_idx = 0
    writer = None
    try:
        while args.max_frames is None or frame_idx < args.max_frames:
            stream = pipeline.send_frame_condition(stream, query())
            stream, latent, ready = pipeline.receive_frame(stream)
            if not ready:
                continue
            frame_idx += 1
            if rank != 0:
                continue
            image8 = frame_to_image(pipeline.decode_latents(latent)[0])
            if writer is None:
                writer = make_writer(
                    args.streaming_path, args.output_path, args.fps,
                    image8.shape[1], image8.shape[0])
            writer.write(image8)
            print(f"frame {frame_idx}", flush=True)
    finally:
        if writer is not None:
            writer.close()


if __name__ == "__main__":
    main()
