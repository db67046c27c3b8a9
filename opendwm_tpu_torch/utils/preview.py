"""Preview composition and media export on the host
(``opendwm_tpu/utils/preview.py``): the view grid of ground truth, layout
and generated frames, the LiDAR BEV compositor, and video export, H.264
through PyAV when it is installed, else an animated GIF through Pillow
(the path returned says which was written)."""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def make_ctsd_preview_tensor(rows: Sequence[np.ndarray],
                             max_views_per_row: Optional[int] = None
                             ) -> np.ndarray:
    """Rows of (t, v, H, W, 3) floats in [0, 1] → (t, H_total, W_total, 3):
    the views side by side, the rows stacked; ``None`` rows are skipped."""
    stacked = []
    for row in rows:
        if row is None:
            continue
        t, v, h, w, c = row.shape
        stacked.append(row.transpose(0, 2, 1, 3, 4).reshape(t, h, v * w, c))
    return np.concatenate(stacked, axis=1)


def make_lidar_bev_preview(voxel_rows: Sequence[np.ndarray],
                           colors: Optional[list] = None) -> np.ndarray:
    """Occupancy grids (t, D, H, W) → their BEV maps (max over z) side by
    side as (t, H, n·W, 3) grey images."""
    frames = []
    for row in voxel_rows:
        bev = row.max(axis=1)  # (t, H, W)
        frames.append(np.repeat(bev[..., None], 3, axis=-1))
    return np.concatenate(frames, axis=2)


def save_tensor_to_video(path: str, fps: float, frames: np.ndarray) -> str:
    """(t, H, W, 3) floats in [0, 1] → an H.264 ``.mp4`` through PyAV when
    it is installed and ``path`` ends in ``.mp4``, else an animated GIF of
    the same stem; returns the path written."""
    frames8 = (np.clip(frames, 0, 1) * 255).astype(np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if path.endswith(".mp4"):
        try:
            import av
        except ImportError:
            av = None
        if av is not None:
            container = av.open(path, "w")
            stream = container.add_stream("libx264", rate=round(fps))
            stream.width = frames8.shape[2]
            stream.height = frames8.shape[1]
            stream.pix_fmt = "yuv420p"
            for frame in frames8:
                f = av.VideoFrame.from_ndarray(frame, format="rgb24")
                for packet in stream.encode(f):
                    container.mux(packet)
            for packet in stream.encode():
                container.mux(packet)
            container.close()
            return path
    from PIL import Image

    gif_path = os.path.splitext(path)[0] + ".gif"
    images = [Image.fromarray(f) for f in frames8]
    images[0].save(gif_path, save_all=True, append_images=images[1:],
                   duration=int(1000 / max(fps, 1)), loop=0)
    return gif_path


def save_tensor_to_image(path: str, image: np.ndarray) -> str:
    """(H, W, 3) floats in [0, 1] → an image file; returns ``path``."""
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray((np.clip(image, 0, 1) * 255).astype(np.uint8)).save(path)
    return path
