"""Synthetic latent-space CTSD batches for smoke tests, benchmarks and CLI
drives (``opendwm_tpu/datasets/synthetic.py:SyntheticCTSDDataset``),
padded LiDAR point clouds with BEV rasters (``SyntheticLidarDataset``), and
the streaming CLI's synthetic live source: the same items from the same
seeds, as numpy arrays."""

from __future__ import annotations

import numpy as np

from opendwm_tpu_torch.config import register


@register("SyntheticCTSDDataset")
class SyntheticCTSDDataset:
    """Latent-space CTSD items: latents + pre-encoded text + layout."""

    def __init__(
        self,
        size: int = 64,
        sequence_length: int = 2,
        view_count: int = 2,
        latent_height: int = 8,
        latent_width: int = 8,
        latent_channels: int = 16,
        text_length: int = 4,
        text_dim: int = 24,
        pooled_dim: int = 16,
        with_layout: bool = True,
        image_scale: int = 8,
        seed: int = 0,
    ):
        self.size = size
        self.t, self.v = sequence_length, view_count
        self.h, self.w, self.c = latent_height, latent_width, latent_channels
        self.text_length, self.text_dim = text_length, text_dim
        self.pooled_dim = pooled_dim
        self.with_layout = with_layout
        self.image_scale = image_scale
        self.seed = seed

    def __len__(self):
        return self.size

    def __getitem__(self, index):
        if isinstance(index, str):
            index = int(index.split("-")[0])
        rng = np.random.default_rng(self.seed + index)
        item = {
            "latents": rng.standard_normal(
                (self.t, self.v, self.h, self.w, self.c), np.float32
            ),
            "encoder_hidden_states": rng.standard_normal(
                (self.t, self.v, self.text_length, self.text_dim), np.float32
            ),
            "pooled_projections": rng.standard_normal(
                (self.t, self.v, self.pooled_dim), np.float32
            ),
        }
        if self.with_layout:
            item["3dbox_images"] = rng.uniform(
                0, 1,
                (self.t, self.v, self.h * self.image_scale,
                 self.w * self.image_scale, 3),
            ).astype(np.float32)
        return item


@register("SyntheticLidarDataset")
class SyntheticLidarDataset:
    """Padded point clouds (uniform in ±``pc_range`` on every axis, all
    valid) with a BEV layout raster per frame."""

    def __init__(self, size: int = 64, sequence_length: int = 2,
                 point_count: int = 256, pc_range: float = 6.0,
                 bev_size: int = 128, seed: int = 0):
        self.size = size
        self.t = sequence_length
        self.n = point_count
        self.range = pc_range
        self.bev_size = bev_size
        self.seed = seed

    def __len__(self):
        return self.size

    def __getitem__(self, index):
        if isinstance(index, str):
            index = int(index.split("-")[0])
        rng = np.random.default_rng(self.seed + index)
        return {
            "lidar_points": rng.uniform(
                -self.range, self.range, (self.t, self.n, 3)
            ).astype(np.float32),
            "lidar_points_mask": np.ones((self.t, self.n), bool),
            "3dbox_bev_images": rng.uniform(
                0, 1, (self.t, self.bev_size, self.bev_size, 3)
            ).astype(np.float32),
        }


@register("SyntheticStreamingAdapter")
class SyntheticStreamingAdapter:
    """A live source for the streaming CLI
    (``opendwm_tpu/datasets/synthetic.py:SyntheticStreamingAdapter``):
    each ``query_data()`` tick emits one frame's canonical batch with
    pre-encoded conditions, drawn from ``default_rng(seed + tick)``."""

    def __init__(
        self,
        view_count: int = 2,
        text_length: int = 4,
        text_dim: int = 24,
        pooled_dim: int = 16,
        seed: int = 0,
    ):
        self.v = view_count
        self.text_length, self.text_dim = text_length, text_dim
        self.pooled_dim = pooled_dim
        self.tick = 0
        self.seed = seed
        self.sensor_channels = [f"CAM_{i}" for i in range(view_count)]

    def query_data(self) -> dict:
        rng = np.random.default_rng(self.seed + self.tick)
        self.tick += 1
        return {
            "fps": np.float32(10.0),
            "pts": np.zeros((1, 1, self.v), np.float32),
            "encoder_hidden_states": rng.standard_normal(
                (1, 1, self.v, self.text_length, self.text_dim)
            ).astype(np.float32),
            "pooled_projections": rng.standard_normal(
                (1, 1, self.v, self.pooled_dim)
            ).astype(np.float32),
        }
