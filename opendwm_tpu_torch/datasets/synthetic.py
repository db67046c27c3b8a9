"""Synthetic latent-space CTSD batches for smoke tests, benchmarks and CLI
drives (``opendwm_tpu/datasets/synthetic.py:SyntheticCTSDDataset``): the
same items from the same seeds, as numpy arrays."""

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
