"""LiDAR KL-VAE over BEV occupancy (``opendwm_tpu/models/vae_point_cloud.py``),
in PyTorch.

The VQ tokenizer's Swin encoder and decoder with a Gaussian latent in place
of the codebook: the encoder emits (mean, logvar) over the token grid
(``codebook_dim`` = 2 · ``latent_dim``), the decoder takes latents of
``latent_dim`` and has the density render grid. The LiDAR UNet's
diffusion path encodes to the mean and decodes without quantization; the
``LidarVAE`` trainer samples the posterior on a given noise and adds the
KL and the DVGO render losses (``RenderedTokenizer``).
"""

from __future__ import annotations

from typing import Optional

import torch

from opendwm_tpu_torch.config import register
from opendwm_tpu_torch.models.vq_point_cloud import (
    RenderedTokenizer,
    VQDecoder,
    VQEncoder,
)
from opendwm_tpu_torch.ops.voxelize import Voxelizer


@register(
    "VAEPointCloud",
    aliases=(
        "dwm.models.vae_point_cloud.VAEPointCloud",
        "dwm.models.lidar_vae_model.VAEPointCloud",
    ),
)
class VAEPointCloud(RenderedTokenizer):
    def __init__(self, voxelizer: Voxelizer, lidar_encoder: VQEncoder,
                 lidar_decoder: VQDecoder, latent_dim: int = 64,
                 bias_init: float = -5.0, ray_stepsize: float = 0.05,
                 ray_max_steps: int = 512):
        super().__init__()
        self.lidar_encoder = lidar_encoder
        self.lidar_decoder = lidar_decoder
        self.latent_dim = latent_dim
        self._init_rendering(voxelizer, lidar_decoder.density_feats,
                             bias_init, ray_stepsize, ray_max_steps)

    def encode_lidar(self, points: torch.Tensor, points_mask: torch.Tensor):
        """points (b, t, N, 3+), mask (b, t, N) → (voxels (b, t, D, H, W),
        mean, logvar (b·t, L, latent)), the logvar clipped to [−30, 20]."""
        voxels = self.voxelizer(points, points_mask)
        feats = self.lidar_encoder(voxels.reshape(-1, *voxels.shape[2:]))
        mean, logvar = feats.chunk(2, -1)
        return voxels, mean, torch.clamp(logvar, -30.0, 20.0)

    @staticmethod
    def sample(mean: torch.Tensor, logvar: torch.Tensor,
               noise: torch.Tensor) -> torch.Tensor:
        """The posterior sample ``mean + exp(logvar / 2) · noise``."""
        return mean + torch.exp(0.5 * logvar) * noise.to(mean.dtype)

    @staticmethod
    def kl(mean: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
        return 0.5 * torch.mean(torch.sum(
            mean ** 2 + torch.exp(logvar) - 1.0 - logvar, -1))

    def decode_lidar(self, latents: torch.Tensor, density: bool = False):
        """latents (n, L, latent) → (density grid or None, voxel logits)."""
        return self.lidar_decoder(latents, density=density)

    def forward(self, points: torch.Tensor, points_mask: torch.Tensor,
                noise: Optional[torch.Tensor] = None,
                render_rays: bool = True) -> dict:
        """Encode, decode the posterior sample on ``noise`` (the mean when
        it is None), the KL term; with ``render_rays`` the DVGO depth and
        SDF losses."""
        voxels, mean, logvar = self.encode_lidar(points, points_mask)
        z = mean if noise is None else self.sample(mean, logvar, noise)
        density, logits = self.lidar_decoder(z, density=render_rays)
        b, t = voxels.shape[:2]
        result = {"voxels": voxels,
                  "lidar_voxel": logits.reshape(b, t, *logits.shape[1:]),
                  "kl_loss": self.kl(mean, logvar), "mean": mean,
                  "logvar": logvar}
        if render_rays:
            result["depth_loss"], result["sdf_loss"], _ = \
                self.render_frames(density, points, points_mask)
        return result
