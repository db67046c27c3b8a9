"""LiDAR KL-VAE trainer (``opendwm_tpu/pipelines/lidar_vae.py``), in
PyTorch.

The loss is the stabilised voxel BCE, the weighted KL term and the DVGO
depth and free-space (SDF) terms of the posterior sample; AdamW with the
config's clipping. The JAX package's guards stay: a non-finite loss
becomes 0, and so does every non-finite gradient entry. The posterior's
noise is explicit (``draw_noise``, from a ``torch.Generator``, or given).
"""

from __future__ import annotations

from typing import Optional

import torch

from opendwm_tpu_torch.config import register
from opendwm_tpu_torch.pipelines.ctsd import (
    TrainState,
    build_train_state,
)
from opendwm_tpu_torch.parallel.train_state import MeshPlacement
from opendwm_tpu_torch.pipelines.lidar_vqvae import (
    stable_bce_with_logits,
    step_optimizer,
)


@register("LidarVAE", aliases=("dwm.pipelines.lidar_vae.LidarVAE",))
class LidarVAE(MeshPlacement):
    """The LiDAR VAE's trainer; ``mesh`` and ``sharding_policy`` (default
    ``"ddp"``, as JAX's) place its train state over a process group."""

    def __init__(self, vae_point_cloud=None, lidar_vae=None,
                 common_config: Optional[dict] = None,
                 training_config: Optional[dict] = None,
                 optimizer_config: Optional[dict] = None,
                 lr_scheduler_config: Optional[dict] = None, mesh=None,
                 sharding_policy: Optional[str] = None,
                 sharding_min_size: Optional[int] = None):
        self.model = vae_point_cloud if vae_point_cloud is not None \
            else lidar_vae
        if self.model is None:
            raise ValueError("LidarVAE needs vae_point_cloud (or lidar_vae)")
        self.common_config = common_config or {}
        self.training_config = training_config or {}
        self.optimizer_config = optimizer_config
        self.lr_scheduler_config = lr_scheduler_config
        self._set_mesh(mesh, sharding_policy or "ddp", sharding_min_size)

    def init_state(self) -> TrainState:
        return self.shard_state(build_train_state(
            self.model, self.training_config, self.optimizer_config,
            self.lr_scheduler_config))

    def draw_noise(self, batch: dict, generator=None) -> torch.Tensor:
        """The posterior's standard normal noise (b·t, L, latent), this data
        rank's rows of the global batch's (``rank_draws``)."""
        points = batch["lidar_points"]
        b, t = points.shape[:2]
        enc = self.model.lidar_encoder
        tokens = (enc.img_size // enc.patch_size) ** 2
        return self.rank_draws(lambda rows: torch.randn(
            rows * t, tokens, self.model.latent_dim, generator=generator,
            device=points.device), b)

    def loss_from_draws(self, batch: dict, noise: torch.Tensor):
        """(loss, metrics) with the posterior sampled on ``noise``."""
        tc = self.training_config
        out = self.model(batch["lidar_points"], batch["lidar_points_mask"],
                         noise=noise)
        voxel_loss = stable_bce_with_logits(
            out["lidar_voxel"].float(), out["voxels"].float()) \
            * tc.get("voxel_loss_coef", 1.0)
        kl_loss = out["kl_loss"] * tc.get("kl_loss_coef", 1e-6)
        depth_loss = out["depth_loss"] * tc.get("depth_loss_coef", 1.0)
        sdf_loss = out["sdf_loss"] * tc.get("sdf_loss_coef", 1.0)
        loss = voxel_loss + kl_loss + depth_loss + sdf_loss
        loss = torch.where(torch.isfinite(loss), loss,
                           torch.zeros_like(loss))
        return loss, {"loss": loss, "voxel_loss": voxel_loss,
                      "kl_loss": kl_loss, "depth_loss": depth_loss,
                      "sdf_loss": sdf_loss}

    def loss_fn(self, batch: dict, generator=None):
        return self.loss_from_draws(batch, self.draw_noise(batch, generator))

    def train_step(self, state: TrainState, batch: dict, generator=None,
                   noise: Optional[torch.Tensor] = None):
        """One step: loss, gradients (non-finite entries zeroed), clip and
        AdamW. ``noise`` replaces the generator's draw. Updates ``state``
        in place and returns ``(state, metrics)``."""
        if noise is None:
            noise = self.draw_noise(batch, generator)
        loss, metrics = self.loss_from_draws(batch, noise)
        step_optimizer(state, loss, self.training_config, finite_only=True)
        state.step += 1
        return state, self.reduce_metrics(
            {k: v.detach() for k, v in metrics.items()})
