"""LiDAR latent diffusion pipeline (``opendwm_tpu/pipelines/
lidar_diffusion.py``), in PyTorch.

The CTSD machinery (``pipelines/ctsd.py``: flow matching for the DiT,
DDPM training and DDIM sampling for the UNet, CFG and reference-latent
injection) over a frozen LiDAR tokenizer's BEV latents: the denoiser runs
with a zero text context of one token and zero pooled projections unless
the batch carries text embeddings, and the 3-D box and HD-map BEV rasters
routed into ``3dbox_images`` (the DiT's ImageAdapter). ``encode_points``
/ ``decode_points`` adapt the tokenizer: latent scale and bias; the
``VQPointCloud``'s codes (quantized again before the decode) or the
``VAEPointCloud``'s posterior mean (decoded as it is); Gumbel-sigmoid
binarisation. Training encodes the points without gradient and hands
the latents to the CTSD loss (``loss_from_draws``).
"""

from __future__ import annotations

from typing import Optional

import torch

from opendwm_tpu_torch.config import register
from opendwm_tpu_torch.models.vae_point_cloud import VAEPointCloud
from opendwm_tpu_torch.models.vq_point_cloud import VQPointCloud
from opendwm_tpu_torch.pipelines.ctsd import CTSDPipeline, TrainState
from opendwm_tpu_torch.pipelines.lidar_maskgit import (
    get_maskgit_conditions,
    gumbel_sigmoid,
)


@register(
    "LidarDiffusionPipeline",
    aliases=("dwm.pipelines.lidar_diffusion.LidarDiffusionPipeline",),
)
class LidarDiffusionPipeline(CTSDPipeline):
    def __init__(self, model, autoencoder, train_scheduler, test_scheduler,
                 common_config: Optional[dict] = None,
                 training_config: Optional[dict] = None,
                 inference_config: Optional[dict] = None,
                 optimizer_config: Optional[dict] = None,
                 lr_scheduler_config: Optional[dict] = None, mesh=None,
                 model_type: str = "sd3",
                 sharding_policy: Optional[str] = None,
                 sharding_min_size: Optional[int] = None):
        super().__init__(
            model=model, train_scheduler=train_scheduler,
            test_scheduler=test_scheduler, common_config=common_config,
            training_config=training_config,
            inference_config=inference_config,
            optimizer_config=optimizer_config,
            lr_scheduler_config=lr_scheduler_config, mesh=mesh,
            model_type=model_type, sharding_policy=sharding_policy,
            sharding_min_size=sharding_min_size)
        self.autoencoder = autoencoder
        cc = self.common_config
        self.latent_bias = cc.get("latent_bias", 0.0)
        self.latent_scale = cc.get("latent_scale", 1.0)
        self.text_embeddings_dim = cc.get("text_embeddings_dim", 1024)
        self.pooled_dim = cc.get("pooled_text_embeddings_dim", 2048)

    def load_autoencoder_params(self, state_dict: dict) -> None:
        """The tokenizer's weights (a port state dict)."""
        self.autoencoder.load_state_dict(state_dict)

    def _kind(self) -> type:
        for kind in (VQPointCloud, VAEPointCloud):
            if isinstance(self.autoencoder, kind):
                return kind
        raise ValueError(
            f"unknown autoencoder {type(self.autoencoder).__name__}: the "
            "LiDAR diffusion pipeline takes a VQPointCloud or a "
            "VAEPointCloud")

    # -- latent adapters (reference :446-476) ------------------------------

    @torch.no_grad()
    def encode_points(self, points, points_mask):
        """points → normalised BEV latents (b, t, 1, h, w, c) (the codes,
        or the posterior mean) and the voxels (b, t, D, H, W)."""
        if self._kind() is VQPointCloud:
            voxels, z, _, _ = self.autoencoder.encode(points, points_mask)
        else:
            voxels, z, _ = self.autoencoder.encode_lidar(points, points_mask)
        n, l, c = z.shape
        h = w = int(round(l ** 0.5))
        b, t = voxels.shape[:2]
        lat = z.reshape(b, t, 1, h, w, c)
        return (lat - self.latent_bias) * self.latent_scale, voxels

    @torch.no_grad()
    def decode_points(self, latents, uniforms=None, generator=None):
        """Normalised latents (b, t, 1, h, w, c) → binary voxels (b, t, D,
        H, W): quantized to the nearest codes (VQ) or taken as they are
        (VAE), decoded, binarised by ``gumbel_sigmoid`` with ``uniforms``
        (u1, u2) or draws from ``generator``."""
        lat = latents / self.latent_scale + self.latent_bias
        b, t, v, h, w, c = lat.shape
        tokens = lat.reshape(b * t, h * w, c)
        if self._kind() is VQPointCloud:
            tokens, _, _ = self.autoencoder.vector_quantizer(tokens)
        _, logits = self.autoencoder.lidar_decoder(tokens)
        vox = gumbel_sigmoid(logits, uniforms, generator)
        return vox.reshape(b, t, *vox.shape[1:])

    # -- batch adaptation --------------------------------------------------

    def prepare_batch(self, batch: dict) -> dict:
        """Tokenize the points and synthesize the conditions the DiT
        expects: latents, gt voxels, text (zero unless the batch carries
        ``text_description_embeddings``), zero pooled projections, and the
        BEV rasters as ``3dbox_images`` (b, t, 1, H, W, 6)."""
        latents, voxels = self.encode_points(batch["lidar_points"],
                                             batch["lidar_points_mask"])
        b, t = latents.shape[:2]
        dev = latents.device
        out = dict(batch, latents=latents, gt_voxels=voxels)
        if "text_description_embeddings" in batch:
            emb = batch["text_description_embeddings"]
            out["encoder_hidden_states"] = emb[:, :, None] \
                if emb.ndim == 4 else emb
        else:
            out["encoder_hidden_states"] = torch.zeros(
                b, t, 1, 1, self.text_embeddings_dim, device=dev)
        out["pooled_projections"] = torch.zeros(b, t, 1, self.pooled_dim,
                                                device=dev)
        ctx = get_maskgit_conditions(batch)
        if ctx is not None:
            out["3dbox_images"] = ctx.reshape(b, t, 1, *ctx.shape[1:])
            out["hdmap_images"] = None
        return out

    # -- training ----------------------------------------------------------

    def init_state(self) -> TrainState:
        """The denoiser's train state; the tokenizer stays frozen."""
        self.autoencoder.requires_grad_(False)
        return super().init_state()

    def loss_from_draws(self, batch: dict, draws: dict):
        """The CTSD loss (``draw_training_randoms``' draws) on the points'
        latents, the BEV rasters as ``3dbox_images``."""
        return super().loss_from_draws(self.prepare_batch(batch), draws)

    def loss_fn(self, batch: dict, generator=None):
        prepared = self.prepare_batch(batch)
        latents = prepared["latents"]
        return super().loss_from_draws(prepared, self.draw_randoms(
            latents.shape, generator, latents.device))

    # -- inference ---------------------------------------------------------

    # no_grad, not inference_mode: an FSDP-sharded model gathers its
    # parameters in its forward, which inference tensors refuse
    @torch.no_grad()
    def generate(self, batch: dict, generator=None, noise=None,
                 voxel_uniforms=None, image_latents=None,
                 reference_frame_count: int = 0) -> dict:
        """Tokenize, denoise from ``noise`` (or draws from ``generator``)
        with the first ``reference_frame_count`` frames of
        ``image_latents`` injected, decode to binary voxels."""
        prepared = self.prepare_batch(batch)
        latents = self.inference_pipeline(
            prepared, tuple(prepared["latents"].shape), generator=generator,
            noise=noise, image_latents=image_latents,
            reference_frame_count=reference_frame_count)
        return {"latents": latents,
                "pred_voxels": self.decode_points(latents, voxel_uniforms,
                                                  generator),
                "gt_voxels": prepared["gt_voxels"]}
