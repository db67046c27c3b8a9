"""LiDAR latent diffusion pipeline, serving half
(``opendwm_tpu/pipelines/lidar_diffusion.py``), in PyTorch.

The CTSD machinery (``pipelines/ctsd.py``: flow matching with CFG and
reference-latent injection) over a frozen LiDAR tokenizer's BEV latents:
the DiT runs with cross-view off and its temporal branch on, a zero text
context of one token and zero pooled projections unless the batch carries
text embeddings, and the 3-D box and HD-map BEV rasters routed into
``3dbox_images`` (the DiT's ImageAdapter). ``encode_points`` /
``decode_points`` adapt the ``VQPointCloud`` tokenizer (latent scale and
bias, quantize before the decode, Gumbel-sigmoid binarisation).

The ``VAEPointCloud`` tokenizer belongs to the LiDAR UNet (ROADMAP Queue
1, item 9c) and raises; training waits for item 11b.
"""

from __future__ import annotations

from typing import Optional

import torch

from opendwm_tpu_torch.config import register
from opendwm_tpu_torch.models.vq_point_cloud import VQPointCloud
from opendwm_tpu_torch.pipelines.ctsd import CTSDPipeline
from opendwm_tpu_torch.pipelines.lidar_maskgit import (
    get_maskgit_conditions,
    gumbel_sigmoid,
)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue 1, {item})")


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

    def _vq(self) -> VQPointCloud:
        if not isinstance(self.autoencoder, VQPointCloud):
            raise _not_ported(
                f"a {type(self.autoencoder).__name__} autoencoder (the LiDAR "
                "UNet's VAEPointCloud)", "item 9c")
        return self.autoencoder

    # -- latent adapters (reference :446-476) ------------------------------

    @torch.inference_mode()
    def encode_points(self, points, points_mask):
        """points → normalised BEV latents (b, t, 1, h, w, c) and the
        voxels (b, t, D, H, W)."""
        voxels, z_q, _, _ = self._vq().encode(points, points_mask)
        n, l, c = z_q.shape
        h = w = int(round(l ** 0.5))
        b, t = voxels.shape[:2]
        lat = z_q.reshape(b, t, 1, h, w, c)
        return (lat - self.latent_bias) * self.latent_scale, voxels

    @torch.inference_mode()
    def decode_points(self, latents, uniforms=None, generator=None):
        """Normalised latents (b, t, 1, h, w, c) → binary voxels (b, t, D,
        H, W): quantized to the nearest codes, decoded, binarised by
        ``gumbel_sigmoid`` with ``uniforms`` (u1, u2) or draws from
        ``generator``."""
        vq = self._vq()
        lat = latents / self.latent_scale + self.latent_bias
        b, t, v, h, w, c = lat.shape
        code, _, _ = vq.vector_quantizer(lat.reshape(b * t, h * w, c))
        _, logits = vq.lidar_decoder(code)
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

    def loss_fn(self, *args, **kwargs):
        raise _not_ported("LiDAR diffusion training", "item 11b")

    def loss_from_draws(self, *args, **kwargs):
        raise _not_ported("LiDAR diffusion training", "item 11b")

    def init_state(self, *args, **kwargs):
        raise _not_ported("LiDAR diffusion training", "item 11b")

    # -- inference ---------------------------------------------------------

    @torch.inference_mode()
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
