"""Joint image + LiDAR BEV world VAE (``opendwm_tpu/models/bev_world_vae.py``),
in PyTorch.

Camera features are lifted into the BEV plane by deformable attention at
projected pillar sample points, fused with the LiDAR pillar features into
a Gaussian BEV latent, and decoded jointly: LiDAR voxel logits and the
DVGO render grid on one branch, per-view images on the other (the BEV
latents splatted into each camera's feature plane). Every pillar is
processed, with the frustum mask folded into the attention weights, and
each pillar takes ``num_sample_per_pillar`` fixed z-levels, as in the JAX
module.

The lift is a weighted sum of image-feature rows: each of the (sample,
view, offset) points of a pillar's head reads four bilinear corners, so
``F.embedding_bag`` with the products of the attention weights and the
corner weights as ``per_sample_weights`` computes the JAX module's
``sum(sampled * weights)`` without holding the sampled features (at the
LiDAR tokenizer's 6400 pillars, 4 heads, 4 samples, 6 views, 2 offsets and
1024 channels those are 1.26e9 values a batch element). The corners are
``bilinear_sample``'s: x clipped to [0, w − 1.001], y to [0, h − 1.001],
then ``floor`` and its right and lower neighbours (``F.grid_sample``'s
border and ``align_corners`` rules give other values). The decode's splat
is an ``index_add`` of features and counts into a flat ``(v, fh · fw)``
canvas, divided by ``max(counts, 1)``.

Module names are the flax ones (``img_encoder.conv_0``, ``lift.
sampling_offsets``), so ``convert.bev_world_vae_state_dict_from_flax``
maps a flax tree with the LiDAR walk and the image VAE's bridge.
``dtype`` is the compute dtype; the parameters stay fp32, as flax keeps
them; the LiDAR encoder and decoder compute in their own ``dtype``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from opendwm_tpu_torch.config import register
from opendwm_tpu_torch.models.depth_net import conv_nhwc
from opendwm_tpu_torch.models.layers import (
    Conv2d,
    GroupNorm,
    Linear,
    resize_nearest,
    set_compute_dtype,
)
from opendwm_tpu_torch.models.vq_point_cloud import VQDecoder, VQEncoder
from opendwm_tpu_torch.ops.voxelize import Voxelizer


class SmallImageEncoder(nn.Module):
    """Conv backbone: (n, H, W, 3) → (n, H/8, W/8, out_channels): three
    stride-2 3x3 convs, each with a GroupNorm (min(8, ch) groups, flax's
    eps 1e-6) and SiLU."""

    def __init__(self, out_channels: int = 64):
        super().__init__()
        prev = 3
        for i, ch in enumerate((out_channels // 2,) * 2 + (out_channels,)):
            self.add_module(f"conv_{i}", Conv2d(prev, ch, 3, stride=2,
                                                padding=1))
            self.add_module(f"norm_{i}", GroupNorm(min(8, ch), ch, eps=1e-6))
            prev = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(3):
            x = conv_nhwc(getattr(self, f"conv_{i}"), x)
            x = F.silu(getattr(self, f"norm_{i}")(x))
        return x


class ImageDecoder(nn.Module):
    """(n, H/8, W/8, C) → (n, H, W, 3): three times nearest x2, a 3x3 conv
    (64, 32, 16 channels), GroupNorm and SiLU; then a 3x3 conv to RGB."""

    def __init__(self, in_channels: int = 64):
        super().__init__()
        prev = in_channels
        for i, ch in enumerate((64, 32, 16)):
            self.add_module(f"conv_{i}", Conv2d(prev, ch, 3, padding=1))
            self.add_module(f"norm_{i}", GroupNorm(min(8, ch), ch, eps=1e-6))
            prev = ch
        self.conv_out = Conv2d(prev, 3, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(3):
            x = resize_nearest(x, (2 * x.shape[1], 2 * x.shape[2]))
            x = conv_nhwc(getattr(self, f"conv_{i}"), x)
            x = F.silu(getattr(self, f"norm_{i}")(x))
        return conv_nhwc(self.conv_out, x)


def bilinear_corners(uv: torch.Tensor, h: int, w: int) -> tuple:
    """Pixel coords ``uv`` (..., 2) on an (h, w) grid → (row-major flat
    indices (..., 4), weights (..., 4)) of the four corners that
    ``bilinear_sample`` reads: (y0, x0), (y0, x0 + 1), (y0 + 1, x0),
    (y0 + 1, x0 + 1)."""
    x = uv[..., 0].clamp(0.0, w - 1.001)
    y = uv[..., 1].clamp(0.0, h - 1.001)
    x0, y0 = torch.floor(x), torch.floor(y)
    tx, ty = x - x0, y - y0
    x0, y0 = x0.long(), y0.long()
    base = y0 * w + x0
    idx = torch.stack([base, base + 1, base + w, base + w + 1], -1)
    coef = torch.stack([(1 - tx) * (1 - ty), tx * (1 - ty), (1 - tx) * ty,
                        tx * ty], -1)
    return idx, coef


def bilinear_sample(feat: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """feat (H, W, C); uv (..., 2) in pixel coords → (..., C)."""
    h, w, c = feat.shape
    idx, coef = bilinear_corners(uv, h, w)
    rows = feat.reshape(h * w, c)[idx.reshape(-1)].reshape(*idx.shape, c)
    return (rows * coef[..., None].to(feat.dtype)).sum(-2)


class DeformableLift(nn.Module):
    """Deformable-attention lift: BEV pillar queries sample multi-view image
    features at projected points plus learned offsets (``sampling_offsets``,
    zero at init), combined by learned attention weights (softmax per head
    over the (sample, view, offset) points, −1e9 outside the frustum)."""

    def __init__(self, channels: int, num_samples: int, num_views: int,
                 num_heads: int = 4, num_offsets: int = 2):
        super().__init__()
        self.num_heads, self.num_offsets = num_heads, num_offsets
        n_pts = num_samples * num_views * num_offsets
        self.sampling_offsets = Linear(channels, num_heads * n_pts * 2)
        self.attention_weights = Linear(channels, num_heads * n_pts)
        self.output_proj = Linear(num_heads * channels, channels)
        with torch.no_grad():
            self.sampling_offsets.weight.zero_()
            self.sampling_offsets.bias.zero_()

    def forward(self, queries: torch.Tensor, img_feats: torch.Tensor,
                uv: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """queries (b, L, C) pillar features; img_feats (b, v, Hf, Wf, C);
        uv (b, L, S, v, 2) projected sample pixels; valid (b, L, S, v) →
        (b, L, C)."""
        b, l, s, v, _ = uv.shape
        nh, no = self.num_heads, self.num_offsets
        fh, fw, c = img_feats.shape[2:]
        offsets = self.sampling_offsets(queries).reshape(b, l, nh, s, v, no,
                                                         2)
        logits = self.attention_weights(queries).reshape(b, l, nh, s, v, no)
        logits = torch.where(valid[:, :, None, :, :, None], logits,
                             torch.full_like(logits, -1e9))
        weights = F.softmax(logits.reshape(b, l, nh, -1), -1).reshape(
            b, l, nh, s, v, no)
        pts = uv[:, :, None, :, :, None, :] + offsets  # b, l, h, s, v, o, 2
        idx, coef = bilinear_corners(pts.float(), fh, fw)
        view = torch.arange(v, device=uv.device)[:, None, None]
        first = (torch.arange(b, device=uv.device)[:, None, None, None, None,
                                                    None, None] * v
                 + view) * (fh * fw)
        # in fp32, as the JAX module's fp32 corner weights promote the sum
        table = img_feats.reshape(b * v * fh * fw, c).float()
        per_point = coef * weights[..., None].float()
        fused = F.embedding_bag(
            (idx + first).reshape(b * l * nh, -1), table,
            per_sample_weights=per_point.reshape(b * l * nh, -1),
            mode="sum")
        return self.output_proj(fused.reshape(b, l, nh * c))


@register(
    "BEVWorldVAE",
    aliases=("dwm.models.bevw_vae_mm_model.VAEBevMultiModality",),
)
class BEVWorldVAE(nn.Module):
    """points, images and cameras → the BEV latent's (mean, logvar), and
    its decode: LiDAR density and voxel logits, per-view images.
    ``pretrained_img_vae`` (keys of ``AutoencoderKL``, its ``dtype``
    included; its ``checkpoint_path`` is the pipeline's): the image branch
    is that SD VAE (the encoder's moments as features), seeded by
    ``load_pretrained_img_vae_params``. ``num_views`` sizes the lift's
    attention weights (flax infers it at the first call)."""

    def __init__(self, voxelizer: Voxelizer, lidar_encoder: VQEncoder,
                 lidar_decoder: VQDecoder, latent_dim: int = 32,
                 img_feature_dim: int = 64, num_sample_per_pillar: int = 4,
                 image_size=(128, 128), num_views: int = 6,
                 pretrained_img_vae: Optional[dict] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.voxelizer = voxelizer
        self.lidar_encoder = lidar_encoder
        self.lidar_decoder = lidar_decoder
        self.latent_dim = latent_dim
        self.num_sample_per_pillar = num_sample_per_pillar
        self.image_size = tuple(image_size)
        self.pretrained_img_vae = pretrained_img_vae
        width = lidar_encoder.pre_quant.out_features
        if pretrained_img_vae is not None:
            from opendwm_tpu_torch.models.autoencoders import AutoencoderKL

            cfg = dict(pretrained_img_vae)
            cfg.pop("checkpoint_path", None)  # the pipeline's
            self.img_vae = AutoencoderKL(**cfg)
            feat_dim = 2 * self.img_vae.latent_channels
            self.img_decoder_proj = Linear(latent_dim,
                                           self.img_vae.latent_channels)
            self._img_downscale = self.img_vae.downscale_factor
        else:
            self.img_encoder = SmallImageEncoder(img_feature_dim)
            self.img_decoder = ImageDecoder(img_feature_dim)
            feat_dim = img_feature_dim
            self.img_decoder_proj = Linear(latent_dim, img_feature_dim)
            self._img_downscale = 8
        self.lift = DeformableLift(width, num_sample_per_pillar, num_views)
        self.img_feat_proj = Linear(feat_dim, width)
        self.moments_proj = Linear(width, 2 * latent_dim)
        self.dtype = dtype
        for name, module in self.named_children():
            if name not in ("lidar_encoder", "lidar_decoder", "img_vae"):
                set_compute_dtype(module, dtype)

    def _encode_images(self, flat_images: torch.Tensor) -> torch.Tensor:
        if self.pretrained_img_vae is not None:
            mean, logvar = self.img_vae.encode(flat_images)
            return torch.cat([mean, logvar], -1)
        return self.img_encoder(flat_images)

    def _decode_images(self, planes: torch.Tensor) -> torch.Tensor:
        if self.pretrained_img_vae is not None:
            return self.img_vae.decode(planes)
        return self.img_decoder(planes)

    # -- geometry -----------------------------------------------------------

    def pillar_sample_points(self, device) -> torch.Tensor:
        """Lidar-frame xyz of the fixed z-level samples of each BEV token's
        pillar: (L, S, 3), L the token grid row-major, S
        ``num_sample_per_pillar`` (made in float64 with numpy and cast, as
        the JAX module)."""
        vox = self.voxelizer
        patch = self.lidar_encoder.patch_size
        gh, gw = vox.height // patch, vox.width // patch
        xs = vox.x_min + (np.arange(gw) + 0.5) * vox.step * patch
        ys = vox.y_min + (np.arange(gh) + 0.5) * vox.step * patch
        zs = np.linspace(vox.z_min, vox.z_max,
                         self.num_sample_per_pillar + 2)[1:-1]
        grid = np.stack(np.meshgrid(ys, xs, zs, indexing="ij"), -1)
        pts = np.stack([grid[..., 1], grid[..., 0], grid[..., 2]], -1)
        return torch.from_numpy(pts.reshape(gh * gw, len(zs), 3).astype(
            np.float32)).to(device)

    def project(self, camera_transforms: torch.Tensor,
                camera_intrinsics: torch.Tensor,
                ego_transforms: torch.Tensor, feat_hw: tuple,
                image_hw: tuple) -> tuple:
        """The pillar samples → (feature-pixel coords (b, L, S, v, 2), in
        the frustum (b, L, S, v)): ``ego_transforms`` (b, 1 + v, 4, 4) are
        the LiDAR's then each camera's."""
        pts = self.pillar_sample_points(camera_transforms.device)
        ego = ego_transforms.float()
        cam_world = ego[:, 1:] @ camera_transforms.float()
        cam_from_lidar = torch.linalg.solve(
            cam_world, ego[:, :1].expand_as(cam_world))
        pts_h = torch.cat([pts, torch.ones_like(pts[..., :1])], -1)
        cam_pts = torch.einsum("bvij,lsj->blsvi", cam_from_lidar,
                               pts_h)[..., :3]
        z = cam_pts[..., 2]
        uvw = torch.einsum("bvij,blsvj->blsvi", camera_intrinsics.float(),
                           cam_pts)
        uv = uvw[..., :2] / uvw[..., 2:3].clamp(min=1e-6)
        (ih, iw), (fh, fw) = image_hw, feat_hw
        valid = ((z > 0.1) & (uv[..., 0] >= 0) & (uv[..., 0] < iw)
                 & (uv[..., 1] >= 0) & (uv[..., 1] < ih))
        scale = torch.tensor([fw / iw, fh / ih], device=uv.device)
        return uv * scale, valid

    # -- encode / decode ----------------------------------------------------

    def encode(self, voxels: torch.Tensor, images: torch.Tensor,
               camera_transforms, camera_intrinsics, ego_transforms):
        """voxels (b, D, H, W); images (b, v, H, W, 3) → (mean, logvar)
        over the BEV tokens (b, L, latent_dim), logvar clipped to [−30,
        20]."""
        lidar_feats = self.lidar_encoder(voxels)
        b, v = images.shape[:2]
        img_feats = self._encode_images(images.reshape(-1,
                                                       *images.shape[2:]))
        fh, fw = img_feats.shape[1:3]
        img_feats = self.img_feat_proj(img_feats).reshape(b, v, fh, fw, -1)
        uv, valid = self.project(camera_transforms, camera_intrinsics,
                                 ego_transforms, (fh, fw),
                                 tuple(images.shape[2:4]))
        lifted = self.lift(lidar_feats, img_feats, uv, valid)
        fused = lidar_feats.to(lifted.dtype) + lifted
        mean, logvar = self.moments_proj(fused).chunk(2, -1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, latents: torch.Tensor, camera_transforms,
               camera_intrinsics, ego_transforms) -> tuple:
        """latents (b, L, latent_dim) → (density (b, F, Zc, H, W), voxel
        logits (b, D, H, W), images (b, v, H, W, 3))."""
        density, voxel_logits = self.lidar_decoder(latents, density=True)
        b, v = latents.shape[0], camera_transforms.shape[1]
        ih, iw = self.image_size
        fh, fw = ih // self._img_downscale, iw // self._img_downscale
        uv, valid = self.project(camera_transforms, camera_intrinsics,
                                 ego_transforms, (fh, fw), (ih, iw))
        px = uv[..., 0].to(torch.int32).clamp(0, fw - 1)
        py = uv[..., 1].to(torch.int32).clamp(0, fh - 1)
        view = torch.arange(v, device=uv.device)
        first = (torch.arange(b, device=uv.device)[:, None, None, None] * v
                 + view) * (fh * fw)
        flat_idx = (first + py * fw + px).reshape(-1)  # (b, L, S, v)
        feats = self.img_decoder_proj(latents)  # (b, L, C)
        w = valid.to(feats.dtype)[..., None]
        src = (feats[:, :, None, None, :] * w).float()
        n, c = b * v * fh * fw, feats.shape[-1]
        # fp32 canvas and counts, as the JAX module's
        canvas = src.new_zeros(n, c).index_add(0, flat_idx,
                                               src.reshape(-1, c))
        counts = src.new_zeros(n, 1).index_add(0, flat_idx,
                                               w.float().reshape(-1, 1))
        planes = (canvas / counts.clamp(min=1.0)).reshape(b * v, fh, fw, -1)
        images = self._decode_images(planes).reshape(b, v, ih, iw, 3)
        return density, voxel_logits, images

    @staticmethod
    def sample(mean: torch.Tensor, logvar: torch.Tensor, generator=None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``mean + exp(logvar / 2) · noise``, the noise standard normal from
        ``generator`` unless given."""
        if noise is None:
            noise = torch.randn(mean.shape, generator=generator,
                                device=mean.device)
        return mean + torch.exp(0.5 * logvar) * noise.to(mean.dtype)

    def forward(self, points, points_mask, images, camera_transforms,
                camera_intrinsics, ego_transforms, generator=None,
                noise: Optional[torch.Tensor] = None) -> dict:
        """points (b, 1, N, 3+) and mask (b, 1, N), images (b, v, H, W, 3),
        cameras (b, v, ...), ``ego_transforms`` (b, 1 + v, 4, 4): the
        latent is a posterior sample with ``generator`` or ``noise``, else
        the mean."""
        voxels = self.voxelizer(points, points_mask)
        if voxels.ndim == 5:  # (b, t, D, H, W): one frame
            voxels = voxels[:, 0]
        mean, logvar = self.encode(voxels, images, camera_transforms,
                                   camera_intrinsics, ego_transforms)
        z = mean if generator is None and noise is None else \
            self.sample(mean, logvar, generator, noise)
        density, voxel_logits, recon = self.decode(
            z, camera_transforms, camera_intrinsics, ego_transforms)
        # in the moments' dtype, as the JAX module
        kl = 0.5 * (mean ** 2 + logvar.exp() - 1.0 - logvar).sum(-1).mean()
        return {"voxels": voxels, "voxel_logits": voxel_logits,
                "density": density, "recon_images": recon, "kl_loss": kl,
                "mean": mean, "logvar": logvar}


def load_pretrained_img_vae_params(model: BEVWorldVAE,
                                   vae_state_dict) -> BEVWorldVAE:
    """Graft an ``AutoencoderKL`` state dict (diffusers names, e.g. from
    ``convert_cli --kind vae``) into the image branch of a ``BEVWorldVAE``
    built with ``pretrained_img_vae``; ``KeyError`` names a key the branch
    needs and the dict lacks, as the JAX ``load_pretrained_img_vae_params``
    (``bev_world_vae.py:347-364``). Returns the model."""
    own = model.img_vae.state_dict()
    for key in own:
        if key not in vae_state_dict:
            raise KeyError(f"pretrained VAE params missing {key!r}")
    model.img_vae.load_state_dict(
        {k: torch.as_tensor(np.asarray(vae_state_dict[k])) for k in own})
    return model
