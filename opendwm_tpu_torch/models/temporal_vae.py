"""Causal temporal (3-D) video VAE, CogVideoX-style
(``opendwm_tpu/models/temporal_vae.py``).

Channel-last video ``(b, 1 + 4k, H, W, 3)`` ↔ latents ``(b, 1 + k, H/8,
W/8, latent_channels)``: causal 3-D convolutions (the time axis
front-padded with the first frame, so frame t never sees a later one),
GroupNorm with statistics per frame, ResNet-3D blocks, 8x spatial and 4x
temporal compression (two stride-2 temporal subsamplings that keep frame
0), no attention. Module names are the flax tree's, so
``convert.temporal_vae_state_dict_from_flax`` is a walk. Convolutions are
``torch.nn.functional.conv3d`` (the JAX package's run in XLA, not in a
Pallas kernel). No pipeline calls this VAE, as in the JAX package; the
scaling contract matches ``AutoencoderKL``'s (``encode_to_scaled`` /
``decode_from_scaled``, views folded through the batch).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from opendwm_tpu_torch.config import register
from opendwm_tpu_torch.models.layers import (
    Conv3d,
    GroupNorm,
    set_compute_dtype,
)


class CausalConv3d(nn.Module):
    """3-D convolution of channel-last ``(b, t, h, w, c)`` video, causal
    in time: ``kt - 1`` copies of the first frame in front, the spatial
    axes padded by half the kernel on each side."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel: Sequence[int] = (3, 3, 3),
                 stride: Sequence[int] = (1, 1, 1)):
        super().__init__()
        kt, kh, kw = kernel
        self.pad_t = kt - 1
        self.conv = Conv3d(in_channels, out_channels, tuple(kernel),
                           stride=tuple(stride),
                           padding=(0, kh // 2, kw // 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pad_t:
            x = torch.cat([x[:, :1].expand(-1, self.pad_t, -1, -1, -1), x], 1)
        return self.conv(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)


class FrameGroupNorm(GroupNorm):
    """GroupNorm of ``min(32, c)`` groups, eps 1e-6, statistics per frame
    of ``(b, t, h, w, c)`` video (normalising over time would leak later
    frames into earlier ones)."""

    def __init__(self, channels: int, groups: int = 32):
        super().__init__(min(groups, channels), channels, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t = x.shape[:2]
        return super().forward(x.reshape(b * t, *x.shape[2:])).reshape(
            x.shape)


class ResBlock3D(nn.Module):
    def __init__(self, in_channels: int, out_channels: Optional[int] = None):
        super().__init__()
        out = out_channels or in_channels
        self.norm1 = FrameGroupNorm(in_channels)
        self.conv1 = CausalConv3d(in_channels, out)
        self.norm2 = FrameGroupNorm(out)
        self.conv2 = CausalConv3d(out, out)
        if in_channels != out:
            self.conv_shortcut = Conv3d(in_channels, out, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x.permute(0, 4, 1, 2, 3)).permute(
                0, 2, 3, 4, 1)
        return x + h


def causal_temporal_downsample(x: torch.Tensor) -> torch.Tensor:
    """Every other frame from frame 0: 1 + 2k → 1 + k frames."""
    return x[:, ::2]


def causal_temporal_upsample(x: torch.Tensor) -> torch.Tensor:
    """The inverse: 1 + k → 1 + 2k frames, each frame after the first
    twice."""
    return torch.cat([x[:, :1], x[:, 1:].repeat_interleave(2, dim=1)], 1)


@register("TemporalAutoencoderKL",
          aliases=("diffusers.AutoencoderKLCogVideoX",))
class TemporalAutoencoderKL(nn.Module):
    """Video VAE; see the module docstring. ``dtype`` is the compute
    dtype, ``param_dtype`` that of the parameters (default ``dtype``)."""

    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 256,
                                                            512),
                 latent_channels: int = 16, layers_per_block: int = 3,
                 temporal_downsample_stages: Sequence[int] = (1, 2),
                 scaling_factor: float = 1.15258426,
                 shift_factor: float = 0.0,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        chans = list(block_out_channels)
        self.n_stages = len(chans)
        self.layers_per_block = layers_per_block
        self.temporal_downsample_stages = tuple(temporal_downsample_stages)
        self.latent_channels = latent_channels
        self.scaling_factor = scaling_factor
        self.shift_factor = shift_factor

        self.encoder_conv_in = CausalConv3d(3, chans[0])
        ch = chans[0]
        for i, out in enumerate(chans):
            for j in range(layers_per_block):
                self.add_module(f"encoder_down_{i}_res_{j}",
                                ResBlock3D(ch, out))
                ch = out
            if i < self.n_stages - 1:
                self.add_module(f"encoder_down_{i}_downsample",
                                CausalConv3d(ch, ch, stride=(1, 2, 2)))
        self.encoder_mid_res_0 = ResBlock3D(ch)
        self.encoder_mid_res_1 = ResBlock3D(ch)
        self.encoder_norm_out = FrameGroupNorm(ch)
        self.encoder_conv_out = CausalConv3d(ch, 2 * latent_channels)

        rchans = chans[::-1]
        self.decoder_conv_in = CausalConv3d(latent_channels, rchans[0])
        ch = rchans[0]
        self.decoder_mid_res_0 = ResBlock3D(ch)
        self.decoder_mid_res_1 = ResBlock3D(ch)
        for i, out in enumerate(rchans):
            for j in range(layers_per_block):
                self.add_module(f"decoder_up_{i}_res_{j}",
                                ResBlock3D(ch, out))
                ch = out
            if i < self.n_stages - 1:
                self.add_module(f"decoder_up_{i}_upsample",
                                CausalConv3d(ch, ch))
        self.decoder_norm_out = FrameGroupNorm(ch)
        self.decoder_conv_out = CausalConv3d(ch, 3)
        self.to(param_dtype or dtype)
        self.dtype = dtype
        set_compute_dtype(self, dtype)

    @property
    def spatial_downscale(self) -> int:
        return 2 ** (self.n_stages - 1)

    @property
    def temporal_downscale(self) -> int:
        return 2 ** len(self.temporal_downsample_stages)

    def encode(self, video: torch.Tensor):
        """video (b, 1 + 4k, H, W, 3) → (mean, logvar), each (b, 1 + k,
        H/8, W/8, latent_channels); logvar clipped to [-30, 20]."""
        x = self.encoder_conv_in(video.to(self.dtype))
        for i in range(self.n_stages):
            for j in range(self.layers_per_block):
                x = getattr(self, f"encoder_down_{i}_res_{j}")(x)
            if i < self.n_stages - 1:
                x = getattr(self, f"encoder_down_{i}_downsample")(x)
                if i in self.temporal_downsample_stages:
                    x = causal_temporal_downsample(x)
        x = self.encoder_mid_res_1(self.encoder_mid_res_0(x))
        moments = self.encoder_conv_out(F.silu(self.encoder_norm_out(x)))
        mean, logvar = moments.chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """latents (b, 1 + k, h, w, c) → video (b, 1 + 4k, 8h, 8w, 3); each
        up stage repeats frames (at the stages mirroring the temporal
        downsamples), then doubles h and w by nearest neighbour per frame."""
        x = self.decoder_conv_in(latents.to(self.dtype))
        x = self.decoder_mid_res_1(self.decoder_mid_res_0(x))
        t_up = {self.n_stages - 2 - s for s in self.temporal_downsample_stages}
        for i in range(self.n_stages):
            for j in range(self.layers_per_block):
                x = getattr(self, f"decoder_up_{i}_res_{j}")(x)
            if i < self.n_stages - 1:
                if i in t_up:
                    x = causal_temporal_upsample(x)
                x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
                x = getattr(self, f"decoder_up_{i}_upsample")(x)
        return self.decoder_conv_out(F.silu(self.decoder_norm_out(x)))

    @staticmethod
    def sample_posterior(mean: torch.Tensor, logvar: torch.Tensor,
                         noise: torch.Tensor) -> torch.Tensor:
        return mean + torch.exp(0.5 * logvar) * noise.to(mean.dtype)

    @staticmethod
    def _views_to_batch(x: torch.Tensor) -> torch.Tensor:
        """(b, t, v, ...) → (b·v, t, ...)."""
        b, t, v = x.shape[:3]
        return x.transpose(1, 2).reshape(b * v, t, *x.shape[3:])

    @staticmethod
    def _batch_to_views(x: torch.Tensor, b: int) -> torch.Tensor:
        """(b·v, t, ...) → (b, t, v, ...)."""
        return x.reshape(b, -1, *x.shape[1:]).transpose(1, 2)

    def encode_to_scaled(self, videos: torch.Tensor,
                         noise: Optional[torch.Tensor] = None,
                         chunk_size: Optional[int] = None) -> torch.Tensor:
        """Multi-view videos (b, t, v, H, W, 3) → scaled latents (b, 1 + k,
        v, h, w, c), the views folded through the batch; a posterior
        sample on ``noise`` (the latents' shape), else the mean. With
        ``chunk_size``, at most that many videos at a time."""
        flat = self._views_to_batch(videos)
        if noise is not None:
            noise = self._views_to_batch(noise)
        size = chunk_size or flat.shape[0]
        zs = []
        for i in range(0, flat.shape[0], size):
            mean, logvar = self.encode(flat[i:i + size])
            zs.append(mean if noise is None else
                      self.sample_posterior(mean, logvar, noise[i:i + size]))
        z = torch.cat(zs)
        return self._batch_to_views(
            (z - self.shift_factor) * self.scaling_factor, videos.shape[0])

    def decode_from_scaled(self, latents: torch.Tensor,
                           chunk_size: Optional[int] = None) -> torch.Tensor:
        """Scaled latents (b, 1 + k, v, h, w, c) → videos (b, 1 + 4k, v,
        8h, 8w, 3); with ``chunk_size``, at most that many videos at a
        time."""
        b = latents.shape[0]
        flat = self._views_to_batch(latents) / self.scaling_factor + \
            self.shift_factor
        out = torch.cat([self.decode(c)
                         for c in flat.split(chunk_size or flat.shape[0])])
        return self._batch_to_views(out, b)
