"""BEVDepth-style depth head (``opendwm_tpu/models/depth_net.py``), in
PyTorch.

The CTSD-2.1 UNet's depth branch (HoloDrive's joint image + LiDAR
supervision): multi-scale UNet features, resized and concatenated by the
caller, and the camera parameters go through a reduce conv, a camera-aware
SE excitation (an MLP over the flattened intrinsics and transforms), three
residual blocks, ASPP and a classifier to per-pixel depth-bin logits, which
``pipelines/depth_loss.py`` supervises with projected LiDAR points.

Channel-last in and out as the JAX module; the convolutions see NCHW
views. Module names are the flax ones (``res_0.conv1``, ``aspp.atrous_2``),
so the UNet's weight bridge carries the ``depth_net`` subtree as it
stands. Every norm is the JAX module's ``_bn``: a GroupNorm of the largest
divisor of the channels that is at most 32, with flax's eps 1e-6 (the
reference's BatchNorm has no flax counterpart; ROADMAP oddities). Flax
infers input widths at the first call; here they are arguments:
``in_channels`` (the CTSD-2.1 UNet's five levels concatenated, 320 + 320 +
640 + 1280 + 1280, by default) and ``camera_dim`` (9 intrinsics + 16
transform entries).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from opendwm_tpu_torch.config import register
from opendwm_tpu_torch.models.layers import (
    Conv2d,
    GroupNorm,
    Linear,
    resize_nearest,
    set_compute_dtype,
)


def _bn(channels: int) -> GroupNorm:
    """``depth_net.py:_bn``: the largest divisor of ``channels`` <= 32."""
    groups = next(g for g in range(min(32, channels), 0, -1)
                  if channels % g == 0)
    return GroupNorm(groups, channels, eps=1e-6)


def conv_nhwc(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A convolution over the spatial axes of channel-last ``x``."""
    return conv(x.movedim(-1, 1)).movedim(1, -1)


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling: a 1x1 conv, 3x3 convs at dilations
    6, 12 and 18 (padding = dilation), and the image pool (the mean over
    H, W through a 1x1 conv, broadcast), concatenated, normed, projected."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv1x1 = Conv2d(in_channels, out_channels, 1)
        for i, rate in enumerate((6, 12, 18)):
            self.add_module(f"atrous_{i}", Conv2d(
                in_channels, out_channels, 3, padding=rate, dilation=rate))
        self.pool_conv = Conv2d(in_channels, out_channels, 1)
        self.bn = _bn(5 * out_channels)
        self.project = Conv2d(5 * out_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = [conv_nhwc(self.conv1x1, x)]
        feats += [conv_nhwc(getattr(self, f"atrous_{i}"), x) for i in range(3)]
        pooled = conv_nhwc(self.pool_conv, x.mean(dim=(1, 2), keepdim=True))
        feats.append(pooled.expand(*x.shape[:-1], pooled.shape[-1]))
        y = F.relu(self.bn(torch.cat(feats, -1)))
        return conv_nhwc(self.project, y)


class CameraAware(nn.Module):
    """SE excitation from the camera parameters: x · sigmoid(fc2(relu(
    fc1(camera))))."""

    def __init__(self, camera_dim: int, channels: int):
        super().__init__()
        self.fc1 = Linear(camera_dim, channels)
        self.fc2 = Linear(channels, channels)

    def forward(self, x: torch.Tensor,
                camera_params: torch.Tensor) -> torch.Tensor:
        s = torch.sigmoid(self.fc2(F.relu(self.fc1(camera_params))))
        return x * s[:, None, None, :]


class ResBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = Conv2d(channels, channels, 3, padding=1)
        self.bn1 = _bn(channels)
        self.conv2 = Conv2d(channels, channels, 3, padding=1)
        self.bn2 = _bn(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(conv_nhwc(self.conv1, x)))
        h = self.bn2(conv_nhwc(self.conv2, h))
        return F.relu(x + h)


@register("DepthNet", aliases=("dwm.models.depth_net.DepthNet",))
class DepthNet(nn.Module):
    """features ``(..., H, W, in_channels)`` and camera parameters
    ``(..., camera_dim)`` → depth-bin logits ``(..., H', W',
    depth_channels)``, H' = H · ``upsample_scale`` (nearest, then a conv)
    when it is set. ``dtype`` is the compute dtype; the parameters stay
    fp32, as flax keeps them (inside the UNet, in the UNet's
    ``param_dtype``)."""

    def __init__(self, mid_channels: int = 256, depth_channels: int = 64,
                 upsample_scale: Optional[int] = None,
                 in_channels: int = 3840, camera_dim: int = 25,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        mid = mid_channels
        self.upsample_scale = upsample_scale
        self.reduce_conv = Conv2d(in_channels, mid, 3, padding=1)
        self.reduce_bn = _bn(mid)
        if upsample_scale:
            self.upsample_conv = Conv2d(mid, mid, 3, padding=1)
        self.camera_aware = CameraAware(camera_dim, mid)
        for i in range(3):
            self.add_module(f"res_{i}", ResBlock(mid))
        self.aspp = ASPP(mid, mid)
        self.classifier = Conv2d(mid, depth_channels, 1)
        self.dtype = dtype
        set_compute_dtype(self, dtype)

    def forward(self, features: torch.Tensor,
                camera_params: torch.Tensor) -> torch.Tensor:
        lead = features.shape[:-3]
        x = features.reshape(-1, *features.shape[-3:]).to(self.dtype)
        cam = camera_params.reshape(-1, camera_params.shape[-1]).to(
            self.dtype)
        x = F.relu(self.reduce_bn(conv_nhwc(self.reduce_conv, x)))
        if self.upsample_scale:
            s = self.upsample_scale
            x = resize_nearest(x, (x.shape[1] * s, x.shape[2] * s))
            x = conv_nhwc(self.upsample_conv, x)
        x = self.camera_aware(x, cam)
        for i in range(3):
            x = getattr(self, f"res_{i}")(x)
        x = conv_nhwc(self.classifier, self.aspp(x))
        return x.reshape(*lead, *x.shape[1:])
