"""Layout-condition image adapter (``opendwm_tpu/models/adapters.py``), in
PyTorch.

T2I-Adapter style: the rasterised 3-D box and HD-map images are
pixel-unshuffled and run through one ``AdapterBlock`` per denoiser stage;
each stage's feature map, optionally through a zero-initialised 1x1 conv
and a tanh zero gate, is a residual that the DiT or the UNet adds to its
hidden states. Public tensors are channel-last like the JAX package's
(``(..., H, W, C)`` in, one ``(..., H_i, W_i, channels[i])`` feature per
stage out); the convolutions run NCHW inside. Parameter names are the
reference's (``condition_image_adapter.body.{i}.in_conv``,
``.resnets.{j}.block1|block2``, ``zero_convs.{i}``, ``zero_gates``), so
a released checkpoint loads with ``load_state_dict``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from opendwm_tpu_torch.config import register
from opendwm_tpu_torch.models.layers import (
    Conv2d,
    checkpointed,
    set_compute_dtype,
)


def pixel_unshuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Channel-last pixel unshuffle ``(n, h, w, c)`` → ``(n, h/r, w/r,
    c·r·r)``, output channel ``c·r·r + i·r + j`` (torch's NCHW order, as
    the JAX package's ``pixel_unshuffle``)."""
    y = F.pixel_unshuffle(x.permute(0, 3, 1, 2), factor)
    return y.permute(0, 2, 3, 1)


class AdapterResnetBlock(nn.Module):
    """``block2(relu(block1(x))) + x``: a 3x3 and a 1x1 conv (NCHW)."""

    def __init__(self, channels: int):
        super().__init__()
        self.block1 = Conv2d(channels, channels, 3, padding=1)
        self.block2 = Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block2(F.relu(self.block1(x))) + x


class AdapterBlock(nn.Module):
    """2x2 average pool when ``down``, a 1x1 ``in_conv`` when the channel
    count changes, then ``num_res_blocks`` resnets (NCHW)."""

    def __init__(self, in_channels: int, out_channels: int,
                 num_res_blocks: int, down: bool = False):
        super().__init__()
        self.down = down
        self.in_conv = Conv2d(in_channels, out_channels, 1) \
            if in_channels != out_channels else None
        self.resnets = nn.ModuleList(
            [AdapterResnetBlock(out_channels) for _ in range(num_res_blocks)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.down:
            x = F.avg_pool2d(x, 2)
        if self.in_conv is not None:
            x = self.in_conv(x)
        for resnet in self.resnets:
            x = resnet(x)
        return x


@register("ImageAdapter", aliases=("dwm.models.adapters.ImageAdapter",))
class ImageAdapter(nn.Module):
    """One residual feature per stage of the denoiser from the layout
    rasters, in ``dtype``; inside a denoiser, its parameters and compute
    dtypes follow the denoiser's."""

    def __init__(
        self,
        in_channels: int = 3,
        channels: Sequence[int] = (320, 320, 640, 1280, 1280),
        is_downblocks: Sequence[bool] = (False, True, True, True, False),
        num_res_blocks: int = 2,
        downscale_factor: int = 8,
        use_zero_convs: bool = False,
        zero_gate_coef: Optional[float] = None,
        gradient_checkpointing: bool = False,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.downscale_factor = downscale_factor
        self.zero_gate_coef = zero_gate_coef
        self.gradient_checkpointing = gradient_checkpointing
        prev = in_channels * downscale_factor ** 2
        body = []
        for ch, down in zip(channels, is_downblocks):
            body.append(AdapterBlock(prev, ch, num_res_blocks, down))
            prev = ch
        self.body = nn.ModuleList(body)
        self.channels = tuple(channels[:len(body)])  # each stage's width
        self.zero_convs = None
        if use_zero_convs:
            self.zero_convs = nn.ModuleList(
                [Conv2d(ch, ch, 1) for ch in channels])
            for conv in self.zero_convs:
                nn.init.zeros_(conv.weight)
                nn.init.zeros_(conv.bias)
        self.zero_gates = nn.Parameter(torch.zeros(len(channels))) \
            if zero_gate_coef else None
        self.to(dtype)
        set_compute_dtype(self, dtype)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        """``x``: ``(..., H, W, C)`` rasters with any leading axes → one
        ``(..., H_i, W_i, channels[i])`` feature per stage."""
        lead = x.shape[:-3]
        x = pixel_unshuffle(x.reshape(-1, *x.shape[-3:]),
                            self.downscale_factor).permute(0, 3, 1, 2)
        features = []
        for i, block in enumerate(self.body):
            x = checkpointed(block, x) if self.gradient_checkpointing \
                else block(x)
            out = x
            if self.zero_convs is not None:
                out = self.zero_convs[i](out)
            if self.zero_gates is not None:
                gate = torch.tanh(self.zero_gate_coef
                                  * self.zero_gates[i].float())
                out = out * gate.to(out.dtype)
            out = out.permute(0, 2, 3, 1)
            features.append(out.reshape(*lead, *out.shape[1:]))
        return features
