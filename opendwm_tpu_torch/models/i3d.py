"""Inflated 3D Inception, the FVD feature network
(``opendwm_tpu/models/i3d.py``): the TATS ``pytorch_i3d`` architecture
whose ``i3d_pretrained_400.pt`` gives the reference's FVD.

NCDHW inside, with the checkpoint's module names
(``Mixed_4b.b1b.conv3d.weight``, ``Conv3d_1a_7x7.bn.running_var``,
``logits.conv3d.bias``), so that ``torch_import.convert_i3d`` of the
released file loads with ``strict=True``. Convolutions and max pools pad
as TensorFlow's "SAME" does: ``pad = max((ceil(n / s) - 1) * s + k - n, 0)``
a side, the smaller half before, the max pools with -inf; ``nn.Conv3d``'s
symmetric padding cannot say that, so the pad is an ``F.pad``. BatchNorm
runs in inference mode, eps 1e-3. The head averages over a window of
(2, 7, 7) clamped to the grid, so that inputs below 224 pixels still pool
to one cell.

Input: channel-last videos ``(n, t, H, W, 3)`` in [-1, 1], as the JAX
model takes them. Output: ``(n, 400)`` logits, averaged over time.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from opendwm_tpu_torch.config import register
from opendwm_tpu_torch.models.inception import FrozenBatchNorm


def same_pads(sizes: Sequence[int], kernel: Sequence[int],
              stride: Sequence[int]) -> list[int]:
    """``F.pad``'s list (last axis first) for TF "SAME" over ``sizes``."""
    pads = []
    for n, k, s in zip(sizes, kernel, stride):
        total = max((math.ceil(n / s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return [p for pair in reversed(pads) for p in pair]


def max_pool_same(x, kernel, stride):
    x = F.pad(x, same_pads(x.shape[2:], kernel, stride), value=-math.inf)
    return F.max_pool3d(x, kernel, stride)


class Unit3D(nn.Module):
    """Conv3d with "SAME" padding → BatchNorm → ReLU."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel: Sequence[int] = (1, 1, 1),
                 stride: Sequence[int] = (1, 1, 1), use_bn: bool = True,
                 activation: bool = True, use_bias: bool = False):
        super().__init__()
        self.kernel, self.stride = tuple(kernel), tuple(stride)
        self.activation = activation
        self.conv3d = nn.Conv3d(in_channels, out_channels, self.kernel,
                                self.stride, bias=use_bias)
        self.bn = FrozenBatchNorm(out_channels) if use_bn else None

    def forward(self, x):
        x = F.pad(x, same_pads(x.shape[2:], self.kernel, self.stride))
        x = self.conv3d(x)
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.activation else x


class InceptionModule(nn.Module):
    """Four branches: 1x1; 1x1 → 3x3x3; 1x1 → 3x3x3; 3x3x3 max → 1x1.
    ``out``: (b0, b1a, b1b, b2a, b2b, b3b) channels."""

    def __init__(self, in_channels: int, out: Sequence[int]):
        super().__init__()
        self.b0 = Unit3D(in_channels, out[0])
        self.b1a = Unit3D(in_channels, out[1])
        self.b1b = Unit3D(out[1], out[2], (3, 3, 3))
        self.b2a = Unit3D(in_channels, out[3])
        self.b2b = Unit3D(out[3], out[4], (3, 3, 3))
        self.b3b = Unit3D(in_channels, out[5])

    def forward(self, x):
        b3 = self.b3b(max_pool_same(x, (3, 3, 3), (1, 1, 1)))
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)),
                          self.b2b(self.b2a(x)), b3], 1)


_INCEPTIONS = {
    "Mixed_3b": (64, 96, 128, 16, 32, 32),
    "Mixed_3c": (128, 128, 192, 32, 96, 64),
    "Mixed_4b": (192, 96, 208, 16, 48, 64),
    "Mixed_4c": (160, 112, 224, 24, 64, 64),
    "Mixed_4d": (128, 128, 256, 24, 64, 64),
    "Mixed_4e": (112, 144, 288, 32, 64, 64),
    "Mixed_4f": (256, 160, 320, 32, 128, 128),
    "Mixed_5b": (256, 160, 320, 32, 128, 128),
    "Mixed_5c": (384, 192, 384, 48, 128, 128),
}


@register("InceptionI3d")
class InceptionI3d(nn.Module):
    """The I3D backbone → (n, num_classes) logits averaged over time."""

    def __init__(self, num_classes: int = 400,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv3d_1a_7x7 = Unit3D(3, 64, (7, 7, 7), (2, 2, 2))
        self.Conv3d_2b_1x1 = Unit3D(64, 64)
        self.Conv3d_2c_3x3 = Unit3D(64, 192, (3, 3, 3))
        cin = 192
        for name, out in _INCEPTIONS.items():
            setattr(self, name, InceptionModule(cin, out))
            cin = out[0] + out[2] + out[4] + out[5]
        self.logits = Unit3D(cin, num_classes, use_bn=False,
                             activation=False, use_bias=True)
        self.to(dtype)

    @property
    def dtype(self) -> torch.dtype:
        return self.Conv3d_1a_7x7.conv3d.weight.dtype

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        x = video.to(self.dtype).permute(0, 4, 1, 2, 3)  # (n, 3, t, h, w)
        x = self.Conv3d_1a_7x7(x)
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))
        x = self.Conv3d_2c_3x3(self.Conv3d_2b_1x1(x))
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))
        x = self.Mixed_3c(self.Mixed_3b(x))
        x = max_pool_same(x, (3, 3, 3), (2, 2, 2))
        for name in ("Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e",
                     "Mixed_4f"):
            x = getattr(self, name)(x)
        x = max_pool_same(x, (2, 2, 2), (2, 2, 2))
        x = self.Mixed_5c(self.Mixed_5b(x))
        window = (min(2, x.shape[2]), min(7, x.shape[3]), min(7, x.shape[4]))
        x = self.logits(F.avg_pool3d(x, window, 1))
        return x[:, :, :, 0, 0].mean(2)  # (n, classes)
