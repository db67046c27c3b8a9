"""InceptionV3, the FID variant (``opendwm_tpu/models/inception.py``): the
FID feature network of the ``pt_inception-2015-12-05`` weights.

Standard InceptionV3 but for the FID quirks: the average pools leave the
padding out of their count, and Mixed_7b and Mixed_7c differ in their pool
branch (average, then max). NCHW inside, with the checkpoint's module names
(``Mixed_5b.branch5x5_1.conv.weight``, ``.bn.running_mean``), so that
``torch_import.convert_fid_inception`` of the released file loads with
``strict=True``. BatchNorm runs in inference mode, eps 1e-3.

Input: channel-last images ``(n, H, W, 3)`` in [0, 1], as the JAX model
takes them (scaled to [-1, 1] inside; 299 x 299 for the released
weights). Output: the ``(n, 2048)`` pool3 features.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from opendwm_tpu_torch.config import register


class FrozenBatchNorm(nn.Module):
    """Inference-mode BatchNorm: ``weight``, ``bias`` and the running
    ``running_mean`` / ``running_var`` (buffers); no batch statistics, no
    counter."""

    def __init__(self, channels: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


class BasicConv(nn.Module):
    """Conv (no bias) → BatchNorm → ReLU; ``padding`` as flax takes it: an
    int, or (h, w) for the 1x7 / 7x1 convs."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel: Sequence[int] = (1, 1), stride: Sequence[int] = (1, 1),
                 padding=0):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, tuple(kernel),
                              tuple(stride), padding, bias=False)
        self.bn = FrozenBatchNorm(out_channels)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def avg_pool_nopad(x):
    """3x3 stride-1 average pool, padding left out of the count."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv(cin, 64)
        self.branch5x5_1 = BasicConv(cin, 48)
        self.branch5x5_2 = BasicConv(48, 64, (5, 5), padding=2)
        self.branch3x3dbl_1 = BasicConv(cin, 64)
        self.branch3x3dbl_2 = BasicConv(64, 96, (3, 3), padding=1)
        self.branch3x3dbl_3 = BasicConv(96, 96, (3, 3), padding=1)
        self.branch_pool = BasicConv(cin, pool_features)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(avg_pool_nopad(x))
        return torch.cat([b1, b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv(cin, 384, (3, 3), (2, 2))
        self.branch3x3dbl_1 = BasicConv(cin, 64)
        self.branch3x3dbl_2 = BasicConv(64, 96, (3, 3), padding=1)
        self.branch3x3dbl_3 = BasicConv(96, 96, (3, 3), (2, 2))

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        row, col = (0, 3), (3, 0)  # the 1x7 and 7x1 convs' padding
        self.branch1x1 = BasicConv(cin, 192)
        self.branch7x7_1 = BasicConv(cin, c7)
        self.branch7x7_2 = BasicConv(c7, c7, (1, 7), padding=row)
        self.branch7x7_3 = BasicConv(c7, 192, (7, 1), padding=col)
        self.branch7x7dbl_1 = BasicConv(cin, c7)
        self.branch7x7dbl_2 = BasicConv(c7, c7, (7, 1), padding=col)
        self.branch7x7dbl_3 = BasicConv(c7, c7, (1, 7), padding=row)
        self.branch7x7dbl_4 = BasicConv(c7, c7, (7, 1), padding=col)
        self.branch7x7dbl_5 = BasicConv(c7, 192, (1, 7), padding=row)
        self.branch_pool = BasicConv(cin, 192)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(avg_pool_nopad(x))
        return torch.cat([b1, b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv(cin, 192)
        self.branch3x3_2 = BasicConv(192, 320, (3, 3), (2, 2))
        self.branch7x7x3_1 = BasicConv(cin, 192)
        self.branch7x7x3_2 = BasicConv(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv(192, 192, (3, 3), (2, 2))

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    """``use_max_pool``: the FID net's Mixed_7c, whose pool branch is a
    3x3 stride-1 max pool."""

    def __init__(self, cin: int, use_max_pool: bool = False):
        super().__init__()
        self.use_max_pool = use_max_pool
        self.branch1x1 = BasicConv(cin, 320)
        self.branch3x3_1 = BasicConv(cin, 384)
        self.branch3x3_2a = BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv(cin, 448)
        self.branch3x3dbl_2 = BasicConv(448, 384, (3, 3), padding=1)
        self.branch3x3dbl_3a = BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv(cin, 192)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        bp = F.max_pool2d(x, 3, 1, 1) if self.use_max_pool \
            else avg_pool_nopad(x)
        return torch.cat([b1, b3, bd, self.branch_pool(bp)], 1)


@register("FIDInceptionV3")
class FIDInceptionV3(nn.Module):
    """pool3 (2048) FID features of channel-last images in [0, 1]."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv(3, 32, (3, 3), (2, 2))
        self.Conv2d_2a_3x3 = BasicConv(32, 32, (3, 3))
        self.Conv2d_2b_3x3 = BasicConv(32, 64, (3, 3), padding=1)
        self.Conv2d_3b_1x1 = BasicConv(64, 80)
        self.Conv2d_4a_3x3 = BasicConv(80, 192, (3, 3))
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048, use_max_pool=True)
        self.to(dtype)

    @property
    def dtype(self) -> torch.dtype:
        return self.Conv2d_1a_3x3.conv.weight.dtype

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.to(self.dtype).permute(0, 3, 1, 2) * 2.0 - 1.0
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, 2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                     "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean((2, 3))  # (n, 2048)
