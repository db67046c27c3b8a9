"""SD image VAE (``opendwm_tpu/models/autoencoders.py``): the encoder,
which turns pixel-space training batches into latents, and the decoder.

Public tensors are channel-last like the JAX package's (latents
``(..., h, w, c)``, images ``(..., H, W, 3)``); the modules permute to
NCHW inside for PyTorch's convolutions. Parameter names are the diffusers
``AutoencoderKL`` state-dict names, so a released checkpoint loads with
``load_state_dict``.

int8 W8A8 serving (``quantization="int8"``): the encoder's and decoder's
resnet convs, ``conv_in``/``conv_out`` and samplers run as ``QConv2d``
and the mid-block attention's ``to_q/k/v/out`` as ``QLinear``;
``quant_conv``/``post_quant_conv`` stay float, as in the JAX model. An
int8 model hands its input to ``conv_in`` in the dtype it arrives in
(fp32 latents from a rollout): ``QConv2d`` quantizes what it is given,
as flax's ``QConv`` does, where a float conv casts it first.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from opendwm_tpu_torch.config import register
from opendwm_tpu_torch.models.layers import conv_factory, dense_factory


def _group_norm(ch: int) -> nn.GroupNorm:
    return nn.GroupNorm(min(32, ch), ch, eps=1e-6)


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: Optional[int] = None,
                 quantized: bool = False):
        super().__init__()
        out_channels = out_channels or in_channels
        conv = conv_factory(quantized)
        self.norm1 = _group_norm(in_channels)
        self.conv1 = conv(in_channels, out_channels, 3, padding=1)
        self.norm2 = _group_norm(out_channels)
        self.conv2 = conv(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (
            conv(in_channels, out_channels, 1)
            if in_channels != out_channels else None
        )

    def forward(self, x):  # NCHW
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head attention over spatial positions (VAE mid block); fp32
    logits and softmax, probabilities in the value dtype, as the JAX
    package's einsum form."""

    def __init__(self, channels: int, quantized: bool = False):
        super().__init__()
        lin = dense_factory(quantized)
        self.group_norm = _group_norm(channels)
        self.to_q = lin(channels, channels)
        self.to_k = lin(channels, channels)
        self.to_v = lin(channels, channels)
        self.to_out = nn.ModuleList([lin(channels, channels)])

    def forward(self, x):  # NCHW
        b, c, h, w = x.shape
        y = self.group_norm(x).reshape(b, c, h * w).transpose(1, 2)
        q, k, v = self.to_q(y), self.to_k(y), self.to_v(y)
        logits = torch.einsum("bqc,bkc->bqk", q.float(), k.float())
        probs = torch.softmax(logits * c**-0.5, dim=-1).to(v.dtype)
        y = self.to_out[0](torch.einsum("bqk,bkc->bqc", probs, v))
        return x + y.transpose(1, 2).reshape(b, c, h, w)


class _Upsample(nn.Module):
    def __init__(self, channels: int, quantized: bool = False):
        super().__init__()
        self.conv = conv_factory(quantized)(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class _Downsample(nn.Module):
    """diffusers' ``Downsample2D``: pad (0, 1, 0, 1), then a stride-2 conv
    without padding."""

    def __init__(self, channels: int, quantized: bool = False):
        super().__init__()
        self.conv = conv_factory(quantized)(channels, channels, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class _MidBlock(nn.Module):
    def __init__(self, channels: int, quantized: bool = False):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock(channels, quantized=quantized) for _ in range(2)])
        self.attentions = nn.ModuleList([AttnBlock(channels, quantized)])

    def forward(self, h):
        return self.resnets[1](self.attentions[0](self.resnets[0](h)))


class _UpBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, layers: int,
                 upsample: bool, quantized: bool = False):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock(in_channels if j == 0 else out_channels, out_channels,
                        quantized)
            for j in range(layers)
        ])
        self.upsamplers = (
            nn.ModuleList([_Upsample(out_channels, quantized)])
            if upsample else None
        )

    def forward(self, h):
        for r in self.resnets:
            h = r(h)
        if self.upsamplers is not None:
            h = self.upsamplers[0](h)
        return h


class _DownBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, layers: int,
                 downsample: bool, quantized: bool = False):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock(in_channels if j == 0 else out_channels, out_channels,
                        quantized)
            for j in range(layers)
        ])
        self.downsamplers = (
            nn.ModuleList([_Downsample(out_channels, quantized)])
            if downsample else None
        )

    def forward(self, h):
        for r in self.resnets:
            h = r(h)
        if self.downsamplers is not None:
            h = self.downsamplers[0](h)
        return h


class Encoder(nn.Module):
    """``conv_in`` → down blocks (``layers_per_block`` resnets, then a
    stride-2 conv but in the last) → mid block → norm, silu, ``conv_out``
    to the posterior's mean and log-variance (``2 * latent_channels``)."""

    def __init__(self,
                 block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 2, latent_channels: int = 4,
                 in_channels: int = 3, quantized: bool = False):
        super().__init__()
        chans = list(block_out_channels)
        conv = conv_factory(quantized)
        self.conv_in = conv(in_channels, chans[0], 3, padding=1)
        self.down_blocks = nn.ModuleList([
            _DownBlock(chans[i - 1] if i else chans[0], ch, layers_per_block,
                       downsample=i < len(chans) - 1, quantized=quantized)
            for i, ch in enumerate(chans)
        ])
        self.mid_block = _MidBlock(chans[-1], quantized)
        self.conv_norm_out = _group_norm(chans[-1])
        self.conv_out = conv(chans[-1], 2 * latent_channels, 3, padding=1)

    def forward(self, x):  # NCHW
        h = self.conv_in(x)
        for blk in self.down_blocks:
            h = blk(h)
        h = self.mid_block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 3, latent_channels: int = 4,
                 out_channels: int = 3, quantized: bool = False):
        super().__init__()
        chans = list(reversed(block_out_channels))
        conv = conv_factory(quantized)
        self.conv_in = conv(latent_channels, chans[0], 3, padding=1)
        self.mid_block = _MidBlock(chans[0], quantized)
        self.up_blocks = nn.ModuleList([
            _UpBlock(chans[i - 1] if i else chans[0], ch, layers_per_block,
                     upsample=i < len(chans) - 1, quantized=quantized)
            for i, ch in enumerate(chans)
        ])
        self.conv_norm_out = _group_norm(chans[-1])
        self.conv_out = conv(chans[-1], out_channels, 3, padding=1)

    def forward(self, z):  # NCHW
        h = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            h = blk(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


@register("AutoencoderKL", aliases=("diffusers.AutoencoderKL",))
class AutoencoderKL(nn.Module):
    """KL image VAE. ``encode`` gives the posterior's (mean, logvar);
    ``encode_to_scaled`` the pipelines' latents ``(z - shift) * scale``, z
    the mean or a posterior sample; ``decode_from_scaled`` undoes the
    scaling: ``decode(latents / scale + shift)``."""

    def __init__(
        self,
        block_out_channels: Sequence[int] = (128, 256, 512, 512),
        latent_channels: int = 4,
        use_quant_conv: bool = True,
        scaling_factor: float = 0.18215,
        shift_factor: float = 0.0,
        sample_size: int = 256,
        dtype: torch.dtype = torch.float32,
        quantization: Optional[str] = None,
    ):
        super().__init__()
        if quantization not in (None, "int8"):
            raise ValueError(f"unknown quantization {quantization!r}")
        self.quantized = quantization == "int8"
        self.block_out_channels = tuple(block_out_channels)
        self.scaling_factor = scaling_factor
        self.shift_factor = shift_factor
        self.use_quant_conv = use_quant_conv
        self.downscale_factor = 2 ** (len(block_out_channels) - 1)
        self.latent_channels = latent_channels
        self.encoder = Encoder(block_out_channels,
                               latent_channels=latent_channels,
                               quantized=self.quantized)
        self.decoder = Decoder(block_out_channels,
                               latent_channels=latent_channels,
                               quantized=self.quantized)
        if use_quant_conv:
            self.quant_conv = nn.Conv2d(2 * latent_channels,
                                        2 * latent_channels, 1)
            self.post_quant_conv = nn.Conv2d(latent_channels,
                                             latent_channels, 1)
        self.to(dtype)

    @property
    def dtype(self) -> torch.dtype:
        return self.decoder.conv_norm_out.weight.dtype

    def _conv_input(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` for ``conv_in``: cast to ``dtype`` for a float conv, as
        it arrives for an int8 one."""
        return x if self.quantized else x.to(self.dtype)

    def latent_shape(self, image_shape: Sequence[int]) -> tuple:
        """The latents' shape for images of ``image_shape`` (..., H, W, 3)."""
        *lead, h, w, _ = image_shape
        f = self.downscale_factor
        return (*lead, h // f, w // f, self.latent_channels)

    def encode(self, x: torch.Tensor):
        """``x``: ``(..., H, W, 3)`` images in [-1, 1] → the posterior's
        ``(mean, logvar)``, each ``(..., h, w, c)``; logvar clipped to
        [-30, 20]."""
        lead = x.shape[:-3]
        x = self._conv_input(x.reshape(-1, *x.shape[-3:]).permute(0, 3, 1, 2))
        moments = self.encoder(x)
        if self.use_quant_conv:
            moments = self.quant_conv(moments)
        mean, logvar = moments.permute(0, 2, 3, 1).chunk(2, dim=-1)
        logvar = logvar.clamp(-30.0, 20.0)
        shape = (*lead, *mean.shape[1:])
        return mean.reshape(shape), logvar.reshape(shape)

    @staticmethod
    def sample_posterior(mean, logvar, generator=None, noise=None):
        """``mean + exp(logvar / 2) * noise``; ``noise`` (standard normal,
        ``mean``'s shape) is drawn from ``generator`` unless given."""
        if noise is None:
            noise = torch.randn(mean.shape, generator=generator,
                                device=mean.device)
        return mean + torch.exp(0.5 * logvar) * noise.to(mean.dtype)

    def encode_to_scaled(self, images: torch.Tensor, generator=None,
                         noise=None) -> torch.Tensor:
        """Images → the pipelines' latents ``(z - shift) * scale``: z is a
        posterior sample when ``generator`` or ``noise`` is given, else the
        mean."""
        mean, logvar = self.encode(images)
        z = mean
        if generator is not None or noise is not None:
            z = self.sample_posterior(mean, logvar, generator, noise)
        return (z - self.shift_factor) * self.scaling_factor

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """``z``: ``(..., h, w, c)`` latents → ``(..., H, W, 3)`` images."""
        lead = z.shape[:-3]
        z = z.reshape(-1, *z.shape[-3:]).permute(0, 3, 1, 2)
        if self.use_quant_conv:
            z = self.post_quant_conv(z.to(self.dtype))
        z = self._conv_input(z)
        out = self.decoder(z).permute(0, 2, 3, 1)
        return out.reshape(*lead, *out.shape[1:])

    def decode_from_scaled(self, latents: torch.Tensor,
                           chunk_size: Optional[int] = None) -> torch.Tensor:
        """Decode pipeline latents ``(..., h, w, c)``; with ``chunk_size``,
        at most that many frames at a time (bounds peak memory)."""
        z = latents / self.scaling_factor + self.shift_factor
        if chunk_size is None:
            return self.decode(z)
        lead = z.shape[:-3]
        flat = z.reshape(-1, *z.shape[-3:])
        out = torch.cat([self.decode(c) for c in flat.split(chunk_size)])
        return out.reshape(*lead, *out.shape[1:])


def sd21_vae(dtype: torch.dtype = torch.float32) -> AutoencoderKL:
    return AutoencoderKL(latent_channels=4, use_quant_conv=True,
                         scaling_factor=0.18215, dtype=dtype)


def sd35_vae(dtype: torch.dtype = torch.float32,
             quantization: Optional[str] = None) -> AutoencoderKL:
    return AutoencoderKL(latent_channels=16, use_quant_conv=False,
                         scaling_factor=1.5305, shift_factor=0.0609,
                         dtype=dtype, quantization=quantization)
