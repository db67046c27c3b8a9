"""SD image VAE, decode side (``opendwm_tpu/models/autoencoders.py``).

Public tensors are channel-last like the JAX package's (latents
``(..., h, w, c)``, images ``(..., H, W, 3)``); the modules permute to
NCHW inside for PyTorch's convolutions. Parameter names are the diffusers
``AutoencoderKL`` state-dict names, so a released checkpoint loads with
``load_state_dict``; its encoder keys are skipped, because the encoder is
not ported yet (ROADMAP Queue 1, item 4).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from opendwm_tpu_torch.config import register


def _group_norm(ch: int) -> nn.GroupNorm:
    return nn.GroupNorm(min(32, ch), ch, eps=1e-6)


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: Optional[int] = None):
        super().__init__()
        out_channels = out_channels or in_channels
        self.norm1 = _group_norm(in_channels)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = _group_norm(out_channels)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (
            nn.Conv2d(in_channels, out_channels, 1)
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

    def __init__(self, channels: int):
        super().__init__()
        self.group_norm = _group_norm(channels)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x):  # NCHW
        b, c, h, w = x.shape
        y = self.group_norm(x).reshape(b, c, h * w).transpose(1, 2)
        q, k, v = self.to_q(y), self.to_k(y), self.to_v(y)
        logits = torch.einsum("bqc,bkc->bqk", q.float(), k.float())
        probs = torch.softmax(logits * c**-0.5, dim=-1).to(v.dtype)
        y = self.to_out[0](torch.einsum("bqk,bkc->bqc", probs, v))
        return x + y.transpose(1, 2).reshape(b, c, h, w)


class _Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class _MidBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock(channels), ResnetBlock(channels)])
        self.attentions = nn.ModuleList([AttnBlock(channels)])

    def forward(self, h):
        return self.resnets[1](self.attentions[0](self.resnets[0](h)))


class _UpBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, layers: int,
                 upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock(in_channels if j == 0 else out_channels, out_channels)
            for j in range(layers)
        ])
        self.upsamplers = (
            nn.ModuleList([_Upsample(out_channels)]) if upsample else None
        )

    def forward(self, h):
        for r in self.resnets:
            h = r(h)
        if self.upsamplers is not None:
            h = self.upsamplers[0](h)
        return h


class Decoder(nn.Module):
    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 3, latent_channels: int = 4,
                 out_channels: int = 3):
        super().__init__()
        chans = list(reversed(block_out_channels))
        self.conv_in = nn.Conv2d(latent_channels, chans[0], 3, padding=1)
        self.mid_block = _MidBlock(chans[0])
        self.up_blocks = nn.ModuleList([
            _UpBlock(chans[i - 1] if i else chans[0], ch, layers_per_block,
                     upsample=i < len(chans) - 1)
            for i, ch in enumerate(chans)
        ])
        self.conv_norm_out = _group_norm(chans[-1])
        self.conv_out = nn.Conv2d(chans[-1], out_channels, 3, padding=1)

    def forward(self, z):  # NCHW
        h = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            h = blk(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


@register("AutoencoderKL", aliases=("diffusers.AutoencoderKL",))
class AutoencoderKL(nn.Module):
    """KL image VAE (decode side). ``decode_from_scaled`` undoes the
    pipelines' latent scaling: ``decode(latents / scale + shift)``."""

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
        if quantization is not None:
            raise NotImplementedError(
                "int8 VAE serving is not ported yet (ROADMAP Queue 1, item 6)"
            )
        self.scaling_factor = scaling_factor
        self.shift_factor = shift_factor
        self.use_quant_conv = use_quant_conv
        self.decoder = Decoder(block_out_channels,
                               latent_channels=latent_channels)
        if use_quant_conv:
            self.post_quant_conv = nn.Conv2d(latent_channels,
                                             latent_channels, 1)
        self.to(dtype)

    @property
    def dtype(self) -> torch.dtype:
        return self.decoder.conv_in.weight.dtype

    def load_state_dict(self, state_dict, strict: bool = True, assign=False):
        """Load a diffusers AutoencoderKL state dict; the encoder's entries
        (``encoder.*``, ``quant_conv.*``) are skipped."""
        state_dict = {
            k: v for k, v in state_dict.items()
            if not k.startswith(("encoder.", "quant_conv."))
        }
        return super().load_state_dict(state_dict, strict=strict,
                                       assign=assign)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """``z``: ``(..., h, w, c)`` latents → ``(..., H, W, 3)`` images."""
        lead = z.shape[:-3]
        z = z.reshape(-1, *z.shape[-3:]).permute(0, 3, 1, 2).to(self.dtype)
        if self.use_quant_conv:
            z = self.post_quant_conv(z)
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
