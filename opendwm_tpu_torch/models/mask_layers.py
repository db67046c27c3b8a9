"""MaskGWM masked reconstruction (``opendwm_tpu/models/mask_layers.py``).

During training a share of the latent tokens is dropped before the DiT's
joint blocks (``MaskController.random_masking``, ``constant`` or
``rand_t`` noise); at the first decoder layer the dropped positions come
back as mask tokens carrying 3-D sincos positions and are refined by a
side interpolator of t2i-modulated STDiT3 blocks, whose output replaces
only the dropped positions (``mask_reconstruction``).

The masking noise is an argument (``draw_mask_noise`` draws it from a
generator), so a test can feed the JAX package's draw. dtypes follow the
JAX module's, whose parameters are always fp32: ``mask_token`` and the
blocks' ``scale_shift_table`` are read in fp32, so the mask tokens, the
modulations and the reconstructed sequence are fp32 under a bf16
``compute`` dtype, as there.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from opendwm_tpu_torch.config import register
from opendwm_tpu_torch.models.layers import (
    FeedForward,
    Linear,
    set_compute_dtype,
    sincos_pos_embed_2d,
)
from opendwm_tpu_torch.ops.attention import dot_product_attention


def sincos_pos_embed_3d(embed_dim: int, t: int, h: int, w: int,
                        spatial_scale: float = 1.0,
                        temporal_scale: float = 1.0) -> np.ndarray:
    """3-D (temporal + spatial) sincos table, ``(t, h * w, embed_dim)``
    fp32 numpy: a quarter of the channels for the frame index, the rest
    the 2-D table of the grid."""
    spatial_dim = embed_dim // 4 * 3
    temporal_dim = embed_dim - spatial_dim
    spatial = sincos_pos_embed_2d(spatial_dim, (h, w), base_size=h,
                                  interpolation_scale=spatial_scale)
    pos_t = np.arange(t, dtype=np.float64) / temporal_scale
    omega = 1.0 / 10000 ** (np.arange(temporal_dim // 2, dtype=np.float64)
                            / (temporal_dim / 2))
    out = np.einsum("t,d->td", pos_t, omega)
    temporal = np.concatenate([np.sin(out), np.cos(out)], axis=1)
    emb = np.concatenate([
        np.broadcast_to(temporal[:, None, :], (t, h * w, temporal_dim)),
        np.broadcast_to(spatial[None], (t, h * w, spatial_dim)),
    ], axis=-1)
    return emb.astype(np.float32)


def _layer_norm(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``LayerNorm`` without scale or bias at ``dtype``: statistics
    in fp32, the result in ``dtype``."""
    return F.layer_norm(x.float(), x.shape[-1:], eps=1e-6).to(dtype)


class STDiT3Block(nn.Module):
    """t2i-modulated self-attention → MLP block, the side interpolator's
    unit. ``temporal``: attention over the T frames of each of the S
    tokens, else over the S tokens of each frame. The JAX block's
    cross-attention runs only on a text context, which the DiT never
    passes, so the port has none."""

    def __init__(self, dim: int, heads: int, head_dim: int,
                 temporal: bool = False):
        super().__init__()
        self.heads, self.head_dim = heads, head_dim
        self.temporal = temporal
        self.scale_shift_table = nn.Parameter(torch.randn(6, dim) / dim**0.5)
        for name in ("attn_q", "attn_k", "attn_v", "attn_out"):
            setattr(self, name, Linear(dim, dim))
        self.mlp = FeedForward(dim, activation="gelu-approximate")

    @property
    def dtype(self) -> torch.dtype:
        return self.attn_q.dtype

    def _heads(self, z: torch.Tensor) -> torch.Tensor:
        return z.reshape(z.shape[0], z.shape[1], self.heads, self.head_dim)

    def forward(self, x: torch.Tensor, t_mlp: torch.Tensor, T: int,
                S: int) -> torch.Tensor:
        """x: (b, T·S, c); t_mlp: (b, 6·c)."""
        b, _, c = x.shape
        mods = self.scale_shift_table.float()[None] + t_mlp.reshape(-1, 6, c)
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = (
            mods[:, i][:, None] for i in range(6))

        xm = _layer_norm(x, self.dtype) * (1 + scale_msa) + shift_msa
        if self.temporal:
            xm = xm.reshape(b, T, S, c).transpose(1, 2).reshape(b * S, T, c)
        else:
            xm = xm.reshape(b * T, S, c)
        attn = dot_product_attention(self._heads(self.attn_q(xm)),
                                     self._heads(self.attn_k(xm)),
                                     self._heads(self.attn_v(xm)))
        attn = self.attn_out(attn.reshape(xm.shape[0], xm.shape[1], c))
        if self.temporal:
            attn = attn.reshape(b, S, T, c).transpose(1, 2)
        x = x + gate_msa * attn.reshape(b, T * S, c)
        xm = _layer_norm(x, self.dtype) * (1 + scale_mlp) + shift_mlp
        return x + gate_mlp * self.mlp(xm)


def draw_mask_noise(n: int, t: int, l: int, mae_mask_type: str = "constant",
                    generator: Optional[torch.Generator] = None,
                    device=None) -> torch.Tensor:
    """The uniform draw behind ``make_mask_ids``: ``(n, 1, l)`` for the
    ``constant`` mask (one mask for every frame), ``(n, t, l)`` for
    ``rand_t``."""
    shape = (n, t, l) if mae_mask_type == "rand_t" else (n, 1, l)
    return torch.rand(shape, generator=generator, device=device)


@register("MaskController", aliases=("dwm.models.mask_layers.MaskController",))
class MaskController(nn.Module):
    """The MaskGWM module the DiT builds from ``mask_module_config``; see
    the module docstring. ``dtype``: the compute dtype."""

    def __init__(self, hidden_size: int = 1536, num_heads: int = 24,
                 attention_head_dim: int = 64, decode_layer: int = 5,
                 interpolater_layer: int = 1, mask_ratio: float = 0.25,
                 mae_mask_type: str = "constant",
                 forward_mix_interpolater: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if mae_mask_type not in ("constant", "rand_t"):
            raise ValueError(f"unknown mae_mask_type {mae_mask_type!r}")
        c = hidden_size
        self.decode_layer = decode_layer
        self.mask_ratio = mask_ratio
        self.mae_mask_type = mae_mask_type
        self.forward_mix_interpolater = forward_mix_interpolater
        self.mask_token = nn.Parameter(0.02 * torch.randn(1, 1, c))
        self.mask_pos_proj = Linear(c, c)
        self.t_block = Linear(c, 6 * c)

        def blocks(temporal: bool):
            return nn.ModuleList([
                STDiT3Block(c, num_heads, attention_head_dim, temporal)
                for _ in range(interpolater_layer)])

        self.sideblocks = blocks(False)
        if forward_mix_interpolater:
            self.temporal_sideblocks = blocks(True)
        set_compute_dtype(self, dtype)

    @property
    def dtype(self) -> torch.dtype:
        return self.t_block.dtype

    def is_first_decoder_layer(self, index_block: int,
                               num_blocks: int) -> bool:
        return index_block == num_blocks - self.decode_layer

    def len_keep(self, l: int) -> int:
        return int(l * (1 - self.mask_ratio))

    def make_mask_ids(self, noise: torch.Tensor, n: int, t: int, l: int):
        """From ``noise`` (``draw_mask_noise``): ids_keep (n·t, len_keep),
        ids_drop (n·t, l - len_keep), ids_restore (n·t, l), and mask (n, t,
        l) with 1 at the dropped positions."""
        keep = self.len_keep(l)
        noise = noise.expand(n, t, l).reshape(n * t, l)
        ids_shuffle = torch.argsort(noise, dim=1, stable=True)
        ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
        ids_keep, ids_drop = ids_shuffle[:, :keep], ids_shuffle[:, keep:]
        mask = torch.ones(n * t, l, device=noise.device).scatter(
            1, ids_keep, 0.0)
        return ids_keep, ids_drop, ids_restore, mask.reshape(n, t, l)

    def random_masking(self, noise: torch.Tensor, x: torch.Tensor, h: int,
                       w: int, condition_residuals: Optional[list] = None):
        """x: (n, t, l, c) tokens → (n, t, len_keep, c), the metas, and the
        token-aligned ``condition_residuals`` dropped the same way."""
        n, t, l, c = x.shape
        ids_keep, ids_drop, ids_restore, mask = self.make_mask_ids(
            noise, n, t, l)

        def keep(z):
            flat = z.reshape(n * t, l, z.shape[-1])
            return flat.gather(1, ids_keep[..., None].expand(
                -1, -1, z.shape[-1])).reshape(n, t, -1, z.shape[-1])

        residuals = None if condition_residuals is None \
            else [keep(r) for r in condition_residuals]
        metas = {"ids_keep": ids_keep, "ids_drop": ids_drop,
                 "ids_restore": ids_restore, "mask": mask, "grid": (h, w)}
        return keep(x), metas, residuals

    def mask_reconstruction(self, x: torch.Tensor, metas: dict,
                            temb: torch.Tensor) -> torch.Tensor:
        """x: (n, t, len_keep, c) processed visible tokens; temb: (n·t, c)
        or (n, c) → (n, t, l, c). The DiT passes no text context
        (``y``), so this takes none."""
        n, t, keep, c = x.shape
        h, w = metas["grid"]
        l = h * w
        dt = self.dtype
        pos = torch.from_numpy(sincos_pos_embed_3d(c, t, h, w)).to(x.device)
        pos = pos[None].expand(n, t, l, c).reshape(n * t, l, c)
        drop = metas["ids_drop"]
        pos_drop = pos.gather(1, drop[..., None].expand(-1, -1, c))
        mask_tokens = self.mask_token.float() + self.mask_pos_proj(
            pos_drop.to(dt))

        flat = x.reshape(n * t, keep, c).to(mask_tokens.dtype)
        combined = torch.cat([flat, mask_tokens], dim=1)
        full = combined.gather(1, metas["ids_restore"][..., None].expand(
            -1, -1, c))
        x_before = full.reshape(n, t, l, c)

        if temb.shape[0] == n:
            temb = temb.repeat_interleave(t, dim=0)
        t_mlp = self.t_block(F.silu(temb.to(dt))).reshape(n, t, -1).mean(1)

        z = x_before.reshape(n, t * l, c)
        for i, block in enumerate(self.sideblocks):
            z = block(z, t_mlp, t, l)
            if self.forward_mix_interpolater:
                zt = self.temporal_sideblocks[i](z, t_mlp, t, l)
                z = 0.5 * z + 0.5 * zt
        m = metas["mask"][..., None]
        return z.reshape(n, t, l, c) * m + x_before * (1 - m)
