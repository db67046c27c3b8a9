"""Cross-view temporal UNet (``opendwm_tpu/models/unet.py``), in PyTorch.

The SD2.1 / SVD skeleton of the reference ``UNetCrossviewTemporalCondition
Model`` (src/dwm/models/crossview_temporal_unet.py:355-835): every resnet
is a spatial ``ResnetBlock2D`` plus a temporal ``(3, 1, 1)`` resnet mixed by
an ``AlphaBlender``, and every transformer runs spatial self- and
cross-attention plus per-layer cross-view and temporal branches, each
``rowwise`` (a latent row attends across views / frames) or full.

Activations are channel-last ``(b, t, v, h, w, c)`` as in the JAX model;
convolutions and group norms see them through ``movedim`` views. Parameter
names are the reference state-dict names (``tests/torch_oracle_unet.py``),
so a released checkpoint loads with ``load_state_dict``; the q/k/v
projections have no bias, as the reference's. ``dtype`` is the compute
dtype and ``param_dtype`` the parameters' (default: ``dtype``).

Attention goes through ``ops.attention.dot_product_attention``: at the
CTSD-2.1 geometry the level-0 spatial self-attention (1792 tokens) takes
the flash kernel (K7), the level-0 branches (336 tokens) and level-1
attention (448 and 168 tokens) the tail-masked kernel (K1); the rest is
plain math, as in the JAX package.

Training as the JAX model trains: parameters may be kept in
``param_dtype`` (fp32 master weights) while every Linear, Conv and norm
computes in ``dtype`` (bf16), as flax's ``param_dtype``/``dtype`` split
does. ``gradient_checkpointing`` rematerialises every resnet (spatial,
temporal and their mixer) and every transformer model of the down, mid
and up blocks in the backward (``torch.utils.checkpoint``), as diffusers'
blocks checkpoint them; remat changes memory, never values.

The layout ImageAdapter (``condition_image_adapter_config``) adds its
first residual after ``conv_in`` and each later one after a down block,
where the sum also replaces that block's last skip state, as in the JAX
model. int8 W8A8 serving (``quantization="int8"``) runs the 2-D convs
(the spatial resnets', ``conv_in``/``conv_out``, the down/upsamplers) as
``QConv2d`` and the transformer models' ``proj_in``/``proj_out`` and
their blocks' attention and GEGLU as ``QLinear``; the ``(3, 1, 1)``
temporal convs, the time projections, embeddings and the adapter stay
float, as in the JAX model.

The depth branch (``depth_net_config``): ``conv_in``'s output and each
down block's, before the adapter's residual, are resized to the sample's
h x w (nearest at half-pixel centres, ``layers.resize_nearest``) and
concatenated; ``DepthNet`` reads them with the camera parameters
(intrinsics ‖ transform, 25 a view). The forward then returns ``(out,
depth_features)``, when it is given both camera tensors, as the JAX model
does (``unet.py:641-713``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from opendwm_tpu_torch.config import register
from opendwm_tpu_torch.models.adapters import ImageAdapter
from opendwm_tpu_torch.models.depth_net import DepthNet
from opendwm_tpu_torch.models.layers import (
    AlphaBlender,
    Attention,
    Conv3d,
    FeedForward,
    GroupNorm,
    LayerNorm,
    Linear,
    TemporalBasicTransformerBlock,
    TimestepEmbedding,
    checkpointed,
    conv_factory,
    dense_factory,
    resize_nearest,
    set_compute_dtype,
    timestep_embedding,
)


def _gn(channels: int, eps: float) -> GroupNorm:
    """``unet.py:_gn``: min(32, channels) groups."""
    return GroupNorm(min(32, channels), channels, eps=eps)


def _conv(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A convolution over the spatial axes of channel-last ``x``."""
    return conv(x.movedim(-1, 1)).movedim(1, -1)


def _call(remat: bool, module: nn.Module, *args):
    """``module(*args)``, rematerialised in the backward if ``remat``."""
    return checkpointed(module, *args) if remat else module(*args)


class SpatialResnetBlock(nn.Module):
    """diffusers ResnetBlock2D (silu, temb added after conv1); input
    ``(n, h, w, c)``, temb ``(n, c_t)``; ``quantized``: int8 convs."""

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: int, eps: float = 1e-5,
                 quantized: bool = False):
        super().__init__()
        conv = conv_factory(quantized)
        self.norm1 = _gn(in_channels, eps)
        self.conv1 = conv(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = Linear(temb_channels, out_channels)
        self.norm2 = _gn(out_channels, eps)
        self.conv2 = conv(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = conv(in_channels, out_channels, 1) \
            if in_channels != out_channels else None

    def forward(self, x, temb):
        h = _conv(self.conv1, F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, None, None, :]
        h = _conv(self.conv2, F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = _conv(self.conv_shortcut, x)
        return x + h


class TemporalResnetBlock(nn.Module):
    """diffusers TemporalResnetBlock: ``(3, 1, 1)`` convolutions over
    ``(t, h, w)``; input ``(n, t, h, w, c)``, temb ``(n, t, c_t)``. Its group
    norms pool over the frames too, as flax's do."""

    def __init__(self, channels: int, temb_channels: int, eps: float = 1e-6):
        super().__init__()
        self.norm1 = _gn(channels, eps)
        self.conv1 = Conv3d(channels, channels, (3, 1, 1), padding=(1, 0, 0))
        self.time_emb_proj = Linear(temb_channels, channels)
        self.norm2 = _gn(channels, eps)
        self.conv2 = Conv3d(channels, channels, (3, 1, 1), padding=(1, 0, 0))

    def forward(self, x, temb):
        h = _conv(self.conv1, F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None, :]
        h = _conv(self.conv2, F.silu(self.norm2(h)))
        return x + h


class CTResBlock(nn.Module):
    """Spatial + temporal resnet mixed by its own ``time_mixer``
    (reference crossview_temporal.py:75-164). Input ``(b, t, v, h, w, c)``,
    temb ``(b, t, v, c_t)``."""

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: int, eps: float = 1e-5,
                 enable_temporal: bool = True, merge_factor: float = 0.5,
                 quantized: bool = False):
        super().__init__()
        self.enable_temporal = enable_temporal
        self.spatial_res_block = SpatialResnetBlock(
            in_channels, out_channels, temb_channels, eps, quantized)
        if enable_temporal:
            self.temporal_res_block = TemporalResnetBlock(
                out_channels, temb_channels, eps)
            self.time_mixer = AlphaBlender(merge_factor)

    def forward(self, x, temb, disable_temporal):
        b, t, v = x.shape[:3]
        h = self.spatial_res_block(x.reshape(-1, *x.shape[3:]),
                                   temb.reshape(-1, temb.shape[-1]))
        h = h.reshape(b, t, v, *h.shape[1:])
        if not self.enable_temporal:
            return h
        ht = h.transpose(1, 2).reshape(b * v, t, *h.shape[3:])
        temb_t = temb.transpose(1, 2).reshape(b * v, t, -1)
        ht = self.temporal_res_block(ht, temb_t)
        ht = ht.reshape(b, v, t, *ht.shape[2:]).transpose(1, 2)
        return self.time_mixer(h, ht, image_only_indicator=disable_temporal)


class BasicTransformerBlock(nn.Module):
    """diffusers BasicTransformerBlock: self-attention, cross-attention to
    the text, GEGLU feed-forward."""

    def __init__(self, dim: int, heads: int, head_dim: int,
                 cross_attention_dim: int, quantized: bool = False):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads, head_dim, qkv_bias=False,
                               quantized=quantized)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, heads, head_dim, qkv_bias=False,
                               context_dim=cross_attention_dim,
                               quantized=quantized)
        self.norm3 = LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim, activation="geglu", quantized=quantized)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context=context)
        return x + self.ff(self.norm3(x))


class TransformerModel(nn.Module):
    """Spatial transformer plus per-layer cross-view and temporal branches
    (reference crossview_temporal.py:269-514); one ``view_mixer`` and one
    ``time_mixer`` shared by the layers. Input ``(b, t, v, h, w, c)``."""

    def __init__(self, channels: int, heads: int, head_dim: int,
                 cross_attention_dim: int, num_layers: int = 1,
                 enable_crossview: bool = True, enable_temporal: bool = True,
                 enable_rowwise_crossview: bool = False,
                 enable_rowwise_temporal: bool = False,
                 merge_factor: float = 0.5, quantized: bool = False):
        super().__init__()
        c = channels
        lin = dense_factory(quantized)
        self.enable_crossview = enable_crossview
        self.enable_temporal = enable_temporal
        self.rowwise_crossview = enable_rowwise_crossview
        self.rowwise_temporal = enable_rowwise_temporal
        self.norm = _gn(c, 1e-6)
        self.proj_in = lin(c, c)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(c, heads, head_dim, cross_attention_dim,
                                  quantized)
            for _ in range(num_layers)])
        if enable_crossview:
            self.crossview_transformer_blocks = nn.ModuleList([
                TemporalBasicTransformerBlock(c, heads, head_dim,
                                              quantized=quantized)
                for _ in range(num_layers)])
            self.view_pos_embed = TimestepEmbedding(c, c * 4, c)
            self.view_mixer = AlphaBlender(merge_factor)
        if enable_temporal:
            self.temporal_transformer_blocks = nn.ModuleList([
                TemporalBasicTransformerBlock(c, heads, head_dim,
                                              quantized=quantized)
                for _ in range(num_layers)])
            self.time_pos_embed = TimestepEmbedding(c, c * 4, c)
            self.time_mixer = AlphaBlender(merge_factor)
        self.proj_out = lin(c, c)

    @staticmethod
    def _position_embedding(embed: nn.Module, index: torch.Tensor,
                            c: int, dtype) -> torch.Tensor:
        return embed(timestep_embedding(index, c).to(dtype))[:, None, :]

    def forward(self, x, context, disable_crossview, disable_temporal,
                crossview_attention_mask=None):
        b, t, v, hh, ww, c = x.shape
        l = hh * ww
        dt = self.proj_in.dtype
        # GroupNorm statistics pool per (b, t, v) image (docs/PARITY.md:131)
        h = self.norm(x.reshape(b * t * v, hh, ww, c))
        h = self.proj_in(h.reshape(b * t * v, l, c))
        ctx = context.reshape(b * t * v, *context.shape[3:])

        dev = x.device
        if self.enable_crossview:
            view_idx = torch.arange(v, dtype=torch.float32, device=dev)
            view_emb = self._position_embedding(
                self.view_pos_embed,
                view_idx[None, None, :].expand(b, t, v).reshape(-1), c, dt)
        if self.enable_temporal:
            seq_idx = torch.arange(t, dtype=torch.float32, device=dev)
            seq_emb = self._position_embedding(
                self.time_pos_embed,
                seq_idx[None, :, None].expand(b, t, v).reshape(-1), c, dt)

        for i, block in enumerate(self.transformer_blocks):
            h = block(h, ctx)
            if self.enable_crossview:
                cv = h + view_emb
                if self.rowwise_crossview:
                    cv = cv.reshape(b * t, v, hh, ww, c).transpose(1, 2)
                    cv = cv.reshape(b * t * hh, v * ww, c)
                else:
                    cv = cv.reshape(b * t, v, l, c).transpose(1, 2)
                    cv = cv.reshape(b * t * l, v, c)
                cv = self.crossview_transformer_blocks[i](
                    cv, mask=crossview_attention_mask)
                if self.rowwise_crossview:
                    cv = cv.reshape(b * t, hh, v, ww, c).transpose(1, 2)
                else:
                    cv = cv.reshape(b * t, l, v, c).transpose(1, 2)
                h = self.view_mixer(
                    h.reshape(b, t * v, l, c), cv.reshape(b, t * v, l, c),
                    image_only_indicator=disable_crossview,
                ).reshape(b * t * v, l, c)

            if self.enable_temporal:
                tp = (h + seq_emb).reshape(b, t, v, hh, ww, c)
                if self.rowwise_temporal:
                    tp = tp.permute(0, 2, 3, 1, 4, 5).reshape(
                        b * v * hh, t * ww, c)
                else:
                    tp = tp.reshape(b, t, v, l, c).permute(0, 2, 3, 1, 4)
                    tp = tp.reshape(b * v * l, t, c)
                tp = self.temporal_transformer_blocks[i](tp)
                if self.rowwise_temporal:
                    tp = tp.reshape(b, v, hh, t, ww, c).permute(
                        0, 3, 1, 2, 4, 5)
                else:
                    tp = tp.reshape(b, v, l, t, c).permute(0, 3, 1, 2, 4)
                h = self.time_mixer(
                    h.reshape(b, t * v, l, c), tp.reshape(b, t * v, l, c),
                    image_only_indicator=disable_temporal,
                ).reshape(b * t * v, l, c)

        h = self.proj_out(h)
        return h.reshape(b, t, v, hh, ww, c) + x


class Downsample(nn.Module):
    """Pad (0, 1, 0, 1), then a VALID stride-2 3x3 convolution."""

    def __init__(self, channels: int, quantized: bool = False):
        super().__init__()
        self.conv = conv_factory(quantized)(channels, channels, 3, stride=2)

    def forward(self, x):  # (n, h, w, c)
        return _conv(self.conv, F.pad(x, (0, 0, 0, 1, 0, 1)))


class Upsample(nn.Module):
    """Nearest x2, then a 3x3 convolution."""

    def __init__(self, channels: int, quantized: bool = False):
        super().__init__()
        self.conv = conv_factory(quantized)(channels, channels, 3, padding=1)

    def forward(self, x):  # (n, h, w, c)
        x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        return _conv(self.conv, x)


def _per_image(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` over the (b*t*v) images of ``(b, t, v, h, w, c)``."""
    out = fn(x.reshape(-1, *x.shape[3:]))
    return out.reshape(*x.shape[:3], *out.shape[1:])


class DownBlock(nn.Module):
    """``DownBlockCT`` (no attention) or ``CrossAttnDownBlockCT``."""

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: int, num_layers: int, add_downsample: bool,
                 transformer: Optional[dict], resnet: dict,
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        self.resnets = nn.ModuleList([
            CTResBlock(in_channels if i == 0 else out_channels, out_channels,
                       temb_channels, **resnet)
            for i in range(num_layers)])
        self.attentions = None if transformer is None else nn.ModuleList([
            TransformerModel(out_channels, **transformer)
            for _ in range(num_layers)])
        self.downsamplers = nn.ModuleList([
            Downsample(out_channels, resnet["quantized"])]) \
            if add_downsample else None

    def forward(self, x, temb, context, disable_crossview, disable_temporal,
                crossview_attention_mask=None):
        states = []
        for i, resnet in enumerate(self.resnets):
            x = _call(self.remat, resnet, x, temb, disable_temporal)
            if self.attentions is not None:
                x = _call(self.remat, self.attentions[i], x, context,
                          disable_crossview, disable_temporal,
                          crossview_attention_mask)
            states.append(x)
        if self.downsamplers is not None:
            x = _per_image(self.downsamplers[0], x)
            states.append(x)
        return x, states


class MidBlock(nn.Module):
    """``MidBlockCT``: resnet, transformer, resnet."""

    def __init__(self, channels: int, temb_channels: int, transformer: dict,
                 resnet: dict, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.resnets = nn.ModuleList([
            CTResBlock(channels, channels, temb_channels, **resnet)
            for _ in range(2)])
        self.attentions = nn.ModuleList([
            TransformerModel(channels, **transformer)])

    def forward(self, x, temb, context, disable_crossview, disable_temporal,
                crossview_attention_mask=None):
        x = _call(self.remat, self.resnets[0], x, temb, disable_temporal)
        x = _call(self.remat, self.attentions[0], x, context,
                  disable_crossview, disable_temporal,
                  crossview_attention_mask)
        return _call(self.remat, self.resnets[1], x, temb, disable_temporal)


class UpBlock(nn.Module):
    """``UpBlockCT``: each resnet takes the next skip state on its input's
    channels; attention in all but the first up block."""

    def __init__(self, in_channels: int, skip_channels: Sequence[int],
                 out_channels: int, temb_channels: int, add_upsample: bool,
                 transformer: Optional[dict], resnet: dict,
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        resnets = []
        for skip in skip_channels:
            resnets.append(CTResBlock(in_channels + skip, out_channels,
                                      temb_channels, **resnet))
            in_channels = out_channels
        self.resnets = nn.ModuleList(resnets)
        self.attentions = None if transformer is None else nn.ModuleList([
            TransformerModel(out_channels, **transformer)
            for _ in skip_channels])
        self.upsamplers = nn.ModuleList([
            Upsample(out_channels, resnet["quantized"])]) \
            if add_upsample else None

    def forward(self, x, res_states, temb, context, disable_crossview,
                disable_temporal, crossview_attention_mask=None):
        for i, resnet in enumerate(self.resnets):
            x = torch.cat([x, res_states.pop()], dim=-1)
            x = _call(self.remat, resnet, x, temb, disable_temporal)
            if self.attentions is not None:
                x = _call(self.remat, self.attentions[i], x, context,
                          disable_crossview, disable_temporal,
                          crossview_attention_mask)
        if self.upsamplers is not None:
            x = _per_image(self.upsamplers[0], x)
        return x


@register(
    "UNetCrossviewTemporal",
    aliases=(
        "dwm.models.crossview_temporal_unet.UNetCrossviewTemporalConditionModel",
    ),
)
class UNetCrossviewTemporal(nn.Module):
    """The crossview-temporal UNet denoiser. Channel-last in and out:

      sample                (b, t, v, h, w, in_channels)  or (b, t, h, w, c)
      timestep              (b, t, v) per-frame timesteps
      encoder_hidden_states (b, t, v, L, cross_attention_dim)
      added_time_ids        (b, t, v, K) numeric conditions (fps, camera)
      condition_image_tensor (b, t, v, H, W, C) layout rasters (the adapter)
      disable_crossview / disable_temporal: (b,) bool AlphaBlender overrides
      crossview_attention_mask: additive bias of the cross-view attention

    ``add_embedding`` takes ``addition_time_embed_dim`` features per added
    time id; its width follows the ids the pipeline feeds, as the flax
    model infers it (``set_add_embedding_width``). ``gradient_checkpointing``
    is read as remat of the blocks' resnets and transformer models; the JAX
    UNet declares it and never reads it (``opendwm_tpu/models/unet.py:519``),
    which gives the same values. ``depth_frustum_range`` is accepted and not
    read (the pipeline reads it), as in the JAX model. With an image adapter,
    its residual 0 is added after ``conv_in`` and residual i after down
    block i - 1, the sum replacing that block's last skip state; without
    one, a ``condition_image_tensor`` is ignored.
    """

    def __init__(
        self,
        in_channels: int = 8,
        out_channels: int = 4,
        block_out_channels: Sequence[int] = (320, 640, 1280, 1280),
        layers_per_block: int = 2,
        transformer_layers_per_block: int = 1,
        num_attention_heads: Sequence[int] = (5, 10, 20, 20),
        cross_attention_dim: int = 1024,
        addition_time_embed_dim: int = 256,
        projection_class_embeddings_input_dim: Optional[int] = 768,
        norm_eps: float = 1e-5,
        merge_factor: float = 0.5,
        enable_crossview: bool = True,
        enable_temporal: bool = True,
        enable_rowwise_crossview: bool = False,
        enable_rowwise_temporal: bool = False,
        condition_image_adapter_config: Optional[dict] = None,
        depth_net_config: Optional[dict] = None,
        depth_frustum_range: Optional[Sequence[float]] = None,
        gradient_checkpointing: bool = False,
        dtype: torch.dtype = torch.float32,
        param_dtype: Optional[torch.dtype] = None,
        quantization: Optional[str] = None,
    ):
        super().__init__()
        if quantization not in (None, "int8"):
            raise ValueError(f"unknown quantization {quantization!r}")
        quantized = quantization == "int8"
        conv = conv_factory(quantized)
        chans = list(block_out_channels)
        heads = list(num_attention_heads)
        n = len(chans)
        ch0 = chans[0]
        temb = ch0 * 4
        self.addition_time_embed_dim = addition_time_embed_dim

        self.conv_in = conv(in_channels, ch0, 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch0, temb)
        self.add_embedding = TimestepEmbedding(
            projection_class_embeddings_input_dim, temb) \
            if projection_class_embeddings_input_dim is not None else None

        resnet = dict(eps=norm_eps, enable_temporal=enable_temporal,
                      merge_factor=merge_factor, quantized=quantized)
        remat = gradient_checkpointing

        def transformer(ch: int, nh: int) -> dict:
            return dict(
                heads=nh, head_dim=ch // nh,
                cross_attention_dim=cross_attention_dim,
                num_layers=transformer_layers_per_block,
                enable_crossview=enable_crossview,
                enable_temporal=enable_temporal,
                enable_rowwise_crossview=enable_rowwise_crossview,
                enable_rowwise_temporal=enable_rowwise_temporal,
                merge_factor=merge_factor, quantized=quantized)

        downs, prev = [], ch0
        skips = [ch0]  # conv_in, then every resnet and downsample output
        for i, ch in enumerate(chans):
            last = i == n - 1
            downs.append(DownBlock(
                prev, ch, temb, layers_per_block, add_downsample=not last,
                transformer=None if last else transformer(ch, heads[i]),
                resnet=resnet, remat=remat))
            skips += [ch] * (layers_per_block + (0 if last else 1))
            prev = ch
        self.down_blocks = nn.ModuleList(downs)
        self.mid_block = MidBlock(chans[-1], temb,
                                  transformer(chans[-1], heads[-1]), resnet,
                                  remat)
        ups = []
        for i, (ch, nh) in enumerate(zip(reversed(chans), reversed(heads))):
            take = [skips.pop() for _ in range(layers_per_block + 1)]
            ups.append(UpBlock(
                prev, take, ch, temb, add_upsample=i < n - 1,
                transformer=None if i == 0 else transformer(ch, nh),
                resnet=resnet, remat=remat))
            prev = ch
        self.up_blocks = nn.ModuleList(ups)
        self.conv_norm_out = _gn(ch0, norm_eps)
        self.conv_out = conv(ch0, out_channels, 3, padding=1)
        self.condition_image_adapter = ImageAdapter(
            **condition_image_adapter_config) \
            if condition_image_adapter_config is not None else None
        self.depth_net = DepthNet(
            **depth_net_config, in_channels=ch0 + sum(chans),
            camera_dim=9 + 16, dtype=dtype) \
            if depth_net_config is not None else None
        self.to(param_dtype or dtype)
        self._dtype = dtype
        set_compute_dtype(self, dtype)

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype."""
        return self._dtype

    def set_add_embedding_width(self, width: int) -> None:
        """Rebuild ``add_embedding`` for ``width`` input features.

        The JAX model sizes it from the ``added_time_ids`` it is fed
        (``addition_time_embed_dim`` features per id), not from
        ``projection_class_embeddings_input_dim``; the pipeline calls this
        with the width its conditions produce."""
        old = self.add_embedding
        if old is not None and old.linear_1.in_features != width:
            new = TimestepEmbedding(width, old.linear_1.out_features)
            set_compute_dtype(new, self.dtype)
            self.add_embedding = new.to(device=old.linear_1.weight.device,
                                        dtype=old.linear_1.weight.dtype)

    def forward(
        self,
        sample: torch.Tensor,
        timestep: torch.Tensor,
        encoder_hidden_states: torch.Tensor,
        added_time_ids: Optional[torch.Tensor] = None,
        condition_image_tensor: Optional[torch.Tensor] = None,
        disable_crossview: Optional[torch.Tensor] = None,
        disable_temporal: Optional[torch.Tensor] = None,
        crossview_attention_mask: Optional[torch.Tensor] = None,
        camera_intrinsics: Optional[torch.Tensor] = None,
        camera_transforms: Optional[torch.Tensor] = None,
        **_unused,
    ):
        squeeze_view = sample.ndim == 5
        if squeeze_view:  # single-view input (b, t, h, w, c)
            sample, timestep = sample[:, :, None], timestep[:, :, None]
            if encoder_hidden_states.ndim == 4:
                encoder_hidden_states = encoder_hidden_states[:, :, None]
            if added_time_ids is not None and added_time_ids.ndim == 3:
                added_time_ids = added_time_ids[:, :, None]
            if condition_image_tensor is not None and \
                    condition_image_tensor.ndim == 5:
                condition_image_tensor = condition_image_tensor[:, :, None]
        b, t, v = sample.shape[:3]
        dt = self.dtype
        dev = sample.device
        if disable_crossview is None:
            disable_crossview = torch.zeros(b, dtype=torch.bool, device=dev)
        if disable_temporal is None:
            disable_temporal = torch.zeros(b, dtype=torch.bool, device=dev)

        ch0 = self.conv_in.out_channels
        emb = self.time_embedding(
            timestep_embedding(timestep.reshape(-1), ch0).to(dt))
        if added_time_ids is not None and self.add_embedding is not None:
            aug = timestep_embedding(added_time_ids.reshape(-1),
                                     self.addition_time_embed_dim)
            emb = emb + self.add_embedding(aug.reshape(b * t * v, -1).to(dt))
        emb = emb.reshape(b, t, v, -1)

        residuals = []
        if self.condition_image_adapter is not None and \
                condition_image_tensor is not None:
            residuals = self.condition_image_adapter(
                condition_image_tensor.to(dt))

        x = _per_image(lambda s: _conv(self.conv_in, s), sample.to(dt))
        depth_inputs = [x]
        if residuals:
            x = x + residuals[0]
        ctx = encoder_hidden_states.to(dt)
        cond = (ctx, disable_crossview, disable_temporal,
                crossview_attention_mask)
        states = [x]
        for i, block in enumerate(self.down_blocks, 1):
            x, block_states = block(x, emb, *cond)
            depth_inputs.append(x)
            if i < len(residuals):  # JAX ``unet.py:634-636``
                x = x + residuals[i]
                block_states[-1] = x
            states += block_states
        depth_features = None
        if self.depth_net is not None and camera_intrinsics is not None \
                and camera_transforms is not None:
            depth_features = self._depth(depth_inputs, camera_intrinsics,
                                         camera_transforms)
        x = self.mid_block(x, emb, *cond)
        for block in self.up_blocks:
            x = block(x, states, emb, *cond)
        out = _per_image(
            lambda h: _conv(self.conv_out, F.silu(self.conv_norm_out(h))), x)
        if squeeze_view:
            out = out[:, :, 0]
        return out if depth_features is None else (out, depth_features)

    def _depth(self, depth_inputs: list, camera_intrinsics: torch.Tensor,
               camera_transforms: torch.Tensor) -> torch.Tensor:
        """The depth net over the levels resized to level 0's h x w and
        concatenated (``unet.py:641-669``): ``(b, t, v, h, w, bins)``."""
        b, t, v, h, w = depth_inputs[0].shape[:5]
        feats = torch.cat([
            resize_nearest(f.reshape(-1, *f.shape[3:]), (h, w))
            for f in depth_inputs], -1).reshape(b, t, v, h, w, -1)
        cams = torch.cat([camera_intrinsics.reshape(b, t, v, -1),
                          camera_transforms.reshape(b, t, v, -1)], -1)
        return self.depth_net(feats, cams)
