"""Shared layers of the MMDiT and the UNet (``opendwm_tpu/models/layers.py``),
in PyTorch.

Parameter names are the reference state-dict names (diffusers 0.31 naming
plus the OpenDWM additions, as in ``tests/torch_oracle_mmdit.py``), so a
released checkpoint loads with ``load_state_dict``. Activations are
channel-last and attention is BSHD, as in the JAX package.

Mixed precision as flax's ``dtype``: ``Linear``, ``Conv2d``, ``Conv3d``,
``LayerNorm`` and ``GroupNorm`` cast their input and parameters to
``compute_dtype`` at each call (``set_compute_dtype``), so parameters may
live in another dtype (fp32 master weights) than the computation (bf16).
RMSNorm scales and mixer factors are applied in fp32 and cast, as in the
JAX layers. ``GroupNorm`` takes channel-last input, as flax's does.

int8 W8A8 serving: ``QLinear`` and ``QConv2d`` (flax ``QDense`` and
``QConv``, ``ops/quant.py``), chosen by ``dense_factory`` /
``conv_factory`` and the ``quantized`` flag of the blocks, as in the JAX
layers.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import (
    checkpoint,
    create_selective_checkpoint_contexts,
)

from opendwm_tpu_torch.ops import quant
from opendwm_tpu_torch.ops.attention import dot_product_attention


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype`` (``None``: the weight's
    dtype); input, weight and bias are cast to it, as flax ``Dense`` does."""

    compute_dtype: Optional[torch.dtype] = None

    @property
    def dtype(self) -> torch.dtype:
        return self.compute_dtype or self.weight.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype``, as ``Linear``."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or self.weight.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` computing in ``compute_dtype``, as ``Linear``
    (no output padding or size: the LiDAR decoder's 2x up-sampling)."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or self.weight.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt), bias,
                                  self.stride, self.padding)


class Conv3d(nn.Conv3d):
    """``nn.Conv3d`` computing in ``compute_dtype``, as ``Linear``."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or self.weight.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` over channel-last ``(N, ..., C)`` input, computing in
    ``compute_dtype``: statistics pool per leading index over every other
    axis, as flax's ``GroupNorm`` does."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or self.weight.dtype
        y = F.group_norm(x.to(dt).movedim(-1, 1), self.num_groups,
                         self.weight.to(dt), self.bias.to(dt), self.eps)
        return y.movedim(1, -1)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` computing in ``compute_dtype``, as ``Linear``."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or self.weight.dtype
        return F.layer_norm(x.to(dt), self.normalized_shape,
                            self.weight.to(dt), self.bias.to(dt), self.eps)


class _Int8Weights(nn.Module):
    """The int8 state of ``QLinear``/``QConv2d``: buffers ``weight_q``
    (int8) and ``weight_scale`` (fp32, one per output channel), and a
    float ``bias`` parameter. A dtype cast of the module (``.to(dtype)``,
    ``.half()``) moves the scale but keeps it fp32, as flax keeps
    ``kernel_scale``: it crosses ``_apply`` as its int32 bits. Fresh
    weights are random int8 with scale 0.02 / 127, as flax draws them."""

    compute_dtype: Optional[torch.dtype] = None

    def _init_int8(self, shape: tuple, bias: bool) -> None:
        self.register_buffer("weight_q", torch.randint(
            -127, 128, shape, dtype=torch.int8))
        self.register_buffer("weight_scale", torch.full(
            (shape[0],), 0.02 / 127, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(shape[0])) if bias else None

    @property
    def dtype(self) -> torch.dtype:
        if self.compute_dtype is not None:
            return self.compute_dtype
        return torch.float32 if self.bias is None else self.bias.dtype

    def _apply(self, fn, recurse=True):
        self._buffers["weight_scale"] = self.weight_scale.view(torch.int32)
        try:
            return super()._apply(fn, recurse)
        finally:
            self._buffers["weight_scale"] = \
                self._buffers["weight_scale"].view(torch.float32)

    def _add_bias(self, y: torch.Tensor) -> torch.Tensor:
        return y if self.bias is None else y + self.bias.to(y.dtype)


class QLinear(_Int8Weights):
    """flax ``QDense``: ``int8_matmul`` of the input, quantized per token
    in the dtype it arrives in (it is not cast to ``compute_dtype`` first,
    as ``Linear`` casts it), then the bias in ``compute_dtype``.
    ``weight_q`` is ``(out_features, in_features)``."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self._init_int8((out_features, in_features), bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._add_bias(quant.int8_matmul(
            x, self.weight_q, self.weight_scale, self.dtype))


class QConv2d(_Int8Weights):
    """flax ``QConv`` behind ``nn.Conv2d``'s NCHW surface: ``int8_conv``
    of the input, quantized with one scale for the whole tensor in the
    dtype it arrives in, then the bias in ``compute_dtype``. ``padding``
    is an int, ``"SAME"`` or ``"VALID"`` (flax's forms); ``weight_q`` is
    channel-last, ``(out_channels, kh, kw, in_channels)``. The output is
    an NCHW view of channel-last memory."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size, stride=1, padding: quant.Padding = 0,
                 bias: bool = True):
        super().__init__()
        kh, kw = (kernel_size,) * 2 if isinstance(kernel_size, int) \
            else kernel_size
        self.in_channels, self.out_channels = in_channels, out_channels
        self.stride = (stride,) * 2 if isinstance(stride, int) \
            else tuple(stride)
        self.padding = padding
        self._init_int8((out_channels, kh, kw, in_channels), bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = quant.int8_conv(x.movedim(1, -1), self.weight_q,
                            self.weight_scale, self.stride, self.padding,
                            self.dtype)
        return self._add_bias(y).movedim(-1, 1)


def dense_factory(quantized: bool) -> type:
    """``Linear``, or ``QLinear`` when the serving path runs int8."""
    return QLinear if quantized else Linear


def conv_factory(quantized: bool) -> type:
    """``Conv2d``, or ``QConv2d`` when the serving path runs int8."""
    return QConv2d if quantized else Conv2d


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> None:
    """Make every ``Linear``/``Conv2d``/``ConvTranspose2d``/``Conv3d``/
    ``LayerNorm``/``GroupNorm`` (and int8 ``QLinear``/``QConv2d``) under
    ``module`` compute in ``dtype`` whatever dtype its parameters are kept
    in."""
    for m in module.modules():
        if isinstance(m, (Linear, Conv2d, ConvTranspose2d, Conv3d, LayerNorm,
                          GroupNorm, _Int8Weights)):
            m.compute_dtype = dtype


def checkpointed(module: nn.Module, *args, saved_ops=None, **kwargs):
    """``module(*args, **kwargs)``, rematerialised in the backward when a
    gradient is being recorded (``torch.utils.checkpoint``, non-reentrant:
    flax's ``nn.remat``); the outputs of ``saved_ops`` are kept instead."""
    if not torch.is_grad_enabled():
        return module(*args, **kwargs)
    extra = {}
    if saved_ops is not None:
        extra["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, list(saved_ops))
    return checkpoint(module, *args, use_reentrant=False, **extra, **kwargs)


def resize_nearest(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Channel-last ``(n, h, w, c)`` → ``(n, *size, c)`` by nearest
    neighbour at half-pixel centres, ``jax.image.resize(..., "nearest")``:
    output ``i`` of ``out`` reads input ``floor((i + 0.5) · in / out)``,
    computed in integers, ``((2i + 1) · in) // (2 · out)``, so that a
    product that is a whole number (4 → 14: output 3 reads input 1) does
    not hang on how a float scale rounds."""
    for dim, (m, n) in enumerate(zip(x.shape[1:3], size), 1):
        if m != n:
            idx = (2 * torch.arange(n, device=x.device) + 1) * m // (2 * n)
            x = x.index_select(dim, idx)
    return x


def timestep_embedding(
    timesteps: torch.Tensor,
    dim: int,
    *,
    flip_sin_to_cos: bool = True,
    downscale_freq_shift: float = 0.0,
    max_period: float = 10000.0,
    scale: float = 1.0,
) -> torch.Tensor:
    """Sinusoidal features of shape ``(*timesteps.shape, dim)`` in fp32
    (diffusers ``get_timestep_embedding``)."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device
    )
    freqs = torch.exp(exponent / (half - downscale_freq_shift))
    args = scale * (timesteps.float()[..., None] * freqs)
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def _sincos_table(embed_dim: int, rows: np.ndarray, cols: np.ndarray,
                  grid_size: tuple[int, int], base_size: int,
                  interpolation_scale: float) -> np.ndarray:
    gh = rows.astype(np.float32) / (grid_size[0] / base_size)
    gw = cols.astype(np.float32) / (grid_size[1] / base_size)
    gh, gw = gh / interpolation_scale, gw / interpolation_scale
    mesh_w, mesh_h = np.meshgrid(gw, gh)  # xy indexing: w varies fastest

    def emb_1d(dim, pos):
        omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
        omega = 1.0 / 10000**omega
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    emb = np.concatenate(
        [emb_1d(embed_dim // 2, mesh_w), emb_1d(embed_dim // 2, mesh_h)],
        axis=1,
    )
    return emb.astype(np.float32)


def sincos_pos_embed_2d(
    embed_dim: int,
    grid_size: tuple[int, int],
    base_size: int,
    interpolation_scale: float = 1.0,
) -> np.ndarray:
    """2-D sincos table of diffusers' SD3 PatchEmbed, as
    ``(grid_h * grid_w, embed_dim)`` fp32 numpy."""
    return _sincos_table(embed_dim, np.arange(grid_size[0]),
                         np.arange(grid_size[1]), grid_size, base_size,
                         interpolation_scale)


def cropped_sincos_pos_embed(
    embed_dim: int, grid_h: int, grid_w: int, max_size: int, base_size: int,
    interpolation_scale: float = 1.0,
) -> np.ndarray:
    """The central ``(grid_h, grid_w)`` crop of the ``max_size`` square
    table, as ``PatchEmbed`` crops it, computing only the crop."""
    top = (max_size - grid_h) // 2
    left = (max_size - grid_w) // 2
    return _sincos_table(embed_dim, np.arange(top, top + grid_h),
                         np.arange(left, left + grid_w),
                         (max_size, max_size), base_size,
                         interpolation_scale)


class TimestepEmbedding(nn.Module):
    """Two-layer MLP with SiLU (diffusers ``TimestepEmbedding``)."""

    def __init__(self, in_dim: int, time_embed_dim: int,
                 out_dim: Optional[int] = None):
        super().__init__()
        self.linear_1 = Linear(in_dim, time_embed_dim)
        self.linear_2 = Linear(time_embed_dim, out_dim or time_embed_dim)

    def forward(self, sample: torch.Tensor) -> torch.Tensor:
        x = self.linear_1(sample)
        return self.linear_2(F.silu(x))


class RMSNorm(nn.Module):
    """RMSNorm with a learned scale, statistics in fp32 (eps 1e-6)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var = (x32 * x32).mean(-1, keepdim=True)
        y = x32 * torch.rsqrt(var + self.eps)
        return (y * self.weight.float()).to(x.dtype)


class _GELUProj(nn.Module):
    def __init__(self, dim: int, inner: int, approximate: str,
                 quantized: bool = False):
        super().__init__()
        self.proj = dense_factory(quantized)(dim, inner)
        self.approximate = approximate

    def forward(self, x):
        return F.gelu(self.proj(x), approximate=self.approximate)


class _GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int, quantized: bool = False):
        super().__init__()
        self.proj = dense_factory(quantized)(dim, inner * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    """diffusers ``FeedForward``; activation in {geglu, gelu-approximate,
    gelu}; ``quantized``: int8 projections (``QLinear``)."""

    def __init__(self, dim: int, dim_out: Optional[int] = None, mult: int = 4,
                 activation: str = "geglu", quantized: bool = False):
        super().__init__()
        inner = dim * mult
        if activation == "geglu":
            act = _GEGLU(dim, inner, quantized)
        elif activation == "gelu-approximate":
            act = _GELUProj(dim, inner, "tanh", quantized)
        elif activation == "gelu":
            act = _GELUProj(dim, inner, "none", quantized)
        else:
            raise ValueError(f"Unknown activation {activation!r}")
        self.net = nn.ModuleList([
            act, nn.Dropout(0.0),
            dense_factory(quantized)(inner, dim_out or dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class Attention(nn.Module):
    """Multi-head self-attention; cross-attention when called with a
    ``context`` (keys and values from it, ``context_dim`` wide); or MMDiT
    joint attention (``joint``) where the context stream carries its own
    projections (``add_*_proj``), the two streams attend over their
    concatenated tokens (sample first) and split. ``context_pre_only``
    drops the context output projection. ``qkv_bias=False`` gives the
    reference UNet's bias-free q/k/v projections; ``quantized`` makes
    every projection a ``QLinear``. ``sp_axis`` names a mesh axis over
    which the attention runs as a ring
    (``ops.ring_attention.ring_attention_replicated``) on tokens replicated
    over it, where no mask is given (JAX ``layers.py:326``); the ring's
    process group is ``sp_group``, which the owner of the mesh sets
    (``parallel.mesh.bind_sequence_parallel``): None rings over one rank."""

    def __init__(self, dim: int, heads: int, head_dim: int,
                 qk_norm: Optional[str] = None, out_dim: Optional[int] = None,
                 joint: bool = False, context_pre_only: bool = False,
                 context_dim: Optional[int] = None, qkv_bias: bool = True,
                 quantized: bool = False, sp_axis: Optional[str] = None):
        super().__init__()
        self.sp_axis = sp_axis
        self.sp_group = None  # parallel.mesh.bind_sequence_parallel
        if qk_norm not in (None, "rms_norm"):
            raise ValueError(f"Unsupported qk_norm {qk_norm!r}")
        inner = heads * head_dim
        kv_dim = context_dim or dim
        lin = dense_factory(quantized)
        self.heads, self.head_dim = heads, head_dim
        self.joint, self.context_pre_only = joint, context_pre_only
        self.to_q = lin(dim, inner, bias=qkv_bias)
        self.to_k = lin(kv_dim, inner, bias=qkv_bias)
        self.to_v = lin(kv_dim, inner, bias=qkv_bias)
        self.to_out = nn.ModuleList([lin(inner, out_dim or dim)])
        if qk_norm == "rms_norm":
            self.norm_q = RMSNorm(head_dim)
            self.norm_k = RMSNorm(head_dim)
        if joint:
            self.add_q_proj = lin(dim, inner)
            self.add_k_proj = lin(dim, inner)
            self.add_v_proj = lin(dim, inner)
            if qk_norm == "rms_norm":
                self.norm_added_q = RMSNorm(head_dim)
                self.norm_added_k = RMSNorm(head_dim)
            if not context_pre_only:
                self.to_add_out = lin(inner, dim)

    def _heads(self, x):
        return x.reshape(x.shape[0], x.shape[1], self.heads, self.head_dim)

    def _qkv(self, x, kv, to_q, to_k, to_v, norm_q, norm_k):
        q, k, v = self._heads(to_q(x)), self._heads(to_k(kv)), \
            self._heads(to_v(kv))
        if norm_q is not None:
            q, k = norm_q(q), norm_k(k)
        return q, k, v

    def forward(self, x, context=None, mask=None):
        kv = x if self.joint or context is None else context
        q, k, v = self._qkv(x, kv, self.to_q, self.to_k, self.to_v,
                            getattr(self, "norm_q", None),
                            getattr(self, "norm_k", None))
        if self.joint:
            cq, ck, cv = self._qkv(
                context, context, self.add_q_proj, self.add_k_proj,
                self.add_v_proj,
                getattr(self, "norm_added_q", None),
                getattr(self, "norm_added_k", None),
            )
            q, k, v = (torch.cat(p, dim=1) for p in ((q, cq), (k, ck), (v, cv)))
        if self.sp_axis is not None and mask is None:
            from opendwm_tpu_torch.ops.ring_attention import (
                ring_attention_replicated,
            )

            out = ring_attention_replicated(q, k, v, self.sp_group)
        else:
            out = dot_product_attention(q, k, v, bias=mask)
        out = out.reshape(out.shape[0], out.shape[1], -1)
        if not self.joint:
            return self.to_out[0](out)
        n_ctx = context.shape[1]
        sample = self.to_out[0](out[:, :-n_ctx])
        if self.context_pre_only:
            return sample, None
        return sample, self.to_add_out(out[:, -n_ctx:])


class CombinedTimestepTextProjEmbeddings(nn.Module):
    """SD3 ``time_text_embed``: sinusoidal timestep MLP + pooled-text MLP."""

    def __init__(self, embed_dim: int, pooled_projection_dim: int):
        super().__init__()
        self.timestep_embedder = TimestepEmbedding(256, embed_dim)
        self.text_embedder = TimestepEmbedding(pooled_projection_dim, embed_dim)

    def forward(self, timestep, pooled_projection):
        t = self.timestep_embedder(timestep_embedding(timestep, 256))
        return t + self.text_embedder(pooled_projection)


class PatchEmbed(nn.Module):
    """SD3 patch embedding plus the cropped sincos position table.
    Takes channel-last ``(B, H, W, C)``; returns ``(B, gh * gw, D)``."""

    def __init__(self, patch_size: int, in_channels: int, embed_dim: int,
                 pos_embed_max_size: int = 384, base_size: int = 64):
        super().__init__()
        self.proj = Conv2d(in_channels, embed_dim, patch_size,
                              stride=patch_size)
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.pos_embed_max_size = pos_embed_max_size
        self.base_size = base_size
        self._pos_cache: dict = {}

    def _pos(self, gh: int, gw: int, like: torch.Tensor) -> torch.Tensor:
        key = (gh, gw, like.device, like.dtype)
        if key not in self._pos_cache:
            table = cropped_sincos_pos_embed(
                self.embed_dim, gh, gw, self.pos_embed_max_size,
                self.base_size,
            )
            self._pos_cache[key] = torch.from_numpy(table).to(
                device=like.device, dtype=like.dtype
            )[None]
        return self._pos_cache[key]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.proj(x.permute(0, 3, 1, 2))
        b, d, gh, gw = x.shape
        x = x.flatten(2).transpose(1, 2)
        return x + self._pos(gh, gw, x)


class AlphaBlender(nn.Module):
    """Learned sigmoid mix of two branches with a per-sample disable:
    ``alpha * a + (1 - alpha) * b``; alpha is 1 where
    ``image_only_indicator`` is set (``learned_with_images``)."""

    def __init__(self, alpha: float = 2.0,
                 merge_strategy: str = "learned_with_images"):
        super().__init__()
        self.alpha = alpha
        self.merge_strategy = merge_strategy
        if merge_strategy != "fixed":
            self.mix_factor = nn.Parameter(torch.tensor([float(alpha)]))

    def forward(self, a, b, image_only_indicator=None):
        if self.merge_strategy == "fixed":
            alpha = torch.tensor(self.alpha, dtype=torch.float32,
                                 device=a.device)
        else:
            alpha = torch.sigmoid(self.mix_factor.float())
        if self.merge_strategy == "learned_with_images":
            if image_only_indicator is None:
                raise ValueError("learned_with_images requires the indicator")
            alpha = torch.where(image_only_indicator, 1.0, alpha)
        alpha = alpha.reshape(alpha.shape + (1,) * (a.ndim - alpha.ndim))
        alpha = alpha.to(a.dtype)
        return alpha * a + (1.0 - alpha) * b


class Mixer(nn.Module):
    """Scale-gated residual mixer: ``a + gate * scale * b``."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.randn(1, dim) / dim**0.5)

    def forward(self, a, b, image_only_indicator=None):
        gate = 1.0
        if image_only_indicator is not None:
            gate = torch.where(image_only_indicator, 0.0, 1.0).to(a.dtype)
            gate = gate.reshape(gate.shape + (1,) * (a.ndim - gate.ndim))
        return a + gate * self.scale.to(a.dtype) * b


class VTSelfAttentionBlock(nn.Module):
    """ff_in → self-attention → ff residual block of the cross-view and
    temporal branches (reference crossview_temporal.py:536-582);
    ``quantized``: its feed-forwards and attention in int8."""

    def __init__(self, dim: int, heads: int, head_dim: int,
                 qk_norm: Optional[str] = None, qkv_bias: bool = True,
                 quantized: bool = False):
        super().__init__()
        self.norm_in = LayerNorm(dim, eps=1e-5)
        self.ff_in = FeedForward(dim, activation="geglu", quantized=quantized)
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads, head_dim, qk_norm=qk_norm,
                               qkv_bias=qkv_bias, quantized=quantized)
        self.norm3 = LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim, activation="geglu", quantized=quantized)

    def forward(self, x, mask=None):
        h = x + self.ff_in(self.norm_in(x))
        h = h + self.attn1(self.norm1(h), mask=mask)
        return h + self.ff(self.norm3(h))


class TemporalBasicTransformerBlock(VTSelfAttentionBlock):
    """The UNet's cross-view and temporal branch block
    (``layers.py:552-592``, reference crossview_temporal.py:167-266): the
    same ff_in → self-attention → ff block with the reference's bias-free
    q/k/v, and an optional cross-attention after the self-attention.
    Attention runs over axis 1: callers reshape so that it is the axis to
    attend over."""

    def __init__(self, dim: int, heads: int, head_dim: int,
                 use_cross_attention: bool = False,
                 cross_attention_dim: Optional[int] = None,
                 quantized: bool = False):
        super().__init__(dim, heads, head_dim, qkv_bias=False,
                         quantized=quantized)
        self.use_cross_attention = use_cross_attention
        if use_cross_attention:
            self.norm2 = LayerNorm(dim, eps=1e-5)
            self.attn2 = Attention(dim, heads, head_dim, qkv_bias=False,
                                   context_dim=cross_attention_dim,
                                   quantized=quantized)

    def forward(self, x, context=None, mask=None):
        h = x + self.ff_in(self.norm_in(x))
        h = h + self.attn1(self.norm1(h), mask=mask)
        if self.use_cross_attention:
            h = h + self.attn2(self.norm2(h), context=context)
        return h + self.ff(self.norm3(h))
