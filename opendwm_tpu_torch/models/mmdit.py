"""Cross-view temporal MMDiT denoiser (``opendwm_tpu/models/mmdit.py``).

Ported: the SD3.5 joint-block backbone (dual attention, qk-RMSNorm,
``context_pre_only`` last block); implicit perspective embedding and
explicit perspective modeling (``RayEncoder``: per-pixel camera rays of
the latent grid, octave-encoded and projected by ``rayencoder_proj`` to a
per-token view embedding); the cross-view branches (``rowwise``,
``full``, and the camera-ring neighbourhoods ``fuse`` and ``adj_fuse``)
and the temporal ones (``pointwise``, ``rowwise``, ``full``), mixed back
by ``AlphaBlender`` or ``Mixer``; the layout ImageAdapter
(``condition_image_adapter_config``: one residual per stage, added to the
tokens before each of the first ``len(channels)`` joint blocks); the
MaskGWM hook (``mask_module_config``: tokens dropped before the blocks
and rebuilt at the first decoder layer, ``models/mask_layers.py``); and
int8 W8A8 serving (``quantization="int8"``: every attention and
feed-forward of the joint blocks and of the cross-view and temporal
branches as ``QLinear``; the modulations, embeddings, norms and
``proj_out`` stay float, as in the JAX model). The joint
block's modulations run through the fused AdaLN kernels
(``ops/fused_adaln.py``), which the JAX model writes out in jnp; its
XLA-only optimisation barriers have no counterpart.

Training as the JAX model trains: parameters may be kept in
``param_dtype`` (fp32 master weights) while every Linear, Conv and norm
computes in ``dtype`` (bf16), as flax's ``param_dtype``/``dtype`` split
does; and the remat flags rematerialise the same blocks as ``nn.remat``
does there (``torch.utils.checkpoint``, non-reentrant), with the
``"dots"``/``"dots_no_batch"`` policies as selective checkpointing that
saves the matrix products. Remat changes memory, never values.

``sequence_parallel_axis`` runs each joint attention as a ring over that
mesh axis (``models.layers.Attention``'s ``sp_axis``), as JAX's does; the
pipeline that holds the model binds the axis to its mesh's group
(``parallel.mesh.bind_sequence_parallel``).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from opendwm_tpu_torch.config import register
from opendwm_tpu_torch.models.adapters import ImageAdapter
from opendwm_tpu_torch.models.mask_layers import MaskController
from opendwm_tpu_torch.models.layers import (
    AlphaBlender,
    Attention,
    CombinedTimestepTextProjEmbeddings,
    FeedForward,
    Linear,
    Mixer,
    PatchEmbed,
    TimestepEmbedding,
    VTSelfAttentionBlock,
    checkpointed,
    set_compute_dtype,
    timestep_embedding,
)
from opendwm_tpu_torch.ops.fused_adaln import (
    adaln_modulate,
    residual_adaln_modulate,
)


class Modulation(nn.Module):
    """adaLN modulation head: ``silu(temb) → Linear(n_chunks * dim)``,
    returned as ``n_chunks`` per-sample ``(n, dim)`` vectors."""

    def __init__(self, dim: int, n_chunks: int):
        super().__init__()
        self.linear = Linear(dim, n_chunks * dim)
        self.n_chunks = n_chunks

    def forward(self, emb: torch.Tensor):
        mod = self.linear(F.silu(emb.to(self.linear.dtype)))
        return mod.chunk(self.n_chunks, dim=-1)


class JointTransformerBlock(nn.Module):
    """SD3 MMDiT block (diffusers ``JointTransformerBlock`` semantics);
    ``dual_attention`` adds the SD3.5 latent-only second attention;
    ``quantized`` runs the attentions and feed-forwards in int8."""

    def __init__(self, heads: int, head_dim: int,
                 qk_norm: Optional[str] = "rms_norm",
                 dual_attention: bool = False,
                 context_pre_only: bool = False,
                 quantized: bool = False, sp_axis: Optional[str] = None):
        super().__init__()
        dim = heads * head_dim
        q8 = dict(quantized=quantized)
        self.dual_attention = dual_attention
        self.context_pre_only = context_pre_only
        self.norm1 = Modulation(dim, 9 if dual_attention else 6)
        self.norm1_context = Modulation(dim, 2 if context_pre_only else 6)
        self.attn = Attention(dim, heads, head_dim, qk_norm=qk_norm,
                              joint=True, context_pre_only=context_pre_only,
                              sp_axis=sp_axis, **q8)
        if dual_attention:
            self.attn2 = Attention(dim, heads, head_dim, qk_norm=qk_norm,
                                   **q8)
        self.ff = FeedForward(dim, activation="gelu-approximate", **q8)
        if not context_pre_only:
            self.ff_context = FeedForward(dim, activation="gelu-approximate",
                                          **q8)

    def forward(self, x, context, temb):
        mods = self.norm1(temb)
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = \
            mods[:6]
        norm_x = adaln_modulate(x, scale_msa, shift_msa)
        cmods = self.norm1_context(temb)
        if self.context_pre_only:
            c_scale, c_shift = cmods  # AdaLayerNormContinuous order
            norm_ctx = adaln_modulate(context, c_scale, c_shift)
        else:
            c_shift_msa, c_scale_msa, c_gate_msa = cmods[:3]
            c_shift_mlp, c_scale_mlp, c_gate_mlp = cmods[3:]
            norm_ctx = adaln_modulate(context, c_scale_msa, c_shift_msa)

        attn_out, ctx_attn_out = self.attn(norm_x, norm_ctx)
        if self.dual_attention:
            shift2, scale2, gate2 = mods[6:]
            norm_x2 = adaln_modulate(x, scale2, shift2)
            x = x + gate_msa[:, None] * attn_out
            x, norm_x = residual_adaln_modulate(
                x, self.attn2(norm_x2).to(x.dtype), gate2, scale_mlp,
                shift_mlp
            )
        else:
            x, norm_x = residual_adaln_modulate(
                x, attn_out.to(x.dtype), gate_msa, scale_mlp, shift_mlp
            )
        x = x + gate_mlp[:, None] * self.ff(norm_x)
        if self.context_pre_only:
            return x, None

        context, norm_ctx = residual_adaln_modulate(
            context, ctx_attn_out, c_gate_msa, c_scale_mlp, c_shift_mlp
        )
        context = context + c_gate_mlp[:, None] * self.ff_context(norm_ctx)
        return x, context


# Ops whose outputs the remat policies save (jax.checkpoint_policies
# dots_saveable / dots_with_no_batch_dims_saveable); the rest is recomputed.
_REMAT_SAVED_OPS = {
    None: None,
    "dots": (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
             torch.ops.aten.bmm.default),
    "dots_no_batch": (torch.ops.aten.mm.default,
                      torch.ops.aten.addmm.default),
}


def octave_encode(coords: torch.Tensor, n_octaves: int,
                  start: int = 0) -> torch.Tensor:
    """sin and cos of ``coords`` at ``2^k·π``, k = start .. start +
    n_octaves - 1: (..., d) → (..., 2·d·n_octaves), all the sines first
    (``RayEncoder._octave_encode``)."""
    octaves = torch.pow(2.0, torch.arange(
        start, start + n_octaves, dtype=torch.float32,
        device=coords.device)) * math.pi
    scaled = (coords[..., None] * octaves).flatten(-2)
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], -1)


def get_rays(intrinsics: torch.Tensor, cam2ref: torch.Tensor,
             hw: tuple[int, int]):
    """Camera origins ``(N, 3)`` and unit ray directions ``(N, h, w, 3)``
    through the pixel centres of an h x w grid, in fp32 (``mmdit.py:208``).
    intrinsics: (N, 3, 3) at the grid's scale; cam2ref: (N, 4, 4)."""
    h, w = hw
    dev = intrinsics.device
    xs = torch.arange(w, dtype=torch.float32, device=dev) + 0.5
    ys = torch.arange(h, dtype=torch.float32, device=dev) + 0.5
    grid_y, grid_x = torch.meshgrid(ys, xs, indexing="ij")
    pix = torch.stack([grid_x.reshape(-1), grid_y.reshape(-1),
                       torch.ones(h * w, device=dev)])  # (3, h·w)
    dirs = torch.linalg.inv(intrinsics.float()) @ pix
    rays_d = cam2ref[:, :3, :3].float() @ dirs
    rays_d = rays_d / torch.linalg.norm(rays_d, dim=1, keepdim=True)
    rays_d = rays_d.transpose(1, 2).reshape(-1, h, w, 3)
    return cam2ref[:, :3, 3].float(), rays_d


# Octaves of the explicit perspective embedding: 8 for the camera origin,
# 4 for the ray direction (3 · 2 · (8 + 4) = 72 features a token).
RAY_POS_OCTAVES, RAY_DIR_OCTAVES = 8, 4
RAY_FEATURES = 3 * 2 * (RAY_POS_OCTAVES + RAY_DIR_OCTAVES)
CROSSVIEW_TYPES = ("rowwise", "full", "fuse", "adj_fuse")
TEMPORAL_TYPES = ("pointwise", "rowwise", "full")


@register(
    "DiTCrossviewTemporal",
    aliases=(
        "dwm.models.crossview_temporal_dit.DiTCrossviewTemporalConditionModel",
    ),
)
class DiTCrossviewTemporal(nn.Module):
    """The flagship denoiser. Channel-last video latents in and out:

      sample                (b, t, v, h, w, in_channels)  or (b, t, h, w, c)
      timestep              (b, t, v) per-frame noise levels
      encoder_hidden_states (b, t, v, L, joint_attention_dim)
      pooled_projections    (b, t, v, pooled_projection_dim)
      added_time_ids        (b, t, v, K) numeric conditions (implicit mode)
      camera_intrinsics_norm (b, t, v, 3, 3) intrinsics over the image size
      camera2referego       (b, t, v, 4, 4) camera → reference ego (explicit)
      condition_image_tensor (b, t, v, H, W, C) layout rasters (the adapter)
      disable_crossview / disable_temporal: (b,) bool AlphaBlender overrides
      crossview_attention_index (v, 3) the views ``fuse``/``adj_fuse``
                            attend over (default: v - 1, v, v + 1 around
                            the camera ring)
      mask_noise            MaskGWM's masking draw
                            (``mask_layers.draw_mask_noise``); without it
                            the mask module is bypassed, as without
                            ``mask_rng``

    Keyword names follow the reference JSON config. ``dtype`` is the dtype
    of the computation; ``param_dtype`` that of the parameters (default:
    ``dtype``; training keeps fp32 master weights under a bf16 ``dtype``).
    """

    def __init__(
        self,
        patch_size: int = 2,
        num_layers: int = 24,
        attention_head_dim: int = 64,
        num_attention_heads: int = 24,
        in_channels: int = 16,
        out_channels: int = 16,
        joint_attention_dim: int = 4096,
        caption_projection_dim: int = 1536,
        pooled_projection_dim: int = 2048,
        pos_embed_max_size: int = 384,
        sample_size: int = 128,
        qk_norm: Optional[str] = "rms_norm",
        dual_attention_layers: Sequence[int] = tuple(range(13)),
        enable_crossview: bool = False,
        crossview_attention_type: Optional[str] = None,
        crossview_block_layers: Sequence[int] = (),
        enable_temporal: bool = False,
        temporal_attention_type: Optional[str] = None,
        temporal_block_layers: Sequence[int] = (),
        qk_norm_on_additional_modules: Optional[str] = None,
        mixer_type: str = "AlphaBlender",
        merge_factor: float = 2.0,
        merge_strategy: str = "learned_with_images",
        disable_view_emb_on_temporal_module: bool = False,
        perspective_modeling_type: str = "",
        projection_class_embeddings_input_dim: Optional[int] = None,
        condition_image_adapter_config: Optional[dict] = None,
        mask_module_config: Optional[dict] = None,
        gradient_checkpointing: bool = False,
        crossview_gradient_checkpointing: bool = False,
        temporal_gradient_checkpointing: bool = False,
        remat_block_layers: Optional[Sequence[int]] = None,
        remat_policy: Optional[str] = None,
        dtype: torch.dtype = torch.float32,
        param_dtype: Optional[torch.dtype] = None,
        attention_backend: Optional[str] = None,
        quantization: Optional[str] = None,
        sequence_parallel_axis: Optional[str] = None,
    ):
        super().__init__()
        if enable_crossview and crossview_attention_type not in \
                CROSSVIEW_TYPES:
            raise ValueError(f"unsupported crossview_attention_type "
                             f"{crossview_attention_type!r}")
        if enable_temporal and temporal_attention_type not in TEMPORAL_TYPES:
            raise ValueError(f"unsupported temporal_attention_type "
                             f"{temporal_attention_type!r}")
        if perspective_modeling_type not in ("", "implicit", "explicit"):
            raise ValueError(f"unknown perspective_modeling_type "
                             f"{perspective_modeling_type!r}")
        if quantization not in (None, "int8"):
            raise ValueError(f"unknown quantization {quantization!r}")
        if attention_backend is not None:
            raise ValueError("attention_backend is a JAX dispatch hint; the "
                             "port dispatches by shape and device")
        if remat_policy not in _REMAT_SAVED_OPS:
            raise ValueError(f"unknown remat_policy {remat_policy!r}")
        dim = attention_head_dim * num_attention_heads
        self.patch_size = patch_size
        self.num_layers = num_layers
        self.inner_dim = dim
        self.out_channels = out_channels
        self.enable_crossview = enable_crossview
        self.enable_temporal = enable_temporal
        self.crossview_block_layers = list(crossview_block_layers)
        self.temporal_block_layers = list(temporal_block_layers)
        self.crossview_attention_type = crossview_attention_type
        self.temporal_attention_type = temporal_attention_type
        self.disable_view_emb_on_temporal_module = \
            disable_view_emb_on_temporal_module
        self.perspective_modeling_type = perspective_modeling_type
        self.gradient_checkpointing = gradient_checkpointing
        self.crossview_gradient_checkpointing = \
            crossview_gradient_checkpointing
        self.temporal_gradient_checkpointing = temporal_gradient_checkpointing
        self.remat_block_layers = None if remat_block_layers is None \
            else list(remat_block_layers)
        self.remat_saved_ops = _REMAT_SAVED_OPS[remat_policy]
        quantized = quantization == "int8"

        self.pos_embed = PatchEmbed(
            patch_size, in_channels, dim, pos_embed_max_size,
            base_size=sample_size // patch_size,
        )
        self.context_embedder = Linear(joint_attention_dim,
                                       caption_projection_dim)
        self.time_text_embed = CombinedTimestepTextProjEmbeddings(
            dim, pooled_projection_dim
        )
        if perspective_modeling_type == "implicit":
            if projection_class_embeddings_input_dim is None:
                raise ValueError(
                    "implicit perspective modeling needs "
                    "projection_class_embeddings_input_dim (256 per added "
                    "time id)"
                )
            self.view_embedding = TimestepEmbedding(
                projection_class_embeddings_input_dim, dim
            )
        elif perspective_modeling_type == "explicit":
            self.rayencoder_proj = Linear(RAY_FEATURES, dim, bias=False)
        self.transformer_blocks = nn.ModuleList([
            JointTransformerBlock(
                num_attention_heads, attention_head_dim, qk_norm=qk_norm,
                dual_attention=i in dual_attention_layers,
                context_pre_only=i == num_layers - 1, quantized=quantized,
                sp_axis=sequence_parallel_axis,
            )
            for i in range(num_layers)
        ])

        def mixer():
            if mixer_type == "AlphaBlender":
                return AlphaBlender(merge_factor, merge_strategy)
            return Mixer(dim)

        def branch():
            return VTSelfAttentionBlock(
                dim, num_attention_heads, attention_head_dim,
                qk_norm=qk_norm_on_additional_modules, quantized=quantized,
            )

        if enable_crossview:
            ids = self.crossview_block_layers
            self.crossview_transformer_blocks = nn.ModuleList(
                [branch() for _ in ids])
            self.view_pos_embeds = nn.ModuleList(
                [TimestepEmbedding(dim, dim * 4, dim) for _ in ids])
            self.view_mixers = nn.ModuleList([mixer() for _ in ids])
        if enable_temporal:
            ids = self.temporal_block_layers
            self.temporal_transformer_blocks = nn.ModuleList(
                [branch() for _ in ids])
            self.time_pos_embeds = nn.ModuleList(
                [TimestepEmbedding(dim, dim * 4, dim) for _ in ids])
            self.time_mixers = nn.ModuleList([mixer() for _ in ids])
        if condition_image_adapter_config is not None:
            self.condition_image_adapter = ImageAdapter(
                **condition_image_adapter_config)
            # Each stage's feature is added to the joint blocks' tokens
            # (the JAX model fails later, at that addition).
            for i, width in enumerate(self.condition_image_adapter.channels):
                if width != dim:
                    raise ValueError(
                        f"ImageAdapter stage {i} is {width} wide, but the "
                        f"DiT's tokens are num_attention_heads x "
                        f"attention_head_dim = {num_attention_heads} x "
                        f"{attention_head_dim} = {dim} wide")
        else:
            self.condition_image_adapter = None
        self.mask_module = None if mask_module_config is None else \
            MaskController(hidden_size=dim, num_heads=num_attention_heads,
                           attention_head_dim=attention_head_dim,
                           **mask_module_config)
        self.norm_out = Modulation(dim, 2)
        self.proj_out = Linear(dim, patch_size * patch_size * out_channels)
        self.to(param_dtype or dtype)
        self._dtype = dtype
        set_compute_dtype(self, dtype)

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype."""
        return self._dtype

    def fsdp_units(self) -> list:
        """The blocks FSDP shards as units of their own
        (``parallel.sharding.shard_model``): the joint and branch blocks."""
        units = list(self.transformer_blocks)
        for name in ("crossview_transformer_blocks",
                     "temporal_transformer_blocks"):
            units += list(getattr(self, name, []))
        return units

    def _remat(self, module: nn.Module, flag: bool):
        """``module``, or a call of it rematerialised in the backward."""
        if not flag:
            return module
        return functools.partial(checkpointed, module,
                                 saved_ops=self.remat_saved_ops)

    def _remat_block(self, i: int) -> bool:
        """Joint block ``i`` is rematerialised (``mmdit.py:508-511``)."""
        return self.gradient_checkpointing and (
            self.remat_block_layers is None or i in self.remat_block_layers)

    def set_view_embedding_width(self, width: int) -> None:
        """Rebuild ``view_embedding`` for ``width`` input features.

        The JAX model sizes it from the ``added_time_ids`` it is fed (256
        features per id), not from ``projection_class_embeddings_input_dim``;
        the pipeline calls this with the width its conditions produce."""
        old = self.view_embedding
        if old.linear_1.in_features != width:
            new = TimestepEmbedding(width, self.inner_dim)
            set_compute_dtype(new, self.dtype)
            self.view_embedding = new.to(device=old.linear_1.weight.device,
                                         dtype=old.linear_1.weight.dtype)

    def forward(
        self,
        sample: torch.Tensor,
        timestep: torch.Tensor,
        encoder_hidden_states: torch.Tensor,
        pooled_projections: torch.Tensor,
        condition_image_tensor: Optional[torch.Tensor] = None,
        added_time_ids: Optional[torch.Tensor] = None,
        camera_intrinsics_norm: Optional[torch.Tensor] = None,
        camera2referego: Optional[torch.Tensor] = None,
        disable_crossview: Optional[torch.Tensor] = None,
        disable_temporal: Optional[torch.Tensor] = None,
        crossview_attention_mask: Optional[torch.Tensor] = None,
        crossview_attention_index: Optional[torch.Tensor] = None,
        mask_noise: Optional[torch.Tensor] = None,
        **_unused,
    ) -> torch.Tensor:
        squeeze_view = sample.ndim == 5
        if squeeze_view:  # single-view input (b, t, h, w, c)
            sample, timestep = sample[:, :, None], timestep[:, :, None]
            if encoder_hidden_states.ndim == 4:
                encoder_hidden_states = encoder_hidden_states[:, :, None]
            if pooled_projections.ndim == 3:
                pooled_projections = pooled_projections[:, :, None]
            if added_time_ids is not None and added_time_ids.ndim == 3:
                added_time_ids = added_time_ids[:, :, None]
            if condition_image_tensor is not None and \
                    condition_image_tensor.ndim == 5:
                condition_image_tensor = condition_image_tensor[:, :, None]

        b, t, v, hh, ww, _ = sample.shape
        p = self.patch_size
        gh, gw = hh // p, ww // p
        n = b * t * v
        dim = self.inner_dim
        dt = self.dtype

        x = self.pos_embed(sample.reshape(n, hh, ww, -1).to(dt))
        ctx = self.context_embedder(
            encoder_hidden_states.reshape(n, *encoder_hidden_states.shape[3:])
            .to(dt)
        )
        temb = self.time_text_embed(
            timestep.reshape(-1), pooled_projections.reshape(n, -1).to(dt)
        )

        view_cam_emb = None
        if self.perspective_modeling_type == "implicit":
            if added_time_ids is None:
                raise ValueError("implicit perspective needs added_time_ids")
            feats = timestep_embedding(added_time_ids.reshape(-1), 256)
            view_cam_emb = self.view_embedding(
                feats.reshape(n, -1).to(dt))[:, None, :]
        elif self.perspective_modeling_type == "explicit":
            view_cam_emb = self._ray_embedding(
                camera_intrinsics_norm, camera2referego, n, gh, gw)

        # Each adapter feature (b, t, v, gh, gw, dim) → tokens, added before
        # joint block i (``mmdit.py:414-425``, ``:505-506``).
        residuals = []
        if self.condition_image_adapter is not None and \
                condition_image_tensor is not None:
            residuals = [
                f.reshape(n, -1, f.shape[-1])
                for f in self.condition_image_adapter(
                    condition_image_tensor.to(dt))]

        if disable_crossview is None:
            disable_crossview = torch.zeros(b, dtype=torch.bool,
                                            device=x.device)
        if disable_temporal is None:
            disable_temporal = torch.zeros(b, dtype=torch.bool,
                                           device=x.device)
        # MaskGWM: drop tokens before the blocks, grouped by (b, v) with t
        # as the frame axis; the adapter residuals are gathered alike
        # (``mmdit.py:432-469``).
        cur_gw, metas = gw, None
        if self.mask_module is not None and mask_noise is not None:
            x, metas, residuals = self.mask_module.random_masking(
                mask_noise, _by_view(x, b, t, v), gh, gw,
                [_by_view(r, b, t, v) for r in residuals])
            keep = x.shape[2]
            x = _by_frame(x, b, v)
            residuals = [_by_frame(r, b, v) for r in residuals]
            cur_gw = keep // gh

        for i, block in enumerate(self.transformer_blocks):
            if metas is not None and self.mask_module.is_first_decoder_layer(
                    i, self.num_layers):
                temb_g = temb.reshape(b, t, v, -1).transpose(1, 2)
                x = self.mask_module.mask_reconstruction(
                    _by_view(x, b, t, v), metas, temb_g.reshape(b * v * t, -1))
                # fp32 from here under a bf16 compute dtype, as in JAX:
                # the mask token is read in fp32 and each residual add
                # promotes (the joint block casts its branch outputs to
                # x's dtype for K4).
                x, cur_gw = _by_frame(x, b, v), gw
            shape = (b, t, v, gh, cur_gw, dim)
            if i < len(residuals):
                x = x + residuals[i]
            x, ctx = self._remat(block, self._remat_block(i))(
                x.contiguous(), ctx, temb)

            if self.enable_temporal and i in self.temporal_block_layers:
                j = self.temporal_block_layers.index(i)
                seq_idx = torch.arange(t, dtype=torch.float32,
                                       device=x.device)
                seq_idx = seq_idx[None, :, None].expand(b, t, v).reshape(-1)
                seq_emb = self.time_pos_embeds[j](
                    timestep_embedding(seq_idx, dim).to(dt))[:, None, :]
                if (
                    self.enable_crossview
                    and not self.disable_view_emb_on_temporal_module
                    and view_cam_emb is not None
                ):
                    seq_emb = seq_emb + view_cam_emb
                x = self._temporal_branch(
                    self._remat(self.temporal_transformer_blocks[j],
                                self.temporal_gradient_checkpointing),
                    self.time_mixers[j],
                    x, seq_emb, shape, disable_temporal,
                )

            if self.enable_crossview and i in self.crossview_block_layers:
                j = self.crossview_block_layers.index(i)
                view_idx = torch.arange(v, dtype=torch.float32,
                                        device=x.device)
                view_idx = view_idx[None, None, :].expand(b, t, v).reshape(-1)
                view_emb = self.view_pos_embeds[j](
                    timestep_embedding(view_idx, dim).to(dt))[:, None, :]
                if view_cam_emb is not None:
                    view_emb = view_emb + view_cam_emb
                x = self._crossview_branch(
                    self._remat(self.crossview_transformer_blocks[j],
                                self.crossview_gradient_checkpointing),
                    self.view_mixers[j],
                    x, view_emb, shape, disable_crossview,
                    crossview_attention_mask, crossview_attention_index,
                )

        scale, shift = self.norm_out(temb)  # AdaLayerNormContinuous order
        x = adaln_modulate(x.contiguous(), scale, shift)
        x = self.proj_out(x)
        x = x.reshape(n, gh, gw, p, p, self.out_channels)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, t, v, hh, ww, -1)
        return x[:, :, 0] if squeeze_view else x

    def _ray_embedding(self, intrinsics_norm, cam2ref, n: int, gh: int,
                       gw: int) -> torch.Tensor:
        """Explicit perspective (``mmdit.py:393-412``): the normalised
        intrinsics at the latent grid's scale, a ray per token, octave
        features of its origin and direction, ``rayencoder_proj`` → the
        per-token view embedding (n, gh·gw, dim)."""
        if intrinsics_norm is None or cam2ref is None:
            raise ValueError("explicit perspective needs "
                             "camera_intrinsics_norm and camera2referego")
        scale = torch.tensor([[gw, 1, gw], [1, gh, gh], [1, 1, 1]],
                             dtype=torch.float32, device=cam2ref.device)
        k = intrinsics_norm.reshape(n, 3, 3).float() * scale
        rays_o, rays_d = get_rays(k, cam2ref.reshape(n, 4, 4), (gh, gw))
        pos = octave_encode(rays_o, RAY_POS_OCTAVES)[:, None, None]
        ray = octave_encode(rays_d, RAY_DIR_OCTAVES)
        raymap = torch.cat([pos.expand(n, gh, gw, pos.shape[-1]), ray], -1)
        return self.rayencoder_proj(raymap.to(self.dtype)).reshape(
            n, gh * gw, -1)

    def _temporal_branch(self, block, mixer, x, emb, shape, disable):
        """``pointwise``: each spatial token attends over the t frames;
        ``rowwise``: each latent row attends over its t frames' rows
        (sequences of t·gw tokens, ``mmdit.py:606-610``); ``full``: all
        t·gh·gw tokens of a view at once."""
        b, t, v, gh, gw, c = shape
        l = gh * gw
        if self.temporal_attention_type == "full":
            h = (x + emb).reshape(b, t, v, l, c).transpose(1, 2)
            h = block(h.reshape(b * v, t * l, c))
            h = h.reshape(b, v, t, l, c).transpose(1, 2)
        elif self.temporal_attention_type == "rowwise":
            h = (x + emb).reshape(b, t, v, gh, gw, c)
            h = block(h.permute(0, 2, 3, 1, 4, 5).reshape(b * v * gh, t * gw,
                                                         c))
            h = h.reshape(b, v, gh, t, gw, c).permute(0, 3, 1, 2, 4, 5)
        else:
            h = (x + emb).reshape(b, t, v, l, c).permute(0, 2, 3, 1, 4)
            h = block(h.reshape(b * v * l, t, c))
            h = h.reshape(b, v, l, t, c).permute(0, 3, 1, 2, 4)
        h = h.reshape(b, t * v, l, c)
        out = mixer(x.reshape(b, t * v, l, c), h, image_only_indicator=disable)
        return out.reshape(b * t * v, l, c)

    def _crossview_branch(self, block, mixer, x, emb, shape, disable, mask,
                          neighbor_index=None):
        """``rowwise``: each latent row attends across the v views;
        ``full``: every token of a frame's v views at once; ``fuse``: each
        view over its 3-view neighbourhood (``neighbor_index``, default
        v - 1, v, v + 1 around the ring) in all t frames jointly; ``adj_fuse``:
        the neighbourhood in this frame and the one before. ``fuse`` and
        ``adj_fuse`` keep the centre view (of this frame) of each sequence
        (``mmdit.py:625-685``)."""
        b, t, v, gh, gw, c = shape
        l = gh * gw
        kind = self.crossview_attention_type
        h = x + emb
        if kind in ("rowwise", "full"):
            h = h.reshape(b * t, v, gh, gw, c).transpose(1, 2)
            rows = b * t * gh if kind == "rowwise" else b * t
            h = block(h.reshape(rows, -1, c), mask=mask)
            h = h.reshape(b * t, gh, v, gw, c).transpose(1, 2)
        else:
            if neighbor_index is None:
                vs = torch.arange(v, device=x.device)
                neighbor_index = torch.stack([(vs - 1) % v, vs,
                                              (vs + 1) % v], 1)
            g = h.reshape(b, t, v, l, c).index_select(
                2, neighbor_index.reshape(-1).to(x.device))
            g = g.reshape(b, t, v, 3, l, c)
            if kind == "fuse":
                g = block(g.transpose(1, 2).reshape(b * v, t * 3 * l, c),
                          mask=mask)
                h = g.reshape(b, v, t, 3, l, c)[:, :, :, 1].transpose(1, 2)
            else:
                prev = torch.cat([g[:, :1], g[:, :-1]], 1)
                pair = torch.stack([prev, g], 2)  # (b, t, 2, v, 3, l, c)
                g = block(pair.transpose(2, 3).reshape(b * t * v, 6 * l, c),
                          mask=mask)
                h = g.reshape(b, t, v, 2, 3, l, c)[:, :, :, 1, 1]
        h = h.reshape(b, t * v, l, c)
        out = mixer(x.reshape(b, t * v, l, c), h,
                    image_only_indicator=disable)
        return out.reshape(b * t * v, l, c)


def _by_view(x: torch.Tensor, b: int, t: int, v: int) -> torch.Tensor:
    """Tokens (b·t·v, l, c) → (b·v, t, l, c): MaskGWM groups by view."""
    return x.reshape(b, t, v, *x.shape[1:]).transpose(1, 2).reshape(
        b * v, t, *x.shape[1:])


def _by_frame(x: torch.Tensor, b: int, v: int) -> torch.Tensor:
    """(b·v, t, l, c) → (b·t·v, l, c), the inverse of ``_by_view``."""
    t = x.shape[1]
    return x.reshape(b, v, *x.shape[1:]).transpose(1, 2).reshape(
        b * t * v, *x.shape[2:])
