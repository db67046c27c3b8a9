"""The stage-sliced flagship DiT for pipeline parallelism
(``opendwm_tpu/parallel/dit_pipeline.py``).

The GPipe schedule (``parallel/pipeline.py``) streams microbatches through
stages that share one structure, so every layer of a stage carries the
flagship's maximal structure: an SD3.5 joint block with the dual
attention, a pointwise-temporal branch and a rowwise-crossview branch,
each mixed back by an AlphaBlender. The published pattern (dual attention
on the first 13 layers, crossview on {1, 5, 9, ...}, temporal on
{2, 3, 6, 7, ...}) is applied through per-layer gates carried in the
stacked stage parameters:

- a {0, 1} gate selects the joint block with or without the dual
  attention's residual (JAX multiplies that residual by the gate; the
  selection gives the DiT's own bits in either form, in bf16 too);
- the branches' AlphaBlender takes ``image_only_indicator`` = not gated on
  (alpha = 1: a bit-exact passthrough).

The carry between stages is one array, the latent tokens and the context
tokens concatenated. Embeddings (patchify, the time/text embedding, the
implicit view embedding) and the output head run replicated, off the
DiT's own modules (``pipelined_dit_forward``); the joint attention may run
as a ring over a ``tp`` axis inside the stages (``sp_axis``). The joint
blocks modulate with the fused AdaLN kernels (K3/K4) as the DiT's do.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from opendwm_tpu_torch.models.layers import (
    AlphaBlender,
    Attention,
    FeedForward,
    TimestepEmbedding,
    VTSelfAttentionBlock,
    set_compute_dtype,
    timestep_embedding,
)
from opendwm_tpu_torch.models.mmdit import Modulation
from opendwm_tpu_torch.ops.fused_adaln import (
    adaln_modulate,
    residual_adaln_modulate,
)
from opendwm_tpu_torch.parallel.mesh import bind_sequence_parallel
from opendwm_tpu_torch.parallel.pipeline import (
    pipeline_apply,
    stack_stage_params,
    stage_slice,
)

FLAGSHIP_DUAL = tuple(range(13))
FLAGSHIP_CROSSVIEW = (1, 5, 9, 13, 17, 21)
FLAGSHIP_TEMPORAL = (2, 3, 6, 7, 10, 11, 14, 15, 18, 19, 22, 23)


class GatedJointBlock(nn.Module):
    """The SD3.5 joint block with the dual attention always present, so
    every layer shares one structure; ``gate`` (0 or 1) selects the joint
    block's own two forms: 1 adds the dual attention's residual after the
    attention's, as the DiT's dual layers do; 0 leaves it out, the
    attention's residual fused with the MLP's modulation (K4), as the DiT's
    other layers do, so either form gives the DiT's bits. Its context stream
    always has outputs."""

    def __init__(self, heads: int, head_dim: int,
                 qk_norm: Optional[str] = "rms_norm",
                 sp_axis: Optional[str] = None):
        super().__init__()
        dim = heads * head_dim
        self.norm1 = Modulation(dim, 9)
        self.norm1_context = Modulation(dim, 6)
        self.attn = Attention(dim, heads, head_dim, qk_norm=qk_norm,
                              joint=True, sp_axis=sp_axis)
        self.attn2 = Attention(dim, heads, head_dim, qk_norm=qk_norm)
        self.ff = FeedForward(dim, activation="gelu-approximate")
        self.ff_context = FeedForward(dim, activation="gelu-approximate")

    def forward(self, x, ctx, temb, gate):
        (shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp,
         shift2, scale2, gate2) = self.norm1(temb)
        (c_shift_msa, c_scale_msa, c_gate_msa, c_shift_mlp, c_scale_mlp,
         c_gate_mlp) = self.norm1_context(temb)
        norm_x = adaln_modulate(x, scale_msa, shift_msa)
        norm_x2 = adaln_modulate(x, scale2, shift2)
        norm_ctx = adaln_modulate(ctx, c_scale_msa, c_shift_msa)
        attn_out, ctx_attn = self.attn(norm_x, norm_ctx)
        x_dual, norm_dual = residual_adaln_modulate(
            x + gate_msa[:, None] * attn_out,
            self.attn2(norm_x2).to(x.dtype), gate2, scale_mlp, shift_mlp)
        x_one, norm_one = residual_adaln_modulate(
            x, attn_out.to(x.dtype), gate_msa, scale_mlp, shift_mlp)
        dual = gate > 0
        x = torch.where(dual, x_dual, x_one)
        norm_x = torch.where(dual, norm_dual, norm_one)
        x = x + gate_mlp[:, None] * self.ff(norm_x)
        ctx, norm_ctx = residual_adaln_modulate(
            ctx, ctx_attn, c_gate_msa, c_scale_mlp, c_shift_mlp)
        ctx = ctx + c_gate_mlp[:, None] * self.ff_context(norm_ctx)
        return x, ctx


class FlagshipStage(nn.Module):
    """``layers_per_stage`` maximal flagship layers. The carry ``h`` is
    (n, gh * gw + ctx_len, dim), latent tokens then context tokens;
    ``temb`` and ``cam_emb`` (the implicit view embedding, zeros without
    one) are (n, dim); the gates are (layers_per_stage,) arrays: ``dual``
    0/1 floats, ``crossview`` / ``temporal`` bools."""

    def __init__(self, heads: int, head_dim: int, layers_per_stage: int,
                 ctx_len: int, t: int, v: int, gh: int, gw: int,
                 qk_norm: Optional[str] = "rms_norm",
                 qk_norm_additional: Optional[str] = "rms_norm",
                 dtype: torch.dtype = torch.float32,
                 sp_axis: Optional[str] = None):
        super().__init__()
        dim = heads * head_dim
        self.dim, self.layers_per_stage, self.ctx_len = \
            dim, layers_per_stage, ctx_len
        self.t, self.v, self.gh, self.gw = t, v, gh, gw
        self.compute_dtype = dtype
        for i in range(layers_per_stage):
            setattr(self, f"joint_{i}", GatedJointBlock(
                heads, head_dim, qk_norm=qk_norm, sp_axis=sp_axis))
            for kind in ("time", "view"):
                setattr(self, f"{kind}_pos_embed_{i}",
                        TimestepEmbedding(dim, dim * 4, dim))
                setattr(self, f"{kind}_mixer_{i}", AlphaBlender(2.0))
            for kind in ("temporal", "crossview"):
                setattr(self, f"{kind}_{i}", VTSelfAttentionBlock(
                    dim, heads, head_dim, qk_norm=qk_norm_additional))
        set_compute_dtype(self, dtype)

    def _pos(self, embed, idx, cam_emb):
        emb = embed(timestep_embedding(idx, self.dim).to(self.compute_dtype))
        return emb[:, None, :] + cam_emb[:, None, :]

    def forward(self, h, temb, cam_emb, dual_gate, crossview_on,
                temporal_on):
        n, dim = h.shape[0], self.dim
        t, v, gh, gw = self.t, self.v, self.gh, self.gw
        b, l = n // (t * v), gh * gw
        lx = h.shape[1] - self.ctx_len
        x, ctx = h[:, :lx].contiguous(), h[:, lx:].contiguous()
        dev = h.device
        seq_idx = torch.arange(t, dtype=torch.float32, device=dev)[
            None, :, None].expand(b, t, v).reshape(-1)
        view_idx = torch.arange(v, dtype=torch.float32, device=dev)[
            None, None, :].expand(b, t, v).reshape(-1)
        for i in range(self.layers_per_stage):
            x, ctx = getattr(self, f"joint_{i}")(x, ctx, temb, dual_gate[i])
            # pointwise temporal: each token attends over the t frames
            emb = self._pos(getattr(self, f"time_pos_embed_{i}"), seq_idx,
                            cam_emb)
            tp = (x + emb).reshape(b, t, v, l, dim).permute(0, 2, 3, 1, 4)
            tp = getattr(self, f"temporal_{i}")(tp.reshape(b * v * l, t, dim))
            tp = tp.reshape(b, v, l, t, dim).permute(0, 3, 1, 2, 4)
            x = getattr(self, f"time_mixer_{i}")(
                x.reshape(b, t * v, l, dim), tp.reshape(b, t * v, l, dim),
                image_only_indicator=(~temporal_on[i]).expand(b),
            ).reshape(n, l, dim)
            # rowwise crossview: each latent row attends across the views
            emb = self._pos(getattr(self, f"view_pos_embed_{i}"), view_idx,
                            cam_emb)
            cv = (x + emb).reshape(b * t, v, gh, gw, dim).transpose(1, 2)
            cv = getattr(self, f"crossview_{i}")(
                cv.reshape(b * t * gh, v * gw, dim))
            cv = cv.reshape(b * t, gh, v, gw, dim).transpose(1, 2)
            x = getattr(self, f"view_mixer_{i}")(
                x.reshape(b, t * v, l, dim), cv.reshape(b, t * v, l, dim),
                image_only_indicator=(~crossview_on[i]).expand(b),
            ).reshape(n, l, dim)
        return torch.cat([x, ctx], dim=1)


def _stage_gates(s: int, lps: int, dual, crossview, temporal, device=None):
    ids = range(s * lps, (s + 1) * lps)
    return {
        "dual": torch.tensor([1.0 if i in dual else 0.0 for i in ids],
                             device=device),
        "crossview": torch.tensor([i in crossview for i in ids],
                                  device=device),
        "temporal": torch.tensor([i in temporal for i in ids],
                                 device=device),
    }


def build_flagship_stages(generator: torch.Generator, *, n_stages: int,
                          num_layers: int = 24, heads: int = 24,
                          head_dim: int = 64, ctx_len: int = 154, t: int = 6,
                          v: int = 6, gh: int = 16, gw: int = 28,
                          batch: int = 1, dual_layers=FLAGSHIP_DUAL,
                          crossview_layers=FLAGSHIP_CROSSVIEW,
                          temporal_layers=FLAGSHIP_TEMPORAL,
                          dtype: torch.dtype = torch.float32,
                          sp_axis: Optional[str] = None, device=None):
    """(stage module, stacked params, (h0, temb0)): per-stage parameters of
    the flagship pattern drawn from ``generator`` (torch's default
    initialisers), stacked, with their gates, and example inputs."""
    if num_layers % n_stages:
        raise ValueError(f"{num_layers} layers do not split into "
                         f"{n_stages} stages")
    lps = num_layers // n_stages
    dim = heads * head_dim
    kw = dict(heads=heads, head_dim=head_dim, layers_per_stage=lps,
              ctx_len=ctx_len, t=t, v=v, gh=gh, gw=gw, dtype=dtype)
    stage = FlagshipStage(**kw, sp_axis=sp_axis).to(device)
    per_stage = []
    for s in range(n_stages):
        module = FlagshipStage(**kw)
        with torch.no_grad():
            for p in module.parameters():
                p.copy_(torch.randn(p.shape, generator=generator,
                                    device=generator.device)
                        * (0.02 if p.ndim > 1 else 0.1))
        per_stage.append({
            "params": {k: p.detach().to(device)
                       for k, p in module.state_dict().items()},
            "gates": _stage_gates(s, lps, dual_layers, crossview_layers,
                                  temporal_layers, device)})
    n = batch * t * v
    h0 = torch.randn(n, gh * gw + ctx_len, dim, generator=generator,
                     device=generator.device).to(device=device, dtype=dtype)
    temb0 = torch.randn(n, dim, generator=generator,
                        device=generator.device).to(device=device,
                                                    dtype=dtype)
    return stage, stack_stage_params(per_stage), (h0, temb0)


def flagship_stage_fn(stage: FlagshipStage):
    """``(stage params, h, temb, cam_emb) -> h`` for ``pipeline_apply``."""

    def block_fn(stage_params, h, temb, cam_emb):
        g = stage_params["gates"]
        return torch.func.functional_call(
            stage, stage_params["params"],
            (h, temb, cam_emb, g["dual"], g["crossview"], g["temporal"]))

    return block_fn


def _zeros_cam(h):
    return torch.zeros(h.shape[0], h.shape[-1], dtype=h.dtype,
                       device=h.device)


def flagship_sequential_apply(stage, stacked_params, h, temb, cam_emb=None):
    """The reference: the same stages one after another (no pipeline)."""
    n_stages = stacked_params["gates"]["dual"].shape[0]
    cam_emb = _zeros_cam(h) if cam_emb is None else cam_emb
    fn = flagship_stage_fn(stage)
    for s in range(n_stages):
        h = fn(stage_slice(stacked_params, s), h, temb, cam_emb)
    return h


def flagship_pipeline_apply(stage, stacked_params, h, temb, mesh, *,
                            microbatches: int, axis: str = "pp",
                            batch_axis: Optional[str] = None, cam_emb=None):
    """GPipe the flagship stages over ``mesh``'s ``pp`` axis (data parallel
    over ``batch_axis`` where given; the stage's ``sp_axis`` rings the
    joint attention over ``mesh``)."""
    cam_emb = _zeros_cam(h) if cam_emb is None else cam_emb
    bind_sequence_parallel(stage, mesh)
    return pipeline_apply(flagship_stage_fn(stage), stacked_params, h, mesh,
                          axis=axis, microbatches=microbatches,
                          conds=(temb, cam_emb), batch_axis=batch_axis)


# ---------------------------------------------------------------------------
# The real model: a DiTCrossviewTemporal's state dict as stacked stages, and
# its forward with the layer stack pipelined
# ---------------------------------------------------------------------------


def make_flagship_stage(model, *, n_stages: int, t: int, v: int, gh: int,
                        gw: int, ctx_len: int,
                        sp_axis: Optional[str] = None) -> FlagshipStage:
    """The stage module matching a ``DiTCrossviewTemporal``'s config,
    computing in its dtype, its parameters on the meta device: the stage
    runs on stacked parameters (``flagship_stage_fn``), which replace them
    all."""
    if model.num_layers % n_stages:
        raise ValueError(f"{model.num_layers} layers do not split into "
                         f"{n_stages} stages")
    attn = model.transformer_blocks[0].attn
    qk = "rms_norm" if hasattr(attn, "norm_q") else None
    branch = _branch_block(model)
    qk_add = "rms_norm" if branch is not None and \
        hasattr(branch.attn1, "norm_q") else None
    with torch.device("meta"):
        return FlagshipStage(
            heads=attn.heads, head_dim=attn.head_dim,
            layers_per_stage=model.num_layers // n_stages, ctx_len=ctx_len,
            t=t, v=v, gh=gh, gw=gw, qk_norm=qk, qk_norm_additional=qk_add,
            dtype=model.dtype, sp_axis=sp_axis,
        ).to(dtype=model.proj_out.weight.dtype)


def _branch_block(model):
    for kind in ("crossview_transformer_blocks",
                 "temporal_transformer_blocks"):
        blocks = getattr(model, kind, None)
        if blocks:
            return blocks[0]
    return None


def _pad_rows(w, want: int):
    """``w`` with zero rows appended up to ``want`` (extra modulation
    chunks feed only gated-off sublayers)."""
    pad = w.new_zeros((want - w.shape[0], *w.shape[1:]))
    return torch.cat([w, pad])


def convert_dit_params_to_stages(model, *, n_stages: int,
                                 state_dict: Optional[dict] = None):
    """A ``DiTCrossviewTemporal``'s state dict (default: its own) → stacked
    ``FlagshipStage`` params and gates. The subset is the flagship serving
    pattern (rowwise crossview, pointwise temporal, AlphaBlender mixers,
    implicit or no perspective, no mask module or adapter). Structural
    fill-ins, each exact under its gate: a non-dual layer's ``norm1``
    padded from 6 to 9 chunks and its ``attn2`` zero; the last layer's
    2-chunk (scale, shift) context modulation remapped into the 6-chunk
    (shift, scale, 0, 0, 0, 0) layout, its ``to_add_out`` and
    ``ff_context`` zero (the context output is discarded); a layer without
    a branch gets zero branch parameters."""
    if model.crossview_attention_type not in (None, "rowwise") or \
            model.temporal_attention_type not in (None, "pointwise") or \
            model.mask_module is not None or \
            model.condition_image_adapter is not None or \
            model.disable_view_emb_on_temporal_module or \
            model.perspective_modeling_type not in ("", "implicit"):
        raise ValueError("convert_dit_params_to_stages takes the flagship "
                         "serving pattern only")
    for kind in ("view_mixers", "time_mixers"):
        for mixer in getattr(model, kind, []):
            if not isinstance(mixer, AlphaBlender):
                raise ValueError("the stages mix with AlphaBlender")
    sd = model.state_dict() if state_dict is None else state_dict
    num_layers, dim = model.num_layers, model.inner_dim
    lps = num_layers // n_stages
    dual = {i for i, blk in enumerate(model.transformer_blocks)
            if blk.dual_attention}
    cv_ids = model.crossview_block_layers if model.enable_crossview else []
    tp_ids = model.temporal_block_layers if model.enable_temporal else []
    template = make_flagship_stage(model, n_stages=n_stages, t=1, v=1, gh=1,
                                   gw=1, ctx_len=1).state_dict()

    def sub(prefix):
        return {k[len(prefix):]: v for k, v in sd.items()
                if k.startswith(prefix)}

    per_stage = []
    for s in range(n_stages):
        tree = {}
        for k in range(lps):
            i = s * lps + k
            joint = sub(f"transformer_blocks.{i}.")
            if i not in dual:
                for leaf in ("weight", "bias"):
                    name = f"norm1.linear.{leaf}"
                    joint[name] = _pad_rows(joint[name], 9 * dim)
            if i == num_layers - 1:
                for leaf in ("weight", "bias"):
                    name = f"norm1_context.linear.{leaf}"
                    w = joint[name]
                    joint[name] = _pad_rows(
                        torch.cat([w[dim:2 * dim], w[:dim]]), 6 * dim)
            for name, value in template.items():
                if name.startswith(f"joint_{k}."):
                    local = name[len(f"joint_{k}."):]
                    if local not in joint:
                        joint[local] = torch.zeros_like(
                            value, device=_device_of(sd))
            tree.update({f"joint_{k}.{n}": w for n, w in joint.items()})
            for ids, parts in (
                (tp_ids, (("time_pos_embed", "time_pos_embeds"),
                          ("temporal", "temporal_transformer_blocks"),
                          ("time_mixer", "time_mixers"))),
                (cv_ids, (("view_pos_embed", "view_pos_embeds"),
                          ("crossview", "crossview_transformer_blocks"),
                          ("view_mixer", "view_mixers"))),
            ):
                for part, src in parts:
                    if i in ids:
                        j = ids.index(i)
                        got = sub(f"{src}.{j}.")
                    else:
                        got = {}
                    for name, value in template.items():
                        if name.startswith(f"{part}_{k}."):
                            local = name[len(f"{part}_{k}."):]
                            tree[name] = got[local] if local in got else \
                                torch.zeros_like(value, device=_device_of(sd))
        unknown = set(tree) - set(template)
        if unknown:
            raise ValueError(f"stage parameters outside the template: "
                             f"{sorted(unknown)}")
        per_stage.append({
            "params": tree,
            "gates": _stage_gates(s, lps, dual, cv_ids, tp_ids,
                                  _device_of(sd))})
    return stack_stage_params(per_stage)


def _device_of(sd):
    return next(iter(sd.values())).device


def pipelined_dit_forward(model, sample, timestep, encoder_hidden_states,
                          pooled_projections, added_time_ids=None, *,
                          n_stages: int, stacked=None, mesh=None,
                          microbatches: int = 1,
                          sp_axis: Optional[str] = None,
                          batch_axis: Optional[str] = None):
    """The whole ``DiTCrossviewTemporal`` forward with the layer stack as
    converted ``FlagshipStage``s: sequential without ``mesh`` (the
    equivalence check), GPipe'd over ``mesh``'s ``pp`` axis with it. The
    embeddings and the output head are the model's own modules."""
    b, t, v, hh, ww, _ = sample.shape
    p = model.patch_size
    gh, gw = hh // p, ww // p
    n = b * t * v
    dt = model.dtype
    x = model.pos_embed(sample.reshape(n, hh, ww, -1).to(dt))
    ctx = model.context_embedder(encoder_hidden_states.reshape(
        n, *encoder_hidden_states.shape[3:]).to(dt))
    temb = model.time_text_embed(timestep.reshape(-1),
                                 pooled_projections.reshape(n, -1).to(dt))
    if model.perspective_modeling_type == "implicit":
        if added_time_ids is None:
            raise ValueError("implicit perspective needs added_time_ids")
        feats = timestep_embedding(added_time_ids.reshape(-1), 256)
        cam_emb = model.view_embedding(feats.reshape(n, -1).to(dt))
    else:
        cam_emb = torch.zeros(n, model.inner_dim, dtype=x.dtype,
                              device=x.device)
    stage = make_flagship_stage(model, n_stages=n_stages, t=t, v=v, gh=gh,
                                gw=gw, ctx_len=ctx.shape[1], sp_axis=sp_axis)
    if stacked is None:
        stacked = convert_dit_params_to_stages(model, n_stages=n_stages)
    h = torch.cat([x, ctx], dim=1)
    if mesh is None:
        h = flagship_sequential_apply(stage, stacked, h, temb, cam_emb)
    else:
        h = flagship_pipeline_apply(stage, stacked, h, temb, mesh,
                                    microbatches=microbatches,
                                    batch_axis=batch_axis, cam_emb=cam_emb)
    scale, shift = model.norm_out(temb)
    x = adaln_modulate(h[:, :gh * gw].contiguous(), scale, shift)
    x = model.proj_out(x)
    x = x.reshape(n, gh, gw, p, p, model.out_channels)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, t, v, hh, ww, -1)
