"""Tiny UniMLVG, DiT branch-type, MaskGWM and temporal-VAE paths on a
device against the same paths on the CPU, and the seeded camera rig that
``chip_smoke.py`` also gives its full-width UniMLVG phases.

Each ``*_gaps`` function builds a tiny fp32 model on the CPU from a seed,
copies it to ``dev`` and runs both on the same inputs and draws (made on
the CPU). It returns a dict whose ``*_rel`` keys are relative norms
``||dev - cpu|| / ||cpu||`` and whose ``*_launches`` keys count the
kernels of the device run. ``chip_smoke.py`` gates its new phases on them
before it runs them at full width, and ``tests/test_torch_unimlvg_cuda.py``
asserts the same on the card.

- ``unimlvg_gaps``: the stage-3 options (explicit perspective and view
  modeling, the adapter, ``pred`` with 3 visible frames) at 16 x 24
  latents and 40 text tokens, so the joint attention (136 tokens) reaches
  K1: a 2-step CFG inference and a 2-window rollout on given noise;
- ``branch_gaps``: a DiT whose cross-view type is ``full``, ``fuse`` or
  ``adj_fuse``, or whose temporal type is ``full``, at 16 x 16 latents
  over 2 views and 2 frames, so each branch's sequences (128 or 384
  tokens) reach K7;
- ``masked_step_gaps``: a DiT with the MaskGWM module at 32 x 32
  latents, forward and backward on one mask draw, so its joint attention
  reaches K1 and K2 before and after the reconstruction;
- ``vae_gaps``: the temporal VAE's encode and decode (1e-4), and its
  causality on the device.
"""

from __future__ import annotations

import copy
import math

import torch

from opendwm_tpu_torch import ops
from opendwm_tpu_torch.models.mask_layers import draw_mask_noise
from opendwm_tpu_torch.models.mmdit import DiTCrossviewTemporal
from opendwm_tpu_torch.models.temporal_vae import TemporalAutoencoderKL
from opendwm_tpu_torch.perf.measure import max_err, rel_err
from opendwm_tpu_torch.pipelines.unimlvg import UnimlvgPipeline
from opendwm_tpu_torch.schedulers import FlowMatchEulerScheduler

# configs/unimlvg/ctsd_unimlvg_stage3_tirda_bm_nwa.json's options at tiny
# widths: 3 joint blocks of 2 x 16 heads, the first dual; one rowwise
# cross-view and one pointwise temporal branch; a 2-stage adapter of the
# joint width down-sampling rasters at 2x the latents
TINY_DIT = dict(
    patch_size=2, num_layers=3, attention_head_dim=16, num_attention_heads=2,
    in_channels=16, out_channels=16, joint_attention_dim=24,
    caption_projection_dim=32, pooled_projection_dim=16,
    pos_embed_max_size=16, sample_size=8, dual_attention_layers=(0,),
    enable_crossview=True, crossview_attention_type="rowwise",
    crossview_block_layers=(1,), enable_temporal=True,
    temporal_attention_type="pointwise", temporal_block_layers=(2,),
    qk_norm_on_additional_modules="rms_norm",
    perspective_modeling_type="explicit",
    condition_image_adapter_config=dict(
        in_channels=6, channels=[32, 32], is_downblocks=[True, False],
        num_res_blocks=1, downscale_factor=2, use_zero_convs=True))
COMMON = {"explicit_view_modeling": True, "ar_input_type": "pred",
          "visible_frame": 3, "reference_timesteps": 0,
          "uncondition_image_color": 0.1255}
TRAINING = {"text_prompt_condition_ratio": 0.8, "3dbox_condition_ratio": 0.8,
            "hdmap_condition_ratio": 0.8, "video_gen_ratio": 0.2,
            "image_pred_ratio": 0.2, "precondition_outputs": True,
            "max_norm_for_grad_clip": 1.0}
# 4 frames x 2 views of 16 x 24 latents (96 tokens) and 40 text tokens
FRAMES, VIEWS, LATENT, TEXT = 4, 2, (16, 24), 40
# the branch types: 2 frames x 2 views of 16 x 16 latents (64 tokens)
BRANCH_FRAMES, BRANCH_VIEWS, BRANCH_LATENT = 2, 2, (16, 16)
# the masked step's 32 x 32 latents: 256 tokens a view-frame, 192 kept, so
# with 8 text tokens the joint attention (200, then 264) reaches K1 and K2
MASK_LATENT = (32, 32)
BRANCH_TYPES = {"crossview_full": dict(crossview_attention_type="full"),
                "crossview_fuse": dict(crossview_attention_type="fuse"),
                "crossview_adj_fuse": dict(
                    crossview_attention_type="adj_fuse"),
                "temporal_full": dict(temporal_attention_type="full")}
VAE = dict(block_out_channels=(8, 16, 16, 32), latent_channels=4,
           layers_per_block=1)


def camera_rig(g: torch.Generator, b: int, t: int, v: int,
               image_hw: tuple[int, int], device=None) -> dict:
    """Seeded cameras of a ``v``-camera ring on an ego car: invertible
    intrinsics (focal lengths 0.7-0.9 of the image width), extrinsics
    360°/v apart (each yaw jittered by 0.05 rad, 1.5 m out, 1.6 m up) and
    ego poses 0.5 m further forward each frame (jittered by 0.05 m);
    ``image_size`` (b, 1, v, 2) as (w, h): not a time-indexed key, so one
    frame serves every window of a rollout."""
    h_img, w_img = image_hw

    def rand(*s):
        return torch.rand(s, generator=g, device=device)

    intr = torch.zeros(b, t, v, 3, 3, device=device)
    intr[..., 0, 0] = (0.7 + 0.2 * rand(b, t, v)) * w_img
    intr[..., 1, 1] = intr[..., 0, 0] * (1 + 0.02 * (rand(b, t, v) - 0.5))
    intr[..., 0, 2], intr[..., 1, 2], intr[..., 2, 2] = \
        w_img / 2, h_img / 2, 1.0
    yaw = torch.arange(v, device=device) * (2 * math.pi / v) + \
        0.05 * (2 * rand(v) - 1)
    cam = torch.eye(4, device=device).repeat(b, t, v, 1, 1)
    cam[..., 0, 0], cam[..., 0, 1] = yaw.cos(), -yaw.sin()
    cam[..., 1, 0], cam[..., 1, 1] = yaw.sin(), yaw.cos()
    cam[..., 0, 3], cam[..., 1, 3] = 1.5 * yaw.cos(), 1.5 * yaw.sin()
    cam[..., 2, 3] = 1.6
    ego = torch.eye(4, device=device).repeat(b, t, v, 1, 1)
    forward = 0.5 * torch.arange(t, device=device)[None, :] + \
        0.05 * (2 * rand(b, t) - 1)
    ego[..., 0, 3] = forward[..., None]
    size = torch.tensor([float(w_img), float(h_img)], device=device)
    return {"camera_intrinsics": intr, "camera_transforms": cam,
            "ego_transforms": ego,
            "image_size": size.expand(b, 1, v, 2).contiguous()}


def tiny_pipeline(seed: int = 0, **model_kw) -> UnimlvgPipeline:
    """A tiny fp32 UniMLVG pipeline on the CPU (``TINY_DIT``, 2 steps with
    CFG 4.0; AdamW lr 5e-5, wd 0.01), its zero convs drawn."""
    torch.manual_seed(seed)
    model = DiTCrossviewTemporal(**TINY_DIT, **model_kw)
    with torch.no_grad():
        for conv in model.condition_image_adapter.zero_convs:
            conv.weight.normal_(0, conv.weight[0].numel() ** -0.5)
    sched = FlowMatchEulerScheduler(shift=3.0)
    return UnimlvgPipeline(
        model, sched, copy.deepcopy(sched), common_config=dict(COMMON),
        training_config=dict(TRAINING),
        inference_config={"inference_steps": 2, "guidance_scale": 4.0},
        optimizer_config={"lr": 5e-5, "weight_decay": 0.01})


def tiny_batch(g: torch.Generator, frames: int = FRAMES) -> dict:
    """One batch of the tiny geometry: latents, text, rasters at 2x the
    latents, cameras."""
    h, w = LATENT
    shape = (1, frames, VIEWS)

    def raster():
        on = torch.rand(*shape, 2 * h, 2 * w, 3, generator=g) < 0.25
        return torch.rand(*shape, 2 * h, 2 * w, 3, generator=g) * on

    return {
        "latents": torch.randn(*shape, h, w, 16, generator=g),
        "encoder_hidden_states": torch.randn(*shape, TEXT, 24, generator=g),
        "pooled_projections": torch.randn(*shape, 16, generator=g),
        "3dbox_images": raster(), "hdmap_images": raster(),
        **camera_rig(g, 1, frames, VIEWS, (8 * h, 8 * w)),
    }


def _on(tree: dict, dev) -> dict:
    return {k: v.to(dev) for k, v in tree.items()}


def unimlvg_gaps(dev, seed: int = 0) -> dict:
    """The tiny UniMLVG pipeline on ``dev`` against the CPU: 2-step CFG
    inference and a 2-window rollout (7 frames, 1 reference frame) on the
    same noise; K1 launches of the device's inference."""
    g = torch.Generator().manual_seed(seed)
    pipe = tiny_pipeline(seed)
    pipe.model.eval()
    dpipe = copy.deepcopy(pipe)
    dpipe.model.to(dev)
    shape = (1, FRAMES, VIEWS, *LATENT, 16)
    batch = tiny_batch(g, 2 * FRAMES - 1)
    window = {k: v[:, :FRAMES] if v.shape[1] > FRAMES else v
              for k, v in batch.items()}
    noise = [torch.randn(shape, generator=g) for _ in range(2)]
    ref = pipe.inference_pipeline(window, shape, noise=noise[0])
    ops.reset_launch_counts()
    out = dpipe.inference_pipeline(_on(window, dev), shape,
                                   noise=noise[0].to(dev))
    k1 = ops.launch_counts()["flash_tail"]
    roll = pipe.autoregressive_inference_pipeline(
        batch, shape, total_frames=2 * FRAMES - 1, noise=noise)
    droll = dpipe.autoregressive_inference_pipeline(
        _on(batch, dev), shape, total_frames=2 * FRAMES - 1,
        noise=[n.to(dev) for n in noise])
    return {"inference_rel": rel_err(out.cpu(), ref),
            "rollout_rel": rel_err(droll.cpu(), roll),
            "inference_k1_launches": k1}


def branch_inputs(g: torch.Generator, latent=BRANCH_LATENT) -> dict:
    """Inputs of the branch-type DiTs (no adapter rasters, no cameras)."""
    shape = (1, BRANCH_FRAMES, BRANCH_VIEWS)
    return {"sample": torch.randn(*shape, *latent, 16, generator=g),
            "timestep": torch.rand(*shape, generator=g) * 1000,
            "encoder_hidden_states": torch.randn(*shape, 8, 24, generator=g),
            "pooled_projections": torch.randn(*shape, 16, generator=g)}


def _branch_dit(seed: int, **kw) -> DiTCrossviewTemporal:
    torch.manual_seed(seed)
    return DiTCrossviewTemporal(**dict(
        TINY_DIT, num_layers=2, dual_attention_layers=(),
        crossview_block_layers=(0,), temporal_block_layers=(1,),
        perspective_modeling_type="", condition_image_adapter_config=None,
        **kw))


def branch_gaps(dev, seed: int = 0) -> dict:
    """Each of ``BRANCH_TYPES`` on ``dev`` against the CPU, and its K7
    launches there (full: 2 views x 64 tokens; fuse: 2 frames x 3 views x
    64; adj_fuse: 2 x 3 x 64; temporal full: 2 frames x 64)."""
    g = torch.Generator().manual_seed(seed)
    inputs = branch_inputs(g)
    out = {}
    for name, kw in BRANCH_TYPES.items():
        model = _branch_dit(seed, **kw).eval()
        dmodel = copy.deepcopy(model).to(dev)
        ops.reset_launch_counts()
        with torch.inference_mode():
            ref = model(**inputs)
            got = dmodel(**_on(inputs, dev))
        out[f"{name}_rel"] = rel_err(got.cpu(), ref)
        out[f"{name}_k7_launches"] = ops.launch_counts()["flash_attention"]
    return out


def masked_step_gaps(dev, seed: int = 0) -> dict:
    """A DiT with the MaskGWM module (decode layer 1 of 2, ratio 0.25) on
    ``dev`` against the CPU on one mask draw: the forward, and the
    gradient of every parameter of ``sum(out * weight)`` (the largest gap
    over the largest gradient of its tensor, or over 1% of the largest of
    all where that is more); and the K1 launches of the device's forward
    and the K2 launches of its backward."""
    g = torch.Generator().manual_seed(seed)
    inputs = branch_inputs(g, MASK_LATENT)
    model = _branch_dit(seed, mask_module_config=dict(decode_layer=1))
    dmodel = copy.deepcopy(model).to(dev)
    b, t, v = inputs["sample"].shape[:3]
    noise = draw_mask_noise(b * v, t, MASK_LATENT[0] * MASK_LATENT[1] // 4,
                            generator=g)
    weight = torch.randn(inputs["sample"].shape, generator=g)
    ref = model(**inputs, mask_noise=noise)
    (ref * weight).sum().backward()
    ops.reset_launch_counts()
    dout = dmodel(**_on(inputs, dev), mask_noise=noise.to(dev))
    k1 = ops.launch_counts()["flash_tail"]
    (dout * weight.to(dev)).sum().backward()
    k2 = ops.launch_counts()["flash_tail_backward"]
    grads = {n: p.grad for n, p in model.named_parameters()}
    top = max(gr.abs().max().item() for gr in grads.values())
    grad = max(max_err(p.grad.cpu(), grads[n]) /
               max(grads[n].abs().max().item(), 1e-2 * top)
               for n, p in dmodel.named_parameters())
    return {"forward_rel": rel_err(dout.detach().cpu(), ref.detach()),
            "grad_rel": grad, "forward_k1_launches": k1,
            "backward_k2_launches": k2}


def vae_gaps(dev, seed: int = 0) -> dict:
    """The tiny temporal VAE on ``dev`` against the CPU: the mean and
    log-variance of 9 frames and their decode; and on ``dev``, the largest
    change of latent frame 0 when the last frame moves (0 if causal)."""
    g = torch.Generator().manual_seed(seed)
    torch.manual_seed(seed)
    vae = TemporalAutoencoderKL(**VAE).eval()
    dvae = copy.deepcopy(vae).to(dev)
    video = torch.randn(2, 9, 32, 32, 3, generator=g)
    later = video.clone()
    later[:, -1] += 10.0
    with torch.inference_mode():
        mean, logvar = vae.encode(video)
        dmean, dlogvar = dvae.encode(video.to(dev))
        dec, ddec = vae.decode(mean), dvae.decode(mean.to(dev))
        dlater, _ = dvae.encode(later.to(dev))
    return {"mean_rel": rel_err(dmean.cpu(), mean),
            "logvar_rel": rel_err(dlogvar.cpu(), logvar),
            "decode_rel": rel_err(ddec.cpu(), dec),
            "causal_gap": max_err(dlater[:, 0], dmean[:, 0])}
