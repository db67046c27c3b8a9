"""Tiny LiDAR training paths and the LiDAR UNet on a device against the same
paths on the CPU.

Each ``*_gaps`` function builds a tiny fp32 pipeline on the CPU from a
seed, copies it to ``dev`` and runs both on the same inputs and draws
(made on the CPU). It returns a dict whose ``*_rel`` keys are relative
norms ``||dev - cpu|| / ||cpu||`` (within 1e-3: ``TOL``), whose
``*_equal`` keys are bit-for-bit agreements and whose ``*_launches`` keys
count the kernels of the device run (``attention_kernels``: those of a
path that should launch none). Gradients are compared as one vector
over every parameter (``grads_rel``): a parameter whose gradient is 0 in
exact arithmetic (an attention's key bias) holds fp32 noise on either
device. ``chip_smoke.py`` gates its LiDAR training phases on them before
it runs them at full width, and ``tests/test_torch_lidar_train_cuda.py``
asserts the same on the card.

- ``codebook_gaps``: a ``LidarCodebook`` step (the DVGO render of 2
  frames, the quantizer, the reservoir filled from given draws) and the
  render's depth alone;
- ``vae_gaps``: a ``LidarVAE`` step on a given posterior noise;
- ``maskgit_train_gaps``: a MaskGIT step (extra embedding, perturbation,
  the layout adapter) on given draws;
- ``dit_train_gaps``: a LiDAR DiT step whose rowwise temporal sequences
  of 144 tokens reach K1 and K2;
- ``unet_gaps``: the LiDAR UNet over a ``VAEPointCloud`` at 16 x 16
  latents (256 tokens: K7 and its backward): encode, a 2-step DDIM
  generation with CFG and a train step.
"""

from __future__ import annotations

import copy

import torch

from opendwm_tpu_torch import ops
from opendwm_tpu_torch.models import vq_point_cloud as vq
from opendwm_tpu_torch.models.maskgit import BidirectionalTransformer
from opendwm_tpu_torch.models.unet import UNetCrossviewTemporal
from opendwm_tpu_torch.models.vae_point_cloud import VAEPointCloud
from opendwm_tpu_torch.ops.voxelize import Voxelizer
from opendwm_tpu_torch.perf import lidar_tiny
from opendwm_tpu_torch.perf.measure import rel_err
from opendwm_tpu_torch.pipelines.ctsd import (
    CTSDPipeline,
    draw_training_randoms,
)
from opendwm_tpu_torch.pipelines.lidar_diffusion import LidarDiffusionPipeline
from opendwm_tpu_torch.pipelines.lidar_maskgit import MaskGITPipeline
from opendwm_tpu_torch.pipelines.lidar_vae import LidarVAE
from opendwm_tpu_torch.pipelines.lidar_vqvae import LidarCodebook
from opendwm_tpu_torch.schedulers import (
    DDIMScheduler,
    DDPMScheduler,
    FlowMatchEulerScheduler,
)

TOL = 1e-3
TRAIN = {"voxel_loss_coef": 1.0, "emb_loss_coef": 1.0, "kl_loss_coef": 1e-3,
         "depth_loss_coef": 0.1, "sdf_loss_coef": 0.1,
         "max_norm_for_grad_clip": 1.0}
RAYS = dict(ray_stepsize=0.25, ray_max_steps=64)
POINTS = 512
# the UNet path: a 128 x 128 x 8 grid into 16 x 16 latents of 8 channels
UNET_VOXELIZER = dict(x_min=-16.0, x_max=16.0, y_min=-16.0, y_max=16.0,
                      step=0.25, z_min=-1.0, z_max=1.0, z_step=0.25)
UNET_ENCODER = dict(img_size=128, patch_size=8, in_chans=8, embed_dim=16,
                    num_heads=2, depth=6, window_size=4)
UNET = dict(in_channels=8, out_channels=8, block_out_channels=[128, 128],
            layers_per_block=1, num_attention_heads=[2, 2],
            cross_attention_dim=16, addition_time_embed_dim=8,
            projection_class_embeddings_input_dim=24,
            enable_rowwise_crossview=True, enable_rowwise_temporal=True,
            merge_factor=2.0, enable_crossview=True, enable_temporal=True,
            gradient_checkpointing=True)
UNET_FRAMES = 2


def _on(tree, dev):
    if isinstance(tree, dict):
        return {k: _on(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_on(v, dev) for v in tree)
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def _points(g, b: int, frames: int, span: float = 10.0) -> dict:
    """Returns past the grid on every axis, the last 32 of a frame masked
    and zeroed (padding)."""
    pts = (torch.rand(b, frames, POINTS, 3, generator=g) - 0.5) * 2 * span
    pts[..., 2] *= 0.12
    mask = torch.ones(b, frames, POINTS, dtype=torch.bool)
    mask[..., -32:] = False
    pts[..., -32:, :] = 0.0
    return {"lidar_points": pts, "lidar_points_mask": mask}


def _grads(module) -> torch.Tensor:
    return torch.cat([p.grad.reshape(-1).float().cpu()
                      for p in module.parameters() if p.grad is not None])


def _params(module) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1).float().cpu()
                      for p in module.parameters()])


def _losses_rel(out: dict, ref: dict) -> dict:
    return {f"{k}_rel": rel_err(out[k].detach().cpu().reshape(1),
                                ref[k].detach().reshape(1))
            for k in ref if torch.is_tensor(ref[k]) and ref[k].ndim == 0
            and float(ref[k].detach()) != 0.0}


def _step_pair(cpu, dev_pipe, run, module_of) -> tuple:
    """(cpu metrics, dev metrics, grads_rel) of ``run(pipe)`` returning
    (loss, metrics), with the gradients of ``module_of(pipe)``."""
    out = {}
    for name, pipe in (("cpu", cpu), ("dev", dev_pipe)):
        module = module_of(pipe)
        module.zero_grad(set_to_none=True)
        loss, metrics = run(pipe)
        loss.backward()
        out[name] = (metrics, _grads(module))
        module.zero_grad(set_to_none=True)
    return out["cpu"][0], out["dev"][0], rel_err(out["dev"][1],
                                                 out["cpu"][1])


def tiny_tokenizer(seed: int = 0, e_dim: int = 16) -> vq.VQPointCloud:
    torch.manual_seed(seed)
    return vq.VQPointCloud(
        Voxelizer(**lidar_tiny.VOXELIZER), vq.VectorQuantizer(64, e_dim),
        vq.VQEncoder(**dict(lidar_tiny.ENCODER, codebook_dim=e_dim)),
        vq.VQDecoder(**dict(lidar_tiny.ENCODER, codebook_dim=e_dim, depth=4,
                            density_feats=4)), bias_init=-2.0, **RAYS)


def codebook_gaps(dev, seed: int = 0) -> dict:
    g = torch.Generator().manual_seed(seed)
    pipe = LidarCodebook(tiny_tokenizer(seed), training_config=TRAIN,
                         optimizer_config={"lr": 5e-4})
    dpipe = copy.deepcopy(pipe)
    dpipe.model.to(dev)
    batch = _points(g, 1, 2)
    dbatch = _on(batch, dev)

    def run(p):
        loss, (metrics, _, _) = p.loss_from_draws(
            dbatch if p is dpipe else batch)
        return loss, metrics

    ops.reset_launch_counts()
    ref, out, grads_rel = _step_pair(pipe, dpipe, run, lambda p: p.model)
    with torch.no_grad():
        vox, z, _, _ = pipe.model.encode(*batch.values())
        density, _ = pipe.model.lidar_decoder(z, density=True)
        depth = pipe.model.render_frames(density, *batch.values())[2]
        dvox, dz, _, _ = dpipe.model.encode(*dbatch.values())
        ddensity, _ = dpipe.model.lidar_decoder(dz, density=True)
        ddepth = dpipe.model.render_frames(ddensity, *dbatch.values())[2]
    states = [p.init_state() for p in (pipe, dpipe)]
    draws = pipe.draw_reservoir(2 * 16, g)
    for p, s, b in ((pipe, states[0], batch), (dpipe, states[1], dbatch)):
        p.train_step(s, b, draws=_on(draws, s.code_age.device))
    counts = ops.launch_counts()
    return {**_losses_rel(out, ref), "grads_rel": grads_rel,
            "voxels_equal": torch.equal(dvox.cpu(), vox),
            "depth_rel": rel_err(ddepth.cpu(), depth),
            "params_rel": rel_err(_params(dpipe.model), _params(pipe.model)),
            "reservoir_rel": rel_err(states[1].reservoir.cpu(),
                                     states[0].reservoir),
            "code_age_equal": torch.equal(states[1].code_age.cpu(),
                                          states[0].code_age),
            "attention_kernels": counts["flash_tail"]
            + counts["flash_attention"]}


def vae_gaps(dev, seed: int = 0) -> dict:
    g = torch.Generator().manual_seed(seed)
    torch.manual_seed(seed)
    latent = 8
    model = VAEPointCloud(
        Voxelizer(**lidar_tiny.VOXELIZER),
        vq.VQEncoder(**dict(lidar_tiny.ENCODER, codebook_dim=2 * latent)),
        vq.VQDecoder(**dict(lidar_tiny.ENCODER, codebook_dim=latent,
                            depth=4, density_feats=4)),
        latent_dim=latent, bias_init=-2.0, **RAYS)
    pipe = LidarVAE(model, training_config=TRAIN,
                    optimizer_config={"lr": 5e-4})
    dpipe = copy.deepcopy(pipe)
    dpipe.model.to(dev)
    batch = _points(g, 1, 2)
    noise = pipe.draw_noise(batch, g)
    ref, out, grads_rel = _step_pair(
        pipe, dpipe,
        lambda p: p.loss_from_draws(*((_on(batch, dev), noise.to(dev))
                                      if p is dpipe else (batch, noise))),
        lambda p: p.model)
    return {**_losses_rel(out, ref), "grads_rel": grads_rel,
            "kl_positive_equal": bool(float(out["kl_loss"].detach()) > 0)}


def maskgit_train_gaps(dev, seed: int = 0) -> dict:
    g = torch.Generator().manual_seed(seed)
    torch.manual_seed(seed)
    model = BidirectionalTransformer(
        64, 16, (4, 4), hidden_dim=32, depth=2, num_heads=2,
        use_extra_embedding=True, enable_perturbation=True,
        perturbation_ratio=0.3, perturbation_topk=5,
        condition_adapter_config=lidar_tiny.ADAPTER)
    pipe = MaskGITPipeline(
        tiny_tokenizer(seed, 16), model,
        training_config={"3dbox_condition_ratio": 0.8,
                         "hdmap_condition_ratio": 0.8,
                         "max_norm_for_grad_clip": 1.0},
        optimizer_config={"lr": 1e-4})
    pipe.vq.vector_quantizer.cosine_similarity = True
    dpipe = copy.deepcopy(pipe)
    dpipe.vq.to(dev)
    dpipe.model.to(dev)
    batch = {**_points(g, 2, 1), **lidar_tiny._rasters(g, 2, 128)}
    draws = pipe.draw_training_randoms(batch, g)
    ref, out, grads_rel = _step_pair(
        pipe, dpipe,
        lambda p: p.loss_from_draws(*((_on(batch, dev), _on(draws, dev))
                                      if p is dpipe else (batch, draws))),
        lambda p: p.model)
    return {**_losses_rel(out, ref), "grads_rel": grads_rel,
            "acc_equal": float(out["acc_0"]) == float(ref["acc_0"])}


def dit_train_gaps(dev, seed: int = 0) -> dict:
    """A LiDAR DiT step (``lidar_tiny.ROWWISE_DIT``, K1 and K2 at 144
    tokens) on given latents (its 4 x 72 grid is no tokenizer's square
    one: the CTSD loss the pipeline hands its latents to) and draws."""
    g = torch.Generator().manual_seed(seed)
    torch.manual_seed(seed)
    h, w = lidar_tiny.ROWWISE_LATENT
    frames = lidar_tiny.ROWWISE_FRAMES
    pipe = LidarDiffusionPipeline(
        lidar_tiny.rowwise_dit(seed), lidar_tiny._tokenizer(cosine=True),
        FlowMatchEulerScheduler(shift=3.0),
        FlowMatchEulerScheduler(shift=3.0),
        common_config={"text_embeddings_dim": 16,
                       "pooled_text_embeddings_dim": 16,
                       "frame_prediction_style": "ctsd"},
        training_config={"all_reference_visible_ratio": 0.5,
                         "reference_latent_count": 1,
                         "disable_reference_frame_loss": True})
    shape = (1, frames, 1, h, w, 8)
    latents = torch.randn(shape, generator=g)
    batch = {"latents": latents,
             "encoder_hidden_states": torch.zeros(1, frames, 1, 1, 16),
             "pooled_projections": torch.zeros(1, frames, 1, 16),
             "3dbox_images": torch.rand(1, frames, 1, 8 * h, 8 * w, 6,
                                        generator=g)}
    draws = draw_training_randoms(shape, pipe.training_config,
                                  pipe.common_config, g)
    dpipe = copy.deepcopy(pipe)
    dpipe.model.to(dev)
    dpipe.autoencoder.to(dev)
    ops.reset_launch_counts()
    ref, out, grads_rel = _step_pair(
        pipe, dpipe,
        lambda p: CTSDPipeline.loss_from_draws(
            p, *((_on(batch, dev), _on(draws, dev)) if p is dpipe
                 else (batch, draws))),
        lambda p: p.model)
    counts = ops.launch_counts()
    return {**_losses_rel(out, ref), "grads_rel": grads_rel,
            "k1_launches": counts["flash_tail"],
            "k2_launches": counts["flash_tail_backward"]}


def tiny_unet_pipeline(seed: int = 0) -> LidarDiffusionPipeline:
    """The LiDAR UNet pipeline in small: a ``VAEPointCloud`` of 16 x 16 x 8
    latents and a 2-level UNet (128 channels, 2 x 64 heads: the 256-token
    self-attention reaches K7), DDPM ``v_prediction`` training and DDIM
    sampling with CFG 3.0, 2 steps."""
    torch.manual_seed(seed)
    tokenizer = VAEPointCloud(
        Voxelizer(**UNET_VOXELIZER),
        vq.VQEncoder(**dict(UNET_ENCODER, codebook_dim=16)),
        vq.VQDecoder(**dict(UNET_ENCODER, codebook_dim=8, depth=4,
                            density_feats=4)), latent_dim=8)
    model = UNetCrossviewTemporal(**UNET)
    return LidarDiffusionPipeline(
        model, tokenizer,
        DDPMScheduler(num_train_timesteps=1000,
                      prediction_type="v_prediction"),
        DDIMScheduler(num_train_timesteps=1000,
                      prediction_type="v_prediction"),
        common_config={"text_embeddings_dim": 16,
                       "pooled_text_embeddings_dim": 16,
                       "frame_prediction_style": "ctsd"},
        training_config={"generation_task_ratio": 0.25,
                         "all_reference_visible_ratio": 1.0,
                         "reference_latent_count": 1,
                         "disable_reference_frame_loss": True,
                         "max_norm_for_grad_clip": 1.0},
        inference_config={"inference_steps": 2, "guidance_scale": 3.0},
        model_type="unet")


def unet_gaps(dev, seed: int = 0) -> dict:
    g = torch.Generator().manual_seed(seed)
    pipe = tiny_unet_pipeline(seed)
    dpipe = copy.deepcopy(pipe)
    dpipe.model.to(dev)
    dpipe.autoencoder.to(dev)
    batch = _points(g, 1, UNET_FRAMES, span=20.0)
    dbatch = _on(batch, dev)
    shape = (1, UNET_FRAMES, 1, 16, 16, 8)
    noise = torch.randn(shape, generator=g)
    uniforms = [torch.rand(UNET_FRAMES, 8, 128, 128, generator=g)
                for _ in range(2)]
    draws = draw_training_randoms(shape, pipe.training_config,
                                  pipe.common_config, g,
                                  scheduler=pipe.train_scheduler)
    pipe.model.eval()
    dpipe.model.eval()
    ops.reset_launch_counts()
    with torch.no_grad():
        lat, vox = pipe.encode_points(*batch.values())
        dlat, dvox = dpipe.encode_points(*dbatch.values())
        got = pipe.generate(batch, noise=noise, voxel_uniforms=uniforms)
        dgot = dpipe.generate(dbatch, noise=noise.to(dev),
                              voxel_uniforms=[u.to(dev) for u in uniforms])
    serve = ops.launch_counts()
    pipe.model.train()
    dpipe.model.train()
    ops.reset_launch_counts()
    ref, out, grads_rel = _step_pair(
        pipe, dpipe,
        lambda p: p.loss_from_draws(*((dbatch, _on(draws, dev))
                                      if p is dpipe else (batch, draws))),
        lambda p: p.model)
    train = ops.launch_counts()
    return {
        "voxels_equal": torch.equal(dvox.cpu(), vox),
        "latents_rel": rel_err(dlat.cpu(), lat),
        "generated_rel": rel_err(dgot["latents"].cpu(), got["latents"]),
        "voxels_equal_share": float(
            (dgot["pred_voxels"].cpu() == got["pred_voxels"]).float().mean()),
        **_losses_rel(out, ref), "grads_rel": grads_rel,
        "serve_k7_launches": serve["flash_attention"],
        "train_k7_launches": train["flash_attention"],
        "train_k7_backward_launches": train["flash_attention_backward"],
    }
