"""The port's serving slice vs the JAX package's, on the CPU in fp32.

Both pipelines are built by their own config runtimes from one config
(the synthetic CTSD-3.5 config with implicit perspective and camera ids),
share weights through the weight bridge and the JAX package's noise
draws, and run a 2-window autoregressive rollout with 3 steps and CFG,
then the VAE decode. Tolerances: 1e-3 on latents (the DiT bar of
``test_dit_converter_parity.py``), 2e-3 on decoded frames (the VAE
amplifies the latent difference).
"""

import copy
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opendwm_tpu.config as jax_config
from opendwm_tpu.models.autoencoders import AutoencoderKL as JaxAutoencoderKL
from opendwm_tpu.pipelines.ctsd import get_conditions as jax_get_conditions
from opendwm_tpu.schedulers import FlowMatchEulerScheduler as JaxFlowMatch
from opendwm_tpu_torch import config
from opendwm_tpu_torch.convert import (
    dit_state_dict_from_flax,
    to_torch,
    vae_state_dict_from_flax,
)
from opendwm_tpu_torch.models.autoencoders import AutoencoderKL
from opendwm_tpu_torch.schedulers import FlowMatchEulerScheduler
from opendwm_tpu_torch.pipelines.ctsd import (
    get_conditions,
    slice_batch_time_window,
)

from torch_port_helpers import random_flax_params

REPO = Path(__file__).resolve().parents[1]
B, T, V, H, W, C = 1, 2, 2, 8, 8, 16
TOTAL_FRAMES = 3  # two windows of 2 frames, 1 reference frame
L, JOINT, POOLED = 4, 24, 16
COMMON = {
    "frame_prediction_style": "ctsd",
    "added_time_ids": "fps_camera_transforms",
    "camera_intrinsic_embedding_indices": [0, 4, 2, 5],
    "camera_intrinsic_denom_embedding_indices": [0, 1, 0, 1],
    "camera_transform_embedding_indices": [3, 7, 11],
}


def _pipeline_config() -> dict:
    cfg = json.loads((REPO / "configs/ctsd/ctsd_35_6views_video_synthetic.json")
                     .read_text())["pipeline"]
    cfg["model"].update(perspective_modeling_type="implicit",
                        projection_class_embeddings_input_dim=2816)
    cfg["common_config"] = dict(COMMON)
    cfg["inference_config"] = {"inference_steps": 3, "guidance_scale": 3.0}
    return cfg


def _batch(rng) -> dict:
    """Conditions for all TOTAL_FRAMES frames, re-sliced per window."""
    intr = np.tile(np.array([[20.0, 0, 32], [0, 20.0, 32], [0, 0, 1]]),
                   (B, TOTAL_FRAMES, V, 1, 1))
    transforms = np.tile(np.eye(4), (B, TOTAL_FRAMES, V, 1, 1))
    transforms[..., :3, 3] = rng.standard_normal((B, TOTAL_FRAMES, V, 3))
    transforms[..., :3, :3] += 0.1 * rng.standard_normal(
        (B, TOTAL_FRAMES, V, 3, 3))
    batch = {
        "encoder_hidden_states": rng.standard_normal(
            (B, TOTAL_FRAMES, V, L, JOINT)),
        "pooled_projections": rng.standard_normal((B, TOTAL_FRAMES, V, POOLED)),
        "camera_intrinsics": intr,
        "camera_transforms": transforms,
        # not a time-indexed key, so one frame broadcasts over the window
        "image_size": np.tile(np.array([64.0, 64.0]), (B, 1, V, 1)),
        "fps": np.full((B,), 10.0),
    }
    return {k: v.astype(np.float32) for k, v in batch.items()}


@pytest.fixture(scope="module")
def pipelines():
    cfg = _pipeline_config()
    jax_pipe = jax_config.create_instance_from_config(copy.deepcopy(cfg))
    port_pipe = config.create_instance_from_config(copy.deepcopy(cfg))
    batch = _batch(np.random.default_rng(0))
    window = slice_batch_time_window(
        {k: torch.from_numpy(v) for k, v in batch.items()}, 0, T)
    conds = jax_get_conditions(
        {k: jnp.asarray(v.numpy()) for k, v in window.items()}, COMMON)
    shapes = jax.eval_shape(
        jax_pipe.model.init, jax.random.PRNGKey(0),
        sample=jnp.zeros((B, T, V, H, W, C)), timestep=jnp.zeros((B, T, V)),
        **conds)
    params = random_flax_params(shapes, 1)
    port_pipe.model.load_state_dict(to_torch(
        dit_state_dict_from_flax(params, cfg["model"]["num_layers"])))

    vae_kw = dict(block_out_channels=(32, 64), latent_channels=C,
                  use_quant_conv=False, scaling_factor=1.5305,
                  shift_factor=0.0609)
    jax_vae = JaxAutoencoderKL(**vae_kw)
    vae_params = random_flax_params(jax.eval_shape(
        jax_vae.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3))), 2)
    jax_pipe.set_vae(jax_vae, vae_params)
    port_vae = AutoencoderKL(**vae_kw)
    port_vae.load_state_dict(to_torch(vae_state_dict_from_flax(vae_params)))
    port_pipe.set_vae(port_vae)
    return jax_pipe, params, port_pipe, batch


@pytest.mark.parametrize("mode", ["fps_camera_transforms",
                                  "fps_camera_transforms_action"])
def test_conditions_match_jax(pipelines, mode):
    _, _, _, batch = pipelines
    rng = np.random.default_rng(3)
    window = {k: v[:, :T] if v.ndim > 1 and v.shape[1] == TOTAL_FRAMES
              else v for k, v in batch.items()}
    ego = np.tile(np.eye(4, dtype=np.float32), (B, T, V, 1, 1))
    ego[..., :3, 3] = np.cumsum(rng.uniform(0, 2, (B, T, V, 3)), axis=1)
    window.update({
        "3dbox_images": rng.uniform(0, 1, (B, T, V, 16, 16, 3)),
        "ego_transforms": ego,
        "uncond_pooled_projections": rng.standard_normal((B, T, V, POOLED)),
    })
    window = {k: v.astype(np.float32) for k, v in window.items()}
    common = dict(COMMON, added_time_ids=mode,
                  camera_ego_sensor_indices=list(range(V)),
                  uncondition_image_color=0.25)
    masks = {"text_condition_mask": np.array([False]),
             "box_condition_mask": np.array([False]),
             "action_condition_mask": np.array([True])}
    ref = jax_get_conditions(
        {k: jnp.asarray(v) for k, v in window.items()}, common,
        do_classifier_free_guidance=True,
        **{k: jnp.asarray(v) for k, v in masks.items()})
    out = get_conditions(
        {k: torch.from_numpy(v) for k, v in window.items()}, common,
        do_classifier_free_guidance=True,
        **{k: torch.from_numpy(v) for k, v in masks.items()})
    assert ref.keys() == out.keys()
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-5, err_msg=k)


def test_flow_match_scheduler_matches_jax():
    jax_sched = JaxFlowMatch(shift=3.0)
    sched = FlowMatchEulerScheduler(shift=3.0)
    np.testing.assert_array_equal(sched.train_sigmas, jax_sched.train_sigmas)
    for n in (4, 40):
        np.testing.assert_array_equal(sched.inference_sigmas(n),
                                      jax_sched.inference_sigmas(n))
    rng = np.random.default_rng(4)
    idx = rng.integers(0, 1000, (2, 3))
    np.testing.assert_array_equal(
        sched.timesteps_at(torch.from_numpy(idx)).numpy(),
        np.asarray(jax_sched.timesteps_at(jnp.asarray(idx))))
    x0, noise = (rng.standard_normal((2, 3, 4)).astype(np.float32)
                 for _ in range(2))
    sig = sched.sigmas_at(torch.from_numpy(idx))
    np.testing.assert_allclose(
        sched.add_noise(torch.from_numpy(x0), torch.from_numpy(noise),
                        sig).numpy(),
        np.asarray(jax_sched.add_noise(jnp.asarray(x0), jnp.asarray(noise),
                                       jnp.asarray(sig.numpy()))),
        atol=1e-6)
    # Euler step keeps the sample's dtype (a bf16 model output, fp32 latents)
    steps = rng.integers(0, 4, (2, 3))
    out = sched.step_by_indices(
        torch.from_numpy(noise).bfloat16(), torch.from_numpy(steps),
        torch.from_numpy(x0), 4)
    ref = jax_sched.step_by_indices(
        jnp.asarray(noise).astype(jnp.bfloat16), jnp.asarray(steps),
        jnp.asarray(x0), 4)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
    idx = sched.sample_train_indices((64,), torch.Generator().manual_seed(0))
    assert idx.dtype == torch.int64 and 0 <= idx.min() <= idx.max() < 1000


def test_view_embedding_width_follows_conditions(pipelines):
    _, _, port_pipe, _ = pipelines
    # 1 fps + 4 intrinsic + 3 extrinsic ids, 256 features each
    assert port_pipe.model.view_embedding.linear_1.in_features == 8 * 256


def test_autoregressive_rollout_and_decode_match_jax(pipelines):
    jax_pipe, params, port_pipe, batch = pipelines
    shape = (B, T, V, H, W, C)
    rng = jax.random.PRNGKey(0)
    ref = jax_pipe.autoregressive_inference_pipeline(
        params, {k: jnp.asarray(v) for k, v in batch.items()},
        shape, rng, total_frames=TOTAL_FRAMES)
    # The JAX rollout's per-window noise draws, handed to the port.
    noise = []
    for _ in range(2):
        rng, step_rng = jax.random.split(rng)
        noise.append(torch.tensor(np.asarray(
            jax.random.normal(step_rng, shape, jnp.float32))))
    out = port_pipe.autoregressive_inference_pipeline(
        {k: torch.from_numpy(v) for k, v in batch.items()}, shape,
        total_frames=TOTAL_FRAMES, noise=noise)
    assert out.shape == ref.shape == (B, TOTAL_FRAMES, V, H, W, C)
    assert float(np.abs(out.numpy() - np.asarray(ref)).max()) <= 1e-3

    frames_ref = np.asarray(jax_pipe.decode_latents(ref))
    frames = port_pipe.decode_latents(out, chunk_size=4).numpy()
    assert frames.shape == frames_ref.shape == (B, TOTAL_FRAMES, V, 16, 16, 3)
    assert np.isfinite(frames).all()
    assert float(np.abs(frames - frames_ref).max()) <= 2e-3


def test_diffusion_forcing_matches_jax(pipelines):
    """Per-frame ladder positions (diffusion forcing), seeded by image
    latents, 4 steps over 2 frames."""
    jax_pipe, params, port_pipe, batch = pipelines
    shape = (B, T, V, H, W, C)
    window = {k: v[:, :T] if v.ndim > 1 and v.shape[1] == TOTAL_FRAMES
              else v for k, v in batch.items()}
    image_latents = np.random.default_rng(5).standard_normal(shape).astype(
        np.float32)
    saved = [(p, p.common_config, p.inference_config)
             for p in (jax_pipe, port_pipe)]
    try:
        for p in (jax_pipe, port_pipe):
            p.common_config = dict(COMMON,
                                   frame_prediction_style="diffusion_forcing")
            p.inference_config = {"inference_steps": 4, "guidance_scale": 3.0}
        ref = jax_pipe.inference_pipeline(
            params, {k: jnp.asarray(v) for k, v in window.items()}, shape,
            jax.random.PRNGKey(0), image_latents=jnp.asarray(image_latents))
        out = port_pipe.inference_pipeline(
            {k: torch.from_numpy(v) for k, v in window.items()}, shape,
            image_latents=torch.from_numpy(image_latents))
    finally:
        for p, common, inference in saved:
            p.common_config, p.inference_config = common, inference
    assert float(np.abs(out.numpy() - np.asarray(ref)).max()) <= 1e-3


def test_generator_noise_is_reproducible(pipelines):
    _, _, port_pipe, batch = pipelines
    window = slice_batch_time_window(
        {k: torch.from_numpy(v) for k, v in batch.items()}, 0, T)
    outs = [
        port_pipe.inference_pipeline(
            window, (B, T, V, H, W, C),
            generator=torch.Generator().manual_seed(7))
        for _ in range(2)
    ]
    assert torch.equal(outs[0], outs[1])
    assert torch.isfinite(outs[0]).all()
