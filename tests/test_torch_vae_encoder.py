"""The port's VAE encoder and the pixel-space (``vae_images``) training step
vs the JAX package's, on the CPU in fp32.

- ``AutoencoderKL.encode`` at a tiny width, with and without the quant
  conv: the posterior's mean and log-variance to 1e-3; ``encode_to_scaled``
  on the mean and on a posterior sample from the same noise.
- A tiny box/map (bm) train step from ``vae_images``: the tiny DiT of
  ``torch_port_helpers.TINY_BM_DIT`` (the ImageAdapter in front of its
  first two joint blocks) behind the tiny SD3.5-shaped VAE, with the flagship's
  training options and ``flat`` AdamW with bf16 moments (``bench.py``'s
  optimizer). Both pipelines take the same draws, the posterior noise of
  the encode included (the port's are rebuilt from the JAX ``PRNGKey``).
  Held as ``tests/test_torch_train.py`` holds its step: the loss to 1e-5
  relative, every gradient (the adapter's too) to 1e-3 of its largest
  entry, one update's parameters to 1e-4 and its gradient norm to 1e-4.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opendwm_tpu.config as jax_config
from opendwm_tpu.models.autoencoders import AutoencoderKL as JaxAutoencoderKL
from opendwm_tpu.pipelines.ctsd import TrainState as JaxTrainState
from opendwm_tpu.pipelines.ctsd import get_conditions as jax_get_conditions
from opendwm_tpu_torch import config
from opendwm_tpu_torch.convert import (
    dit_state_dict_from_flax,
    to_torch,
    vae_state_dict_from_flax,
)
from opendwm_tpu_torch.models.autoencoders import AutoencoderKL
from opendwm_tpu_torch.pipelines.ctsd import draw_training_randoms

from torch_port_helpers import (
    TINY_BM_DIT,
    jax_training_draws,
    layout_rasters,
    random_flax_params,
    to_torch_tree,
)

TOL = 1e-3
SD35_TINY = dict(block_out_channels=(8, 16), latent_channels=16,
                 use_quant_conv=False, scaling_factor=1.5305,
                 shift_factor=0.0609)


def _vae_params(vae, seed: int, image_hw=(16, 24)):
    shapes = jax.eval_shape(vae.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, *image_hw, 3)))
    return random_flax_params(shapes, seed)


def _max_err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
                 .max())


@pytest.mark.parametrize("use_quant_conv,latent", [(True, 4), (False, 16)])
def test_encoder_matches_jax(use_quant_conv, latent):
    kw = dict(SD35_TINY, latent_channels=latent, use_quant_conv=use_quant_conv)
    jax_vae = JaxAutoencoderKL(**kw)
    params = _vae_params(jax_vae, 7)
    rng = np.random.default_rng(latent)
    x = rng.uniform(-1, 1, (2, 3, 16, 24, 3)).astype(np.float32)
    noise = jax.random.normal(jax.random.PRNGKey(1), (2, 3, 8, 12, latent))
    mean_ref, logvar_ref = jax.jit(
        lambda p, x: jax_vae.apply(p, x, method=jax_vae.encode))(
            params, jnp.asarray(x))
    scaled_ref = jax.jit(jax_vae.encode_to_scaled)(params, jnp.asarray(x))
    sample_ref = jax.jit(jax_vae.encode_to_scaled)(
        params, jnp.asarray(x), jax.random.PRNGKey(1))

    port = AutoencoderKL(**kw)
    port.load_state_dict(to_torch(vae_state_dict_from_flax(params)))
    assert port.latent_shape(x.shape) == mean_ref.shape
    with torch.no_grad():
        mean, logvar = port.encode(torch.from_numpy(x))
        scaled = port.encode_to_scaled(torch.from_numpy(x))
        sample = port.encode_to_scaled(
            torch.from_numpy(x), noise=torch.tensor(np.asarray(noise)))
    assert mean.shape == logvar.shape == mean_ref.shape == (2, 3, 8, 12,
                                                            latent)
    print(f"encoder (quant conv {use_quant_conv}): mean "
          f"{_max_err(mean, mean_ref):.2e}, logvar "
          f"{_max_err(logvar, logvar_ref):.2e}, scaled "
          f"{_max_err(scaled, scaled_ref):.2e}, sampled "
          f"{_max_err(sample, sample_ref):.2e}")
    assert _max_err(mean, mean_ref) <= TOL
    assert _max_err(logvar, logvar_ref) <= TOL
    assert _max_err(scaled, scaled_ref) <= TOL
    assert _max_err(sample, sample_ref) <= TOL
    assert _max_err(sample, scaled) > 100 * TOL  # the noise is used


def test_posterior_clips_logvar_and_draws_from_generator():
    vae = AutoencoderKL(**SD35_TINY)
    with torch.no_grad():
        vae.encoder.conv_out.bias[16:] = 1e3  # logvar far above 20
        mean, logvar = vae.encode(torch.zeros(1, 4, 6, 3))
    assert float(logvar.max()) == 20.0
    draws = [AutoencoderKL.sample_posterior(
        mean, logvar, torch.Generator().manual_seed(3)) for _ in range(2)]
    assert torch.equal(*draws)
    noise = torch.randn(mean.shape, generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(draws[0],
                               mean + torch.exp(0.5 * logvar) * noise)


# -- the bm train step from vae_images ---------------------------------------

B, T, V, H, W = 1, 2, 2, 8, 12  # latents; images and rasters are 2x
COMMON = {
    "frame_prediction_style": "ctsd",
    "cat_condition": True,
    "uncondition_image_color": 0.1255,
    "added_time_ids": "fps_camera_transforms",
    "camera_intrinsic_embedding_indices": [0, 4, 2, 5],
    "camera_intrinsic_denom_embedding_indices": [0, 1, 0, 1],
    "camera_transform_embedding_indices": [3, 7, 11],
}
# configs/ctsd/ctsd_35_tirda_bm_nwao.json's training options
TRAINING = {
    "text_prompt_condition_ratio": 0.8,
    "3dbox_condition_ratio": 0.8,
    "hdmap_condition_ratio": 0.8,
    "generation_task_ratio": 0.25,
    "image_generation_ratio": 0.15,
    "all_reference_visible_ratio": 0.5,
    "reference_visible_rate": 0.95,
    "reference_latent_count": {"1": 0.5, "3": 0.5},
    "disable_reference_frame_loss": True,
    "max_norm_for_grad_clip": 1.0,
    "weighting_scheme": "logit_normal",
}
OPTIMIZER = {"lr": 1e-4, "weight_decay": 0.01, "flat": True,
             "mu_dtype": "bfloat16"}


def _pipeline_config() -> dict:
    model = {"_class_name": "dwm.models.crossview_temporal_dit."
             "DiTCrossviewTemporalConditionModel",
             **copy.deepcopy(TINY_BM_DIT)}
    model["projection_class_embeddings_input_dim"] = 2816
    return {
        "_class_name": "CTSDPipeline",
        "model": model,
        "train_scheduler": {"_class_name": "FlowMatchEulerScheduler",
                            "shift": 3.0},
        "test_scheduler": {"_class_name": "FlowMatchEulerScheduler",
                           "shift": 3.0},
        "common_config": dict(COMMON),
        "training_config": dict(TRAINING),
        "optimizer_config": dict(OPTIMIZER),
    }


def _batch(rng) -> dict:
    intr = np.tile(np.array([[20.0, 0, 12], [0, 20.0, 8], [0, 0, 1]]),
                   (B, T, V, 1, 1))
    transforms = np.tile(np.eye(4), (B, T, V, 1, 1))
    transforms[..., :3, 3] = rng.standard_normal((B, T, V, 3))
    batch = {
        "vae_images": rng.uniform(-1, 1, (B, T, V, 2 * H, 2 * W, 3)),
        "3dbox_images": layout_rasters(rng, (B, T, V, 2 * H, 2 * W, 3)),
        "hdmap_images": layout_rasters(rng, (B, T, V, 2 * H, 2 * W, 3)),
        "encoder_hidden_states": rng.standard_normal((B, T, V, 7, 24)),
        "pooled_projections": rng.standard_normal((B, T, V, 16)),
        "camera_intrinsics": intr,
        "camera_transforms": transforms,
        "image_size": np.tile(np.array([24.0, 16.0]), (B, T, V, 1)),
        "fps": np.full((B,), 10.0),
    }
    return {k: v.astype(np.float32) for k, v in batch.items()}


def _rel_to_max(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


@pytest.fixture(scope="module")
def bm():
    cfg = _pipeline_config()
    jax_pipe = jax_config.create_instance_from_config(copy.deepcopy(cfg))
    cfg["model"]["param_dtype"] = torch.float32
    port_pipe = config.create_instance_from_config(cfg)
    jax_vae = JaxAutoencoderKL(**SD35_TINY)
    vae_params = _vae_params(jax_vae, 8, (2 * H, 2 * W))
    jax_pipe.set_vae(jax_vae, vae_params)
    port_vae = AutoencoderKL(**SD35_TINY)
    port_vae.load_state_dict(to_torch(vae_state_dict_from_flax(vae_params)))
    port_pipe.set_vae(port_vae)

    batch = _batch(np.random.default_rng(0))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    conds = jax_get_conditions(jbatch, COMMON)
    shapes = jax.eval_shape(
        jax_pipe.model.init, jax.random.PRNGKey(0),
        sample=jnp.zeros((B, T, V, H, W, 16)),
        timestep=jnp.zeros((B, T, V)), **conds)
    params = random_flax_params(shapes, 1)
    port_pipe.model.load_state_dict(to_torch(
        dit_state_dict_from_flax(params, TINY_BM_DIT["num_layers"])))
    return jax_pipe, params, port_pipe, batch


def test_draws_carry_the_posterior_noise():
    shape = (B, T, V, H, W, 16)
    plain = draw_training_randoms(shape, TRAINING, COMMON,
                                  torch.Generator().manual_seed(0))
    with_vae = draw_training_randoms(shape, TRAINING, COMMON,
                                     torch.Generator().manual_seed(0),
                                     vae=True)
    assert "vae" not in plain and with_vae["vae"].shape == shape
    assert with_vae.keys() - plain.keys() == {"vae"}


def test_bm_train_step_from_vae_images_matches_jax(bm):
    jax_pipe, params, port_pipe, batch = bm
    key = jax.random.PRNGKey(5)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    draws = jax_training_draws(key, (B, T, V, H, W, 16), TRAINING, COMMON,
                               vae=True)

    # loss and every gradient
    (ref_loss, _), ref_grads = jax.jit(
        jax.value_and_grad(jax_pipe.loss_fn, has_aux=True))(
            params["params"], jbatch, key)
    state = port_pipe.init_state()
    loss, _ = port_pipe.loss_from_draws(to_torch_tree(batch), draws)
    loss.backward()
    assert abs(loss.item() - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    ref = dit_state_dict_from_flax(ref_grads, TINY_BM_DIT["num_layers"])
    grads = {n: p.grad for n, p in port_pipe.model.named_parameters()}
    assert grads.keys() == ref.keys()
    assert any(n.startswith("condition_image_adapter.zero_convs") for n in ref)
    errs = {name: _rel_to_max(g.numpy(), ref[name])
            for name, g in grads.items()}
    print(f"bm step: loss {loss.item():.6f} vs {float(ref_loss):.6f}, worst "
          f"gradient {max(errs.values()):.2e} of its largest "
          f"({max(errs, key=errs.get)})")
    for name, err in errs.items():
        assert err <= 1e-3, name
    assert all(p.grad is None for p in port_pipe.vae.parameters())

    # one train step: the same loss, clipping and flat AdamW (bf16 moments)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           opt_state=jax_pipe.tx.init(params["params"]))
    new_state, ref_metrics = jax.jit(jax_pipe._train_step_impl)(
        jstate, jbatch, key)
    before = {n: p.detach().clone()
              for n, p in port_pipe.model.named_parameters()}
    state, metrics = port_pipe.train_step(state, to_torch_tree(batch),
                                          draws=draws)
    grad_norm = float(ref_metrics["grad_norm"])
    assert abs(metrics["grad_norm"].item() - grad_norm) <= 1e-4 * grad_norm
    moments = {t.dtype for s in state.optimizer.state.values()
               for k, t in s.items() if k.startswith("exp_avg")}
    assert moments == {torch.bfloat16}
    ref = dit_state_dict_from_flax(new_state.params, TINY_BM_DIT["num_layers"])
    print(f"bm step: grad norm {metrics['grad_norm'].item():.6f} vs "
          f"{grad_norm:.6f}, worst parameter gap "
          f"""{max(float(np.abs(p.detach().numpy() - ref[n]).max())
                   for n, p in port_pipe.model.named_parameters()):.2e}""")
    for name, p in port_pipe.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name], atol=1e-4,
                                   err_msg=name)
        assert not torch.equal(p.detach(), before[name]), name
