"""DFoT, diffusion forcing on CTSD-3.5
(``configs/ctsd/multi_datasets/ctsd_35_df16_tirda_bm_nwao.json``): the
port against the JAX package on the CPU in fp32.

Both pipelines are built by their own config runtimes from the config
file with its widths and depth cut (3 joint blocks of 4 x 8 heads: dual
attention, a rowwise cross-view and a pointwise temporal branch; the
adapter's first two stages, the first down-sampled, its zero convs and
gates; 2 views, the ego sensors cut to them), its conditions (box and map
rasters, camera and action ids: ``fps_camera_transforms_action``), its
training options (per-(sample, frame) timesteps, the reference frames'
scale and offset jitter, image generation) and its sampling (flow-match
Euler, CFG 4.0). Draws: one ``PRNGKey``'s, rebuilt for the port.

Bars as ``tests/test_torch_train.py``'s: the loss to 1e-5 relative, each
gradient (the adapter's too) to 1e-3 of its largest entry, one AdamW
step's parameters and gradient norm to 1e-4; 4 sampling steps over 2
frames to 1e-3 (``tests/test_torch_pipeline.py``'s bar).

The config's own 40 steps cannot be sampled over its 6 frames in either
package: diffusion forcing needs the steps divisible by the frames
(``opendwm_tpu/pipelines/ctsd.py:724``); JAX asserts, the port raises a
``ValueError``.
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
from opendwm_tpu.pipelines.ctsd import TrainState as JaxTrainState
from opendwm_tpu.pipelines.ctsd import get_conditions as jax_get_conditions
from opendwm_tpu_torch import config
from opendwm_tpu_torch.convert import dit_state_dict_from_flax, to_torch
from opendwm_tpu_torch.pipelines.ctsd import get_conditions

from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    jax_training_draws,
    layout_rasters,
    one_torch_thread,
    random_flax_params,
    recording_tx,
    redraw_gates,
    to_torch_tree,
)

REPO = Path(__file__).resolve().parents[1]
CONFIG = REPO / "configs/ctsd/multi_datasets" / \
    "ctsd_35_df16_tirda_bm_nwao.json"
B, T, V, H, W, C = 2, 2, 2, 16, 24, 16
L, JOINT, POOLED, LAYERS = 40, 24, 16, 3
MODEL_CUT = dict(num_layers=LAYERS, attention_head_dim=8,
                 num_attention_heads=4, joint_attention_dim=JOINT,
                 caption_projection_dim=32, pooled_projection_dim=POOLED,
                 pos_embed_max_size=16, sample_size=8,
                 dual_attention_layers=[0], crossview_block_layers=[1],
                 temporal_block_layers=[2])
KEY = 1
IDS = 1 + 4 + 12 + 2  # fps, intrinsics, extrinsics, speed and steering


def _pipeline_config() -> dict:
    cfg = json.loads(CONFIG.read_text())["pipeline"]
    assert cfg["common_config"]["frame_prediction_style"] == \
        "diffusion_forcing"
    model = cfg["model"]
    del model["dtype"]  # fp32 compute
    model.update(MODEL_CUT)
    adapter = model["condition_image_adapter_config"]
    adapter["channels"] = [32, 32]
    adapter["is_downblocks"] = adapter["is_downblocks"][:2]
    cfg["common_config"]["camera_ego_sensor_indices"] = list(range(V))
    return cfg


def _batch(rng) -> dict:
    intr = np.tile(np.array([[20.0, 0, 32], [0, 20.0, 32], [0, 0, 1]]),
                   (B, T, V, 1, 1))
    transforms = np.tile(np.eye(4), (B, T, V, 1, 1))
    transforms[..., :3, 3] = rng.standard_normal((B, T, V, 3))
    ego = np.tile(np.eye(4), (B, T, V, 1, 1))
    ego[..., :3, 3] = np.cumsum(rng.uniform(0, 2, (B, T, V, 3)), axis=1)
    batch = {
        "latents": rng.standard_normal((B, T, V, H, W, C)),
        "encoder_hidden_states": rng.standard_normal((B, T, V, L, JOINT)),
        "pooled_projections": rng.standard_normal((B, T, V, POOLED)),
        "camera_intrinsics": intr,
        "camera_transforms": transforms,
        "ego_transforms": ego,
        "image_size": np.tile(np.array([64.0, 64.0]), (B, T, V, 1)),
        "fps": np.full((B,), 10.0),
    }
    for key in ("3dbox_images", "hdmap_images"):
        batch[key] = layout_rasters(rng, (B, T, V, 8 * H, 8 * W, 3))
    return {k: v.astype(np.float32) for k, v in batch.items()}


def _rel_to_max(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


@pytest.fixture(scope="module")
def setup():
    cfg = _pipeline_config()
    jax_pipe = jax_config.create_instance_from_config(copy.deepcopy(cfg))
    jax_pipe.tx = recording_tx(jax_pipe.tx)
    port_pipe = config.create_instance_from_config(copy.deepcopy(cfg))
    batch = _batch(np.random.default_rng(0))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    conds = jax_get_conditions(jbatch, cfg["common_config"])
    assert conds["added_time_ids"].shape[-1] == IDS
    shapes = jax.eval_shape(
        jax_pipe.model.init, jax.random.PRNGKey(0),
        sample=jbatch["latents"], timestep=jnp.zeros((B, T, V)), **conds)
    params = redraw_gates(jax.tree.map(np.asarray,
                                       random_flax_params(shapes, 1)),
                          np.random.default_rng(2))
    port_pipe.model.load_state_dict(to_torch(
        dit_state_dict_from_flax(params, LAYERS)))
    return cfg, jax_pipe, params, port_pipe, batch


@pytest.fixture(scope="module")
def jax_step(setup):
    """JAX's train step on ``KEY``'s draws, compiled once: the new state,
    the metrics and the gradients of its ``value_and_grad``."""
    _, jax_pipe, params, _, batch = setup
    jparams = jax.tree.map(jnp.asarray, params)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                          opt_state=jax_pipe.tx.init(jparams["params"]))
    new_state, metrics = jax.jit(jax_pipe._train_step_impl)(
        state, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(KEY))
    return new_state, metrics, new_state.opt_state[0]


def _draws(cfg, batch):
    return jax_training_draws(jax.random.PRNGKey(KEY),
                              batch["latents"].shape, cfg["training_config"],
                              cfg["common_config"])


def _port_copy(port_pipe, **model_flags):
    pipe = copy.copy(port_pipe)
    model = config.create_instance_from_config(dict(
        _pipeline_config()["model"], **model_flags))
    model.set_view_embedding_width(
        port_pipe.model.view_embedding.linear_1.in_features)
    model.load_state_dict(port_pipe.model.state_dict())
    pipe.model = model
    return pipe


def test_dfot_conditions_carry_the_action_ids(setup):
    cfg, _, _, port_pipe, batch = setup
    conds = get_conditions(to_torch_tree(batch), cfg["common_config"])
    ids = conds["added_time_ids"]
    assert ids.shape == (B, T, V, IDS)
    assert bool((ids[..., -2:] != -1000.0).any())  # speed and steering
    assert port_pipe.model.view_embedding.linear_1.in_features == 256 * IDS


def test_dfot_loss_and_gradients_match_jax(setup, jax_step):
    """Per-(sample, frame) timesteps: the draw is (b, t); the loss and
    every gradient, the adapter's included."""
    cfg, _, _, port_pipe, batch = setup
    _, ref_metrics, ref_grads = jax_step
    draws = _draws(cfg, batch)
    assert draws["time"].shape == (B, T)
    pipe = _port_copy(port_pipe)
    loss, _ = pipe.loss_from_draws(to_torch_tree(batch), draws)
    loss.backward()
    ref_loss = float(ref_metrics["sd_loss"])
    assert ref_loss > 0 and abs(loss.item() - ref_loss) <= 1e-5 * ref_loss
    ref = dit_state_dict_from_flax({"params": ref_grads}, LAYERS)
    grads = {n: p.grad for n, p in pipe.model.named_parameters()}
    assert grads.keys() == ref.keys()
    adapter = [n for n in ref if n.startswith("condition_image_adapter.")]
    assert len(adapter) > 10
    for name, g in grads.items():
        if name in adapter:
            assert float(g.abs().max()) > 0, name
        assert _rel_to_max(g.numpy(), ref[name]) <= 1e-3, name


def test_dfot_train_step_matches_jax(setup, jax_step):
    """One AdamW step with the config's optimizer (lr 5e-5, weight decay
    0.01, clip 1.0)."""
    cfg, _, _, port_pipe, batch = setup
    assert cfg["optimizer_config"] == {"lr": 5e-05, "weight_decay": 0.01}
    new_state, ref_metrics, _ = jax_step
    pipe = _port_copy(port_pipe, param_dtype=torch.float32)
    state = pipe.init_state()
    state, metrics = pipe.train_step(state, to_torch_tree(batch),
                                     draws=_draws(cfg, batch))
    grad_norm = float(ref_metrics["grad_norm"])
    assert abs(metrics["grad_norm"].item() - grad_norm) <= 1e-4 * grad_norm
    ref = dit_state_dict_from_flax(new_state.params, LAYERS)
    before = port_pipe.model.state_dict()
    for name, p in pipe.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name], atol=1e-4,
                                   err_msg=name)
        assert not torch.equal(p.detach(), before[name]), name


def _sample(pipe, args: tuple, steps: int, t: int, **kwargs):
    saved = pipe.inference_config
    pipe.inference_config = dict(saved, inference_steps=steps)
    try:
        shape = (B, t, V, H, W, C)
        return pipe.inference_pipeline(*args, shape, **kwargs)
    finally:
        pipe.inference_config = saved


def test_dfot_sampling_matches_jax(setup):
    """4 diffusion-forcing steps over 2 frames at the config's CFG 4.0,
    seeded from image latents."""
    cfg, jax_pipe, params, port_pipe, batch = setup
    assert cfg["inference_config"]["guidance_scale"] == 4.0
    window = {k: v for k, v in batch.items() if k != "latents"}
    image_latents = np.random.default_rng(5).standard_normal(
        (B, T, V, H, W, C)).astype(np.float32)
    ref = _sample(jax_pipe, (params, {k: jnp.asarray(v)
                                      for k, v in window.items()}), 4, T,
                  rng=jax.random.PRNGKey(0),
                  image_latents=jnp.asarray(image_latents))
    out = _sample(port_pipe, (to_torch_tree(window),), 4, T,
                  image_latents=torch.from_numpy(image_latents))
    assert out.shape == ref.shape and bool(torch.isfinite(out).all())
    assert float(np.abs(out.numpy() - np.asarray(ref)).max()) <= 1e-3
    assert float(np.abs(out.numpy() - image_latents).max()) > 1e-2


def test_dfot_config_steps_fail_over_its_frames(setup):
    """The config's 40 steps over 6 frames (40 % 6 = 4): JAX's assertion
    and the port's ``ValueError``; 36 steps pass the check."""
    cfg, jax_pipe, params, port_pipe, batch = setup
    steps = cfg["inference_config"]["inference_steps"]
    assert steps == 40
    window = {k: v for k, v in batch.items() if k != "latents"}
    with pytest.raises(AssertionError):
        _sample(jax_pipe, (params, {k: jnp.asarray(v)
                                    for k, v in window.items()}), steps, 6,
                rng=jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="divisible"):
        _sample(port_pipe, (to_torch_tree(window),), steps, 6)
    assert 36 % 6 == 0 and steps % 6 != 0
