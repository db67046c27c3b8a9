"""The port's CTSD-2.1 UNet slice vs the JAX package's, on the CPU in fp32.

- Schedulers: DDPM/DDIM tables, noising, targets and steps for the three
  prediction types, <= 1e-6 (the same fp32 formulas).
- ``TemporalBasicTransformerBlock`` and ``TransformerModel`` (its group
  norm pools per (b, t, v) image, ``docs/PARITY.md:131-133``), <= 1e-5.
- The tiny UNet (the widths of ``tests/test_unet.py``; 16x16 latents, so
  the level-0 self-attention is 256 tokens, a K7 shape): rowwise and full
  branches, the disable flags, a 5-D sample, <= 1e-3 (the bar of
  ``tests/test_unet_converter_parity.py``).
- ``CTSDPipeline(model_type="unet")``: DDIM sampling with CFG on the same
  noise, and a 2-window rollout, <= 1e-3; the ``sd21_vae`` decode.

The JAX model's parameters come from ``jax.eval_shape`` of its init (no
init is run) drawn with numpy, with the q/k/v biases set to zero: the
reference UNet has none, so neither has the port.
"""

import copy
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opendwm_tpu.config as jax_config
from opendwm_tpu.convert.torch_import import convert_ctsd_unet
from opendwm_tpu.models import layers as jax_layers
from opendwm_tpu.models import unet as jax_unet
from opendwm_tpu.models.autoencoders import sd21_vae as jax_sd21_vae
from opendwm_tpu.schedulers import DDIMScheduler as JaxDDIM
from opendwm_tpu.schedulers import DDPMScheduler as JaxDDPM
from opendwm_tpu_torch import config
from opendwm_tpu_torch.convert import (
    to_torch,
    unet_state_dict_from_flax,
    vae_state_dict_from_flax,
)
from opendwm_tpu_torch.models import layers, unet
from opendwm_tpu_torch.models.autoencoders import sd21_vae
from opendwm_tpu_torch.ops import flash_attention
from opendwm_tpu_torch.pipelines.ctsd import slice_batch_time_window
from opendwm_tpu_torch.schedulers import DDIMScheduler, DDPMScheduler

from torch_oracle_unet import UNetCrossviewTemporalOracle
from torch_port_helpers import random_flax_params

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-3
B, T, V, H, W = 1, 2, 2, 16, 16
TINY = dict(  # tests/test_unet.py widths
    in_channels=4, out_channels=4, block_out_channels=(8, 16, 16),
    layers_per_block=1, transformer_layers_per_block=1,
    num_attention_heads=(2, 2, 2), cross_attention_dim=12,
    addition_time_embed_dim=8, projection_class_embeddings_input_dim=24,
    merge_factor=2.0,
)


def _max_err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
                 .max())


def _zero_qkv_bias(tree):
    """The flax tree with the q/k/v biases zeroed, as a reference state
    dict converts (``convert_ctsd_unet``)."""
    out = {}
    for name, node in tree.items():
        if not isinstance(node, dict):
            out[name] = node
        elif name in ("to_q", "to_k", "to_v"):
            out[name] = dict(node, bias=np.zeros_like(node["bias"]))
        else:
            out[name] = _zero_qkv_bias(node)
    return out


def _params(init, seed: int, *args, **kwargs):
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), *args, **kwargs)
    tree = jax.tree.map(np.asarray, random_flax_params(shapes, seed))
    return _zero_qkv_bias(tree)


def _inputs(seed: int, b: int = B) -> dict:
    rng = np.random.default_rng(seed)
    inputs = dict(
        sample=rng.standard_normal((b, T, V, H, W, 4)),
        timestep=rng.uniform(0, 1000, (b, T, V)),
        encoder_hidden_states=rng.standard_normal((b, T, V, 5, 12)),
        added_time_ids=rng.standard_normal((b, T, V, 3)),
    )
    return {k: v.astype(np.float32) for k, v in inputs.items()}


def _jnp(tree: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _torch(tree: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


@pytest.fixture(scope="module", params=[True, False], ids=["rowwise", "full"])
def tiny_unet(request):
    """(JAX model, its apply, params, port model) of one tiny UNet."""
    cfg = dict(TINY, enable_rowwise_crossview=request.param,
               enable_rowwise_temporal=request.param)
    model = jax_unet.UNetCrossviewTemporal(**cfg)
    params = _params(model.init, 1, **_jnp(_inputs(0)))
    apply = jax.jit(lambda p, kw: model.apply(p, **kw))
    port = unet.UNetCrossviewTemporal(**cfg)
    port.load_state_dict(to_torch(unet_state_dict_from_flax(params)))
    return model, apply, params, port.eval()


# -- schedulers ---------------------------------------------------------------


@pytest.mark.parametrize("prediction", ["epsilon", "v_prediction", "sample"])
def test_ddpm_matches_jax(prediction):
    kw = dict(prediction_type=prediction, beta_schedule="scaled_linear",
              beta_end=0.012, beta_start=0.00085)
    jax_sched, sched = JaxDDPM(**kw), DDPMScheduler(**kw)
    np.testing.assert_array_equal(sched.alphas_cumprod,
                                  np.asarray(jax_sched.alphas_cumprod))
    np.testing.assert_array_equal(sched.betas, np.asarray(jax_sched.betas))
    rng = np.random.default_rng(1)
    x0, noise, out, step_noise = (
        rng.standard_normal((2, 3, 2, 4, 4, 2)).astype(np.float32)
        for _ in range(4))
    t = rng.integers(0, 1000, (2, 3, 2)).astype(np.int32)
    t[0, 0, 0] = 0  # the last ancestral step adds no noise
    def both(method, *arrays):
        return (getattr(sched, method)(*map(torch.from_numpy, arrays)),
                getattr(jax_sched, method)(*map(jnp.asarray, arrays)))

    pairs = [both("add_noise", x0, noise, t),
             both("training_target", x0, noise, t),
             both("pred_original", out, x0, t),
             both("step", out, t, x0, step_noise)]
    for got, ref in pairs:
        assert got.shape == ref.shape
        assert _max_err(got, ref) <= 1e-6


@pytest.mark.parametrize("prediction", ["epsilon", "v_prediction", "sample"])
@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_matches_jax(prediction, eta):
    kw = dict(prediction_type=prediction, set_alpha_to_one=eta > 0,
              steps_offset=1 if eta > 0 else 0)
    jax_sched, sched = JaxDDIM(**kw), DDIMScheduler(**kw)
    for n in (4, 50):
        np.testing.assert_array_equal(sched.timesteps(n),
                                      jax_sched.timesteps(n))
    rng = np.random.default_rng(2)
    out, sample, noise = (rng.standard_normal((2, 3, 2, 4, 4, 2))
                          .astype(np.float32) for _ in range(3))
    ts = sched.timesteps(4)
    t = ts[rng.integers(0, 4, (2, 3, 2))]  # every frame at its own step
    got = sched.step(torch.from_numpy(out), torch.from_numpy(t),
                     torch.from_numpy(sample), 4, eta=eta,
                     noise=torch.from_numpy(noise))
    ref = jax_sched.step(jnp.asarray(out), jnp.asarray(t),
                         jnp.asarray(sample), 4, eta=eta,
                         noise=jnp.asarray(noise))
    assert got.dtype == torch.float32
    assert _max_err(got, ref) <= 1e-6


def test_ddim_refuses_float_timesteps_as_jax_does():
    x = np.zeros((1, 2, 2, 2, 2, 2), np.float32)
    t = np.full((1, 2, 2), 250.0, np.float32)
    with pytest.raises(TypeError, match="Indexer must have integer"):
        JaxDDIM().step(jnp.asarray(x), jnp.asarray(t), jnp.asarray(x), 4)
    with pytest.raises(TypeError, match="integers"):
        DDIMScheduler().step(torch.from_numpy(x), torch.from_numpy(t),
                             torch.from_numpy(x), 4)


def test_scheduler_aliases_resolve():
    for name, cls in (("dwm.schedulers.temporal_independent.DDIMScheduler",
                       DDIMScheduler),
                      ("dwm.schedulers.temporal_independent.DDPMScheduler",
                       DDPMScheduler),
                      ("diffusers.DDIMScheduler", DDIMScheduler)):
        sched = config.create_instance_from_config(
            {"_class_name": name, "prediction_type": "v_prediction"})
        assert type(sched) is cls and sched.prediction_type == "v_prediction"


# -- modules ------------------------------------------------------------------


@pytest.mark.parametrize("cross", [False, True])
def test_temporal_basic_transformer_block_matches_jax(cross):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 20, 16)).astype(np.float32)
    ctx = rng.standard_normal((6, 7, 12)).astype(np.float32)
    block = jax_layers.TemporalBasicTransformerBlock(
        heads=2, head_dim=8, use_cross_attention=cross)
    args = (jnp.asarray(x), jnp.asarray(ctx) if cross else None)
    params = _params(block.init, 4, *args)
    ref = block.apply(params, *args)
    port = layers.TemporalBasicTransformerBlock(
        16, 2, 8, use_cross_attention=cross,
        cross_attention_dim=12 if cross else None)
    port.load_state_dict(to_torch(unet_state_dict_from_flax(params)))
    with torch.no_grad():
        out = port(torch.from_numpy(x),
                   torch.from_numpy(ctx) if cross else None)
    assert _max_err(out, ref) <= 1e-5


def test_transformer_model_group_norm_pools_per_image():
    """Views and frames at very different scales: statistics pooled across
    (t, v) would normalise them together (the bug of docs/PARITY.md)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 2, 3, 4, 4, 16)).astype(np.float32)
    x *= np.array([1.0, 30.0, 0.1], np.float32)[None, None, :, None, None,
                                                  None]
    x[:, 1] += 5.0
    ctx = rng.standard_normal((1, 2, 3, 5, 12)).astype(np.float32)
    off = np.zeros((1,), bool)
    model = jax_unet.TransformerModel(heads=2, head_dim=8)
    args = [jnp.asarray(a) for a in (x, ctx, off, off)]
    params = _params(model.init, 6, *args)
    ref = model.apply(params, *args)
    port = unet.TransformerModel(16, 2, 8, cross_attention_dim=12)
    port.load_state_dict(to_torch(unet_state_dict_from_flax(params)))
    with torch.no_grad():
        out = port(*(torch.from_numpy(a) for a in (x, ctx, off, off)))
    assert _max_err(out, ref) <= 1e-4 * np.abs(np.asarray(ref)).max()


def test_tiny_unet_matches_jax(tiny_unet):
    _, apply, params, port = tiny_unet
    inputs = _inputs(7)
    ref = np.asarray(apply(params, _jnp(inputs)))
    with torch.no_grad():
        out = port(**_torch(inputs))
    assert out.shape == ref.shape == (B, T, V, H, W, 4)
    assert _max_err(out, ref) <= TOL


def test_tiny_unet_disable_flags_match_jax(tiny_unet):
    _, apply, params, port = tiny_unet
    inputs = _inputs(8, b=2)
    flags = {"disable_crossview": np.array([True, False]),
             "disable_temporal": np.array([False, True])}
    ref = np.asarray(apply(params, _jnp({**inputs, **flags})))
    with torch.no_grad():
        out = port(**_torch({**inputs, **flags}))
    assert _max_err(out, ref) <= TOL


def test_tiny_unet_single_view_sample_matches_jax(tiny_unet):
    _, apply, params, port = tiny_unet
    inputs = {k: v[:, :, 0] for k, v in _inputs(9).items()}
    ref = np.asarray(apply(params, _jnp(inputs)))
    with torch.no_grad():
        out = port(**_torch(inputs))
    assert out.shape == ref.shape == (B, T, H, W, 4)
    assert _max_err(out, ref) <= TOL


def test_tiny_unet_routes_level0_self_attention_to_flash(monkeypatch):
    """One transformer per resnet: 1 in down_blocks.0 and 2 in the last up
    block attend over the 256 level-0 tokens through the flash branch (at
    the CTSD-2.1 geometry: 2 + 3 per forward, 1792 tokens)."""
    seen = []
    plain = flash_attention.flash_attention_plain

    def counting(q, k, v, scale, causal=False, segment_ids=None):
        assert segment_ids is None  # the model never passes segment ids
        seen.append((tuple(q.shape), tuple(k.shape), causal))
        return plain(q, k, v, scale, causal)

    monkeypatch.setattr(flash_attention, "flash_attention_plain", counting)
    torch.manual_seed(0)
    model = unet.UNetCrossviewTemporal(**TINY).eval()
    with torch.no_grad():
        model(**_torch(_inputs(10)))
    assert seen == [((B * T * V, H * W, 2, 4),) * 2 + (False,)] * 3


def test_unet_weight_bridge_round_trip():
    """Reference state dict → flax (``convert_ctsd_unet``) → port state dict
    gives the reference's keys and values back, Conv3d kernels included,
    and the port model takes them strictly."""
    torch.manual_seed(0)
    oracle = UNetCrossviewTemporalOracle(
        in_channels=4, block_out_channels=(8, 16, 16), layers_per_block=1,
        num_attention_heads=(2, 2, 2), cross_attention_dim=12,
        addition_time_embed_dim=8, projection_class_embeddings_input_dim=24)
    sd = {k: v.numpy() for k, v in oracle.state_dict().items()}
    back = unet_state_dict_from_flax(convert_ctsd_unet(sd))
    assert sd.keys() == back.keys()
    for k in sd:
        np.testing.assert_array_equal(sd[k], back[k], err_msg=k)
    assert back["down_blocks.0.resnets.0.temporal_res_block.conv1.weight"] \
        .shape == (8, 8, 3, 1, 1)
    port = unet.UNetCrossviewTemporal(**TINY)
    port.load_state_dict(to_torch(back))

    params = convert_ctsd_unet(sd)
    node = params["params"]["mid_block"]["attentions_0"][
        "transformer_blocks_0"]["attn1"]["to_q"]
    node["bias"] = node["bias"] + 0.5
    with pytest.raises(ValueError, match="nonzero bias"):
        unet_state_dict_from_flax(params)


def test_unported_unet_options_raise():
    for option in ({"condition_image_adapter_config": {"in_channels": 6}},
                   {"depth_net_config": {}}, {"quantization": "int8"}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            unet.UNetCrossviewTemporal(**TINY, **option)


def test_ctsd21_config_resolves_to_port_classes():
    cfg = json.loads((REPO / "configs/ctsd/multi_datasets/"
                      "ctsd_21_tirda_nwao.json").read_text())["pipeline"]
    with torch.device("meta"):
        pipe = config.create_instance_from_config(cfg)
    model = pipe.model
    assert isinstance(model, unet.UNetCrossviewTemporal)
    assert model.dtype == torch.bfloat16
    assert [len(b.resnets) for b in model.down_blocks] == [2, 2, 2, 2]
    assert [b.attentions is None for b in model.up_blocks] == \
        [True, False, False, False]
    # 1 fps + 4 intrinsic + 12 extrinsic ids, 256 features each, as the JAX
    # model infers it (the config's projection_class_embeddings_input_dim
    # says 2816)
    assert model.add_embedding.linear_1.in_features == 17 * 256
    assert pipe.model_type == "unet"
    assert isinstance(pipe.test_scheduler, DDIMScheduler)
    assert isinstance(pipe.train_scheduler, DDPMScheduler)
    assert pipe.test_scheduler.prediction_type == "v_prediction"
    # its tiny sibling (the same pipeline config, the tiny UNet) trains: the
    # DDPM v-prediction loss of one batch is finite
    cfg["model"] = dict(TINY, _class_name=cfg["model"]["_class_name"])
    cfg["common_config"].pop("added_time_ids")
    tiny = config.create_instance_from_config(cfg)
    g = torch.Generator().manual_seed(0)
    loss, _ = tiny.loss_fn({
        "latents": torch.randn(1, 2, 2, 8, 8, 4, generator=g),
        "encoder_hidden_states": torch.randn(1, 2, 2, 5, 12, generator=g),
    }, g)
    assert loss.ndim == 0 and torch.isfinite(loss)


# -- pipeline -----------------------------------------------------------------

P_H = P_W = 8  # pipeline latents
TOTAL_FRAMES = 3  # two windows of 2 frames, 1 reference frame
COMMON = {
    "frame_prediction_style": "ctsd",
    "added_time_ids": "fps_camera_transforms",
    "camera_intrinsic_embedding_indices": [0, 4, 2, 5],
    "camera_intrinsic_denom_embedding_indices": [0, 1, 0, 1],
    "camera_transform_embedding_indices": [3, 7, 11],
}


def _pipeline_config() -> dict:
    cfg = json.loads((REPO / "configs/ctsd/multi_datasets/"
                      "ctsd_21_tirda_nwao.json").read_text())["pipeline"]
    model = {k: v for k, v in TINY.items()}
    model.update(_class_name=cfg["model"]["_class_name"],
                 enable_rowwise_crossview=True, enable_rowwise_temporal=True)
    cfg["model"] = model
    cfg["common_config"] = dict(COMMON)
    # 2 steps: few large DDIM steps under CFG 3 amplify any fp32 difference,
    # in the JAX package as in the port, and the rollout's second window
    # starts from the first (test_ddim_gap_is_the_reference_amplification)
    cfg["inference_config"] = {"inference_steps": 2, "guidance_scale": 3.0}
    return cfg


def _batch(rng) -> dict:
    intr = np.tile(np.array([[20.0, 0, 32], [0, 20.0, 32], [0, 0, 1]]),
                   (B, TOTAL_FRAMES, V, 1, 1))
    transforms = np.tile(np.eye(4), (B, TOTAL_FRAMES, V, 1, 1))
    transforms[..., :3, 3] = rng.standard_normal((B, TOTAL_FRAMES, V, 3))
    batch = {
        "encoder_hidden_states": rng.standard_normal(
            (B, TOTAL_FRAMES, V, 5, 12)),
        "camera_intrinsics": intr,
        "camera_transforms": transforms,
        "image_size": np.tile(np.array([64.0, 64.0]), (B, 1, V, 1)),
        "fps": np.full((B,), 10.0),
    }
    return {k: v.astype(np.float32) for k, v in batch.items()}


@dataclasses.dataclass(frozen=True)
class _IntTimestepDDIM(JaxDDIM):
    """The JAX DDIM with its timesteps cast back to integers: the JAX
    pipeline's reference-frame injection makes them floats (fault logged in
    ROADMAP Queue 3); the port keeps them integers."""

    def step(self, model_output, timesteps, sample, num_inference_steps,
             eta=0.0, noise=None):
        return super().step(model_output,
                            jnp.asarray(timesteps).astype(jnp.int32), sample,
                            num_inference_steps, eta, noise)


@pytest.fixture(scope="module")
def pipelines():
    cfg = _pipeline_config()
    jax_pipe = jax_config.create_instance_from_config(copy.deepcopy(cfg))
    port_pipe = config.create_instance_from_config(copy.deepcopy(cfg))
    batch = _batch(np.random.default_rng(0))
    window = {k: v[:, :T] if v.ndim > 1 and v.shape[1] == TOTAL_FRAMES
              else v for k, v in batch.items()}
    from opendwm_tpu.pipelines.ctsd import get_conditions as jax_conditions

    conds = jax_conditions(_jnp(window), COMMON)
    params = _params(jax_pipe.model.init, 11,
                     sample=jnp.zeros((B, T, V, P_H, P_W, 4)),
                     timestep=jnp.zeros((B, T, V)), **conds)
    port_pipe.model.load_state_dict(
        to_torch(unet_state_dict_from_flax(params)))
    port_pipe.model.eval()
    return jax_pipe, params, port_pipe, batch


def test_pipeline_ddim_cfg_matches_jax(pipelines):
    jax_pipe, params, port_pipe, batch = pipelines
    shape = (B, T, V, P_H, P_W, 4)
    window = slice_batch_time_window(_torch(batch), 0, T)
    rng = jax.random.PRNGKey(3)
    ref = jax_pipe.inference_pipeline(
        params, {k: jnp.asarray(v.numpy()) for k, v in window.items()},
        shape, rng)
    noise = torch.tensor(np.asarray(jax.random.normal(rng, shape)))
    out = port_pipe.inference_pipeline(window, shape, noise=noise)
    assert out.shape == ref.shape and torch.isfinite(out).all()
    assert _max_err(out, ref) <= TOL


def test_ddim_gap_is_the_reference_amplification(pipelines, monkeypatch):
    """Attributes the DDIM pipeline's port-vs-JAX gap (ROADMAP Queue 3) at
    3 steps under CFG 3: the JAX pipeline, run against itself with its
    initial latents moved by 1e-5 N(0, 1), moves ~80 times as far as the
    largest move (the few large DDIM v-prediction steps amplify any
    difference), and the port moves the same. The port's gap to JAX at 3
    steps stays inside the 1e-3 bar and below that amplified 1e-5: the
    reference's own sensitivity, not a port fault. The 2-window rollout
    (``test_rollout_matches_jax_with_integer_timesteps``) stays at 2 steps:
    its second window starts from the first window's output, whose gap it
    amplifies again."""
    jax_pipe, params, port_pipe, batch = pipelines
    for pipe in (jax_pipe, port_pipe):
        monkeypatch.setattr(pipe, "inference_config",
                            dict(pipe.inference_config, inference_steps=3))
    shape = (B, T, V, P_H, P_W, 4)
    window = slice_batch_time_window(_torch(batch), 0, T)
    jax_window = {k: jnp.asarray(v.numpy()) for k, v in window.items()}
    rng = jax.random.PRNGKey(3)
    noise = np.asarray(jax.random.normal(rng, shape))
    move = np.random.default_rng(5).standard_normal(shape).astype(
        np.float32) * 1e-5
    normal = jax.random.normal

    def jax_run(delta):
        monkeypatch.setattr(jax.random, "normal", lambda key, s, dtype=(
            jnp.float32): normal(key, s, dtype) + jnp.asarray(delta))
        out = np.asarray(jax_pipe.inference_pipeline(
            params, jax_window, shape, rng))
        monkeypatch.setattr(jax.random, "normal", normal)
        return out

    def port_run(delta):
        return port_pipe.inference_pipeline(
            window, shape, noise=torch.from_numpy(noise + delta)).numpy()

    ref, ref_moved = jax_run(np.zeros_like(move)), jax_run(move)
    out, out_moved = port_run(np.zeros_like(move)), port_run(move)
    jax_moves, port_moves = _max_err(ref_moved, ref), _max_err(out_moved, out)
    gap = _max_err(out, ref)
    assert jax_moves >= 30 * np.abs(move).max()
    assert 0.5 * jax_moves <= port_moves <= 2 * jax_moves
    assert gap <= TOL and gap <= 0.2 * jax_moves


def test_jax_rollout_crashes_on_float_timesteps(pipelines):
    """Pins ROADMAP Queue 3's DDIM fault: with reference frames injected,
    ``jnp.where(ref_mask, 0.0, timesteps)`` makes the DDIM timesteps
    float32 and the table lookup refuses them."""
    jax_pipe, params, _, batch = pipelines
    shape = (B, T, V, P_H, P_W, 4)
    window = {k: v[:, :T] if v.ndim > 1 and v.shape[1] == TOTAL_FRAMES
              else v for k, v in batch.items()}
    with pytest.raises(TypeError, match="Indexer must have integer"):
        jax_pipe.inference_pipeline(
            params, _jnp(window), shape, jax.random.PRNGKey(0),
            image_latents=jnp.zeros(shape), reference_frame_count=1)


def test_rollout_matches_jax_with_integer_timesteps(pipelines):
    jax_pipe, params, port_pipe, batch = pipelines
    shape = (B, T, V, P_H, P_W, 4)
    saved = jax_pipe.test_scheduler
    jax_pipe.test_scheduler = _IntTimestepDDIM(
        **{f.name: getattr(saved, f.name)
           for f in dataclasses.fields(saved)})
    try:
        rng = jax.random.PRNGKey(4)
        ref = jax_pipe.autoregressive_inference_pipeline(
            params, _jnp(batch), shape, rng, total_frames=TOTAL_FRAMES)
    finally:
        jax_pipe.test_scheduler = saved
    noise = []
    for _ in range(2):  # the JAX rollout's per-window draws
        rng, step_rng = jax.random.split(rng)
        noise.append(torch.tensor(np.asarray(
            jax.random.normal(step_rng, shape))))
    out = port_pipe.autoregressive_inference_pipeline(
        _torch(batch), shape, total_frames=TOTAL_FRAMES, noise=noise)
    assert out.shape == ref.shape == (B, TOTAL_FRAMES, V, P_H, P_W, 4)
    assert _max_err(out, ref) <= TOL


def test_sd21_vae_decode_matches_jax():
    """``sd21_vae`` at full width (4 latent channels, quant convs, scale
    0.18215) decoding scaled 4x6 latents to 32x48 frames."""
    jax_vae, port_vae = jax_sd21_vae(), sd21_vae()
    params = random_flax_params(jax.eval_shape(
        jax_vae.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 48, 3))), 12)
    port_vae.load_state_dict(to_torch(vae_state_dict_from_flax(params)))
    z = np.random.default_rng(13).standard_normal((1, 2, 2, 4, 6, 4)) \
        .astype(np.float32) * 0.18215
    ref = np.asarray(jax.jit(jax_vae.decode_from_scaled)(params,
                                                         jnp.asarray(z)))
    with torch.no_grad():
        out = port_vae.decode_from_scaled(torch.from_numpy(z), chunk_size=3)
    assert out.shape == ref.shape == (1, 2, 2, 32, 48, 3)
    assert _max_err(out, ref) <= TOL
