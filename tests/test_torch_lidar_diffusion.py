"""The port's LiDAR DiT path (``opendwm_tpu_torch/models/mmdit.py``'s
temporal ``rowwise`` branch, ``opendwm_tpu_torch/pipelines/
lidar_diffusion.py``) against the JAX package's on the CPU in fp32.

- A tiny DiT with temporal ``rowwise`` branches (each latent row attends
  over its frames' rows: sequences of t·gw tokens) and the layout adapter:
  output within 1e-3 in relative norm; ``full`` still raises.
- ``LidarDiffusionPipeline``: ``prepare_batch``'s conditions (a zero text
  context of one token, zero pooled projections, the BEV rasters as
  ``3dbox_images``), ``encode_points``, and ``generate`` at 2 flow-match
  steps with CFG and one injected reference frame, fed JAX's initial noise
  and Gumbel-sigmoid uniforms: latents within 1e-3, the same voxels.
- Training runs with the tokenizer frozen; a tokenizer that is neither
  LiDAR autoencoder raises.
- The repo's LiDAR DiT config builds through the port's registry.
"""

import copy
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendwm_tpu.models import vq_point_cloud as jvq
from opendwm_tpu.models.mmdit import DiTCrossviewTemporal as JaxDiT
from opendwm_tpu.ops.voxelize import Voxelizer as JaxVoxelizer
from opendwm_tpu.pipelines.ctsd import get_conditions as jax_conditions
from opendwm_tpu.pipelines.lidar_diffusion import (
    LidarDiffusionPipeline as JaxPipeline,
)
from opendwm_tpu.schedulers import FlowMatchEulerScheduler as JaxFlow
from opendwm_tpu_torch.config import create_instance_from_config
from opendwm_tpu_torch.convert import dit_state_dict_from_flax, to_torch
from opendwm_tpu_torch.models import vq_point_cloud as tvq
from opendwm_tpu_torch.models.mmdit import DiTCrossviewTemporal
from opendwm_tpu_torch.ops.voxelize import Voxelizer
from opendwm_tpu_torch.pipelines.lidar_diffusion import LidarDiffusionPipeline
from opendwm_tpu_torch.schedulers import FlowMatchEulerScheduler

from torch_port_helpers import (
    flax_init,
    load_lidar,
    random_flax_params,
    redraw_gates,
    rel,
)

REPO = Path(__file__).resolve().parents[1]
REL_TOL = 1e-3
IMG, ZC, E_DIM = 16, 8, 16
VOX = dict(x_min=-4.0, x_max=4.0, y_min=-4.0, y_max=4.0, step=0.5,
           z_min=-1.0, z_max=1.0, z_step=0.25)
ENC = dict(img_size=IMG, patch_size=8, in_chans=ZC, embed_dim=8,
           num_heads=2, depth=6, codebook_dim=E_DIM, window_size=2)
DEC = dict(ENC, depth=4, density_feats=4)
DIT = dict(
    patch_size=1, num_layers=2, attention_head_dim=8, num_attention_heads=2,
    in_channels=E_DIM, out_channels=E_DIM, joint_attention_dim=24,
    caption_projection_dim=16, pooled_projection_dim=32,
    pos_embed_max_size=8, sample_size=2, dual_attention_layers=(),
    enable_crossview=False, enable_temporal=True,
    temporal_attention_type="rowwise", temporal_block_layers=(0, 1),
    qk_norm_on_additional_modules="rms_norm",
    condition_image_adapter_config=dict(
        in_channels=3, channels=[16, 16], is_downblocks=[True, False],
        num_res_blocks=1, downscale_factor=32, use_zero_convs=True))
COMMON = {"text_embeddings_dim": 24, "pooled_text_embeddings_dim": 32,
          "latent_scale": 2.0, "latent_bias": 0.1,
          "frame_prediction_style": "ctsd"}
INFERENCE = {"inference_steps": 2, "guidance_scale": 2.0}


def t(x):
    return torch.from_numpy(np.array(x))


def test_rowwise_temporal_dit():
    rng = np.random.default_rng(0)
    b, frames, v, h, w = 1, 3, 1, 4, 6
    cfg = dict(DIT, patch_size=2, in_channels=8, out_channels=8,
               pos_embed_max_size=8, sample_size=4,
               condition_image_adapter_config=dict(
                   DIT["condition_image_adapter_config"],
                   downscale_factor=8))
    inputs = dict(
        sample=rng.standard_normal((b, frames, v, h, w, 8)),
        timestep=rng.uniform(0, 1000, (b, frames, v)),
        encoder_hidden_states=rng.standard_normal((b, frames, v, 3, 24)),
        pooled_projections=rng.standard_normal((b, frames, v, 32)),
        condition_image_tensor=rng.uniform(size=(b, frames, v, 8 * h, 8 * w,
                                                 3)))
    inputs = {k: a.astype(np.float32) for k, a in inputs.items()}
    jm = JaxDiT(**cfg)
    jargs = {k: jnp.asarray(a) for k, a in inputs.items()}
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), **jargs))
    params = jax.tree.map(lambda a: np.asarray(a, np.float32),
                          random_flax_params(shapes, 1))
    params = {"params": redraw_gates(params["params"],
                                     np.random.default_rng(2))}
    # the zero convs drawn non-zero, so the adapter reaches the output
    want = jm.apply(params, **jargs)
    tm = DiTCrossviewTemporal(**cfg)
    tm.load_state_dict(to_torch(dit_state_dict_from_flax(params, 2)))
    got = tm(**{k: t(a) for k, a in inputs.items()}).detach()
    assert got.shape == inputs["sample"].shape
    assert rel(got, want) < REL_TOL
    with pytest.raises(ValueError, match="temporal_attention_type"):
        DiTCrossviewTemporal(**dict(cfg, temporal_attention_type="diagonal"))


@pytest.fixture(scope="module")
def pipes():
    key = jax.random.PRNGKey(0)
    batch = {
        "lidar_points": jax.random.uniform(key, (1, 3, 64, 3), minval=-3,
                                           maxval=3),
        "lidar_points_mask": jnp.ones((1, 3, 64), bool),
        "3dbox_bev_images": jax.random.uniform(
            jax.random.fold_in(key, 1), (3, IMG * 8, IMG * 8, 3)),
    }
    jvqm = jvq.VQPointCloud(
        voxelizer=JaxVoxelizer(**VOX),
        vector_quantizer=jvq.VectorQuantizer(n_e=16, e_dim=E_DIM),
        lidar_encoder=jvq.VQEncoder(**ENC),
        lidar_decoder=jvq.VQDecoder(**DEC))
    vq_params = flax_init(jvqm, batch["lidar_points"],
                          batch["lidar_points_mask"], seed=1,
                          render_rays=False)
    jp = JaxPipeline(model=JaxDiT(**DIT), autoencoder=jvqm,
                     train_scheduler=JaxFlow(shift=1.0),
                     test_scheduler=JaxFlow(shift=1.0), common_config=COMMON,
                     inference_config=INFERENCE,
                     optimizer_config={"lr": 1e-3})
    jp.load_autoencoder_params(vq_params)
    prepared = jp.prepare_batch(batch)
    prepared["3dbox_images"] = prepared.pop("condition_image_tensor_override")
    conds = jax_conditions(prepared, jp.common_config)
    lat = prepared["latents"]
    shapes = jax.eval_shape(lambda: jp.model.init(
        jax.random.PRNGKey(0), sample=lat, timestep=jnp.zeros(lat.shape[:3]),
        **conds))
    params = jax.tree.map(lambda a: np.asarray(a, np.float32),
                          random_flax_params(shapes, 2))
    params = {"params": redraw_gates(params["params"],
                                     np.random.default_rng(3))}

    model = DiTCrossviewTemporal(**DIT)
    model.load_state_dict(to_torch(dit_state_dict_from_flax(params, 2)))
    tvqm = load_lidar(tvq.VQPointCloud(
        Voxelizer(**VOX), tvq.VectorQuantizer(16, E_DIM),
        tvq.VQEncoder(**ENC), tvq.VQDecoder(**DEC)), vq_params)
    tp = LidarDiffusionPipeline(model, tvqm, FlowMatchEulerScheduler(
        shift=1.0), FlowMatchEulerScheduler(shift=1.0), common_config=COMMON,
        inference_config=INFERENCE)
    return jp, params, tp, batch, {k: t(v) for k, v in batch.items()}


def test_prepare_batch(pipes):
    jp, _, tp, batch, tbatch = pipes
    want = jp.prepare_batch(batch)
    got = tp.prepare_batch(tbatch)
    assert rel(got["latents"], want["latents"]) < REL_TOL
    np.testing.assert_array_equal(got["gt_voxels"].numpy(),
                                  np.asarray(want["gt_voxels"]))
    assert got["encoder_hidden_states"].shape == (1, 3, 1, 1, 24)
    assert got["pooled_projections"].shape == (1, 3, 1, 32)
    assert not got["encoder_hidden_states"].any()
    assert not got["pooled_projections"].any()
    np.testing.assert_array_equal(
        got["3dbox_images"].numpy(),
        np.asarray(want["condition_image_tensor_override"]))
    assert got["hdmap_images"] is None


def test_generate_matches_jax(pipes):
    jp, params, tp, batch, tbatch = pipes
    rng = jax.random.PRNGKey(4)
    image_latents = jp.encode_points(batch["lidar_points"],
                                     batch["lidar_points_mask"])[0]
    want = jp.generate(params, batch, rng, image_latents=image_latents,
                       reference_frame_count=1)
    k_denoise, k_decode = jax.random.split(rng)
    shape = want["latents"].shape
    noise = t(jax.random.normal(k_denoise, shape, jnp.float32))
    vshape = (3, ZC, IMG, IMG)
    uniforms = (t(jax.random.uniform(k_decode, vshape)),
                t(jax.random.uniform(jax.random.fold_in(k_decode, 1),
                                     vshape)))
    got = tp.generate(tbatch, noise=noise, voxel_uniforms=uniforms,
                      image_latents=t(image_latents),
                      reference_frame_count=1)
    assert rel(got["latents"], want["latents"]) < REL_TOL
    np.testing.assert_array_equal(got["pred_voxels"].numpy(),
                                  np.asarray(want["pred_voxels"]))
    np.testing.assert_array_equal(got["gt_voxels"].numpy(),
                                  np.asarray(want["gt_voxels"]))
    assert got["pred_voxels"].shape == (1, 3, ZC, IMG, IMG)
    # the reference frame is the encoded one
    torch.testing.assert_close(got["latents"][:, 0], t(image_latents)[:, 0])


def test_training_and_other_tokenizers_raise(pipes):
    """Training runs (held against JAX in
    test_torch_lidar_diffusion_train.py): a finite loss with the tokenizer
    frozen; a tokenizer that is neither LiDAR autoencoder raises."""
    tp, tbatch = pipes[2], pipes[4]
    pipe = copy.copy(tp)
    pipe.model = copy.deepcopy(tp.model)
    pipe.autoencoder = copy.deepcopy(tp.autoencoder)
    state = pipe.init_state()
    assert not any(p.requires_grad for p in pipe.autoencoder.parameters())
    loss, metrics = pipe.loss_fn(tbatch, torch.Generator().manual_seed(0))
    assert torch.isfinite(loss).item() and float(loss.detach()) > 0
    state, _ = pipe.train_step(state, tbatch,
                               torch.Generator().manual_seed(1))
    assert state.step == 1
    other = LidarDiffusionPipeline(tp.model, torch.nn.Linear(2, 2),
                                   tp.train_scheduler, tp.test_scheduler)
    with pytest.raises(ValueError, match="VAEPointCloud"):
        other.encode_points(None, None)


def test_config_builds():
    cfg = json.loads((REPO / "configs/lidar/lidar_diffusion_dit_temporal_ns"
                      ".json").read_text())["pipeline"]
    with torch.device("meta"):
        pipe = create_instance_from_config(cfg)
    assert isinstance(pipe, LidarDiffusionPipeline)
    assert pipe.model.temporal_attention_type == "rowwise"
    assert pipe.model.inner_dim == 1024 and pipe.model.dtype == torch.bfloat16
    assert isinstance(pipe.autoencoder, tvq.VQPointCloud)
    assert pipe.autoencoder.vector_quantizer.cosine_similarity
