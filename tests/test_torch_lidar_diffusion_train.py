"""The port's LiDAR diffusion training and its LiDAR UNet path
(``opendwm_tpu_torch/pipelines/lidar_diffusion.py`` over
``models/vae_point_cloud.py`` and the UNet) against the JAX package's on
the CPU in fp32, on JAX's own draws.

- The LiDAR DiT (VQ tokenizer, temporal ``rowwise`` branches, the layout
  adapter): the loss within 1e-5 relative and each gradient within 1e-4
  in relative norm (or, where JAX's own fp32 gradient is further than
  5e-5 from the float64 one, within twice that distance of JAX's and
  within 1e-4 of the float64 one: ``torch_port_helpers.check_grad_dicts``).
- The LiDAR UNet (``configs/lidar/lidar_diffusion_unet_temporal_ns.json``
  in small: a ``VAEPointCloud`` and a 2-level UNet with cross-view over
  its one view and rowwise temporal, DDPM ``v_prediction`` training and
  DDIM sampling): ``encode_points`` (the posterior mean), ``decode_points``
  (no quantization), a 2-step DDIM generation with CFG and one train step
  within 1e-3 (the whole pipelines' bar); the voxels as JAX's. The JAX
  UNet's q/k/v biases are zeroed (the reference UNet has none) and frozen
  in its train step; the port's ``add_embedding`` has no counterpart in
  JAX's tree (no ``added_time_ids``: flax never builds it) and takes no
  gradient.
"""

import copy
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendwm_tpu.config import create_instance_from_config as jax_create
from opendwm_tpu.models import vq_point_cloud as jvq
from opendwm_tpu.models.mmdit import DiTCrossviewTemporal as JaxDiT
from opendwm_tpu.ops.voxelize import Voxelizer as JaxVoxelizer
from opendwm_tpu.pipelines.ctsd import TrainState as JaxTrainState
from opendwm_tpu.pipelines.ctsd import get_conditions as jax_conditions
from opendwm_tpu.pipelines.lidar_diffusion import (
    LidarDiffusionPipeline as JaxPipeline,
)
from opendwm_tpu.schedulers import FlowMatchEulerScheduler as JaxFlow
from opendwm_tpu_torch.config import create_instance_from_config
from opendwm_tpu_torch.convert import (
    dit_state_dict_from_flax,
    lidar_state_dict_from_flax,
    to_torch,
    unet_state_dict_from_flax,
)
from opendwm_tpu_torch.models import vq_point_cloud as tvq
from opendwm_tpu_torch.models.mmdit import DiTCrossviewTemporal
from opendwm_tpu_torch.models.vae_point_cloud import VAEPointCloud
from opendwm_tpu_torch.ops.voxelize import Voxelizer
from opendwm_tpu_torch.pipelines.lidar_diffusion import LidarDiffusionPipeline
from opendwm_tpu_torch.schedulers import FlowMatchEulerScheduler

from torch_port_helpers import (
    check_grad_dicts,
    check_update_dicts,
    flax_init,
    jax_training_draws,
    load_lidar,
    random_flax_params,
    recording_tx,
    redraw_gates,
    rel,
)

REPO = Path(__file__).resolve().parents[1]
LOSS_TOL = 1e-5
PIPE_TOL = 1e-3


def t(x):
    return torch.from_numpy(np.array(x))


def tree_to_torch(batch):
    return {k: t(v) for k, v in batch.items()}


# -- the LiDAR DiT ----------------------------------------------------------

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
TRAIN = {"all_reference_visible_ratio": 0.5, "reference_latent_count": 1,
         "disable_reference_frame_loss": True, "max_norm_for_grad_clip": 1.0}


@pytest.fixture(scope="module")
def dit_pipes():
    key = jax.random.PRNGKey(0)
    batch = {
        "lidar_points": jax.random.uniform(key, (2, 3, 64, 3), minval=-3,
                                           maxval=3),
        "lidar_points_mask": jnp.ones((2, 3, 64), bool),
        "3dbox_bev_images": jax.random.uniform(
            jax.random.fold_in(key, 1), (6, IMG * 8, IMG * 8, 3)),
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
                     training_config=TRAIN, optimizer_config={"lr": 1e-3})
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

    def port(dtype=torch.float32):
        model = DiTCrossviewTemporal(**DIT)
        model.load_state_dict(to_torch(dit_state_dict_from_flax(params, 2)))
        tvqm = load_lidar(tvq.VQPointCloud(
            Voxelizer(**VOX), tvq.VectorQuantizer(16, E_DIM),
            tvq.VQEncoder(**ENC), tvq.VQDecoder(**DEC)), vq_params)
        tp = LidarDiffusionPipeline(
            model.to(dtype), tvqm.to(dtype), FlowMatchEulerScheduler(
                shift=1.0), FlowMatchEulerScheduler(shift=1.0),
            common_config=COMMON, training_config=TRAIN)
        return tp

    return jp, params, port, batch, lat.shape


@pytest.mark.parametrize("seed", [0, 5])
def test_dit_loss_and_gradients(dit_pipes, seed):
    jp, params, port, batch, shape = dit_pipes
    key = jax.random.PRNGKey(seed)
    (loss, _), grads = jax.jit(jax.value_and_grad(jp.loss_fn, has_aux=True))(
        params["params"], batch, key)
    draws = jax_training_draws(key, shape, TRAIN, COMMON)
    tp = port()
    tloss, metrics = tp.loss_from_draws(tree_to_torch(batch), draws)
    assert abs(float(tloss.detach()) - float(loss)) \
        <= LOSS_TOL * abs(float(loss))
    tloss.backward()

    tp64 = port(torch.float64)
    b64 = {k: v.double() if v.is_floating_point() else v
           for k, v in tree_to_torch(batch).items()}
    d64 = jax.tree.map(lambda a: a.double() if a.is_floating_point() else a,
                       draws)
    tp64.loss_from_draws(b64, d64)[0].backward()
    exact = {n: p.grad.numpy() for n, p in tp64.model.named_parameters()}
    got = {n: p.grad.numpy() for n, p in tp.model.named_parameters()}
    check_grad_dicts(got, dit_state_dict_from_flax(grads, 2), exact)
    assert not any(p.grad is not None for p in tp.autoencoder.parameters())


# -- the LiDAR UNet over VAEPointCloud ----------------------------------------

UNET_CONFIG = REPO / "configs/lidar/lidar_diffusion_unet_temporal_ns.json"
LATENT, UIMG, B, FRAMES = 8, 32, 1, 3
QKV_BIAS = r".*\.to_[qkv]\.bias$"


def unet_pipeline_config() -> dict:
    """The LiDAR UNet config in small: a 2-level UNet and a tokenizer of
    4 x 4 latents; everything else (cross-view on over one view, rowwise
    temporal, DDPM/DDIM v-prediction, the training config) as it is."""
    cfg = json.loads(UNET_CONFIG.read_text())["pipeline"]
    model = cfg["model"]
    del model["dtype"]
    model.update(in_channels=LATENT, out_channels=LATENT,
                 block_out_channels=[8, 16], layers_per_block=1,
                 num_attention_heads=[2, 2], cross_attention_dim=12,
                 addition_time_embed_dim=8,
                 projection_class_embeddings_input_dim=24)
    ae = cfg["autoencoder"]
    ae["voxelizer"].update(x_min=-8.0, x_max=8.0, y_min=-8.0, y_max=8.0,
                           step=0.5, z_min=-1.0, z_max=1.0, z_step=0.25)
    ae["lidar_encoder"].update(img_size=UIMG, in_chans=8, embed_dim=8,
                               num_heads=2, depth=6,
                               codebook_dim=2 * LATENT, window_size=2)
    ae["lidar_decoder"].update(img_size=UIMG, in_chans=8, embed_dim=8,
                               num_heads=2, depth=4, codebook_dim=LATENT,
                               window_size=2, density_feats=4)
    ae.update(latent_dim=LATENT, ray_max_steps=32)
    cfg["common_config"].update(text_embeddings_dim=12,
                                pooled_text_embeddings_dim=8,
                                distribution_framework="ddp")
    cfg["inference_config"]["inference_steps"] = 2
    cfg["sharding_policy"] = "ddp"
    return cfg


def _zero_qkv_bias(tree):
    out = {}
    for name, node in tree.items():
        if not isinstance(node, dict):
            out[name] = node
        elif name in ("to_q", "to_k", "to_v"):
            out[name] = dict(node, bias=np.zeros_like(node["bias"]))
        else:
            out[name] = _zero_qkv_bias(node)
    return out


@pytest.fixture(scope="module")
def unet_pipes():
    cfg = unet_pipeline_config()
    jax_cfg = copy.deepcopy(cfg)
    jax_cfg["training_config"]["freezing_pattern"] = QKV_BIAS
    jp = jax_create(jax_cfg)
    jp.tx = recording_tx(jp.tx)
    rng = np.random.default_rng(0)
    pts = rng.uniform(-8, 8, (B, FRAMES, 300, 3)).astype(np.float32)
    pts[..., 2] = rng.uniform(-1, 1, (B, FRAMES, 300))
    batch = {"lidar_points": pts,
             "lidar_points_mask": np.ones((B, FRAMES, 300), bool)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ae_params = flax_init(jp.autoencoder, *jb.values(), seed=1)
    jp.load_autoencoder_params(ae_params)
    prepared = jp.prepare_batch(jb)
    conds = jax_conditions(prepared, jp.common_config)
    lat = prepared["latents"]
    shapes = jax.eval_shape(lambda: jp.model.init(
        jax.random.PRNGKey(0), sample=lat, timestep=jnp.zeros(lat.shape[:3]),
        **conds))
    params = {"params": _zero_qkv_bias(jax.tree.map(
        lambda a: np.asarray(a, np.float32),
        random_flax_params(shapes, 2))["params"])}

    def port():
        tp = create_instance_from_config(copy.deepcopy(cfg))
        missing, unexpected = tp.model.load_state_dict(
            to_torch(unet_state_dict_from_flax(params)), strict=False)
        assert not unexpected
        assert missing and all(k.startswith("add_embedding.")
                               for k in missing)
        tp.load_autoencoder_params(to_torch(
            lidar_state_dict_from_flax(ae_params)))
        return tp

    return jp, params, port, batch, jb


def test_unet_pipeline_encode_decode_generate(unet_pipes):
    jp, params, port, batch, jb = unet_pipes
    tp = port()
    assert isinstance(tp.autoencoder, VAEPointCloud)
    tb = tree_to_torch(batch)
    want_lat, want_vox = jp.encode_points(jb["lidar_points"],
                                          jb["lidar_points_mask"])
    got_lat, got_vox = tp.encode_points(tb["lidar_points"],
                                        tb["lidar_points_mask"])
    assert got_lat.shape == (B, FRAMES, 1, UIMG // 8, UIMG // 8, LATENT)
    assert rel(got_lat, want_lat) < LOSS_TOL
    np.testing.assert_array_equal(got_vox.numpy(), np.asarray(want_vox))
    # decode: the latents as they are (no quantization)
    key = jax.random.PRNGKey(3)
    vshape = (B * FRAMES, 8, UIMG, UIMG)
    uniforms = (t(jax.random.uniform(key, vshape)),
                t(jax.random.uniform(jax.random.fold_in(key, 1), vshape)))
    want = jp.decode_points(want_lat, key)
    got = tp.decode_points(got_lat, uniforms)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    rng = jax.random.PRNGKey(4)
    want = jp.generate(params, jb, rng)
    k_denoise, k_decode = jax.random.split(rng)
    noise = t(jax.random.normal(k_denoise, want["latents"].shape,
                                jnp.float32))
    uniforms = (t(jax.random.uniform(k_decode, vshape)),
                t(jax.random.uniform(jax.random.fold_in(k_decode, 1),
                                     vshape)))
    got = tp.generate(tb, noise=noise, voxel_uniforms=uniforms)
    assert rel(got["latents"], want["latents"]) < PIPE_TOL
    mismatch = float((got["pred_voxels"].numpy()
                      != np.asarray(want["pred_voxels"])).mean())
    assert mismatch <= 1e-3
    assert float(got["pred_voxels"].sum()) > 0


def test_unet_train_step(unet_pipes):
    """The loss and every gradient within 1e-3 (``check_grad_dicts`` with
    the port run in float64 for the sums that cancel, such as an
    AlphaBlender mix factor's; a parameter whose JAX gradient is below
    1e-6 of the global norm, such as a bias before a GroupNorm, has a
    gradient of 0 in exact arithmetic and fp32 noise in either package:
    the port's is held below 1e-5 of the global norm), then one step as
    ``check_update_dicts`` holds it."""
    jp, params, port, batch, jb = unet_pipes
    key = jax.random.PRNGKey(7)
    jparams = jax.tree.map(jnp.asarray, params)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                          opt_state=jp.tx.init(jparams["params"]))
    new_state, metrics = jax.jit(jp._train_step_impl)(state, jb, key)
    grads = unet_state_dict_from_flax({"params": _zero_qkv_bias(
        jax.tree.map(np.asarray, new_state.opt_state[0]))})
    cfg = unet_pipeline_config()
    shape = (B, FRAMES, 1, UIMG // 8, UIMG // 8, LATENT)
    draws = jax_training_draws(
        key, shape, cfg["training_config"], cfg["common_config"],
        num_train_timesteps=cfg["train_scheduler"]["num_train_timesteps"])

    def port_grads(dtype):
        tp = port()
        tp.model.to(dtype)
        tp.autoencoder.to(dtype)
        b = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in tree_to_torch(batch).items()}
        d = jax.tree.map(
            lambda a: a.to(dtype) if a.is_floating_point() else a, draws)
        loss, _ = tp.loss_from_draws(b, d)
        loss.backward()
        return loss, {n: p.grad for n, p in tp.model.named_parameters()}

    loss, got = port_grads(torch.float32)
    assert abs(float(loss.detach()) - float(metrics["sd_loss"])) \
        <= PIPE_TOL * float(metrics["sd_loss"])
    exact = {n: g.numpy() for n, g in port_grads(torch.float64)[1].items()
             if g is not None}
    total = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                        for g in grads.values()))
    exact_zero = []  # e.g. the cross-view queries: one view, one key
    held = {}
    for name, g in got.items():
        if name.startswith("add_embedding."):
            assert g is None
            continue
        if np.linalg.norm(grads[name]) < 1e-6 * total:  # 0 in exact math
            assert np.linalg.norm(g.numpy()) < 1e-5 * total, name
            exact_zero.append(name)
        else:
            held[name] = g.numpy()
    check_grad_dicts(held, {n: grads[n] for n in held}, exact, PIPE_TOL)

    tp = port()
    old = {n: p.detach().clone().numpy()
           for n, p in tp.model.named_parameters()}
    tstate = tp.init_state()
    assert not any(p.requires_grad for p in tp.autoencoder.parameters())
    tstate, tmetrics = tp.train_step(tstate, tree_to_torch(batch),
                                     draws=draws)
    assert tstate.step == 1
    # JAX's grad_norm also counts its zeroed (frozen) q/k/v biases'
    # gradients, which the port has not; the clipping sees the trainable
    # ones in both
    ref = unet_state_dict_from_flax(new_state.params)
    got = {n: p.detach().numpy() for n, p in tp.model.named_parameters()
           if not n.startswith("add_embedding.")}
    assert exact_zero
    grads = {n: 0.0 * g if n in exact_zero else g for n, g in grads.items()}
    check_update_dicts(got, old, {n: ref[n] for n in got}, grads,
                       cfg["optimizer_config"]["lr"],
                       cfg["training_config"]["max_norm_for_grad_clip"],
                       param_tol=PIPE_TOL,
                       update_tol=PIPE_TOL)
