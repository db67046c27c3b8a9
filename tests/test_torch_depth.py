"""The port's depth branch (``models/depth_net.py``, the UNet's depth hook,
``pipelines/depth_loss.py`` and the CTSD pipeline's wiring) against the
JAX package's, on the CPU in fp32.

- ``resize_nearest`` (the UNet's level resize) equals ``jax.image.resize``
  (``"nearest"``) bit for bit at the level sizes a UNet gives, and at
  uneven ones (3 → 10, 4 → 14).
- ``DepthNet`` with and without ``upsample_scale``: <= 1e-4 of the
  largest output.
- The tiny UNet's ``(out, depth_features)`` (``tests/test_depth_branch.py``
  widths) at 8 x 8 latents and, with two levels, at 10 x 14 (levels 10 x
  14 and 5 x 7; with three the JAX UNet's up path cannot concatenate 6 x 8
  with 5 x 7): <= 1e-3.
- ``make_depth_loss`` on ``tests/test_depth_branch.py``'s ``camera_batch``
  with random logits, with points half-way between bins (rounded half to
  even), with no valid point (exactly 0), and its gradient; and
  ``depth_bin_to_metric``: <= 1e-5.
- A tiny CTSD-2.1 ``train_step`` with the depth loss, unsharded, against
  the JAX ``_train_step_impl``: the losses, every gradient (the depth
  net's included) and one AdamW step, at the bars of
  ``tests/test_torch_unet_train.py``.
- The weight bridge carries ``depth_net``; the importer refuses a
  reference ``depth_net.*`` key; sampling with the depth branch raises, as
  the JAX pipeline does.

The JAX params come from ``jax.eval_shape`` of the init drawn with numpy
(``torch_port_helpers.flax_init``), q/k/v biases zero.
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
from opendwm_tpu.models.depth_net import DepthNet as JaxDepthNet
from opendwm_tpu.models.unet import UNetCrossviewTemporal as JaxUNet
from opendwm_tpu.pipelines import depth_loss as jax_depth
from opendwm_tpu.pipelines.ctsd import TrainState as JaxTrainState
from opendwm_tpu.pipelines.ctsd import get_conditions as jax_get_conditions
from opendwm_tpu_torch import config
from opendwm_tpu_torch import torch_import as ti
from opendwm_tpu_torch.convert import (
    to_torch,
    unet_flax_from_state_dict,
    unet_state_dict_from_flax,
)
from opendwm_tpu_torch.models.depth_net import DepthNet
from opendwm_tpu_torch.models.layers import resize_nearest
from opendwm_tpu_torch.models.unet import UNetCrossviewTemporal
from opendwm_tpu_torch.pipelines import depth_loss

from test_depth_branch import BINS, FRUSTUM, camera_batch
from test_torch_unet_train import (
    QKV_BIAS,
    _flat_names,
    _is_qkv_bias,
    _rel_to_max,
    _zero_qkv_bias,
)
from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    flax_init,
    jax_training_draws,
    one_torch_thread,
    random_flax_params,
    recording_tx,
    to_torch_tree,
)

REPO = Path(__file__).resolve().parents[1]
CONFIG = REPO / "configs/ctsd/multi_datasets/ctsd_21_tirda_nwao.json"
B, T, V = 1, 2, 2
DEPTH = {"mid_channels": 16, "depth_channels": BINS}
TINY = dict(  # tests/test_depth_branch.py
    in_channels=4, out_channels=4, block_out_channels=(8, 16, 16),
    layers_per_block=1, num_attention_heads=(2, 2, 2),
    cross_attention_dim=12, projection_class_embeddings_input_dim=None,
    depth_net_config=DEPTH, depth_frustum_range=FRUSTUM)


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


# -- the level resize ----------------------------------------------------------

@pytest.mark.parametrize("m,n", [(5, 10), (3, 10), (2, 10), (7, 14),
                                 (4, 14), (2, 14), (4, 8), (16, 32),
                                 (7, 56), (6, 12)])
def test_resize_nearest_matches_jax(m, n):
    x = np.random.default_rng(m * 100 + n).standard_normal(
        (2, m, m + 1, 3)).astype(np.float32)
    size = (n, n + 2)
    ref = jax.image.resize(jnp.asarray(x), (2, *size, 3), "nearest")
    out = resize_nearest(torch.from_numpy(x), size)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


# -- DepthNet -------------------------------------------------------------------

@pytest.mark.parametrize("upsample_scale", [None, 2])
def test_depth_net_matches_jax(upsample_scale):
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((2, 3, 6, 10, 12)).astype(np.float32)
    cams = rng.standard_normal((2, 3, 25)).astype(np.float32)
    jax_net = JaxDepthNet(upsample_scale=upsample_scale, **DEPTH)
    params = flax_init(jax_net, jnp.asarray(feats), jnp.asarray(cams))
    ref = np.asarray(jax_net.apply(params, jnp.asarray(feats),
                                   jnp.asarray(cams)))
    net = DepthNet(upsample_scale=upsample_scale, in_channels=12, **DEPTH)
    net.load_state_dict(to_torch(unet_state_dict_from_flax(params)))
    with torch.no_grad():
        out = net(torch.from_numpy(feats), torch.from_numpy(cams)).numpy()
    scale = upsample_scale or 1
    assert out.shape == (2, 3, 6 * scale, 10 * scale, BINS) == ref.shape
    assert _rel(out, ref) <= 1e-4
    # flax's GroupNorm eps, and 20 groups of the 80 ASPP channels
    assert net.aspp.bn.num_groups == 20 and net.aspp.bn.eps == 1e-6


# -- the UNet's depth hook ------------------------------------------------------

def _unet_case(h, w, chans, heads, seed):
    rng = np.random.default_rng(seed)
    cams = camera_batch(jax.random.PRNGKey(seed))
    inp = dict(
        sample=rng.standard_normal((B, T, V, h, w, 4)).astype(np.float32),
        timestep=np.full((B, T, V), 500.0, np.float32),
        encoder_hidden_states=rng.standard_normal(
            (B, T, V, 5, 12)).astype(np.float32),
        camera_intrinsics=np.asarray(cams["camera_intrinsics"]),
        camera_transforms=np.asarray(cams["camera_transforms"]))
    cfg = dict(TINY, block_out_channels=chans, num_attention_heads=heads)
    jax_model = JaxUNet(**cfg)
    params = flax_init(jax_model, **{k: jnp.asarray(v)
                                     for k, v in inp.items()}, seed=seed)
    params = {"params": _zero_qkv_bias(params["params"])}
    return cfg, jax_model, params, inp


@pytest.mark.parametrize("h,w,chans,heads", [
    (8, 8, (8, 16, 16), (2, 2, 2)),
    (10, 14, (8, 16), (2, 2)),
])
def test_tiny_unet_depth_features_match_jax(h, w, chans, heads):
    cfg, jax_model, params, inp = _unet_case(h, w, chans, heads, 1)
    ref_out, ref_depth = jax.jit(jax_model.apply)(
        params, **{k: jnp.asarray(v) for k, v in inp.items()})
    model = UNetCrossviewTemporal(**cfg)
    model.load_state_dict(to_torch(unet_state_dict_from_flax(params)))
    with torch.no_grad():
        out, depth = model(**{k: torch.from_numpy(v) for k, v in
                              inp.items()})
        plain = model(**{k: torch.from_numpy(v) for k, v in inp.items()
                         if not k.startswith("camera")})
    assert depth.shape == (B, T, V, h, w, BINS) == ref_depth.shape
    assert _rel(out, ref_out) <= 1e-3
    assert _rel(depth, ref_depth) <= 1e-3
    # without the cameras, no depth branch: the prediction alone
    assert isinstance(plain, torch.Tensor) and torch.equal(plain, out)


# -- the depth loss ------------------------------------------------------------

def _loss_batch(n_points=32, half_bins=False):
    batch = {k: np.array(v) for k, v in
             camera_batch(jax.random.PRNGKey(0), n_points).items()}
    if half_bins:
        # the camera looks along ego +x: a point at x = min + (k + 0.5)
        # interval lies half-way between bins k and k + 1
        x = FRUSTUM[0] + (np.arange(n_points) % 6 + 1.5) * FRUSTUM[2]
        batch["lidar_points"][..., 0] = x.astype(np.float32)
        batch["lidar_points"][..., 1:] = np.float32(0.25)
    return batch


@pytest.mark.parametrize("case", ["random", "half_bins", "no_points"])
def test_depth_loss_matches_jax(case):
    batch = _loss_batch(half_bins=case == "half_bins")
    if case == "no_points":
        batch["lidar_points_mask"][:] = False
    feats = np.random.default_rng(2).standard_normal(
        (B, T, V, 8, 8, BINS)).astype(np.float32)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    ref, ref_grad = jax.value_and_grad(
        lambda f: jax_depth.make_depth_loss(f, jbatch, FRUSTUM, 0.5))(
            jnp.asarray(feats))
    tfeats = torch.from_numpy(feats).requires_grad_()
    loss = depth_loss.make_depth_loss(tfeats, to_torch_tree(batch), FRUSTUM,
                                      0.5)
    loss.backward()
    if case == "no_points":
        assert loss.item() == 0.0 == float(ref)
        assert not tfeats.grad.any()
        return
    assert abs(loss.item() - float(ref)) <= 1e-5 * float(ref)
    assert _rel(tfeats.grad, ref_grad) <= 1e-5
    if case == "half_bins":
        fd, _, valid = depth_loss.frustum_indices(
            feats.shape, to_torch_tree(batch), FRUSTUM)
        # z - min = 1.5, 2.5, ... 6.5 intervals: half to even
        want = torch.tensor([2, 2, 4, 4, 6, 6])
        assert torch.equal(fd[0, 0, 0, :6], want)
        assert valid.all()


def test_depth_loss_uniform_logits_and_bin_to_metric():
    batch = to_torch_tree(_loss_batch())
    loss = depth_loss.make_depth_loss(torch.zeros(B, T, V, 8, 8, BINS),
                                      batch, FRUSTUM)
    assert abs(loss.item() - np.log(BINS)) <= 1e-5 * np.log(BINS)
    feats = np.random.default_rng(3).standard_normal((2, 4, BINS))
    ref = jax_depth.depth_bin_to_metric(jnp.asarray(feats), FRUSTUM)
    out = depth_loss.depth_bin_to_metric(torch.from_numpy(feats), FRUSTUM)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6)
    intr = torch.tensor([[50.0, 0, 32], [0, 40, 24], [0, 0, 1]])
    np.testing.assert_allclose(
        depth_loss.normalized_intrinsics(intr, torch.tensor([64.0, 48.0])),
        np.asarray(jax_depth.normalized_intrinsics(
            jnp.asarray(intr.numpy()), jnp.asarray([64.0, 48.0]))))


# -- the train step ------------------------------------------------------------

H = W = 16
TRAIN_MODEL = dict(
    in_channels=4, out_channels=4, block_out_channels=[8, 16, 16],
    layers_per_block=1, transformer_layers_per_block=1,
    num_attention_heads=[2, 2, 2], cross_attention_dim=12,
    addition_time_embed_dim=8, projection_class_embeddings_input_dim=24,
    merge_factor=2.0, enable_rowwise_crossview=True,
    enable_rowwise_temporal=True, gradient_checkpointing=True,
    depth_net_config=DEPTH, depth_frustum_range=list(FRUSTUM))
TB = 2  # batch of the train step


def _train_config() -> dict:
    cfg = json.loads(CONFIG.read_text())["pipeline"]
    cfg["model"] = dict(TRAIN_MODEL, _class_name=cfg["model"]["_class_name"])
    cfg["common_config"].update(enable_depth_branch=True,
                                depth_frustum_range=list(FRUSTUM))
    cfg["training_config"]["depth_loss_coef"] = 0.5
    return cfg


def _train_batch() -> dict:
    rng = np.random.default_rng(0)
    intr = np.tile(np.array([[20.0, 0, 32], [0, 20.0, 32], [0, 0, 1]]),
                   (TB, T, V, 1, 1))
    transforms = np.tile(np.eye(4), (TB, T, V, 1, 1))
    transforms[..., :3, :3] += 0.1 * rng.standard_normal((TB, T, V, 3, 3))
    transforms[..., :3, 3] = 0.5 * rng.standard_normal((TB, T, V, 3))
    points = np.concatenate([
        rng.uniform(-4, 4, (TB, T, 64, 2)),
        rng.uniform(3, 12, (TB, T, 64, 1))], -1)
    batch = {
        "latents": rng.standard_normal((TB, T, V, H, W, 4)),
        "encoder_hidden_states": rng.standard_normal((TB, T, V, 5, 12)),
        "camera_intrinsics": intr,
        "camera_transforms": transforms,
        "image_size": np.tile(np.array([64.0, 64.0]), (TB, T, V, 1)),
        "fps": np.full((TB,), 10.0),
        "lidar_points": points,
        "ego_transforms": np.tile(np.eye(4), (TB, T, V + 1, 1, 1)),
    }
    batch = {k: v.astype(np.float32) for k, v in batch.items()}
    batch["lidar_points_mask"] = rng.uniform(size=(TB, T, 64)) < 0.9
    return batch


@pytest.fixture(scope="module")
def train_setup():
    cfg = _train_config()
    jax_cfg = copy.deepcopy(cfg)
    jax_cfg["training_config"]["freezing_pattern"] = QKV_BIAS
    jax_pipe = jax_config.create_instance_from_config(jax_cfg)
    jax_pipe.tx = recording_tx(jax_pipe.tx)
    port_pipe = config.create_instance_from_config(copy.deepcopy(cfg))
    batch = _train_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    conds = jax_get_conditions(jbatch, cfg["common_config"])
    assert {"camera_intrinsics", "camera_transforms"} <= set(conds)
    shapes = jax.eval_shape(
        jax_pipe.model.init, jax.random.PRNGKey(0),
        sample=jbatch["latents"], timestep=jnp.zeros((TB, T, V)), **conds)
    params = _zero_qkv_bias(
        jax.tree.map(np.asarray, random_flax_params(shapes, 1)))
    port_pipe.model.load_state_dict(to_torch(
        unet_state_dict_from_flax(params)))
    return cfg, jax_pipe, params, port_pipe, batch


def test_depth_train_step_matches_jax(train_setup):
    """Loss (sd, depth and their sum), every gradient, the gradient norm
    and one AdamW step (lr 5e-5, wd 0.01, clip 1.0: the config's), as
    ``tests/test_torch_unet_train.py`` holds them."""
    cfg, jax_pipe, params, port_pipe, batch = train_setup
    port_pipe = copy.copy(port_pipe)
    port_pipe.model = copy.deepcopy(port_pipe.model)
    key = jax.random.PRNGKey(3)
    jparams = jax.tree.map(jnp.asarray, params)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                          opt_state=jax_pipe.tx.init(jparams["params"]))
    new_state, ref_m = jax.jit(jax_pipe._train_step_impl)(
        state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    ref_grads = new_state.opt_state[0]
    draws = jax_training_draws(
        key, batch["latents"].shape, cfg["training_config"],
        cfg["common_config"],
        num_train_timesteps=cfg["train_scheduler"]["num_train_timesteps"])

    # loss and gradients, before the update
    loss, metrics = port_pipe.loss_from_draws(to_torch_tree(batch), draws)
    loss.backward()
    assert set(metrics) == {"sd_loss", "depth_loss", "loss"} and \
        metrics["loss"] is loss
    for k in ("sd_loss", "depth_loss", "loss"):
        want = float(ref_m[k])
        assert want > 0 and abs(metrics[k].item() - want) <= 1e-5 * want, k
    back = unet_flax_from_state_dict(
        {n: p.grad for n, p in port_pipe.model.named_parameters()})["params"]
    got = dict(zip(_flat_names(back), jax.tree.leaves(back)))
    ref = dict(zip(_flat_names(ref_grads),
                   map(np.asarray, jax.tree.leaves(ref_grads))))
    assert got.keys() == ref.keys()
    depth_names = [n for n in ref if n.startswith("depth_net.")]
    assert len(depth_names) == 2 * (14 + 2 + 8)  # convs, fc1/2, norms
    biases = {n for n in ref if _is_qkv_bias(n)}
    floor = 1e-2 * max(np.abs(g).max() for g in ref.values())
    for name in sorted(ref.keys() - biases):
        assert _rel_to_max(got[name], ref[name], floor) <= 1e-3, name
    for p in port_pipe.model.parameters():
        p.grad = None

    # one step
    before = {n: p.detach().clone()
              for n, p in port_pipe.model.named_parameters()}
    port_state = port_pipe.init_state()
    port_state, metrics = port_pipe.train_step(
        port_state, to_torch_tree(batch), draws=draws)
    trainable = [np.asarray(g) for n, g in zip(
        _flat_names(ref_grads), jax.tree.leaves(ref_grads))
        if not _is_qkv_bias(n)]
    grad_norm = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                                  for g in trainable)))
    assert abs(metrics["grad_norm"].item() - grad_norm) <= 1e-4 * grad_norm
    want = unet_state_dict_from_flax(new_state.params)
    grads = unet_state_dict_from_flax({"params": _zero_qkv_bias(
        jax.tree.map(np.asarray, ref_grads))})
    lr = cfg["optimizer_config"]["lr"]
    top = max(np.abs(g).max() for g in grads.values())
    for name, p in port_pipe.model.named_parameters():
        start = before[name].numpy()
        gap = np.abs(p.detach().numpy() - want[name]) - \
            2 * np.spacing(np.abs(start))
        bar = 1e-3 * max(np.abs(grads[name]).max(), 1e-2 * top)
        sure = np.abs(grads[name]) > 10 * bar
        assert gap.max() <= 2.02 * lr, name
        if sure.any():
            assert gap[sure].max() <= 1e-2 * lr, name
        assert not torch.equal(p.detach(), before[name]), name


# -- the bridge, the importer, sampling ----------------------------------------

def test_bridge_carries_the_depth_net_and_the_importer_refuses_it(
        train_setup):
    _, _, params, port_pipe, _ = train_setup
    sd = port_pipe.model.state_dict()
    tree = unet_flax_from_state_dict(sd)
    assert jax.tree.structure(tree["params"]) == \
        jax.tree.structure(params["params"])
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        a, np.asarray(b, np.float32)), tree["params"]["depth_net"],
        params["params"]["depth_net"])
    back = unet_state_dict_from_flax(tree)
    assert back.keys() == sd.keys()
    assert "depth_net.aspp.atrous_2.weight" in back
    # a reference checkpoint's depth net (BatchNorm) has no map in either
    # importer: the port's refuses its keys as unread
    ref_sd = {k: v for k, v in sd.items() if not k.startswith("depth_net.")}
    ti.convert_ctsd_unet(ref_sd)
    ref_sd["depth_net.reduce_conv.weight"] = sd[
        "depth_net.reduce_conv.weight"]
    ref_sd["depth_net.reduce_bn.running_mean"] = torch.zeros(16)
    with pytest.raises(ValueError, match="depth_net.reduce_bn.running_mean"):
        ti.convert_ctsd_unet(ref_sd)


@pytest.mark.parametrize("cfg_scale", [None, 2.0])
def test_sampling_with_the_depth_branch_raises_as_jax(cfg_scale):
    """JAX's ``inference_pipeline`` does not unpack the model's tuple: it
    raises (AttributeError, or TypeError under CFG); the port raises a
    TypeError saying so. Without the camera tensors both sample."""
    common = {"enable_depth_branch": True,
              "depth_frustum_range": list(FRUSTUM)}
    ic = {"inference_steps": 2}
    if cfg_scale is not None:
        ic["guidance_scale"] = cfg_scale
    model = dict(TINY, block_out_channels=(8, 16), num_attention_heads=(2, 2),
                 _class_name="UNetCrossviewTemporal")
    pipe_cfg = dict(_class_name="CTSDPipeline", model=model,
                    train_scheduler={"_class_name": "DDPMScheduler"},
                    test_scheduler={"_class_name": "DDIMScheduler"},
                    common_config=common, inference_config=ic,
                    model_type="unet")
    jax_pipe = jax_config.create_instance_from_config(copy.deepcopy(
        pipe_cfg))
    port_pipe = config.create_instance_from_config(copy.deepcopy(pipe_cfg))
    cams = camera_batch(jax.random.PRNGKey(4))
    batch = {"encoder_hidden_states": np.random.default_rng(5)
             .standard_normal((B, T, V, 5, 12)).astype(np.float32),
             "camera_intrinsics": np.asarray(cams["camera_intrinsics"]),
             "camera_transforms": np.asarray(cams["camera_transforms"])}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    params = flax_init(jax_pipe.model, sample=jnp.zeros((B, T, V, 8, 8, 4)),
                       timestep=jnp.zeros((B, T, V)),
                       **jax_get_conditions(jbatch, common), seed=2)
    params = {"params": _zero_qkv_bias(params["params"])}
    port_pipe.model.load_state_dict(
        to_torch(unet_state_dict_from_flax(params)))
    shape = (B, T, V, 8, 8, 4)
    rng = jax.random.PRNGKey(6)
    with pytest.raises((AttributeError, TypeError)):
        jax_pipe.inference_pipeline(params, jbatch, shape, rng)
    noise = torch.tensor(np.asarray(jax.random.normal(rng, shape)))
    with pytest.raises(TypeError, match="depth branch"):
        port_pipe.inference_pipeline(to_torch_tree(batch), shape,
                                     noise=noise)
    plain = {"encoder_hidden_states": batch["encoder_hidden_states"]}
    ref = jax_pipe.inference_pipeline(
        params, {k: jnp.asarray(v) for k, v in plain.items()}, shape, rng)
    out = port_pipe.inference_pipeline(to_torch_tree(plain), shape,
                                       noise=noise)
    assert _rel(out, ref) <= 1e-3
