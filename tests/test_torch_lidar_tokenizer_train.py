"""The port's LiDAR tokenizer trainers (``opendwm_tpu_torch/models/
vq_point_cloud.py``'s training half, ``models/vae_point_cloud.py``,
``pipelines/lidar_vqvae.py``, ``pipelines/lidar_vae.py``) against the JAX
package's on the CPU in fp32, on the JAX package's own draws.

Bars: losses within 1e-5 relative; each parameter's gradient within 1e-4
in relative norm (``||port - jax|| / ||jax||``), or, where JAX's own fp32
gradient is further than 5e-5 from the same loss's float64 gradient,
within twice that distance of JAX's and within 1e-4 of the float64 one
(``check_grads``); the parameters after an
update within 1e-5 and the update itself (new − old) within 1e-3 in
relative norm (AdamW's first step moves an entry by about lr whatever its
gradient, so the parameters alone would hide a wrong gradient), but at
entries whose gradient is within 100 x AdamW's eps of 0 (``check_update``:
both packages move them by at most lr).

- ``update_code_stats``; ``kmeans_revive`` bit for bit for one seed;
  ``soft_l1``;
- ``LidarCodebook``: every loss term, every gradient, two updates (the
  reservoir filled on the first, rolled on the second, from JAX's
  ``jax.random.choice`` draws), the code ages and usage; the ``z_q`` and
  indices the port takes from its one forward equal the JAX loss's second
  encode; ``maybe_revive_codebook`` as JAX's;
- ``VAEPointCloud`` and ``LidarVAE``: every loss term and gradient on
  JAX's posterior noise, one update; the non-finite guard (a NaN weight:
  loss 0, every non-finite gradient 0, the same update as JAX's);
- the weight bridge both ways, the density MLP included; a serving tree
  without it loads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendwm_tpu.models import vae_point_cloud as jvae
from opendwm_tpu.models import vq_point_cloud as jvq
from opendwm_tpu.ops.voxelize import Voxelizer as JaxVoxelizer
from opendwm_tpu.pipelines import lidar_vae as jlvae
from opendwm_tpu.pipelines import lidar_vqvae as jlvq
from opendwm_tpu.pipelines.ctsd import TrainState as JaxTrainState
from opendwm_tpu_torch.convert import (
    lidar_flax_from_state_dict,
    lidar_state_dict_from_flax,
    to_torch,
    vae_point_cloud_flax_from_state_dict,
)
from opendwm_tpu_torch.models import vae_point_cloud as tvae
from opendwm_tpu_torch.models import vq_point_cloud as tvq
from opendwm_tpu_torch.ops.voxelize import Voxelizer
from opendwm_tpu_torch.pipelines import lidar_vae as tlvae
from opendwm_tpu_torch.pipelines import lidar_vqvae as tlvq

from torch_port_helpers import (
    check_lidar_grads,
    check_lidar_update,
    flax_init,
    lidar_float64_grads,
    load_lidar,
    rel,
)

LOSS_TOL = 1e-5
IMG, ZC, E_DIM, N_E, LATENT = 16, 8, 12, 16, 6
VOX = dict(x_min=-4.0, x_max=4.0, y_min=-4.0, y_max=4.0, step=0.5,
           z_min=-1.0, z_max=1.0, z_step=0.25)
ENC = dict(img_size=IMG, patch_size=8, in_chans=ZC, embed_dim=8,
           num_heads=2, depth=6, codebook_dim=E_DIM, window_size=2)
DEC = dict(ENC, depth=4, density_feats=4)
RAYS = dict(ray_stepsize=0.25, ray_max_steps=32)
TRAIN = dict(voxel_loss_coef=1.0, emb_loss_coef=1.0, depth_loss_coef=0.1,
             sdf_loss_coef=0.1, kl_loss_coef=1e-3,
             max_norm_for_grad_clip=1.0)
OPT = {"lr": 5e-4}
SCHED = {"_class_name": "torch.optim.lr_scheduler.CosineAnnealingLR",
         "T_max": 100, "eta_min": 5e-5}


def t(x):
    return torch.from_numpy(np.array(x))


def lidar_batch(seed: int, b: int = 1, frames: int = 2, n: int = 96):
    """Returns inside the box, a few past it, the last 8 of each frame
    masked and zeroed (padding)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-4.5, 4.5, (b, frames, n, 3)).astype(np.float32)
    pts[..., 2] = rng.uniform(-1.2, 1.2, (b, frames, n))
    mask = np.ones((b, frames, n), bool)
    mask[..., -8:] = False
    pts[..., -8:, :] = 0.0
    return {"lidar_points": pts, "lidar_points_mask": mask}


def jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def tbatch(batch):
    return {k: t(v) for k, v in batch.items()}


# -- pieces -----------------------------------------------------------------

def test_update_code_stats():
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 10, (3, 7))
    age = rng.integers(0, 300, 20).astype(np.float32)
    usage = rng.uniform(0, 5, 20).astype(np.float32)
    want = jvq.update_code_stats(jnp.asarray(idx), jnp.asarray(age),
                                 jnp.asarray(usage), 20)
    got = tvq.update_code_stats(t(idx), t(age), t(usage), 20)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert float(got[0][15]) == age[15] + 1 and float(got[0][idx[0, 0]]) == 0


def test_kmeans_revive_bit_for_bit():
    rng = np.random.default_rng(1)
    codebook = rng.standard_normal((24, 5)).astype(np.float32)
    reservoir = rng.standard_normal((240, 5)).astype(np.float32)
    age = rng.integers(0, 400, 24).astype(np.float32)
    want = jvq.kmeans_revive(codebook, reservoir, age, 256, seed=3)
    got = tvq.kmeans_revive(codebook, reservoir, age, 256, seed=3)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, codebook)


def test_soft_l1():
    rng = np.random.default_rng(2)
    pred = rng.standard_normal(203).astype(np.float32)
    gt = rng.standard_normal(203).astype(np.float32)
    gt[:5] += 100.0  # outliers past the 95% cut
    want = float(jvq.soft_l1(jnp.asarray(pred), jnp.asarray(gt)))
    got = float(tvq.soft_l1(t(pred), t(gt)))
    assert abs(got - want) <= LOSS_TOL * abs(want)
    assert want < 2.0


# -- the VQ tokenizer and LidarCodebook --------------------------------------

def jax_vq():
    return jvq.VQPointCloud(
        voxelizer=JaxVoxelizer(**VOX),
        vector_quantizer=jvq.VectorQuantizer(n_e=N_E, e_dim=E_DIM),
        lidar_encoder=jvq.VQEncoder(**ENC),
        lidar_decoder=jvq.VQDecoder(**DEC), **RAYS)


def port_vq():
    return tvq.VQPointCloud(
        voxelizer=Voxelizer(**VOX),
        vector_quantizer=tvq.VectorQuantizer(n_e=N_E, e_dim=E_DIM),
        lidar_encoder=tvq.VQEncoder(**ENC),
        lidar_decoder=tvq.VQDecoder(**DEC), **RAYS)


@pytest.fixture(scope="module")
def codebook():
    batch = lidar_batch(0)
    jmodel = jax_vq()
    params = flax_init(jmodel, *jbatch(batch).values(), seed=4)
    jpipe = jlvq.LidarCodebook(jmodel, training_config=TRAIN,
                               optimizer_config=OPT,
                               lr_scheduler_config=SCHED)
    tpipe = tlvq.LidarCodebook(load_lidar(port_vq(), params),
                               training_config=TRAIN,
                               optimizer_config=OPT,
                               lr_scheduler_config=SCHED)
    return jpipe, params, tpipe, batch


def test_codebook_loss_gradients_and_encode_reuse(codebook):
    jpipe, params, tpipe, batch = codebook
    (loss, (metrics, zq, idx)), grads = jax.jit(jax.value_and_grad(
        jpipe.loss_fn, has_aux=True))(params, jbatch(batch),
                                      jax.random.PRNGKey(0))
    tloss, (tmetrics, tzq, tidx) = tpipe.loss_from_draws(tbatch(batch))
    for k, v in metrics.items():
        assert abs(float(tmetrics[k].detach()) - float(v)) \
            <= LOSS_TOL * abs(float(v)), k
    assert float(metrics["depth_loss"]) > 0 and float(metrics["sdf_loss"]) > 0
    # z_q and the indices of the one forward = the JAX loss's second encode
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))
    assert rel(tzq, zq) < LOSS_TOL
    for p in tpipe.model.parameters():
        p.grad = None
    tloss.backward()

    def loss64(dtype):
        model = load_lidar(port_vq(), params).to(dtype)
        pipe = tlvq.LidarCodebook(model, training_config=TRAIN)
        b = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in tbatch(batch).items()}
        return pipe.loss_from_draws(b)[0], model

    check_lidar_grads(tpipe.model, grads, lidar_float64_grads(loss64))


def _jax_codebook_state(jpipe, params):
    jp = jax.tree.map(jnp.asarray, params)
    n_e, e_dim = N_E, E_DIM
    return jlvq.VQTrainState(
        step=jnp.zeros((), jnp.int32), params=jp,
        opt_state=jpipe.tx.init(jp["params"]),
        code_age=jnp.full((n_e,), 10000.0), code_usage=jnp.zeros((n_e,)),
        reservoir=jnp.zeros((n_e * 10, e_dim)),
        reservoir_initialized=jnp.zeros((), bool))


def _jax_reservoir_draws(key, rows: int, size: int) -> dict:
    """``_train_step_impl``'s reservoir draws (``lidar_vqvae.py:135-173``)."""
    take = jax.random.choice(jax.random.fold_in(key, 17), rows,
                             (size // 100,), replace=False)
    fill = jax.random.choice(jax.random.fold_in(key, 23), rows, (size,),
                             replace=True)
    return {"take": t(take), "fill": t(fill)}


def test_codebook_two_updates_and_reservoir(codebook):
    jpipe, params, tpipe, batch = codebook
    jstep = jax.jit(jpipe._train_step_impl)
    jstate = _jax_codebook_state(jpipe, params)
    model = load_lidar(port_vq(), params)
    pipe = tlvq.LidarCodebook(model, training_config=TRAIN,
                              optimizer_config=OPT,
                              lr_scheduler_config=SCHED)
    state = pipe.init_state()
    assert float(state.code_age[0]) == 10000.0
    assert state.reservoir.shape == (N_E * 10, E_DIM)
    rows = 2 * (IMG // 8) ** 2
    old = jstate.params["params"]
    first_grads = jax.jit(jax.grad(lambda p, b: jpipe.loss_fn(
        p, b, None)[0]))(jstate.params, jbatch(lidar_batch(20)))
    for step, seed in enumerate((11, 12)):
        key = jax.random.PRNGKey(seed)
        b = lidar_batch(20 + step)
        jstate, jmetrics = jstep(jstate, jbatch(b), key)
        state, metrics = pipe.train_step(
            state, tbatch(b), draws=_jax_reservoir_draws(key, rows,
                                                         N_E * 10))
        assert abs(float(metrics["loss"]) - float(jmetrics["loss"])) \
            <= LOSS_TOL * float(jmetrics["loss"])
        np.testing.assert_array_equal(state.code_age.numpy(),
                                      np.asarray(jstate.code_age))
        np.testing.assert_array_equal(state.code_usage.numpy(),
                                      np.asarray(jstate.code_usage))
        assert rel(state.reservoir, jstate.reservoir) < LOSS_TOL
        assert state.reservoir_initialized
        if step == 0:
            check_lidar_update(model, old, jstate.params["params"],
                               first_grads["params"], OPT["lr"],
                               TRAIN["max_norm_for_grad_clip"])
    assert state.step == 2
    assert float((state.code_age == 0).sum()) > 0
    assert float(state.code_age.max()) == 10002.0

    # a forced revival: k-means over the same reservoir, ages reset
    state.code_age[: N_E // 2] = 300.0
    jstate = jstate.replace(code_age=jnp.asarray(state.code_age.numpy()))
    jstate, jrevived = jpipe.maybe_revive_codebook(jstate, seed=5)
    before = model.vector_quantizer.embedding.detach().clone()
    state, revived = pipe.maybe_revive_codebook(state, seed=5)
    assert revived and jrevived
    assert not torch.equal(before, model.vector_quantizer.embedding)
    assert rel(model.vector_quantizer.embedding.detach(),
               jstate.params["params"]["vector_quantizer"]["embedding"]) \
        < 1e-4
    assert float(state.code_age.abs().sum()) == 0.0
    assert float(state.code_usage.abs().sum()) == 0.0
    state.code_age[0] = 0.0
    assert pipe.maybe_revive_codebook(state)[1] is False  # all live


def test_vq_bridge_round_trip_and_serving_tree(codebook):
    _, params, tpipe, _ = codebook
    back = lidar_flax_from_state_dict(tpipe.model.state_dict())
    flat_in = jax.tree_util.tree_leaves_with_path(params)
    flat_out = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_in) == len(flat_out)
    for path, leaf in flat_in:
        np.testing.assert_array_equal(flat_out[path], np.asarray(leaf))
    assert "density_mlp_1" in back["params"]
    # a serving tree (no rendering, so no density MLP) loads and keeps the
    # module's own density MLP
    serving = {"params": {k: v for k, v in params["params"].items()
                          if not k.startswith("density_mlp")}}
    model = port_vq()
    own = model.density_mlp_1.weight.detach().clone()
    model.load_state_dict(to_torch(lidar_state_dict_from_flax(serving)))
    assert torch.equal(model.density_mlp_1.weight, own)


# -- the KL tokenizer and LidarVAE -------------------------------------------

VAE_ENC = dict(ENC, codebook_dim=2 * LATENT)
VAE_DEC = dict(DEC, codebook_dim=LATENT)


@pytest.fixture(scope="module")
def vae():
    batch = lidar_batch(1)
    jmodel = jvae.VAEPointCloud(
        voxelizer=JaxVoxelizer(**VOX), lidar_encoder=jvq.VQEncoder(**VAE_ENC),
        lidar_decoder=jvq.VQDecoder(**VAE_DEC), latent_dim=LATENT, **RAYS)
    params = flax_init(jmodel, *jbatch(batch).values(), seed=6)
    jpipe = jlvae.LidarVAE(jmodel, training_config=TRAIN,
                           optimizer_config=OPT)
    return jpipe, params, batch


def port_vae(params):
    model = tvae.VAEPointCloud(
        voxelizer=Voxelizer(**VOX), lidar_encoder=tvq.VQEncoder(**VAE_ENC),
        lidar_decoder=tvq.VQDecoder(**VAE_DEC), latent_dim=LATENT, **RAYS)
    return load_lidar(model, params)


def _posterior_noise(key, b=1, frames=2):
    return jax.random.normal(key, (b * frames, (IMG // 8) ** 2, LATENT))


def test_vae_model_pieces(vae):
    jpipe, params, batch = vae
    jmodel = jpipe.model
    model = port_vae(params)
    jb, tb = jbatch(batch), tbatch(batch)
    _, mean, logvar = jmodel.apply(params, *jb.values(),
                                   method=jmodel.encode_lidar)
    _, tmean, tlogvar = model.encode_lidar(*tb.values())
    assert rel(tmean.detach(), mean) < LOSS_TOL
    assert rel(tlogvar.detach(), logvar) < LOSS_TOL
    tlogvar = tlogvar.detach()
    assert float(tlogvar.max()) <= 20.0 and float(tlogvar.min()) >= -30.0
    assert abs(float(model.kl(tmean, tlogvar))
               - float(jmodel.kl(mean, logvar))) \
        <= LOSS_TOL * float(jmodel.kl(mean, logvar))
    key = jax.random.PRNGKey(2)
    want = jmodel.sample(mean, logvar, key)
    got = model.sample(tmean, tlogvar, t(_posterior_noise(key)))
    assert rel(got.detach(), want) < LOSS_TOL
    _, logits = jmodel.apply(params, want, method=jmodel.decode_lidar)
    assert rel(model.decode_lidar(got)[1].detach(), logits) < 1e-4
    back = vae_point_cloud_flax_from_state_dict(model.state_dict())
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        np.testing.assert_array_equal(
            dict(jax.tree_util.tree_leaves_with_path(back))[path],
            np.asarray(leaf))


def test_lidar_vae_loss_gradients_and_update(vae):
    jpipe, params, batch = vae
    key = jax.random.PRNGKey(7)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        jpipe.loss_fn, has_aux=True))(params, jbatch(batch), key)
    pipe = tlvae.LidarVAE(lidar_vae=port_vae(params), training_config=TRAIN,
                          optimizer_config=OPT)
    noise = t(_posterior_noise(key))
    tloss, tmetrics = pipe.loss_from_draws(tbatch(batch), noise)
    for k, v in metrics.items():
        assert abs(float(tmetrics[k].detach()) - float(v)) \
            <= LOSS_TOL * abs(float(v)), k
    assert float(metrics["kl_loss"]) > 0
    tloss.backward()

    def loss64(dtype):
        model = port_vae(params).to(dtype)
        pipe64 = tlvae.LidarVAE(model, training_config=TRAIN)
        b = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in tbatch(batch).items()}
        return pipe64.loss_from_draws(b, noise.to(dtype))[0], model

    check_lidar_grads(pipe.model, grads, lidar_float64_grads(loss64))

    jp = jax.tree.map(jnp.asarray, params)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=jp,
                           opt_state=jpipe.tx.init(jp["params"]))
    jstate, _ = jax.jit(jpipe._train_step_impl)(jstate, jbatch(batch), key)
    pipe.model.zero_grad(set_to_none=True)
    state = pipe.init_state()
    state, _ = pipe.train_step(state, tbatch(batch), noise=noise)
    check_lidar_update(pipe.model, params["params"], jstate.params["params"],
                       grads["params"], OPT["lr"],
                       TRAIN["max_norm_for_grad_clip"])


def test_lidar_vae_non_finite_guard(vae):
    """A NaN weight: JAX's loss is 0 and its gradients are zeroed where
    non-finite; the port's step is the same."""
    jpipe, params, batch = vae
    bad = jax.tree.map(np.array, params)
    bad["params"]["lidar_decoder"]["voxel_pred"]["bias"][0] = np.nan
    key = jax.random.PRNGKey(8)
    jp = jax.tree.map(jnp.asarray, bad)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=jp,
                           opt_state=jpipe.tx.init(jp["params"]))
    jstate, jmetrics = jax.jit(jpipe._train_step_impl)(jstate, jbatch(batch),
                                                       key)
    assert float(jmetrics["loss"]) == 0.0
    pipe = tlvae.LidarVAE(vae_point_cloud=port_vae(bad),
                          training_config=TRAIN, optimizer_config=OPT)
    state = pipe.init_state()
    state, metrics = pipe.train_step(state, tbatch(batch),
                                     noise=t(_posterior_noise(key)))
    assert float(metrics["loss"]) == 0.0
    got = dict(jax.tree_util.tree_leaves_with_path(
        lidar_flax_from_state_dict(pipe.model.state_dict())["params"]))
    for path, new in jax.tree_util.tree_leaves_with_path(
            jstate.params["params"]):
        new = np.asarray(new)
        np.testing.assert_array_equal(np.isnan(got[path]), np.isnan(new))
        ok = ~np.isnan(new)
        assert rel(got[path][ok], new[ok]) < 1e-5, path
    with pytest.raises(ValueError, match="vae_point_cloud"):
        tlvae.LidarVAE()
