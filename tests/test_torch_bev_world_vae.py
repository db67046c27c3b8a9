"""The port's ``BEVWorldVAE`` (``models/bev_world_vae.py``) against the JAX
package's, on the CPU in fp32, on ``tests/test_bev_world_vae.py``'s
fixture (a 16 x 16 BEV grid of 2 x 2 tokens, 2 views of 32 x 32, 3
samples a pillar).

- ``bilinear_sample`` at points inside, on the clip edges and outside the
  grid: <= 1e-6.
- Every output (voxels bit for bit; the moments, the voxel logits, the
  density grid, the images, the KL), at the mean and at a posterior
  sample on the JAX draw: <= 1e-4 of each output's largest entry.
- The gradients of the JAX test's loss (the images' and the logits' mean
  squares plus the KL) for every parameter: <= 1e-3 of the tensor's
  largest entry, or of 1% of the largest of all if that is more.
- The SD-VAE image branch (``pretrained_img_vae``) and the graft of an
  ``AutoencoderKL`` state dict (``load_pretrained_img_vae_params``, a
  missing key raising ``KeyError``); the latent's dependence on the
  images.

The JAX params come from ``jax.eval_shape`` of the init drawn with numpy
(``torch_port_helpers.flax_init``); the port loads them through
``convert.bev_world_vae_state_dict_from_flax``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendwm_tpu.models.autoencoders import AutoencoderKL as JaxVAE
from opendwm_tpu.models.bev_world_vae import BEVWorldVAE as JaxBEV
from opendwm_tpu.models.bev_world_vae import \
    bilinear_sample as jax_bilinear_sample
from opendwm_tpu_torch.config import get_class
from opendwm_tpu_torch.convert import (
    bev_world_vae_state_dict_from_flax,
    to_torch,
    vae_state_dict_from_flax,
)
from opendwm_tpu_torch.models.bev_world_vae import (
    BEVWorldVAE,
    bilinear_sample,
    load_pretrained_img_vae_params,
)
from opendwm_tpu_torch.models.vq_point_cloud import VQDecoder, VQEncoder
from opendwm_tpu_torch.ops.voxelize import Voxelizer

from test_bev_world_vae import (  # noqa: F401 (a fixture)
    IMG,
    LATENT,
    ZC,
    B,
    V,
    model_and_inputs,
)
from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    flax_init,
    one_torch_thread,
    to_torch_tree,
)

VAE_CFG = dict(block_out_channels=(8, 16), latent_channels=4,
               use_quant_conv=True)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _port(**kwargs) -> BEVWorldVAE:
    return BEVWorldVAE(
        voxelizer=Voxelizer(x_min=-8, x_max=8, y_min=-8, y_max=8, step=1.0,
                            z_min=-1, z_max=1, z_step=0.25),
        lidar_encoder=VQEncoder(img_size=IMG, patch_size=8, in_chans=ZC,
                                embed_dim=8, num_heads=2, depth=6,
                                codebook_dim=16, window_size=2),
        lidar_decoder=VQDecoder(img_size=IMG, patch_size=8, in_chans=ZC,
                                embed_dim=8, num_heads=2, depth=4,
                                codebook_dim=LATENT, window_size=2,
                                density_feats=4),
        latent_dim=LATENT, num_sample_per_pillar=3, image_size=(32, 32),
        num_views=V, **kwargs)


@pytest.fixture(scope="module")
def pair(model_and_inputs):
    model, inputs = model_and_inputs
    inputs = {k: jnp.asarray(np.asarray(v)) for k, v in inputs.items()}
    params = flax_init(model, **inputs, seed=3)
    port = _port(img_feature_dim=16)
    port.load_state_dict(to_torch(bev_world_vae_state_dict_from_flax(params)))
    return model, params, inputs, port


def test_registry_resolves_the_port_class():
    assert get_class("BEVWorldVAE") is BEVWorldVAE
    assert get_class("dwm.models.bevw_vae_mm_model.VAEBevMultiModality") \
        is BEVWorldVAE


def test_bilinear_sample_matches_jax():
    rng = np.random.default_rng(0)
    feat = rng.standard_normal((5, 7, 3)).astype(np.float32)
    uv = np.concatenate([
        rng.uniform(-2, 9, (40, 2)),
        [[0.0, 0.0], [6.0, 4.0], [5.999, 3.999], [1.5, 1.5], [-1, 3]],
    ]).astype(np.float32)
    ref = jax_bilinear_sample(jnp.asarray(feat), jnp.asarray(uv))
    out = bilinear_sample(torch.from_numpy(feat), torch.from_numpy(uv))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
    grid = torch.arange(16.0).reshape(4, 4, 1)
    assert bilinear_sample(grid, torch.tensor([[1.5, 1.5]]))[0, 0].item() \
        == (5 + 6 + 9 + 10) / 4


@pytest.mark.parametrize("sampled", [False, True])
def test_outputs_match_jax(pair, sampled):
    model, params, inputs, port = pair
    rng = jax.random.PRNGKey(5) if sampled else None
    ref = model.apply(params, **inputs, rng=rng)
    noise = None
    if sampled:
        noise = torch.from_numpy(np.asarray(jax.random.normal(
            rng, ref["mean"].shape)))
    with torch.no_grad():
        out = port(**to_torch_tree({k: np.asarray(v)
                                    for k, v in inputs.items()}),
                   noise=noise)
    assert set(out) == set(ref)
    np.testing.assert_array_equal(out["voxels"].numpy(),
                                  np.asarray(ref["voxels"]))
    assert out["recon_images"].shape == (B, V, 32, 32, 3)
    assert out["voxel_logits"].shape == (B, ZC, IMG, IMG)
    for key in ("mean", "logvar", "voxel_logits", "density",
                "recon_images", "kl_loss"):
        assert _rel(out[key], ref[key]) <= 1e-4, key


def _loss(out):
    return (out["recon_images"] ** 2).mean() + \
        (out["voxel_logits"] ** 2).mean() + out["kl_loss"]


def test_gradients_match_jax(pair):
    model, params, inputs, port = pair
    ref = jax.grad(lambda p: _loss(model.apply(p, **inputs)))(params)
    ref = bev_world_vae_state_dict_from_flax(jax.tree.map(np.asarray, ref))
    port.zero_grad()
    _loss(port(**to_torch_tree({k: np.asarray(v)
                                for k, v in inputs.items()}))).backward()
    # the density branch is not in the loss: no gradient, JAX's zeros
    got = {n: torch.zeros_like(p) if p.grad is None else p.grad
           for n, p in port.named_parameters()}
    assert got.keys() == ref.keys()
    top = max(np.abs(g).max() for g in ref.values())
    assert top > 0
    for name, g in ref.items():
        gap = np.abs(got[name].numpy().astype(np.float64) - g).max()
        assert gap <= 1e-3 * max(np.abs(g).max(), 1e-2 * top), name
    # the offsets move the sample points: their gradient reaches the lift
    assert got["lift.sampling_offsets.weight"].abs().max() > 0


def test_latent_depends_on_the_images(pair):
    _, _, inputs, port = pair
    batch = to_torch_tree({k: np.asarray(v) for k, v in inputs.items()})
    with torch.no_grad():
        a = port(**batch)["mean"]
        b = port(**dict(batch, images=torch.zeros_like(batch["images"])))[
            "mean"]
    assert not torch.allclose(a, b)


def test_sd_vae_branch_and_graft(model_and_inputs):
    base, inputs = model_and_inputs
    inputs = {k: jnp.asarray(np.asarray(v)) for k, v in inputs.items()}
    jax_model = JaxBEV(
        voxelizer=base.voxelizer, lidar_encoder=base.lidar_encoder,
        lidar_decoder=base.lidar_decoder, latent_dim=LATENT,
        num_sample_per_pillar=3, image_size=(32, 32),
        pretrained_img_vae=VAE_CFG)
    params = flax_init(jax_model, **inputs, seed=4)
    assert "img_vae" in params["params"]
    port = _port(pretrained_img_vae=VAE_CFG)
    port.load_state_dict(to_torch(bev_world_vae_state_dict_from_flax(params)))
    ref = jax_model.apply(params, **inputs)
    with torch.no_grad():
        out = port(**to_torch_tree({k: np.asarray(v)
                                    for k, v in inputs.items()}))
    for key in ("mean", "recon_images", "kl_loss"):
        assert _rel(out[key], ref[key]) <= 1e-4, key

    # graft an AutoencoderKL's weights: the branch computes what it does
    vae_params = flax_init(JaxVAE(**VAE_CFG), jnp.zeros((1, 32, 32, 3)),
                           seed=7)
    vae_sd = vae_state_dict_from_flax(vae_params)
    load_pretrained_img_vae_params(port, vae_sd)
    imgs = np.asarray(inputs["images"]).reshape(-1, 32, 32, 3)
    want, _ = JaxVAE(**VAE_CFG).apply(vae_params, jnp.asarray(imgs),
                                      method="encode")
    with torch.no_grad():
        got = port._encode_images(torch.from_numpy(imgs))
    np.testing.assert_allclose(got[..., :4].numpy(), np.asarray(want),
                               atol=1e-5)
    del vae_sd["decoder.conv_out.bias"]
    with pytest.raises(KeyError, match="decoder.conv_out.bias"):
        load_pretrained_img_vae_params(port, vae_sd)
