"""The causal temporal VAE, the port vs the JAX package, on the CPU in fp32.

A small VAE (channels 8/16/16/32, one ResNet block a stage, 4 latent
channels) with numpy-drawn weights carried across by
``convert.temporal_vae_state_dict_from_flax``. Tolerance 1e-4 on means,
log-variances, decoded frames and the scaled multi-view round trip (the
posterior noise is the JAX draw); the compression ratios and causality
are checked on the port alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendwm_tpu.models.temporal_vae import (
    TemporalAutoencoderKL as JaxTemporalVAE,
)
from opendwm_tpu_torch import config
from opendwm_tpu_torch.convert import (
    temporal_vae_state_dict_from_flax,
    to_torch,
)
from opendwm_tpu_torch.models.temporal_vae import TemporalAutoencoderKL

from torch_port_helpers import flax_init

KW = dict(block_out_channels=(8, 16, 16, 32), latent_channels=4,
          layers_per_block=1)
TOL = 1e-4


@pytest.fixture(scope="module")
def vaes():
    jv = JaxTemporalVAE(**KW)
    enc = flax_init(jv, jnp.zeros((1, 5, 32, 32, 3)), seed=0,
                    method=jv.encode)
    dec = flax_init(jv, jnp.zeros((1, 2, 4, 4, 4)), seed=1, method=jv.decode)
    params = {"params": {**enc["params"], **dec["params"]}}
    tv = TemporalAutoencoderKL(**KW)
    tv.load_state_dict(to_torch(temporal_vae_state_dict_from_flax(params)))
    return jv, params, tv.eval()


def _video(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_encode_and_decode_match_jax(vaes):
    jv, params, tv = vaes
    video = _video(2, (2, 9, 32, 32, 3))
    mean, logvar = jv.apply(params, jnp.asarray(video), method=jv.encode)
    with torch.no_grad():
        tmean, tlogvar = tv.encode(torch.from_numpy(video))
        out = tv.decode(tmean)
    assert tmean.shape == (2, 3, 4, 4, 4)  # 1 + 4k frames → 1 + k; / 8
    np.testing.assert_allclose(tmean.numpy(), np.asarray(mean), atol=TOL)
    np.testing.assert_allclose(tlogvar.numpy(), np.asarray(logvar), atol=TOL)
    ref = jv.apply(params, mean, method=jv.decode)
    assert out.shape == (2, 9, 32, 32, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL)


def test_logvar_is_clipped(vaes):
    _, _, tv = vaes
    big = TemporalAutoencoderKL(**KW)
    big.load_state_dict(tv.state_dict())
    with torch.no_grad():
        big.encoder_conv_out.conv.bias[4:] = 100.0
        _, logvar = big.encode(torch.from_numpy(_video(3, (1, 5, 32, 32, 3))))
    assert logvar.max().item() == 20.0


@pytest.mark.parametrize("chunk", [None, 1])
def test_scaled_round_trip_matches_jax(vaes, chunk):
    """Multi-view (b, t, v, H, W, 3) videos with views folded through the
    batch: a posterior sample on the JAX noise, then the decode."""
    jv, params, tv = vaes
    videos = _video(4, (1, 5, 2, 32, 32, 3))
    key = jax.random.PRNGKey(5)
    lat = jv.encode_to_scaled(params, jnp.asarray(videos), key)
    # the JAX draw, in the port's (b, t, v, ...) layout
    noise = np.asarray(jax.random.normal(key, (2, 2, 4, 4, 4)))
    noise = noise.reshape(1, 2, 2, 4, 4, 4).transpose(0, 2, 1, 3, 4, 5)
    with torch.no_grad():
        tlat = tv.encode_to_scaled(torch.from_numpy(videos),
                                   noise=torch.from_numpy(noise.copy()),
                                   chunk_size=chunk)
        dec = tv.decode_from_scaled(tlat, chunk_size=chunk)
    assert tlat.shape == (1, 2, 2, 4, 4, 4)
    np.testing.assert_allclose(tlat.numpy(), np.asarray(lat), atol=TOL)
    ref = jv.decode_from_scaled(params, lat)
    assert dec.shape == (1, 5, 2, 32, 32, 3)
    np.testing.assert_allclose(dec.numpy(), np.asarray(ref), atol=TOL)
    with torch.no_grad():  # without noise: the posterior mean
        mean = tv.encode_to_scaled(torch.from_numpy(videos))
    np.testing.assert_allclose(
        mean.numpy(), np.asarray(jv.encode_to_scaled(
            params, jnp.asarray(videos))), atol=TOL)


def test_causality(vaes):
    """A change to the last frame leaves the first latent frame alone."""
    _, _, tv = vaes
    video = torch.from_numpy(_video(6, (1, 9, 32, 32, 3)))
    later = video.clone()
    later[:, -1] += 10.0
    with torch.no_grad():
        a, _ = tv.encode(video)
        b, _ = tv.encode(later)
    assert (a[:, 0] - b[:, 0]).abs().max().item() <= 1e-5
    assert not torch.allclose(a[:, -1], b[:, -1])
    with torch.no_grad():  # and the decode: latent frame k only moves later
        lat = a.clone()
        lat[:, -1] += 1.0
        da, db = tv.decode(a), tv.decode(lat)
    assert (da[:, :5] - db[:, :5]).abs().max().item() <= 1e-5
    assert not torch.allclose(da[:, -1], db[:, -1])


def test_registered_under_the_diffusers_name():
    cls = config.get_class("diffusers.AutoencoderKLCogVideoX")
    assert cls is TemporalAutoencoderKL
    vae = config.create_instance_from_config({
        "_class_name": "TemporalAutoencoderKL", **KW,
        "dtype": {"_class_name": "get_class", "class_name": "jnp.bfloat16"}})
    assert vae.spatial_downscale == 8 and vae.temporal_downscale == 4
    assert vae.encoder_conv_in.conv.weight.dtype == torch.bfloat16
