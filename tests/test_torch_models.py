"""Port models vs the JAX package's, on the CPU in fp32.

- Weight bridge: ``opendwm_tpu_torch.convert`` inverts the JAX package's
  ``convert_ctsd_dit`` / ``convert_autoencoder_kl`` key for key.
- Tiny DiT (the layer/head/dim sizes of
  ``configs/ctsd/ctsd_35_6views_video_synthetic.json`` plus implicit
  perspective): the port's forward on bridged weights vs
  ``DiTCrossviewTemporal.apply``, <= 1e-3 (the bar of
  ``test_dit_converter_parity.py``).
- Tiny VAE decode, <= 1e-3.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendwm_tpu.convert.torch_import import (
    convert_autoencoder_kl,
    convert_ctsd_dit,
)
from opendwm_tpu.models import layers as jax_layers
from opendwm_tpu.models.autoencoders import AutoencoderKL as JaxAutoencoderKL
from opendwm_tpu.models.mmdit import DiTCrossviewTemporal as JaxDiT
from opendwm_tpu_torch.config import create_instance_from_config, get_class
from opendwm_tpu_torch.convert import (
    dit_state_dict_from_flax,
    to_torch,
    vae_state_dict_from_flax,
)
from opendwm_tpu_torch.models import layers
from opendwm_tpu_torch.models.autoencoders import AutoencoderKL
from opendwm_tpu_torch.models.mmdit import DiTCrossviewTemporal

from torch_oracle_mmdit import OracleDiT
from torch_port_helpers import random_flax_params
from torch_oracle_vae import AutoencoderKLOracle

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-3


def _synthetic_model_config() -> dict:
    cfg = json.loads((REPO / "configs/ctsd/ctsd_35_6views_video_synthetic.json")
                     .read_text())["pipeline"]["model"]
    cfg = {k: v for k, v in cfg.items() if k != "_class_name"}
    cfg.update(perspective_modeling_type="implicit",
               projection_class_embeddings_input_dim=3 * 256)
    return cfg


def _random_params(init, seed: int, *args, **kwargs):
    return random_flax_params(
        jax.eval_shape(init, jax.random.PRNGKey(0), *args, **kwargs), seed)


def _oracle_dit():
    torch.manual_seed(0)
    return OracleDiT(
        patch=2, layers=2, heads=2, head_dim=8, in_ch=16, out_ch=16,
        joint_dim=24, pooled_dim=16, max_size=16, base_size=4,
        dual_layers=(0,), crossview_layers=(0,), temporal_layers=(1,),
        added_ids=11,
    ).eval()


def _oracle_dit_port():
    return DiTCrossviewTemporal(
        patch_size=2, num_layers=2, attention_head_dim=8,
        num_attention_heads=2, in_channels=16, out_channels=16,
        joint_attention_dim=24, caption_projection_dim=16,
        pooled_projection_dim=16, pos_embed_max_size=16, sample_size=8,
        qk_norm="rms_norm", dual_attention_layers=(0,),
        enable_crossview=True, crossview_attention_type="rowwise",
        crossview_block_layers=(0,), enable_temporal=True,
        temporal_attention_type="pointwise", temporal_block_layers=(1,),
        qk_norm_on_additional_modules="rms_norm",
        perspective_modeling_type="implicit",
        projection_class_embeddings_input_dim=11 * 256,
    )


def _assert_same_state(a: dict, b: dict):
    assert a.keys() == b.keys(), sorted(set(a) ^ set(b))[:10]
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


def test_sincos_tables_match_jax():
    full = layers.sincos_pos_embed_2d(32, (16, 12), 4)
    np.testing.assert_array_equal(
        full, jax_layers.sincos_pos_embed_2d(32, (16, 12), 4))
    # PatchEmbed's central crop of the square table, computed alone
    table = jax_layers.sincos_pos_embed_2d(32, (16, 16), 4).reshape(16, 16, 32)
    np.testing.assert_array_equal(
        layers.cropped_sincos_pos_embed(32, 6, 10, 16, 4),
        table[5:11, 3:13].reshape(60, 32))


def test_timestep_embedding_matches_jax():
    # Arguments reach ~1e3 rad, where one fp32 ulp is 6e-5: sin/cos of the
    # two libraries may differ by about that much.
    t = np.array([[0.0, 1.5, 999.0], [250.0, 3.0, 7.25]], np.float32)
    for dim in (8, 256, 9):
        np.testing.assert_allclose(
            layers.timestep_embedding(torch.from_numpy(t), dim).numpy(),
            np.asarray(jax_layers.timestep_embedding(jnp.asarray(t), dim)),
            atol=1e-4)


def test_dit_weight_bridge_round_trip():
    sd = {k: v.numpy() for k, v in _oracle_dit().state_dict().items()}
    back = dit_state_dict_from_flax(convert_ctsd_dit(sd, num_layers=2), 2)
    _assert_same_state(sd, back)


@pytest.mark.parametrize("use_quant_conv,latent", [(True, 4), (False, 16)])
def test_vae_weight_bridge_round_trip(use_quant_conv, latent):
    torch.manual_seed(0)
    oracle = AutoencoderKLOracle(chans=(32, 64), latent_ch=latent,
                                 use_quant_conv=use_quant_conv)
    sd = {k: v.numpy() for k, v in oracle.state_dict().items()}
    _assert_same_state(sd, vae_state_dict_from_flax(convert_autoencoder_kl(sd)))


def test_port_dit_loads_reference_state_dict_and_matches_oracle():
    oracle = _oracle_dit()
    with torch.no_grad():
        for p in oracle.parameters():
            if p.ndim == 1:
                p.add_(torch.randn_like(p) * 0.05)
    port = _oracle_dit_port()
    port.load_state_dict(oracle.state_dict())  # strict: same names/shapes
    rng = np.random.default_rng(0)
    b, t, v = 1, 2, 2
    args = [
        rng.standard_normal((b, t, v, 8, 8, 16)),
        rng.uniform(0, 1000, (b, t, v)),
        rng.standard_normal((b, t, v, 4, 24)),
        rng.standard_normal((b, t, v, 16)),
        rng.standard_normal((b, t, v, 11)),
    ]
    args = [torch.tensor(a, dtype=torch.float32) for a in args]
    with torch.no_grad():
        ref = oracle(*args)
        out = port(*args[:4], added_time_ids=args[4])
    assert (out - ref).abs().max().item() <= TOL


def test_single_view_input_matches_one_view():
    torch.manual_seed(1)
    port = _oracle_dit_port().eval()
    g = torch.Generator().manual_seed(1)
    args = dict(
        sample=torch.randn(1, 2, 1, 8, 8, 16, generator=g),
        timestep=torch.rand(1, 2, 1, generator=g) * 1000,
        encoder_hidden_states=torch.randn(1, 2, 1, 4, 24, generator=g),
        pooled_projections=torch.randn(1, 2, 1, 16, generator=g),
        added_time_ids=torch.randn(1, 2, 1, 11, generator=g),
    )
    with torch.no_grad():
        ref = port(**args)[:, :, 0]
        out = port(**{k: a[:, :, 0] for k, a in args.items()})
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


def test_tiny_dit_matches_jax():
    cfg = _synthetic_model_config()
    jax_model = JaxDiT(**cfg)
    rng = np.random.default_rng(1)
    # 16x24 latents: 96 latent + 40 text tokens = 136 joint tokens, so the
    # joint attention takes the tail-masked path; dual attention (96) and
    # rowwise cross-view (24) take plain math; temporal (t=2) the tiny form.
    b, t, v, h, w = 1, 2, 2, 16, 24
    inputs = {
        "sample": rng.standard_normal((b, t, v, h, w, 16)),
        "timestep": rng.uniform(0, 1000, (b, t, v)),
        "encoder_hidden_states": rng.standard_normal((b, t, v, 40, 24)),
        "pooled_projections": rng.standard_normal((b, t, v, 16)),
        "added_time_ids": rng.standard_normal((b, t, v, 3)),
        "disable_temporal": np.array([False]),
    }
    inputs = {k: (v.astype(np.float32) if v.dtype != bool else v)
              for k, v in inputs.items()}
    jax_inputs = {k: jnp.asarray(v) for k, v in inputs.items()}
    params = _random_params(jax_model.init, 2, **jax_inputs)
    ref = np.asarray(jax.jit(jax_model.apply)(params, **jax_inputs))

    port = DiTCrossviewTemporal(**cfg)
    port.load_state_dict(to_torch(
        dit_state_dict_from_flax(params, cfg["num_layers"])))
    with torch.no_grad():
        out = port(**{k: torch.from_numpy(v) for k, v in inputs.items()})
    assert out.shape == ref.shape
    assert float(np.abs(out.numpy() - ref).max()) <= TOL


@pytest.mark.parametrize("use_quant_conv,latent", [(True, 4), (False, 16)])
def test_tiny_vae_decode_matches_jax(use_quant_conv, latent):
    kw = dict(block_out_channels=(32, 64), latent_channels=latent,
              use_quant_conv=use_quant_conv, scaling_factor=1.5305,
              shift_factor=0.0609)
    jax_vae = JaxAutoencoderKL(**kw)
    rng = np.random.default_rng(latent)
    z = rng.standard_normal((2, 3, 6, 8, latent)).astype(np.float32)
    params = _random_params(jax_vae.init, 3, jnp.zeros((1, 12, 16, 3)))
    ref = np.asarray(jax.jit(jax_vae.decode_from_scaled)(params,
                                                         jnp.asarray(z)))

    port = AutoencoderKL(**kw)
    port.load_state_dict(to_torch(vae_state_dict_from_flax(params)))
    with torch.no_grad():
        out = port.decode_from_scaled(torch.from_numpy(z), chunk_size=4)
    assert out.shape == ref.shape == (2, 3, 12, 16, 3)
    assert float(np.abs(out.numpy() - ref).max()) <= TOL


def test_flagship_config_builds_port_classes_without_memory():
    cfg = json.loads((REPO / "configs/ctsd/multi_datasets/"
                      "ctsd_35_tirda_nwao.json").read_text())["pipeline"]
    with torch.device("meta"):
        pipe = create_instance_from_config(cfg)
    model = pipe.model
    assert isinstance(model, DiTCrossviewTemporal)
    assert model.dtype == torch.bfloat16
    assert len(model.transformer_blocks) == 24
    # 1 fps + 4 intrinsic + 12 extrinsic ids, 256 features each (the JAX
    # model sizes view_embedding from the ids it is fed, not from the
    # config's projection_class_embeddings_input_dim of 2816).
    assert model.view_embedding.linear_1.in_features == 17 * 256
    assert type(pipe.test_scheduler).__name__ == "FlowMatchEulerScheduler"


def test_config_get_state_and_dtype_names():
    from opendwm_tpu_torch import config

    config.global_state["test_torch_models.value"] = 7
    try:
        assert create_instance_from_config(
            {"_class_name": "dwm.common.get_state",
             "key": "test_torch_models.value"}) == 7
    finally:
        del config.global_state["test_torch_models.value"]
    for name, dtype in (("jnp.bfloat16", torch.bfloat16),
                        ("torch.float", torch.float32),
                        ("torch.half", torch.float16)):
        assert create_instance_from_config(
            {"_class_name": "get_class", "class_name": name}) is dtype


def test_unported_names_and_options_raise():
    from opendwm_tpu_torch.models.bev_world_vae import BEVWorldVAE
    from opendwm_tpu_torch.models.depth_net import DepthNet

    # ported now: the registry resolves them to the port's classes
    assert get_class("BEVWorldVAE") is BEVWorldVAE
    assert get_class("dwm.models.bevw_vae_mm_model.VAEBevMultiModality") \
        is BEVWorldVAE
    assert get_class("DepthNet") is DepthNet
    assert get_class("dwm.models.depth_net.DepthNet") is DepthNet
    with pytest.raises(KeyError, match="NoSuchModel"):
        get_class("NoSuchModel")
    # sequence_parallel_axis is ported now: the joint attentions ring over
    # that axis (one device without a process group: the block step alone)
    cfg = _synthetic_model_config()
    cfg["sequence_parallel_axis"] = "sp"
    model = DiTCrossviewTemporal(**cfg)
    assert all(b.attn.sp_axis == "sp" and b.attn.sp_group is None
               for b in model.transformer_blocks)
