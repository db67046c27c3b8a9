"""The port's reference-checkpoint importer (``opendwm_tpu_torch.
torch_import``) against the JAX package's, on the CPU in fp32.

- DiT, UNet, VAE: random reference-named dicts from the in-repo torch
  oracles; the port's imported state dict equals, bit for bit, the JAX
  converter's flax tree mapped back by the port's weight bridge
  (``*_state_dict_from_flax(convert_*(sd))``); the port model loads it with
  ``strict=True`` and is within 1e-3 of the oracle's output (the bar of
  ``test_dit_converter_parity.py``).
- CLIP and T5: tiny HF models (``transformers``, skipped without it); the
  port's import equals ``clip_/t5_state_dict_from_flax(convert_*(sd))``
  and the port's forward is within 1e-4 in relative norm of HF's.
- Files: ``.pth``, ``.safetensors`` (the port's own reader and writer,
  held against the ``safetensors`` package), bf16 and
  ``{"state_dict": ...}``, against ``load_torch_state_dict`` of the JAX
  package; the SD2.1 key remap against the JAX CLI's.
- A missing key and an extra key each raise.
"""

import numpy as np
import pytest
import torch

from opendwm_tpu.convert import torch_import as jti
from opendwm_tpu.convert.cli import sd21_to_svd_keys as jax_sd21_to_svd_keys
from opendwm_tpu_torch import torch_import as ti
from opendwm_tpu_torch.convert import (
    clip_state_dict_from_flax,
    dit_state_dict_from_flax,
    t5_state_dict_from_flax,
    unet_state_dict_from_flax,
    vae_state_dict_from_flax,
)
from opendwm_tpu_torch.convert_cli import sd21_to_svd_keys
from opendwm_tpu_torch.models.autoencoders import AutoencoderKL
from opendwm_tpu_torch.models.mmdit import DiTCrossviewTemporal
from opendwm_tpu_torch.models.text_encoders import (
    CLIPTextEncoder,
    T5TextEncoder,
)
from opendwm_tpu_torch.models.unet import UNetCrossviewTemporal

from torch_oracle_mmdit import OracleDiT
from torch_oracle_unet import UNetCrossviewTemporalOracle
from torch_oracle_vae import AutoencoderKLOracle
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-3
TEXT_REL = 1e-4
UNET = dict(in_channels=8, out_channels=4, block_out_channels=(32, 64),
            layers_per_block=1, num_attention_heads=(2, 4),
            cross_attention_dim=32, addition_time_embed_dim=8,
            projection_class_embeddings_input_dim=24)


def _numpy(sd):
    return {k: v.detach().numpy() for k, v in sd.items()}


def _assert_same(a: dict, b: dict):
    assert a.keys() == b.keys(), sorted(set(a) ^ set(b))[:10]
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def _redraw_vectors(module, seed):
    """Biases and norm weights away from their 0/1 init, so a wrong map
    moves the output."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            if p.ndim == 1:
                p.add_(torch.randn(p.shape, generator=g) * 0.05)
    return module


def _oracle_dit():
    torch.manual_seed(0)
    return _redraw_vectors(OracleDiT(
        patch=2, layers=2, heads=2, head_dim=8, in_ch=16, out_ch=16,
        joint_dim=24, pooled_dim=16, max_size=16, base_size=4,
        dual_layers=(0,), crossview_layers=(0,), temporal_layers=(1,),
        added_ids=11).eval(), 1)


def _port_dit():
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
        projection_class_embeddings_input_dim=11 * 256).eval()


def test_dit_import_matches_jax_and_oracle():
    oracle = _oracle_dit()
    sd = oracle.state_dict()
    _assert_same(ti.convert_ctsd_dit(_numpy(sd), 2),
                 dit_state_dict_from_flax(jti.convert_ctsd_dit(_numpy(sd), 2),
                                          2))
    assert ti.dit_layer_count(sd) == 2
    port = _port_dit()
    port.load_state_dict(ti.convert_ctsd_dit(sd, 2), strict=True)
    rng = np.random.default_rng(0)
    args = [torch.tensor(a, dtype=torch.float32) for a in (
        rng.standard_normal((1, 2, 2, 8, 8, 16)),
        rng.uniform(0, 1000, (1, 2, 2)),
        rng.standard_normal((1, 2, 2, 4, 24)),
        rng.standard_normal((1, 2, 2, 16)),
        rng.standard_normal((1, 2, 2, 11)))]
    with torch.no_grad():
        ref = oracle(*args)
        out = port(*args[:4], added_time_ids=args[4])
    assert (out - ref).abs().max().item() <= TOL


def test_dit_import_fills_the_jax_zero_biases_and_skips_the_sincos_buffer():
    sd = _numpy(_oracle_dit().state_dict())
    del sd["proj_out.bias"]
    sd["pos_embed.pos_embed"] = np.zeros((1, 256, 16), np.float32)
    got = ti.convert_ctsd_dit(sd, 2)
    assert not got["proj_out.bias"].any()
    _assert_same(got, dit_state_dict_from_flax(jti.convert_ctsd_dit(sd, 2), 2))


@pytest.mark.parametrize("sd21", [False, True], ids=["svd_keys", "sd21_keys"])
def test_unet_import_matches_jax_and_oracle(sd21):
    torch.manual_seed(0)
    oracle = _redraw_vectors(UNetCrossviewTemporalOracle(**UNET).eval(), 2)
    sd = oracle.state_dict()
    if sd21:
        # an SD2.1-era dict: the spatial resnets without the SVD wrapper
        # (the oracle's temporal resnets would not survive the remap, in
        # either package, so this case keeps the spatial ones only)
        keep = {k: v for k, v in sd.items()
                if "temporal_res_block" not in k and "time_mixer" not in k
                or "attentions" in k}
        sd = {k.replace(".spatial_res_block", ""): v for k, v in keep.items()}
        assert sd21_to_svd_keys(sd) != sd
        np_sd = _numpy(sd)
        got = jax_sd21_to_svd_keys(np_sd)
        assert sd21_to_svd_keys(np_sd).keys() == got.keys()
        ref = unet_state_dict_from_flax(jti.convert_ctsd_unet(got))
        _assert_same(ti.convert_ctsd_unet(sd21_to_svd_keys(np_sd)), ref)
        return
    _assert_same(ti.convert_ctsd_unet(_numpy(sd)),
                 unet_state_dict_from_flax(jti.convert_ctsd_unet(_numpy(sd))))
    assert sd21_to_svd_keys(sd) is sd  # nothing to remap
    port = UNetCrossviewTemporal(**UNET).eval()
    port.load_state_dict(ti.convert_ctsd_unet(sd), strict=True)
    rng = np.random.default_rng(0)
    inp = dict(
        sample=rng.standard_normal((1, 2, 2, 8, 8, 8), np.float32) * 0.5,
        timestep=rng.uniform(0, 1000, (1, 2, 2)).astype(np.float32),
        encoder_hidden_states=rng.standard_normal((1, 2, 2, 3, 32),
                                                  np.float32),
        added_time_ids=rng.standard_normal((1, 2, 2, 3), np.float32))
    with torch.no_grad():
        ref = oracle(torch.from_numpy(inp["sample"].transpose(0, 1, 2, 5, 3,
                                                              4)),
                     *(torch.from_numpy(inp[k]) for k in (
                         "timestep", "encoder_hidden_states",
                         "added_time_ids")))
        out = port(**{k: torch.from_numpy(v) for k, v in inp.items()})
    ref = ref.permute(0, 1, 2, 4, 5, 3)
    assert (out - ref).abs().max().item() <= TOL


@pytest.mark.parametrize("use_quant_conv,latent", [(True, 4), (False, 16)])
def test_vae_import_matches_jax_and_oracle(use_quant_conv, latent):
    torch.manual_seed(0)
    oracle = _redraw_vectors(AutoencoderKLOracle(
        chans=(32, 64), latent_ch=latent,
        use_quant_conv=use_quant_conv).eval(), 3)
    sd = oracle.state_dict()
    _assert_same(ti.convert_autoencoder_kl(_numpy(sd)),
                 vae_state_dict_from_flax(jti.convert_autoencoder_kl(
                     _numpy(sd))))
    port = AutoencoderKL(block_out_channels=(32, 64), latent_channels=latent,
                         use_quant_conv=use_quant_conv).eval()
    port.load_state_dict(ti.convert_autoencoder_kl(sd), strict=True)
    x = np.random.default_rng(0).standard_normal((2, 16, 16, 3),
                                                 np.float32) * 0.5
    with torch.no_grad():
        recon, mean, _ = oracle(torch.from_numpy(x.transpose(0, 3, 1, 2)))
        got_mean, _ = port.encode(torch.from_numpy(x))
        got = port.decode(got_mean)
    assert (got_mean - mean.permute(0, 2, 3, 1)).abs().max() <= TOL
    assert (got - recon.permute(0, 2, 3, 1)).abs().max() <= TOL


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("act,proj", [("quick_gelu", None), ("gelu", 32)])
def test_clip_import_matches_jax_and_hf(act, proj):
    transformers = pytest.importorskip("transformers")
    cfg = transformers.CLIPTextConfig(
        vocab_size=99, hidden_size=16, intermediate_size=37,
        num_hidden_layers=3, num_attention_heads=4,
        max_position_embeddings=77, hidden_act=act, eos_token_id=2,
        bos_token_id=0, pad_token_id=1, projection_dim=proj or 16)
    torch.manual_seed(0)
    hf = (transformers.CLIPTextModelWithProjection if proj
          else transformers.CLIPTextModel)(cfg).eval()
    sd = hf.state_dict()
    _assert_same(ti.convert_clip_text(_numpy(sd)),
                 clip_state_dict_from_flax(jti.convert_clip_text(_numpy(sd))))
    port = CLIPTextEncoder(vocab_size=99, hidden_size=16, num_layers=3,
                           num_heads=4, intermediate_size=37, act=act,
                           eos_token_id=2, projection_dim=proj).eval()
    port.load_state_dict(ti.convert_clip_text(sd), strict=True)
    ids = torch.tensor([[0, 5, 9, 42, 2, 1, 1, 1], [0, 7, 2, 1, 1, 1, 1, 1]])
    with torch.no_grad():
        ref = hf(ids, output_hidden_states=True)
        last, pooled, hidden = port(ids)
    assert _rel(last, ref.last_hidden_state) <= TEXT_REL
    assert _rel(hidden[-2], ref.hidden_states[-2]) <= TEXT_REL
    assert _rel(pooled, ref.text_embeds if proj else ref.pooler_output) \
        <= TEXT_REL


def test_t5_import_matches_jax_and_hf():
    transformers = pytest.importorskip("transformers")
    cfg = transformers.T5Config(
        vocab_size=99, d_model=32, d_kv=8, d_ff=48, num_layers=3,
        num_heads=4, feed_forward_proj="gated-gelu",
        relative_attention_num_buckets=32)
    torch.manual_seed(0)
    hf = transformers.T5EncoderModel(cfg).eval()
    sd = hf.state_dict()
    assert "encoder.embed_tokens.weight" in sd  # HF's tie, read and checked
    _assert_same(ti.convert_t5_encoder(_numpy(sd)),
                 t5_state_dict_from_flax(jti.convert_t5_encoder(_numpy(sd))))
    port = T5TextEncoder(vocab_size=99, d_model=32, d_kv=8, d_ff=48,
                         num_layers=3, num_heads=4).eval()
    port.load_state_dict(ti.convert_t5_encoder(sd), strict=True)
    ids = torch.tensor([[3, 17, 44, 8, 1, 0], [5, 9, 1, 0, 0, 0]])
    with torch.no_grad():
        ref = hf(ids).last_hidden_state
        out = port(ids)
    assert _rel(out, ref) <= TEXT_REL
    untied = dict(sd, **{"encoder.embed_tokens.weight":
                         sd["shared.weight"] + 1})
    with pytest.raises(ValueError, match="embed_tokens"):
        ti.convert_t5_encoder(untied)


def _vae_source():
    torch.manual_seed(0)
    return _redraw_vectors(AutoencoderKLOracle(chans=(16, 32)), 4).state_dict()


@pytest.mark.parametrize("form", ["pth", "wrapped", "bf16", "safetensors",
                                  "safetensors_bf16"])
def test_files_load_as_the_jax_loader(tmp_path, form):
    sd = _vae_source()
    if form.endswith("bf16"):
        sd = {k: v.bfloat16() for k, v in sd.items()}
    if form.startswith("safetensors"):
        path = tmp_path / "vae.safetensors"
        ti.write_safetensors(str(path), sd)
    else:
        path = tmp_path / "vae.pth"
        torch.save({"state_dict": sd} if form == "wrapped" else sd, path)
    got = ti.load_torch_state_dict(str(path))
    want = jti.load_torch_state_dict(str(path))
    assert got.keys() == want.keys() == sd.keys()
    for k in sd:
        assert got[k].dtype == sd[k].dtype  # bf16 stays bf16
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      np.asarray(want[k], np.float32))
    # (JAX widens a .pth's bf16 to fp32 and keeps a .safetensors' bf16)
    _assert_same(ti.convert_autoencoder_kl(
                     {k: v.float().numpy() for k, v in got.items()}),
                 vae_state_dict_from_flax(jti.convert_autoencoder_kl(
                     {k: np.asarray(v, np.float32) for k, v in want.items()})))


def test_safetensors_reader_and_writer_against_the_package(tmp_path):
    st_numpy = pytest.importorskip("safetensors.numpy")
    st_torch = pytest.importorskip("safetensors.torch")
    rng = np.random.default_rng(0)
    arrays = {"a": rng.standard_normal((3, 5)).astype(np.float32),
              "b": rng.standard_normal(7).astype(np.float16),
              "c": rng.integers(-9, 9, (2, 2)).astype(np.int64),
              "d": np.zeros((0, 4), np.float32),
              "e": rng.standard_normal((1, 3)).astype(np.float64)}
    theirs = tmp_path / "theirs.safetensors"
    st_numpy.save_file(arrays, str(theirs), metadata={"format": "np"})
    got = ti.read_safetensors(str(theirs))
    assert got.keys() == arrays.keys()
    for k, v in arrays.items():
        np.testing.assert_array_equal(got[k].numpy(), v)
        assert got[k].numpy().dtype == v.dtype
    tensors = {k: torch.from_numpy(v) for k, v in arrays.items()}
    tensors["f"] = torch.randn(4, 3).bfloat16()
    ours = tmp_path / "ours.safetensors"
    ti.write_safetensors(str(ours), tensors)
    back = st_torch.load_file(str(ours))
    assert back.keys() == tensors.keys()
    for k, v in tensors.items():
        assert torch.equal(back[k], v) and back[k].dtype == v.dtype


def test_missing_and_extra_keys_raise():
    sd = _numpy(_oracle_dit().state_dict())
    with pytest.raises(KeyError, match="proj_out.weight"):
        ti.convert_ctsd_dit({k: v for k, v in sd.items()
                             if k != "proj_out.weight"}, 2)
    with pytest.raises(ValueError, match="no place in the port model"):
        ti.convert_ctsd_dit(dict(sd, **{"stray.weight": sd["proj_out.bias"]}),
                            2)
    with pytest.raises(ValueError, match="transformer_blocks.1"):
        ti.convert_ctsd_dit(sd, 1)  # the last block's keys stay unread
    vae = _numpy(_vae_source())
    with pytest.raises(ValueError, match="no place"):
        ti.convert_autoencoder_kl(dict(vae, extra=vae["decoder.conv_in.bias"]))
    with pytest.raises(KeyError):
        ti.convert_autoencoder_kl({k: v for k, v in vae.items()
                                   if "mid_block" not in k})


def test_the_jax_cli_remaps_a_vae_and_fails_where_the_port_does_not():
    """The JAX CLI applies ``sd21_to_svd_keys`` to every kind, and a
    diffusers VAE's ``resnets.N.conv1`` keys match it, so ``--kind vae``
    fails there (``opendwm_tpu/convert/cli.py:65``); the port's CLI remaps
    UNet dicts only."""
    sd = _numpy(_vae_source())
    with pytest.raises(KeyError):
        jti.convert_autoencoder_kl(jax_sd21_to_svd_keys(sd))
    _assert_same(ti.convert_autoencoder_kl(sd),
                 vae_state_dict_from_flax(jti.convert_autoencoder_kl(sd)))


FULL_WIDTH = {
    # the serving DiT and UNet of chip_smoke.py's phases 5 and 7
    "ctsd_dit": "configs/ctsd/multi_datasets/ctsd_35_tirda_nwao.json",
    "ctsd_unet": "configs/ctsd/multi_datasets/ctsd_21_tirda_nwao.json",
    "ctsd_unet_sd21": "configs/ctsd/multi_datasets/ctsd_21_tirda_nwao.json",
}


def _full_width(kind):
    from opendwm_tpu_torch import run_all
    from opendwm_tpu_torch.models.autoencoders import sd35_vae
    from opendwm_tpu_torch.models.i3d import InceptionI3d
    from opendwm_tpu_torch.models.inception import FIDInceptionV3

    if kind in FULL_WIDTH:
        kw = run_all.load_model_kwargs(FULL_WIDTH[kind])
        if kind == "ctsd_dit":
            return DiTCrossviewTemporal(**kw)
        if kind == "ctsd_unet_sd21":
            kw.update(enable_crossview=False, enable_temporal=False)
        return UNetCrossviewTemporal(**kw)
    return {"vae": sd35_vae,
            "clip_l": lambda: CLIPTextEncoder(
                hidden_size=768, num_layers=12, num_heads=12,
                act="quick_gelu", projection_dim=768),
            "clip_g": lambda: CLIPTextEncoder(
                hidden_size=1280, num_layers=32, num_heads=20,
                projection_dim=1280),
            "t5_xxl": T5TextEncoder, "i3d": InceptionI3d,
            "fid_inception": FIDInceptionV3}[kind]()


@pytest.mark.parametrize("kind", ["ctsd_dit", "ctsd_unet", "ctsd_unet_sd21",
                                  "vae", "clip_l", "clip_g", "t5_xxl", "i3d",
                                  "fid_inception"])
def test_full_width_key_sets(kind):
    """The full-width models' reference-named key sets (built on the meta
    device: no weights) import onto the port's exactly, T5-XXL included,
    whose import the card phase leaves unrun."""
    from opendwm_tpu_torch import run_all
    from opendwm_tpu_torch.perf.land_eval import (
        reference_state_dict,
        sd21_state_dict,
    )

    with torch.device("meta"):
        model = _full_width(kind)
    src_kind = {"clip_l": "clip", "clip_g": "clip", "t5_xxl": "t5",
                "ctsd_unet_sd21": "ctsd_unet"}.get(kind, kind)
    sd = reference_state_dict(src_kind, model)
    if kind == "ctsd_unet_sd21":
        sd = sd21_state_dict(sd)
        assert sd21_to_svd_keys(sd) != sd
    state = run_all.convert(src_kind, sd)
    want = model.state_dict()
    assert state.keys() == want.keys()
    assert all(state[k].shape == want[k].shape for k in want)
    model.load_state_dict(state, strict=True)
    if kind == "ctsd_dit":
        assert ti.dit_layer_count(sd) == 24
