"""The port's layout ImageAdapter vs the JAX package's, on the CPU in fp32.

- ``ImageAdapter`` alone at two tiny configs (DiT-like: 2 stages, the
  first down-sampled; UNet-like: 3 stages), zero convs and zero gates set
  to random non-zero values: every stage's feature to 1e-4 of
  ``max(1, |jax|)``.
- A tiny DiT and a tiny UNet with the adapter: the output to 1e-3 (the
  bar of ``test_dit_converter_parity.py``); the same output with the
  rasters swapped for the uncondition colour moves by at least 100x that
  bar, so the comparison sees the adapter.
- ``freezing_pattern``: a pattern that freezes all but the adapter, and
  the warmup configs' backbone pattern, split the port's parameters as
  the JAX package's ``optax.multi_transform`` labels split the flax tree.

The JAX models' parameters come from ``jax.eval_shape`` of their init,
drawn with numpy (``torch_port_helpers.random_flax_params``); the zero
gates are redrawn N(0, 1) so that the gated residuals are not near zero.
"""

import copy
import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendwm_tpu.models.adapters import ImageAdapter as JaxImageAdapter
from opendwm_tpu.models.mmdit import DiTCrossviewTemporal as JaxDiT
from opendwm_tpu.models.unet import UNetCrossviewTemporal as JaxUNet
from opendwm_tpu_torch.config import create_instance_from_config, get_class
from opendwm_tpu_torch.convert import (
    dit_flax_from_state_dict,
    dit_state_dict_from_flax,
    flax_param_name,
    image_adapter_state_dict_from_flax,
    to_torch,
    unet_state_dict_from_flax,
)
from opendwm_tpu_torch.models.adapters import ImageAdapter, pixel_unshuffle
from opendwm_tpu_torch.models.mmdit import DiTCrossviewTemporal
from opendwm_tpu_torch.models.unet import UNetCrossviewTemporal
from opendwm_tpu_torch.pipelines import optim

from torch_port_helpers import (
    TINY_BM_DIT,
    layout_rasters,
    random_flax_params,
    redraw_gates,
)

REPO = Path(__file__).resolve().parents[1]
FEATURE_TOL = 1e-4
MODEL_TOL = 1e-3
UNCOND_COLOR = 0.1255  # the bm configs' uncondition_image_color

ADAPTERS = {
    "dit": dict(in_channels=6, channels=[16, 16], is_downblocks=[True, False],
                num_res_blocks=2, downscale_factor=2, use_zero_convs=True,
                zero_gate_coef=0.5),
    "unet": dict(in_channels=6, channels=[8, 16, 16],
                 is_downblocks=[False, True, True], num_res_blocks=1,
                 downscale_factor=4, use_zero_convs=True, zero_gate_coef=2.0),
}


def _params(init, seed: int, *args, **kwargs) -> dict:
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), *args, **kwargs)
    tree = jax.tree.map(np.asarray, random_flax_params(shapes, seed))
    return redraw_gates(tree, np.random.default_rng(seed))


def _rel_max(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))


def test_pixel_unshuffle_matches_jax():
    from opendwm_tpu.models.adapters import pixel_unshuffle as jax_unshuffle

    x = np.random.default_rng(0).standard_normal((2, 8, 12, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(
        pixel_unshuffle(torch.from_numpy(x), 4).numpy(),
        np.asarray(jax_unshuffle(jnp.asarray(x), 4)))


@pytest.mark.parametrize("kind", ADAPTERS)
def test_image_adapter_features_match_jax(kind):
    cfg = ADAPTERS[kind]
    rng = np.random.default_rng(1)
    # leading (b, t, v) axes, as the denoisers hand them over
    x = layout_rasters(rng, (1, 2, 2, 16, 24, cfg["in_channels"]))
    jax_adapter = JaxImageAdapter(**cfg)
    params = _params(jax_adapter.init, 2, jnp.asarray(x))
    ref = jax.jit(jax_adapter.apply)(params, jnp.asarray(x))

    port = ImageAdapter(**cfg)
    port.load_state_dict(to_torch(image_adapter_state_dict_from_flax(params)))
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    assert len(out) == len(ref) == len(cfg["channels"])
    errs = [_rel_max(o.numpy(), r) for o, r in zip(out, ref)]
    print(f"adapter {kind}: features rel err {max(errs):.2e}")
    for i, (o, r) in enumerate(zip(out, ref)):
        assert o.shape == r.shape, i
        assert errs[i] <= FEATURE_TOL, i


def test_image_adapter_is_registered_and_zero_initialised():
    cls = get_class("dwm.models.adapters.ImageAdapter")
    assert cls is ImageAdapter is get_class("ImageAdapter")
    adapter = create_instance_from_config(
        {"_class_name": "dwm.models.adapters.ImageAdapter", **ADAPTERS["dit"]})
    assert all(not c.weight.any() and not c.bias.any()
               for c in adapter.zero_convs)
    assert not adapter.zero_gates.any()
    feats = adapter(torch.rand(2, 16, 24, 6))
    assert [tuple(f.shape) for f in feats] == [(2, 4, 6, 16)] * 2
    assert all(not f.any() for f in feats)  # zero convs and gates: no effect


# -- the denoisers with the adapter ------------------------------------------

DIT = TINY_BM_DIT  # shared with tests/test_torch_vae_encoder.py
UNET = dict(  # tests/test_unet.py widths
    in_channels=4, out_channels=4, block_out_channels=(8, 16, 16),
    layers_per_block=1, transformer_layers_per_block=1,
    num_attention_heads=(2, 2, 2), cross_attention_dim=12,
    addition_time_embed_dim=8, projection_class_embeddings_input_dim=24,
    merge_factor=2.0, enable_rowwise_crossview=True,
    enable_rowwise_temporal=True,
    # conv_in, then each down block's output (the CTSD-2.1 bm shape)
    condition_image_adapter_config=dict(
        in_channels=6, channels=[8, 8, 16, 16],
        is_downblocks=[False, True, True, False], num_res_blocks=1,
        downscale_factor=2, use_zero_convs=True, zero_gate_coef=1.0),
)


def _dit_inputs(rng, b=1, t=2, v=2, h=8, w=12) -> dict:
    inputs = {
        "sample": rng.standard_normal((b, t, v, h, w, 16)),
        "timestep": rng.uniform(0, 1000, (b, t, v)),
        "encoder_hidden_states": rng.standard_normal((b, t, v, 7, 24)),
        "pooled_projections": rng.standard_normal((b, t, v, 16)),
        "added_time_ids": rng.standard_normal((b, t, v, 3)),
        "condition_image_tensor": layout_rasters(
            rng, (b, t, v, 2 * h, 2 * w, 6)),
    }
    return {k: v.astype(np.float32) for k, v in inputs.items()}


def _unet_inputs(rng, b=1, t=2, v=2, h=16, w=16) -> dict:
    inputs = {
        "sample": rng.standard_normal((b, t, v, h, w, 4)),
        "timestep": rng.uniform(0, 1000, (b, t, v)),
        "encoder_hidden_states": rng.standard_normal((b, t, v, 5, 12)),
        "added_time_ids": rng.standard_normal((b, t, v, 3)),
        "condition_image_tensor": layout_rasters(
            rng, (b, t, v, 2 * h, 2 * w, 6)),
    }
    return {k: v.astype(np.float32) for k, v in inputs.items()}


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


def _denoisers():
    """(name, JAX model, params, port model, inputs) of the tiny DiT and
    UNet with the adapter."""
    rng = np.random.default_rng(3)
    dit_in = _dit_inputs(rng)
    jax_dit = JaxDiT(**DIT)
    dit_params = _params(jax_dit.init, 4,
                         **{k: jnp.asarray(v) for k, v in dit_in.items()})
    dit = DiTCrossviewTemporal(**DIT)
    dit.load_state_dict(to_torch(dit_state_dict_from_flax(
        dit_params, DIT["num_layers"])))
    yield "dit", jax_dit, dit_params, dit, dit_in

    unet_in = _unet_inputs(rng)
    jax_unet = JaxUNet(**UNET)
    unet_params = _zero_qkv_bias(_params(
        jax_unet.init, 5, **{k: jnp.asarray(v) for k, v in unet_in.items()}))
    unet = UNetCrossviewTemporal(**UNET)
    unet.load_state_dict(to_torch(unet_state_dict_from_flax(unet_params)))
    yield "unet", jax_unet, unet_params, unet, unet_in


@pytest.fixture(scope="module")
def denoisers():
    return {name: rest for name, *rest in _denoisers()}


@pytest.mark.parametrize("name", ["dit", "unet"])
def test_denoiser_with_adapter_matches_jax(denoisers, name):
    jax_model, params, port, inputs = denoisers[name]
    uncond = dict(inputs, condition_image_tensor=np.full_like(
        inputs["condition_image_tensor"], UNCOND_COLOR))
    apply = jax.jit(jax_model.apply)
    outs = {}
    for case, x in (("rasters", inputs), ("uncond", uncond)):
        ref = np.asarray(apply(params, **{k: jnp.asarray(v)
                                          for k, v in x.items()}))
        with torch.no_grad():
            out = port(**{k: torch.from_numpy(v) for k, v in x.items()})
        assert out.shape == ref.shape
        err = float(np.abs(out.numpy() - ref).max())
        print(f"{name} with the adapter, {case}: max abs err {err:.2e}")
        assert err <= MODEL_TOL, case
        outs[case] = ref
    # the rasters move the output far beyond the bar: the adapter is seen
    move = float(np.abs(outs["rasters"] - outs["uncond"]).max())
    print(f"{name}: the rasters move the output by {move:.3f}")
    assert move >= 100 * MODEL_TOL


@pytest.mark.parametrize("name", ["dit", "unet"])
def test_denoiser_adapter_weights_round_trip(denoisers, name):
    """The adapter's flax names (``flax_param_name``) are the flax tree's,
    and the reverse bridge puts its weights back."""
    _, params, port, _ = denoisers[name]
    tree = params["params"]["condition_image_adapter"]
    sd = {k: v for k, v in port.state_dict().items()
          if k.startswith("condition_image_adapter.")}
    back = dit_flax_from_state_dict(sd)["params"]["condition_image_adapter"]
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        a, b.astype(np.float32)), back, tree)


def _flax_names(tree, prefix=()) -> dict:
    """Dotted flax name → leaf, as ``optim.build_optimizer``'s labels_fn
    joins the tree path."""
    out = {}
    for name, node in tree.items():
        if isinstance(node, dict):
            out.update(_flax_names(node, prefix + (name,)))
        else:
            out[".".join(prefix + (name,))] = node
    return out


WARMUP = json.loads((REPO / "configs/ctsd/multi_datasets/"
                     "ctsd_21_tirda_bm_nwa_warmup.json").read_text())[
    "pipeline"]["training_config"]["freezing_pattern"]
PATTERNS = {"all_but_adapter": "^(?!condition_image_adapter)",
            "warmup_backbone": WARMUP}


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("name", ["dit", "unet"])
def test_freezing_pattern_splits_as_jax(denoisers, name, pattern):
    _, params, port, _ = denoisers[name]
    rx = re.compile(PATTERNS[pattern])
    flax = _flax_names(params["params"])
    jax_train = {n for n in flax if not rx.match(n)}
    trainable, frozen = optim.split_trainable(port, PATTERNS[pattern])
    by_id = {id(p): n for n, p in port.named_parameters()}
    port_train = {flax_param_name(by_id[id(p)], p.ndim) for p in trainable}
    port_frozen = {flax_param_name(by_id[id(p)], p.ndim) for p in frozen}
    names = port_train | port_frozen
    assert names <= flax.keys()
    # only the flax UNet's q/k/v biases have no port counterpart
    assert all(re.fullmatch(r".*\.to_[qkv]\.bias", n)
               for n in flax.keys() - names)
    assert port_train == jax_train & names
    adapter = {n for n in names if n.startswith("condition_image_adapter.")}
    assert adapter and adapter <= port_train
    if pattern == "all_but_adapter":
        assert port_train == adapter


def test_flagship_configs_build_the_adapter():
    for path, n_stages in (("ctsd/ctsd_35_tirda_bm_nwao.json", 6),
                           ("ctsd/multi_datasets/ctsd_21_tirda_bm_nwa.json",
                            5)):
        cfg = json.loads((REPO / "configs" / path).read_text())["pipeline"]
        with torch.device("meta"):
            pipe = create_instance_from_config(cfg)
        adapter = pipe.model.condition_image_adapter
        assert isinstance(adapter, ImageAdapter) and \
            len(adapter.body) == n_stages
        assert pipe.model.dtype == torch.bfloat16


@pytest.mark.parametrize("channels,stage", [([32, 40], 1), ([24, 32], 0)])
def test_dit_refuses_adapter_of_another_width(channels, stage):
    """Every adapter feature is added to the joint blocks' tokens, so each
    stage must be num_attention_heads x attention_head_dim wide (4 x 8 =
    32 here); the port says so when it is built, naming both widths."""
    kw = copy.deepcopy(TINY_BM_DIT)
    kw["condition_image_adapter_config"]["channels"] = channels
    with pytest.raises(ValueError, match=rf"stage {stage} is "
                       rf"{channels[stage]} wide.* = 32 wide"):
        DiTCrossviewTemporal(**kw)


def test_xs_configs_adapter_is_wider_than_their_dit():
    """The two XS configs pair a 20 x 64 = 1280-wide DiT with a 1536-wide
    ImageAdapter; the port refuses them when it builds them."""
    for name in ("ctsd_35_xs_df6v3_tirda_bm_nwao.json",
                 "ctsd_35_xs_df6v3_tirda_bm_nwao_streaming.json"):
        cfg = json.loads((REPO / "configs/experimental" / name).read_text())
        model = dict(cfg["pipeline"]["model"], num_layers=1)
        with torch.device("meta"), pytest.raises(
                ValueError, match="1536 wide.* = 1280 wide"):
            create_instance_from_config(model)
