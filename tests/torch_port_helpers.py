"""Shared helpers of the tests that hold the PyTorch port against JAX."""

import jax
import jax.numpy as jnp
import numpy as np
import torch


def random_flax_params(shapes, seed: int):
    """A flax param tree of ``shapes`` (from ``jax.eval_shape(init, ...)``,
    so no init is compiled) drawn with numpy: kernels ~ N(0, 1/fan_in),
    norm scales ~ 1 + N(0, 0.05^2), everything else ~ N(0, 0.05^2) so
    that no bias is zero."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        if len(leaf.shape) >= 2:
            return noise / np.sqrt(np.prod(leaf.shape[:-1]))
        if path[-1].key == "scale":
            return 1.0 + 0.05 * noise
        return 0.05 * noise

    return jax.tree_util.tree_map_with_path(draw, shapes)


def flax_text_params(module, ids_shape, seed: int):
    """Params of a flax text encoder drawn with numpy: matrices N(0,
    1/fan_in), embeddings and the relative bias N(0, 1), norm scales 1 +
    N(0, 0.05^2), biases N(0, 0.05^2)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            jnp.zeros(ids_shape, jnp.int32))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        noise = rng.standard_normal(leaf.shape)
        name = path[-1].key
        if name in ("embedding", "relative_attention_bias"):
            value = noise
        elif name == "position_embedding":
            value = 0.1 * noise
        elif len(leaf.shape) >= 2:
            value = noise / np.sqrt(leaf.shape[0])
        elif name in ("scale", "weight"):
            value = 1.0 + 0.05 * noise
        else:
            value = 0.05 * noise
        return value.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def redraw_gates(tree, rng):
    """The flax tree with every ``zero_gates`` leaf drawn N(0, 1)."""
    out = {}
    for name, node in tree.items():
        if name == "zero_gates":
            out[name] = rng.standard_normal(node.shape).astype(np.float32)
        elif isinstance(node, dict):
            out[name] = redraw_gates(node, rng)
        else:
            out[name] = node
    return out


def to_torch_tree(tree):
    """A (nested dict) tree of arrays as torch tensors."""
    if isinstance(tree, dict):
        return {k: to_torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def jax_prediction_draws(key, shape, style) -> dict:
    """``make_input_for_prediction``'s draws from ``key`` (ctsd.py:330), as
    the port's ``draw_prediction_randoms`` returns them."""
    b, t, v = shape[:3]
    ks = jax.random.split(key, 7)
    return to_torch_tree({
        "scale": jax.random.normal(ks[0], (b, t, 1, 1, 1, 1)),
        "offset": jax.random.normal(ks[1], (b, t, 1, 1, 1, 1)),
        "task": jax.random.uniform(ks[2], (b, 1, 1)),
        "image": jax.random.uniform(
            ks[3], (b,) if style == "diffusion_forcing" else (b, 1, 1)),
        "all_visible": jax.random.uniform(ks[4], (b, 1, 1)),
        "partial_visible": jax.random.uniform(ks[5], (b, t, v)),
        "count": jax.random.uniform(ks[6], (b, 1, 1)),
    })


def jax_training_draws(key, shape, tc, cc, num_train_timesteps=None,
                       vae: bool = False) -> dict:
    """``CTSDPipeline.loss_fn``'s draws from ``key`` (ctsd.py:542-571), as
    the port's ``draw_training_randoms`` returns them: the flow-match draw,
    or with ``num_train_timesteps`` the DDPM's integer timesteps; with
    ``vae``, the VAE posterior's noise (``sample_posterior``'s draw)."""
    rng, k_vae = jax.random.split(key)
    k_noise, k_time, k_text, k_box, k_map, k_act, k_pred = \
        jax.random.split(rng, 7)
    b, t = shape[:2]
    style = cc.get("frame_prediction_style")
    t_shape = (b, t) if style == "diffusion_forcing" else (b,)
    if num_train_timesteps is not None:
        time = jax.random.randint(k_time, t_shape, 0, num_train_timesteps)
    elif tc.get("weighting_scheme", "logit_normal") == "logit_normal":
        time = jax.random.normal(k_time, t_shape)
    else:
        time = jax.random.uniform(k_time, t_shape)
    draws = to_torch_tree({
        "noise": jax.random.normal(k_noise, shape, jnp.float32),
        "time": time,
        "text": jax.random.uniform(k_text, (b,)),
        "box": jax.random.uniform(k_box, (b,)),
        "map": jax.random.uniform(k_map, (b,)),
        "action": jax.random.uniform(k_act, (b,)),
    })
    draws["prediction"] = jax_prediction_draws(k_pred, shape, style)
    if vae:
        draws["vae"] = to_torch_tree(
            jax.random.normal(k_vae, shape, jnp.float32))
    return draws


def layout_rasters(rng, shape) -> np.ndarray:
    """Box/map-like layout rasters: mostly background, a quarter of the
    pixels set to uniform values."""
    return np.where(rng.uniform(size=shape) < 0.25, rng.uniform(size=shape),
                    0.0).astype(np.float32)


# A tiny DiT with the ImageAdapter: 3 joint blocks (dual attention, a
# rowwise cross-view and a pointwise temporal branch) and 2 adapter stages
# of the joint width, the first down-sampled (the flagship's shape), so
# rasters at 2x the latents land on the 2x2 patch grid.
TINY_BM_DIT = dict(
    patch_size=2, num_layers=3, attention_head_dim=8, num_attention_heads=4,
    in_channels=16, out_channels=16, joint_attention_dim=24,
    caption_projection_dim=32, pooled_projection_dim=16,
    pos_embed_max_size=16, sample_size=8, qk_norm="rms_norm",
    dual_attention_layers=[0], enable_crossview=True,
    crossview_attention_type="rowwise", crossview_block_layers=[1],
    enable_temporal=True, temporal_attention_type="pointwise",
    temporal_block_layers=[2], qk_norm_on_additional_modules="rms_norm",
    perspective_modeling_type="implicit",
    projection_class_embeddings_input_dim=3 * 256,
    condition_image_adapter_config=dict(
        in_channels=6, channels=[32, 32], is_downblocks=[True, False],
        num_res_blocks=2, downscale_factor=2, use_zero_convs=True),
)


def rel(port, ref) -> float:
    """``||port - ref|| / ||ref||`` in float64."""
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(port - ref) / np.linalg.norm(ref))


def flax_init(module, *args, seed: int = 0, **kwargs):
    """fp32 numpy params of flax ``module`` for ``module.init(*args,
    **kwargs)``, from ``jax.eval_shape`` and ``random_flax_params``."""
    shapes = jax.eval_shape(
        lambda *a: module.init(jax.random.PRNGKey(0), *a, **kwargs), *args)
    return jax.tree.map(lambda a: np.asarray(a, np.float32),
                        random_flax_params(shapes, seed))


def load_lidar(port_module, params):
    """``port_module`` (a LiDAR tokenizer or MaskGIT module) with the flax
    ``params`` through ``convert.lidar_state_dict_from_flax``."""
    from opendwm_tpu_torch.convert import lidar_state_dict_from_flax, to_torch

    port_module.load_state_dict(to_torch(lidar_state_dict_from_flax(params)))
    return port_module
