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


def jax_training_draws(key, shape, tc, cc, num_train_timesteps=None) -> dict:
    """``CTSDPipeline.loss_fn``'s draws from ``key`` (ctsd.py:542-571), as
    the port's ``draw_training_randoms`` returns them: the flow-match draw,
    or with ``num_train_timesteps`` the DDPM's integer timesteps."""
    rng, _ = jax.random.split(key)  # the VAE's key
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
    return draws
