"""Shared helpers of the tests that hold the PyTorch port against JAX."""

import jax
import numpy as np


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
