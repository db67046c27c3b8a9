"""Shared helpers of the tests that hold the PyTorch port against JAX."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
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


def recording_tx(tx):
    """``tx`` behind a stage that passes the updates through and keeps
    them (the raw gradients) as its state, so that one compiled
    ``_train_step_impl`` also returns the gradients of its
    ``jax.value_and_grad`` (in ``opt_state[0]``)."""
    import optax

    return optax.chain(optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates)), tx)


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


# -- the LiDAR trainers' bars: gradients and one AdamW update on the flax
# tree (``lidar_flax_from_state_dict``)

GRAD_TOL = 1e-4
PARAM_TOL = 1e-5
UPDATE_TOL = 1e-3
ADAM_EPS = 1e-8


def lidar_grads(port_module) -> dict:
    """The port's gradients on the flax tree, as ``{path: array}``."""
    from opendwm_tpu_torch.convert import lidar_flax_from_state_dict

    tree = lidar_flax_from_state_dict(
        {n: p.grad for n, p in port_module.named_parameters()})
    return dict(jax.tree_util.tree_leaves_with_path(tree))


def lidar_float64_grads(make_loss) -> dict:
    """The gradients of ``make_loss(dtype)`` (a loss of a port module built
    in that dtype, returned with the module) in float64, on the flax
    tree."""
    loss, module = make_loss(torch.float64)
    loss.backward()
    return lidar_grads(module)


def check_grad_dicts(got: dict, ref: dict, exact: dict,
                     tol: float = GRAD_TOL) -> None:
    """Each gradient of ``got`` within ``tol`` of JAX's (``ref``, same
    keys). Where JAX's own fp32 gradient is further than ``tol`` / 2 from
    ``exact`` (the same loss in float64: a sum of many cancelling terms,
    such as the bias gradients of the density branch's first block), the
    port is held within twice JAX's distance of JAX's and within ``tol``
    of ``exact``. Where JAX's is 0 (a shifted window of one token per
    region: the −100 mask leaves one key, so the position bias gets none)
    the port's is below 1e-20."""
    assert set(got) == set(ref)
    nonzero = 0
    for key, g in ref.items():
        g, mine = np.asarray(g), np.asarray(got[key])
        if float(np.abs(g).max()) == 0:
            assert float(np.abs(mine).max()) < 1e-20, key
            continue
        nonzero += 1
        jax_error = rel(g, exact[key])
        if jax_error <= tol / 2:
            assert rel(mine, g) < tol, (key, rel(mine, g))
        else:
            assert rel(mine, g) < 2 * jax_error, (key, rel(mine, g))
            assert rel(mine, exact[key]) < tol, key
    assert nonzero > 0.9 * len(ref)


def check_lidar_grads(port_module, jax_grads, exact: dict) -> None:
    """``check_grad_dicts`` on the flax tree of a LiDAR module."""
    check_grad_dicts(lidar_grads(port_module),
                     dict(jax.tree_util.tree_leaves_with_path(jax_grads)),
                     exact)


def check_update_dicts(got: dict, old: dict, new: dict, grads: dict,
                       lr: float, max_norm=None, param_tol: float = PARAM_TOL,
                       update_tol: float = UPDATE_TOL) -> None:
    """The port's parameters after one AdamW step (``got``) within
    ``param_tol`` of JAX's (``new``) and their move from ``old`` within
    ``update_tol`` of JAX's (plus four ulps of the fp32 parameters: torch's
    AdamW rounds the decay and the step apart, optax rounds their sum, so
    an entry may land two ulps away, and a move of weight decay alone is a
    few ulps), but where JAX's gradient
    (``grads``), clipped to ``max_norm`` as the step clips it, is below
    100 x AdamW's eps: its first step moves such an entry by ``lr · g /
    (|g| + eps)``, which turns the fp32 noise of a gradient near 0 (an
    attention's key bias, a bias before a normalisation: 0 in exact
    arithmetic) into a move of up to lr; there both packages move by at
    most lr."""
    norm = np.sqrt(sum(float((np.asarray(g, np.float64) ** 2).sum())
                       for g in grads.values()))
    scale = min(1.0, max_norm / norm) if max_norm and norm > 0 else 1.0
    for key, want in new.items():
        want, before = np.asarray(want), np.asarray(old[key])
        mine = np.asarray(got[key])
        noisy = np.abs(np.asarray(grads[key])) * scale < 100 * ADAM_EPS
        if noisy.any():
            assert np.abs(mine - before)[noisy].max() <= 1.01 * lr, key
            assert np.abs(want - before)[noisy].max() <= 1.01 * lr, key
        ok = ~noisy
        if not ok.any():
            continue
        assert rel(mine[ok], want[ok]) < param_tol, key
        step = want[ok].astype(np.float64) - before[ok]
        err = mine[ok].astype(np.float64) - want[ok]
        assert np.linalg.norm(err) <= update_tol * np.linalg.norm(step) \
            + 4 * np.linalg.norm(np.spacing(want[ok])), key


def check_lidar_update(port_module, old_params, new_params, grads,
                       lr: float, max_norm=None) -> None:
    """``check_update_dicts`` on the flax tree of a LiDAR module."""
    from opendwm_tpu_torch.convert import lidar_flax_from_state_dict

    def leaves(tree):
        return dict(jax.tree_util.tree_leaves_with_path(tree))

    check_update_dicts(
        leaves(lidar_flax_from_state_dict(port_module.state_dict())[
            "params"]), leaves(old_params), leaves(new_params),
        leaves(grads), lr, max_norm)


def assert_same_item(got, want, path: str = "item") -> None:
    """``got`` (a port reader's item) is ``want`` (the JAX reader's) key
    for key, in the same order, and bit for bit: arrays by dtype, shape
    and values, numpy scalars by type and value, PIL images by mode, size
    and pixels, lists, tuples and dicts element by element."""
    from PIL import Image

    if isinstance(want, dict):
        assert isinstance(got, dict), path
        assert list(got) == list(want), (path, list(got), list(want))
        for k in want:
            assert_same_item(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_item(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert (got.dtype, got.shape) == (want.dtype, want.shape), path
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, Image.Image):
        assert isinstance(got, Image.Image), path
        assert (got.mode, got.size) == (want.mode, want.size), path
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=path)
    else:
        assert type(got) is type(want), (path, type(got), type(want))
        assert got == want or (got != got and want != want), \
            (path, got, want)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for the test (autouse where a test module
    imports it). Those modules run many small ops; the suite runs six
    workers on the host's cores, where OpenMP's barriers over a full team
    each stall while other workers hold the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
