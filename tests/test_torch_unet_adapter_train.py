"""The port's CTSD-2.1 layout UNet training step
(``configs/ctsd/multi_datasets/ctsd_21_tirda_bm_nwa.json``) vs the JAX
package's, on the CPU in fp32.

Both pipelines are built by their own config runtimes from the bm config,
the UNet cut to ``tests/test_torch_unet_train.py``'s tiny one at two
levels and its ``ImageAdapter`` to the config's shape in small (conv_in's
residual, then one a down block, down-sampled to each level; the config's
downscale 8; no zero convs, as the config), with the config's
conditions, training options and optimizer (AdamW lr 5e-5, weight decay
0.01, clip 1.0). The batch carries box and map rasters at 8 x the
latents, so the adapter's residuals reach conv_in and every down block.
Draws: one ``PRNGKey``'s, rebuilt for the port (DDPM integer timesteps).

Bars as ``tests/test_torch_unet_train.py``'s: the loss to 1e-5 relative,
each gradient (the adapter's too, each non-zero) to 1e-3 of its largest
entry or of 1% of the largest gradient entry, the gradient norm to 1e-4,
and one AdamW step's update to 1% of the learning rate where JAX's
gradient's sign is certain, twice the learning rate elsewhere.
"""

import copy
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import opendwm_tpu.config as jax_config
from opendwm_tpu.pipelines.ctsd import TrainState as JaxTrainState
from opendwm_tpu.pipelines.ctsd import get_conditions as jax_get_conditions
from opendwm_tpu_torch import config
from opendwm_tpu_torch.convert import (
    unet_flax_from_state_dict,
    unet_state_dict_from_flax,
    to_torch,
)

from test_torch_unet_train import (
    QKV_BIAS,
    TINY,
    _batch,
    _draws,
    _flat_names,
    _is_qkv_bias,
    _rel_to_max,
    _zero_qkv_bias,
)
from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    layout_rasters,
    one_torch_thread,
    random_flax_params,
    recording_tx,
    to_torch_tree,
)

REPO = Path(__file__).resolve().parents[1]
CONFIG = REPO / "configs/ctsd/multi_datasets/ctsd_21_tirda_bm_nwa.json"
# two levels: each level adds ~20 s to the JAX step's compile (~90 s at
# four)
UNET = dict(TINY, block_out_channels=[8, 16], num_attention_heads=[2, 2])
ADAPTER = dict(in_channels=6, channels=[8, 8, 16],
               is_downblocks=[False, True, False], num_res_blocks=1,
               downscale_factor=8)


def _pipeline_config() -> dict:
    cfg = json.loads(CONFIG.read_text())["pipeline"]
    assert cfg["model"]["condition_image_adapter_config"][
        "downscale_factor"] == ADAPTER["downscale_factor"]
    cfg["model"] = dict(UNET, _class_name=cfg["model"]["_class_name"],
                        condition_image_adapter_config=ADAPTER)
    return cfg


def _layout_batch() -> dict:
    batch = _batch(np.random.default_rng(0))
    b, t, v, h, w, _ = batch["latents"].shape
    rng = np.random.default_rng(1)
    for key in ("3dbox_images", "hdmap_images"):
        batch[key] = layout_rasters(rng, (b, t, v, 8 * h, 8 * w, 3))
    return batch


@pytest.fixture(scope="module")
def setup():
    cfg = _pipeline_config()
    jax_cfg = copy.deepcopy(cfg)
    jax_cfg["training_config"]["freezing_pattern"] = QKV_BIAS
    jax_pipe = jax_config.create_instance_from_config(jax_cfg)
    jax_pipe.tx = recording_tx(jax_pipe.tx)
    port_pipe = config.create_instance_from_config(copy.deepcopy(cfg))
    batch = _layout_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    conds = jax_get_conditions(jbatch, cfg["common_config"])
    assert conds["condition_image_tensor"].shape[-1] == 6
    shapes = jax.eval_shape(
        jax_pipe.model.init, jax.random.PRNGKey(0),
        sample=jbatch["latents"],
        timestep=jnp.zeros(batch["latents"].shape[:3]), **conds)
    params = _zero_qkv_bias(
        jax.tree.map(np.asarray, random_flax_params(shapes, 3)))
    assert "condition_image_adapter" in params["params"]
    port_pipe.model.load_state_dict(to_torch(
        unet_state_dict_from_flax(params)))
    return cfg, jax_pipe, params, port_pipe, batch


KEY = 0  # key 2 makes every frame a reference frame: a loss of 0


@pytest.fixture(scope="module")
def jax_step(setup):
    """JAX's step on ``KEY``'s draws, compiled once: the new state, the
    metrics and the gradients of its ``value_and_grad``."""
    cfg, jax_pipe, params, port_pipe, batch = setup
    jparams = jax.tree.map(jnp.asarray, params)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                          opt_state=jax_pipe.tx.init(jparams["params"]))
    new_state, metrics = jax.jit(jax_pipe._train_step_impl)(
        state, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(KEY))
    return new_state, metrics, new_state.opt_state[0]  # recording_tx's


def test_layout_unet_loss_and_gradients_match_jax(setup, jax_step):
    """The loss and every gradient of the step's ``value_and_grad``; the
    adapter's gradients are non-zero."""
    cfg, _, _, port_pipe, batch = setup
    _, ref_metrics, ref_grads = jax_step
    key = jax.random.PRNGKey(KEY)
    ref_loss = float(ref_metrics["sd_loss"])
    pipe = copy.copy(port_pipe)
    pipe.model = copy.deepcopy(port_pipe.model)
    draws = _draws(key, batch, cfg)
    loss, _ = pipe.loss_from_draws(to_torch_tree(batch), draws)
    loss.backward()
    assert ref_loss > 0 and abs(loss.item() - ref_loss) <= 1e-5 * ref_loss
    back = unet_flax_from_state_dict(
        {n: p.grad for n, p in pipe.model.named_parameters()})["params"]
    got = dict(zip(_flat_names(back), jax.tree.leaves(back)))
    ref = dict(zip(_flat_names(ref_grads),
                   map(np.asarray, jax.tree.leaves(ref_grads))))
    assert got.keys() == ref.keys()
    adapter = [n for n in ref if n.startswith("condition_image_adapter.")]
    assert len(adapter) > 10
    for name in adapter:
        assert float(np.abs(got[name]).max()) > 0, name
    floor = 1e-2 * max(np.abs(g).max() for g in ref.values())
    for name in sorted(n for n in ref if not _is_qkv_bias(n)):
        assert _rel_to_max(got[name], ref[name], floor) <= 1e-3, name



def test_layout_unet_train_step_matches_jax(setup, jax_step):
    """One AdamW step with the config's settings (lr 5e-5, weight decay
    0.01, clip 1.0): the loss, the gradient norm and the update; every
    adapter parameter moves."""
    cfg, _, _, port_pipe, batch = setup
    assert cfg["optimizer_config"] == {"lr": 5e-05, "weight_decay": 0.01}
    new_state, ref_metrics, ref_grads = jax_step
    key = jax.random.PRNGKey(KEY)
    ref_loss = float(ref_metrics["sd_loss"])
    ref = dict(zip(_flat_names(ref_grads),
                   map(np.asarray, jax.tree.leaves(ref_grads))))
    trainable = [g for n, g in ref.items() if not _is_qkv_bias(n)]
    grad_norm = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                                  for g in trainable)))
    pipe = copy.copy(port_pipe)
    pipe.model = copy.deepcopy(port_pipe.model)
    state = pipe.init_state()
    state, metrics = pipe.train_step(state, to_torch_tree(batch),
                                     draws=_draws(key, batch, cfg))
    assert abs(metrics["sd_loss"].item() - ref_loss) <= 1e-5 * ref_loss
    assert abs(metrics["grad_norm"].item() - grad_norm) <= 1e-4 * grad_norm
    new = unet_state_dict_from_flax(new_state.params)
    grads = unet_state_dict_from_flax({"params": _zero_qkv_bias(
        jax.tree.map(np.asarray, ref_grads))})
    before = port_pipe.model.state_dict()
    lr = cfg["optimizer_config"]["lr"]
    top = max(np.abs(g).max() for g in grads.values())
    certain = total = 0
    for name, p in pipe.model.named_parameters():
        start = before[name].numpy()
        gap = np.abs(p.detach().numpy() - new[name]) - \
            2 * np.spacing(np.abs(start))
        bar = 1e-3 * max(np.abs(grads[name]).max(), 1e-2 * top)
        sure = np.abs(grads[name]) > 10 * bar
        assert gap.max() <= 2.02 * lr, name
        if sure.any():
            assert gap[sure].max() <= 1e-2 * lr, name
        if name.startswith("condition_image_adapter."):
            assert not np.array_equal(p.detach().numpy(), start), name
        certain += int(sure.sum())
        total += sure.size
    assert certain >= total / 2
