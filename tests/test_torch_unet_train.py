"""The port's CTSD-2.1 UNet training step vs the JAX package's, on the CPU
in fp32.

Both pipelines are built by their own config runtimes from
``configs/ctsd/multi_datasets/ctsd_21_tirda_nwao.json`` with the UNet cut
to a tiny one (``block_out_channels`` [8, 16, 16, 16], 2 heads per level,
``layers_per_block`` 1, rowwise branches, remat as the config sets it) and
the config's conditions and training options. The JAX params come from
``jax.eval_shape`` of the init drawn with numpy (no init is run), q/k/v
biases zero; the port loads them through the weight bridge. Both take the
same draws: the port's are rebuilt from the JAX ``PRNGKey`` in the split
order of ``CTSDPipeline.loss_fn`` (DDPM integer timesteps). Latents of
16 x 16 make the level-0 self-attention 256 tokens, so the port's attention
goes through K7's autograd Function (plain forward and backward on the
CPU).

The flax UNet's q/k/v projections carry biases that the reference's (and
the port's) have not; under ``jax.value_and_grad`` they get gradients.
The JAX side freezes them through ``freezing_pattern`` so that both clip by
the norm of the same parameters and the biases stay zero after the step
(ROADMAP Queue 3).

Tolerances: the loss to 1e-5 relative; each gradient to 1e-3 of its
largest entry, the UNet bar of ``tests/test_unet_converter_parity.py``,
or of 1% of the largest entry of all gradients if that is more: a
gradient far below the rest is a sum of cancelling terms whose rounding
scales with the terms, not with the sum (the mixers' factors: ~2e-7 apart
at any size, 1.3e-4 at the smallest, where the largest entry is 8.4e-2),
or vanishes in exact arithmetic (a conv bias right before a group norm of
one channel per group: rounding noise of 1e-9 in both packages); the
gradient norm to 1e-4 relative. One AdamW step moves a parameter by
about the learning rate (5e-5) times the sign of its gradient, plus the
decay, so the update is held to 1% of the learning rate (plus two fp32
ulps of the parameter) wherever the JAX gradient is ten times the
gradient bar, its sign thus certain, and to twice the learning rate
elsewhere (a gradient entry near 0 may take either sign in the two
packages). Remat on or off to 1e-6 (it changes memory, never values).
"""

import copy
import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import opendwm_tpu.config as jax_config
from opendwm_tpu.pipelines import optim as jax_optim
from opendwm_tpu.pipelines.ctsd import TrainState as JaxTrainState
from opendwm_tpu.pipelines.ctsd import get_conditions as jax_get_conditions
from opendwm_tpu_torch import checkpoint, config, train
from opendwm_tpu_torch.convert import (
    flax_param_name,
    to_torch,
    unet_flax_from_state_dict,
    unet_state_dict_from_flax,
)
from opendwm_tpu_torch.models.layers import (
    Conv2d,
    Conv3d,
    GroupNorm,
    LayerNorm,
    Linear,
)
from opendwm_tpu_torch.pipelines import optim
from opendwm_tpu_torch.pipelines.ctsd import draw_training_randoms
from opendwm_tpu_torch.schedulers import DDPMScheduler

from torch_port_helpers import (
    jax_training_draws,
    random_flax_params,
    to_torch_tree,
)

REPO = Path(__file__).resolve().parents[1]
CONFIG = REPO / "configs/ctsd/multi_datasets/ctsd_21_tirda_nwao.json"
WARMUP = REPO / "configs/ctsd/multi_datasets/ctsd_21_tirda_nwao_warmup.json"
B, T, V, H, W, C = 2, 2, 2, 16, 16, 4
TEXT, CROSS = 5, 12
TINY = dict(
    in_channels=C, out_channels=C, block_out_channels=[8, 16, 16, 16],
    layers_per_block=1, transformer_layers_per_block=1,
    num_attention_heads=[2, 2, 2, 2], cross_attention_dim=CROSS,
    addition_time_embed_dim=8, projection_class_embeddings_input_dim=24,
    merge_factor=2.0, enable_rowwise_crossview=True,
    enable_rowwise_temporal=True, gradient_checkpointing=True,
)
QKV_BIAS = r".*\.to_[qkv]\.bias$"


def _pipeline_config(**model) -> dict:
    cfg = json.loads(CONFIG.read_text())["pipeline"]
    cfg["model"] = dict(TINY, _class_name=cfg["model"]["_class_name"],
                        **model)
    return cfg


def _batch(rng) -> dict:
    intr = np.tile(np.array([[20.0, 0, 32], [0, 20.0, 32], [0, 0, 1]]),
                   (B, T, V, 1, 1))
    transforms = np.tile(np.eye(4), (B, T, V, 1, 1))
    transforms[..., :3, :3] += 0.1 * rng.standard_normal((B, T, V, 3, 3))
    transforms[..., :3, 3] = rng.standard_normal((B, T, V, 3))
    batch = {
        "latents": rng.standard_normal((B, T, V, H, W, C)),
        "encoder_hidden_states": rng.standard_normal((B, T, V, TEXT, CROSS)),
        "camera_intrinsics": intr,
        "camera_transforms": transforms,
        "image_size": np.tile(np.array([64.0, 64.0]), (B, T, V, 1)),
        "fps": np.full((B,), 10.0),
    }
    return {k: v.astype(np.float32) for k, v in batch.items()}


def _zero_qkv_bias(tree):
    """The flax tree with the q/k/v biases zeroed, as a reference state
    dict converts (``convert_ctsd_unet``)."""
    out = {}
    for name, node in tree.items():
        if not isinstance(node, dict):
            out[name] = node
        elif name in ("to_q", "to_k", "to_v"):
            out[name] = dict(node, bias=np.zeros_like(node["bias"]))
        else:
            out[name] = _zero_qkv_bias(node)
    return out


def _flat_names(tree) -> list:
    """Dotted leaf names of a flax tree, as its ``freezing_pattern`` sees
    them."""
    return [".".join(str(getattr(k, "key", k)) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _is_qkv_bias(name: str) -> bool:
    return re.match(QKV_BIAS, name) is not None


def _rel_to_max(a, b, floor: float = 0.0) -> float:
    """max |a - b| over the largest |b| (or over ``floor``, if larger)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), floor, 1e-12))


def _recording(tx):
    """``tx`` behind a stage that passes the updates through and keeps
    them (the raw gradients) as its state, so that one compiled
    ``_train_step_impl`` also returns the gradients of its
    ``jax.value_and_grad``."""
    return optax.chain(optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates)), tx)


def _draws(key, batch, cfg):
    return jax_training_draws(
        key, batch["latents"].shape, cfg["training_config"],
        cfg["common_config"],
        num_train_timesteps=cfg["train_scheduler"]["num_train_timesteps"])


@pytest.fixture(scope="module")
def setup():
    cfg = _pipeline_config()
    jax_cfg = copy.deepcopy(cfg)
    jax_cfg["training_config"]["freezing_pattern"] = QKV_BIAS
    jax_pipe = jax_config.create_instance_from_config(jax_cfg)
    jax_pipe.tx = _recording(jax_pipe.tx)
    port_pipe = config.create_instance_from_config(copy.deepcopy(cfg))
    batch = _batch(np.random.default_rng(0))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    conds = jax_get_conditions(jbatch, cfg["common_config"])
    shapes = jax.eval_shape(
        jax_pipe.model.init, jax.random.PRNGKey(0),
        sample=jbatch["latents"], timestep=jnp.zeros((B, T, V)), **conds)
    params = _zero_qkv_bias(
        jax.tree.map(np.asarray, random_flax_params(shapes, 1)))
    port_pipe.model.load_state_dict(to_torch(
        unet_state_dict_from_flax(params)))
    return cfg, jax_pipe, params, port_pipe, batch


def _port_copy(port_pipe, **model_flags):
    """The port pipeline with a fresh model (same weights), optionally
    built with other flags."""
    pipe = copy.copy(port_pipe)
    model = config.create_instance_from_config(
        _pipeline_config(**model_flags)["model"])
    model.set_add_embedding_width(
        port_pipe.model.add_embedding.linear_1.in_features)
    model.load_state_dict(port_pipe.model.state_dict())
    pipe.model = model
    return pipe


_JITTED: dict = {}


def _jax_train_step(jax_pipe, params, batch, key):
    """``_train_step_impl`` of the JAX package, compiled once for the
    module: (new state, metrics, the gradients of its ``value_and_grad``)."""
    if "step" not in _JITTED:
        _JITTED["step"] = jax.jit(jax_pipe._train_step_impl)
    jparams = jax.tree.map(jnp.asarray, params)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                          opt_state=jax_pipe.tx.init(jparams["params"]))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    new_state, metrics = _JITTED["step"](state, jbatch, key)
    return new_state, metrics, new_state.opt_state[0]


# -- loss, gradients and one train step ----------------------------------------

@pytest.mark.parametrize("seed", [0, 5])
def test_unet_loss_and_gradients_match_jax(setup, seed):
    cfg, jax_pipe, params, port_pipe, batch = setup
    key = jax.random.PRNGKey(seed)
    _, ref_metrics, ref_grads = _jax_train_step(jax_pipe, params, batch, key)
    ref_loss = float(ref_metrics["sd_loss"])

    pipe = _port_copy(port_pipe)
    draws = _draws(key, batch, cfg)
    assert draws["time"].dtype in (torch.int32, torch.int64)
    loss, metrics = pipe.loss_from_draws(to_torch_tree(batch), draws)
    loss.backward()
    assert metrics["sd_loss"] is loss and ref_loss > 0
    assert abs(loss.item() - ref_loss) <= 1e-5 * ref_loss

    # the port's gradients on the flax tree (the reverse bridge puts zeros
    # at the q/k/v biases, which the reference UNet has not)
    back = unet_flax_from_state_dict(
        {n: p.grad for n, p in pipe.model.named_parameters()})["params"]
    got = dict(zip(_flat_names(back), jax.tree.leaves(back)))
    ref = dict(zip(_flat_names(ref_grads),
                   map(np.asarray, jax.tree.leaves(ref_grads))))
    assert got.keys() == ref.keys()
    biases = {n for n in ref if _is_qkv_bias(n)}
    assert max(np.abs(ref[n]).max() for n in biases) > 0
    assert not any(np.any(got[n]) for n in biases)
    floor = 1e-2 * max(np.abs(g).max() for g in ref.values())
    for name in sorted(ref.keys() - biases):
        assert _rel_to_max(got[name], ref[name], floor) <= 1e-3, name


def test_unet_train_step_matches_jax(setup):
    """One step of AdamW (lr 5e-5, wd 0.01) after clipping to 1.0, the
    config's optimizer; the JAX side freezes its q/k/v biases."""
    cfg, jax_pipe, params, port_pipe, batch = setup
    key = jax.random.PRNGKey(7)
    new_state, ref_metrics, ref_grads = _jax_train_step(jax_pipe, params,
                                                        batch, key)
    # the JAX metric counts the frozen biases' gradients; clipping does not
    trainable = [np.asarray(g) for name, g in zip(
        _flat_names(ref_grads), jax.tree.leaves(ref_grads))
        if not _is_qkv_bias(name)]
    grad_norm = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                                  for g in trainable)))
    assert float(ref_metrics["grad_norm"]) > grad_norm

    pipe = _port_copy(port_pipe)
    port_state = pipe.init_state()
    port_state, metrics = pipe.train_step(port_state, to_torch_tree(batch),
                                          draws=_draws(key, batch, cfg))
    assert port_state.step == 1
    assert abs(metrics["sd_loss"].item() - float(ref_metrics["sd_loss"])) \
        <= 1e-5 * float(ref_metrics["sd_loss"])
    assert abs(metrics["grad_norm"].item() - grad_norm) <= 1e-4 * grad_norm
    # the frozen biases stayed zero, so the JAX model is still a bias-free
    # UNet and converts back
    ref = unet_state_dict_from_flax(new_state.params)
    # (the frozen q/k/v biases' gradients, which the port has not, zeroed)
    grads = unet_state_dict_from_flax({"params": _zero_qkv_bias(
        jax.tree.map(np.asarray, ref_grads))})
    before = port_pipe.model.state_dict()
    lr = cfg["optimizer_config"]["lr"]
    top = max(np.abs(g).max() for g in grads.values())
    moved = certain = total = 0
    for name, p in pipe.model.named_parameters():
        # both packages stepped from the same fp32 values
        start = before[name].numpy()
        gap = np.abs(p.detach().numpy() - ref[name]) - \
            2 * np.spacing(np.abs(start))
        bar = 1e-3 * max(np.abs(grads[name]).max(), 1e-2 * top)
        sure = np.abs(grads[name]) > 10 * bar
        assert gap.max() <= 2.02 * lr, name
        if sure.any():
            assert gap[sure].max() <= 1e-2 * lr, name
        certain += int(sure.sum())
        total += sure.size
        moved += int(not torch.equal(p.detach(), before[name]))
    assert moved == len(ref)
    assert certain >= total / 2


def test_unet_remat_keeps_loss_and_gradients(setup):
    """``gradient_checkpointing`` (remat of every resnet and transformer
    model) changes memory, never values; a rematerialised module runs
    again in the backward."""
    cfg, _, _, port_pipe, batch = setup
    tbatch = to_torch_tree(batch)
    draws = draw_training_randoms(
        tbatch["latents"].shape, cfg["training_config"],
        cfg["common_config"], torch.Generator().manual_seed(11),
        scheduler=port_pipe.train_scheduler)
    results = []
    for remat in (False, True):
        pipe = _port_copy(port_pipe, gradient_checkpointing=remat)
        calls = []
        hook = pipe.model.mid_block.attentions[0].register_forward_pre_hook(
            lambda *_: calls.append(1))
        loss, _ = pipe.loss_from_draws(tbatch, draws)
        loss.backward()
        hook.remove()
        results.append((loss.item(), len(calls), {
            n: p.grad for n, p in pipe.model.named_parameters()}))
    (loss0, calls0, grads0), (loss1, calls1, grads1) = results
    assert (calls0, calls1) == (1, 2)
    assert abs(loss0 - loss1) <= 1e-6
    for name, g in grads1.items():
        assert (g - grads0[name]).abs().max().item() <= 1e-6, name


def test_unet_fp32_masters_under_bf16_compute(setup):
    """fp32 masters under bf16 compute, as the train slice runs: every
    Linear, Conv2d, Conv3d (the temporal resnets), LayerNorm and
    channel-last GroupNorm casts its input and parameters at use; the loss
    is within bf16 error of the fp32 model's on the same draws (the fp32
    model is the one held against JAX above), and every parameter gets a
    finite fp32 gradient."""
    cfg, _, _, port_pipe, batch = setup
    tbatch = to_torch_tree(batch)
    draws = draw_training_randoms(
        tbatch["latents"].shape, cfg["training_config"],
        cfg["common_config"], torch.Generator().manual_seed(3),
        scheduler=port_pipe.train_scheduler)
    with torch.no_grad():
        ref, _ = _port_copy(port_pipe).loss_from_draws(tbatch, draws)
    pipe = _port_copy(port_pipe, dtype=torch.bfloat16,
                      param_dtype=torch.float32)
    cast = [m for m in pipe.model.modules()
            if isinstance(m, (Linear, Conv2d, Conv3d, LayerNorm, GroupNorm))]
    assert {type(m) for m in cast} == {Linear, Conv2d, Conv3d, LayerNorm,
                                       GroupNorm}
    assert all(m.compute_dtype == torch.bfloat16 for m in cast)
    loss, _ = pipe.loss_from_draws(tbatch, draws)
    loss.backward()
    # bf16 keeps 8 bits of mantissa; measured 1.7e-4 here, bar 3e-2 as
    # the DiT's forward
    assert abs(loss.item() - ref.item()) <= 3e-2 * ref.item()
    for name, p in pipe.model.named_parameters():
        assert p.dtype == torch.float32, name
        assert p.grad is not None and p.grad.dtype == torch.float32, name
        assert torch.isfinite(p.grad).all(), name


# -- draws, the weight bridge and freezing -------------------------------------

def test_ddpm_training_draws():
    """Integer timesteps uniform on [0, 1000), per sample (per frame under
    diffusion forcing), from the generator: the distribution of the JAX
    package's ``jax.random.randint``."""
    sched = DDPMScheduler(prediction_type="v_prediction")
    shape = (4096, 3, 2, 2, 2, 4)
    for style, t_shape in ((None, (4096,)), ("diffusion_forcing",
                                             (4096, 3))):
        draws = draw_training_randoms(
            shape, {}, {"frame_prediction_style": style},
            torch.Generator().manual_seed(0), scheduler=sched)
        time = draws["time"]
        assert time.shape == t_shape and time.dtype == torch.int64
        assert 0 <= time.min() and time.max() < 1000
        assert abs(time.float().mean().item() - 499.5) < 15
    again = draw_training_randoms(shape, {}, {},
                                  torch.Generator().manual_seed(0),
                                  scheduler=sched)
    first = draw_training_randoms(shape, {}, {},
                                  torch.Generator().manual_seed(0),
                                  scheduler=sched)
    assert torch.equal(again["time"], first["time"])


def test_unet_flax_bridge_round_trip(setup):
    """port state dict → flax tree → port state dict is the identity, the
    flax tree has the JAX model's structure (zero q/k/v biases put back),
    and ``flax_param_name`` names every port parameter as it appears there."""
    _, _, params, port_pipe, _ = setup
    sd = port_pipe.model.state_dict()
    tree = unet_flax_from_state_dict(sd)
    assert jax.tree.structure(tree["params"]) == \
        jax.tree.structure(params["params"])
    # (the drawn params are fp64 numpy; the port holds them as fp32)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        a, np.asarray(b, np.float32)), tree["params"], params["params"])
    back = unet_state_dict_from_flax(tree)
    assert back.keys() == sd.keys()
    for name, value in sd.items():
        np.testing.assert_array_equal(back[name], value.numpy(), name)
    names = set(_flat_names(params["params"]))
    for name, p in port_pipe.model.named_parameters():
        assert flax_param_name(name, p.ndim) in names, name


def test_warmup_freezing_pattern_matches_jax(setup):
    """The warmup config's ``freezing_pattern`` (flax names) freezes the
    same parameters in both packages: the JAX optimizer gives them zero
    updates, the port leaves them out of its optimizer."""
    _, _, params, port_pipe, _ = setup
    pattern = json.loads(WARMUP.read_text())["pipeline"]["training_config"][
        "freezing_pattern"]
    jtx = jax_optim.build_optimizer({"lr": 1e-2},
                                    {"freezing_pattern": pattern})
    jparams = jax.tree.map(jnp.asarray, params["params"])
    ones = jax.tree.map(jnp.ones_like, jparams)
    updates, _ = jtx.update(ones, jtx.init(jparams), jparams)
    frozen_jax = {name for name, u in zip(_flat_names(updates),
                                          jax.tree.leaves(updates))
                  if not np.any(np.asarray(u))}
    trainable, frozen = optim.split_trainable(port_pipe.model, pattern)
    names = {id(p): flax_param_name(n, p.ndim)
             for n, p in port_pipe.model.named_parameters()}
    frozen_port = {names[id(p)] for p in frozen}
    biases = {n for n in frozen_jax if _is_qkv_bias(n)}
    assert frozen_port == frozen_jax - biases
    # the warmup stage trains the down/upsamplers and the output norm only
    assert sorted({names[id(p)].split(".")[1 if "_blocks_" in
                                           names[id(p)] else 0]
                   for p in trainable}) == ["conv_norm_out", "downsample",
                                            "upsample"]
    assert frozen


# -- the train CLI -------------------------------------------------------------

def _cli_config(tmp_path) -> Path:
    config_dict = json.loads(CONFIG.read_text())
    pipe = config_dict["pipeline"]
    pipe["model"] = dict(TINY, _class_name=pipe["model"]["_class_name"])
    # the synthetic items carry no cameras: no numeric ids
    pipe["common_config"].pop("added_time_ids")
    pipe["training_config"]["reference_latent_count"] = 1
    item = dict(_class_name="SyntheticCTSDDataset", size=8,
                sequence_length=T, view_count=V, latent_height=8,
                latent_width=8, latent_channels=C, text_length=TEXT,
                text_dim=CROSS, with_layout=False)
    config_dict["training_dataset"] = item
    config_dict["training_collate_fn"] = {"_class_name": "CollateFnIgnoring"}
    config_dict["batch_size"] = 1
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(config_dict))
    return path


def test_unet_train_cli_runs_checkpoints_and_resumes(tmp_path):
    cfg, out = _cli_config(tmp_path), tmp_path / "out"
    argv = ["-c", str(cfg), "-o", str(out), "--device", "cpu",
            "--max-steps", "2", "--log-steps", "1",
            "--checkpointing-steps", "1"]
    train.main(train.create_parser().parse_args(argv))
    assert checkpoint.latest_step(str(out)) == 2
    final = torch.load(out / "checkpoints" / "2" / "state.pt",
                       weights_only=True)
    train.main(train.create_parser().parse_args(argv + ["--resume-from",
                                                        "1"]))
    resumed = torch.load(out / "checkpoints" / "2" / "state.pt",
                         weights_only=True)
    assert resumed["step"] == 2
    for name, value in final["model"].items():
        assert torch.equal(resumed["model"][name], value), name
    events = [json.loads(line)
              for line in (out / "log" / "events.jsonl").read_text()
              .splitlines()]
    assert [e["step"] for e in events] == [1, 2, 2]
    assert events[1]["sd_loss"] == events[2]["sd_loss"]
    assert all(np.isfinite(e["sd_loss"]) and e["grad_norm"] > 0
               for e in events)
