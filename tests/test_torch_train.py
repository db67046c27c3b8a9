"""The port's training step vs the JAX package's, on the CPU in fp32.

Both pipelines are built by their own config runtimes from one config (the
synthetic CTSD-3.5 config cut to 3 layers, with implicit perspective,
camera ids and the flagship's training options), share weights through
the weight bridge, and take the same random draws: the port's draws are
rebuilt from the JAX ``PRNGKey`` in the split order of
``opendwm_tpu/pipelines/ctsd.py`` (``loss_fn``, ``make_input_for_prediction``).
Latents of 16 x 24 and 40 text tokens make the joint attention 136 tokens
long, so the port's attention goes through its autograd Function (plain
forward and backward on the CPU).

Tolerances: the loss to 1e-5 relative; each parameter's gradient to 1e-3
of its largest entry (the DiT bar of ``test_dit_converter_parity.py``);
one AdamW step's parameters and gradient norm to 1e-4; schedules and
optimizer updates on given gradients to float rounding (1e-6); remat
on or off to 1e-6 (it changes memory, never values); a resumed run
exactly.
"""

import copy
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opendwm_tpu.config as jax_config
from opendwm_tpu.models.mmdit import DiTCrossviewTemporal as JaxDiT
from opendwm_tpu.pipelines import optim as jax_optim
from opendwm_tpu.pipelines.ctsd import TrainState as JaxTrainState
from opendwm_tpu.pipelines.ctsd import get_conditions as jax_get_conditions
from opendwm_tpu.pipelines.ctsd import (
    make_input_for_prediction as jax_make_input_for_prediction,
)
from opendwm_tpu_torch import checkpoint, config, train
from opendwm_tpu_torch.convert import (
    dit_flax_from_state_dict,
    dit_state_dict_from_flax,
    to_torch,
)
from opendwm_tpu_torch.models.mmdit import DiTCrossviewTemporal
from opendwm_tpu_torch.pipelines import optim
from opendwm_tpu_torch.pipelines.ctsd import (
    draw_training_randoms,
    make_input_for_prediction,
)

from torch_port_helpers import (
    jax_prediction_draws,
    jax_training_draws,
    random_flax_params,
    to_torch_tree,
)

REPO = Path(__file__).resolve().parents[1]
SYNTHETIC = REPO / "configs/ctsd/ctsd_35_6views_video_synthetic.json"
B, T, V, H, W, C = 2, 2, 2, 16, 24, 16
L, JOINT, POOLED = 40, 24, 16
LAYERS = 3
COMMON = {
    "frame_prediction_style": "ctsd",
    "added_time_ids": "fps_camera_transforms",
    "camera_intrinsic_embedding_indices": [0, 4, 2, 5],
    "camera_intrinsic_denom_embedding_indices": [0, 1, 0, 1],
    "camera_transform_embedding_indices": [3, 7, 11],
}
# configs/ctsd/multi_datasets/ctsd_35_tirda_nwao.json's training options,
# plus the reference-frame scale/offset noise of the diffusion-forcing
# configs.
TRAINING = {
    "text_prompt_condition_ratio": 0.8,
    "generation_task_ratio": 0.25,
    "image_generation_ratio": 0.15,
    "all_reference_visible_ratio": 0.5,
    "reference_visible_rate": 0.95,
    "reference_latent_count": {"1": 0.5, "3": 0.5},
    "reference_frame_scale_std": 0.1,
    "reference_frame_offset_std": 0.05,
    "disable_reference_frame_loss": True,
    "max_norm_for_grad_clip": 1.0,
    "weighting_scheme": "logit_normal",
}
MODEL_CUT = dict(num_layers=LAYERS, dual_attention_layers=[0],
                 crossview_block_layers=[1], temporal_block_layers=[2],
                 perspective_modeling_type="implicit",
                 projection_class_embeddings_input_dim=2816)


def _pipeline_config() -> dict:
    cfg = json.loads(SYNTHETIC.read_text())["pipeline"]
    cfg["model"].update(MODEL_CUT)
    cfg["common_config"] = dict(COMMON)
    cfg["training_config"] = dict(TRAINING)
    return cfg


def _batch(rng, latent_hw=(H, W), text_tokens=L) -> dict:
    intr = np.tile(np.array([[20.0, 0, 32], [0, 20.0, 32], [0, 0, 1]]),
                   (B, T, V, 1, 1))
    transforms = np.tile(np.eye(4), (B, T, V, 1, 1))
    transforms[..., :3, 3] = rng.standard_normal((B, T, V, 3))
    batch = {
        "latents": rng.standard_normal((B, T, V, *latent_hw, C)),
        "encoder_hidden_states": rng.standard_normal(
            (B, T, V, text_tokens, JOINT)),
        "pooled_projections": rng.standard_normal((B, T, V, POOLED)),
        "camera_intrinsics": intr,
        "camera_transforms": transforms,
        "image_size": np.tile(np.array([64.0, 64.0]), (B, T, V, 1)),
        "fps": np.full((B,), 10.0),
    }
    return {k: v.astype(np.float32) for k, v in batch.items()}


def _rel_to_max(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


@pytest.fixture(scope="module")
def setup():
    cfg = _pipeline_config()
    jax_pipe = jax_config.create_instance_from_config(copy.deepcopy(cfg))
    port_pipe = config.create_instance_from_config(copy.deepcopy(cfg))
    batch = _batch(np.random.default_rng(0))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    conds = jax_get_conditions(jbatch, COMMON)
    shapes = jax.eval_shape(
        jax_pipe.model.init, jax.random.PRNGKey(0),
        sample=jbatch["latents"], timestep=jnp.zeros((B, T, V)), **conds)
    params = random_flax_params(shapes, 1)
    port_pipe.model.load_state_dict(to_torch(
        dit_state_dict_from_flax(params, LAYERS)))
    return jax_pipe, params, port_pipe, batch


def _port_copy(port_pipe, **model_flags):
    """The port pipeline with a fresh model (same weights), optionally
    built with other flags."""
    pipe = copy.copy(port_pipe)
    cfg = {k: v for k, v in _pipeline_config()["model"].items()
           if k != "_class_name"}
    model = DiTCrossviewTemporal(**cfg, **model_flags)
    model.set_view_embedding_width(
        port_pipe.model.view_embedding.linear_1.in_features)
    model.load_state_dict(port_pipe.model.state_dict())
    pipe.model = model
    return pipe


# -- make_input_for_prediction -----------------------------------------------

PREDICTION_STYLES = {
    "passthrough": (None, 0),
    "diffusion_forcing": ("diffusion_forcing", 0),
    "ctsd": ("ctsd", 1),
    "ctsd_count_dict": ("ctsd", {"1": 0.3, "2": 0.5, "3": 0.2}),
}


@pytest.mark.parametrize("case", PREDICTION_STYLES)
def test_make_input_for_prediction_matches_jax(case):
    style, count = PREDICTION_STYLES[case]
    tc = {"reference_frame_scale_std": 0.1, "reference_frame_offset_std": 0.05,
          "image_generation_ratio": 0.5, "generation_task_ratio": 0.4,
          "all_reference_visible_ratio": 0.5, "reference_visible_rate": 0.7}
    cc = {"frame_prediction_style": style}
    rng = np.random.default_rng(5)
    shape = (6, 3, 2, 4, 4, 16)
    noisy, latents = (rng.standard_normal(shape).astype(np.float32)
                      for _ in range(2))
    ts = rng.uniform(0, 1000, shape[:3]).astype(np.float32)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        ref = jax_make_input_for_prediction(
            key, jnp.asarray(noisy), jnp.asarray(latents), jnp.asarray(ts),
            tc, cc, count)
        out = make_input_for_prediction(
            jax_prediction_draws(key, shape, style), torch.from_numpy(noisy),
            torch.from_numpy(latents), torch.from_numpy(ts), tc, cc, count)
        np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]),
                                   atol=1e-6)
        np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))
        assert out[2].keys() == ref[2].keys()
        for k in ref[2]:
            np.testing.assert_array_equal(out[2][k].numpy(),
                                          np.asarray(ref[2][k]))
        np.testing.assert_array_equal(out[3].numpy(), np.asarray(ref[3]))


# -- loss, gradients and one train step ----------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_loss_and_gradients_match_jax(setup, seed):
    jax_pipe, params, port_pipe, batch = setup
    key = jax.random.PRNGKey(seed)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (ref_loss, _), ref_grads = jax.jit(
        jax.value_and_grad(jax_pipe.loss_fn, has_aux=True))(
            params["params"], jbatch, key)

    pipe = _port_copy(port_pipe)
    draws = jax_training_draws(key, batch["latents"].shape, TRAINING, COMMON)
    loss, metrics = pipe.loss_from_draws(to_torch_tree(batch), draws)
    loss.backward()
    assert metrics["sd_loss"] is loss
    assert abs(loss.item() - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))

    ref = dit_state_dict_from_flax(ref_grads, LAYERS)
    grads = {n: p.grad for n, p in pipe.model.named_parameters()}
    assert grads.keys() == ref.keys()
    for name, g in grads.items():
        assert _rel_to_max(g.numpy(), ref[name]) <= 1e-3, name
    # the reverse bridge maps the port's gradients onto the flax tree
    back = dit_flax_from_state_dict(grads)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, b, atol=1e-3 * max(np.abs(b).max(), 1e-12)), back["params"],
        jax.tree.map(np.asarray, ref_grads))


def test_train_step_matches_jax(setup):
    """One step of AdamW (lr 1e-4, wd 0.01) after clipping to 1.0."""
    jax_pipe, params, port_pipe, batch = setup
    key = jax.random.PRNGKey(7)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          opt_state=jax_pipe.tx.init(params["params"]))
    new_state, ref_metrics = jax.jit(jax_pipe._train_step_impl)(
        state, jbatch, key)

    pipe = _port_copy(port_pipe, param_dtype=torch.float32)
    port_state = pipe.init_state()
    port_state, metrics = pipe.train_step(
        port_state, to_torch_tree(batch),
        draws=jax_training_draws(key, batch["latents"].shape, TRAINING,
                                  COMMON))
    assert port_state.step == 1
    grad_norm = float(ref_metrics["grad_norm"])
    assert abs(metrics["grad_norm"].item() - grad_norm) <= 1e-4 * grad_norm
    ref = dit_state_dict_from_flax(new_state.params, LAYERS)
    before = port_pipe.model.state_dict()
    moved = 0
    for name, p in pipe.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name], atol=1e-4,
                                   err_msg=name)
        moved += int(not torch.equal(p.detach(), before[name]))
    assert moved == len(ref)


# -- schedules and the optimizer chain ----------------------------------------

SCHEDULES = {
    "cosine": {"_class_name": "torch.optim.lr_scheduler.CosineAnnealingLR",
               "T_max": 4, "eta_min": 1e-5},
    "exponential": {"_class_name": "torch.optim.lr_scheduler.ExponentialLR",
                    "gamma": 0.8},
    "linear": {"_class_name": "torch.optim.lr_scheduler.LinearLR",
               "start_factor": 0.25, "end_factor": 1.0, "total_iters": 3},
    "warmup_cosine": {"type": "warmup_cosine", "init_lr": 1e-5,
                      "warmup_steps": 2, "decay_steps": 5, "end_lr": 2e-5},
}


@pytest.mark.parametrize("name", SCHEDULES)
def test_lr_schedules_match_optax(name):
    spec = SCHEDULES[name]
    ref = jax_optim.build_schedule(spec, 1e-3)
    schedule = optim.build_schedule(spec, 1e-3)
    p = torch.nn.Parameter(torch.zeros(3))
    opt, lr_scheduler = optim.build_optimizer([p], {"lr": 1e-3,
                                                    "lr_scheduler": spec})
    # optax evaluates in fp32: 1e-6 of the base lr absorbs its rounding
    for count in range(6):
        want = float(ref(count))
        assert schedule(count) == pytest.approx(want, rel=1e-6, abs=1e-9)
        # the optimizer's update at this count uses the same lr
        assert opt.param_groups[0]["lr"] == pytest.approx(want, rel=1e-6,
                                                          abs=1e-9)
        p.grad = torch.ones(3)
        opt.step()
        lr_scheduler.step()


def test_config_runtime_resolves_schedule_names():
    spec = config.create_instance_from_config(SCHEDULES["cosine"])
    assert spec == {"type": "cosine", "T_max": 4, "eta_min": 1e-5}


class _Toy(torch.nn.Module):
    """Parameters named as the flax tree {"frozen": {"kernel"},
    "body": {"kernel", "bias"}} is (``convert.flax_param_name``)."""

    def __init__(self, arrays: dict):
        super().__init__()
        self.frozen = torch.nn.Module()
        self.body = torch.nn.Module()
        self.frozen.weight = torch.nn.Parameter(
            torch.tensor(arrays["frozen"]["kernel"]))
        self.body.weight = torch.nn.Parameter(
            torch.tensor(arrays["body"]["kernel"]))
        self.body.bias = torch.nn.Parameter(
            torch.tensor(arrays["body"]["bias"]))


@pytest.mark.parametrize("accumulation", [1, 3])
def test_freezing_clip_and_accumulation_match_optax(accumulation):
    """``freezing_pattern`` (``optax.multi_transform`` + ``set_to_zero``),
    clipping over the trainable leaves only, and
    ``gradient_accumulation_steps`` (``optax.MultiSteps``)."""
    tc = {"freezing_pattern": "^frozen", "max_norm_for_grad_clip": 0.5,
          "gradient_accumulation_steps": accumulation}
    oc = {"lr": 1e-2, "weight_decay": 0.1}
    rng = np.random.default_rng(accumulation)

    def tree():
        return {"frozen": {"kernel": rng.standard_normal((3, 4))},
                "body": {"kernel": rng.standard_normal((4, 5)),
                         "bias": rng.standard_normal(5)}}

    init = jax.tree.map(lambda a: a.astype(np.float32), tree())
    tx = jax_optim.build_optimizer(oc, tc)
    jparams = jax.tree.map(jnp.asarray, init)
    opt_state = tx.init(jparams)

    toy = _Toy(init)
    trainable, frozen = optim.split_trainable(toy, tc["freezing_pattern"])
    assert frozen == [toy.frozen.weight]
    opt, lr_scheduler = optim.build_optimizer(trainable, oc)
    acc = optim.GradientAccumulator(accumulation) if accumulation > 1 \
        else None
    for step in range(2 * accumulation):
        grads = jax.tree.map(lambda a: 3 * a.astype(np.float32), tree())
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, grads),
                                       opt_state, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, updates)
        toy.frozen.weight.grad = torch.tensor(grads["frozen"]["kernel"])
        toy.body.weight.grad = torch.tensor(grads["body"]["kernel"])
        toy.body.bias.grad = torch.tensor(grads["body"]["bias"])
        updated = optim.apply_gradients(opt, lr_scheduler, acc, 0.5)
        assert updated == ((step + 1) % accumulation == 0)
        toy.zero_grad(set_to_none=True)
        for p, ref in ((toy.frozen.weight, jparams["frozen"]["kernel"]),
                       (toy.body.weight, jparams["body"]["kernel"]),
                       (toy.body.bias, jparams["body"]["bias"])):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(ref),
                                       rtol=1e-6, atol=1e-6)
    assert torch.equal(toy.frozen.weight.detach(),
                       torch.tensor(init["frozen"]["kernel"]))
    assert toy.frozen.weight not in opt.state


def test_other_moment_dtypes_are_not_ported():
    """Moment dtypes as the JAX package keeps them: without ``flat`` it
    hands ``optax.adamw`` no ``mu_dtype`` (the parameters' dtype), with it
    ``flat_adamw`` stores ``mu_dtype`` (``FlatAdamW`` unless fp32)."""
    p = torch.nn.Parameter(torch.zeros(2))
    for oc in ({"mu_dtype": "bfloat16"}, {"flat": True},
               {"flat": True, "mu_dtype": "float32"}):
        opt, _ = optim.build_optimizer([p], oc)
        assert type(opt) is torch.optim.AdamW, oc
    for name in ("bfloat16", "jnp.bfloat16", torch.bfloat16):
        opt, _ = optim.build_optimizer([p], {"flat": True, "mu_dtype": name})
        assert isinstance(opt, optim.FlatAdamW)
        assert opt.mu_dtype == torch.bfloat16


# -- remat ----------------------------------------------------------------------

REMAT = {
    "all_blocks": dict(gradient_checkpointing=True),
    "listed_blocks": dict(gradient_checkpointing=True,
                          remat_block_layers=[0, 2]),
    "branches": dict(crossview_gradient_checkpointing=True,
                     temporal_gradient_checkpointing=True),
    "dots": dict(gradient_checkpointing=True,
                 crossview_gradient_checkpointing=True,
                 temporal_gradient_checkpointing=True, remat_policy="dots"),
    "dots_no_batch": dict(gradient_checkpointing=True,
                          remat_policy="dots_no_batch"),
}


def _loss_grads_and_calls(pipe, batch, draws):
    calls = [0] * LAYERS
    hooks = [block.register_forward_pre_hook(
        lambda *_, i=i: calls.__setitem__(i, calls[i] + 1))
        for i, block in enumerate(pipe.model.transformer_blocks)]
    loss, _ = pipe.loss_from_draws(batch, draws)
    loss.backward()
    for h in hooks:
        h.remove()
    grads = {n: p.grad for n, p in pipe.model.named_parameters()}
    return loss, grads, calls


@pytest.mark.parametrize("variant", REMAT)
def test_remat_keeps_loss_and_gradients(setup, variant):
    _, _, port_pipe, batch = setup
    flags = REMAT[variant]
    tbatch = to_torch_tree(batch)
    draws = draw_training_randoms(tbatch["latents"].shape, TRAINING, COMMON,
                                  torch.Generator().manual_seed(11))
    ref_loss, ref_grads, ref_calls = _loss_grads_and_calls(
        _port_copy(port_pipe), tbatch, draws)
    loss, grads, calls = _loss_grads_and_calls(
        _port_copy(port_pipe, **flags), tbatch, draws)
    assert ref_calls == [1] * LAYERS
    remat = flags.get("gradient_checkpointing", False)
    listed = flags.get("remat_block_layers")
    # a rematerialised block runs again in the backward
    assert calls == [2 if remat and (listed is None or i in listed) else 1
                     for i in range(LAYERS)]
    assert abs(loss.item() - ref_loss.item()) <= 1e-6
    for name, g in grads.items():
        assert (g - ref_grads[name]).abs().max().item() <= 1e-6, name


def test_unknown_remat_policy_raises():
    cfg = {k: v for k, v in _pipeline_config()["model"].items()
           if k != "_class_name"}
    with pytest.raises(ValueError, match="remat_policy"):
        DiTCrossviewTemporal(**cfg, remat_policy="everything")


# -- mixed precision and the weight bridge -------------------------------------

def test_fp32_masters_under_bf16_compute(setup):
    """fp32 flax params load exactly into a ``param_dtype=float32`` model
    that computes in bf16; its forward stays within bf16 error of the JAX
    model at ``dtype=bfloat16`` (flax params fp32 too), and the reverse
    bridge gives the flax tree back bit for bit."""
    _, params, port_pipe, batch = setup
    cfg = {k: v for k, v in _pipeline_config()["model"].items()
           if k != "_class_name"}
    model = DiTCrossviewTemporal(**cfg, dtype=torch.bfloat16,
                                 param_dtype=torch.float32)
    width = port_pipe.model.view_embedding.linear_1.in_features
    model.set_view_embedding_width(width)
    sd = dit_state_dict_from_flax(params, LAYERS)
    model.load_state_dict(to_torch(sd))
    # (the drawn params are fp64 numpy; the masters hold them as fp32)
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32
        assert np.array_equal(p.detach().numpy(),
                              sd[name].astype(np.float32)), name
    back = dit_flax_from_state_dict(model.state_dict())
    jax.tree.map(np.testing.assert_array_equal, back["params"],
                 jax.tree.map(lambda a: np.asarray(a, np.float32),
                              params["params"]))

    jbatch ={k: jnp.asarray(v) for k, v in batch.items()}
    conds = jax_get_conditions(jbatch, COMMON)
    timestep = np.full((B, T, V), 500.0, np.float32)
    jax_model = JaxDiT(**cfg, dtype=jnp.bfloat16)
    ref = np.asarray(jax.jit(jax_model.apply)(
        params, sample=jbatch["latents"], timestep=jnp.asarray(timestep),
        **conds).astype(jnp.float32))
    with torch.no_grad():
        out = model(sample=torch.from_numpy(batch["latents"]),
                    timestep=torch.from_numpy(timestep),
                    **{k: torch.from_numpy(np.array(v))
                       for k, v in conds.items()})
    assert out.dtype == torch.bfloat16
    # bf16 keeps 8 bits and the two packages round at other points (the
    # port's residual AdaLN normalises the fp32 sum, flax rounds each
    # sublayer's output): 1.4e-2 measured here, bar 3e-2.
    rel = np.linalg.norm(out.float().numpy() - ref) / np.linalg.norm(ref)
    assert rel <= 3e-2


# -- checkpoint ------------------------------------------------------------------

def _tiny_pipeline(**training):
    cfg = _pipeline_config()
    cfg["training_config"].update(training)
    torch.manual_seed(0)
    cfg["model"]["param_dtype"] = torch.float32
    return config.create_instance_from_config(cfg)


@pytest.mark.parametrize("accumulation,save_at", [(None, 2), (2, 1)])
def test_checkpoint_resume_matches_uninterrupted(tmp_path, accumulation,
                                                 save_at):
    rng = np.random.default_rng(2)
    batches = [to_torch_tree(_batch(rng, (8, 8), 4)) for _ in range(3)]
    pipe = _tiny_pipeline(gradient_accumulation_steps=accumulation)
    state = pipe.init_state()
    gen = torch.Generator().manual_seed(5)
    for b in batches:
        pipe.train_step(state, b, gen)
        if state.step == save_at:
            checkpoint.save_checkpoint(str(tmp_path), save_at, state, gen)

    resumed = _tiny_pipeline(gradient_accumulation_steps=accumulation)
    rstate = resumed.init_state()
    rgen = torch.Generator().manual_seed(123)
    checkpoint.load_checkpoint(str(tmp_path), save_at, rstate, rgen)
    assert rstate.step == save_at
    for b in batches[save_at:]:
        resumed.train_step(rstate, b, rgen)
    assert checkpoint.latest_step(str(tmp_path)) == save_at
    for (name, a), b in zip(resumed.model.named_parameters(),
                            pipe.model.parameters()):
        assert torch.equal(a, b), name


def test_model_only_round_trip(tmp_path):
    pipe = _tiny_pipeline()
    path = tmp_path / "weights" / "model.pt"
    checkpoint.save_model_only(str(path), pipe.model)
    other = _tiny_pipeline()
    with torch.no_grad():
        for p in other.model.parameters():
            p.zero_()
    checkpoint.load_model_only(str(path), other.model)
    for a, b in zip(other.model.parameters(), pipe.model.parameters()):
        assert torch.equal(a, b)
    assert checkpoint.load_model_only(str(path)).keys() == \
        pipe.model.state_dict().keys()


def test_init_state_needs_fp32_masters():
    cfg = _pipeline_config()
    cfg["model"]["dtype"] = torch.bfloat16
    pipe = config.create_instance_from_config(cfg)
    with pytest.raises(ValueError, match="param_dtype"):
        pipe.init_state()
    with pytest.raises(NotImplementedError, match="item 13"):
        pipe.shard_state(None)


# -- the train CLI -----------------------------------------------------------------

def _cli_config(tmp_path) -> Path:
    config_dict = json.loads(SYNTHETIC.read_text())
    model = config_dict["pipeline"]["model"]
    # cut as tests/test_train_cli.py cuts it
    model.update(num_layers=2, dual_attention_layers=[0],
                 crossview_block_layers=[0], temporal_block_layers=[1])
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(config_dict))
    return path


def test_train_cli_runs_checkpoints_and_resumes(tmp_path, capsys):
    cfg, out = _cli_config(tmp_path), tmp_path / "out"
    argv = ["-c", str(cfg), "-o", str(out), "--device", "cpu",
            "--max-steps", "3", "--log-steps", "1",
            "--checkpointing-steps", "2"]
    train.main(train.create_parser().parse_args(argv))
    assert "ignoring JAX-only config key jax_platform" in \
        capsys.readouterr().out
    assert checkpoint.latest_step(str(out)) == 3
    assert (out / "checkpoints" / "2" / "state.pt").exists()
    final = torch.load(out / "checkpoints" / "3" / "state.pt",
                       weights_only=True)

    train.main(train.create_parser().parse_args(argv + ["--resume-from",
                                                        "2"]))
    resumed = torch.load(out / "checkpoints" / "3" / "state.pt",
                         weights_only=True)
    assert resumed["step"] == 3
    for name, value in final["model"].items():
        assert torch.equal(resumed["model"][name], value), name
    events = [json.loads(line)
              for line in (out / "log" / "events.jsonl").read_text()
              .splitlines()]
    assert [e["step"] for e in events] == [1, 2, 3, 3]
    assert events[2]["sd_loss"] == events[3]["sd_loss"]
    assert all(np.isfinite(e["sd_loss"]) and e["grad_norm"] > 0
               for e in events)


@pytest.mark.parametrize("extra,error", [
    (["--evaluation-steps", "1"], None),
    (["--preview-steps", "1"], ValueError),
    (["--profile-steps", "0:1"], None),
])
def test_train_cli_refuses_unported_flags(tmp_path, extra, error):
    """The three flags are ported (with ``vae_checkpoint_path`` in
    test_torch_eval_cli.py): a step's evaluation logs the config's metric
    and a profiled step writes its trace. The preview refuses the
    synthetic config as the JAX CLI does: without a VAE its 8 x 8 latents
    cannot stand in one grid beside its 64 x 64 box rasters
    (``np.concatenate`` raises in both packages)."""
    out = tmp_path / "o"
    cfg = _cli_config(tmp_path)
    cfg.write_text(json.dumps(dict(json.loads(cfg.read_text()),
                                   evaluation_batches=1)))
    argv = ["-c", str(cfg), "-o", str(out),
            "--device", "cpu", "--max-steps", "1", "--log-steps", "1"] + extra
    if error is not None:
        with pytest.raises(error, match="concatenat"):
            train.main(train.create_parser().parse_args(argv))
        return
    train.main(train.create_parser().parse_args(argv))
    events = [json.loads(line) for line in
              (out / "log" / "events.jsonl").read_text().splitlines()]
    if extra[0] == "--evaluation-steps":
        assert [e["step"] for e in events if "evaluation/fid_proxy" in e] \
            == [1]
        assert all(np.isfinite(e.get("evaluation/fid_proxy", 0.0))
                   for e in events)
    else:
        assert [e["step"] for e in events if "profile_written" in e] == [1]
        traces = list((out / "profile").glob("*.json"))
        assert len(traces) == 1 and traces[0].stat().st_size > 0


def test_train_cli_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    argv = ["-c", str(_cli_config(tmp_path)), "-o", str(tmp_path / "o"),
            "--device", "cuda"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(train.create_parser().parse_args(argv))
