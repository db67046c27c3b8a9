"""The port's sharded training step against the JAX package's on a virtual
mesh of the same shape, on the CPU in fp32.

A tiny CTSD-3.5 (the synthetic config cut to 2 layers, as
``test_torch_train.py`` cuts it to 3) takes one step under ``fsdp`` (world 2),
``ddp`` (world 2) and ``hsdp`` (world 4, 2 x 2), and two with
``max_norm_for_grad_clip`` and with ``{"flat": true}`` bf16 moments under
``fsdp`` (AdamW's first step moves each parameter by about lr sign(g),
whatever the gradient's scale; the second shows the clip's and the
moments' values), in spawned gloo ranks (``torch_dist_workers``: no JAX in
them), each rank on its slice of the batch and of the JAX draws. JAX's
steps run on the 8-device virtual CPU mesh with the same mesh shape and
policy. The losses within 1e-5 relative; every parameter within 1e-4,
and the updates (the values after the steps less the start) within 2e-3
of JAX's in relative norm over the whole model, and 0.1 a tensor
(``_check_update``). Steps that draw from a generator at world 2 equal
the one-process steps on the whole batch, and so does the train CLI under
``torchrun``'s environment at world 2. A DiT with ``sequence_parallel_axis`` trains at
tp = 2 (its joint attentions ringed over the two ranks) as in one process.
A checkpoint saved at world 2 loads in one process and one saved in one
process loads at world 2, and the next step is the same. MaskGIT takes
its mesh (DDP, world 2) and equals its one-process step.
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opendwm_tpu.config as jax_config
from opendwm_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from opendwm_tpu.parallel.mesh import make_mesh as jax_make_mesh
from opendwm_tpu.parallel.sharding import shard_batch as jax_shard_batch
from opendwm_tpu.pipelines.ctsd import TrainState as JaxTrainState
from opendwm_tpu.pipelines.ctsd import get_conditions as jax_get_conditions
from opendwm_tpu_torch import checkpoint, train
from opendwm_tpu_torch.convert import dit_state_dict_from_flax, to_torch

import torch_dist_workers as workers
from test_torch_train import COMMON, TRAINING
from test_torch_train import _cli_config
from test_torch_train import _pipeline_config as _train_config
from torch_port_helpers import (
    jax_training_draws,
    random_flax_params,
    to_torch_tree,
)

# test_torch_train.py's cut at 2 layers: the dual attention, a cross-view
# and a temporal branch on layer 1
LAYERS = 2
B, T, V, H, W, C = 4, 2, 2, 16, 24, 16
L, JOINT, POOLED = 40, 24, 16
NO_CLIP = {k: v for k, v in TRAINING.items()
           if k != "max_norm_for_grad_clip"}
# (world, (dp, fsdp), policy, training_config, optimizer_config update,
# steps)
CASES = {
    "fsdp": (2, (1, 2), "fsdp", NO_CLIP, {}, 1),
    "ddp": (2, (2, 1), "ddp", NO_CLIP, {}, 1),
    "hsdp": (4, (2, 2), "hsdp", NO_CLIP, {}, 1),
    "clip": (2, (1, 2), "fsdp", {**NO_CLIP, "max_norm_for_grad_clip": 1e-3},
             {}, 2),
    "flat": (2, (1, 2), "fsdp", NO_CLIP, {"flat": True,
                                          "mu_dtype": "bfloat16"}, 2),
}
GENERATOR_SEED = 11
CLI_STEPS = 2


def _batch(rng) -> dict:
    intr = np.tile(np.array([[20.0, 0, 32], [0, 20.0, 32], [0, 0, 1]]),
                   (B, T, V, 1, 1))
    transforms = np.tile(np.eye(4), (B, T, V, 1, 1))
    transforms[..., :3, 3] = rng.standard_normal((B, T, V, 3))
    batch = {
        "latents": rng.standard_normal((B, T, V, H, W, C)),
        "encoder_hidden_states": rng.standard_normal((B, T, V, L, JOINT)),
        "pooled_projections": rng.standard_normal((B, T, V, POOLED)),
        "camera_intrinsics": intr,
        "camera_transforms": transforms,
        "image_size": np.tile(np.array([64.0, 64.0]), (B, T, V, 1)),
        "fps": np.full((B,), 10.0),
    }
    return {k: v.astype(np.float32) for k, v in batch.items()}


def _pipeline_config() -> dict:
    cfg = _train_config()
    cfg["model"].update(num_layers=LAYERS, dual_attention_layers=[0],
                        crossview_block_layers=[1], temporal_block_layers=[1])
    return cfg


def _config(tc, oc_update) -> dict:
    cfg = _pipeline_config()
    cfg["training_config"] = dict(tc)
    cfg["optimizer_config"] = {**cfg["optimizer_config"], **oc_update}
    return cfg


def _jax_steps(cfg, params, batch, keys, world, dims, policy):
    """JAX's sharded steps, one a key, on a (dp, fsdp) mesh of ``world``
    virtual devices: (losses, grad norms, the new params as a port state
    dict)."""
    pipe = jax_config.create_instance_from_config(copy.deepcopy(cfg))
    pipe.mesh = jax_make_mesh(JaxMeshSpec(dp=dims[0], fsdp=dims[1], tp=1),
                              jax.devices()[:world])
    pipe.policy = policy
    state = pipe.shard_state(JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        opt_state=pipe.tx.init(params["params"])))
    jbatch = jax_shard_batch({k: jnp.asarray(v) for k, v in batch.items()},
                             pipe.mesh)
    losses, norms = [], []
    for key in keys:
        state, metrics = pipe.train_step(state, jbatch, key)
        losses.append(float(metrics["sd_loss"]))
        norms.append(float(metrics["grad_norm"]))
    return (losses, norms,
            dit_state_dict_from_flax(jax.device_get(state.params), LAYERS))


def _params(model) -> dict:
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _cli_runs(tmp_path_factory) -> dict:
    """The train CLI, ``CLI_STEPS`` steps of the cut synthetic config, in
    one process here: its start, its parameters after the steps, its logged
    losses; and the world-2 case's arguments."""
    tmp = tmp_path_factory.mktemp("cli")
    cfg = _cli_config(tmp)

    def argv(out):
        return ["-c", str(cfg), "-o", str(tmp / out), "--device", "cpu",
                "--max-steps", str(CLI_STEPS), "--log-steps", "1"]

    config, device = train.read_config(train.create_parser().parse_args(
        argv("one")))
    torch.manual_seed(config.get("generator_seed", 0))
    start = _params(train.build_pipeline(config, device).model)
    state = train.main(train.create_parser().parse_args(argv("one")))
    return {"start": start, "params": _params(state.model),
            "losses": _logged_losses(tmp / "one"), "dir": tmp / "two",
            "argv": argv("two")}


def _logged_losses(out) -> list:
    return [json.loads(line)["sd_loss"] for line in
            (out / "log" / "events.jsonl").read_text().splitlines()]


def _maskgit_one_process():
    """The small MaskGIT's weights, batch and draws, and its one-process
    step's loss and transformer parameters."""
    torch.manual_seed(3)
    pipe = workers.maskgit_pipeline()
    rng = np.random.default_rng(1)
    b, img = workers.MASKGIT_B, workers.MASKGIT_IMG
    pts = rng.uniform(-8, 8, (b, 1, 256, 3)).astype(np.float32)
    pts[..., 2] = rng.uniform(-1, 1, (b, 1, 256))
    batch = {"lidar_points": torch.from_numpy(pts),
             "lidar_points_mask": torch.ones(b, 1, 256, dtype=torch.bool),
             "3dbox_bev_images": torch.from_numpy(
                 rng.uniform(size=(b, img, img, 3)).astype(np.float32))}
    draws = pipe.draw_training_randoms(batch, torch.Generator().manual_seed(5))
    state_dict = {"model": copy.deepcopy(pipe.model.state_dict()),
                  "vq": copy.deepcopy(pipe.vq.state_dict())}
    state = pipe.init_state()
    state, metrics = pipe.train_step(state, batch, draws=draws)
    return state_dict, batch, draws, (
        float(metrics["ce_loss"]),
        {n: p.detach().clone() for n, p in state.model.named_parameters()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg0 = _pipeline_config()
    batch = _batch(np.random.default_rng(0))
    jax_pipe = jax_config.create_instance_from_config(copy.deepcopy(cfg0))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    shapes = jax.eval_shape(
        jax_pipe.model.init, jax.random.PRNGKey(0),
        sample=jbatch["latents"], timestep=jnp.zeros((B, T, V)),
        **jax_get_conditions(jbatch, COMMON))
    params = random_flax_params(shapes, 1)
    state_dict = to_torch(dit_state_dict_from_flax(params, LAYERS))
    keys = [jax.random.PRNGKey(7), jax.random.PRNGKey(8)]
    draws = [jax_training_draws(k, batch["latents"].shape, NO_CLIP, COMMON)
             for k in keys]
    tbatch = to_torch_tree(batch)

    ref = {name: _jax_steps(_config(tc, oc), params, batch, keys[:steps],
                            world, dims, policy)
           for name, (world, dims, policy, tc, oc, steps) in CASES.items()}

    # one process: step 1, its checkpoint, step 2
    one_dir = str(tmp_path_factory.mktemp("one"))
    two_dir = str(tmp_path_factory.mktemp("two"))
    one = workers.ctsd_pipeline(_config(NO_CLIP, {}), state_dict)
    state = one.init_state()
    state, metrics = one.train_step(state, tbatch, draws=draws[0])
    one_step1 = ([float(metrics["sd_loss"])], _params(state.model))
    checkpoint.save_checkpoint(one_dir, 1, state)
    state, _ = one.train_step(state, tbatch, draws=draws[1])
    one_step2 = _params(state.model)
    # one process drawing from a generator, as the train CLI does
    gen_one = workers.ctsd_pipeline(_config(NO_CLIP, {}), state_dict)
    gen_state = gen_one.init_state()
    gen = torch.Generator().manual_seed(GENERATOR_SEED)
    gen_losses = []
    for _ in range(2):
        gen_state, metrics = gen_one.train_step(gen_state, tbatch, gen)
        gen_losses.append(float(metrics["sd_loss"]))

    def case(name, draw_list=draws, *extra):
        world, dims, policy, tc, oc, steps = CASES[name]
        return ("sharded_step", (_config(tc, oc), state_dict, tbatch,
                                 draw_list,
                                 {"dp": dims[0], "fsdp": dims[1], "tp": 1},
                                 policy, *(extra or (steps,))))

    two_cases = {name: case(name) for name in ("fsdp", "ddp", "clip", "flat")}
    two_cases["generator"] = case("fsdp", GENERATOR_SEED, 2)
    # the joint attentions ringed over tp = 2 (the data ranks: 1)
    sp_cfg = _config(NO_CLIP, {})
    sp_cfg["model"]["sequence_parallel_axis"] = "tp"
    two_cases["sp"] = ("sharded_step", (
        sp_cfg, state_dict, tbatch, [draws[0]], {"dp": 1, "fsdp": 1, "tp": 2},
        "fsdp"))
    cli = _cli_runs(tmp_path_factory)
    two_cases["cli"] = ("train_cli", (cli["argv"],))
    # a checkpoint saved at world 2 and resumed there; one saved in one
    # process and resumed at world 2
    two_cases["save"] = case("fsdp", [draws[0]], 1, (two_dir, 1))
    two_cases["resume_two"] = case("fsdp", [draws[1]], 1, None, (two_dir, 1))
    two_cases["resume_one"] = case("fsdp", [draws[1]], 1, None, (one_dir, 1))
    # gradient accumulation over 2 micro-steps: FSDP averages each
    # micro-step's gradient once, the accumulator keeps their running mean
    accum = _config({**NO_CLIP, "gradient_accumulation_steps": 2}, {})
    two_cases["accum"] = ("sharded_step", (
        accum, state_dict, tbatch, draws, {"dp": 1, "fsdp": 2, "tp": 1},
        "fsdp", 2))
    mg_sd, mg_batch, mg_draws, mg_ref = _maskgit_one_process()
    two_cases["maskgit"] = ("maskgit_step", (mg_sd, mg_batch, mg_draws))
    two = workers.run_group("run_cases", 2, two_cases)
    four = workers.run_group("run_cases", 4, {"hsdp": case("hsdp")})

    # one process from the world-2 checkpoint
    solo = workers.ctsd_pipeline(_config(NO_CLIP, {}), state_dict)
    solo_state = solo.init_state()
    checkpoint.load_checkpoint(two_dir, 1, solo_state)
    solo_state, _ = solo.train_step(solo_state, tbatch, draws=draws[1])
    acc = workers.ctsd_pipeline(accum, state_dict)
    acc_state = acc.init_state()
    acc_norms = []
    for d in draws:
        acc_state, metrics = acc.train_step(acc_state, tbatch, draws=d)
        acc_norms.append(float(metrics["grad_norm"]))
    cli["two_losses"] = _logged_losses(cli["dir"])
    start = {n: p.detach().clone() for n, p in state_dict.items()}
    return dict(ref=ref, two=two, four=four, accum_norms=acc_norms,
                start=start, one_step1=one_step1, cli=cli,
                generator=(gen_losses, _params(gen_state.model)),
                accum_one={n: p.detach().clone()
                           for n, p in acc_state.model.named_parameters()},
                one_step2=one_step2,
                solo_step2={n: p.detach().clone() for n, p in
                            solo_state.model.named_parameters()},
                maskgit_ref=mg_ref)


def _check_update(got: dict, want: dict, start: dict):
    """Every parameter's update (its value less ``start``; float64
    differences of fp32 values, so exact) against ``want``'s: over the
    whole model within 2e-3 in relative norm, and each tensor's within 0.1
    beyond one fp32 ulp an element (the rounding floor of a norm scale
    near 1 that only weight decay moves). Skipping a tensor's update, or
    halving or doubling it, misses by 0.5 or more. The floor of the whole
    model's is AdamW: a first step moves an element with a gradient near
    its eps (1e-8) by lr g / (|g| + eps), so rounding in g moves it by up
    to 0.2 lr; some ten of 230k elements do, 5.4e-4 of the update's norm
    against JAX's step (the clipped two-step case: 7.5e-5)."""
    assert got.keys() == want.keys()
    diff2 = step2 = 0.0
    for name, p in got.items():
        p0 = np.asarray(start[name], np.float64)
        ref = np.asarray(want[name])
        step = ref.astype(np.float64) - p0
        diff = np.asarray(p, np.float64) - p0 - step
        ulp = np.linalg.norm(np.spacing(np.abs(ref.astype(np.float32))))
        assert np.linalg.norm(diff) <= 0.1 * np.linalg.norm(step) + ulp, name
        diff2 += np.sum(diff ** 2)
        step2 += np.sum(step ** 2)
    assert diff2 <= (2e-3) ** 2 * step2


def _check_step(got, ref, start):
    losses, norms, params = ref
    np.testing.assert_allclose(got["loss"], losses, rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], norms, rtol=1e-4)
    for name, p in got["params"].items():
        np.testing.assert_allclose(p.numpy(), params[name], atol=1e-4,
                                   err_msg=name)
    _check_update(got["params"], params, start)


@pytest.mark.parametrize("name", ["fsdp", "ddp", "clip", "flat"])
def test_world_two_step_matches_jax(runs, name):
    """Every rank's losses, grad norms and parameter updates equal JAX's
    sharded steps'."""
    for rank in runs["two"]:
        _check_step(rank[name], runs["ref"][name], runs["start"])


def test_hsdp_two_by_two_matches_jax(runs):
    for rank in runs["four"]:
        _check_step(rank["hsdp"], runs["ref"]["hsdp"], runs["start"])


def test_generator_draws_are_the_global_batch_rows(runs):
    """Two fsdp steps at world 2 that draw from a generator (seeded alike
    on both ranks) equal the one-process steps on the whole batch: each
    rank keeps its rows of the randoms drawn for the global batch."""
    losses, params = runs["generator"]
    for rank in runs["two"]:
        got = rank["generator"]
        np.testing.assert_allclose(got["loss"], losses, rtol=1e-5)
        _check_update(got["params"], params, runs["start"])


def test_train_cli_under_torchrun_at_world_two(runs):
    """The train CLI in torchrun's environment at world 2 (fsdp, each rank
    on its half of each batch) takes the steps of the one-process CLI on
    the same data: rank 0's logged losses and both ranks' parameters."""
    cli = runs["cli"]
    np.testing.assert_allclose(cli["two_losses"], cli["losses"], rtol=1e-5)
    for rank in runs["two"]:
        assert rank["cli"]["step"] == CLI_STEPS
        _check_update(rank["cli"]["params"], cli["params"], cli["start"])


def test_sequence_parallel_train_step_at_tp_two(runs):
    """A DiT with ``sequence_parallel_axis="tp"`` in the pipeline's train
    step on a (dp 1, fsdp 1, tp 2) mesh, its joint attentions ringed over
    the two ranks, equals the one-process step without the ring."""
    losses, params = runs["one_step1"]
    for rank in runs["two"]:
        got = rank["sp"]
        np.testing.assert_allclose(got["loss"], losses, rtol=1e-5)
        _check_update(got["params"], params, runs["start"])


@pytest.mark.parametrize("name", ["fsdp", "hsdp"])
def test_parameters_and_moments_are_placed_as_jax_rules(runs, name):
    """Each parameter is a DTensor sharded on the dimension JAX's rule picks
    (dim 0 where JAX replicates), over the fsdp axis (HSDP: replicated over
    dp); its moments are placed like it."""
    got = (runs["four"] if name == "hsdp" else runs["two"])[0][name]
    dims = got["shardings"]["params"]
    assert any(d is not None for d in dims.values())
    assert any(d is None for d in dims.values())
    for pname, dim in dims.items():
        shard = f"Shard(dim={0 if dim is None else dim})"
        want = f"(Replicate(), {shard})" if name == "hsdp" else f"({shard},)"
        assert got["placements"][pname] == want, pname
        assert got["moments"][pname] == want, pname
        assert got["shardings"]["opt_state"][pname] == {
            "exp_avg": dim, "exp_avg_sq": dim}


def test_checkpoint_moves_between_world_sizes(runs):
    """A checkpoint saved at world 2 loads in one process, and one saved in
    one process loads at world 2: the next step equals the uninterrupted
    run's (to float summation order)."""
    for got in (runs["solo_step2"],
                *(r["resume_two"]["params"] for r in runs["two"])):
        for name, p in got.items():
            np.testing.assert_allclose(p.numpy(),
                                       runs["one_step2"][name].numpy(),
                                       atol=1e-5, err_msg=name)
    for rank in runs["two"]:
        assert rank["resume_one"]["step"] == 2
        for name, p in rank["resume_one"]["params"].items():
            np.testing.assert_allclose(p.numpy(),
                                       runs["one_step2"][name].numpy(),
                                       atol=1e-5, err_msg=name)


def test_maskgit_takes_its_mesh(runs):
    """MaskGIT under DDP at world 2 (its default policy) equals its
    one-process step on the whole batch."""
    loss, params = runs["maskgit_ref"]
    for rank in runs["two"]:
        got = rank["maskgit"]
        assert got["policy"] == "ddp"
        assert abs(got["loss"] - loss) <= 1e-5 * abs(loss)
        for name, p in got["params"].items():
            a, b = p.numpy(), params[name].numpy()
            if name.endswith("qkv.bias"):
                # the key bias's gradient is 0 in exact arithmetic (softmax
                # is shift-invariant), so AdamW's first step moves it by up
                # to lr on rounding noise, whichever way: held to 2 lr
                third = a.shape[0] // 3
                key = slice(third, 2 * third)
                assert np.abs(a[key] - b[key]).max() <= 2e-3, name
                a, b = np.delete(a, np.r_[key]), np.delete(b, np.r_[key])
            np.testing.assert_allclose(a, b, atol=1e-5, err_msg=name)


def test_gradient_accumulation_reduces_once(runs):
    """Two accumulated micro-steps under fsdp at world 2: each micro-step's
    gradient norm is the whole batch's (a second reduction would double
    it; AdamW's update alone would not show it), and the update after the
    second equals the one-process accumulation's."""
    for rank in runs["two"]:
        got = rank["accum"]
        assert got["step"] == 2
        np.testing.assert_allclose(got["grad_norm"], runs["accum_norms"],
                                   rtol=1e-4)
        for name, p in got["params"].items():
            np.testing.assert_allclose(p.numpy(),
                                       runs["accum_one"][name].numpy(),
                                       atol=1e-5, err_msg=name)
