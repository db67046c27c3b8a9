"""UniMLVG and the DiT's explicit perspective and other branch types, the
port vs the JAX package, on the CPU in fp32.

Both pipelines are built by their own config runtimes from the stage-3
UniMLVG config cut to 3 layers of 4 x 8 heads with a 2-stage adapter of
the joint width; weights cross by the weight bridge, and every draw is
the JAX package's, rebuilt from its ``PRNGKey`` in its split order.
Tolerances: rays, octaves and explicit view conditions to 1e-5; the DiT,
inference and the rollout to 1e-3 (the DiT bar of
``test_dit_converter_parity.py``); ``gen_ar_input`` to 1e-6; the loss to
1e-5 relative, each gradient to 1e-3 of its largest entry and one AdamW
step to 1e-4 (``test_torch_train.py``).
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
from opendwm_tpu.models.mmdit import RayEncoder
from opendwm_tpu.models.mmdit import get_rays as jax_get_rays
from opendwm_tpu.pipelines.ctsd import TrainState as JaxTrainState
from opendwm_tpu.pipelines.ctsd import get_conditions as jax_get_conditions
from opendwm_tpu_torch import config
from opendwm_tpu_torch.convert import (
    dit_flax_from_state_dict,
    dit_state_dict_from_flax,
    to_torch,
)
from opendwm_tpu_torch.models.mmdit import (
    DiTCrossviewTemporal,
    get_rays,
    octave_encode,
)
from opendwm_tpu_torch.pipelines.ctsd import get_conditions
from opendwm_tpu_torch.pipelines.unimlvg import (
    draw_unimlvg_randoms,
    fill_svd_mask,
)

from torch_port_helpers import (
    flax_init,
    layout_rasters,
    redraw_gates,
    to_torch_tree,
)

REPO = Path(__file__).resolve().parents[1]
STAGES = {n: REPO / f"configs/unimlvg/ctsd_unimlvg_{n}.json"
          for n in ("stage1_tird_o", "stage2_tirda_bm_nwa",
                    "stage3_tirda_bm_nwa")}
B, T, V, H, W, C = 1, 4, 3, 8, 8, 16
TOTAL_FRAMES = 7  # two windows of 4 frames, 1 reference frame
L, JOINT, POOLED = 5, 24, 16
LAYERS = 3
MODEL_CUT = dict(
    num_layers=LAYERS, attention_head_dim=8, num_attention_heads=4,
    joint_attention_dim=JOINT, caption_projection_dim=32,
    pooled_projection_dim=POOLED, pos_embed_max_size=16, sample_size=8,
    dual_attention_layers=[0], crossview_block_layers=[1],
    temporal_block_layers=[2])
ADAPTER = dict(in_channels=6, channels=[32, 32], is_downblocks=[True, False],
               num_res_blocks=1, downscale_factor=2, use_zero_convs=True)


def _pipeline_config(stage: str = "stage3_tirda_bm_nwa") -> dict:
    cfg = json.loads(STAGES[stage].read_text())["pipeline"]
    cfg["model"].update(MODEL_CUT)
    cfg["model"].pop("dtype")
    if "condition_image_adapter_config" in cfg["model"]:
        cfg["model"]["condition_image_adapter_config"] = dict(ADAPTER)
    cfg["inference_config"]["inference_steps"] = 2
    return cfg


def _cameras(rng, frames: int) -> dict:
    """A ring of V cameras 120° apart with jittered focal lengths, on an
    ego moving forward a little each frame."""
    yaw = np.arange(V) * 2 * np.pi / V + 0.1 * rng.standard_normal(V)
    cam = np.tile(np.eye(4), (B, frames, V, 1, 1))
    cam[..., 0, 0], cam[..., 0, 1] = np.cos(yaw), -np.sin(yaw)
    cam[..., 1, 0], cam[..., 1, 1] = np.sin(yaw), np.cos(yaw)
    cam[..., :3, 3] = rng.standard_normal((B, frames, V, 3))
    ego = np.tile(np.eye(4), (B, frames, V, 1, 1))
    ego[..., 0, 3] = np.arange(frames)[None, :, None] * 0.5
    ego[..., :3, :3] += 0.02 * rng.standard_normal((B, frames, V, 3, 3))
    intr = np.zeros((B, frames, V, 3, 3))
    intr[..., 0, 0] = rng.uniform(30, 40, (B, frames, V))
    intr[..., 1, 1] = rng.uniform(30, 40, (B, frames, V))
    intr[..., 0, 2], intr[..., 1, 2], intr[..., 2, 2] = 32, 30, 1
    return {"camera_intrinsics": intr, "camera_transforms": cam,
            "ego_transforms": ego,
            # not a time-indexed key: one frame broadcasts over a window
            "image_size": np.tile([64.0, 64.0], (B, 1, V, 1))}


def _batch(rng, frames: int = T) -> dict:
    batch = {
        "latents": rng.standard_normal((B, frames, V, H, W, C)),
        "encoder_hidden_states": rng.standard_normal(
            (B, frames, V, L, JOINT)),
        "pooled_projections": rng.standard_normal((B, frames, V, POOLED)),
        "3dbox_images": layout_rasters(rng, (B, frames, V, 2 * H, 2 * W, 3)),
        "hdmap_images": layout_rasters(rng, (B, frames, V, 2 * H, 2 * W, 3)),
        **_cameras(rng, frames),
    }
    return {k: np.asarray(v, np.float32) for k, v in batch.items()}


def _jnp(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _rel_to_max(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


@pytest.fixture(scope="module")
def setup():
    cfg = _pipeline_config()
    jax_pipe = jax_config.create_instance_from_config(copy.deepcopy(cfg))
    port_pipe = config.create_instance_from_config(copy.deepcopy(cfg))
    batch = _batch(np.random.default_rng(0))
    conds = jax_get_conditions(_jnp(batch), cfg["common_config"])
    params = flax_init(jax_pipe.model, seed=1,
                       sample=jnp.asarray(batch["latents"]),
                       timestep=jnp.zeros((B, T, V)), **conds)
    params = {"params": redraw_gates(params["params"],
                                     np.random.default_rng(2))}
    port_pipe.model.load_state_dict(to_torch(
        dit_state_dict_from_flax(params, LAYERS)))
    return jax_pipe, params, port_pipe, batch


# -- explicit perspective and view modeling -----------------------------------

def test_get_rays_and_octave_encoding_match_jax():
    rng = np.random.default_rng(3)
    k = np.zeros((6, 3, 3), np.float32)
    k[:, 0, 0], k[:, 1, 1] = rng.uniform(10, 20, 6), rng.uniform(10, 20, 6)
    k[:, 0, 2], k[:, 1, 2], k[:, 2, 2] = 14, 8, 1
    c2r = np.tile(np.eye(4, dtype=np.float32), (6, 1, 1))
    c2r[:, :3, :3] += 0.3 * rng.standard_normal((6, 3, 3)).astype(np.float32)
    c2r[:, :3, 3] = rng.standard_normal((6, 3))
    ref_o, ref_d = jax_get_rays(jnp.asarray(k), jnp.asarray(c2r), (16, 28))
    out_o, out_d = get_rays(torch.from_numpy(k), torch.from_numpy(c2r),
                            (16, 28))
    np.testing.assert_allclose(out_o.numpy(), np.asarray(ref_o), atol=1e-5)
    np.testing.assert_allclose(out_d.numpy(), np.asarray(ref_d), atol=1e-5)
    for coords, n in ((ref_o, 8), (ref_d, 4)):
        np.testing.assert_allclose(
            octave_encode(torch.tensor(np.asarray(coords)), n).numpy(),
            np.asarray(RayEncoder._octave_encode(coords, n)), atol=1e-5)


@pytest.mark.parametrize("ego", [True, False], ids=["ego", "no_ego"])
def test_explicit_view_conditions_match_jax(ego):
    batch = _batch(np.random.default_rng(4))
    if not ego:
        del batch["ego_transforms"]
    common = {"explicit_view_modeling": True}
    ref = jax_get_conditions(_jnp(batch), common,
                             do_classifier_free_guidance=True)
    out = get_conditions(_torch(batch), common,
                         do_classifier_free_guidance=True)
    assert ref.keys() == out.keys()
    for key in ("camera_intrinsics_norm", "camera2referego"):
        assert out[key].shape == (2 * B, T, V, *ref[key].shape[-2:])
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   atol=1e-5, err_msg=key)


# -- the DiT's branch types -------------------------------------------------------

DIT_CASES = {
    "explicit": {},
    "crossview_full": dict(crossview_attention_type="full"),
    "crossview_fuse": dict(crossview_attention_type="fuse"),
    "crossview_adj_fuse": dict(crossview_attention_type="adj_fuse"),
    "temporal_full": dict(temporal_attention_type="full"),
}


@pytest.mark.parametrize("case", DIT_CASES)
def test_dit_matches_jax(setup, case):
    """The stage-3 DiT (explicit perspective, adapter) with each cross-view
    and temporal type; ``fuse`` and ``adj_fuse`` also on a given
    neighbourhood index."""
    _, params, port_pipe, batch = setup
    kw = {k: v for k, v in _pipeline_config()["model"].items()
          if k != "_class_name"}
    kw.update(DIT_CASES[case])
    jm = JaxDiT(**kw)
    tm = DiTCrossviewTemporal(**kw)
    tm.load_state_dict(port_pipe.model.state_dict())
    common = _pipeline_config()["common_config"]
    indices = [None]
    if "fuse" in case:
        indices.append(np.array([[2, 0, 1], [0, 1, 2], [1, 2, 0]]))
    ts = np.random.default_rng(5).uniform(0, 1000, (B, T, V))
    for index in indices:
        jconds = jax_get_conditions(_jnp(batch), common)
        tconds = get_conditions(_torch(batch), common)
        if index is not None:
            jconds["crossview_attention_index"] = jnp.asarray(index)
            tconds["crossview_attention_index"] = torch.from_numpy(index)
        ref = jm.apply(params, sample=jnp.asarray(batch["latents"]),
                       timestep=jnp.asarray(ts), **jconds)
        with torch.no_grad():
            out = tm(sample=torch.from_numpy(batch["latents"]),
                     timestep=torch.from_numpy(ts), **tconds)
        assert out.shape == (B, T, V, H, W, C)
        assert float(np.abs(out.numpy() - np.asarray(ref)).max()) <= 1e-3


def test_camera_transforms_move_the_output(setup):
    _, _, port_pipe, batch = setup
    common = _pipeline_config()["common_config"]
    moved = dict(batch, camera_transforms=batch["camera_transforms"].copy())
    moved["camera_transforms"][..., :3, 3] += 1.0
    kw = dict(sample=torch.from_numpy(batch["latents"]),
              timestep=torch.full((B, T, V), 500.0))
    with torch.no_grad():
        a = port_pipe.model(**kw, **get_conditions(_torch(batch), common))
        b = port_pipe.model(**kw, **get_conditions(_torch(moved), common))
    assert float((a - b).norm() / a.norm()) > 1e-3


# -- gen_ar_input ---------------------------------------------------------------

VISTA_P = np.array([2.0 ** i for i in range(4)]) / 15.0


def jax_ar_draws(key, shape, style, train: bool) -> dict:
    """``gen_ar_input``'s draws from ``key`` (``unimlvg.py:75-94``), as
    ``draw_ar_randoms`` returns them."""
    b, t, v = shape[:3]
    if style == "vista":
        return to_torch_tree({"vista": jax.random.choice(
            key, 4, p=jnp.asarray(VISTA_P))})
    if style == "pred" and train:
        k1, k2 = jax.random.split(key)
        return to_torch_tree({"ratio": jax.random.uniform(k1, (b, 1, 1)),
                              "drop": jax.random.uniform(k2, (b, t, v))})
    return {}


def jax_loss_draws(key, shape, style) -> dict:
    """``UnimlvgPipeline.loss_fn``'s draws from ``key``, as
    ``draw_unimlvg_randoms`` returns them."""
    ks = jax.random.split(key, 7)
    b = shape[0]
    draws = to_torch_tree({
        "noise": jax.random.normal(ks[0], shape, jnp.float32),
        "time": jax.random.normal(ks[1], (b,)),
        **{name: jax.random.uniform(k, (b,))
           for name, k in zip(("text", "box", "map", "cxt"), ks[2:6])},
    })
    draws["ar"] = jax_ar_draws(ks[6], shape, style, True)
    return draws


AR_CASES = {
    "sd": ("sd", False, {}),
    "svd": ("svd", False, {"ar_input_cfg": {"num_init_frames": 2}}),
    "vista": ("vista", False, {}),
    "pred_train": ("pred", True, {"visible_frame": 2,
                                  "reference_timesteps": 7.0}),
    "pred_infer": ("pred", False, {"visible_frame": 3}),
    "pred_infer_disable_reference": ("pred", False, {"visible_frame": 3}),
}


@pytest.mark.parametrize("case", AR_CASES)
def test_gen_ar_input_matches_jax(setup, case):
    jax_pipe, _, port_pipe, _ = setup
    style, train, common = AR_CASES[case]
    rng = np.random.default_rng(6)
    shape = (4, T, V, 2, 2, C)
    noisy, latent = (rng.standard_normal(shape).astype(np.float32)
                     for _ in range(2))
    latent[1] = 0.0  # an all-zero context: svd's mask goes to zero
    ts = rng.uniform(0, 1000, shape[:3]).astype(np.float32)
    cxt = np.array([True, True, False, True])
    saved = [(p, p.common_config, p.inference_config)
             for p in (jax_pipe, port_pipe)]
    try:
        for p in (jax_pipe, port_pipe):
            p.common_config = dict(common, ar_input_type=style)
            p.inference_config = {"disable_reference": True} \
                if case.endswith("disable_reference") else {}
        for seed in range(3):
            key = jax.random.PRNGKey(seed)
            ref = jax_pipe.gen_ar_input(
                key, jnp.asarray(noisy), jnp.asarray(latent),
                jnp.asarray(ts), infer=not train,
                cxt_condition_mask=jnp.asarray(cxt) if style == "svd"
                else None, first_autoregressive=True)
            out = port_pipe.gen_ar_input(
                jax_ar_draws(key, shape, style, train),
                torch.from_numpy(noisy), torch.from_numpy(latent),
                torch.from_numpy(ts), infer=not train,
                cxt_condition_mask=torch.from_numpy(cxt)
                if style == "svd" else None, first_autoregressive=True)
            for o, r in zip(out, ref):
                assert (o is None) == (r is None)
                if r is not None:
                    np.testing.assert_allclose(o.numpy(), np.asarray(r),
                                               atol=1e-6)
    finally:
        for p, cc, ic in saved:
            p.common_config, p.inference_config = cc, ic


def test_fill_svd_mask():
    lat = torch.ones(1, 3, 1, 2, 2, 4)
    ori, mask = fill_svd_mask(2, lat)
    assert ori[0, 2].sum() == 0 and ori[0, 0].sum() == 16
    assert mask[0, :, 0, 0, 0, 0].tolist() == [1, 1, 0]
    assert fill_svd_mask(2, torch.zeros_like(lat))[1].sum() == 0


# -- inference and the rollout ----------------------------------------------------

def test_inference_matches_jax(setup):
    """Two flow-match steps with CFG 4.0 under ``pred`` with 3 visible
    frames and no context: the first window's visible frames come from
    zeros at the reference timestep, as in the JAX package."""
    jax_pipe, params, port_pipe, batch = setup
    shape = (B, T, V, H, W, C)
    rng = jax.random.PRNGKey(8)
    ref = jax_pipe.inference_pipeline(params, _jnp(batch), shape, rng)
    _, k_init = jax.random.split(rng)
    seen = []
    hook = port_pipe.model.register_forward_pre_hook(
        lambda _, args, kw: seen.append((kw["sample"], kw["timestep"])),
        with_kwargs=True)
    try:
        out = port_pipe.inference_pipeline(
            _torch(batch), shape, noise=torch.tensor(np.asarray(
                jax.random.normal(k_init, shape, jnp.float32))))
    finally:
        hook.remove()
    assert float(np.abs(out.numpy() - np.asarray(ref)).max()) <= 1e-3
    sample, timestep = seen[0]
    assert sample.shape[0] == 2 * B  # CFG at batch 2
    assert torch.all(sample[:, :3] == 0) and torch.all(timestep[:, :3] == 0)
    assert torch.all(sample[:, 3] != 0) and torch.all(timestep[:, 3] > 0)


def test_rollout_matches_jax(setup):
    """Two windows: the second window's context is the first window's last
    frame and zeros (``reference_frame_count`` 1), while ``pred`` shows
    ``visible_frame`` 3 frames of it, as in the JAX package."""
    jax_pipe, params, port_pipe, _ = setup
    batch = _batch(np.random.default_rng(9), TOTAL_FRAMES)
    shape = (B, T, V, H, W, C)
    rng = jax.random.PRNGKey(10)
    ref = jax_pipe.autoregressive_inference_pipeline(
        params, _jnp(batch), shape, rng, total_frames=TOTAL_FRAMES)
    noise = []
    for _ in range(2):
        rng, step_rng = jax.random.split(rng)
        _, k_init = jax.random.split(step_rng)
        noise.append(torch.tensor(np.asarray(
            jax.random.normal(k_init, shape, jnp.float32))))
    seen = []
    hook = port_pipe.model.register_forward_pre_hook(
        lambda _, args, kw: seen.append(kw["sample"]), with_kwargs=True)
    try:
        out = port_pipe.autoregressive_inference_pipeline(
            _torch(batch), shape, total_frames=TOTAL_FRAMES, noise=noise)
    finally:
        hook.remove()
    assert out.shape == ref.shape == (B, TOTAL_FRAMES, V, H, W, C)
    assert float(np.abs(out.numpy() - np.asarray(ref)).max()) <= 1e-3
    second = seen[2]  # the second window's first step
    assert torch.equal(second[:, 0], torch.cat([out[:, T - 1]] * 2))
    assert torch.all(second[:, 1:3] == 0)


# -- training --------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_loss_and_gradients_match_jax(setup, seed):
    jax_pipe, params, port_pipe, batch = setup
    key = jax.random.PRNGKey(seed)
    (ref_loss, _), ref_grads = jax.jit(jax.value_and_grad(
        jax_pipe.loss_fn, has_aux=True))(params["params"], _jnp(batch), key)
    pipe = copy.copy(port_pipe)
    pipe.model = copy.deepcopy(port_pipe.model)
    loss, metrics = pipe.loss_from_draws(
        _torch(batch), jax_loss_draws(key, batch["latents"].shape, "pred"))
    loss.backward()
    assert metrics["sd_loss"] is loss
    assert abs(loss.item() - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    ref = dit_state_dict_from_flax(ref_grads, LAYERS)
    grads = {n: p.grad for n, p in pipe.model.named_parameters()}
    assert grads.keys() == ref.keys()
    for name, g in grads.items():
        assert _rel_to_max(g.numpy(), ref[name]) <= 1e-3, name
    back = dit_flax_from_state_dict(grads)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, b, atol=1e-3 * max(np.abs(b).max(), 1e-12)), back["params"],
        jax.tree.map(np.asarray, ref_grads))


def test_train_step_matches_jax(setup):
    """One AdamW step (lr 5e-5, wd 0.01) after clipping to 1.0."""
    jax_pipe, params, port_pipe, batch = setup
    key = jax.random.PRNGKey(7)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          opt_state=jax_pipe.tx.init(params["params"]))
    new_state, ref_metrics = jax.jit(jax_pipe._train_step_impl)(
        state, _jnp(batch), key)
    pipe = copy.copy(port_pipe)
    pipe.model = copy.deepcopy(port_pipe.model)
    port_state = pipe.init_state()
    port_state, metrics = pipe.train_step(
        port_state, _torch(batch),
        draws=jax_loss_draws(key, batch["latents"].shape, "pred"))
    grad_norm = float(ref_metrics["grad_norm"])
    assert abs(metrics["grad_norm"].item() - grad_norm) <= 1e-4 * grad_norm
    ref = dit_state_dict_from_flax(new_state.params, LAYERS)
    for name, p in pipe.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name], atol=1e-4,
                                   err_msg=name)


def test_loss_draws_from_a_generator(setup):
    _, _, port_pipe, batch = setup
    draws = draw_unimlvg_randoms(batch["latents"].shape, "pred",
                                 torch.Generator().manual_seed(0))
    assert set(draws) == {"noise", "time", "text", "box", "map", "cxt", "ar"}
    assert set(draws["ar"]) == {"ratio", "drop"}
    with torch.no_grad():
        loss, _ = port_pipe.loss_fn(_torch(batch),
                                    torch.Generator().manual_seed(0))
        again, _ = port_pipe.loss_from_draws(_torch(batch), draws)
    assert torch.isfinite(loss) and loss.item() == again.item()


# -- the three configs ----------------------------------------------------------

@pytest.mark.parametrize("stage", STAGES)
def test_unimlvg_configs_build_and_train(stage):
    """Each ``configs/unimlvg/`` config, cut to 3 layers, builds through
    the port's registry (stage 3 as ``Unimlvg``, stages 1-2 as
    ``CTSDPipeline`` with explicit view modeling) and takes a train step."""
    cfg = _pipeline_config(stage)
    cfg["model"]["param_dtype"] = torch.float32
    pipe = config.create_instance_from_config(cfg)
    want = "UnimlvgPipeline" if stage.startswith("stage3") else "CTSDPipeline"
    assert type(pipe).__name__ == want
    assert pipe.model.perspective_modeling_type == "explicit"
    batch = _torch(_batch(np.random.default_rng(11)))
    if "condition_image_adapter_config" not in cfg["model"]:
        del batch["3dbox_images"], batch["hdmap_images"]
    state = pipe.init_state()
    before = pipe.model.rayencoder_proj.weight.detach().clone()
    _, metrics = pipe.train_step(state, batch,
                                 torch.Generator().manual_seed(1))
    assert torch.isfinite(metrics["sd_loss"])
    assert not torch.equal(pipe.model.rayencoder_proj.weight, before)
