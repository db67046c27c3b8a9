"""The port's streaming pipeline against the JAX package's, on the CPU in
fp32 (the geometry of ``tests/test_streaming.py``: B, T, V, H, W, C = 1,
3, 2, 8, 8, 16 and 6 steps, so 2 a tick).

Both pipelines drive the same tiny DiT (the one of
``tests/test_streaming.py``, or one with an ImageAdapter; JAX params drawn
with numpy, loaded into the port through ``convert.py``) from the same
initial latents and, each tick, the JAX package's fresh tail noise. Each
tick's emitted latent and ``ready`` are held to JAX's at 1e-3, in both CFG
forms, with box/map rasters (``condition_image_tensor``), uncond text from
the frame batch and ``text_prompt_interval`` 2; the condition queues after
every push too. JAX's ``step_stream`` is jitted, one compile a
configuration.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendwm_tpu.models.mmdit import DiTCrossviewTemporal as JaxDiT
from opendwm_tpu.pipelines import ctsd_streaming as jax_streaming
from opendwm_tpu.pipelines.ctsd import get_conditions as jax_get_conditions
from opendwm_tpu.schedulers import FlowMatchEulerScheduler as JaxFlowMatch
from opendwm_tpu_torch import config
from opendwm_tpu_torch.convert import dit_state_dict_from_flax, to_torch
from opendwm_tpu_torch.models.mmdit import DiTCrossviewTemporal
from opendwm_tpu_torch.pipelines import ctsd_streaming
from opendwm_tpu_torch.pipelines.ctsd import get_conditions
from opendwm_tpu_torch.schedulers import FlowMatchEulerScheduler

from torch_port_helpers import (
    TINY_BM_DIT,
    layout_rasters,
    random_flax_params,
    redraw_gates,
)

B, T, V, H, W, C = 1, 3, 2, 8, 8, 16
L, JOINT, POOLED = 4, 24, 16
TOL = 1e-3
TICKS = 5  # ready from the 3rd
# The DiT of tests/test_streaming.py and the synthetic streaming config.
PLAIN_DIT = dict(
    patch_size=2, num_layers=2, attention_head_dim=8, num_attention_heads=4,
    in_channels=C, out_channels=C, joint_attention_dim=JOINT,
    caption_projection_dim=32, pooled_projection_dim=POOLED,
    pos_embed_max_size=16, sample_size=8, dual_attention_layers=(),
    enable_crossview=True, crossview_attention_type="rowwise",
    crossview_block_layers=(0,), enable_temporal=True,
    temporal_attention_type="pointwise", temporal_block_layers=(1,))
# Action ids: fps + 1 intrinsic + 1 extrinsic + speed and steering.
ACTION = {
    "added_time_ids": "fps_camera_transforms_action",
    "camera_intrinsic_embedding_indices": [0],
    "camera_intrinsic_denom_embedding_indices": [0],
    "camera_transform_embedding_indices": [3],
}


def _model_kw(common, adapter=True):
    if not adapter:
        return dict(PLAIN_DIT)
    kw = copy.deepcopy(TINY_BM_DIT)
    if "added_time_ids" not in common:
        kw.pop("perspective_modeling_type")
        kw.pop("projection_class_embeddings_input_dim")
    return kw


def build(inference_config, common=None, seed=1, adapter=True):
    """(JAX pipeline, its params, the port's pipeline) on one tiny DiT,
    with the ImageAdapter or the plain one of ``tests/test_streaming.py``."""
    common = dict(common or {}, uncondition_image_color=0.25)
    kw = _model_kw(common, adapter)
    jax_pipe = jax_streaming.StreamingCTSDPipeline(
        model=JaxDiT(**kw), train_scheduler=JaxFlowMatch(shift=3.0),
        test_scheduler=JaxFlowMatch(shift=3.0), common_config=common,
        inference_config=inference_config, sharding_policy="ddp")
    conds = jx(template(adapter))
    if "added_time_ids" in common:
        conds["added_time_ids"] = jnp.zeros((B, T, V, 5))
    shapes = jax.eval_shape(
        jax_pipe.model.init, jax.random.PRNGKey(0),
        sample=jnp.zeros((B, T, V, H, W, C)), timestep=jnp.zeros((B, T, V)),
        **conds)
    params = jax.tree.map(np.asarray, random_flax_params(shapes, seed))
    if adapter:  # N(0, 1) gates, so the rasters move the output
        params = redraw_gates(params, np.random.default_rng(seed))
    port = ctsd_streaming.StreamingCTSDPipeline(
        model=DiTCrossviewTemporal(**kw).eval(),
        train_scheduler=FlowMatchEulerScheduler(shift=3.0),
        test_scheduler=FlowMatchEulerScheduler(shift=3.0),
        common_config=common, inference_config=inference_config)
    port.model.load_state_dict(to_torch(
        dit_state_dict_from_flax(params, kw["num_layers"])))
    return jax_pipe, params, port


def frame_batch(rng, rasters=True) -> dict:
    """One frame's conditions (numpy): text, uncond text and, with
    ``rasters``, box and map rasters."""
    batch = {
        "encoder_hidden_states": rng.standard_normal((B, 1, V, L, JOINT)),
        "pooled_projections": rng.standard_normal((B, 1, V, POOLED)),
        "uncond_encoder_hidden_states": rng.standard_normal(
            (B, 1, V, L, JOINT)),
        "uncond_pooled_projections": rng.standard_normal((B, 1, V, POOLED)),
    }
    if rasters:
        for key in ("3dbox_images", "hdmap_images"):
            batch[key] = layout_rasters(rng, (B, 1, V, 2 * H, 2 * W, 3))
    return {k: v.astype(np.float32) for k, v in batch.items()}


def template(rasters=True):
    out = {"encoder_hidden_states": np.zeros((B, T, V, L, JOINT), np.float32),
           "pooled_projections": np.zeros((B, T, V, POOLED), np.float32)}
    if rasters:
        out["condition_image_tensor"] = np.zeros(
            (B, T, V, 2 * H, 2 * W, 6), np.float32)
    return out


def jx(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def pt(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def fresh_noise(jax_state):
    """The tail noise JAX's next ``step_stream`` draws."""
    _, k_new = jax.random.split(jax_state.rng)
    return jax.random.normal(k_new, (B, 1, V, H, W, C), jnp.float32)


def run_ticks(jax_pipe, params, port, frames, rasters=True):
    """Drive both pipelines tick by tick; yields (tick, JAX out, port out)
    after checking the queues and ``ready``."""
    step = jax.jit(jax_pipe.step_stream)
    js = jax_pipe.reset_streaming((B, T, V, H, W, C), jx(template(rasters)),
                                  jax.random.PRNGKey(5))
    ps = port.reset_streaming((B, T, V, H, W, C), pt(template(rasters)),
                              noise=torch.from_numpy(np.array(js.latents)))
    for i, fb in enumerate(frames):
        js = jax_pipe.send_frame_condition(js, jx(fb))
        ps = port.send_frame_condition(ps, pt(fb))
        assert ps.frames_received == int(js.frames_received) == i + 1
        for k, q in ps.conditions.items():
            if isinstance(q, torch.Tensor):
                np.testing.assert_array_equal(
                    q.numpy(), np.asarray(js.conditions[k]), err_msg=k)
        fresh = torch.from_numpy(np.array(fresh_noise(js)))
        js, j_out, j_ready = step(params, js)
        ps, p_out, p_ready = port.receive_frame(ps, fresh)
        assert p_ready == bool(j_ready) == (i + 1 >= T)
        yield i, np.asarray(j_out), p_out.numpy()
        np.testing.assert_array_equal(ps.latents[:, -1:].numpy(),
                                      fresh.numpy())


@pytest.mark.parametrize("adapter,sequential", [
    (False, False), (True, False), (True, True)])
def test_fifo_ticks_match_jax(adapter, sequential):
    ic = {"inference_steps": 6, "guidance_scale": 2.0,
          "sequential_cfg": sequential, "text_prompt_interval": 2}
    jax_pipe, params, port = build(ic, adapter=adapter)
    rng = np.random.default_rng(7)
    frames = [frame_batch(rng, adapter) for _ in range(TICKS)]
    outs = []
    for i, j_out, p_out in run_ticks(jax_pipe, params, port, frames,
                                     adapter):
        assert p_out.shape == (B, V, H, W, C)
        np.testing.assert_allclose(p_out, j_out, atol=TOL,
                                   err_msg=f"tick {i}")
        outs.append(p_out)
    assert not np.allclose(outs[-2], outs[-1])  # new frames flow through


def test_text_prompt_interval_holds_text():
    """Text lands at the tail on frames 0, 2, 4 and repeats the previous
    tail in between; rasters land on every frame."""
    _, _, port = build({"inference_steps": 6, "text_prompt_interval": 2})
    rng = np.random.default_rng(3)
    frames = [pt(frame_batch(rng)) for _ in range(4)]
    s = port.reset_streaming((B, T, V, H, W, C), pt(template()),
                             torch.Generator().manual_seed(0))
    texts = []
    for fb in frames:
        s = port.send_frame_condition(s, fb)
        texts.append(s.conditions["encoder_hidden_states"][:, -1])
        torch.testing.assert_close(
            s.conditions["condition_image_tensor"][:, -1],
            torch.cat([fb["3dbox_images"], fb["hdmap_images"]], -1)[:, 0])
    ehs = [fb["encoder_hidden_states"][:, 0] for fb in frames]
    for got, want in zip(texts, [ehs[0], ehs[0], ehs[2], ehs[2]]):
        torch.testing.assert_close(got, want)


def test_uncond_text_picked_up_from_frame_batch():
    """The frame batch's uncond text lands in the state and moves the CFG
    output against the zeros used without it."""
    ic = {"inference_steps": 6, "guidance_scale": 2.0}
    _, _, port = build(ic)
    fb = pt(frame_batch(np.random.default_rng(4)))
    plain = {k: v for k, v in fb.items() if not k.startswith("uncond_")}
    outs = []
    for batch in (fb, plain):
        s = port.reset_streaming((B, T, V, H, W, C), pt(template()),
                                 torch.Generator().manual_seed(0))
        s = port.send_frame_condition(s, batch)
        outs.append(port.step_stream(s)[1])
    s_with = port.send_frame_condition(port.reset_streaming(
        (B, T, V, H, W, C), pt(template())), fb)
    assert set(s_with.uncond_text) == {"encoder_hidden_states",
                                       "pooled_projections"}
    assert (outs[0] - outs[1]).abs().max() > 1e-4


def test_sequential_cfg_equals_batched():
    ic = {"inference_steps": 6, "guidance_scale": 2.0}
    _, _, port = build(ic)
    seq = ctsd_streaming.StreamingCTSDPipeline(
        model=port.model, train_scheduler=port.train_scheduler,
        test_scheduler=port.test_scheduler, common_config=port.common_config,
        inference_config=dict(ic, sequential_cfg=True))
    s = port.reset_streaming((B, T, V, H, W, C), pt(template()),
                             torch.Generator().manual_seed(0))
    s = port.send_frame_condition(s, pt(frame_batch(
        np.random.default_rng(9))))
    noise = torch.randn(B, 1, V, H, W, C)
    _, out_batched, _ = port.step_stream(s, noise)
    _, out_seq, _ = seq.step_stream(s, noise)
    torch.testing.assert_close(out_seq, out_batched, rtol=1e-5, atol=1e-5)


def test_uncondition_branch_matches_jax():
    """A full queue set directly, with action ids and rasters: the
    unconditional branch (action ids at -1000, rasters at the uncondition
    colour, zero text) and the step, against JAX."""
    ic = {"inference_steps": 6, "guidance_scale": 2.0}
    jax_pipe, params, port = build(ic, ACTION)
    rng = np.random.default_rng(11)
    conds = {
        "encoder_hidden_states": rng.standard_normal((B, T, V, L, JOINT)),
        "pooled_projections": rng.standard_normal((B, T, V, POOLED)),
        "condition_image_tensor": layout_rasters(
            rng, (B, T, V, 2 * H, 2 * W, 6)),
        "added_time_ids": rng.uniform(-2, 2, (B, T, V, 5)),
    }
    conds = {k: v.astype(np.float32) for k, v in conds.items()}
    latents = rng.standard_normal((B, T, V, H, W, C)).astype(np.float32)
    js = jax_streaming.StreamingState(
        latents=jnp.asarray(latents), conditions=jx(conds),
        frames_received=jnp.asarray(T, jnp.int32),
        rng=jax.random.PRNGKey(3))
    ps = ctsd_streaming.StreamingState(
        latents=torch.from_numpy(latents), conditions=pt(conds),
        frames_received=T)
    fresh = torch.from_numpy(np.array(fresh_noise(js)))
    _, j_out, _ = jax.jit(jax_pipe.step_stream)(params, js)
    _, p_out, ready = port.step_stream(ps, fresh)
    assert ready
    np.testing.assert_allclose(p_out.numpy(), np.asarray(j_out), atol=TOL)

    cfg, _ = port._guidance_conditions(ps, sequential=False)
    ids = cfg["added_time_ids"]
    assert ids.shape == (2 * B, T, V, 5)
    assert (ids[:B, ..., -2:] == -1000).all()
    torch.testing.assert_close(ids[:B, ..., :-2], ids[B:, ..., :-2])
    assert (cfg["condition_image_tensor"][:B] == 0.25).all()
    assert (cfg["encoder_hidden_states"][:B] == 0).all()

    # the rasters move the output: the adapter is on the path
    blank = dataclasses.replace(ps, conditions=dict(
        ps.conditions, condition_image_tensor=torch.full_like(
            ps.conditions["condition_image_tensor"], 0.25)))
    _, moved, _ = port.step_stream(blank, fresh)
    assert (moved - p_out).abs().max() > 1e-3


def test_steps_per_inference_assert():
    _, _, port = build({"inference_steps": 6})
    assert port.steps_per_inference(3) == 2
    with pytest.raises(AssertionError):
        port.steps_per_inference(4)  # 6 % 4 != 0


def test_config_builds_streaming_pipeline():
    cfg = {"_class_name": "dwm.pipelines.ctsd.StreamingCrossviewTemporalSD",
           "model": dict(_model_kw({}), _class_name="DiTCrossviewTemporal"),
           "train_scheduler": {"_class_name": "FlowMatchEulerScheduler"},
           "test_scheduler": {"_class_name": "FlowMatchEulerScheduler"},
           "inference_config": {"inference_steps": 6}}
    pipe = config.create_instance_from_config(cfg)
    assert isinstance(pipe, ctsd_streaming.StreamingCTSDPipeline)


def test_frame_conditions_match_jax_get_conditions():
    """The frame conditions the queue takes are the JAX package's."""
    fb = frame_batch(np.random.default_rng(2))
    common = {"uncondition_image_color": 0.25}
    ref = jax_get_conditions(jx(fb), common)
    out = get_conditions(pt(fb), common)
    for k in ("encoder_hidden_states", "pooled_projections",
              "condition_image_tensor"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]))
