"""The pipelines' evaluation and preview against the JAX package's, on the
CPU in fp32.

- CTSD (the synthetic config's tiny DiT with implicit perspective and a
  tiny VAE, shared weights as in test_torch_pipeline.py):
  ``evaluate_pipeline`` over two batches with ``FrechetPairedMetric``
  (plain and with shrinkage) on the decoded frames, the JAX package's
  initial noise (one key, ``PRNGKey(global_step)``, for every batch)
  handed to the port: results within 1e-4 relative; ``preview_pipeline``:
  the composited grid within 1e-5 and the same file name.
- MaskGIT: ``evaluate_pipeline`` (voxel IoU, voxel diff, Chamfer) on
  JAX's draws (``fold_in(rng, i)`` for batch i) within 1e-4;
  ``save_results`` writes the same file names and ``.bin`` bytes.
- ``rewrite_prompts`` equal on its three modes.
"""

import copy
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opendwm_tpu.config as jax_config
import opendwm_tpu.preview as jax_preview
import opendwm_tpu.utils.preview as jax_preview_utils
from opendwm_tpu.metrics import frechet as jfr
from opendwm_tpu.models.autoencoders import AutoencoderKL as JaxAutoencoderKL
from opendwm_tpu.pipelines.ctsd import get_conditions as jax_get_conditions
from opendwm_tpu_torch import config, preview
from opendwm_tpu_torch.convert import (
    dit_state_dict_from_flax,
    to_torch,
    vae_state_dict_from_flax,
)
from opendwm_tpu_torch.metrics import frechet
from opendwm_tpu_torch.models.autoencoders import AutoencoderKL
from opendwm_tpu_torch.pipelines import ctsd as tctsd
from opendwm_tpu_torch.pipelines.ctsd import slice_batch_time_window

from test_torch_maskgit import IMG, ZC, jax_decode_draws, jax_sigmoid_draws
from test_torch_maskgit import pipes as maskgit_pipes  # noqa: F401
from test_torch_pipeline import B, C, H, T, V, W, _batch, _pipeline_config
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_port_helpers import random_flax_params

REL = 1e-4
GRID_TOL = 1e-5


@pytest.fixture(scope="module")
def ctsd_pipes():
    """(JAX pipeline, its params, the port's) on shared weights, a tiny VAE
    of 4 levels (8 x 8 latents → 64 x 64 frames, the box rasters' size)."""
    cfg = _pipeline_config()
    jax_pipe = jax_config.create_instance_from_config(copy.deepcopy(cfg))
    port_pipe = config.create_instance_from_config(copy.deepcopy(cfg))
    window = slice_batch_time_window(
        {k: torch.from_numpy(v) for k, v in
         _batch(np.random.default_rng(0)).items()}, 0, T)
    conds = jax_get_conditions(
        {k: jnp.asarray(v.numpy()) for k, v in window.items()},
        cfg["common_config"])
    shapes = jax.eval_shape(
        jax_pipe.model.init, jax.random.PRNGKey(0),
        sample=jnp.zeros((B, T, V, H, W, C)), timestep=jnp.zeros((B, T, V)),
        **conds)
    params = random_flax_params(shapes, 1)
    port_pipe.model.load_state_dict(to_torch(
        dit_state_dict_from_flax(params, cfg["model"]["num_layers"])))
    vae_kw = dict(block_out_channels=(8, 8, 16, 16), latent_channels=C,
                  use_quant_conv=False, scaling_factor=1.5305,
                  shift_factor=0.0609)
    jax_vae = JaxAutoencoderKL(**vae_kw)
    vae_params = random_flax_params(jax.eval_shape(
        jax_vae.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))), 2)
    jax_pipe.set_vae(jax_vae, vae_params)
    port_vae = AutoencoderKL(**vae_kw)
    port_vae.load_state_dict(to_torch(vae_state_dict_from_flax(vae_params)))
    port_pipe.set_vae(port_vae)
    return jax_pipe, params, port_pipe


def _eval_batches(n: int):
    """Window batches with latents and 64 x 64 box rasters."""
    out = []
    for i in range(n):
        rng = np.random.default_rng(10 + i)
        batch = {k: v[:, :T] if v.ndim > 1 and v.shape[1] == 3 else v
                 for k, v in _batch(rng).items()}
        batch["latents"] = rng.standard_normal((B, T, V, H, W, C),
                                               np.float32)
        batch["3dbox_images"] = rng.uniform(
            0, 1, (B, T, V, 8 * H, 8 * W, 3)).astype(np.float32)
        out.append(batch)
    return out


def _jax_state(params, step=0):
    return types.SimpleNamespace(params=params, step=step)


def test_ctsd_evaluate_matches_jax(ctsd_pipes):
    jax_pipe, params, port_pipe = ctsd_pipes
    batches = _eval_batches(2)
    step = 5
    jmetrics = {"fid_proxy": jfr.FrechetPairedMetric(6),
                "shrunk": jfr.FrechetPairedMetric(6, shrinkage=1e-3)}
    want = jax_pipe.evaluate_pipeline(
        _jax_state(params), step,
        batches=[{k: jnp.asarray(v) for k, v in b.items()} for b in batches],
        metrics=jmetrics)
    noise = torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(step), (B, T, V, H, W, C), jnp.float32)))
    logged = []
    logger = types.SimpleNamespace(log=lambda s, v: logged.append((s, v)))
    got = port_pipe.evaluate_pipeline(
        None, step,
        batches=[{k: torch.from_numpy(v) for k, v in b.items()}
                 for b in batches],
        metrics={"fid_proxy": frechet.FrechetPairedMetric(6),
                 "shrunk": frechet.FrechetPairedMetric(6, shrinkage=1e-3)},
        noise=[noise, noise], logger=logger)
    assert got.keys() == want.keys() == {"evaluation/fid_proxy",
                                         "evaluation/shrunk"}
    for k in want:
        assert want[k] > 0
        assert abs(got[k] - want[k]) / want[k] <= REL, k
    assert logged == [(step, got)]
    assert port_pipe.evaluate_pipeline(None, 0) == {}  # no metrics, batches


def test_ctsd_preview_matches_jax(ctsd_pipes, tmp_path, monkeypatch):
    jax_pipe, params, port_pipe = ctsd_pipes
    batch = _eval_batches(1)[0]
    grids = {}

    def capture(name):
        def save(path, fps, frames):
            grids[name] = (path, fps, frames)
            return path
        return save

    monkeypatch.setattr(jax_preview_utils, "save_tensor_to_video",
                        capture("jax"))
    monkeypatch.setattr(tctsd, "save_tensor_to_video", capture("port"))
    step = 3
    jax_pipe.preview_pipeline(_jax_state(params, step),
                              {k: jnp.asarray(v) for k, v in batch.items()},
                              str(tmp_path), 7)
    noise = torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(step), (B, T, V, H, W, C), jnp.float32)))
    port_pipe.preview_pipeline(
        types.SimpleNamespace(step=step),
        {k: torch.from_numpy(v) for k, v in batch.items()}, str(tmp_path), 7,
        noise=noise)
    (jpath, jfps, jgrid), (path, fps, grid) = grids["jax"], grids["port"]
    assert path == jpath == str(tmp_path / "preview" / "7.mp4")
    assert fps == jfps == 10.0
    assert grid.shape == jgrid.shape == (T, 3 * 8 * H, V * 8 * W, 3)
    assert np.abs(grid - np.asarray(jgrid)).max() <= GRID_TOL


def test_ctsd_preview_writes_a_file(ctsd_pipes, tmp_path):
    _, _, port_pipe = ctsd_pipes
    batch = {k: torch.from_numpy(v) for k, v in _eval_batches(1)[0].items()}
    path = port_pipe.preview_pipeline(types.SimpleNamespace(step=0), batch,
                                      str(tmp_path), 0)
    # PyAV is absent here: an animated GIF of the same stem
    assert path == str(tmp_path / "preview" / "0.gif")
    from PIL import Image

    with Image.open(path) as im:
        assert im.n_frames == T and im.size == (V * 8 * W, 3 * 8 * H)


def test_maskgit_evaluate_matches_jax(maskgit_pipes):  # noqa: F811
    jp, params, tp, batch, tbatch = maskgit_pipes
    rng = jax.random.PRNGKey(8)
    frames = tbatch["lidar_points"].shape[1]
    want = jp.evaluate_pipeline(params, [batch], rng, global_step=2)
    n, l = frames, (IMG // 8) ** 2
    key = jax.random.fold_in(rng, 0)  # batch 0's key
    k1, k2 = jax.random.split(jax.random.fold_in(key, 99))
    shape = (n, ZC, IMG, IMG)
    draws = [{"decode": jax_decode_draws(key, 4, n, l),
              "pred_voxels": jax_sigmoid_draws(k1, shape),
              "vq_voxels": jax_sigmoid_draws(k2, shape)}]
    got = tp.evaluate_pipeline(tp.model, [tbatch], global_step=2,
                               draws=draws)
    assert got.keys() == want.keys() == {"evaluation/voxel_iou",
                                         "evaluation/voxel_diff",
                                         "evaluation/chamfer"}
    for k in want:
        assert np.isfinite(want[k])
        assert got[k] == pytest.approx(float(want[k]), rel=REL, abs=REL), k


@pytest.mark.parametrize("with_names", [False, True])
def test_maskgit_save_results_match_jax(maskgit_pipes, tmp_path,  # noqa: F811
                                        with_names):
    jp, params, tp, batch, tbatch = maskgit_pipes
    rng = jax.random.PRNGKey(4)
    results = jp.autoregressive_inference_pipeline(
        params, batch, rng, num_reference_frame=1, window_frames=2)
    tresults = {k: torch.from_numpy(np.asarray(v)) if hasattr(v, "shape")
                else v for k, v in results.items()}
    extra = {}
    if with_names:
        extra["sample_data"] = [[{"filename": [f"sweeps/f{i}.pcd.bin"]}
                                 for i in range(3)]]
    ic = {"save_preview": True, "save_pred_results": True,
          "save_gt_results": True}
    outputs = {}
    for name, pipe, res, b in (("jax", jp, results, batch),
                               ("port", tp, tresults, tbatch)):
        saved = pipe.inference_config
        pipe.inference_config = dict(saved, **ic)
        try:
            out = tmp_path / name
            paths = pipe.save_results(res, dict(b, **extra), str(out), "s")
        finally:
            pipe.inference_config = saved
        outputs[name] = (out, [str(p)[len(str(out)):] for p in paths])
    (jout, jpaths), (pout, ppaths) = outputs["jax"], outputs["port"]
    assert ppaths == jpaths and len(ppaths) == 1 + 3 + 3
    for rel_path in ppaths:
        a, b = (pout / rel_path.lstrip("/")), (jout / rel_path.lstrip("/"))
        if rel_path.endswith(".bin"):
            assert a.read_bytes() == b.read_bytes(), rel_path
        else:
            from PIL import Image

            assert np.array_equal(np.asarray(Image.open(a)),
                                  np.asarray(Image.open(b))), rel_path


@pytest.mark.parametrize("settings", [
    {"mode": "add", "text": "at night"},
    {"mode": "replace", "text": "a snowy road"},
    {"mode": "template", "text": "A photo of {}, in the rain."},
    {"mode": "other", "text": "x"},
    None,
])
def test_rewrite_prompts_matches_jax(settings):
    batch = {"image_description": [[["a car", "a bus"], "a street"],
                                   "a frame"],
             "fps": np.ones(1)}
    assert preview.rewrite_prompts(batch, settings) == \
        jax_preview.rewrite_prompts(batch, settings)
    assert preview.rewrite_prompts({"fps": 1}, settings) == {"fps": 1}
