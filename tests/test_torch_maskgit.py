"""The port's MaskGIT (``opendwm_tpu_torch/models/maskgit.py``,
``opendwm_tpu_torch/pipelines/lidar_maskgit.py``) against the JAX
package's (``opendwm_tpu/models/maskgit.py``,
``opendwm_tpu/pipelines/lidar_maskgit.py``) on the CPU in fp32.

- ``BidirectionalTransformer``: spatial only; temporal (rotary attention
  over the frames) with the extra embedding; both with the layout
  adapter's per-block residuals: logits within 1e-3 in relative norm.
- The draws: ``argmax(logits + jax.random.gumbel(key, logits.shape))``
  is ``jax.random.categorical(key, logits)`` bit for bit (jax 0.9.0), so
  the port's ``sample_tokens`` fed that noise picks JAX's codes; chunked
  sampling equals unchunked.
- ``inference_pipeline`` (generation and prediction) and a 2-window
  ``autoregressive_inference_pipeline`` fed JAX's own draws, rebuilt from
  the same key splits (``lidar_maskgit.py:307``, ``:442``, ``:517``):
  the same code indices and voxels.
- The weight bridge: flax → port → flax bit for bit; the perturbation
  draws act only where the model enables it; the evaluation's
  signature.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendwm_tpu.models import vq_point_cloud as jvq
from opendwm_tpu.models.maskgit import BidirectionalTransformer as JaxBT
from opendwm_tpu.ops.voxelize import Voxelizer as JaxVoxelizer
from opendwm_tpu.pipelines import lidar_maskgit as jpipe
from opendwm_tpu_torch.config import create_instance_from_config
from opendwm_tpu_torch.convert import (
    lidar_flax_from_state_dict,
    lidar_state_dict_from_flax,
    to_torch,
)
from opendwm_tpu_torch.models import vq_point_cloud as tvq
from opendwm_tpu_torch.models.maskgit import BidirectionalTransformer
from opendwm_tpu_torch.ops.voxelize import Voxelizer
from opendwm_tpu_torch.pipelines import lidar_maskgit as tpipe

from torch_port_helpers import flax_init, load_lidar as load, rel

REPO = Path(__file__).resolve().parents[1]
REL_TOL = 1e-3
IMG, ZC, N_E, E_DIM = 16, 8, 16, 12
VOX = dict(x_min=-4.0, x_max=4.0, y_min=-4.0, y_max=4.0, step=0.5,
           z_min=-1.0, z_max=1.0, z_step=0.25)
ENC = dict(img_size=IMG, patch_size=8, in_chans=ZC, embed_dim=8,
           num_heads=2, depth=6, codebook_dim=E_DIM, window_size=2)
DEC = dict(ENC, depth=4, density_feats=4)
ADAPTER = dict(in_channels=3, channels=[16, 16], is_downblocks=[True, False],
               num_res_blocks=1, downscale_factor=32)
MODEL = dict(n_e=N_E, e_dim=E_DIM, img_size=(IMG // 8, IMG // 8),
             hidden_dim=16, depth=2, num_heads=2, window_size=2,
             enable_temporal=True, condition_adapter_config=ADAPTER)
PIPE = dict(common_config={"T": 4},
            training_config={"max_reference_frame": 1},
            inference_config={"sample_steps": 4,
                              "do_classifier_free_guidance": True,
                              "guidance_scale": 2.0},
            blank_code=[0])


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("temporal,extra", [(False, False), (True, True)])
def test_bidirectional_transformer(temporal, extra):
    rng = np.random.default_rng(10 + temporal)
    b, frames, grid = 1, 3, 4
    n, l = b * frames, grid * grid
    cfg = dict(n_e=32, e_dim=E_DIM, img_size=(grid, grid), hidden_dim=16,
               depth=3, num_heads=2, window_size=2, enable_temporal=temporal,
               use_extra_embedding=extra,
               condition_adapter_config=dict(ADAPTER, downscale_factor=8))
    x = rng.standard_normal((n, l, E_DIM)).astype(np.float32)
    ids = rng.integers(0, 32, (n, l))
    ids[rng.uniform(size=(n, l)) < 0.4] = -1
    ctx = rng.uniform(size=(n, 8 * grid * 2, 8 * grid * 2, 3)) \
        .astype(np.float32)
    jm = JaxBT(**cfg)
    kw = dict(batch_size=b, num_frames=frames)
    params = flax_init(jm, jnp.asarray(x), jnp.asarray(ids),
                       jnp.asarray(ctx), seed=11, **kw)
    want = jm.apply(params, jnp.asarray(x), jnp.asarray(ids),
                    jnp.asarray(ctx), **kw)
    tm = load(BidirectionalTransformer(**cfg), params)
    got = tm(t(x), t(ids), t(ctx), **kw).detach()
    assert got.shape == (n, l, 32)
    assert rel(got, want) < REL_TOL
    # the context residuals matter
    no_ctx = tm(t(x), t(ids), None, **kw).detach()
    assert rel(no_ctx, got) > 100 * REL_TOL

    back = lidar_flax_from_state_dict(tm.state_dict())
    leaves = dict(jax.tree_util.tree_leaves_with_path(back))
    flat = jax.tree_util.tree_leaves_with_path(params)
    assert len(flat) == len(leaves)
    for path, leaf in flat:
        np.testing.assert_array_equal(leaves[path], leaf)
    # the perturbation's draws move the logits only where the model
    # enables it (its ids are held against JAX in
    # test_torch_maskgit_train.py)
    draws = {"uniform": torch.zeros(n, l),
             "choice": torch.ones(n, l, dtype=torch.long)}
    perturbed = tm(t(x), t(ids), t(ctx), perturb_draws=draws, **kw).detach()
    assert torch.equal(perturbed, got)  # enable_perturbation is off
    tm.enable_perturbation = True
    perturbed = tm(t(x), t(ids), t(ctx), perturb_draws=draws, **kw).detach()
    if extra:
        assert rel(perturbed, got) > 10 * REL_TOL
    else:
        assert torch.equal(perturbed, got)  # no extra embedding to perturb


def test_gumbel_max_is_jax_categorical(monkeypatch):
    """The reproduction the pipeline tests rely on, and the port's sampler
    given that noise, with and without CFG, blank codes and chunking."""
    key = jax.random.PRNGKey(5)
    logits = jax.random.normal(jax.random.PRNGKey(6), (2, 7, 50)) * 3
    noise = jax.random.gumbel(key, logits.shape)
    ours = jnp.argmax(logits + noise, -1)
    np.testing.assert_array_equal(np.asarray(ours),
                                  np.asarray(jax.random.categorical(key,
                                                                    logits)))
    flat = t(noise).reshape(-1, 50)
    ids, prob = tpipe.sample_tokens(t(logits), lambda r0, r1: flat[r0:r1])
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ours))
    want = np.take_along_axis(np.asarray(jax.nn.softmax(logits, -1)),
                              np.asarray(ours)[..., None], -1)[..., 0]
    np.testing.assert_allclose(prob.numpy(), want, rtol=1e-5)

    both = torch.cat([t(logits) * 0.5, t(logits)])
    blank = torch.tensor([0, 3])
    whole = tpipe.sample_tokens(both, lambda r0, r1: flat[r0:r1],
                                guidance=2.5, blank=blank)
    monkeypatch.setattr(tpipe, "SAMPLE_CHUNK_ELEMS", 50 * 3)
    chunked = tpipe.sample_tokens(both, lambda r0, r1: flat[r0:r1],
                                  guidance=2.5, blank=blank)
    assert torch.equal(whole[0], chunked[0])
    assert torch.equal(whole[1], chunked[1])
    assert not bool(torch.isin(whole[0], blank).any())


def jax_decode_draws(key, steps: int, n: int, l: int):
    """``_iterative_decode``'s draws from ``key`` (``lidar_maskgit.py:307``):
    per step the categorical's Gumbel noise and the confidence uniforms."""
    out = {"sample": [], "confidence": []}
    for _ in range(steps):
        key, k_sample, k_gumbel = jax.random.split(key, 3)
        out["sample"].append(t(jax.random.gumbel(k_sample, (n, l, N_E))))
        out["confidence"].append(t(jax.random.uniform(k_gumbel, (n, l))))
    return out


def jax_sigmoid_draws(key, shape):
    """``gumbel_sigmoid``'s two uniforms from ``key``."""
    return (t(jax.random.uniform(key, shape)),
            t(jax.random.uniform(jax.random.fold_in(key, 1), shape)))


@pytest.fixture(scope="module")
def pipes():
    key = jax.random.PRNGKey(0)
    b, frames, n_pts = 1, 3, 64
    batch = {
        "lidar_points": jax.random.uniform(key, (b, frames, n_pts, 3),
                                           minval=-3, maxval=3),
        "lidar_points_mask": jnp.ones((b, frames, n_pts), bool),
        "3dbox_bev_images": jax.random.uniform(
            jax.random.fold_in(key, 1), (b * frames, IMG * 8, IMG * 8, 3)),
    }
    jvqm = jvq.VQPointCloud(
        voxelizer=JaxVoxelizer(**VOX),
        vector_quantizer=jvq.VectorQuantizer(n_e=N_E, e_dim=E_DIM),
        lidar_encoder=jvq.VQEncoder(**ENC),
        lidar_decoder=jvq.VQDecoder(**DEC))
    vq_params = flax_init(jvqm, batch["lidar_points"],
                          batch["lidar_points_mask"], seed=1,
                          render_rays=False)
    jmodel = JaxBT(**MODEL)
    jp = jpipe.MaskGITPipeline(jvqm, jmodel, optimizer_config={"lr": 1e-3},
                               **PIPE)
    jp.load_vq_params(vq_params)
    _, code, idx = jp.tokenize(batch["lidar_points"],
                               batch["lidar_points_mask"])
    params = flax_init(jmodel, code, idx,
                       jpipe.get_maskgit_conditions(batch), seed=2,
                       batch_size=b, num_frames=frames)

    tvqm = tvq.VQPointCloud(Voxelizer(**VOX), tvq.VectorQuantizer(N_E, E_DIM),
                            tvq.VQEncoder(**ENC), tvq.VQDecoder(**DEC))
    tp = tpipe.MaskGITPipeline(tvqm, load(BidirectionalTransformer(**MODEL),
                                          params), **PIPE)
    tp.load_vq_params(to_torch(lidar_state_dict_from_flax(vq_params)))
    tbatch = {k: t(v) for k, v in batch.items()}
    return jp, params, tp, batch, tbatch


@pytest.mark.parametrize("task", ["generation", "prediction"])
def test_inference_pipeline_matches_jax(pipes, task):
    jp, params, tp, batch, tbatch = pipes
    rng = jax.random.PRNGKey(3)
    want = jp.inference_pipeline(params, batch, rng, task_type=task,
                                 num_reference_frame=1)
    n, l = 3, (IMG // 8) ** 2
    k1, k2 = jax.random.split(jax.random.fold_in(rng, 99))
    shape = (n, ZC, IMG, IMG)
    draws = {"decode": jax_decode_draws(rng, 4, n, l),
             "pred_voxels": jax_sigmoid_draws(k1, shape),
             "vq_voxels": jax_sigmoid_draws(k2, shape)}
    got = tp.inference_pipeline(tbatch, task_type=task,
                                num_reference_frame=1, draws=draws)
    for key in ("pred_indices", "gt_voxels", "pred_voxels", "vq_voxels"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    assert (got["pred_indices"] >= 0).all()
    if task == "prediction":  # the reference frame is pinned
        _, _, gt_idx = tp.tokenize(tbatch["lidar_points"],
                                   tbatch["lidar_points_mask"])
        assert torch.equal(got["pred_indices"][0, 0], gt_idx[0])


def test_rollout_matches_jax(pipes):
    """A 2-window rollout (3 frames, windows of 2, 1 reference frame)."""
    jp, params, tp, batch, tbatch = pipes
    rng = jax.random.PRNGKey(4)
    want = jp.autoregressive_inference_pipeline(
        params, batch, rng, num_reference_frame=1, window_frames=2)
    draws, key = [], rng
    for _ in range(2):
        key, k_win = jax.random.split(key)
        key, k_vox = jax.random.split(key)
        draws.append({"decode": jax_decode_draws(k_win, 4, 2,
                                                 (IMG // 8) ** 2),
                      "voxels": jax_sigmoid_draws(k_vox, (2, ZC, IMG, IMG))})
    got = tp.autoregressive_inference_pipeline(
        tbatch, num_reference_frame=1, window_frames=2, draws=draws)
    for key in ("pred_indices", "pred_voxels", "gt_voxels", "pred_points",
                "pred_points_mask"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    assert got["pred_voxels"].shape == (1, 3, ZC, IMG, IMG)
    with pytest.raises(ValueError, match="2 windows"):
        tp.autoregressive_inference_pipeline(
            tbatch, num_reference_frame=1, window_frames=2, draws=draws[:1])


def test_generator_draws_run(pipes):
    """Without given draws the pipeline draws from the generator: seeded
    runs repeat, finite and binary."""
    _, _, tp, _, tbatch = pipes
    runs = [tp.inference_pipeline(
        tbatch, generator=torch.Generator().manual_seed(0)) for _ in range(2)]
    assert torch.equal(runs[0]["pred_indices"], runs[1]["pred_indices"])
    assert set(runs[0]["pred_voxels"].unique().tolist()) <= {0.0, 1.0}


def test_training_parts_raise(pipes):
    """Training is ported (held against JAX in test_torch_maskgit_train.py):
    ``random_mask`` masks ``l − floor(l (1 − ratio))`` tokens a row. The
    evaluation is ported too (held against JAX in
    test_torch_eval_pipelines.py); it takes the JAX signature, the model
    first, and refuses a model that is not the pipeline's."""
    tp = pipes[2]
    noise = torch.rand(3, 10, generator=torch.Generator().manual_seed(0))
    mask = tpipe.random_mask(noise, torch.tensor(0.35))
    assert mask.sum(1).tolist() == [4, 4, 4]
    with pytest.raises(ValueError, match="its own model"):
        tp.evaluate_pipeline(torch.nn.Linear(1, 1), [])
    with np.errstate(invalid="ignore"):
        assert set(tp.evaluate_pipeline(tp.model, [], metrics={
            "voxel_iou": tpipe.VoxelIoU()})) == {"evaluation/voxel_iou"}


@pytest.mark.parametrize("name", ["lidar_maskgit_layout_ns",
                                  "lidar_maskgit_temporal_vq80k_layout_ns"])
def test_configs_build(name):
    cfg = json.loads((REPO / "configs/lidar" / f"{name}.json").read_text())
    with torch.device("meta"):
        pipe = create_instance_from_config(cfg["pipeline"])
    assert isinstance(pipe, tpipe.MaskGITPipeline)
    assert isinstance(pipe.model, BidirectionalTransformer)
    temporal = "temporal" in name
    assert (pipe.model.blocks.temporal_blocks is not None) == temporal
    assert (pipe.model.extra_embedding is not None) == temporal
    assert pipe.vq.vector_quantizer.n_e == (80000 if temporal else 2048)
