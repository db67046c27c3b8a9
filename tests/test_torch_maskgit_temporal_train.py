"""The port's temporal MaskGIT training
(``configs/lidar/lidar_maskgit_temporal_vq80k_layout_ns.json`` in small:
``enable_temporal``, ``task_type_ratio`` 0.5, several frames) against the
JAX package's on the CPU in fp32, on JAX's own draws rebuilt from its key
splits with ``n = b·t`` and ``max_ref = min(t, 3)``
(``opendwm_tpu/pipelines/lidar_maskgit.py:192-251``).

Two keys, one a task: the prediction task (masks on the frames after
each sample's ``n_ref`` reference frames only) and the generation task.
Two builds: batch 2 without the layout adapter, and batch 1 with it and a
raster a frame (the config's model). Both packages fail to train the
layout model at batch 2: the dropout masks are one a sample, the rasters
one a frame (``opendwm_tpu/pipelines/lidar_maskgit.py:96``), so ``where``
cannot broadcast them; the port raises as JAX does.
Bars as ``tests/test_torch_maskgit_train.py``'s: the loss and ``acc_0``
within 1e-5 relative, every gradient (the temporal blocks' included,
each non-zero) through ``check_lidar_grads``, one AdamW step through
``check_lidar_update``. The training loss applies the head a chunk of
masked rows at a time (``head_cross_entropy``); with chunks of a few rows
it equals the head over every row followed by ``smoothed_cross_entropy``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendwm_tpu.models import vq_point_cloud as jvq
from opendwm_tpu.models.maskgit import BidirectionalTransformer as JaxBT
from opendwm_tpu.ops.voxelize import Voxelizer as JaxVoxelizer
from opendwm_tpu.pipelines import lidar_maskgit as jpipe
from opendwm_tpu.pipelines.ctsd import TrainState as JaxTrainState
from opendwm_tpu_torch.convert import lidar_state_dict_from_flax, to_torch
from opendwm_tpu_torch.models import vq_point_cloud as tvq
from opendwm_tpu_torch.models.maskgit import BidirectionalTransformer
from opendwm_tpu_torch.ops.voxelize import Voxelizer
from opendwm_tpu_torch.pipelines import lidar_maskgit as tpipe

from test_torch_maskgit_train import (
    ADAPTER,
    DEC,
    E_DIM,
    ENC,
    IMG,
    LOSS_TOL,
    N_E,
    VOX,
    jax_training_draws,
    t,
)
from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    check_lidar_grads,
    check_lidar_update,
    flax_init,
    lidar_float64_grads,
    load_lidar,
    one_torch_thread,
    recording_tx,
    rel,
)

T = 3
L = (IMG // 8) ** 2
BUILDS = {"batch2": (2, False), "layout": (1, True)}  # (batch, adapter)
MODEL = dict(n_e=N_E, e_dim=E_DIM, img_size=(IMG // 8, IMG // 8),
             hidden_dim=16, depth=2, num_heads=2, window_size=2,
             use_extra_embedding=True, enable_temporal=True,
             enable_perturbation=True, perturbation_ratio=0.3,
             perturbation_topk=3, condition_adapter_config=ADAPTER)
TRAIN = {"task_type_ratio": 0.5, "max_reference_frame": 3,
         "3dbox_condition_ratio": 0.8, "hdmap_condition_ratio": 0.8,
         "max_norm_for_grad_clip": 1.0}
OPT = {"lr": 1e-4, "weight_decay": 0.01}  # the temporal config's


def _key_for(prediction: bool) -> jax.Array:
    """The first PRNGKey whose task draw selects the prediction task (or
    the generation task) at ``task_type_ratio`` and whose cosine mask
    ratio keeps 30-70% of the tokens visible: with every token masked each
    frame of a sample is the same mask token, so the temporal attention
    mixes equal values and its queries and keys get no gradient."""
    for seed in range(100):
        key = jax.random.PRNGKey(seed)
        k_task, k_ratio = jax.random.split(key, 7)[:2]
        ratio = np.cos(float(jax.random.uniform(k_ratio, ())) * np.pi / 2)
        if (float(jax.random.uniform(k_task, ())) <
                TRAIN["task_type_ratio"]) == prediction and \
                0.3 < ratio < 0.7:
            return key
    raise AssertionError("no key in 100 selects the task")


KEYS = {"prediction": _key_for(True), "generation": _key_for(False)}


def _draws(key, b: int) -> dict:
    return jax_training_draws(key, b, b * T, L, min(T, 3), 3)


def _batch(b: int, layout: bool) -> dict:
    rng = np.random.default_rng(11)
    pts = rng.uniform(-8, 8, (b, T, 256, 3)).astype(np.float32)
    pts[..., 2] = rng.uniform(-1, 1, (b, T, 256))
    batch = {"lidar_points": pts,
             "lidar_points_mask": np.ones((b, T, 256), bool)}
    if layout:
        batch["3dbox_bev_images"] = rng.uniform(
            size=(b * T, IMG, IMG, 3)).astype(np.float32)
    return batch


@functools.cache
def _build(name: str):
    b, layout = BUILDS[name]
    model = MODEL if layout else dict(MODEL, condition_adapter_config=None)
    batch = _batch(b, layout)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jvqm = jvq.VQPointCloud(
        voxelizer=JaxVoxelizer(**VOX),
        vector_quantizer=jvq.VectorQuantizer(n_e=N_E, e_dim=E_DIM,
                                             cosine_similarity=True),
        lidar_encoder=jvq.VQEncoder(**ENC),
        lidar_decoder=jvq.VQDecoder(**DEC))
    vq_params = flax_init(jvqm, jb["lidar_points"][:, :1],
                          jb["lidar_points_mask"][:, :1], seed=1,
                          render_rays=False)
    jmodel = JaxBT(**model)
    jp = jpipe.MaskGITPipeline(jvqm, jmodel, training_config=TRAIN,
                               optimizer_config=OPT)
    jp.load_vq_params(vq_params)
    # the init takes shapes only: no tokenization (~7 s eager)
    params = flax_init(jmodel, jnp.zeros((b * T, L, E_DIM)),
                       jnp.zeros((b * T, L), jnp.int32),
                       jpipe.get_maskgit_conditions(jb), seed=2,
                       batch_size=b, num_frames=T)

    def port(dtype=torch.float32):
        vqm = tvq.VQPointCloud(
            Voxelizer(**VOX), tvq.VectorQuantizer(N_E, E_DIM,
                                                  cosine_similarity=True),
            tvq.VQEncoder(**ENC), tvq.VQDecoder(**DEC))
        tp = tpipe.MaskGITPipeline(
            vqm, load_lidar(BidirectionalTransformer(**model), params),
            training_config=TRAIN, optimizer_config=OPT)
        tp.load_vq_params(to_torch(lidar_state_dict_from_flax(vq_params)))
        tp.vq.to(dtype)
        tp.model.to(dtype)
        return tp

    return jp, params, port, batch, jb, b


@pytest.fixture(scope="module", params=list(BUILDS))
def pipes(request):
    return _build(request.param)


def _temporal_grads(model) -> dict:
    return {n: p.grad for n, p in model.named_parameters()
            if n.startswith("blocks.temporal_blocks.")}


@pytest.mark.parametrize("task", list(KEYS))
def test_temporal_loss_and_gradients(pipes, task):
    jp, params, port, batch, jb, b = pipes
    key = KEYS[task]
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        jp.loss_fn, has_aux=True))(params, jb, key)
    tp = port()
    tb = {k: t(v) for k, v in batch.items()}
    draws = _draws(key, b)
    assert (float(draws["task"]) < TRAIN["task_type_ratio"]) == \
        (task == "prediction")
    tloss, tmetrics = tp.loss_from_draws(tb, draws)
    for k in ("ce_loss", "acc_0"):
        want = float(metrics[k])
        assert abs(float(tmetrics[k].detach()) - want) \
            <= LOSS_TOL * max(abs(want), 1e-6), k
    assert float(loss) > 0
    tloss.backward()
    temporal = _temporal_grads(tp.model)
    assert len(temporal) == 2 * 17  # 2 temporal blocks of 17 tensors
    for name, g in temporal.items():
        assert float(g.abs().max()) > 0, name

    def loss64(dtype):
        tp64 = port(dtype)
        b64 = {k: v.to(dtype) if v.is_floating_point() else v
               for k, v in tb.items()}
        return tp64.loss_from_draws(b64, draws)[0], tp64.model

    check_lidar_grads(tp.model, grads, lidar_float64_grads(loss64))


def test_prediction_masks_only_future_frames(pipes, monkeypatch):
    """Under the prediction task the head sees masked rows of the frames
    after each sample's reference frames only; under generation, of every
    frame."""
    _, _, port, batch, _, b = pipes
    tb = {k: t(v) for k, v in batch.items()}
    seen = {}

    def spy(features, head, labels, mask, eps=tpipe.LABEL_SMOOTHING):
        seen["mask"] = mask.reshape(b, T, L)
        return head_cross_entropy(features, head, labels, mask, eps)

    head_cross_entropy = tpipe.head_cross_entropy
    monkeypatch.setattr(tpipe, "head_cross_entropy", spy)
    for task, key in KEYS.items():
        draws = _draws(key, b)
        port().loss_from_draws(tb, draws)
        per_frame = seen["mask"].sum(-1)
        for s, n_ref in enumerate(draws["ref"].tolist()):
            if task == "prediction":  # n_ref = T leaves no future frame
                assert 1 <= n_ref <= min(T, 3)
                assert int(per_frame[s, :n_ref].sum()) == 0, task
                assert bool((per_frame[s, n_ref:] > 0).all()), task
            else:
                assert bool((per_frame[s] > 0).all()), task


def test_chunked_head_is_the_head_over_every_row(pipes, monkeypatch):
    """``head_cross_entropy`` in chunks of three rows against the head over
    every row and ``smoothed_cross_entropy``: the loss, ``acc_0`` and the
    gradients of the features and of the head."""
    _, _, port, _, _, b = pipes
    rng = np.random.default_rng(4)
    tp = port()
    feats = t(rng.standard_normal((b * T, L, 16)).astype(np.float32))
    labels = t(rng.integers(0, N_E, (b * T, L)))
    mask = t(rng.uniform(size=(b * T, L)) < 0.6)
    results = []
    for chunked in (False, True):
        f = feats.clone().requires_grad_()
        tp.model.pred.zero_grad(set_to_none=True)
        if chunked:
            monkeypatch.setattr(tpipe, "CE_CHUNK_ELEMS", 3 * N_E)
            loss, acc = tpipe.head_cross_entropy(f, tp.model.pred, labels,
                                                 mask)
        else:
            loss, acc = tpipe.smoothed_cross_entropy(tp.model.pred(f),
                                                     labels, mask)
        loss.backward()
        results.append((float(loss.detach()), float(acc), f.grad,
                        tp.model.pred.weight.grad, tp.model.pred.bias.grad))
    (l0, a0, *g0), (l1, a1, *g1) = results
    assert abs(l1 - l0) <= 1e-6 * l0 and a1 == pytest.approx(a0, rel=1e-6)
    for mine, ref in zip(g1, g0):
        assert rel(mine, ref) < 1e-5
    # no masked row: a loss of 0 that still back-propagates
    f = feats.clone().requires_grad_()
    loss, acc = tpipe.head_cross_entropy(f, tp.model.pred, labels,
                                         torch.zeros_like(mask))
    loss.backward()
    assert float(loss.detach()) == 0.0 and float(acc) == 0.0
    assert float(f.grad.abs().max()) == 0.0


def test_temporal_train_step_update():
    """One AdamW step of the config's model (the layout build) on the
    prediction task's draws."""
    jp, params, port, batch, jb, b = _build("layout")
    key = KEYS["prediction"]
    jparams = jax.tree.map(jnp.asarray, params)
    tx = recording_tx(jp.tx)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                           opt_state=tx.init(jparams["params"]))
    saved, jp.tx = jp.tx, tx
    try:
        jstate, jmetrics = jax.jit(jp._train_step_impl)(jstate, jb, key)
    finally:
        jp.tx = saved
    grads = {"params": jstate.opt_state[0]}
    tp = port()
    state = tp.init_state()
    state, metrics = tp.train_step(
        state, {k: t(v) for k, v in batch.items()}, draws=_draws(key, b))
    assert state.step == 1
    assert abs(float(metrics["ce_loss"]) - float(jmetrics["ce_loss"])) \
        <= LOSS_TOL * float(jmetrics["ce_loss"])
    check_lidar_update(tp.model, params["params"], jstate.params["params"],
                       grads["params"], OPT["lr"],
                       TRAIN["max_norm_for_grad_clip"])
    # the generator's draws over several frames
    gen = tp.draw_training_randoms({k: t(v) for k, v in batch.items()},
                                   torch.Generator().manual_seed(0))
    assert gen["mask"].shape == (b * T, L)
    assert 1 <= int(gen["ref"].min()) and int(gen["ref"].max()) <= min(T, 3)


def test_layout_at_batch_two_fails_in_both_packages():
    """The reference's oddity: a dropout mask a sample against a raster a
    frame cannot broadcast once b > 1 and t > 1, in JAX and in the port
    alike."""
    batch = _batch(2, True)
    masks = {"box_condition_mask": np.array([True, False])}
    with pytest.raises(ValueError, match="broadcast"):
        jpipe.get_maskgit_conditions(
            {k: jnp.asarray(v) for k, v in batch.items()},
            **{k: jnp.asarray(v) for k, v in masks.items()})
    with pytest.raises(RuntimeError, match="size of tensor"):
        tpipe.get_maskgit_conditions(
            {k: t(v) for k, v in batch.items()},
            **{k: t(v) for k, v in masks.items()})
