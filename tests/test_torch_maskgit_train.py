"""The port's MaskGIT training (``opendwm_tpu_torch/models/maskgit.py``'s
``_perturb``, ``opendwm_tpu_torch/pipelines/lidar_maskgit.py``'s
``random_mask``, ``loss_from_draws`` and ``train_step``) against the JAX
package's on the CPU in fp32, on JAX's own draws rebuilt from its key
splits (``lidar_maskgit.py:197``, ``maskgit.py:243``).

Bars: ``random_mask`` and the perturbed ids equal JAX's bit for bit;
losses and ``acc_0`` within 1e-5 relative; each gradient within 1e-4 in
relative norm (or within twice JAX's own fp32 error where that exceeds
5e-5, see ``torch_port_helpers.check_lidar_grads``); one AdamW update as
``check_lidar_update`` holds it. The chunked cross-entropy and
perturbation equal the one-chunk forms. The configuration is the
full-width config's in small: one frame, the extra embedding with the
perturbation on, the layout adapter, layout dropout.
"""

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
from opendwm_tpu_torch.models import maskgit as tmaskgit
from opendwm_tpu_torch.models import vq_point_cloud as tvq
from opendwm_tpu_torch.models.maskgit import BidirectionalTransformer
from opendwm_tpu_torch.ops.voxelize import Voxelizer
from opendwm_tpu_torch.pipelines import lidar_maskgit as tpipe

from torch_port_helpers import (
    check_lidar_grads,
    check_lidar_update,
    flax_init,
    lidar_float64_grads,
    load_lidar,
    rel,
)

LOSS_TOL = 1e-5
IMG, ZC, N_E, E_DIM, B = 32, 8, 24, 12, 2
VOX = dict(x_min=-8.0, x_max=8.0, y_min=-8.0, y_max=8.0, step=0.5,
           z_min=-1.0, z_max=1.0, z_step=0.25)
ENC = dict(img_size=IMG, patch_size=8, in_chans=ZC, embed_dim=8,
           num_heads=2, depth=6, codebook_dim=E_DIM, window_size=2)
DEC = dict(ENC, depth=4, density_feats=4)
ADAPTER = dict(in_channels=3, channels=[16, 16], is_downblocks=[False, False],
               num_res_blocks=1, downscale_factor=8)
MODEL = dict(n_e=N_E, e_dim=E_DIM, img_size=(IMG // 8, IMG // 8),
             hidden_dim=16, depth=2, num_heads=2, window_size=2,
             use_extra_embedding=True, enable_perturbation=True,
             perturbation_ratio=0.3, perturbation_topk=3,
             condition_adapter_config=ADAPTER)
TRAIN = {"task_type_ratio": 0.0, "max_reference_frame": 3,
         "3dbox_condition_ratio": 0.5, "hdmap_condition_ratio": 0.5,
         "max_norm_for_grad_clip": 1.0}
OPT = {"lr": 1e-3, "weight_decay": 0.01}


def t(x):
    return torch.from_numpy(np.array(x))


def jax_training_draws(key, b, n, l, max_ref, topk) -> dict:
    """``MaskGITPipeline.loss_fn``'s draws from ``key``, as the port's
    ``draw_training_randoms`` returns them."""
    k_task, k_ratio, k_mask, k_ref, k_box, k_map, k_pert = \
        jax.random.split(key, 7)
    k1, k2 = jax.random.split(k_pert)
    return {
        "task": t(jax.random.uniform(k_task, ())),
        "ratio": t(jax.random.uniform(k_ratio, ())),
        "mask": t(jax.random.uniform(k_mask, (n, l))),
        "ref": t(jax.random.randint(k_ref, (b,), 1, max_ref + 1)),
        "box": t(jax.random.uniform(k_box, (b,))),
        "map": t(jax.random.uniform(k_map, (b,))),
        "perturb": {"uniform": t(jax.random.uniform(k1, (n, l))),
                    "choice": t(jax.random.randint(k2, (n, l), 0, topk))},
    }


@pytest.mark.parametrize("ratio", [0.0, 0.3, 0.9])
def test_random_mask_bit_for_bit(ratio):
    key = jax.random.PRNGKey(int(ratio * 10))
    want = jpipe.random_mask(key, (5, 37), jnp.float32(ratio))
    got = tpipe.random_mask(t(jax.random.uniform(key, (5, 37))),
                            torch.tensor(ratio))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    kept = int(np.floor(37 * (1 - np.float32(ratio))))
    assert int(got[0].sum()) == 37 - kept


def test_perturbation_ids(monkeypatch):
    rng = np.random.default_rng(0)
    jm = JaxBT(**dict(MODEL, condition_adapter_config=None))
    x_id = rng.integers(0, N_E, (3, 16))
    x_id[rng.uniform(size=x_id.shape) < 0.3] = -1
    table = rng.standard_normal((N_E, E_DIM)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = jm.apply({}, jnp.asarray(x_id), jnp.asarray(table), key,
                    method=jm._perturb)
    k1, k2 = jax.random.split(key)
    draws = {"uniform": t(jax.random.uniform(k1, x_id.shape)),
             "choice": t(jax.random.randint(k2, x_id.shape, 0, 3))}
    tm = BidirectionalTransformer(**dict(MODEL,
                                         condition_adapter_config=None))
    with torch.no_grad():
        tm.extra_embedding.weight.copy_(t(table))
    got = tm._perturb(t(x_id), draws)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    moved = got != t(x_id)
    assert 0 < int(moved.sum()) and bool((t(x_id)[moved] != -1).all())
    monkeypatch.setattr(tmaskgit, "PERTURB_CHUNK_ELEMS", 2 * N_E)
    assert torch.equal(tm._perturb(t(x_id), draws), got)


@pytest.fixture(scope="module")
def pipes():
    rng = np.random.default_rng(1)
    pts = rng.uniform(-8, 8, (B, 1, 256, 3)).astype(np.float32)
    pts[..., 2] = rng.uniform(-1, 1, (B, 1, 256))
    raster = rng.uniform(size=(B, IMG, IMG, 3)).astype(np.float32)
    batch = {"lidar_points": pts,
             "lidar_points_mask": np.ones((B, 1, 256), bool),
             "3dbox_bev_images": raster}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jvqm = jvq.VQPointCloud(
        voxelizer=JaxVoxelizer(**VOX),
        vector_quantizer=jvq.VectorQuantizer(n_e=N_E, e_dim=E_DIM,
                                             cosine_similarity=True),
        lidar_encoder=jvq.VQEncoder(**ENC),
        lidar_decoder=jvq.VQDecoder(**DEC))
    vq_params = flax_init(jvqm, jb["lidar_points"], jb["lidar_points_mask"],
                          seed=1, render_rays=False)
    jmodel = JaxBT(**MODEL)
    jp = jpipe.MaskGITPipeline(jvqm, jmodel, training_config=TRAIN,
                               optimizer_config=OPT)
    jp.load_vq_params(vq_params)
    _, code, idx = jp.tokenize(jb["lidar_points"], jb["lidar_points_mask"])
    params = flax_init(jmodel, code, idx, jpipe.get_maskgit_conditions(jb),
                       seed=2, batch_size=B, num_frames=1)

    def port(dtype=torch.float32):
        vqm = tvq.VQPointCloud(
            Voxelizer(**VOX), tvq.VectorQuantizer(N_E, E_DIM,
                                                  cosine_similarity=True),
            tvq.VQEncoder(**ENC), tvq.VQDecoder(**DEC))
        tp = tpipe.MaskGITPipeline(
            vqm, load_lidar(BidirectionalTransformer(**MODEL), params),
            training_config=TRAIN, optimizer_config=OPT)
        tp.load_vq_params(to_torch(lidar_state_dict_from_flax(vq_params)))
        tp.vq.to(dtype)
        tp.model.to(dtype)
        return tp

    return jp, params, port, batch, jb


def _draws(key):
    l = (IMG // 8) ** 2
    return jax_training_draws(key, B, B, l, 1, 3)


@pytest.mark.parametrize("seed", [0, 3])
def test_loss_and_gradients(pipes, seed, monkeypatch):
    jp, params, port, batch, jb = pipes
    key = jax.random.PRNGKey(seed)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        jp.loss_fn, has_aux=True))(params, jb, key)
    tp = port()
    tb = {k: t(v) for k, v in batch.items()}
    draws = _draws(key)
    tloss, tmetrics = tp.loss_from_draws(tb, draws)
    for k in ("ce_loss", "acc_0"):
        want = float(metrics[k])
        assert abs(float(tmetrics[k].detach()) - want) \
            <= LOSS_TOL * max(abs(want), 1e-6), k
    assert float(loss) > 0
    tloss.backward()

    def loss64(dtype):
        tp64 = port(dtype)
        b64 = {k: v.to(dtype) if v.is_floating_point() else v
               for k, v in tb.items()}
        return tp64.loss_from_draws(b64, draws)[0], tp64.model

    check_lidar_grads(tp.model, grads, lidar_float64_grads(loss64))

    # chunks of two rows: the same loss and gradients
    grads1 = {n: p.grad.clone() for n, p in tp.model.named_parameters()}
    tp.model.zero_grad(set_to_none=True)
    monkeypatch.setattr(tpipe, "CE_CHUNK_ELEMS", 2 * N_E)
    monkeypatch.setattr(tmaskgit, "PERTURB_CHUNK_ELEMS", 2 * N_E)
    loss2, m2 = tp.loss_from_draws(tb, draws)
    loss2.backward()
    assert abs(float(loss2.detach()) - float(tloss.detach())) \
        <= 1e-6 * float(tloss.detach())
    assert float(m2["acc_0"]) == float(tmetrics["acc_0"])
    for n, p in tp.model.named_parameters():
        zero = float(grads1[n].abs().max()) == 0.0
        assert (zero and float(p.grad.abs().max()) == 0.0) or \
            rel(p.grad, grads1[n]) < 1e-5, n


def test_smoothed_cross_entropy_is_the_one_hot_form():
    """The closed form against ``−Σ target · log_softmax`` with the one-hot
    target, in float64: loss and gradient."""
    rng = np.random.default_rng(5)
    logits = t(rng.standard_normal((2, 9, 30))).requires_grad_()
    labels = t(rng.integers(0, 30, (2, 9)))
    mask = t(rng.uniform(size=(2, 9)) < 0.5)
    loss, acc = tpipe.smoothed_cross_entropy(logits, labels, mask)
    loss.backward()
    ref_logits = logits.detach().clone().requires_grad_()
    target = torch.nn.functional.one_hot(labels, 30).double() * 0.9 + 0.1 / 30
    ce = -(target * torch.log_softmax(ref_logits, -1)).sum(-1)
    m = mask.double()
    ref = (ce * m).sum() / (m.sum() + 1e-5)
    ref.backward()
    assert abs(float(loss.detach()) - float(ref.detach())) < 1e-12
    assert rel(logits.grad, ref_logits.grad) < 1e-12
    hits = ((logits.argmax(-1) == labels) & mask).sum()
    assert float(acc) == pytest.approx(float(hits) / (float(m.sum()) + 1e-5))


def test_train_step_update(pipes):
    jp, params, port, batch, jb = pipes
    key = jax.random.PRNGKey(7)
    jparams = jax.tree.map(jnp.asarray, params)
    grads = jax.jit(jax.grad(lambda p: jp.loss_fn(p, jb, key)[0]))(jparams)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                           opt_state=jp.tx.init(jparams["params"]))
    jstate, jmetrics = jax.jit(jp._train_step_impl)(jstate, jb, key)
    tp = port()
    state = tp.init_state()
    assert not any(p.requires_grad for p in tp.vq.parameters())
    state, metrics = tp.train_step(
        state, {k: t(v) for k, v in batch.items()}, draws=_draws(key))
    assert state.step == 1
    assert abs(float(metrics["ce_loss"]) - float(jmetrics["ce_loss"])) \
        <= LOSS_TOL * float(jmetrics["ce_loss"])
    check_lidar_update(tp.model, params["params"], jstate.params["params"],
                       grads["params"], OPT["lr"],
                       TRAIN["max_norm_for_grad_clip"])
    # the generator's draws run: the same draws, the same loss
    gen_draws = tp.draw_training_randoms(
        {k: t(v) for k, v in batch.items()}, torch.Generator().manual_seed(0))
    assert gen_draws["mask"].shape == (B, (IMG // 8) ** 2)
    assert int(gen_draws["ref"].min()) >= 1
