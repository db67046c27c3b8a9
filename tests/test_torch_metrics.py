"""The port's metrics (``opendwm_tpu_torch/metrics``) against the JAX
package's, on the CPU, on the inputs of ``tests/test_metrics.py`` and
``tests/test_ray_metrics.py`` and random ones.

Bars: the Fréchet state's sums within 1e-6 relative, distances within
1e-5 relative on distinct sets and below 1e-6 absolute on identical ones,
the proxy features within 1e-6; Chamfer, MMD, JSD, IoU, diff and the ray
errors within 1e-5. The JAX package asks for float64 Fréchet sums but
never enables x64, so JAX keeps them in float32; the port keeps them in
float32 too (pinned below).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendwm_tpu.metrics import frechet as jfr
from opendwm_tpu.metrics import general as jgen
from opendwm_tpu.metrics import pc_metrics as jpc
from opendwm_tpu.metrics import ray_metrics as jray
from opendwm_tpu.metrics import voxel_metrics as jvox
from opendwm_tpu_torch.metrics import frechet, general, pc_metrics, \
    ray_metrics, voxel_metrics

from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

SUM_REL, DIST_REL, SAME_ABS, FEAT_TOL, TOL = 1e-6, 1e-5, 1e-6, 1e-6, 1e-5


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _feed(metric, chunks_real, chunks_fake, to):
    state = metric.init()
    for c in chunks_real:
        state = metric.update(state, to(c), real=True)
    for c in chunks_fake:
        state = metric.update(state, to(c), real=False)
    return state


CASES = {
    # test_metrics.py's streaming case: 300 real vs 200 fake, 8 features
    "streaming": lambda rng: (np.split(rng.standard_normal((300, 8)), 3),
                              np.split(rng.standard_normal((200, 8)) * 1.3
                                       + 0.5, 2), 0.0),
    # its mean shift: ≈ 8 x 2²
    "mean_shift": lambda rng: ([rng.standard_normal((500, 8))],
                               [rng.standard_normal((500, 8)) + 2.0], 0.0),
    # its rank-deficient case, with shrinkage
    "rank_deficient": lambda rng: ([rng.standard_normal((6, 64))],
                                   [rng.standard_normal((6, 64)) + 1.0], 1e-3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_frechet_state_and_distance_match_jax(case):
    real, fake, shrinkage = CASES[case](np.random.default_rng(1))
    dim = real[0].shape[1]
    jm = jfr.FrechetDistance(dim, shrinkage=shrinkage)
    pm = frechet.FrechetDistance(dim, shrinkage=shrinkage)
    js = _feed(jm, real, fake, jnp.asarray)
    ps = _feed(pm, real, fake, torch.from_numpy)
    for side in ("real", "fake"):
        for part in ("sum", "cov_sum"):
            got = getattr(ps, f"{side}_{part}")
            want = getattr(js, f"{side}_{part}")
            assert got.dtype == torch.float32 and want.dtype == jnp.float32
            assert _rel(got, want) <= SUM_REL, (side, part)
        assert getattr(ps, f"{side}_n") == int(getattr(js, f"{side}_n"))
    want = jm.compute(js)
    assert want > 1.0
    assert abs(pm.compute(ps) - want) / abs(want) <= DIST_REL


@pytest.mark.parametrize("shrinkage", [0.0, 1e-3])
def test_frechet_of_identical_sets_is_zero(shrinkage):
    feats = np.random.default_rng(0).standard_normal((500, 16))
    m = frechet.FrechetDistance(16, shrinkage=shrinkage)
    state = _feed(m, [feats], [feats.copy()], torch.from_numpy)
    assert abs(m.compute(state)) < SAME_ABS
    assert abs(frechet.frechet_distance(feats, feats.copy())) < SAME_ABS
    assert frechet.frechet_distance(feats, feats + 1) == pytest.approx(
        jfr.frechet_distance(feats, feats + 1), rel=DIST_REL)


@pytest.mark.parametrize("batch,x64", [(4, False), (2, True)],
                         ids=["48_samples", "12_samples_x64"])
def test_paired_metric_and_proxy_features_match_jax(batch, x64):
    """48 images of 32 proxy features: against the JAX package as it runs.
    12 images (fewer than the features, no shrinkage): the covariance
    product is singular and its eigenvalues depend on the precision; the
    JAX package's host step runs in float32 there (its float32 sums make
    float32 numpy means), 8e-5 from float64, so the port's float64 step is
    held against the JAX package under ``jax.enable_x64``, as it means to
    compute (``frechet.py:91-110``)."""
    rng = np.random.default_rng(2)
    real = rng.standard_normal((batch, 3, batch, 8, 8, 16)).astype(np.float32)
    fake = (rng.standard_normal(real.shape) * 1.2 + 0.3).astype(np.float32)
    pm = frechet.FrechetPairedMetric(32)
    with jax.enable_x64(x64):
        jm = jfr.FrechetPairedMetric(32)
        np.testing.assert_allclose(
            pm._default_features(torch.from_numpy(real)).numpy(),
            np.asarray(jm._default_features(jnp.asarray(real))),
            atol=FEAT_TOL)
        jm.update(jnp.asarray(real), jnp.asarray(fake))
        want = jm.compute()
    # the population standard deviation, as jnp.std
    feats = pm._default_features(torch.from_numpy(real))
    assert torch.allclose(feats[:, 16:], torch.from_numpy(real).reshape(
        -1, 8, 8, 16).std((1, 2), correction=0))
    pm.update(torch.from_numpy(real), torch.from_numpy(fake))
    assert abs(pm.compute() - want) / want <= DIST_REL
    pm.reset()
    assert pm.state.real_n == 0
    with pytest.raises(RuntimeError, match=">=2"):
        pm.compute()


def test_mean_metric_matches_jax():
    jm, pm = jgen.CustomMeanMetric(), general.CustomMeanMetric()
    for value in ([1.0, 3.0, np.nan], [np.inf, 2.5], 4.0):
        jm.update(value)
        pm.update(torch.tensor(value, dtype=torch.float64))
    assert pm.compute() == jm.compute() == pytest.approx(10.5 / 4)
    pm.reset()
    assert np.isnan(pm.compute())


def _clouds():
    rng = np.random.default_rng(0)
    out = {
        "identical": (rng.uniform(-10, 10, (100, 3)),) * 2 + (None, None),
        "offset": (np.zeros((4, 3)), np.tile([3.0, 0, 0], (4, 1)), None,
                   None),
        "clamp": (np.array([[0.0, 0, 0], [500.0, 0, 0]]),
                  np.array([[1.0, 0, 0]]), None, None),
        "outside": (np.zeros((8, 3)) + 1e8, np.zeros((8, 3)), None, None),
        "random_masked": (rng.uniform(-80, 80, (700, 3)) * [1, 1, 0.05],
                          rng.uniform(-80, 80, (1300, 3)) * [1, 1, 0.05],
                          rng.uniform(size=700) < 0.7,
                          rng.uniform(size=1300) < 0.6),
    }
    return {k: tuple(None if a is None else np.asarray(a, np.float32)
                     if a.dtype != bool else a for a in v)
            for k, v in out.items()}


@pytest.mark.parametrize("case", sorted(_clouds()))
@pytest.mark.parametrize("chunk", [None, 64], ids=["one_chunk", "chunks"])
def test_chamfer_matches_jax(case, chunk, monkeypatch):
    if chunk:
        monkeypatch.setattr(pc_metrics, "CHUNK_ELEMS", chunk * 1300)
    pred, gt, pm, gm = _clouds()[case]

    def j(x):
        return None if x is None else jnp.asarray(x)

    def t(x):
        return None if x is None else torch.from_numpy(x)

    want = float(jpc.chamfer_distance(j(pred), j(gt), j(pm), j(gm)))
    got = float(pc_metrics.chamfer_distance(t(pred), t(gt), t(pm), t(gm)))
    assert got == pytest.approx(want, rel=TOL, abs=TOL)
    for inner in (None, 30):
        jmet, pmet = jpc.PointCloudChamfer(inner), \
            pc_metrics.PointCloudChamfer(inner)
        jmet.update(j(pred), j(gt), j(pm), j(gm))
        pmet.update(t(pred), t(gt), t(pm), t(gm))
        want, got = jmet.compute(), pmet.compute()
        assert got == pytest.approx(want, rel=TOL, abs=TOL) or \
            (np.isnan(got) and np.isnan(want))


def test_directed_min_dists_infinite_without_targets():
    a = torch.zeros(3, 3)
    got = pc_metrics._directed_min_dists(a, torch.zeros(0, 3))
    assert torch.isinf(got).all()
    want = jpc._directed_min_dists(jnp.zeros((3, 3)), jnp.zeros((2, 3)),
                                   jnp.ones(3, bool), jnp.zeros(2, bool))
    assert np.isinf(np.asarray(want)).all()


def test_histogram_mmd_jsd_match_jax():
    rng = np.random.default_rng(0)
    pts = np.array([[0.0, 0.0, 0.0], [10.0, -10.0, 1.0], [1000.0, 0.0, 0.0],
                    [-80.0, 79.99, 0.0]], np.float32)
    np.testing.assert_array_equal(
        pc_metrics.point_cloud_to_histogram(torch.from_numpy(pts)).numpy(),
        np.asarray(jpc.point_cloud_to_histogram(jnp.asarray(pts))))
    clouds = [(rng.uniform(-50, 50, (64, 3)).astype(np.float32),
               rng.uniform(-60, 40, (80, 3)).astype(np.float32))
              for _ in range(3)]
    for jcls, pcls in ((jpc.PointCloudMMD, pc_metrics.PointCloudMMD),
                       (jpc.PointCloudJSD, pc_metrics.PointCloudJSD)):
        jm, pm = jcls(), pcls()
        for pred, gt in clouds:
            jm.update(jnp.asarray(pred), jnp.asarray(gt))
            pm.update(torch.from_numpy(pred), torch.from_numpy(gt))
        want = jm.compute()
        assert want > 0
        assert pm.compute() == pytest.approx(want, rel=TOL, abs=TOL)


def test_voxel_metrics_match_jax():
    rng = np.random.default_rng(3)
    gt = rng.uniform(size=(2, 3, 4, 8, 8)) < 0.3
    pred = rng.uniform(size=(2, 3, 4, 8, 8)) < 0.4
    gt[1, 2] = pred[1, 2] = False  # an empty union: NaN, counted as 0
    for jcls, pcls in ((jvox.VoxelIoU, voxel_metrics.VoxelIoU),
                       (jvox.VoxelDiff, voxel_metrics.VoxelDiff)):
        jm, pm = jcls(), pcls()
        for g, p in ((gt, pred), (gt[0, 0], pred[0, 0])):
            jm.update(g, p)
            pm.update(torch.from_numpy(g), torch.from_numpy(p))
        np.testing.assert_allclose(pm.values, jm.values, rtol=TOL)
        assert pm.compute() == pytest.approx(jm.compute(), rel=TOL)


def _ray_cases():
    rng = np.random.default_rng(0)
    pts = rng.uniform(1, 30, (64, 3))
    rng = np.random.default_rng(1)
    gt = np.stack([rng.uniform(5, 20, 64), rng.uniform(5, 20, 64),
                   rng.uniform(-3, 3, 64)], -1)
    rng = np.random.default_rng(2)
    cloud = rng.uniform(-40, 40, (300, 3)) * [1, 1, 0.1]
    return {"identical": (pts, pts, None, None),
            "scaled": (gt * 1.05, gt, None, None),
            "masked": (cloud[:150] + 0.3, cloud[150:],
                       rng.uniform(size=150) < 0.8,
                       rng.uniform(size=150) < 0.9)}


@pytest.mark.parametrize("case", sorted(_ray_cases()))
def test_ray_errors_match_jax(case):
    pred, gt, pm, gm = _ray_cases()[case]
    origin = np.array([0.5, -0.25, 0.1], np.float32) if case == "masked" \
        else np.zeros(3, np.float32)
    pred, gt = pred.astype(np.float32), gt.astype(np.float32)
    want = jray.compute_ray_errors(
        jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(origin),
        None if pm is None else jnp.asarray(pm),
        None if gm is None else jnp.asarray(gm))
    got = ray_metrics.compute_ray_errors(
        torch.from_numpy(pred), torch.from_numpy(gt),
        torch.from_numpy(origin),
        None if pm is None else torch.from_numpy(pm),
        None if gm is None else torch.from_numpy(gm))
    for g, w in zip(got, want):
        assert float(g) == pytest.approx(float(w), rel=TOL, abs=TOL)


def test_nanmedian_is_numpys():
    x = torch.tensor([3.0, float("nan"), 1.0, 4.0, 2.0])
    assert float(ray_metrics.nanmedian(x)) == float(np.nanmedian(x.numpy()))
    assert float(ray_metrics.nanmedian(x[:3])) == 2.0
    assert np.isnan(float(ray_metrics.nanmedian(torch.full((2,),
                                                           float("nan")))))
    az, el, d = ray_metrics.spherical_projection(torch.tensor([[0.0, 5, 0]]))
    assert (float(az), float(el), float(d)) == (0.0, 0.0, 5.0)
