"""The port's DVGO renderer (``opendwm_tpu_torch/ops/dvgo.py``) against the
JAX package's (``opendwm_tpu/ops/dvgo.py``) on the CPU in fp32.

Bars: outputs within 1e-5 relative (``rel``: ``||port - jax|| /
||jax||``), gradients within 1e-4 in relative norm.

- ``trilinear_grid_query`` in both JAX modes ("block" and "corner8"), on
  points at cell corners, just inside and outside cell edges and outside
  the box on every axis;
- ``ray_aabb``, ``alphas_to_weights`` and ``raw_to_alpha``;
- the renderer's depth, its feature output, ``loss_sdf`` and
  ``alphainv_last`` with padded zero rays (which add nothing to the SDF
  sum but count in its mean, as in the JAX package), with and without
  offsets; the
  chunked, checkpointed ``render`` equal to the one-shot call;
- gradients of a loss of all three outputs with respect to the grid and
  the density MLP's weights, one-shot and chunked.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendwm_tpu.ops import dvgo as jd
from opendwm_tpu_torch.ops import dvgo as td

from torch_port_helpers import rel

OUT_TOL = 1e-5
GRAD_TOL = 1e-4
BOX_MIN, BOX_MAX = (-4.0, -4.0, -1.0), (4.0, 4.0, 1.0)
GRID = (4, 6, 10, 12)  # (C, D, H, W)


def t(x):
    return torch.from_numpy(np.array(x))


def edge_points(rng) -> np.ndarray:
    """Cell corners, points one ulp either side of cell edges, uniform
    points and points past the box on every axis."""
    c, d, h, w = GRID
    lo, hi = np.array(BOX_MIN, np.float32), np.array(BOX_MAX, np.float32)
    cells = np.array([w - 1, h - 1, d - 1], np.float32)
    idx = rng.integers(0, cells.astype(int) + 1, (40, 3)).astype(np.float32)
    corners = lo + idx / cells * (hi - lo)
    near = np.concatenate([np.nextafter(corners, np.float32(np.inf)),
                           np.nextafter(corners, np.float32(-np.inf))])
    uniform = rng.uniform(lo, hi, (60, 3)).astype(np.float32)
    outside = rng.uniform(lo - 1.0, hi + 1.0, (60, 3)).astype(np.float32)
    return np.concatenate([corners, near, uniform, outside]).astype(
        np.float32)


@pytest.mark.parametrize("mode", ["block", "corner8"])
def test_trilinear_grid_query(mode):
    rng = np.random.default_rng(0)
    grid = rng.standard_normal(GRID).astype(np.float32)
    pts = edge_points(rng).reshape(4, -1, 3)
    want = jd.trilinear_grid_query(jnp.asarray(grid), jnp.asarray(pts),
                                   BOX_MIN, BOX_MAX, mode=mode)
    got = td.trilinear_grid_query(t(grid), t(pts), BOX_MIN, BOX_MAX,
                                  mode=mode)
    assert got.shape == (4, pts.shape[1], GRID[0])
    assert rel(got, want) < OUT_TOL
    # a grid with a unit depth falls back to the corner gathers
    flat = grid[:, :1]
    want = jd.trilinear_grid_query(jnp.asarray(flat), jnp.asarray(pts),
                                   BOX_MIN, BOX_MAX, mode=mode)
    got = td.trilinear_grid_query(t(flat), t(pts), BOX_MIN, BOX_MAX,
                                  mode=mode)
    assert rel(got, want) < OUT_TOL


def test_ray_aabb_alphas_and_raw_to_alpha():
    rng = np.random.default_rng(1)
    o = rng.uniform(-2, 2, (50, 3)).astype(np.float32)
    d = rng.standard_normal((50, 3)).astype(np.float32)
    d[:5, 0] = 0.0  # axis-parallel rays
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    lo, hi = np.array(BOX_MIN, np.float32), np.array(BOX_MAX, np.float32)
    for w, g in zip(jd.ray_aabb(jnp.asarray(o), jnp.asarray(d), lo, hi),
                    td.ray_aabb(t(o), t(d), t(lo), t(hi))):
        assert rel(g, w) < OUT_TOL
    alpha = rng.uniform(0, 1, (7, 30)).astype(np.float32)
    for w, g in zip(jd.alphas_to_weights(jnp.asarray(alpha)),
                    td.alphas_to_weights(t(alpha))):
        assert rel(g, w) < OUT_TOL
    raw = rng.uniform(-30, 30, (200,)).astype(np.float32)
    assert rel(td.raw_to_alpha(t(raw), -2.0, 0.5),
               jd.raw_to_alpha(jnp.asarray(raw), -2.0, 0.5)) < OUT_TOL


def _mlp_weights(rng):
    c = GRID[0]
    return (rng.standard_normal((c, 8)).astype(np.float32) * 0.7,
            rng.standard_normal(8).astype(np.float32) * 0.1,
            rng.standard_normal((8,)).astype(np.float32))


def _jax_mlp(w1, b1, w2):
    return lambda f: jnp.maximum(f @ w1 + b1, 0.0) @ w2 - 1.0


def _torch_mlp(w1, b1, w2):
    return lambda f: torch.relu(f @ w1 + b1) @ w2 - 1.0


def _rays(rng, n=48):
    rays = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    rays[:, 2] = rng.uniform(-1.5, 1.5, n)
    rays[-4:] = 0.0  # padded rays
    return rays


RENDER = dict(xyz_min=BOX_MIN, xyz_max=BOX_MAX, stepsize=0.1, max_steps=70)


@pytest.mark.parametrize("feat_render,offsets,mode", [
    (False, False, "block"), (True, False, "block"),
    (False, True, "corner8")])
def test_renderer_outputs(feat_render, offsets, mode, monkeypatch):
    rng = np.random.default_rng(2)
    grid = rng.standard_normal(GRID).astype(np.float32)
    w = _mlp_weights(rng)
    rays = _rays(rng)
    off = rng.uniform(-0.05, 0.05, (48, 70, 3)).astype(np.float32) \
        if offsets else None
    want = jd.DVGORenderer(**RENDER, query_mode=mode)(
        _jax_mlp(*map(jnp.asarray, w)), jnp.zeros((48, 3)),
        jnp.asarray(rays), jnp.asarray(grid), feat_render=feat_render,
        offsets=None if off is None else jnp.asarray(off))
    renderer = td.DVGORenderer(**RENDER, query_mode=mode)
    args = (_torch_mlp(*map(t, w)), torch.zeros(48, 3), t(rays), t(grid))
    kw = dict(feat_render=feat_render,
              offsets=None if off is None else t(off))
    got = renderer(*args, **kw)
    assert got[0].shape == ((48, GRID[0]) if feat_render else (48,))
    for g, w_ in zip(got, want):
        assert rel(g, w_) < OUT_TOL
    # a padded zero ray adds nothing to the SDF sum but counts in its mean
    per_ray = renderer._rays(args[0], args[1], args[2],
                             td.channel_last(args[3]), GRID[1:],
                             feat_render, kw["offsets"])[1]
    assert torch.all(per_ray[-4:] == 0) and torch.all(per_ray[:-4] > 0)
    assert float(got[1]) == pytest.approx(float(per_ray.sum()) / 48,
                                          rel=1e-6)
    monkeypatch.setattr(td, "RENDER_CHUNK_SAMPLES", 70 * 10)  # 5 chunks
    chunked = renderer.render(*args, **kw)
    for g, w_ in zip(chunked, want):
        assert rel(g, w_) < OUT_TOL


@pytest.mark.parametrize("chunk", [None, 70 * 16])
def test_renderer_gradients(chunk, monkeypatch):
    rng = np.random.default_rng(3)
    grid = rng.standard_normal(GRID).astype(np.float32)
    w = _mlp_weights(rng)
    rays = _rays(rng)

    def jax_loss(g, w1, b1, w2):
        depth, sdf, last = jd.DVGORenderer(**RENDER)(
            _jax_mlp(w1, b1, w2), jnp.zeros((48, 3)), jnp.asarray(rays), g)
        return jnp.sum(depth * jnp.linspace(0.5, 1.5, 48)) + 3.0 * sdf \
            + jnp.sum(last)

    want = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(
        jnp.asarray(grid), *map(jnp.asarray, w))
    params = [t(grid).requires_grad_()] + [t(x).requires_grad_() for x in w]
    renderer = td.DVGORenderer(**RENDER)
    if chunk is not None:
        monkeypatch.setattr(td, "RENDER_CHUNK_SAMPLES", chunk)
        call = renderer.render
    else:
        call = renderer
    depth, sdf, last = call(_torch_mlp(*params[1:]), torch.zeros(48, 3),
                            t(rays), params[0])
    loss = (depth * torch.linspace(0.5, 1.5, 48)).sum() + 3.0 * sdf \
        + last.sum()
    loss.backward()
    for p, g in zip(params, want):
        assert float(np.abs(np.asarray(g)).max()) > 0
        assert rel(p.grad, g) < GRAD_TOL
