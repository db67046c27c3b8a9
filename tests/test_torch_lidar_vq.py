"""The port's LiDAR tokenizer (``opendwm_tpu_torch/ops/voxelize.py``,
``opendwm_tpu_torch/models/vq_point_cloud.py``) against the JAX package's
(``opendwm_tpu/ops/voxelize.py``, ``opendwm_tpu/models/vq_point_cloud.py``)
on the CPU in fp32.

- The voxelizer equal bit for bit, with points out of range on every axis
  and masked points; voxel centers and ``voxels_to_points`` too.
- ``WindowAttention`` with and without the shifted-window mask (at ws 2,
  the tiny-sequence attention, and ws 8, the plain one), ``SwinBlock``,
  ``PatchMerging``, ``VQEncoder`` and ``VQDecoder`` (both branches; the
  transposed conv's kernel flip) within 1e-3 in relative norm
  ``||port - jax|| / ||jax||``.
- The quantizer's indices equal JAX's in the Euclidean and the cosine
  mode; an index may differ only where the two candidates' distances are
  within 1e-6 (none does on these draws).
- ``VQPointCloud.encode``: voxels bit for bit, codes and indices as above.
- The weight bridge: flax → port → flax bit for bit, the ``ConvTranspose``
  kernel and the relative position tables included; a serving tree
  without the DVGO density MLP loads and maps back with the port's own.

The JAX side's parameters come from ``jax.eval_shape`` of its init, drawn
with numpy (``torch_port_helpers.flax_init``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendwm_tpu.models import vq_point_cloud as jvq
from opendwm_tpu.ops import voxelize as jvox
from opendwm_tpu_torch.convert import lidar_flax_from_state_dict
from opendwm_tpu_torch.models import vq_point_cloud as tvq
from opendwm_tpu_torch.ops import voxelize as tvox

from torch_port_helpers import flax_init, load_lidar as load, rel

REL_TOL = 1e-3
TIE_TOL = 1e-6
VOXELIZER = dict(x_min=-8.0, x_max=8.0, y_min=-8.0, y_max=8.0, step=0.5,
                 z_min=-1.0, z_max=1.0, z_step=0.25)  # 8 x 32 x 32
ENCODER = dict(img_size=32, patch_size=8, in_chans=8, embed_dim=16,
               num_heads=2, depth=6, codebook_dim=12, window_size=2)
DECODER = dict(ENCODER, depth=4, density_feats=4)


def points(seed: int, shape, lo=-10.0, hi=10.0):
    """Points past the grid on every axis, and a mask with holes."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(lo, hi, shape + (3,)).astype(np.float32)
    pts[..., 2] = rng.uniform(-1.4, 1.4, shape).astype(np.float32)
    mask = rng.uniform(size=shape) > 0.2
    return pts, mask


def test_voxelizer_is_bit_exact():
    pts, mask = points(0, (2, 3, 4000))
    pts[0, 0, :8] = [[-8.0, -8.0, -1.0], [8.0, 0, 0], [0, 8.0, 0],
                     [0, 0, 1.0], [7.999, 7.999, 0.999], [-8.001, 0, 0],
                     [0, -8.001, 0], [0, 0, -1.001]]
    mask[0, 0, :8] = True
    want = jvox.Voxelizer(**VOXELIZER)(jnp.asarray(pts), jnp.asarray(mask))
    got = tvox.Voxelizer(**VOXELIZER)(torch.from_numpy(pts),
                                      torch.from_numpy(mask))
    assert got.shape == (2, 3, 8, 32, 32) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < float(got.sum()) < mask.sum()  # some points fell outside
    only_masked = tvox.Voxelizer(**VOXELIZER)(
        torch.from_numpy(pts), torch.zeros(mask.shape, dtype=torch.bool))
    assert float(only_masked.sum()) == 0.0


def test_voxelizer_at_voxel_boundaries():
    """At the configs' grid, points within 3 ulps of every voxel boundary
    fall in JAX's voxels, and some of them in another voxel under a product
    with the step's fp32 reciprocal (what the card's check looks for)."""
    from opendwm_tpu_torch.perf import lidar_tiny

    cfg = lidar_tiny.CONFIG_GRID
    pts = lidar_tiny.boundary_points(tvox.Voxelizer(**cfg))
    mask = torch.ones(pts.shape[:2], dtype=torch.bool)
    want = jvox.Voxelizer(**cfg)(jnp.asarray(pts.numpy()),
                                 jnp.asarray(mask.numpy()))
    got = tvox.Voxelizer(**cfg)(pts, mask)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    gaps = lidar_tiny.boundary_gaps(torch.device("cpu"))
    assert gaps["boundary_voxels_equal"]
    assert gaps["boundary_reciprocal_flips"] > 0


@pytest.mark.parametrize("cfg", [
    VOXELIZER,
    dict(x_min=-50.0, x_max=50.0, y_min=-50.0, y_max=50.0, step=0.15625,
         z_min=-3.0, z_max=2.6, z_step=0.14),  # the configs' grid
])
def test_voxel_centers_and_points(cfg):
    jv, tv = jvox.Voxelizer(**cfg), tvox.Voxelizer(**cfg)
    assert tv.grid_shape == jv.grid_shape
    np.testing.assert_array_equal(tv.voxel_coordinates().numpy(),
                                  np.asarray(jv.voxel_coordinates()))
    if cfg is VOXELIZER:
        vox = (np.random.default_rng(1).uniform(size=(2, *jv.grid_shape))
               > 0.7).astype(np.float32)
        jp, jm = jvox.voxels_to_points(jnp.asarray(vox), jv)
        tp, tm = tvox.voxels_to_points(torch.from_numpy(vox), tv)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


@pytest.mark.parametrize("ws,grid,shift", [(2, 8, 0), (2, 8, 1), (8, 16, 0),
                                           (8, 16, 4)])
def test_swin_block(ws, grid, shift):
    """A Swin block (window attention with the relative bias, shifted with
    the −100 mask when ``shift``) and its window attention alone."""
    dim, heads = 16, 2
    rng = np.random.default_rng(ws + shift)
    x = rng.standard_normal((2, grid * grid, dim)).astype(np.float32)
    jblock = jvq.SwinBlock(heads=heads, window_size=ws, shift=shift,
                           input_resolution=(grid, grid))
    params = flax_init(jblock, jnp.asarray(x), seed=ws + shift)
    want = jblock.apply(params, jnp.asarray(x))
    tblock = load(tvq.SwinBlock(dim, heads, ws, shift, (grid, grid)), params)
    got = tblock(torch.from_numpy(x)).detach()
    assert rel(got, want) < REL_TOL

    wins = rng.standard_normal((2 * (grid // ws) ** 2, ws * ws, dim)) \
        .astype(np.float32)
    mask = jvq.shifted_window_mask(grid, grid, ws, shift) if shift else None
    jattn = jvq.WindowAttention(heads=heads, window_size=ws)
    aparams = {"params": params["params"]["attn"]}
    want = jattn.apply(aparams, jnp.asarray(wins),
                       None if mask is None else jnp.asarray(mask))
    got = tblock.attn(torch.from_numpy(wins),
                      None if mask is None else torch.from_numpy(mask))
    assert rel(got.detach(), want) < REL_TOL
    if shift:
        assert (mask == -100.0).any() and (mask == 0.0).any()


def test_patch_merging():
    dim, grid = 8, 6
    x = np.random.default_rng(3).standard_normal((2, grid * grid, dim)) \
        .astype(np.float32)
    jm = jvq.PatchMerging(input_resolution=(grid, grid))
    params = flax_init(jm, jnp.asarray(x), seed=3)
    tm = load(tvq.PatchMerging(dim, (grid, grid)), params)
    got = tm(torch.from_numpy(x)).detach()
    assert got.shape == (2, 9, 2 * dim)
    assert rel(got, jm.apply(params, jnp.asarray(x))) < REL_TOL


@pytest.fixture(scope="module")
def vq_pair():
    """A tiny ``VQPointCloud`` of each package on the same weights."""
    pts, mask = points(4, (1, 2, 3000))
    jmodel = jvq.VQPointCloud(
        voxelizer=jvox.Voxelizer(**VOXELIZER),
        vector_quantizer=jvq.VectorQuantizer(n_e=32, e_dim=12),
        lidar_encoder=jvq.VQEncoder(**ENCODER),
        lidar_decoder=jvq.VQDecoder(**DECODER))
    params = flax_init(jmodel, jnp.asarray(pts), jnp.asarray(mask), seed=4,
                       render_rays=False)
    tmodel = tvq.VQPointCloud(
        tvox.Voxelizer(**VOXELIZER), tvq.VectorQuantizer(32, 12),
        tvq.VQEncoder(**ENCODER), tvq.VQDecoder(**DECODER))
    return jmodel, params, load(tmodel, params), pts, mask


def test_encoder_and_decoder(vq_pair):
    jmodel, params, tmodel, pts, mask = vq_pair
    p = params["params"]
    vox = np.asarray(jmodel.voxelizer(jnp.asarray(pts), jnp.asarray(mask)))
    vox = vox.reshape(-1, *vox.shape[2:])
    want = jmodel.lidar_encoder.apply({"params": p["lidar_encoder"]},
                                      jnp.asarray(vox))
    got = tmodel.lidar_encoder(torch.from_numpy(vox.copy())).detach()
    assert got.shape == (2, 16, 12)
    assert rel(got, want) < REL_TOL

    tokens = np.random.default_rng(5).standard_normal((2, 16, 12)) \
        .astype(np.float32)
    jd, jv = jmodel.lidar_decoder.apply({"params": p["lidar_decoder"]},
                                        jnp.asarray(tokens))
    td, tv = tmodel.lidar_decoder(torch.from_numpy(tokens), density=True)
    assert tv.shape == (2, 8, 32, 32) and td.shape == (2, 4, 2, 32, 32)
    assert rel(tv.detach(), jv) < REL_TOL
    assert rel(td.detach(), jd) < REL_TOL
    none, tv2 = tmodel.lidar_decoder(torch.from_numpy(tokens))
    assert none is None and torch.equal(tv2, tv)


def test_transposed_conv_needs_the_flip(vq_pair):
    """The decoder's 2x up-sampling: flax's ``ConvTranspose`` (no
    ``transpose_kernel``) is torch's with the kernel flipped in space; the
    unflipped kernel gives another function."""
    jmodel, params, _, _, _ = vq_pair
    kernel = np.asarray(params["params"]["lidar_decoder"]["upsample"]
                        ["kernel"])
    bias = np.asarray(params["params"]["lidar_decoder"]["upsample"]["bias"])
    x = np.random.default_rng(6).standard_normal((1, 4, 4, kernel.shape[2])) \
        .astype(np.float32)
    import flax.linen as nn
    want = nn.ConvTranspose(kernel.shape[3], (2, 2), strides=(2, 2)).apply(
        {"params": {"kernel": kernel, "bias": bias}}, jnp.asarray(x))
    conv = tvq.ConvTranspose2d(kernel.shape[2], kernel.shape[3], 2, stride=2)
    conv.bias.data = torch.from_numpy(bias)
    for flipped, ok in ((True, True), (False, False)):
        w = kernel.transpose(2, 3, 0, 1)
        conv.weight.data = torch.from_numpy(
            np.ascontiguousarray(w[:, :, ::-1, ::-1] if flipped else w))
        got = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1).detach()
        assert (rel(got, want) < REL_TOL) == ok


def _check_indices(got, want, dist):
    """Indices equal, or the two candidates within ``TIE_TOL`` by the
    JAX side's distance (``dist``: (rows, n_e), smaller is nearer)."""
    got, want = np.asarray(got).ravel(), np.asarray(want).ravel()
    rows = np.nonzero(got != want)[0]
    for r in rows:
        assert abs(dist[r, got[r]] - dist[r, want[r]]) <= TIE_TOL
    return len(rows)


@pytest.mark.parametrize("cosine", [False, True])
def test_quantizer_indices(cosine):
    rng = np.random.default_rng(7 + cosine)
    n_e, e_dim = 64, 12
    z = rng.standard_normal((3, 40, e_dim)).astype(np.float32)
    emb = rng.standard_normal((n_e, e_dim)).astype(np.float32) * 0.5
    jq = jvq.VectorQuantizer(n_e=n_e, e_dim=e_dim, cosine_similarity=cosine)
    params = {"params": {"embedding": jnp.asarray(emb)}}
    jz, (jc, jb), jidx = jq.apply(params, jnp.asarray(z))
    tq = tvq.VectorQuantizer(n_e, e_dim, cosine_similarity=cosine)
    tq.embedding.data = torch.from_numpy(emb)
    tz, (tc, tb), tidx = tq(torch.from_numpy(z))
    codes = np.asarray(jq.apply(params, jnp.arange(n_e), method=jq.lookup))
    flat = z.reshape(-1, e_dim).astype(np.float64)
    if cosine:
        flat = flat / np.linalg.norm(flat, axis=-1, keepdims=True)
        dist = -flat @ codes.T
    else:
        dist = ((flat[:, None] - codes[None]) ** 2).sum(-1)
    assert _check_indices(tidx, jidx, dist) == 0
    assert tidx.shape == (3, 40)
    assert rel(tz.detach(), jz) < REL_TOL
    for t_loss, j_loss in ((tc, jc), (tb, jb)):
        assert abs(t_loss.item() - float(j_loss)) <= \
            1e-5 * max(1.0, abs(float(j_loss)))
    np.testing.assert_allclose(tq.lookup(torch.arange(n_e)).detach().numpy(),
                               codes, rtol=1e-6, atol=1e-7)


def test_quantizer_chunks_change_nothing(monkeypatch):
    """The nearest-code search in row chunks gives the unchunked indices."""
    q = tvq.VectorQuantizer(50, 8, cosine_similarity=True)
    z = torch.randn(2, 37, 8, generator=torch.Generator().manual_seed(0))
    whole = q(z)[2]
    monkeypatch.setattr(tvq, "QUANTIZER_CHUNK_ELEMS", 50 * 5)
    assert torch.equal(q(z)[2], whole)


def test_vq_encode(vq_pair):
    jmodel, params, tmodel, pts, mask = vq_pair
    jvox_, jz, _, jidx = jmodel.apply(params, jnp.asarray(pts),
                                      jnp.asarray(mask), method=jmodel.encode)
    tvox_, tz, _, tidx = tmodel.encode(torch.from_numpy(pts),
                                       torch.from_numpy(mask))
    np.testing.assert_array_equal(tvox_.numpy(), np.asarray(jvox_))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    assert rel(tz.detach(), jz) < REL_TOL
    out = tmodel(torch.from_numpy(pts), torch.from_numpy(mask),
                 render_rays=False)
    assert out["lidar_voxel"].shape == (1, 2, 8, 32, 32)
    assert "depth_loss" not in out
    # with the rays rendered (training; held against JAX in
    # test_torch_lidar_tokenizer_train.py): finite losses, a depth a ray
    rendered = tmodel(torch.from_numpy(pts), torch.from_numpy(mask))
    assert rendered["pred_depth"].shape == (1, 2, 3000)
    assert torch.isfinite(rendered["depth_loss"]).item()
    assert torch.isfinite(rendered["sdf_loss"]).item()
    torch.testing.assert_close(rendered["lidar_voxel"], out["lidar_voxel"])


def test_weight_bridge_round_trip(vq_pair):
    _, params, tmodel, _, _ = vq_pair
    back = lidar_flax_from_state_dict(tmodel.state_dict())
    flat_in = jax.tree_util.tree_leaves_with_path(params)
    flat_out = dict(jax.tree_util.tree_leaves_with_path(back))
    # a serving tree holds no density MLP (flax makes it only when a
    # forward renders); the port's module keeps its own, which maps back
    extra = {jax.tree_util.keystr(p) for p in flat_out} \
        - {jax.tree_util.keystr(p) for p, _ in flat_in}
    assert extra == {f"['params']['density_mlp_{i}']['{leaf}']"
                     for i in (1, 2) for leaf in ("kernel", "bias")}
    for path, leaf in flat_in:
        np.testing.assert_array_equal(np.asarray(flat_out[path]),
                                      np.asarray(leaf))
    names = set(tmodel.state_dict())
    assert "lidar_decoder.upsample.weight" in names
    assert "lidar_encoder.stage_1.blocks.1.attn." \
        "relative_position_bias_table" in names
