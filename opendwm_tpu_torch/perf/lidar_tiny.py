"""Tiny LiDAR serving paths on a device against the same paths on the CPU,
and the checks of the voxelizer and the quantizer's code search that
``chip_smoke.py`` also runs at the configs' sizes.

Each ``*_gaps`` function builds a tiny fp32 model on the CPU from a seed,
copies it to ``dev`` and runs both on the same inputs and draws (made on
the CPU). It returns a dict whose keys say how it is gated: ``*_rel`` a
relative norm ``||dev - cpu|| / ||cpu||`` (within 1e-3), ``*_equal`` a
bit-for-bit agreement, ``*_gap`` a float64 score gap between two codes
(within ``TIE_TOL``: a tie). ``chip_smoke.py`` gates its LiDAR phases on
them before it runs them at full width, and ``tests/test_torch_lidar_cuda.py``
asserts the same on the card.

- ``maskgit_gaps``: the voxelizer at the configs' grid on points at voxel
  boundaries, the tokenizer (voxels bit for bit, features, code indices
  equal up to ties), the MaskGIT transformer's logits (spatial, or
  temporal with the extra embedding) with the layout context and the
  decoder's voxel logits, each from the device's own codes, and
  ``inference_pipeline`` fed one set of draws (the share of equal code
  indices: fp32 rounding can flip a near-tie, and a flip moves the later
  steps, so it is reported, not gated);
- ``dit_gaps``: a DiT with temporal ``rowwise`` branches whose t·gw = 144
  tokens reach K1 on the card, the tokenizer's latents, and
  ``LidarDiffusionPipeline.generate`` with the device's own reference
  frame on given noise and uniforms;
- ``nearest_gaps``: ``VectorQuantizer.nearest`` as it runs, in chunks,
  against one unchunked call and against float64 scores, at any size.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from opendwm_tpu_torch import ops
from opendwm_tpu_torch.models import vq_point_cloud as vq
from opendwm_tpu_torch.models.maskgit import BidirectionalTransformer
from opendwm_tpu_torch.models.mmdit import DiTCrossviewTemporal
from opendwm_tpu_torch.ops.voxelize import Voxelizer
from opendwm_tpu_torch.perf.measure import rel_err
from opendwm_tpu_torch.pipelines.lidar_diffusion import LidarDiffusionPipeline
from opendwm_tpu_torch.pipelines.lidar_maskgit import MaskGITPipeline
from opendwm_tpu_torch.schedulers import FlowMatchEulerScheduler

TIE_TOL = 1e-6  # two codes this close by a float64 score are a tie
# the voxelizer of the configs in configs/lidar/: 40 x 640 x 640, steps
# whose reciprocals are not exact in fp32
CONFIG_GRID = dict(x_min=-50.0, x_max=50.0, y_min=-50.0, y_max=50.0,
                   step=0.15625, z_min=-3.0, z_max=2.6, z_step=0.14)
VOXELIZER = dict(x_min=-8.0, x_max=8.0, y_min=-8.0, y_max=8.0, step=0.5,
                 z_min=-1.0, z_max=1.0, z_step=0.25)  # 8 x 32 x 32
ENCODER = dict(img_size=32, patch_size=8, in_chans=8, embed_dim=16,
               num_heads=2, depth=6, codebook_dim=16, window_size=2)
N_E, FRAMES, POINTS = 64, 3, 2000
ADAPTER = dict(in_channels=6, channels=[32, 32], is_downblocks=[True, False],
               num_res_blocks=1, downscale_factor=16)
# t = 4 frames of 4 x 72 latents, gh x gw = 2 x 36 patches: rowwise
# sequences of 144 tokens, which K1 takes (a multiple of 128 would go to K7)
ROWWISE_FRAMES, ROWWISE_LATENT = 4, (4, 72)
ROWWISE_DIT = dict(
    patch_size=2, num_layers=2, attention_head_dim=64, num_attention_heads=2,
    in_channels=8, out_channels=8, joint_attention_dim=16,
    caption_projection_dim=128, pooled_projection_dim=16,
    pos_embed_max_size=40, sample_size=72, dual_attention_layers=(),
    enable_temporal=True, temporal_attention_type="rowwise",
    temporal_block_layers=(0, 1), qk_norm_on_additional_modules="rms_norm",
    condition_image_adapter_config=dict(
        in_channels=6, channels=[128, 128], is_downblocks=[True, False],
        num_res_blocks=1, downscale_factor=8, use_zero_convs=True))


def _tokenizer(e_dim: int = 16, cosine: bool = False) -> vq.VQPointCloud:
    return vq.VQPointCloud(
        Voxelizer(**VOXELIZER),
        vq.VectorQuantizer(N_E, e_dim, cosine_similarity=cosine),
        vq.VQEncoder(**dict(ENCODER, codebook_dim=e_dim)),
        vq.VQDecoder(**dict(ENCODER, codebook_dim=e_dim, depth=4,
                            density_feats=4)))


def _rasters(g, frames: int, size: int) -> dict:
    def raster():
        on = torch.rand(frames, size, size, 3, generator=g) < 0.25
        return torch.rand(frames, size, size, 3, generator=g) * on

    return {"3dbox_bev_images": raster(), "hdmap_bev_images": raster()}


def lidar_batch(g, frames: int, size: int) -> dict:
    """Points past the grid on every axis (all valid) and rasters."""
    pts = (torch.rand(1, frames, POINTS, 3, generator=g) - 0.5) * 20
    pts[..., 2] *= 0.12
    return {"lidar_points": pts,
            "lidar_points_mask": torch.ones(1, frames, POINTS,
                                            dtype=torch.bool),
            **_rasters(g, frames, size)}


def _on(tree, dev):
    return {k: v.to(dev) if isinstance(v, torch.Tensor) else v
            for k, v in tree.items()}


def _decode_draws(g, steps: int, n: int, l: int, n_e: int) -> dict:
    return {"sample": [-torch.log(-torch.log(
        torch.rand(n, l, n_e, generator=g).clamp(min=1e-38)))
        for _ in range(steps)],
        "confidence": [torch.rand(n, l, generator=g) for _ in range(steps)]}


def tiny_maskgit(temporal: bool, seed: int = 0) -> MaskGITPipeline:
    """A tiny fp32 MaskGIT pipeline on the CPU: 4 x 4 tokens, 64 codes (the
    temporal one with the extra embedding and cosine codes), the layout
    adapter, 4 steps with CFG and blank code 0."""
    torch.manual_seed(seed)
    model = BidirectionalTransformer(
        N_E, 16, (4, 4), hidden_dim=32, depth=2, num_heads=2,
        enable_temporal=temporal, use_extra_embedding=temporal,
        condition_adapter_config=ADAPTER)
    return MaskGITPipeline(
        _tokenizer(cosine=temporal), model, common_config={"T": 4},
        inference_config={"sample_steps": 4, "use_blank_code": True,
                          "do_classifier_free_guidance": True,
                          "guidance_scale": 3.0},
        blank_code=[0])


def code_scores(cosine: bool, z: torch.Tensor,
                codes64: torch.Tensor) -> torch.Tensor:
    """float64 scores of ``z``'s rows against ``codes64`` (larger is
    nearer): the cosine similarity, or minus the squared distance."""
    z = z.double()
    if cosine:
        return z / z.norm(dim=-1, keepdim=True).clamp(min=1e-12) @ codes64.T
    return 2 * z @ codes64.T - (z * z).sum(-1, keepdim=True) \
        - (codes64 * codes64).sum(-1)


@torch.no_grad()
def flip_gap(quantizer: vq.VectorQuantizer, flat: torch.Tensor,
             got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest float64 score gap, by ``flat``'s rows (rows, e_dim),
    between the codes ``got`` and ``want`` pick for a row (0 where they
    agree)."""
    codes64 = quantizer.codes().double()
    gap, step = 0.0, max(1, 2 ** 27 // codes64.shape[0])
    for r0 in range(0, flat.shape[0], step):
        s = code_scores(quantizer.cosine_similarity, flat[r0:r0 + step],
                        codes64)
        pair = s.gather(1, torch.stack([got[r0:r0 + step],
                                        want[r0:r0 + step]], 1))
        gap = max(gap, float((pair[:, 0] - pair[:, 1]).abs().max()))
    return gap


@torch.no_grad()
def nearest_gaps(quantizer: vq.VectorQuantizer, flat: torch.Tensor) -> dict:
    """``quantizer.nearest`` over ``flat`` (rows, e_dim) as it runs, in
    chunks of ``QUANTIZER_CHUNK_ELEMS`` similarities, against one unchunked
    call and against the best codes by float64 scores: {"chunks",
    "rows_differ" (chunked vs unchunked), "chunk_flip_gap" (their largest
    float64 score gap), "shortfall_gap" (the most by which a chosen code's
    float64 score falls short of its row's best)}."""
    codes = quantizer.codes()
    codes = codes.to(torch.promote_types(flat.dtype, codes.dtype))
    chunk_elems = vq.QUANTIZER_CHUNK_ELEMS
    chunked = quantizer.nearest(flat, codes)
    vq.QUANTIZER_CHUNK_ELEMS = flat.shape[0] * codes.shape[0]
    try:
        whole = quantizer.nearest(flat, codes)
    finally:
        vq.QUANTIZER_CHUNK_ELEMS = chunk_elems
    codes64 = codes.double()
    shortfall, step = 0.0, max(1, 2 ** 27 // codes64.shape[0])
    for r0 in range(0, flat.shape[0], step):
        s = code_scores(quantizer.cosine_similarity, flat[r0:r0 + step],
                        codes64)
        mine = s.gather(1, chunked[r0:r0 + step, None])[:, 0]
        shortfall = max(shortfall, float((s.max(-1).values - mine).max()))
    rows = max(1, chunk_elems // codes.shape[0])
    return {"chunks": -(-flat.shape[0] // rows),
            "rows_differ": int((chunked != whole).sum()),
            "chunk_flip_gap": flip_gap(quantizer, flat, chunked, whole),
            "shortfall_gap": shortfall}


def boundary_points(voxelizer: Voxelizer, ulps: int = 3) -> torch.Tensor:
    """(1, N, 3) fp32 points within ``ulps`` fp32 steps of every voxel
    boundary of ``voxelizer``, one axis at a time (the other two at voxel
    centres, spread over the grid)."""
    axes = ((voxelizer.x_min, voxelizer.step, voxelizer.width),
            (voxelizer.y_min, voxelizer.step, voxelizer.height),
            (voxelizer.z_min, voxelizer.z_step, voxelizer.depth))
    groups = []
    for a, (lo, step, cells) in enumerate(axes):
        edge = (lo + np.arange(cells + 1) * step).astype(np.float32)
        near = [edge]
        for direction in (-np.inf, np.inf):
            v = edge
            for _ in range(ulps):
                v = np.nextafter(v, np.float32(direction))
                near.append(v)
        near = np.concatenate(near)
        pts = np.empty((near.size, 3), np.float32)
        for b, (blo, bstep, bcells) in enumerate(axes):
            centre = (np.arange(near.size) * 7919) % bcells
            pts[:, b] = blo + (centre + 0.5) * bstep
        pts[:, a] = near
        groups.append(pts)
    return torch.from_numpy(np.concatenate(groups))[None]


def boundary_gaps(dev) -> dict:
    """The voxelizer at the configs' grid on ``boundary_points``, the device
    against the CPU, and how many of those points a product with the
    step's fp32 reciprocal puts in another voxel than the division (the
    points' power to see that fault)."""
    voxelizer = Voxelizer(**CONFIG_GRID)
    pts = boundary_points(voxelizer)
    mask = torch.ones(pts.shape[:2], dtype=torch.bool)
    want = voxelizer(pts, mask)
    got = voxelizer(pts.to(dev), mask.to(dev))
    off = pts[0] - torch.tensor([voxelizer.x_min, voxelizer.y_min,
                                 voxelizer.z_min])
    steps = torch.tensor([voxelizer.step, voxelizer.step, voxelizer.z_step])
    flips = torch.floor(off / steps) != torch.floor(off * (1 / steps))
    return {"boundary_voxels_equal": torch.equal(got.cpu(), want),
            "boundary_reciprocal_flips": int(flips.sum())}


def maskgit_gaps(dev, temporal: bool, seed: int = 0) -> dict:
    pipe = tiny_maskgit(temporal, seed)
    g = torch.Generator().manual_seed(seed)
    dpipe = copy.deepcopy(pipe)
    dpipe.vq.to(dev)
    dpipe.model.to(dev)
    batch = lidar_batch(g, FRAMES, 128)
    dbatch = _on(batch, dev)
    n, l = FRAMES, 16
    draws = {"decode": _decode_draws(g, 4, n, l, N_E),
             "pred_voxels": [torch.rand(n, 8, 32, 32, generator=g)
                             for _ in range(2)],
             "vq_voxels": [torch.rand(n, 8, 32, 32, generator=g)
                           for _ in range(2)]}
    ddraws = {"decode": {k: [x.to(dev) for x in v]
                         for k, v in draws["decode"].items()},
              "pred_voxels": [x.to(dev) for x in draws["pred_voxels"]],
              "vq_voxels": [x.to(dev) for x in draws["vq_voxels"]]}

    def masked(idx):
        ids = idx.reshape(n, l).clone()
        ids[:, ::3] = -1
        return ids

    ops.reset_launch_counts()
    with torch.inference_mode():
        vox, code, _, idx = pipe.vq.encode(batch["lidar_points"],
                                           batch["lidar_points_mask"])
        dvox, dcode, _, didx = dpipe.vq.encode(dbatch["lidar_points"],
                                               dbatch["lidar_points_mask"])
        feats = pipe.vq.lidar_encoder(vox.reshape(-1, 8, 32, 32))
        dfeats = dpipe.vq.lidar_encoder(dvox.reshape(-1, 8, 32, 32))
        ctx = torch.cat([batch["3dbox_bev_images"],
                         batch["hdmap_bev_images"]], -1)
        kw = dict(batch_size=1, num_frames=FRAMES)
        logits = pipe.model(code, masked(idx), ctx, **kw)
        dlogits = dpipe.model(dcode, masked(didx), ctx.to(dev), **kw)
        _, vlogits = pipe.vq.lidar_decoder(code)
        _, dvlogits = dpipe.vq.lidar_decoder(dcode)
        out = pipe.inference_pipeline(batch, draws=draws)
        dout = dpipe.inference_pipeline(dbatch, draws=ddraws)
        gap = flip_gap(pipe.vq.vector_quantizer,
                       feats.reshape(-1, feats.shape[-1]),
                       didx.cpu().reshape(-1), idx.reshape(-1))
    counts = ops.launch_counts()
    same_ids = (dout["pred_indices"].cpu() == out["pred_indices"])
    return {
        "voxels_equal": torch.equal(dvox.cpu(), vox),
        **boundary_gaps(dev),
        "encoder_rel": rel_err(dfeats.cpu(), feats),
        "indices_equal_share": float((didx.cpu() == idx).float().mean()),
        "index_flip_gap": gap,
        "logits_rel": rel_err(dlogits.cpu(), logits),
        "decoder_rel": rel_err(dvlogits.cpu(), vlogits),
        "pipeline_ids_equal_share": float(same_ids.float().mean()),
        "pipeline_ids_nonnegative": bool((dout["pred_indices"] >= 0).all()),
        "kernel_launches": counts["flash_tail"] + counts["flash_attention"]
        + counts["adaln_modulate"] + counts["residual_adaln_modulate"],
    }


def rowwise_dit(seed: int = 0) -> DiTCrossviewTemporal:
    """The tiny rowwise DiT (fp32), its zero convs and gates drawn."""
    torch.manual_seed(seed)
    model = DiTCrossviewTemporal(**ROWWISE_DIT)
    with torch.no_grad():
        for conv in model.condition_image_adapter.zero_convs:
            conv.weight.normal_(0, conv.weight[0].numel() ** -0.5)
    return model


def dit_gaps(dev, seed: int = 0) -> dict:
    g = torch.Generator().manual_seed(seed)
    model = rowwise_dit(seed).eval()
    dmodel = copy.deepcopy(model).to(dev)
    b, t, (h, w) = 1, ROWWISE_FRAMES, ROWWISE_LATENT
    inputs = dict(
        sample=torch.randn(b, t, 1, h, w, 8, generator=g),
        timestep=torch.rand(b, t, 1, generator=g) * 1000,
        encoder_hidden_states=torch.randn(b, t, 1, 1, 16, generator=g),
        pooled_projections=torch.randn(b, t, 1, 16, generator=g),
        condition_image_tensor=torch.rand(b, t, 1, 8 * h, 8 * w, 6,
                                          generator=g))
    ops.reset_launch_counts()
    with torch.inference_mode():
        out = model(**inputs)
        dout = dmodel(**_on(inputs, dev))
    k1 = ops.launch_counts()["flash_tail"]

    # the pipeline: a 32 x 32 x 8 grid into 4 x 4 latents of 16 channels
    torch.manual_seed(seed + 1)
    pipe = LidarDiffusionPipeline(
        DiTCrossviewTemporal(**dict(
            ROWWISE_DIT, in_channels=16, out_channels=16, patch_size=1,
            caption_projection_dim=128, sample_size=4, pos_embed_max_size=8,
            condition_image_adapter_config=dict(
                ROWWISE_DIT["condition_image_adapter_config"],
                downscale_factor=16))),
        _tokenizer(cosine=True), FlowMatchEulerScheduler(shift=3.0),
        FlowMatchEulerScheduler(shift=3.0),
        common_config={"text_embeddings_dim": 16,
                       "pooled_text_embeddings_dim": 16},
        inference_config={"inference_steps": 2, "guidance_scale": 3.0})
    pipe.model.eval()
    dpipe = copy.deepcopy(pipe)
    dpipe.model.to(dev)
    dpipe.autoencoder.to(dev)
    batch = lidar_batch(g, FRAMES, 128)
    noise = torch.randn(1, FRAMES, 1, 4, 4, 16, generator=g)
    uniforms = [torch.rand(FRAMES, 8, 32, 32, generator=g) for _ in range(2)]
    dbatch = _on(batch, dev)
    with torch.inference_mode():
        ref, _ = pipe.encode_points(batch["lidar_points"],
                                    batch["lidar_points_mask"])
        dref, _ = dpipe.encode_points(dbatch["lidar_points"],
                                      dbatch["lidar_points_mask"])
        got = pipe.generate(batch, noise=noise, voxel_uniforms=uniforms,
                            image_latents=ref, reference_frame_count=1)
        dgot = dpipe.generate(dbatch, noise=noise.to(dev),
                              voxel_uniforms=[u.to(dev) for u in uniforms],
                              image_latents=dref, reference_frame_count=1)
    return {
        "dit_rel": rel_err(dout.cpu(), out),
        "dit_k1_launches": k1,
        "reference_latents_rel": rel_err(dref.cpu(), ref),
        "latents_rel": rel_err(dgot["latents"].cpu(), got["latents"]),
        "voxels_equal_share": float(
            (dgot["pred_voxels"].cpu() == got["pred_voxels"]).float().mean()),
    }
