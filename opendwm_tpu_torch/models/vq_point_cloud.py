"""LiDAR VQ tokenizer, serving half (``opendwm_tpu/models/vq_point_cloud.py``),
in PyTorch.

Ported: the Swin primitives (window partition, relative position bias,
shifted windows with the −100 mask), ``PatchMerging``, ``BasicLayer``,
``VectorQuantizer`` (Euclidean and cosine, ``lookup``), ``VQEncoder``,
``VQDecoder`` and ``VQPointCloud``: voxelize → encode → quantize and
decode → voxel logits, everything a MaskGIT or LiDAR-DiT server runs; and
the training half: the density MLP and the DVGO depth/SDF rendering
(``ray_render``, frame by frame, each frame's rays in checkpointed chunks:
``ops/dvgo.py``), ``soft_l1``, the code statistics
(``update_code_stats``) and the host-side k-means dead-code revival
(``kmeans_revive``, numpy and scipy as in the JAX package, so the same
seed gives the same bits).

Parameters keep the flax modules' names (``stage_0.blocks.1.attn.qkv``
for ``stage_0/blocks_1/attn/qkv``; ``convert.py`` maps the trees) and are
kept in fp32, as flax keeps them; ``dtype`` is the compute dtype, as
flax's. Activations are channel-last and attention BSHD, as in the JAX
package; the attention goes through the port's dispatch with the bias
(plain math at ws 8, the fp32 tiny-sequence form at ws 2).

The quantizer's nearest-code search runs in row chunks of at most
``QUANTIZER_CHUNK_ELEMS`` similarities (80000 codes x 38400 tokens is
12.3 GB in fp32); rows are independent, so chunking changes no index.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from opendwm_tpu_torch.config import register
from opendwm_tpu_torch.models.layers import (
    Conv2d,
    ConvTranspose2d,
    LayerNorm,
    Linear,
    set_compute_dtype,
    sincos_pos_embed_2d,
)
from opendwm_tpu_torch.ops.attention import dot_product_attention
from opendwm_tpu_torch.ops.dvgo import DVGORenderer
from opendwm_tpu_torch.ops.voxelize import Voxelizer

QUANTIZER_CHUNK_ELEMS = 2 ** 28  # similarities a chunk: 1 GiB in fp32


# ---------------------------------------------------------------------------
# Swin primitives
# ---------------------------------------------------------------------------

def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(n, h, w, c) → (n * num_windows, ws * ws, c)"""
    n, h, w, c = x.shape
    x = x.reshape(n, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(windows: torch.Tensor, ws: int, h: int,
                   w: int) -> torch.Tensor:
    n = windows.shape[0] // ((h // ws) * (w // ws))
    x = windows.reshape(n, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h, w, -1)


@functools.cache
def relative_position_index(ws: int) -> np.ndarray:
    coords = np.stack(
        np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")
    ).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0) + ws - 1
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int64)


@functools.cache
def shifted_window_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """(num_windows, ws², ws²) additive mask: −100 between tokens that the
    cyclic shift brought from different regions, else 0."""
    img = np.zeros((1, h, w, 1))
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, wsl, :] = cnt
            cnt += 1
    win = img.reshape(1, h // ws, ws, w // ws, ws, 1)
    win = win.transpose(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def _on(cache: dict, key: tuple, make, device) -> torch.Tensor:
    """``make()`` (numpy) as a tensor on ``device``, kept in ``cache``."""
    key = key + (device,)
    if key not in cache:
        cache[key] = torch.from_numpy(make()).to(device)
    return cache[key]


class WindowAttention(nn.Module):
    """Window self-attention with a learned relative position bias; the
    shifted-window mask, when given, is added to the bias and tiled over
    the ``nw // nm`` window groups."""

    def __init__(self, dim: int, heads: int, window_size: int):
        super().__init__()
        self.heads = heads
        self.window_size = window_size
        self.qkv = Linear(dim, 3 * dim)
        self.relative_position_bias_table = nn.Parameter(
            nn.init.trunc_normal_(torch.empty((2 * window_size - 1) ** 2,
                                              heads), std=0.02))
        self.proj = Linear(dim, dim)
        self._tables: dict = {}

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        nw, l, c = x.shape
        hd = c // self.heads
        q, k, v = self.qkv(x).reshape(nw, l, 3, self.heads, hd).unbind(2)
        idx = _on(self._tables, ("index", self.window_size),
                  lambda: relative_position_index(self.window_size).ravel(),
                  x.device)
        bias = self.relative_position_bias_table[idx]
        bias = bias.reshape(l, l, self.heads).permute(2, 0, 1)[None].float()
        if mask is not None:
            nm = mask.shape[0]
            bias = bias + mask[:, None].float()  # (nm, heads, l, l)
            bias = bias[None].expand(nw // nm, *bias.shape).reshape(
                nw, self.heads, l, l)
        out = dot_product_attention(q, k, v, bias, scale=hd ** -0.5)
        return self.proj(out.reshape(nw, l, c))


class SwinBlock(nn.Module):
    """Pre-LN (eps 1e-5) window attention, cyclically shifted by −shift
    and back when ``shift`` > 0, then an exact-GELU MLP."""

    def __init__(self, dim: int, heads: int, window_size: int, shift: int,
                 input_resolution: tuple[int, int], mlp_ratio: float = 4.0):
        super().__init__()
        self.window_size, self.shift = window_size, shift
        self.input_resolution = tuple(input_resolution)
        hidden = int(dim * mlp_ratio)
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, heads, window_size)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)
        self._tables: dict = {}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, l, c = x.shape
        h, w = self.input_resolution
        ws, shift = self.window_size, self.shift
        y = self.norm1(x).reshape(n, h, w, c)
        mask = None
        if shift > 0:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
            mask = _on(self._tables, ("mask", h, w, ws, shift),
                       lambda: shifted_window_mask(h, w, ws, shift), x.device)
        y = self.attn(window_partition(y, ws), mask=mask)
        y = window_reverse(y, ws, h, w)
        if shift > 0:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + y.reshape(n, l, c)
        y = self.fc2(F.gelu(self.fc1(self.norm2(x))))
        return x + y


class PatchMerging(nn.Module):
    """2x2 token merge: channels ordered (row offset, column offset, c), as
    the JAX reshape and transpose order them; LayerNorm, then a bias-free
    projection to 2c."""

    def __init__(self, dim: int, input_resolution: tuple[int, int]):
        super().__init__()
        self.input_resolution = tuple(input_resolution)
        self.norm = LayerNorm(4 * dim, eps=1e-5)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, _, c = x.shape
        h, w = self.input_resolution
        x = x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(n, (h // 2) * (w // 2), 4 * c)
        return self.reduction(self.norm(x))


class BasicLayer(nn.Module):
    """``depth`` Swin blocks, every other one shifted by ws // 2, then an
    optional ``PatchMerging``."""

    def __init__(self, dim: int, depth: int, heads: int, window_size: int,
                 input_resolution: tuple[int, int], downsample: bool = False):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinBlock(dim, heads, window_size,
                      0 if i % 2 == 0 else window_size // 2,
                      input_resolution)
            for i in range(depth)])
        self.downsample = PatchMerging(dim, input_resolution) \
            if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        return x if self.downsample is None else self.downsample(x)


def position_table(cache: dict, dim: int, h: int, w: int,
                   like: torch.Tensor) -> torch.Tensor:
    """The (1, h·w, dim) sincos table (base size h) in ``like``'s device
    and dtype, kept in ``cache``."""
    key = (dim, h, w, like.device, like.dtype)
    if key not in cache:
        table = sincos_pos_embed_2d(dim, (h, w), base_size=h)
        cache[key] = torch.from_numpy(table).to(like.device, like.dtype)[None]
    return cache[key]


# ---------------------------------------------------------------------------
# Vector quantizer
# ---------------------------------------------------------------------------

def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """``x / max(|x|, 1e-12)`` with the norm as ``jnp.linalg.norm`` forms
    it (square root of the sum of squares)."""
    norm = torch.sqrt((x * x).sum(-1, keepdim=True))
    return x / torch.clamp(norm, min=1e-12)


@register(
    "VectorQuantizer", aliases=("dwm.models.vq_point_cloud.VectorQuantizer",)
)
class VectorQuantizer(nn.Module):
    """Nearest code by Euclidean distance, or by cosine similarity over
    unit-normalised codes; straight-through output and the (beta ·
    commitment, codebook) loss pair, as the JAX module returns them."""

    def __init__(self, n_e: int, e_dim: int, beta: float = 0.25,
                 cosine_similarity: bool = False, dead_limit: int = 256):
        super().__init__()
        self.n_e, self.e_dim, self.beta = n_e, e_dim, beta
        self.cosine_similarity = cosine_similarity
        self.dead_limit = dead_limit
        self.embedding = nn.Parameter(
            torch.empty(n_e, e_dim).uniform_(-1.0 / n_e, 1.0 / n_e))

    def codes(self) -> torch.Tensor:
        e = self.embedding
        return _l2_normalize(e) if self.cosine_similarity else e

    def nearest(self, flat: torch.Tensor,
                codes: torch.Tensor) -> torch.Tensor:
        """Index of the nearest code of each row of ``flat`` (first on
        ties), ``QUANTIZER_CHUNK_ELEMS`` similarities at a time."""
        rows = max(1, QUANTIZER_CHUNK_ELEMS // codes.shape[0])
        code_sq = None if self.cosine_similarity else (codes ** 2).sum(-1)
        out = []
        for z in flat.split(rows):  # in z's dtype, promoted as jnp does
            if self.cosine_similarity:
                sim = _l2_normalize(z).to(codes.dtype) @ codes.T
                out.append(sim.argmax(-1))
            else:
                d = (z ** 2).sum(-1, keepdim=True).to(codes.dtype) \
                    - 2 * z.to(codes.dtype) @ codes.T + code_sq[None]
                out.append(d.argmin(-1))
        return torch.cat(out)

    def forward(self, z: torch.Tensor):
        """z: (..., e_dim) → (z_q straight-through, (commit, codebook)
        loss, indices (...))."""
        codes = self.codes()
        codes = codes.to(torch.promote_types(z.dtype, codes.dtype))
        idx = self.nearest(z.reshape(-1, self.e_dim), codes)
        z_q = codes[idx].reshape(z.shape)
        if self.cosine_similarity:
            z_norm = _l2_normalize(z)
            commit = self.beta * torch.mean(
                1 - torch.sum(z_q.detach() * z_norm, -1))
            codebook = torch.mean(1 - torch.sum(z_q * z_norm.detach(), -1))
            z_for_st = z_norm
        else:
            commit = self.beta * torch.mean((z_q.detach() - z) ** 2)
            codebook = torch.mean((z_q - z.detach()) ** 2)
            z_for_st = z
        z_q = z_for_st + (z_q - z_for_st).detach()
        return z_q, (commit, codebook), idx.reshape(z.shape[:-1])

    def lookup(self, indices: torch.Tensor) -> torch.Tensor:
        return self.codes()[indices]


def update_code_stats(indices: torch.Tensor, code_age: torch.Tensor,
                      code_usage: torch.Tensor, n_e: int):
    """(age, usage) after one step's ``indices``: a used code's age
    returns to 0, the others age by 1; usage adds the counts."""
    counts = torch.zeros(n_e, dtype=code_usage.dtype,
                         device=code_usage.device)
    counts.index_add_(0, indices.reshape(-1),
                      torch.ones(indices.numel(), dtype=code_usage.dtype,
                                 device=code_usage.device))
    age = torch.where(counts > 0, torch.zeros_like(code_age), code_age + 1.0)
    return age, code_usage + counts


def kmeans_revive(codebook: np.ndarray, reservoir: np.ndarray,
                  code_age: np.ndarray, dead_limit: int,
                  seed: int = 0) -> np.ndarray:
    """Host-side dead-code revival: k-means (scipy ``kmeans2``, 100
    iterations, float64) over the reservoir and the live codes, started
    from the live codes plus reservoir rows drawn from ``seed``. Returns
    the new codebook in the codebook's dtype."""
    import scipy.cluster.vq

    rng = np.random.default_rng(seed)
    n_e = codebook.shape[0]
    live = codebook[code_age < dead_limit]
    all_z = np.concatenate([reservoir, live])
    rng.shuffle(all_z)
    init = np.concatenate([
        live,
        reservoir[rng.permutation(len(reservoir))[: n_e - len(live)]],
    ])
    centroid, _ = scipy.cluster.vq.kmeans2(
        all_z.astype(np.float64), init.astype(np.float64), minit="matrix",
        iter=100)
    return centroid.astype(codebook.dtype)


def soft_l1(pred: torch.Tensor, gt: torch.Tensor,
            keep_ratio: float = 0.95) -> torch.Tensor:
    """Mean of the smallest ``keep_ratio`` of the absolute errors."""
    err = torch.abs(pred - gt).reshape(-1)
    return torch.sort(err).values[:int(err.shape[0] * keep_ratio)].mean()


DENSITY_MLP_KEYS = tuple(f"density_mlp_{i}.{leaf}" for i in (1, 2)
                         for leaf in ("weight", "bias"))


class RenderedTokenizer(nn.Module):
    """What the two LiDAR autoencoders share for training: the density MLP
    (the render grid's features → alpha logit: Dense(32), ReLU, Dense(1)
    with the bias at ``bias_init``, in fp32 as flax ``Dense`` with no
    dtype computes over fp32 features; flax's names ``density_mlp_1``/
    ``_2``) and the loading of a serving state dict without it."""

    def _init_rendering(self, voxelizer: Voxelizer, density_feats: int,
                        bias_init: float, ray_stepsize: float,
                        ray_max_steps: int) -> None:
        self.voxelizer = voxelizer
        self.ray_stepsize, self.ray_max_steps = ray_stepsize, ray_max_steps
        self.density_mlp_1 = Linear(density_feats, 32)
        self.density_mlp_2 = Linear(32, 1)
        with torch.no_grad():
            self.density_mlp_2.bias.fill_(bias_init)

    def density_mlp(self, feats: torch.Tensor) -> torch.Tensor:
        return self.density_mlp_2(F.relu(self.density_mlp_1(feats)))[..., 0]

    def render_frames(self, density: torch.Tensor, points: torch.Tensor,
                      points_mask: torch.Tensor):
        """Depth and free-space losses of the density grids (b·t, F, Zc, H,
        W) against the returns (b, t, N, 3+) seen from the origin, frame by
        frame as the JAX ``vmap`` of one frame: (mean depth loss, mean SDF
        loss, rendered depth (b·t, N))."""
        v = self.voxelizer
        renderer = DVGORenderer(
            xyz_min=(v.x_min, v.y_min, v.z_min),
            xyz_max=(v.x_max, v.y_max, v.z_max),
            stepsize=self.ray_stepsize, max_steps=self.ray_max_steps)
        frames = density.shape[0]
        pts = points[..., :3].reshape(frames, -1, 3).float()
        msk = points_mask.reshape(frames, -1)
        depth_losses, sdf_losses, depths = [], [], []
        for grid, rays, m in zip(density, pts, msk):
            depth, sdf, _ = renderer.render(
                self.density_mlp, torch.zeros_like(rays), rays, grid)
            gt = torch.sqrt((rays * rays).sum(-1))
            # a masked ray is a zero error, inside the 95% kept (as in the
            # JAX package)
            depth_losses.append(soft_l1(torch.where(m, depth, gt), gt))
            sdf_losses.append(sdf)
            depths.append(depth)
        return (torch.stack(depth_losses).mean(),
                torch.stack(sdf_losses).mean(), torch.stack(depths))

    def load_state_dict(self, state_dict, strict: bool = True, **kwargs):
        """As ``nn.Module.load_state_dict``; a serving state dict without
        the density MLP keeps the module's own."""
        if not any(k in state_dict for k in DENSITY_MLP_KEYS):
            own = self.state_dict()
            state_dict = dict(state_dict,
                              **{k: own[k] for k in DENSITY_MLP_KEYS})
        return super().load_state_dict(state_dict, strict, **kwargs)


# ---------------------------------------------------------------------------
# VQ encoder / decoder
# ---------------------------------------------------------------------------

@register("VQEncoder", aliases=("dwm.models.vq_point_cloud.VQEncoder",))
class VQEncoder(nn.Module):
    """Conv patchify (p/2) + sincos positions → Swin stage at 2x the token
    resolution (4 blocks) → PatchMerging → Swin stage (depth − 4 blocks)
    → LayerNorm + GELU → pre-quant projection."""

    def __init__(self, img_size: int = 640, patch_size: int = 8,
                 in_chans: int = 40, embed_dim: int = 512,
                 num_heads: int = 16, depth: int = 12,
                 codebook_dim: int = 1024, window_size: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.img_size, self.patch_size = img_size, patch_size
        p = patch_size // 2
        c = embed_dim // 2
        h = img_size // p
        self.patch_embed = Conv2d(in_chans, c, p, stride=p)
        self.patch_norm = LayerNorm(c, eps=1e-5)
        self.stage_0 = BasicLayer(c, 4, num_heads, window_size, (h, h),
                                  downsample=True)
        self.stage_1 = BasicLayer(2 * c, depth - 4, num_heads, window_size,
                                  (h // 2, h // 2))
        self.norm = LayerNorm(2 * c, eps=1e-5)
        self.pre_quant = Linear(2 * c, codebook_dim)
        self.dtype = dtype
        set_compute_dtype(self, dtype)
        self._tables: dict = {}

    def forward(self, voxels: torch.Tensor) -> torch.Tensor:
        """voxels: (n, D, H, W) occupancy (z bins as channels) →
        (n, tokens, codebook_dim)."""
        x = self.patch_embed(voxels.to(self.dtype)).permute(0, 2, 3, 1)
        n, h, w, c = x.shape
        x = self.patch_norm(x).reshape(n, h * w, c)
        x = x + position_table(self._tables, c, h, w, x)
        x = self.stage_1(self.stage_0(x))
        return self.pre_quant(F.gelu(self.norm(x)))


@register("VQDecoder", aliases=("dwm.models.vq_point_cloud.VQDecoder",))
class VQDecoder(nn.Module):
    """Token embed + sincos positions → Swin → 2x up-sampling (transposed
    conv) → a density branch and a voxel branch (2 Swin blocks, LayerNorm,
    GELU, projection each) unpatchified to the grid."""

    def __init__(self, img_size: int = 640, patch_size: int = 8,
                 in_chans: int = 40, embed_dim: int = 512,
                 num_heads: int = 16, depth: int = 12,
                 codebook_dim: int = 1024, bias_init: float = -3.0,
                 window_size: int = 8, density_feats: int = 16,
                 density_z_ratio: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.grid = img_size // patch_size
        self.p = patch_size // 2
        self.in_chans, self.embed_dim = in_chans, embed_dim
        self.density_feats = density_feats
        self.zc = in_chans // density_z_ratio
        h, h2, half = self.grid, 2 * self.grid, embed_dim // 2
        self.decoder_embed = Linear(codebook_dim, embed_dim)
        self.blocks = BasicLayer(embed_dim, depth - 2, num_heads, window_size,
                                 (h, h))
        self.upsample = ConvTranspose2d(embed_dim, half, 2, stride=2)
        for name, out in (("density", self.p ** 2 * density_feats * self.zc),
                          ("voxel", self.p ** 2 * in_chans)):
            self.add_module(f"{name}_block", BasicLayer(
                half, 2, num_heads, window_size, (h2, h2)))
            self.add_module(f"{name}_norm", LayerNorm(half, eps=1e-5))
            self.add_module(f"{name}_pred", Linear(half, out))
        with torch.no_grad():
            self.voxel_pred.bias.fill_(bias_init)
            self.density_pred.bias.zero_()
        self.dtype = dtype
        set_compute_dtype(self, dtype)
        self._tables: dict = {}

    def _head(self, name: str, x: torch.Tensor) -> torch.Tensor:
        y = getattr(self, f"{name}_block")(x)
        y = F.gelu(getattr(self, f"{name}_norm")(y))
        return getattr(self, f"{name}_pred")(y)

    def _unpatchify(self, y: torch.Tensor, channels: int) -> torch.Tensor:
        n, h2, p = y.shape[0], 2 * self.grid, self.p
        y = y.reshape(n, h2, h2, p, p, channels).permute(0, 5, 1, 3, 2, 4)
        return y.reshape(n, channels, h2 * p, h2 * p)

    def forward(self, tokens: torch.Tensor, density: bool = False):
        """tokens: (n, L, codebook_dim) at (img/patch)² resolution →
        (density grid (n, F, Zc, H, W) or None, voxel logits (n, D, H, W)).
        Serving never reads the density branch (XLA drops it from the JAX
        package's serving programs), so it runs only with ``density=True``
        (the DVGO rendering of training)."""
        h = self.grid
        n = tokens.shape[0]
        x = self.decoder_embed(tokens)
        x = x + position_table(self._tables, self.embed_dim, h, h, x)
        x = self.blocks(x).reshape(n, h, h, self.embed_dim)
        x = self.upsample(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        x = x.reshape(n, 4 * h * h, self.embed_dim // 2)
        grid = None
        if density:
            grid = self._unpatchify(self._head("density", x),
                                    self.density_feats * self.zc)
            grid = grid.reshape(n, self.density_feats, self.zc,
                                *grid.shape[-2:])
        voxel = self._unpatchify(self._head("voxel", x), self.in_chans)
        return grid, voxel


# ---------------------------------------------------------------------------
# VQPointCloud
# ---------------------------------------------------------------------------

@register("VQPointCloud", aliases=("dwm.models.vq_point_cloud.VQPointCloud",))
class VQPointCloud(RenderedTokenizer):
    """Composite LiDAR tokenizer. ``voxelizer`` is a static dataclass;
    points arrive padded with a mask (static shapes). The density MLP
    (``density_mlp_1``/``_2``, flax's names) serves the DVGO rendering of
    training only; a serving state dict may leave it out."""

    def __init__(self, voxelizer: Voxelizer,
                 vector_quantizer: VectorQuantizer, lidar_encoder: VQEncoder,
                 lidar_decoder: VQDecoder, bias_init: float = -5.0,
                 ray_stepsize: float = 0.05, ray_max_steps: int = 512):
        super().__init__()
        self.vector_quantizer = vector_quantizer
        self.lidar_encoder = lidar_encoder
        self.lidar_decoder = lidar_decoder
        self._init_rendering(voxelizer, lidar_decoder.density_feats,
                             bias_init, ray_stepsize, ray_max_steps)

    def encode(self, points: torch.Tensor, points_mask: torch.Tensor):
        """points (b, t, N, 3+), mask (b, t, N) → (voxels (b, t, D, H, W),
        z_q (b·t, L, e_dim), (commit, codebook) loss, indices (b·t, L))."""
        voxels = self.voxelizer(points, points_mask)
        feats = self.lidar_encoder(voxels.reshape(-1, *voxels.shape[2:]))
        z_q, emb_loss, idx = self.vector_quantizer(feats)
        return voxels, z_q, emb_loss, idx

    def ray_render(self, density: torch.Tensor, points: torch.Tensor,
                   points_mask: torch.Tensor):
        """density (b, t, F, Zc, H, W); points (b, t, N, 3+) from the
        LiDAR origin → (depth loss, SDF loss, rendered depth (b, t, N))."""
        b, t = density.shape[:2]
        depth_loss, sdf_loss, depth = self.render_frames(
            density.reshape(b * t, *density.shape[2:]), points, points_mask)
        return depth_loss, sdf_loss, depth.reshape(b, t, -1)

    def forward(self, points: torch.Tensor, points_mask: torch.Tensor,
                render_rays: bool = True) -> dict:
        """Voxelize, encode, quantize, decode; with ``render_rays`` the
        DVGO depth and SDF losses too. The dict also carries ``z_q`` and
        the indices, which the trainer's code statistics and reservoir
        read."""
        voxels, z_q, emb_loss, idx = self.encode(points, points_mask)
        b, t = voxels.shape[:2]
        density, logits = self.lidar_decoder(z_q, density=render_rays)
        result = {"voxels": voxels,
                  "lidar_voxel": logits.reshape(b, t, *logits.shape[1:]),
                  "emb_loss": emb_loss, "indices": idx, "z_q": z_q}
        if render_rays:
            result["depth_loss"], result["sdf_loss"], \
                result["pred_depth"] = self.ray_render(
                    density.reshape(b, t, *density.shape[1:]), points,
                    points_mask)
        return result

