"""Differentiable DVGO-style ray rendering (``opendwm_tpu/ops/dvgo.py``),
in PyTorch.

Rays are marched with a static step count from their entry into the grid's
box, so (rays, steps) is a dense 2-D problem: per-sample trilinear grid
queries are gathers from the channel-last grid, alpha compositing is an
exclusive cumulative product along the steps. The JAX package renders
with XLA, not with a Pallas kernel, so this is plain PyTorch.

At the LiDAR configs' size one frame holds ~32k rays x 768 steps = 25M
samples: their 16 grid features alone are 1.6 GB in fp32 and the density
MLP's 32-wide hidden layer 3.2 GB. ``DVGORenderer.render`` therefore runs
the rays in chunks of at most ``RENDER_CHUNK_SAMPLES`` samples, each under
activation checkpointing when gradients are on: autograd keeps only a
chunk's inputs and per-ray outputs and recomputes the chunk in the
backward. Rays are independent, so chunks change no value.

Points are divided by tensors on their own device, never by Python
numbers: on the card PyTorch turns a division by a Python number into a
product with its fp32 reciprocal.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.utils.checkpoint

RENDER_CHUNK_SAMPLES = 2 ** 22  # rays x steps of one checkpointed chunk


def _corner_fracs(grid_shape, xyz, xyz_min, xyz_max):
    """Base corner indices and interpolation fractions, align_corners=True;
    the floor is clipped to ``size - 2`` so the +1 corner is in range."""
    d, h, w = grid_shape
    norm = (xyz - xyz_min) / (xyz_max - xyz_min)
    fx = norm[..., 0] * (w - 1)
    fy = norm[..., 1] * (h - 1)
    fz = norm[..., 2] * (d - 1)
    x0 = torch.clamp(torch.floor(fx), 0, max(w - 2, 0)).long()
    y0 = torch.clamp(torch.floor(fy), 0, max(h - 2, 0)).long()
    z0 = torch.clamp(torch.floor(fz), 0, max(d - 2, 0)).long()
    tx = torch.clamp(fx - x0, 0.0, 1.0)[..., None]
    ty = torch.clamp(fy - y0, 0.0, 1.0)[..., None]
    tz = torch.clamp(fz - z0, 0.0, 1.0)[..., None]
    return (z0, y0, x0), (tz, ty, tx)


def _as_box(value, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(value, dtype=torch.float32, device=like.device)


def query_channel_last(flat_grid: torch.Tensor, grid_shape, xyz, xyz_min,
                       xyz_max, mode: str = "block") -> torch.Tensor:
    """``trilinear_grid_query`` on a grid already laid out channel-last and
    flattened to (D·H·W, C); returns (..., C) in the grid's type promoted
    with fp32."""
    d, h, w = grid_shape
    (z0, y0, x0), (tz, ty, tx) = _corner_fracs(grid_shape, xyz, xyz_min,
                                               xyz_max)
    if mode == "block" and min(d, h, w) < 2:
        mode = "corner8"  # a 2x2x2 block needs every spatial dim >= 2
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    z1 = torch.clamp(z0 + 1, max=d - 1)

    def g(zi, yi, xi):
        flat = ((zi * h + yi) * w + xi).reshape(-1)
        return flat_grid.index_select(0, flat).reshape(
            *zi.shape, flat_grid.shape[-1])

    if mode == "block":
        # the JAX block gather's order: z first, then y, then x
        c = {(a, b_, e): g(za, yb, xe)
             for a, za in ((0, z0), (1, z1))
             for b_, yb in ((0, y0), (1, y1))
             for e, xe in ((0, x0), (1, x1))}
        cz = {(b_, e): c[0, b_, e] * (1 - tz) + c[1, b_, e] * tz
              for b_ in (0, 1) for e in (0, 1)}
        cy = {e: cz[0, e] * (1 - ty) + cz[1, e] * ty for e in (0, 1)}
        return cy[0] * (1 - tx) + cy[1] * tx
    c00 = g(z0, y0, x0) * (1 - tx) + g(z0, y0, x1) * tx
    c01 = g(z0, y1, x0) * (1 - tx) + g(z0, y1, x1) * tx
    c10 = g(z1, y0, x0) * (1 - tx) + g(z1, y0, x1) * tx
    c11 = g(z1, y1, x0) * (1 - tx) + g(z1, y1, x1) * tx
    c0 = c00 * (1 - ty) + c01 * ty
    c1 = c10 * (1 - ty) + c11 * ty
    return c0 * (1 - tz) + c1 * tz


def channel_last(grid: torch.Tensor) -> torch.Tensor:
    """(C, D, H, W) → (D·H·W, C)."""
    return grid.permute(1, 2, 3, 0).reshape(-1, grid.shape[0])


def trilinear_grid_query(grid: torch.Tensor, xyz: torch.Tensor, xyz_min,
                         xyz_max, mode: str = "block") -> torch.Tensor:
    """Sample ``grid`` (C, D, H, W) at world points (..., 3) with
    align_corners=True semantics; grid axes are (z, y, x), points (x, y,
    z). ``mode`` "block" interpolates z, y, x in that order (the JAX block
    gather), "corner8" x, y, z: the same values up to rounding."""
    return query_channel_last(channel_last(grid), grid.shape[1:], xyz,
                              _as_box(xyz_min, xyz), _as_box(xyz_max, xyz),
                              mode)


def ray_aabb(rays_o, unit_d, xyz_min, xyz_max):
    """Entry/exit distances of rays with an axis-aligned box (slab
    method); the entry is clipped at 0."""
    safe = torch.where(torch.abs(unit_d) < 1e-9,
                       torch.full_like(unit_d, 1e-9), unit_d)
    inv = 1.0 / safe
    t0 = (xyz_min - rays_o) * inv
    t1 = (xyz_max - rays_o) * inv
    t_near = torch.minimum(t0, t1).amax(-1)
    t_far = torch.maximum(t0, t1).amin(-1)
    return torch.clamp(t_near, min=0.0), t_far


def alphas_to_weights(alpha: torch.Tensor):
    """Volume-rendering weights ``alpha_i · prod_{j<i} (1 − alpha_j)``
    along the last axis, and the final transmittance."""
    trans = torch.cumprod(1.0 - alpha + 1e-10, -1)
    exclusive = torch.cat([torch.ones_like(trans[..., :1]),
                           trans[..., :-1]], -1)
    return alpha * exclusive, trans[..., -1]


def raw_to_alpha(density: torch.Tensor, shift: float,
                 interval: float) -> torch.Tensor:
    """``1 − exp(−softplus(density + shift) · interval)``, the softplus as
    ``jax.nn.softplus`` forms it (``logaddexp(x, 0)``)."""
    x = density + shift
    return 1.0 - torch.exp(-torch.logaddexp(x, torch.zeros_like(x))
                           * interval)


@dataclasses.dataclass(frozen=True)
class DVGORenderer:
    """Fixed-step-count ray renderer over a feature grid: an ``mlp`` maps
    grid features to an alpha logit (sigmoid applied here); ``rays_o`` is
    usually 0 (the LiDAR origin) and ``rays_d`` the unnormalised returns,
    so |rays_d| is the ground-truth depth of the free-space (SDF) loss."""

    xyz_min: tuple
    xyz_max: tuple
    stepsize: float
    max_steps: int
    near: float = 0.0
    query_mode: str = "block"

    def _rays(self, mlp, rays_o, rays_d, flat_grid, grid_shape,
              feat_render: bool, offsets):
        """Per-ray (output, Σ weights² before the return, final
        transmittance) of rays (N, 3)."""
        n = rays_o.shape[0]
        xyz_min = _as_box(self.xyz_min, rays_o)
        xyz_max = _as_box(self.xyz_max, rays_o)
        norm_d = torch.sqrt((rays_d * rays_d).sum(-1))
        unit_d = rays_d / torch.clamp(norm_d[..., None], min=1e-9)
        t_near, t_far = ray_aabb(rays_o, unit_d, xyz_min, xyz_max)
        s = torch.arange(self.max_steps, dtype=torch.float32,
                         device=rays_o.device)
        t = t_near[:, None] + s[None, :] * self.stepsize
        pts = rays_o[:, None, :] + unit_d[:, None, :] * t[..., None]
        if offsets is not None:
            pts = pts + offsets
        inside = (t <= t_far[:, None]) & (pts > xyz_min).all(-1) \
            & (pts < xyz_max).all(-1)
        feats = query_channel_last(flat_grid, grid_shape, pts, xyz_min,
                                   xyz_max, self.query_mode)
        alpha = torch.sigmoid(mlp(feats)).reshape(n, self.max_steps)
        alpha = torch.where(inside, alpha, torch.zeros_like(alpha))
        weights, alphainv_last = alphas_to_weights(alpha)
        if offsets is None:  # |pts − rays_o| is the march distance t
            dist = t
        else:
            dist = torch.sqrt(((pts - rays_o[:, None, :]) ** 2).sum(-1))
        before = (norm_d[:, None] - dist) > self.near
        sdf = torch.where(before, weights ** 2,
                          torch.zeros_like(weights)).sum(-1)
        if feat_render:
            output = torch.einsum("ns,nsc->nc", weights, feats)
        else:
            output = (weights * (s[None, :] * self.stepsize)).sum(-1)
        return output, sdf, alphainv_last

    def __call__(self, mlp: Callable, rays_o: torch.Tensor,
                 rays_d: torch.Tensor, grid: torch.Tensor,
                 feat_render: bool = False,
                 offsets: Optional[torch.Tensor] = None):
        """rays_o/rays_d: (N, 3); grid: (C, D, H, W). Returns (output,
        loss_sdf, alphainv_last): the expected depth (N,) or feature map
        (N, C) with ``feat_render``; the mean over rays of Σ weights²
        before the LiDAR return; the final transmittance (N,)."""
        output, sdf, last = self._rays(mlp, rays_o, rays_d,
                                       channel_last(grid), grid.shape[1:],
                                       feat_render, offsets)
        return output, sdf.mean(), last

    def render(self, mlp: Callable, rays_o: torch.Tensor,
               rays_d: torch.Tensor, grid: torch.Tensor,
               feat_render: bool = False,
               offsets: Optional[torch.Tensor] = None):
        """``__call__`` over chunks of at most ``RENDER_CHUNK_SAMPLES``
        samples, each checkpointed when gradients are on: the same values,
        with autograd holding a chunk's samples only while it is
        recomputed in the backward."""
        flat, shape = channel_last(grid), tuple(grid.shape[1:])
        rows = max(1, RENDER_CHUNK_SAMPLES // self.max_steps)
        outs = []
        for r0 in range(0, rays_o.shape[0], rows):
            args = (rays_o[r0:r0 + rows], rays_d[r0:r0 + rows], flat)
            off = None if offsets is None else offsets[r0:r0 + rows]

            def chunk(o, d, g, off=off):
                return self._rays(mlp, o, d, g, shape, feat_render, off)

            if torch.is_grad_enabled():
                outs.append(torch.utils.checkpoint.checkpoint(
                    chunk, *args, use_reentrant=False))
            else:
                outs.append(chunk(*args))
        output, sdf, last = (torch.cat(parts) for parts in zip(*outs))
        return output, sdf.mean(), last
