"""MaskGIT backbone for LiDAR token modelling
(``opendwm_tpu/models/maskgit.py``), in PyTorch.

A bidirectional transformer over VQ code tokens: mask-token substitution
where ``x_id == -1``, optional ``extra_embedding`` input codes, Swin
blocks over the token grid (window 2: 4-token windows, which the
attention dispatch sends to its fp32 tiny-sequence form), optionally
interleaved with temporal blocks (rotary attention over the frames of
each token, plain einsum as in the JAX model), per-block residuals from
the layout ``ImageAdapter``, and a LayerNorm + GELU head to ``n_e`` logits.

Parameters keep the flax names (``blocks.blocks.3`` for
``blocks/blocks_3``, ``blocks.temporal_blocks.3`` for
``blocks/temporal_blocks_3``) and are kept in fp32, as flax keeps them;
``dtype`` is the compute dtype. The top-k cosine perturbation of the
extra embedding (``_perturb``, a training augmentation) takes its draws
explicitly (``draw_perturbation``: the uniforms that pick the tokens and
the choice among each token's top-k neighbours); only the picked tokens'
similarities are formed, ``PERTURB_CHUNK_ELEMS`` at a time (a full-width
batch holds 51,200 tokens x 80,000 codes).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from opendwm_tpu_torch.config import register
from opendwm_tpu_torch.models.adapters import ImageAdapter
from opendwm_tpu_torch.models.layers import (
    FeedForward,
    LayerNorm,
    Linear,
    set_compute_dtype,
)
from opendwm_tpu_torch.models.vq_point_cloud import (
    SwinBlock,
    _l2_normalize,
    position_table,
)

PERTURB_CHUNK_ELEMS = 2 ** 28  # similarities a chunk of the perturbation


class RotaryEmbedding(nn.Module):
    """Learned-frequency rotary embedding ('pixel' init) over the sequence
    axis of ``(..., seq, heads, head_dim)`` tensors; pairs are interleaved
    (even, odd) and the result is fp32 when the frequencies are."""

    def __init__(self, head_dim: int, max_freq: float = 10.0):
        super().__init__()
        self.freqs = nn.Parameter(
            torch.linspace(1.0, max_freq / 2, head_dim // 2) * math.pi)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = torch.arange(x.shape[-3], dtype=torch.float32, device=x.device)
        angles = t[:, None] * self.freqs[None, :]
        cos = torch.cos(angles)[None, :, None, :]
        sin = torch.sin(angles)[None, :, None, :]
        x1, x2 = x[..., 0::2], x[..., 1::2]
        out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
        return out.reshape(x.shape)


class TemporalTransformerBlock(nn.Module):
    """Pre-LN (eps 1e-6) self-attention with rotary q/k over the frames,
    fp32 logits and softmax, then a tanh-GELU feed-forward. Input
    ``(n, t, c)``."""

    def __init__(self, dim: int, heads: int, head_dim: int):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.head_dim = heads, head_dim
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.to_q = Linear(dim, inner)
        self.to_k = Linear(dim, inner)
        self.to_v = Linear(dim, inner)
        self.rope = RotaryEmbedding(head_dim)
        self.to_out = Linear(inner, dim)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.ff = FeedForward(dim, activation="gelu-approximate")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = self.norm1(x)
        shape = (*n.shape[:-1], self.heads, self.head_dim)
        q = self.rope(self.to_q(n).reshape(shape))
        k = self.rope(self.to_k(n).reshape(shape))
        v = self.to_v(n).reshape(shape)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        probs = torch.softmax(logits * self.head_dim ** -0.5, -1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        x = x + self.to_out(out.reshape(*x.shape[:-1], -1))
        return x + self.ff(self.norm2(x))


class MaskgitTransformer(nn.Module):
    """Swin blocks over the token grid, each followed by a temporal block
    when ``enable_temporal``; the i-th context residual is added after
    block i."""

    def __init__(self, dim: int, input_resolution: Sequence[int], depth: int,
                 num_heads: int, window_size: int = 2,
                 enable_temporal: bool = False):
        super().__init__()
        self.dim = dim
        self.blocks = nn.ModuleList([
            SwinBlock(dim, num_heads, window_size,
                      0 if i % 2 == 0 else window_size // 2,
                      tuple(input_resolution))
            for i in range(depth)])
        self.temporal_blocks = nn.ModuleList([
            TemporalTransformerBlock(dim, num_heads, dim // num_heads)
            for _ in range(depth)]) if enable_temporal else None

    def forward(self, x: torch.Tensor, context: Optional[list] = None,
                batch_size: Optional[int] = None,
                num_frames: Optional[int] = None) -> torch.Tensor:
        context = list(context) if context is not None else []
        l, c = x.shape[-2], self.dim
        for i, spatial in enumerate(self.blocks):
            x = spatial(x)
            if self.temporal_blocks is not None:
                b, t = batch_size, num_frames
                x = x.reshape(b, t, l, c).transpose(1, 2).reshape(b * l, t, c)
                x = self.temporal_blocks[i](x)
                x = x.reshape(b, l, t, c).transpose(1, 2).reshape(b * t, l, c)
            if context:
                x = x + context.pop(0)
        return x


@register(
    "BidirectionalTransformerWithAdapter",
    aliases=("dwm.models.maskgit_model.BidirectionalTransformerWithAdapter",),
)
class BidirectionalTransformer(nn.Module):
    """Inputs: ``x`` (N, L, e_dim) quantized features (ignored with
    ``use_extra_embedding``), ``x_id`` (N, L) code indices with −1 at
    masked positions, ``context`` an optional (N, H, W, C) BEV layout
    raster, ``batch_size``/``num_frames`` when temporal. Returns (N, L,
    n_e) logits in the compute dtype."""

    def __init__(self, n_e: int, e_dim: int, img_size: Sequence[int],
                 hidden_dim: int = 512, depth: int = 24, num_heads: int = 16,
                 window_size: int = 2, use_extra_embedding: bool = False,
                 enable_temporal: bool = False,
                 condition_adapter_config: Optional[dict] = None,
                 enable_perturbation: bool = False,
                 perturbation_ratio: float = 0.1, perturbation_topk: int = 5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_e, self.e_dim, self.hidden_dim = n_e, e_dim, hidden_dim
        self.enable_perturbation = enable_perturbation
        self.perturbation_ratio = perturbation_ratio
        self.perturbation_topk = perturbation_topk
        self.img_size = tuple(img_size)
        self.mask_token = nn.Parameter(torch.randn(1, 1, e_dim) * 0.02)
        self.extra_embedding = nn.Embedding(n_e, e_dim) \
            if use_extra_embedding else None
        self.decoder_embed = Linear(e_dim, hidden_dim)
        self.condition_adapter = ImageAdapter(**condition_adapter_config) \
            if condition_adapter_config is not None else None
        self.blocks = MaskgitTransformer(hidden_dim, self.img_size, depth,
                                         num_heads, window_size,
                                         enable_temporal)
        self.norm = LayerNorm(hidden_dim, eps=1e-5)
        self.pred = Linear(hidden_dim, n_e)
        self.dtype = dtype
        set_compute_dtype(self, dtype)
        self._tables: dict = {}

    def forward(self, x: Optional[torch.Tensor], x_id: torch.Tensor,
                context: Optional[torch.Tensor] = None,
                batch_size: Optional[int] = None,
                num_frames: Optional[int] = None,
                perturb_draws: Optional[dict] = None, head=None):
        """``perturb_draws`` (``draw_perturbation``) turns the extra
        embedding's perturbation on, where the model enables it. ``head``,
        a function of the head's input ``gelu(norm(h))`` (N, L,
        hidden_dim) and the head ``self.pred``, replaces the logits by its
        result: training applies the head with its loss, a chunk of rows
        at a time, inside the forward, so that a data-parallel wrapper's
        hooks see every use of the weights."""
        masked = (x_id == -1)[..., None]
        if self.extra_embedding is not None:
            if self.enable_perturbation and perturb_draws is not None:
                x_id = self._perturb(x_id, perturb_draws)
            tok = self.extra_embedding(x_id.clamp(min=0)).to(self.dtype)
        else:
            tok = x
        h = torch.where(masked, self.mask_token.to(tok.dtype), tok)
        h = self.decoder_embed(h)
        h = h + position_table(self._tables, self.hidden_dim,
                               *self.img_size, h)
        ctx = None
        if self.condition_adapter is not None and context is not None:
            ctx = [f.reshape(f.shape[0], -1, f.shape[-1])
                   for f in self.condition_adapter(context.to(self.dtype))]
        h = self.blocks(h, ctx, batch_size=batch_size, num_frames=num_frames)
        features = F.gelu(self.norm(h))
        if head is not None:
            return head(features, self.pred)
        return self.pred(features)

    def draw_perturbation(self, shape, generator=None, device=None) -> dict:
        """The perturbation's draws for ids of ``shape``, in the JAX
        package's order: ``uniform`` (which tokens move) and ``choice``
        (which of the top-k neighbours)."""
        return {"uniform": torch.rand(shape, generator=generator,
                                      device=device),
                "choice": torch.randint(0, self.perturbation_topk, shape,
                                        generator=generator, device=device)}

    @torch.no_grad()
    def _perturb(self, x_id: torch.Tensor, draws: dict) -> torch.Tensor:
        """Replace ~``perturbation_ratio`` of the visible tokens with one of
        their top-k cosine neighbours in the extra embedding: a token moves
        where its uniform is below the ratio, to the neighbour its choice
        names (rank 0 is the most similar)."""
        table = self.extra_embedding.weight.float()
        table_n = _l2_normalize(table)
        move = (draws["uniform"].to(x_id.device) < self.perturbation_ratio) \
            & (x_id != -1)
        rows = move.nonzero(as_tuple=True)
        ids = x_id[rows]
        choice = draws["choice"].to(x_id.device)[rows]
        step = max(1, PERTURB_CHUNK_ELEMS // table_n.shape[0])
        neighbours = []
        for r0 in range(0, ids.shape[0], step):
            sim = table_n[ids[r0:r0 + step]] @ table_n.T
            top = sim.topk(self.perturbation_topk, -1).indices
            neighbours.append(top.gather(-1, choice[r0:r0 + step, None])[:, 0])
        out = x_id.clone()
        if neighbours:
            out[rows] = torch.cat(neighbours).to(out.dtype)
        return out
