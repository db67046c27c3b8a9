"""Text encoders (``opendwm_tpu/models/text_encoders.py``), in PyTorch:
the CLIP text tower and the T5 encoder stack, and SD3's combination of
their outputs into the DiT's context and pooled vector.

Parameter names follow the JAX package's flax trees with dots for slashes
(``layers.3.self_attn.q_proj.weight`` is ``layers_3/self_attn/q_proj``),
so ``convert.clip_state_dict_from_flax`` / ``t5_state_dict_from_flax``
map one onto the other. ``dtype`` is the dtype of the parameters and of
the computation: the encoders are never trained, so they keep no fp32
master weights.

Attention passes its mask or relative-position bias to
``ops.attention.dot_product_attention``, which sends any biased call to
the plain path (never a kernel), as the JAX package sends it to
``_xla_attention``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from opendwm_tpu_torch.config import register
from opendwm_tpu_torch.models.layers import LayerNorm, Linear, \
    set_compute_dtype
from opendwm_tpu_torch.ops.attention import dot_product_attention


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


_ACTS = {
    "gelu": F.gelu,
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "quick_gelu": quick_gelu,
}


def _finish(module: nn.Module, dtype) -> None:
    module.to(dtype)
    module._dtype = dtype
    set_compute_dtype(module, dtype)


# ---------------------------------------------------------------------------
# CLIP text model
# ---------------------------------------------------------------------------

class CLIPAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (
            Linear(dim, dim) for _ in range(4))

    def forward(self, x, mask):
        shape = x.shape[:-1] + (self.heads, x.shape[-1] // self.heads)
        out = dot_product_attention(
            self.q_proj(x).reshape(shape), self.k_proj(x).reshape(shape),
            self.v_proj(x).reshape(shape), bias=mask)
        return self.out_proj(out.reshape(x.shape))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, dim: int, heads: int, intermediate_size: int,
                 act: str = "quick_gelu"):
        super().__init__()
        self.act = _ACTS[act]
        self.layer_norm1 = LayerNorm(dim, eps=1e-5)
        self.self_attn = CLIPAttention(dim, heads)
        self.layer_norm2 = LayerNorm(dim, eps=1e-5)
        self.fc1 = Linear(dim, intermediate_size)
        self.fc2 = Linear(intermediate_size, dim)

    def forward(self, x, mask):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.fc2(self.act(self.fc1(self.layer_norm2(x))))


@register("CLIPTextEncoder",
          aliases=("transformers.CLIPTextModel",
                   "transformers.CLIPTextModelWithProjection"))
class CLIPTextEncoder(nn.Module):
    """CLIP text tower. ``forward(input_ids)`` returns
    ``(last_hidden_state, pooled, hidden_states)``: the hidden state at
    each sequence's EOS token is pooled, through ``text_projection`` when
    ``projection_dim`` is set; ``hidden_states`` holds the input of every
    layer and the final normed output."""

    def __init__(
        self,
        vocab_size: int = 49408,
        hidden_size: int = 1024,
        num_layers: int = 23,
        num_heads: int = 16,
        intermediate_size: Optional[int] = None,
        max_position_embeddings: int = 77,
        act: str = "gelu",
        eos_token_id: int = 49407,
        projection_dim: Optional[int] = None,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        d = hidden_size
        self.eos_token_id = eos_token_id
        self.token_embedding = nn.Embedding(vocab_size, d)
        self.position_embedding = nn.Parameter(
            torch.empty(max_position_embeddings, d).normal_(0.0, 0.01))
        self.layers = nn.ModuleList([
            CLIPEncoderLayer(d, num_heads, intermediate_size or 4 * d, act)
            for _ in range(num_layers)])
        self.final_layer_norm = LayerNorm(d, eps=1e-5)
        self.text_projection = None if projection_dim is None else \
            Linear(d, projection_dim, bias=False)
        _finish(self, dtype)

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype."""
        return self._dtype

    def forward(self, input_ids: torch.Tensor):
        b, s = input_ids.shape
        x = self.token_embedding(input_ids).to(self.dtype)
        x = x + self.position_embedding[:s].to(self.dtype)
        causal = torch.full((s, s), float("-inf"), device=x.device).triu(1)
        causal = causal[None, None]
        hidden_states = []
        for layer in self.layers:
            hidden_states.append(x)
            x = layer(x, causal)
        x = self.final_layer_norm(x)
        hidden_states.append(x)

        if self.eos_token_id == 2:
            # The legacy pooling of models whose eos_token_id is 2: at the
            # highest token id (the EOS is the largest id of the CLIP
            # vocabulary), kept for checkpoint parity.
            eos = input_ids.argmax(-1)
        else:
            eos = (input_ids == self.eos_token_id).int().argmax(-1)
        pooled = x[torch.arange(b, device=x.device), eos]
        if self.text_projection is not None:
            pooled = self.text_projection(pooled)
        return x, pooled, hidden_states


# ---------------------------------------------------------------------------
# T5 encoder
# ---------------------------------------------------------------------------

class T5LayerNorm(nn.Module):
    """RMS norm without bias or mean-centering (T5 style), eps 1e-6, its
    statistics in fp32."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        x32 = x.float()
        var = (x32 * x32).mean(-1, keepdim=True)
        return (x32 * torch.rsqrt(var + 1e-6)).to(x.dtype) * \
            self.weight.to(x.dtype)


def t5_relative_position_bucket(relative_position: torch.Tensor,
                                num_buckets: int = 32,
                                max_distance: int = 128) -> torch.Tensor:
    """Bidirectional bucketing of HF T5, in float32 as the JAX package
    computes it (the ``+ 1e-6`` keeps exact powers of two off the integer
    boundary, so the ids do not depend on the last bit of the log)."""
    num_buckets //= 2
    ret = (relative_position > 0).to(torch.int64) * num_buckets
    n = relative_position.abs()
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_large = max_exact + (
        torch.log(n.float() / max_exact + 1e-6)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).to(torch.int64)  # truncation toward zero, as astype(int32)
    val_large = val_large.clamp(max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_large)


class T5Attention(nn.Module):
    """Unscaled attention (T5 folds the scale into the init); block 0
    holds the relative-position bias that every block adds."""

    def __init__(self, dim: int, heads: int, kv_dim: int,
                 has_relative_bias: bool = False,
                 relative_buckets: int = 32,
                 relative_max_distance: int = 128):
        super().__init__()
        inner = heads * kv_dim
        self.heads, self.kv_dim = heads, kv_dim
        self.relative_max_distance = relative_max_distance
        self.q, self.k, self.v = (Linear(dim, inner, bias=False)
                                  for _ in range(3))
        self.o = Linear(inner, dim, bias=False)
        self.relative_attention_bias = nn.Parameter(
            torch.empty(relative_buckets, heads).normal_()) \
            if has_relative_bias else None

    def position_bias(self, s: int, device) -> torch.Tensor:
        pos = torch.arange(s, device=device)
        buckets = t5_relative_position_bucket(
            pos[None, :] - pos[:, None],
            self.relative_attention_bias.shape[0], self.relative_max_distance)
        # (s, s, heads) -> (1, heads, s, s), in the parameters' dtype
        return self.relative_attention_bias[buckets].permute(2, 0, 1)[None]

    def forward(self, x, bias):
        b, s, _ = x.shape
        if self.relative_attention_bias is not None:
            bias = self.position_bias(s, x.device)
        shape = (b, s, self.heads, self.kv_dim)
        out = dot_product_attention(
            self.q(x).reshape(shape), self.k(x).reshape(shape),
            self.v(x).reshape(shape), bias=bias, scale=1.0)
        return self.o(out.reshape(b, s, -1)), bias


class T5Block(nn.Module):
    """Attention, then the gated GELU (tanh) feed-forward, each pre-normed."""

    def __init__(self, dim: int, heads: int, kv_dim: int, d_ff: int,
                 has_relative_bias: bool = False):
        super().__init__()
        self.ln_attn = T5LayerNorm(dim)
        self.attention = T5Attention(dim, heads, kv_dim, has_relative_bias)
        self.ln_ff = T5LayerNorm(dim)
        self.wi_0 = Linear(dim, d_ff, bias=False)
        self.wi_1 = Linear(dim, d_ff, bias=False)
        self.wo = Linear(d_ff, dim, bias=False)

    def forward(self, x, bias):
        attn_out, bias = self.attention(self.ln_attn(x), bias)
        x = x + attn_out
        h = self.ln_ff(x)
        h = F.gelu(self.wi_0(h), approximate="tanh") * self.wi_1(h)
        return x + self.wo(h), bias


@register("T5TextEncoder", aliases=("transformers.T5EncoderModel",))
class T5TextEncoder(nn.Module):
    """T5 encoder stack (the gated-GELU variant: t5-v1.1, T5-XXL)."""

    def __init__(
        self,
        vocab_size: int = 32128,
        d_model: int = 4096,
        d_kv: int = 64,
        d_ff: int = 10240,
        num_layers: int = 24,
        num_heads: int = 64,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.shared = nn.Embedding(vocab_size, d_model)
        self.block = nn.ModuleList([
            T5Block(d_model, num_heads, d_kv, d_ff, has_relative_bias=i == 0)
            for i in range(num_layers)])
        self.final_layer_norm = T5LayerNorm(d_model)
        _finish(self, dtype)

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype."""
        return self._dtype

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        x = self.shared(input_ids).to(self.dtype)
        bias = None
        for block in self.block:
            x, bias = block(x, bias)
        return self.final_layer_norm(x)


# ---------------------------------------------------------------------------
# Prompt encoding (SD 3.x)
# ---------------------------------------------------------------------------

def sd3_prompt_embeddings(clip_l_out, clip_g_out, t5_out, *,
                          caption_dim: int = 4096):
    """Dual CLIP (+ T5) into SD3's ``(tokens, pooled)`` conditioning: the
    penultimate hidden states of both CLIPs, concatenated channel-wise and
    zero-padded to ``caption_dim``, then the T5 tokens after them along
    the sequence; pooled = both CLIP pooled projections, concatenated."""
    _, pooled_l, hs_l = clip_l_out
    _, pooled_g, hs_g = clip_g_out
    clip_tokens = torch.cat([hs_l[-2], hs_g[-2]], -1)
    clip_tokens = F.pad(clip_tokens, (0, caption_dim - clip_tokens.shape[-1]))
    tokens = clip_tokens if t5_out is None else \
        torch.cat([clip_tokens, t5_out], -2)
    return tokens, torch.cat([pooled_l, pooled_g], -1)
