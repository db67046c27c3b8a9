"""Attention dispatch over BSHD tensors (``opendwm_tpu/ops/attention.py``).

Dispatch rules, in the JAX package's order (its TPU branches):

- the flash kernel (``ops/flash_attention.py``, K7) for unbiased shapes
  whose sequence lengths are multiples of 128 (``flash_attention.supported``),
  causal or not; its causal mask is top-left, as the TPU kernel's;
- the tiny-sequence form for ``q_seq == kv_seq <= 16`` (the temporal
  ``pointwise`` branch attends over t frames per token), all in fp32;
- the tail-masked kernel (``ops/flash_tail.py``, K1) for self-attention
  shapes that meet ``flash_tail.supported`` with no bias and no causal mask;
- plain math with an fp32 softmax otherwise (causal masked bottom-right).

The kernels' wrappers run their plain versions on CPU tensors.
"""

from __future__ import annotations

import math

import torch

from opendwm_tpu_torch.ops import flash_attention, flash_tail

_TINY_MAX_SEQ = 16


def _tiny_seq_attention(q, k, v, scale, bias=None):
    """fp32 attention for tiny sequences (``attention.py:_tiny_seq_attention``).

    ``bias``: optional additive ``(b_or_1, heads, q_seq, kv_seq)`` term."""
    logits = torch.einsum("bihd,bjhd->bhij", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhij,bjhd->bihd", probs, v.float())


def _plain_attention(q, k, v, bias, scale, is_causal):
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    if is_causal:
        q_len, k_len = logits.shape[-2], logits.shape[-1]
        causal = torch.ones(q_len, k_len, dtype=torch.bool,
                            device=q.device).tril(k_len - q_len)
        logits = logits.masked_fill(~causal, float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def dot_product_attention(q, k, v, bias=None, scale=None, is_causal=False):
    """Multi-head attention over ``(batch, seq, heads, head_dim)`` tensors.

    k/v may have fewer heads (grouped-query); they are repeated. ``bias``
    is an additive term broadcastable to ``(batch, heads, q_seq, kv_seq)``.
    ``scale`` defaults to ``1/sqrt(head_dim)``.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if k.shape[2] != q.shape[2]:
        reps = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(reps, dim=2)
        v = v.repeat_interleave(reps, dim=2)
    q_seq, kv_seq = q.shape[1], k.shape[1]
    if bias is None and flash_attention.supported(q_seq, kv_seq, q.shape[-1]):
        return flash_attention.flash_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), scale, is_causal)
    if (
        not is_causal
        and (bias is None or bias.ndim == 4)
        and q_seq == kv_seq <= _TINY_MAX_SEQ
    ):
        return _tiny_seq_attention(q, k, v, scale, bias).to(q.dtype)
    if (
        bias is None
        and not is_causal
        and flash_tail.supported(q_seq, kv_seq, q.shape[-1])
    ):
        return flash_tail.tail_masked_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), scale
        ).to(q.dtype)
    return _plain_attention(q, k, v, bias, scale, is_causal).to(q.dtype)
