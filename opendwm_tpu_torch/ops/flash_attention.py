"""Flash attention for sequence lengths that are multiples of 128 (K7).

Replaces the stock Pallas TPU kernel
(``jax.experimental.pallas.ops.tpu.flash_attention``) that
``opendwm_tpu/ops/attention.py:dot_product_attention`` reaches when
``_can_use_flash`` holds: no bias, both sequence lengths multiples of 128
and at least 128, head_dim at most 256 (``supported`` below). It serves the
UNet's level-0 spatial self-attention (1792 tokens at 32x56 latents).

The Hopper kernel is CUDA C++ in ``csrc/flash_attention.cu`` (design and
what bounds it are noted there), built with nvcc at first use and called
through ctypes. Causal masking is top-left, as the TPU kernel's: key j is
visible to query i iff j <= i, also when q and kv lengths differ (the JAX
package's XLA fallback masks bottom-right there). The wrapper takes the
plain PyTorch version only for CPU tensors; for a CUDA tensor it launches
the kernel or raises. The kernel has a forward only: its backward waits
for the UNet training slice (ROADMAP Queue 2, K7).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from opendwm_tpu_torch.ops import _build

MIN_SEQ = 128
MAX_HEAD_DIM = 256

# Kernel launches, in total and by (batch, q_seq, kv_seq, heads, head_dim).
launches = 0
launches_by_shape: dict[tuple[int, int, int, int, int], int] = {}


def reset_launches() -> None:
    global launches
    launches = 0
    launches_by_shape.clear()


def supported(q_seq: int, kv_seq: int, head_dim: int) -> bool:
    """The shapes ``dot_product_attention`` sends here: the JAX package's
    ``_can_use_flash`` shape rules."""
    return (
        q_seq >= MIN_SEQ and kv_seq >= MIN_SEQ
        and q_seq % 128 == 0 and kv_seq % 128 == 0
        and head_dim <= MAX_HEAD_DIM
    )


def flash_attention_plain(q, k, v, scale: float, causal: bool = False):
    """Plain PyTorch version over BSHD tensors: fp32 logits and softmax,
    probabilities in ``v.dtype``, output in ``q.dtype``; ``causal`` masks
    top-left (key j visible to query i iff j <= i)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        q_len, k_len = logits.shape[-2], logits.shape[-1]
        hidden = torch.ones(q_len, k_len, dtype=torch.bool,
                            device=q.device).triu(1)
        logits = logits.masked_fill(hidden, float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v).to(q.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load_library("flash_attention.cu")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_forward.argtypes = [ptr] * 4 + [
        i32, i32, i32, i32, i32, ctypes.c_float, i32, i32, ptr]
    lib.flash_attention_forward.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Compile and load the CUDA kernel now rather than at first launch."""
    _library()


def _check(q, k, v) -> None:
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4 or \
            q.shape[0] != k.shape[0] or q.shape[2:] != k.shape[2:]:
        raise ValueError(
            f"q must be (B, Sq, H, D) and k/v (B, Skv, H, D); got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash_attention kernel takes bf16 or fp32, not "
                        f"{q.dtype}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q/k/v must share one dtype")
    if not (q.device == k.device == v.device):
        raise ValueError("q/k/v must lie on one device")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention kernel takes contiguous BSHD "
                         "tensors")
    if q.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {q.shape[-1]} > {MAX_HEAD_DIM}")


def _launch(q, k, v, scale: float, causal: bool):
    global launches
    _check(q, k, v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    out = torch.empty_like(q)
    lib = _library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
            sk, h, d, float(scale), int(causal),
            int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        msg = lib.flash_attention_error_string(rc).decode()
        raise RuntimeError(f"flash_attention launch failed: {msg} ({rc})")
    launches += 1
    key = (b, sq, sk, h, d)
    launches_by_shape[key] = launches_by_shape.get(key, 0) + 1
    return out


def flash_attention(q, k, v, scale: float, causal: bool = False):
    """BSHD attention: K7 on CUDA tensors, the plain version on CPU ones."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CPU or CUDA, not "
                         f"{q.device}")
    if torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad
    ):
        raise NotImplementedError(
            "K7's backward is not ported yet (ROADMAP Queue 2, K7: it comes "
            "with the UNet training slice, Queue 1 item 9)")
    return _launch(q, k, v, scale, causal)
