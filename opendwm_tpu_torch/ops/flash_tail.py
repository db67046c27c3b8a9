"""Tail-masked attention for sequences that are not a multiple of 128.

Replaces the Pallas kernel ``opendwm_tpu/ops/flash_tail.py:_forward``
(body ``_kernel``): non-causal, unbiased BSHD attention with an fp32
softmax over the S valid keys. It serves the serving path's 602-token
joint attention, 448-token dual attention and 168-token rowwise
cross-view attention.

The Hopper kernel is CUDA C++ in ``csrc/flash_tail.cu`` (design and what
bounds it are noted there), built with nvcc at first use and called
through ctypes. The wrapper takes the plain PyTorch version only for CPU
tensors; for a CUDA tensor it launches the kernel or raises. The kernel
has no backward yet (ROADMAP Queue 2, item K2), so a CUDA call that would
need one raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from opendwm_tpu_torch.ops import _build

MAX_PADDED_SEQ = 1024  # dispatch bound kept from the JAX package

# Kernel launches, in total and by sequence length.
launches = 0
launches_by_seq: dict[int, int] = {}


def reset_launches() -> None:
    global launches
    launches = 0
    launches_by_seq.clear()


def _pad_len(n: int) -> int:
    return -(-n // 128) * 128


def supported(q_seq: int, kv_seq: int, head_dim: int) -> bool:
    """The shapes ``dot_product_attention`` sends here (as in the JAX package)."""
    return (
        q_seq == kv_seq
        and 128 <= q_seq
        and _pad_len(q_seq) <= MAX_PADDED_SEQ
        and head_dim <= 128
    )


def tail_masked_attention_plain(q, k, v, scale: float):
    """Plain PyTorch version: fp32 logits and softmax, probabilities in
    ``v.dtype`` (``opendwm_tpu/ops/flash_tail.py:_xla_reference``)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load_library("flash_tail.cu")
    lib.flash_tail_forward.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.flash_tail_forward.restype = ctypes.c_int
    lib.flash_tail_error_string.argtypes = [ctypes.c_int]
    lib.flash_tail_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Compile and load the CUDA kernel now rather than at first launch."""
    _library()


def _check(q, k, v) -> None:
    if not (q.shape == k.shape == v.shape) or q.ndim != 4:
        raise ValueError(
            f"q/k/v must share one (B, S, H, D) shape; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash_tail kernel takes bf16 or fp32, not {q.dtype}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q/k/v must share one dtype")
    if not (q.device == k.device == v.device):
        raise ValueError("q/k/v must lie on one device")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_tail kernel takes contiguous BSHD tensors")
    if q.shape[-1] > 128:
        raise ValueError(f"head_dim {q.shape[-1]} > 128")


def tail_masked_attention(q, k, v, scale: float):
    """BSHD attention for any sequence length; kernel on CUDA tensors."""
    global launches
    if q.device.type == "cpu":
        return tail_masked_attention_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_tail runs on CPU or CUDA, not {q.device}")
    _check(q, k, v)
    if torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad
    ):
        raise NotImplementedError(
            "flash_tail has no backward kernel yet (ROADMAP Queue 2, item "
            "K2); run inference under torch.no_grad()/inference_mode()"
        )
    b, s, h, d = q.shape
    out = torch.empty_like(q)
    lib = _library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = lib.flash_tail_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, h, d, float(scale), int(q.dtype == torch.bfloat16), stream,
        )
    if rc != 0:
        msg = lib.flash_tail_error_string(rc).decode()
        raise RuntimeError(f"flash_tail kernel launch failed: {msg} ({rc})")
    launches += 1
    launches_by_seq[s] = launches_by_seq.get(s, 0) + 1
    return out
