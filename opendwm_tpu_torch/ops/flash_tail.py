"""Tail-masked attention for sequences that are not a multiple of 128.

Replaces the Pallas kernels of ``opendwm_tpu/ops/flash_tail.py``:

- K1 ``_forward`` (body ``_kernel``): non-causal, unbiased BSHD attention
  with an fp32 softmax over the S valid keys;
- K2 ``_backward`` (body ``_bwd_kernel``): dq, dk, dv from the recomputed
  masked softmax, with no probability matrix in global memory.

They serve the 602-token joint attention, the 448-token dual attention
and the 168-token rowwise cross-view attention, in serving and training.

The Hopper kernels are CUDA C++ in ``csrc/flash_tail.cu`` (design and what
bounds them are noted there; the same source holds K5 and K6, other tilings
of K1, wrapped in ``ops/tail_variants.py``), built with nvcc at first use
and called through ctypes. K1 in bf16 at head dim 64 runs the TMA + wgmma
forward of ``csrc/flash_fwd_sm90.cuh``, which K7 shares; ``sm90_launches``
counts those launches. A call that needs a gradient goes through an
autograd Function whose forward is K1 (also writing the row log-sum-exp)
and whose backward is K2. The wrappers take the plain PyTorch versions
only for CPU tensors; for a CUDA tensor they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from opendwm_tpu_torch.ops import _build

MAX_PADDED_SEQ = 1024  # dispatch bound kept from the JAX package

# Kernel launches, in total and by sequence length: the forward (K1, with
# the launches that also wrote the log-sum-exp counted apart, and those that
# ran the Hopper forward of csrc/flash_fwd_sm90.cuh) and the backward (K2).
launches = 0
launches_by_seq: dict[int, int] = {}
lse_launches = 0
sm90_launches = 0
backward_launches = 0
backward_launches_by_seq: dict[int, int] = {}


def reset_launches() -> None:
    global launches, lse_launches, sm90_launches, backward_launches
    launches = lse_launches = sm90_launches = backward_launches = 0
    launches_by_seq.clear()
    backward_launches_by_seq.clear()


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


def tail_masked_attention_backward_plain(q, k, v, do, scale: float):
    """Plain PyTorch version of the backward, step for step as
    ``opendwm_tpu/ops/flash_tail.py:_bwd_kernel``: fp32 logits and softmax;
    ``p`` rounded to ``q.dtype`` for ``dv = p^T dO``; ``dp = dO V^T``,
    ``delta = rowsum(dp * p)``, ``ds = p (dp - delta) scale`` in
    ``q.dtype``; ``dq = ds K``, ``dk = ds^T Q``; products of ``q.dtype``
    values accumulated in fp32; outputs in ``q.dtype``."""
    dt = q.dtype
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.softmax(logits, dim=-1)
    do = do.to(dt).float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), do)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v.float())
    delta = (dp * p).sum(-1, keepdim=True)
    ds = (p * (dp - delta) * scale).to(dt).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return dq.to(dt), dk.to(dt), dv.to(dt)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load_library("flash_tail.cu")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    shape = [i32, i32, i32, i32, ctypes.c_float, i32, ptr]
    lib.flash_tail_forward.argtypes = [ptr] * 4 + shape
    lib.flash_tail_forward_lse.argtypes = [ptr] * 5 + shape
    lib.flash_tail_backward.argtypes = [ptr] * 10 + shape
    # K5 / K6 (ops/tail_variants.py): the shape, then nh or bq, the stream
    lib.tail_hpack_forward.argtypes = [ptr] * 4 + shape[:-1] + [i32, ptr]
    lib.tail_qsplit_forward.argtypes = [ptr] * 4 + shape[:-1] + [i32, ptr]
    for fn in (lib.flash_tail_forward, lib.flash_tail_forward_lse,
               lib.flash_tail_backward, lib.tail_hpack_forward,
               lib.tail_qsplit_forward):
        fn.restype = ctypes.c_int
    lib.flash_tail_forward_takes_sm90.argtypes = [ptr] * 4 + [i32, i32]
    lib.flash_tail_forward_takes_sm90.restype = ctypes.c_int
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


def _raise_on_error(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.flash_tail_error_string(rc).decode()
        raise RuntimeError(f"flash_tail {what} launch failed: {msg} ({rc})")


def _launch_forward(q, k, v, scale: float, with_lse: bool):
    """K1 on CUDA tensors; also returns the row log-sum-exp if asked."""
    global launches, lse_launches, sm90_launches
    b, s, h, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(b * h, s, device=q.device, dtype=torch.float32) \
        if with_lse else None
    lib = _library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    is_bf16 = int(q.dtype == torch.bfloat16)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    args = (b, s, h, d, float(scale), is_bf16, stream)
    with torch.cuda.device(q.device):
        if with_lse:
            rc = lib.flash_tail_forward_lse(*ptrs, lse.data_ptr(), *args)
        else:
            rc = lib.flash_tail_forward(*ptrs, *args)
    _raise_on_error(lib, rc, "forward")
    launches += 1
    sm90_launches += lib.flash_tail_forward_takes_sm90(*ptrs, d, is_bf16)
    launches_by_seq[s] = launches_by_seq.get(s, 0) + 1
    lse_launches += int(with_lse)
    return out, lse


def _launch_backward(q, k, v, out, do, lse, scale: float):
    """K2 on CUDA tensors: (dq, dk, dv) of the forward that gave out, lse."""
    global backward_launches
    _check(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError("dO must match q in shape, dtype and device")
    do = do.contiguous()
    b, s, h, d = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(b * h, s, device=q.device, dtype=torch.float32)
    lib = _library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = lib.flash_tail_backward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, s, h, d, float(scale),
            int(q.dtype == torch.bfloat16), stream)
    _raise_on_error(lib, rc, "backward")
    backward_launches += 1
    backward_launches_by_seq[s] = backward_launches_by_seq.get(s, 0) + 1
    return dq, dk, dv


def tail_masked_attention_backward(q, k, v, out, do, lse, scale: float):
    """(dq, dk, dv): K2 on CUDA tensors (``out`` and ``lse`` from
    ``tail_masked_attention_forward``), the plain backward on CPU tensors
    (where ``out`` and ``lse`` are not read)."""
    if _on_device(q):
        return _launch_backward(q, k, v, out, do, lse, scale)
    return tail_masked_attention_backward_plain(q, k, v, do, scale)


def tail_masked_attention_forward(q, k, v, scale: float):
    """K1 writing the row log-sum-exp the backward needs: ``(out, lse)``
    on CUDA tensors; ``(plain out, None)`` on CPU tensors."""
    if _on_device(q):
        _check(q, k, v)
        return _launch_forward(q, k, v, scale, with_lse=True)
    return tail_masked_attention_plain(q, k, v, scale), None


class _TailMaskedAttention(torch.autograd.Function):
    """Forward K1 (with the log-sum-exp), backward K2; the plain versions
    of both on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = tail_masked_attention_forward(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        return (*tail_masked_attention_backward(q, k, v, out, do, lse,
                                                ctx.scale), None)


def _on_device(q) -> bool:
    """False for a CPU tensor (plain version); True for CUDA; else raise."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"flash_tail runs on CPU or CUDA, not {q.device}")
    return True


def tail_masked_attention(q, k, v, scale: float):
    """BSHD attention for any sequence length; kernels on CUDA tensors.

    A call that needs a gradient goes through the autograd Function (K1
    forward with the log-sum-exp, K2 backward)."""
    on_device = _on_device(q)
    if on_device:
        _check(q, k, v)
    if torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad
    ):
        return _TailMaskedAttention.apply(q, k, v, scale)
    if not on_device:
        return tail_masked_attention_plain(q, k, v, scale)
    return _launch_forward(q, k, v, scale, with_lse=False)[0]
