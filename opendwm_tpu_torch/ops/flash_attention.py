"""Flash attention for sequence lengths that are multiples of 128 (K7).

Replaces the stock Pallas TPU kernel
(``jax.experimental.pallas.ops.tpu.flash_attention``) that
``opendwm_tpu/ops/attention.py:dot_product_attention`` reaches when
``_can_use_flash`` holds: no bias, both sequence lengths multiples of 128
and at least 128, head_dim at most 256 (``supported`` below). It serves the
UNet's level-0 spatial self-attention (1792 tokens at 32x56 latents), in
serving and training.

The Hopper kernels are CUDA C++ in ``csrc/flash_attention.cu`` (design and
what bounds them are noted there; the bf16 forward at head dim 64, with or
without segment ids, runs the TMA + wgmma forward of
``csrc/flash_fwd_sm90.cuh`` that K1 shares, and ``sm90_launches`` counts
those launches), built with nvcc at first use and called through
ctypes: the forward, and the backward that replaces the stock kernel's
``custom_vjp`` backward (``_flash_attention_bwd_dkv`` and
``_flash_attention_bwd_dq``), ``csrc/flash_bwd.cuh``, which K2 shares: in
bf16 at head dim 64 the TMA + wgmma backward of
``csrc/flash_bwd_sm90.cuh`` (counted by ``sm90_backward_launches``; its
dQ sums go through an fp32 workspace, ``flash_tail.dq_workspace``). A call
that needs a gradient goes through an autograd Function whose forward also
writes the row log-sum-exp and whose backward is the kernel's. Causal masking is top-left, as the TPU kernel's:
key j is visible to query i iff j <= i, also when q and kv lengths differ
(the JAX package's XLA fallback masks bottom-right there). The wrappers
take the plain PyTorch versions only for CPU tensors; for a CUDA tensor
they launch the kernel or raise.

K7-seg: with ``segment_ids`` (``SegmentIds``, as the stock kernel takes
them) query i sees key j only where their ids are equal. It serves the
attention shoot-out (``perf/exp_attn602.py`` ``v_flashpad`` and its port
``opendwm_tpu_torch/perf/exp_attn602.py``), which pads a sequence to a
multiple of 128 and gives the pads segment 1; the JAX model never passes
segment ids, so ``ops/attention.py`` does not either. As in the stock
kernel, a pair whose ids differ gets the finite ``MASK_VALUE`` added to its
scaled logit, not -inf, so a query whose id no key shares attends to every
key alike (the mean of V). Its launches are counted apart from K7's.

K7-seg's backward replaces the stock kernel's backward given
``segment_ids`` (``_flash_attention_bwd_dkv`` / ``_dq``, jax 0.9.0
``flash_attention.py:941``, ``:1287``): a call with segment ids that needs
a gradient runs K7-seg writing the log-sum-exp, and its backward is the
one backward entry's (``csrc/flash_bwd.cuh`` ``backward_segment``, built
from ``csrc/flash_segment.cu``) with the ids. The
log-sum-exp is in the log2 domain with the mask added after the scores
are scaled there, as the kernel's forward adds it; a row that sees no key
of its segment has an lse of ``MASK_VALUE`` (its count of keys vanishes
beside it), and the backward gives it back the stock kernel's uniform
probabilities 1 / n (``flash_attention_backward_plain``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from opendwm_tpu_torch.ops import _build
from opendwm_tpu_torch.ops.flash_tail import dq_workspace

MIN_SEQ = 128
MAX_HEAD_DIM = 256
_LOG2E = 1.4426950408889634
# The stock kernel's DEFAULT_MASK_VALUE, added to the scaled logit of a
# (query, key) pair whose segment ids differ.
MASK_VALUE = -0.7 * torch.finfo(torch.float32).max


class SegmentIds(NamedTuple):
    """int32 segment ids of the queries, ``(B, Sq)``, and of the keys,
    ``(B, Skv)``: query i sees key j only where their ids are equal (the
    stock kernel's ``SegmentIds``)."""

    q: torch.Tensor
    kv: torch.Tensor

# Kernel launches, in total and by (batch, q_seq, kv_seq, heads, head_dim):
# the forward (with the launches that also wrote the log-sum-exp counted
# apart), the backward, and the forward with segment ids (K7-seg); the
# forward launches of both kinds that ran the Hopper forward of
# csrc/flash_fwd_sm90.cuh, and the backward launches that ran the Hopper
# backward of csrc/flash_bwd_sm90.cuh.
launches = 0
launches_by_shape: dict[tuple[int, int, int, int, int], int] = {}
lse_launches = 0
sm90_launches = 0
backward_launches = 0
backward_launches_by_shape: dict[tuple[int, int, int, int, int], int] = {}
segment_launches = 0
segment_lse_launches = 0  # those of them that also wrote the log-sum-exp
segment_launches_by_shape: dict[tuple[int, int, int, int, int], int] = {}
sm90_backward_launches = 0
# K7-seg's backward: its launches, by shape, and those that ran the Hopper
# backward.
segment_backward_launches = 0
segment_backward_launches_by_shape: dict[tuple[int, int, int, int, int],
                                         int] = {}
segment_sm90_backward_launches = 0


def reset_launches() -> None:
    global launches, lse_launches, backward_launches, segment_launches
    global segment_lse_launches, sm90_launches, sm90_backward_launches
    global segment_backward_launches, segment_sm90_backward_launches
    launches = lse_launches = backward_launches = segment_launches = 0
    segment_lse_launches = 0
    sm90_launches = sm90_backward_launches = 0
    segment_backward_launches = segment_sm90_backward_launches = 0
    launches_by_shape.clear()
    backward_launches_by_shape.clear()
    segment_launches_by_shape.clear()
    segment_backward_launches_by_shape.clear()


def supported(q_seq: int, kv_seq: int, head_dim: int) -> bool:
    """The shapes ``dot_product_attention`` sends here: the JAX package's
    ``_can_use_flash`` shape rules."""
    return (
        q_seq >= MIN_SEQ and kv_seq >= MIN_SEQ
        and q_seq % 128 == 0 and kv_seq % 128 == 0
        and head_dim <= MAX_HEAD_DIM
    )


def _hidden(q_len: int, k_len: int, device) -> torch.Tensor:
    """Top-left causal mask: True where key j is hidden from query i."""
    return torch.ones(q_len, k_len, dtype=torch.bool, device=device).triu(1)


def _logits(q, k, scale: float, causal: bool,
            segment_ids: SegmentIds | None = None):
    """fp32 ``(b, h, q, k)`` scaled scores: causally hidden pairs at -inf,
    pairs of different segments plus ``MASK_VALUE``."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if segment_ids is not None:
        same = segment_ids.q[:, None, :, None] == segment_ids.kv[:, None, None]
        logits = logits + torch.where(same, 0.0, MASK_VALUE)
    if causal:
        logits = logits.masked_fill(
            _hidden(logits.shape[-2], logits.shape[-1], q.device),
            float("-inf"))
    return logits


def flash_attention_plain(q, k, v, scale: float, causal: bool = False,
                          segment_ids: SegmentIds | None = None):
    """Plain PyTorch version over BSHD tensors: fp32 logits and softmax,
    probabilities in ``v.dtype``, output in ``q.dtype``; ``causal`` masks
    top-left (key j visible to query i iff j <= i); ``segment_ids`` add
    ``MASK_VALUE`` to the scaled logits of pairs whose ids differ, as the
    stock kernel does (a row that sees no key of its segment gets the mean
    of V over its causally visible keys; the stock kernel adds the finite
    value to causally hidden pairs too, so there such a row's output
    depends on which of its blocks run, and only rows that see a key of
    their segment are the same function)."""
    logits = _logits(q, k, scale, causal, segment_ids)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v).to(q.dtype)


def _log2_scores(q, k, scale: float, causal: bool,
                 segment_ids: SegmentIds):
    """fp32 ``(b, h, q, k)`` scores in the log2 domain as the kernels
    form them under segment ids: scaled into the log2 domain, then
    ``MASK_VALUE`` added where the ids differ (before, the product with
    log2(e) would overflow it to -inf); causally hidden pairs at -inf."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * \
        (scale * _LOG2E)
    same = segment_ids.q[:, None, :, None] == segment_ids.kv[:, None, None]
    scores = scores + torch.where(same, 0.0, MASK_VALUE)
    if causal:
        scores = scores.masked_fill(
            _hidden(scores.shape[-2], scores.shape[-1], q.device),
            float("-inf"))
    return scores


def _segment_probs(scores, lse):
    """``exp2(scores - lse)``; a row that sees no key of its segment (its
    lse is ``MASK_VALUE``: every visible score equals it, and log2 of the
    count vanishes beside it) gets 1 / n over its n visible keys, the
    stock kernel's uniform probabilities."""
    p = torch.exp2(scores - lse[..., None])
    hidden = (lse < 0.5 * MASK_VALUE)[..., None]
    n = torch.isfinite(scores).sum(-1, keepdim=True).clamp_min(1)
    return torch.where(hidden, p / n, p)


def flash_attention_forward_plain(q, k, v, scale: float,
                                  causal: bool = False,
                                  segment_ids: SegmentIds | None = None):
    """``(out, lse)``: the plain forward and the row log-sum-exp that the
    kernel's forward writes for the backward, fp32 ``(b * h, q_seq)`` in
    the log2 domain of the scaled scores (with segment ids, of
    ``_log2_scores``: the running max plus log2 of the sum, as the kernel
    takes it)."""
    if segment_ids is not None:
        scores = _log2_scores(q, k, scale, causal, segment_ids)
        m = scores.amax(-1, keepdim=True)
        lse = (m + torch.log2(torch.exp2(scores - m).sum(-1, keepdim=True))
               )[..., 0]
        probs = _segment_probs(scores, lse).to(v.dtype)
    else:
        logits = _logits(q, k, scale, causal)
        lse = torch.logsumexp(logits, dim=-1) * _LOG2E
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v).to(q.dtype)
    return out, lse.reshape(-1, q.shape[1])


def flash_attention_backward_plain(q, k, v, o, lse, do, scale: float,
                                   causal: bool = False,
                                   segment_ids: SegmentIds | None = None):
    """Plain PyTorch version of the backward, step for step as the stock
    kernel's ``_flash_attention_bwd``: ``di = rowsum(o * do)`` in fp32;
    ``p = exp(s * scale - lse)`` from the forward's ``lse``
    (``flash_attention_forward_plain``; the stock kernel keeps the max and
    the sum apart), 0 where hidden; ``dv = p^T dO`` with ``p`` in
    ``q.dtype``; ``dp = dO V^T``; ``ds = (dp - di) p scale`` in
    ``q.dtype``; ``dq = ds K``, ``dk = ds^T Q``; products of ``q.dtype``
    values accumulated in fp32; outputs in ``q.dtype``. With segment ids
    ``p`` is ``_segment_probs`` of ``_log2_scores`` (the stock kernel's
    masked logits; 1 / n on a row that sees no key of its segment)."""
    dt = q.dtype
    b, sq, h, _ = q.shape
    lse = lse.reshape(b, h, sq).float()
    if segment_ids is not None:
        p = _segment_probs(_log2_scores(q, k, scale, causal, segment_ids),
                           lse)
    else:
        logits = _logits(q, k, scale, causal)
        p = torch.exp2(logits * _LOG2E - lse[..., None])
    do = do.to(dt).float()
    di = (o.float() * do).sum(-1).permute(0, 2, 1)[..., None]
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), do)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v.float())
    ds = ((dp - di) * p * scale).to(dt).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return dq.to(dt), dk.to(dt), dv.to(dt)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load_library("flash_attention.cu")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    shape = [i32, i32, i32, i32, i32, ctypes.c_float, i32, i32, ptr]
    lib.flash_attention_forward.argtypes = [ptr] * 4 + shape
    lib.flash_attention_forward_lse.argtypes = [ptr] * 5 + shape
    lib.flash_attention_backward.argtypes = [ptr] * 11 + shape
    lib.flash_attention_forward_segment.argtypes = [ptr] * 6 + shape
    lib.flash_attention_forward_segment_lse.argtypes = [ptr] * 7 + shape
    for fn in (lib.flash_attention_forward, lib.flash_attention_forward_lse,
               lib.flash_attention_backward,
               lib.flash_attention_forward_segment,
               lib.flash_attention_forward_segment_lse):
        fn.restype = ctypes.c_int
    lib.flash_attention_forward_takes_sm90.argtypes = [ptr] * 4 + [i32, i32]
    lib.flash_attention_forward_takes_sm90.restype = ctypes.c_int
    lib.flash_attention_backward_takes_sm90.argtypes = [ptr] * 6 + [i32, i32]
    lib.flash_attention_backward_takes_sm90.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _segment_library() -> ctypes.CDLL:
    """K7-seg's backward (``csrc/flash_segment.cu``)."""
    lib = _build.load_library("flash_segment.cu")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_backward_segment.argtypes = [ptr] * 13 + [
        i32, i32, i32, i32, i32, ctypes.c_float, i32, i32, ptr]
    lib.flash_attention_backward_segment.restype = ctypes.c_int
    lib.flash_segment_backward_takes_sm90.argtypes = [ptr] * 6 + [i32, i32]
    lib.flash_segment_backward_takes_sm90.restype = ctypes.c_int
    lib.flash_segment_error_string.argtypes = [ctypes.c_int]
    lib.flash_segment_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Compile and load the CUDA kernels now rather than at first launch."""
    _library()
    _segment_library()


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


def _check_segment_ids(segment_ids: SegmentIds, q, k) -> None:
    b, sq, sk = q.shape[0], q.shape[1], k.shape[1]
    for name, ids, shape in (("q", segment_ids.q, (b, sq)),
                             ("kv", segment_ids.kv, (b, sk))):
        if tuple(ids.shape) != shape or ids.dtype != torch.int32 or \
                ids.device != q.device:
            raise ValueError(
                f"segment ids {name} must be int32 of shape {shape} on "
                f"{q.device}, not {ids.dtype} {tuple(ids.shape)} on "
                f"{ids.device}")


def _raise_on_error(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.flash_attention_error_string(rc).decode()
        raise RuntimeError(f"flash_attention {what} launch failed: {msg} "
                           f"({rc})")


def _launch(q, k, v, scale: float, causal: bool, with_lse: bool = False):
    """K7 on CUDA tensors: ``(out, lse)``, ``lse`` None unless asked."""
    global launches, lse_launches, sm90_launches
    _check(q, k, v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    out = torch.empty_like(q)
    lse = torch.empty(b * h, sq, device=q.device, dtype=torch.float32) \
        if with_lse else None
    lib = _library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    is_bf16 = int(q.dtype == torch.bfloat16)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    args = (b, sq, sk, h, d, float(scale), int(causal), is_bf16, stream)
    with torch.cuda.device(q.device):
        if with_lse:
            rc = lib.flash_attention_forward_lse(*ptrs, lse.data_ptr(), *args)
        else:
            rc = lib.flash_attention_forward(*ptrs, *args)
    _raise_on_error(lib, rc, "forward")
    launches += 1
    lse_launches += int(with_lse)
    sm90_launches += lib.flash_attention_forward_takes_sm90(*ptrs, d, is_bf16)
    key = (b, sq, sk, h, d)
    launches_by_shape[key] = launches_by_shape.get(key, 0) + 1
    return out, lse


def _launch_segment(q, k, v, scale: float, causal: bool,
                    segment_ids: SegmentIds, with_lse: bool = False):
    """K7-seg on CUDA tensors: ``(out, lse)``, ``lse`` None unless asked."""
    global segment_launches, sm90_launches, segment_lse_launches
    _check(q, k, v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    q_ids, kv_ids = (ids.contiguous() for ids in segment_ids)
    out = torch.empty_like(q)
    lse = torch.empty(b * h, sq, device=q.device, dtype=torch.float32) \
        if with_lse else None
    lib = _library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    is_bf16 = int(q.dtype == torch.bfloat16)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    args = (q_ids.data_ptr(), kv_ids.data_ptr(), b, sq, sk, h, d,
            float(scale), int(causal), is_bf16, stream)
    with torch.cuda.device(q.device):
        if with_lse:
            rc = lib.flash_attention_forward_segment_lse(
                *ptrs, lse.data_ptr(), *args)
        else:
            rc = lib.flash_attention_forward_segment(*ptrs, *args)
    _raise_on_error(lib, rc, "segment forward")
    segment_launches += 1
    segment_lse_launches += int(with_lse)
    sm90_launches += lib.flash_attention_forward_takes_sm90(*ptrs, d, is_bf16)
    key = (b, sq, sk, h, d)
    segment_launches_by_shape[key] = segment_launches_by_shape.get(key, 0) + 1
    return out, lse


def _launch_backward(q, k, v, out, do, lse, scale: float, causal: bool,
                     segment_ids: SegmentIds | None = None):
    """The K7 backward on CUDA tensors (K7-seg's with ``segment_ids``):
    (dq, dk, dv) of the forward that gave ``out`` and ``lse``."""
    global backward_launches, sm90_backward_launches
    global segment_backward_launches, segment_sm90_backward_launches
    _check(q, k, v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    for name, t, shape, dtype in (("dO", do, q.shape, q.dtype),
                                  ("out", out, q.shape, q.dtype),
                                  ("lse", lse, (b * h, sq), torch.float32)):
        if t.shape != shape or t.dtype != dtype or t.device != q.device:
            raise ValueError(
                f"{name} must be {dtype} of shape {tuple(shape)} on "
                f"{q.device}, not {t.dtype} {tuple(t.shape)} on {t.device}")
    out, do, lse = out.contiguous(), do.contiguous(), lse.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(b * h, sq, device=q.device, dtype=torch.float32)
    lib = _library()
    is_bf16 = int(q.dtype == torch.bfloat16)
    sm90 = lib.flash_attention_backward_takes_sm90(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), d, is_bf16)
    ws = dq_workspace(b, sq, h, q.device) if sm90 else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            None if ws is None else ws.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr())
    args = (b, sq, sk, h, d, float(scale), int(causal), is_bf16, stream)
    key = (b, sq, sk, h, d)
    with torch.cuda.device(q.device):
        if segment_ids is None:
            rc = lib.flash_attention_backward(*ptrs, *args)
        else:
            q_ids, kv_ids = (ids.contiguous() for ids in segment_ids)
            rc = _segment_library().flash_attention_backward_segment(
                *ptrs, q_ids.data_ptr(), kv_ids.data_ptr(), *args)
    if segment_ids is not None:
        if rc != 0:
            msg = _segment_library().flash_segment_error_string(rc).decode()
            raise RuntimeError(f"flash_attention segment backward launch "
                               f"failed: {msg} ({rc})")
        segment_backward_launches += 1
        segment_sm90_backward_launches += sm90
        segment_backward_launches_by_shape[key] = \
            segment_backward_launches_by_shape.get(key, 0) + 1
        return dq, dk, dv
    _raise_on_error(lib, rc, "backward")
    backward_launches += 1
    sm90_backward_launches += sm90
    backward_launches_by_shape[key] = \
        backward_launches_by_shape.get(key, 0) + 1
    return dq, dk, dv


def _on_device(q) -> bool:
    """False for a CPU tensor (plain version); True for CUDA; else raise."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CPU or CUDA, not "
                         f"{q.device}")
    return True


def flash_attention_forward(q, k, v, scale: float, causal: bool = False,
                            segment_ids: SegmentIds | None = None):
    """``(out, lse)`` for the backward: K7 (K7-seg with ``segment_ids``)
    writing the row log-sum-exp on CUDA tensors,
    ``flash_attention_forward_plain`` on CPU tensors."""
    if _on_device(q):
        if segment_ids is not None:
            _check_segment_ids(segment_ids, q, k)
            return _launch_segment(q, k, v, scale, causal, segment_ids,
                                   with_lse=True)
        return _launch(q, k, v, scale, causal, with_lse=True)
    return flash_attention_forward_plain(q, k, v, scale, causal, segment_ids)


def flash_attention_backward(q, k, v, out, do, lse, scale: float,
                             causal: bool = False,
                             segment_ids: SegmentIds | None = None):
    """(dq, dk, dv) of ``flash_attention_forward``'s ``(out, lse)``: the
    kernel on CUDA tensors (K7-seg's backward with ``segment_ids``),
    ``flash_attention_backward_plain`` on CPU tensors."""
    if _on_device(q):
        return _launch_backward(q, k, v, out, do, lse, scale, causal,
                                segment_ids)
    return flash_attention_backward_plain(q, k, v, out, lse, do, scale,
                                          causal, segment_ids)


class _FlashAttention(torch.autograd.Function):
    """Forward K7 (K7-seg with segment ids) with the log-sum-exp, backward
    the K7 backward given the same ids; the plain versions of both on CPU
    tensors."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, q_ids, kv_ids):
        ids = None if q_ids is None else SegmentIds(q_ids, kv_ids)
        out, lse = flash_attention_forward(q, k, v, scale, causal, ids)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.causal, ctx.ids = scale, causal, ids
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        return (*flash_attention_backward(q, k, v, out, do, lse, ctx.scale,
                                          ctx.causal, ctx.ids),
                None, None, None, None)


def flash_attention(q, k, v, scale: float, causal: bool = False,
                    segment_ids: SegmentIds | None = None):
    """BSHD attention: K7 (K7-seg with ``segment_ids``) on CUDA tensors,
    the plain version on CPU ones.

    A call that needs a gradient goes through the autograd Function (K7 or
    K7-seg with the log-sum-exp forward, the K7 backward with the same
    ids)."""
    on_device = _on_device(q)
    if segment_ids is not None:
        _check_segment_ids(segment_ids, q, k)
    if torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad
    ):
        q_ids, kv_ids = segment_ids if segment_ids is not None \
            else (None, None)
        return _FlashAttention.apply(q, k, v, scale, causal, q_ids, kv_ids)
    if not on_device:
        return flash_attention_plain(q, k, v, scale, causal, segment_ids)
    if segment_ids is not None:
        return _launch_segment(q, k, v, scale, causal, segment_ids)[0]
    return _launch(q, k, v, scale, causal)[0]
