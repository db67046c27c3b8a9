"""Other tilings of the tail-masked attention: K5 and K6.

Replaces the Pallas kernels of the tiling experiment ``perf/exp_tailvar.py``:

- K5 ``tail_hpack`` (body ``_hpack_kernel``): one grid step takes ``nh``
  batch-heads, all of their query rows against all keys;
- K6 ``tail_qsplit`` (body ``_qsplit_kernel``): one grid step takes ``bq``
  query rows of one batch-head against all keys.

Both compute K1's function (``ops/flash_tail.py``): non-causal BSHD
attention over the S valid keys with an fp32 softmax, the unnormalised
probabilities rounded to the input type before the product with v. Only the
experiment (``opendwm_tpu_torch/perf/exp_tailvar.py``) runs them; the
attention dispatch never does, as in the JAX package.

The Hopper kernels are CUDA C++ beside K1 in ``csrc/flash_tail.cu`` (one
block per TPU grid step) and share its library. In bf16 at head dim 64
with 16-byte-aligned tensors (K1's rule) they run
``csrc/tail_tiling_sm90.cuh``: K1's TMA + wgmma mainloop in two consumer
warpgroups that share each K/V stage, so they give K1's bits; the
launches that did are counted apart (``hpack_sm90_launches``,
``qsplit_sm90_launches``). Their other launches run the mma.sync or FMA
tile step of K1's other launches, again K1's bits. The wrappers take the
plain version only for CPU tensors; for a CUDA tensor they launch the
kernel or raise. No gradient: the experiment defines none.
"""

from __future__ import annotations

import torch

from opendwm_tpu_torch.ops import flash_tail

# Kernel launches by tiling (nh for K5, the effective bq for K6), and those
# that ran the Hopper kernel of csrc/tail_tiling_sm90.cuh.
hpack_launches_by_nh: dict[int, int] = {}
qsplit_launches_by_bq: dict[int, int] = {}
hpack_sm90_launches = 0
qsplit_sm90_launches = 0


def reset_launches() -> None:
    global hpack_sm90_launches, qsplit_sm90_launches
    hpack_launches_by_nh.clear()
    qsplit_launches_by_bq.clear()
    hpack_sm90_launches = qsplit_sm90_launches = 0


def tail_attention_plain(q, k, v, scale: float):
    """Plain PyTorch version, step for step as ``_hpack_kernel`` and
    ``_qsplit_kernel``: fp32 scores times ``scale``, ``m = rowmax``,
    ``p = exp(s - m)`` and ``l = rowsum(p)`` in fp32, ``o = p.to(q.dtype) v``
    accumulated in fp32, ``o / l`` in ``q.dtype``. Keys past S do not exist
    here, which is what the TPU kernels' -1e30 mask gives them."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype).float(), v.float())
    return (o / l.transpose(1, 2)).to(q.dtype)


tail_hpack_plain = tail_attention_plain
tail_qsplit_plain = tail_attention_plain


def effective_bq(seq: int, bq: int) -> int:
    """The query rows of one K6 grid step: ``bq`` cut by 128 until it
    divides S padded to a multiple of 128 (``perf/exp_tailvar.py:123-124``).
    The kernel takes 128 or 256."""
    if bq <= 0 or bq % 128:
        raise ValueError(f"bq must be a positive multiple of 128, not {bq}")
    padded = -(-seq // 128) * 128
    while padded % bq:
        bq -= 128
    if bq not in (128, 256):
        raise ValueError(f"tail_qsplit runs 128- or 256-row blocks; bq cuts "
                         f"to {bq} at S = {seq}")
    return bq


def _launch(entry: str, q, k, v, scale: float, tiling: int):
    """One launch: the output, and 1 if it ran the Hopper kernel, else 0."""
    lib = flash_tail._library()
    b, s, h, d = q.shape
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    is_bf16 = int(q.dtype == torch.bfloat16)
    with torch.cuda.device(q.device):
        rc = getattr(lib, entry)(*ptrs, b, s, h, d, float(scale), is_bf16,
                                 tiling, stream)
    flash_tail._raise_on_error(lib, rc, entry)
    return out, lib.tail_tiling_takes_sm90(*ptrs, d, is_bf16)


def tail_hpack(q, k, v, scale: float, nh: int):
    """K5 on CUDA tensors (one block per ``nh`` batch-heads), the plain
    version on CPU tensors. ``nh`` must divide the head count."""
    global hpack_sm90_launches
    on_device = flash_tail._on_device(q)
    flash_tail._check(q, k, v)
    if nh <= 0 or q.shape[2] % nh:
        raise ValueError(f"nh = {nh} must divide the {q.shape[2]} heads")
    if not on_device:
        return tail_attention_plain(q, k, v, scale)
    out, sm90 = _launch("tail_hpack_forward", q, k, v, scale, nh)
    hpack_launches_by_nh[nh] = hpack_launches_by_nh.get(nh, 0) + 1
    hpack_sm90_launches += sm90
    return out


def tail_qsplit(q, k, v, scale: float, bq: int):
    """K6 on CUDA tensors (one block per ``effective_bq(S, bq)`` query rows
    of one batch-head), the plain version on CPU tensors."""
    global qsplit_sm90_launches
    on_device = flash_tail._on_device(q)
    flash_tail._check(q, k, v)
    bq = effective_bq(q.shape[1], bq)
    if not on_device:
        return tail_attention_plain(q, k, v, scale)
    out, sm90 = _launch("tail_qsplit_forward", q, k, v, scale, bq)
    qsplit_launches_by_bq[bq] = qsplit_launches_by_bq.get(bq, 0) + 1
    qsplit_sm90_launches += sm90
    return out
