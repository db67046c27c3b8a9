"""Ring attention: exact attention with the sequence split over a ring of
ranks (``opendwm_tpu/ops/ring_attention.py``).

Each rank holds its slice of the queries, keys and values; the key/value
slices travel around the ring (``batch_isend_irecv`` to the next rank,
from the previous one) and each step attends the local queries to the
slice at hand and merges the block into an online-softmax accumulator, so
the result is the attention over the whole sequence. The backward is the
standard ring backward: every block is recomputed from the global row
log-sum-exp, dQ is summed locally, and the dK/dV accumulators travel with
their key/value slice and come home after a full turn.

The per-rank block step (``block_forward`` + ``merge``; ``block_backward``)
is kept apart from the exchange, so ``ring_steps`` / ``ring_steps_backward``
run n ranks' steps in one process on the same functions in the same order
(the collective and the one-process form give the same bits on the CPU).

Block step. On CUDA tensors: the port's hand-written attention forward
with its log-sum-exp, K7 (``ops/flash_attention.py``) where the slice
length is a multiple of 128, else K1 (``ops/flash_tail.py``; the 301-token
slices of a 602-token ring at n = 2); the block backward is the K7/K2
backward entry (``csrc/flash_bwd.cuh``) given the global log-sum-exp and
the global output. On CPU tensors: the plain version, JAX's
``_block_attend`` (fp32 logits, the probabilities cast to v's dtype), whose
unnormalised output, row max and row sum the merge takes; a kernel block
enters the merge as (its output, its log-sum-exp, 1).

``ring_attention_sharded`` takes the local slices and returns the local
output; ``ring_attention_replicated`` takes replicated tensors, slices
them, rings, and all-gathers the output (its gradients are the
single-device ones on every rank, as JAX's). Both need the sequence to
divide by the ring size, as JAX's ``seq % n`` assertion does.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.distributed as dist

from opendwm_tpu_torch.ops import flash_attention, flash_tail
from opendwm_tpu_torch.parallel.collectives import gather_along, slice_along

_LN2 = math.log(2.0)
_LOG2E = 1.0 / _LN2


# ---------------------------------------------------------------------------
# The block step
# ---------------------------------------------------------------------------


def block_forward_plain(q, k, v, scale: float):
    """JAX's ``_block_attend``: (unnormalised output fp32 (b, sq, h, d),
    row max (b, h, sq), row sum (b, h, sq)), fp32 logits, probabilities in
    v's dtype."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    m = logits.amax(-1)
    p = torch.exp(logits - m[..., None])
    s = p.sum(-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    return out.float(), m, s


def _kernel_takes(sq: int, head_dim: int) -> str:
    return "flash_attention" if flash_attention.supported(sq, sq, head_dim) \
        else "flash_tail"


def block_forward(q, k, v, scale: float):
    """The block step's (o, m, s): the kernel on CUDA tensors (K7 or K1 with
    its log-sum-exp; o is its normalised output, m its natural-log lse,
    s = 1), the plain version on CPU tensors."""
    if q.device.type == "cpu":
        return block_forward_plain(q, k, v, scale)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if _kernel_takes(q.shape[1], q.shape[-1]) == "flash_attention":
        out, lse = flash_attention.flash_attention_forward(q, k, v, scale)
    else:
        out, lse = flash_tail.tail_masked_attention_forward(q, k, v, scale)
    b, sq, h, _ = q.shape
    m = lse.reshape(b, h, sq) * _LN2
    return out.float(), m, torch.ones_like(m)


def merge(acc, blk):
    """Fold block (o, m, s) into the accumulator (JAX's ring step)."""
    o_acc, m_acc, s_acc = acc
    o_blk, m_blk, s_blk = blk
    m_new = torch.maximum(m_acc, m_blk)
    alpha = torch.exp(m_acc - m_new)
    beta = torch.exp(m_blk - m_new)
    o_new = (o_acc * alpha.transpose(1, 2)[..., None]
             + o_blk * beta.transpose(1, 2)[..., None])
    return o_new, m_new, s_acc * alpha + s_blk * beta


def finish(acc, dtype):
    """(output in ``dtype``, the rows' natural-log log-sum-exp (b, h, sq))."""
    o, m, s = acc
    return (o / s.transpose(1, 2)[..., None]).to(dtype), m + torch.log(s)


def block_backward_plain(q, k, v, out, do, lse, scale: float):
    """(dq, dk, dv) in fp32 of one block given the global output, its
    cotangent and the rows' global log-sum-exp (natural log, (b, h, sq)):
    p = exp(s * scale - lse), dv = p^T dO, ds = p (dO V^T - rowsum(dO o
    out)) scale, dq = ds K, dk = ds^T Q."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.exp(logits - lse[..., None])
    do = do.float()
    delta = (out.float() * do).sum(-1).transpose(1, 2)[..., None]
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(v.dtype).float(), do)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v.float())
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return dq, dk, dv


def block_backward(q, k, v, out, do, lse, scale: float):
    """The block step's gradients: the K7/K2 backward on CUDA tensors (in
    the input type), the plain version on CPU tensors (fp32)."""
    if q.device.type == "cpu":
        return block_backward_plain(q, k, v, out, do, lse, scale)
    b, sq, h, _ = q.shape
    lse2 = (lse * _LOG2E).reshape(b * h, sq).contiguous()
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out, do = out.contiguous(), do.to(q.dtype).contiguous()
    if _kernel_takes(sq, q.shape[-1]) == "flash_attention":
        return flash_attention.flash_attention_backward(q, k, v, out, do, lse2,
                                                        scale)
    return flash_tail.tail_masked_attention_backward(q, k, v, out, do, lse2,
                                                     scale)


# ---------------------------------------------------------------------------
# The ring, over lists of per-rank tensors
# ---------------------------------------------------------------------------


def _ring_forward(qs, ks, vs, scale: float, n: int, rotate: Callable):
    """Every rank's (output, lse) of the ring over n ranks. ``qs``, ``ks``,
    ``vs`` hold the slices of the ranks this process runs (all n, or its
    own); ``rotate`` moves lists of per-rank tensors one rank on (rank r
    receives rank r - 1's)."""
    accs = [block_forward(q, k, v, scale) for q, k, v in zip(qs, ks, vs)]
    for _ in range(n - 1):
        ks, vs = rotate([ks, vs])
        accs = [merge(acc, block_forward(q, k, v, scale))
                for acc, q, k, v in zip(accs, qs, ks, vs)]
    return [finish(acc, q.dtype) for acc, q in zip(accs, qs)]


def _ring_backward(qs, ks, vs, outs, dos, lses, scale: float, n: int,
                   rotate: Callable):
    """Every rank's (dq, dk, dv), fp32, of its own slices: dQ summed over
    the steps in order; the dK/dV accumulators travel with their key/value
    slice (added to in ring order from its owner on) and reach their owner
    after the last step's move."""
    dqs = [None] * len(qs)
    dks = [None] * len(qs)
    dvs = [None] * len(qs)
    for step in range(n):
        for r, (q, k, v) in enumerate(zip(qs, ks, vs)):
            dq, dk, dv = (g.float() for g in block_backward(
                q, k, v, outs[r], dos[r], lses[r], scale))
            dqs[r] = dq if dqs[r] is None else dqs[r] + dq
            dks[r] = dk if dks[r] is None else dks[r] + dk
            dvs[r] = dv if dvs[r] is None else dvs[r] + dv
        if step < n - 1:
            ks, vs, dks, dvs = rotate([ks, vs, dks, dvs])
        elif n > 1:
            dks, dvs = rotate([dks, dvs])
    return dqs, dks, dvs


def _rotate_lists(kinds):
    """The one-process ring: rank r takes rank r - 1's tensors."""
    return [[x[-1], *x[:-1]] for x in kinds]


def _check_divisible(seq: int, n: int) -> None:
    if seq % n:
        raise ValueError(
            f"ring attention needs the sequence to divide by the ring size "
            f"(JAX asserts seq % n == 0): seq {seq}, n {n}")


def ring_steps(qs, ks, vs, scale: Optional[float] = None):
    """The ring of ``len(qs)`` ranks run in this process, one rank's slices
    per list entry: every rank's (output, lse) by the same block steps and
    merges, in the same order, as the collective ring."""
    scale = 1.0 / math.sqrt(qs[0].shape[-1]) if scale is None else scale
    return _ring_forward(list(qs), list(ks), list(vs), scale, len(qs),
                         _rotate_lists)


def ring_steps_backward(qs, ks, vs, outs, dos, lses,
                        scale: Optional[float] = None):
    """``ring_steps``'s backward: every rank's fp32 (dq, dk, dv) lists."""
    scale = 1.0 / math.sqrt(qs[0].shape[-1]) if scale is None else scale
    return _ring_backward(list(qs), list(ks), list(vs), list(outs),
                          list(dos), list(lses), scale, len(qs),
                          _rotate_lists)


# ---------------------------------------------------------------------------
# The collective ring
# ---------------------------------------------------------------------------


def _group_rotate(group):
    """Move this rank's tensors to the next rank of ``group`` and take the
    previous one's (one ``batch_isend_irecv`` per move)."""
    n = dist.get_world_size(group)
    rank = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (rank + 1) % n)
    prv = dist.get_global_rank(group, (rank - 1) % n)

    def rotate(kinds):
        ops, recv = [], []
        for (x,) in kinds:
            x = x.contiguous()
            buf = torch.empty_like(x)
            ops.append(dist.P2POp(dist.isend, x, nxt, group))
            ops.append(dist.P2POp(dist.irecv, buf, prv, group))
            recv.append([buf])
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return recv

    return rotate


class _RingAttention(torch.autograd.Function):
    """The collective ring over ``group`` on this rank's slices (None: a
    ring of one rank, the block step alone)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, group):
        n = 1 if group is None else dist.get_world_size(group)
        rotate = None if n == 1 else _group_rotate(group)
        ((out, lse),) = _ring_forward([q], [k], [v], scale, n, rotate)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.n, ctx.rotate = scale, n, rotate
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        (dq,), (dk,), (dv,) = _ring_backward(
            [q], [k], [v], [out], [do], [lse], ctx.scale, ctx.n, ctx.rotate)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def ring_attention_sharded(q, k, v, group=None,
                           scale: Optional[float] = None):
    """Exact attention over the sequence split across ``group`` (None: one
    rank): q/k/v are this rank's (b, seq / n, h, d) slices, in ring order;
    returns this rank's slice of the output."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    if group is not None and dist.get_world_size(group) == 1:
        group = None
    return _RingAttention.apply(q, k, v, scale, group)


def ring_attention_replicated(q, k, v, group=None,
                              scale: Optional[float] = None):
    """Sequence-parallel attention on q/k/v replicated over ``group``:
    each rank takes its sequence slice, the ring runs, and the outputs are
    all-gathered back to the replicated layout (the attention's work split
    1/n a rank). seq must divide by the group size."""
    n = 1 if group is None else dist.get_world_size(group)
    _check_divisible(q.shape[1], n)
    if n == 1:
        return ring_attention_sharded(q, k, v, None, scale)
    q, k, v = (slice_along(t, 1, group) for t in (q, k, v))
    return gather_along(ring_attention_sharded(q, k, v, group, scale), 1,
                        group)
