"""Errors, timings and bounds of a kernel on the card, for ``chip_smoke.py``
and the experiments in this package."""

from __future__ import annotations

import subprocess

import torch

# Published peaks of one H100 SXM (dense): bf16 on the tensor cores, fp32
# outside them, HBM3 bytes/s. bound_ms is the larger of operations over the
# peak for their type and bytes (each input read once, each output written
# once) over the memory rate.
PEAK_BF16, PEAK_FP32, PEAK_BYTES = 989e12, 67e12, 3.35e12


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def scaled_err(a, b) -> float:
    """max of |a - b| / max(1, |b|): the measure the tolerances bound."""
    b = b.float()
    return ((a.float() - b).abs() / b.abs().clamp(min=1.0)).max().item()


def rel_err(a, b) -> float:
    """||a - b|| / ||b||: the measure the relative-norm bars bound."""
    b = b.float()
    return ((a.float() - b).norm() / b.norm()).item()


def time_ms(fn, iters: int = 10) -> float:
    """ms per call of ``fn``: CUDA events around ``iters`` calls after 2
    warm-ups."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_pair(kernel, plain, iters: int = 10):
    """ms per call of each, timed in turns plain, kernel, kernel, plain."""
    p1, k1, k2, p2 = (time_ms(fn, iters) for fn in (plain, kernel, kernel,
                                                    plain))
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16):
    """(ms, what bounds it): the least time the card could take."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"


def visible_pairs(sq: int, sk: int, causal: bool) -> int:
    """(query, key) pairs that attend: all, or under the top-left causal
    mask those with key <= query."""
    if not causal:
        return sq * sk
    n = min(sq, sk)
    return n * (n + 1) // 2 + (sq - n) * sk


def attention_bound(b, sq, sk, h, d, causal=False, backward=False,
                    dtype=torch.bfloat16):
    """Attention in bf16 (tensor cores) or fp32 (outside them): the forward
    does 2 products over the visible pairs (QK^T, PV), reads q, k, v and
    writes o; the backward does 5 (S, dP, dV, dK, dQ), reads q, k, v, o, dO
    and the fp32 lse and writes dq, dk, dv."""
    products = 5 if backward else 2
    flops = 2 * products * b * h * visible_pairs(sq, sk, causal) * d
    q_elems, kv_elems = b * sq * h * d, b * sk * h * d
    size = dtype.itemsize
    nbytes = size * (2 * q_elems + 2 * kv_elems)
    if backward:
        nbytes = size * (4 * q_elems + 4 * kv_elems) + 4 * b * h * sq
    peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32
    return bound(flops, nbytes, peak)


def packed_segment_ids(b: int, s: int, seed: int, device) -> torch.Tensor:
    """int32 (b, s) segment ids in 1-4 contiguous segments per row, 0, 1,
    ... in order (packed sequences), drawn on the CPU from ``seed``: under
    the causal mask every query sees at least itself."""
    g = torch.Generator().manual_seed(seed)
    ids = torch.zeros(b, s, dtype=torch.int32)
    for row in ids:
        n = int(torch.randint(1, 5, (1,), generator=g))
        for cut in torch.randperm(s - 1, generator=g)[:n - 1] + 1:
            row[cut:] += 1
    return ids.to(device)


def segment_pairs(q_ids, kv_ids, causal=False) -> int:
    """(query, key) pairs that a forward with segment ids must attend, per
    head: those of one segment (under the top-left causal mask with key <=
    query), and every visible key of a query that shares no key's id (it
    gets the mean of V over them)."""
    visible = torch.ones(q_ids.shape[1], kv_ids.shape[1], dtype=torch.bool,
                         device=q_ids.device)
    if causal:
        visible = visible.tril()
    same = (q_ids[:, :, None] == kv_ids[:, None, :]) & visible
    per_row = same.sum(-1)
    return int(torch.where(per_row > 0, per_row, visible.sum(-1)).sum())


def segment_attention_bound(q_ids, kv_ids, h, d, causal=False,
                            dtype=torch.bfloat16):
    """The forward of ``attention_bound`` over the pairs that the segment
    ids leave (``segment_pairs``), whose bytes also count the int32 ids."""
    (b, sq), sk = q_ids.shape, kv_ids.shape[1]
    flops = 2 * 2 * h * segment_pairs(q_ids, kv_ids, causal) * d
    nbytes = dtype.itemsize * 2 * (b * sq + b * sk) * h * d + \
        4 * (b * sq + b * sk)
    peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32
    return bound(flops, nbytes, peak)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]
