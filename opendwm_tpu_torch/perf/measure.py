"""Errors, timings and bounds of a kernel on the card, for ``chip_smoke.py``
and the experiments in this package."""

from __future__ import annotations

import bisect
import subprocess
import time
from typing import NamedTuple

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


def time_ms(fn, iters: int = 10, warmups: int = 2) -> float:
    """ms per call of ``fn``: CUDA events around ``iters`` calls after
    ``warmups`` warm-ups."""
    for _ in range(warmups):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_graph_ms(calls, replays: int = 3) -> float:
    """Device ms per call: ``calls`` (zero-argument callables) captured once,
    in order, in a CUDA graph after 2 eager warm-ups of the first, and the
    graph replayed ``replays`` times after one untimed replay, timed with
    CUDA events: no host work is left between the launches."""
    for _ in range(2):
        calls[0]()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in calls:
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * len(calls))
    del graph
    return ms


L2_BYTES = 50e6  # the H100's L2 cache


def cold_copies(bytes_read: float) -> int:
    """How many copies of a call's inputs to rotate over so that the other
    copies' reads between two uses of one copy exceed twice the L2: each
    call then reads its inputs from device memory."""
    return 1 + max(1, -(-int(2 * L2_BYTES) // int(bytes_read)))


def host_us(fn, calls: int = 1000) -> float:
    """Host µs per call: ``time.perf_counter`` around ``calls`` enqueues of
    ``fn`` after one warm-up and a synchronize, while the device runs
    behind (the device work is not waited for)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


PLAIN_BUDGET_MS = 200.0  # the plain version's calls in one of its timings


def time_pair(kernel, plain, iters: int = 10):
    """ms per call of each, timed in turns plain, kernel, kernel, plain.
    The plain version (the yardstick) is timed over as many of ``iters``
    calls as fit in ``PLAIN_BUDGET_MS`` by one timed call after the
    warm-ups, at least 2: its slowest rows (0.1-0.25 s a call) take 8
    calls instead of 24."""
    estimate = time_ms(plain, 1)
    n = max(2, min(iters, int(PLAIN_BUDGET_MS // max(estimate, 1e-3))))
    p1 = time_ms(plain, n, warmups=0)
    k1, k2 = time_ms(kernel, iters), time_ms(kernel, iters)
    p2 = time_ms(plain, n, warmups=1)
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16):
    """(ms, what bounds it): the least time the card could take."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"


def adaln_bound(n, l, d, residual=False, itemsize=2):
    """AdaLN over (n, l, d) rows of ``itemsize`` bytes (bf16 by default):
    K3 reads x, scale and shift and writes y, ~8 fp32 operations an element
    (statistics, normalisation, modulation); K4 also reads delta and gate
    and writes x', ~10 an element."""
    big, small = (4, 3) if residual else (2, 2)
    nbytes = itemsize * (big * n * l * d + small * n * d)
    return bound((10 if residual else 8) * n * l * d, nbytes, PEAK_FP32)


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
                            dtype=torch.bfloat16, backward=False):
    """``attention_bound`` over the pairs that the segment ids leave
    (``segment_pairs``), whose bytes also count the int32 ids: the forward
    (2 products; q, k, v read, o written) or the backward (5 products; q, k,
    v, o, dO and the fp32 lse read, dq, dk, dv written)."""
    (b, sq), sk = q_ids.shape, kv_ids.shape[1]
    products = 5 if backward else 2
    flops = 2 * products * h * segment_pairs(q_ids, kv_ids, causal) * d
    tensors = 4 if backward else 2
    nbytes = dtype.itemsize * tensors * (b * sq + b * sk) * h * d + \
        4 * (b * sq + b * sk) + (4 * b * h * sq if backward else 0)
    peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32
    return bound(flops, nbytes, peak)


class DeviceEvent(NamedTuple):
    """An event of a profile's device timeline (times in ns): a kernel,
    a copy or a set, or the GPU-side span of a profiler range
    (``annotation``); ``link``: the correlation id of the host operation
    that launched it (0 for none)."""

    name: str
    start: int
    end: int
    annotation: bool
    link: int

    @property
    def ms(self) -> float:
        return (self.end - self.start) / 1e6


def device_events(prof) -> list:
    """The device timeline of a ``torch.profiler`` profile, read once a
    profile from its Kineto results: the profiler's own table
    (``key_averages``, ``events``) builds an event tree of every host and
    device event first, 24 s for 200k events on the card's host (torch
    2.11), where this reads them in about 1 s."""
    cached = getattr(prof, "_device_events", None)
    if cached is None:
        from torch.autograd import DeviceType

        cached = [DeviceEvent(e.name(), e.start_ns(), e.end_ns(),
                              e.is_user_annotation(),
                              e.linked_correlation_id())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA]
        prof._device_events = cached
    return cached


def launched_by(prof, op: str) -> set:
    """The names of the device events that host operation ``op`` (e.g.
    ``aten::_int_mm``) launched in a profile."""
    ids = {e.correlation_id() for e in prof.profiler.kineto_results.events()
           if e.name() == op}
    return {e.name for e in device_events(prof) if e.link in ids}


def range_kernels(prof, name: str) -> tuple:
    """The kernels of a ``torch.profiler`` profile's device timeline, each
    once (the GPU-side spans of profiler ranges are not kernels), split
    into (those that ran inside a GPU-side span of a range called
    ``name``, the rest)."""
    device = device_events(prof)
    spans = sorted((e.start, e.end) for e in device if e.name == name)
    starts = [s for s, _ in spans]
    inside, outside = [], []
    for e in device:
        if e.name == name or e.annotation:
            continue
        i = bisect.bisect_right(starts, e.start) - 1
        within = i >= 0 and e.end <= spans[i][1]
        (inside if within else outside).append(e)
    return inside, outside


def kernels_ms(kernels) -> float:
    """Device ms of profiler kernel events."""
    return sum(e.ms for e in kernels)


def range_device_ms(prof, name: str) -> tuple:
    """(device ms, kernels) of the kernels that ran inside the GPU-side
    spans of the profiler ranges called ``name``."""
    inside, _ = range_kernels(prof, name)
    return kernels_ms(inside), len(inside)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def clock_line() -> str:
    """The card's SM clock and its maximum, temperature, power draw and
    active clock-event reasons, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,temperature.gpu,"
         "power.draw,clocks_event_reasons.active", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip() or "unread: " + out.stderr.strip()[:200]
