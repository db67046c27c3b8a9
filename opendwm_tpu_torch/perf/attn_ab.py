"""The attention kernels of two checkouts side by side on one card, in both
directions: the forwards K1 (``csrc/flash_tail.cu``), K7 with and without
the log-sum-exp and K7-seg (``csrc/flash_attention.cu``), and the
backwards K2 and the K7 backward, at the shapes the port's paths and the
shoot-out give them, bf16, head dim 64.

Run from the root of a checkout, with a second checkout (for example the
parent commit's sources unpacked with ``git archive``) to compare against:

    python -m opendwm_tpu_torch.perf.attn_ab --parent DIR --out PATH

It builds ``DIR``'s two sources and this checkout's (whose bf16
head-dim-64 forward is ``csrc/flash_fwd_sm90.cuh`` and backward
``csrc/flash_bwd_sm90.cuh``), all four nvcc processes at once. Each launch
goes straight to the C entry points; a backward entry without its dQ
workspace argument (a checkout from before the Hopper backward) is called
without it. Both backwards take the same forward output and log-sum-exp,
this checkout's. This checkout must agree with the parent within the
attention bars (forward: scaled error 2e-2, relative norm 2^-7; backward:
relative norm 0.6% per gradient), or it raises. Both are timed with CUDA
events (2 warm-ups, 10 calls) in turns, parent, tree, tree, parent, beside
the least time the card could take (``bound_ms``). The JSON report, with
ptxas's registers and spills of this checkout's Hopper kernels, goes to
``--out`` only.
"""

from __future__ import annotations

import argparse
import ctypes
import json
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from opendwm_tpu_torch.ops import _build, flash_attention
from opendwm_tpu_torch.ops.flash_tail import dq_workspace
from opendwm_tpu_torch.perf.measure import (
    attention_bound,
    card_line,
    packed_segment_ids,
    rel_err,
    scaled_err,
    segment_attention_bound,
    time_ms,
)

SOURCES = ("flash_tail.cu", "flash_attention.cu")
# (kernel, batch, q_seq, kv_seq, heads, causal): K1 at the DiT's (CFG
# batch) and the UNet's shapes, K7 at the UNet's level 0 (serving, and
# with the log-sum-exp at the training batch), at the LiDAR UNet's 6400
# tokens and causal with q != kv, K7-seg at the shoot-out's flashpad call
# (pads of S 602 in segment 1) and at packed ids.
CASES = (
    ("K1", 72, 602, 602, 24, False), ("K1", 72, 448, 448, 24, False),
    ("K1", 192, 168, 168, 24, False), ("K1", 384, 336, 336, 5, False),
    ("K1", 72, 448, 448, 10, False), ("K1", 192, 168, 168, 10, False),
    ("K7", 72, 1792, 1792, 5, False), ("K7", 8, 6400, 6400, 5, False),
    ("K7", 8, 1792, 3584, 5, True), ("K7 lse", 36, 1792, 1792, 5, False),
    ("K7-seg flashpad", 36, 640, 640, 24, False),
    ("K7-seg packed", 8, 1792, 1792, 24, False),
)
# (kernel, batch, q_seq, kv_seq, heads, causal): K2 at the DiT's and the
# UNet's training shapes (batch 1, no CFG), the K7 backward at the UNet's
# level 0, at 6400 tokens and causal with q shorter and longer than kv.
BWD_CASES = (
    ("K2", 36, 602, 602, 24, False), ("K2", 36, 448, 448, 24, False),
    ("K2", 96, 168, 168, 24, False), ("K2", 192, 336, 336, 5, False),
    ("K2", 36, 448, 448, 10, False), ("K2", 96, 168, 168, 10, False),
    ("K7 bwd", 36, 1792, 1792, 5, False), ("K7 bwd", 8, 6400, 6400, 5, False),
    ("K7 bwd", 8, 1792, 3584, 5, True), ("K7 bwd", 8, 3584, 1792, 5, True),
)
TOL, REL_TOL, BWD_REL_TOL = 2e-2, 2 ** -7, 6e-3
SEED = 0


def _bind(lib: ctypes.CDLL, source: str) -> ctypes.CDLL:
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if source == "flash_tail.cu":
        shape = [i32] * 4 + [f32, i32, ptr]
        lib.flash_tail_forward.argtypes = [ptr] * 4 + shape
        backward = lib.flash_tail_backward
        fns = [lib.flash_tail_forward]
    else:
        shape = [i32] * 5 + [f32, i32, i32, ptr]
        lib.flash_attention_forward.argtypes = [ptr] * 4 + shape
        lib.flash_attention_forward_lse.argtypes = [ptr] * 5 + shape
        lib.flash_attention_forward_segment.argtypes = [ptr] * 6 + shape
        backward = lib.flash_attention_backward
        fns = [lib.flash_attention_forward, lib.flash_attention_forward_lse,
               lib.flash_attention_forward_segment]
    # the backward's entry takes the dQ workspace since the Hopper backward
    lib.has_workspace = hasattr(lib, source.split(".")[0] +
                                "_backward_takes_sm90")
    backward.argtypes = [ptr] * (11 if lib.has_workspace else 10) + shape
    for fn in fns + [backward]:
        fn.restype = ctypes.c_int
    return lib


def build(parent: Path) -> dict[str, dict[str, ctypes.CDLL]]:
    """Both sources of the parent and of this checkout, compiled at
    once."""
    csrcs = {"parent": parent / "opendwm_tpu_torch" / "csrc", "tree": None}
    with ThreadPoolExecutor(len(csrcs)) as pool:
        for job in [pool.submit(_build.build_all, SOURCES, c)
                    for c in csrcs.values()]:
            job.result()
    return {name: {src: _bind(ctypes.CDLL(str(_build.library_path(src, c))),
                              src) for src in SOURCES}
            for name, c in csrcs.items()}


def _inputs(kernel, b, sq, sk, h, dev, g):
    q = torch.randn(b, sq, h, 64, generator=g, device=dev,
                    dtype=torch.bfloat16)
    k, v = (torch.randn(b, sk, h, 64, generator=g, device=dev,
                        dtype=torch.bfloat16) for _ in range(2))
    ids = None
    if kernel == "K7-seg flashpad":
        ids = torch.zeros(b, sq, dtype=torch.int32, device=dev)
        ids[:, 602:] = 1
    elif kernel == "K7-seg packed":
        ids = packed_segment_ids(b, sq, SEED, dev)
    return q, k, v, ids


def _call(libs, kernel, q, k, v, ids, causal):
    """One launch of ``kernel`` from ``libs``: (out, lse or None)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    out = torch.empty_like(q)
    lse = torch.empty(b * h, sq, device=q.device, dtype=torch.float32) \
        if kernel == "K7 lse" else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    scale = d ** -0.5
    if kernel == "K1":
        rc = libs["flash_tail.cu"].flash_tail_forward(
            *ptrs, b, sq, h, d, scale, 1, stream)
    else:
        lib = libs["flash_attention.cu"]
        shape = (b, sq, sk, h, d, scale, int(causal), 1, stream)
        if ids is not None:
            rc = lib.flash_attention_forward_segment(
                *ptrs, ids.data_ptr(), ids.data_ptr(), *shape)
        elif lse is not None:
            rc = lib.flash_attention_forward_lse(*ptrs, lse.data_ptr(),
                                                 *shape)
        else:
            rc = lib.flash_attention_forward(*ptrs, *shape)
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {rc}")
    return out, lse


def _call_backward(libs, kernel, q, k, v, out, do, lse, causal):
    """One backward launch of ``kernel`` from ``libs``: (dq, dk, dv)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    grads = [torch.empty_like(t) for t in (q, k, v)]
    delta = torch.empty(b * h, sq, device=q.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib = libs["flash_tail.cu" if kernel == "K2" else "flash_attention.cu"]
    ptrs = [t.data_ptr() for t in (q, k, v, out, do, lse, delta)]
    if lib.has_workspace:
        ptrs.append(dq_workspace(b, sq, h, q.device).data_ptr())
    ptrs += [t.data_ptr() for t in grads]
    if kernel == "K2":
        rc = lib.flash_tail_backward(*ptrs, b, sq, h, d, d ** -0.5, 1,
                                     stream)
    else:
        rc = lib.flash_attention_backward(*ptrs, b, sq, sk, h, d, d ** -0.5,
                                          int(causal), 1, stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} backward launch failed: cudaError {rc}")
    return grads


def _timed(calls) -> dict:
    """ms of each call, in turns parent, tree, tree, parent."""
    order = list(calls) + list(calls)[::-1]
    times = {name: [] for name in calls}
    for name in order:
        times[name].append(time_ms(calls[name]))
    return {f"{name}_ms": sum(t) / len(t) for name, t in times.items()}


def run_backward(libs, dev, g) -> list[dict]:
    """Every case of ``BWD_CASES``: the parent's and this checkout's
    backward on one forward's output and log-sum-exp, compared and timed."""
    rows = []
    for kernel, b, sq, sk, h, causal in BWD_CASES:
        q, do = (torch.randn(b, sq, h, 64, generator=g, device=dev,
                             dtype=torch.bfloat16) for _ in range(2))
        k, v = (torch.randn(b, sk, h, 64, generator=g, device=dev,
                            dtype=torch.bfloat16) for _ in range(2))
        out, lse = flash_attention.flash_attention_forward(q, k, v, 64 ** -0.5,
                                                           causal)
        calls = {name: (lambda lb=lb: _call_backward(lb, kernel, q, k, v, out,
                                                     do, lse, causal))
                 for name, lb in libs.items()}
        ref = calls["parent"]()
        row = {"kernel": kernel, "shape": [b, sq, sk, h, 64],
               "causal": causal}
        for name, call in calls.items():
            grads = call()
            torch.cuda.synchronize()
            rels = [rel_err(a, r) for a, r in zip(grads, ref)]
            if not max(rels) <= BWD_REL_TOL:
                raise RuntimeError(f"{name} {kernel} {row['shape']} "
                                   f"disagrees with the parent: {rels}")
            row[f"{name}_vs_parent"] = rels
            del grads
        del ref
        row.update(_timed(calls))
        row["bound_ms"], row["bound_by"] = attention_bound(
            b, sq, sk, h, 64, causal, backward=True)
        print(json.dumps(row), flush=True)
        rows.append(row)
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()
    return rows


def ptxas() -> dict:
    """Registers and spill bytes that ptxas gave the Hopper kernels'
    instances in this checkout's build of each source."""
    out = {}
    for src in SOURCES:
        for body in ("flash_fwd_sm90", "flash_bwd_sm90"):
            report = _build.ptxas_report(_build.library_path(src), body)
            out[f"{src}:{body}"] = {
                "registers": sorted({r.get("registers")
                                     for r in report.values()}),
                "spill_bytes": sum(r.get("spill_bytes", 0)
                                   for r in report.values())}
            print(f"ptxas {src} {body}: {json.dumps(out[f'{src}:{body}'])}",
                  flush=True)
    return out


def run(parent: Path, device="cuda") -> list[dict]:
    dev = torch.device(device)
    libs = build(parent)
    g = torch.Generator(dev).manual_seed(SEED)
    rows = []
    for kernel, b, sq, sk, h, causal in CASES:
        q, k, v, ids = _inputs(kernel, b, sq, sk, h, dev, g)
        calls = {name: (lambda lb=lb: _call(lb, kernel, q, k, v, ids,
                                              causal))
                 for name, lb in libs.items()}
        ref, ref_lse = calls["parent"]()
        row = {"kernel": kernel, "shape": [b, sq, sk, h, 64],
               "causal": causal}
        for name, call in calls.items():
            out, lse = call()
            torch.cuda.synchronize()
            errs = (scaled_err(out, ref), rel_err(out, ref))
            if lse is not None:
                errs += (scaled_err(lse, ref_lse),)
            if not (errs[0] <= TOL and errs[1] <= REL_TOL
                    and (len(errs) == 2 or errs[2] <= 1e-4)):
                raise RuntimeError(f"{name} {kernel} {row['shape']} "
                                   f"disagrees with the parent: {errs}")
            row[f"{name}_vs_parent"] = errs
        row.update(_timed(calls))
        row["bound_ms"], row["bound_by"] = (
            segment_attention_bound(ids, ids, h, 64, causal)
            if ids is not None else attention_bound(b, sq, sk, h, 64, causal))
        print(json.dumps(row), flush=True)
        rows.append(row)
        del q, k, v, ids
    return rows + run_backward(libs, dev, g)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        description="The attention kernels of a parent checkout and of "
                    "this one, forward and backward, timed side by side on "
                    "the card")
    parser.add_argument("--parent", required=True, type=Path,
                        help="root of the checkout to compare against")
    parser.add_argument("--out", required=True, help="JSON report path")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the comparison needs an NVIDIA GPU")
    report = {"device": {"platform": "gpu",
                         "kind": torch.cuda.get_device_name(0),
                         "card": card_line()},
              "rows": run(args.parent), "ptxas": ptxas()}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print("card:", report["device"]["card"])
    print("wrote", out)
    return report


if __name__ == "__main__":
    main()
