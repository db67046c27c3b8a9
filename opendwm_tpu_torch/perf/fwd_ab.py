"""The attention forwards before and after the Hopper redesign, side by side
on one card: K1 (``csrc/flash_tail.cu``), K7 with and without the
log-sum-exp and K7-seg (``csrc/flash_attention.cu``) at the shapes the
port's paths and the shoot-out give them, bf16, head dim 64.

Run from the root of a checkout, with a second checkout (for example one
unpacked with ``git archive``) whose sources to compare against:

    python -m opendwm_tpu_torch.perf.fwd_ab --parent DIR --out PATH

It builds ``DIR``'s two sources and this checkout's (whose bf16 head-dim-64
forward is ``csrc/flash_fwd_sm90.cuh``), all four nvcc processes at once.
Each launch goes straight to the C entry points, which both checkouts
share. This checkout's output must agree with the parent's within the
attention bars (scaled error 2e-2, relative norm 2^-7), or it raises. Both
are timed with CUDA events (2 warm-ups, 10 calls) in turns, parent, tree,
tree, parent, beside the least time the card could take (``bound_ms``).
The JSON report, with ptxas's registers and spills of this checkout's
Hopper forward, goes to ``--out`` only.
"""

from __future__ import annotations

import argparse
import ctypes
import json
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from opendwm_tpu_torch.ops import _build
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
TOL, REL_TOL = 2e-2, 2 ** -7
SEED = 0


def _bind(lib: ctypes.CDLL, source: str) -> ctypes.CDLL:
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if source == "flash_tail.cu":
        lib.flash_tail_forward.argtypes = [ptr] * 4 + [i32] * 4 + \
            [f32, i32, ptr]
        fns = [lib.flash_tail_forward]
    else:
        shape = [i32] * 5 + [f32, i32, i32, ptr]
        lib.flash_attention_forward.argtypes = [ptr] * 4 + shape
        lib.flash_attention_forward_lse.argtypes = [ptr] * 5 + shape
        lib.flash_attention_forward_segment.argtypes = [ptr] * 6 + shape
        fns = [lib.flash_attention_forward, lib.flash_attention_forward_lse,
               lib.flash_attention_forward_segment]
    for fn in fns:
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


def ptxas() -> dict:
    """Registers and spill bytes that ptxas gave the Hopper forward's
    instances in this checkout's build of each source."""
    out = {}
    for src in SOURCES:
        report = _build.ptxas_report(_build.library_path(src),
                                     "flash_fwd_sm90")
        out[src] = {"registers": sorted({r.get("registers")
                                         for r in report.values()}),
                    "spill_bytes": sum(r.get("spill_bytes", 0)
                                       for r in report.values())}
        print(f"ptxas {src}: {json.dumps(out[src])}", flush=True)
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
        order = list(calls) + list(calls)[::-1]
        times = {name: [] for name in calls}
        for name in order:
            times[name].append(time_ms(calls[name]))
        row.update({f"{name}_ms": sum(t) / len(t) for name, t in
                    times.items()})
        row["bound_ms"], row["bound_by"] = (
            segment_attention_bound(ids, ids, h, 64, causal)
            if ids is not None else attention_bound(b, sq, sk, h, 64, causal))
        print(json.dumps(row), flush=True)
        rows.append(row)
        del q, k, v, ids
    return rows


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        description="The attention forwards of a parent checkout and of "
                    "this one, timed side by side on the card")
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
