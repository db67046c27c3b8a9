"""Tail-attention tiling experiment: K1 against its other tilings K5 and K6
at the CTSD-3.5 DiT's joint (602-token) and dual (448-token) attention.

Port of ``perf/exp_tailvar.py``. The variants, all the same function
(``ops/tail_variants.py``), differ in the share of work of one block:

  tail       K1 (``ops/flash_tail.py``): 64 query rows of one batch-head
  tail_h2    K5 ``tail_hpack``: all query rows of 2 batch-heads
  tail_h4    K5: of 4 batch-heads
  tail_q128  K6 ``tail_qsplit``: 128 query rows of one batch-head
  tail_q256  K6: 256 rows, cut by 128 until it divides S padded to a
             multiple of 128 (at S = 602, padded 640, it runs 128-row
             blocks; the report's ``bq_run`` says so)

Run from the root of a checkout:

    python -m opendwm_tpu_torch.perf.exp_tailvar [--device cuda|cpu] --out PATH

``cuda`` (the default) needs a card and runs the kernels; ``cpu`` runs the
plain versions and reports their numerics only. Inputs are drawn from a
seeded generator on the device. Every variant is held against the plain
version on the same inputs (scaled error ``|x - plain| / max(1, |plain|)``
at most 2e-2 in bf16, 1e-4 in fp32, and relative norm
``||x - plain|| / ||plain||`` at most 2^-7 in bf16, 1e-5 in fp32). K5 and
K6 must also agree with K1 within those bars and, on the card, equal it bit
for bit (``equals_k1``): in bf16 at head dim 64 all three run the per-tile
step of the Hopper forward (``csrc/flash_fwd_sm90.cuh``; K5 and K6 through
``csrc/tail_tiling_sm90.cuh``), in fp32 K1's FMA tile step. A variant that
disagrees or fails raises. On the card each is then timed with CUDA
events (2 warm-ups, 10 calls, in turns plain, kernel, kernel, plain),
beside the plain version, the least time the card could take
(``bound_ms``) and one call of ``scaled_dot_product_attention`` on the
same inputs (``library_ms``, a yardstick the port never calls). The JSON
report goes to ``--out`` only.
"""

from __future__ import annotations

import argparse
import functools
import json
from pathlib import Path

import torch

from opendwm_tpu_torch.ops import flash_tail, tail_variants
from opendwm_tpu_torch.perf.measure import (
    attention_bound,
    card_line,
    max_err,
    rel_err,
    scaled_err,
    time_ms,
    time_pair,
)

B, H, HD = 36, 24, 64
SHAPES = {"joint_602": 602, "dual_448": 448}
ATTN_TOL, FP32_TOL = 2e-2, 1e-4
# At these inputs the softmax is near uniform over S keys and the outputs
# are ~0.5 / sqrt(S), far below 1, so the scaled error is an absolute one
# about as large as the outputs: a kernel that attends to the padded keys
# (~6% off at S 602) or drops a key tile (~20%) would pass it. The
# relative norm catches both. Its bf16 bar is one ulp, at most 2^-7 of a
# bf16 value: outputs within one ulp of the plain version everywhere stay
# under it (K1 measures ~3e-3: p is rounded to bf16 against another max).
REL_TOL = {torch.bfloat16: 2 ** -7, torch.float32: 1e-5}
SEED = 0

# name: (kernel, function of (q, k, v, scale), tiling)
VARIANTS = {
    "tail": ("flash_tail_forward", flash_tail.tail_masked_attention, {}),
    "tail_h2": ("tail_hpack",
                functools.partial(tail_variants.tail_hpack, nh=2), {"nh": 2}),
    "tail_h4": ("tail_hpack",
                functools.partial(tail_variants.tail_hpack, nh=4), {"nh": 4}),
    "tail_q128": ("tail_qsplit",
                  functools.partial(tail_variants.tail_qsplit, bq=128),
                  {"bq": 128}),
    "tail_q256": ("tail_qsplit",
                  functools.partial(tail_variants.tail_qsplit, bq=256),
                  {"bq": 256}),
}


def run(seq: int, label: str, device, b: int | None = None,
        dtype=torch.bfloat16) -> list[dict]:
    """Every variant at (b or B, seq, H, HD): its errors against the plain
    version and, on the card, its times. Raises if one disagrees."""
    device = torch.device(device)
    b = B if b is None else b
    g = torch.Generator(device).manual_seed(SEED)
    q, k, v = ((torch.randn(b, seq, H, HD, generator=g, device=device) * 0.5)
               .to(dtype) for _ in range(3))
    scale = HD ** -0.5
    tol = ATTN_TOL if dtype == torch.bfloat16 else FP32_TOL
    rel_tol = REL_TOL[dtype]

    def plain():
        return tail_variants.tail_attention_plain(q, k, v, scale)

    ref = plain()
    on_card = device.type == "cuda"
    if on_card:
        bound_ms, bound_by = attention_bound(b, seq, seq, H, HD,
                                             dtype=dtype)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, scale=scale))
    rows, k1_out = [], None
    for name, (kernel, fn, tiling) in VARIANTS.items():
        call = functools.partial(fn, q, k, v, scale)
        got = call()
        row = {"variant": name, "kernel": kernel, **tiling,
               "shape": [b, seq, H, HD], "dtype": str(dtype).split(".")[-1],
               "max_abs_err": max_err(got, ref),
               "scaled_err": scaled_err(got, ref),
               "rel_err": rel_err(got, ref)}
        if "bq" in tiling:
            row["bq_run"] = tail_variants.effective_bq(seq, tiling["bq"])
        if not (row["scaled_err"] <= tol and row["rel_err"] <= rel_tol):
            raise RuntimeError(
                f"{label} {name} disagrees with the plain version: scaled "
                f"err {row['scaled_err']} (bar {tol}), relative norm "
                f"{row['rel_err']} (bar {rel_tol})")
        if kernel == "flash_tail_forward":
            k1_out = got
        else:
            row["vs_k1_scaled_err"] = scaled_err(got, k1_out)
            row["vs_k1_rel_err"] = rel_err(got, k1_out)
            if not (row["vs_k1_scaled_err"] <= tol and
                    row["vs_k1_rel_err"] <= rel_tol):
                raise RuntimeError(
                    f"{label} {name} disagrees with K1: scaled err "
                    f"{row['vs_k1_scaled_err']}, relative norm "
                    f"{row['vs_k1_rel_err']}")
            if on_card:
                row["equals_k1"] = torch.equal(got, k1_out)
                if not row["equals_k1"]:
                    raise RuntimeError(f"{label} {name} differs from K1, "
                                       f"whose tile step it runs")
        if on_card:
            ms, plain_ms = time_pair(call, plain)
            row.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, library_ms=library_ms)
        else:
            row["numerics"] = "ok (plain versions on the cpu; not timed)"
        print(label, json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        description="K1 against its tilings K5 (tail_hpack) and K6 "
                    "(tail_qsplit) at the DiT's tail-masked attention shapes")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--out", required=True, help="JSON report path")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda needs an NVIDIA GPU; --device "
                               "cpu runs the plain versions")
        torch.backends.cuda.matmul.allow_tf32 = False
        where = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                 "card": card_line()}
    else:
        where = {"platform": "cpu"}
    report = {"device": where, "shape": f"b{B} h{H} hd{HD}",
              **{label: run(seq, label, device)
                 for label, seq in SHAPES.items()}}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print("wrote", out)
    return report


if __name__ == "__main__":
    main()
