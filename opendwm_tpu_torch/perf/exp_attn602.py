"""Attention shoot-out at the CTSD-3.5 DiT's joint (602-token) and dual
(448-token) attention shapes.

Port of ``perf/exp_attn602.py``. Three ways to compute one function,
softmax(q k^T / sqrt(HD)) v over (B, S, H, HD) bf16:

  tail      K1 (``ops/flash_tail.py`` ``tail_masked_attention``), the
            kernel the DiT dispatches
  plain     the plain attention (``v_xla``): the q k^T product in the input
            type, fp32 scale and softmax, probabilities in the input type
  flashpad  pad S to the next multiple of 128, give the pads segment 1, run
            K7-seg (``ops/flash_attention.py`` with ``SegmentIds``), slice
            the S rows back (``v_flashpad``)

Run from the root of a checkout:

    python -m opendwm_tpu_torch.perf.exp_attn602 [--device cuda|cpu] --out PATH

``cuda`` (the default) needs a card and runs the kernels; ``cpu`` runs the
plain versions and reports their numerics only. Inputs are 0.5 N(0, 1),
drawn from a seeded generator on the device. Every variant is held against
``plain`` on the same inputs (scaled error ``|x - plain| / max(1, |plain|)``
at most 2e-2 in bf16, 1e-4 in fp32, and relative norm
``||x - plain|| / ||plain||`` at most 2^-7 in bf16, 1e-5 in fp32: the
outputs are ~0.5 / sqrt(S), so the scaled bar alone is as large as they
are). A variant that disagrees or fails raises. On the card each is then
timed with CUDA events (2 warm-ups, 10 calls, in turns plain, variant,
variant, plain) beside the least time the card could take for the unpadded
function (``bound_ms``, the same for all three) and one call of
``scaled_dot_product_attention`` on the unpadded inputs (``library_ms``, a
yardstick the port never calls); ``flashpad`` also logs the time of its
pads and slice outside the kernel (``pad_slice_ms``). The JSON report goes
to ``--out`` only, never to ``perf/BENCH_ATTN602.json``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from opendwm_tpu_torch.ops import flash_attention, flash_tail
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
ATTN_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
REL_TOL = {torch.bfloat16: 2 ** -7, torch.float32: 1e-5}
SEED = 0


def v_plain(q, k, v, scale):
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def v_tail(q, k, v, scale):
    return flash_tail.tail_masked_attention(q, k, v, scale)


def pad(q, k, v):
    """q, k, v padded with zeros to a multiple of 128 tokens, and the
    segment ids that give the pads segment 1."""
    b, seq = q.shape[:2]
    extra = (-seq) % 128
    padded = [torch.nn.functional.pad(x, (0, 0, 0, 0, 0, extra))
              for x in (q, k, v)]
    ids = torch.cat([torch.zeros(b, seq, dtype=torch.int32, device=q.device),
                     torch.ones(b, extra, dtype=torch.int32,
                                device=q.device)], dim=1)
    return padded, flash_attention.SegmentIds(ids, ids)


def v_flashpad(q, k, v, scale):
    (qp, kp, vp), ids = pad(q, k, v)
    out = flash_attention.flash_attention(qp, kp, vp, scale, segment_ids=ids)
    return out[:, :q.shape[1]].contiguous()


VARIANTS = {"tail": v_tail, "plain": v_plain, "flashpad": v_flashpad}


def run(seq: int, label: str, device, b: int | None = None,
        dtype=torch.bfloat16) -> list[dict]:
    """Every variant at (b or B, seq, H, HD): its errors against ``plain``
    and, on the card, its times. Raises if one disagrees."""
    device = torch.device(device)
    b = B if b is None else b
    g = torch.Generator(device).manual_seed(SEED)
    q, k, v = ((torch.randn(b, seq, H, HD, generator=g, device=device) * 0.5)
               .to(dtype) for _ in range(3))
    scale = HD ** -0.5
    tol, rel_tol = ATTN_TOL[dtype], REL_TOL[dtype]

    def plain():
        return v_plain(q, k, v, scale)

    ref = plain()
    on_card = device.type == "cuda"
    if on_card:
        bound_ms, bound_by = attention_bound(b, seq, seq, H, HD, dtype=dtype)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, scale=scale))
    rows = []
    for name, fn in VARIANTS.items():
        def call(fn=fn):
            return fn(q, k, v, scale)

        got = call()
        if got.shape != ref.shape:
            raise RuntimeError(f"{label} {name} disagrees with the plain "
                               f"version: shape {tuple(got.shape)}")
        row = {"variant": name, "shape": [b, seq, H, HD],
               "dtype": str(dtype).split(".")[-1],
               "max_abs_err": max_err(got, ref),
               "scaled_err": scaled_err(got, ref),
               "rel_err": rel_err(got, ref)}
        if not (row["scaled_err"] <= tol and row["rel_err"] <= rel_tol):
            raise RuntimeError(
                f"{label} {name} disagrees with the plain version: scaled "
                f"err {row['scaled_err']} (bar {tol}), relative norm "
                f"{row['rel_err']} (bar {rel_tol})")
        if on_card:
            ms, plain_ms = time_pair(call, plain)
            row.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, library_ms=library_ms)
            if name == "flashpad":
                row["pad_slice_ms"] = time_ms(
                    lambda: pad(q, k, v)[0][0][:, :seq].contiguous())
        else:
            row["numerics"] = "ok (plain versions on the cpu; not timed)"
        print(label, json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        description="K1 against the plain attention and K7-seg over padded "
                    "sequences at the DiT's joint and dual attention shapes")
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
