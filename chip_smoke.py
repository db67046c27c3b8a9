#!/usr/bin/env python3
"""Drive the PyTorch port's CTSD-3.5 serving and training paths, its
CTSD-2.1 UNet serving and training paths, the tail-attention tiling
experiment and the attention shoot-out on one GPU.

Run from the root of a checkout:
    python3 chip_smoke.py [--profile-train] [--profile-unet]
                          [--profile-unet-train]

Phases; any failure raises and exits non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: the CUDA kernels from ``opendwm_tpu_torch/csrc`` (one nvcc per
   source, all at once) and the Triton kernels; ptxas's registers and
   spills (its report is kept beside each library, so a library built by
   an earlier run is held too) and a SASS census (``cuobjdump -sass``:
   ``HGMMA``, ``UTMALDG`` / ``LDGSTS``, ``LDSM``) of each instance of the
   Hopper forward (``csrc/flash_fwd_sm90.cuh``, the body of every bf16
   head-dim-64 launch of K1, K7 and K7-seg), failing on an instance that
   ptxas did not report, a spill, or an instance without wgmma or
   asynchronous loads;
3. kernels: each Hopper kernel against its plain PyTorch version on the
   same inputs, at the shapes the serving and training paths give it, in
   bf16 (the attention kernels also in fp32), with both times: K1 (and
   its variant that writes the log-sum-exp for the backward) at the DiT's
   and the UNet's shapes, K2 (the attention backward), K3, K4, K7 (flash
   attention at the UNet's 1792 tokens, at 6400 and causal with q != kv;
   its backward at the UNet's training shape (36 x 1792), at 6400 and
   causal with q shorter and longer than kv, and its forward with the
   log-sum-exp against the serving launch), K7-seg (flash attention with
   segment ids: the shoot-out's flashpad call at (36, 640, 24, 64) with
   the pads of S 602 in segment 1, and random ids in 1-4 segments per row
   at (8, 1792, 24, 64), non-causal and causal, in bf16 and fp32; rows
   that see no key of their segment against the mean of V), K7 at K1's
   serving shapes (equal to K1 bit for bit: one body) and its backward at
   K2's training shapes timed beside K1 and K2 (the numbers of the fold in
   ROADMAP Queue 2), the tail-attention tiling experiment
   (``opendwm_tpu_torch/perf/exp_tailvar.py``: K1, K5 at nh 2 and 4, K6 at
   bq 128 and 256 at (36, 602 | 448, 24, 64) in bf16 and at (8, 602, 24,
   64) in fp32, K5 and K6 equal to each other bit for bit and to K1 within
   the bars; its launches are the ``tailvar`` path's), and the
   attention shoot-out (``opendwm_tpu_torch/perf/exp_attn602.py``: K1, the
   plain attention and K7-seg over S padded to a multiple of 128 at (36,
   602 | 448, 24, 64) bf16; its launches are the ``attn602`` path's, and
   K7-seg must have launched at (36, 640) and (36, 512) there). Beside
   each kernel's time: its plain version's, the least time the card could
   take for the same work (``bound_ms``), and the time of one PyTorch call
   that computes the same function (``library_ms``:
   ``scaled_dot_product_attention`` or its backward for the attention
   kernels, with the boolean same-id mask for K7-seg; none for the AdaLN
   ones). The card's clocks are logged between phases;
4. tiny models: the kernel path end to end (fp32, small widths) against
   the plain path on the CPU: the DiT, one AdamW train step of the DiT
   with remat on, the UNet, and one AdamW train step of the UNet with remat
   on (the train steps through their loss, every gradient and the update);
5. serving slice: ``configs/ctsd/multi_datasets/ctsd_35_tirda_nwao.json``
   at full width (24 layers, 24x64 heads, bf16) with random weights drawn
   on the card from a seed; a 2-window autoregressive rollout of 1 x 6
   frames x 6 views of 32x56 latents with CFG 4.0 (the one cut:
   inference_steps 40 -> 4), then the SD3.5 VAE decode to 256x448 frames.
   Every kernel of the path must have launched during the rollout;
6. train slice: the same config at full width and depth, fp32 master
   weights under bf16 compute, remat as the config sets it, AdamW (lr 5e-5,
   wd 0.01, clip 1.0, fp32 moments); 3 ``train_step`` calls on a synthetic
   batch of the same geometry with an explicit generator, steps 2 and 3
   timed. K1, K2 (at s = 602, 448, 168), K3 and K4 must have launched in
   the timed steps; launches are also counted by phase (forward; backward
   with the remat recompute) on one extra, untimed pass.
   ``--profile-train`` adds 3 more steps, then 3 under ``torch.profiler``,
   and prints their device time by kernel family;
7. UNet serving slice: ``configs/ctsd/multi_datasets/ctsd_21_tirda_nwao.json``
   at full width (320/640/1280/1280 channels, 5/10/20/20 x 64 heads, rowwise
   cross-view and temporal branches, bf16) with random weights drawn on the
   card from a seed; a 2-window autoregressive rollout of 1 x 6 frames x 6
   views of 32x56x4 latents with 77 x 1024 text tokens, DDIM v-prediction
   with CFG 3.0 (the one cut: inference_steps 50 -> 4), then the SD2.1 VAE
   decode to 256x448 frames. K7 must have launched 5 times a CFG forward,
   all at (72, 1792, 5, 64), and K1 at s = 336, 448, 168 during the
   rollout. ``--profile-unet`` adds one
   ``torch.profiler`` CFG forward and prints its device time by kernel
   family;
8. UNet train slice: the CTSD-2.1 config at full width and depth, fp32
   master weights under bf16 compute, remat as the config sets it (every
   resnet and transformer model), AdamW (lr 5e-5, wd 0.01, clip 1.0, fp32
   moments), DDPM v-prediction; 3 ``train_step`` calls on a synthetic batch
   of 1 x 6 frames x 6 views of 32x56x4 latents with 77 x 1024 text tokens
   and an explicit generator, steps 2 and 3 timed. K7 (10 a step: forward
   and remat recompute) and its backward (5 a step), all at (36, 1792, 5,
   64), and K1 and K2 at s = 336, 448, 168 must have launched in the timed
   steps; launches are also counted by phase on one extra,
   untimed pass. ``--profile-unet-train`` adds 3 more steps, then 3
   under ``torch.profiler``.

Each slice is freed before the next. K7-seg must have launched on no path
but the shoot-out, and every K1 and K7 forward launch of the four model
paths must have run the Hopper forward (its launch counters). The line
before the last is the kernels JSON; the last is the device JSON.
"""

from __future__ import annotations

import copy
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

# Before CUDA initialises: 60 GB of training state in few large blocks
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import torch  # noqa: E402

from opendwm_tpu_torch.perf.measure import (  # noqa: E402
    PEAK_FP32,
    attention_bound,
    bound,
    card_line,
    max_err,
    packed_segment_ids,
    rel_err,
    scaled_err,
    segment_attention_bound,
    time_ms,
    time_pair,
)

REPO = Path(__file__).resolve().parent
CONFIG = REPO / "configs/ctsd/multi_datasets/ctsd_35_tirda_nwao.json"
UNET_CONFIG = REPO / "configs/ctsd/multi_datasets/ctsd_21_tirda_nwao.json"
TINY_CONFIG = REPO / "configs/ctsd/ctsd_35_6views_video_synthetic.json"
SEED = 0
STEPS = 4  # cut from the config's 40
WINDOWS = 2
FRAMES, VIEWS, LAT_H, LAT_W, TEXT_TOKENS = 6, 6, 32, 56, 154
DECODE_CHUNK = 12  # frames per VAE decode call
ATTN_SHAPES = ((72, 602), (72, 448), (192, 168))  # (batch, seq); 24x64 heads
TRAIN_ATTN_SHAPES = ((36, 602), (36, 448), (96, 168))  # batch 1, no CFG
TRAIN_STEPS = 3  # steps 2 and 3 are timed
PROFILE_STEPS = 3  # with --profile-train/-unet-train: 3 more, then 3 profiled
ADALN_SHAPES = ((72, 448, 1536), (72, 154, 1536))
# The UNet at the CFG batch: K1 at the level-0 branches (384 x 336), level-1
# self-attention (72 x 448) and branches (192 x 168); K7 at the level-0
# self-attention (72 x 1792) and at the 80x80 LiDAR BEV latents (6400).
UNET_TEXT_TOKENS, UNET_TEXT_DIM, UNET_LAT_C = 77, 1024, 4
UNET_K1_SHAPES = ((384, 336, 5), (72, 448, 10), (192, 168, 10))
K7_SHAPES = ((72, 1792, 1792, 5, False), (8, 6400, 6400, 5, False),
             (8, 1792, 3584, 5, True))  # (batch, q, kv, heads, causal)
# The K7 backward at the UNet's training batch (1 x 36 view-frames, no
# CFG), at the LiDAR UNet's BEV tokens, and causal with q shorter and
# longer than kv; fp32 at a small causal shape.
K7_BWD_SHAPES = ((36, 1792, 1792, 5, False), (8, 6400, 6400, 5, False),
                 (8, 1792, 3584, 5, True), (8, 3584, 1792, 5, True))
K7_BWD_FP32 = (2, 384, 256, 5, True)
# K7-seg (flash attention with segment ids): the shoot-out's flashpad call
# at S 602 padded to 640, pads in segment 1 (batch, seq, padded seq); and
# (batch, seq) with random ids in 1-4 contiguous segments per row.
K7_SEG_FLASHPAD = (36, 602, 640)
K7_SEG_RANDOM = (8, 1792)
# The UNet's level-0 self-attention (K7) in each forward: 2 down and 3 up
# transformer models; a train step runs them forward, again in the remat
# recompute, and backward.
UNET_K7_PER_FORWARD = 5
# The tiling experiment's fp32 check (batch, seq; 24 x 64 heads): S 602
# pads to 640, where K6's bq 256 cuts to 128.
TAILVAR_FP32 = (8, 602)
# The stock Pallas flash attention that K7 replaces (jax 0.9.0): its
# backward is _flash_attention_bwd_dkv (:941) and _flash_attention_bwd_dq
# (:1287).
STOCK_FLASH = "jax/experimental/pallas/ops/tpu/flash_attention.py"
# Tolerances on |kernel - plain| / max(1, |plain|), elementwise: absolute
# for outputs below 1, relative above, because one bf16 ulp is 2^-7 of the
# value (0.0625 at 16) and the two versions may round an fp32 result that
# differs in its last bits to neighbouring bf16 values.
ATTN_TOL, ADALN_TOL, FP32_TOL, TINY_TOL = 2e-2, 3e-2, 1e-4, 1e-3
# Attention in bf16 also ||kernel - plain|| / ||plain||: its outputs sit far
# below 1 (~0.04-0.07 at these shapes), where ATTN_TOL alone is as large as
# a typical value.
ATTN_REL_TOL = 2 ** -7
# K2 in bf16: ||kernel - plain|| / ||plain|| per gradient, the bar recorded
# for the JAX kernel (docs/PARITY.md): dS is rounded to bf16 at other
# points, and delta comes from dO.O instead of dP.P.
K2_REL_TOL = 6e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def adaln_bound(n, l, d, residual=False):
    """bf16 AdaLN: K3 reads x, scale, shift and writes y, ~8 fp32
    operations an element (statistics, normalisation, modulation); K4 also
    reads delta and gate and writes x', ~10 an element."""
    big, small = (4, 3) if residual else (2, 2)
    nbytes = 2 * (big * n * l * d + small * n * d)
    return bound((10 if residual else 8) * n * l * d, nbytes, PEAK_FP32)


def sdpa_ms(q, k, v, scale, causal=False, do=None, ref=None, mask=None):
    """ms of one PyTorch call computing the same function on the same
    inputs (BHSD views of them): ``scaled_dot_product_attention`` (with
    ``mask``, a boolean mask of the visible pairs, in place of ``causal``),
    or with ``do`` its backward from its own forward's output and
    log-sum-exp:
    the flash kernel's, or for causal with q != kv, where the flash kernel
    masks bottom-right, the memory-efficient kernel's, whose ``is_causal``
    is top-left as K7's. With ``ref`` (the plain dq, dk, dv) it logs the
    relative error of the library's gradients. Timed as a yardstick; the
    port never calls it. None, with the reason logged, if the call is
    refused."""
    F = torch.nn.functional
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    try:
        if do is None:
            return time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=causal, scale=scale))
        dot = do.transpose(1, 2)
        if causal and q.shape[1] != k.shape[1]:
            from torch.nn.attention import SDPBackend, sdpa_kernel
            qt, kt, vt = (x.detach().requires_grad_() for x in (qt, kt, vt))
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                out = F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, scale=scale)

            def backward():
                return torch.autograd.grad(out, (qt, kt, vt), dot,
                                           retain_graph=True)
        else:
            aten = torch.ops.aten
            out, lse, cq, ck, mq, mk, seed, offset = \
                aten._scaled_dot_product_flash_attention(
                    qt, kt, vt, 0.0, causal, False, scale=scale)[:8]

            def backward():
                return aten._scaled_dot_product_flash_attention_backward(
                    dot, qt, kt, vt, out, lse, cq, ck, mq, mk, 0.0, causal,
                    seed, offset, scale=scale)[:3]
        if ref is not None:
            rels = [rel_err(a.transpose(1, 2), r)
                    for a, r in zip(backward(), ref)]
            log(f"  library backward vs plain: rel err dq/dk/dv "
                f"{rels[0]:.2e}/{rels[1]:.2e}/{rels[2]:.2e}")
        return time_ms(backward)
    except RuntimeError as err:
        log(f"  library call not measured: {str(err).splitlines()[0][:200]}")
        return None


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.3f} ms"


def yardsticks(ms, plain_ms, library_ms, bound_pair) -> dict:
    """The numbers kept beside each kernel row."""
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_pair[0], "bound_by": bound_pair[1]}


def log_clocks(when: str) -> None:
    """The card's SM clock and its maximum, temperature, power draw and
    active clock-event reasons (a bit mask; 0x0 for none), as nvidia-smi
    reads them: times from one run are comparable only at one clock."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,temperature.gpu,"
         "power.draw,clocks_event_reasons.active", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    log(f"clocks {when}: "
        f"{out.stdout.strip() or 'unread: ' + out.stderr.strip()[:200]}")


def check_attention(dev, flash_tail):
    g = torch.Generator(dev).manual_seed(SEED)
    rows = []
    for b, s in ATTN_SHAPES:
        q, k, v = (torch.randn(b, s, 24, 64, generator=g, device=dev,
                               dtype=torch.bfloat16) for _ in range(3))
        scale = 64 ** -0.5
        out = flash_tail.tail_masked_attention(q, k, v, scale)
        ref = flash_tail.tail_masked_attention_plain(q, k, v, scale)
        err, scaled, rel = max_err(out, ref), scaled_err(out, ref), \
            rel_err(out, ref)
        ms, plain_ms = time_pair(
            lambda: flash_tail.tail_masked_attention(q, k, v, scale),
            lambda: flash_tail.tail_masked_attention_plain(q, k, v, scale))
        lib_ms = sdpa_ms(q, k, v, scale)
        log(f"K1 flash_tail bf16 ({b},{s},24,64): max_abs_err {err:.3e}, "
            f"scaled {scaled:.3e} (tol {ATTN_TOL}), rel norm {rel:.3e} (tol "
            f"{ATTN_REL_TOL}), kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"sdpa {fmt_ms(lib_ms)}")
        if not (scaled <= ATTN_TOL and rel <= ATTN_REL_TOL):
            fail(f"flash_tail disagrees at s={s}: scaled {scaled}, rel {rel}")
        rows.append({"shape": [b, s, 24, 64], "dtype": "bf16",
                     "max_abs_err": err, "scaled_err": scaled,
                     "rel_err": rel,
                     **yardsticks(ms, plain_ms, lib_ms,
                                  attention_bound(b, s, s, 24, 64))})
    q, k, v = (torch.randn(192, 168, 24, 64, generator=g, device=dev)
               for _ in range(3))
    err = max_err(flash_tail.tail_masked_attention(q, k, v, 0.125),
                  flash_tail.tail_masked_attention_plain(q, k, v, 0.125))
    log(f"K1 flash_tail fp32 (192,168,24,64): max_abs_err {err:.3e} "
        f"(tol {FP32_TOL})")
    if not err <= FP32_TOL:
        fail(f"flash_tail disagrees in fp32: {err}")
    return rows


def check_attention_backward(dev, flash_tail):
    """K2 against the plain backward at the training shapes, bf16, and one
    fp32 shape; K1 with the log-sum-exp against the serving K1 at s602."""
    g = torch.Generator(dev).manual_seed(SEED + 2)
    scale = 64 ** -0.5
    rows = []
    cases = [(b, s, torch.bfloat16) for b, s in TRAIN_ATTN_SHAPES] + \
        [(TRAIN_ATTN_SHAPES[2][0], TRAIN_ATTN_SHAPES[2][1], torch.float32)]
    for b, s, dtype in cases:
        q, k, v, do = (torch.randn(b, s, 24, 64, generator=g, device=dev,
                                   dtype=dtype) for _ in range(4))
        out, lse = flash_tail.tail_masked_attention_forward(q, k, v, scale)
        grads = flash_tail.tail_masked_attention_backward(q, k, v, out, do,
                                                          lse, scale)
        ref = flash_tail.tail_masked_attention_backward_plain(q, k, v, do,
                                                              scale)
        errs = [max_err(a, r) for a, r in zip(grads, ref)]
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        if dtype == torch.float32:
            scaled = max(scaled_err(a, r) for a, r in zip(grads, ref))
            log(f"K2 flash_tail backward fp32 ({b},{s},24,64): max_abs_err "
                f"{max(errs):.3e}, scaled {scaled:.3e} (tol {FP32_TOL})")
            if not scaled <= FP32_TOL:
                fail(f"flash_tail backward disagrees in fp32: {scaled}")
            continue
        rels = [rel_err(a, r) for a, r in zip(grads, ref)]
        ms, plain_ms = time_pair(
            lambda: flash_tail.tail_masked_attention_backward(
                q, k, v, out, do, lse, scale),
            lambda: flash_tail.tail_masked_attention_backward_plain(
                q, k, v, do, scale))
        lib_ms = sdpa_ms(q, k, v, scale, do=do)
        log(f"K2 flash_tail backward {tag} ({b},{s},24,64): rel err dq/dk/dv "
            f"{rels[0]:.2e}/{rels[1]:.2e}/{rels[2]:.2e} (tol {K2_REL_TOL}), "
            f"max_abs_err {max(errs):.3e}, kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, sdpa flash backward {fmt_ms(lib_ms)}")
        if not max(rels) <= K2_REL_TOL:
            fail(f"flash_tail backward disagrees at s={s}: {rels}")
        rows.append({"shape": [b, s, 24, 64], "dtype": tag,
                     "max_abs_err": max(errs), "rel_err": rels,
                     **yardsticks(ms, plain_ms, lib_ms,
                                  attention_bound(b, s, s, 24, 64,
                                                  backward=True))})
        del q, k, v, do, out, lse, grads, ref
    torch.cuda.empty_cache()

    b, s = ATTN_SHAPES[0]
    q, k, v = (torch.randn(b, s, 24, 64, generator=g, device=dev,
                           dtype=torch.bfloat16) for _ in range(3))
    lse_ms, serve_ms = time_pair(
        lambda: flash_tail.tail_masked_attention_forward(q, k, v, scale),
        lambda: flash_tail.tail_masked_attention(q, k, v, scale))
    log(f"K1 flash_tail bf16 ({b},{s},24,64): with the log-sum-exp "
        f"{lse_ms:.3f} ms, serving launch {serve_ms:.3f} ms")
    return rows, {"lse_ms": lse_ms, "serving_ms": serve_ms}


def check_unet_attention(dev, flash_tail, flash_attention):
    """K1 at the UNet's shapes and K7 at its own, each against its plain
    version in bf16 with both times; K7 also in fp32."""
    g = torch.Generator(dev).manual_seed(SEED + 3)
    k1_rows, k7_rows = [], []
    scale = 64 ** -0.5
    for b, s, h in UNET_K1_SHAPES:
        q, k, v = (torch.randn(b, s, h, 64, generator=g, device=dev,
                               dtype=torch.bfloat16) for _ in range(3))
        out = flash_tail.tail_masked_attention(q, k, v, scale)
        ref = flash_tail.tail_masked_attention_plain(q, k, v, scale)
        err, scaled, rel = max_err(out, ref), scaled_err(out, ref), \
            rel_err(out, ref)
        del out, ref
        ms, plain_ms = time_pair(
            lambda: flash_tail.tail_masked_attention(q, k, v, scale),
            lambda: flash_tail.tail_masked_attention_plain(q, k, v, scale))
        lib_ms = sdpa_ms(q, k, v, scale)
        log(f"K1 flash_tail bf16 ({b},{s},{h},64) [UNet]: max_abs_err "
            f"{err:.3e}, scaled {scaled:.3e} (tol {ATTN_TOL}), rel norm "
            f"{rel:.3e} (tol {ATTN_REL_TOL}), kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, sdpa {fmt_ms(lib_ms)}")
        if not (scaled <= ATTN_TOL and rel <= ATTN_REL_TOL):
            fail(f"flash_tail disagrees at the UNet's {(b, s, h)}: scaled "
                 f"{scaled}, rel {rel}")
        k1_rows.append({"shape": [b, s, h, 64], "dtype": "bf16",
                        "max_abs_err": err, "scaled_err": scaled,
                        "rel_err": rel,
                        **yardsticks(ms, plain_ms, lib_ms,
                                     attention_bound(b, s, s, h, 64))})
        del q, k, v

    for b, sq, sk, h, causal in K7_SHAPES:
        q = torch.randn(b, sq, h, 64, generator=g, device=dev,
                        dtype=torch.bfloat16)
        k, v = (torch.randn(b, sk, h, 64, generator=g, device=dev,
                            dtype=torch.bfloat16) for _ in range(2))

        def kernel():
            return flash_attention.flash_attention(q, k, v, scale, causal)

        def plain():
            return flash_attention.flash_attention_plain(q, k, v, scale,
                                                         causal)

        out, ref = kernel(), plain()
        err, scaled, rel = max_err(out, ref), scaled_err(out, ref), \
            rel_err(out, ref)
        del out, ref
        ms, plain_ms = time_pair(kernel, plain)
        lib_ms = sdpa_ms(q, k, v, scale, causal)
        tag = f"({b},{sq},{sk},{h},64){' causal' if causal else ''}"
        log(f"K7 flash_attention bf16 {tag}: max_abs_err {err:.3e}, scaled "
            f"{scaled:.3e} (tol {ATTN_TOL}), rel norm {rel:.3e} (tol "
            f"{ATTN_REL_TOL}), kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"sdpa {fmt_ms(lib_ms)}")
        if not (scaled <= ATTN_TOL and rel <= ATTN_REL_TOL):
            fail(f"flash_attention disagrees at {tag}: scaled {scaled}, rel "
                 f"{rel}")
        k7_rows.append({"shape": [b, sq, sk, h, 64], "causal": causal,
                        "dtype": "bf16", "max_abs_err": err,
                        "scaled_err": scaled, "rel_err": rel,
                        **yardsticks(ms, plain_ms, lib_ms,
                                     attention_bound(b, sq, sk, h, 64,
                                                     causal))})
        if sq == 1792:  # the UNet's shapes, also in fp32
            q, k, v = q.float(), k.float(), v.float()
            err = scaled_err(kernel(), plain())
            log(f"K7 flash_attention fp32 {tag}: scaled err {err:.3e} "
                f"(tol {FP32_TOL})")
            if not err <= FP32_TOL:
                fail(f"flash_attention disagrees in fp32 at {tag}: {err}")
        del q, k, v
        torch.cuda.empty_cache()
    return k1_rows, k7_rows


def check_flash_attention_backward(dev, flash_attention):
    """The K7 backward against its plain version (each from its own
    forward's output and log-sum-exp) at ``K7_BWD_SHAPES`` in bf16, with
    both times, the relative error of each gradient and the time of the
    library's flash backward; fp32 at ``K7_BWD_FP32``. Then K7 with the
    log-sum-exp against the serving launch at the training shape."""
    g = torch.Generator(dev).manual_seed(SEED + 4)
    scale = 64 ** -0.5
    rows = []
    for (b, sq, sk, h, causal), dtype in \
            [(s, torch.bfloat16) for s in K7_BWD_SHAPES] + \
            [(K7_BWD_FP32, torch.float32)]:
        q, do = (torch.randn(b, sq, h, 64, generator=g, device=dev,
                             dtype=dtype) for _ in range(2))
        k, v = (torch.randn(b, sk, h, 64, generator=g, device=dev,
                            dtype=dtype) for _ in range(2))
        out, lse = flash_attention.flash_attention_forward(q, k, v, scale,
                                                           causal)
        ref_out, ref_lse = flash_attention.flash_attention_forward_plain(
            q, k, v, scale, causal)

        def kernel():
            return flash_attention.flash_attention_backward(
                q, k, v, out, do, lse, scale, causal)

        def plain():
            return flash_attention.flash_attention_backward_plain(
                q, k, v, ref_out, ref_lse, do, scale, causal)

        grads, ref = kernel(), plain()
        errs = [max_err(a, r) for a, r in zip(grads, ref)]
        tag = f"({b},{sq},{sk},{h},64){' causal' if causal else ''}"
        if dtype == torch.float32:
            scaled = max(scaled_err(a, r) for a, r in zip(grads, ref))
            log(f"K7 flash_attention backward fp32 {tag}: max_abs_err "
                f"{max(errs):.3e}, scaled {scaled:.3e} (tol {FP32_TOL})")
            if not scaled <= FP32_TOL:
                fail(f"flash_attention backward disagrees in fp32 at {tag}: "
                     f"{scaled}")
            continue
        rels = [rel_err(a, r) for a, r in zip(grads, ref)]
        lib_ms = sdpa_ms(q, k, v, scale, causal, do=do, ref=ref)
        del grads, ref
        torch.cuda.empty_cache()
        ms, plain_ms = time_pair(kernel, plain)
        log(f"K7 flash_attention backward bf16 {tag}: rel err dq/dk/dv "
            f"{rels[0]:.2e}/{rels[1]:.2e}/{rels[2]:.2e} (tol {K2_REL_TOL}), "
            f"max_abs_err {max(errs):.3e}, kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, sdpa backward {fmt_ms(lib_ms)}")
        if not max(rels) <= K2_REL_TOL:
            fail(f"flash_attention backward disagrees at {tag}: {rels}")
        rows.append({"shape": [b, sq, sk, h, 64], "causal": causal,
                     "dtype": "bf16", "max_abs_err": max(errs),
                     "rel_err": rels,
                     **yardsticks(ms, plain_ms, lib_ms,
                                  attention_bound(b, sq, sk, h, 64, causal,
                                                  backward=True))})
        del q, k, v, do, out, lse, ref_out, ref_lse
        torch.cuda.empty_cache()

    b, sq, sk, h, _ = K7_BWD_SHAPES[0]
    q, k, v = (torch.randn(b, sq, h, 64, generator=g, device=dev,
                           dtype=torch.bfloat16) for _ in range(3))
    lse_ms, serve_ms = time_pair(
        lambda: flash_attention.flash_attention_forward(q, k, v, scale),
        lambda: flash_attention.flash_attention(q, k, v, scale))
    log(f"K7 flash_attention bf16 ({b},{sq},{sk},{h},64): with the "
        f"log-sum-exp {lse_ms:.3f} ms, serving launch {serve_ms:.3f} ms")
    return rows, {"lse_ms": lse_ms, "serving_ms": serve_ms}


def check_flash_attention_segment(dev, flash_attention):
    """K7-seg against its plain version, each case with both times, the
    bound over the pairs its ids leave and SDPA with the boolean same-id
    mask (only where no row is fully hidden): the flashpad call at
    ``K7_SEG_FLASHPAD`` in bf16 and fp32, random ids at ``K7_SEG_RANDOM``
    non-causal and causal in both types; then rows that see no key of
    their segment (non-causal, fp32) against the mean of V."""
    SegmentIds = flash_attention.SegmentIds
    g = torch.Generator(dev).manual_seed(SEED + 5)
    scale = 64 ** -0.5
    b, seq, padded = K7_SEG_FLASHPAD
    pad_ids = torch.zeros(b, padded, dtype=torch.int32, device=dev)
    pad_ids[:, seq:] = 1
    rb, rs = K7_SEG_RANDOM
    rand_ids = packed_segment_ids(rb, rs, SEED + 5, dev)
    hidden_q = rand_ids.clone()
    hidden_q[:, ::5] = 99  # every fifth query shares no key's id
    cases = [("flashpad", pad_ids, pad_ids, False, dtype, 0.5)
             for dtype in (torch.bfloat16, torch.float32)] + \
        [("random", rand_ids, rand_ids, causal, dtype, 1.0)
         for dtype in (torch.bfloat16, torch.float32)
         for causal in (False, True)] + \
        [("hidden rows", hidden_q, rand_ids, False, torch.float32, 1.0)]
    rows = []
    for what, q_ids, kv_ids, causal, dtype, std in cases:
        bq, sq = q_ids.shape
        q, k, v = ((torch.randn(bq, sq, 24, 64, generator=g, device=dev)
                    * std).to(dtype) for _ in range(3))
        ids = SegmentIds(q_ids, kv_ids)

        def kernel():
            return flash_attention.flash_attention(q, k, v, scale, causal,
                                                   segment_ids=ids)

        def plain():
            return flash_attention.flash_attention_plain(q, k, v, scale,
                                                         causal, ids)

        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        err, scaled, rel = max_err(out, ref), scaled_err(out, ref), \
            rel_err(out, ref)
        bf16 = dtype == torch.bfloat16
        tol, rel_tol = (ATTN_TOL, ATTN_REL_TOL) if bf16 else (FP32_TOL, 1e-5)
        tag = (f"{what} {'bf16' if bf16 else 'fp32'} ({bq},{sq},24,64)"
               f"{' causal' if causal else ''}")
        visible = q_ids[:, :, None] == kv_ids[:, None, :]
        if causal:
            visible &= torch.ones(sq, sq, dtype=torch.bool, device=dev).tril()
        seen = visible.any(-1)
        extra = ""
        if not seen.all():
            mean_v = v.float().mean(1, keepdim=True).expand_as(out)
            hid = ~seen
            mean_err = scaled_err(out[hid], mean_v[hid])
            extra = (f", {int(hid.sum())} rows with no key of their segment "
                     f"vs the mean of V {mean_err:.3e} (tol {FP32_TOL})")
            if not mean_err <= FP32_TOL:
                fail(f"flash_attention_segment {tag}: hidden rows are not "
                     f"the mean of V: {mean_err}")
        del out, ref
        ms, plain_ms = time_pair(kernel, plain)
        lib_ms = sdpa_ms(q, k, v, scale, mask=visible[:, None]) \
            if seen.all() else None
        bnd = segment_attention_bound(q_ids, kv_ids, 24, 64, causal, dtype)
        log(f"K7-seg flash_attention_segment {tag}: max_abs_err {err:.3e}, "
            f"scaled {scaled:.3e} (tol {tol}), rel norm {rel:.3e} (tol "
            f"{rel_tol}){extra}, kernel {ms:.3f} ms, plain {plain_ms:.3f} "
            f"ms, bound {bnd[0]:.3f} ms ({bnd[1]}), sdpa with the mask "
            f"{fmt_ms(lib_ms)}")
        if not (scaled <= tol and rel <= rel_tol):
            fail(f"flash_attention_segment disagrees at {tag}: scaled "
                 f"{scaled}, rel {rel}")
        rows.append({"case": what, "shape": [bq, sq, sq, 24, 64],
                     "causal": causal, "dtype": "bf16" if bf16 else "fp32",
                     "max_abs_err": err, "scaled_err": scaled,
                     "rel_err": rel,
                     **yardsticks(ms, plain_ms, lib_ms, bnd)})
        del q, k, v, visible
        torch.cuda.empty_cache()
    return rows


def check_k7_at_tail_shapes(dev, flash_tail, flash_attention):
    """K7 (no padding: it masks by bounds) at K1's serving shapes, equal to
    K1 bit for bit (both launch the Hopper forward of
    ``csrc/flash_fwd_sm90.cuh``), and its backward at K2's training shapes
    against its plain version; each timed beside K1 or K2 in turns (K1, K7,
    K7, K1): the numbers of the fold of the two sources (ROADMAP Queue 2)."""
    g = torch.Generator(dev).manual_seed(SEED + 6)
    scale = 64 ** -0.5
    fwd, bwd = [], []
    for b, s in ATTN_SHAPES:
        q, k, v = (torch.randn(b, s, 24, 64, generator=g, device=dev,
                               dtype=torch.bfloat16) for _ in range(3))
        same = torch.equal(flash_attention.flash_attention(q, k, v, scale),
                           flash_tail.tail_masked_attention(q, k, v, scale))
        if not same:
            fail(f"K7 differs from K1 at K1's ({b},{s}), though both run "
                 "one body")
        k7_ms, k1_ms = time_pair(
            lambda: flash_attention.flash_attention(q, k, v, scale),
            lambda: flash_tail.tail_masked_attention(q, k, v, scale))
        log(f"K7 at K1's shape bf16 ({b},{s},24,64): equal to K1 bit for "
            f"bit, K7 {k7_ms:.3f} ms, K1 {k1_ms:.3f} ms "
            f"({k7_ms / k1_ms:.3f}x)")
        fwd.append({"shape": [b, s, 24, 64], "equals_k1": same,
                    "k7_ms": k7_ms, "k1_ms": k1_ms,
                    "bound_ms": attention_bound(b, s, s, 24, 64)[0]})
        del q, k, v
    for b, s in TRAIN_ATTN_SHAPES:
        q, k, v, do = (torch.randn(b, s, 24, 64, generator=g, device=dev,
                                   dtype=torch.bfloat16) for _ in range(4))
        out7, lse7 = flash_attention.flash_attention_forward(q, k, v, scale)
        out1, lse1 = flash_tail.tail_masked_attention_forward(q, k, v, scale)
        ref_out, ref_lse = flash_attention.flash_attention_forward_plain(
            q, k, v, scale)
        grads = flash_attention.flash_attention_backward(q, k, v, out7, do,
                                                         lse7, scale)
        ref = flash_attention.flash_attention_backward_plain(
            q, k, v, ref_out, ref_lse, do, scale)
        rels = [rel_err(a, r) for a, r in zip(grads, ref)]
        del grads, ref, ref_out, ref_lse
        if not max(rels) <= K2_REL_TOL:
            fail(f"the K7 backward disagrees at K2's ({b},{s}): {rels}")
        k7_ms, k2_ms = time_pair(
            lambda: flash_attention.flash_attention_backward(
                q, k, v, out7, do, lse7, scale),
            lambda: flash_tail.tail_masked_attention_backward(
                q, k, v, out1, do, lse1, scale))
        log(f"K7 backward at K2's shape bf16 ({b},{s},24,64): rel err "
            f"dq/dk/dv {rels[0]:.2e}/{rels[1]:.2e}/{rels[2]:.2e} (tol "
            f"{K2_REL_TOL}), K7 backward {k7_ms:.3f} ms, K2 {k2_ms:.3f} ms "
            f"({k7_ms / k2_ms:.3f}x)")
        bwd.append({"shape": [b, s, 24, 64], "rel_err": rels,
                    "k7_ms": k7_ms, "k2_ms": k2_ms,
                    "bound_ms": attention_bound(b, s, s, 24, 64,
                                                backward=True)[0]})
        del q, k, v, do, out7, lse7, out1, lse1
        torch.cuda.empty_cache()
    return fwd, bwd


def run_tailvar(dev, ops, exp_tailvar):
    """The tail-attention tiling experiment through its run function at its
    full shapes in bf16 and at ``TAILVAR_FP32``: K1, K5 (nh 2, 4) and K6 (bq
    128, 256), each against the plain version (the scaled error and the
    relative norm), timed beside it, the bound and SDPA. K5 and K6 run one
    mma.sync tile step, so they must equal each other bit for bit; K1 runs
    the Hopper forward of ``csrc/flash_fwd_sm90.cuh`` in bf16 at D 64, so
    they are held to it within the same bars. Returns the experiment's
    launches and the K5 and K6 rows."""
    ops.reset_launch_counts()
    runs = [(exp_tailvar.run(seq, label, dev), ATTN_TOL)
            for label, seq in exp_tailvar.SHAPES.items()]
    b, seq = TAILVAR_FP32
    runs.append((exp_tailvar.run(seq, "fp32", dev, b=b, dtype=torch.float32),
                 FP32_TOL))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    log(f"launches in the tiling experiment: {json.dumps(counts)}")
    rows = {"tail_hpack": [], "tail_qsplit": []}
    for results, tol in runs:  # each row was printed by the experiment
        for r in results:
            rel_tol = exp_tailvar.REL_TOL[getattr(torch, r["dtype"])]
            near_k1 = r.get("vs_k1_scaled_err", 0.0) <= tol and \
                r.get("vs_k1_rel_err", 0.0) <= rel_tol
            if not (r["scaled_err"] <= tol and r["rel_err"] <= rel_tol
                    and near_k1 and r.get("equals_tilings", True)):
                fail(f"tiling {r['variant']} {r['dtype']} {r['shape']} "
                     f"disagrees: scaled {r['scaled_err']} (bar {tol}), "
                     f"relative norm {r['rel_err']} (bar {rel_tol}), "
                     f"against K1 {r.get('vs_k1_scaled_err')} / "
                     f"{r.get('vs_k1_rel_err')}, equal to the other "
                     f"tilings: {r.get('equals_tilings')}")
            if r["kernel"] in rows:
                rows[r["kernel"]].append(r)
    for key, want in (("tail_hpack_by_nh", (2, 4)),
                      ("tail_qsplit_by_bq", (128, 256))):
        for n in want:
            if counts[key].get(n, 0) == 0:
                fail(f"{key}[{n}] never launched in the tiling experiment")
    return counts, rows


def run_attn602(dev, ops, exp_attn602):
    """The attention shoot-out through its run function at its full shapes
    in bf16: K1, the plain attention and K7-seg over the sequence padded to
    a multiple of 128 (flashpad), each against the plain attention (it
    raises on one that disagrees) and timed beside it, the bound and SDPA.
    K7-seg must have launched at both padded shapes. Returns the
    shoot-out's launches."""
    ops.reset_launch_counts()
    runs = [exp_attn602.run(seq, label, dev)
            for label, seq in exp_attn602.SHAPES.items()]
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    log(f"launches in the attention shoot-out: {json.dumps(counts)}")
    for rows in runs:  # each row was printed by the shoot-out
        for r in rows:
            if not (r["scaled_err"] <= ATTN_TOL and
                    r["rel_err"] <= exp_attn602.REL_TOL[torch.bfloat16]):
                fail(f"shoot-out {r['variant']} {r['shape']} disagrees: "
                     f"scaled {r['scaled_err']}, relative norm "
                     f"{r['rel_err']}")
    b, h, d = exp_attn602.B, exp_attn602.H, exp_attn602.HD
    for seq in exp_attn602.SHAPES.values():
        padded = -(-seq // 128) * 128
        key = f"{b},{padded},{padded},{h},{d}"
        if counts["flash_attention_segment_by_shape"].get(key, 0) == 0:
            fail(f"flash_attention_segment never launched at ({key}) in the "
                 "shoot-out")
    return counts


def check_adaln(dev, fused_adaln):
    g = torch.Generator(dev).manual_seed(SEED + 1)
    rows = {"adaln_modulate": [], "residual_adaln_modulate": []}
    for (n, l, d), dtype in [(s, torch.bfloat16) for s in ADALN_SHAPES] + \
            [(ADALN_SHAPES[0], torch.float32)]:
        x, delta = (torch.randn(n, l, d, generator=g, device=dev,
                                dtype=dtype) for _ in range(2))
        # strided per-sample vectors, as the model's modulation chunks are
        gate, scale, shift = torch.randn(
            n, 9 * d, generator=g, device=dev,
            dtype=dtype).chunk(9, dim=-1)[:3]
        cases = {
            "adaln_modulate": (
                lambda: fused_adaln.adaln_modulate(x, scale, shift),
                lambda: fused_adaln.adaln_modulate_plain(x, scale, shift)),
            "residual_adaln_modulate": (
                lambda: fused_adaln.residual_adaln_modulate(
                    x, delta, gate, scale, shift),
                lambda: fused_adaln.residual_adaln_modulate_plain(
                    x, delta, gate, scale, shift)),
        }
        for name, (kernel, plain) in cases.items():
            outs, refs = kernel(), plain()
            if not isinstance(outs, tuple):
                outs, refs = (outs,), (refs,)
            err = max(max_err(a, b) for a, b in zip(outs, refs))
            rel = max(scaled_err(a, b) for a, b in zip(outs, refs))
            tol = ADALN_TOL if dtype == torch.bfloat16 else FP32_TOL
            tag = "bf16" if dtype == torch.bfloat16 else "fp32"
            if not rel <= tol:
                fail(f"{name} {tag} disagrees at {(n, l, d)}: {rel}")
            if dtype != torch.bfloat16:
                log(f"{name} fp32 ({n},{l},{d}): max_abs_err {err:.3e} "
                    f"(tol {tol})")
                continue
            ms, plain_ms = time_pair(kernel, plain)
            log(f"{name} bf16 ({n},{l},{d}): max_abs_err {err:.3e}, scaled "
                f"{rel:.3e} (tol {tol}), kernel {ms:.3f} ms, plain "
                f"{plain_ms:.3f} ms")
            rows[name].append({
                "shape": [n, l, d], "dtype": "bf16", "max_abs_err": err,
                "scaled_err": rel,
                **yardsticks(ms, plain_ms, None, adaln_bound(
                    n, l, d, residual=name.startswith("residual")))})
    return rows


def check_tiny_model(dev, DiTCrossviewTemporal):
    """Kernel path (card, fp32) vs plain path (CPU) on one small model."""
    torch.manual_seed(SEED)
    model = DiTCrossviewTemporal(
        patch_size=2, num_layers=3, attention_head_dim=16,
        num_attention_heads=2, in_channels=16, out_channels=16,
        joint_attention_dim=24, caption_projection_dim=32,
        pooled_projection_dim=16, pos_embed_max_size=16, sample_size=8,
        dual_attention_layers=(0,), enable_crossview=True,
        crossview_attention_type="rowwise", crossview_block_layers=(1,),
        enable_temporal=True, temporal_attention_type="pointwise",
        temporal_block_layers=(2,), qk_norm_on_additional_modules="rms_norm",
    ).eval()
    g = torch.Generator().manual_seed(SEED)
    args = dict(  # 96 latent + 40 text tokens: a 136-token joint attention
        sample=torch.randn(1, 2, 4, 16, 24, 16, generator=g),
        timestep=torch.rand(1, 2, 4, generator=g) * 1000,
        encoder_hidden_states=torch.randn(1, 2, 4, 40, 24, generator=g),
        pooled_projections=torch.randn(1, 2, 4, 16, generator=g),
    )
    with torch.no_grad():
        ref = model(**args)
        out = model.to(dev)(**{k: a.to(dev) for k, a in args.items()}).cpu()
    err = max_err(out, ref)
    log(f"tiny model, kernels on the card vs plain on the CPU (fp32): "
        f"max_abs_err {err:.3e} (tol {TINY_TOL})")
    if not err <= TINY_TOL:
        fail(f"tiny model disagrees: {err}")


def check_tiny_unet(dev, UNetCrossviewTemporal, flash_attention, flash_tail):
    """The UNet's kernel path (card, fp32) vs its plain path (CPU): 16x24
    latents give a 384-token self-attention (K7) and, over 6 views, a
    144-token rowwise cross-view attention (K1)."""
    torch.manual_seed(SEED)
    model = UNetCrossviewTemporal(
        in_channels=4, out_channels=4, block_out_channels=(8, 16, 16),
        layers_per_block=1, num_attention_heads=(2, 2, 2),
        cross_attention_dim=12, addition_time_embed_dim=8,
        projection_class_embeddings_input_dim=24, merge_factor=2.0,
        enable_rowwise_crossview=True, enable_rowwise_temporal=True).eval()
    g = torch.Generator().manual_seed(SEED)
    args = dict(
        sample=torch.randn(1, 2, 6, 16, 24, 4, generator=g),
        timestep=torch.randint(0, 1000, (1, 2, 6), generator=g),
        encoder_hidden_states=torch.randn(1, 2, 6, 5, 12, generator=g),
        added_time_ids=torch.randn(1, 2, 6, 3, generator=g),
    )
    with torch.no_grad():
        ref = model(**args)
        flash_attention.reset_launches()
        flash_tail.reset_launches()
        out = model.to(dev)(**{k: a.to(dev) for k, a in args.items()}).cpu()
    k7, k1 = flash_attention.launches, flash_tail.launches
    err = max_err(out, ref)
    log(f"tiny UNet, kernels on the card vs plain on the CPU (fp32): "
        f"max_abs_err {err:.3e} (tol {TINY_TOL}); K7 launches {k7}, K1 {k1}")
    if not err <= TINY_TOL:
        fail(f"tiny UNet disagrees: {err}")
    if k7 != 3 or k1 != 3:
        fail(f"tiny UNet launched K7 {k7} and K1 {k1} times, not 3 and 3")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _one_step(pipe, batch, draws) -> dict:
    """One ``train_step``: its metrics, the gradients the optimizer received
    (after clipping), its learning rate, and each parameter before and
    after, on the CPU."""
    state = pipe.init_state()
    params = list(pipe.model.parameters())
    before = [p.detach().cpu().clone() for p in params]
    seen = {}

    def grab(optimizer, *_):
        seen["lr"] = optimizer.param_groups[0]["lr"]
        seen["grads"] = [torch.zeros(p.shape) if p.grad is None
                         else p.grad.detach().cpu().clone() for p in params]

    hook = state.optimizer.register_step_pre_hook(grab)
    _, metrics = pipe.train_step(state, batch, draws=draws)
    hook.remove()
    return {**seen, "metrics": {k: v.item() for k, v in metrics.items()},
            "before": before, "after": [p.detach().cpu() for p in params]}


def step_errors(out: dict, ref: dict) -> dict:
    """How far one train step (``_one_step``) is from the reference's on
    the same model and draws. ``loss`` and ``grad_norm``: relative.
    ``grad``: the largest of max|g - g_ref| over the largest |g_ref| of its
    tensor, or over 1% of the largest of all if that is more (a gradient
    far below the rest is a sum of cancelling terms whose rounding scales
    with the terms). ``update`` (in units of the learning rate): the largest
    gap between the two updates where the gradient is at least ten times
    that bar, so its sign is certain; there AdamW's first step moves by
    about lr (sign of g) plus the decay, so a wrong sign shows as 2. Two
    fp32 ulps of the parameter are allowed for rounding. ``update_any``:
    the same over every entry (at most 2 plus rounding). ``certain``: the
    share of entries whose sign is certain."""
    lr = ref["lr"]
    top = max(g.abs().max().item() for g in ref["grads"])
    grad = update = update_any = 0.0
    certain = total = 0
    for g, gr, b, a, ar in zip(out["grads"], ref["grads"], ref["before"],
                               out["after"], ref["after"]):
        bar = max(gr.abs().max().item(), 1e-2 * top)
        grad = max(grad, (g - gr).abs().max().item() / bar)
        sure = gr.abs() > 10 * TINY_TOL * bar
        ulp = torch.nextafter(b.abs(), torch.tensor(float("inf"))) - b.abs()
        gap = (a - ar).abs() - 2 * ulp  # both started from b
        update_any = max(update_any, gap.max().item() / lr)
        if sure.any():
            update = max(update, gap[sure].max().item() / lr)
        certain += int(sure.sum())
        total += sure.numel()
    m, mr = out["metrics"], ref["metrics"]
    return {"loss": abs(m["sd_loss"] - mr["sd_loss"]) / mr["sd_loss"],
            "grad_norm": abs(m["grad_norm"] - mr["grad_norm"])
            / mr["grad_norm"],
            "grad": grad, "update": update, "update_any": update_any,
            "certain": certain / total}


def check_step_errors(errs: dict, what: str) -> None:
    """Loss, gradient norm and every gradient to ``TINY_TOL``; the update
    to 1% of the learning rate where the gradient's sign is certain, on at
    least half the entries."""
    log(f"{what}, kernels on the card vs plain on the CPU (fp32): rel err "
        f"loss {errs['loss']:.2e}, grad norm {errs['grad_norm']:.2e}, "
        f"gradients {errs['grad']:.2e} (tol {TINY_TOL}); update gap "
        f"{errs['update']:.2e} lr where the sign is certain "
        f"({100 * errs['certain']:.1f}% of entries; tol 1e-2), "
        f"{errs['update_any']:.2e} lr anywhere (tol 2.02)")
    if not (errs["loss"] <= TINY_TOL and errs["grad_norm"] <= TINY_TOL
            and errs["grad"] <= TINY_TOL and errs["update"] <= 1e-2
            and errs["update_any"] <= 2.02 and errs["certain"] >= 0.5):
        fail(f"{what} disagrees: {errs}")


def check_tiny_train_step(dev, create_instance_from_config,
                          draw_training_randoms):
    """One AdamW step of a tiny model with remat on: the kernel path on the
    card against the plain path on the CPU, fp32, on the same draws."""
    cfg = json.loads(TINY_CONFIG.read_text())["pipeline"]
    cfg["model"].update(
        num_layers=3, dual_attention_layers=[0], crossview_block_layers=[1],
        temporal_block_layers=[2], param_dtype=torch.float32,
        gradient_checkpointing=True, crossview_gradient_checkpointing=True,
        temporal_gradient_checkpointing=True)
    torch.manual_seed(SEED)
    ref_pipe = create_instance_from_config(cfg)
    pipe = copy.deepcopy(ref_pipe)
    pipe.model.to(dev)
    g = torch.Generator().manual_seed(SEED)
    batch = {  # 96 latent + 40 text tokens: a 136-token joint attention
        "latents": torch.randn(1, 2, 2, 16, 24, 16, generator=g),
        "encoder_hidden_states": torch.randn(1, 2, 2, 40, 24, generator=g),
        "pooled_projections": torch.randn(1, 2, 2, 16, generator=g),
    }
    draws = draw_training_randoms(batch["latents"].shape,
                                  ref_pipe.training_config,
                                  ref_pipe.common_config, g)
    ref = _one_step(ref_pipe, batch, draws)
    out = _one_step(pipe, _to(batch, dev), _to(draws, dev))
    check_step_errors(step_errors(out, ref), "tiny train step (remat, AdamW)")


def check_tiny_unet_train_step(dev, create_instance_from_config,
                               draw_training_randoms, flash_attention,
                               flash_tail):
    """One AdamW step of a tiny UNet with remat on: the kernel path on the
    card (K7 and its backward at 384 tokens, K1 and K2 at 144) against the
    plain path on the CPU, fp32, on the same draws."""
    cfg = json.loads(UNET_CONFIG.read_text())["pipeline"]
    cfg["model"] = dict(
        _class_name=cfg["model"]["_class_name"], in_channels=4,
        out_channels=4, block_out_channels=[8, 16, 16], layers_per_block=1,
        num_attention_heads=[2, 2, 2], cross_attention_dim=12,
        addition_time_embed_dim=8, merge_factor=2.0,
        enable_rowwise_crossview=True, enable_rowwise_temporal=True,
        gradient_checkpointing=True, param_dtype=torch.float32)
    cfg["common_config"].pop("added_time_ids")
    cfg["training_config"]["reference_latent_count"] = 1
    torch.manual_seed(SEED)
    ref_pipe = create_instance_from_config(cfg)
    pipe = copy.deepcopy(ref_pipe)
    pipe.model.to(dev)
    g = torch.Generator().manual_seed(SEED)
    batch = {"latents": torch.randn(1, 2, 6, 16, 24, 4, generator=g),
             "encoder_hidden_states": torch.randn(1, 2, 6, 5, 12,
                                                  generator=g)}
    draws = draw_training_randoms(batch["latents"].shape,
                                  ref_pipe.training_config,
                                  ref_pipe.common_config, g,
                                  scheduler=ref_pipe.train_scheduler)
    ref = _one_step(ref_pipe, batch, draws)
    flash_attention.reset_launches()
    flash_tail.reset_launches()
    out = _one_step(pipe, _to(batch, dev), _to(draws, dev))
    k7_bwd = dict(flash_attention.backward_launches_by_shape)
    k2 = dict(flash_tail.backward_launches_by_seq)
    log(f"tiny UNet train step: K7 backward launches {k7_bwd}, K2 {k2}")
    check_step_errors(step_errors(out, ref), "tiny UNet train step (remat, "
                      "AdamW, DDPM v-prediction)")
    if k7_bwd != {(12, 384, 384, 2, 4): 3} or k2 != {144: 3}:
        fail(f"tiny UNet train step launched the K7 backward {k7_bwd} and "
             f"K2 {k2}, not 3 and 3")


def random_init_(module, gen) -> None:
    """Weights ~ N(0, 1/fan_in), norm scales 1, biases 0, AlphaBlender
    mix factors 2 (the config's merge factor), drawn on the module's device."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("mix_factor"):
                p.fill_(2.0)
            elif p.ndim >= 2:
                p.normal_(0.0, p[0].numel() ** -0.5, generator=gen)
            elif name.endswith("weight"):
                p.fill_(1.0)
            else:
                p.zero_()


def make_batch(dev, gen, text_tokens: int = TEXT_TOKENS,
               text_dim: int = 4096, pooled_dim: int | None = 2048) -> dict:
    """One canonical latent-space batch: 6 frames x 6 views, pre-encoded
    text (the DiT's 154 tokens, 4096 wide, pooled 2048 by default) and ring
    cameras."""
    b, t, v = 1, FRAMES, VIEWS
    w_img, h_img = 8 * LAT_W, 8 * LAT_H
    intr = torch.zeros(b, t, v, 3, 3, device=dev)
    intr[..., 0, 0] = intr[..., 1, 1] = 0.79 * w_img
    intr[..., 0, 2], intr[..., 1, 2], intr[..., 2, 2] = w_img / 2, h_img / 2, 1
    yaw = torch.arange(v, device=dev) * (2 * torch.pi / v)
    cam = torch.eye(4, device=dev).repeat(b, t, v, 1, 1)
    cam[..., 0, 0], cam[..., 0, 1] = yaw.cos(), -yaw.sin()
    cam[..., 1, 0], cam[..., 1, 1] = yaw.sin(), yaw.cos()
    cam[..., 0, 3], cam[..., 1, 3] = 1.5 * yaw.cos(), 1.5 * yaw.sin()
    cam[..., 2, 3] = 1.6
    batch = {
        "encoder_hidden_states": torch.randn(
            b, t, v, text_tokens, text_dim, generator=gen, device=dev),
    }
    if pooled_dim is not None:
        batch["pooled_projections"] = torch.randn(
            b, t, v, pooled_dim, generator=gen, device=dev)
    return {
        **batch,
        "camera_intrinsics": intr,
        "camera_transforms": cam,
        "image_size": torch.tensor([float(w_img), float(h_img)],
                                   device=dev).expand(b, t, v, 2),
        "fps": torch.full((b,), 10.0, device=dev),
    }


def run_slice(dev, create_instance_from_config, sd35_vae, ops, get_conditions):
    cfg = json.loads(CONFIG.read_text())["pipeline"]
    log(f"cut: inference_steps {cfg['inference_config']['inference_steps']} "
        f"-> {STEPS}")
    cfg["inference_config"]["inference_steps"] = STEPS
    with torch.device("meta"):
        pipe = create_instance_from_config(cfg)
        vae = sd35_vae(dtype=torch.bfloat16)
    gen = torch.Generator(dev).manual_seed(SEED)
    for module in (pipe.model, vae):
        module.to_empty(device=dev)
        random_init_(module, gen)
        module.eval()
    pipe.set_vae(vae)
    model = pipe.model
    n_params = sum(p.numel() for p in model.parameters())
    log(f"denoiser: {CONFIG.relative_to(REPO)}, {len(model.transformer_blocks)}"
        f" joint blocks, width {model.inner_dim}, {n_params / 1e9:.3f}B "
        f"params, {model.dtype}; guidance "
        f"{cfg['inference_config']['guidance_scale']}")

    batch = make_batch(dev, gen)
    latent_shape = (1, FRAMES, VIEWS, LAT_H, LAT_W, 16)
    total_frames = FRAMES + (WINDOWS - 1) * (FRAMES - 1)

    # One denoiser forward at the CFG batch, timed alone (warms up too).
    conds = get_conditions(batch, pipe.common_config,
                           do_classifier_free_guidance=True)
    sample = torch.randn((2,) + latent_shape[1:], generator=gen, device=dev)
    timestep = torch.full((2, FRAMES, VIEWS), 500.0, device=dev)
    fwd_s = []
    with torch.inference_mode():
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = model(sample=sample, timestep=timestep, **conds)
            torch.cuda.synchronize()
            fwd_s.append(time.perf_counter() - t0)
    if out.shape != sample.shape or not torch.isfinite(out).all():
        fail("denoiser forward output is not finite or has the wrong shape")
    del out, sample, conds
    forward_s = min(fwd_s[1:])

    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    latents = pipe.autoregressive_inference_pipeline(
        batch, latent_shape, total_frames=total_frames,
        reference_frame_count=1, generator=gen)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    frames = pipe.decode_latents(latents, chunk_size=DECODE_CHUNK)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    want_latents = (1, total_frames, VIEWS, LAT_H, LAT_W, 16)
    want_frames = (1, total_frames, VIEWS, 8 * LAT_H, 8 * LAT_W, 3)
    if tuple(latents.shape) != want_latents or \
            not torch.isfinite(latents).all():
        fail(f"rollout latents {tuple(latents.shape)} not finite/expected")
    if tuple(frames.shape) != want_frames or not torch.isfinite(frames).all():
        fail(f"decoded frames {tuple(frames.shape)} not finite/expected")
    forwards = WINDOWS * STEPS
    rollout_s, decode_s = t1 - t0, t2 - t1
    log(f"rollout: {WINDOWS} windows x {STEPS} steps = {forwards} CFG "
        f"forwards, {total_frames} frames x {VIEWS} views, latents "
        f"{want_latents}, {rollout_s:.3f} s ({rollout_s / forwards:.3f} s "
        f"per step)")
    log(f"decode: frames {want_frames} {frames.dtype}, {decode_s:.3f} s; "
        f"frame range [{frames.min().item():.3f}, {frames.max().item():.3f}]")
    log(f"denoiser forward (CFG batch 2 x {FRAMES * VIEWS} view-frames): "
        f"{forward_s:.4f} s; per generated frame ({VIEWS} views, rollout + "
        f"decode): "
        f"{(rollout_s + decode_s) / total_frames:.4f} s; peak memory "
        f"{peak_gb:.2f} GiB")
    log(f"launches during the rollout: {json.dumps(counts)}")
    for s in (602, 448, 168):
        if counts["flash_tail_by_seq"].get(s, 0) == 0:
            fail(f"flash_tail never launched at s={s} on the main path")
    if counts["adaln_modulate"] == 0 or counts["residual_adaln_modulate"] == 0:
        fail("a fused AdaLN kernel never launched on the main path")
    return counts


def run_unet_slice(dev, create_instance_from_config, sd21_vae, ops,
                   get_conditions, profile: bool = False):
    """The CTSD-2.1 UNet serving path at full width: a 2-window rollout
    with DDIM and CFG, then the SD2.1 VAE decode."""
    cfg = json.loads(UNET_CONFIG.read_text())["pipeline"]
    ic = cfg["inference_config"]
    log(f"unet cut: inference_steps {ic['inference_steps']} -> {STEPS}")
    ic["inference_steps"] = STEPS
    with torch.device("meta"):
        pipe = create_instance_from_config(cfg)
        vae = sd21_vae(dtype=torch.bfloat16)
    gen = torch.Generator(dev).manual_seed(SEED)
    for module in (pipe.model, vae):
        module.to_empty(device=dev)
        random_init_(module, gen)
        module.eval()
    pipe.set_vae(vae)
    model = pipe.model
    mc = cfg["model"]
    n_params = sum(p.numel() for p in model.parameters())
    log(f"unet denoiser: {UNET_CONFIG.relative_to(REPO)}, channels "
        f"{mc['block_out_channels']}, heads {mc['num_attention_heads']} x 64, "
        f"rowwise cross-view {mc['enable_rowwise_crossview']}, rowwise "
        f"temporal {mc['enable_rowwise_temporal']}, {n_params / 1e9:.3f}B "
        f"params, {model.dtype}; {type(pipe.test_scheduler).__name__} "
        f"{pipe.test_scheduler.prediction_type}, guidance "
        f"{ic['guidance_scale']}")

    batch = make_batch(dev, gen, UNET_TEXT_TOKENS, UNET_TEXT_DIM, None)
    latent_shape = (1, FRAMES, VIEWS, LAT_H, LAT_W, UNET_LAT_C)
    total_frames = FRAMES + (WINDOWS - 1) * (FRAMES - 1)

    conds = get_conditions(batch, pipe.common_config,
                           do_classifier_free_guidance=True)
    sample = torch.randn((2,) + latent_shape[1:], generator=gen, device=dev)
    timestep = torch.full((2, FRAMES, VIEWS), 500, device=dev)
    fwd_s = []
    with torch.inference_mode():
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = model(sample=sample, timestep=timestep, **conds)
            torch.cuda.synchronize()
            fwd_s.append(time.perf_counter() - t0)
        if profile:
            from torch.profiler import ProfilerActivity
            from torch.profiler import profile as profiler

            with profiler(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA]) as prof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model(sample=sample, timestep=timestep, **conds)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
            log(_kernel_time_table(prof, dt, "UNet CFG forward"))
    if out.shape != sample.shape or not torch.isfinite(out).all():
        fail("UNet forward output is not finite or has the wrong shape")
    del out, sample, conds
    forward_s = min(fwd_s[1:])

    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    latents = pipe.autoregressive_inference_pipeline(
        batch, latent_shape, total_frames=total_frames,
        reference_frame_count=1, generator=gen)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    frames = pipe.decode_latents(latents, chunk_size=DECODE_CHUNK)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = ops.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    want_latents = (1, total_frames, VIEWS, LAT_H, LAT_W, UNET_LAT_C)
    want_frames = (1, total_frames, VIEWS, 8 * LAT_H, 8 * LAT_W, 3)
    if tuple(latents.shape) != want_latents or \
            not torch.isfinite(latents).all():
        fail(f"unet rollout latents {tuple(latents.shape)} not "
             "finite/expected")
    if tuple(frames.shape) != want_frames or not torch.isfinite(frames).all():
        fail(f"unet decoded frames {tuple(frames.shape)} not finite/expected")
    forwards = WINDOWS * STEPS
    rollout_s, decode_s = t1 - t0, t2 - t1
    frame_s = (rollout_s + decode_s) / total_frames
    log(f"unet rollout: {WINDOWS} windows x {STEPS} steps = {forwards} CFG "
        f"forwards, {total_frames} frames x {VIEWS} views, latents "
        f"{want_latents}, {rollout_s:.3f} s ({rollout_s / forwards:.3f} s "
        f"per step); latent range [{latents.min().item():.3f}, "
        f"{latents.max().item():.3f}]")
    log(f"unet decode: frames {want_frames} {frames.dtype}, {decode_s:.3f} "
        f"s; frame range [{frames.min().item():.3f}, "
        f"{frames.max().item():.3f}]")
    log(f"unet forward (CFG batch 2 x {FRAMES * VIEWS} view-frames): "
        f"{forward_s:.4f} s; per generated frame ({VIEWS} views, rollout + "
        f"decode): {frame_s:.4f} s; peak memory {peak_gib:.2f} GiB")
    log(f"launches during the unet rollout: {json.dumps(counts)}")
    k7_key = f"{2 * FRAMES * VIEWS},{LAT_H * LAT_W},{LAT_H * LAT_W},5,64"
    k7 = counts["flash_attention_by_shape"].get(k7_key, 0)
    log(f"K7 at ({k7_key}): {k7} launches, {k7 / forwards:g} per CFG "
        f"forward")
    want = UNET_K7_PER_FORWARD * forwards
    if k7 != want or counts["flash_attention"] != want:
        fail(f"flash_attention launched {counts['flash_attention_by_shape']}"
             f" on the unet path, not {want} times at ({k7_key})")
    for s in (336, 448, 168):
        if counts["flash_tail_by_seq"].get(s, 0) == 0:
            fail(f"flash_tail never launched at s={s} on the unet path")
    return counts, {"forward_s": forward_s, "frame_s": frame_s,
                    "peak_gib": peak_gib}


def _kernel_time_table(prof, step_s: float, what: str = "train step",
                       steps: int = 1) -> str:
    """Device time of ``steps`` profiled steps (``step_s``: their wall
    time in all) by kernel family, and the top kernels, from the kernel
    entries of ``key_averages`` (operator entries also carry their
    kernels' time and are skipped). The busy share is the device time over
    the same steps' wall time, both under the profiler."""
    from torch.autograd import DeviceType

    families = (  # matched in order, case-insensitively
        ("K1/K7 fwd sm90 (CUDA)", ("flash_fwd_sm90",)),
        ("K1/K2 flash_tail (CUDA)", ("flash_tail",)),
        ("K7 flash_attention (CUDA)", ("flash_attention",)),
        ("K3/K4 fused AdaLN (Triton)", ("_adaln_kernel",)),
        ("convolution (cuDNN)", ("conv", "fprop", "dgrad", "implicit")),
        ("group norm", ("group_norm", "groupnorm")),
        ("GEMM (cuBLAS)", ("gemm", "nvjet", "cutlass", "sm90_xmma")),
        ("AdamW (fused)", ("adam", "fusedoptimizer")),
        ("reduce (norms, sums)", ("reduce",)),
        ("copy / cat / cast", ("copy", "cat", "memcpy", "memset")),
        ("elementwise", ("elementwise", "vectorized", "unrolled")),
    )
    sums: dict = {}
    kernels = []
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != DeviceType.CUDA or \
                getattr(evt, "is_user_annotation", False):
            continue  # operators, and annotation ranges on the GPU timeline
        t = evt.self_device_time_total
        kernels.append((t, evt.count, evt.key))
        name = evt.key.lower()
        fam = next((f for f, keys in families
                    if any(k in name for k in keys)), "other")
        sums[fam] = sums.get(fam, 0.0) + t
    total = sum(sums.values())
    lines = [f"{steps} x {what}: wall {step_s * 1e3 / steps:.1f} ms, device "
             f"kernel time {total / 1e3 / steps:.1f} ms a step "
             f"({100 * total / 1e6 / step_s:.1f}% busy under the profiler)"]
    for fam, t in sorted(sums.items(), key=lambda kv: -kv[1]):
        lines.append(f"  {fam:28s} {t / 1e3:9.1f} ms  {100 * t / total:5.1f}%")
    lines.append("top kernels (self device ms, calls, name):")
    for t, n, key in sorted(kernels, reverse=True)[:25]:
        lines.append(f"  {t / 1e3:9.2f} {n:6d}  {key[:110]}")
    return "\n".join(lines)


def run_train_slice(dev, create_instance_from_config, ops,
                    profile: bool = False):
    """``train_step`` at full width and depth on a synthetic batch."""
    cfg = json.loads(CONFIG.read_text())["pipeline"]
    cfg["model"]["param_dtype"] = torch.float32
    mc, oc, tc = cfg["model"], cfg["optimizer_config"], cfg["training_config"]
    log(f"train: AdamW lr {oc['lr']}, weight decay {oc['weight_decay']}, "
        f"clip {tc['max_norm_for_grad_clip']}, fp32 moments; remat: joint "
        f"blocks {mc.get('gradient_checkpointing', False)} (layers "
        f"{mc.get('remat_block_layers', 'all')}), cross-view "
        f"{mc.get('crossview_gradient_checkpointing', False)}, temporal "
        f"{mc.get('temporal_gradient_checkpointing', False)}")
    with torch.device("meta"):
        pipe = create_instance_from_config(cfg)
    model = pipe.model
    gen = torch.Generator(dev).manual_seed(SEED)
    model.to_empty(device=dev)
    random_init_(model, gen)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"train: {len(model.transformer_blocks)} joint blocks, width "
        f"{model.inner_dim}, {n_params / 1e9:.3f}B params in fp32, compute "
        f"{model.dtype}; reckoned state {n_params * 16 / 1e9:.1f} GB = "
        f"{n_params * 16 / 2**30:.1f} GiB (4 B param + 4 B grad + 8 B "
        f"AdamW moments)")
    batch = make_batch(dev, gen)
    batch["latents"] = torch.randn(1, FRAMES, VIEWS, LAT_H, LAT_W, 16,
                                   generator=gen, device=dev)
    counts, metrics = drive_train(dev, pipe, batch, ops, "train", profile)
    for s in (602, 448, 168):
        if counts["flash_tail_by_seq"].get(s, 0) == 0:
            fail(f"flash_tail never launched at s={s} in the train steps")
        if counts["flash_tail_backward_by_seq"].get(s, 0) == 0:
            fail(f"the K2 backward never launched at s={s} in the train "
                 "steps")
    if counts["adaln_modulate"] == 0 or counts["residual_adaln_modulate"] == 0:
        fail("a fused AdaLN kernel never launched in the train steps")
    return counts, metrics


def drive_train(dev, pipe, batch, ops, tag: str, profile: bool = False):
    """``TRAIN_STEPS`` train steps of ``pipe`` on ``batch`` with an explicit
    generator, steps 2 onward timed; between step 1 and the timed steps, the
    launches by phase on one untimed forward + backward (no update). Fails
    on a non-finite loss or gradient norm, or if fewer than 99% of the
    parameters changed. Returns the launches of the timed steps and
    {s_per_step, peak_gib}."""
    state = pipe.init_state()
    generator = torch.Generator(dev).manual_seed(SEED + 1)
    names, params = zip(*pipe.model.named_parameters())
    heads_before = [p.detach().reshape(-1)[:256].clone() for p in params]

    def step():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics = pipe.train_step(state, batch, generator)
        out = (metrics["sd_loss"].item(), metrics["grad_norm"].item())
        torch.cuda.synchronize()
        return (time.perf_counter() - t0,) + out

    records = [step()]  # step 1 also allocates the AdamW moments
    ops.reset_launch_counts()
    loss, _ = pipe.loss_fn(batch, torch.Generator(dev).manual_seed(SEED + 2))
    torch.cuda.synchronize()
    forward_counts = ops.launch_counts()
    ops.reset_launch_counts()
    loss.backward()
    torch.cuda.synchronize()
    backward_counts = ops.launch_counts()
    del loss
    for p in params:
        p.grad = None
    log(f"{tag} launches, forward: {json.dumps(forward_counts)}")
    log(f"{tag} launches, backward (with the remat recompute): "
        f"{json.dumps(backward_counts)}")

    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    records += [step() for _ in range(TRAIN_STEPS - 1)]
    counts = ops.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    moved = [not torch.equal(p.detach().reshape(-1)[:256], h)
             for p, h in zip(params, heads_before)]
    changed = sum(moved)
    unchanged = [n for n, m in zip(names, moved) if not m]
    s_per_step = sum(r[0] for r in records[1:]) / (len(records) - 1)
    for i, (dt, loss_v, gn) in enumerate(records, 1):
        log(f"{tag} step {i}: {dt:.3f} s, sd_loss {loss_v:.6f}, grad_norm "
            f"{gn:.4f}{' (warm-up)' if i == 1 else ''}")
    log(f"{tag}: {s_per_step:.3f} s per step (steps 2-{TRAIN_STEPS}), "
        f"{FRAMES / s_per_step:.2f} 6-view frames/s; peak memory "
        f"{peak_gib:.2f} GiB; parameters changed: {changed} of "
        f"{len(params)} tensors (unchanged: {unchanged[:5]})")
    log(f"launches during the timed {tag} steps: {json.dumps(counts)}")
    if not all(torch.isfinite(torch.tensor(r[1:])).all() for r in records):
        fail(f"a {tag} loss or gradient norm is not finite")
    # A parameter without a gradient and at zero (a bias whose output is
    # dropped) cannot move; all else must.
    if changed < 0.99 * len(params):
        fail(f"only {changed} of {len(params)} parameters changed")

    if profile:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as profiler

        # more unprofiled steps beside the profiled ones, for the spread
        walls = [step()[0] for _ in range(PROFILE_STEPS)]
        log(f"{tag} unprofiled steps: "
            f"{', '.join(f'{w:.3f}' for w in walls)} s, mean "
            f"{sum(walls) / len(walls):.3f} s")
        with profiler(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            walls = [step()[0] for _ in range(PROFILE_STEPS)]
        log(f"{tag} profiled steps: "
            f"{', '.join(f'{w:.3f}' for w in walls)} s")
        log(_kernel_time_table(prof, sum(walls), f"{tag} step", len(walls)))
    return counts, {"s_per_step": s_per_step, "peak_gib": peak_gib}


def run_unet_train_slice(dev, create_instance_from_config, ops,
                         profile: bool = False):
    """The CTSD-2.1 UNet's ``train_step`` at full width and depth on a
    synthetic batch: DDPM v-prediction, fp32 masters, remat as the config
    sets it."""
    cfg = json.loads(UNET_CONFIG.read_text())["pipeline"]
    cfg["model"]["param_dtype"] = torch.float32
    mc, oc, tc = cfg["model"], cfg["optimizer_config"], cfg["training_config"]
    with torch.device("meta"):
        pipe = create_instance_from_config(cfg)
    model = pipe.model
    gen = torch.Generator(dev).manual_seed(SEED)
    model.to_empty(device=dev)
    random_init_(model, gen)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"unet train: {UNET_CONFIG.relative_to(REPO)}, channels "
        f"{mc['block_out_channels']}, {n_params / 1e9:.3f}B params in fp32, "
        f"compute {model.dtype}; {type(pipe.train_scheduler).__name__} "
        f"{pipe.train_scheduler.prediction_type}; AdamW lr {oc['lr']}, "
        f"weight decay {oc['weight_decay']}, clip "
        f"{tc['max_norm_for_grad_clip']}, fp32 moments; remat "
        f"{mc.get('gradient_checkpointing', False)}; reckoned state "
        f"{n_params * 16 / 2**30:.1f} GiB (4 B param + 4 B grad + 8 B AdamW "
        f"moments)")
    batch = make_batch(dev, gen, UNET_TEXT_TOKENS, UNET_TEXT_DIM, None)
    batch["latents"] = torch.randn(1, FRAMES, VIEWS, LAT_H, LAT_W,
                                   UNET_LAT_C, generator=gen, device=dev)
    counts, metrics = drive_train(dev, pipe, batch, ops, "unet train",
                                  profile)
    k7_key = f"{FRAMES * VIEWS},{LAT_H * LAT_W},{LAT_H * LAT_W},5,64"
    steps = TRAIN_STEPS - 1
    # forward and remat recompute; backward
    for what, want in (("flash_attention", 2 * UNET_K7_PER_FORWARD * steps),
                       ("flash_attention_backward",
                        UNET_K7_PER_FORWARD * steps)):
        n = counts[f"{what}_by_shape"].get(k7_key, 0)
        log(f"{what} at ({k7_key}): {n} launches in {steps} steps")
        if n != want or counts[what] != want:
            fail(f"{what} launched {counts[f'{what}_by_shape']} in the unet "
                 f"train steps, not {want} times at ({k7_key})")
    for s in (336, 448, 168):
        if counts["flash_tail_by_seq"].get(s, 0) == 0:
            fail(f"flash_tail never launched at s={s} in the unet train steps")
        if counts["flash_tail_backward_by_seq"].get(s, 0) == 0:
            fail(f"the K2 backward never launched at s={s} in the unet train "
                 "steps")
    return counts, metrics


def census_sm90(_build, sources) -> dict:
    """ptxas's registers and spills (from the report kept beside each
    library, so a library built by an earlier run is held too) and a SASS
    census (``cuobjdump -sass``) of the Hopper forward's instances in each
    built library. Fails on an instance that ptxas did not report, on a
    spill, or on an instance without ``HGMMA`` or without an asynchronous
    load (``UTMALDG`` or ``LDGSTS``)."""
    census = {}
    for source in sources:
        lib = _build.library_path(source)
        ptxas = _build.ptxas_report(lib, "flash_fwd_sm90")
        sass = _build.sass_census(lib, "flash_fwd_sm90")
        if not sass:
            fail(f"no flash_fwd_sm90 instance in the SASS of {source}")
        for name, ops in sass.items():
            flags = name.split("flash_fwd_sm90_kernel")[-1].split("EEEv")[0]
            entry = {**ptxas.get(name, {}), **ops}
            census[f"{source}:{flags}"] = entry
            log(f"  sm90 {source} {flags}: {json.dumps(entry)}")
            if "spill_bytes" not in entry or "registers" not in entry:
                fail(f"ptxas reported no registers or spills for the Hopper "
                     f"forward {source} {flags}")
            if entry["spill_bytes"] or not ops["HGMMA"] or \
                    not (ops["UTMALDG"] or ops["LDGSTS"]):
                fail(f"the Hopper forward {source} {flags} spills or lacks "
                     f"wgmma / asynchronous loads: {entry}")
    return census


def check_new_body_on_paths(paths: dict) -> None:
    """Every forward launch of K1, K7 and K7-seg on the model paths ran the
    Hopper forward (bf16, head dim 64, aligned), none an old body."""
    for path in ("serve", "train", "unet_serve", "unet_train"):
        c = paths[path]
        k1_old = c["flash_tail"] - c["flash_tail_sm90"]
        k7_old = c["flash_attention"] + c["flash_attention_segment"] - \
            c["flash_attention_sm90"]
        log(f"{path}: K1 {c['flash_tail']} launches, {c['flash_tail_sm90']} "
            f"on the Hopper forward; K7 {c['flash_attention']} (+ K7-seg "
            f"{c['flash_attention_segment']}), {c['flash_attention_sm90']} "
            f"on it")
        if k1_old or k7_old:
            fail(f"{path}: {k1_old} K1 and {k7_old} K7 forward launches ran "
                 "an old body")


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device")
    from opendwm_tpu_torch import ops
    from opendwm_tpu_torch.config import create_instance_from_config
    from opendwm_tpu_torch.models.autoencoders import sd21_vae, sd35_vae
    from opendwm_tpu_torch.models.mmdit import DiTCrossviewTemporal
    from opendwm_tpu_torch.models.unet import UNetCrossviewTemporal
    from opendwm_tpu_torch.ops import (
        _build,
        flash_attention,
        flash_tail,
        fused_adaln,
    )
    from opendwm_tpu_torch.perf import exp_attn602, exp_tailvar
    from opendwm_tpu_torch.pipelines.ctsd import (
        draw_training_randoms,
        get_conditions,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}")

    t0 = time.perf_counter()
    sources = ("flash_tail.cu", "flash_attention.cu")
    _build.build_all(sources)
    flash_tail.build()
    flash_attention.build()
    fused_adaln.build()
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc sm_90a, one process "
        f"per source, + triton import), sources under "
        f"{Path(_build.CSRC).relative_to(REPO)}")
    for source in sources:
        for line in _build.ptxas_log(_build.library_path(source)).splitlines():
            low = line.lower()
            if any(w in low for w in ("registers", "spill", "wgmma",
                                      "setmaxnreg")):
                log(f"  ptxas {source}: {line.strip()}")
    sm90_census = census_sm90(_build, sources)

    log_clocks("before the kernel checks")
    attn_rows = check_attention(dev, flash_tail)
    bwd_rows, lse_timing = check_attention_backward(dev, flash_tail)
    unet_k1_rows, k7_rows = check_unet_attention(dev, flash_tail,
                                                 flash_attention)
    k7_bwd_rows, k7_lse_timing = check_flash_attention_backward(
        dev, flash_attention)
    k7_seg_rows = check_flash_attention_segment(dev, flash_attention)
    k7_at_k1, k7_bwd_at_k2 = check_k7_at_tail_shapes(dev, flash_tail,
                                                     flash_attention)
    tailvar, tiling_rows = run_tailvar(dev, ops, exp_tailvar)
    attn602 = run_attn602(dev, ops, exp_attn602)
    log_clocks("after the attention checks")
    adaln_rows = check_adaln(dev, fused_adaln)
    check_tiny_model(dev, DiTCrossviewTemporal)
    check_tiny_train_step(dev, create_instance_from_config,
                          draw_training_randoms)
    check_tiny_unet(dev, UNetCrossviewTemporal, flash_attention, flash_tail)
    check_tiny_unet_train_step(dev, create_instance_from_config,
                               draw_training_randoms, flash_attention,
                               flash_tail)
    gc.collect()
    torch.cuda.empty_cache()
    log_clocks("before the serving slice")
    serve = run_slice(dev, create_instance_from_config, sd35_vae, ops,
                      get_conditions)
    gc.collect()
    torch.cuda.empty_cache()
    log_clocks("before the UNet serving slice")
    unet, _ = run_unet_slice(dev, create_instance_from_config, sd21_vae, ops,
                             get_conditions,
                             profile="--profile-unet" in sys.argv[1:])
    gc.collect()
    torch.cuda.empty_cache()
    log_clocks("before the train slice")
    train, _ = run_train_slice(dev, create_instance_from_config, ops,
                               profile="--profile-train" in sys.argv[1:])
    gc.collect()
    torch.cuda.empty_cache()
    log_clocks("before the UNet train slice")
    unet_train, _ = run_unet_train_slice(
        dev, create_instance_from_config, ops,
        profile="--profile-unet-train" in sys.argv[1:])
    log_clocks("at the end")
    paths = {"serve": serve, "train": train, "unet_serve": unet,
             "unet_train": unet_train, "tailvar": tailvar,
             "attn602": attn602}
    strays = {p: c["flash_attention_segment"] for p, c in paths.items()
              if p != "attn602" and c["flash_attention_segment"]}
    if strays:
        fail(f"flash_attention_segment launched outside the shoot-out: "
             f"{strays}")
    check_new_body_on_paths(paths)

    def entry(name, route, source, replaces, key, rows, **extra):
        by_path = {path: counts.get(key, 0) for path, counts in paths.items()}
        if key in ("flash_tail", "flash_attention"):
            extra["launches_sm90_by_path"] = {
                path: counts.get(f"{key}_sm90", 0)
                for path, counts in paths.items()}
        first = rows[0]  # the path's main shape
        return {
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            **{k: first[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")},
            **extra, "shapes": rows,
        }

    csrc = "opendwm_tpu_torch/csrc/flash_tail.cu"
    triton_src = "opendwm_tpu_torch/ops/fused_adaln.py"
    k7_src = "opendwm_tpu_torch/csrc/flash_attention.cu"
    sm90_src = "opendwm_tpu_torch/csrc/flash_fwd_sm90.cuh"
    kernels = [
        entry("flash_tail_forward", "cuda", csrc,
              "opendwm_tpu/ops/flash_tail.py:55", "flash_tail",
              attn_rows + unet_k1_rows,
              lse_ms=lse_timing["lse_ms"],
              serving_ms_beside_lse=lse_timing["serving_ms"],
              body=sm90_src, sass=sm90_census),
        entry("flash_tail_backward", "cuda", csrc,
              "opendwm_tpu/ops/flash_tail.py:125", "flash_tail_backward",
              bwd_rows),
        entry("adaln_modulate", "triton", triton_src,
              "opendwm_tpu/ops/fused_adaln.py:45", "adaln_modulate",
              adaln_rows["adaln_modulate"]),
        entry("residual_adaln_modulate", "triton", triton_src,
              "opendwm_tpu/ops/fused_adaln.py:133", "residual_adaln_modulate",
              adaln_rows["residual_adaln_modulate"]),
        entry("flash_attention_forward", "cuda", k7_src,
              "opendwm_tpu/ops/attention.py:151", "flash_attention", k7_rows,
              lse_ms=k7_lse_timing["lse_ms"],
              serving_ms_beside_lse=k7_lse_timing["serving_ms"],
              at_k1_shapes=k7_at_k1, body=sm90_src),
        entry("flash_attention_backward", "cuda", k7_src,
              f"{STOCK_FLASH}:941", "flash_attention_backward", k7_bwd_rows,
              replaces_also=f"{STOCK_FLASH}:1287",
              at_k2_shapes=k7_bwd_at_k2),
        entry("tail_hpack", "cuda", csrc, "perf/exp_tailvar.py:75",
              "tail_hpack", tiling_rows["tail_hpack"]),
        entry("tail_qsplit", "cuda", csrc, "perf/exp_tailvar.py:119",
              "tail_qsplit", tiling_rows["tail_qsplit"]),
        entry("flash_attention_segment", "cuda", k7_src,
              "perf/exp_attn602.py:88", "flash_attention_segment",
              k7_seg_rows, replaces_also=f"{STOCK_FLASH}:140",
              body=sm90_src),
    ]
    log(f"card: {card}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
