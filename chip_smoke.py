#!/usr/bin/env python3
"""Drive the PyTorch port's CTSD-3.5 serving path once on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases; any failure raises and exits non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: the CUDA kernel from ``opendwm_tpu_torch/csrc`` (nvcc) and the
   Triton kernels;
3. kernels: each Hopper kernel against its plain PyTorch version on the
   same inputs, at the shapes the serving path gives it, in bf16 (the
   attention kernel also in fp32), with both times;
4. tiny model: the kernel path end to end (fp32, small widths) against
   the plain path on the CPU;
5. slice: ``configs/ctsd/multi_datasets/ctsd_35_tirda_nwao.json`` at full
   width (24 layers, 24x64 heads, bf16) with random weights drawn on the
   card from a seed; a 2-window autoregressive rollout of 1 x 6 frames x 6
   views of 32x56 latents with CFG 4.0 (the one cut: inference_steps
   40 -> 4), then the SD3.5 VAE decode to 256x448 frames. Every kernel of
   the path must have launched during the rollout.

The line before the last is the kernels JSON; the last is the device JSON.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent
CONFIG = REPO / "configs/ctsd/multi_datasets/ctsd_35_tirda_nwao.json"
SEED = 0
STEPS = 4  # cut from the config's 40
WINDOWS = 2
FRAMES, VIEWS, LAT_H, LAT_W, TEXT_TOKENS = 6, 6, 32, 56, 154
DECODE_CHUNK = 12  # frames per VAE decode call
ATTN_SHAPES = ((72, 602), (72, 448), (192, 168))  # (batch, seq); 24x64 heads
ADALN_SHAPES = ((72, 448, 1536), (72, 154, 1536))
# Tolerances on |kernel - plain| / max(1, |plain|), elementwise: absolute
# for outputs below 1, relative above, because one bf16 ulp is 2^-7 of the
# value (0.0625 at 16) and the two versions may round an fp32 result that
# differs in its last bits to neighbouring bf16 values.
ATTN_TOL, ADALN_TOL, FP32_TOL, TINY_TOL = 2e-2, 3e-2, 1e-4, 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def scaled_err(a, b) -> float:
    """max of |a - b| / max(1, |b|): the measure the tolerances bound."""
    b = b.float()
    return ((a.float() - b).abs() / b.abs().clamp(min=1.0)).max().item()


def time_pair(kernel, plain, iters: int = 10):
    """ms per call of each, timed in turns plain, kernel, kernel, plain."""

    def ms(fn):
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

    p1, k1, k2, p2 = ms(plain), ms(kernel), ms(kernel), ms(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def check_attention(dev, flash_tail):
    g = torch.Generator(dev).manual_seed(SEED)
    rows = []
    for b, s in ATTN_SHAPES:
        q, k, v = (torch.randn(b, s, 24, 64, generator=g, device=dev,
                               dtype=torch.bfloat16) for _ in range(3))
        scale = 64 ** -0.5
        out = flash_tail.tail_masked_attention(q, k, v, scale)
        ref = flash_tail.tail_masked_attention_plain(q, k, v, scale)
        err, rel = max_err(out, ref), scaled_err(out, ref)
        ms, plain_ms = time_pair(
            lambda: flash_tail.tail_masked_attention(q, k, v, scale),
            lambda: flash_tail.tail_masked_attention_plain(q, k, v, scale))
        log(f"K1 flash_tail bf16 ({b},{s},24,64): max_abs_err {err:.3e}, "
            f"scaled {rel:.3e} (tol {ATTN_TOL}), kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms")
        if not rel <= ATTN_TOL:
            fail(f"flash_tail disagrees at s={s}: {rel}")
        rows.append({"shape": [b, s, 24, 64], "dtype": "bf16",
                     "max_abs_err": err, "scaled_err": rel, "ms": ms,
                     "plain_ms": plain_ms})
    q, k, v = (torch.randn(192, 168, 24, 64, generator=g, device=dev)
               for _ in range(3))
    err = max_err(flash_tail.tail_masked_attention(q, k, v, 0.125),
                  flash_tail.tail_masked_attention_plain(q, k, v, 0.125))
    log(f"K1 flash_tail fp32 (192,168,24,64): max_abs_err {err:.3e} "
        f"(tol {FP32_TOL})")
    if not err <= FP32_TOL:
        fail(f"flash_tail disagrees in fp32: {err}")
    return rows


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
            rows[name].append({"shape": [n, l, d], "dtype": "bf16",
                               "max_abs_err": err, "scaled_err": rel,
                               "ms": ms, "plain_ms": plain_ms})
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


def make_batch(dev, gen) -> dict:
    """One canonical latent-space batch: 6 frames x 6 views, pre-encoded
    text (154 tokens, 4096 wide; pooled 2048) and ring cameras."""
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
    return {
        "encoder_hidden_states": torch.randn(
            b, t, v, TEXT_TOKENS, 4096, generator=gen, device=dev),
        "pooled_projections": torch.randn(b, t, v, 2048, generator=gen,
                                          device=dev),
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


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device")
    from opendwm_tpu_torch import ops
    from opendwm_tpu_torch.config import create_instance_from_config
    from opendwm_tpu_torch.models.autoencoders import sd35_vae
    from opendwm_tpu_torch.models.mmdit import DiTCrossviewTemporal
    from opendwm_tpu_torch.ops import _build, flash_tail, fused_adaln
    from opendwm_tpu_torch.pipelines.ctsd import get_conditions

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}")

    t0 = time.perf_counter()
    flash_tail.build()
    fused_adaln.build()
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc sm_90a + triton "
        f"import), sources under {Path(_build.CSRC).relative_to(REPO)}")
    for line in _build.build_logs.get("flash_tail.cu", "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    attn_rows = check_attention(dev, flash_tail)
    adaln_rows = check_adaln(dev, fused_adaln)
    check_tiny_model(dev, DiTCrossviewTemporal)
    counts = run_slice(dev, create_instance_from_config, sd35_vae, ops,
                       get_conditions)

    def entry(name, route, source, replaces, launches, rows):
        return {
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": rows[0]["ms"], "plain_ms": rows[0]["plain_ms"],
            "shapes": rows,
        }

    kernels = [
        entry("flash_tail_forward", "cuda",
              "opendwm_tpu_torch/csrc/flash_tail.cu",
              "opendwm_tpu/ops/flash_tail.py:55", counts["flash_tail"],
              attn_rows),
        entry("adaln_modulate", "triton",
              "opendwm_tpu_torch/ops/fused_adaln.py",
              "opendwm_tpu/ops/fused_adaln.py:45", counts["adaln_modulate"],
              adaln_rows["adaln_modulate"]),
        entry("residual_adaln_modulate", "triton",
              "opendwm_tpu_torch/ops/fused_adaln.py",
              "opendwm_tpu/ops/fused_adaln.py:133",
              counts["residual_adaln_modulate"],
              adaln_rows["residual_adaln_modulate"]),
    ]
    log(f"card: {card}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
