#!/usr/bin/env python3
"""Drive the PyTorch port's CTSD-3.5 serving and training paths and its
CTSD-2.1 UNet serving path on one GPU.

Run from the root of a checkout:
    python3 chip_smoke.py [--profile-train] [--profile-unet]

Phases; any failure raises and exits non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: the CUDA kernels from ``opendwm_tpu_torch/csrc`` (one nvcc per
   source, all at once) and the Triton kernels;
3. kernels: each Hopper kernel against its plain PyTorch version on the
   same inputs, at the shapes the serving and training paths give it, in
   bf16 (the attention kernels also in fp32), with both times: K1 (and
   its variant that writes the log-sum-exp for the backward) at the DiT's
   and the UNet's shapes, K2 (the attention backward), K3, K4, K7 (flash
   attention at the UNet's 1792 tokens, at 6400 and causal with q != kv);
4. tiny models: the kernel path end to end (fp32, small widths) against
   the plain path on the CPU: the DiT, one AdamW train step of the DiT
   with remat on, and the UNet;
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
   ``--profile-train`` adds one ``torch.profiler`` step and prints its
   device time by kernel family;
7. UNet serving slice: ``configs/ctsd/multi_datasets/ctsd_21_tirda_nwao.json``
   at full width (320/640/1280/1280 channels, 5/10/20/20 x 64 heads, rowwise
   cross-view and temporal branches, bf16) with random weights drawn on the
   card from a seed; a 2-window autoregressive rollout of 1 x 6 frames x 6
   views of 32x56x4 latents with 77 x 1024 text tokens, DDIM v-prediction
   with CFG 3.0 (the one cut: inference_steps 50 -> 4), then the SD2.1 VAE
   decode to 256x448 frames. K7 must have launched at (72, 1792, 5, 64) and
   K1 at s = 336, 448, 168 during the rollout. ``--profile-unet`` adds one
   ``torch.profiler`` CFG forward and prints its device time by kernel
   family.

Each slice is freed before the next. The line before the last is the
kernels JSON; the last is the device JSON.
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
ADALN_SHAPES = ((72, 448, 1536), (72, 154, 1536))
# The UNet at the CFG batch: K1 at the level-0 branches (384 x 336), level-1
# self-attention (72 x 448) and branches (192 x 168); K7 at the level-0
# self-attention (72 x 1792) and at the 80x80 LiDAR BEV latents (6400).
UNET_TEXT_TOKENS, UNET_TEXT_DIM, UNET_LAT_C = 77, 1024, 4
UNET_K1_SHAPES = ((384, 336, 5), (72, 448, 10), (192, 168, 10))
K7_SHAPES = ((72, 1792, 1792, 5, False), (8, 6400, 6400, 5, False),
             (8, 1792, 3584, 5, True))  # (batch, q, kv, heads, causal)
# Tolerances on |kernel - plain| / max(1, |plain|), elementwise: absolute
# for outputs below 1, relative above, because one bf16 ulp is 2^-7 of the
# value (0.0625 at 16) and the two versions may round an fp32 result that
# differs in its last bits to neighbouring bf16 values.
ATTN_TOL, ADALN_TOL, FP32_TOL, TINY_TOL = 2e-2, 3e-2, 1e-4, 1e-3
# K2 in bf16: ||kernel - plain|| / ||plain|| per gradient, the bar recorded
# for the JAX kernel (docs/PARITY.md): dS is rounded to bf16 at other
# points, and delta comes from dO.O instead of dP.P.
K2_REL_TOL = 6e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def rel_err(a, b) -> float:
    b = b.float()
    return ((a.float() - b).norm() / b.norm()).item()


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
        log(f"K2 flash_tail backward {tag} ({b},{s},24,64): rel err dq/dk/dv "
            f"{rels[0]:.2e}/{rels[1]:.2e}/{rels[2]:.2e} (tol {K2_REL_TOL}), "
            f"max_abs_err {max(errs):.3e}, kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms")
        if not max(rels) <= K2_REL_TOL:
            fail(f"flash_tail backward disagrees at s={s}: {rels}")
        rows.append({"shape": [b, s, 24, 64], "dtype": tag,
                     "max_abs_err": max(errs), "rel_err": rels, "ms": ms,
                     "plain_ms": plain_ms})
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
        err, rel = max_err(out, ref), scaled_err(out, ref)
        del out, ref
        ms, plain_ms = time_pair(
            lambda: flash_tail.tail_masked_attention(q, k, v, scale),
            lambda: flash_tail.tail_masked_attention_plain(q, k, v, scale))
        log(f"K1 flash_tail bf16 ({b},{s},{h},64) [UNet]: max_abs_err "
            f"{err:.3e}, scaled {rel:.3e} (tol {ATTN_TOL}), kernel {ms:.3f} "
            f"ms, plain {plain_ms:.3f} ms")
        if not rel <= ATTN_TOL:
            fail(f"flash_tail disagrees at the UNet's {(b, s, h)}: {rel}")
        k1_rows.append({"shape": [b, s, h, 64], "dtype": "bf16",
                        "max_abs_err": err, "scaled_err": rel, "ms": ms,
                        "plain_ms": plain_ms})
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
        err, rel = max_err(out, ref), scaled_err(out, ref)
        del out, ref
        ms, plain_ms = time_pair(kernel, plain)
        tag = f"({b},{sq},{sk},{h},64){' causal' if causal else ''}"
        log(f"K7 flash_attention bf16 {tag}: max_abs_err {err:.3e}, scaled "
            f"{rel:.3e} (tol {ATTN_TOL}), kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms")
        if not rel <= ATTN_TOL:
            fail(f"flash_attention disagrees at {tag}: {rel}")
        k7_rows.append({"shape": [b, sq, sk, h, 64], "causal": causal,
                        "dtype": "bf16", "max_abs_err": err,
                        "scaled_err": rel, "ms": ms, "plain_ms": plain_ms})
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
    _, ref = ref_pipe.train_step(ref_pipe.init_state(), batch, draws=draws)
    _, out = pipe.train_step(pipe.init_state(), _to(batch, dev),
                             draws=_to(draws, dev))
    loss_err = abs(out["sd_loss"].item() - ref["sd_loss"].item())
    param_err = max(max_err(a.detach().cpu(), b.detach()) for a, b in
                    zip(pipe.model.parameters(), ref_pipe.model.parameters()))
    log(f"tiny train step (remat, AdamW), kernels on the card vs plain on "
        f"the CPU (fp32): loss {out['sd_loss'].item():.6f} vs "
        f"{ref['sd_loss'].item():.6f}, max_abs_err loss {loss_err:.3e}, "
        f"updated params {param_err:.3e} (tol {TINY_TOL})")
    if not (loss_err <= TINY_TOL and param_err <= TINY_TOL):
        fail(f"tiny train step disagrees: {loss_err}, {param_err}")


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
    if k7 == 0:
        fail(f"flash_attention never launched at ({k7_key}) on the unet path")
    for s in (336, 448, 168):
        if counts["flash_tail_by_seq"].get(s, 0) == 0:
            fail(f"flash_tail never launched at s={s} on the unet path")
    return counts, {"forward_s": forward_s, "frame_s": frame_s,
                    "peak_gib": peak_gib}


def _kernel_time_table(prof, step_s: float, what: str = "train step") -> str:
    """Device time of one profiled step by kernel family, and the top
    kernels, from the kernel entries of ``key_averages`` (operator entries
    also carry their kernels' time and are skipped)."""
    from torch.autograd import DeviceType

    families = (  # matched in order, case-insensitively
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
    lines = [f"one {what}: wall {step_s * 1e3:.1f} ms, device kernel "
             f"time {total / 1e3:.1f} ms ({100 * total / 1e6 / step_s:.1f}% "
             f"busy)"]
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
    state = pipe.init_state()
    batch = make_batch(dev, gen)
    batch["latents"] = torch.randn(1, FRAMES, VIEWS, LAT_H, LAT_W, 16,
                                   generator=gen, device=dev)
    generator = torch.Generator(dev).manual_seed(SEED + 1)
    names, params = zip(*model.named_parameters())
    heads_before = [p.detach().reshape(-1)[:256].clone() for p in params]

    def step():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics = pipe.train_step(state, batch, generator)
        out = (metrics["sd_loss"].item(), metrics["grad_norm"].item())
        torch.cuda.synchronize()
        return (time.perf_counter() - t0,) + out

    records = [step()]  # step 1 also allocates the AdamW moments
    # Launches by phase, on one untimed forward + backward (no update).
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
    log(f"train launches, forward: {json.dumps(forward_counts)}")
    log(f"train launches, backward (with the remat recompute): "
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
        log(f"train step {i}: {dt:.3f} s, sd_loss {loss_v:.6f}, grad_norm "
            f"{gn:.4f}{' (warm-up)' if i == 1 else ''}")
    log(f"train: {s_per_step:.3f} s per step (steps 2-{TRAIN_STEPS}), "
        f"{FRAMES / s_per_step:.2f} 6-view frames/s; peak memory "
        f"{peak_gib:.2f} GiB; parameters changed: {changed} of "
        f"{len(params)} tensors (unchanged: {unchanged[:5]})")
    log(f"launches during the timed train steps: {json.dumps(counts)}")
    if not all(torch.isfinite(torch.tensor(r[1:])).all() for r in records):
        fail("a train loss or gradient norm is not finite")
    # The last block's context queries get no gradient (its context output
    # is dropped), so their zero biases cannot move; all else must.
    if changed < 0.99 * len(params):
        fail(f"only {changed} of {len(params)} parameters changed")
    for s in (602, 448, 168):
        if counts["flash_tail_by_seq"].get(s, 0) == 0:
            fail(f"flash_tail never launched at s={s} in the train steps")
        if counts["flash_tail_backward_by_seq"].get(s, 0) == 0:
            fail(f"the K2 backward never launched at s={s} in the train "
                 "steps")
    if counts["adaln_modulate"] == 0 or counts["residual_adaln_modulate"] == 0:
        fail("a fused AdaLN kernel never launched in the train steps")

    if profile:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as profiler

        with profiler(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            dt = step()[0]
        log(_kernel_time_table(prof, dt))
    return counts, {"s_per_step": s_per_step, "peak_gib": peak_gib}


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
    _build.build_all(["flash_tail.cu", "flash_attention.cu"])
    flash_tail.build()
    flash_attention.build()
    fused_adaln.build()
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc sm_90a, one process "
        f"per source, + triton import), sources under "
        f"{Path(_build.CSRC).relative_to(REPO)}")
    for source, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {source}: {line.strip()}")

    attn_rows = check_attention(dev, flash_tail)
    bwd_rows, lse_timing = check_attention_backward(dev, flash_tail)
    unet_k1_rows, k7_rows = check_unet_attention(dev, flash_tail,
                                                 flash_attention)
    adaln_rows = check_adaln(dev, fused_adaln)
    check_tiny_model(dev, DiTCrossviewTemporal)
    check_tiny_train_step(dev, create_instance_from_config,
                          draw_training_randoms)
    check_tiny_unet(dev, UNetCrossviewTemporal, flash_attention, flash_tail)
    serve = run_slice(dev, create_instance_from_config, sd35_vae, ops,
                      get_conditions)
    gc.collect()
    torch.cuda.empty_cache()
    unet, _ = run_unet_slice(dev, create_instance_from_config, sd21_vae, ops,
                             get_conditions,
                             profile="--profile-unet" in sys.argv[1:])
    gc.collect()
    torch.cuda.empty_cache()
    train, _ = run_train_slice(dev, create_instance_from_config, ops,
                               profile="--profile-train" in sys.argv[1:])

    def entry(name, route, source, replaces, key, rows, **extra):
        by_path = {"serve": serve.get(key, 0), "train": train.get(key, 0),
                   "unet_serve": unet.get(key, 0)}
        return {
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": rows[0]["ms"], "plain_ms": rows[0]["plain_ms"],
            **extra, "shapes": rows,
        }

    csrc = "opendwm_tpu_torch/csrc/flash_tail.cu"
    triton_src = "opendwm_tpu_torch/ops/fused_adaln.py"
    kernels = [
        entry("flash_tail_forward", "cuda", csrc,
              "opendwm_tpu/ops/flash_tail.py:55", "flash_tail",
              attn_rows + unet_k1_rows,
              lse_ms=lse_timing["lse_ms"],
              serving_ms_beside_lse=lse_timing["serving_ms"]),
        entry("flash_tail_backward", "cuda", csrc,
              "opendwm_tpu/ops/flash_tail.py:125", "flash_tail_backward",
              bwd_rows),
        entry("adaln_modulate", "triton", triton_src,
              "opendwm_tpu/ops/fused_adaln.py:45", "adaln_modulate",
              adaln_rows["adaln_modulate"]),
        entry("residual_adaln_modulate", "triton", triton_src,
              "opendwm_tpu/ops/fused_adaln.py:133", "residual_adaln_modulate",
              adaln_rows["residual_adaln_modulate"]),
        entry("flash_attention_forward", "cuda",
              "opendwm_tpu_torch/csrc/flash_attention.cu",
              "opendwm_tpu/ops/attention.py:151", "flash_attention", k7_rows),
    ]
    log(f"card: {card}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
