#!/usr/bin/env python3
"""Drive the PyTorch port's CTSD-3.5 serving and training paths, its
streaming serving path with the CLIP/T5 text stage, its CTSD-2.1 UNet
serving and training paths, the layout-conditioned (box + map) flagship's
DiT and UNet serving and DiT training paths, int8 W8A8 serving of the DiT,
the UNet and the VAE, LiDAR serving (MaskGIT generation, its rollout and
the LiDAR DiT), UniMLVG serving and training, the DiT's other cross-view
and temporal types and MaskGWM, the causal temporal VAE, LiDAR training
(the VQ and KL tokenizers with the DVGO renderer, MaskGIT, the LiDAR DiT)
and the LiDAR UNet, LiDAR UNet training from a nuScenes-format archive
through the host data stack and the train CLI, the landing of reference
checkpoints and the evaluation path (the evaluate and preview CLIs, the
FID / FVD nets, the metrics, the train CLI's evaluation, preview and
profile), the tail-attention tiling experiment and the attention shoot-out
on one GPU.

Run from the root of a checkout:
    python3 chip_smoke.py [--profile-dit] [--profile-stream]
                          [--profile-train] [--profile-unet]
                          [--profile-unet-train]

Phases; any failure raises and exits non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: the CUDA kernels from ``opendwm_tpu_torch/csrc`` (one nvcc per
   source, all at once: ``flash_tail.cu``, ``flash_attention.cu``,
   ``adaln.cu``); ptxas's registers and spills (its report is kept beside
   each library, so a library built by an earlier run is held too) of every
   kernel of ``adaln.cu`` (K3/K4), failing on a spill, and a SASS census (``cuobjdump -sass``:
   ``HGMMA``, ``UTMALDG``, ``HMMA``) of each instance of the Hopper forward
   (``csrc/flash_fwd_sm90.cuh``, the body of every bf16 head-dim-64 launch
   of K1, K7 and K7-seg), of the Hopper tilings
   (``csrc/tail_tiling_sm90.cuh``, the body of every bf16 head-dim-64
   launch of K5 and K6) and of the Hopper backward
   (``csrc/flash_bwd_sm90.cuh``, the body of every bf16 head-dim-64
   launch of K2 and the K7 backward), failing on a body without an
   instance, an instance that ptxas did not report, a spill, or an
   instance without wgmma or TMA loads or with ``mma.sync``;
3. kernels: each Hopper kernel against its plain PyTorch version on the
   same inputs, at the shapes the serving and training paths give it, in
   bf16 (the attention kernels also in fp32), with both times: K1 (and
   its variant that writes the log-sum-exp for the backward) at the DiT's,
   the UNet's and the LiDAR DiT's shapes and the masked step's (36, 490 |
   336, 24, 64), K2 (the attention backward) at the DiT's, the UNet's and
   the masked step's training shapes, K3 and K4 (at the DiT's serving,
   training and masked shapes in bf16 on the d-1536 kernel, at the first
   also in fp16 and fp32, at the masked step's fp32 stream (36, 448,
   1536) in fp32, and at the LiDAR DiT's d-1024 shapes on the
   runtime-width kernel; x' equal to the
   plain version's bit for bit, bf16 and fp16 also within 2^-8 in relative
   norm; each timed eager, as device time replayed from a CUDA graph,
   as device time with inputs from device memory rather than L2, and as
   host µs a call), K7 (flash
   attention at the UNet's 1792 tokens, at 6400 and causal with q != kv,
   and at the DiT's other branch types' (12, 2688), (72, 2688) and (12,
   8064) at 24 x 64 heads, where the plain version runs over batch chunks
   whose fp32 logits stay under 8 GiB;
   its backward at the UNet's training shape (36 x 1792), at 6400 and
   causal with q shorter and longer than kv, and its forward with the
   log-sum-exp against the serving launch), K7-seg (flash attention with
   segment ids: the shoot-out's flashpad call at (36, 640, 24, 64) with
   the pads of S 602 in segment 1, and random ids in 1-4 segments per row
   at (8, 1792, 24, 64), non-causal and causal, in bf16 and fp32; rows
   that see no key of their segment against the mean of V), K7 at K1's
   serving shapes (equal to K1 bit for bit: one body) and its backward at
   K2's training shapes (equal to K2 bit for bit in dK and dV, within
   2^-7 in relative norm in dQ, whose fp32 sums arrive in no fixed order:
   one body) timed beside K1 and K2, the tail-attention tiling experiment
   (``opendwm_tpu_torch/perf/exp_tailvar.py``: K1, K5 at nh 2 and 4, K6 at
   bq 128 and 256 at (36, 602 | 448, 24, 64) in bf16 and at (8, 602, 24,
   64) in fp32, K5 and K6 equal to K1 bit for bit, every bf16 launch of
   them on the Hopper tiling kernel and no fp32 one; its launches are the
   ``tailvar`` path's), and the
   attention shoot-out (``opendwm_tpu_torch/perf/exp_attn602.py``: K1, the
   plain attention and K7-seg over S padded to a multiple of 128 at (36,
   602 | 448, 24, 64) bf16; its launches are the ``attn602`` path's, and
   K7-seg must have launched at (36, 640) and (36, 512) there). Beside
   each kernel's time: its plain version's, the least time the card could
   take for the same work (``bound_ms``), and the time of one PyTorch call
   that computes the same function (``library_ms``:
   ``scaled_dot_product_attention`` or its backward for the attention
   kernels, with the boolean same-id mask for K7-seg, and
   ``aten._scaled_dot_product_flash_attention``, which also returns the
   log-sum-exp, beside K7 with the log-sum-exp; none for the AdaLN ones).
   The card's clocks are logged between phases;
4. tiny models: the kernel path end to end (fp32, small widths) against
   the plain path on the CPU: the DiT, one AdamW train step of the DiT
   with remat on, the UNet, one AdamW train step of the UNet with remat
   on (the train steps through their loss, every gradient and the update),
   two CLIPs (both pooling rules) and a T5 (which must launch no attention
   kernel), and 4 ticks of a streaming pipeline on a 2-layer DiT with an
   ImageAdapter (3 frames, 2 views, 6 steps) in both CFG forms;
5. serving slice: ``configs/ctsd/multi_datasets/ctsd_35_tirda_nwao.json``
   at full width (24 layers, 24x64 heads, bf16) with random weights drawn
   on the card from a seed; a 2-window autoregressive rollout of 1 x 6
   frames x 6 views of 32x56 latents with CFG 4.0 (the one cut:
   inference_steps 40 -> 4), then the SD3.5 VAE decode to 256x448 frames.
   Every kernel of the path must have launched during the rollout, K3 62
   and K4 47 times a CFG forward. ``--profile-dit`` adds one
   ``torch.profiler`` CFG forward and prints its device time by kernel
   family and K3's and K4's device ms in it;
5b. stream slice: streaming serving end to end. The SD3 text stage at
   full width (CLIP-L 768 x 12, CLIP-G 1280 x 32, T5-XXL; 77 CLIP + 77 T5
   tokens, six prompts a frame, the in-repo ``WhitespaceTokenizer``),
   drawn from a seed in fp32 and held in bf16 within ``TEXT_REL_TOL`` in
   relative norm of the fp32 run; a refresh (cond and uncond encodes)
   timed ``TEXT_REPS`` times. Then the FIFO streaming pipeline on phase
   5's DiT at ``bench.py``'s streaming settings (30 steps over the
   6-frame window, 5 a tick, sequential CFG 3.0, the text refreshed
   every ``TEXT_INTERVAL`` frames and held in between), each emitted frame
   decoded by the SD3.5 VAE and written by the streaming CLI's PNG writer.
   6 ticks fill the queue (``ready`` False until the 6th), then
   ``STREAM_TIMED`` are timed: ms a frame in steady state (median and
   spread), with the refresh amortised, peak memory; one profiled tick
   gives the busy share and the device time by family
   (``--profile-stream``: 3 ticks, and the text refresh's profile). K1 at
   s = 602, 448, 168, K3 62 and K4 47 a forward, and no K7;
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
   under ``torch.profiler``;
9. bm DiT serving slice: ``configs/ctsd/ctsd_35_tirda_bm_nwao.json`` (the
   flagship: phase 5's DiT plus the 6 x 1536 ImageAdapter, 4.080B params)
   as phase 5, with random 256 x 448 x 3 box and map rasters per
   view-frame. Before the rollout, one forward at batch 1 with the rasters
   and one with the uncondition colour must differ by more than
   ``RASTER_MIN_MOVE`` in relative norm (``random_init_`` draws the zero
   convs and zero gates non-zero), and the profiler gives the adapter's
   device ms beside the CFG forward's. K1, K3 and K4 as in phase 5;
10. bm UNet serving slice: ``configs/ctsd/multi_datasets/
   ctsd_21_tirda_bm_nwa.json`` (phase 7's UNet plus its 5-stage adapter)
   as phase 7, with the same rasters gate and profile. K7 and K1 as in
   phase 7;
10b. int8 serving: phase 5's DiT and its SD3.5 VAE, and phase 7's UNet,
   each quantized on the card by the port's quantizer
   (``ops/quant.quantize_state_dict``, through
   ``opendwm_tpu_torch/perf/exp_int8_fidelity.py``'s ``build_pair``) from
   its bf16 weights and run beside its bf16 twin. The DiT: CFG forwards
   of both timed in turns (median of ``INT8_TIMED``), one profiled
   forward of each by kernel family with the int8 GEMM (``_int_mm``) and
   the quantize/dequantize work as lines of their own, then
   ``exp_int8_fidelity.run``: the forward's fidelity (cosine,
   ``max_rel_err``, ``max_rel_err_where_big``) and phase 5's 2-window
   rollout with both (the latents' cosine); the int8 rollout's latents
   decoded by the int8 VAE in chunks of 6 against the bf16 VAE, peak
   memory. The UNet: a CFG forward of both timed in turns and its
   cosine. Gates: cosine at least 0.995 (DiT forward) and 0.99 (UNet
   forward, VAE decode), finite outputs; K1, K3 (62) and K4 (47) a CFG
   forward of the int8 DiT, K7 (5) on the int8 UNet; a census
   (``Int8Census``) in which every quantized layer call ran one
   ``_int_mm`` and no float GEMM, and the ``_int_mm`` launches of a
   forward, of the rollout and of the decode equal the ``QLinear`` /
   ``QConv2d`` calls that the architecture implies; ``int8_mm`` at each
   shape of these paths that it pads and at their largest unpadded one
   (random int8 operands) equal to the float64 product bit for bit;
11. bm DiT train slice: the flagship at full width and depth, fp32
   masters, bf16 compute, remat as the config sets it, flat AdamW with
   bf16 moments (``BM_OPTIMIZER``, as ``bench.py`` trains); 3 steps from
   pixels (``vae_images``, 1 x 6 frames x 6 views of 256 x 448) through the
   SD3.5 VAE encoder, with the rasters. K1 and K2 as in phase 6; the
   optimizer state must hold 2 bytes a moment element (phase 6's: 4); the
   profiler gives the encoder's and the adapter's device ms. Its peak
   memory and its update alone (``optimizer.step()`` between two
   synchronizes, as phase 6 times the fused AdamW's) are logged beside
   phase 6's; ``--profile-train`` profiles it as it does phase 6;
12. LiDAR MaskGIT generation: ``configs/lidar/lidar_maskgit_layout_ns.json``
   at full width in bf16 compute (as ``bench.py:247-252``): the Swin VQ
   tokenizer (12-block encoder and decoder, 512 wide, ws 8, 2048 codes)
   and the 24-block MaskGIT (512 wide, ws 2, 80 x 80 tokens, the layout
   adapter), at ``bench.py``'s geometry (1 frame of 32768 points, random
   640 x 640 x 3 box and map rasters), 20 steps, CFG 3.0, blank code 0.
   First a tiny MaskGIT on the card against the CPU
   (``perf/lidar_tiny.py``, 1e-3); the rasters must move the logits;
   5 generations timed (s per frame: median and spread), one split into
   voxelize / encode + quantize / steps / decode, one profiled (busy
   share, device time by family); every index set, voxels binary, finite
   logits. No kernel runs on this path;
13. LiDAR MaskGIT rollout: ``configs/lidar/
   lidar_maskgit_temporal_vq80k_layout_ns.json`` (temporal blocks, the
   extra embedding, 80000 cosine codes) through
   ``autoregressive_inference_pipeline``: 11 frames, 3 reference frames,
   windows of 8 (2 windows), 20 steps each; the categorical step runs over
   row chunks (``pipelines/lidar_maskgit.py``), as 102,400 rows x 80,000
   codes do not fit in fp32 at once. A tiny temporal MaskGIT against the
   CPU first; one step profiled (busy share, the sampling's share); s per
   generated frame, peak memory; the reference frames stay pinned;
14. LiDAR DiT: ``configs/lidar/lidar_diffusion_dit_temporal_ns.json`` (16
   joint blocks at d 1024 in bf16, 8 rowwise temporal branches, the
   6-channel BEV adapter; the vq80k tokenizer in fp32) on 6 frames with
   one reference frame, CFG 3.0 (the one cut: inference_steps 50 -> 4).
   A tiny rowwise DiT (reaching K1) and a tiny pipeline against the CPU
   first; CFG forwards timed, the rasters gate, one forward profiled with
   the plain joint attention at s 1601 as a range of its own; the census:
   K1 8 a CFG forward, all at (80, 240, 16, 64) on the Hopper forward, K3
   33 and K4 31 a forward, all on the runtime-width kernel
   (``adaln_any_kernel``) at (12, 1600, 1024) and (12, 1, 1024);
15. UniMLVG serving: ``configs/unimlvg/ctsd_unimlvg_stage3_tirda_bm_nwa.json``
   (24 layers, the 6 x 1536 adapter, explicit perspective and view
   modeling, ``pred`` with 3 visible frames, bf16; the one cut: 40 -> 4
   steps) at phase 9's geometry with a seeded camera rig
   (``perf/unimlvg_tiny.camera_rig``: invertible intrinsics, extrinsics
   60° apart, ego poses 0.5 m further forward each frame). First the tiny
   pipeline on the card against the CPU (2-step CFG inference and a
   2-window rollout, 1e-3, K1 launched); CFG forwards timed (median of
   ``UNIMLVG_TIMED``); moving the camera transforms by 1 m and the rasters
   each move the output by more than ``RASTER_MIN_MOVE``; one profiled
   CFG forward (busy share, device ms by family); a 2-window rollout with
   CFG 4.0 and the SD3.5 VAE decode: s per generated 6-view frame, peak
   memory, the census (K1 at (72, 602, 24, 64) and at s 448 and 168, K3
   62 and K4 47 a CFG forward at (72, 448 | 154, 1536));
16. branch types and MaskGWM, on phase 15's DiT: the tiny types and a
   tiny masked step (forward and every gradient) against the CPU (1e-3,
   K7 launched by the types, K1 and K2 by the step); one CFG forward with each of cross-view ``full``,
   ``fuse``, ``adj_fuse`` and temporal ``full``, timed, K7 launched
   exactly ``BRANCH_K7``'s count at its shape (6 or 12 a forward at (12,
   2688), (12, 8064), (72, 2688)) on the Hopper forward; then a
   MaskController of its defaults attached (ratio 0.25, decode layer 5:
   336 of 448 tokens kept) and one masked forward + backward at batch 1
   with perspective modeling off (the ray embedding cannot meet the
   shortened rows, in the JAX model either): K1 and K2 at (36, 490 | 336,
   24, 64) and K3/K4 at (36, 336, 1536), no launch at a shape phase 3 did
   not hold against its plain version, the stream bf16 up to the first
   decoder layer and fp32 from it (as in the JAX model), s, peak memory;
17. UniMLVG training: the same config's ``loss_fn`` at full width and
   depth, fp32 masters, bf16 compute, remat as the config sets it, flat
   AdamW with bf16 moments (``BM_OPTIMIZER``); a tiny step on the card
   against the CPU first (``check_step_errors``), then 3 steps as phase 6
   (s per step, peak memory, K1/K2 at s 602, 448, 168, 2 B a moment);
18. the causal temporal VAE at the JAX defaults: the tiny VAE on the card
   against the CPU (1e-4) and causal; the full-width VAE in fp32 on 9
   frames of 64 x 112 (a change to the last frame leaves latent frame 0
   within 1e-5); in bf16, ``decode_from_scaled`` of 6 views x 5 latent
   frames of 32 x 56 to 17 frames of 256 x 448 and ``encode_to_scaled``
   back, ``TVAE_CHUNK`` views a call, each timed with its peak memory.
   Phases 15-18 log their seconds.
19. LiDAR tokenizer training (``configs/lidar/lidar_vqvae_nwa.json``, fp32:
   12 + 12 Swin blocks at 512, 2048 x 1024 codes, a 40 x 640 x 640 grid,
   768 ray steps) on 4 x 2 frames of 32,768 points in the voxelizer's box
   (1,024 a frame masked): the tiny ``LidarCodebook`` and ``LidarVAE``
   steps on the card against the CPU first (``perf/lidar_train_tiny.py``,
   1e-3); 3 steps (s a step, peak), the code ages and usage moved and the
   reservoir full after step 1; one step profiled with the render and the
   Swin encoder and decoder as ranges; the DVGO render's forward and
   backward alone (samples a second, its share of a step); a forced
   revival at the synthetic config's 64 codes (the codebook moves, the
   ages are 0); then ``configs/lidar/lidar_vae_nwak.json``'s ``LidarVAE``
   at the same geometry, 2 steps, finite, the KL term above 0;
20. MaskGIT training (``configs/lidar/lidar_maskgit_vq80k_layout_ns.json``:
   24 blocks at 512, 80,000 cosine codes, the extra embedding and its
   perturbation, 6-channel rasters; the transformer in bf16 compute over
   fp32 masters), the tokenizer saved by ``save_model_only`` and loaded
   through ``load_vq_params``: the tiny step against the CPU first; 3
   steps of 8 x 1 frame (s a step, peak, finite ``ce_loss`` and
   ``acc_0``);
21. LiDAR DiT training (``configs/lidar/lidar_diffusion_dit_temporal_ns.json``:
   16 blocks at d 1024, bf16 compute over fp32 masters, remat as the config
   sets it) at batch 4 of 6 frames: the tiny step against the CPU first (K1
   and K2), then 3 steps as phase 6; K1 and K2 at (160, 240, 16, 64) only,
   K3/K4 on the runtime-width kernel at (24, 1600 | 1, 1024), counted per
   step;
22. the LiDAR UNet (``configs/lidar/lidar_diffusion_unet_temporal_ns.json``:
   a VAEPointCloud of 64 latent channels and the UNet 320-1280 in bf16 over
   fp32 masters) on 80 x 80 latents x 4 frames x 1 view: the tiny pipeline
   against the CPU first (K7 forward and backward); DDIM with CFG 3.0, cut
   from 50 to 4 steps (s a generation, peak); 3 train steps at the
   config's batch 4 as phase 6; K7 at (8 | 16, 6400, 6400, 5, 64) and K1
   (and K2) at the shapes phase 3 held, nothing else.
   Phases 19-22 log their seconds;
23. the host data stack: ``opendwm_tpu_torch/perf/nuscenes_fixture.py``
   writes a nuScenes-format archive at nuScenes' scale (one train-split
   scene, 40 keyframes at 2 Hz, LIDAR_TOP sweeps of 34,720 points, ~50
   boxes a sample; deflated, with its ``.info.json``) and its extracted
   tree; the native zip scan, inflate, LiDAR decode and voxelizer equal
   their numpy fallbacks on it; the LiDAR UNet config's reader gives the
   same items, bit for bit, through ``CombinedZipFileSystem`` from 4
   threads as through ``DirFileSystem`` over the tree in one (and, with
   Pillow, one item's BEV rasters through both); the reader's items a
   second alone and through ``PrefetchLoader`` at 1 and 4 workers; then
   the port's train CLI (``train.main --device cuda``) trains the LiDAR
   UNet for 3 steps from the archive through the config's own dataset
   section (4 loader threads; its final checkpoint not written): a finite
   loss, s a step, the wait for the loader's batch, peak; K7 and its
   backward at (16, 6400, 6400, 5, 64) only, K1 and K2 at phase 22's
   training shapes only;
24. weight landing and evaluation (``run_land_eval_phase``). Sources in
   the released checkpoints' names are drawn on the card from ``SEED``:
   phase 5's DiT and phase 7's UNet (in memory; the UNet's SD2.1 skeleton,
   without its cross-view and temporal branches, in SD2.1-era keys, so
   that ``sd21_to_svd_keys`` runs), the SD3.5 VAE, CLIP-L (HF names), the
   FID Inception and I3D, the last four written in the released layout as
   one ``.pth`` and one ``.safetensors`` each (``run_all.discover`` must
   find the ``.pth`` tree). Each lands through ``run_all.import_entry``
   (every source key read, ``strict=True``, ``verified``), and a twin of
   its architecture holding the imported weights gives the source's golden
   forward bit for bit; each file load's seconds and GB/s are logged. Then
   ``evaluate.main --device cuda`` on a config at phase 5's geometry (its
   DiT without the implicit perspective embedding: the synthetic data has
   no cameras; 4 steps, CFG 3.0; the landed VAE as
   ``vae_checkpoint_path``; ``fid_proxy`` over the decoded frames): a
   finite result, K1 at (72, 602 | 448, 24, 64) and (192, 168, 24, 64)
   only, K3 62 and K4 47 a CFG forward at (72, 448 | 154, 1536) only
   (the ``land_eval`` path); FID (Inception at 299²) over every decoded
   frame and FVD (I3D at 224²) over every view's clip, random nets with
   shrinkage, each above 0. The preview CLI writes its batch's file; MaskGIT's
   ``evaluate_pipeline`` (voxel IoU, diff, Chamfer: finite) and
   ``save_results`` (the BEV PNG) at phase 12's geometry; and the train CLI
   runs 2 steps of ``TINY_CONFIG`` with ``--evaluation-steps 1
   --preview-steps 1 --profile-steps 1:1`` and a tiny VAE landed by
   ``convert_cli``: the metric logged at both steps, both previews and
   the trace written.

Each slice is freed before the next. K7-seg must have launched on no path
but the shoot-out, every K1 and K7 forward launch of the twenty model
paths must have run the Hopper forward, every K2 and K7 backward launch of
the eight training paths the Hopper backward, every bf16 K5 and K6
launch of the tailvar path the Hopper tilings, and every K3 and K4 launch
of the eleven DiT paths the d-1536 kernel (their launch counters).
The line before the last is the kernels JSON; the last is the device JSON.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

# Before CUDA initialises: 60 GB of training state in few large blocks
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import torch  # noqa: E402

from opendwm_tpu_torch.perf.measure import (  # noqa: E402
    adaln_bound,
    attention_bound,
    card_line,
    cold_copies,
    host_us,
    max_err,
    packed_segment_ids,
    range_device_ms,
    rel_err,
    scaled_err,
    segment_attention_bound,
    time_graph_ms,
    time_ms,
    time_pair,
)

REPO = Path(__file__).resolve().parent
CONFIG = REPO / "configs/ctsd/multi_datasets/ctsd_35_tirda_nwao.json"
UNET_CONFIG = REPO / "configs/ctsd/multi_datasets/ctsd_21_tirda_nwao.json"
# The layout-conditioned (box + map) configs: the flagship DiT and the UNet,
# each with its ImageAdapter; the DiT trains from pixels through the VAE
# encoder with bench.py's flat AdamW and bf16 moments.
BM_CONFIG = REPO / "configs/ctsd/ctsd_35_tirda_bm_nwao.json"
BM_UNET_CONFIG = REPO / "configs/ctsd/multi_datasets/ctsd_21_tirda_bm_nwa.json"
BM_OPTIMIZER = {"flat": True, "mu_dtype": "bfloat16"}
# The rasters must move a denoiser's output by more than this relative
# norm against the uncondition colour; an adapter that adds nothing (zero
# convs left at zero) moves it by exactly 0.
RASTER_MIN_MOVE = 1e-3
# The paths whose launch counters the body gates read.
TRAIN_PATHS = ("train", "unet_train", "bm_train", "unimlvg_train",
               "mask_step", "lidar_dit_train", "lidar_unet_train",
               "lidar_unet_data")
MODEL_PATHS = ("serve", "train", "unet_serve", "unet_train", "bm_serve",
               "bm_unet_serve", "bm_train", "stream", "int8_serve",
               "int8_unet", "lidar_dit", "unimlvg_serve", "unimlvg_train",
               "branch_types", "mask_step", "lidar_dit_train",
               "lidar_unet_serve", "lidar_unet_train", "lidar_unet_data",
               "land_eval")
DIT_PATHS = ("serve", "train", "bm_serve", "bm_train", "stream",
             "int8_serve", "unimlvg_serve", "unimlvg_train", "branch_types",
             "mask_step", "land_eval")
# LiDAR serving (bench.py:228-394's geometry): MaskGIT generation on the
# layout config (bf16 compute, as bench.py:247-252 sets it), the temporal
# vq80k config's autoregressive rollout, and the temporal LiDAR DiT (its
# d-1024 K3/K4 run the runtime-width kernel, so it is no DIT_PATHS path).
LIDAR_MASKGIT_CONFIG = REPO / "configs/lidar/lidar_maskgit_layout_ns.json"
LIDAR_ROLLOUT_CONFIG = \
    REPO / "configs/lidar/lidar_maskgit_temporal_vq80k_layout_ns.json"
LIDAR_DIT_CONFIG = REPO / "configs/lidar/lidar_diffusion_dit_temporal_ns.json"
LIDAR_PATHS = ("lidar_maskgit", "lidar_maskgit_rollout", "lidar_dit")
LIDAR_POINTS, LIDAR_RASTER = 32768, 640  # a frame's points; BEV raster side
LIDAR_BLANK_CODE = (0,)
MASKGIT_STEPS, MASKGIT_TIMED = 20, 5  # the config's 20 steps, no cut
# 11 frames, 3 reference frames, windows of 8: 2 windows
ROLLOUT_FRAMES, ROLLOUT_REF, ROLLOUT_WINDOW = 11, 3, 8
LIDAR_DIT_FRAMES, LIDAR_DIT_REF = 6, 1
LIDAR_DIT_STEPS = 4  # cut from the config's 50
LIDAR_DIT_FORWARDS = 3  # CFG forwards timed alone
# The LiDAR DiT's K1 launches (its 8 rowwise temporal branches at CFG
# batch 2: b·v·gh = 80 sequences of t·gw = 240 tokens, 16 x 64 heads)
# and K3/K4 launches a CFG forward (16 joint blocks, none dual, the last
# context_pre_only: K3 2 a block + norm_out, K4 1 a block + 15).
LIDAR_K1_SHAPE = (80, 240, 16)
LIDAR_K1_PER_FORWARD, LIDAR_K3_PER_FORWARD, LIDAR_K4_PER_FORWARD = 8, 33, 31
LIDAR_TINY_TOL = 1e-3
# LiDAR training and the LiDAR UNet (phases 19-22), at the configs' full
# width with random weights drawn on the card: the VQ tokenizer (4 x 2
# frames of LIDAR_POINTS points in the voxelizer's box, the last
# TOKENIZER_MASKED of each frame masked; 768 ray steps a point), the KL
# tokenizer at the same geometry, MaskGIT on the 80k cosine codebook (8 x 1
# frame), the LiDAR DiT (batch 4 of 6 frames) and the LiDAR UNet over a
# VAEPointCloud (80 x 80 latents x 4 frames; DDIM with CFG cut from 50 to
# LIDAR_UNET_STEPS steps, and a train step at the config's batch 4).
LIDAR_VQVAE_CONFIG = REPO / "configs/lidar/lidar_vqvae_nwa.json"
LIDAR_VAE_CONFIG = REPO / "configs/lidar/lidar_vae_nwak.json"
LIDAR_VQVAE_SYNTHETIC = REPO / "configs/lidar/lidar_vqvae_synthetic.json"
LIDAR_MASKGIT_TRAIN_CONFIG = \
    REPO / "configs/lidar/lidar_maskgit_vq80k_layout_ns.json"
LIDAR_UNET_CONFIG = \
    REPO / "configs/lidar/lidar_diffusion_unet_temporal_ns.json"
TOKENIZER_BATCH, TOKENIZER_FRAMES, TOKENIZER_MASKED = 4, 2, 1024
LIDAR_TRAIN_STEPS, LIDAR_VAE_STEPS = 3, 2
MASKGIT_TRAIN_BATCH = 8
LIDAR_DIT_TRAIN_BATCH = 4
LIDAR_UNET_FRAMES, LIDAR_UNET_BATCH, LIDAR_UNET_STEPS = 4, 4, 4
# The LiDAR DiT's K1 (and K2) at the train batch: 4 x 40 rows of 6 x 40
# tokens; its K3/K4 at 4 x 6 frames of 1600 latent tokens and 1 text token.
LIDAR_DIT_TRAIN_K1_SHAPE = (160, 240, 16)
LIDAR_TRAIN_ADALN_SHAPES = ((24, 1600, 1024), (24, 1, 1024))
# The LiDAR UNet's K1 (batch, seq, heads) a forward, at CFG batch 2 of 4
# frames (serving) and at the train batch of 4 x 4 frames: the level-0
# rowwise temporal branch (80 rows of 4 x 80 tokens, 5 heads), the level-1
# one (40 rows of 4 x 40, 10 heads) and the level-2 self-attention (20 x
# 20 tokens, 20 heads); its K7 at the level-0 self-attention (80 x 80).
LIDAR_UNET_K1_SERVE = ((160, 320, 5), (80, 160, 10), (8, 400, 20))
LIDAR_UNET_K1_TRAIN = ((320, 320, 5), (160, 160, 10), (16, 400, 20))
LIDAR_UNET_K7_SERVE, LIDAR_UNET_K7_TRAIN = (8, 6400, 6400, 5), \
    (16, 6400, 6400, 5)
# The LiDAR UNet's parameters that get no gradient: the added-time
# embedding (the LiDAR pipeline feeds no added_time_ids) and the norm
# before each cross-attention (one zero text token: a single key, so the
# queries' gradient is 0), whose bias starts at 0 and so stays there.
LIDAR_UNET_MAY_STAY = (r"^add_embedding\.",
                       r"transformer_blocks\.\d+\.norm2\.bias$")
# The data phase (23): a nuScenes-format archive at nuScenes' scale (one
# train-split scene of 40 keyframes at 2 Hz, LIDAR_TOP sweeps of 34,720
# points, ~50 boxes a sample; perf/nuscenes_fixture.py), read through the
# LiDAR UNet config's own dataset section by the port's train CLI for
# DATA_STEPS steps with DATA_WORKERS loader threads. The rasters' keys:
# the settings the reader takes and the items' keys they make.
NUSCENES_SAMPLES, NUSCENES_POINTS, NUSCENES_BOXES = 40, 34720, 50
DATA_WORKERS, DATA_STEPS, DATA_LOADER_BATCHES = 4, 3, 4
RASTER_SETTINGS = ("_3dbox_bev_settings", "hdmap_bev_settings")
RASTER_KEYS = ("3dbox_bev_images", "hdmap_bev_images")
# UniMLVG stage 3 (the best video model the repo publishes, with explicit
# perspective and view modeling and ``pred`` with 3 visible frames) and the
# DiT's other options, at phases 5 and 9's geometry; its CFG forwards are
# timed UNIMLVG_TIMED times (median).
UNIMLVG_CONFIG = REPO / "configs/unimlvg/ctsd_unimlvg_stage3_tirda_bm_nwa.json"
UNIMLVG_TIMED = 5
# The other branch types on the same DiT at the CFG batch (24 x 64 heads):
# each type's K7 shape (batch, tokens) and launches a CFG forward (6
# cross-view layers, 12 temporal ones). full: 2 x 6 frames of 6 views x
# 448 tokens; fuse: 2 x 6 views of 6 frames x 3 views x 448; adj_fuse:
# 2 x 36 view-frames of 2 frames x 3 views x 448; temporal full: 2 x 6
# views of 6 frames x 448.
BRANCH_K7 = {"crossview_full": ("crossview_attention_type", "full",
                                (12, 2688), 6),
             "crossview_fuse": ("crossview_attention_type", "fuse",
                                (12, 8064), 6),
             "crossview_adj_fuse": ("crossview_attention_type", "adj_fuse",
                                    (72, 2688), 6),
             "temporal_full": ("temporal_attention_type", "full",
                               (12, 2688), 12)}
DIT_K7_SHAPES = ((12, 2688), (72, 2688), (12, 8064))
# The plain attention at those shapes runs over batch chunks whose fp32
# logits stay under this many bytes (all of (12, 8064) would take 75 GB).
PLAIN_LOGIT_BYTES = 8 << 30
# MaskGWM's defaults (ratio 0.25, decode layer 5): 336 of 448 latent tokens
# a view-frame kept, so a batch-1 step's joint attention is 336 + 154
# tokens long and its dual attention 336 (K1 forward, K2 backward); K3/K4
# modulate the 336 kept tokens, and from the first decoder layer on the
# fp32 stream of all 448 (as in the JAX model).
MASK_ATTN_SHAPES = ((36, 490, 24), (36, 336, 24))
MASK_ADALN_SHAPE, MASK_ADALN_FP32_SHAPE = (36, 336, 1536), (36, 448, 1536)
# The causal temporal VAE at the JAX defaults (128/256/256/512 channels, 3
# blocks a stage, 16 latent channels) in bf16: 5 latent frames of 6 views
# decode to 17 frames of 256 x 448 and encode back, the views folded
# through the batch TVAE_CHUNK at a time; the tiny VAE's tolerance.
TVAE_LATENT_FRAMES, TVAE_CHUNK, TVAE_TOL = 5, 2, 1e-4
TINY_CONFIG = REPO / "configs/ctsd/ctsd_35_6views_video_synthetic.json"
SEED = 0
STEPS = 4  # cut from the config's 40
WINDOWS = 2
FRAMES, VIEWS, LAT_H, LAT_W, TEXT_TOKENS = 6, 6, 32, 56, 154
DECODE_CHUNK = 12  # frames per VAE decode call
ATTN_SHAPES = ((72, 602), (72, 448), (192, 168))  # (batch, seq); 24x64 heads
TRAIN_ATTN_SHAPES = ((36, 602), (36, 448), (96, 168))  # batch 1: train, stream
# The int8 phase: CFG forwards timed a model (in turns with the bf16 twin),
# and the int8 VAE decode's chunk (bench.py:807).
INT8_TIMED, INT8_DECODE_CHUNK = 5, 6
TRAIN_STEPS = 3  # steps 2 and 3 are timed
PROFILE_STEPS = 3  # with --profile-train/-unet-train: 3 more, then 3 profiled
# The CUDA sources, built together (one nvcc each, all at once).
SOURCES = ("flash_tail.cu", "flash_attention.cu", "adaln.cu")
# K3/K4 (batch x view-frames, tokens, width): the DiT's latent (448) and
# text (154) tokens at the CFG batch of serving and at training's batch 1.
ADALN_SHAPES = ((72, 448, 1536), (72, 154, 1536), (36, 448, 1536),
                (36, 154, 1536), MASK_ADALN_SHAPE)
# ... and the LiDAR DiT's at d 1024 (CFG batch 2 x 6 frames: 1600 latent
# tokens, 1 text token), which run the runtime-width kernel.
LIDAR_ADALN_SHAPES = ((12, 1600, 1024), (12, 1, 1024))
# K3 and K4 launches a DiT CFG forward (models/mmdit.py): K3 at :92 (24
# blocks), :96/:100 (24), :105 (13 dual-attention blocks) and :439 (1); K4
# at :107/:111 (24) and :118 (23: the last block is context_pre_only).
K3_PER_FORWARD, K4_PER_FORWARD = 62, 47
# The UNet at the CFG batch: K1 at the level-0 branches (384 x 336), level-1
# self-attention (72 x 448) and branches (192 x 168); K7 at the level-0
# self-attention (72 x 1792) and at the 80x80 LiDAR BEV latents (6400).
UNET_TEXT_TOKENS, UNET_TEXT_DIM, UNET_LAT_C = 77, 1024, 4
UNET_K1_SHAPES = ((384, 336, 5), (72, 448, 10), (192, 168, 10))
UNET_K2_SHAPES = ((192, 336, 5), (36, 448, 10), (96, 168, 10))  # batch 1
# (batch, seq, heads) at head dim 64 where phase 3 holds K1 (bf16) and K2
# (bf16, the Hopper backward) against their plain versions: the DiT's
# serving and training shapes (the stream's too), the LiDAR DiT's, and the
# masked step's; the UNet's K1 shapes apart (check_unet_attention).
K1_CHECKED = tuple((b, s, 24) for b, s in ATTN_SHAPES + TRAIN_ATTN_SHAPES) \
    + (LIDAR_K1_SHAPE, LIDAR_DIT_TRAIN_K1_SHAPE) + MASK_ATTN_SHAPES
K2_CHECKED = tuple((b, s, 24) for b, s in TRAIN_ATTN_SHAPES) \
    + UNET_K2_SHAPES + MASK_ATTN_SHAPES + (LIDAR_DIT_TRAIN_K1_SHAPE,) \
    + LIDAR_UNET_K1_TRAIN
K7_SHAPES = ((72, 1792, 1792, 5, False), (8, 6400, 6400, 5, False),
             (8, 1792, 3584, 5, True), LIDAR_UNET_K7_TRAIN + (False,))
# (batch, q, kv, heads, causal)
# The K7 backward at the UNet's training batch (1 x 36 view-frames, no
# CFG), at the LiDAR UNet's BEV tokens (and its train batch), and causal
# with q shorter and longer than kv; fp32 at a small causal shape.
K7_BWD_SHAPES = ((36, 1792, 1792, 5, False), (8, 6400, 6400, 5, False),
                 (8, 1792, 3584, 5, True), (8, 3584, 1792, 5, True),
                 LIDAR_UNET_K7_TRAIN + (False,))
# the plain K7 backward runs over batch chunks of at most this many rows
# (the fp32 probabilities, their gradient and dS at (16, 6400, 5) would
# take ~40 GB)
K7_BWD_PLAIN_BATCH = 8
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
# The stream phase, at bench.py's streaming settings (run_streaming_bench):
# 30 flow-match steps over the 6-frame window (5 a tick), sequential CFG
# 3.0; 6 ticks fill the queue, then STREAM_TIMED ticks are timed. The text
# refreshes every TEXT_INTERVAL frames (the XS streaming config's
# text_prompt_interval); a refresh is timed TEXT_REPS times.
STREAM_STEPS, STREAM_GUIDANCE, STREAM_TIMED = 30, 3.0, 6
TEXT_INTERVAL, TEXT_REPS = 10, 5
# The SD3 text encoders at full width: CLIP-L, CLIP-G, T5-XXL (defaults).
TEXT_ENCODERS = {
    "clip_l": dict(hidden_size=768, num_layers=12, num_heads=12,
                   act="quick_gelu", projection_dim=768),
    "clip_g": dict(hidden_size=1280, num_layers=32, num_heads=20,
                   act="gelu", projection_dim=1280),
    "t5": {},
}
STREAM_SCENES = ("a rainy city street at night with parked cars",
                 "a sunny highway with trucks in the right lane")
STREAM_VIEWS = ("front", "front right", "back right", "back", "back left",
                "front left")
# The bf16 text stage against its fp32 twin, ||bf16 - fp32|| / ||fp32||.
TEXT_REL_TOL = 3e-2
# The tiny streaming check's DiT: 2 joint blocks (the first with dual
# attention and the rowwise cross-view branch, the second with the
# pointwise temporal one) and a 2-stage ImageAdapter of the joint width;
# 16 x 24 latents and 40 text tokens make a 136-token joint attention (K1).
TINY_STREAM_DIT = dict(
    patch_size=2, num_layers=2, attention_head_dim=16, num_attention_heads=2,
    in_channels=16, out_channels=16, joint_attention_dim=24,
    caption_projection_dim=32, pooled_projection_dim=16,
    pos_embed_max_size=16, sample_size=8, dual_attention_layers=(0,),
    enable_crossview=True, crossview_attention_type="rowwise",
    crossview_block_layers=(0,), enable_temporal=True,
    temporal_attention_type="pointwise", temporal_block_layers=(1,),
    qk_norm_on_additional_modules="rms_norm",
    condition_image_adapter_config=dict(
        in_channels=6, channels=[32, 32], is_downblocks=[True, False],
        num_res_blocks=1, downscale_factor=2, use_zero_convs=True))
# Tolerances on |kernel - plain| / max(1, |plain|), elementwise: absolute
# for outputs below 1, relative above, because one bf16 ulp is 2^-7 of the
# value (0.0625 at 16) and the two versions may round an fp32 result that
# differs in its last bits to neighbouring bf16 values.
ATTN_TOL, ADALN_TOL, FP32_TOL, TINY_TOL = 2e-2, 3e-2, 1e-4, 1e-3
# K3/K4 in bf16 and fp16 also ||kernel - plain|| / ||plain||: both round
# the same fp32 values, so they differ only where a value lies near a
# rounding boundary; a kernel with wrong statistics moves every value.
ADALN_REL_TOL = 2 ** -8
# Attention in bf16 also ||kernel - plain|| / ||plain||: its outputs sit far
# below 1 (~0.04-0.07 at these shapes), where ATTN_TOL alone is as large as
# a typical value.
ATTN_REL_TOL = 2 ** -7
# K2 in bf16: ||kernel - plain|| / ||plain|| per gradient, the bar recorded
# for the JAX kernel (docs/PARITY.md): dS is rounded to bf16 at other
# points, and delta comes from dO.O instead of dP.P.
K2_REL_TOL = 6e-3
# dQ of the Hopper backward is a sum of fp32 atomics in no fixed order: two
# launches, or K2 and the K7 backward, agree in dQ within one bf16 ulp in
# relative norm, in dK and dV bit for bit.
DQ_ORDER_TOL = 2 ** -7


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def sdpa_ms(q, k, v, scale, causal=False, do=None, ref=None, mask=None,
            lse=False):
    """ms of one PyTorch call computing the same function on the same
    inputs (BHSD views of them): ``scaled_dot_product_attention`` (with
    ``mask``, a boolean mask of the visible pairs, in place of ``causal``),
    with ``lse`` the flash forward that also returns the log-sum-exp
    (``aten._scaled_dot_product_flash_attention``), or with ``do`` its
    backward from its own forward's output and log-sum-exp:
    the flash kernel's, or for causal with q != kv, where the flash kernel
    masks bottom-right, the memory-efficient kernel's, whose ``is_causal``
    is top-left as K7's. With ``ref`` (the plain dq, dk, dv) it logs the
    relative error of the library's gradients. Timed as a yardstick; the
    port never calls it. None, with the reason logged, if the call is
    refused."""
    F = torch.nn.functional
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    try:
        if lse:
            return time_ms(lambda: torch.ops.aten
                           ._scaled_dot_product_flash_attention(
                               qt, kt, vt, 0.0, causal, False, scale=scale))
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
    for b, s, h in K1_CHECKED:
        q, k, v = (torch.randn(b, s, h, 64, generator=g, device=dev,
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
        log(f"K1 flash_tail bf16 ({b},{s},{h},64): max_abs_err {err:.3e}, "
            f"scaled {scaled:.3e} (tol {ATTN_TOL}), rel norm {rel:.3e} (tol "
            f"{ATTN_REL_TOL}), kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"sdpa {fmt_ms(lib_ms)}")
        if not (scaled <= ATTN_TOL and rel <= ATTN_REL_TOL):
            fail(f"flash_tail disagrees at s={s}: scaled {scaled}, rel {rel}")
        rows.append({"shape": [b, s, h, 64], "dtype": "bf16",
                     "max_abs_err": err, "scaled_err": scaled,
                     "rel_err": rel,
                     **yardsticks(ms, plain_ms, lib_ms,
                                  attention_bound(b, s, s, h, 64))})
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
    """K2 against the plain backward at ``K2_CHECKED`` (the DiT's, the
    UNet's and the masked step's training shapes) in bf16 (each launch on
    the Hopper backward) and at one fp32 shape (an old body); K1 with the
    log-sum-exp against the serving K1 at s602."""
    g = torch.Generator(dev).manual_seed(SEED + 2)
    scale = 64 ** -0.5
    rows = []
    cases = [(b, s, h, torch.bfloat16) for b, s, h in K2_CHECKED] + \
        [(*TRAIN_ATTN_SHAPES[2], 24, torch.float32)]
    for b, s, h, dtype in cases:
        q, k, v, do = (torch.randn(b, s, h, 64, generator=g, device=dev,
                                   dtype=dtype) for _ in range(4))
        out, lse = flash_tail.tail_masked_attention_forward(q, k, v, scale)
        before = flash_tail.sm90_backward_launches
        grads = flash_tail.tail_masked_attention_backward(q, k, v, out, do,
                                                          lse, scale)
        on_sm90 = flash_tail.sm90_backward_launches - before
        ref = flash_tail.tail_masked_attention_backward_plain(q, k, v, do,
                                                              scale)
        errs = [max_err(a, r) for a, r in zip(grads, ref)]
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        shape = f"({b},{s},{h},64)"
        if on_sm90 != (dtype == torch.bfloat16):
            fail(f"K2 {tag} {shape} ran the wrong body ({on_sm90} launches "
                 "on the Hopper backward)")
        if dtype == torch.float32:
            scaled = max(scaled_err(a, r) for a, r in zip(grads, ref))
            log(f"K2 flash_tail backward fp32 {shape}: max_abs_err "
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
        log(f"K2 flash_tail backward {tag} {shape}: rel err dq/dk/dv "
            f"{rels[0]:.2e}/{rels[1]:.2e}/{rels[2]:.2e} (tol {K2_REL_TOL}), "
            f"max_abs_err {max(errs):.3e}, kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, sdpa flash backward {fmt_ms(lib_ms)}")
        if not max(rels) <= K2_REL_TOL:
            fail(f"flash_tail backward disagrees at {shape}: {rels}")
        rows.append({"shape": [b, s, h, 64], "dtype": tag,
                     "max_abs_err": max(errs), "rel_err": rels,
                     **yardsticks(ms, plain_ms, lib_ms,
                                  attention_bound(b, s, s, h, 64,
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
    """K1 at the UNet's shapes (the CTSD-2.1 UNet's and the LiDAR UNet's
    serving and training ones) and K7 at its own, each against its plain
    version in bf16 with both times; K7 also in fp32."""
    g = torch.Generator(dev).manual_seed(SEED + 3)
    k1_rows, k7_rows = [], []
    scale = 64 ** -0.5
    for b, s, h in \
            UNET_K1_SHAPES + LIDAR_UNET_K1_SERVE + LIDAR_UNET_K1_TRAIN:
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


def check_dit_k7(dev, flash_attention):
    """K7 at the DiT's other branch types' shapes (``DIT_K7_SHAPES``, 24 x
    64 heads, bf16) against its plain version, which runs over batch
    chunks (``PLAIN_LOGIT_BYTES``), with both times, the bound and SDPA's
    time."""
    g = torch.Generator(dev).manual_seed(SEED + 7)
    scale = 64 ** -0.5
    rows = []
    for b, s in DIT_K7_SHAPES:
        q, k, v = (torch.randn(b, s, 24, 64, generator=g, device=dev,
                               dtype=torch.bfloat16) for _ in range(3))
        chunk = max(1, min(b, PLAIN_LOGIT_BYTES // (24 * s * s * 4)))

        def kernel():
            return flash_attention.flash_attention(q, k, v, scale)

        def plain():
            return torch.cat([flash_attention.flash_attention_plain(
                q[i:i + chunk], k[i:i + chunk], v[i:i + chunk], scale)
                for i in range(0, b, chunk)])

        out, ref = kernel(), plain()
        err, scaled, rel = max_err(out, ref), scaled_err(out, ref), \
            rel_err(out, ref)
        del out, ref
        ms, plain_ms = time_pair(kernel, plain)
        lib_ms = sdpa_ms(q, k, v, scale)
        log(f"K7 flash_attention bf16 ({b},{s},{s},24,64) [DiT branch]: "
            f"max_abs_err {err:.3e}, scaled {scaled:.3e} (tol {ATTN_TOL}), "
            f"rel norm {rel:.3e} (tol {ATTN_REL_TOL}), kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms (batch chunks of {chunk}), sdpa "
            f"{fmt_ms(lib_ms)}")
        if not (scaled <= ATTN_TOL and rel <= ATTN_REL_TOL):
            fail(f"flash_attention disagrees at the DiT's ({b},{s}): scaled "
                 f"{scaled}, rel {rel}")
        rows.append({"shape": [b, s, s, 24, 64], "causal": False,
                     "dtype": "bf16", "max_abs_err": err,
                     "scaled_err": scaled, "rel_err": rel,
                     "plain_batch_chunk": chunk,
                     **yardsticks(ms, plain_ms, lib_ms,
                                  attention_bound(b, s, s, 24, 64))})
        del q, k, v
        torch.cuda.empty_cache()
    return rows


def check_flash_attention_backward(dev, flash_attention):
    """The K7 backward against its plain version (each from its own
    forward's output and log-sum-exp) at ``K7_BWD_SHAPES`` in bf16 (each
    launch on the Hopper backward), with both times, the relative error of
    each gradient and the time of the library's flash backward; fp32 at
    ``K7_BWD_FP32`` (an old body). Then K7 with the
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

        def plain():  # over batch chunks; lse rows are (batch, head)
            lse_rows = ref_lse.reshape(b, h, -1)
            parts = []
            for i in range(0, b, K7_BWD_PLAIN_BATCH):
                j = slice(i, i + K7_BWD_PLAIN_BATCH)
                parts.append(flash_attention.flash_attention_backward_plain(
                    q[j], k[j], v[j], ref_out[j],
                    lse_rows[j].reshape(-1, sq), do[j], scale, causal))
            return tuple(torch.cat(grads_) for grads_ in zip(*parts))

        before = flash_attention.sm90_backward_launches
        grads, ref = kernel(), plain()
        on_sm90 = flash_attention.sm90_backward_launches - before
        errs = [max_err(a, r) for a, r in zip(grads, ref)]
        tag = f"({b},{sq},{sk},{h},64){' causal' if causal else ''}"
        if on_sm90 != (dtype == torch.bfloat16):
            fail(f"the K7 backward {tag} {dtype} ran the wrong body "
                 f"({on_sm90} launches on the Hopper backward)")
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
    lse_lib_ms = sdpa_ms(q, k, v, scale, lse=True)
    log(f"K7 flash_attention bf16 ({b},{sq},{sk},{h},64): with the "
        f"log-sum-exp {lse_ms:.3f} ms, serving launch {serve_ms:.3f} ms, "
        f"sdpa flash forward with the log-sum-exp {fmt_ms(lse_lib_ms)}")
    return rows, {"lse_ms": lse_ms, "serving_ms": serve_ms,
                  "lse_library_ms": lse_lib_ms}


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
    (the DiT's and the UNet's) against its plain version and equal to K2
    (both launch the Hopper backward of ``csrc/flash_bwd_sm90.cuh``): dK
    and dV bit for bit, dQ within ``DQ_ORDER_TOL`` in relative norm; each
    timed beside K1 or K2 in turns (K1, K7, K7, K1)."""
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
    for b, s, h in [(b, s, 24) for b, s in TRAIN_ATTN_SHAPES] + \
            list(UNET_K2_SHAPES):
        q, k, v, do = (torch.randn(b, s, h, 64, generator=g, device=dev,
                                   dtype=torch.bfloat16) for _ in range(4))
        out7, lse7 = flash_attention.flash_attention_forward(q, k, v, scale)
        out1, lse1 = flash_tail.tail_masked_attention_forward(q, k, v, scale)
        ref_out, ref_lse = flash_attention.flash_attention_forward_plain(
            q, k, v, scale)
        grads = flash_attention.flash_attention_backward(q, k, v, out7, do,
                                                         lse7, scale)
        k2 = flash_tail.tail_masked_attention_backward(q, k, v, out1, do,
                                                       lse1, scale)
        ref = flash_attention.flash_attention_backward_plain(
            q, k, v, ref_out, ref_lse, do, scale)
        rels = [rel_err(a, r) for a, r in zip(grads, ref)]
        same_dkdv = torch.equal(grads[1], k2[1]) and \
            torch.equal(grads[2], k2[2])
        dq_vs_k2 = rel_err(grads[0], k2[0])
        del grads, k2, ref, ref_out, ref_lse
        shape = f"({b},{s},{h},64)"
        if not max(rels) <= K2_REL_TOL:
            fail(f"the K7 backward disagrees at K2's {shape}: {rels}")
        if not (same_dkdv and dq_vs_k2 <= DQ_ORDER_TOL):
            fail(f"the K7 backward differs from K2 at {shape}, though both "
                 f"run one body: dK/dV equal {same_dkdv}, dQ rel "
                 f"{dq_vs_k2:.3e} (tol {DQ_ORDER_TOL})")
        k7_ms, k2_ms = time_pair(
            lambda: flash_attention.flash_attention_backward(
                q, k, v, out7, do, lse7, scale),
            lambda: flash_tail.tail_masked_attention_backward(
                q, k, v, out1, do, lse1, scale))
        log(f"K7 backward at K2's shape bf16 {shape}: rel err dq/dk/dv "
            f"{rels[0]:.2e}/{rels[1]:.2e}/{rels[2]:.2e} (tol {K2_REL_TOL}), "
            f"dK/dV equal to K2 bit for bit, dQ rel {dq_vs_k2:.2e} from K2's, "
            f"K7 backward {k7_ms:.3f} ms, K2 {k2_ms:.3f} ms "
            f"({k7_ms / k2_ms:.3f}x)")
        bwd.append({"shape": [b, s, h, 64], "rel_err": rels,
                    "dk_dv_equal_k2": same_dkdv, "dq_rel_vs_k2": dq_vs_k2,
                    "k7_ms": k7_ms, "k2_ms": k2_ms,
                    "bound_ms": attention_bound(b, s, s, h, 64,
                                                backward=True)[0]})
        del q, k, v, do, out7, lse7, out1, lse1
        torch.cuda.empty_cache()
    return fwd, bwd


def check_tailvar_rows(runs, rel_tols) -> None:
    """Each row of the tiling experiment (``runs``: pairs of its rows and
    their scaled bar; ``rel_tols``: the relative-norm bar by dtype) within
    the bars against the plain version and K1, and every K5 and K6 row
    equal to K1 bit for bit (``equals_k1``, which the experiment sets on
    the card): in bf16 at D 64 they run K1's Hopper tile step, in fp32 its
    FMA step."""
    for results, tol in runs:
        for r in results:
            rel_tol = rel_tols[getattr(torch, r["dtype"])]
            near_k1 = r.get("vs_k1_scaled_err", 0.0) <= tol and \
                r.get("vs_k1_rel_err", 0.0) <= rel_tol
            k1_bits = r["kernel"] == "flash_tail_forward" or \
                r.get("equals_k1") is True
            if not (r["scaled_err"] <= tol and r["rel_err"] <= rel_tol
                    and near_k1 and k1_bits):
                fail(f"tiling {r['variant']} {r['dtype']} {r['shape']} "
                     f"disagrees: scaled {r['scaled_err']} (bar {tol}), "
                     f"relative norm {r['rel_err']} (bar {rel_tol}), "
                     f"against K1 {r.get('vs_k1_scaled_err')} / "
                     f"{r.get('vs_k1_rel_err')}, equal to K1: "
                     f"{r.get('equals_k1')}")


def check_tailvar_launches(bf16: dict, total: dict) -> None:
    """``bf16``: the tiling experiment's launch counts after its bf16 runs
    (D 64, aligned tensors), ``total`` after its fp32 run too. K5 at nh 2
    and 4 and K6 at bq 128 and 256 launched in bf16; every bf16 launch of
    K5 and K6 ran the Hopper tiling kernel and no fp32 launch did."""
    for key, want in (("tail_hpack_by_nh", (2, 4)),
                      ("tail_qsplit_by_bq", (128, 256))):
        for n in want:
            if bf16[key].get(n, 0) == 0:
                fail(f"{key}[{n}] never launched in the tiling experiment")
    for kernel in ("tail_hpack", "tail_qsplit"):
        hopper = bf16[f"{kernel}_sm90"]
        fp32 = total[kernel] - bf16[kernel]
        log(f"tailvar: {kernel} {bf16[kernel]} bf16 launches, {hopper} on "
            f"the Hopper tiling kernel; {fp32} fp32 launches, "
            f"{total[f'{kernel}_sm90'] - hopper} on it")
        if hopper != bf16[kernel]:
            fail(f"{bf16[kernel] - hopper} of {bf16[kernel]} bf16 {kernel} "
                 "launches ran an old body")
        if fp32 == 0 or total[f"{kernel}_sm90"] != hopper:
            fail(f"the fp32 {kernel} launches ({fp32}) did not all run the "
                 "FMA body")


def run_tailvar(dev, ops, exp_tailvar):
    """The tail-attention tiling experiment through its run function at its
    full shapes in bf16 and at ``TAILVAR_FP32``: K1, K5 (nh 2, 4) and K6 (bq
    128, 256), each against the plain version (the scaled error and the
    relative norm), timed beside it, the bound and SDPA. K5 and K6 must
    equal K1 bit for bit, and every bf16 launch of them must have run the
    Hopper tiling kernel (``csrc/tail_tiling_sm90.cuh``). Returns the
    experiment's launches and the K5 and K6 rows."""
    ops.reset_launch_counts()
    runs = [(exp_tailvar.run(seq, label, dev), ATTN_TOL)
            for label, seq in exp_tailvar.SHAPES.items()]
    torch.cuda.synchronize()
    bf16 = ops.launch_counts()
    b, seq = TAILVAR_FP32
    runs.append((exp_tailvar.run(seq, "fp32", dev, b=b, dtype=torch.float32),
                 FP32_TOL))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    log(f"launches in the tiling experiment: {json.dumps(counts)}")
    check_tailvar_rows(runs, exp_tailvar.REL_TOL)  # rows printed by the run
    check_tailvar_launches(bf16, counts)
    rows = {"tail_hpack": [], "tail_qsplit": []}
    for results, _ in runs:
        for r in results:
            if r["kernel"] in rows:
                rows[r["kernel"]].append(r)
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


def adaln_case(fused_adaln, name, x, delta, gate, scale, shift):
    """(kernel, plain) callables of K3 (``adaln_modulate``) or K4
    (``residual_adaln_modulate``) on these inputs."""
    if name == "adaln_modulate":
        return (lambda: fused_adaln.adaln_modulate(x, scale, shift),
                lambda: fused_adaln.adaln_modulate_plain(x, scale, shift))
    return (lambda: fused_adaln.residual_adaln_modulate(x, delta, gate, scale,
                                                        shift),
            lambda: fused_adaln.residual_adaln_modulate_plain(
                x, delta, gate, scale, shift))


def adaln_inputs(n, l, d, dtype, dev, g):
    """x and delta (n, l, d) and gate, scale, shift as strided (n, d)
    chunks of an (n, 9d) output, as the model's modulation vectors are."""
    x, delta = (torch.randn(n, l, d, generator=g, device=dev, dtype=dtype)
                for _ in range(2))
    gate, scale, shift = torch.randn(n, 9 * d, generator=g, device=dev,
                                     dtype=dtype).chunk(9, dim=-1)[:3]
    return x, delta, gate, scale, shift


def adaln_errors(outs, refs, dtype) -> dict:
    """K3/K4 outputs against the plain version's: max abs, scaled and
    relative-norm errors over every output, and whether x' (K4's first
    output) equals the plain x' bit for bit."""
    return {"max_abs_err": max(max_err(a, b) for a, b in zip(outs, refs)),
            "scaled_err": max(scaled_err(a, b) for a, b in zip(outs, refs)),
            "rel_err": max(rel_err(a, b) for a, b in zip(outs, refs)),
            "x_bits_equal": len(outs) == 1 or torch.equal(outs[0], refs[0]),
            "dtype": str(dtype).split(".")[-1]}


def check_adaln_errors(name: str, shape, e: dict) -> None:
    """The bars: scaled error ADALN_TOL (bf16, fp16) or FP32_TOL (fp32),
    relative norm ADALN_REL_TOL in bf16 and fp16, x' bit for bit."""
    low = e["dtype"] != "float32"
    tol = ADALN_TOL if low else FP32_TOL
    if not (e["scaled_err"] <= tol and
            (not low or e["rel_err"] <= ADALN_REL_TOL) and e["x_bits_equal"]):
        fail(f"{name} {e['dtype']} {shape} disagrees with its plain version: "
             f"{e}")


def adaln_census(fused_adaln, residual: bool) -> tuple:
    """(launches, launches on the d-1536 kernel) of K4 or K3 so far."""
    if residual:
        return fused_adaln.res_launches, fused_adaln.res_fixed_launches
    return fused_adaln.launches, fused_adaln.fixed_launches


def check_adaln(dev, fused_adaln):
    """K3 and K4 against their plain versions at the serving and training
    shapes in bf16, and at the first in fp16 and fp32; each launch on the
    d-1536 kernel; then at the LiDAR DiT's d-1024 shapes in bf16, each
    launch on the runtime-width kernel. Each bf16 row is timed four ways:
    eager (``ms``, CUDA
    events around 10 queued calls, as the attention kernels), device
    (``device_ms``: the 10 calls replayed from a CUDA graph), cold device
    (``device_ms_cold``: the same over copies of the inputs that together
    exceed twice the L2, so the inputs come from device memory; the bound
    counts device-memory bytes) and host (``host_us``: enqueue cost a
    call)."""
    g = torch.Generator(dev).manual_seed(SEED + 1)
    rows = {"adaln_modulate": [], "residual_adaln_modulate": []}
    cases = [(s, torch.bfloat16) for s in ADALN_SHAPES] + \
        [(ADALN_SHAPES[0], torch.float16), (ADALN_SHAPES[0], torch.float32),
         (MASK_ADALN_FP32_SHAPE, torch.float32)] \
        + [(s, torch.bfloat16)
           for s in LIDAR_ADALN_SHAPES + LIDAR_TRAIN_ADALN_SHAPES]
    for (n, l, d), dtype in cases:
        inputs = adaln_inputs(n, l, d, dtype, dev, g)
        for name in rows:
            residual = name.startswith("residual")
            kernel, plain = adaln_case(fused_adaln, name, *inputs)
            before = adaln_census(fused_adaln, residual)
            outs, refs = kernel(), plain()
            torch.cuda.synchronize()
            launched, fixed = (a - b for a, b in zip(
                adaln_census(fused_adaln, residual), before))
            want = 1 if d == fused_adaln.FIXED_D else 0
            if launched != 1 or fixed != want:
                fail(f"{name} at {(n, l, d)} {dtype} did not run the "
                     f"{'d-1536' if want else 'runtime-width'} kernel")
            if not residual:
                outs, refs = (outs,), (refs,)
            e = adaln_errors(outs, refs, dtype)
            check_adaln_errors(name, (n, l, d), e)
            if dtype != torch.bfloat16:
                log(f"{name} {e['dtype']} ({n},{l},{d}): {json.dumps(e)}")
                continue
            ms, plain_ms = time_pair(kernel, plain)
            device_ms = time_graph_ms([kernel] * 10)
            x, delta = inputs[:2]
            copies = [inputs] + [
                (torch.randn_like(x), torch.randn_like(delta), *inputs[2:])
                for _ in range(cold_copies(x.nbytes * (2 if residual else 1))
                               - 1)]
            cold = [adaln_case(fused_adaln, name, *c)[0] for c in copies]
            device_ms_cold = time_graph_ms(
                [cold[i % len(cold)] for i in range(10)])
            del copies, cold
            host = host_us(kernel)
            bnd = adaln_bound(n, l, d, residual=residual)
            log(f"{name} bf16 ({n},{l},{d}): scaled {e['scaled_err']:.3e} (tol "
                f"{ADALN_TOL}), relative norm {e['rel_err']:.3e} (tol "
                f"{ADALN_REL_TOL:.3e}), x' bits equal {e['x_bits_equal']}; "
                f"eager {ms:.4f} ms, device {device_ms:.4f} ms, cold device "
                f"{device_ms_cold:.4f} ms, host {host:.1f} us a call, bound "
                f"{bnd[0]:.4f} ms; plain {plain_ms:.3f} ms")
            rows[name].append({
                "shape": [n, l, d], **e, "device_ms": device_ms,
                "device_ms_cold": device_ms_cold, "host_us": host,
                **yardsticks(ms, plain_ms, None, bnd)})
            torch.cuda.empty_cache()
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
    mix factors 2 (the config's merge factor), the ImageAdapter's zero
    gates N(0, 1) (its zero convs are weights: N(0, 1/fan_in), not zero),
    the MaskGIT rotary frequencies at their init (π·linspace(1, 5)),
    drawn on the module's device."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("mix_factor"):
                p.fill_(2.0)
            elif name.endswith("rope.freqs"):
                p.copy_(torch.linspace(1.0, 5.0, p.numel()) * torch.pi)
            elif name.endswith("zero_gates"):
                p.normal_(0.0, 1.0, generator=gen)
            elif p.ndim >= 2:
                p.normal_(0.0, p[0].numel() ** -0.5, generator=gen)
            elif name.endswith("weight"):
                p.fill_(1.0)
            else:
                p.zero_()


def layout_rasters(dev, gen) -> dict:
    """Random 3-D box and HD-map rasters of the batch's 6 frames x 6 views
    at the VAE's image size (256 x 448 x 3 each): a quarter of the pixels
    set to uniform values, the rest background."""
    shape = (1, FRAMES, VIEWS, 8 * LAT_H, 8 * LAT_W, 3)

    def raster():
        on = torch.rand(shape, generator=gen, device=dev) < 0.25
        return torch.rand(shape, generator=gen, device=dev) * on

    return {"3dbox_images": raster(), "hdmap_images": raster()}


def check_moves(out_a, out_b, what: str, cause: str) -> float:
    """The relative norm by which ``cause`` moves a denoiser's output;
    fails unless it is finite and above ``RASTER_MIN_MOVE`` (equal outputs:
    the input reached nothing)."""
    move = rel_err(out_a, out_b)
    log(f"{what}: {cause} move the output by {move:.4e} in relative norm "
        f"(gate > {RASTER_MIN_MOVE})")
    if not move > RASTER_MIN_MOVE:  # also fails on NaN
        fail(f"{what}: {cause} do not move the output (relative norm "
             f"{move})")
    return move


def moment_census(optimizer) -> tuple:
    """(bytes, elements) of the AdamW moments (``exp_avg``,
    ``exp_avg_sq``) in ``optimizer``'s state."""
    n_bytes = n_elems = 0
    for state in optimizer.state.values():
        for key in ("exp_avg", "exp_avg_sq"):
            if key in state:
                n_bytes += state[key].numel() * state[key].element_size()
                n_elems += state[key].numel()
    return n_bytes, n_elems


def check_moment_bytes(n_bytes: int, n_elems: int, want: int,
                       what: str) -> None:
    """The optimizer state holds ``want`` bytes a moment element."""
    log(f"{what}: AdamW moments {n_bytes / 1e9:.3f} GB over {n_elems} "
        f"elements ({n_bytes / max(n_elems, 1):g} B an element; want {want})")
    if n_elems == 0 or n_bytes != want * n_elems:
        fail(f"{what}: the moments hold {n_bytes} B for {n_elems} elements, "
             f"not {want} B an element")


def profile_ms(fn) -> float:
    """Device ms of the kernels one call of ``fn`` launches, from
    ``torch.profiler`` (after one unprofiled warm-up call)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as profiler

    fn()
    torch.cuda.synchronize()
    with profiler(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(t for t, _, _ in _device_kernels(prof)) / 1e3


def make_batch(dev, gen, text_tokens: int = TEXT_TOKENS,
               text_dim: int = 4096, pooled_dim: int | None = 2048,
               layout: bool = False) -> dict:
    """One canonical latent-space batch: 6 frames x 6 views, pre-encoded
    text (the DiT's 154 tokens, 4096 wide, pooled 2048 by default) and ring
    cameras; with ``layout``, box and map rasters too."""
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
    if layout:
        batch.update(layout_rasters(dev, gen))
    return {
        **batch,
        "camera_intrinsics": intr,
        "camera_transforms": cam,
        "image_size": torch.tensor([float(w_img), float(h_img)],
                                   device=dev).expand(b, t, v, 2),
        "fps": torch.full((b,), 10.0, device=dev),
    }


def serve_layout_checks(model, common_config: dict, batch: dict,
                        get_conditions, cfg_kwargs: dict, what: str) -> dict:
    """A layout path's adapter at full width: the rasters gate on one
    forward of batch 1 (``check_moves``), then the device ms
    (profiler) of the ImageAdapter at the CFG batch and of the CFG forward
    that runs it."""
    kwargs = {**get_conditions(batch, common_config),
              "sample": cfg_kwargs["sample"][:1],
              "timestep": cfg_kwargs["timestep"][:1]}
    rasters = kwargs["condition_image_tensor"]
    uncond = torch.full_like(rasters, common_config["uncondition_image_color"])
    with torch.inference_mode():
        move = check_moves(
            model(**kwargs),
            model(**{**kwargs, "condition_image_tensor": uncond}), what,
            "the rasters (against the uncondition colour)")
        adapter_ms = profile_ms(lambda: model.condition_image_adapter(
            cfg_kwargs["condition_image_tensor"].to(model.dtype)))
        forward_ms = profile_ms(lambda: model(**cfg_kwargs))
    log(f"{what}: ImageAdapter {adapter_ms:.3f} device ms at the CFG batch "
        f"(rasters {tuple(cfg_kwargs['condition_image_tensor'].shape)}), "
        f"{100 * adapter_ms / forward_ms:.2f}% of the CFG forward's "
        f"{forward_ms:.3f} device ms (profiler)")
    return {"raster_move": move, "adapter_ms": adapter_ms,
            "forward_device_ms": forward_ms}


def run_slice(dev, create_instance_from_config, sd35_vae, ops, get_conditions,
              profile: bool = False, config: Path = CONFIG,
              layout: bool = False, tag: str = "serve"):
    """A CTSD-3.5 DiT serving path at full width: a 2-window rollout with
    CFG, then the SD3.5 VAE decode; with ``layout``, box and map rasters
    through the ImageAdapter (``serve_layout_checks``)."""
    cfg = json.loads(config.read_text())["pipeline"]
    log(f"{tag} cut: inference_steps "
        f"{cfg['inference_config']['inference_steps']} -> {STEPS}")
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
    log(f"{tag} denoiser: {config.relative_to(REPO)}, "
        f"{len(model.transformer_blocks)} joint blocks, width "
        f"{model.inner_dim}, {n_params / 1e9:.3f}B params, {model.dtype}; "
        f"guidance {cfg['inference_config']['guidance_scale']}")

    batch = make_batch(dev, gen, layout=layout)
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
        if profile:
            log(f"DiT CFG forward unprofiled: "
                f"{', '.join(f'{t:.4f}' for t in fwd_s)} s")
            dt, prof = profile_forward(model, dict(
                sample=sample, timestep=timestep, **conds), "DiT CFG forward")
            log(f"K3/K4 in the DiT CFG forward ({dt:.4f} s profiled): "
                f"{json.dumps(adaln_profile_ms(prof))}")
    if out.shape != sample.shape or not torch.isfinite(out).all():
        fail("denoiser forward output is not finite or has the wrong shape")
    del out
    if layout:
        serve_layout_checks(model, pipe.common_config, batch, get_conditions,
                            dict(sample=sample, timestep=timestep, **conds),
                            f"{tag} DiT")
    del sample, conds
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
    log(f"{tag} rollout: {WINDOWS} windows x {STEPS} steps = {forwards} CFG "
        f"forwards, {total_frames} frames x {VIEWS} views, latents "
        f"{want_latents}, {rollout_s:.3f} s ({rollout_s / forwards:.3f} s "
        f"per step)")
    log(f"{tag} decode: frames {want_frames} {frames.dtype}, {decode_s:.3f} "
        f"s; frame range [{frames.min().item():.3f}, "
        f"{frames.max().item():.3f}]")
    log(f"{tag} denoiser forward (CFG batch 2 x {FRAMES * VIEWS} "
        f"view-frames): {forward_s:.4f} s; per generated frame ({VIEWS} "
        f"views, rollout + decode): "
        f"{(rollout_s + decode_s) / total_frames:.4f} s; peak memory "
        f"{peak_gb:.2f} GiB")
    log(f"launches during the {tag} rollout: {json.dumps(counts)}")
    for s in (602, 448, 168):
        if counts["flash_tail_by_seq"].get(s, 0) == 0:
            fail(f"flash_tail never launched at s={s} on the {tag} path")
    k3, k4 = counts["adaln_modulate"], counts["residual_adaln_modulate"]
    log(f"{tag}: K3 {k3} launches ({k3 / forwards:g} a CFG forward), K4 {k4} "
        f"({k4 / forwards:g})")
    if k3 != K3_PER_FORWARD * forwards or k4 != K4_PER_FORWARD * forwards:
        fail(f"K3/K4 launched {k3}/{k4} times in {forwards} CFG forwards, not "
             f"{K3_PER_FORWARD}/{K4_PER_FORWARD} a forward")
    return counts


def run_unet_slice(dev, create_instance_from_config, sd21_vae, ops,
                   get_conditions, profile: bool = False,
                   config: Path = UNET_CONFIG, layout: bool = False,
                   tag: str = "unet"):
    """A CTSD-2.1 UNet serving path at full width: a 2-window rollout
    with DDIM and CFG, then the SD2.1 VAE decode; with ``layout``, box and
    map rasters through the ImageAdapter (``serve_layout_checks``)."""
    cfg = json.loads(config.read_text())["pipeline"]
    ic = cfg["inference_config"]
    log(f"{tag} cut: inference_steps {ic['inference_steps']} -> {STEPS}")
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
    log(f"{tag} denoiser: {config.relative_to(REPO)}, channels "
        f"{mc['block_out_channels']}, heads {mc['num_attention_heads']} x 64, "
        f"rowwise cross-view {mc['enable_rowwise_crossview']}, rowwise "
        f"temporal {mc['enable_rowwise_temporal']}, {n_params / 1e9:.3f}B "
        f"params, {model.dtype}; {type(pipe.test_scheduler).__name__} "
        f"{pipe.test_scheduler.prediction_type}, guidance "
        f"{ic['guidance_scale']}")

    batch = make_batch(dev, gen, UNET_TEXT_TOKENS, UNET_TEXT_DIM, None,
                       layout=layout)
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
            profile_forward(model, dict(sample=sample, timestep=timestep,
                                        **conds), "UNet CFG forward")
    if out.shape != sample.shape or not torch.isfinite(out).all():
        fail("UNet forward output is not finite or has the wrong shape")
    del out
    if layout:
        serve_layout_checks(model, pipe.common_config, batch, get_conditions,
                            dict(sample=sample, timestep=timestep, **conds),
                            f"{tag} UNet")
    del sample, conds
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
        fail(f"{tag} rollout latents {tuple(latents.shape)} not "
             "finite/expected")
    if tuple(frames.shape) != want_frames or not torch.isfinite(frames).all():
        fail(f"{tag} decoded frames {tuple(frames.shape)} not finite/expected")
    forwards = WINDOWS * STEPS
    rollout_s, decode_s = t1 - t0, t2 - t1
    frame_s = (rollout_s + decode_s) / total_frames
    log(f"{tag} rollout: {WINDOWS} windows x {STEPS} steps = {forwards} CFG "
        f"forwards, {total_frames} frames x {VIEWS} views, latents "
        f"{want_latents}, {rollout_s:.3f} s ({rollout_s / forwards:.3f} s "
        f"per step); latent range [{latents.min().item():.3f}, "
        f"{latents.max().item():.3f}]")
    log(f"{tag} decode: frames {want_frames} {frames.dtype}, {decode_s:.3f} "
        f"s; frame range [{frames.min().item():.3f}, "
        f"{frames.max().item():.3f}]")
    log(f"{tag} forward (CFG batch 2 x {FRAMES * VIEWS} view-frames): "
        f"{forward_s:.4f} s; per generated frame ({VIEWS} views, rollout + "
        f"decode): {frame_s:.4f} s; peak memory {peak_gib:.2f} GiB")
    log(f"launches during the {tag} rollout: {json.dumps(counts)}")
    k7_key = f"{2 * FRAMES * VIEWS},{LAT_H * LAT_W},{LAT_H * LAT_W},5,64"
    k7 = counts["flash_attention_by_shape"].get(k7_key, 0)
    log(f"{tag}: K7 at ({k7_key}): {k7} launches, {k7 / forwards:g} per CFG "
        f"forward")
    want = UNET_K7_PER_FORWARD * forwards
    if k7 != want or counts["flash_attention"] != want:
        fail(f"flash_attention launched {counts['flash_attention_by_shape']}"
             f" on the {tag} path, not {want} times at ({k7_key})")
    for s in (336, 448, 168):
        if counts["flash_tail_by_seq"].get(s, 0) == 0:
            fail(f"flash_tail never launched at s={s} on the {tag} path")
    return counts, {"forward_s": forward_s, "frame_s": frame_s,
                    "peak_gib": peak_gib}


def turns_s(fns: dict, kwargs: dict, rounds: int = INT8_TIMED) -> dict:
    """Host seconds of ``rounds`` calls of each ``fns[name](**kwargs)``
    (each ending in a synchronize), in turns whose order alternates (a b,
    b a, ...), after one warm-up call each: the median and the spread."""
    times: dict = {name: [] for name in fns}
    with torch.inference_mode():
        for fn in fns.values():
            fn(**kwargs)
        for r in range(rounds):
            for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fns[name](**kwargs)
                torch.cuda.synchronize()
                times[name].append(time.perf_counter() - t0)
    return {name: median_spread(ts) for name, ts in times.items()}


def int8_census(exp, ops, qmodel, kwargs: dict, want: int, what: str):
    """One forward of the int8 ``qmodel`` under ``exp.Int8Census``: every
    quantized layer ran one ``_int_mm`` and no float GEMM, and the
    ``_int_mm`` launches are the ``want`` layer calls that the
    architecture implies. Returns (the forward's launch counts, the
    census summary)."""
    ops.reset_launch_counts()
    census = exp.Int8Census(qmodel)
    with torch.inference_mode(), census:
        out = qmodel(**kwargs)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    try:
        summary = census.check(want, what)
    except AssertionError as e:
        fail(str(e))
    log(f"{what}: census {json.dumps(summary)}; _int_mm launches "
        f"{counts['int8_mm']} (want {want})")
    if counts["int8_mm"] != want:
        fail(f"{what}: {counts['int8_mm']} _int_mm launches, not the "
             f"{want} quantized layer calls of the architecture")
    if not torch.isfinite(out).all():
        fail(f"{what}: the int8 forward is not finite")
    return counts, summary


def int8_profile(exp, model, kwargs: dict, what: str, quantized: bool):
    """One profiled forward: the device time by family and, for an int8
    model, the int8 GEMM and the quantize/dequantize work as lines of
    their own (``exp.int8_split``)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as profiler

    ranges = exp.int8_ranges(model) if quantized else contextlib.nullcontext()
    with torch.inference_mode(), ranges, profiler(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model(**kwargs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    log(_kernel_time_table(prof, dt, what))
    split = exp.int8_split(prof)
    total = sum(v["ms"] for v in split.values())
    table = sum(t for t, _, _ in _device_kernels(prof)) / 1e3
    log(f"  {what}: the split covers {total:.3f} of the table's {table:.3f} "
        "device ms")
    for key, v in split.items():
        log(f"  {what} {key}: {v['ms']:.3f} device ms in {v['kernels']} "
            f"kernels ({100 * v['ms'] / max(total, 1e-9):.1f}%)")
    return {"wall_s": dt, "device_ms": total, **split}


def int8_mm_exact(dev, ops, shapes) -> list:
    """``int8_mm`` at full width against an exact product: one call at
    each shape of the int8 paths that ``int8_mm`` pads (rows under 17, K
    or N not a multiple of 8) and at the largest one it does not, on random
    int8 operands, equal to the float64 product (exact: each sum of int8
    products here is an integer far below 2^53), taken in row blocks."""
    shapes = {tuple(map(int, key.split(","))) for key in shapes}
    padded = sorted(sh for sh in shapes
                    if sh[0] <= 16 or sh[1] % 8 or sh[2] % 8)
    plain = sorted(set(shapes) - set(padded), key=lambda sh: sh[0] * sh[1] *
                   sh[2])[-1:]
    gen = torch.Generator(dev).manual_seed(SEED)
    rows = []
    for m, k, n in padded + plain:
        a = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                          dtype=torch.int8)
        w = torch.randint(-127, 128, (n, k), generator=gen, device=dev,
                          dtype=torch.int8)
        y = ops.quant.int8_mm(a, w)
        wt = w.double().t()
        equal = tuple(y.shape) == (m, n) and y.dtype == torch.int32 and all(
            torch.equal(y[i:i + 65536].double(), a[i:i + 65536].double() @ wt)
            for i in range(0, m, 65536))
        rows.append({"shape": [m, k, n], "padded": (m, k, n) in padded,
                     "equal": equal})
        if not equal:
            fail(f"int8_mm at ({m}, {k}, {n}) differs from the exact product")
    log(f"int8_mm at the int8 paths' shapes, equal to the exact product: "
        f"{json.dumps(rows)}")
    return rows


def run_int8_slice(dev, sd35_vae, ops, get_conditions, exp):
    """int8 W8A8 serving at full width: phase 5's DiT and phase 7's UNet,
    each quantized on the card by the port's quantizer from its bf16
    weights (``exp_int8_fidelity.build_pair``) and run beside its bf16
    twin; the SD3.5 VAE likewise for the decode."""
    out: dict = {}
    # The DiT: draws in phase 5's order (model, VAE, batch).
    cfg = json.loads(CONFIG.read_text())["pipeline"]
    cfg["inference_config"]["inference_steps"] = STEPS
    gen = torch.Generator(dev).manual_seed(SEED)
    pipe, qpipe = exp.build_pair(cfg, dev, random_init_, gen)
    with torch.device("meta"):
        vae = sd35_vae(dtype=torch.bfloat16)
        qvae = sd35_vae(dtype=torch.bfloat16, quantization="int8")
    vae.to_empty(device=dev)
    random_init_(vae, gen)
    qvae.to_empty(device=dev)
    qvae.load_state_dict(ops.quant.quantize_state_dict(vae.state_dict(),
                                                       qvae))
    model, qmodel = pipe.model.eval(), qpipe.model.eval()
    qpipe.set_vae(qvae.eval())
    n8 = sum(b.numel() for b in qmodel.buffers() if b.dtype == torch.int8)
    log(f"int8 DiT: {n8 / 1e9:.3f}B int8 weights quantized on the card from "
        f"the bf16 ones of {CONFIG.relative_to(REPO)}")
    batch = make_batch(dev, gen)
    latent_shape = (1, FRAMES, VIEWS, LAT_H, LAT_W, 16)
    kwargs = dict(
        sample=torch.randn((2,) + latent_shape[1:], generator=gen,
                           device=dev),
        timestep=torch.full((2, FRAMES, VIEWS), 500.0, device=dev),
        **get_conditions(batch, pipe.common_config,
                         do_classifier_free_guidance=True))
    times = turns_s({"bf16": model, "int8": qmodel}, kwargs)
    log(f"DiT CFG forward (batch 2 x {FRAMES * VIEWS} view-frames), s: "
        f"bf16 {json.dumps(times['bf16'])}, int8 {json.dumps(times['int8'])}"
        f"; int8 / bf16 {times['int8']['median'] / times['bf16']['median']:.3f}")
    counts, census = int8_census(exp, ops, qmodel, kwargs,
                                 exp.dit_int8_calls(cfg["model"]),
                                 "int8 DiT CFG forward")
    k3, k4 = counts["adaln_modulate"], counts["residual_adaln_modulate"]
    if k3 != K3_PER_FORWARD or k4 != K4_PER_FORWARD:
        fail(f"int8 DiT: K3/K4 launched {k3}/{k4} times in a CFG forward, "
             f"not {K3_PER_FORWARD}/{K4_PER_FORWARD}")
    for s in (602, 448, 168):
        if counts["flash_tail_by_seq"].get(s, 0) == 0:
            fail(f"int8 DiT: K1 never launched at s={s} in a CFG forward")
    profiles = {name: int8_profile(exp, m, kwargs, f"DiT {name} CFG forward",
                                   name == "int8")
                for name, m in (("bf16", model), ("int8", qmodel))}

    def before(name):  # the int8 rollout runs last: count it and the decode
        if name == "int8":
            ops.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()

    total_frames = FRAMES + (WINDOWS - 1) * (FRAMES - 1)
    report, lat = exp.run(pipe, qpipe, kwargs, batch, latent_shape,
                          total_frames, SEED, before=before)
    del kwargs
    fwd, roll = report["forward"], report["rollout"]
    log(f"DiT int8 forward fidelity: {json.dumps(fwd)}")
    log(f"rollouts ({WINDOWS} windows x {STEPS} steps), s: "
        f"{json.dumps(report['rollout_s'])}")
    if not fwd["cosine"] >= exp.DIT_COSINE:
        fail(f"int8 DiT forward cosine {fwd['cosine']} < {exp.DIT_COSINE}")
    t0 = time.perf_counter()
    frames = qpipe.decode_latents(lat, chunk_size=INT8_DECODE_CHUNK)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    serve_counts = ops.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        ref_frames = vae.decode_from_scaled(lat, chunk_size=INT8_DECODE_CHUNK)
    torch.cuda.synchronize()
    bf16_decode_s = time.perf_counter() - t0
    dec = exp.forward_fidelity(ref_frames, frames)
    want_frames = (1, total_frames, VIEWS, 8 * LAT_H, 8 * LAT_W, 3)
    if not torch.isfinite(lat).all() or \
            tuple(frames.shape) != want_frames or \
            not torch.isfinite(frames).all():
        fail(f"int8 rollout or decode not finite/expected "
             f"({tuple(frames.shape)})")
    forwards = WINDOWS * STEPS
    chunks = -(-total_frames * VIEWS // INT8_DECODE_CHUNK)
    want = forwards * exp.dit_int8_calls(cfg["model"]) + \
        chunks * exp.vae_decoder_int8_calls(qvae.block_out_channels)
    log(f"int8 decode: frames {want_frames} in chunks of "
        f"{INT8_DECODE_CHUNK}, {decode_s:.3f} s (the bf16 VAE "
        f"{bf16_decode_s:.3f} s); fidelity to the bf16 VAE on the same "
        f"latents {json.dumps(dec)}")
    log(f"int8 rollout fidelity: {json.dumps(roll)}; peak memory (int8 "
        f"rollout + decode, bf16 twin resident) {peak_gib:.2f} GiB")
    log(f"launches during the int8 rollout and decode: "
        f"{json.dumps(serve_counts)}")
    if not dec["cosine"] >= exp.VAE_COSINE:
        fail(f"int8 VAE decode cosine {dec['cosine']} < {exp.VAE_COSINE}")
    k3, k4 = (serve_counts["adaln_modulate"],
              serve_counts["residual_adaln_modulate"])
    if serve_counts["int8_mm"] != want or k3 != K3_PER_FORWARD * forwards \
            or k4 != K4_PER_FORWARD * forwards:
        fail(f"int8 rollout + decode: {serve_counts['int8_mm']} _int_mm "
             f"(want {want}), K3/K4 {k3}/{k4} in {forwards} CFG forwards")
    out["dit"] = {"forward_s": times, **report, "decode": dec,
                  "decode_s": decode_s, "bf16_decode_s": bf16_decode_s,
                  "peak_gib": peak_gib, "census": census,
                  "profiles": profiles}
    del pipe, qpipe, model, qmodel, vae, qvae, lat, frames, ref_frames
    gc.collect()
    torch.cuda.empty_cache()
    log_clocks("before the int8 UNet")

    ucfg = json.loads(UNET_CONFIG.read_text())["pipeline"]
    gen = torch.Generator(dev).manual_seed(SEED)
    upipe, uqpipe = exp.build_pair(ucfg, dev, random_init_, gen)
    umodel, uqmodel = upipe.model.eval(), uqpipe.model.eval()
    batch = make_batch(dev, gen, UNET_TEXT_TOKENS, UNET_TEXT_DIM, None)
    kwargs = dict(
        sample=torch.randn((2, FRAMES, VIEWS, LAT_H, LAT_W, UNET_LAT_C),
                           generator=gen, device=dev),
        timestep=torch.full((2, FRAMES, VIEWS), 500, device=dev),
        **get_conditions(batch, upipe.common_config,
                         do_classifier_free_guidance=True))
    times = turns_s({"bf16": umodel, "int8": uqmodel}, kwargs)
    with torch.inference_mode():
        fwd = exp.forward_fidelity(umodel(**kwargs), uqmodel(**kwargs))
    log(f"UNet CFG forward, s: bf16 {json.dumps(times['bf16'])}, int8 "
        f"{json.dumps(times['int8'])}; int8 / bf16 "
        f"{times['int8']['median'] / times['bf16']['median']:.3f}")
    log(f"UNet int8 forward fidelity: {json.dumps(fwd)}")
    if not fwd["cosine"] >= exp.UNET_COSINE:
        fail(f"int8 UNet forward cosine {fwd['cosine']} < {exp.UNET_COSINE}")
    unet_counts, census = int8_census(exp, ops, uqmodel, kwargs,
                                      exp.unet_int8_calls(ucfg["model"]),
                                      "int8 UNet CFG forward")
    k7_key = f"{2 * FRAMES * VIEWS},{LAT_H * LAT_W},{LAT_H * LAT_W},5,64"
    k7 = unet_counts["flash_attention_by_shape"].get(k7_key, 0)
    if k7 != UNET_K7_PER_FORWARD or \
            unet_counts["flash_attention"] != UNET_K7_PER_FORWARD:
        fail(f"int8 UNet: K7 launched "
             f"{unet_counts['flash_attention_by_shape']} in a CFG forward, "
             f"not {UNET_K7_PER_FORWARD} at ({k7_key})")
    for s in (336, 448, 168):
        if unet_counts["flash_tail_by_seq"].get(s, 0) == 0:
            fail(f"int8 UNet: K1 never launched at s={s} in a CFG forward")
    out["unet"] = {"forward_s": times, "forward": fwd, "census": census}
    out["int8_mm_exact"] = int8_mm_exact(
        dev, ops, {**counts["int8_mm_by_shape"],
                   **serve_counts["int8_mm_by_shape"],
                   **unet_counts["int8_mm_by_shape"]})
    return serve_counts, unet_counts, out


FAMILIES = (  # kernel families of the profiles, matched in order, lowercase
    ("K1/K7 fwd sm90 (CUDA)", ("flash_fwd_sm90",)),
    ("K1/K2 flash_tail (CUDA)", ("flash_tail",)),
    ("K7 flash_attention (CUDA)", ("flash_attention",)),
    ("K3/K4 fused AdaLN (CUDA)", ("adaln",)),
    ("convolution (cuDNN)", ("conv", "fprop", "dgrad", "implicit")),
    ("group norm", ("group_norm", "groupnorm")),
    ("GEMM (cuBLAS)", ("gemm", "nvjet", "cutlass", "sm90_xmma")),
    ("AdamW (fused)", ("adam", "fusedoptimizer")),
    ("foreach (FlatAdamW, clipping)", ("foreach", "multi_tensor")),
    ("reduce (norms, sums)", ("reduce",)),
    ("copy / cat / cast", ("copy", "cat", "memcpy", "memset")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def _device_kernels(prof) -> list:
    """(self device µs, calls, name) of each kernel in ``key_averages``
    (operator entries also carry their kernels' time and are skipped, as
    are annotation ranges on the GPU timeline)."""
    from torch.autograd import DeviceType

    return [(evt.self_device_time_total, evt.count, evt.key)
            for evt in prof.key_averages()
            if getattr(evt, "device_type", None) == DeviceType.CUDA and
            not getattr(evt, "is_user_annotation", False)]


def adaln_profile_ms(prof) -> dict:
    """Device ms and launches of K3 and K4 in a profile: the kernels whose
    names hold ``adaln`` (CUDA: ``adaln_{stream,any}_kernel<T, residual>``),
    K4 those with the residual flag set (or Triton's ``_res_adaln_kernel``)."""
    out = {"K3_ms": 0.0, "K3_launches": 0, "K4_ms": 0.0, "K4_launches": 0}
    for t, n, key in _device_kernels(prof):
        name = key.lower()
        if "adaln" not in name:
            continue
        k = "K4" if ("true>" in name or "_res_" in name) else "K3"
        out[f"{k}_ms"] += t / 1e3
        out[f"{k}_launches"] += n
    return out


def _kernel_time_table(prof, step_s: float, what: str = "train step",
                       steps: int = 1) -> str:
    """Device time of ``steps`` profiled steps (``step_s``: their wall
    time in all) by kernel family (``FAMILIES``), and the top kernels. The
    busy share is the device time over the same steps' wall time, both
    under the profiler."""
    sums: dict = {}
    kernels = _device_kernels(prof)
    for t, _, key in kernels:
        name = key.lower()
        fam = next((f for f, keys in FAMILIES
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


def profile_forward(model, kwargs: dict, what: str):
    """One forward of ``model`` under ``torch.profiler``: logs its device
    time by kernel family and returns (its wall seconds under the profiler,
    the profile)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as profiler

    with profiler(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model(**kwargs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    log(_kernel_time_table(prof, dt, what))
    return dt, prof


def run_train_slice(dev, create_instance_from_config, ops,
                    profile: bool = False, config: Path = CONFIG,
                    sd35_vae=None, tag: str = "train"):
    """``train_step`` of a CTSD-3.5 DiT at full width and depth on a
    synthetic batch of latents; given ``sd35_vae``, the layout path: a
    batch of pixels (``vae_images``) and box/map rasters, encoded by the
    SD3.5 VAE in the step, with ``BM_OPTIMIZER``'s flat AdamW and bf16
    moments."""
    layout = sd35_vae is not None
    cfg = json.loads(config.read_text())["pipeline"]
    cfg["model"]["param_dtype"] = torch.float32
    mc, oc, tc = cfg["model"], cfg["optimizer_config"], cfg["training_config"]
    if layout:
        oc.update(BM_OPTIMIZER)
    moments = oc.get("mu_dtype", "float32") if oc.get("flat") else "float32"
    log(f"{tag}: {config.relative_to(REPO)}; AdamW lr {oc['lr']}, weight "
        f"decay {oc['weight_decay']}, clip {tc['max_norm_for_grad_clip']}, "
        f"flat {bool(oc.get('flat'))}, {moments} moments; remat: joint "
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
    moment_bytes = 2 * torch.finfo(getattr(torch, moments)).bits // 8
    state_bytes = n_params * (8 + moment_bytes)
    log(f"{tag}: {len(model.transformer_blocks)} joint blocks, width "
        f"{model.inner_dim}, {n_params / 1e9:.3f}B params in fp32, compute "
        f"{model.dtype}; reckoned state {state_bytes / 1e9:.1f} GB = "
        f"{state_bytes / 2**30:.1f} GiB (4 B param + 4 B grad + "
        f"{moment_bytes} B AdamW moments)")
    batch = make_batch(dev, gen, layout=layout)
    if layout:
        with torch.device("meta"):
            vae = sd35_vae(dtype=torch.bfloat16)
        vae.to_empty(device=dev)
        random_init_(vae, gen)
        pipe.set_vae(vae.eval().requires_grad_(False))
        batch["vae_images"] = torch.rand(
            1, FRAMES, VIEWS, 8 * LAT_H, 8 * LAT_W, 3, generator=gen,
            device=dev) * 2 - 1
    else:
        batch["latents"] = torch.randn(1, FRAMES, VIEWS, LAT_H, LAT_W, 16,
                                       generator=gen, device=dev)
    counts, metrics = drive_train(dev, pipe, batch, ops, tag, profile)
    check_train_seqs(counts, tag)
    check_moment_bytes(*metrics["moments"], moment_bytes // 2, tag)
    if layout:
        rasters = torch.cat([batch["3dbox_images"], batch["hdmap_images"]],
                            -1)
        with torch.no_grad():
            metrics["encoder_ms"] = profile_ms(
                lambda: pipe.ensure_latents(batch))
            metrics["adapter_ms"] = profile_ms(
                lambda: model.condition_image_adapter(rasters.to(model.dtype)))
        step_ms = 1e3 * metrics["s_per_step"]
        log(f"{tag}: VAE encoder {metrics['encoder_ms']:.3f} device ms for "
            f"{tuple(batch['vae_images'].shape)} images "
            f"({100 * metrics['encoder_ms'] / step_ms:.2f}% of a step's "
            f"{step_ms:.1f} ms wall); ImageAdapter forward "
            f"{metrics['adapter_ms']:.3f} device ms (profiler)")
    return counts, metrics


def check_train_seqs(counts: dict, tag: str) -> None:
    """K1 and the K2 backward launched at the DiT's three sequence lengths
    (602 joint, 448 dual, 168 rowwise cross-view) in a train path's steps."""
    for s in (602, 448, 168):
        if counts["flash_tail_by_seq"].get(s, 0) == 0:
            fail(f"flash_tail never launched at s={s} in the {tag} steps")
        if counts["flash_tail_backward_by_seq"].get(s, 0) == 0:
            fail(f"the K2 backward never launched at s={s} in the {tag} "
                 "steps")


def drive_train(dev, pipe, batch, ops, tag: str, profile: bool = False,
                frames_per_step: int = FRAMES, unit: str = "6-view frames",
                may_stay: tuple = ()):
    """``TRAIN_STEPS`` train steps of ``pipe`` on ``batch`` with an explicit
    generator, steps 2 onward timed; between step 1 and the timed steps, the
    launches by phase on one untimed forward + backward (no update). Fails
    on a non-finite loss or gradient norm, or if fewer than 99% of the
    parameters changed (of those whose names match none of the
    ``may_stay`` patterns); then times the update alone. Returns the launches
    of the timed steps and {s_per_step, peak_gib, update_s, moments:
    ``moment_census`` of the optimizer}."""
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
             or any(re.search(pattern, n) for pattern in may_stay)
             for n, p, h in zip(names, params, heads_before)]
    changed = sum(moved)
    unchanged = [n for n, m in zip(names, moved) if not m]
    s_per_step = sum(r[0] for r in records[1:]) / (len(records) - 1)
    for i, (dt, loss_v, gn) in enumerate(records, 1):
        log(f"{tag} step {i}: {dt:.3f} s, sd_loss {loss_v:.6f}, grad_norm "
            f"{gn:.4f}{' (warm-up)' if i == 1 else ''}")
    log(f"{tag}: {s_per_step:.3f} s per step (steps 2-{TRAIN_STEPS}), "
        f"{frames_per_step / s_per_step:.2f} {unit}/s; peak memory "
        f"{peak_gib:.2f} GiB; parameters changed: {changed} of "
        f"{len(params)} tensors (unchanged: {unchanged[:5]})")
    log(f"launches during the timed {tag} steps: {json.dumps(counts)}")
    if not all(torch.isfinite(torch.tensor(r[1:])).all() for r in records):
        fail(f"a {tag} loss or gradient norm is not finite")
    # A parameter without a gradient and at zero (a bias whose output is
    # dropped) cannot move; all else must.
    if changed < 0.99 * len(params):
        fail(f"only {changed} of {len(params)} parameters changed")

    # The update alone: optimizer.step() between two synchronizes, twice on
    # one more backward's gradients (the timed steps keep theirs overlapped)
    loss, _ = pipe.loss_fn(batch, torch.Generator(dev).manual_seed(SEED + 3))
    loss.backward()
    del loss
    update_s = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state.optimizer.step()
        torch.cuda.synchronize()
        update_s.append(time.perf_counter() - t0)
    for p in params:
        p.grad = None
    log(f"{tag}: the update ({type(state.optimizer).__name__}.step) alone: "
        f"{', '.join(f'{u:.4f}' for u in update_s)} s")

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
    return counts, {"s_per_step": s_per_step, "peak_gib": peak_gib,
                    "update_s": min(update_s),
                    "moments": moment_census(state.optimizer)}


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


# -- the stream phase: prompts → text stage → FIFO streaming → decode ------

def text_init_(module, gen) -> None:
    """Random text-encoder weights in the scales that HF's CLIP and T5
    initializers use (factor 1), drawn on the module's device: CLIP token
    and position embeddings N(0, 0.02²), q/k/v and fc2 N(0, d^-1 / (2
    layers)), out_proj and text_projection N(0, 1/d), fc1 N(0, 1/(2 d));
    T5 embedding N(0, 1), q N(0, 1/(d d_kv)), k/v/wi N(0, 1/d), o N(0,
    1/(heads d_kv)), wo N(0, 1/d_ff), the relative bias N(0, 1/d); norm
    scales 1, biases 0."""
    t5 = hasattr(module, "shared")
    d = module.shared.weight.shape[1] if t5 else \
        module.token_embedding.weight.shape[1]
    layers = len(module.block if t5 else module.layers)
    d_kv = module.block[0].attention.kv_dim if t5 else None
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.split(".")[-2] if name.endswith(
                ("weight", "bias")) else name.split(".")[-1]
            if name.endswith("bias") or (p.ndim == 1 and "norm" in name) or \
                    name.endswith(("ln_attn.weight", "ln_ff.weight")):
                p.fill_(0.0 if name.endswith("bias") else 1.0)
                continue
            fan_in = p.shape[1] if p.ndim == 2 else d
            if t5:
                std = {"shared": 1.0, "q": (d * d_kv) ** -0.5,
                       "o": fan_in ** -0.5, "wo": fan_in ** -0.5,
                       "relative_attention_bias": d ** -0.5}.get(
                           leaf, d ** -0.5)
            else:
                std = {"token_embedding": 0.02, "position_embedding": 0.02,
                       "out_proj": d ** -0.5, "text_projection": d ** -0.5,
                       "fc1": (2 * d) ** -0.5}.get(
                           leaf, d ** -0.5 * (2 * layers) ** -0.5)
            p.normal_(0.0, std, generator=gen)


def text_encoders(dev, dtype) -> dict:
    """CLIP-L, CLIP-G and T5-XXL (``TEXT_ENCODERS``) at full width,
    parameters and compute in ``dtype``, built on ``dev`` without weights
    (``to_empty``)."""
    from opendwm_tpu_torch.models import text_encoders as te

    with torch.device("meta"):
        built = {"clip_l": te.CLIPTextEncoder(**TEXT_ENCODERS["clip_l"],
                                              dtype=dtype),
                 "clip_g": te.CLIPTextEncoder(**TEXT_ENCODERS["clip_g"],
                                              dtype=dtype),
                 "t5": te.T5TextEncoder(**TEXT_ENCODERS["t5"], dtype=dtype)}
    return {k: m.to_empty(device=dev).eval() for k, m in built.items()}


def text_stage(encoders: dict, t5_max_length: int = 77):
    """The SD3 text stage over ``encoders`` (its context as wide as the
    T5's), with the in-repo
    ``WhitespaceTokenizer`` laid out on CLIP's ids (bos 49406, eos 49407)
    and T5's (pad 0, eos 1)."""
    from opendwm_tpu_torch.models.text_stage import (
        SD3TextStage,
        WhitespaceTokenizer,
    )

    clip_tok = WhitespaceTokenizer(vocab_size=49406, bos=49406, eos=49407,
                                   pad=49407)
    t5_tok = WhitespaceTokenizer(vocab_size=32100, bos=0, eos=1, pad=0)
    return SD3TextStage(encoders["clip_l"], clip_tok, encoders["clip_g"],
                        clip_tok, t5=encoders["t5"], t5_tokenizer=t5_tok,
                        clip_max_length=77, t5_max_length=t5_max_length,
                        caption_dim=encoders["t5"].shared.weight.shape[1])


def prompts(tick: int) -> list:
    """Six prompts a frame, one a view; the scene changes every
    ``TEXT_INTERVAL`` frames."""
    scene = STREAM_SCENES[(tick // TEXT_INTERVAL) % len(STREAM_SCENES)]
    return [f"{scene}, seen from the {view} camera" for view in STREAM_VIEWS]


def check_text_bar(errs: dict, tol: float = TEXT_REL_TOL) -> None:
    """The bf16 text stage within ``tol`` in relative norm of the fp32 one
    on every output (a NaN fails too)."""
    log(f"text stage, bf16 against fp32, relative norm: "
        f"{json.dumps(errs)} (bar {tol})")
    bad = {k: e for k, e in errs.items() if not e <= tol}
    if bad:
        fail(f"the bf16 text stage is off its fp32 twin: {bad}")


def check_ready_schedule(readies: list, window: int) -> None:
    """``ready`` is False for the ticks that fill the window and True
    from the window-th tick on."""
    want = [i + 1 >= window for i in range(len(readies))]
    if readies != want:
        fail(f"ready by tick {readies}, not {want}")


def check_stream_census(counts: dict, forwards: int) -> None:
    """The stream path launched K1 at s = 602, 448 and 168, K3 and K4
    ``K3_PER_FORWARD`` and ``K4_PER_FORWARD`` times a forward, and neither
    K7 nor K7-seg (the text encoders' biased attention stays plain)."""
    for s in (602, 448, 168):
        if counts["flash_tail_by_seq"].get(s, 0) == 0:
            fail(f"flash_tail never launched at s={s} on the stream path")
    k3, k4 = counts["adaln_modulate"], counts["residual_adaln_modulate"]
    if k3 != K3_PER_FORWARD * forwards or k4 != K4_PER_FORWARD * forwards:
        fail(f"K3/K4 launched {k3}/{k4} times in {forwards} forwards on the "
             f"stream path, not {K3_PER_FORWARD}/{K4_PER_FORWARD} a forward")
    k7 = counts["flash_attention"] + counts["flash_attention_segment"]
    if k7:
        fail(f"K7 launched {k7} times on the stream path")


def busy_share(prof, wall_s: float) -> tuple:
    """(device ms, device ms / wall) of a profile over ``wall_s``."""
    device_ms = sum(t for t, _, _ in _device_kernels(prof)) / 1e3
    return device_ms, device_ms / (1e3 * wall_s)


def median_spread(values) -> dict:
    ordered = sorted(values)
    return {"median": ordered[len(ordered) // 2], "min": ordered[0],
            "max": ordered[-1], "n": len(ordered)}


def run_text_phase(dev, profile: bool = False):
    """The text stage at full width: fp32 encoders drawn from ``SEED``, the
    same weights in bf16 held to them (``check_text_bar``); one refresh
    (the cond and uncond encodes of a frame's 6 prompts) timed
    ``TEXT_REPS`` times. Returns (the bf16 stage, refresh ms)."""
    gen = torch.Generator(dev).manual_seed(SEED)
    enc32 = text_encoders(dev, torch.float32)
    for m in enc32.values():
        text_init_(m, gen)
    sizes = {k: sum(p.numel() for p in m.parameters()) / 1e9
             for k, m in enc32.items()}
    batch = {"image_description": [[prompts(0)]]}
    ref = text_stage(enc32)(batch)
    enc = text_encoders(dev, torch.bfloat16)
    for k, m in enc.items():
        m.load_state_dict(enc32[k].state_dict())
    del enc32
    gc.collect()
    torch.cuda.empty_cache()
    stage = text_stage(enc)
    out = stage(batch)
    keys = ("encoder_hidden_states", "pooled_projections",
            "uncond_encoder_hidden_states", "uncond_pooled_projections")
    for k in keys:
        if not torch.isfinite(out[k]).all():
            fail(f"text stage {k} is not finite")
    log(f"text stage: CLIP-L {sizes['clip_l']:.3f}B, CLIP-G "
        f"{sizes['clip_g']:.3f}B, T5-XXL {sizes['t5']:.3f}B params, bf16; "
        f"{json.dumps({k: list(out[k].shape) for k in keys})}")
    check_text_bar({k: rel_err(out[k], ref[k]) for k in keys})
    del ref
    walls = []
    for _ in range(TEXT_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stage(batch)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    refresh = median_spread(walls)
    log(f"text refresh (cond + uncond, {VIEWS} prompts; 77 CLIP + 77 T5 "
        f"tokens): {refresh['median']:.2f} ms median of {TEXT_REPS} "
        f"({refresh['min']:.2f}-{refresh['max']:.2f})")
    if profile:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as profiler

        with profiler(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stage(batch)
            torch.cuda.synchronize()
        log(_kernel_time_table(prof, time.perf_counter() - t0,
                               "text refresh"))
    return stage, refresh


def stream_frame(text: dict, cams: dict) -> dict:
    """One frame's batch: the text stage's outputs and the single-frame
    camera and fps fields."""
    keys = ("encoder_hidden_states", "pooled_projections",
            "uncond_encoder_hidden_states", "uncond_pooled_projections")
    return {**{k: text[k] for k in keys}, **cams}


def run_stream_slice(dev, create_instance_from_config, sd35_vae, ops,
                     get_conditions, profile: bool = False):
    """Streaming serving at full width: prompts through the text stage
    (``run_text_phase``) into frame conditions; the FIFO streaming
    pipeline on the nwao DiT at ``bench.py``'s streaming settings
    (``STREAM_STEPS`` steps over the 6-frame window, sequential CFG
    ``STREAM_GUIDANCE``); each emitted frame through the SD3.5 VAE decode
    and the streaming CLI's PNG writer. The text refreshes every
    ``TEXT_INTERVAL`` frames (the pipeline holds it in between)."""
    from opendwm_tpu_torch.streaming import PNGWriter, frame_to_image

    stage, refresh = run_text_phase(dev, profile)
    cfg = json.loads(CONFIG.read_text())["pipeline"]
    cfg["_class_name"] = "StreamingCTSDPipeline"
    cfg["inference_config"] = {
        "inference_steps": STREAM_STEPS, "guidance_scale": STREAM_GUIDANCE,
        "sequential_cfg": True, "text_prompt_interval": TEXT_INTERVAL}
    with torch.device("meta"):
        pipe = create_instance_from_config(cfg)
        vae = sd35_vae(dtype=torch.bfloat16)
    gen = torch.Generator(dev).manual_seed(SEED)
    for module in (pipe.model, vae):
        module.to_empty(device=dev)
        random_init_(module, gen)
        module.eval()
    pipe.set_vae(vae)
    spi = pipe.steps_per_inference(FRAMES)
    log(f"stream: {CONFIG.relative_to(REPO)} as StreamingCTSDPipeline, "
        f"{json.dumps(cfg['inference_config'])}: {spi} steps a tick, "
        f"{2 * spi} batch-1 DiT forwards (sequential CFG) + the decode of "
        f"{VIEWS} views")

    full = make_batch(dev, gen, text_tokens=1, pooled_dim=None)
    cams = {k: full[k][:, :1] for k in ("camera_intrinsics",
                                        "camera_transforms", "image_size")}
    cams["fps"] = full["fps"]
    text = stage({"image_description": [[prompts(0)]]})
    template = {k: torch.cat([v] * FRAMES, 1) if v.ndim >= 2 else v
                for k, v in get_conditions(stream_frame(text, cams),
                                           pipe.common_config).items()}
    latent_shape = (1, FRAMES, VIEWS, LAT_H, LAT_W, 16)
    state = pipe.reset_streaming(latent_shape, template, gen)
    writer = PNGWriter(str(REPO / "build" / "stream_frames"))

    def tick(i, state, text):
        refreshed = i % TEXT_INTERVAL == 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if refreshed:
            text = stage({"image_description": [[prompts(i)]]})
        state = pipe.send_frame_condition(state, stream_frame(text, cams))
        state, latent, ready = pipe.receive_frame(state)
        frame = pipe.decode_latents(latent) if ready else None
        torch.cuda.synchronize()
        return state, text, frame, ready, refreshed, time.perf_counter() - t0

    n_ticks = FRAMES + STREAM_TIMED
    readies, walls, write_s = [], [], []
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    for i in range(n_ticks):
        state, text, frame, ready, refreshed, dt = tick(i, state, text)
        readies.append(ready)
        walls.append((dt, refreshed))
        if ready:
            want = (1, VIEWS, 8 * LAT_H, 8 * LAT_W, 3)
            if tuple(frame.shape) != want or not torch.isfinite(frame).all():
                fail(f"emitted frame {tuple(frame.shape)} is not finite or "
                     f"not {want}")
            t0 = time.perf_counter()
            writer.write(frame_to_image(frame[0]))
            write_s.append(time.perf_counter() - t0)
        log(f"stream tick {i}: {1e3 * dt:.1f} ms, ready {ready}"
            f"{', text refreshed' if refreshed else ''}")
    counts = ops.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check_ready_schedule(readies, FRAMES)
    forwards = n_ticks * 2 * spi
    check_stream_census(counts, forwards)

    steady = median_spread([1e3 * w for w, r in walls[FRAMES:] if not r])
    if steady["n"] < 5:
        fail(f"only {steady['n']} steady ticks were timed")
    amortised = steady["median"] + refresh["median"] / TEXT_INTERVAL
    log(f"stream: {steady['median']:.1f} ms a frame in steady state, median "
        f"of {steady['n']} ticks ({steady['min']:.1f}-{steady['max']:.1f}); "
        f"{amortised:.1f} ms with the text refreshed every {TEXT_INTERVAL} "
        f"frames (+{refresh['median']:.1f} / {TEXT_INTERVAL}); peak memory "
        f"{peak_gib:.2f} GiB (text encoders, DiT, VAE); PNG writer "
        f"{1e3 * min(write_s):.1f}-{1e3 * max(write_s):.1f} ms a frame "
        f"(host, outside the tick)")
    log(f"launches on the stream path ({n_ticks} ticks, {forwards} DiT "
        f"forwards): K1 by seq {json.dumps(counts['flash_tail_by_seq'])}, "
        f"K3 by shape {json.dumps(counts['adaln_modulate_by_shape'])}, K4 by "
        f"shape {json.dumps(counts['residual_adaln_modulate_by_shape'])}")

    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as profiler

    n_prof = 3 if profile else 1
    with profiler(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        prof_s = 0.0
        for i in range(n_ticks, n_ticks + n_prof):
            state, text, _, _, _, dt = tick(i, state, text)
            prof_s += dt
    device_ms, busy = busy_share(prof, prof_s)
    log(f"stream tick under the profiler: wall {1e3 * prof_s / n_prof:.1f} "
        f"ms, device {device_ms / n_prof:.1f} ms, busy {100 * busy:.1f}%")
    log(_kernel_time_table(prof, prof_s, "stream tick", n_prof))
    return counts, {"steady_ms": steady, "amortised_ms": amortised,
                    "refresh_ms": refresh, "peak_gib": peak_gib,
                    "busy": busy}


def check_tiny_text(dev) -> None:
    """A tiny CLIP (both pooling rules) and T5 on the card against the CPU
    (fp32), and no attention kernel launched by them."""
    from opendwm_tpu_torch.models import text_encoders as te
    from opendwm_tpu_torch.ops import flash_attention, flash_tail

    torch.manual_seed(SEED)
    g = torch.Generator().manual_seed(SEED)
    ids = torch.randint(3, 90, (3, 20), generator=g)
    ids[:, 12] = 97
    models = [te.CLIPTextEncoder(vocab_size=99, hidden_size=32,
                                 num_layers=2, num_heads=4, act=act,
                                 eos_token_id=eos, projection_dim=16)
              for act, eos in (("quick_gelu", 2), ("gelu", 97))]
    models.append(te.T5TextEncoder(vocab_size=99, d_model=32, d_kv=8,
                                   d_ff=48, num_layers=2, num_heads=4))
    def parts(out):  # T5's output, or CLIP's last state and pooled
        return [out] if isinstance(out, torch.Tensor) else list(out[:2])

    flash_attention.reset_launches()
    flash_tail.reset_launches()
    errs = []
    with torch.no_grad():
        for m in models:
            ref = parts(m.eval()(ids))
            out = parts(m.to(dev)(ids.to(dev)))
            errs += [max_err(o.cpu(), r) for o, r in zip(out, ref)]
    launched = flash_attention.launches + flash_tail.launches
    log(f"tiny CLIPs and T5, the card vs the CPU (fp32): max_abs_err "
        f"{max(errs):.3e} (tol {TINY_TOL}); attention kernel launches "
        f"{launched}")
    if not max(errs) <= TINY_TOL:
        fail(f"tiny text encoders disagree: {errs}")
    if launched:
        fail(f"the text encoders launched an attention kernel {launched} "
             "times")


def check_tiny_stream(dev, DiTCrossviewTemporal, StreamingCTSDPipeline,
                      flash_tail) -> None:
    """A tiny streaming pipeline (a 2-layer DiT with an ImageAdapter, 3
    frames, 2 views, 6 steps) on the card against the CPU with the same
    weights, frames and tail noise, 4 ticks in each CFG form (fp32)."""
    from opendwm_tpu_torch.schedulers import FlowMatchEulerScheduler

    b, t, v, h, w, c, lt = 1, 3, 2, 16, 24, 16, 40
    g = torch.Generator().manual_seed(SEED)
    model = DiTCrossviewTemporal(**TINY_STREAM_DIT).eval()
    random_init_(model, g)
    card_model = copy.deepcopy(model).to(dev)
    frames = [{"encoder_hidden_states": torch.randn(b, 1, v, lt, 24,
                                                    generator=g),
               "pooled_projections": torch.randn(b, 1, v, 16, generator=g),
               "uncond_encoder_hidden_states": torch.randn(
                   b, 1, v, lt, 24, generator=g),
               "3dbox_images": torch.rand(b, 1, v, 2 * h, 2 * w, 3,
                                          generator=g),
               "hdmap_images": torch.rand(b, 1, v, 2 * h, 2 * w, 3,
                                          generator=g)}
              for _ in range(4)]
    noise = [torch.randn(b, t, v, h, w, c, generator=g)] + [
        torch.randn(b, 1, v, h, w, c, generator=g) for _ in range(4)]
    template = {"encoder_hidden_states": torch.zeros(b, t, v, lt, 24),
                "pooled_projections": torch.zeros(b, t, v, 16),
                "condition_image_tensor": torch.zeros(b, t, v, 2 * h, 2 * w,
                                                      6)}
    errs = {}
    for sequential in (False, True):
        outs = []
        for m, d in ((model, torch.device("cpu")), (card_model, dev)):
            pipe = StreamingCTSDPipeline(
                model=m, train_scheduler=FlowMatchEulerScheduler(),
                test_scheduler=FlowMatchEulerScheduler(),
                common_config={"uncondition_image_color": 0.25},
                inference_config={"inference_steps": 6,
                                  "guidance_scale": 2.0,
                                  "sequential_cfg": sequential,
                                  "text_prompt_interval": 2})
            state = pipe.reset_streaming(
                (b, t, v, h, w, c), _to(template, d), noise=noise[0])
            flash_tail.reset_launches()
            ticks = []
            for fb, fresh in zip(frames, noise[1:]):
                state = pipe.send_frame_condition(state, _to(fb, d))
                state, out, ready = pipe.receive_frame(state, fresh)
                ticks.append((out.cpu(), ready))
            outs.append(ticks)
        k1 = flash_tail.launches
        if [r for _, r in outs[0]] != [r for _, r in outs[1]]:
            fail("tiny stream: ready differs between the card and the CPU")
        form = "sequential" if sequential else "batched"
        errs[form] = max(max_err(a, b_) for (a, _), (b_, _) in
                         zip(outs[1], outs[0]))
        if k1 == 0:
            fail(f"tiny stream ({form} CFG) launched no K1 on the card")
    log(f"tiny stream, 4 ticks, the card vs the CPU (fp32): max_abs_err "
        f"{json.dumps(errs)} (tol {TINY_TOL})")
    if not all(e <= TINY_TOL for e in errs.values()):
        fail(f"tiny stream disagrees: {errs}")


# -- LiDAR serving ------------------------------------------------------------

def lidar_batch(dev, gen, frames: int, b: int = 1, voxelizer=None,
                masked: int = 0, rasters: bool = True) -> dict:
    """``bench.py``'s LiDAR geometry (``:276-288``): ``b`` x ``frames``
    frames of ``LIDAR_POINTS`` points uniform in [-50, 50]³ (or in
    ``voxelizer``'s box), all valid but the last ``masked`` of a frame
    (masked and zeroed: padding); with ``rasters``, random
    ``LIDAR_RASTER``² x 3 box and map BEV rasters a frame (b·frames, H,
    W, 3; a quarter of the pixels uniform, the rest 0), so that the rasters
    move the output."""
    if voxelizer is None:
        lo = torch.full((3,), -50.0, device=dev)
        hi = torch.full((3,), 50.0, device=dev)
    else:
        v = voxelizer
        lo = torch.tensor([v.x_min, v.y_min, v.z_min], device=dev)
        hi = torch.tensor([v.x_max, v.y_max, v.z_max], device=dev)
    pts = lo + torch.rand(b, frames, LIDAR_POINTS, 3, generator=gen,
                          device=dev) * (hi - lo)
    mask = torch.ones(b, frames, LIDAR_POINTS, dtype=torch.bool, device=dev)
    if masked:
        mask[..., -masked:] = False
        pts[..., -masked:, :] = 0.0
    batch = {"lidar_points": pts, "lidar_points_mask": mask}
    if rasters:
        shape = (b * frames, LIDAR_RASTER, LIDAR_RASTER, 3)
        for key in ("3dbox_bev_images", "hdmap_bev_images"):
            on = torch.rand(shape, generator=gen, device=dev) < 0.25
            batch[key] = torch.rand(shape, generator=gen, device=dev) * on
    return batch


def build_lidar(create_instance_from_config, config: Path, dev,
                parts: tuple, bf16: tuple = (), fp32_masters: bool = False):
    """The pipeline of ``config`` at full width with ``bf16``'s modules in
    bf16 compute (and with ``fp32_masters`` its ``model`` built with fp32
    parameters, to train), its ``parts`` drawn on the card from ``SEED``,
    in eval mode."""
    cfg = json.loads(config.read_text())["pipeline"]
    for part in bf16:
        node = cfg
        for key in part:
            node = node[key]
        node["dtype"] = {"_class_name": "get_class",
                         "class_name": "torch.bfloat16"}
    if fp32_masters:
        cfg["model"]["param_dtype"] = torch.float32
    with torch.device("meta"):
        pipe = create_instance_from_config(cfg)
    gen = torch.Generator(dev).manual_seed(SEED)
    for part in parts:
        module = getattr(pipe, part)
        module.to_empty(device=dev)
        random_init_(module, gen)
        module.eval()
        n = sum(p.numel() for p in module.parameters())
        log(f"  {config.name} {part}: {type(module).__name__}, "
            f"{n / 1e6:.2f}M params")
    return pipe, gen


def check_lidar_tiny_gaps(gaps: dict, what: str) -> None:
    """A tiny LiDAR path on the card against the CPU
    (``perf/lidar_tiny.py``): every relative norm (``*_rel``) within
    ``LIDAR_TINY_TOL``, every ``*_equal`` bit for bit, every code score gap
    (``*_gap``) within the tie tolerance, every code index set; the
    voxelizer's boundary points able to see a reciprocal product; the
    MaskGIT paths launch no kernel, the DiT's reaches K1."""
    from opendwm_tpu_torch.perf.lidar_tiny import TIE_TOL

    log(f"tiny {what} on the card vs the CPU: {json.dumps(gaps)}")
    bad = {k: v for k, v in gaps.items()
           if (k.endswith("_rel") and not v <= LIDAR_TINY_TOL)
           or (k.endswith("_equal") and v is not True)
           or (k.endswith("_gap") and not v <= TIE_TOL)}
    if bad or not gaps.get("pipeline_ids_nonnegative", True) or \
            gaps.get("boundary_reciprocal_flips", 1) == 0:
        fail(f"tiny {what}: the card disagrees with the CPU: {gaps}")
    if gaps.get("kernel_launches", 0) or gaps.get("dit_k1_launches", 1) == 0:
        fail(f"tiny {what}: wrong kernel launches: {gaps}")


def check_nearest(gaps: dict, what: str) -> None:
    """The quantizer's code search at full width (``lidar_tiny.
    nearest_gaps``): cut into more than one chunk, and every chosen code
    the best by float64 scores, the chunked and the unchunked call apart
    only at ties."""
    from opendwm_tpu_torch.perf.lidar_tiny import TIE_TOL

    log(f"{what}: the code search in chunks: {json.dumps(gaps)}")
    if gaps["chunks"] < 2 or not gaps["chunk_flip_gap"] <= TIE_TOL or \
            not gaps["shortfall_gap"] <= TIE_TOL:
        fail(f"{what}: the code search is not exact up to ties: {gaps}")


def check_lidar_outputs(voxels: dict, indices, what: str) -> None:
    """Every code index set (≥ 0) and every voxel grid binary."""
    if indices is not None and not bool((indices >= 0).all()):
        fail(f"{what}: a code index stayed masked")
    for name, v in voxels.items():
        values = set(torch.unique(v).tolist())
        if not values <= {0.0, 1.0}:
            fail(f"{what}: {name} is not binary: {sorted(values)[:5]}")


@contextlib.contextmanager
def ranged(module, attr: str, name: str):
    """``module.attr`` (a function) runs inside a profiler range ``name``."""
    fn = getattr(module, attr)

    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)

    setattr(module, attr, wrapped)
    try:
        yield
    finally:
        setattr(module, attr, fn)


def profiled(fn, what: str, ranges=()):
    """One call of ``fn`` under ``torch.profiler`` (after the caller's
    warm-up), with each ``(module, attr, name)`` of ``ranges`` in its own
    range: logs the device time by family and each range's device ms and
    share; returns {wall_s, device_ms, busy, ranges}."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as profiler

    with contextlib.ExitStack() as stack:
        for module, attr, name in ranges:
            stack.enter_context(ranged(module, attr, name))
        with profiler(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    log(_kernel_time_table(prof, wall, what))
    device_ms, busy = busy_share(prof, wall)
    out = {"wall_s": wall, "device_ms": device_ms, "busy": busy,
           "ranges": {}}
    for _, _, name in ranges:
        ms, n = range_device_ms(prof, name)
        out["ranges"][name] = {"ms": ms, "kernels": n,
                               "share": ms / device_ms if device_ms else 0.0}
        log(f"{what}: {name} {ms:.3f} device ms in {n} kernels, "
            f"{100 * ms / max(device_ms, 1e-9):.2f}% of {device_ms:.3f}")
    return out


def sync_s(fn):
    """(fn(), host seconds of the call, ending in a synchronize)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def maskgit_split(pipe, batch, gen) -> dict:
    """One generation timed part by part, as ``inference_pipeline`` runs
    it: voxelize, encode + quantize, the ``MASKGIT_STEPS`` steps, decode
    (the predicted and the VQ voxels, each binarised)."""
    from opendwm_tpu_torch.pipelines.lidar_maskgit import (
        get_maskgit_conditions,
        gumbel_sigmoid,
    )

    vq = pipe.vq
    with torch.inference_mode():
        vox, t_vox = sync_s(lambda: vq.voxelizer(
            batch["lidar_points"], batch["lidar_points_mask"]))
        (code, _, idx), t_enc = sync_s(lambda: vq.vector_quantizer(
            vq.lidar_encoder(vox.reshape(-1, *vox.shape[2:]))))
        ctx = get_maskgit_conditions(batch, do_classifier_free_guidance=True)
        init = torch.full(idx.reshape(code.shape[0], -1).shape, -1,
                          device=code.device)
        (x, ids), t_steps = sync_s(lambda: pipe._iterative_decode(
            code.dtype, init, ctx, 1, 1, gen))
        _, t_dec = sync_s(lambda: (
            gumbel_sigmoid(vq.lidar_decoder(x)[1],
                           generator=gen),
            gumbel_sigmoid(vq.lidar_decoder(code)[1],
                           generator=gen)))
    if not bool((ids >= 0).all()):
        fail("lidar_maskgit: the split run left a code index masked")
    return {"voxelize_s": t_vox, "encode_quantize_s": t_enc,
            "steps_s": t_steps, "decode_s": t_dec}


def run_lidar_maskgit(dev, create_instance_from_config, ops):
    """MaskGIT generation at full width (``LIDAR_MASKGIT_CONFIG`` in bf16
    compute): the rasters gate, ``MASKGIT_TIMED`` generations timed
    (median and spread), one split by part, one profiled."""
    from opendwm_tpu_torch.perf import lidar_tiny
    from opendwm_tpu_torch.pipelines.lidar_maskgit import (
        get_maskgit_conditions,
    )

    check_lidar_tiny_gaps(lidar_tiny.maskgit_gaps(dev, temporal=False),
                          "MaskGIT")
    pipe, gen = build_lidar(
        create_instance_from_config, LIDAR_MASKGIT_CONFIG, dev,
        ("vq", "model"), bf16=(("vq_point_cloud", "lidar_encoder"),
                               ("vq_point_cloud", "lidar_decoder"),
                               ("bi_directional_transformer",)))
    pipe.blank_code = LIDAR_BLANK_CODE
    pipe.inference_config["sample_steps"] = MASKGIT_STEPS
    batch = lidar_batch(dev, gen, 1)
    with torch.inference_mode():
        _, code, idx = pipe.tokenize(batch["lidar_points"],
                                     batch["lidar_points_mask"])
        ids = idx.clone()
        ids[:, ::2] = -1
        ctx = get_maskgit_conditions(batch)
        kw = dict(batch_size=1, num_frames=1)
        logits = pipe.model(code, ids, ctx, **kw)
        if not bool(torch.isfinite(logits).all()):
            fail("lidar_maskgit: the logits are not finite")
        move = check_moves(
            logits, pipe.model(code, ids, torch.zeros_like(ctx), **kw),
            "lidar_maskgit logits", "the rasters (against zeros)")
    del logits, code
    pipe.inference_pipeline(batch, generator=gen)  # warm-up

    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(MASKGIT_TIMED):
        out, dt = sync_s(lambda: pipe.inference_pipeline(batch,
                                                         generator=gen))
        times.append(dt)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_lidar_outputs({k: out[k] for k in ("pred_voxels", "vq_voxels")},
                        out["pred_indices"], "lidar_maskgit")
    split = maskgit_split(pipe, batch, gen)
    prof = profiled(lambda: pipe.inference_pipeline(batch, generator=gen),
                    "LiDAR MaskGIT generation (1 frame, 20 steps, CFG)")
    spread = median_spread(times)
    log(f"lidar_maskgit: s per generated frame {json.dumps(spread)}; "
        f"split {json.dumps(split)}; peak {peak:.2f} GiB; busy "
        f"{100 * prof['busy']:.1f}%; rasters move the logits by {move:.4e}; "
        f"voxels occupied {float(out['pred_voxels'].float().mean()):.4f}; "
        f"launches {json.dumps(counts)}")
    return counts, {"s_per_frame": spread, "split": split, "peak_gib": peak,
                    "busy": prof["busy"], "device_ms": prof["device_ms"]}


def run_lidar_rollout(dev, create_instance_from_config, ops):
    """The temporal vq80k MaskGIT's autoregressive rollout at full width:
    ``ROLLOUT_FRAMES`` frames, ``ROLLOUT_REF`` reference frames, windows of
    ``ROLLOUT_WINDOW``; one step profiled at the window's shape first."""
    from opendwm_tpu_torch.perf import lidar_tiny
    from opendwm_tpu_torch.pipelines import lidar_maskgit

    check_lidar_tiny_gaps(lidar_tiny.maskgit_gaps(dev, temporal=True),
                          "temporal MaskGIT")
    pipe, gen = build_lidar(
        create_instance_from_config, LIDAR_ROLLOUT_CONFIG, dev,
        ("vq", "model"), bf16=(("vq_point_cloud", "lidar_encoder"),
                               ("vq_point_cloud", "lidar_decoder"),
                               ("bi_directional_transformer",)))
    pipe.blank_code = LIDAR_BLANK_CODE
    batch = lidar_batch(dev, gen, ROLLOUT_FRAMES)
    tw, ref = ROLLOUT_WINDOW, ROLLOUT_REF
    window = {k: v[:, :tw] if k.startswith("lidar") else v[:tw]
              for k, v in batch.items()}
    with torch.inference_mode():
        _, _, idx = pipe.tokenize(window["lidar_points"],
                                  window["lidar_points_mask"])
        init = idx.clone()
        init[ref:] = -1
        ctx = lidar_maskgit.get_maskgit_conditions(
            window, do_classifier_free_guidance=True)
    pipe.inference_config["sample_steps"] = 1

    def one_step():
        with torch.inference_mode():
            pipe._iterative_decode(torch.float32, init, ctx, 1, tw, gen)

    one_step()  # warm-up
    step = profiled(one_step, "LiDAR MaskGIT rollout step (8 frames, CFG)",
                    ranges=((lidar_maskgit, "sample_tokens",
                             "sample_tokens"),))
    pipe.inference_config["sample_steps"] = MASKGIT_STEPS
    del ctx, init

    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    out, dt = sync_s(lambda: pipe.autoregressive_inference_pipeline(
        batch, generator=gen, num_reference_frame=ref, window_frames=tw))
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_lidar_outputs({"pred_voxels": out["pred_voxels"]},
                        out["pred_indices"], "lidar_maskgit_rollout")
    want = (1, ROLLOUT_FRAMES, pipe.vq.voxelizer.depth, LIDAR_RASTER,
            LIDAR_RASTER)
    if tuple(out["pred_voxels"].shape) != want:
        fail(f"rollout voxels {tuple(out['pred_voxels'].shape)} != {want}")
    if not torch.equal(out["pred_indices"][0, :ref], idx[:ref]):
        fail("rollout: the reference frames' codes were not pinned")
    generated = ROLLOUT_FRAMES - ref
    log(f"lidar_maskgit_rollout: {ROLLOUT_FRAMES} frames ({generated} "
        f"generated) in {dt:.3f} s: {dt / generated:.4f} s per generated "
        f"frame; peak {peak:.2f} GiB; the profiled step {step['wall_s']:.4f} "
        f"s, busy {100 * step['busy']:.1f}%; launches {json.dumps(counts)}")
    return counts, {"s": dt, "s_per_generated_frame": dt / generated,
                    "peak_gib": peak, "step_s": step["wall_s"],
                    "busy": step["busy"], "step_device_ms": step["device_ms"],
                    "sample_tokens": step["ranges"]["sample_tokens"]}


def check_lidar_dit_census(c: dict, forwards: int) -> None:
    """The LiDAR DiT path's launches over ``forwards`` CFG forwards: K1
    ``LIDAR_K1_PER_FORWARD`` a forward, all at ``LIDAR_K1_SHAPE`` and on
    the Hopper forward; K3 and K4 ``LIDAR_K3/K4_PER_FORWARD`` a forward,
    all on the runtime-width kernel (``adaln_any_kernel``) at exactly the
    ``LIDAR_ADALN_SHAPES``; no K7."""
    shape = ",".join(map(str, LIDAR_K1_SHAPE + (64,)))
    k1 = LIDAR_K1_PER_FORWARD * forwards
    log(f"lidar_dit: K1 {c['flash_tail']} launches by shape "
        f"{json.dumps(c['flash_tail_by_shape'])}, on the Hopper forward "
        f"{json.dumps(c['flash_tail_sm90_by_shape'])}")
    if c["flash_tail"] != k1 or c["flash_tail_by_shape"] != {shape: k1} or \
            c["flash_tail_sm90_by_shape"] != {shape: k1}:
        fail(f"lidar_dit: K1 should have launched {k1} times at ({shape}), "
             f"all on the Hopper forward")
    allowed = {",".join(map(str, s)) for s in LIDAR_ADALN_SHAPES}
    for key, per in (("adaln_modulate", LIDAR_K3_PER_FORWARD),
                     ("residual_adaln_modulate", LIDAR_K4_PER_FORWARD)):
        log(f"lidar_dit: {key} {c[key]} launches, {c[f'{key}_fixed']} on "
            f"the d-1536 kernel, by shape {json.dumps(c[f'{key}_by_shape'])}")
        if c[key] != per * forwards or c[f"{key}_fixed"] != 0 or \
                set(c[f"{key}_by_shape"]) != allowed:
            fail(f"lidar_dit: {key} should have launched {per * forwards} "
                 f"times, all on the runtime-width kernel at {allowed}")
    if c["flash_attention"] or c["flash_attention_segment"]:
        fail("lidar_dit: K7 launched on the LiDAR DiT path")


def run_lidar_dit(dev, create_instance_from_config, ops, get_conditions):
    """The temporal LiDAR DiT at full width (``LIDAR_DIT_CONFIG``: the
    d-1024 DiT in bf16, the fp32 vq80k tokenizer): CFG forwards timed, the
    rasters gate, one forward profiled with the plain joint attention at
    s 1601 as its own range, then ``generate`` with one reference frame
    and the launch census."""
    from opendwm_tpu_torch.ops import attention
    from opendwm_tpu_torch.perf import lidar_tiny

    check_lidar_tiny_gaps(lidar_tiny.dit_gaps(dev), "rowwise DiT")
    pipe, gen = build_lidar(create_instance_from_config, LIDAR_DIT_CONFIG,
                            dev, ("model", "autoencoder"))
    log(f"lidar_dit cut: inference_steps "
        f"{pipe.inference_config['inference_steps']} -> {LIDAR_DIT_STEPS}")
    pipe.inference_config["inference_steps"] = LIDAR_DIT_STEPS
    model = pipe.model
    batch = lidar_batch(dev, gen, LIDAR_DIT_FRAMES)
    prepared = pipe.prepare_batch(batch)
    with torch.inference_mode():
        vox = prepared["gt_voxels"]
        feats = pipe.autoencoder.lidar_encoder(vox.reshape(-1,
                                                           *vox.shape[2:]))
        check_nearest(lidar_tiny.nearest_gaps(
            pipe.autoencoder.vector_quantizer,
            feats.reshape(-1, feats.shape[-1])), "lidar_dit tokenizer")
    del vox, feats
    latents = prepared["latents"]
    conds = get_conditions(prepared, pipe.common_config,
                           do_classifier_free_guidance=True)
    kwargs = dict(sample=torch.randn((2, *latents.shape[1:]), generator=gen,
                                     device=dev),
                  timestep=torch.full((2, *latents.shape[1:3]), 500.0,
                                      device=dev), **conds)
    fwd_s = []
    with torch.inference_mode():
        for _ in range(1 + LIDAR_DIT_FORWARDS):
            out, dt = sync_s(lambda: model(**kwargs))
            fwd_s.append(dt)
        if out.shape != kwargs["sample"].shape or \
                not bool(torch.isfinite(out).all()):
            fail("lidar_dit: the CFG forward is not finite or misshapen")
        one = {k: v[1:] for k, v in kwargs.items()}
        move = check_moves(
            model(**one), model(**{**one, "condition_image_tensor":
                                   torch.zeros_like(one[
                                       "condition_image_tensor"])}),
            "lidar_dit output", "the rasters (against zeros)")
        prof = profiled(lambda: model(**kwargs),
                        "LiDAR DiT CFG forward (12 frames x 1601 tokens)",
                        ranges=((attention, "_plain_attention",
                                 "plain_attention"),))
    del out, kwargs, one
    forward_s = min(fwd_s[1:])

    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    got, dt = sync_s(lambda: pipe.generate(
        batch, generator=gen, image_latents=latents,
        reference_frame_count=LIDAR_DIT_REF))
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_lidar_dit_census(counts, LIDAR_DIT_STEPS)
    check_lidar_outputs({"pred_voxels": got["pred_voxels"]}, None,
                        "lidar_dit")
    if tuple(got["latents"].shape) != tuple(latents.shape) or \
            not bool(torch.isfinite(got["latents"]).all()):
        fail("lidar_dit: the generated latents are not finite or misshapen")
    if not torch.equal(got["latents"][:, :LIDAR_DIT_REF],
                       latents[:, :LIDAR_DIT_REF]):
        fail("lidar_dit: the reference frame was not injected")
    generated = LIDAR_DIT_FRAMES - LIDAR_DIT_REF
    attn = prof["ranges"]["plain_attention"]
    log(f"lidar_dit: CFG forward {forward_s:.4f} s (of "
        f"{', '.join(f'{t:.4f}' for t in fwd_s)}); generate {dt:.3f} s "
        f"({LIDAR_DIT_STEPS} steps, {generated} generated frames): "
        f"{dt / generated:.4f} s per generated frame; peak {peak:.2f} GiB; "
        f"busy {100 * prof['busy']:.1f}%; plain joint attention at s 1601 "
        f"{attn['ms']:.3f} device ms ({100 * attn['share']:.2f}%); rasters "
        f"move the output by {move:.4e}")
    return counts, {"forward_s": forward_s, "generate_s": dt,
                    "s_per_generated_frame": dt / generated,
                    "peak_gib": peak, "busy": prof["busy"],
                    "device_ms": prof["device_ms"],
                    "plain_attention": attn}


def merge_counts(total: dict, more: dict) -> dict:
    """``launch_counts`` dicts added entry by entry (the by-shape dicts
    too)."""
    out = dict(total)
    for key, value in more.items():
        if isinstance(value, dict):
            merged = dict(out.get(key, {}))
            for k, n in value.items():
                merged[k] = merged.get(k, 0) + n
            out[key] = merged
        else:
            out[key] = out.get(key, 0) + value
    return out


def check_gaps(gaps: dict, tols: dict, what: str) -> None:
    """A tiny path on the card against the CPU (``perf/unimlvg_tiny.py``):
    every key of ``tols`` within its bar; every ``*_launches`` key above 0."""
    log(f"{what}, the card vs the CPU (fp32): {json.dumps(gaps)}")
    bad = {k: gaps[k] for k, tol in tols.items() if not gaps[k] <= tol}
    bad.update({k: n for k, n in gaps.items()
                if k.endswith("_launches") and n <= 0})
    if bad:
        fail(f"{what} disagrees with the CPU or launched no kernel: {bad}")


def unimlvg_batch(dev, gen, unimlvg_tiny) -> dict:
    """Phase 9's batch (text, random box and map rasters) with the seeded
    camera rig of ``unimlvg_tiny.camera_rig`` (ego poses included)."""
    batch = make_batch(dev, gen, layout=True)
    batch.update(unimlvg_tiny.camera_rig(gen, 1, FRAMES, VIEWS,
                                         (8 * LAT_H, 8 * LAT_W), dev))
    return batch


def check_unimlvg_census(c: dict, forwards: int, tag: str) -> None:
    """K1 at the joint attention's (72, 602, 24, 64) and at the other two
    sequence lengths, K3/K4 62/47 a CFG forward at (72, 448 | 154, 1536)."""
    k1 = c["flash_tail_by_shape"].get("72,602,24,64", 0)
    k3, k4 = c["adaln_modulate"], c["residual_adaln_modulate"]
    log(f"{tag} census: K1 by shape {json.dumps(c['flash_tail_by_shape'])} "
        f"({c['flash_tail_sm90']} of {c['flash_tail']} on the Hopper "
        f"forward); K3 {k3} ({k3 / forwards:g} a CFG forward) by shape "
        f"{json.dumps(c['adaln_modulate_by_shape'])}, K4 {k4} "
        f"({k4 / forwards:g}) by shape "
        f"{json.dumps(c['residual_adaln_modulate_by_shape'])}; K7 "
        f"{c['flash_attention']}")
    for s in (602, 448, 168):
        if c["flash_tail_by_seq"].get(s, 0) == 0:
            fail(f"flash_tail never launched at s={s} on the {tag} path")
    shapes = set(c["adaln_modulate_by_shape"]) | \
        set(c["residual_adaln_modulate_by_shape"])
    if k1 == 0 or k3 != K3_PER_FORWARD * forwards or \
            k4 != K4_PER_FORWARD * forwards or \
            not {"72,448,1536", "72,154,1536"} <= shapes:
        fail(f"{tag}: K1 at (72, 602) {k1} times, K3/K4 {k3}/{k4} times in "
             f"{forwards} CFG forwards (want {K3_PER_FORWARD}/"
             f"{K4_PER_FORWARD} a forward) at {sorted(shapes)}")


def run_unimlvg_slice(dev, create_instance_from_config, sd35_vae, ops,
                      get_conditions, unimlvg_tiny):
    """UniMLVG stage 3 serving at full width (``UNIMLVG_CONFIG``, the one
    cut: 40 -> ``STEPS`` steps): the tiny pipeline against the CPU first;
    CFG forwards timed (median of ``UNIMLVG_TIMED``); the camera and
    raster gates at batch 1; one profiled CFG forward; a 2-window rollout
    with CFG 4.0 and the SD3.5 VAE decode, with the launch census. Returns
    (counts, metrics, the pipeline) for the branch-type phase."""
    check_gaps(unimlvg_tiny.unimlvg_gaps(dev),
               {"inference_rel": TINY_TOL, "rollout_rel": TINY_TOL},
               "tiny UniMLVG (2-step CFG inference, 2-window rollout)")
    cfg = json.loads(UNIMLVG_CONFIG.read_text())["pipeline"]
    log(f"unimlvg serve cut: inference_steps "
        f"{cfg['inference_config']['inference_steps']} -> {STEPS}")
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
    model, cc = pipe.model, pipe.common_config
    n_params = sum(p.numel() for p in model.parameters())
    log(f"unimlvg serve: {UNIMLVG_CONFIG.relative_to(REPO)} "
        f"({type(pipe).__name__}), {len(model.transformer_blocks)} joint "
        f"blocks, width {model.inner_dim}, {n_params / 1e9:.3f}B params, "
        f"{model.dtype}, perspective {model.perspective_modeling_type}, "
        f"ar_input_type {cc['ar_input_type']} with {cc['visible_frame']} "
        f"visible frames; guidance {cfg['inference_config']['guidance_scale']}")

    batch = unimlvg_batch(dev, gen, unimlvg_tiny)
    latent_shape = (1, FRAMES, VIEWS, LAT_H, LAT_W, 16)
    total_frames = FRAMES + (WINDOWS - 1) * (FRAMES - 1)
    conds = get_conditions(batch, cc, do_classifier_free_guidance=True)
    kwargs = dict(sample=torch.randn((2,) + latent_shape[1:], generator=gen,
                                     device=dev),
                  timestep=torch.full((2, FRAMES, VIEWS), 500.0, device=dev),
                  **conds)
    with torch.inference_mode():
        out = model(**kwargs)  # warm-up
        fwd_s = [sync_s(lambda: model(**kwargs))[1]
                 for _ in range(UNIMLVG_TIMED)]
        if out.shape != kwargs["sample"].shape or \
                not torch.isfinite(out).all():
            fail("UniMLVG forward output is not finite or has the wrong "
                 "shape")
        one = dict(sample=kwargs["sample"][:1],
                   timestep=kwargs["timestep"][:1])
        moved = dict(batch, camera_transforms=batch["camera_transforms"]
                     .clone())
        moved["camera_transforms"][..., :3, 3] += 1.0
        camera_move = check_moves(
            model(**one, **get_conditions(batch, cc)),
            model(**one, **get_conditions(moved, cc)), "unimlvg serve",
            "the camera transforms (+1 m)")
        del out, moved
        layout = serve_layout_checks(model, cc, batch, get_conditions,
                                     kwargs, "unimlvg serve DiT")
        prof = profiled(lambda: model(**kwargs), "UniMLVG CFG forward")
    forward_s = median_spread(fwd_s)
    del kwargs, conds

    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    latents, rollout_s = sync_s(lambda: pipe.autoregressive_inference_pipeline(
        batch, latent_shape, total_frames=total_frames,
        reference_frame_count=1, generator=gen))
    frames, decode_s = sync_s(lambda: pipe.decode_latents(
        latents, chunk_size=DECODE_CHUNK))
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    want_latents = (1, total_frames, VIEWS, LAT_H, LAT_W, 16)
    want_frames = (1, total_frames, VIEWS, 8 * LAT_H, 8 * LAT_W, 3)
    if tuple(latents.shape) != want_latents or \
            not torch.isfinite(latents).all() or \
            tuple(frames.shape) != want_frames or \
            not torch.isfinite(frames).all():
        fail(f"UniMLVG rollout latents {tuple(latents.shape)} or frames "
             f"{tuple(frames.shape)} not finite or not as expected")
    forwards = WINDOWS * STEPS
    per_frame = (rollout_s + decode_s) / total_frames
    log(f"unimlvg serve: CFG forward {forward_s['median']:.4f} s (median of "
        f"{UNIMLVG_TIMED}, {forward_s['min']:.4f}-{forward_s['max']:.4f}); "
        f"rollout {WINDOWS} windows x {STEPS} steps {rollout_s:.3f} s, "
        f"decode {decode_s:.3f} s, {per_frame:.4f} s per generated 6-view "
        f"frame ({total_frames} frames); peak {peak:.2f} GiB; busy "
        f"{100 * prof['busy']:.1f}% of the profiled forward "
        f"({prof['device_ms']:.1f} device ms)")
    check_unimlvg_census(counts, forwards, "unimlvg serve")
    del latents, frames
    pipe.set_vae(None)
    return counts, {"forward_s": forward_s, "rollout_s": rollout_s,
                    "decode_s": decode_s, "s_per_generated_frame": per_frame,
                    "peak_gib": peak, "busy": prof["busy"],
                    "forward_device_ms": prof["device_ms"],
                    "camera_move": camera_move, **layout}, pipe


def run_branch_types(dev, pipe, ops, get_conditions, unimlvg_tiny,
                     mask_layers):
    """The other branch types and MaskGWM on the UniMLVG DiT at full width:
    the tiny types and masked step against the CPU first; then one CFG
    forward (after a warm-up) with each of cross-view ``full``, ``fuse``,
    ``adj_fuse`` and temporal ``full`` in place of the config's, each
    launching K7 exactly at its shape (``BRANCH_K7``); then a MaskController
    of its defaults attached and one masked forward + backward at batch 1
    on one ``draw_mask_noise`` draw, with perspective modeling off: the per-token ray
    embedding cannot meet the shortened rows (the JAX model fails to
    broadcast). Returns the launch counts of the type forwards and of the
    masked step, and the metrics."""
    check_gaps(unimlvg_tiny.branch_gaps(dev),
               {f"{name}_rel": TINY_TOL for name in BRANCH_K7},
               "tiny branch types")
    check_gaps(unimlvg_tiny.masked_step_gaps(dev),
               {"forward_rel": TINY_TOL, "grad_rel": TINY_TOL},
               "tiny masked DiT step (forward and every gradient, K1 and "
               "K2 launched)")
    model, cc = pipe.model, pipe.common_config
    gen = torch.Generator(dev).manual_seed(SEED + 5)
    batch = unimlvg_batch(dev, gen, unimlvg_tiny)
    kwargs = dict(sample=torch.randn(2, FRAMES, VIEWS, LAT_H, LAT_W, 16,
                                     generator=gen, device=dev),
                  timestep=torch.full((2, FRAMES, VIEWS), 500.0, device=dev),
                  **get_conditions(batch, cc,
                                   do_classifier_free_guidance=True))
    total, metrics = {}, {}
    saved = (model.crossview_attention_type, model.temporal_attention_type)
    for name, (attr, kind, (b, s), per_forward) in BRANCH_K7.items():
        setattr(model, attr, kind)
        with torch.inference_mode():
            model(**kwargs)
            ops.reset_launch_counts()
            out, dt = sync_s(lambda: model(**kwargs))
        c = ops.launch_counts()
        total = merge_counts(total, c)
        want = {f"{b},{s},{s},24,64": per_forward}
        log(f"branch {name}: CFG forward {dt:.4f} s; K7 by shape "
            f"{json.dumps(c['flash_attention_by_shape'])} "
            f"({c['flash_attention_sm90']} on the Hopper forward), K1 "
            f"{c['flash_tail']}")
        if c["flash_attention_by_shape"] != want or \
                c["flash_attention_sm90"] != per_forward or \
                not torch.isfinite(out).all():
            fail(f"branch {name}: K7 launched {c['flash_attention_by_shape']}"
                 f" ({c['flash_attention_sm90']} on the Hopper forward), not "
                 f"{want}, or the output is not finite")
        metrics[name] = {"forward_s": dt, "k7_shape": [b, s, s, 24, 64],
                         "k7_launches": per_forward}
        setattr(model, attr, saved[0] if attr.startswith("cross")
                else saved[1])
        del out

    attn = model.transformer_blocks[0].attn
    model.mask_module = mask_layers.MaskController(
        hidden_size=model.inner_dim, num_heads=attn.heads,
        attention_head_dim=attn.head_dim, dtype=model.dtype).to(
            device=dev, dtype=model.dtype)
    n_blocks = len(model.transformer_blocks)
    first_fp32 = n_blocks - model.mask_module.decode_layer
    random_init_(model.mask_module, gen)
    saved_perspective = model.perspective_modeling_type
    model.perspective_modeling_type = ""
    one = dict(sample=kwargs["sample"][:1], timestep=kwargs["timestep"][:1],
               **get_conditions(batch, cc),
               mask_noise=mask_layers.draw_mask_noise(
                   VIEWS, FRAMES, LAT_H * LAT_W // 4, generator=gen,
                   device=dev))
    del kwargs
    params = [p for p in model.parameters()]
    stream = []  # the dtype each joint block's x arrives in
    hooks = [block.register_forward_pre_hook(
        lambda _, args: stream.append(args[0].dtype))
        for block in model.transformer_blocks]

    def step():
        out = model(**one)
        loss = out.float().square().mean()
        loss.backward()
        for p in params:
            p.grad = None
        return loss.item()

    try:
        step()  # warm-up
        stream.clear()
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        loss, dt = sync_s(step)
        mask = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
    finally:
        for hook in hooks:
            hook.remove()
        model.perspective_modeling_type = saved_perspective
        model.mask_module = None
    check_mask_step(mask, stream[:n_blocks], first_fp32, loss)
    log(f"masked step (MaskGWM defaults: ratio 0.25, decode layer 5; "
        f"perspective off): forward + backward {dt:.4f} s, loss {loss:.6f}, "
        f"peak {peak:.2f} GiB")
    metrics["mask_step"] = {"s": dt, "loss": loss, "peak_gib": peak,
                            "k1_by_shape": mask["flash_tail_by_shape"]}
    return total, mask, metrics


def check_mask_step(c: dict, stream: list, first_fp32: int,
                    loss: float) -> None:
    """The masked step launched K1 and K2 at both of ``MASK_ATTN_SHAPES``
    and K3/K4 at ``MASK_ADALN_SHAPE``, and at no shape phase 3 did not
    hold against its plain version (K1 ``K1_CHECKED``, K2 ``K2_CHECKED``'s
    24-head sequences, K3/K4 ``ADALN_SHAPES``); its stream ran in bf16 up
    to the first decoder layer (``first_fp32``) and in fp32 from it
    (``stream``: the dtype each joint block's x arrived in, forward only);
    the loss is finite."""
    k1 = set(c["flash_tail_by_shape"])
    k2 = set(c["flash_tail_backward_by_seq"])
    k3 = set(c["adaln_modulate_by_shape"])
    k4 = set(c["residual_adaln_modulate_by_shape"])
    log(f"masked step census: K1 by shape {json.dumps(c['flash_tail_by_shape'])}"
        f" ({c['flash_tail_sm90']} of {c['flash_tail']} on the Hopper "
        f"forward), K2 by sequence "
        f"{json.dumps(c['flash_tail_backward_by_seq'])} "
        f"({c['flash_tail_backward_sm90']} of {c['flash_tail_backward']} on "
        f"the Hopper backward), K3 by shape "
        f"{json.dumps(c['adaln_modulate_by_shape'])}, K4 by shape "
        f"{json.dumps(c['residual_adaln_modulate_by_shape'])}; the stream "
        f"into the joint blocks {[str(d)[6:] for d in stream]}")
    checked_k1 = {f"{b},{s},{h},64" for b, s, h in K1_CHECKED}
    checked_k2 = {s for _, s, h in K2_CHECKED if h == 24}
    checked_adaln = {",".join(map(str, x)) for x in ADALN_SHAPES}
    want_k1 = {f"{b},{s},{h},64" for b, s, h in MASK_ATTN_SHAPES}
    want_k2 = {s for _, s, _ in MASK_ATTN_SHAPES}
    want_adaln = ",".join(map(str, MASK_ADALN_SHAPE))
    unchecked = (k1 - checked_k1) | {str(s) for s in k2 - checked_k2} | \
        ((k3 | k4) - checked_adaln)
    missing = (want_k1 - k1) | {str(s) for s in want_k2 - k2} | \
        {f"K3 {want_adaln}"} - {f"K3 {x}" for x in k3} | \
        {f"K4 {want_adaln}"} - {f"K4 {x}" for x in k4}
    if unchecked or missing:
        fail(f"the masked step launched kernels at shapes phase 3 did not "
             f"check ({sorted(unchecked)}) or not at its own "
             f"({sorted(missing)})")
    want = [torch.bfloat16] * first_fp32 + \
        [torch.float32] * (len(stream) - first_fp32)
    if stream != want:
        fail(f"the masked stream ran in {stream}, not bf16 up to block "
             f"{first_fp32} and fp32 from it")
    if not math.isfinite(loss):
        fail(f"the masked step's loss {loss} is not finite")


def check_tiny_unimlvg_step(dev, unimlvg_tiny, draw_unimlvg_randoms):
    """One AdamW step of the tiny UniMLVG pipeline (``pred``, remat on):
    the kernel path on the card against the plain path on the CPU, fp32,
    on the same draws."""
    ref_pipe = unimlvg_tiny.tiny_pipeline(
        SEED, gradient_checkpointing=True,
        crossview_gradient_checkpointing=True,
        temporal_gradient_checkpointing=True)
    pipe = copy.deepcopy(ref_pipe)
    pipe.model.to(dev)
    g = torch.Generator().manual_seed(SEED)
    batch = unimlvg_tiny.tiny_batch(g)
    draws = draw_unimlvg_randoms(batch["latents"].shape, "pred", g)
    ref = _one_step(ref_pipe, batch, draws)
    out = _one_step(pipe, _to(batch, dev), _to(draws, dev))
    check_step_errors(step_errors(out, ref), "tiny UniMLVG train step (pred, "
                      "remat, AdamW)")


def run_unimlvg_train(dev, create_instance_from_config, ops, unimlvg_tiny,
                      draw_unimlvg_randoms, profile: bool = False):
    """UniMLVG stage 3's ``loss_fn`` at full width and depth: fp32 masters
    under bf16 compute, remat as the config sets it, flat AdamW with bf16
    moments (``BM_OPTIMIZER``, as phase 11 trains the same 4.08B model: the
    config's fp32 moments put masters, gradients and moments at ~65 GB
    before activations); the tiny step against the CPU first, then
    ``drive_train`` on a batch of latents, rasters and the camera rig."""
    check_tiny_unimlvg_step(dev, unimlvg_tiny, draw_unimlvg_randoms)
    tag = "unimlvg train"
    cfg = json.loads(UNIMLVG_CONFIG.read_text())["pipeline"]
    cfg["model"]["param_dtype"] = torch.float32
    cfg["optimizer_config"].update(BM_OPTIMIZER)
    mc = cfg["model"]
    log(f"{tag}: {UNIMLVG_CONFIG.relative_to(REPO)}; AdamW "
        f"{json.dumps(cfg['optimizer_config'])}, clip "
        f"{cfg['training_config']['max_norm_for_grad_clip']}; remat: joint "
        f"blocks {mc['gradient_checkpointing']}, cross-view "
        f"{mc['crossview_gradient_checkpointing']}, temporal "
        f"{mc['temporal_gradient_checkpointing']}")
    with torch.device("meta"):
        pipe = create_instance_from_config(cfg)
    gen = torch.Generator(dev).manual_seed(SEED)
    pipe.model.to_empty(device=dev)
    random_init_(pipe.model, gen)
    batch = unimlvg_batch(dev, gen, unimlvg_tiny)
    batch["latents"] = torch.randn(1, FRAMES, VIEWS, LAT_H, LAT_W, 16,
                                   generator=gen, device=dev)
    counts, metrics = drive_train(dev, pipe, batch, ops, tag, profile)
    check_train_seqs(counts, tag)
    check_moment_bytes(*metrics["moments"], 2, tag)
    log(f"{tag}: K2 {counts['flash_tail_backward']} launches in the timed "
        f"steps by sequence {json.dumps(counts['flash_tail_backward_by_seq'])}"
        f" ({counts['flash_tail_backward_sm90']} on the Hopper backward)")
    return counts, metrics


def run_temporal_vae(dev, ops, TemporalAutoencoderKL, unimlvg_tiny):
    """The causal temporal VAE at the JAX defaults: the tiny VAE against
    the CPU first (``TVAE_TOL``, causal on the card); the full-width VAE in
    fp32 on one view of 9 frames of 64 x 112, where a change to the last
    frame must leave latent frame 0 within 1e-5; then in bf16
    ``decode_from_scaled`` of 6 views x ``TVAE_LATENT_FRAMES`` latent
    frames of 32 x 56 into 17 frames of 256 x 448 and ``encode_to_scaled``
    of them back, each after a warm-up on one chunk, timed with its peak
    memory. No kernel of the port runs here (cuDNN convolutions)."""
    gaps = unimlvg_tiny.vae_gaps(dev)
    check_gaps(gaps, {"mean_rel": TVAE_TOL, "logvar_rel": TVAE_TOL,
                      "decode_rel": TVAE_TOL, "causal_gap": 1e-5},
               "tiny temporal VAE")
    gen = torch.Generator(dev).manual_seed(SEED + 6)
    with torch.device("meta"):
        vae32 = TemporalAutoencoderKL()
        vae = TemporalAutoencoderKL(dtype=torch.bfloat16)
    vae32.to_empty(device=dev)
    random_init_(vae32, gen)
    n_params = sum(p.numel() for p in vae32.parameters())
    video = torch.rand(1, 9, 64, 112, 3, generator=gen, device=dev) * 2 - 1
    later = video.clone()
    later[:, -1] = -later[:, -1]
    with torch.inference_mode():
        first, _ = vae32.encode(video)
        second, _ = vae32.encode(later)
    causal_gap = max_err(first[:, 0], second[:, 0])
    last_move = max_err(first[:, -1], second[:, -1])
    log(f"temporal VAE ({n_params / 1e6:.1f}M params): fp32, 9 frames of 64 "
        f"x 112, the last frame flipped: latent frame 0 moves "
        f"{causal_gap:.3e} (tol 1e-5), the last latent frame "
        f"{last_move:.3e}")
    if not (causal_gap <= 1e-5 and last_move > 0):
        fail(f"the temporal VAE is not causal on the card: {causal_gap}, "
             f"{last_move}")
    vae.to_empty(device=dev)
    vae.load_state_dict(vae32.state_dict())
    vae.eval()
    del vae32, video, later, first, second
    torch.cuda.empty_cache()

    t_out = 1 + vae.temporal_downscale * (TVAE_LATENT_FRAMES - 1)
    latents = torch.randn(1, TVAE_LATENT_FRAMES, VIEWS, LAT_H, LAT_W, 16,
                          generator=gen, device=dev)
    ops.reset_launch_counts()
    metrics = {}
    with torch.inference_mode():
        vae.decode_from_scaled(latents[:, :, :TVAE_CHUNK])
        torch.cuda.reset_peak_memory_stats()
        frames, decode_s = sync_s(lambda: vae.decode_from_scaled(
            latents, chunk_size=TVAE_CHUNK))
        metrics["decode"] = {"s": decode_s, "peak_gib":
                             torch.cuda.max_memory_allocated() / 2**30}
        vae.encode_to_scaled(frames[:, :, :TVAE_CHUNK])
        torch.cuda.reset_peak_memory_stats()
        back, encode_s = sync_s(lambda: vae.encode_to_scaled(
            frames, chunk_size=TVAE_CHUNK))
        metrics["encode"] = {"s": encode_s, "peak_gib":
                             torch.cuda.max_memory_allocated() / 2**30}
    counts = ops.launch_counts()
    want_frames = (1, t_out, VIEWS, 8 * LAT_H, 8 * LAT_W, 3)
    if tuple(frames.shape) != want_frames or \
            tuple(back.shape) != tuple(latents.shape) or \
            not torch.isfinite(frames).all() or \
            not torch.isfinite(back).all():
        fail(f"temporal VAE frames {tuple(frames.shape)} / latents "
             f"{tuple(back.shape)} not finite or not as expected")
    log(f"temporal VAE (bf16, {TVAE_CHUNK} views a call): decode "
        f"{tuple(latents.shape)} -> {want_frames} {decode_s:.3f} s, peak "
        f"{metrics['decode']['peak_gib']:.2f} GiB; encode back "
        f"{encode_s:.3f} s, peak {metrics['encode']['peak_gib']:.2f} GiB; "
        f"frame range [{frames.min().item():.3f}, "
        f"{frames.max().item():.3f}]")
    metrics.update(causal_gap=causal_gap, tiny=gaps)
    return counts, metrics


def check_launch_shapes(c: dict, want: dict, tag: str) -> None:
    """Each by-shape census of ``want`` (a ``launch_counts`` key such as
    ``flash_tail_by_shape``: the shapes phase 3 held, as tuples) launched at
    exactly those shapes, each at least once."""
    for key, shapes in want.items():
        allowed = {",".join(map(str, s)) for s in shapes}
        got = {k for k, n in c.get(key, {}).items() if n}
        log(f"{tag}: {key} {json.dumps(c.get(key, {}))}")
        if got != allowed:
            fail(f"{tag}: {key} launched at {sorted(got)}, phase 3 held "
                 f"{sorted(allowed)}")


def lidar_steps(pipe, state, batch, generator, steps: int, tag: str,
                first: int = 1) -> dict:
    """``steps`` train steps (numbered from ``first``) timed one by one
    (host seconds ending in a synchronize) with the peak memory; fails on a
    non-finite metric. Returns {s_per_step (the mean after the first),
    step_s, peak_gib, metrics (the last step's)}."""
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(steps):
        (state, metrics), dt = sync_s(lambda: pipe.train_step(
            state, batch, generator))
        metrics = {k: float(v) for k, v in metrics.items()}
        times.append(dt)
        log(f"{tag} step {first + i}: {dt:.3f} s, {json.dumps(metrics)}")
        if not all(math.isfinite(v) for v in metrics.values()):
            fail(f"{tag}: a metric of step {first + i} is not finite: "
                 f"{metrics}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    return {"s_per_step": sum(times[1:]) / max(1, len(times) - 1),
            "step_s": times, "peak_gib": peak, "metrics": metrics}


def render_alone(model, density, batch) -> dict:
    """The DVGO render of ``density`` (frames, F, Zc, H, W) against the
    batch's rays, forward and backward (its chunks recomputed), alone:
    device ms by CUDA events over 2 runs after one warm-up, and samples
    (rays x steps x frames) a second."""
    grid = density.detach().requires_grad_()

    def run():
        depth_loss, sdf_loss, _ = model.render_frames(
            grid, batch["lidar_points"], batch["lidar_points_mask"])
        (depth_loss + sdf_loss).backward()
        grid.grad = None
        model.zero_grad(set_to_none=True)

    run()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(2):
        run()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / 2
    frames, rays = grid.shape[0], batch["lidar_points"].shape[-2]
    samples = frames * rays * model.ray_max_steps
    return {"ms": ms, "samples": samples,
            "samples_per_s": samples / (ms / 1e3)}


def run_lidar_tokenizer_train(dev, create_instance_from_config, ops):
    """Phase 19: the VQ tokenizer's ``LidarCodebook`` at full width
    (``LIDAR_VQVAE_CONFIG``, fp32 as the config): the tiny step against the
    CPU first; ``LIDAR_TRAIN_STEPS`` steps timed with the peak; the code
    statistics and the reservoir; one step profiled with the render, the
    encoder and the decoder as ranges; the render's forward and backward
    alone (samples a second, its share of a step); a forced revival at the
    synthetic config's size; then ``LidarVAE`` (``LIDAR_VAE_CONFIG``) at
    the same geometry."""
    from opendwm_tpu_torch.perf import lidar_train_tiny

    tol = lidar_train_tiny.TOL
    for name in ("codebook_gaps", "vae_gaps"):
        gaps = getattr(lidar_train_tiny, name)(dev)
        check_gaps(gaps, {k: tol for k in gaps if k.endswith("_rel")},
                   f"tiny {name[:-5]} step")
        if not all(v for k, v in gaps.items() if k.endswith("_equal")) or \
                gaps.get("attention_kernels", 0):
            fail(f"tiny {name[:-5]} step: {gaps}")

    tag = "lidar tokenizer train"
    pipe, gen = build_lidar(create_instance_from_config,
                            LIDAR_VQVAE_CONFIG, dev, ("model",))
    model = pipe.model
    batch = lidar_batch(dev, gen, TOKENIZER_FRAMES, TOKENIZER_BATCH,
                        model.voxelizer, TOKENIZER_MASKED, rasters=False)
    n_e = model.vector_quantizer.n_e
    log(f"{tag}: {LIDAR_VQVAE_CONFIG.relative_to(REPO)}: {n_e} codes x "
        f"{model.vector_quantizer.e_dim}, grid "
        f"{model.voxelizer.grid_shape}, {model.ray_max_steps} ray steps of "
        f"{model.ray_stepsize} m, batch {TOKENIZER_BATCH} x "
        f"{TOKENIZER_FRAMES} frames of {LIDAR_POINTS} points "
        f"({TOKENIZER_MASKED} masked a frame)")
    state = pipe.init_state()
    generator = torch.Generator(dev).manual_seed(SEED + 1)
    ops.reset_launch_counts()
    first = lidar_steps(pipe, state, batch, generator, 1, tag)
    if not state.reservoir_initialized or \
            not bool((state.reservoir.abs().sum(-1) > 0).all()):
        fail(f"{tag}: the reservoir is not full after step 1")
    used = int((state.code_age == 0).sum())
    tokens = int(state.code_usage.sum())
    grid = model.lidar_encoder.img_size // model.lidar_encoder.patch_size
    if used == 0 or tokens != TOKENIZER_BATCH * TOKENIZER_FRAMES * grid ** 2 \
            or float(state.code_age.max()) != 10001.0:
        fail(f"{tag}: code stats after step 1: {used} codes used, usage "
             f"{tokens}, oldest {float(state.code_age.max())}")
    timed = lidar_steps(pipe, state, batch, generator,
                        LIDAR_TRAIN_STEPS - 1, tag, first=2)
    counts = ops.launch_counts()
    timed["s_per_step"] = sum(timed["step_s"]) / len(timed["step_s"])
    timed["step_s"] = first["step_s"] + timed["step_s"]
    timed["peak_gib"] = max(first["peak_gib"], timed["peak_gib"])
    log(f"{tag}: {used} of {n_e} codes used at step 1; the reservoir full "
        f"({state.reservoir.shape[0]} rows)")

    prof = profiled(
        lambda: pipe.train_step(state, batch, generator),
        f"{tag} step (profiled)",
        ranges=((model, "render_frames", "dvgo_render_forward"),
                (model.lidar_encoder, "forward", "swin_encoder_forward"),
                (model.lidar_decoder, "forward", "swin_decoder_forward")))
    with torch.no_grad():
        _, z, _, _ = model.encode(batch["lidar_points"],
                                  batch["lidar_points_mask"])
        density, _ = model.lidar_decoder(z, density=True)
    del z
    render = render_alone(model, density, batch)
    del density
    step_ms = 1e3 * timed["s_per_step"]
    render["share_of_step"] = render["ms"] / step_ms
    log(f"{tag}: the DVGO render alone (forward + backward, "
        f"{TOKENIZER_BATCH * TOKENIZER_FRAMES} frames): {render['ms']:.1f} "
        f"device ms, {render['samples']} samples, "
        f"{render['samples_per_s'] / 1e9:.3f} G samples/s, "
        f"{100 * render['share_of_step']:.1f}% of a {step_ms:.1f} ms step")

    # a forced revival at the synthetic config's size
    small, _ = build_lidar(create_instance_from_config,
                           LIDAR_VQVAE_SYNTHETIC, dev, ("model",))
    small_state = small.init_state()
    v = small.model.voxelizer
    small_batch = {"lidar_points": (torch.rand(
        2, 2, 128, 3, generator=gen, device=dev) - 0.5) * 12,
        "lidar_points_mask": torch.ones(2, 2, 128, dtype=torch.bool,
                                        device=dev)}
    small.train_step(small_state, small_batch, generator)
    vq = small.model.vector_quantizer
    small_state.code_age[: vq.n_e // 2] = float(vq.dead_limit)
    before = vq.embedding.detach().clone()
    (small_state, revived), revive_s = sync_s(
        lambda: small.maybe_revive_codebook(small_state, seed=SEED))
    if not revived or torch.equal(before, vq.embedding) or \
            float(small_state.code_age.abs().sum()) != 0.0:
        fail(f"{tag}: the forced revival did not revive the codebook "
             f"({revived})")
    log(f"{tag}: a forced revival at {vq.n_e} codes x {vq.e_dim} (grid "
        f"{v.grid_shape}): {revive_s:.3f} s on the host; the codebook moved "
        f"by {rel_err(vq.embedding.detach(), before):.3e}, ages 0")
    del small, small_state, pipe, state, model, batch
    gc.collect()
    torch.cuda.empty_cache()

    vae_tag = "lidar vae train"
    vpipe, vgen = build_lidar(create_instance_from_config,
                              LIDAR_VAE_CONFIG, dev, ("model",))
    vbatch = lidar_batch(dev, vgen, TOKENIZER_FRAMES, TOKENIZER_BATCH,
                         vpipe.model.voxelizer, TOKENIZER_MASKED,
                         rasters=False)
    vstate = vpipe.init_state()
    ops.reset_launch_counts()
    vae = lidar_steps(vpipe, vstate, vbatch, generator, LIDAR_VAE_STEPS,
                      vae_tag)
    vae_counts = ops.launch_counts()
    if not vae["metrics"]["kl_loss"] > 0:
        fail(f"{vae_tag}: the KL term is {vae['metrics']['kl_loss']}")
    frames = TOKENIZER_BATCH * TOKENIZER_FRAMES
    log(f"{tag}: {timed['s_per_step']:.3f} s a step (steps 2-"
        f"{LIDAR_TRAIN_STEPS}; {frames / timed['s_per_step']:.2f} frames/s), "
        f"peak {timed['peak_gib']:.2f} GiB; {vae_tag}: "
        f"{vae['s_per_step']:.3f} s a step, peak {vae['peak_gib']:.2f} GiB")
    for key, c in (("tokenizer", counts), ("vae", vae_counts)):
        if c["flash_tail"] or c["flash_attention"]:
            fail(f"lidar {key} train: an attention kernel launched on a "
                 "Swin path (its windows carry a position bias)")
    metrics = {"tokenizer": {k: timed[k] for k in ("s_per_step", "step_s",
                                                  "peak_gib")},
               "render": render, "busy": prof["busy"],
               "step_device_ms": prof["device_ms"],
               "ranges": prof["ranges"], "revive_s": revive_s,
               "vae": {k: vae[k] for k in ("s_per_step", "step_s",
                                          "peak_gib")}}
    return counts, vae_counts, metrics


def run_lidar_maskgit_train(dev, create_instance_from_config, ops):
    """Phase 20: MaskGIT training at full width
    (``LIDAR_MASKGIT_TRAIN_CONFIG``: 24 blocks at 512, window 2, 80,000
    cosine codes, the extra embedding and its perturbation, 6-channel
    rasters; the transformer in bf16 compute over fp32 masters as phase 12
    serves it, the tokenizer fp32, frozen, saved by ``save_model_only``
    and loaded through ``load_vq_params``): the tiny step against the CPU
    first; ``LIDAR_TRAIN_STEPS`` steps of ``MASKGIT_TRAIN_BATCH`` x 1 frame
    timed with the peak; finite ``ce_loss`` and ``acc_0``."""
    from opendwm_tpu_torch import checkpoint
    from opendwm_tpu_torch.perf import lidar_train_tiny

    gaps = lidar_train_tiny.maskgit_train_gaps(dev)
    check_gaps(gaps, {k: lidar_train_tiny.TOL for k in gaps
                      if k.endswith("_rel")}, "tiny MaskGIT step")
    tag = "lidar maskgit train"

    pipe, gen = build_lidar(create_instance_from_config,
                            LIDAR_MASKGIT_TRAIN_CONFIG, dev, ("vq", "model"),
                            bf16=(("bi_directional_transformer",),))
    path = REPO / "build" / "lidar_maskgit_tokenizer.pt"
    checkpoint.save_model_only(str(path), pipe.vq)
    saved = pipe.vq.vector_quantizer.embedding.detach().clone()
    with torch.no_grad():
        pipe.vq.vector_quantizer.embedding.zero_()
    pipe.load_vq_params(checkpoint.load_model_only(str(path)))
    path.unlink()
    if not torch.equal(pipe.vq.vector_quantizer.embedding, saved):
        fail(f"{tag}: load_vq_params did not restore the tokenizer")
    del saved
    batch = lidar_batch(dev, gen, 1, MASKGIT_TRAIN_BATCH)
    state = pipe.init_state()
    generator = torch.Generator(dev).manual_seed(SEED + 1)
    ops.reset_launch_counts()
    out = lidar_steps(pipe, state, batch, generator, LIDAR_TRAIN_STEPS, tag)
    counts = ops.launch_counts()
    log(f"{tag}: {out['s_per_step']:.3f} s a step (steps 2-"
        f"{LIDAR_TRAIN_STEPS}; {MASKGIT_TRAIN_BATCH / out['s_per_step']:.2f}"
        f" frames/s), peak {out['peak_gib']:.2f} GiB, ce_loss "
        f"{out['metrics']['ce_loss']:.4f}, acc_0 "
        f"{out['metrics']['acc_0']:.4f}")
    if counts["flash_tail"] or counts["flash_attention"]:
        fail(f"{tag}: an attention kernel launched (its 4-token windows take "
             "the tiny-sequence form)")
    return counts, {k: out[k] for k in ("s_per_step", "step_s", "peak_gib",
                                        "metrics")}


def check_lidar_dit_train_census(c: dict, steps: int) -> None:
    """The LiDAR DiT train steps' launches: K1 and K2 at
    ``LIDAR_DIT_TRAIN_K1_SHAPE`` only, K2 8 a step (the 8 temporal
    branches' backward); K3 and K4 on the runtime-width kernel at exactly
    ``LIDAR_TRAIN_ADALN_SHAPES``, the same count every step and at least
    a forward's; no K7."""
    tag = "lidar dit train"
    shape = (LIDAR_DIT_TRAIN_K1_SHAPE + (64,),)
    check_launch_shapes(c, {"flash_tail_by_shape": shape,
                            "flash_tail_backward_by_shape": shape}, tag)
    if c["flash_tail_backward"] != LIDAR_K1_PER_FORWARD * steps or \
            c["flash_tail"] < LIDAR_K1_PER_FORWARD * steps:
        fail(f"{tag}: K1 {c['flash_tail']} and K2 "
             f"{c['flash_tail_backward']} launches in {steps} steps")
    for key, per in (("adaln_modulate", LIDAR_K3_PER_FORWARD),
                     ("residual_adaln_modulate", LIDAR_K4_PER_FORWARD)):
        log(f"{tag}: {key} {c[key]} launches ({c[key] / steps:g} a step), "
            f"{c[f'{key}_fixed']} on the d-1536 kernel")
        if c[key] % steps or c[key] < per * steps or c[f"{key}_fixed"]:
            fail(f"{tag}: {key} launched {c[key]} times in {steps} steps, "
                 f"{c[f'{key}_fixed']} on the d-1536 kernel")
    check_launch_shapes(c, {"adaln_modulate_by_shape":
                            LIDAR_TRAIN_ADALN_SHAPES,
                            "residual_adaln_modulate_by_shape":
                            LIDAR_TRAIN_ADALN_SHAPES}, tag)
    if c["flash_attention"] or c["flash_attention_backward"]:
        fail(f"{tag}: K7 launched")


def run_lidar_dit_train(dev, create_instance_from_config, ops):
    """Phase 21: the LiDAR DiT's train step at full width
    (``LIDAR_DIT_CONFIG``: 16 blocks at d 1024, bf16 compute over fp32
    masters, remat as the config sets it; the vq80k tokenizer frozen) on
    ``LIDAR_DIT_TRAIN_BATCH`` x ``LIDAR_DIT_FRAMES`` frames: the tiny step
    against the CPU first (K1 and K2), then ``drive_train`` and the
    census."""
    from opendwm_tpu_torch.perf import lidar_train_tiny

    gaps = lidar_train_tiny.dit_train_gaps(dev)
    check_gaps(gaps, {k: lidar_train_tiny.TOL for k in gaps
                      if k.endswith("_rel")}, "tiny LiDAR DiT step")
    tag = "lidar dit train"

    pipe, gen = build_lidar(create_instance_from_config, LIDAR_DIT_CONFIG,
                            dev, ("model", "autoencoder"), fp32_masters=True)
    mc = json.loads(LIDAR_DIT_CONFIG.read_text())["pipeline"]["model"]
    log(f"{tag}: remat: joint blocks {mc.get('gradient_checkpointing')}; "
        f"batch {LIDAR_DIT_TRAIN_BATCH} x {LIDAR_DIT_FRAMES} frames")
    batch = lidar_batch(dev, gen, LIDAR_DIT_FRAMES, LIDAR_DIT_TRAIN_BATCH)
    frames = LIDAR_DIT_TRAIN_BATCH * LIDAR_DIT_FRAMES
    counts, metrics = drive_train(dev, pipe, batch, ops, tag,
                                  frames_per_step=frames,
                                  unit="LiDAR frames")
    check_lidar_dit_train_census(counts, TRAIN_STEPS - 1)
    return counts, metrics


def check_lidar_unet_census(c: dict, tag: str, k1: tuple, k7: tuple,
                            backward: bool) -> None:
    """The LiDAR UNet path's launches: K1 (and in training K2) at exactly
    ``k1``'s shapes, K7 (and its backward) at ``k7``, no K3/K4 (the UNet
    has no AdaLN)."""
    k1 = tuple(s + (64,) for s in k1)
    want = {"flash_tail_by_shape": k1,
            "flash_attention_by_shape": (k7 + (64,),)}
    if backward:
        want.update({"flash_tail_backward_by_shape": k1,
                     "flash_attention_backward_by_shape": (k7 + (64,),)})
    check_launch_shapes(c, want, tag)
    if c["adaln_modulate"] or c["residual_adaln_modulate"]:
        fail(f"{tag}: K3/K4 launched on the UNet")


def run_lidar_unet(dev, create_instance_from_config, ops):
    """Phase 22: the LiDAR UNet (``LIDAR_UNET_CONFIG``: a VAEPointCloud of
    64 latent channels, fp32, and the UNet 320-1280 in bf16 compute over
    fp32 masters, remat as the config sets it) on 80 x 80 latents x
    ``LIDAR_UNET_FRAMES`` frames x 1 view: the tiny pipeline against the
    CPU first; serving: DDIM with CFG 3.0, cut from 50 to
    ``LIDAR_UNET_STEPS`` steps, timed; one train step at the config's
    batch; the census of both."""
    from opendwm_tpu_torch.perf import lidar_train_tiny

    gaps = lidar_train_tiny.unet_gaps(dev)
    check_gaps(gaps, {k: lidar_train_tiny.TOL for k in gaps
                      if k.endswith("_rel")}, "tiny LiDAR UNet")
    if not gaps["voxels_equal"] or gaps["voxels_equal_share"] < 0.999:
        fail(f"tiny LiDAR UNet: voxels differ: {gaps}")
    tag = "lidar unet"

    pipe, gen = build_lidar(create_instance_from_config, LIDAR_UNET_CONFIG,
                            dev, ("model", "autoencoder"), fp32_masters=True)
    log(f"{tag} cut: inference_steps "
        f"{pipe.inference_config['inference_steps']} -> {LIDAR_UNET_STEPS}")
    pipe.inference_config["inference_steps"] = LIDAR_UNET_STEPS
    batch = lidar_batch(dev, gen, LIDAR_UNET_FRAMES,
                        voxelizer=pipe.autoencoder.voxelizer, rasters=False)
    pipe.generate(batch, generator=gen)  # warm-up
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(2):
        got, dt = sync_s(lambda: pipe.generate(batch, generator=gen))
        times.append(dt)
    serve_counts = ops.launch_counts()
    serve_peak = torch.cuda.max_memory_allocated() / 2**30
    check_lidar_unet_census(serve_counts, f"{tag} serve",
                            LIDAR_UNET_K1_SERVE, LIDAR_UNET_K7_SERVE, False)
    k7 = serve_counts["flash_attention"]
    want = 2 * LIDAR_UNET_STEPS * UNET_K7_PER_FORWARD
    if k7 != want:
        fail(f"{tag} serve: K7 launched {k7} times in 2 generations, want "
             f"{want}")
    check_lidar_outputs({"pred_voxels": got["pred_voxels"]}, None,
                        f"{tag} serve")
    if not bool(torch.isfinite(got["latents"]).all()):
        fail(f"{tag} serve: the latents are not finite")
    log(f"{tag} serve: {min(times):.3f} s a generation of "
        f"{LIDAR_UNET_FRAMES} frames ({LIDAR_UNET_STEPS} DDIM steps, CFG "
        f"{pipe.inference_config['guidance_scale']}; of "
        f"{', '.join(f'{t:.3f}' for t in times)}), peak {serve_peak:.2f} "
        f"GiB")
    del got
    pipe.model.train()
    train_batch = lidar_batch(dev, gen, LIDAR_UNET_FRAMES, LIDAR_UNET_BATCH,
                              pipe.autoencoder.voxelizer, rasters=False)
    frames = LIDAR_UNET_BATCH * LIDAR_UNET_FRAMES
    train_counts, metrics = drive_train(
        dev, pipe, train_batch, ops, f"{tag} train", frames_per_step=frames,
        unit="LiDAR frames", may_stay=LIDAR_UNET_MAY_STAY)
    check_lidar_unet_census(train_counts, f"{tag} train",
                            LIDAR_UNET_K1_TRAIN, LIDAR_UNET_K7_TRAIN, True)
    metrics.update(generate_s=min(times), serve_peak_gib=serve_peak)
    return serve_counts, train_counts, metrics


def check_native_parity(parity: dict, tag: str) -> None:
    """The native library built and agreed with its numpy fallbacks on
    the archive: the same central directory, every deflated member inflated
    to the same bytes, every sweep decoded (with and without the range
    filter) to the same points and mask, the same occupancy grid."""
    log(f"{tag}: native vs fallback: {json.dumps(parity)}")
    if not parity["native"]:
        fail(f"{tag}: the native data plane did not build")
    if not parity["scan_equal"] or parity["inflate_mismatches"] or \
            parity["decode_mismatches"] or not parity["inflated"] or \
            not parity["decoded"] or parity["voxelize_equal"] is False:
        fail(f"{tag}: the native data plane disagrees with its fallback: "
             f"{parity}")


def check_items_equal(got: list, want: list, what: str) -> None:
    """``got`` and ``want`` (lists of reader items) equal key for key and
    bit for bit (``perf/data_plane.item_differences``)."""
    from opendwm_tpu_torch.perf.data_plane import item_differences

    if len(got) != len(want):
        fail(f"{what}: {len(got)} items against {len(want)}")
    bad = [d for i, (g, w) in enumerate(zip(got, want))
           for d in item_differences(g, w, f"item {i}")]
    if bad:
        fail(f"{what}: {len(bad)} differences, first {bad[:5]}")
    log(f"{what}: {len(got)} items equal, bit for bit")


def check_cli_events(events: list, steps: int, tag: str) -> None:
    """The train CLI logged every step, each with a loss (``*loss``), all
    finite, its seconds and the loader's wait."""
    if [e["step"] for e in events] != list(range(1, steps + 1)):
        fail(f"{tag}: logged steps {[e['step'] for e in events]}, want 1-"
             f"{steps}")
    for e in events:
        losses = [v for k, v in e.items() if k.endswith("loss")]
        if not losses or not all(isinstance(v, float) and math.isfinite(v)
                                 for v in losses) or \
                "data_wait_s" not in e or "step_s" not in e:
            fail(f"{tag}: step {e['step']} logged {e}")


def run_data_phase(dev, create_instance_from_config, ops):
    """Phase 23: the LiDAR UNet trained from a nuScenes-format archive
    through the config's own dataset section and the port's train CLI.
    ``perf/nuscenes_fixture.py`` writes the archive (deflated, with its
    ``.info.json``) and its extracted tree; the native zip scan, inflate,
    LiDAR decode and voxelizer must equal their fallbacks on it; the
    reader's items through ``CombinedZipFileSystem`` from ``DATA_WORKERS``
    threads must equal those through ``DirFileSystem`` over the tree in one
    thread (the rasters aside), and, with Pillow, one item's BEV rasters
    through both; the reader's items a second alone and through
    ``PrefetchLoader`` at 1 and ``DATA_WORKERS`` workers; then
    ``train.main --device cuda`` for ``DATA_STEPS`` steps of the config
    (only ``training_dataset.fs.paths`` and ``autoencoder_checkpoint_path``
    changed: a random VAEPointCloud saved by ``save_model_only``) with
    ``num_workers`` ``DATA_WORKERS``: a finite loss each step, K7 and its
    backward at ``LIDAR_UNET_K7_TRAIN`` only, K1 and K2 at
    ``LIDAR_UNET_K1_TRAIN`` only. The CLI's final checkpoint (the 1.92B
    UNet's fp32 weights and AdamW moments, ~23 GB) is not written."""
    import importlib.util
    import shutil

    import numpy as np

    from opendwm_tpu_torch import checkpoint, train
    from opendwm_tpu_torch.datasets.common import CollateFnIgnoring
    from opendwm_tpu_torch.perf import data_plane, nuscenes_fixture

    tag = "data"
    work = REPO / "build" / "data_phase"
    shutil.rmtree(work, ignore_errors=True)
    metrics: dict = {"packages": {
        name: importlib.util.find_spec(name) is not None
        for name in ("PIL", "fsspec", "pyarrow", "av", "botocore")}}
    log(f"{tag}: optional packages present: {json.dumps(metrics['packages'])}"
        " (this phase needs none of them but Pillow, for the rasters)")
    try:
        t0 = time.perf_counter()
        info = nuscenes_fixture.write_archive(
            work, NUSCENES_SAMPLES, NUSCENES_POINTS, NUSCENES_BOXES, SEED)
        tree = nuscenes_fixture.extract(info["archive"], work / "tree")
        archive = Path(info["archive"])
        metrics["write_s"] = time.perf_counter() - t0
        mib = archive.stat().st_size / 2**20
        log(f"{tag}: wrote {archive.name} ({mib:.1f} MiB deflated: "
            f"{info['samples']} samples of {info['points']} "
            f"points, {info['boxes']} boxes a sample) and its tree in "
            f"{metrics['write_s']:.2f} s")

        config = json.loads(LIDAR_UNET_CONFIG.read_text())
        vox = create_instance_from_config(
            config["pipeline"]["autoencoder"]["voxelizer"])
        pc_range = (vox.x_min, vox.y_min, vox.z_min, vox.x_max, vox.y_max,
                    vox.z_max)
        check_native_parity(data_plane.native_parity(
            archive.read_bytes(), pc_range,
            (vox.x_min, vox.y_min, vox.z_min, vox.step, vox.z_step,
             *vox.grid_shape)), tag)

        ds_cfg = copy.deepcopy(config["training_dataset"])
        ds_cfg["fs"]["paths"] = [str(archive)]
        plain = {k: v for k, v in ds_cfg.items() if k not in RASTER_SETTINGS}
        on_tree = {"_class_name": "dwm.fs.dirfs.DirFileSystem", "path": tree}
        zip_ds = create_instance_from_config(plain)
        dir_ds = create_instance_from_config(dict(plain, fs=on_tree))
        index = list(range(len(zip_ds)))
        t0 = time.perf_counter()
        got = data_plane.read_items(zip_ds, index * 2, DATA_WORKERS)
        metrics["threaded_read_s"] = time.perf_counter() - t0
        want = data_plane.read_items(dir_ds, index, 1)
        check_items_equal(got, want * 2, f"{tag}: the reader through "
                          f"CombinedZipFileSystem from {DATA_WORKERS} threads "
                          "vs DirFileSystem in one")
        del got, want
        if metrics["packages"]["PIL"]:
            rasters = [create_instance_from_config(
                {**{k: ds_cfg[k] for k in RASTER_SETTINGS}, **plain,
                 "fs": fs})[0] for fs in (ds_cfg["fs"], on_tree)]
            check_items_equal(
                [{k: rasters[0][k] for k in RASTER_KEYS}],
                [{k: rasters[1][k] for k in RASTER_KEYS}],
                f"{tag}: one item's BEV rasters through both filesystems")
            lit = [int(np.asarray(im).any(-1).sum())
                   for im in rasters[0]["3dbox_bev_images"]]
            if not all(lit):
                fail(f"{tag}: a BEV box raster is empty: {lit} pixels lit")
            log(f"{tag}: box rasters light {lit} pixels a frame")
        else:
            log(f"{tag}: Pillow is missing: the BEV raster check is skipped, "
                "and the training run reads without the raster settings "
                "(the train CLI drops the rasters in any case)")
            ds_cfg = plain
        reader = create_instance_from_config(ds_cfg)
        collate = CollateFnIgnoring()
        batch_size = config.get("batch_size", 1)
        data_plane.items_per_s(reader, index[:2])  # warm
        metrics["items_per_s"] = data_plane.items_per_s(reader, index)
        for w in (1, DATA_WORKERS):
            metrics[f"loader_items_per_s_{w}"] = \
                data_plane.loader_items_per_s(reader, batch_size, collate, w,
                                              DATA_LOADER_BATCHES, SEED)
        frames = config["training_dataset"]["sequence_length"]
        log(f"{tag}: the reader {metrics['items_per_s']:.1f} items/s alone, "
            f"{metrics['loader_items_per_s_1']:.1f} through PrefetchLoader "
            f"at 1 worker, {metrics[f'loader_items_per_s_{DATA_WORKERS}']:.1f}"
            f" at {DATA_WORKERS} ({DATA_LOADER_BATCHES} batches of "
            f"{batch_size} items of {frames} frames)")
        del reader, zip_ds, dir_ds

        with torch.device("meta"):
            vae = create_instance_from_config(
                config["pipeline"]["autoencoder"])
        vae.to_empty(device=dev)
        random_init_(vae, torch.Generator(dev).manual_seed(SEED))
        vae_path = work / "lidar_vae.pt"
        checkpoint.save_model_only(str(vae_path), vae)
        del vae
        run_cfg = copy.deepcopy(config)
        run_cfg["training_dataset"] = ds_cfg
        run_cfg["autoencoder_checkpoint_path"] = str(vae_path)
        run_cfg["training_dataloader"] = {"num_workers": DATA_WORKERS}
        cfg_path = work / "config.json"
        cfg_path.write_text(json.dumps(run_cfg))
        out = work / "out"
        args = train.create_parser().parse_args(
            ["-c", str(cfg_path), "-o", str(out), "--device", "cuda",
             "--max-steps", str(DATA_STEPS), "--log-steps", "1"])
        skipped = []
        save = train.ckpt_lib.save_checkpoint
        train.ckpt_lib.save_checkpoint = lambda *a, **k: skipped.append(a[1])
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            state = train.main(args)
        finally:
            train.ckpt_lib.save_checkpoint = save
        counts = ops.launch_counts()
        metrics["cli_s"] = time.perf_counter() - t0
        metrics["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        events = [json.loads(line) for line in
                  (out / "log" / "events.jsonl").read_text().splitlines()]
        check_cli_events(events, DATA_STEPS, tag)
        if state.step != DATA_STEPS:
            fail(f"{tag}: the CLI stopped at step {state.step}")
        del state
        for key in ("step_s", "data_wait_s", "sd_loss"):
            metrics[key] = [e[key] for e in events]
        log(f"{tag} train (the CLI, {DATA_STEPS} steps of {batch_size} x "
            f"{frames} frames): "
            f"{metrics['cli_s']:.1f} s in all; a step "
            f"{', '.join(f'{x:.3f}' for x in metrics['step_s'])} s, the wait "
            f"for the loader's batch "
            f"{', '.join(f'{x:.4f}' for x in metrics['data_wait_s'])} s; peak "
            f"{metrics['peak_gib']:.2f} GiB; sd_loss "
            f"{', '.join(f'{x:.4f}' for x in metrics['sd_loss'])}; the final "
            f"checkpoint of step {skipped} not written")
        check_lidar_unet_census(counts, f"{tag} train", LIDAR_UNET_K1_TRAIN,
                                LIDAR_UNET_K7_TRAIN, True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return counts, metrics


# Phase 24's files in the released layout: (folder, stem) of each source
# (an HF model's folder, or a file of the weights directory's root).
LAND_LAYOUT = {"vae": ("base/vae", "diffusion_pytorch_model"),
               "clip_l": ("base/text_encoder", "model"),
               "fid_inception": ("", "pt_inception-2015-12-05"),
               "i3d": ("", "i3d_pretrained_400")}


def land_sources(dev) -> dict:
    """Phase 24's sources, drawn on the card from ``SEED``: {name: (kind,
    model factory, the source model, model kwargs or None)}; the DiT and
    UNets in bf16 as their configs compute, the file kinds in fp32."""
    from opendwm_tpu_torch import run_all
    from opendwm_tpu_torch.models.autoencoders import sd35_vae
    from opendwm_tpu_torch.models.i3d import InceptionI3d
    from opendwm_tpu_torch.models.inception import FIDInceptionV3
    from opendwm_tpu_torch.models.mmdit import DiTCrossviewTemporal
    from opendwm_tpu_torch.models.text_encoders import CLIPTextEncoder
    from opendwm_tpu_torch.models.unet import UNetCrossviewTemporal

    dit_kw = run_all.load_model_kwargs(str(CONFIG))
    unet_kw = run_all.load_model_kwargs(str(UNET_CONFIG))
    sd21_kw = dict(unet_kw, enable_crossview=False, enable_temporal=False)
    specs = {
        "ctsd_dit": ("ctsd_dit", lambda: DiTCrossviewTemporal(**dit_kw),
                     dit_kw),
        "ctsd_unet": ("ctsd_unet", lambda: UNetCrossviewTemporal(**unet_kw),
                      unet_kw),
        "ctsd_unet_sd21": ("ctsd_unet",
                           lambda: UNetCrossviewTemporal(**sd21_kw), sd21_kw),
        "vae": ("vae", sd35_vae, None),
        "clip_l": ("clip", lambda: CLIPTextEncoder(**TEXT_ENCODERS["clip_l"]),
                   None),
        "fid_inception": ("fid_inception", FIDInceptionV3, None),
        "i3d": ("i3d", InceptionI3d, None),
    }
    gen = torch.Generator(dev).manual_seed(SEED)
    out = {}
    for i, (name, (kind, factory, kw)) in enumerate(specs.items()):
        with torch.device("meta"):
            model = factory()
        model.to_empty(device=dev)
        if kind == "clip":
            text_init_(model, gen)
        elif kind in ("i3d", "fid_inception"):
            run_all.lecun_normal_(model, SEED + i)
        else:
            random_init_(model, gen)
        out[name] = (kind, factory, model.eval(), kw)
    return out


def check_landed(name: str, entry: dict, twin_out, source_out) -> None:
    """A landed entry: ``verified`` (run_all's golden forward finite) and
    the imported weights' forward equal to the source's bit for bit."""
    if entry["status"] != "verified":
        fail(f"land {name}: {entry['status']}: {entry.get('error')}")
    if twin_out.shape != source_out.shape or \
            not torch.equal(twin_out, source_out):
        fail(f"land {name}: the imported model's golden forward differs from "
             f"the source's by {max_err(twin_out, source_out):.3e}")


def land_one(name: str, spec: tuple, source, dev, output=None) -> dict:
    """``run_all.import_entry`` of ``source`` (a file, an HF directory or a
    dict) for ``spec`` (``land_sources``): the entry, checked against the
    source model's golden forward by a twin of its architecture holding
    the imported weights (strict)."""
    from opendwm_tpu_torch import run_all

    kind, factory, model, kw = spec
    entry, state, checked = run_all.import_entry(
        name, kind, source, kw, dev, output=output)
    if checked is None:
        fail(f"land {name}: {entry['status']}: {entry.get('error')}")
    inputs = checked[1]
    del checked
    with torch.device("meta"):
        twin = factory()
    twin.to_empty(device=dev)
    twin.load_state_dict(state, strict=True)
    twin_out = run_all.golden_forward(kind, twin.eval(), inputs)
    source_out = run_all.golden_forward(kind, model, inputs)
    check_landed(name, entry, twin_out, source_out)
    if "load_s" in entry:
        entry["load_gb_per_s"] = entry["load_bytes"] / entry["load_s"] / 1e9
    log(f"land {name} ({kind}): {entry['status']}, {entry['n_params'] / 1e6:.2f}"
        f"M params, {entry['seconds']} s"
        + (f"; file load {entry['load_s']:.3f} s, "
           f"{entry['load_bytes'] / 1e9:.3f} GB, "
           f"{entry['load_gb_per_s']:.3f} GB/s" if "load_s" in entry else "")
        + "; forward equal to the source's bit for bit")
    return entry


def land_weights(dev, work: Path) -> tuple:
    """Part 1 of phase 24: the DiT and the UNets from in-memory reference
    dicts, the SD3.5 VAE, CLIP-L, the Inception and I3D through one
    ``.pth`` and one ``.safetensors`` file each in the reference layout
    (``run_all.discover`` must find the ``.pth`` tree with its kinds).
    Returns run_all's report and the landed VAE's file."""
    from opendwm_tpu_torch import run_all
    from opendwm_tpu_torch.perf.land_eval import (
        reference_state_dict,
        sd21_state_dict,
    )
    from opendwm_tpu_torch.torch_import import write_safetensors

    report = {"weights_dir": str(work / "sources"), "entries": []}
    sources = land_sources(dev)
    for name in ("ctsd_dit", "ctsd_unet", "ctsd_unet_sd21"):
        spec = sources.pop(name)
        sd = reference_state_dict(spec[0], spec[2])
        if name == "ctsd_unet_sd21":
            sd = sd21_state_dict(sd)
        report["entries"].append(land_one(name, spec, sd, dev))
        del spec, sd
        gc.collect()
        torch.cuda.empty_cache()
    for ext in (".pth", ".safetensors"):
        root = work / "sources" / ext[1:]
        want = {}
        for name, spec in sources.items():
            folder, stem = LAND_LAYOUT[name]
            # the TATS I3D file is a .pt
            path = root / folder / (stem + (".pt" if name == "i3d" and
                                            ext == ".pth" else ext))
            path.parent.mkdir(parents=True, exist_ok=True)
            sd = {k: v.detach().cpu() for k, v in
                  reference_state_dict(spec[0], spec[2]).items()}
            if ext == ".pth":
                torch.save(sd, path)
            else:
                write_safetensors(str(path), sd)
            rel = folder or path.name  # an HF model's entry is its folder
            want[rel] = spec[0]
            report["entries"].append(land_one(
                f"{name}{ext}", spec, str(root / rel), dev,
                output=str(work / "landed" / ext[1:])))
        if ext == ".pth":
            found = {rel: kind for rel, kind, _ in run_all.discover(str(root))}
            if found != want:
                fail(f"land: run_all.discover found {found}, want {want}")
    bad = [e for e in report["entries"] if e["status"] != "verified"]
    if bad:
        fail(f"land: entries not verified: {bad}")
    vae_file = next(e["out_path"] for e in report["entries"]
                    if e["file"] == "vae.pth")
    del sources
    return report, Path(vae_file)


def land_eval_config(vae_file: Path) -> dict:
    """The evaluate and preview CLIs' config at full width: phase 5's DiT
    (``CONFIG``; the implicit perspective embedding and its camera ids
    left out: ``SyntheticCTSDDataset`` carries no cameras) with
    ``STEPS`` flow-match steps and CFG 3.0, one synthetic batch of
    ``FRAMES`` x ``VIEWS`` latents of ``LAT_H`` x ``LAT_W`` with
    ``TEXT_TOKENS`` text tokens, the SD3.5 VAE in bf16 from ``vae_file``
    (a frozen stage) and the synthetic config's ``fid_proxy`` metric over
    the decoded RGB frames."""
    from opendwm_tpu_torch.perf import land_eval

    pipe = json.loads(CONFIG.read_text())["pipeline"]
    pipe["model"] = {k: v for k, v in pipe["model"].items()
                     if k not in ("perspective_modeling_type",
                                  "projection_class_embeddings_input_dim")}
    pipe["common_config"] = {
        k: v for k, v in pipe["common_config"].items()
        if k not in ("added_time_ids", "camera_intrinsic_embedding_indices",
                     "camera_intrinsic_denom_embedding_indices",
                     "camera_transform_embedding_indices")}
    pipe["inference_config"] = {"inference_steps": STEPS,
                                "guidance_scale": 3.0}
    data = {"_class_name": "SyntheticCTSDDataset", "size": 1,
            "sequence_length": FRAMES, "view_count": VIEWS,
            "latent_height": LAT_H, "latent_width": LAT_W,
            "latent_channels": 16, "text_length": TEXT_TOKENS,
            "text_dim": pipe["model"]["joint_attention_dim"],
            "pooled_dim": pipe["model"]["pooled_projection_dim"],
            "with_layout": False, "seed": SEED}
    collate = {"_class_name": "CollateFnIgnoring"}
    config = {"generator_seed": SEED, "batch_size": 1, "pipeline": pipe,
              "validation_dataset": data, "validation_collate_fn": collate,
              "preview_dataset": data, "preview_collate_fn": collate}
    vae = {"_class_name": "AutoencoderKL", "latent_channels": 16,
           "use_quant_conv": False, "scaling_factor": 1.5305,
           "shift_factor": 0.0609,
           "dtype": {"_class_name": "get_class",
                     "class_name": "torch.bfloat16"}}
    return land_eval.with_vae(config, vae, vae_file)


def run_eval_cli(dev, ops, config_path: Path, out: Path) -> tuple:
    """Part 2 of phase 24: ``evaluate.main --device cuda`` on the
    full-width config, the metric's decoded frames tapped; then the FID /
    FVD drill on those frames. Returns the evaluation's launch counts and
    its numbers."""
    from opendwm_tpu_torch import evaluate
    from opendwm_tpu_torch.metrics.frechet import FrechetPairedMetric
    from opendwm_tpu_torch.perf import land_eval
    from opendwm_tpu_torch.pipelines.ctsd import CTSDPipeline

    tapped, timed = [], {}
    update, evaluate_pipeline = (FrechetPairedMetric.update,
                                 CTSDPipeline.evaluate_pipeline)

    def tap(self, real, fake):
        tapped.append((real, fake))
        return update(self, real, fake)

    def timed_evaluate(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = evaluate_pipeline(self, *args, **kwargs)
        torch.cuda.synchronize()
        timed["evaluate_pipeline_s"] = time.perf_counter() - t0
        return out

    FrechetPairedMetric.update = tap
    CTSDPipeline.evaluate_pipeline = timed_evaluate
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        results = evaluate.main(evaluate.create_parser().parse_args(
            ["-c", str(config_path), "-o", str(out), "--device", dev.type,
             "--max-batches", "1"]))
    finally:
        FrechetPairedMetric.update = update
        CTSDPipeline.evaluate_pipeline = evaluate_pipeline
    counts = ops.launch_counts()
    metrics = {"cli_s": time.perf_counter() - t0, **timed,
               "results": results,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    if set(results) != {"evaluation/fid_proxy"} or \
            not all(math.isfinite(v) for v in results.values()):
        fail(f"land eval: the evaluation JSON {results}")
    if len(tapped) != 1:
        fail(f"land eval: the metric saw {len(tapped)} batches, not 1")
    real, fake = tapped[0]
    want = (1, FRAMES, VIEWS, 8 * LAT_H, 8 * LAT_W, 3)
    for what, x in (("real", real), ("fake", fake)):
        if tuple(x.shape) != want or not bool(torch.isfinite(x).all()):
            fail(f"land eval: the decoded {what} frames "
                 f"{tuple(x.shape)} are not finite / {want}")
    log(f"land eval: evaluate CLI {metrics['cli_s']:.1f} s in all, "
        f"evaluate_pipeline {metrics['evaluate_pipeline_s']:.3f} s for its "
        f"batch ({STEPS} CFG steps at {FRAMES} x {VIEWS} x {LAT_H} x "
        f"{LAT_W}, the decode of real and generated frames, the metric); "
        f"peak {metrics['peak_gib']:.2f} GiB; {json.dumps(results)}")
    log(f"land eval: launches {json.dumps(counts)}")
    forwards = STEPS
    k3, k4 = counts["adaln_modulate"], counts["residual_adaln_modulate"]
    if k3 != K3_PER_FORWARD * forwards or k4 != K4_PER_FORWARD * forwards:
        fail(f"land eval: K3/K4 launched {k3}/{k4} times in {forwards} CFG "
             f"forwards, not {K3_PER_FORWARD}/{K4_PER_FORWARD} a forward")
    check_launch_shapes(counts, {
        "flash_tail_by_shape": [(b, s, 24, 64) for b, s in ATTN_SHAPES],
        "adaln_modulate_by_shape": ADALN_SHAPES[:2],
        "residual_adaln_modulate_by_shape": ADALN_SHAPES[:2]},
        "land eval")
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    drill = land_eval.frames_drill(real, fake, dev)
    drill["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    metrics["drill"] = drill
    log(f"land eval: the drill on the decoded frames: FID "
        f"{drill['fid']:.6e} over {drill['fid_images']} frames a side at "
        f"{land_eval.FID_SIZE}², FVD {drill['fvd']:.6e} over "
        f"{drill['fvd_clips']} view clips a side at {land_eval.FVD_SIZE}² "
        f"(random-weight nets, shrinkage); {drill['seconds']:.2f} s, peak "
        f"{drill['peak_gib']:.2f} GiB")
    return counts, metrics


def run_maskgit_eval(dev, create_instance_from_config, work: Path) -> dict:
    """Part 3b of phase 24: MaskGIT's ``evaluate_pipeline`` (voxel IoU,
    voxel diff, Chamfer) and ``save_results`` for one generation at phase
    12's geometry."""
    pipe, gen = build_lidar(
        create_instance_from_config, LIDAR_MASKGIT_CONFIG, dev,
        ("vq", "model"), bf16=(("vq_point_cloud", "lidar_encoder"),
                               ("vq_point_cloud", "lidar_decoder"),
                               ("bi_directional_transformer",)))
    pipe.blank_code = LIDAR_BLANK_CODE
    pipe.inference_config["sample_steps"] = MASKGIT_STEPS
    batch = lidar_batch(dev, gen, 1)
    results, eval_s = sync_s(lambda: pipe.evaluate_pipeline(
        pipe.model, [batch], gen))
    if set(results) != {"evaluation/voxel_iou", "evaluation/voxel_diff",
                        "evaluation/chamfer"} or \
            not all(math.isfinite(v) for v in results.values()):
        fail(f"land maskgit: evaluation {results}")
    out, _ = sync_s(lambda: pipe.inference_pipeline(batch, generator=gen))
    paths = pipe.save_results(out, batch, str(work / "maskgit"), "0")
    if len(paths) != 1 or not Path(paths[0]).is_file() or \
            Path(paths[0]).stat().st_size == 0:
        fail(f"land maskgit: save_results wrote {paths}")
    occupied = float(out["pred_voxels"].float().mean())
    log(f"land maskgit: evaluate_pipeline {eval_s:.3f} s (one generation "
        f"of {MASKGIT_STEPS} steps, the Chamfer over the occupied voxels' "
        f"centres: {occupied:.4f} of the grid predicted), "
        f"{json.dumps(results)}; save_results wrote {paths}")
    return {"evaluate_s": eval_s, "results": results,
            "pred_occupied": occupied, "bev": paths[0]}


def run_train_flags(dev, work: Path) -> dict:
    """Part 4 of phase 24: the train CLI on the card with
    ``--evaluation-steps 1 --preview-steps 1 --profile-steps 1:1`` for 2
    steps of ``TINY_CONFIG`` with a tiny VAE landed by ``convert_cli`` as
    its ``vae_checkpoint_path``: the metric logged at both steps, both
    previews and the trace written."""
    from opendwm_tpu_torch import train
    from opendwm_tpu_torch.perf import land_eval

    config = land_eval.with_vae(json.loads(TINY_CONFIG.read_text()),
                                land_eval.TINY_VAE,
                                land_eval.land_tiny_vae(work / "tiny_vae"))
    cfg = land_eval.write_config(config, work / "tiny.json")
    out = work / "tiny_out"
    t0 = time.perf_counter()
    train.main(train.create_parser().parse_args(
        ["-c", str(cfg), "-o", str(out), "--device", dev.type,
         "--max-steps", "2", "--log-steps", "1", "--evaluation-steps", "1",
         "--preview-steps", "1", "--profile-steps", "1:1"]))
    cli_s = time.perf_counter() - t0
    events = [json.loads(line) for line in
              (out / "log" / "events.jsonl").read_text().splitlines()]
    evals = {e["step"]: e["evaluation/fid_proxy"] for e in events
             if "evaluation/fid_proxy" in e}
    if sorted(evals) != [1, 2] or \
            not all(math.isfinite(v) for v in evals.values()):
        fail(f"land train CLI: evaluations {evals}")
    if [e["step"] for e in events if "profile_written" in e] != [2]:
        fail("land train CLI: the profile was not logged at step 2")
    previews = sorted(p.name for p in (out / "preview").iterdir())
    traces = [p for p in (out / "profile").glob("*.json")
              if p.stat().st_size > 0]
    if previews != ["1.gif", "2.gif"] or len(traces) != 1:
        fail(f"land train CLI: previews {previews}, traces {traces}")
    log(f"land train CLI: 2 steps with evaluation, preview and a profile "
        f"of step 2 in {cli_s:.1f} s: fid_proxy {json.dumps(evals)}, "
        f"previews {previews}, trace {traces[0].name} "
        f"({traces[0].stat().st_size / 2**20:.1f} MiB)")
    return {"cli_s": cli_s, "fid_proxy": evals,
            "trace_mib": traces[0].stat().st_size / 2**20}


def run_land_eval_phase(dev, create_instance_from_config, ops) -> tuple:
    """Phase 24: weight landing and evaluation (``land_weights``,
    ``run_eval_cli``, the preview CLI, ``run_maskgit_eval``,
    ``run_train_flags``). Returns the evaluate CLI's launch counts (the
    ``land_eval`` path) and the phase's numbers."""
    import shutil

    from opendwm_tpu_torch import preview
    from opendwm_tpu_torch.perf import land_eval

    work = REPO / "build" / "land_eval"
    shutil.rmtree(work, ignore_errors=True)
    metrics: dict = {}
    try:
        t0 = time.perf_counter()
        report, vae_file = land_weights(dev, work)
        metrics["land_s"] = time.perf_counter() - t0
        metrics["report"] = report
        log(f"land: {len(report['entries'])} entries verified, each forward "
            f"equal to its source's, in {metrics['land_s']:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()

        cfg = land_eval.write_config(land_eval_config(vae_file),
                                     work / "eval.json")
        counts, metrics["evaluate"] = run_eval_cli(dev, ops, cfg,
                                                   work / "eval_out")
        gc.collect()
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        paths = preview.main(preview.create_parser().parse_args(
            ["-c", str(cfg), "-o", str(work / "eval_out"), "--device",
             dev.type, "--max-batches", "1"]))
        metrics["preview_cli_s"] = time.perf_counter() - t0
        if len(paths) != 1 or not Path(paths[0]).is_file():
            fail(f"land preview: the CLI wrote {paths}")
        log(f"land preview: the CLI wrote {Path(paths[0]).name} "
            f"({Path(paths[0]).stat().st_size / 2**20:.2f} MiB) in "
            f"{metrics['preview_cli_s']:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()

        metrics["maskgit"] = run_maskgit_eval(
            dev, create_instance_from_config, work)
        gc.collect()
        torch.cuda.empty_cache()
        metrics["train_cli"] = run_train_flags(dev, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return counts, metrics


def census_sm90(_build, sources, body: str) -> dict:
    """ptxas's registers and spills (from the report kept beside each
    library, so a library built by an earlier run is held too) and a SASS
    census (``cuobjdump -sass``) of the instances of the Hopper kernel
    ``body`` (``flash_fwd_sm90``, ``tail_tiling_sm90`` or
    ``flash_bwd_sm90``) in each built library of ``sources``. Fails on a
    library without an instance, an instance that ptxas did not report, a
    spill, or an instance without ``HGMMA`` or ``UTMALDG`` or with
    ``HMMA``."""
    census = {}
    for source in sources:
        lib = _build.library_path(source)
        ptxas = _build.ptxas_report(lib, body)
        sass = _build.sass_census(lib, f"{body}_kernel")
        if not sass:
            fail(f"no {body} instance in the SASS of {source}")
        for name, ops in sass.items():
            flags = name.split(f"{body}_kernel")[-1].split("EEEv")[0]
            entry = {**ptxas.get(name, {}), **ops}
            census[f"{source}:{flags}"] = entry
            log(f"  {body} {source} {flags}: {json.dumps(entry)}")
            if "spill_bytes" not in entry or "registers" not in entry:
                fail(f"ptxas reported no registers or spills for {body} "
                     f"{source} {flags}")
            if entry["spill_bytes"] or not ops["HGMMA"] or \
                    not ops["UTMALDG"] or ops["HMMA"]:
                fail(f"{body} {source} {flags} spills, lacks wgmma or TMA "
                     f"loads, or runs mma.sync: {entry}")
    return census


def check_adaln_ptxas(_build) -> dict:
    """ptxas's registers and spills for every kernel of ``csrc/adaln.cu``
    (the d-1536 and runtime-width kernels of K3 and K4 in fp32, bf16 and
    fp16: 12), from the report kept beside the library. Fails on a missing
    instance, one ptxas did not report, or a spill."""
    report = _build.ptxas_report(_build.library_path("adaln.cu"), "adaln_")
    for fn, entry in report.items():
        log(f"  adaln.cu {fn}: {json.dumps(entry)}")
        if "spill_bytes" not in entry or "registers" not in entry or \
                entry["spill_bytes"]:
            fail(f"adaln.cu {fn} spills or was not reported: {entry}")
    if len(report) != 12:
        fail(f"adaln.cu has {len(report)} kernels in ptxas's report, not 12")
    return report


def check_adaln_on_paths(paths: dict) -> None:
    """Every K3 and K4 launch of the DiT paths (``DIT_PATHS``) ran the
    d-1536 kernel, and each path launched both."""
    for path in DIT_PATHS:
        c = paths[path]
        for key in ("adaln_modulate", "residual_adaln_modulate"):
            log(f"{path}: {key} {c[key]} launches, {c[f'{key}_fixed']} on "
                f"the d-1536 kernel, by shape "
                f"{json.dumps(c[f'{key}_by_shape'])}")
            if c[key] == 0 or c[f"{key}_fixed"] != c[key]:
                fail(f"{path}: {key} launched {c[key]} times, "
                     f"{c[f'{key}_fixed']} of them on the d-1536 kernel")


def check_new_body_on_paths(paths: dict) -> None:
    """Every forward launch of K1, K7 and K7-seg on the model paths
    (``MODEL_PATHS``) ran the Hopper forward, and every backward launch of
    K2 and K7 on the training paths (``TRAIN_PATHS``) the Hopper backward
    (bf16, head dim 64, aligned), none an old body."""
    for path in TRAIN_PATHS:
        c = paths[path]
        k2_old = c["flash_tail_backward"] - c["flash_tail_backward_sm90"]
        k7_old = c["flash_attention_backward"] - \
            c["flash_attention_backward_sm90"]
        log(f"{path}: K2 {c['flash_tail_backward']} launches, "
            f"{c['flash_tail_backward_sm90']} on the Hopper backward; K7 "
            f"backward {c['flash_attention_backward']}, "
            f"{c['flash_attention_backward_sm90']} on it")
        if k2_old or k7_old:
            fail(f"{path}: {k2_old} K2 and {k7_old} K7 backward launches ran "
                 "an old body")
    for path in MODEL_PATHS:
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
    from opendwm_tpu_torch.models import mask_layers
    from opendwm_tpu_torch.models.mmdit import DiTCrossviewTemporal
    from opendwm_tpu_torch.models.temporal_vae import TemporalAutoencoderKL
    from opendwm_tpu_torch.models.unet import UNetCrossviewTemporal
    from opendwm_tpu_torch.ops import (
        _build,
        flash_attention,
        flash_tail,
        fused_adaln,
    )
    from opendwm_tpu_torch.perf import (
        exp_attn602,
        exp_int8_fidelity,
        exp_tailvar,
        unimlvg_tiny,
    )
    from opendwm_tpu_torch.pipelines.ctsd import (
        draw_training_randoms,
        get_conditions,
    )
    from opendwm_tpu_torch.pipelines.ctsd_streaming import (
        StreamingCTSDPipeline,
    )
    from opendwm_tpu_torch.pipelines.unimlvg import draw_unimlvg_randoms

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}")

    t0 = time.perf_counter()
    _build.build_all(SOURCES)
    flash_tail.build()
    flash_attention.build()
    fused_adaln.build()
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc sm_90a, one process "
        f"per source), sources under {Path(_build.CSRC).relative_to(REPO)}")
    for source in SOURCES:
        for line in _build.ptxas_log(_build.library_path(source)).splitlines():
            low = line.lower()
            if any(w in low for w in ("registers", "spill", "wgmma",
                                      "setmaxnreg")):
                log(f"  ptxas {source}: {line.strip()}")
    sources = ("flash_tail.cu", "flash_attention.cu")  # the attention
    sm90_census = census_sm90(_build, sources, "flash_fwd_sm90")
    tiling_census = census_sm90(_build, ("flash_tail.cu",),
                                "tail_tiling_sm90")
    bwd90_census = census_sm90(_build, sources, "flash_bwd_sm90")
    adaln_ptxas = check_adaln_ptxas(_build)

    log_clocks("before the kernel checks")
    attn_rows = check_attention(dev, flash_tail)
    bwd_rows, lse_timing = check_attention_backward(dev, flash_tail)
    unet_k1_rows, k7_rows = check_unet_attention(dev, flash_tail,
                                                 flash_attention)
    k7_bwd_rows, k7_lse_timing = check_flash_attention_backward(
        dev, flash_attention)
    k7_seg_rows = check_flash_attention_segment(dev, flash_attention)
    dit_k7_rows = check_dit_k7(dev, flash_attention)
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
    check_tiny_text(dev)
    check_tiny_stream(dev, DiTCrossviewTemporal, StreamingCTSDPipeline,
                      flash_tail)
    gc.collect()
    torch.cuda.empty_cache()
    log_clocks("before the serving slice")
    serve = run_slice(dev, create_instance_from_config, sd35_vae, ops,
                      get_conditions,
                      profile="--profile-dit" in sys.argv[1:])
    gc.collect()
    torch.cuda.empty_cache()
    log_clocks("before the stream slice")
    stream, stream_metrics = run_stream_slice(
        dev, create_instance_from_config, sd35_vae, ops, get_conditions,
        profile="--profile-stream" in sys.argv[1:])
    gc.collect()
    torch.cuda.empty_cache()
    log_clocks("before the UNet serving slice")
    unet, _ = run_unet_slice(dev, create_instance_from_config, sd21_vae, ops,
                             get_conditions,
                             profile="--profile-unet" in sys.argv[1:])
    gc.collect()
    torch.cuda.empty_cache()
    log_clocks("before the train slice")
    train, train_metrics = run_train_slice(
        dev, create_instance_from_config, ops,
        profile="--profile-train" in sys.argv[1:])
    gc.collect()
    torch.cuda.empty_cache()
    log_clocks("before the UNet train slice")
    unet_train, _ = run_unet_train_slice(
        dev, create_instance_from_config, ops,
        profile="--profile-unet-train" in sys.argv[1:])
    gc.collect()
    torch.cuda.empty_cache()
    log_clocks("before the bm DiT serving slice")
    bm_serve = run_slice(dev, create_instance_from_config, sd35_vae, ops,
                         get_conditions, config=BM_CONFIG, layout=True,
                         tag="bm serve")
    gc.collect()
    torch.cuda.empty_cache()
    log_clocks("before the bm UNet serving slice")
    bm_unet, _ = run_unet_slice(dev, create_instance_from_config, sd21_vae,
                                ops, get_conditions, config=BM_UNET_CONFIG,
                                layout=True, tag="bm unet")
    gc.collect()
    torch.cuda.empty_cache()
    log_clocks("before the int8 serving slice")
    int8_serve, int8_unet, _ = run_int8_slice(
        dev, sd35_vae, ops, get_conditions, exp_int8_fidelity)
    gc.collect()
    torch.cuda.empty_cache()
    log_clocks("before the bm DiT train slice")
    bm_train, bm_train_metrics = run_train_slice(
        dev, create_instance_from_config, ops, config=BM_CONFIG,
        sd35_vae=sd35_vae, tag="bm train",
        profile="--profile-train" in sys.argv[1:])
    log(f"train peak memory: nwao (fp32 moments) "
        f"{train_metrics['peak_gib']:.2f} GiB, bm (bf16 moments, "
        f"+ImageAdapter, +VAE encoder) {bm_train_metrics['peak_gib']:.2f} "
        f"GiB; the update alone: nwao (fused AdamW) "
        f"{train_metrics['update_s']:.4f} s, bm (FlatAdamW) "
        f"{bm_train_metrics['update_s']:.4f} s")
    lidar = {}
    for name, run, args in (
            ("lidar_maskgit", run_lidar_maskgit, ()),
            ("lidar_maskgit_rollout", run_lidar_rollout, ()),
            ("lidar_dit", run_lidar_dit, (get_conditions,))):
        gc.collect()
        torch.cuda.empty_cache()
        log_clocks(f"before the {name} phase")
        lidar[name] = run(dev, create_instance_from_config, ops, *args)
    phase_s = {}
    gc.collect()
    torch.cuda.empty_cache()
    log_clocks("before the UniMLVG serving phase")
    t0 = time.perf_counter()
    unimlvg_serve, unimlvg_metrics, unimlvg_pipe = run_unimlvg_slice(
        dev, create_instance_from_config, sd35_vae, ops, get_conditions,
        unimlvg_tiny)
    phase_s["unimlvg_serve"] = time.perf_counter() - t0
    log_clocks("before the branch-type and MaskGWM phase")
    t0 = time.perf_counter()
    branch_types, mask_step, branch_metrics = run_branch_types(
        dev, unimlvg_pipe, ops, get_conditions, unimlvg_tiny, mask_layers)
    phase_s["branch_types_and_mask_step"] = time.perf_counter() - t0
    del unimlvg_pipe
    gc.collect()
    torch.cuda.empty_cache()
    log_clocks("before the UniMLVG train phase")
    t0 = time.perf_counter()
    unimlvg_train, unimlvg_train_metrics = run_unimlvg_train(
        dev, create_instance_from_config, ops, unimlvg_tiny,
        draw_unimlvg_randoms, profile="--profile-train" in sys.argv[1:])
    phase_s["unimlvg_train"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    log_clocks("before the temporal VAE phase")
    t0 = time.perf_counter()
    temporal_vae, tvae_metrics = run_temporal_vae(
        dev, ops, TemporalAutoencoderKL, unimlvg_tiny)
    phase_s["temporal_vae"] = time.perf_counter() - t0
    lidar_train, lidar_train_metrics = {}, {}
    for name, run in (("lidar_tokenizer_train", run_lidar_tokenizer_train),
                      ("lidar_maskgit_train", run_lidar_maskgit_train),
                      ("lidar_dit_train", run_lidar_dit_train),
                      ("lidar_unet", run_lidar_unet)):
        gc.collect()
        torch.cuda.empty_cache()
        log_clocks(f"before the {name} phase")
        t0 = time.perf_counter()
        *counts, lidar_train_metrics[name] = run(
            dev, create_instance_from_config, ops)
        lidar_train_metrics[name]["phase_s"] = time.perf_counter() - t0
        log(f"{name}: {lidar_train_metrics[name]['phase_s']:.1f} s")
        if name == "lidar_tokenizer_train":
            lidar_train["lidar_tokenizer_train"], \
                lidar_train["lidar_vae_train"] = counts
        elif name == "lidar_unet":
            lidar_train["lidar_unet_serve"], \
                lidar_train["lidar_unet_train"] = counts
        else:
            lidar_train[name] = counts[0]
    gc.collect()
    torch.cuda.empty_cache()
    log_clocks("before the data phase")
    t0 = time.perf_counter()
    lidar_train["lidar_unet_data"], data_metrics = run_data_phase(
        dev, create_instance_from_config, ops)
    data_metrics["phase_s"] = time.perf_counter() - t0
    log(f"data: {data_metrics['phase_s']:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    log_clocks("before the weight-landing and evaluation phase")
    t0 = time.perf_counter()
    land_counts, land_metrics = run_land_eval_phase(
        dev, create_instance_from_config, ops)
    land_metrics["phase_s"] = time.perf_counter() - t0
    log(f"land and evaluate: {land_metrics['phase_s']:.1f} s")
    log_clocks("at the end")
    log(f"weight landing and evaluation ({card}): " + json.dumps(
        {k: v for k, v in land_metrics.items() if k != "report"}))
    log(f"run_all's report ({card}): " + json.dumps(land_metrics["report"]))
    log(f"the data phase ({card}): " + json.dumps(data_metrics))
    log(f"LiDAR training and the LiDAR UNet ({card}): "
        + json.dumps(lidar_train_metrics))
    log(f"UniMLVG and the DiT's other options ({card}): " + json.dumps({
        "phase_s": phase_s, "unimlvg_serve": unimlvg_metrics,
        "branch_types": branch_metrics,
        "unimlvg_train": {k: v for k, v in unimlvg_train_metrics.items()
                          if k != "moments"},
        "temporal_vae": tvae_metrics}))
    log(f"LiDAR serving ({card}): "
        + json.dumps({k: m for k, (_, m) in lidar.items()}))
    log(f"stream: {stream_metrics['steady_ms']['median']:.1f} ms a frame "
        f"steady, {stream_metrics['amortised_ms']:.1f} with the text "
        f"refresh amortised, peak {stream_metrics['peak_gib']:.2f} GiB, busy "
        f"{100 * stream_metrics['busy']:.1f}%")
    paths = {"serve": serve, "train": train, "unet_serve": unet,
             "unet_train": unet_train, "bm_serve": bm_serve,
             "bm_unet_serve": bm_unet, "bm_train": bm_train,
             "stream": stream, "int8_serve": int8_serve,
             "int8_unet": int8_unet, "tailvar": tailvar, "attn602": attn602,
             **{k: c for k, (c, _) in lidar.items()},
             "unimlvg_serve": unimlvg_serve, "branch_types": branch_types,
             "mask_step": mask_step, "unimlvg_train": unimlvg_train,
             "temporal_vae": temporal_vae, **lidar_train,
             "land_eval": land_counts}
    strays = {p: c["flash_attention_segment"] for p, c in paths.items()
              if p != "attn602" and c["flash_attention_segment"]}
    if strays:
        fail(f"flash_attention_segment launched outside the shoot-out: "
             f"{strays}")
    check_new_body_on_paths(paths)
    check_adaln_on_paths(paths)

    def adaln_times(rows):  # the main shape's other three timings
        return {k: rows[0][k] for k in ("device_ms", "device_ms_cold",
                                         "host_us")}

    def entry(name, route, source, replaces, key, rows, **extra):
        by_path = {path: counts.get(key, 0) for path, counts in paths.items()}
        if key in ("flash_tail", "flash_attention", "flash_tail_backward",
                   "flash_attention_backward", "tail_hpack", "tail_qsplit"):
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
    adaln_src = "opendwm_tpu_torch/csrc/adaln.cu"
    adaln_body = (f"{adaln_src}:adaln_stream_kernel (d 1536, rows by bulk "
                  "copy), adaln_any_kernel (other widths)")
    k7_src = "opendwm_tpu_torch/csrc/flash_attention.cu"
    sm90_src = "opendwm_tpu_torch/csrc/flash_fwd_sm90.cuh"
    bwd90_src = "opendwm_tpu_torch/csrc/flash_bwd_sm90.cuh"
    tiling_src = "opendwm_tpu_torch/csrc/tail_tiling_sm90.cuh"
    kernels = [
        entry("flash_tail_forward", "cuda", csrc,
              "opendwm_tpu/ops/flash_tail.py:55", "flash_tail",
              attn_rows + unet_k1_rows,
              lse_ms=lse_timing["lse_ms"],
              serving_ms_beside_lse=lse_timing["serving_ms"],
              body=sm90_src, sass=sm90_census),
        entry("flash_tail_backward", "cuda", csrc,
              "opendwm_tpu/ops/flash_tail.py:125", "flash_tail_backward",
              bwd_rows, body=bwd90_src, sass=bwd90_census),
        entry("adaln_modulate", "cuda", adaln_src,
              "opendwm_tpu/ops/fused_adaln.py:45", "adaln_modulate",
              adaln_rows["adaln_modulate"], body=adaln_body,
              ptxas=adaln_ptxas, **adaln_times(adaln_rows["adaln_modulate"])),
        entry("residual_adaln_modulate", "cuda", adaln_src,
              "opendwm_tpu/ops/fused_adaln.py:133", "residual_adaln_modulate",
              adaln_rows["residual_adaln_modulate"], body=adaln_body,
              ptxas=adaln_ptxas, **adaln_times(adaln_rows["residual_adaln_modulate"])),
        entry("flash_attention_forward", "cuda", k7_src,
              "opendwm_tpu/ops/attention.py:151", "flash_attention",
              k7_rows + dit_k7_rows,
              lse_ms=k7_lse_timing["lse_ms"],
              serving_ms_beside_lse=k7_lse_timing["serving_ms"],
              lse_library_ms=k7_lse_timing["lse_library_ms"],
              at_k1_shapes=k7_at_k1, body=sm90_src),
        entry("flash_attention_backward", "cuda", k7_src,
              f"{STOCK_FLASH}:941", "flash_attention_backward", k7_bwd_rows,
              replaces_also=f"{STOCK_FLASH}:1287",
              at_k2_shapes=k7_bwd_at_k2, body=bwd90_src),
        entry("tail_hpack", "cuda", csrc, "perf/exp_tailvar.py:75",
              "tail_hpack", tiling_rows["tail_hpack"], body=tiling_src,
              sass=tiling_census),
        entry("tail_qsplit", "cuda", csrc, "perf/exp_tailvar.py:119",
              "tail_qsplit", tiling_rows["tail_qsplit"], body=tiling_src,
              sass=tiling_census),
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
