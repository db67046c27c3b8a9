"""Pieces shared by ``chip_smoke.py``'s weight-landing and evaluation
phase and its CPU tests: the reference-named sources of the port's own
models, a tiny image VAE landed through ``convert_cli`` for the CLIs'
``vae_checkpoint_path``, and the FID / FVD drill on decoded frames.

- ``reference_state_dict``: a port model's weights in the released
  checkpoints' names (the DiT, UNet, VAE, I3D and Inception carry them
  already; CLIP and T5 get HF's), and ``sd21_state_dict``: a UNet's in
  SD2.1-era keys (no ``spatial_res_block``; a dict with temporal resnets
  cannot be one: the remap would wrap those too).
- ``land_tiny_vae``: a diffusers-named VAE file through ``convert_cli
  --kind vae``; ``with_vae``: a config with that VAE as a frozen stage and
  the ``fid_proxy`` metric at 6 features (the channel means and standard
  deviations of RGB frames; the synthetic config's 32 count its 16-channel
  latents).
- ``frames_drill``: FID (``FIDInceptionV3`` at ``FID_SIZE``) over every
  frame and FVD (``InceptionI3d`` at ``FVD_SIZE``) over every view's clip
  of two sets of decoded frames, random nets (``run_all.lecun_normal_``)
  and covariance shrinkage, as ``run_all``'s drill scores them.
"""

from __future__ import annotations

import copy
import json
import re
import time
from pathlib import Path

import torch

from opendwm_tpu_torch import convert_cli, run_all

TINY_VAE = {"_class_name": "AutoencoderKL",
            "block_out_channels": [8, 8, 16, 16], "latent_channels": 16,
            "use_quant_conv": False, "scaling_factor": 1.5305,
            "shift_factor": 0.0609}
RGB_FEATURES = 6
FID_SIZE, FVD_SIZE = 299, 224


def reference_state_dict(kind: str, model: torch.nn.Module) -> dict:
    """``model``'s weights named as the released checkpoints of ``kind``
    name them."""
    sd = model.state_dict()
    if kind == "clip":
        return run_all.hf_clip_state_dict(sd)
    if kind == "t5":
        return run_all.hf_t5_state_dict(sd)
    if kind == "ctsd_dit" and "rayencoder_proj.weight" in sd:
        sd = {k.replace("rayencoder_proj", "rayencoder.proj"): v
              for k, v in sd.items()}
    return sd


def sd21_state_dict(unet_sd: dict) -> dict:
    """A UNet state dict without temporal resnets in SD2.1-era keys."""
    if any(re.search(r"resnets\.\d+\.(temporal_res_block|time_mixer)", k)
           for k in unet_sd):
        raise ValueError("an SD2.1-era dict has no temporal resnets")
    return {k.replace(".spatial_res_block", ""): v
            for k, v in unet_sd.items()}


def land_tiny_vae(work: Path, seed: int = 0) -> Path:
    """A ``TINY_VAE`` drawn from ``seed``, written in diffusers' names and
    landed by ``convert_cli --kind vae``; returns the port file."""
    from opendwm_tpu_torch.models.autoencoders import AutoencoderKL

    work.mkdir(parents=True, exist_ok=True)
    torch.manual_seed(seed)
    vae = AutoencoderKL(**{k: v for k, v in TINY_VAE.items()
                           if k != "_class_name"})
    torch.save(vae.state_dict(), work / "diffusion_pytorch_model.pth")
    out = work / "vae.pt"
    convert_cli.main(["--kind", "vae", "--input",
                      str(work / "diffusion_pytorch_model.pth"),
                      "--output", str(out)])
    return out


def with_vae(config: dict, vae: dict, vae_path: Path,
             num_features: int = RGB_FEATURES) -> dict:
    """``config`` with ``vae`` (a config node) loaded from ``vae_path`` as
    its frozen image VAE, and its ``fid_proxy`` metric over RGB frames."""
    config = copy.deepcopy(config)
    config["vae"] = dict(vae)
    config["vae_checkpoint_path"] = str(vae_path)
    config["metrics"] = {"fid_proxy": {
        "_class_name": "FrechetPairedMetric", "num_features": num_features}}
    return config


def write_config(config: dict, path: Path) -> Path:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(config, indent=1))
    return path


def views_to_clips(media: torch.Tensor, size: int) -> torch.Tensor:
    """(b, t, v, h, w, c) frames in [-1, 1] → every view's clip as
    (b·v, t, size, size, 3) in [0, 1] (bilinear a frame)."""
    b, t, v, h, w = media.shape[:5]
    clips = media[..., :3].permute(0, 2, 1, 3, 4, 5).reshape(b * v, t, h, w,
                                                             3)
    frames = run_all.to_images(clips, size)  # (b·v·t, size, size, 3)
    return frames.reshape(b * v, t, size, size, 3)


@torch.inference_mode()
def frames_drill(real: torch.Tensor, fake: torch.Tensor, device,
                 seeds=run_all.DRILL_SEEDS[:2],
                 fid_size: int = FID_SIZE, fvd_size: int = FVD_SIZE) -> dict:
    """FID over every frame and FVD over every view's clip of ``real`` and
    ``fake`` ((b, t, v, h, w, 3) in [-1, 1]) with random-weight nets drawn
    from ``seeds`` and ``run_all.DRILL_SHRINKAGE``; the distances, the
    samples and the seconds. Distinct inputs must give distances above 0
    (``run_all``'s gate)."""
    from opendwm_tpu_torch.metrics.frechet import FrechetPairedMetric
    from opendwm_tpu_torch.models.i3d import InceptionI3d
    from opendwm_tpu_torch.models.inception import FIDInceptionV3

    t0 = time.perf_counter()
    i3d = run_all.lecun_normal_(InceptionI3d().to(device).eval(), seeds[0])
    fid_net = run_all.lecun_normal_(FIDInceptionV3().to(device).eval(),
                                    seeds[1])
    fvd = FrechetPairedMetric(400, feature_fn=lambda x: i3d(
        views_to_clips(x, fvd_size)), shrinkage=run_all.DRILL_SHRINKAGE)
    fid = FrechetPairedMetric(2048, feature_fn=lambda x: fid_net(
        run_all.to_images(x, fid_size)), shrinkage=run_all.DRILL_SHRINKAGE)
    real, fake = real.to(device).float(), fake.to(device).float()
    for m in (fvd, fid):
        m.update(real, fake)
    out = {"fvd": fvd.compute(), "fid": fid.compute(),
           "fvd_clips": fvd.state.real_n, "fid_images": fid.state.real_n}
    out["seconds"] = time.perf_counter() - t0
    for kind in ("fvd", "fid"):
        if not out[kind] > 0.0:
            raise AssertionError(f"degenerate {kind} {out[kind]} on distinct "
                                 "inputs")
    return out

