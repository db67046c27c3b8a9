"""Checkpoint conversion CLI (``opendwm_tpu/convert/cli.py``): a released
reference checkpoint → the port model's weights as a ``save_model_only``
file, which ``checkpoint.load_model_only`` reads (the train CLI's
``vae_checkpoint_path`` among them).

    python -m opendwm_tpu_torch.convert_cli --kind ctsd_dit \\
        --input ctsd_35.pth --output converted/ctsd_35.pt [--num-layers 24] \\
        [--dtype bf16|f32]

Kinds: ``ctsd_dit`` (the DiT with the OpenDWM cross-view / temporal
additions), ``ctsd_unet`` (the UNet; an SD2.1-era dict gets the
``spatial_res_block`` key remap first, ``sd21_to_svd_keys``), ``vae``
(diffusers ``AutoencoderKL``), ``clip`` (HF ``CLIPTextModel`` /
``CLIPTextModelWithProjection``), ``t5`` (HF ``T5EncoderModel``), ``i3d``
(the TATS FVD net) and ``fid_inception`` (the ``pt_inception`` FID net).
The conversion runs on the host; no card is needed.
"""

from __future__ import annotations

import argparse
import re

import torch

from opendwm_tpu_torch import checkpoint as ckpt_lib
from opendwm_tpu_torch import torch_import as ti


def sd21_to_svd_keys(sd: dict) -> dict:
    """Insert ``.spatial_res_block`` into the resnet keys of an SD2.1-era
    dict (reference ``try_to_convert_state_dict``); any other dict is
    returned as it is."""
    pattern = re.compile(r"resnets\.(\d+)\.conv")
    if not any(pattern.search(k) for k in sd):
        return sd
    sub = re.compile(r"resnets\.(\d+)")
    return {(sub.sub(r"resnets.\1.spatial_res_block", k) if "resnets" in k
             else k): v for k, v in sd.items()}


CONVERTERS = {
    "ctsd_dit": lambda sd, args: ti.convert_ctsd_dit(sd, args.num_layers),
    "ctsd_unet": lambda sd, args: ti.convert_ctsd_unet(sd21_to_svd_keys(sd)),
    "vae": lambda sd, args: ti.convert_autoencoder_kl(sd),
    "clip": lambda sd, args: ti.convert_clip_text(sd),
    "t5": lambda sd, args: ti.convert_t5_encoder(sd),
    "i3d": lambda sd, args: ti.convert_i3d(sd),
    "fid_inception": lambda sd, args: ti.convert_fid_inception(sd),
}
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kind", required=True, choices=sorted(CONVERTERS))
    parser.add_argument("--input", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--num-layers", type=int, default=24)
    parser.add_argument(
        "--dtype", default=None, choices=sorted(DTYPES),
        help="cast the float tensors before saving (default: keep the "
             "source's dtypes)")
    args = parser.parse_args(argv)

    sd = ti.load_torch_state_dict(args.input)
    state = CONVERTERS[args.kind](sd, args)
    if args.dtype:
        target = DTYPES[args.dtype]
        state = {k: v.to(target) if v.is_floating_point() else v
                 for k, v in state.items()}
    ckpt_lib.save_model_only(args.output, state)
    n = sum(v.numel() for v in state.values())
    print(f"converted {args.kind}: {n / 1e6:.1f}M params → {args.output}")
    return state


if __name__ == "__main__":
    main()
