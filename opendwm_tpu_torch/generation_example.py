"""Checkpoint-only generation (``examples/ctsd_generation_example.py``):
the config embeds a literal batch of pre-encoded conditions, so no dataset
is needed; build the pipeline, denoise, decode and write the preview.

    python -m opendwm_tpu_torch.generation_example \\
        -c examples/ctsd_generation_example.json -o out/ [--device cuda|cpu]

A batch entry ``{"_shape": [...], "_randn": s}`` is ``s`` times standard
normal noise, ``{"_shape": [...], "_fill": x}`` a constant, anything else
the literal array. ``checkpoint_path`` (a ``save_model_only`` file of the
model, e.g. ``convert_cli --kind ctsd_dit``'s) replaces the default
initialisation under ``generator_seed``. ``--device`` defaults to ``cuda``
and raises without a card.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from opendwm_tpu_torch import checkpoint as ckpt_lib
from opendwm_tpu_torch.train import build_pipeline, read_config
from opendwm_tpu_torch.utils.preview import (
    make_ctsd_preview_tensor,
    save_tensor_to_video,
)


def literal_batch(spec: dict, seed: int, device) -> dict:
    """The config's literal batch on ``device``. Every ``_randn`` entry is
    drawn from a generator seeded with ``seed``, as the JAX example draws
    each from the one key."""
    batch = {}
    for key, value in spec.items():
        if isinstance(value, dict) and "_shape" in value:
            shape = tuple(value["_shape"])
            if "_randn" in value:
                gen = torch.Generator(device).manual_seed(seed)
                batch[key] = torch.randn(shape, generator=gen,
                                         device=device) * value["_randn"]
            else:
                batch[key] = torch.full(shape, float(value.get("_fill", 0.0)),
                                        device=device)
        else:
            batch[key] = torch.as_tensor(np.asarray(value, np.float32),
                                         device=device)
    return batch


def main(args=None) -> str:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("-c", "--config-path", required=True)
    parser.add_argument("-o", "--output-path", required=True)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = args or parser.parse_args()
    config, device = read_config(args)
    seed = config.get("generator_seed", 0)
    torch.manual_seed(seed)
    pipeline = build_pipeline(config, device)
    if config.get("checkpoint_path"):
        ckpt_lib.load_model_only(config["checkpoint_path"], pipeline.model)
    pipeline.model.eval()
    batch = literal_batch(config["batch"], seed + 1, device)
    latents = pipeline.inference_pipeline(
        batch, tuple(batch["latents"].shape),
        generator=torch.Generator(device).manual_seed(seed + 3))
    frames = pipeline.decode_latents(latents).float().cpu().numpy()

    def to01(x):
        lo, hi = x.min(), x.max()
        return (x - lo) / max(hi - lo, 1e-6)

    grid = make_ctsd_preview_tensor([to01(frames[0])[..., :3]])
    os.makedirs(args.output_path, exist_ok=True)
    path = save_tensor_to_video(
        os.path.join(args.output_path, "generation.mp4"), 2.0, grid)
    print(f"wrote {path}; latents shape {tuple(latents.shape)}", flush=True)
    return path


if __name__ == "__main__":
    main()
