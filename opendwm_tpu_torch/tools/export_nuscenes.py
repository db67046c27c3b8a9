"""Export generated frames in the nuScenes directory layout
(``opendwm_tpu/tools/export_nuscenes.py``), in PyTorch.

Generated multi-view videos are written back as
``samples/{CHANNEL}/{token}.jpg`` with the ``sample_data`` records that
point at them, so that nuScenes consumers (detectors, simulators) read
synthetic data as they read recorded data.

    python -m opendwm_tpu_torch.tools.export_nuscenes -c config.json \\
        -o export/ [--device cuda|cpu] [--checkpoint STEP] [--max-batches N]

The config's pipeline generates from its ``preview_dataset`` (built as the
preview CLI builds it); ``--checkpoint`` loads the train CLI's checkpoint
of that step under the output path. ``--device`` defaults to ``cuda`` and
raises without a card.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from opendwm_tpu_torch import checkpoint as ckpt_lib
from opendwm_tpu_torch.config import create_instance_from_config
from opendwm_tpu_torch.train import build_pipeline, read_config, \
    to_device_batch


def export_batch(output_path: str, frames: np.ndarray, sensor_channels,
                 timestamps: np.ndarray,
                 scene_name: str = "generated") -> list[dict]:
    """Write ``frames`` (t, v, H, W, 3) in [0, 1] as JPEGs and return their
    ``sample_data`` records; ``timestamps`` (t, v) in ms."""
    from PIL import Image

    records = []
    for t in range(frames.shape[0]):
        for v, channel in enumerate(sensor_channels):
            token = f"{scene_name}_{t:04d}_{channel}"
            rel = f"samples/{channel}/{token}.jpg"
            path = os.path.join(output_path, rel)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            Image.fromarray(
                (np.clip(frames[t, v], 0, 1) * 255).astype(np.uint8)
            ).save(path)
            records.append({
                "token": token,
                "sample_token": f"{scene_name}_{t:04d}",
                "filename": rel,
                "timestamp": int(timestamps[t, v] * 1000),
                "is_key_frame": True,
                "fileformat": "jpg",
                "width": int(frames.shape[3]),
                "height": int(frames.shape[2]),
            })
    return records


def create_parser():
    parser = argparse.ArgumentParser(
        description="Export generated frames as nuScenes samples "
                    "(PyTorch port).")
    parser.add_argument("-c", "--config-path", required=True)
    parser.add_argument("-o", "--output-path", required=True)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--checkpoint", type=int, default=None)
    parser.add_argument("--max-batches", type=int, default=1)
    return parser


def main(args=None) -> list[dict]:
    args = args or create_parser().parse_args()
    config, device = read_config(args)
    torch.manual_seed(config.get("generator_seed", 0))
    pipeline = build_pipeline(config, device)
    dataset = create_instance_from_config(config["preview_dataset"])
    collate = create_instance_from_config(
        config.get("preview_collate_fn", {})) or (lambda items: items[0])
    channels = config.get("sensor_channels", ["CAM_FRONT"])
    state = pipeline.init_state()
    if args.checkpoint is not None:
        ckpt_lib.load_checkpoint(args.output_path, args.checkpoint, state)
    pipeline.model.eval()
    generator = torch.Generator(device).manual_seed(
        config.get("generator_seed", 0))
    records = []
    for i in range(args.max_batches):
        host = collate([dataset[i]])
        batch = pipeline.ensure_latents(to_device_batch(host, device))
        gen = pipeline.inference_pipeline(batch, tuple(batch["latents"].shape),
                                          generator)
        frames = pipeline.decode_latents(gen).float().cpu().numpy()[0]
        frames = np.clip((frames + 1) / 2, 0, 1)
        ts = np.asarray(host.get("pts", np.zeros(frames.shape[:2],
                                                 np.float32)))
        ts = ts[0] if ts.ndim == 3 else ts
        records += export_batch(args.output_path, frames, channels, ts,
                                f"gen{i:03d}")
    with open(os.path.join(args.output_path, "sample_data.json"), "w") as f:
        json.dump(records, f, indent=1)
    print(f"exported {len(records)} sample_data records", flush=True)
    return records


if __name__ == "__main__":
    main()
