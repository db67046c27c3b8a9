"""Offline LiDAR sequence visualizer CLI.

The port of ``opendwm_tpu/tools/visualize_lidar.py``,
on the port's readers, filesystems and registry; host-side.

Capability parity with the reference's standalone visualizer toolchain
(src/dwm/utils/lidar_visualizer.py + lidar_visualizer_utils.py, an open3d
app with its own nuScenes/KITTI-360 loaders): here the canonical dataset
adapters (datasets/nuscenes.py, datasets/kitti360.py, ...) supply points /
boxes / map lines, and the PIL BEV / perspective renderers draw them —
open3d optional, not required.

    python -m opendwm_tpu_torch.tools.visualize_lidar -c dataset_config.json \
        -o out/ [--perspective] [--max-items 4] [--gif]

``dataset_config.json`` is ``{"dataset": {<_class_name dataset config>}}``
or a full training config (its validation/training dataset is used).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from opendwm_tpu_torch.config import create_instance_from_config, global_state


def create_parser():
    parser = argparse.ArgumentParser(description="Render LiDAR sequences.")
    parser.add_argument("-c", "--config-path", required=True)
    parser.add_argument("-o", "--output-path", required=True)
    parser.add_argument("--max-items", type=int, default=4)
    parser.add_argument("--perspective", action="store_true")
    parser.add_argument("--gif", action="store_true",
                        help="also write an animated GIF per item")
    parser.add_argument("--image-size", type=int, default=640)
    return parser


def item_frames(item: dict):
    """Canonical item → list of (points (N,3), mask) frames."""
    pts = np.asarray(item["lidar_points"])
    mask = item.get("lidar_points_mask")
    frames = []
    for t in range(pts.shape[0]):
        p = pts[t]
        m = np.asarray(mask[t]) if mask is not None else None
        if isinstance(p, np.ndarray) and p.ndim == 2:
            frames.append((p[..., :3], m))
    return frames


def main(args=None):
    args = args or create_parser().parse_args()
    with open(args.config_path) as f:
        config = json.load(f)
    if "global_state" in config:
        for key, value in config["global_state"].items():
            global_state[key] = create_instance_from_config(value)
    ds_cfg = (
        config.get("dataset")
        or config.get("validation_dataset")
        or config["training_dataset"]
    )
    dataset = create_instance_from_config(ds_cfg)

    from opendwm_tpu_torch.utils.lidar_visualizer import render_sequence

    os.makedirs(args.output_path, exist_ok=True)
    n = min(len(dataset), args.max_items)
    written = []
    for i in range(n):
        item = dataset[i]
        frames = item_frames(item)
        images = render_sequence(
            [p for p, _ in frames],
            masks=[m for _, m in frames],
            perspective=args.perspective,
            image_size=args.image_size,
        )
        for t, img in enumerate(images):
            path = os.path.join(args.output_path, f"{i:04d}_{t:03d}.png")
            img.save(path)
            written.append(path)
        if args.gif and len(images) > 1:
            gif = os.path.join(args.output_path, f"{i:04d}.gif")
            images[0].save(
                gif, save_all=True, append_images=images[1:],
                duration=500, loop=0,
            )
            written.append(gif)
    print(f"wrote {len(written)} files to {args.output_path}")
    return written


if __name__ == "__main__":
    main()
