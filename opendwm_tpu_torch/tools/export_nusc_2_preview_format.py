"""Export a dataset's validation segments as preview data packages.

The port of ``opendwm_tpu/tools/export_nusc_2_preview_format.py``,
on the port's readers, filesystems and registry; host-side.

Capability parity with reference
src/dwm/tools/export_nusc_2_preview_format.py:1-110: each segment becomes a
self-contained directory — ``data.json`` plus per-view rgb / 3dbox / hdmap
PNGs — loadable by ``datasets.preview.PreviewDataset`` for checkpoint-only
generation demos. Reference frames (the first ``--reference-frame-count``)
keep their RGB pixels; later frames carry layout conditions only.

    python -m opendwm_tpu_torch.tools.export_nusc_2_preview_format \
        -c config.json -o out/ --reference-frame-count 3
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from opendwm_tpu_torch.config import create_instance_from_config, global_state

NUSC_CAMERAS = [
    "CAM_FRONT_LEFT", "CAM_FRONT", "CAM_FRONT_RIGHT",
    "CAM_BACK_RIGHT", "CAM_BACK", "CAM_BACK_LEFT",
]


def create_parser():
    parser = argparse.ArgumentParser(
        description="Convert dataset segments into preview data packages."
    )
    parser.add_argument("-c", "--config-path", required=True)
    parser.add_argument("-o", "--output-path", required=True)
    parser.add_argument("--reference-frame-count", type=int, default=3)
    parser.add_argument("--max-items", type=int, default=None)
    return parser


def _save_png(path: str, image01: np.ndarray):
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(
        (np.clip(image01, 0, 1) * 255).astype(np.uint8)
    ).save(path)


def export_item(
    item: dict, output_path: str, sensor_channels, reference_frame_count: int
) -> str:
    """One dataset item (canonical dict, unbatched (t, v, ...) tensors) →
    one preview package directory. Returns the package path."""
    os.makedirs(output_path, exist_ok=True)
    t = len(item.get("pts", item.get("images", [])))
    fps = float(np.asarray(item.get("fps", 2.0)))
    samples = []
    for fi in range(t):
        views = {}
        for vi, ch in enumerate(sensor_channels):
            rec = {}
            desc = item.get("image_description")
            if desc is not None:
                rec["description"] = desc[fi][vi]
            if "camera_intrinsics" in item:
                rec["camera_intrinsic"] = np.asarray(
                    item["camera_intrinsics"][fi][vi]
                ).tolist()
            if "camera_transforms" in item:
                rec["camera_transform"] = np.asarray(
                    item["camera_transforms"][fi][vi]
                ).tolist()
            if "images" in item and fi < reference_frame_count:
                rel = os.path.join(ch, "rgb", f"{fi}.png")
                _save_png(
                    os.path.join(output_path, rel),
                    np.asarray(item["images"][fi][vi]),
                )
                rec["rgb"] = rel
            for key, sub in (("3dbox_images", "3dbox"),
                             ("hdmap_images", "hdmap")):
                if key in item and item[key] is not None:
                    rel = os.path.join(ch, sub, f"{fi}.png")
                    _save_png(
                        os.path.join(output_path, rel),
                        np.asarray(item[key][fi][vi]),
                    )
                    rec[sub] = rel
            views[ch] = rec
        sample = {"timestamp": round(fi / fps, 4), "views": views}
        if "ego_transforms" in item:
            sample["ego_pose"] = np.asarray(
                item["ego_transforms"][fi][0]
            ).tolist()
        samples.append(sample)
    json_path = os.path.join(output_path, "data.json")
    with open(json_path, "w") as f:
        json.dump({"samples": samples}, f, indent=2)
    return output_path


def main(args=None):
    args = args or create_parser().parse_args()
    with open(args.config_path) as f:
        config = json.load(f)
    if "global_state" in config:
        for key, value in config["global_state"].items():
            global_state[key] = create_instance_from_config(value)

    dataset = create_instance_from_config(config["validation_dataset"])
    channels = config.get("sensor_channels", NUSC_CAMERAS)
    n = len(dataset)
    if args.max_items:
        n = min(n, args.max_items)
    print(f"exporting {n} of {len(dataset)} items")
    for i in range(n):
        item = dataset[i]
        name = item.get("scene_name", f"segment_{i:05d}")
        export_item(
            item, os.path.join(args.output_path, str(name)), channels,
            args.reference_frame_count,
        )
    print("done")


if __name__ == "__main__":
    main()
