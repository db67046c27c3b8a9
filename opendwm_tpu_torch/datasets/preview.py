"""Preview dataset: replays exported layout packages for checkpoint-only
generation demos (reference src/dwm/datasets/preview.py:12-330; the port's
copy of ``opendwm_tpu/datasets/preview.py``).

Package layout:
    sample/
      data.json            — per-frame, per-view records (timestamp, camera
                             intrinsics/extrinsics, description, condition
                             image paths — any field may be null)
      <view>/3dbox/*.png   — optional rasterized 3dbox conditions
      <view>/hdmap/*.png   — optional rasterized hdmap conditions
      <view>/rgb/*.png     — optional reference frames

Yields the canonical batch dict so any CTSD pipeline can generate from it
without dataset-specific code.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from opendwm_tpu_torch.config import register
from opendwm_tpu_torch.datasets.common import add_stub_key_data, find_nearest

try:
    from PIL import Image
except ImportError:  # pragma: no cover
    Image = None

VEHICLE_COLORS = [
    "red", "green", "blue", "black", "yellow", "brown", "white", "purple",
    "grey", "beige", "maroon", "orange", "cream", "UPS", "silver", "tan",
    "copper-colored", "dark-colored", "dark",
]
VEHICLE_NAMES = [
    "SUV", "SUVs", "bus", "buses", "car", "cars", "truck", "trucks", "van",
    "vehicle", "sedan", "Volkswagen", "pickup", "taxi", "Mercedes-Benz",
    "minivan", "RV", "limousine", "trolley", "shuttle", "tram",
    "semi-truck", "motorbike",
]


def drop_vehicle_color(text: str) -> str:
    """Remove color adjectives preceding vehicle nouns (reference :105-117)."""
    words = text.split(" ")
    out: list[str] = []
    for i, word in enumerate(words):
        if (
            (word in VEHICLE_NAMES or word.rstrip(".,") in VEHICLE_NAMES)
            and i > 0
            and words[i - 1] in VEHICLE_COLORS
            and out
        ):
            out.pop()
        out.append(word)
    return " ".join(out)


@register(
    "PreviewDataset", aliases=("dwm.datasets.preview.PreviewDataset",)
)
class PreviewDataset:
    def __init__(
        self,
        json_file: str,
        sequence_length: int,
        fps_stride_tuples: list = ((0, 1),),
        sensor_channels: list = ("CAM_FRONT",),
        enable_camera_transforms: bool = True,
        use_hdmap: bool = True,
        use_3dbox: bool = True,
        drop_vehicle_color: bool = False,
        image_size: tuple = (448, 256),
        stub_key_data_dict: Optional[dict] = None,
    ):
        self.root = os.path.dirname(os.path.abspath(json_file))
        with open(json_file) as f:
            self.data = json.load(f)
        self.sequence_length = sequence_length
        self.sensor_channels = list(sensor_channels)
        self.enable_camera_transforms = enable_camera_transforms
        self.use_hdmap = use_hdmap
        self.use_3dbox = use_3dbox
        self.drop_vehicle_color = drop_vehicle_color
        self.image_size = tuple(image_size)
        self.stub_key_data_dict = stub_key_data_dict

        samples = self.data["samples"] if isinstance(self.data, dict) \
            else self.data
        self.samples = samples
        indices = list(range(len(samples)))
        self.segments = []
        for fps, stride in fps_stride_tuples:
            for seg in self._enumerate_segments(
                indices, sequence_length, fps, stride
            ):
                self.segments.append({"indices": seg, "fps": fps})

    def _enumerate_segments(self, indices, seq_len, fps, stride):
        if len(indices) < seq_len:
            return
        if fps == 0:
            for t in range(0, len(indices) - seq_len + 1, max(1, stride)):
                yield indices[t: t + seq_len]
        else:
            ts = [float(self.samples[i].get("timestamp", i)) for i in indices]
            start = ts[0]
            end = ts[-1] - seq_len / fps
            t = start
            while t <= end:
                yield [
                    indices[find_nearest(ts, t + i / fps)]
                    for i in range(seq_len)
                ]
                t += stride

    def __len__(self):
        return len(self.segments)

    def _load_image(self, rel_path):
        w, h = self.image_size
        if rel_path is None:
            return np.zeros((h, w, 3), np.float32)
        p = os.path.join(self.root, rel_path)
        img = Image.open(p).convert("RGB").resize((w, h))
        return np.asarray(img, np.float32) / 255.0

    def __getitem__(self, index: int) -> dict:
        seg = self.segments[index]
        frames = [self.samples[i] for i in seg["indices"]]
        t = len(frames)
        v = len(self.sensor_channels)

        result: dict = {"fps": np.float32(seg["fps"])}
        result["pts"] = np.asarray(
            [[float(f.get("timestamp", i)) * 1000] * v
             for i, f in enumerate(frames)],
            np.float32,
        )

        def view_rec(frame, channel):
            views = frame.get("views", {})
            return views.get(channel, {})

        descs = []
        for frame in frames:
            row = []
            for ch in self.sensor_channels:
                rec = view_rec(frame, ch)
                text = rec.get("description", frame.get("description", ""))
                if self.drop_vehicle_color and text:
                    text = drop_vehicle_color(text)
                row.append(text)
            descs.append(row)
        result["image_description"] = descs

        if self.use_3dbox:
            result["3dbox_images"] = np.stack([
                np.stack([
                    self._load_image(view_rec(f, ch).get("3dbox"))
                    for ch in self.sensor_channels
                ])
                for f in frames
            ])
        if self.use_hdmap:
            result["hdmap_images"] = np.stack([
                np.stack([
                    self._load_image(view_rec(f, ch).get("hdmap"))
                    for ch in self.sensor_channels
                ])
                for f in frames
            ])

        if self.enable_camera_transforms:
            intr, trans, sizes = [], [], []
            for f in frames:
                intr.append([]), trans.append([]), sizes.append([])
                for ch in self.sensor_channels:
                    rec = view_rec(f, ch)
                    intr[-1].append(
                        np.asarray(
                            rec.get("camera_intrinsic") or np.eye(3),
                            np.float32,
                        )
                    )
                    trans[-1].append(
                        np.asarray(
                            rec.get("camera_transform") or np.eye(4),
                            np.float32,
                        )
                    )
                    sizes[-1].append(list(self.image_size))
            result["camera_transforms"] = np.asarray(trans, np.float32)
            result["camera_intrinsics"] = np.asarray(intr, np.float32)
            result["image_size"] = np.asarray(sizes, np.float32)

        add_stub_key_data(self.stub_key_data_dict, result)
        return result
