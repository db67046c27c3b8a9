"""OpenDV-YouTube motion dataset (unlabeled driving videos; the port's
copy of ``opendwm_tpu/datasets/opendv.py``).

Capability parity with reference src/dwm/datasets/opendv.py (328 LoC):
meta-JSON-driven clip enumeration by (fps, stride) over video durations,
windowed video decode with nearest-pts frame matching and gray-frame
fallback on decode errors (:186-290), fake camera parameters / empty layout
conditions for schema alignment with the labeled datasets (:270-288), and
time-keyed image descriptions.

Video decode backends: PyAV when importable (the reference's path); else a
pre-extracted frame-directory layout (``{video_id}/{frame:06d}.jpg`` at the
meta-declared fps), the route where PyAV is not installed. PyAV is
imported when a video is read. Decode failures yield gray frames, never
crashes.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from opendwm_tpu_torch.config import register
from opendwm_tpu_torch.datasets.common import (
    add_stub_key_data,
    find_nearest,
    make_image_description_string,
)

try:
    from PIL import Image
except ImportError:  # pragma: no cover
    Image = None


@register("OpenDVDataset", aliases=("dwm.datasets.opendv.MotionDataset",))
class MotionDataset:
    def __init__(
        self,
        fs,
        meta_path: str,
        sequence_length: int,
        fps_stride_tuples: list,
        split: Optional[str] = None,
        mini_batch: Optional[int] = None,
        shuffle_seed: Optional[int] = 42,
        take_video_count: Optional[int] = None,
        ignore_list: Optional[list] = None,
        enable_pts: bool = True,
        enable_fake_camera_transforms: bool = False,
        enable_fake_3dbox_images: bool = False,
        enable_fake_hdmap_images: bool = False,
        fake_condition_image_color=0,
        image_size: tuple = (576, 320),
        image_description_settings: Optional[dict] = None,
        stub_key_data_dict: Optional[dict] = None,
    ):
        self.fs = fs
        self.sequence_length = sequence_length
        self.mini_batch = mini_batch
        self.enable_pts = enable_pts
        self.enable_fake_camera_transforms = enable_fake_camera_transforms
        self.enable_fake_3dbox_images = enable_fake_3dbox_images
        self.enable_fake_hdmap_images = enable_fake_hdmap_images
        self.fake_color = (
            tuple(fake_condition_image_color)
            if isinstance(fake_condition_image_color, list)
            else fake_condition_image_color
        )
        self.image_size = tuple(image_size)
        self.image_description_settings = image_description_settings
        self.stub_key_data_dict = stub_key_data_dict
        ignore = set(ignore_list or [])

        with open(meta_path) as f:
            meta = json.load(f)
        videos = [
            m for m in meta
            if (split is None or m.get("split") == split)
            and m.get("videoid", m.get("id")) not in ignore
        ]
        if take_video_count is not None:
            videos = videos[:take_video_count]

        self.items = []
        for video in videos:
            vid = video.get("videoid", video.get("id"))
            path = video.get("path", f"{vid}.mp4")
            duration = float(video.get("length", video.get("duration", 0)))
            start_discard = float(video.get("start_discard", 0))
            end_discard = float(video.get("end_discard", 0))
            video_fps = float(video.get("fps", 10))
            for fps, stride in fps_stride_tuples:
                t = start_discard
                end = duration - end_discard - sequence_length / fps
                while t <= end:
                    self.items.append({
                        "path": path, "begin": t, "fps": fps,
                        "video_fps": video_fps, "video_id": vid,
                    })
                    t += stride
        if shuffle_seed is not None:
            rng = np.random.RandomState(shuffle_seed)
            order = rng.permutation(len(self.items))
            self.items = [self.items[i] for i in order]

        if image_description_settings is not None:
            with open(image_description_settings["path"]) as f:
                self.image_descriptions = json.load(f)
            with open(
                image_description_settings["candidates_times_path"]
            ) as f:
                self.time_list_dict = json.load(f)
            self.image_desc_rs = np.random.RandomState(
                image_description_settings.get("seed", 0)
            )

    def __len__(self):
        return len(self.items)

    # -- decode backends ---------------------------------------------------------

    def _gray_frames(self, times):
        w, h = self.image_size
        return [Image.new("RGB", (w, h), (128, 128, 128)) for _ in times]

    def _decode_av(self, av, item, times):
        try:
            with self.fs.open(item["path"]) as f:
                container = av.open(f)
                stream = container.streams.video[0]
                tb = stream.time_base
                container.seek(
                    int(times[0] / tb), stream=stream, any_frame=False
                )
                decoded = []
                for frame in container.decode(stream):
                    decoded.append((float(frame.pts * tb), frame))
                    if decoded[-1][0] > times[-1] + 1.0:
                        break
                if not decoded:
                    return self._gray_frames(times)
                pts_list = [p for p, _ in decoded]
                out = []
                for t in times:
                    _, frame = decoded[find_nearest(pts_list, t)]
                    out.append(frame.to_image().resize(self.image_size))
                return out
        except Exception:
            return self._gray_frames(times)

    def _decode_frames_dir(self, item, times):
        base = os.path.splitext(item["path"])[0]
        out = []
        for t in times:
            idx = int(round(t * item["video_fps"]))
            path = f"{base}/{idx:06d}.jpg"
            try:
                with self.fs.open(path) as f:
                    img = Image.open(f).convert("RGB")
                    img.load()
                out.append(img.resize(self.image_size))
            except Exception:
                out.extend(self._gray_frames([t]))
        return out

    def decode_window(self, item, times):
        try:
            import av
        except ImportError:
            return self._decode_frames_dir(item, times)
        return self._decode_av(av, item, times)

    # -- items ---------------------------------------------------------------------

    def __getitem__(self, index: int) -> dict:
        item = self.items[index]
        fps = item["fps"]
        times = [item["begin"] + i / fps for i in range(self.sequence_length)]
        frames = self.decode_window(item, times)

        k = self.mini_batch or 1
        images = [[f] * k if self.mini_batch else [f] for f in frames]
        result: dict = {
            "fps": np.float32(fps),
            "images": images,
        }
        if self.enable_pts:
            result["pts"] = np.asarray(
                [[(t - times[0]) * 1000] * max(k, 1) for t in times],
                np.float32,
            )

        w, h = self.image_size
        v = max(k, 1)
        t = self.sequence_length
        if self.enable_fake_camera_transforms:
            # frontal pinhole guess (reference :270-288)
            cam = np.array(
                [[0, 0, 1, 1.5], [-1, 0, 0, 0], [0, -1, 0, 1.5],
                 [0, 0, 0, 1]], np.float32,
            )
            intr = np.array(
                [[0.5 * (w + h), 0, w / 2], [0, 0.5 * (w + h), h / 2],
                 [0, 0, 1]], np.float32,
            )
            result["camera_transforms"] = np.broadcast_to(
                cam, (t, v, 4, 4)
            ).copy()
            result["camera_intrinsics"] = np.broadcast_to(
                intr, (t, v, 3, 3)
            ).copy()
            result["image_size"] = np.full((t, v, 2), [w, h], np.float32)
        if self.enable_fake_3dbox_images:
            result["3dbox_images"] = [
                [Image.new("RGB", (w, h), self.fake_color) for _ in range(v)]
                for _ in range(t)
            ]
        if self.enable_fake_hdmap_images:
            result["hdmap_images"] = [
                [Image.new("RGB", (w, h), self.fake_color) for _ in range(v)]
                for _ in range(t)
            ]

        if self.image_description_settings is not None:
            vid = item["video_id"]
            descs = []
            for time in times:
                time_list = self.time_list_dict.get(vid, [0])
                nearest = time_list[
                    find_nearest(time_list, int(time * 1000))
                ]
                cap = self.image_descriptions.get(
                    f"{vid}.{nearest:.0f}", {}
                )
                text = (
                    make_image_description_string(
                        cap, self.image_description_settings,
                        self.image_desc_rs,
                    )
                    if cap else ""
                )
                descs.append([text] * v)
            result["image_description"] = descs

        add_stub_key_data(self.stub_key_data_dict, result)
        return result
