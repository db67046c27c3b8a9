"""Build random-access offset indexes for TFRecord shards (Waymo).

The port of ``opendwm_tpu/tools/dataset_make_info_json.py``,
on the port's readers, filesystems and registry; host-side.

Reference src/dwm/tools/dataset_make_info_json.py — the Waymo/Argoverse
datasets need O(1) record access from dataloader workers; this writes
``{shard: [record offsets]}`` consumed by datasets.waymo.

    python -m opendwm_tpu_torch.tools.dataset_make_info_json \
        -o info.json shard1.tfrecord shard2.tfrecord ...
"""

from __future__ import annotations

import argparse
import json

from opendwm_tpu_torch.datasets.tfrecord import make_tfrecord_index


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("shards", nargs="+")
    parser.add_argument("-o", "--output", required=True)
    args = parser.parse_args(argv)
    info = {}
    for shard in args.shards:
        with open(shard, "rb") as f:
            info[shard] = make_tfrecord_index(f)
        print(f"{shard}: {len(info[shard])} records")
    with open(args.output, "w") as f:
        json.dump(info, f)
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
