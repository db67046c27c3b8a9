"""Find the "blank" (free-space) VQ codes for MaskGIT's suppression
(``opendwm_tpu/tools/make_blank_code.py``), in PyTorch.

The frozen LiDAR tokenizer encodes a validation set on the card, the codes
are counted with ``torch.bincount``, and the ``top_k`` most frequent are the
blank list (free space dominates LiDAR BEV grids); the ranking is numpy's
``argsort(-counts)`` on the host, as the JAX tool ranks, so tied counts
order the same. The list feeds ``MaskGITPipeline(blank_code=...)`` (the
train CLI's ``blank_code_path``).

    python -m opendwm_tpu_torch.tools.make_blank_code -c config.json \\
        -o blank.json [--device cuda|cpu] [--top-k 10] [--max-batches 16]

The config holds ``vq_point_cloud`` (the tokenizer), ``validation_dataset``
and optionally ``validation_collate_fn``, ``batch_size`` and
``vq_checkpoint_path`` (a ``save_model_only`` file); without a checkpoint
the tokenizer's weights are torch's init under ``generator_seed``.
``--device`` defaults to ``cuda`` and raises without a card.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from opendwm_tpu_torch import checkpoint as ckpt_lib
from opendwm_tpu_torch.config import create_instance_from_config
from opendwm_tpu_torch.train import read_config, to_device_batch


@torch.no_grad()
def code_counts(vq_model, batches) -> torch.Tensor:
    """How often each code of the tokenizer's codebook is chosen over
    ``batches`` (device batches with ``lidar_points`` and
    ``lidar_points_mask``): (n_e,) int64 on the batches' device."""
    counts = None
    for batch in batches:
        _, _, _, idx = vq_model.encode(batch["lidar_points"],
                                       batch["lidar_points_mask"])
        c = torch.bincount(idx.reshape(-1),
                           minlength=vq_model.vector_quantizer.n_e)
        counts = c if counts is None else counts + c
    return counts


def rank_codes(counts, top_k: int = 10) -> list[int]:
    """The ``top_k`` most frequent codes, by ``np.argsort(-counts)``."""
    counts = np.asarray(counts.cpu() if isinstance(counts, torch.Tensor)
                        else counts)
    return [int(i) for i in np.argsort(-counts)[:top_k]]


def find_blank_codes(vq_model, batches, top_k: int = 10) -> list[int]:
    return rank_codes(code_counts(vq_model, batches), top_k)


def create_parser():
    parser = argparse.ArgumentParser(
        description="Find the blank VQ codes of a LiDAR tokenizer "
                    "(PyTorch port).")
    parser.add_argument("-c", "--config-path", required=True)
    parser.add_argument("-o", "--output-path", required=True)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--top-k", type=int, default=10)
    parser.add_argument("--max-batches", type=int, default=16)
    return parser


def main(args=None) -> list[int]:
    args = args or create_parser().parse_args()
    config, device = read_config(args)
    torch.manual_seed(config.get("generator_seed", 0))
    vq_model = create_instance_from_config(config["vq_point_cloud"])
    if config.get("vq_checkpoint_path"):
        ckpt_lib.load_model_only(config["vq_checkpoint_path"], vq_model)
    vq_model.to(device).eval()
    dataset = create_instance_from_config(config["validation_dataset"])
    collate = create_instance_from_config(config.get(
        "validation_collate_fn", {"_class_name": "CollateFnIgnoring"}))
    bs = config.get("batch_size", 1)
    batches = [
        to_device_batch(collate([dataset[i * bs + j] for j in range(bs)]),
                        device)
        for i in range(min(args.max_batches, len(dataset) // bs))]
    blank = find_blank_codes(vq_model, batches, args.top_k)
    with open(args.output_path, "w") as f:
        json.dump({"blank_code": blank}, f)
    print(f"wrote {args.output_path}: {blank}", flush=True)
    return blank


if __name__ == "__main__":
    main()
