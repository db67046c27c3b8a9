"""Evaluation CLI of the port (``opendwm_tpu/evaluate.py``).

Builds the pipeline and the validation dataset from a JSON config,
truncates the dataset to whole batches (``batch_size``; ``--max-batches``
caps them), and runs ``evaluate_pipeline`` once over them with the
config's ``metrics``; prints the results as one JSON line and logs them
under ``{output}/log``.

    python -m opendwm_tpu_torch.evaluate -c config.json -o output/ \\
        [--device cuda|cpu] [--checkpoint STEP] [--max-batches N]

``--device`` defaults to ``cuda`` and raises without a card. The model
holds fp32 master weights under the config's compute dtype, as the train
CLI builds it, so that ``--checkpoint STEP`` loads that CLI's checkpoint of
``STEP`` under ``output/``; without it the weights are torch's default
initialisation under ``generator_seed``. The frozen stages load as in the
train CLI (``vae_checkpoint_path``: the metrics then see decoded frames;
the JAX CLI reads no frozen stage and scores latents).

Under ``torchrun`` every rank joins the process group and the pipeline's
mesh (its train state placed by the policy, as the train CLI places it)
and takes its rows of every batch (``train.rank_batch``; a batch that
does not split over the data ranks is refused); each rank generates its
rows from its rows of the global batch's noise, and the metrics' states
are merged over the data ranks before ``compute``, so every rank returns
the global batch's score, as the JAX CLI's global arrays give it. Rank 0
prints and logs.
"""

from __future__ import annotations

import argparse
import json

import torch

from opendwm_tpu_torch import checkpoint as ckpt_lib
from opendwm_tpu_torch.config import create_instance_from_config
from opendwm_tpu_torch.train import (
    JsonlLogger,
    NullLogger,
    build_pipeline,
    launch,
    rank_batch,
    read_config,
    to_device_batch,
)


def create_parser():
    parser = argparse.ArgumentParser(
        description="Evaluate a pipeline from a JSON config (PyTorch port).")
    parser.add_argument("-c", "--config-path", required=True)
    parser.add_argument("-o", "--output-path", required=True)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--checkpoint", type=int, default=None)
    parser.add_argument("--max-batches", type=int, default=None)
    return parser


def main(args=None) -> dict:
    """The results of the global batches, on every rank."""
    args = args or create_parser().parse_args()
    config, device = read_config(args)
    rank = launch(device)
    torch.manual_seed(config.get("generator_seed", 0))
    pipeline = build_pipeline(config, device)
    dataset = create_instance_from_config(config["validation_dataset"])
    collate = create_instance_from_config(
        config.get("validation_collate_fn", {})) or (lambda items: items[0])
    metrics = {name: create_instance_from_config(cfg)
               for name, cfg in config.get("metrics", {}).items()}

    bs = config.get("batch_size", 1)
    n = (len(dataset) // bs) * bs  # whole batches only
    limit = args.max_batches or (n // bs)
    batches = [to_device_batch(rank_batch(
        collate([dataset[j] for j in range(i, i + bs)]), pipeline), device)
        for i in range(0, min(n, limit * bs), bs)]

    state = pipeline.init_state()
    if args.checkpoint is not None:
        ckpt_lib.load_checkpoint(args.output_path, args.checkpoint, state)
    logger = JsonlLogger(args.output_path) if rank == 0 else NullLogger()
    try:
        results = pipeline.evaluate_pipeline(
            state, args.checkpoint or 0, batches=batches, logger=logger,
            metrics=metrics)
    finally:
        logger.close()
    if rank == 0:
        print(json.dumps({k: float(v) for k, v in results.items()}),
              flush=True)
    return results


if __name__ == "__main__":
    main()
