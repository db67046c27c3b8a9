"""Training CLI of the port (``opendwm_tpu/train.py``).

A JSON config is reflected into a pipeline and a dataset, then a step loop
calls ``train_step``, logs and checkpoints at the configured intervals:

    python -m opendwm_tpu_torch.train -c config.json -o output/ \\
        --device cuda [--max-steps N] [--log-steps N] \\
        [--checkpointing-steps N] [--resume-from STEP]

The device is explicit: ``--device cuda`` without a card raises and never
falls back to the CPU. The model keeps fp32 master weights
(``param_dtype``) and computes in the config's ``dtype``, as the JAX
package does. Randomness comes from one ``torch.Generator`` on the device,
seeded from ``generator_seed`` and saved in each checkpoint; the data
order is a function of the seed and the step, so a resumed run takes the
steps an uninterrupted one takes. Logs go to stdout and
``{output}/log/events.jsonl``, and to TensorBoard / Weights & Biases when
those are installed (optional, as in the JAX package).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Iterable, Optional

import numpy as np
import torch

from opendwm_tpu_torch import checkpoint as ckpt_lib
from opendwm_tpu_torch.config import create_instance_from_config, global_state

# Config keys that only steer JAX; the port reads none of them.
_JAX_ONLY_KEYS = ("jax_platform", "num_virtual_cpu_devices")


def create_parser():
    parser = argparse.ArgumentParser(
        description="Train a world model pipeline from a JSON config "
                    "(PyTorch port).")
    parser.add_argument("-c", "--config-path", required=True)
    parser.add_argument("-o", "--output-path", required=True)
    parser.add_argument("--device", required=True, choices=("cuda", "cpu"))
    parser.add_argument("--resume-from", type=int, default=None)
    parser.add_argument("--log-steps", type=int, default=100)
    parser.add_argument("--checkpointing-steps", type=int, default=0)
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--preview-steps", type=int, default=0)
    parser.add_argument("--evaluation-steps", type=int, default=0)
    parser.add_argument("--profile-steps", type=str, default=None)
    parser.add_argument("--wandb", type=str, default=None,
                        help="W&B project name (optional)")
    return parser


class JsonlLogger:
    """stdout + ``{output}/log/events.jsonl``, plus TensorBoard scalars
    (tensorboardX) and Weights & Biases when those packages are installed."""

    def __init__(self, output_path: str, tensorboard: bool = True,
                 wandb_project: Optional[str] = None):
        self.dir = os.path.join(output_path, "log")
        os.makedirs(self.dir, exist_ok=True)
        self.f = open(os.path.join(self.dir, "events.jsonl"), "a")
        self.tb = None
        if tensorboard:
            try:
                from tensorboardX import SummaryWriter

                self.tb = SummaryWriter(self.dir)
            except ImportError:
                self.tb = None
        self.wandb = None
        if wandb_project:
            try:
                import wandb

                wandb.init(project=wandb_project, dir=self.dir)
                self.wandb = wandb
            except ImportError:
                self.wandb = None

    def log(self, step: int, values: dict) -> None:
        payload = {"step": step}
        for k, v in values.items():
            try:
                payload[k] = float(v)
            except (TypeError, ValueError):
                payload[k] = str(v)
        self.f.write(json.dumps(payload) + "\n")
        self.f.flush()
        scalars = {k: v for k, v in payload.items()
                   if k != "step" and isinstance(v, float)}
        if self.tb is not None:
            for k, v in scalars.items():
                self.tb.add_scalar(k, v, step)
            self.tb.flush()
        if self.wandb is not None:
            self.wandb.log(scalars, step=step)
        print(" ".join(f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                       for k, v in payload.items()), flush=True)

    def close(self) -> None:
        self.f.close()
        if self.tb is not None:
            self.tb.close()


def batch_iterator(dataset, batch_size: int, collate_fn, seed: int = 0,
                   skip: int = 0) -> Iterable[dict]:
    """Shuffled batches, each epoch a permutation drawn from ``seed``; the
    first ``skip`` batches are passed over without being loaded."""
    rng = np.random.default_rng(seed)
    per_epoch = len(dataset) // batch_size
    if per_epoch == 0:
        raise ValueError(f"dataset of {len(dataset)} items is smaller than "
                         f"one batch of {batch_size}")
    while True:
        order = rng.permutation(len(dataset))
        for i in range(per_epoch):
            if skip:
                skip -= 1
                continue
            items = order[i * batch_size:(i + 1) * batch_size]
            yield collate_fn([dataset[int(j)] for j in items])


def to_device_batch(batch: dict, device: torch.device) -> dict:
    """numpy arrays → tensors on ``device`` (floats as fp32); other fields
    are dropped."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and v.dtype != object:
            t = torch.from_numpy(np.ascontiguousarray(v))
            if t.is_floating_point():
                t = t.float()
            out[k] = t.to(device)
    return out


def _device(name: str) -> torch.device:
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch sees no CUDA device")
    return torch.device(name)


def _refuse_unported(args, config: dict) -> None:
    for flag, value, item in (
        ("--preview-steps", args.preview_steps, "item 16"),
        ("--evaluation-steps", args.evaluation_steps, "item 16"),
        ("--profile-steps", args.profile_steps, "item 17"),
    ):
        if value:
            raise NotImplementedError(
                f"{flag} is not ported yet (ROADMAP Queue 1, {item})")
    for key, item in (("vae_checkpoint_path", "item 4"),
                      ("autoencoder_checkpoint_path", "item 11"),
                      ("vq_checkpoint_path", "item 11"),
                      ("training_sampler", "item 8")):
        if config.get(key):
            raise NotImplementedError(
                f"config key {key!r} is not ported yet (ROADMAP Queue 1, "
                f"{item})")


def main(args=None):
    args = args or create_parser().parse_args()
    with open(args.config_path) as f:
        config = json.load(f)
    _refuse_unported(args, config)
    device = _device(args.device)
    for key in _JAX_ONLY_KEYS:
        if key in config:
            print(f"ignoring JAX-only config key {key}={config[key]!r}",
                  flush=True)

    for key, value in config.get("global_state", {}).items():
        global_state[key] = create_instance_from_config(value)

    seed = config.get("generator_seed", 0)
    torch.manual_seed(seed)
    pipe_cfg = dict(config["pipeline"])
    # fp32 master weights under the config's compute dtype, as flax keeps
    # its params.
    pipe_cfg["model"] = dict(pipe_cfg["model"], param_dtype=torch.float32)
    pipeline = create_instance_from_config(pipe_cfg)
    pipeline.model.to(device)

    dataset = create_instance_from_config(config["training_dataset"])
    dl_cfg = dict(config.get("training_dataloader", {}))
    collate_cfg = dl_cfg.get("collate_fn",
                             config.get("training_collate_fn", {}))
    collate = create_instance_from_config(collate_cfg) or \
        (lambda items: items[0])
    if dl_cfg.get("num_workers", 0) > 0:
        print("loading in-process: num_workers is not used", flush=True)
    batch_size = dl_cfg.get("batch_size", config.get("batch_size", 1))

    state = pipeline.init_state()
    generator = torch.Generator(device).manual_seed(seed)
    if args.resume_from is not None:
        ckpt_lib.load_checkpoint(args.output_path, args.resume_from, state,
                                 generator)
        print(f"resumed from step {args.resume_from}", flush=True)
    loader = batch_iterator(dataset, batch_size, collate, seed,
                            skip=state.step)

    logger = JsonlLogger(args.output_path, wandb_project=args.wandb)
    max_steps = args.max_steps or config.get("train_steps", 1000)
    durations: list[float] = []
    try:
        while state.step < max_steps:
            batch = to_device_batch(next(loader), device)
            t0 = time.perf_counter()
            state, metrics = pipeline.train_step(state, batch, generator)
            if state.step % args.log_steps == 0:
                metrics = {k: float(v) for k, v in metrics.items()}  # syncs
                durations.append(time.perf_counter() - t0)
                logger.log(state.step, dict(
                    metrics, lr=state.lr_scheduler.get_last_lr()[0],
                    s_per_step=float(np.mean(durations[-20:]))))
            else:
                durations.append(time.perf_counter() - t0)
            if args.checkpointing_steps and \
                    state.step % args.checkpointing_steps == 0:
                ckpt_lib.save_checkpoint(args.output_path, state.step, state,
                                         generator)
    finally:
        logger.close()
    ckpt_lib.save_checkpoint(args.output_path, state.step, state, generator)
    print(f"done at step {state.step}", flush=True)
    return state


if __name__ == "__main__":
    main()
