"""Training CLI of the port (``opendwm_tpu/train.py``).

A JSON config is reflected into a pipeline and a dataset, then a step loop
calls ``train_step``, logs and checkpoints at the configured intervals:

    python -m opendwm_tpu_torch.train -c config.json -o output/ \\
        [--device cuda|cpu] [--max-steps N] [--log-steps N] \\
        [--checkpointing-steps N] [--resume-from STEP] \\
        [--evaluation-steps N] [--preview-steps N] [--profile-steps S:C]

The loader is built as the JAX CLI builds it: ``training_sampler`` (the
bucket sampler, given the dataset) orders the batches when the config has
one; ``training_dataloader.num_workers > 0`` fetches each batch's items on
that many threads of a ``PrefetchLoader`` that keeps ``prefetch_factor``
batches ready, else the loop loads them itself (``batch_iterator``). A
batch's arrays go to the device; its other fields (the readers' PIL
rasters among them, as in the JAX CLI) are dropped, and the first step
says which.

``--device`` defaults to ``cuda``, which raises without a card and never
falls back to the CPU. The model keeps fp32 master weights
(``param_dtype``) and computes in the config's ``dtype``, as the JAX
package does. Frozen stages load from the port's ``save_model_only`` files
as the JAX CLI chains them: ``vq_checkpoint_path`` (``load_vq_params``),
``autoencoder_checkpoint_path`` (``load_autoencoder_params``) and
``blank_code_path`` (a JSON ``{"blank_code": [...]}`` for
``pipeline.blank_code``) and ``vae_checkpoint_path`` (the config's ``vae``,
its weights from that file, given to ``set_vae``; ``convert_cli --kind
vae`` writes one from a diffusers checkpoint); every module the pipeline
holds moves to the device. As the JAX CLI, this loop never revives a
LiDAR codebook.

Every ``--evaluation-steps`` steps the pipeline's ``evaluate_pipeline``
scores the config's ``metrics`` over up to ``evaluation_batches`` (4)
batches of ``validation_dataset`` (truncated to whole batches, collated
by ``validation_dataloader.collate_fn`` or the training collate), in
either of the JAX signatures: MaskGIT's (the model first, a generator
seeded with ``generator_seed`` + the step) or CTSD's (the state and the
step). Every ``--preview-steps`` steps ``preview_pipeline`` writes the
step's batch under ``{output}/preview``. ``--profile-steps START:COUNT``
traces COUNT steps (at least 1; 3 without ``:COUNT``) from step START
with ``torch.profiler`` and writes the Chrome trace to
``{output}/profile``, the traced steps' peak memory logged beside it.
Randomness comes from one ``torch.Generator`` on the device, seeded from
``generator_seed`` and saved in each checkpoint; the data
order is a function of the seed and the step, so a resumed run takes the
steps an uninterrupted one takes. Each logged step carries ``step_s``
(its train step alone), ``s_per_step`` (their mean over the last 20
steps) and ``data_wait_s`` (its wait for the loader's batch). Logs go to
stdout and
``{output}/log/events.jsonl``, and to TensorBoard / Weights & Biases when
those are installed (optional, as in the JAX package).

Multi-device: under ``torchrun`` (RANK and WORLD_SIZE set) the CLI
initialises the process group (NCCL on the card, each rank on its
LOCAL_RANK device; gloo with ``--device cpu``), the pipeline's mesh spans
every rank and its policy places the train state; each rank takes its
slice of every batch (``parallel.sharding.shard_batch``; the batch must
divide by the data ranks) and its rows of the randoms drawn for the whole
batch from the generator every rank seeds alike, so that the step is the
one-process step on the same batch; rank 0 alone logs and writes (a
checkpoint is written by every rank, sharded). The evaluation and the
preview take the rank's rows too: each rank generates its rows from its
rows of the global batch's draws, the metrics' states are merged over the
data ranks before ``compute``, so the logged ``evaluation/*`` values are
the global batch's, and rank 0 writes the preview of the global row 0.
Without ``torchrun`` the single-process path is unchanged.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import time
from typing import Iterable, Optional

import numpy as np
import torch

from opendwm_tpu_torch import checkpoint as ckpt_lib
from opendwm_tpu_torch.parallel import mesh as mesh_lib
from opendwm_tpu_torch.parallel.sharding import (
    data_parallel_size,
    shard_batch,
)
from opendwm_tpu_torch.config import create_instance_from_config, global_state
from opendwm_tpu_torch.datasets.loader import PrefetchLoader, index_batches

# Config keys that only steer JAX; the port reads none of them.
_JAX_ONLY_KEYS = ("jax_platform", "num_virtual_cpu_devices")


def create_parser():
    parser = argparse.ArgumentParser(
        description="Train a world model pipeline from a JSON config "
                    "(PyTorch port).")
    parser.add_argument("-c", "--config-path", required=True)
    parser.add_argument("-o", "--output-path", required=True)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
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


def batch_iterator(dataset, batch_size: int, collate_fn, sampler=None,
                   seed: int = 0, skip: int = 0) -> Iterable[dict]:
    """Batches in the loop's own thread: the sampler's micro-batches, else
    each epoch a permutation drawn from ``seed``; the first ``skip``
    batches are passed over without being loaded."""
    for indices in index_batches(len(dataset), batch_size, sampler, seed,
                                 skip):
        yield collate_fn([dataset[i] for i in indices])


def build_loader(config: dict, dataset, collate_fn, seed: int = 0,
                 skip: int = 0):
    """The training batches of ``config`` (``opendwm_tpu/train.py``'s
    loader): the bucket sampler when the config names one, and a
    ``PrefetchLoader`` when ``training_dataloader.num_workers > 0``.
    Returns the iterator and the loader to close (or None)."""
    dl_cfg = dict(config.get("training_dataloader", {}))
    sampler = None
    if "training_sampler" in config:
        sampler = create_instance_from_config(config["training_sampler"],
                                              dataset=dataset)
    batch_size = dl_cfg.get("batch_size", config.get("batch_size", 1))
    num_workers = dl_cfg.get("num_workers", 0)
    if num_workers > 0:
        loader = PrefetchLoader(
            dataset, batch_size, collate_fn, sampler, seed,
            num_workers=num_workers,
            prefetch_batches=dl_cfg.get("prefetch_factor", 2), skip=skip)
        return iter(loader), loader
    return batch_iterator(dataset, batch_size, collate_fn, sampler, seed,
                          skip), None


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


def dropped_fields(batch: dict) -> list:
    """The fields of a host batch that ``to_device_batch`` drops."""
    return sorted(k for k, v in batch.items()
                  if not (isinstance(v, np.ndarray) and v.dtype != object))


def _device(name: str) -> torch.device:
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch sees no CUDA device")
    return torch.device(name)


def load_frozen_stages(pipeline, config: dict) -> None:
    """The frozen stages a config names (``save_model_only`` files): the
    tokenizers, the blank codes and the image VAE, into the pipelines that
    take them."""
    for key, method in (("vq_checkpoint_path", "load_vq_params"),
                        ("autoencoder_checkpoint_path",
                         "load_autoencoder_params")):
        if config.get(key) and hasattr(pipeline, method):
            getattr(pipeline, method)(ckpt_lib.load_model_only(config[key]))
    if config.get("blank_code_path") and hasattr(pipeline, "blank_code"):
        with open(config["blank_code_path"]) as f:
            pipeline.blank_code = tuple(json.load(f)["blank_code"])
    if config.get("vae_checkpoint_path") and hasattr(pipeline, "set_vae"):
        vae = create_instance_from_config(config["vae"])
        pipeline.set_vae(ckpt_lib.load_model_only(
            config["vae_checkpoint_path"], vae).eval())


def read_config(args) -> tuple:
    """(the config, the device) of a CLI's arguments; the config's global
    state is built, and its JAX-only keys are named and skipped."""
    with open(args.config_path) as f:
        config = json.load(f)
    device = _device(args.device)
    for key in _JAX_ONLY_KEYS:
        if key in config:
            print(f"ignoring JAX-only config key {key}={config[key]!r}",
                  flush=True)
    for key, value in config.get("global_state", {}).items():
        global_state[key] = create_instance_from_config(value)
    return config, device


def build_pipeline(config: dict, device: torch.device):
    """The config's pipeline with fp32 master weights under the config's
    compute dtype (as flax keeps its params; the LiDAR tokenizers and
    MaskGIT hold fp32 parameters whatever their dtype) and its frozen
    stages, every module it holds on ``device``. The modules are built on
    ``device``: their default initialisation runs there, from its
    generator (a full-width DiT's 3.8B parameters take ~31 s on the host,
    0.5 s on an H100)."""
    pipe_cfg = dict(config["pipeline"])
    if "model" in pipe_cfg:
        pipe_cfg["model"] = dict(pipe_cfg["model"],
                                 param_dtype=torch.float32)
    with torch.device(device):
        pipeline = create_instance_from_config(pipe_cfg)
    load_frozen_stages(pipeline, config)
    for module in vars(pipeline).values():
        if isinstance(module, torch.nn.Module):
            module.to(device)
    return pipeline


class NullLogger:
    """The logger of a rank other than 0: logs nothing."""

    def log(self, step: int, values: dict) -> None:
        pass

    def close(self) -> None:
        pass


def _largest_shape(tree) -> Optional[tuple]:
    """The shape of the array leaf of ``tree`` with the most elements (None
    without one)."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        shapes = [x for x in map(_largest_shape, tree) if x is not None]
        return max(shapes, key=np.prod, default=None)
    shape = tuple(getattr(tree, "shape", ()))
    if not shape or getattr(tree, "dtype", None) == object:
        return None
    return shape


def rank_batch(batch: dict, pipeline) -> dict:
    """This data rank's slice of a host batch (the whole batch on one
    device). The batch's leading axis (its largest array's) must divide by
    the data ranks: each rank keeps its rows of the randoms drawn for the
    whole batch (``MeshPlacement.rank_draws``)."""
    mesh = getattr(pipeline, "mesh", None)
    n = 1 if mesh is None else data_parallel_size(mesh)
    if n == 1:
        return batch
    shape = _largest_shape(batch)
    if shape is None or shape[0] % n:
        raise ValueError(
            f"a batch of {shape and shape[0]} does not split over {n} data "
            "ranks: make the batch size a multiple")
    return shard_batch(batch, mesh)


def validation_batches(config: dict, collate_fn, device,
                       pipeline=None) -> list:
    """Up to ``evaluation_batches`` (4) device batches of the config's
    ``validation_dataset``, truncated to whole batches
    (``opendwm_tpu/train.py:224-250``); this data rank's slices of them
    under a process group."""
    dataset = create_instance_from_config(config["validation_dataset"])
    dl_cfg = dict(config.get("validation_dataloader", {}))
    if "collate_fn" in dl_cfg:
        collate_fn = create_instance_from_config(dl_cfg["collate_fn"])
    train_bs = dict(config.get("training_dataloader", {})).get(
        "batch_size", config.get("batch_size", 1))
    bs = dl_cfg.get("batch_size", train_bs)
    n = (len(dataset) // bs) * bs
    limit = config.get("evaluation_batches", 4) * bs
    return [to_device_batch(rank_batch(
        collate_fn([dataset[j] for j in range(i, i + bs)]), pipeline),
        device) for i in range(0, min(n, limit), bs)]


def parse_profile_steps(spec: Optional[str]) -> tuple:
    """``START:COUNT`` → (start, count): COUNT at least 1 (a trace of 0
    steps would never stop), 3 without it; no spec → (-1, 0)."""
    if not spec:
        return -1, 0
    parts = spec.split(":")
    return int(parts[0]), max(1, int(parts[1])) if len(parts) > 1 else 3


class StepProfiler:
    """A ``torch.profiler`` trace of some steps, written as a Chrome trace
    under ``{output}/profile`` when it stops."""

    def __init__(self, output_path: str, device: torch.device):
        self.dir = os.path.join(output_path, "profile")
        self.device = device
        self.prof = None
        self.first = None

    def start(self, step: int) -> None:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self.first = step
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        self.prof = torch.profiler.profile(activities=activities)
        self.prof.start()

    @property
    def active(self) -> bool:
        return self.prof is not None

    def stop(self, step: int) -> dict:
        """Stop, write the trace; the values to log beside it."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.stop()
        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(self.dir, f"steps_{self.first}_{step}.json")
        self.prof.export_chrome_trace(path)
        self.prof = None
        values = {"profile_written": 1.0}
        if self.device.type == "cuda":
            values["peak_memory_gib"] = \
                torch.cuda.max_memory_allocated(self.device) / 2 ** 30
        print(f"profile of steps {self.first + 1}-{step} → {path}",
              flush=True)
        return values


def evaluate(pipeline, state, batches, seed: int, device, logger) -> dict:
    """``evaluate_pipeline`` in the signature the pipeline has: MaskGIT's
    (the model first, then the batches and a generator seeded alike on
    every rank, whose draws are made for the global batch) or CTSD's (the
    state and the step); the global batch's results on every rank."""
    first = next(iter(inspect.signature(
        pipeline.evaluate_pipeline).parameters))
    if first == "params":
        return pipeline.evaluate_pipeline(
            state.model, batches or [],
            torch.Generator(device).manual_seed(seed + state.step),
            global_step=state.step, logger=logger)
    return pipeline.evaluate_pipeline(state, state.step, batches=batches,
                                      logger=logger)


def launch(device: torch.device) -> int:
    """Under ``torchrun``: join the process group (``mesh.init_from_env``:
    NCCL on the card, gloo on the CPU), destroyed at exit; returns the
    rank (0 without ``torchrun``)."""
    if not mesh_lib.is_launched():
        return 0
    import atexit

    import torch.distributed as dist

    rank = mesh_lib.init_from_env(device)
    atexit.register(lambda: dist.is_initialized() and
                    dist.destroy_process_group())
    return rank


def main(args=None):
    args = args or create_parser().parse_args()
    config, device = read_config(args)
    rank = launch(device)
    if mesh_lib.is_launched() and device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    return _train(args, config, device, rank)


def _train(args, config: dict, device: torch.device, rank: int):
    seed = config.get("generator_seed", 0)
    torch.manual_seed(seed)
    pipeline = build_pipeline(config, device)

    dataset = create_instance_from_config(config["training_dataset"])
    dl_cfg = dict(config.get("training_dataloader", {}))
    collate_cfg = dl_cfg.get("collate_fn",
                             config.get("training_collate_fn", {}))
    collate = create_instance_from_config(collate_cfg) or \
        (lambda items: items[0])
    val_batches = None
    if args.evaluation_steps and "validation_dataset" in config:
        val_batches = validation_batches(config, collate, device, pipeline)
    if hasattr(pipeline, "metrics") and "metrics" in config:
        pipeline.metrics = {name: create_instance_from_config(cfg)
                            for name, cfg in config["metrics"].items()}

    state = pipeline.init_state()
    generator = torch.Generator(device).manual_seed(seed)
    if args.resume_from is not None:
        ckpt_lib.load_checkpoint(args.output_path, args.resume_from, state,
                                 generator)
        if rank == 0:
            print(f"resumed from step {args.resume_from}", flush=True)
    loader, prefetch = build_loader(config, dataset, collate, seed,
                                    skip=state.step)

    logger = JsonlLogger(args.output_path, wandb_project=args.wandb) \
        if rank == 0 else NullLogger()
    max_steps = args.max_steps or config.get("train_steps", 1000)
    durations: list[float] = []
    waits: list[float] = []
    profile_start, profile_count = parse_profile_steps(args.profile_steps)
    profiler = StepProfiler(args.output_path, device)
    try:
        while state.step < max_steps:
            if state.step == profile_start:
                profiler.start(state.step)
            t0 = time.perf_counter()
            host_batch = next(loader)
            waits.append(time.perf_counter() - t0)
            if len(waits) == 1 and dropped_fields(host_batch) and rank == 0:
                print("dropped fields that are not arrays (the JAX CLI drops "
                      f"them too): {', '.join(dropped_fields(host_batch))}",
                      flush=True)
            batch = to_device_batch(rank_batch(host_batch, pipeline), device)
            t0 = time.perf_counter()
            state, metrics = pipeline.train_step(state, batch, generator)
            if profiler.active and \
                    state.step >= profile_start + profile_count:
                logger.log(state.step, profiler.stop(state.step))
            if state.step % args.log_steps == 0:
                metrics = {k: float(v) for k, v in metrics.items()}  # syncs
                durations.append(time.perf_counter() - t0)
                logger.log(state.step, dict(
                    metrics, lr=state.lr_scheduler.get_last_lr()[0],
                    s_per_step=float(np.mean(durations[-20:])),
                    step_s=durations[-1], data_wait_s=waits[-1]))
            else:
                durations.append(time.perf_counter() - t0)
            if args.checkpointing_steps and \
                    state.step % args.checkpointing_steps == 0:
                ckpt_lib.save_checkpoint(args.output_path, state.step, state,
                                         generator)
            if args.evaluation_steps and \
                    state.step % args.evaluation_steps == 0 and \
                    hasattr(pipeline, "evaluate_pipeline"):
                evaluate(pipeline, state, val_batches, seed, device, logger)
            if args.preview_steps and \
                    state.step % args.preview_steps == 0 and \
                    hasattr(pipeline, "preview_pipeline"):
                # every rank runs the (collective) forward; rank 0 writes
                pipeline.preview_pipeline(
                    state, batch, args.output_path if rank == 0 else None,
                    state.step)
    finally:
        if profiler.active:  # the loop ended inside the traced steps
            logger.log(state.step, profiler.stop(state.step))
        logger.close()
        if prefetch is not None:
            prefetch.close()
    ckpt_lib.save_checkpoint(args.output_path, state.step, state, generator)
    if rank == 0:
        print(f"done at step {state.step}", flush=True)
    return state


if __name__ == "__main__":
    main()
