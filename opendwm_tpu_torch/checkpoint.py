"""Checkpoint save/load of the training state (``opendwm_tpu/checkpoint.py``).

One file per step, written with ``torch.save``:

    {output}/checkpoints/{step}/state.pt   — model, optimizer, LR scheduler,
                                             gradient accumulator, step and
                                             the generator's state

so that loading it and taking the next step gives what an uninterrupted
run gives. ``save_model_only`` / ``load_model_only`` handle the weights
alone (the deployable export). The JAX package's sharded Orbax layout has
no counterpart on one card.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import torch

_STATE_FILE = "state.pt"


def _step_dir(output_path: str, step: int) -> Path:
    return Path(output_path).resolve() / "checkpoints" / str(step)


def save_checkpoint(output_path: str, step: int, state,
                    generator: Optional[torch.Generator] = None) -> Path:
    """Write ``state`` (a ``pipelines.ctsd.TrainState``) and the generator's
    state under ``{output_path}/checkpoints/{step}/``; returns the file."""
    path = _step_dir(output_path, step) / _STATE_FILE
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {
        "step": state.step,
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "lr_scheduler": state.lr_scheduler.state_dict(),
        "accumulator": None if state.accumulator is None
        else state.accumulator.state_dict(),
        "generator": None if generator is None else generator.get_state(),
    }
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(output_path: str, step: int, state,
                    generator: Optional[torch.Generator] = None):
    """Load the checkpoint of ``step`` into ``state`` (built by
    ``init_state``) and ``generator``, in place; returns ``state``."""
    device = next(state.model.parameters()).device
    payload = torch.load(_step_dir(output_path, step) / _STATE_FILE,
                         map_location=device, weights_only=True)
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.lr_scheduler.load_state_dict(payload["lr_scheduler"])
    if (payload["accumulator"] is None) != (state.accumulator is None):
        raise ValueError("the checkpoint and the state disagree on gradient "
                         "accumulation")
    if state.accumulator is not None:
        state.accumulator.load_state_dict(payload["accumulator"])
    if generator is not None and payload["generator"] is not None:
        generator.set_state(payload["generator"].cpu())
    state.step = payload["step"]
    return state


def latest_step(output_path: str) -> Optional[int]:
    """The highest step with a checkpoint under ``output_path``, or None."""
    root = Path(output_path).resolve() / "checkpoints"
    steps = [int(p.name) for p in root.glob("*")
             if p.name.isdigit() and (p / _STATE_FILE).exists()]
    return max(steps, default=None)


def save_model_only(path: str, model: torch.nn.Module) -> None:
    """The weights alone, as one ``torch.save`` of the state dict."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(model.state_dict(), path)


def load_model_only(path: str, model: Optional[torch.nn.Module] = None):
    """The saved state dict, or ``model`` with it loaded (strict)."""
    state_dict = torch.load(path, map_location="cpu", weights_only=True)
    if model is None:
        return state_dict
    model.load_state_dict(state_dict)
    return model
