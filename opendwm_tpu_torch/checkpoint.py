"""Checkpoint save/load of the training state (``opendwm_tpu/checkpoint.py``).

One file per step, written with ``torch.save``:

    {output}/checkpoints/{step}/state.pt   — model, optimizer, LR scheduler,
                                             gradient accumulator, step, the
                                             generator's state and the
                                             state's own extra fields (a
                                             LiDAR codebook's ages, usage
                                             and reservoir)

so that loading it and taking the next step gives what an uninterrupted
run gives. ``save_model_only`` / ``load_model_only`` handle the weights
alone (the deployable export).

A train state placed over a process group (``parallel.train_state``:
FSDP, HSDP or DDP) is saved as the JAX package's Orbax layout allows,
restorable under another world size: the model and optimizer through
``torch.distributed.checkpoint`` with the state-dict helpers (each rank
writes its shards, ``{step}/dcp/``), the rest by rank 0 (``{step}/meta.pt``).
Either layout loads into a state of any placement: a sharded checkpoint
into one process without a process group, a one-device ``state.pt`` into
a sharded state.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Optional

import torch

_STATE_FILE = "state.pt"
_DCP_DIR = "dcp"
_META_FILE = "meta.pt"
_BASE_FIELDS = ("step", "model", "optimizer", "lr_scheduler", "accumulator")


def _extra_fields(state) -> list:
    return [f.name for f in dataclasses.fields(state)
            if f.name not in _BASE_FIELDS]


def _step_dir(output_path: str, step: int) -> Path:
    return Path(output_path).resolve() / "checkpoints" / str(step)


def _is_placed(state) -> bool:
    """Whether ``state``'s model lies over a process group."""
    return getattr(state.model, "_mesh_policy", None) is not None


def _meta(state, generator) -> dict:
    return {
        "step": state.step,
        "lr_scheduler": state.lr_scheduler.state_dict(),
        "accumulator": None if state.accumulator is None
        else state.accumulator.state_dict(),
        "generator": None if generator is None else generator.get_state(),
        "extra": {name: getattr(state, name) for name in _extra_fields(state)},
    }


def _save_sharded(step_dir: Path, state, generator) -> Path:
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.state_dict import get_state_dict

    model_sd, optim_sd = get_state_dict(state.model, state.optimizer)
    dcp.save({"model": model_sd, "optimizer": optim_sd},
             checkpoint_id=str(step_dir / _DCP_DIR))
    meta = step_dir / _META_FILE
    if dist.get_rank() == 0:
        tmp = meta.with_suffix(f".{os.getpid()}.tmp")
        torch.save(_meta(state, generator), tmp)
        os.replace(tmp, meta)
    dist.barrier()
    return meta


def save_checkpoint(output_path: str, step: int, state,
                    generator: Optional[torch.Generator] = None) -> Path:
    """Write ``state`` (a ``pipelines.ctsd.TrainState``) and the generator's
    state under ``{output_path}/checkpoints/{step}/``; returns the file (a
    placed state: its ``meta.pt``, beside the sharded ``dcp/``; every rank
    calls this)."""
    if _is_placed(state):
        step_dir = _step_dir(output_path, step)
        step_dir.mkdir(parents=True, exist_ok=True)
        return _save_sharded(step_dir, state, generator)
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
        "extra": {name: getattr(state, name) for name in _extra_fields(state)},
    }
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def _load_model_and_optimizer(step_dir: Path, state, device) -> dict:
    """The model and optimizer of either layout into ``state``, whatever its
    placement; returns the rest of the payload."""
    from opendwm_tpu_torch.parallel.train_state import (
        fqns,
        load_full_optimizer_state,
        optimizer_state_by_name,
    )

    if (step_dir / _STATE_FILE).exists():
        payload = torch.load(step_dir / _STATE_FILE, map_location=device,
                             weights_only=True)
        if not _is_placed(state):
            state.model.load_state_dict(payload["model"])
            state.optimizer.load_state_dict(payload["optimizer"])
            return payload
        from torch.distributed.checkpoint.state_dict import (
            StateDictOptions,
            set_model_state_dict,
        )

        # the one-device file: its optimizer state keyed by name, as the
        # unplaced optimizer over the same parameters orders them
        set_model_state_dict(state.model, payload["model"],
                             options=StateDictOptions(full_state_dict=True))
        names = fqns(state.model, state.optimizer)
        osd = payload["optimizer"]
        load_full_optimizer_state(state.model, state.optimizer, {
            "state": {names[i]: st for i, st in osd["state"].items()},
            "param_groups": [{**g, "params": [names[i] for i in g["params"]]}
                             for g in osd["param_groups"]]})
        return payload
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.state_dict import (
        get_state_dict,
        set_state_dict,
    )

    if _is_placed(state):
        model_sd, optim_sd = get_state_dict(state.model, state.optimizer)
        sd = {"model": model_sd, "optimizer": optim_sd}
        dcp.load(sd, checkpoint_id=str(step_dir / _DCP_DIR))
        set_state_dict(state.model, state.optimizer,
                       model_state_dict=sd["model"],
                       optim_state_dict=sd["optimizer"])
    else:  # one process: read the shards into whole tensors
        if not state.optimizer.state:
            _init_moments(state.optimizer)
        sd = {"model": state.model.state_dict(),
              "optimizer": optimizer_state_by_name(state.model,
                                                   state.optimizer)}
        dcp.load(sd, checkpoint_id=str(step_dir / _DCP_DIR))
        state.model.load_state_dict(sd["model"])
        load_full_optimizer_state(state.model, state.optimizer,
                                  sd["optimizer"])
    return torch.load(step_dir / _META_FILE, map_location=device,
                      weights_only=True)


def _init_moments(optimizer) -> None:
    """Create the optimizer's moments (a step at lr 0 on zero gradients,
    the state restored after), so a checkpoint's can be read into them."""
    saved = [(p, p.grad) for g in optimizer.param_groups for p in g["params"]]
    lrs = [g["lr"] for g in optimizer.param_groups]
    for g in optimizer.param_groups:
        g["lr"] = 0.0
        for p in g["params"]:
            p.grad = torch.zeros_like(p)
    with torch.no_grad():
        snapshot = [p.detach().clone() for p, _ in saved]
        optimizer.step()
        for (p, _), old in zip(saved, snapshot):
            p.copy_(old)  # weight decay at lr 0 moves nothing; keep bits
    for g, lr in zip(optimizer.param_groups, lrs):
        g["lr"] = lr
    for p, grad in saved:
        p.grad = grad


def load_checkpoint(output_path: str, step: int, state,
                    generator: Optional[torch.Generator] = None):
    """Load the checkpoint of ``step`` into ``state`` (built by
    ``init_state``) and ``generator``, in place; returns ``state``. Either
    layout, into a state of any placement (every rank calls this)."""
    device = next(state.model.parameters()).device
    payload = _load_model_and_optimizer(_step_dir(output_path, step), state,
                                        device)
    state.lr_scheduler.load_state_dict(payload["lr_scheduler"])
    if (payload["accumulator"] is None) != (state.accumulator is None):
        raise ValueError("the checkpoint and the state disagree on gradient "
                         "accumulation")
    if state.accumulator is not None:
        state.accumulator.load_state_dict(payload["accumulator"])
    if generator is not None and payload["generator"] is not None:
        generator.set_state(payload["generator"].cpu())
    for name, value in payload.get("extra", {}).items():
        setattr(state, name, value)
    state.step = payload["step"]
    return state


def latest_step(output_path: str) -> Optional[int]:
    """The highest step with a checkpoint under ``output_path``, or None."""
    root = Path(output_path).resolve() / "checkpoints"
    steps = [int(p.name) for p in root.glob("*")
             if p.name.isdigit() and ((p / _STATE_FILE).exists()
                                      or (p / _META_FILE).exists())]
    return max(steps, default=None)


def save_model_only(path: str, model) -> None:
    """The weights alone, as one ``torch.save`` of the state dict
    (``model``: a module, or a state dict)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    state = model.state_dict() if isinstance(model, torch.nn.Module) \
        else dict(model)
    torch.save(state, path)


def load_model_only(path: str, model: Optional[torch.nn.Module] = None):
    """The saved state dict, or ``model`` with it loaded (strict)."""
    state_dict = torch.load(path, map_location="cpu", weights_only=True)
    if model is None:
        return state_dict
    model.load_state_dict(state_dict)
    return model
