"""Config → object-graph runtime for the PyTorch port.

Same JSON semantics as ``opendwm_tpu.config`` (a dict with ``_class_name``
is reflected into a live object; other dicts and lists recurse; the
``get_class`` special form returns the class itself), but every name
resolves to a class of this package, and resolving one never imports JAX.
The JAX package's registry cannot be shared: importing it loads
``jax.numpy`` to register its dtype names.

Resolution order: the registry, then the ``dwm.*`` reference aliases, then
the lazy module map (reference module path → port module whose import
registers the class). Anything else raises ``KeyError`` naming the class.
"""

from __future__ import annotations

import importlib
from typing import Any, Callable

import torch

_REGISTRY: dict[str, Callable] = {}
_ALIASES: dict[str, str] = {}


def register(name: str | None = None, aliases: tuple[str, ...] = ()):
    """Class/function decorator adding the object to the config registry."""

    def wrap(obj):
        key = name or f"{obj.__module__}.{obj.__qualname__}"
        _REGISTRY[key] = obj
        _REGISTRY.setdefault(obj.__qualname__, obj)
        for a in aliases:
            _ALIASES[a] = key
        return obj

    return wrap


# Reference module path (or short name) → the port module registering it.
_LAZY_MODULES: dict[str, str] = {
    "dwm.models.crossview_temporal_dit": "opendwm_tpu_torch.models.mmdit",
    "dwm.models.crossview_temporal_unet": "opendwm_tpu_torch.models.unet",
    "dwm.schedulers.temporal_independent": "opendwm_tpu_torch.schedulers",
    "diffusers.FlowMatchEulerDiscreteScheduler": "opendwm_tpu_torch.schedulers",
    "diffusers.DDPMScheduler": "opendwm_tpu_torch.schedulers",
    "diffusers.DDIMScheduler": "opendwm_tpu_torch.schedulers",
    "diffusers.AutoencoderKL": "opendwm_tpu_torch.models.autoencoders",
    "dwm.pipelines.ctsd": "opendwm_tpu_torch.pipelines.ctsd",
    "CTSDPipeline": "opendwm_tpu_torch.pipelines.ctsd",
    "DiTCrossviewTemporal": "opendwm_tpu_torch.models.mmdit",
    "UNetCrossviewTemporal": "opendwm_tpu_torch.models.unet",
    "FlowMatchEulerScheduler": "opendwm_tpu_torch.schedulers",
    "DDPMScheduler": "opendwm_tpu_torch.schedulers",
    "DDIMScheduler": "opendwm_tpu_torch.schedulers",
    "AutoencoderKL": "opendwm_tpu_torch.models.autoencoders",
    "torch.optim.lr_scheduler": "opendwm_tpu_torch.pipelines.optim",
    "CosineAnnealingLR": "opendwm_tpu_torch.pipelines.optim",
    "ExponentialLR": "opendwm_tpu_torch.pipelines.optim",
    "LinearLR": "opendwm_tpu_torch.pipelines.optim",
    "SyntheticCTSDDataset": "opendwm_tpu_torch.datasets.synthetic",
    "dwm.datasets.common": "opendwm_tpu_torch.datasets.common",
    "CollateFnIgnoring": "opendwm_tpu_torch.datasets.common",
}


def _lazy_import_for(class_name: str) -> None:
    parts = class_name.split(".")
    for depth in range(len(parts), 0, -1):
        target = _LAZY_MODULES.get(".".join(parts[:depth]))
        if target is not None:
            importlib.import_module(target)
            return


def get_class(class_name: str):
    """Resolve a class path or short name to a callable of this package."""
    if class_name not in _REGISTRY and class_name not in _ALIASES:
        _lazy_import_for(class_name)
    if class_name in _REGISTRY:
        return _REGISTRY[class_name]
    if class_name in _ALIASES:
        return get_class(_ALIASES[class_name])
    raise KeyError(
        f"{class_name!r} has no PyTorch port yet (opendwm_tpu_torch covers "
        "the CTSD-3.5 serving and training paths and the CTSD-2.1 serving "
        "path; see ROADMAP.md Queue 1)."
    )


def create_instance(class_name: str, **kwargs):
    return get_class(class_name)(**kwargs)


def create_instance_from_config(_config: Any, level: int = 0, **kwargs):
    """Recursively reflect a JSON config node into live objects.

    Extra ``kwargs`` are injected into the top-level instantiation only.
    """
    if isinstance(_config, dict):
        if "_class_name" in _config:
            args = instantiate_config(_config, level)
            if level == 0:
                args.update(kwargs)
            if _config["_class_name"] == "get_class":
                return get_class(**args)
            return create_instance(_config["_class_name"], **args)
        return instantiate_config(_config, level)
    if isinstance(_config, list):
        return [create_instance_from_config(i, level + 1) for i in _config]
    return _config


def instantiate_config(_config: dict, level: int = 0) -> dict:
    return {
        k: create_instance_from_config(v, level + 1)
        for k, v in _config.items()
        if k != "_class_name"
    }


global_state: dict[str, Any] = {}


@register("get_state", aliases=("dwm.common.get_state",))
def get_state(key: str):
    return global_state[key]


# Dtype names as the configs spell them, JAX or torch style.
for _n in ("bfloat16", "float32", "float16", "int32", "int8"):
    _REGISTRY[f"torch.{_n}"] = getattr(torch, _n)
    _ALIASES[f"jnp.{_n}"] = f"torch.{_n}"
_ALIASES["torch.float"] = "torch.float32"
_ALIASES["torch.half"] = "torch.float16"
