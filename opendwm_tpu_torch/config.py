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
    "dwm.models.adapters": "opendwm_tpu_torch.models.adapters",
    "ImageAdapter": "opendwm_tpu_torch.models.adapters",
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
    # the host data stack: filesystems, readers, the bucket sampler
    "dwm.fs": "opendwm_tpu_torch.fs",
    "fsspec.implementations.local": "opendwm_tpu_torch.fs",
    "LocalFileSystem": "opendwm_tpu_torch.fs",
    "DirFileSystem": "opendwm_tpu_torch.fs",
    "CombinedZipFileSystem": "opendwm_tpu_torch.fs",
    "CombinedTarFileSystem": "opendwm_tpu_torch.fs",
    "ForkableS3FileSystem": "opendwm_tpu_torch.fs",
    "dwm.datasets.common": "opendwm_tpu_torch.datasets.common",
    "CollateFnIgnoring": "opendwm_tpu_torch.datasets.common",
    "DatasetAdapter": "opendwm_tpu_torch.datasets.common",
    "ConcatMotionDataset": "opendwm_tpu_torch.datasets.common",
    "dwm.datasets.nuscenes": "opendwm_tpu_torch.datasets.nuscenes",
    "NuScenesDataset": "opendwm_tpu_torch.datasets.nuscenes",
    "dwm.datasets.waymo": "opendwm_tpu_torch.datasets.waymo",
    "WaymoDataset": "opendwm_tpu_torch.datasets.waymo",
    "dwm.datasets.argoverse": "opendwm_tpu_torch.datasets.argoverse",
    "ArgoverseDataset": "opendwm_tpu_torch.datasets.argoverse",
    "dwm.datasets.kitti360": "opendwm_tpu_torch.datasets.kitti360",
    "Kitti360Dataset": "opendwm_tpu_torch.datasets.kitti360",
    "dwm.datasets.opendv": "opendwm_tpu_torch.datasets.opendv",
    "OpenDVDataset": "opendwm_tpu_torch.datasets.opendv",
    "dwm.datasets.carla_streaming":
        "opendwm_tpu_torch.datasets.carla_streaming",
    "StreamingDataAdapter": "opendwm_tpu_torch.datasets.carla_streaming",
    "dwm.datasets.preview": "opendwm_tpu_torch.datasets.preview",
    "PreviewDataset": "opendwm_tpu_torch.datasets.preview",
    "dwm.utils.sampler": "opendwm_tpu_torch.utils.sampler",
    "VariableVideoBatchSampler": "opendwm_tpu_torch.utils.sampler",
    "transformers.CLIPTextModel": "opendwm_tpu_torch.models.text_encoders",
    "transformers.CLIPTextModelWithProjection":
        "opendwm_tpu_torch.models.text_encoders",
    "transformers.T5EncoderModel": "opendwm_tpu_torch.models.text_encoders",
    "CLIPTextEncoder": "opendwm_tpu_torch.models.text_encoders",
    "T5TextEncoder": "opendwm_tpu_torch.models.text_encoders",
    "SD3TextStage": "opendwm_tpu_torch.models.text_stage",
    "CLIPTextStage": "opendwm_tpu_torch.models.text_stage",
    "dwm.pipelines.ctsd.StreamingCrossviewTemporalSD":
        "opendwm_tpu_torch.pipelines.ctsd_streaming",
    "StreamingCTSDPipeline": "opendwm_tpu_torch.pipelines.ctsd_streaming",
    "SyntheticStreamingAdapter": "opendwm_tpu_torch.datasets.synthetic",
    "dwm.models.voxelizer": "opendwm_tpu_torch.ops.voxelize",
    "Voxelizer": "opendwm_tpu_torch.ops.voxelize",
    "dwm.models.vq_point_cloud": "opendwm_tpu_torch.models.vq_point_cloud",
    "VQPointCloud": "opendwm_tpu_torch.models.vq_point_cloud",
    "VectorQuantizer": "opendwm_tpu_torch.models.vq_point_cloud",
    "VQEncoder": "opendwm_tpu_torch.models.vq_point_cloud",
    "VQDecoder": "opendwm_tpu_torch.models.vq_point_cloud",
    "dwm.models.maskgit_model": "opendwm_tpu_torch.models.maskgit",
    "BidirectionalTransformerWithAdapter": "opendwm_tpu_torch.models.maskgit",
    "dwm.pipelines.lidar_maskgit": "opendwm_tpu_torch.pipelines.lidar_maskgit",
    "MaskGITPipeline": "opendwm_tpu_torch.pipelines.lidar_maskgit",
    "dwm.pipelines.lidar_diffusion":
        "opendwm_tpu_torch.pipelines.lidar_diffusion",
    "LidarDiffusionPipeline": "opendwm_tpu_torch.pipelines.lidar_diffusion",
    "dwm.pipelines.unimlvg": "opendwm_tpu_torch.pipelines.unimlvg",
    "Unimlvg": "opendwm_tpu_torch.pipelines.unimlvg",
    "diffusers.AutoencoderKLCogVideoX":
        "opendwm_tpu_torch.models.temporal_vae",
    "TemporalAutoencoderKL": "opendwm_tpu_torch.models.temporal_vae",
    "dwm.models.mask_layers": "opendwm_tpu_torch.models.mask_layers",
    "MaskController": "opendwm_tpu_torch.models.mask_layers",
    "dwm.models.vae_point_cloud": "opendwm_tpu_torch.models.vae_point_cloud",
    "dwm.models.lidar_vae_model": "opendwm_tpu_torch.models.vae_point_cloud",
    "VAEPointCloud": "opendwm_tpu_torch.models.vae_point_cloud",
    "dwm.pipelines.lidar_vqvae": "opendwm_tpu_torch.pipelines.lidar_vqvae",
    "LidarCodebook": "opendwm_tpu_torch.pipelines.lidar_vqvae",
    "dwm.pipelines.lidar_vae": "opendwm_tpu_torch.pipelines.lidar_vae",
    "LidarVAE": "opendwm_tpu_torch.pipelines.lidar_vae",
    "SyntheticLidarDataset": "opendwm_tpu_torch.datasets.synthetic",
    "dwm.metrics": "opendwm_tpu_torch.metrics",
    "FrechetDistance": "opendwm_tpu_torch.metrics",
    "FrechetPairedMetric": "opendwm_tpu_torch.metrics",
    "CustomMeanMetric": "opendwm_tpu_torch.metrics",
    "VoxelIoU": "opendwm_tpu_torch.metrics",
    "VoxelDiff": "opendwm_tpu_torch.metrics",
    "PointCloudChamfer": "opendwm_tpu_torch.metrics",
    "PointCloudMMD": "opendwm_tpu_torch.metrics",
    "PointCloudJSD": "opendwm_tpu_torch.metrics",
    "FIDInceptionV3": "opendwm_tpu_torch.models.inception",
    "InceptionI3d": "opendwm_tpu_torch.models.i3d",
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
        "the CTSD-3.5 MMDiT and CTSD-2.1 UNet serving and training paths, "
        "with the layout ImageAdapter and the image VAE, streaming serving, "
        "the CLIP/T5 text stage, LiDAR serving and training (the VQ and KL "
        "tokenizers, MaskGIT, the LiDAR DiT and UNet), UniMLVG, MaskGWM, "
        "the temporal VAE, the host data stack, the metrics and the FID/FVD "
        "feature nets; see ROADMAP.md Queue 1)."
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
