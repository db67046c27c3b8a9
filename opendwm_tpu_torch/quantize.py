"""Offline int8 quantization of a checkpoint
(``opendwm_tpu/convert/quantize.py``).

Builds the model twice from its JSON object config, float and with
``quantization="int8"`` (on the meta device: only their structure is
read), and maps the float state dict onto the int8 model's with
``ops.quant.quantize_state_dict``, so exactly the layers that the int8
model serves as ``QLinear``/``QConv2d`` get per-channel int8 weights and
everything else (norms, embeddings, the temporal 3-D convs) passes
through untouched.

Usage:
    python -m opendwm_tpu_torch.quantize \\
        --config configs/ctsd/multi_datasets/ctsd_35_tirda_nwao.json \\
        --model-key pipeline.model \\
        --input /path/model.pt --output /path/model_int8.pt [--device cpu]

The input and output are ``checkpoint.save_model_only`` files (one
``torch.save`` of a state dict). The config entry must be a
``_class_name`` object config of a model that accepts ``quantization``
(DiTCrossviewTemporal, UNetCrossviewTemporal, AutoencoderKL). Unlike the
JAX CLI it takes no example input shape: the structure is read from the
modules. ``--device`` is where the weights are quantized: ``cuda`` by default,
which raises without a card (both devices give the same bits); the
output is saved from the CPU.
"""

from __future__ import annotations

import argparse
import copy
import json
from typing import Mapping

import torch

from opendwm_tpu_torch import checkpoint
from opendwm_tpu_torch.config import create_instance_from_config
from opendwm_tpu_torch.ops.quant import quantize_state_dict
from opendwm_tpu_torch.train import _device


def _dig(cfg: dict, dotted: str) -> dict:
    node = cfg
    for part in dotted.split("."):
        node = node[part]
    return node


def _structure(config: dict, quantization) -> torch.nn.Module:
    config = copy.deepcopy(config)
    config["quantization"] = quantization
    with torch.device("meta"):
        return create_instance_from_config(config)


def quantize_checkpoint(config: dict,
                        state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The int8 state dict of ``config``'s model from its float
    ``state_dict`` (which must name the float model's entries)."""
    names = set(_structure(config, None).state_dict())
    if names != set(state_dict):
        diff = sorted(names.symmetric_difference(state_dict))
        raise KeyError(f"the state dict is not the config's float model's: "
                       f"{diff[:10]}")
    return quantize_state_dict(state_dict, _structure(config, "int8"))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", required=True,
                        help="JSON file holding the model object config")
    parser.add_argument("--model-key", default=None,
                        help="dotted path to the _class_name object inside "
                             "the config JSON (default: the file root)")
    parser.add_argument("--input", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where the weights are quantized")
    args = parser.parse_args(argv)
    device = _device(args.device)

    with open(args.config) as f:
        cfg = json.load(f)
    if args.model_key:
        cfg = _dig(cfg, args.model_key)
    state = {k: v.to(device)
             for k, v in checkpoint.load_model_only(args.input).items()}
    qstate = {k: v.cpu() for k, v in quantize_checkpoint(cfg, state).items()}
    checkpoint.save_model_only(args.output, qstate)
    n8 = sum(v.numel() for v in qstate.values() if v.dtype == torch.int8)
    print(f"quantized: {n8 / 1e6:.1f}M int8 params -> {args.output}")


if __name__ == "__main__":
    main()
