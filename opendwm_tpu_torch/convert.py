"""Weight bridge from the JAX package's flax params to port state dicts.

The inverses of ``opendwm_tpu/convert/torch_import.py``'s
``convert_ctsd_dit``, ``convert_ctsd_unet`` and ``convert_autoencoder_kl``:
a nested dict of
numpy arrays (``{"params": {...}}`` or the inner tree) becomes a flat
``{reference_name: np.ndarray}`` dict that ``load_state_dict`` takes
(through :func:`to_torch`). Rules, reversed:

- flax Dense ``kernel`` (in, out) → Linear ``weight`` (out, in);
- flax Conv ``kernel`` (kh, kw, in, out) → Conv2d ``weight`` (out, in, kh, kw),
  and (kt, kh, kw, in, out) → Conv3d ``weight`` (out, in, kt, kh, kw);
- LayerNorm/GroupNorm/RMSNorm ``scale`` → ``weight``, ``bias`` → ``bias``.

The way back, for the DiT and the UNet: ``flax_param_name`` names a port
parameter as the JAX package's trees name it (its ``freezing_pattern``
regexes are written against those names), and
``dit_flax_from_state_dict`` / ``unet_flax_from_state_dict`` map a port
state dict (weights or gradients) onto the flax tree.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch


def _tree(params: Mapping) -> Mapping:
    return params["params"] if "params" in params else params


def _get(tree: Mapping, path: str):
    node = tree
    for p in path.split("/"):
        node = node[p]
    return node


def _has(tree: Mapping, path: str) -> bool:
    try:
        _get(tree, path)
    except KeyError:
        return False
    return True


def _linear(tree, sd, src: str, dst: str):
    node = _get(tree, src)
    sd[f"{dst}.weight"] = np.asarray(node["kernel"]).T
    sd[f"{dst}.bias"] = np.asarray(node["bias"])


def _conv(tree, sd, src: str, dst: str):
    node = _get(tree, src)
    sd[f"{dst}.weight"] = np.asarray(node["kernel"]).transpose(3, 2, 0, 1)
    sd[f"{dst}.bias"] = np.asarray(node["bias"])


def _norm(tree, sd, src: str, dst: str):
    node = _get(tree, src)
    sd[f"{dst}.weight"] = np.asarray(node["scale"])
    if "bias" in node:
        sd[f"{dst}.bias"] = np.asarray(node["bias"])


def _count(tree, prefix: str) -> int:
    """Number of ``{prefix}_{i}`` entries, i = 0, 1, ..."""
    n = 0
    while f"{prefix}_{n}" in tree:
        n += 1
    return n


def _attention(tree, sd, src, dst):
    for p in ("to_q", "to_k", "to_v"):
        _linear(tree, sd, f"{src}/{p}", f"{dst}.{p}")
    _linear(tree, sd, f"{src}/to_out", f"{dst}.to_out.0")
    for p in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
        if _has(tree, f"{src}/{p}"):
            _norm(tree, sd, f"{src}/{p}", f"{dst}.{p}")
    for p in ("add_q_proj", "add_k_proj", "add_v_proj", "to_add_out"):
        if _has(tree, f"{src}/{p}"):
            _linear(tree, sd, f"{src}/{p}", f"{dst}.{p}")


def _feed_forward(tree, sd, src, dst):
    _linear(tree, sd, f"{src}/proj_in", f"{dst}.net.0.proj")
    _linear(tree, sd, f"{src}/proj_out", f"{dst}.net.2")


def _vt_block(tree, sd, src, dst):
    for p in ("norm_in", "norm1", "norm3"):
        _norm(tree, sd, f"{src}/{p}", f"{dst}.{p}")
    _feed_forward(tree, sd, f"{src}/ff_in", f"{dst}.ff_in")
    _attention(tree, sd, f"{src}/attn1", f"{dst}.attn1")
    _feed_forward(tree, sd, f"{src}/ff", f"{dst}.ff")


_DIT_TOP_LEVEL = re.compile(
    r"(pos_embed|context_embedder|time_text_embed|view_embedding|"
    r"transformer_blocks_\d+|crossview_transformer_blocks_\d+|"
    r"temporal_transformer_blocks_\d+|view_pos_embeds_\d+|"
    r"time_pos_embeds_\d+|view_mixers_\d+|time_mixers_\d+|norm_out|proj_out)"
)


def dit_state_dict_from_flax(params: Mapping, num_layers: int) -> dict:
    """Flax ``DiTCrossviewTemporal`` params → reference state dict (numpy)."""
    tree = _tree(params)
    unknown = [k for k in tree if not _DIT_TOP_LEVEL.fullmatch(k)]
    if unknown:
        raise NotImplementedError(
            f"params outside the ported slice: {sorted(unknown)}")
    sd: dict = {}
    _conv(tree, sd, "pos_embed/proj", "pos_embed.proj")
    _linear(tree, sd, "context_embedder", "context_embedder")
    for name in ("timestep_embedder", "text_embedder"):
        for lin in ("linear_1", "linear_2"):
            _linear(tree, sd, f"time_text_embed/{name}/{lin}",
                    f"time_text_embed.{name}.{lin}")
    if "view_embedding" in tree:
        for lin in ("linear_1", "linear_2"):
            _linear(tree, sd, f"view_embedding/{lin}", f"view_embedding.{lin}")

    for i in range(num_layers):
        src, dst = f"transformer_blocks_{i}", f"transformer_blocks.{i}"
        _linear(tree, sd, f"{src}/norm1/linear", f"{dst}.norm1.linear")
        _linear(tree, sd, f"{src}/norm1_context/linear",
                f"{dst}.norm1_context.linear")
        _attention(tree, sd, f"{src}/attn", f"{dst}.attn")
        if _has(tree, f"{src}/attn2"):
            _attention(tree, sd, f"{src}/attn2", f"{dst}.attn2")
        _feed_forward(tree, sd, f"{src}/ff", f"{dst}.ff")
        if _has(tree, f"{src}/ff_context"):
            _feed_forward(tree, sd, f"{src}/ff_context", f"{dst}.ff_context")

    for kind in ("crossview_transformer_blocks", "temporal_transformer_blocks"):
        for j in range(_count(tree, kind)):
            _vt_block(tree, sd, f"{kind}_{j}", f"{kind}.{j}")
    for kind in ("view_pos_embeds", "time_pos_embeds"):
        for j in range(_count(tree, kind)):
            for lin in ("linear_1", "linear_2"):
                _linear(tree, sd, f"{kind}_{j}/{lin}", f"{kind}.{j}.{lin}")
    for kind in ("view_mixers", "time_mixers"):
        for j in range(_count(tree, kind)):
            node = tree[f"{kind}_{j}"]
            key = "mix_factor" if "mix_factor" in node else "scale"
            sd[f"{kind}.{j}.{key}"] = np.asarray(node[key])

    _linear(tree, sd, "norm_out/linear", "norm_out.linear")
    _linear(tree, sd, "proj_out", "proj_out")
    return sd


# Port module-path pieces → flax ones (the reverse of the rules of the DiT
# and UNet bridges).
_FLAX_PIECES = (
    (re.compile(r"(^|\.)((?:crossview_|temporal_)?transformer_blocks|"
                r"view_pos_embeds|time_pos_embeds|view_mixers|time_mixers|"
                r"down_blocks|up_blocks|resnets|attentions)\.(\d+)(?=\.)"),
     r"\1\2_\3"),
    (re.compile(r"\.to_out\.0\."), ".to_out."),
    (re.compile(r"\.net\.0\.proj\."), ".proj_in."),
    (re.compile(r"\.net\.2\."), ".proj_out."),
    (re.compile(r"\.downsamplers\.0\.conv\."), ".downsample."),
    (re.compile(r"\.upsamplers\.0\.conv\."), ".upsample."),
)
# torch weight axes → flax kernel axes: Linear, Conv2d, Conv3d.
_FLAX_AXES = {2: (1, 0), 4: (2, 3, 1, 0), 5: (2, 3, 4, 1, 0)}


def flax_param_name(name: str, ndim: int) -> str:
    """The JAX package's dotted name of DiT or UNet parameter ``name``
    (``ndim``: its rank): ``transformer_blocks.0.ff.net.0.proj.weight`` →
    ``transformer_blocks_0.ff.proj_in.kernel``,
    ``down_blocks.0.resnets.1.spatial_res_block.norm1.weight`` →
    ``down_blocks_0.resnets_1.spatial_res_block.norm1.scale``."""
    for pattern, repl in _FLAX_PIECES:
        name = pattern.sub(repl, name)
    head, _, leaf = name.rpartition(".")
    if leaf == "weight":
        leaf = "kernel" if ndim >= 2 else "scale"
    return f"{head}.{leaf}"


def _flax_from_state_dict(state_dict: Mapping, qkv_bias: bool) -> dict:
    """Port state dict (tensors or arrays) → flax ``{"params": tree}`` of
    numpy arrays; ``qkv_bias`` adds the zero q/k/v biases that the flax
    UNet holds and the reference's has not."""
    tree: dict = {}
    for name, value in state_dict.items():
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().float().numpy()
        value = np.asarray(value)
        if value.ndim in _FLAX_AXES:
            value = value.transpose(_FLAX_AXES[value.ndim])
        *path, leaf = flax_param_name(name, value.ndim).split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value
        if qkv_bias and leaf == "kernel" and path[-1] in ("to_q", "to_k",
                                                          "to_v"):
            node["bias"] = np.zeros(value.shape[-1], value.dtype)
    return {"params": tree}


def dit_flax_from_state_dict(state_dict: Mapping) -> dict:
    """Port DiT state dict (tensors or arrays; weights or their gradients)
    → the flax ``{"params": tree}`` of numpy arrays, inverting
    ``dit_state_dict_from_flax``."""
    return _flax_from_state_dict(state_dict, qkv_bias=False)


def unet_flax_from_state_dict(state_dict: Mapping) -> dict:
    """Port UNet state dict (tensors or arrays; weights or their
    gradients) → the flax ``{"params": tree}`` of numpy arrays, inverting
    ``unet_state_dict_from_flax``: Conv3d kernels included, and the zero
    q/k/v biases of the flax model put back (zero gradients too: the port
    has no such parameter)."""
    return _flax_from_state_dict(state_dict, qkv_bias=True)


def _resnet(tree, sd, src, dst):
    for p in ("norm1", "norm2"):
        _norm(tree, sd, f"{src}/{p}", f"{dst}.{p}")
    for p in ("conv1", "conv2", "conv_shortcut"):
        if _has(tree, f"{src}/{p}"):
            _conv(tree, sd, f"{src}/{p}", f"{dst}.{p}")


def _vae_attention(tree, sd, src, dst):
    _norm(tree, sd, f"{src}/group_norm", f"{dst}.group_norm")
    for p in ("to_q", "to_k", "to_v"):
        _linear(tree, sd, f"{src}/{p}", f"{dst}.{p}")
    _linear(tree, sd, f"{src}/to_out", f"{dst}.to_out.0")


def _blocks(tree, kind: str) -> dict[int, list[int]]:
    """``{kind}_{i}_resnet_{j}`` names → {i: [j, ...]} (kind: up / down)."""
    found: dict[int, list[int]] = {}
    for name in tree:
        m = re.fullmatch(rf"{kind}_(\d+)_resnet_(\d+)", name)
        if m:
            found.setdefault(int(m.group(1)), []).append(int(m.group(2)))
    return {i: sorted(js) for i, js in sorted(found.items())}


def vae_state_dict_from_flax(params: Mapping) -> dict:
    """Flax ``AutoencoderKL`` params → diffusers state dict (numpy), encoder
    included when the params hold one."""
    tree = _tree(params)
    sd: dict = {}
    for part, kind, blocks, sampler in (
        ("encoder", "down", "down_blocks", "downsamplers"),
        ("decoder", "up", "up_blocks", "upsamplers"),
    ):
        if part not in tree:
            continue
        sub = tree[part]
        _conv(sub, sd, "conv_in", f"{part}.conv_in")
        for i, js in _blocks(sub, kind).items():
            for j in js:
                _resnet(sub, sd, f"{kind}_{i}_resnet_{j}",
                        f"{part}.{blocks}.{i}.resnets.{j}")
            name = f"{kind}_{i}_{'downsample' if kind == 'down' else 'upsample'}"
            if name in sub:
                _conv(sub, sd, name, f"{part}.{blocks}.{i}.{sampler}.0.conv")
        for j in (0, 1):
            _resnet(sub, sd, f"mid_resnet_{j}", f"{part}.mid_block.resnets.{j}")
        _vae_attention(sub, sd, "mid_attn", f"{part}.mid_block.attentions.0")
        _norm(sub, sd, "conv_norm_out", f"{part}.conv_norm_out")
        _conv(sub, sd, "conv_out", f"{part}.conv_out")
    for name in ("quant_conv", "post_quant_conv"):
        if name in tree:
            _conv(tree, sd, name, name)
    return sd


# UNet flax module names → reference state-dict pieces.
_UNET_LISTS = ("down_blocks", "up_blocks", "resnets", "attentions",
               "transformer_blocks", "crossview_transformer_blocks",
               "temporal_transformer_blocks")
_UNET_RENAMES = {"downsample": "downsamplers.0.conv",
                 "upsample": "upsamplers.0.conv", "to_out": "to_out.0"}


def _unet_piece(parent: str, name: str) -> str:
    m = re.fullmatch(r"(.+)_(\d+)", name)
    if m and m.group(1) in _UNET_LISTS:
        return f"{m.group(1)}.{m.group(2)}"
    if parent in ("ff", "ff_in"):
        return {"proj_in": "net.0.proj", "proj_out": "net.2"}[name]
    return _UNET_RENAMES.get(name, name)


def _leaf(name: str, value: np.ndarray) -> tuple[str, np.ndarray]:
    """A flax leaf as the torch parameter (name, value)."""
    if name == "kernel":
        axes = {2: (1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}[value.ndim]
        return "weight", value.transpose(axes)
    return {"scale": "weight"}.get(name, name), value


def unet_state_dict_from_flax(params: Mapping) -> dict:
    """Flax ``UNetCrossviewTemporal`` params → reference state dict (numpy),
    Conv3d kernels included. The reference's q/k/v projections have no
    bias: the flax model's (zero after ``convert_ctsd_unet``) are dropped,
    and a nonzero one raises."""
    sd: dict = {}

    def walk(node, path: list[str]):
        for name, value in node.items():
            if isinstance(value, Mapping):
                parent = path[-1] if path else ""
                walk(value, path + [_unet_piece(parent, name)])
                continue
            leaf, value = _leaf(name, np.asarray(value))
            if leaf == "bias" and path[-1] in ("to_q", "to_k", "to_v"):
                if np.any(value != 0):
                    raise ValueError(
                        f"{'.'.join(path)} has a nonzero bias; the reference "
                        "UNet's q/k/v projections have none")
                continue
            sd[".".join(path + [leaf])] = value

    walk(_tree(params), [])
    return sd


def to_torch(state_dict: Mapping[str, np.ndarray]) -> dict:
    """numpy state dict → tensors (copies, so the source may be read-only)."""
    return {k: torch.tensor(np.asarray(v)) for k, v in state_dict.items()}
