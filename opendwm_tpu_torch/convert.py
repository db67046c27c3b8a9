"""Weight bridge from the JAX package's flax params to port state dicts.

The inverses of ``opendwm_tpu/convert/torch_import.py``'s
``convert_ctsd_dit``, ``convert_ctsd_unet`` and ``convert_autoencoder_kl``,
and maps of the CLIP and T5 text encoders onto port names that mirror
their flax trees: a nested dict of
numpy arrays (``{"params": {...}}`` or the inner tree) becomes a flat
``{reference_name: np.ndarray}`` dict that ``load_state_dict`` takes
(through :func:`to_torch`). Rules, reversed:

- flax Dense ``kernel`` (in, out) → Linear ``weight`` (out, in);
- flax Conv ``kernel`` (kh, kw, in, out) → Conv2d ``weight`` (out, in, kh, kw),
  and (kt, kh, kw, in, out) → Conv3d ``weight`` (out, in, kt, kh, kw);
- LayerNorm/GroupNorm/RMSNorm ``scale`` → ``weight``, ``bias`` → ``bias``;
- int8 trees (``quantize_param_tree``'s): ``QDense`` ``kernel_q`` (in,
  out) → ``QLinear`` ``weight_q`` (out, in), ``QConv`` ``kernel_q`` (kh,
  kw, in, out) → ``QConv2d`` ``weight_q`` (out, kh, kw, in), each
  ``kernel_scale`` → ``weight_scale``, unchanged.

The causal temporal VAE (``TemporalAutoencoderKL``) mirrors its flax tree
(``temporal_vae_state_dict_from_flax``). The DiT's explicit perspective
projection (``rayencoder_proj``) and MaskGWM module (``mask_module``) map
both ways with the rest of the DiT.

The LiDAR tokenizers (``VQPointCloud``, ``VAEPointCloud``) and the
MaskGIT transformer (``BidirectionalTransformer``) mirror their flax
trees: ``lidar_state_dict_from_flax`` and ``lidar_flax_from_state_dict``
map them both ways (the tokenizer's ``ConvTranspose`` kernel is flipped
in space; see ``_transposed_conv_weight``), the DVGO density MLP
included; ``vae_point_cloud_state_dict_from_flax`` and
``vae_point_cloud_flax_from_state_dict`` name the same walk for the KL
tokenizer; ``bev_world_vae_state_dict_from_flax`` maps the BEV world VAE
with that walk and, for its SD-VAE image branch, the VAE's bridge. The
UNet's depth net (``depth_net``) keeps the flax names, so the UNet's
bridge carries it both ways.

The way back, for the DiT and the UNet: ``flax_param_name`` names a port
parameter as the JAX package's trees name it (its ``freezing_pattern``
regexes are written against those names), and
``dit_flax_from_state_dict`` / ``unet_flax_from_state_dict`` map a port
state dict (weights or gradients) onto the flax tree; the text encoders'
``clip_flax_from_state_dict`` / ``t5_flax_from_state_dict`` do the same
from the one parameter list that their forward maps read.
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


# flax kernel axes → port weight axes, float and int8 (``kernel_q``).
_KERNEL_AXES = {("kernel", 2): (1, 0), ("kernel", 4): (3, 2, 0, 1),
                ("kernel", 5): (4, 3, 0, 1, 2), ("kernel_q", 2): (1, 0),
                ("kernel_q", 4): (3, 0, 1, 2)}
_KERNEL_NAMES = {"kernel": "weight", "kernel_q": "weight_q",
                 "kernel_scale": "weight_scale"}


def _weights(tree, sd, src: str, dst: str):
    """A Dense or Conv node (float or int8) → ``weight`` or ``weight_q``
    and ``weight_scale``, and ``bias``."""
    node = _get(tree, src)
    for name, value in node.items():
        leaf, value = _leaf(name, np.asarray(value))
        sd[f"{dst}.{leaf}"] = value


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
        _weights(tree, sd, f"{src}/{p}", f"{dst}.{p}")
    _weights(tree, sd, f"{src}/to_out", f"{dst}.to_out.0")
    for p in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
        if _has(tree, f"{src}/{p}"):
            _norm(tree, sd, f"{src}/{p}", f"{dst}.{p}")
    for p in ("add_q_proj", "add_k_proj", "add_v_proj", "to_add_out"):
        if _has(tree, f"{src}/{p}"):
            _weights(tree, sd, f"{src}/{p}", f"{dst}.{p}")


def _feed_forward(tree, sd, src, dst):
    _weights(tree, sd, f"{src}/proj_in", f"{dst}.net.0.proj")
    _weights(tree, sd, f"{src}/proj_out", f"{dst}.net.2")


def _vt_block(tree, sd, src, dst):
    for p in ("norm_in", "norm1", "norm3"):
        _norm(tree, sd, f"{src}/{p}", f"{dst}.{p}")
    _feed_forward(tree, sd, f"{src}/ff_in", f"{dst}.ff_in")
    _attention(tree, sd, f"{src}/attn1", f"{dst}.attn1")
    _feed_forward(tree, sd, f"{src}/ff", f"{dst}.ff")


_DIT_TOP_LEVEL = re.compile(
    r"(pos_embed|context_embedder|time_text_embed|view_embedding|"
    r"rayencoder_proj|mask_module|"
    r"transformer_blocks_\d+|crossview_transformer_blocks_\d+|"
    r"temporal_transformer_blocks_\d+|view_pos_embeds_\d+|"
    r"time_pos_embeds_\d+|view_mixers_\d+|time_mixers_\d+|norm_out|proj_out|"
    r"condition_image_adapter)"
)


def image_adapter_state_dict_from_flax(params: Mapping) -> dict:
    """Flax ``ImageAdapter`` params (``body_{i}/in_conv``,
    ``body_{i}/resnets_{j}/block1|block2``, ``zero_convs_{i}``,
    ``zero_gates``) → reference state dict (numpy)."""
    tree = _tree(params)
    sd: dict = {}
    for i in range(_count(tree, "body")):
        body = f"body_{i}"
        if _has(tree, f"{body}/in_conv"):
            _weights(tree, sd, f"{body}/in_conv", f"body.{i}.in_conv")
        for j in range(_count(tree[body], "resnets")):
            for conv in ("block1", "block2"):
                _weights(tree, sd, f"{body}/resnets_{j}/{conv}",
                         f"body.{i}.resnets.{j}.{conv}")
    for i in range(_count(tree, "zero_convs")):
        _weights(tree, sd, f"zero_convs_{i}", f"zero_convs.{i}")
    if "zero_gates" in tree:
        sd["zero_gates"] = np.asarray(tree["zero_gates"])
    return sd


def mask_module_state_dict_from_flax(params: Mapping) -> dict:
    """Flax ``MaskController`` params (``mask_token``, ``mask_pos_proj``,
    ``t_block``, ``sideblocks_{i}`` and ``temporal_sideblocks_{i}`` with
    their ``scale_shift_table``, ``attn_*`` and ``mlp``) →
    the port's state dict (numpy)."""
    sd: dict = {}

    def walk(node, path: list[str]):
        for name, value in node.items():
            if isinstance(value, Mapping):
                m = re.fullmatch(r"((?:temporal_)?sideblocks)_(\d+)", name)
                if m:
                    name = f"{m.group(1)}.{m.group(2)}"
                elif path and path[-1] == "mlp":
                    name = {"proj_in": "net.0.proj", "proj_out": "net.2"}[name]
                walk(value, path + [name])
                continue
            leaf, value = _leaf(name, np.asarray(value))
            sd[".".join(path + [leaf])] = value

    walk(_tree(params), [])
    return sd


def dit_state_dict_from_flax(params: Mapping, num_layers: int) -> dict:
    """Flax ``DiTCrossviewTemporal`` params → reference state dict (numpy)."""
    tree = _tree(params)
    unknown = [k for k in tree if not _DIT_TOP_LEVEL.fullmatch(k)]
    if unknown:
        raise NotImplementedError(
            f"params outside the ported slice: {sorted(unknown)}")
    sd: dict = {}
    _weights(tree, sd, "pos_embed/proj", "pos_embed.proj")
    _weights(tree, sd, "context_embedder", "context_embedder")
    for name in ("timestep_embedder", "text_embedder"):
        for lin in ("linear_1", "linear_2"):
            _weights(tree, sd, f"time_text_embed/{name}/{lin}",
                     f"time_text_embed.{name}.{lin}")
    if "view_embedding" in tree:
        for lin in ("linear_1", "linear_2"):
            _weights(tree, sd, f"view_embedding/{lin}",
                     f"view_embedding.{lin}")
    if "rayencoder_proj" in tree:
        _weights(tree, sd, "rayencoder_proj", "rayencoder_proj")
    if "mask_module" in tree:
        sd.update({f"mask_module.{k}": v for k, v in
                   mask_module_state_dict_from_flax(
                       tree["mask_module"]).items()})

    for i in range(num_layers):
        src, dst = f"transformer_blocks_{i}", f"transformer_blocks.{i}"
        _weights(tree, sd, f"{src}/norm1/linear", f"{dst}.norm1.linear")
        _weights(tree, sd, f"{src}/norm1_context/linear",
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
                _weights(tree, sd, f"{kind}_{j}/{lin}", f"{kind}.{j}.{lin}")
    for kind in ("view_mixers", "time_mixers"):
        for j in range(_count(tree, kind)):
            node = tree[f"{kind}_{j}"]
            key = "mix_factor" if "mix_factor" in node else "scale"
            sd[f"{kind}.{j}.{key}"] = np.asarray(node[key])

    if "condition_image_adapter" in tree:
        adapter = image_adapter_state_dict_from_flax(
            tree["condition_image_adapter"])
        sd.update({f"condition_image_adapter.{k}": v
                   for k, v in adapter.items()})
    _weights(tree, sd, "norm_out/linear", "norm_out.linear")
    _weights(tree, sd, "proj_out", "proj_out")
    return sd


def flagship_stage_state_dict_from_flax(params: Mapping,
                                        layers_per_stage: int) -> dict:
    """Flax ``FlagshipStage`` params (``opendwm_tpu/parallel/
    dit_pipeline.py``; one stage's tree) → the port's ``FlagshipStage``
    state dict (numpy)."""
    tree = _tree(params)
    sd: dict = {}
    for k in range(layers_per_stage):
        src, dst = f"joint_{k}", f"joint_{k}"
        for mod in ("norm1", "norm1_context"):
            _weights(tree, sd, f"{src}/{mod}/linear", f"{dst}.{mod}.linear")
        for attn in ("attn", "attn2"):
            _attention(tree, sd, f"{src}/{attn}", f"{dst}.{attn}")
        for ff in ("ff", "ff_context"):
            _feed_forward(tree, sd, f"{src}/{ff}", f"{dst}.{ff}")
        for kind in ("time", "view"):
            for lin in ("linear_1", "linear_2"):
                _weights(tree, sd, f"{kind}_pos_embed_{k}/{lin}",
                         f"{kind}_pos_embed_{k}.{lin}")
            sd[f"{kind}_mixer_{k}.mix_factor"] = np.asarray(
                tree[f"{kind}_mixer_{k}"]["mix_factor"])
        for kind in ("temporal", "crossview"):
            _vt_block(tree, sd, f"{kind}_{k}", f"{kind}_{k}")
    return sd


# Port module-path pieces → flax ones (the reverse of the rules of the DiT
# and UNet bridges).
_FLAX_PIECES = (
    (re.compile(r"(^|\.)((?:crossview_|temporal_)?transformer_blocks|"
                r"view_pos_embeds|time_pos_embeds|view_mixers|time_mixers|"
                r"down_blocks|up_blocks|resnets|attentions|body|zero_convs|"
                r"(?:temporal_)?sideblocks)"
                r"\.(\d+)(?=\.)"),
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
    ``down_blocks_0.resnets_1.spatial_res_block.norm1.scale``,
    ``condition_image_adapter.body.0.in_conv.weight`` →
    ``condition_image_adapter.body_0.in_conv.kernel``."""
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
        if name.endswith(".weight") and value.ndim in _FLAX_AXES:
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
            _weights(tree, sd, f"{src}/{p}", f"{dst}.{p}")


def _vae_attention(tree, sd, src, dst):
    _norm(tree, sd, f"{src}/group_norm", f"{dst}.group_norm")
    for p in ("to_q", "to_k", "to_v"):
        _weights(tree, sd, f"{src}/{p}", f"{dst}.{p}")
    _weights(tree, sd, f"{src}/to_out", f"{dst}.to_out.0")


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
        _weights(sub, sd, "conv_in", f"{part}.conv_in")
        for i, js in _blocks(sub, kind).items():
            for j in js:
                _resnet(sub, sd, f"{kind}_{i}_resnet_{j}",
                        f"{part}.{blocks}.{i}.resnets.{j}")
            name = f"{kind}_{i}_{'downsample' if kind == 'down' else 'upsample'}"
            if name in sub:
                _weights(sub, sd, name,
                         f"{part}.{blocks}.{i}.{sampler}.0.conv")
        for j in (0, 1):
            _resnet(sub, sd, f"mid_resnet_{j}", f"{part}.mid_block.resnets.{j}")
        _vae_attention(sub, sd, "mid_attn", f"{part}.mid_block.attentions.0")
        _norm(sub, sd, "conv_norm_out", f"{part}.conv_norm_out")
        _weights(sub, sd, "conv_out", f"{part}.conv_out")
    for name in ("quant_conv", "post_quant_conv"):
        if name in tree:
            _weights(tree, sd, name, name)
    return sd


def temporal_vae_state_dict_from_flax(params: Mapping) -> dict:
    """Flax ``TemporalAutoencoderKL`` params → the port's state dict
    (numpy): the port's modules carry the flax names
    (``encoder_down_0_res_1.conv1.conv``), so each leaf keeps its path;
    Conv kernels (kt, kh, kw, in, out) become Conv3d weights (out, in, kt,
    kh, kw) and GroupNorm scales weights."""
    sd: dict = {}

    def walk(node, path: list[str]):
        for name, value in node.items():
            if isinstance(value, Mapping):
                walk(value, path + [name])
                continue
            leaf, value = _leaf(name, np.asarray(value))
            sd[".".join(path + [leaf])] = np.ascontiguousarray(value)

    walk(_tree(params), [])
    return sd


# UNet flax module names → reference state-dict pieces.
_UNET_LISTS = ("down_blocks", "up_blocks", "resnets", "attentions",
               "transformer_blocks", "crossview_transformer_blocks",
               "temporal_transformer_blocks", "body", "zero_convs")
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
    if (name, value.ndim) in _KERNEL_AXES:
        value = value.transpose(_KERNEL_AXES[name, value.ndim])
    return _KERNEL_NAMES.get(name, {"scale": "weight"}.get(name, name)), \
        value


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


# Text encoders: (flax path, kind) of every parameter. Kinds: "kernel"
# (Dense, transposed), "embed" (Embed's ``embedding``), "scale"
# (LayerNorm), "bias", "raw" (a parameter of the same name and layout).
# The port's name is the path with dots, ``layers_3`` as ``layers.3``.
_FLAX_LEAF = {"kernel": "kernel", "embed": "embedding", "scale": "scale",
              "bias": "bias", "raw": None}
_PORT_SUFFIX = {"kernel": ".weight", "embed": ".weight", "scale": ".weight",
                "bias": ".bias", "raw": ""}


def _clip_params(num_layers: int, projection: bool) -> list:
    pairs = [("token_embedding", "embed"), ("position_embedding", "raw")]
    for i in range(num_layers):
        for name in ("self_attn/q_proj", "self_attn/k_proj",
                     "self_attn/v_proj", "self_attn/out_proj", "fc1", "fc2"):
            pairs += [(f"layers_{i}/{name}", "kernel"),
                      (f"layers_{i}/{name}", "bias")]
        for name in ("layer_norm1", "layer_norm2"):
            pairs += [(f"layers_{i}/{name}", "scale"),
                      (f"layers_{i}/{name}", "bias")]
    pairs += [("final_layer_norm", "scale"), ("final_layer_norm", "bias")]
    if projection:
        pairs.append(("text_projection", "kernel"))
    return pairs


def _t5_params(num_layers: int) -> list:
    pairs = [("shared", "embed")]
    for i in range(num_layers):
        for name in ("attention/q", "attention/k", "attention/v",
                     "attention/o", "wi_0", "wi_1", "wo"):
            pairs.append((f"block_{i}/{name}", "kernel"))
        for name in ("ln_attn/weight", "ln_ff/weight"):
            pairs.append((f"block_{i}/{name}", "raw"))
    pairs += [("block_0/attention/relative_attention_bias", "raw"),
              ("final_layer_norm/weight", "raw")]
    return pairs


def _port_name(path: str, kind: str) -> str:
    name = re.sub(r"(layers|block)_(\d+)", r"\1.\2", path).replace("/", ".")
    return name + _PORT_SUFFIX[kind]


def _from_flax(tree: Mapping, pairs: list) -> dict:
    sd = {}
    for path, kind in pairs:
        node = _get(tree, path)
        leaf = _FLAX_LEAF[kind]
        value = np.asarray(node if leaf is None else node[leaf])
        sd[_port_name(path, kind)] = value.T if kind == "kernel" else value
    return sd


def _to_flax(state_dict: Mapping, pairs: list) -> dict:
    tree: dict = {}
    for path, kind in pairs:
        value = state_dict[_port_name(path, kind)]
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().float().numpy()
        value = np.asarray(value)
        if kind == "kernel":
            value = value.T
        leaf = _FLAX_LEAF[kind]
        parts = path.split("/") + ([] if leaf is None else [leaf])
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return {"params": tree}


def _layer_count(names, prefix: str) -> int:
    found = [int(m.group(1)) for n in names
             if (m := re.match(rf"{prefix}[._](\d+)", n))]
    return 1 + max(found) if found else 0


def clip_state_dict_from_flax(params: Mapping) -> dict:
    """Flax ``CLIPTextEncoder`` params → the port's state dict (numpy)."""
    tree = _tree(params)
    return _from_flax(tree, _clip_params(_count(tree, "layers"),
                                         "text_projection" in tree))


def clip_flax_from_state_dict(state_dict: Mapping) -> dict:
    """The port's ``CLIPTextEncoder`` state dict (tensors or arrays) → the
    flax ``{"params": tree}`` of numpy arrays."""
    return _to_flax(state_dict, _clip_params(
        _layer_count(state_dict, "layers"),
        "text_projection.weight" in state_dict))


def t5_state_dict_from_flax(params: Mapping) -> dict:
    """Flax ``T5TextEncoder`` params → the port's state dict (numpy)."""
    tree = _tree(params)
    return _from_flax(tree, _t5_params(_count(tree, "block")))


def t5_flax_from_state_dict(state_dict: Mapping) -> dict:
    """The port's ``T5TextEncoder`` state dict (tensors or arrays) → the
    flax ``{"params": tree}`` of numpy arrays."""
    return _to_flax(state_dict, _t5_params(_layer_count(state_dict,
                                                        "block")))


# LiDAR models: the port's modules mirror the flax trees, so one walk maps
# both ways. ``{X}_{i}`` of these lists is ``{X}.{i}``; a feed-forward's
# ``proj_in``/``proj_out`` are ``net.0.proj``/``net.2``.
_LIDAR_LISTS = ("blocks", "temporal_blocks", "body", "resnets", "zero_convs")


def _transposed_conv_weight(kernel: np.ndarray) -> np.ndarray:
    """flax ``ConvTranspose`` kernel (kh, kw, in, out), built without
    ``transpose_kernel`` → ``ConvTranspose2d`` weight (in, out, kh, kw):
    flax correlates the dilated input with the kernel, so at kernel 2,
    stride 2 output pixel 2i + a reads tap 1 − a; torch's reads tap a."""
    return kernel.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]


def lidar_state_dict_from_flax(params: Mapping) -> dict:
    """Flax ``VQPointCloud``, ``VAEPointCloud`` or
    ``BidirectionalTransformer`` params (or a tree of one of their
    submodules) → the port's state dict (numpy). A tree without the DVGO
    density MLP (``density_mlp_1/2``, flax creates it only when a forward
    renders) maps to a state dict without it, which the tokenizers load."""
    sd: dict = {}

    def walk(node, path: list[str]):
        for name, value in node.items():
            parent = path[-1] if path else ""
            if isinstance(value, Mapping):
                m = re.fullmatch(r"(.+)_(\d+)", name)
                if m and m.group(1) in _LIDAR_LISTS:
                    name = f"{m.group(1)}.{m.group(2)}"
                elif parent == "ff":
                    name = {"proj_in": "net.0.proj", "proj_out": "net.2"}[name]
                walk(value, path + [name])
                continue
            value = np.asarray(value)
            if name == "kernel" and parent == "upsample":
                value, name = _transposed_conv_weight(value), "weight"
            elif name == "kernel":
                value = value.transpose(_KERNEL_AXES["kernel", value.ndim])
                name = "weight"
            elif name == "scale" or (name == "embedding" and
                                     parent == "extra_embedding"):
                name = "weight"
            sd[".".join(path + [name])] = np.ascontiguousarray(value)

    walk(_tree(params), [])
    return sd


def lidar_flax_from_state_dict(state_dict: Mapping) -> dict:
    """The port's ``VQPointCloud`` or ``BidirectionalTransformer`` state dict
    (tensors or arrays) → the flax ``{"params": tree}`` of numpy arrays,
    inverting ``lidar_state_dict_from_flax`` bit for bit."""
    tree: dict = {}
    for name, value in state_dict.items():
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().numpy()
        value = np.asarray(value)
        *mods, leaf = name.split(".")
        path: list[str] = []
        i = 0
        while i < len(mods):
            if mods[i] in _LIDAR_LISTS and i + 1 < len(mods) and \
                    mods[i + 1].isdigit():
                path.append(f"{mods[i]}_{mods[i + 1]}")
                i += 2
            elif mods[i] == "net" and path and path[-1] == "ff":
                first = mods[i + 1] == "0"
                path.append("proj_in" if first else "proj_out")
                i += 3 if first else 2
            else:
                path.append(mods[i])
                i += 1
        parent = path[-1] if path else ""
        if leaf == "weight":
            if parent == "extra_embedding":
                leaf = "embedding"
            elif value.ndim == 1:
                leaf = "scale"
            else:
                value = value[:, :, ::-1, ::-1].transpose(2, 3, 0, 1) \
                    if parent == "upsample" \
                    else value.transpose(_FLAX_AXES[value.ndim])
                leaf = "kernel"
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(value)
    return {"params": tree}


def vae_point_cloud_state_dict_from_flax(params: Mapping) -> dict:
    """Flax ``VAEPointCloud`` params → the port's state dict (numpy)."""
    return lidar_state_dict_from_flax(params)


def vae_point_cloud_flax_from_state_dict(state_dict: Mapping) -> dict:
    """The port's ``VAEPointCloud`` state dict → the flax ``{"params":
    tree}``, inverting ``vae_point_cloud_state_dict_from_flax``."""
    return lidar_flax_from_state_dict(state_dict)


def bev_world_vae_state_dict_from_flax(params: Mapping) -> dict:
    """Flax ``BEVWorldVAE`` params → the port's state dict (numpy): the
    LiDAR encoder and decoder and the image branch by the LiDAR walk (the
    port's modules carry the flax names), an SD-VAE image branch
    (``img_vae``) by ``vae_state_dict_from_flax``."""
    tree = dict(_tree(params))
    img_vae = tree.pop("img_vae", None)
    sd = lidar_state_dict_from_flax(tree)
    if img_vae is not None:
        sd.update({f"img_vae.{k}": v
                   for k, v in vae_state_dict_from_flax(img_vae).items()})
    return sd


def to_torch(state_dict: Mapping[str, np.ndarray]) -> dict:
    """numpy state dict → tensors (copies, so the source may be read-only)."""
    return {k: torch.tensor(np.asarray(v)) for k, v in state_dict.items()}
