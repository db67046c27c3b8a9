"""Released reference checkpoints → the port's state dicts
(``opendwm_tpu/convert/torch_import.py``), with no flax tree in between.

OpenDWM ships ``.pth`` checkpoints of its CTSD / UniMLVG denoisers built on
diffusers' SD 2.1 / SD 3.5 skeletons, and the base models come as HF
directories of ``.safetensors`` / ``.bin`` files; the FID and FVD feature
nets are the ``pt_inception-2015-12-05`` and TATS ``i3d_pretrained_400.pt``
files. Each ``convert_*`` takes a flat ``{reference_name: array}`` dict
(:func:`load_torch_state_dict`; torch tensors or numpy arrays) and returns
the port model's state dict with the same array type, for
``load_state_dict(strict=True)``:

- the DiT, the UNet and the VAE carry the reference's names in the port
  (``convert.py``), so their maps select the keys the JAX converter reads
  and fill the zero biases it fills (``linear``/``conv`` without a bias);
  the DiT's ``rayencoder.proj`` is the port's ``rayencoder_proj``;
- CLIP and T5 map HF's names onto the port's, which mirror the flax trees;
- I3D and the FID Inception keep the TATS / ``pt_inception`` names.

Every key of the source must be read: a key the port model has no place
for raises (``ValueError``), as a missing one does (``KeyError``); only the
keys each map names as bookkeeping are passed over (BatchNorm's
``num_batches_tracked``, CLIP's ``position_ids``, T5's tied
``encoder.embed_tokens``, diffusers' ``pos_embed.pos_embed`` sincos buffer,
the Inception's 1008-way ``fc`` head, which pool3 features never reach).
No array is transposed: the port's layers keep torch's layouts.

``.safetensors`` files are read by :func:`read_safetensors` (the format:
an 8-byte little-endian header length, a JSON header, the raw buffers),
without the ``safetensors`` package; :func:`write_safetensors` writes one.
"""

from __future__ import annotations

import json
import re
import struct
from pathlib import Path
from typing import Iterable, Mapping

import numpy as np
import torch

# safetensors dtype names ↔ torch dtypes
_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """A ``.safetensors`` file → ``{name: CPU tensor}`` (the header's
    ``__metadata__`` is dropped). The tensors share one buffer read from
    the file; one whose offset does not suit its dtype's alignment is
    copied out."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        count = int(np.prod(shape, dtype=np.int64))
        size = torch.empty((), dtype=dtype).element_size()
        if end - begin != count * size or end > len(data):
            raise ValueError(f"{path}: {name} has offsets {begin}-{end} for "
                             f"{count} {info['dtype']} values")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        t = torch.frombuffer(data, dtype=dtype, count=count, offset=begin)
        if begin % size:
            t = t.clone()
        out[name] = t.reshape(shape)
    return out


def write_safetensors(path: str, tensors: Mapping[str, torch.Tensor]) -> None:
    """Write ``tensors`` (any device; copied to the host) as a
    ``.safetensors`` file, the wider dtypes first so that every buffer
    starts aligned to its element."""
    host = {k: v.detach().contiguous().cpu() for k, v in tensors.items()}
    names = sorted(host, key=lambda k: (-host[k].element_size(), k))
    header, offset = {}, 0
    for k in names:
        n = host[k].numel() * host[k].element_size()
        header[k] = {"dtype": _ST_NAMES[host[k].dtype],
                     "shape": list(host[k].shape),
                     "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-(len(raw) + 8) % 8)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for k in names:
            f.write(host[k].view(-1).view(torch.uint8).numpy().tobytes()
                    if host[k].numel() else b"")


def load_torch_state_dict(path: str, device=None) -> dict[str, torch.Tensor]:
    """A ``.pth`` / ``.pt`` / ``.bin`` (``torch.load``, weights only; a
    ``{"state_dict": ...}`` wrapper is unwrapped) or ``.safetensors`` file
    → ``{name: tensor}`` on ``device`` (the host by default). Dtypes stay
    as stored: bf16 stays bf16 (the JAX loader widens it to fp32 because
    numpy has no bf16; the values are the same)."""
    if str(path).endswith(".safetensors"):
        sd = read_safetensors(path)
        if device is not None:
            sd = {k: v.to(device) for k, v in sd.items()}
        return sd
    sd = torch.load(path, map_location=device or "cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return dict(sd)


# ---------------------------------------------------------------------------
# The source dict, with the keys read from it
# ---------------------------------------------------------------------------

class _Source:
    """A reference state dict whose reads are recorded, so that ``finish``
    can refuse the keys no map read."""

    def __init__(self, sd: Mapping):
        self.sd = sd
        self.used: set[str] = set()

    def __contains__(self, key: str) -> bool:
        return key in self.sd

    def __iter__(self):
        return iter(self.sd)

    def take(self, key: str):
        value = self.sd[key]  # KeyError names a missing key
        self.used.add(key)
        return value

    def get(self, key: str):
        return self.take(key) if key in self.sd else None

    def finish(self, out: dict, what: str, ignore: Iterable[str] = ()) -> dict:
        patterns = [re.compile(p) for p in ignore]
        extra = sorted(k for k in self.sd if k not in self.used
                       and not any(p.search(k) for p in patterns))
        if extra:
            raise ValueError(
                f"{what}: {len(extra)} source keys have no place in the port "
                f"model: {extra[:8]}{' ...' if len(extra) > 8 else ''}")
        return out


def _zeros(w, n: int):
    if isinstance(w, torch.Tensor):
        return torch.zeros(n, dtype=w.dtype, device=w.device)
    return np.zeros(n, np.asarray(w).dtype)


def linear(src: _Source, out: dict, name: str, dst: str | None = None,
           bias: bool = True) -> None:
    """``name.weight`` and ``name.bias`` (zeros when the source has none,
    as the JAX converter fills them); ``bias=False``: the port layer has
    none, so a source bias stays unread (and is refused)."""
    dst = dst or name
    w = src.take(f"{name}.weight")
    out[f"{dst}.weight"] = w
    if bias:
        b = src.get(f"{name}.bias")
        out[f"{dst}.bias"] = b if b is not None else _zeros(w, w.shape[0])


conv = linear  # a Conv2d maps as a Linear: weight, bias (zeros if none)


def norm(src: _Source, out: dict, name: str, bias: bool = True) -> None:
    """``name.weight`` and, unless ``bias=False`` (an RMSNorm), the bias
    when the source has one: a LayerNorm or GroupNorm, or a Conv3d, whose
    missing bias the JAX converter does not fill."""
    out[f"{name}.weight"] = src.take(f"{name}.weight")
    if bias and f"{name}.bias" in src:
        out[f"{name}.bias"] = src.take(f"{name}.bias")


def index_count(src, pattern: str) -> int:
    """1 + the largest index that ``pattern``'s group catches in the keys
    of ``src`` (a layer count); ``KeyError`` when no key matches."""
    found = [int(m.group(1)) for k in src if (m := re.match(pattern, k))]
    if not found:
        raise KeyError(f"no key matches {pattern!r}")
    return 1 + max(found)


# ---------------------------------------------------------------------------
# CLIP and T5 text encoders (HF transformers naming)
# ---------------------------------------------------------------------------

def clip_names(num_layers: int, projection: bool) -> list[tuple[str, str]]:
    """(HF name without ``text_model.``, port name) of every CLIP
    parameter."""
    pairs = [("embeddings.token_embedding.weight", "token_embedding.weight"),
             ("embeddings.position_embedding.weight", "position_embedding")]
    for i in range(num_layers):
        hf, port = f"encoder.layers.{i}", f"layers.{i}"
        for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
            pairs += [(f"{hf}.self_attn.{p}.{leaf}",
                       f"{port}.self_attn.{p}.{leaf}")
                      for leaf in ("weight", "bias")]
        for p in ("layer_norm1", "layer_norm2"):
            pairs += [(f"{hf}.{p}.{leaf}", f"{port}.{p}.{leaf}")
                      for leaf in ("weight", "bias")]
        for p in ("fc1", "fc2"):
            pairs += [(f"{hf}.mlp.{p}.{leaf}", f"{port}.{p}.{leaf}")
                      for leaf in ("weight", "bias")]
    pairs += [("final_layer_norm.weight", "final_layer_norm.weight"),
              ("final_layer_norm.bias", "final_layer_norm.bias")]
    if projection:
        pairs.append(("text_projection.weight", "text_projection.weight"))
    return pairs


def convert_clip_text(sd: Mapping) -> dict:
    """HF ``CLIPTextModel`` / ``CLIPTextModelWithProjection`` → the port's
    ``CLIPTextEncoder`` state dict (``torch_import.py:89``). A bias the
    source lacks is zeros, as the JAX converter fills it."""
    src = _Source({k.removeprefix("text_model."): v for k, v in sd.items()})
    n = index_count(src, r"encoder\.layers\.(\d+)\.")
    out = {}
    for hf, port in clip_names(n, "text_projection.weight" in src):
        if hf.endswith(".bias") and hf not in src:
            w = src.sd[hf.removesuffix(".bias") + ".weight"]
            out[port] = _zeros(w, w.shape[0])
        else:
            out[port] = src.take(hf)
    return src.finish(out, "clip", ignore=(r"^embeddings\.position_ids$",))


def t5_names(num_layers: int) -> list[tuple[str, str]]:
    """(HF name, port name) of every T5 encoder parameter."""
    pairs = [("shared.weight", "shared.weight")]
    for i in range(num_layers):
        hf, port = f"encoder.block.{i}.layer", f"block.{i}"
        for p in ("q", "k", "v", "o"):
            pairs.append((f"{hf}.0.SelfAttention.{p}.weight",
                          f"{port}.attention.{p}.weight"))
        if i == 0:
            pairs.append((f"{hf}.0.SelfAttention.relative_attention_bias."
                          "weight", f"{port}.attention.relative_attention_bias"))
        pairs.append((f"{hf}.0.layer_norm.weight", f"{port}.ln_attn.weight"))
        for p in ("wi_0", "wi_1", "wo"):
            pairs.append((f"{hf}.1.DenseReluDense.{p}.weight",
                          f"{port}.{p}.weight"))
        pairs.append((f"{hf}.1.layer_norm.weight", f"{port}.ln_ff.weight"))
    pairs.append(("encoder.final_layer_norm.weight", "final_layer_norm.weight"))
    return pairs


def convert_t5_encoder(sd: Mapping) -> dict:
    """HF ``T5EncoderModel`` → the port's ``T5TextEncoder`` state dict
    (``torch_import.py:120``). ``encoder.embed_tokens.weight``, HF's tie of
    ``shared.weight``, is read only to check that it is that tie."""
    src = _Source(sd)
    out = {port: src.take(hf) for hf, port in
           t5_names(index_count(src, r"encoder\.block\.(\d+)\."))}
    tied = src.get("encoder.embed_tokens.weight")
    if tied is not None and not (tied is out["shared.weight"]
                                 or bool((tied == out["shared.weight"]).all())):
        raise ValueError("t5: encoder.embed_tokens.weight differs from "
                         "shared.weight; the port's T5 ties them")
    return src.finish(out, "t5")


# ---------------------------------------------------------------------------
# AutoencoderKL (diffusers naming)
# ---------------------------------------------------------------------------

def _resnet(src, out, name):
    for p in ("norm1", "norm2"):
        norm(src, out, f"{name}.{p}")
    for p in ("conv1", "conv2"):
        conv(src, out, f"{name}.{p}")
    if f"{name}.conv_shortcut.weight" in src:
        conv(src, out, f"{name}.conv_shortcut")


def convert_autoencoder_kl(sd: Mapping) -> dict:
    """diffusers ``AutoencoderKL`` → the port's (``torch_import.py:155``)."""
    src, out = _Source(sd), {}

    def vae_attn(name):
        norm(src, out, f"{name}.group_norm")
        for p in ("to_q", "to_k", "to_v", "to_out.0"):
            linear(src, out, f"{name}.{p}")

    for part, blocks, sampler in (("encoder", "down_blocks", "downsamplers"),
                                  ("decoder", "up_blocks", "upsamplers")):
        conv(src, out, f"{part}.conv_in")
        for i in range(index_count(src, rf"{part}\.{blocks}\.(\d+)\.")):
            j = 0
            while f"{part}.{blocks}.{i}.resnets.{j}.norm1.weight" in src:
                _resnet(src, out, f"{part}.{blocks}.{i}.resnets.{j}")
                j += 1
            key = f"{part}.{blocks}.{i}.{sampler}.0.conv"
            if f"{key}.weight" in src:
                conv(src, out, key)
        for j in (0, 1):
            _resnet(src, out, f"{part}.mid_block.resnets.{j}")
        vae_attn(f"{part}.mid_block.attentions.0")
        norm(src, out, f"{part}.conv_norm_out")
        conv(src, out, f"{part}.conv_out")
    if "quant_conv.weight" in src:
        conv(src, out, "quant_conv")
        conv(src, out, "post_quant_conv")
    return src.finish(out, "vae")


# ---------------------------------------------------------------------------
# Crossview-temporal MMDiT (diffusers SD3 + OpenDWM additions)
# ---------------------------------------------------------------------------

def _vt_block(src, out, name):
    norm(src, out, f"{name}.norm_in")
    linear(src, out, f"{name}.ff_in.net.0.proj")
    linear(src, out, f"{name}.ff_in.net.2")
    norm(src, out, f"{name}.norm1")
    for p in ("to_q", "to_k", "to_v", "to_out.0"):
        linear(src, out, f"{name}.attn1.{p}")
    if f"{name}.attn1.norm_q.weight" in src:
        norm(src, out, f"{name}.attn1.norm_q", bias=False)
        norm(src, out, f"{name}.attn1.norm_k", bias=False)
    norm(src, out, f"{name}.norm3")
    linear(src, out, f"{name}.ff.net.0.proj")
    linear(src, out, f"{name}.ff.net.2")


def _mmdit_attn(src, out, name, has_context, context_pre_only):
    for p in ("to_q", "to_k", "to_v", "to_out.0"):
        linear(src, out, f"{name}.{p}")
    if f"{name}.norm_q.weight" in src:
        norm(src, out, f"{name}.norm_q", bias=False)
        norm(src, out, f"{name}.norm_k", bias=False)
    if has_context:
        for p in ("add_q_proj", "add_k_proj", "add_v_proj"):
            linear(src, out, f"{name}.{p}")
        if f"{name}.norm_added_q.weight" in src:
            norm(src, out, f"{name}.norm_added_q", bias=False)
            norm(src, out, f"{name}.norm_added_k", bias=False)
        if not context_pre_only:
            linear(src, out, f"{name}.to_add_out")


def _adapter(src, out, prefix: str, zero_convs: bool) -> None:
    i = 0
    while f"{prefix}.body.{i}.resnets.0.block1.weight" in src:
        body = f"{prefix}.body.{i}"
        if f"{body}.in_conv.weight" in src:
            conv(src, out, f"{body}.in_conv")
        j = 0
        while f"{body}.resnets.{j}.block1.weight" in src:
            conv(src, out, f"{body}.resnets.{j}.block1")
            conv(src, out, f"{body}.resnets.{j}.block2")
            j += 1
        if zero_convs and f"{prefix}.zero_convs.{i}.weight" in src:
            conv(src, out, f"{prefix}.zero_convs.{i}")
        i += 1
    if zero_convs and f"{prefix}.zero_gates" in src:
        out[f"{prefix}.zero_gates"] = src.take(f"{prefix}.zero_gates")


def convert_ctsd_dit(sd: Mapping, num_layers: int) -> dict:
    """The reference ``DiTCrossviewTemporalConditionModel`` state dict →
    the port's (``torch_import.py:260``), ``num_layers`` joint blocks."""
    src, out = _Source(sd), {}
    conv(src, out, "pos_embed.proj")
    linear(src, out, "context_embedder")
    for name in ("timestep_embedder", "text_embedder"):
        for lin in ("linear_1", "linear_2"):
            linear(src, out, f"time_text_embed.{name}.{lin}")
    if "view_embedding.linear_1.weight" in src:
        linear(src, out, "view_embedding.linear_1")
        linear(src, out, "view_embedding.linear_2")
    if "rayencoder.proj.weight" in src:
        linear(src, out, "rayencoder.proj", "rayencoder_proj", bias=False)

    for i in range(num_layers):
        name = f"transformer_blocks.{i}"
        last = i == num_layers - 1
        linear(src, out, f"{name}.norm1.linear")
        linear(src, out, f"{name}.norm1_context.linear")
        _mmdit_attn(src, out, f"{name}.attn", True, last)
        if f"{name}.attn2.to_q.weight" in src:
            _mmdit_attn(src, out, f"{name}.attn2", False, False)
        linear(src, out, f"{name}.ff.net.0.proj")
        linear(src, out, f"{name}.ff.net.2")
        if not last:
            linear(src, out, f"{name}.ff_context.net.0.proj")
            linear(src, out, f"{name}.ff_context.net.2")

    for kind in ("crossview_transformer_blocks", "temporal_transformer_blocks"):
        j = 0
        while f"{kind}.{j}.norm_in.weight" in src:
            _vt_block(src, out, f"{kind}.{j}")
            j += 1
    for kind in ("view_pos_embeds", "time_pos_embeds"):
        j = 0
        while f"{kind}.{j}.linear_1.weight" in src:
            linear(src, out, f"{kind}.{j}.linear_1")
            linear(src, out, f"{kind}.{j}.linear_2")
            j += 1
    for kind in ("view_mixers", "time_mixers"):
        j = 0
        while f"{kind}.{j}.mix_factor" in src:
            out[f"{kind}.{j}.mix_factor"] = src.take(f"{kind}.{j}.mix_factor")
            j += 1
    if "condition_image_adapter.body.0.in_conv.weight" in src:
        _adapter(src, out, "condition_image_adapter", zero_convs=True)
    linear(src, out, "norm_out.linear")
    linear(src, out, "proj_out")
    return src.finish(out, "ctsd_dit", ignore=(r"^pos_embed\.pos_embed$",))


def dit_layer_count(sd: Mapping) -> int:
    """The joint blocks of a reference DiT state dict (``run_all.py:626``)."""
    return index_count(sd, r"transformer_blocks\.(\d+)\.")


# ---------------------------------------------------------------------------
# I3D (TATS pytorch_i3d) and the FID InceptionV3
# ---------------------------------------------------------------------------

_BN = ("weight", "bias", "running_mean", "running_var")
_BN_COUNTER = (r"\.bn\.num_batches_tracked$",)


def convert_i3d(sd: Mapping) -> dict:
    """TATS ``i3d_pretrained_400.pt`` → the port's ``InceptionI3d``
    (``torch_import.py:373``): every ``*.conv3d`` (weight, bias when
    present) and its ``*.bn``."""
    src, out = _Source(sd), {}
    units = sorted(k[: -len(".conv3d.weight")] for k in src
                   if k.endswith("conv3d.weight"))
    for unit in units:
        norm(src, out, f"{unit}.conv3d")  # the bias as found
        if f"{unit}.bn.weight" in src:
            for leaf in _BN:
                out[f"{unit}.bn.{leaf}"] = src.take(f"{unit}.bn.{leaf}")
    return src.finish(out, "i3d", ignore=_BN_COUNTER)


def convert_fid_inception(sd: Mapping) -> dict:
    """``pt_inception-2015-12-05`` → the port's ``FIDInceptionV3``
    (``torch_import.py:389``): every ``*.conv`` (no bias) and its
    ``*.bn``."""
    src, out = _Source(sd), {}
    units = sorted(k[: -len(".conv.weight")] for k in src
                   if k.endswith(".conv.weight"))
    for unit in units:
        out[f"{unit}.conv.weight"] = src.take(f"{unit}.conv.weight")
        for leaf in _BN:
            out[f"{unit}.bn.{leaf}"] = src.take(f"{unit}.bn.{leaf}")
    return src.finish(out, "fid_inception",
                      ignore=_BN_COUNTER + (r"^fc\.",))


# ---------------------------------------------------------------------------
# Crossview-temporal UNet (diffusers SVD skeleton + OpenDWM additions)
# ---------------------------------------------------------------------------

def _ct_resblock(src, out, name):
    _unet_resnet(src, out, f"{name}.spatial_res_block", conv)
    base = f"{name}.temporal_res_block"
    if f"{base}.norm1.weight" in src:
        _unet_resnet(src, out, base, norm)  # Conv3d: the bias as found
        out[f"{name}.time_mixer.mix_factor"] = \
            src.take(f"{name}.time_mixer.mix_factor")


def _unet_resnet(src, out, base, conv_fn):
    norm(src, out, f"{base}.norm1")
    norm(src, out, f"{base}.norm2")
    conv_fn(src, out, f"{base}.conv1")
    conv_fn(src, out, f"{base}.conv2")
    if f"{base}.time_emb_proj.weight" in src:
        linear(src, out, f"{base}.time_emb_proj")
    if f"{base}.conv_shortcut.weight" in src:
        conv(src, out, f"{base}.conv_shortcut")


def _unet_attention(src, out, name):
    """The reference UNet's attention: q/k/v without bias."""
    for p in ("to_q", "to_k", "to_v"):
        linear(src, out, f"{name}.{p}", bias=False)
    linear(src, out, f"{name}.to_out.0")


def _basic_block(src, out, name, temporal: bool):
    if temporal:
        norm(src, out, f"{name}.norm_in")
        linear(src, out, f"{name}.ff_in.net.0.proj")
        linear(src, out, f"{name}.ff_in.net.2")
    norm(src, out, f"{name}.norm1")
    _unet_attention(src, out, f"{name}.attn1")
    if f"{name}.attn2.to_q.weight" in src:
        norm(src, out, f"{name}.norm2")
        _unet_attention(src, out, f"{name}.attn2")
    norm(src, out, f"{name}.norm3")
    linear(src, out, f"{name}.ff.net.0.proj")
    linear(src, out, f"{name}.ff.net.2")


def _transformer_model(src, out, name):
    norm(src, out, f"{name}.norm")
    linear(src, out, f"{name}.proj_in")
    linear(src, out, f"{name}.proj_out")
    k = 0
    while f"{name}.transformer_blocks.{k}.norm1.weight" in src:
        _basic_block(src, out, f"{name}.transformer_blocks.{k}", False)
        k += 1
    for kind, embed in (("crossview_transformer_blocks", "view_pos_embed"),
                        ("temporal_transformer_blocks", "time_pos_embed")):
        k = 0
        while f"{name}.{kind}.{k}.norm_in.weight" in src:
            _basic_block(src, out, f"{name}.{kind}.{k}", True)
            k += 1
        if f"{name}.{embed}.linear_1.weight" in src:
            linear(src, out, f"{name}.{embed}.linear_1")
            linear(src, out, f"{name}.{embed}.linear_2")
    for mixer in ("view_mixer", "time_mixer"):
        if f"{name}.{mixer}.mix_factor" in src:
            out[f"{name}.{mixer}.mix_factor"] = \
                src.take(f"{name}.{mixer}.mix_factor")


def convert_ctsd_unet(sd: Mapping) -> dict:
    """The reference ``UNetCrossviewTemporalConditionModel`` state dict →
    the port's (``torch_import.py:503``; apply
    ``convert_cli.sd21_to_svd_keys`` first to an SD2.1-era dict). The
    reference's q/k/v projections have no bias, and the port's neither."""
    src, out = _Source(sd), {}
    conv(src, out, "conv_in")
    linear(src, out, "time_embedding.linear_1")
    linear(src, out, "time_embedding.linear_2")
    if "add_embedding.linear_1.weight" in src:
        linear(src, out, "add_embedding.linear_1")
        linear(src, out, "add_embedding.linear_2")
    for group in ("down_blocks", "up_blocks"):
        i = 0
        while any(k.startswith(f"{group}.{i}.") for k in src):
            name = f"{group}.{i}"
            j = 0
            while f"{name}.resnets.{j}.spatial_res_block.norm1.weight" in src:
                _ct_resblock(src, out, f"{name}.resnets.{j}")
                j += 1
            j = 0
            while f"{name}.attentions.{j}.proj_in.weight" in src:
                _transformer_model(src, out, f"{name}.attentions.{j}")
                j += 1
            for sampler in ("downsamplers", "upsamplers"):
                if f"{name}.{sampler}.0.conv.weight" in src:
                    conv(src, out, f"{name}.{sampler}.0.conv")
            i += 1
    for j in (0, 1):
        _ct_resblock(src, out, f"mid_block.resnets.{j}")
    if "mid_block.attentions.0.proj_in.weight" in src:
        _transformer_model(src, out, "mid_block.attentions.0")
    norm(src, out, "conv_norm_out")
    conv(src, out, "conv_out")
    if "condition_image_adapter.body.0.resnets.0.block1.weight" in src:
        _adapter(src, out, "condition_image_adapter", zero_convs=False)
    return src.finish(out, "ctsd_unet")
