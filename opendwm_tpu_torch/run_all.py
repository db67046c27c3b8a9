"""One-command weight landing (``opendwm_tpu/convert/run_all.py``):
released checkpoints → the port's weights, converted and checked.

Scans a directory of released OpenDWM checkpoints (the ``.pth`` files of
the reference README's model table) and HF base-model directories, runs
each file's converter (``torch_import``), writes the port model's weights
(``checkpoint.save_model_only``), loads them into the port model with
``strict=True``, runs a golden forward on fixed inputs (shape, finiteness
and moments of the output) and writes a JSON report:

    python -m opendwm_tpu_torch.run_all --weights-dir /weights \\
        --output converted/ [--report WEIGHTS_PARITY.json] [--device cuda|cpu]

    # without weights: tiny sources in the reference naming, written from
    # the port's own models, through the same path, then the metrics drill
    python -m opendwm_tpu_torch.run_all --dry-run --output landed/ \\
        --device cpu

An entry is ``verified`` when its forward is finite, ``nonfinite`` when it
is not, ``failed`` when any step raised (the report keeps the error and the
run goes on to the next entry). ``--device`` defaults to ``cuda`` and
raises without a card.

Reference names: ``ctsd_35_tirda_*.pth`` and ``ctsd_unimlvg_*.pth`` (the
DiT), ``ctsd_21_*.pth`` (the UNet, the SD2.1 → SVD key remap applied); HF
base directories hold ``vae/``, ``text_encoder/`` and ``text_encoder_2/``
(CLIP), ``text_encoder_3/`` (T5); ``i3d*`` / ``pt_inception*`` files are
the metric nets.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from opendwm_tpu_torch import checkpoint as ckpt_lib
from opendwm_tpu_torch import torch_import as ti
from opendwm_tpu_torch.config import instantiate_config
from opendwm_tpu_torch.convert_cli import CONVERTERS

REPO = Path(__file__).resolve().parents[1]

# (regex on the basename, kind, the repo config whose model the check
# builds, or None)
MANIFEST = [
    (r"ctsd_unimlvg.*\.pth$", "ctsd_dit",
     "configs/unimlvg/ctsd_unimlvg_stage3_tirda_bm_nwa.json"),
    (r"ctsd_35.*\.pth$", "ctsd_dit", "configs/ctsd/ctsd_35_tirda_bm_nwao.json"),
    (r"ctsd_21.*\.pth$", "ctsd_unet",
     "configs/ctsd/multi_datasets/ctsd_21_tirda_bm_nwa.json"),
    (r"(i3d|rgb_imagenet).*\.(pt|pth)$", "i3d", None),
    (r"(pt_inception|fid).*\.pth$", "fid_inception", None),
]
# HF base-model subdirectories (the SD3.5 medium layout).
HF_SUBDIRS = [("vae", "vae"), ("text_encoder", "clip"),
              ("text_encoder_2", "clip"), ("text_encoder_3", "t5")]
WEIGHT_SUFFIXES = (".pth", ".pt", ".bin", ".safetensors")


def load_model_kwargs(config_rel: str) -> dict:
    """The model section of a config (a path in the repo, or absolute) as
    constructor arguments: class nodes resolved (``dtype``), ``_class_name``
    and the gradient-checkpointing switches dropped."""
    cfg = json.loads((REPO / config_rel).read_text())
    kwargs = {k: v for k, v in cfg["pipeline"]["model"].items()
              if "gradient_checkpointing" not in k and not k.startswith("_")}
    return instantiate_config(kwargs)


def stats(out: torch.Tensor) -> dict:
    a = out.detach().float().cpu().numpy()
    return {"shape": list(a.shape), "finite": bool(np.isfinite(a).all()),
            "mean": float(a.mean()), "std": float(a.std()),
            "max_abs": float(np.abs(a).max())}


def convert(kind: str, sd: dict, num_layers: int | None = None) -> dict:
    """The port state dict of reference dict ``sd``: a DiT's layer count
    from its keys, a UNet remapped from SD2.1 keys when it has them."""
    if kind == "ctsd_dit":
        return ti.convert_ctsd_dit(sd, num_layers or ti.dit_layer_count(sd))
    return CONVERTERS[kind](sd, argparse.Namespace(num_layers=num_layers))


# ---------------------------------------------------------------------------
# Golden forwards: the model a state dict loads into, fixed inputs (numpy
# draws of the JAX checks, so both packages feed the same values)
# ---------------------------------------------------------------------------

def _rng():
    return np.random.default_rng(0)


def _t(x, device, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x)).to(device=device, dtype=dtype)


def _dit(state, sd, kw, device):
    from opendwm_tpu_torch.models.mmdit import DiTCrossviewTemporal

    rng, (b, t, v, h, w) = _rng(), (1, 2, 2, 8, 8)
    n_ids = kw.get("projection_class_embeddings_input_dim", 2816) // 256
    inputs = dict(
        sample=rng.standard_normal((b, t, v, h, w, kw["in_channels"]),
                                   np.float32),
        timestep=rng.uniform(0, 1000, (b, t, v)).astype(np.float32),
        encoder_hidden_states=rng.standard_normal(
            (b, t, v, 4, kw["joint_attention_dim"]), np.float32),
        pooled_projections=rng.standard_normal(
            (b, t, v, kw["pooled_projection_dim"]), np.float32),
        added_time_ids=rng.standard_normal((b, t, v, n_ids), np.float32))
    return (lambda: DiTCrossviewTemporal(**kw),
            {k: _t(x, device) for k, x in inputs.items()})


def _unet(state, sd, kw, device):
    from opendwm_tpu_torch.models.unet import UNetCrossviewTemporal

    ctx = int(next(v for k, v in state.items()
                   if "attn2.to_k.weight" in k).shape[1])
    n_ids = kw.get("projection_class_embeddings_input_dim", 768) \
        // kw.get("addition_time_embed_dim", 256)
    rng, (b, t, v, h, w) = _rng(), (1, 2, 2, 8, 8)
    inputs = dict(
        sample=rng.standard_normal((b, t, v, h, w, kw["in_channels"]),
                                   np.float32) * 0.5,
        timestep=rng.uniform(0, 1000, (b, t, v)).astype(np.float32),
        encoder_hidden_states=rng.standard_normal((b, t, v, 3, ctx),
                                                  np.float32),
        added_time_ids=rng.standard_normal((b, t, v, n_ids), np.float32))
    return (lambda: UNetCrossviewTemporal(**dict(kw, cross_attention_dim=ctx)),
            {k: _t(x, device) for k, x in inputs.items()})


def _vae(state, sd, kw, device):
    from opendwm_tpu_torch.models.autoencoders import AutoencoderKL

    chans, i = [], 0
    while f"encoder.down_blocks.{i}.resnets.0.conv1.weight" in state:
        chans.append(int(state[f"encoder.down_blocks.{i}.resnets.0.conv1."
                               "weight"].shape[0]))
        i += 1
    x = _rng().standard_normal((1, 32, 32, 3), np.float32) * 0.5
    return (lambda: AutoencoderKL(
        block_out_channels=tuple(chans),
        latent_channels=int(state["decoder.conv_in.weight"].shape[1]),
        use_quant_conv="quant_conv.weight" in state), {"x": _t(x, device)})


def _clip(state, sd, kw, device):
    from opendwm_tpu_torch.models.text_encoders import CLIPTextEncoder

    emb = state["token_embedding.weight"]
    vocab, width = int(emb.shape[0]), int(emb.shape[1])
    proj = state.get("text_projection.weight")
    ids = np.array([[5, 320, 125, vocab - 1, 0, 0, 0, 0]]) % vocab
    return (lambda: CLIPTextEncoder(
        vocab_size=vocab, hidden_size=width,
        num_layers=ti.index_count(state, r"layers\.(\d+)\."),
        num_heads=max(1, width // 64),
        intermediate_size=int(state["layers.0.fc1.weight"].shape[0]),
        eos_token_id=vocab - 1,
        projection_dim=None if proj is None else int(proj.shape[0]),
        max_position_embeddings=int(state["position_embedding"].shape[0])),
        {"input_ids": _t(ids, device, torch.long)})


def _t5(state, sd, kw, device):
    from opendwm_tpu_torch.models.text_encoders import T5TextEncoder

    emb = state["shared.weight"]
    bias = state["block.0.attention.relative_attention_bias"]
    heads = int(bias.shape[1])
    return (lambda: T5TextEncoder(
        vocab_size=int(emb.shape[0]), d_model=int(emb.shape[1]),
        d_ff=int(state["block.0.wi_0.weight"].shape[0]),
        num_layers=ti.index_count(state, r"block\.(\d+)\."), num_heads=heads,
        d_kv=int(state["block.0.attention.k.weight"].shape[0]) // heads),
        {"input_ids": _t([[71, 307, 4]], device, torch.long)})


def _i3d(state, sd, kw, device):
    from opendwm_tpu_torch.models.i3d import InceptionI3d

    return InceptionI3d, {"video": torch.zeros((1, 16, 64, 64, 3),
                                               device=device)}


def _fid_inception(state, sd, kw, device):
    from opendwm_tpu_torch.models.inception import FIDInceptionV3

    return FIDInceptionV3, {"images": torch.zeros((1, 299, 299, 3),
                                                  device=device)}


# kind → (state, sd, model kwargs, device) → (model factory, inputs)
CHECKS = {"ctsd_dit": _dit, "ctsd_unet": _unet, "vae": _vae, "clip": _clip,
          "t5": _t5, "i3d": _i3d, "fid_inception": _fid_inception}


def build_checked(kind: str, state: dict, sd: dict, model_kwargs,
                  device) -> tuple:
    """(the port model of ``kind`` on ``device`` with ``state`` loaded
    strictly, in eval mode; its golden inputs on ``device``)."""
    factory, inputs = CHECKS[kind](state, sd, model_kwargs or {}, device)
    with torch.device("meta"):
        model = factory()
    model.to_empty(device=device)
    model.load_state_dict(state, strict=True)
    return model.eval(), inputs


@torch.inference_mode()
def golden_forward(kind: str, model, inputs: dict) -> torch.Tensor:
    if kind == "vae":
        mean, _ = model.encode(inputs["x"])
        return model.decode(mean)
    out = model(**inputs)
    return out[0] if isinstance(out, tuple) else out


def import_entry(rel: str, kind: str, source, model_kwargs=None,
                 device="cpu", output: str | None = None, check: bool = True,
                 num_layers: int | None = None) -> tuple:
    """Land one checkpoint: ``source`` a file, an HF directory or an
    in-memory reference dict. Returns ``(entry, state, checked)``: the
    report entry (``status``: converted / verified / nonfinite / failed;
    a file's load seconds and bytes), the port state dict (None on
    failure) and, when checked, ``(model, inputs, output)``."""
    t0 = time.perf_counter()
    entry = {"file": rel, "kind": kind, "status": "converted"}
    state = checked = None
    try:
        sd = source
        if isinstance(source, (str, Path)):
            t1 = time.perf_counter()
            sd = load_source(source)
            entry["load_s"] = time.perf_counter() - t1
            entry["load_bytes"] = int(sum(v.numel() * v.element_size()
                                          for v in sd.values()))
        state = convert(kind, sd, num_layers)
        entry["n_params"] = int(sum(v.numel() for v in state.values()))
        if output is not None:
            out_path = os.path.join(
                output, rel.replace(os.sep, "_").rsplit(".", 1)[0] + ".pt")
            ckpt_lib.save_model_only(out_path, state)
            entry["out_path"] = out_path
        if check:
            model, inputs = build_checked(kind, state, sd, model_kwargs,
                                          device)
            out = golden_forward(kind, model, inputs)
            entry["check"] = stats(out)
            entry["status"] = "verified" if entry["check"]["finite"] \
                else "nonfinite"
            checked = (model, inputs, out)
    except Exception as exc:  # noqa: BLE001 - report, go on with the rest
        entry["status"] = "failed"
        entry["error"] = f"{type(exc).__name__}: {exc}"
    entry["seconds"] = round(time.perf_counter() - t0, 2)
    return entry, state, checked


def load_source(path) -> dict:
    """A weight file, or every weight file of an HF model directory in one
    dict."""
    path = Path(path)
    if not path.is_dir():
        return ti.load_torch_state_dict(str(path))
    sd = {}
    for f in sorted(path.iterdir()):
        if f.name.endswith(WEIGHT_SUFFIXES):
            sd.update(ti.load_torch_state_dict(str(f)))
    return sd


def discover(weights_dir: str) -> list:
    """[(path relative to ``weights_dir``, kind, config or None)]."""
    found = []
    for root, dirs, files in os.walk(weights_dir):
        rel_root = os.path.relpath(root, weights_dir)
        base = os.path.basename(root)
        for sub, kind in HF_SUBDIRS:
            if base == sub and any(f.startswith((
                    "diffusion_pytorch_model", "model", "pytorch_model"))
                    for f in files):
                found.append((rel_root, kind, None))
                dirs.clear()
                break
        else:
            for f in files:
                for pattern, kind, config in MANIFEST:
                    if re.search(pattern, f):
                        found.append((os.path.normpath(
                            os.path.join(rel_root, f)), kind, config))
                        break
    return sorted(found)


# ---------------------------------------------------------------------------
# Dry run: tiny sources in the reference naming, from the port's models
# ---------------------------------------------------------------------------

DRY_DIT = dict(
    patch_size=2, num_layers=2, attention_head_dim=8, num_attention_heads=2,
    in_channels=16, out_channels=16, joint_attention_dim=24,
    caption_projection_dim=16, pooled_projection_dim=16,
    pos_embed_max_size=16, sample_size=8, qk_norm="rms_norm",
    dual_attention_layers=(0,), enable_crossview=True,
    crossview_attention_type="rowwise", crossview_block_layers=(0,),
    enable_temporal=True, temporal_attention_type="pointwise",
    temporal_block_layers=(1,), qk_norm_on_additional_modules="rms_norm",
    perspective_modeling_type="implicit",
    projection_class_embeddings_input_dim=11 * 256)
DRY_UNET = dict(in_channels=8, out_channels=4, block_out_channels=(32, 64),
                layers_per_block=1, num_attention_heads=(2, 4),
                addition_time_embed_dim=8,
                projection_class_embeddings_input_dim=24)
DRY_CLIP = dict(vocab_size=1000, hidden_size=64, intermediate_size=128,
                num_layers=2, num_heads=1, max_position_embeddings=77)
DRY_T5 = dict(vocab_size=1000, d_model=64, d_kv=16, d_ff=128, num_layers=2,
              num_heads=4)


def hf_clip_state_dict(port_sd: dict) -> dict:
    """The port's CLIP state dict in HF ``CLIPTextModel`` names."""
    n = ti.index_count(port_sd, r"layers\.(\d+)\.")
    return {(hf if hf.startswith("text_projection") else f"text_model.{hf}"):
            port_sd[port]
            for hf, port in ti.clip_names(n, "text_projection.weight"
                                          in port_sd)}


def hf_t5_state_dict(port_sd: dict) -> dict:
    """The port's T5 state dict in HF ``T5EncoderModel`` names."""
    n = ti.index_count(port_sd, r"block\.(\d+)\.")
    return {hf: port_sd[port] for hf, port in ti.t5_names(n)}


def dryrun_sources(weights_dir: str) -> dict:
    """Write tiny reference-named sources from the port's own models;
    returns {relative path: (kind, model kwargs or None)}."""
    from opendwm_tpu_torch.models.autoencoders import AutoencoderKL
    from opendwm_tpu_torch.models.mmdit import DiTCrossviewTemporal
    from opendwm_tpu_torch.models.text_encoders import (
        CLIPTextEncoder,
        T5TextEncoder,
    )
    from opendwm_tpu_torch.models.unet import UNetCrossviewTemporal

    root = Path(weights_dir)

    def save(rel, sd):
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        torch.save(sd, root / rel)

    torch.manual_seed(0)
    save("ctsd_35_tirda_bm_nwao_40k.pth",
         DiTCrossviewTemporal(**DRY_DIT).state_dict())
    torch.manual_seed(0)
    save("ctsd_21_tirda_bm_nwa_30k.pth",
         UNetCrossviewTemporal(**DRY_UNET, cross_attention_dim=32)
         .state_dict())
    torch.manual_seed(0)
    save("base_model/vae/diffusion_pytorch_model.pth",
         AutoencoderKL(block_out_channels=(32, 64)).state_dict())
    torch.manual_seed(0)
    save("base_model/text_encoder/model.pth",
         hf_clip_state_dict(CLIPTextEncoder(**DRY_CLIP).state_dict()))
    torch.manual_seed(0)
    save("base_model/text_encoder_3/model.pth",
         hf_t5_state_dict(T5TextEncoder(**DRY_T5).state_dict()))
    return {"ctsd_35_tirda_bm_nwao_40k.pth": ("ctsd_dit", DRY_DIT),
            "ctsd_21_tirda_bm_nwa_30k.pth": ("ctsd_unet", DRY_UNET),
            os.path.join("base_model", "vae"): ("vae", None),
            os.path.join("base_model", "text_encoder"): ("clip", None),
            os.path.join("base_model", "text_encoder_3"): ("t5", None)}


# ---------------------------------------------------------------------------
# The metrics drill
# ---------------------------------------------------------------------------

DRILL_SHRINKAGE = 1e-3
# host seeds of the I3D and Inception weights and of the drill's draws
DRILL_SEEDS = (9, 10, 11)
# the Inception's input side (the FID net's 299 and the JAX drill's)
DRILL_FID_SIZE = 299


def to_video(media: torch.Tensor, frames: int, size: int) -> torch.Tensor:
    """(b, t, v, h, w, c) → view 0's clip of each sample as (b, frames,
    size, size, 3) in [0, 1] (the first 3 channels, ``x / 2 + 1/2``,
    trilinear)."""
    vid = (media[:, :, 0, ..., :3].float() * 0.5 + 0.5).clamp(0.0, 1.0)
    vid = F.interpolate(vid.permute(0, 4, 1, 2, 3), (frames, size, size),
                        mode="trilinear", align_corners=False)
    return vid.permute(0, 2, 3, 4, 1)


def to_images(media: torch.Tensor, size: int) -> torch.Tensor:
    """(..., h, w, c) → every image as (n, size, size, 3) in [0, 1]."""
    imgs = (media[..., :3].float() * 0.5 + 0.5).clamp(0.0, 1.0)
    imgs = imgs.reshape(-1, *imgs.shape[-3:]).permute(0, 3, 1, 2)
    imgs = F.interpolate(imgs, (size, size), mode="bilinear",
                         align_corners=False)
    return imgs.permute(0, 2, 3, 1)


@torch.no_grad()
def lecun_normal_(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Draw a feature net as flax initialises one: every conv / linear
    weight from N(0, 1 / fan_in), biases 0, BatchNorm at identity; drawn
    on the host from ``seed``, so a card and the CPU hold the same net."""
    gen = torch.Generator().manual_seed(seed)
    for name, t in list(module.named_parameters()) + \
            list(module.named_buffers()):
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "weight" and t.ndim > 1:
            t.copy_(torch.randn(t.shape, generator=gen) * t[0].numel() ** -0.5)
        elif leaf in ("weight", "running_var"):
            t.fill_(1.0)
        else:  # biases, running means
            t.zero_()
    return module


@torch.inference_mode()
def metrics_drill(report: dict, overrides: dict, device) -> dict:
    """One landed DiT through the quality path (``run_all.py:357``): its
    weights from the written file → ``CTSDPipeline`` → generated latents →
    FVD (``InceptionI3d``) and FID (``FIDInceptionV3``) through
    ``FrechetPairedMetric`` with covariance shrinkage. The feature nets
    have random weights, so the numbers say nothing of quality; the gates
    say the path discriminates: distinct inputs give distances above 0,
    the nets' features differ between them, and a gross shift (uniform
    noise against decoded latents) gives more than 3x both the generated
    distance and the same-distribution floor."""
    from opendwm_tpu_torch.metrics.frechet import FrechetPairedMetric
    from opendwm_tpu_torch.models.i3d import InceptionI3d
    from opendwm_tpu_torch.models.inception import FIDInceptionV3
    from opendwm_tpu_torch.models.mmdit import DiTCrossviewTemporal
    from opendwm_tpu_torch.pipelines.ctsd import CTSDPipeline
    from opendwm_tpu_torch.schedulers import FlowMatchEulerScheduler

    entry = next((e for e in report["entries"] if e["kind"] == "ctsd_dit"
                  and e["status"] == "verified"), None)
    if entry is None:
        return {"status": "skipped", "reason": "no verified ctsd_dit"}
    _, kwargs = overrides[entry["file"]]
    model = DiTCrossviewTemporal(**kwargs)
    ckpt_lib.load_model_only(entry["out_path"], model)
    pipe = CTSDPipeline(
        model=model.to(device).eval(),
        train_scheduler=FlowMatchEulerScheduler(shift=3.0),
        test_scheduler=FlowMatchEulerScheduler(shift=3.0),
        inference_config={"inference_steps": 2, "guidance_scale": 2.0})

    b, t, v, h, w, c = 2, 2, 2, 8, 8, 16
    i3d = lecun_normal_(InceptionI3d().to(device).eval(), DRILL_SEEDS[0])
    fid_net = lecun_normal_(FIDInceptionV3().to(device).eval(),
                            DRILL_SEEDS[1])

    nets = {"fvd": (400, lambda x: i3d(to_video(x, 8, 32))),
            "fid": (2048, lambda x: fid_net(to_images(x, DRILL_FID_SIZE)))}

    def metrics():
        # each batch's features are computed once and fed to every metric
        # and gap that reads them
        return {k: FrechetPairedMetric(dim, feature_fn=lambda f: f,
                                       shrinkage=DRILL_SHRINKAGE)
                for k, (dim, _) in nets.items()}

    def features(x):
        return {k: fn(x) for k, (_, fn) in nets.items()}

    gen = torch.Generator().manual_seed(DRILL_SEEDS[2])  # on the host

    def normal(*shape):
        return torch.randn(shape, generator=gen).to(device)

    subtle = metrics()
    gaps = {"i3d": [], "inception": []}
    n_batches = 8
    for _ in range(n_batches):
        batch = {"latents": normal(b, t, v, h, w, c),
                 "encoder_hidden_states": normal(
                     b, t, v, 4, kwargs["joint_attention_dim"]),
                 "pooled_projections": normal(
                     b, t, v, kwargs["pooled_projection_dim"]),
                 "added_time_ids": normal(b, t, v, 11)}
        fake = features(pipe.decode_latents(pipe.inference_pipeline(
            batch, batch["latents"].shape, noise=normal(b, t, v, h, w, c))))
        real = features(pipe.decode_latents(batch["latents"]))
        for k, m in subtle.items():
            m.update(real[k], fake[k])
        for name, k in (("i3d", "fvd"), ("inception", "fid")):
            gaps[name].append(float(
                (real[k].mean(0) - fake[k].mean(0)).abs().max()))
    fvd_val, fid_val = subtle["fvd"].compute(), subtle["fid"].compute()
    cal, same = metrics(), metrics()
    for _ in range(n_batches):
        real = features(pipe.decode_latents(normal(b, t, v, h, w, c)))
        real2 = features(pipe.decode_latents(normal(b, t, v, h, w, c)))
        noise = features(torch.rand((b, t, v, h, w, c),
                                    generator=gen).to(device) * 2 - 1)
        for k in nets:
            cal[k].update(real[k], noise[k])
            same[k].update(real[k], real2[k])
    values = {"fvd_random_i3d": fvd_val, "fid_random_inception": fid_val,
              "fvd_noise_calibration": cal["fvd"].compute(),
              "fid_noise_calibration": cal["fid"].compute(),
              "fvd_same_dist_floor": same["fvd"].compute(),
              "fid_same_dist_floor": same["fid"].compute()}
    check_drill(values, gaps)
    out = {"status": "ok", "checkpoint": entry["out_path"],
           "samples": n_batches * b, **values,
           "feature_mean_gap_max": {k: max(g) for k, g in gaps.items()},
           "note": "random-weight feature nets + covariance shrinkage "
                   f"{DRILL_SHRINKAGE}: exercises the land → generate → "
                   "Fréchet path and its discrimination; not a quality "
                   "claim"}
    print(f"metrics drill: {json.dumps(out)}", flush=True)
    return out


def check_drill(values: dict, gaps: dict) -> None:
    """The drill's gates (``run_all.py:478-501``)."""
    for kind in ("fvd", "fid"):
        subtle = values[f"{kind}_random_" + ("i3d" if kind == "fvd"
                                             else "inception")]
        cal = values[f"{kind}_noise_calibration"]
        floor = values[f"{kind}_same_dist_floor"]
        if not subtle > 0.0:
            raise AssertionError(f"degenerate {kind} {subtle} on distinct "
                                 "inputs")
        if not cal > 3 * subtle:
            raise AssertionError(f"{kind} not monotone in the shift: "
                                 f"calibration {cal} vs {subtle}")
        if not cal > 3 * floor:
            raise AssertionError(f"{kind} calibration {cal} not above the "
                                 f"same-distribution floor {floor}")
    for name, g in gaps.items():
        if not max(g) > 1e-6:
            raise AssertionError(f"{name} features do not discriminate")


# ---------------------------------------------------------------------------
# The command line
# ---------------------------------------------------------------------------

def _device(name: str) -> torch.device:
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch sees no CUDA device")
    return torch.device(name)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--weights-dir", default=None,
                        help="directory of released checkpoints")
    parser.add_argument("--output", required=True,
                        help="directory for the converted weights")
    parser.add_argument("--report", default=None,
                        help="the JSON report (default "
                             "<output>/WEIGHTS_PARITY.json)")
    parser.add_argument("--dry-run", action="store_true",
                        help="write tiny sources and run the whole path "
                             "without real weights")
    parser.add_argument("--skip-check", action="store_true",
                        help="convert only; no golden forwards")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    device = _device(args.device)

    overrides = {}
    weights_dir = args.weights_dir
    if args.dry_run:
        weights_dir = os.path.join(args.output, "_dryrun_sources")
        overrides = dryrun_sources(weights_dir)
    if not weights_dir or not os.path.isdir(weights_dir):
        raise SystemExit(f"weights dir not found: {weights_dir!r} "
                         "(pass --weights-dir or --dry-run)")

    report = {"weights_dir": os.path.abspath(weights_dir), "entries": []}
    for rel, kind, config in discover(weights_dir):
        model_kwargs = None
        if rel in overrides:
            kind, model_kwargs = overrides[rel]
        elif config is not None:
            model_kwargs = load_model_kwargs(config)
        entry, _, _ = import_entry(
            rel, kind, os.path.join(weights_dir, rel), model_kwargs, device,
            output=args.output, check=not args.skip_check)
        report["entries"].append(entry)
        print(f"[{entry['status']:>9}] {kind:<13} {rel} "
              f"({entry['seconds']}s)", flush=True)

    if args.dry_run:
        try:
            report["metrics_drill"] = metrics_drill(report, overrides, device)
        except Exception as exc:  # noqa: BLE001 - record, don't abort
            report["metrics_drill"] = {
                "status": "failed", "error": f"{type(exc).__name__}: {exc}"}
            print(f"metrics drill failed: {exc}", flush=True)

    report_path = args.report or os.path.join(args.output,
                                              "WEIGHTS_PARITY.json")
    os.makedirs(os.path.dirname(report_path) or ".", exist_ok=True)
    with open(report_path, "w") as f:
        json.dump(report, f, indent=1)
    n_ok = sum(e["status"] == "verified" for e in report["entries"])
    print(f"report → {report_path}  ({n_ok}/{len(report['entries'])} "
          "verified)", flush=True)
    if not report["entries"]:
        raise SystemExit("no known checkpoint files found")
    return report


if __name__ == "__main__":
    main()
