"""int8 fidelity of the CTSD-3.5 DiT: bf16 against int8 quantized FROM THE
SAME WEIGHTS (port of ``perf/exp_int8_fidelity.py``).

(a) one CFG forward: cosine, ``max_rel_err`` (``|int8 - bf16| /
    max(|bf16|, 1e-3)``), its mean, where its maximum lies,
    ``max_rel_err_where_big`` (over ``|bf16| > 0.1 * std(bf16)``, the JAX
    script's mask), ``max_abs_err`` and both outputs' standard deviations
    (``forward_fidelity``);
(b) a rollout's latents: cosine, and the least cosine of a frame
    (``rollout_fidelity``).

``run`` does both for a float pipeline and its int8 twin (``build_pair``:
the same config with ``quantization="int8"``, weights quantized from the
float model's by ``ops.quant.quantize_state_dict``). The tests run it on
the CPU at a tiny size; ``chip_smoke.py``'s int8 phase runs it on the
card at full width (phase 5's CTSD-3.5 geometry: bf16, random weights
from a seed, 1 x 6 frames x 6 views of 32 x 56 latents, the 2-window
rollout of 4 steps with CFG 4.0) and prints the report.

The module also holds what the int8 phase checks and profiles with:
the number of ``QLinear``/``QConv2d`` calls a forward implies, read from
a model config (``dit_int8_calls``, ``unet_int8_calls``,
``vae_decoder_int8_calls``); ``Int8Census``, which records each quantized
layer's products (an integer one, and no float GEMM, per call); and
``int8_ranges`` / ``int8_split``, which split a profile's device time
into the int8 GEMM (``aten::_int_mm``'s kernels), the quantize and
dequantize work around it (every other kernel launched inside a
quantized layer) and the rest.
"""

from __future__ import annotations

import contextlib
import copy
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from opendwm_tpu_torch.config import create_instance_from_config
from opendwm_tpu_torch.models.layers import QConv2d, QLinear
from opendwm_tpu_torch.ops.quant import quantize_state_dict
from opendwm_tpu_torch.perf.measure import (
    kernels_ms,
    launched_by,
    range_kernels,
)

QUANTIZED = (QLinear, QConv2d)
# The JAX package's bars (tests/test_quant.py): cosine to the float path.
DIT_COSINE, UNET_COSINE, VAE_COSINE = 0.995, 0.99, 0.99
# aten GEMMs and convolutions as a dispatch mode sees them.
_GEMMS = {"mm", "addmm", "bmm", "baddbmm", "addbmm", "matmul", "linear",
          "convolution", "_convolution", "cudnn_convolution", "_int_mm",
          "_scaled_mm"}
RANGE = "int8 layer"


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return (a @ b / (a.norm() * b.norm() + 1e-30)).item()


def forward_fidelity(ref: torch.Tensor, out: torch.Tensor) -> dict:
    """The JAX script's forward report of ``out`` (int8) against ``ref``
    (float), unrounded."""
    ref, out = ref.float().flatten(), out.float().flatten()
    err = (out - ref).abs()
    rel = err / ref.abs().clamp(min=1e-3)
    k = int(rel.argmax())
    big = ref.abs() > 0.1 * ref.std(correction=0)
    return {
        "cosine": cosine(ref, out),
        "max_rel_err": rel[k].item(),
        "mean_rel_err": rel.mean().item(),
        "max_rel_err_at": {"float_value": ref[k].item(),
                           "abs_err": err[k].item()},
        "max_rel_err_where_big": rel[big].max().item(),
        "max_abs_err": err.max().item(),
        "out_std_float": ref.std(correction=0).item(),
        "out_std_int8": out.std(correction=0).item(),
    }


def rollout_fidelity(ref: torch.Tensor, out: torch.Tensor) -> dict:
    """Cosine of two rollouts' latents ``(b, frames, ...)``, overall and
    the least of a frame."""
    return {
        "cosine": cosine(ref, out),
        "per_frame_cosine_min": min(cosine(ref[:, i], out[:, i])
                                    for i in range(ref.shape[1])),
        "lat_std_float": ref.float().std(correction=0).item(),
        "lat_std_int8": out.float().std(correction=0).item(),
    }


def build_pair(pipeline_config: dict, device, init_, gen):
    """A float pipeline built from ``pipeline_config`` on ``device`` with
    weights drawn by ``init_(model, gen)``, and its int8 twin: the same
    config with ``quantization="int8"``, its weights quantized from the
    float model's. Both are built on the meta device first, so no
    full-width weights are made on the CPU."""
    qconfig = copy.deepcopy(pipeline_config)
    qconfig["model"]["quantization"] = "int8"
    with torch.device("meta"):
        pipe = create_instance_from_config(copy.deepcopy(pipeline_config))
        qpipe = create_instance_from_config(qconfig)
    pipe.model.to_empty(device=device)
    init_(pipe.model, gen)
    qpipe.model.to_empty(device=device)
    qpipe.model.load_state_dict(quantize_state_dict(pipe.model.state_dict(),
                                                    qpipe.model))
    return pipe, qpipe


def run(pipe, qpipe, forward_kwargs: dict, batch: dict, latent_shape,
        total_frames: int, seed: int = 0,
        before=None) -> tuple[dict, torch.Tensor]:
    """(a) and (b) for ``pipe`` and its int8 twin ``qpipe``: one forward
    of each model on ``forward_kwargs``, and each pipeline's rollout of
    ``batch`` from a generator seeded ``seed``, the bf16 one first, each
    timed (``rollout_s``). ``before(name)``, where given, is called just
    before the rollout ``name`` ("bf16", "int8"); the int8 one runs last,
    so what a caller starts there (launch counts, peak memory) sees that
    rollout and nothing after it but the caller's own work. Returns the
    report and the int8 rollout's latents."""
    dev = forward_kwargs["sample"].device
    with torch.inference_mode():
        fwd = forward_fidelity(pipe.model(**forward_kwargs),
                               qpipe.model(**forward_kwargs))
    lats, secs = {}, {}
    for name, p in (("bf16", pipe), ("int8", qpipe)):
        if before is not None:
            before(name)
        _sync(dev)
        t0 = time.perf_counter()
        lats[name] = p.autoregressive_inference_pipeline(
            batch, latent_shape, total_frames=total_frames,
            reference_frame_count=1,
            generator=torch.Generator(dev).manual_seed(seed))
        _sync(dev)
        secs[name] = time.perf_counter() - t0
    return {"forward": fwd, "rollout": rollout_fidelity(lats["bf16"],
                                                         lats["int8"]),
            "rollout_s": secs}, lats["int8"]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# -- what the architecture implies -------------------------------------------

def dit_int8_calls(cfg: dict) -> int:
    """``QLinear`` calls of one int8 DiT forward (``models/mmdit.py``): a
    joint block's attention q, k, v, the context's q, k, v and the output
    projections (no context output in the last, ``context_pre_only``
    block), 4 more with dual attention, 2 a feed-forward (no context one
    in the last block); 8 a cross-view or temporal branch block (``ff_in``,
    q, k, v, out, ``ff``)."""
    n = cfg.get("num_layers", 24)
    dual = set(cfg.get("dual_attention_layers", range(13)))
    calls = 0
    for i in range(n):
        last = i == n - 1
        calls += (7 if last else 8) + (4 if i in dual else 0) + \
            (2 if last else 4)
    for flag, layers in (("enable_crossview", "crossview_block_layers"),
                         ("enable_temporal", "temporal_block_layers")):
        if cfg.get(flag, False):
            calls += 8 * len(cfg.get(layers, ()))
    return calls


def unet_int8_calls(cfg: dict) -> int:
    """``QLinear``/``QConv2d`` calls of one int8 UNet forward
    (``models/unet.py``): ``conv_in``, ``conv_out``; 2 convs a spatial
    resnet (3 where its channels change); a sampler each; a transformer
    model's ``proj_in``/``proj_out`` and, a layer, 10 in its block (2
    attentions, GEGLU) and 8 in each cross-view and temporal block."""
    chans = list(cfg.get("block_out_channels", (320, 640, 1280, 1280)))
    per_block = cfg.get("layers_per_block", 2)
    tf_layers = cfg.get("transformer_layers_per_block", 1)
    branches = int(cfg.get("enable_crossview", True)) + \
        int(cfg.get("enable_temporal", True))
    model = 2 + tf_layers * (10 + 8 * branches)

    def resnet(cin, cout):
        return 2 + (cin != cout)

    n = len(chans)
    calls, prev, skips = 2, chans[0], [chans[0]]
    for i, ch in enumerate(chans):
        last = i == n - 1
        for j in range(per_block):
            calls += resnet(prev if j == 0 else ch, ch)
        calls += 0 if last else per_block * model + 1
        skips += [ch] * (per_block + (0 if last else 1))
        prev = ch
    calls += 2 * resnet(prev, prev) + model
    for i, ch in enumerate(reversed(chans)):
        for _ in range(per_block + 1):
            calls += resnet(prev + skips.pop(), ch)
            prev = ch
        calls += (0 if i == 0 else (per_block + 1) * model) + \
            (1 if i < n - 1 else 0)
    return calls


def vae_decoder_int8_calls(block_out_channels=(128, 256, 512, 512),
                           layers_per_block: int = 3) -> int:
    """``QConv2d``/``QLinear`` calls of one int8 VAE decode
    (``models/autoencoders.py``): ``conv_in``, the mid block's 2 resnets
    and attention (q, k, v, out), each up block's resnets (2 convs, 3
    where the channels change) and upsampler, ``conv_out``."""
    chans = list(reversed(block_out_channels))
    calls = 1 + 2 * 2 + 4 + 1
    prev = chans[0]
    for i, ch in enumerate(chans):
        for j in range(layers_per_block):
            calls += 2 + ((prev if j == 0 else ch) != ch)
        calls += 1 if i < len(chans) - 1 else 0
        prev = ch
    return calls


# -- census and profile ---------------------------------------------------------

class Int8Census(TorchDispatchMode):
    """For every call of a ``QLinear``/``QConv2d`` under ``model`` while
    the mode is on, the integer products (``aten._int_mm`` on the card,
    the int32 ``mm`` on the CPU) and the float GEMMs it ran; also the
    float GEMMs outside quantized layers. ``calls``: one ``[integer,
    float]`` pair a layer call."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model
        self.calls: list = []
        self.outside_float = 0
        self._layer = None
        self._hooks: list = []

    def __enter__(self):
        def pre(module, args):
            self._layer = [0, 0]
            self.calls.append(self._layer)

        def post(module, args, out):
            self._layer = None

        for m in self.model.modules():
            if isinstance(m, QUANTIZED):
                self._hooks += [m.register_forward_pre_hook(pre),
                                m.register_forward_hook(post)]
        return super().__enter__()

    def __exit__(self, *exc):
        for h in self._hooks:
            h.remove()
        self._hooks.clear()
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in _GEMMS:
            floats = any(isinstance(a, torch.Tensor) and a.is_floating_point()
                         for a in args)
            if self._layer is not None:
                self._layer[int(floats)] += 1
            elif floats:
                self.outside_float += 1
        return func(*args, **(kwargs or {}))

    def check(self, want_calls: int, what: str) -> dict:
        """Raises unless there were ``want_calls`` quantized layer calls,
        each with exactly one integer product and no float GEMM."""
        bad = [c for c in self.calls if c != [1, 0]]
        summary = {"layer_calls": len(self.calls),
                   "integer_products": sum(c[0] for c in self.calls),
                   "float_gemms_in_layers": sum(c[1] for c in self.calls),
                   "float_gemms_outside": self.outside_float}
        if len(self.calls) != want_calls or bad:
            raise AssertionError(
                f"{what}: {summary}, want {want_calls} layer calls of one "
                f"integer product and no float GEMM each ({len(bad)} not)")
        return summary


@contextlib.contextmanager
def int8_ranges(model: torch.nn.Module):
    """Each ``QLinear``/``QConv2d`` call under ``model`` inside a profiler
    range named ``RANGE``."""
    open_ranges: list = []

    def pre(module, args):
        r = torch.profiler.record_function(RANGE)
        r.__enter__()
        open_ranges.append(r)

    def post(module, args, out):
        open_ranges.pop().__exit__(None, None, None)

    hooks = []
    for m in model.modules():
        if isinstance(m, QUANTIZED):
            hooks += [m.register_forward_pre_hook(pre),
                      m.register_forward_hook(post)]
    try:
        yield
    finally:
        for h in hooks:
            h.remove()


def int8_split(prof) -> dict:
    """Device ms and kernels of a profile taken under ``int8_ranges``:
    ``int8_gemm`` (the kernels that ``aten::_int_mm`` launched),
    ``quant_dequant`` (every other kernel inside a quantized layer's range
    on the device timeline: casts, amax, division, rounding, padding,
    im2col, dequantize, bias) and ``other``. Each kernel is counted once,
    as the profile's own table counts it."""
    gemms = launched_by(prof, "aten::_int_mm")
    inside, outside = range_kernels(prof, RANGE)
    parts = {"int8_gemm": [e for e in inside + outside if e.name in gemms],
             "quant_dequant": [e for e in inside if e.name not in gemms],
             "other": [e for e in outside if e.name not in gemms]}
    return {k: {"ms": kernels_ms(v), "kernels": len(v)}
            for k, v in parts.items()}
