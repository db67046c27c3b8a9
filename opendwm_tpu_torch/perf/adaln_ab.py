"""K3 and K4 (fused AdaLN) of another checkout beside this one's, on one
card: kernel against kernel at the DiTs' shapes and, with ``--model``, a
full-width DiT's CFG forward (and train step) with either pair in the
model.

Run from the root of a checkout, with a second checkout (for example the
parent commit's files unpacked with ``git archive``) to compare against:

    python -m opendwm_tpu_torch.perf.adaln_ab --parent DIR --out PATH \
        [--model [dit|lidar]]

The parent's ``opendwm_tpu_torch/ops/fused_adaln.py`` is loaded from its
path beside this checkout's (whose kernels are ``csrc/adaln.cu``); both
modules' public functions are called as the model calls them. At each
shape of ``SHAPES`` in bf16 (the CTSD-3.5 DiT's at d 1536, the LiDAR DiT's
at d 1024) both are held to their plain version (this checkout's): scaled
error 3e-2, relative norm 2^-8; this checkout's x' (K4) must equal the
plain x' bit for bit (the parent's is reported), and whether the two
checkouts' outputs are the same bits is reported. They are timed in
turns, parent, tree, tree, parent (each turn kept), four ways: eager ms
(CUDA events around 10 queued calls), device ms (the same 10 calls
replayed from a CUDA graph), cold device ms (the graph over copies of the
inputs that together exceed twice the L2) and host µs a call (1000
enqueues), beside the least time the card could take (``bound_ms``,
device-memory bytes) and a same-bytes ``copy_`` (K3/K4 have no PyTorch
call of the same function: the per-sample scale defeats ``layer_norm``'s
affine).

``--model`` (``dit``) swaps each pair into ``models/mmdit.py`` in turn
(the model and every other kernel are this checkout's) and times, in the
same turns, 3 DiT CFG forwards a turn (CTSD-3.5 config at full width,
random weights from seed 0, the smoke's 6 x 6 view-frames) with one
profiled forward a pair (K3/K4 device ms in it), then 2 train steps a turn
(fp32 masters, bf16 compute, AdamW, the config's remat). ``--model
lidar`` does the same for the LiDAR DiT's CFG forward
(``configs/lidar/lidar_diffusion_dit_temporal_ns.json`` at full width,
random weights from seed 0, at ``chip_smoke.py`` phase 14's geometry: 6
frames, CFG batch 2, K3/K4 at (12, 1600 | 1, 1024)), without a train
step. The JSON report goes to ``--out`` only.
"""

from __future__ import annotations

import os

# Before CUDA initialises: the train step's 60 GB of state in few blocks
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

import torch  # noqa: E402

from opendwm_tpu_torch.ops import _build, fused_adaln  # noqa: E402
from opendwm_tpu_torch.perf.measure import (  # noqa: E402
    adaln_bound,
    card_line,
    clock_line,
    cold_copies,
    host_us,
    rel_err,
    scaled_err,
    time_graph_ms,
    time_ms,
)

REPO = Path(__file__).resolve().parents[2]
# (batch x view-frames, tokens, width): the CTSD-3.5 DiT's latent and text
# tokens at the serving CFG batch and at training's batch 1; the LiDAR
# DiT's latent and text tokens at its CFG batch (2 x 6 frames) and at its
# training batch (4 x 6 frames).
SHAPES = ((72, 448, 1536), (72, 154, 1536), (36, 448, 1536), (36, 154, 1536),
          (12, 1600, 1024), (12, 1, 1024), (24, 1600, 1024), (24, 1, 1024))
KERNELS = ("adaln_modulate", "residual_adaln_modulate")
TOL, REL_TOL = 3e-2, 2 ** -8
ORDER = ("parent", "tree", "tree", "parent")
SEED = 0


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_parent(parent: Path):
    """The parent checkout's ``ops/fused_adaln.py``, loaded from its path.
    If it builds CUDA sources (``_build``), it builds its own: its
    ``_build`` is the parent's ``ops/_build.py``, whose sources are the
    parent's ``csrc/`` and whose libraries go under the parent's
    ``build/``."""
    ops = parent / "opendwm_tpu_torch" / "ops"
    module = _load(ops / "fused_adaln.py", "parent_fused_adaln")
    if hasattr(module, "_build"):
        module._build = _load(ops / "_build.py", "parent_build")
    return module


def _inputs(n, l, d, dev, g):
    x, delta = (torch.randn(n, l, d, generator=g, device=dev,
                            dtype=torch.bfloat16) for _ in range(2))
    # strided per-sample vectors, as the model's modulation chunks are
    gate, scale, shift = torch.randn(n, 9 * d, generator=g, device=dev,
                                     dtype=torch.bfloat16).chunk(9, -1)[:3]
    return x, delta, gate, scale, shift


def _call(module, name, x, delta, gate, scale, shift, plain=False):
    """A call of ``module``'s K3 or K4 (or its plain version) returning a
    tuple of outputs."""
    fn = getattr(module, f"{name}_plain" if plain else name)
    if name == "adaln_modulate":
        return lambda: (fn(x, scale, shift),)
    return lambda: fn(x, delta, gate, scale, shift)


def _times(fn, cold) -> dict:
    return {"ms": time_ms(fn), "device_ms": time_graph_ms([fn] * 10),
            "device_ms_cold": time_graph_ms(
                [cold[i % len(cold)] for i in range(10)]),
            "host_us": host_us(fn)}


def copy_ms(copies, residual: bool) -> float:
    """Cold device ms of plain copies of the same bytes as the kernel's
    rows (x into y; for K4 also delta into x'): the rate the card's copy
    kernel reaches for this traffic, a yardstick of what a kernel bound by
    bytes can reach here."""
    x = copies[0][0]
    y, xo = torch.empty_like(x), torch.empty_like(x)

    def call(c):
        y.copy_(c[0])
        if residual:
            xo.copy_(c[1])
    return time_graph_ms([lambda c=copies[i % len(copies)]: call(c)
                          for i in range(10)])


def host_parts(dev) -> dict:
    """Host µs of each step of this checkout's K3 call at (36, 154, 1536)
    bf16 (``host_us``, 1000 calls each): the whole wrapper, the autograd
    Function's apply, and its pieces."""
    x, _, _, scale, shift = _inputs(36, 154, 1536, dev,
                                    torch.Generator(dev).manual_seed(SEED))
    lib = fused_adaln._library()
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(dev).cuda_stream
    parts = {
        "wrapper": lambda: fused_adaln.adaln_modulate(x, scale, shift),
        "autograd_apply": lambda: fused_adaln._AdaLN.apply(x, scale, shift,
                                                           1e-6),
        "check_rows": lambda: fused_adaln._check_rows(x, scale, shift),
        "vecs": lambda: fused_adaln._vecs(36, 1536, x.dtype, scale, shift),
        "empty_like": lambda: torch.empty_like(x),
        "instance": lambda: fused_adaln.instance(
            1536, x.dtype, scale.dtype,
            *fused_adaln._addresses(x, out, scale, shift)),
        "current_stream": lambda: torch.cuda.current_stream(
            x.device).cuda_stream,
        "ctypes_launch": lambda: lib.adaln_forward(
            x.data_ptr(), scale.data_ptr(), shift.data_ptr(), out.data_ptr(),
            36, 154, 1536, scale.stride(0), shift.stride(0), 1e-6, 1, 1, 1,
            stream),
    }
    return {name: host_us(fn) for name, fn in parts.items()}


def run_kernels(parent_mod, dev) -> list[dict]:
    mods = {"parent": parent_mod, "tree": fused_adaln}
    g = torch.Generator(dev).manual_seed(SEED)
    rows = []
    for n, l, d in SHAPES:
        inputs = _inputs(n, l, d, dev, g)
        for name in KERNELS:
            residual = name.startswith("residual")
            ref = _call(fused_adaln, name, *inputs, plain=True)()
            row = {"kernel": name, "shape": [n, l, d]}
            got = {}
            for who, mod in mods.items():
                outs = got[who] = _call(mod, name, *inputs)()
                torch.cuda.synchronize()
                errs = {"scaled_err": max(scaled_err(a, b)
                                          for a, b in zip(outs, ref)),
                        "rel_err": max(rel_err(a, b)
                                       for a, b in zip(outs, ref))}
                if residual:
                    errs["x_bits_equal"] = torch.equal(outs[0], ref[0])
                    errs["x_bits_differing"] = int(
                        (outs[0].view(torch.int16) !=
                         ref[0].view(torch.int16)).sum())
                row[f"{who}_vs_plain"] = errs
                if not (errs["scaled_err"] <= TOL and
                        errs["rel_err"] <= REL_TOL):
                    raise RuntimeError(f"{who} {name} {(n, l, d)} disagrees "
                                       f"with the plain version: {errs}")
                if who == "tree" and residual and not errs["x_bits_equal"]:
                    raise RuntimeError(f"tree x' at {(n, l, d)} differs from "
                                       f"the plain version's: {errs}")
            row["tree_bits_equal_parent"] = all(
                torch.equal(a, b) for a, b in zip(got["tree"], got["parent"]))
            del ref, outs, got
            x, delta = inputs[:2]
            copies = [inputs] + [
                (torch.randn_like(x), torch.randn_like(delta), *inputs[2:])
                for _ in range(cold_copies(x.nbytes * (2 if residual else 1))
                               - 1)]
            turns: dict = {who: [] for who in mods}
            for who in ORDER:
                fn = _call(mods[who], name, *inputs)
                cold = [_call(mods[who], name, *c) for c in copies]
                turns[who].append(_times(fn, cold))
            row["copy_device_ms_cold"] = copy_ms(copies, residual)
            del copies
            for who, ts in turns.items():
                for k in ts[0]:
                    row[f"{who}_{k}"] = sum(t[k] for t in ts) / len(ts)
                row[f"{who}_turns"] = ts
            row["bound_ms"], row["bound_by"] = adaln_bound(n, l, d, residual)
            print(json.dumps(row), flush=True)
            rows.append(row)
        del inputs
        torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def use(module):
    """The model's K3/K4 (``models/mmdit.py``'s names) from ``module``."""
    from opendwm_tpu_torch.models import mmdit

    saved = mmdit.adaln_modulate, mmdit.residual_adaln_modulate
    mmdit.adaln_modulate = module.adaln_modulate
    mmdit.residual_adaln_modulate = module.residual_adaln_modulate
    try:
        yield
    finally:
        mmdit.adaln_modulate, mmdit.residual_adaln_modulate = saved


def _launched(module) -> int:
    return module.launches + module.res_launches


def _smoke():
    """``chip_smoke.py`` of this checkout, for its phase builders."""
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    import chip_smoke

    return chip_smoke


def forward_turns(mods: dict, model, kwargs: dict, what: str) -> dict:
    """``model``'s CFG forward with each pair of ``mods``: a warm-up of
    each, then 3 forwards a turn (``ORDER``; host seconds around each,
    between synchronizes), the relative error of the tree's output to the
    parent's, and one profiled forward a pair (K3/K4 device ms in it)."""
    smoke = _smoke()
    report: dict = {"forward_s": {w: [] for w in mods}}
    outs = {}
    with torch.inference_mode():
        for module in mods.values():  # warm-ups
            with use(module):
                model(**kwargs)
        for who in ORDER:
            before = _launched(mods[who])
            with use(mods[who]):
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    outs[who] = model(**kwargs)
                    torch.cuda.synchronize()
                    report["forward_s"][who].append(time.perf_counter() - t0)
            if _launched(mods[who]) == before:
                raise RuntimeError(f"the {who} K3/K4 never ran in the model")
        report["forward_rel_err_tree_vs_parent"] = rel_err(outs["tree"],
                                                           outs["parent"])
        for who in mods:
            with use(mods[who]):
                dt, prof = smoke.profile_forward(
                    model, kwargs, f"{what} ({who} K3/K4)")
            report[f"{who}_profiled"] = {"wall_s": dt,
                                         **smoke.adaln_profile_ms(prof)}
            print(f"{who}: {json.dumps(report[f'{who}_profiled'])}",
                  flush=True)
    return report


def _print_times(report: dict, keys) -> None:
    for key in keys:
        for who, ts in report[key].items():
            print(f"{key} {who}: {', '.join(f'{t:.4f}' for t in ts)}; mean "
                  f"{sum(ts) / len(ts):.4f}", flush=True)


def run_lidar_model(parent_mod, dev) -> dict:
    """The LiDAR DiT's CFG forward with each pair, in turns, at
    ``chip_smoke.py`` phase 14's geometry."""
    smoke = _smoke()
    from opendwm_tpu_torch.config import create_instance_from_config
    from opendwm_tpu_torch.pipelines.ctsd import get_conditions

    mods = {"parent": parent_mod, "tree": fused_adaln}
    pipe, gen = smoke.build_lidar(create_instance_from_config,
                                  smoke.LIDAR_DIT_CONFIG, dev,
                                  ("model", "autoencoder"))
    prepared = pipe.prepare_batch(smoke.lidar_batch(dev, gen,
                                                    smoke.LIDAR_DIT_FRAMES))
    latents = prepared["latents"]
    conds = get_conditions(prepared, pipe.common_config,
                           do_classifier_free_guidance=True)
    kwargs = dict(sample=torch.randn((2, *latents.shape[1:]), generator=gen,
                                     device=dev),
                  timestep=torch.full((2, *latents.shape[1:3]), 500.0,
                                      device=dev), **conds)
    del prepared
    report = forward_turns(mods, pipe.model, kwargs, "LiDAR DiT CFG forward")
    _print_times(report, ("forward_s",))
    del pipe, conds, kwargs, latents
    gc.collect()
    torch.cuda.empty_cache()
    return report


def run_model(parent_mod, dev) -> dict:
    """The DiT CFG forward and train step with each pair, in turns."""
    smoke = _smoke()
    from opendwm_tpu_torch.config import create_instance_from_config
    from opendwm_tpu_torch.pipelines.ctsd import get_conditions

    mods = {"parent": parent_mod, "tree": fused_adaln}
    cfg = json.loads(smoke.CONFIG.read_text())["pipeline"]
    with torch.device("meta"):
        pipe = create_instance_from_config(cfg)
    model = pipe.model
    gen = torch.Generator(dev).manual_seed(SEED)
    model.to_empty(device=dev)
    smoke.random_init_(model, gen)
    model.eval()
    batch = smoke.make_batch(dev, gen)
    conds = get_conditions(batch, pipe.common_config,
                           do_classifier_free_guidance=True)
    shape = (2, smoke.FRAMES, smoke.VIEWS, smoke.LAT_H, smoke.LAT_W, 16)
    kwargs = dict(sample=torch.randn(shape, generator=gen, device=dev),
                  timestep=torch.full(shape[:3], 500.0, device=dev), **conds)
    report = forward_turns(mods, model, kwargs, "DiT CFG forward")
    report["step_s"] = {w: [] for w in mods}
    del pipe, model, conds, kwargs, batch
    gc.collect()
    torch.cuda.empty_cache()

    cfg["model"]["param_dtype"] = torch.float32
    with torch.device("meta"):
        pipe = create_instance_from_config(cfg)
    pipe.model.to_empty(device=dev)
    smoke.random_init_(pipe.model, gen)
    batch = smoke.make_batch(dev, gen)
    batch["latents"] = torch.randn(shape[1:], generator=gen,
                                   device=dev)[None]
    state = pipe.init_state()
    generator = torch.Generator(dev).manual_seed(SEED + 1)

    def step():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics = pipe.train_step(state, batch, generator)
        if not torch.isfinite(metrics["sd_loss"]):
            raise RuntimeError("non-finite train loss")
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for module in mods.values():  # warm-ups; the first allocates AdamW's
        with use(module):
            step()
    for who in ORDER:
        before = _launched(mods[who])
        with use(mods[who]):
            report["step_s"][who] += [step() for _ in range(2)]
        if _launched(mods[who]) == before:
            raise RuntimeError(f"the {who} K3/K4 never ran in the train step")
    _print_times(report, ("forward_s", "step_s"))
    del pipe, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return report


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        description="K3/K4 of a parent checkout and of this one, timed side "
                    "by side on the card")
    parser.add_argument("--parent", required=True, type=Path,
                        help="root of the checkout to compare against")
    parser.add_argument("--out", required=True, help="JSON report path")
    parser.add_argument("--model", nargs="?", const="dit",
                        choices=("dit", "lidar"),
                        help="also time a full-width model with each pair: "
                             "the CTSD-3.5 DiT's CFG forward and train step "
                             "(dit, the default) or the LiDAR DiT's CFG "
                             "forward (lidar)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the comparison needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.build_all(("adaln.cu", "flash_tail.cu", "flash_attention.cu")
                     if args.model else ("adaln.cu",))
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    parent_mod = load_parent(args.parent)
    report = {"device": {"platform": "gpu",
                         "kind": torch.cuda.get_device_name(0),
                         "card": card_line()},
              "ptxas": _build.ptxas_report(_build.library_path("adaln.cu"),
                                           "adaln_"),
              "sass": _build.sass_census(_build.library_path("adaln.cu"),
                                         "adaln_stream_kernel"),
              "clocks": {"before": clock_line()},
              "rows": run_kernels(parent_mod, dev),
              "host_parts_us": host_parts(dev)}
    report["clocks"]["after_kernels"] = clock_line()
    print(f"clocks: {json.dumps(report['clocks'])}", flush=True)
    print(f"host parts (us a call): {json.dumps(report['host_parts_us'])}",
          flush=True)
    if args.model:
        run = run_lidar_model if args.model == "lidar" else run_model
        report["model"] = {"name": args.model, **run(parent_mod, dev)}
        report["clocks"]["after_model"] = clock_line()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print("card:", report["device"]["card"])
    print("wrote", out)
    return report


if __name__ == "__main__":
    main()
