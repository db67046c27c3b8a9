"""The gates of ``chip_smoke.py`` that hold the Hopper kernels, fed with
made-up census, launch counts and experiment rows on the CPU: the
SASS/ptxas census of the forward, tiling and backward instances, the rule
that every attention launch of a model path ran the Hopper body, and the
tiling experiment's rules (K5 and K6 equal to K1 bit for bit, every bf16
launch of them on the Hopper tiling kernel); for K3/K4 (``csrc/adaln.cu``)
the ptxas spill gate, the bars and the rule that every launch of the DiT
paths ran the d-1536 kernel, and that the smoke builds every CUDA source.
Also the shape of the backward's fp32 dQ workspace; and the layout
phases' gates: the rasters must move a denoiser's output, ``random_init_``
draws the ImageAdapter's zero convs and gates non-zero, and the bf16
moments hold 2 bytes an element; the stream phase's gates: the ``ready``
schedule, the bf16 text stage's bar, the stream path's launch census, the
text encoders' weight scales and the tiny streaming DiT; the UniMLVG
phases' gates: the rollout's census, the branch types' K7 shapes and
MaskGWM's K1 shape from the geometry, the tiny paths' bars, the cameras
must move the output; the LiDAR training phases' gates: the LiDAR DiT's
and the LiDAR UNet's train census, their shapes from the configs and
phase 3's lists, the UNet's parameters that may stay; the data phase's
gates: its launch census, the native data plane against its fallbacks,
the items through the two filesystems bit for bit, the train CLI's logged
steps. No kernel runs here.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from opendwm_tpu_torch.ops import flash_tail

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


GOOD = {"HGMMA": 20, "UTMALDG": 4, "UTMASTG": 2, "LDGSTS": 0, "LDSM": 0,
        "HMMA": 0}
NAME = "_ZN5bwd9021flash_bwd_sm90_kernelILb0EEEvNS0_6ParamsE"


class _FakeBuild:
    """``ops._build`` as the census reads it, with one instance."""

    def __init__(self, ptxas, sass):
        self.ptxas, self.sass = ptxas, sass

    def library_path(self, source):
        return Path(source)

    def ptxas_report(self, lib, name_part):
        return self.ptxas

    def sass_census(self, lib, name_part):
        return self.sass


@pytest.mark.parametrize("case", ["ok", "spill", "mma_sync", "no_tma",
                                  "no_wgmma", "no_ptxas", "no_instance"])
def test_census_holds_every_instance(smoke, case):
    """The census passes a clean instance and fails on a spill, on
    ``mma.sync`` (HMMA), without TMA loads or wgmma, on an instance ptxas
    did not report, and when the library has no instance at all."""
    ptxas = {NAME: {"spill_bytes": 0, "registers": 168}}
    ops = dict(GOOD)
    if case == "spill":
        ptxas[NAME]["spill_bytes"] = 948
    elif case == "mma_sync":
        ops["HMMA"] = 16
    elif case == "no_tma":
        ops["UTMALDG"] = 0
    elif case == "no_wgmma":
        ops["HGMMA"] = 0
    elif case == "no_ptxas":
        ptxas = {}
    sass = {} if case == "no_instance" else {NAME: ops}
    build = _FakeBuild(ptxas, sass)
    if case == "ok":
        census = smoke.census_sm90(build, ("flash_tail.cu",),
                                   "flash_bwd_sm90")
        assert census == {"flash_tail.cu:ILb0": {
            "spill_bytes": 0, "registers": 168, **GOOD}}
    else:
        with pytest.raises(SystemExit):
            smoke.census_sm90(build, ("flash_tail.cu",), "flash_bwd_sm90")


TILING_NAME = ("_ZN12_GLOBAL__N_18tiling9023tail_tiling_sm90_kernelILi8EEEv"
               "NS0_6ParamsE")


@pytest.mark.parametrize("case", ["ok", "missing", "spill", "mma_sync"])
def test_census_holds_the_tiling_instance(smoke, case):
    """The census of the Hopper tiling kernel (K5/K6) passes its instance
    and fails on a build without it, on a spill, or on ``mma.sync``."""
    ptxas = {TILING_NAME: {"spill_bytes": 0, "registers": 168}}
    ops = dict(GOOD, HGMMA=16, UTMASTG=1)
    if case == "spill":
        ptxas[TILING_NAME]["spill_bytes"] = 64
    elif case == "mma_sync":
        ops["HMMA"] = 8
    build = _FakeBuild(ptxas, {} if case == "missing" else
                       {TILING_NAME: ops})
    if case == "ok":
        census = smoke.census_sm90(build, ("flash_tail.cu",),
                                   "tail_tiling_sm90")
        assert census == {"flash_tail.cu:ILi8": {
            "spill_bytes": 0, "registers": 168, **ops}}
    else:
        with pytest.raises(SystemExit):
            smoke.census_sm90(build, ("flash_tail.cu",), "tail_tiling_sm90")


def _tailvar_rows(dtype="bfloat16", err=3e-3, **over):
    """One shape's rows of the tiling experiment as the card reports them,
    with ``over`` set in K5's nh-4 row."""
    rows = [{"variant": "tail", "kernel": "flash_tail_forward",
             "dtype": dtype, "shape": [36, 602, 24, 64],
             "scaled_err": err, "rel_err": err}]
    for name, kernel in (("tail_h2", "tail_hpack"), ("tail_h4", "tail_hpack"),
                         ("tail_q128", "tail_qsplit"),
                         ("tail_q256", "tail_qsplit")):
        rows.append({**rows[0], "variant": name, "kernel": kernel,
                     "vs_k1_scaled_err": 0.0, "vs_k1_rel_err": 0.0,
                     "equals_k1": True})
    rows[2].update(over)
    return rows


@pytest.mark.parametrize("over,ok", [
    ({}, True),
    ({"equals_k1": False}, False),
    ({"equals_k1": None}, False),
    ({"vs_k1_rel_err": 1e-2}, False),
    ({"rel_err": 1e-2}, False),
])
def test_tailvar_rows_hold_k1_bits(smoke, over, ok):
    """A K5/K6 row passes only within the bars and equal to K1 bit for bit;
    one whose output is not K1's, or that was never compared, fails."""
    rel_tols = {torch.bfloat16: 2 ** -7, torch.float32: 1e-5}
    runs = [(_tailvar_rows(**over), 2e-2),
            (_tailvar_rows("float32", 1e-6), 1e-4)]
    if ok:
        smoke.check_tailvar_rows(runs, rel_tols)
    else:
        with pytest.raises(SystemExit):
            smoke.check_tailvar_rows(runs, rel_tols)


def _tailvar_counts(hpack, qsplit, hpack_sm90, qsplit_sm90):
    return {"tail_hpack": hpack, "tail_qsplit": qsplit,
            "tail_hpack_sm90": hpack_sm90, "tail_qsplit_sm90": qsplit_sm90,
            "tail_hpack_by_nh": {2: hpack // 2, 4: hpack - hpack // 2},
            "tail_qsplit_by_bq": {128: qsplit - 1, 256: 1}}


@pytest.mark.parametrize("bf16,total,ok", [
    ((48, 48, 48, 48), (72, 72, 48, 48), True),
    ((48, 48, 47, 48), (72, 72, 47, 48), False),  # a bf16 K5 on an old body
    ((48, 48, 48, 48), (72, 72, 48, 49), False),  # an fp32 K6 on Hopper
    ((48, 48, 48, 48), (48, 48, 48, 48), False),  # no fp32 launch
])
def test_tailvar_launches_ran_the_hopper_tilings(smoke, bf16, total, ok):
    """Every bf16 K5/K6 launch of the tiling experiment ran the Hopper
    tiling kernel and no fp32 one did."""
    args = (_tailvar_counts(*bf16), _tailvar_counts(*total))
    if ok:
        smoke.check_tailvar_launches(*args)
    else:
        with pytest.raises(SystemExit):
            smoke.check_tailvar_launches(*args)


def test_tailvar_launches_need_every_tiling(smoke):
    """K6 at bq 256 must have launched in bf16."""
    bf16 = _tailvar_counts(48, 48, 48, 48)
    bf16["tail_qsplit_by_bq"] = {128: 48}
    with pytest.raises(SystemExit):
        smoke.check_tailvar_launches(bf16, _tailvar_counts(72, 72, 48, 48))


def _counts(**over):
    counts = {"flash_tail": 10, "flash_tail_sm90": 10,
              "flash_attention": 5, "flash_attention_segment": 0,
              "flash_attention_sm90": 5, "flash_tail_backward": 4,
              "flash_tail_backward_sm90": 4, "flash_attention_backward": 2,
              "flash_attention_backward_sm90": 2}
    counts.update(over)
    return counts


@pytest.mark.parametrize("path,over,ok", [
    ("train", {}, True),
    ("train", {"flash_tail_backward_sm90": 3}, False),
    ("unet_train", {"flash_attention_backward_sm90": 1}, False),
    ("unet_serve", {"flash_tail_sm90": 9}, False),
    ("serve", {"flash_attention_sm90": 4}, False),
    ("bm_train", {"flash_tail_backward_sm90": 3}, False),
    ("bm_serve", {"flash_tail_sm90": 9}, False),
    ("bm_unet_serve", {"flash_attention_sm90": 4}, False),
    ("stream", {"flash_tail_sm90": 9}, False),
    ("int8_serve", {"flash_tail_sm90": 9}, False),
    ("int8_unet", {"flash_attention_sm90": 4}, False),
    ("unimlvg_serve", {"flash_tail_sm90": 9}, False),
    ("unimlvg_train", {"flash_tail_backward_sm90": 3}, False),
    ("branch_types", {"flash_attention_sm90": 4}, False),
    ("mask_step", {"flash_tail_backward_sm90": 3}, False),
    ("mask_step", {}, True),
    ("land_eval", {"flash_tail_sm90": 9}, False),
])
def test_model_paths_run_the_hopper_bodies(smoke, path, over, ok):
    """Every K1/K7 forward launch of the fifteen model paths and every
    K2/K7 backward launch of the five training paths must have run the
    Hopper body; one launch of an old body fails the run."""
    assert set(smoke.TRAIN_PATHS) < set(smoke.MODEL_PATHS)
    assert {"bm_serve", "bm_unet_serve", "bm_train", "stream", "int8_serve",
            "int8_unet", "unimlvg_serve", "unimlvg_train", "branch_types",
            "mask_step"} < set(smoke.MODEL_PATHS)
    assert {"unimlvg_train", "mask_step"} < set(smoke.TRAIN_PATHS)
    paths = {p: _counts() for p in smoke.MODEL_PATHS}
    paths[path] = _counts(**over)
    if ok:
        smoke.check_new_body_on_paths(paths)
    else:
        with pytest.raises(SystemExit):
            smoke.check_new_body_on_paths(paths)


@pytest.mark.parametrize("q_seq,rows", [(1, 64), (64, 64), (65, 128),
                                        (602, 640), (1792, 1792)])
def test_dq_workspace_is_whole_query_tiles(q_seq, rows):
    """The Hopper backward sums dQ in fp32 over whole 64-row query tiles:
    (batch * heads, q_seq rounded up to 64, 64)."""
    ws = flash_tail.dq_workspace(2, q_seq, 3, torch.device("cpu"))
    assert ws.shape == (6, rows, 64) and ws.dtype == torch.float32


def test_smoke_builds_every_source(smoke):
    """``chip_smoke.py`` builds (and so hashes, checks with ptxas and
    launches from) every CUDA source of the package, ``adaln.cu`` too."""
    csrc = REPO / "opendwm_tpu_torch" / "csrc"
    assert set(smoke.SOURCES) == {p.name for p in csrc.glob("*.cu")}
    assert "adaln.cu" in smoke.SOURCES


def _adaln_counts(k3=62, k4=47, k3_fixed=None, k4_fixed=None) -> dict:
    return {"adaln_modulate": k3,
            "adaln_modulate_fixed": k3 if k3_fixed is None else k3_fixed,
            "adaln_modulate_by_shape": {"72,448,1536": k3},
            "residual_adaln_modulate": k4,
            "residual_adaln_modulate_fixed": k4 if k4_fixed is None
            else k4_fixed,
            "residual_adaln_modulate_by_shape": {"72,448,1536": k4}}


@pytest.mark.parametrize("path,over,ok", [
    ("serve", {}, True),
    ("serve", {"k3_fixed": 61}, False),
    ("train", {"k4_fixed": 0}, False),
    ("train", {"k3": 0, "k3_fixed": 0}, False),
    ("bm_serve", {"k4_fixed": 46}, False),
    ("bm_train", {"k4": 0, "k4_fixed": 0}, False),
    ("stream", {"k4_fixed": 46}, False),
    ("int8_serve", {"k3_fixed": 61}, False),
    ("unimlvg_serve", {"k3_fixed": 61}, False),
    ("branch_types", {"k4_fixed": 46}, False),
    ("mask_step", {"k3": 0, "k3_fixed": 0}, False),
    ("land_eval", {"k4_fixed": 187}, False),
])
def test_dit_paths_run_the_row_kernel(smoke, path, over, ok):
    """Every K3/K4 launch of the eleven DiT paths must have run the d-1536
    kernel of ``csrc/adaln.cu``, and each path must have launched both."""
    assert set(smoke.DIT_PATHS) == {"serve", "train", "bm_serve", "bm_train",
                                    "stream", "int8_serve", "unimlvg_serve",
                                    "unimlvg_train", "branch_types",
                                    "mask_step", "land_eval"}
    paths = {p: _adaln_counts() for p in smoke.DIT_PATHS}
    paths[path] = _adaln_counts(**over)
    if ok:
        smoke.check_adaln_on_paths(paths)
    else:
        with pytest.raises(SystemExit):
            smoke.check_adaln_on_paths(paths)


@pytest.mark.parametrize("dtype,over,ok", [
    ("bfloat16", {}, True),
    ("bfloat16", {"rel_err": 2 ** -7}, False),   # wrong statistics
    ("bfloat16", {"scaled_err": 0.05}, False),
    ("bfloat16", {"x_bits_equal": False}, False),
    ("float16", {"rel_err": 2 ** -7}, False),
    ("float32", {"scaled_err": 5e-5}, True),
    ("float32", {"scaled_err": 2e-4}, False),
    ("float32", {"x_bits_equal": False}, False),
])
def test_adaln_bars(smoke, dtype, over, ok):
    """K3/K4's bars on the card: scaled error 3e-2 (bf16, fp16) or 1e-4
    (fp32), relative norm 2^-8 in bf16 and fp16, x' bit for bit."""
    e = {"max_abs_err": 0.01, "scaled_err": 0.01, "rel_err": 1e-3,
         "x_bits_equal": True, "dtype": dtype, **over}
    if ok:
        smoke.check_adaln_errors("residual_adaln_modulate", (2, 3, 4), e)
    else:
        with pytest.raises(SystemExit):
            smoke.check_adaln_errors("residual_adaln_modulate", (2, 3, 4), e)


def test_adaln_errors_read_x_bits(smoke):
    """``adaln_errors`` holds K4's x' bit for bit and its y to the bars."""
    x = torch.randn(2, 3, 8).to(torch.bfloat16)
    y = torch.randn(2, 3, 8).to(torch.bfloat16)
    bumped = (x.view(torch.int16) + 1).view(torch.bfloat16)  # one ulp
    assert smoke.adaln_errors((x, y), (x, y), torch.bfloat16)["x_bits_equal"]
    e = smoke.adaln_errors((bumped, y), (x, y), torch.bfloat16)
    assert not e["x_bits_equal"] and e["dtype"] == "bfloat16"
    assert smoke.adaln_errors((y,), (y,), torch.float32)["x_bits_equal"]


class _FakeAdalnBuild:
    """``ops._build`` as ``check_adaln_ptxas`` reads it."""

    def __init__(self, report):
        self.report = report

    def library_path(self, source):
        return source

    def ptxas_report(self, lib, name_part):
        return self.report


def _adaln_ptxas(n=12, **over):
    report = {f"_ZN12_GLOBAL__N_119adaln_stream_kernelI{i}EEvNS_4ArgsE":
              {"registers": 90, "spill_bytes": 0} for i in range(n)}
    first = next(iter(report))
    report[first].update(over)
    return report


@pytest.mark.parametrize("report,ok", [
    (_adaln_ptxas(), True),
    (_adaln_ptxas(spill_bytes=8), False),
    (_adaln_ptxas(n=11), False),
    ({"f": {"registers": 40}}, False),
])
def test_adaln_ptxas_fails_on_a_spill(smoke, report, ok):
    """Every kernel of ``csrc/adaln.cu`` (12 instances) must be in ptxas's
    report with 0 spill bytes."""
    if ok:
        assert smoke.check_adaln_ptxas(_FakeAdalnBuild(report)) == report
    else:
        with pytest.raises(SystemExit):
            smoke.check_adaln_ptxas(_FakeAdalnBuild(report))


@pytest.mark.parametrize("move,ok", [(0.0, False), (5e-4, False),
                                     (float("nan"), False), (2e-3, True),
                                     (0.5, True)])
def test_rasters_must_move_the_output(smoke, move, ok):
    """The layout phases fail when the output with the rasters equals (or
    sits within ``RASTER_MIN_MOVE`` of) the output with the uncondition
    colour, or is not finite."""
    base = torch.linspace(1.0, 2.0, 64)
    direction = torch.ones(64) / 8.0  # unit norm
    moved = base + move * base.norm() * direction
    assert smoke.RASTER_MIN_MOVE == 1e-3
    if ok:
        got = smoke.check_moves(moved, base, "made-up", "the rasters")
        assert got == pytest.approx(move, rel=1e-4)
    else:
        with pytest.raises(SystemExit):
            smoke.check_moves(moved, base, "made-up", "the rasters")


class _FakeOptimizer:
    def __init__(self, dtype, sizes=(6, 10)):
        self.state = {i: {"step": torch.tensor(3.0),
                          "exp_avg": torch.zeros(n, dtype=dtype),
                          "exp_avg_sq": torch.zeros(n, dtype=dtype)}
                      for i, n in enumerate(sizes)}


@pytest.mark.parametrize("dtype,want,ok", [
    (torch.bfloat16, 2, True), (torch.float32, 4, True),
    (torch.float32, 2, False), (torch.bfloat16, 4, False)])
def test_moment_bytes_gate(smoke, dtype, want, ok):
    """The bm train phase's optimizer state must hold 2 bytes a moment
    element (bf16), the nwao phase's 4; the step counters do not count."""
    n_bytes, n_elems = smoke.moment_census(_FakeOptimizer(dtype))
    assert n_elems == 2 * 16
    assert n_bytes == n_elems * torch.finfo(dtype).bits // 8
    if ok:
        smoke.check_moment_bytes(n_bytes, n_elems, want, "made-up")
    else:
        with pytest.raises(SystemExit):
            smoke.check_moment_bytes(n_bytes, n_elems, want, "made-up")
    with pytest.raises(SystemExit):  # no moments at all
        smoke.check_moment_bytes(0, 0, want, "made-up")


def test_random_init_draws_the_adapter_nonzero(smoke):
    """Without it the zero convs and gates stay zero, the adapter adds
    nothing, and every check of it passes vacuously."""
    from opendwm_tpu_torch.models.adapters import ImageAdapter

    adapter = ImageAdapter(in_channels=6, channels=[8, 8],
                           is_downblocks=[True, False], num_res_blocks=1,
                           downscale_factor=2, use_zero_convs=True,
                           zero_gate_coef=1.0)
    smoke.random_init_(adapter, torch.Generator().manual_seed(0))
    assert all(c.weight.abs().min() > 0 for c in adapter.zero_convs)
    assert adapter.zero_gates.abs().min() > 0
    feats = adapter(torch.rand(1, 8, 8, 6))
    assert all(f.abs().max() > 0 for f in feats)


@pytest.mark.parametrize("readies,ok", [
    ([False] * 5 + [True] * 7, True),
    ([False] * 6 + [True] * 6, False),   # ready one tick late
    ([False] * 4 + [True] * 8, False),   # ready before the window is full
    ([False] * 5 + [True, False] + [True] * 5, False),
])
def test_ready_schedule(smoke, readies, ok):
    """``ready`` is False while the 6 ticks fill the queue, True from the
    6th on."""
    if ok:
        smoke.check_ready_schedule(readies, 6)
    else:
        with pytest.raises(SystemExit):
            smoke.check_ready_schedule(readies, 6)


@pytest.mark.parametrize("errs,ok", [
    ({"encoder_hidden_states": 0.017, "pooled_projections": 0.013}, True),
    ({"encoder_hidden_states": 0.017, "pooled_projections": 0.031}, False),
    ({"encoder_hidden_states": float("nan")}, False),
])
def test_text_bar(smoke, errs, ok):
    """The bf16 text stage within 3e-2 in relative norm of the fp32 one,
    on every output; a NaN fails."""
    assert smoke.TEXT_REL_TOL == 3e-2
    if ok:
        smoke.check_text_bar(errs)
    else:
        with pytest.raises(SystemExit):
            smoke.check_text_bar(errs)


def _stream_counts(**over) -> dict:
    forwards = 120
    counts = {"flash_tail_by_seq": {602: 2880, 448: 1560, 168: 720},
              "adaln_modulate": 62 * forwards,
              "residual_adaln_modulate": 47 * forwards,
              "flash_attention": 0, "flash_attention_segment": 0}
    counts.update(over)
    return counts


@pytest.mark.parametrize("over,ok", [
    ({}, True),
    ({"flash_tail_by_seq": {602: 2880, 448: 1560}}, False),
    ({"adaln_modulate": 62 * 120 - 1}, False),
    ({"residual_adaln_modulate": 46 * 120}, False),
    ({"flash_attention": 1}, False),     # the text encoders reached K7
    ({"flash_attention_segment": 2}, False),
])
def test_stream_census(smoke, over, ok):
    """The stream path's launches: K1 at s = 602, 448 and 168, K3 62 and
    K4 47 a DiT forward, no K7 and no K7-seg."""
    if ok:
        smoke.check_stream_census(_stream_counts(**over), 120)
    else:
        with pytest.raises(SystemExit):
            smoke.check_stream_census(_stream_counts(**over), 120)


def test_text_init_draws_the_reference_scales(smoke):
    """``text_init_`` draws CLIP and T5 weights in the scales of their
    reference initializers: norms 1, biases 0, T5's q at 1/sqrt(d d_kv)."""
    from opendwm_tpu_torch.models import text_encoders as te

    g = torch.Generator().manual_seed(0)
    clip = te.CLIPTextEncoder(vocab_size=500, hidden_size=64, num_layers=2,
                              num_heads=4, projection_dim=32)
    t5 = te.T5TextEncoder(vocab_size=500, d_model=64, d_kv=16, d_ff=128,
                          num_layers=2, num_heads=4)
    for m in (clip, t5):
        smoke.text_init_(m, g)
    assert (clip.layers[0].layer_norm1.weight == 1).all()
    assert (clip.layers[0].self_attn.q_proj.bias == 0).all()
    assert (t5.block[1].ln_ff.weight == 1).all()
    for p, std in ((clip.token_embedding.weight, 0.02),
                   (clip.layers[1].self_attn.k_proj.weight,
                    64 ** -0.5 * 4 ** -0.5),
                   (clip.layers[0].fc1.weight, 128 ** -0.5),
                   (t5.shared.weight, 1.0),
                   (t5.block[0].attention.q.weight, (64 * 16) ** -0.5),
                   (t5.block[1].wo.weight, 128 ** -0.5)):
        assert abs(p.std().item() / std - 1) < 0.1, (p.shape, std)


def test_tiny_stream_dit_reaches_k1(smoke):
    """The tiny streaming check's DiT builds (its adapter as wide as its
    tokens) and its joint attention, 96 latent + 40 text tokens, is a
    shape the tail kernel takes."""
    from opendwm_tpu_torch.models.mmdit import DiTCrossviewTemporal

    model = DiTCrossviewTemporal(**smoke.TINY_STREAM_DIT)
    assert model.inner_dim == 32
    assert flash_tail.supported(96 + 40, 96 + 40, 16)


def _lidar_dit_counts(**over) -> dict:
    """The LiDAR DiT path's counts over 4 CFG forwards, as they should be."""
    shape = "80,240,16,64"
    counts = {
        "flash_tail": 32, "flash_tail_by_shape": {shape: 32},
        "flash_tail_sm90_by_shape": {shape: 32},
        "adaln_modulate": 132, "adaln_modulate_fixed": 0,
        "adaln_modulate_by_shape": {"12,1600,1024": 68, "12,1,1024": 64},
        "residual_adaln_modulate": 124, "residual_adaln_modulate_fixed": 0,
        "residual_adaln_modulate_by_shape": {"12,1600,1024": 64,
                                             "12,1,1024": 60},
        "flash_attention": 0, "flash_attention_segment": 0}
    counts.update(over)
    return counts


@pytest.mark.parametrize("over,ok", [
    ({}, True),
    ({"flash_tail": 31}, False),
    ({"flash_tail_sm90_by_shape": {"80,240,16,64": 31}}, False),
    ({"flash_tail_by_shape": {"80,240,16,64": 31, "80,256,16,64": 1}},
     False),
    ({"adaln_modulate_fixed": 1}, False),
    ({"residual_adaln_modulate_fixed": 124}, False),
    ({"residual_adaln_modulate_by_shape": {"12,1600,1024": 124}}, False),
    ({"residual_adaln_modulate": 120}, False),
    ({"flash_attention": 1}, False),
])
def test_lidar_dit_census(smoke, over, ok):
    """The LiDAR DiT path: K1 8 a CFG forward, all at (80, 240, 16, 64) on
    the Hopper forward; K3 33 and K4 31 a forward, all on the
    runtime-width kernel at both d-1024 shapes; no K7. The path is a model
    path but not a d-1536 one."""
    assert "lidar_dit" in smoke.MODEL_PATHS
    assert "lidar_dit" not in smoke.DIT_PATHS
    assert smoke.LIDAR_K1_SHAPE + (64,) == (80, 240, 16, 64)
    if ok:
        smoke.check_lidar_dit_census(_lidar_dit_counts(**over), 4)
    else:
        with pytest.raises(SystemExit):
            smoke.check_lidar_dit_census(_lidar_dit_counts(**over), 4)


def test_lidar_census_counts_follow_the_config(smoke):
    """K1/K3/K4 a CFG forward of the LiDAR DiT, from its config: one K1 a
    temporal branch, K3 two a joint block plus ``norm_out``, K4 one a
    block plus one a block that is not ``context_pre_only``; the d-1024
    shapes at CFG batch 2 x 6 frames of 40 x 40 patches."""
    import json

    cfg = json.loads(smoke.LIDAR_DIT_CONFIG.read_text())["pipeline"]["model"]
    layers = cfg["num_layers"]
    assert smoke.LIDAR_K1_PER_FORWARD == len(cfg["temporal_block_layers"])
    assert smoke.LIDAR_K3_PER_FORWARD == 2 * layers + 1
    assert smoke.LIDAR_K4_PER_FORWARD == 2 * layers - 1
    width = cfg["attention_head_dim"] * cfg["num_attention_heads"]
    gw = cfg["sample_size"] // cfg["patch_size"]
    n = 2 * smoke.LIDAR_DIT_FRAMES
    assert smoke.LIDAR_ADALN_SHAPES == ((n, gw * gw, width), (n, 1, width))
    assert smoke.LIDAR_K1_SHAPE == (2 * gw, smoke.LIDAR_DIT_FRAMES * gw,
                                    cfg["num_attention_heads"])


@pytest.mark.parametrize("over,ok", [
    ({}, True),
    ({"logits_rel": 2e-3}, False),
    ({"encoder_rel": float("nan")}, False),
    ({"voxels_equal": False}, False),
    ({"pipeline_ids_nonnegative": False}, False),
    ({"kernel_launches": 1}, False),
    ({"pipeline_ids_equal_share": 0.9}, True),  # reported, not gated
    ({"boundary_voxels_equal": False}, False),
    ({"boundary_reciprocal_flips": 0}, False),  # the points see nothing
    ({"indices_equal_share": 0.98, "index_flip_gap": 5e-7}, True),  # a tie
    ({"indices_equal_share": 0.98, "index_flip_gap": 2e-6}, False),
])
def test_lidar_tiny_gaps_gate(smoke, over, ok):
    gaps = {"voxels_equal": True, "boundary_voxels_equal": True,
            "boundary_reciprocal_flips": 4, "encoder_rel": 1e-6,
            "indices_equal_share": 1.0, "index_flip_gap": 0.0,
            "logits_rel": 1e-6, "decoder_rel": 1e-6,
            "pipeline_ids_equal_share": 1.0, "pipeline_ids_nonnegative": True,
            "kernel_launches": 0, **over}
    if ok:
        smoke.check_lidar_tiny_gaps(gaps, "MaskGIT")
    else:
        with pytest.raises(SystemExit):
            smoke.check_lidar_tiny_gaps(gaps, "MaskGIT")


@pytest.mark.parametrize("k1,ok", [(8, True), (0, False)])
def test_lidar_tiny_dit_gate_needs_k1(smoke, k1, ok):
    gaps = {"dit_rel": 1e-6, "dit_k1_launches": k1,
            "reference_latents_rel": 1e-6, "latents_rel": 1e-6,
            "voxels_equal_share": 1.0}
    if ok:
        smoke.check_lidar_tiny_gaps(gaps, "rowwise DiT")
    else:
        with pytest.raises(SystemExit):
            smoke.check_lidar_tiny_gaps(gaps, "rowwise DiT")


@pytest.mark.parametrize("wrong", [None, "argmin", "last_chunk"])
@pytest.mark.parametrize("cosine", [False, True])
def test_code_search_gate(smoke, monkeypatch, cosine, wrong):
    """``check_nearest`` on ``lidar_tiny.nearest_gaps`` over 7 chunks:
    passes the quantizer as it is, fails one whose search picks the
    second-best code of a row or skips the last chunk's rows."""
    from opendwm_tpu_torch.models import vq_point_cloud as tvq
    from opendwm_tpu_torch.perf import lidar_tiny

    q = tvq.VectorQuantizer(300, 16, cosine_similarity=cosine)
    g = torch.Generator().manual_seed(int(cosine))
    with torch.no_grad():
        q.embedding.normal_(0, 0.25, generator=g)
    flat = torch.randn(200, 16, generator=g) * 0.25
    monkeypatch.setattr(tvq, "QUANTIZER_CHUNK_ELEMS", 300 * 30)
    nearest = q.nearest

    def broken(z, codes):  # only the chunked call
        idx = nearest(z, codes)
        if tvq.QUANTIZER_CHUNK_ELEMS == 300 * 30 and wrong == "argmin":
            s = lidar_tiny.code_scores(cosine, z[:1], codes.double())
            idx[0] = s.topk(2).indices[0, 1]
        if tvq.QUANTIZER_CHUNK_ELEMS == 300 * 30 and wrong == "last_chunk":
            idx[180:] = 0
        return idx

    monkeypatch.setattr(q, "nearest", broken)
    gaps = lidar_tiny.nearest_gaps(q, flat)
    assert gaps["chunks"] == 7
    if wrong is None:
        assert gaps["rows_differ"] == 0
        smoke.check_nearest(gaps, "tiny")
    else:
        with pytest.raises(SystemExit):
            smoke.check_nearest(gaps, "tiny")


@pytest.mark.parametrize("case,ok", [("ok", True), ("masked", False),
                                     ("not_binary", False)])
def test_lidar_outputs_gate(smoke, case, ok):
    ids = torch.zeros(1, 3, 16, dtype=torch.long)
    vox = torch.tensor([0.0, 1.0, 1.0])
    if case == "masked":
        ids[0, 1, 3] = -1
    elif case == "not_binary":
        vox[0] = 0.5
    if ok:
        smoke.check_lidar_outputs({"pred_voxels": vox}, ids, "lidar")
    else:
        with pytest.raises(SystemExit):
            smoke.check_lidar_outputs({"pred_voxels": vox}, ids, "lidar")


def test_random_init_sets_the_rotary_frequencies(smoke):
    """The MaskGIT rotary frequencies are drawn at their init, not zeroed
    as other 1-D parameters that are no norm scale."""
    from opendwm_tpu_torch.models.maskgit import TemporalTransformerBlock

    block = TemporalTransformerBlock(32, 2, 16)
    want = block.rope.freqs.detach().clone()
    with torch.no_grad():
        block.rope.freqs.zero_()
    smoke.random_init_(block, torch.Generator().manual_seed(0))
    torch.testing.assert_close(block.rope.freqs.detach(), want)


class _Span:
    def __init__(self, start, end):
        self.start, self.end = start, end

    def elapsed_us(self):
        return self.end - self.start


class _Event:
    def __init__(self, name, start, end, annotation=False):
        from torch.autograd import DeviceType

        self.name, self.device_type = name, DeviceType.CUDA
        self.time_range = _Span(start, end)
        self.is_user_annotation = annotation


def test_range_split_counts_kernels_inside_the_spans():
    """``range_device_ms`` sums the kernels that ran inside the GPU-side
    spans of a range (each once) and nothing outside them; ``int8_split``
    splits by the same rule, the int8 GEMM's kernels apart wherever they
    ran."""
    from types import SimpleNamespace

    from opendwm_tpu_torch.perf.exp_int8_fidelity import RANGE, int8_split
    from opendwm_tpu_torch.perf.measure import range_device_ms

    def events(name):
        return [_Event(name, 100, 200),
                _Event("gemm", 110, 150), _Event("softmax", 150, 190),
                _Event("gemm", 210, 260),
                _Event(name, 300, 350),
                _Event("gemm", 305, 345), _Event("other", 340, 360),
                _Event("annotation", 301, 302, annotation=True)]

    prof = SimpleNamespace(events=lambda: events("plain_attention"))
    ms, n = range_device_ms(prof, "plain_attention")
    assert n == 3 and ms == pytest.approx((40 + 40 + 40) / 1e3)

    int_mm = SimpleNamespace(name="aten::_int_mm", device_type=None,
                             kernels=[SimpleNamespace(name="gemm")])
    prof = SimpleNamespace(events=lambda: events(RANGE) + [int_mm])
    split = int8_split(prof)
    assert split["int8_gemm"] == {"ms": pytest.approx(0.13), "kernels": 3}
    assert split["quant_dequant"] == {"ms": pytest.approx(0.04),
                                      "kernels": 1}
    assert split["other"] == {"ms": pytest.approx(0.02), "kernels": 1}


def test_rollout_sampling_in_chunks_is_unchunked(monkeypatch):
    """The temporal MaskGIT's decode with the categorical step cut into
    chunks of 5 rows gives the codes of one chunk, from one generator
    seed (the chunks draw their noise in row order)."""
    from opendwm_tpu_torch.perf import lidar_tiny
    from opendwm_tpu_torch.pipelines import lidar_maskgit

    pipe = lidar_tiny.tiny_maskgit(temporal=True)
    batch = lidar_tiny.lidar_batch(torch.Generator().manual_seed(0), 3, 128)
    runs = []
    for chunk in (lidar_maskgit.SAMPLE_CHUNK_ELEMS, 5 * lidar_tiny.N_E):
        monkeypatch.setattr(lidar_maskgit, "SAMPLE_CHUNK_ELEMS", chunk)
        runs.append(pipe.autoregressive_inference_pipeline(
            batch, generator=torch.Generator().manual_seed(1),
            num_reference_frame=1, window_frames=2))
    assert torch.equal(runs[0]["pred_indices"], runs[1]["pred_indices"])
    assert torch.equal(runs[0]["pred_voxels"], runs[1]["pred_voxels"])
    assert (runs[0]["pred_indices"] >= 0).all()


def test_tiny_lidar_dit_reaches_k1():
    """The tiny rowwise DiT of the LiDAR DiT phase's card check: its
    rowwise temporal sequences (t·gw tokens, 64-wide heads) are a shape
    K1 takes and K7 does not (the dispatch tries K7 first)."""
    from opendwm_tpu_torch.ops import flash_attention
    from opendwm_tpu_torch.perf import lidar_tiny

    cfg = lidar_tiny.ROWWISE_DIT
    seq = lidar_tiny.ROWWISE_FRAMES * (lidar_tiny.ROWWISE_LATENT[1]
                                       // cfg["patch_size"])
    assert cfg["temporal_attention_type"] == "rowwise"
    assert flash_tail.supported(seq, seq, cfg["attention_head_dim"])
    assert not flash_attention.supported(seq, seq, cfg["attention_head_dim"])


# -- UniMLVG, the branch types, MaskGWM and the temporal VAE (phases 15-18) --

def _unimlvg_counts(**over) -> dict:
    """The launch census of phase 15's rollout (8 CFG forwards) as the
    card gave it."""
    counts = {
        "flash_tail": 344, "flash_tail_sm90": 344, "flash_attention": 0,
        "flash_tail_by_seq": {602: 192, 448: 104, 168: 48},
        "flash_tail_by_shape": {"72,602,24,64": 192, "72,448,24,64": 104,
                                "192,168,24,64": 48},
        "adaln_modulate": 496, "residual_adaln_modulate": 376,
        "adaln_modulate_by_shape": {"72,448,1536": 304, "72,154,1536": 192},
        "residual_adaln_modulate_by_shape": {"72,448,1536": 192,
                                             "72,154,1536": 184}}
    counts.update(over)
    return counts


@pytest.mark.parametrize("over,ok", [
    ({}, True),
    ({"flash_tail_by_shape": {"72,448,24,64": 104, "192,168,24,64": 48}},
     False),
    ({"flash_tail_by_seq": {602: 192, 448: 104}}, False),
    ({"adaln_modulate": 495}, False),
    ({"residual_adaln_modulate": 377}, False),
    ({"adaln_modulate_by_shape": {"72,448,1536": 496},
      "residual_adaln_modulate_by_shape": {"72,448,1536": 376}}, False),
])
def test_unimlvg_census(smoke, over, ok):
    """Phase 15: K1 at (72, 602, 24, 64) and at s 448 and 168, K3 62 and
    K4 47 a CFG forward at both (72, 448 | 154, 1536) shapes."""
    if ok:
        smoke.check_unimlvg_census(_unimlvg_counts(**over), 8, "made-up")
    else:
        with pytest.raises(SystemExit):
            smoke.check_unimlvg_census(_unimlvg_counts(**over), 8,
                                       "made-up")


def test_branch_k7_shapes_follow_the_geometry(smoke):
    """Each branch type's K7 shape from the geometry at the CFG batch (2 x
    6 frames x 6 views of 16 x 28 patches) and its launches from the
    UniMLVG config's branch layers; every shape a K7 shape and in phase
    3's list."""
    import json

    from opendwm_tpu_torch.ops import flash_attention

    model = json.loads(smoke.UNIMLVG_CONFIG.read_text())["pipeline"]["model"]
    b, t, v = 2, smoke.FRAMES, smoke.VIEWS
    l = (smoke.LAT_H // 2) * (smoke.LAT_W // 2)
    want = {"crossview_full": ((b * t, v * l),
                               len(model["crossview_block_layers"])),
            "crossview_fuse": ((b * v, t * 3 * l),
                               len(model["crossview_block_layers"])),
            "crossview_adj_fuse": ((b * t * v, 2 * 3 * l),
                                   len(model["crossview_block_layers"])),
            "temporal_full": ((b * v, t * l),
                              len(model["temporal_block_layers"]))}
    assert {k: (shape, n) for k, (_, _, shape, n)
            in smoke.BRANCH_K7.items()} == want
    assert {shape for shape, _ in want.values()} == \
        set(smoke.DIT_K7_SHAPES)
    for _, s in smoke.DIT_K7_SHAPES:
        assert flash_attention.supported(s, s, 64)
    for name, (attr, kind, _, _) in smoke.BRANCH_K7.items():
        assert attr.split("_")[0] == name.split("_")[0] and \
            name.endswith(kind)


def test_mask_k1_shape_follows_the_defaults(smoke):
    """MaskGWM's defaults keep int(448 x 0.75) = 336 tokens a view-frame;
    with the 154 text tokens the joint attention of a batch-1 step is K1's
    (36, 490), its dual attention (36, 336); K3/K4 modulate (36, 336) and,
    from the first decoder layer, the fp32 (36, 448). Phase 3 holds each
    against its plain version."""
    from opendwm_tpu_torch.models.mask_layers import MaskController

    mc = MaskController(hidden_size=8, num_heads=2, attention_head_dim=4)
    l = (smoke.LAT_H // 2) * (smoke.LAT_W // 2)
    keep = mc.len_keep(l)
    n = smoke.FRAMES * smoke.VIEWS
    assert (mc.mask_ratio, mc.decode_layer, keep) == (0.25, 5, 336)
    assert smoke.MASK_ATTN_SHAPES == ((n, keep + smoke.TEXT_TOKENS, 24),
                                      (n, keep, 24))
    assert smoke.MASK_ADALN_SHAPE == (n, keep, 1536)
    assert smoke.MASK_ADALN_FP32_SHAPE == (n, l, 1536)
    assert set(smoke.MASK_ATTN_SHAPES) <= set(smoke.K1_CHECKED)
    assert set(smoke.MASK_ATTN_SHAPES) <= set(smoke.K2_CHECKED)
    assert {smoke.MASK_ADALN_SHAPE, smoke.MASK_ADALN_FP32_SHAPE} <= \
        set(smoke.ADALN_SHAPES)
    for _, s, _ in smoke.MASK_ATTN_SHAPES:
        assert flash_tail.supported(s, s, 64)
    assert keep % (smoke.LAT_H // 2) == 0  # whole rows for the branches


def _mask_counts(**over) -> dict:
    """The masked step's launch census as the card gave it."""
    counts = {"flash_tail": 77, "flash_tail_sm90": 77,
              "flash_tail_by_shape": {"36,490,24,64": 38,
                                      "36,336,24,64": 26,
                                      "36,448,24,64": 1,
                                      "36,602,24,64": 10,
                                      "96,168,24,64": 2},
              "flash_tail_backward": 39, "flash_tail_backward_sm90": 39,
              "flash_tail_backward_by_seq": {602: 5, 168: 1, 448: 1,
                                             490: 19, 336: 13},
              "adaln_modulate_by_shape": {"36,336,1536": 40,
                                          "36,448,1536": 12,
                                          "36,154,1536": 50},
              "residual_adaln_modulate_by_shape": {"36,336,1536": 38,
                                                   "36,448,1536": 10,
                                                   "36,154,1536": 46}}
    counts.update(over)
    return counts


_STREAM = [torch.bfloat16] * 19 + [torch.float32] * 5


@pytest.mark.parametrize("over,stream,loss,ok", [
    ({}, _STREAM, 1.3, True),
    ({"flash_tail_by_shape": {"36,490,24,64": 38, "36,336,24,64": 26,
                              "36,126,24,64": 4}}, _STREAM, 1.3, False),
    ({"flash_tail_by_shape": {"36,490,24,64": 38}}, _STREAM, 1.3, False),
    ({"flash_tail_backward_by_seq": {602: 5, 336: 13}}, _STREAM, 1.3,
     False),
    ({"flash_tail_backward_by_seq": {490: 19, 336: 13, 252: 2}}, _STREAM,
     1.3, False),
    ({"adaln_modulate_by_shape": {"36,448,1536": 12}}, _STREAM, 1.3, False),
    ({"residual_adaln_modulate_by_shape": {"36,336,1536": 38,
                                           "36,400,1536": 1}},
     _STREAM, 1.3, False),
    ({}, [torch.bfloat16] * 24, 1.3, False),
    ({}, [torch.float32] * 24, 1.3, False),
    ({}, _STREAM, float("nan"), False),
], ids=["ok", "k1-unchecked", "k1-missing", "k2-missing", "k2-unchecked",
        "k3-missing", "k4-unchecked", "stream-bf16", "stream-fp32",
        "loss-nan"])
def test_mask_step_gate(smoke, over, stream, loss, ok):
    """Phase 16's masked step: K1/K2 at both masked shapes and K3/K4 at
    the kept tokens' shape, none at a shape phase 3 did not check, the
    stream bf16 before block 19 and fp32 from it, a finite loss."""
    if ok:
        smoke.check_mask_step(_mask_counts(**over), stream, 19, loss)
    else:
        with pytest.raises(SystemExit):
            smoke.check_mask_step(_mask_counts(**over), stream, 19, loss)


@pytest.mark.parametrize("over,ok", [
    ({}, True),
    ({"inference_rel": 2e-3}, False),
    ({"rollout_rel": float("nan")}, False),
    ({"inference_k1_launches": 0}, False),
])
def test_tiny_gaps_gate(smoke, over, ok):
    gaps = {"inference_rel": 1e-6, "rollout_rel": 1e-6,
            "inference_k1_launches": 6, **over}
    tols = {"inference_rel": smoke.TINY_TOL, "rollout_rel": smoke.TINY_TOL}
    if ok:
        smoke.check_gaps(gaps, tols, "made-up")
    else:
        with pytest.raises(SystemExit):
            smoke.check_gaps(gaps, tols, "made-up")


@pytest.mark.parametrize("move,ok", [(0.0, False), (float("nan"), False),
                                     (5e-4, False), (0.2, True)])
def test_cameras_must_move_the_output(smoke, move, ok):
    base = torch.linspace(1.0, 2.0, 64)
    moved = base + move * base.norm() * torch.ones(64) / 8.0
    if ok:
        assert smoke.check_moves(moved, base, "made-up", "the cameras") == \
            pytest.approx(move, rel=1e-4)
    else:
        with pytest.raises(SystemExit):
            smoke.check_moves(moved, base, "made-up", "the cameras")


def test_merge_counts_adds_by_shape(smoke):
    a = {"flash_attention": 6, "flash_attention_by_shape": {"12,2688": 6}}
    b = {"flash_attention": 12, "flash_attention_by_shape": {"12,2688": 6,
                                                             "72,2688": 6}}
    assert smoke.merge_counts(smoke.merge_counts({}, a), b) == {
        "flash_attention": 18,
        "flash_attention_by_shape": {"12,2688": 12, "72,2688": 6}}


def test_tiny_unimlvg_paths_reach_their_kernels(smoke):
    """The card checks' tiny geometries: the UniMLVG DiT's joint attention
    is a K1 shape; each branch type's sequences are K7 shapes; the masked
    step's kept tokens fill whole rows, and its joint attention is a K1
    shape before and after the reconstruction."""
    from opendwm_tpu_torch.ops import flash_attention
    from opendwm_tpu_torch.perf import unimlvg_tiny as u

    h, w = u.LATENT
    joint = (h // 2) * (w // 2) + u.TEXT
    head = u.TINY_DIT["attention_head_dim"]
    assert flash_tail.supported(joint, joint, head)
    assert not flash_attention.supported(joint, joint, head)
    t, v = u.BRANCH_FRAMES, u.BRANCH_VIEWS
    l = (u.BRANCH_LATENT[0] // 2) * (u.BRANCH_LATENT[1] // 2)
    for s in (v * l, t * 3 * l, 2 * 3 * l, t * l):
        assert flash_attention.supported(s, s, head)
    assert set(u.BRANCH_TYPES) == set(smoke.BRANCH_K7)
    assert int(l * 0.75) % (u.BRANCH_LATENT[0] // 2) == 0
    l = (u.MASK_LATENT[0] // 2) * (u.MASK_LATENT[1] // 2)
    text = u.branch_inputs(torch.Generator())["encoder_hidden_states"]
    for s in (int(l * 0.75), l):  # before and after the reconstruction
        joint = s + text.shape[-2]
        assert flash_tail.supported(joint, joint, head)
    assert int(l * 0.75) % (u.MASK_LATENT[0] // 2) == 0


# -- LiDAR training and the LiDAR UNet (phases 19-22) ------------------------

def _lidar_dit_train_counts(**over) -> dict:
    """The census of 2 LiDAR DiT train steps: K1 16 and K2 8 a step at
    (160, 240, 16, 64), K3/K4 on the runtime-width kernel at the train
    batch's d-1024 shapes."""
    k1 = "160,240,16,64"
    counts = {
        "flash_tail": 32, "flash_tail_by_shape": {k1: 32},
        "flash_tail_backward": 16, "flash_tail_backward_by_shape": {k1: 16},
        "adaln_modulate": 132, "adaln_modulate_fixed": 0,
        "adaln_modulate_by_shape": {"24,1600,1024": 68, "24,1,1024": 64},
        "residual_adaln_modulate": 124, "residual_adaln_modulate_fixed": 0,
        "residual_adaln_modulate_by_shape": {"24,1600,1024": 64,
                                             "24,1,1024": 60},
        "flash_attention": 0, "flash_attention_backward": 0}
    counts.update(over)
    return counts


@pytest.mark.parametrize("over,ok", [
    ({}, True),
    ({"flash_tail_backward": 15}, False),
    ({"flash_tail": 8}, False),
    ({"flash_tail_by_shape": {"160,240,16,64": 31, "80,240,16,64": 1}},
     False),
    ({"flash_tail_backward_by_shape": {"160,256,16,64": 16}}, False),
    ({"adaln_modulate": 131}, False),  # not the same count every step
    ({"adaln_modulate": 40, "adaln_modulate_by_shape":
      {"24,1600,1024": 20, "24,1,1024": 20}}, False),  # under a forward's
    ({"residual_adaln_modulate_fixed": 2}, False),
    ({"adaln_modulate_by_shape": {"24,1600,1024": 132}}, False),
    ({"flash_attention_backward": 1}, False),
])
def test_lidar_dit_train_census(smoke, over, ok):
    """The LiDAR DiT train steps: K1 and K2 at (160, 240, 16, 64) only, K2
    8 a step, K3/K4 at the same count every step, at least a forward's,
    on the runtime-width kernel at both train shapes; no K7."""
    assert {"lidar_dit_train", "lidar_unet_train"} <= set(smoke.TRAIN_PATHS)
    assert {"lidar_dit_train", "lidar_unet_serve", "lidar_unet_train"} <= \
        set(smoke.MODEL_PATHS)
    assert "lidar_dit_train" not in smoke.DIT_PATHS
    if ok:
        smoke.check_lidar_dit_train_census(_lidar_dit_train_counts(**over), 2)
    else:
        with pytest.raises(SystemExit):
            smoke.check_lidar_dit_train_census(
                _lidar_dit_train_counts(**over), 2)


def test_lidar_train_shapes_follow_the_configs(smoke):
    """The train batch's K1/K2 and K3/K4 shapes from the LiDAR DiT config,
    the LiDAR UNet's K7 from its 80 x 80 latents; phase 3 holds each: K1
    and K2 at the DiT's train shape and K2 at the UNet's train shapes, K7
    and its backward at the UNet's train batch, K3/K4 at the train
    shapes."""
    import json

    cfg = json.loads(smoke.LIDAR_DIT_CONFIG.read_text())["pipeline"]["model"]
    gw = cfg["sample_size"] // cfg["patch_size"]
    b, t = smoke.LIDAR_DIT_TRAIN_BATCH, smoke.LIDAR_DIT_FRAMES
    width = cfg["attention_head_dim"] * cfg["num_attention_heads"]
    assert smoke.LIDAR_DIT_TRAIN_K1_SHAPE == (b * gw, t * gw,
                                              cfg["num_attention_heads"])
    assert smoke.LIDAR_TRAIN_ADALN_SHAPES == ((b * t, gw * gw, width),
                                              (b * t, 1, width))
    assert smoke.LIDAR_DIT_TRAIN_K1_SHAPE in smoke.K1_CHECKED
    assert smoke.LIDAR_DIT_TRAIN_K1_SHAPE in smoke.K2_CHECKED
    assert set(smoke.LIDAR_UNET_K1_TRAIN) <= set(smoke.K2_CHECKED)
    unet = json.loads(smoke.LIDAR_UNET_CONFIG.read_text())["pipeline"]
    side = unet["autoencoder"]["lidar_encoder"]["img_size"] // \
        unet["autoencoder"]["lidar_encoder"]["patch_size"]
    heads = unet["model"]["num_attention_heads"][0]
    frames = smoke.LIDAR_UNET_FRAMES
    assert smoke.LIDAR_UNET_K7_SERVE == (2 * frames, side * side,
                                         side * side, heads)
    assert smoke.LIDAR_UNET_K7_TRAIN == (smoke.LIDAR_UNET_BATCH * frames,
                                         side * side, side * side, heads)
    assert smoke.LIDAR_UNET_K7_TRAIN + (False,) in smoke.K7_SHAPES
    assert smoke.LIDAR_UNET_K7_TRAIN + (False,) in smoke.K7_BWD_SHAPES
    # the rowwise temporal branch at level 0: rows x (frames x row)
    assert smoke.LIDAR_UNET_K1_SERVE[0] == (2 * side, frames * side, heads)
    assert smoke.LIDAR_UNET_K1_TRAIN[0] == (
        smoke.LIDAR_UNET_BATCH * side, frames * side, heads)


@pytest.mark.parametrize("over,ok", [
    ({}, True),
    ({"flash_tail_by_shape": {"320,320,5,64": 1}}, False),  # one missing
    ({"flash_attention_by_shape": {"16,6400,6400,5,64": 5,
                                   "8,6400,6400,5,64": 1}}, False),
    ({"flash_tail_backward_by_shape": {}}, False),
    ({"adaln_modulate": 1}, False),
])
def test_lidar_unet_census(smoke, over, ok):
    """The LiDAR UNet's train census: K1 and K2 at exactly the three
    train shapes, K7 and its backward at (16, 6400, 6400, 5, 64), no
    K3/K4; a by-shape count of 0 does not count as launched."""
    k1 = {",".join(map(str, s + (64,))): 5 for s in smoke.LIDAR_UNET_K1_TRAIN}
    k7 = {"16,6400,6400,5,64": 5}
    base = {"flash_tail_by_shape": k1,
            "flash_tail_backward_by_shape": dict(k1),
            "flash_attention_by_shape": k7,
            "flash_attention_backward_by_shape": dict(k7),
            "adaln_modulate": 0, "residual_adaln_modulate": 0}
    args = ("lidar unet train", smoke.LIDAR_UNET_K1_TRAIN,
            smoke.LIDAR_UNET_K7_TRAIN, True)
    if ok:
        smoke.check_lidar_unet_census({**base, **over}, *args)
    else:
        with pytest.raises(SystemExit):
            smoke.check_lidar_unet_census({**base, **over}, *args)
    zero = dict(base, flash_tail_by_shape={**k1, "8,400,20,64": 0})
    smoke.check_lidar_unet_census(zero, *args)


def test_lidar_unet_may_stay_names_the_parameters_without_gradient(smoke):
    """``LIDAR_UNET_MAY_STAY`` matches the LiDAR UNet's added-time
    embedding and each cross-attention's ``norm2`` bias, nothing else."""
    import json
    import re

    from opendwm_tpu_torch.config import create_instance_from_config

    cfg = json.loads(smoke.LIDAR_UNET_CONFIG.read_text())["pipeline"]
    with torch.device("meta"):
        model = create_instance_from_config(cfg["model"])
    names = [n for n, _ in model.named_parameters()]
    stay = [n for n in names
            if any(re.search(p, n) for p in smoke.LIDAR_UNET_MAY_STAY)]
    assert {n for n in stay if n.startswith("add_embedding.")} == {
        n for n in names if n.startswith("add_embedding.")}
    others = [n for n in stay if not n.startswith("add_embedding.")]
    assert others and all(n.endswith("norm2.bias") for n in others)
    assert len(stay) < 0.05 * len(names)


# -- the data phase (23) ------------------------------------------------------

def test_data_phase_trains_at_the_lidar_unet_train_shapes(smoke):
    """The data path is a training path whose batches (the config's
    batch of its reader's sequence length) give the LiDAR UNet's train
    shapes, which phases 3 and 22 hold: its launch gate is phase 22's."""
    import json

    cfg = json.loads(smoke.LIDAR_UNET_CONFIG.read_text())
    assert "lidar_unet_data" in smoke.TRAIN_PATHS
    assert "lidar_unet_data" in smoke.MODEL_PATHS
    assert cfg["batch_size"] == smoke.LIDAR_UNET_BATCH
    assert cfg["training_dataset"]["sequence_length"] == \
        smoke.LIDAR_UNET_FRAMES
    assert cfg["training_dataset"]["sensor_channels"] == ["LIDAR_TOP"]
    assert set(smoke.RASTER_SETTINGS) <= set(cfg["training_dataset"])
    assert smoke.DATA_STEPS >= 3 and smoke.DATA_WORKERS == 4


@pytest.mark.parametrize("over,ok", [
    ({}, True),
    ({"flash_attention_by_shape": {"16,6400,6400,5,64": 15,
                                   "4,6400,6400,5,64": 1}}, False),
    ({"flash_attention_backward_by_shape": {}}, False),
    ({"flash_tail_backward_by_shape": {"320,320,5,64": 3}}, False),
    ({"flash_tail_by_shape": {"320,320,5,64": 9, "160,160,10,64": 9,
                              "16,400,20,64": 9, "8,400,20,64": 1}}, False),
    ({"residual_adaln_modulate": 2}, False),
])
def test_data_phase_launch_gate(smoke, over, ok):
    """K7 and its backward at (16, 6400, 6400, 5, 64) only, K1 and K2 at
    the three train shapes only, no K3/K4: a launch at any other shape,
    or a kernel that never launched, fails the phase."""
    k1 = {",".join(map(str, s + (64,))): 9 for s in smoke.LIDAR_UNET_K1_TRAIN}
    k7 = {"16,6400,6400,5,64": 15}
    counts = {"flash_tail_by_shape": k1,
              "flash_tail_backward_by_shape": dict(k1),
              "flash_attention_by_shape": k7,
              "flash_attention_backward_by_shape": dict(k7),
              "adaln_modulate": 0, "residual_adaln_modulate": 0, **over}
    args = ("data train", smoke.LIDAR_UNET_K1_TRAIN,
            smoke.LIDAR_UNET_K7_TRAIN, True)
    if ok:
        smoke.check_lidar_unet_census(counts, *args)
    else:
        with pytest.raises(SystemExit):
            smoke.check_lidar_unet_census(counts, *args)


GOOD_PARITY = {"native": True, "scan_equal": True, "inflated": 51,
               "inflate_mismatches": 0, "decoded": 80, "decode_mismatches": 0,
               "voxelize_equal": True, "entries": 51, "voxels": 18532}


@pytest.mark.parametrize("over,ok", [
    ({}, True),
    ({"voxelize_equal": None}, True),  # no grid asked for
    ({"native": False}, False),
    ({"scan_equal": False}, False),
    ({"inflate_mismatches": 1}, False),
    ({"decode_mismatches": 2}, False),
    ({"decoded": 0}, False),
    ({"inflated": 0}, False),
    ({"voxelize_equal": False}, False),
])
def test_native_parity_gate(smoke, over, ok):
    if ok:
        smoke.check_native_parity({**GOOD_PARITY, **over}, "data")
    else:
        with pytest.raises(SystemExit):
            smoke.check_native_parity({**GOOD_PARITY, **over}, "data")


def test_native_parity_sees_a_wrong_library(smoke, tmp_path, monkeypatch):
    """``perf/data_plane.native_parity`` on an archive, with the native
    decode made to drop a point: the gate fails."""
    import numpy as np

    from opendwm_tpu_torch import native
    from opendwm_tpu_torch.perf import data_plane, nuscenes_fixture

    info = nuscenes_fixture.write_archive(tmp_path, samples=2, points=300,
                                          boxes=2)
    data = open(info["archive"], "rb").read()
    smoke.check_native_parity(data_plane.native_parity(
        data, (-50, -50, -3, 50, 50, 2.6)), "data")
    decode = native.decode_lidar_bin

    def wrong(raw, stride=5, max_points=32768, pc_range=None,
              use_native=None):
        pts, mask = decode(raw, stride, max_points, pc_range, use_native)
        if use_native:
            mask = mask.copy()
            mask[np.flatnonzero(mask)[-1]] = False
        return pts, mask

    monkeypatch.setattr(native, "decode_lidar_bin", wrong)
    with pytest.raises(SystemExit):
        smoke.check_native_parity(data_plane.native_parity(
            data, (-50, -50, -3, 50, 50, 2.6)), "data")


def _items():
    import numpy as np
    from PIL import Image

    return [{"fps": np.float32(2), "pts": np.arange(4, dtype=np.float32),
             "lidar_points": np.ones((2, 5, 3), np.float32),
             "3dbox_bev_images": [Image.new("RGB", (4, 4), (0, 0, 255))],
             "scene": "scene-0001"} for _ in range(2)]


def _changed(what):
    import numpy as np
    from PIL import Image

    items = _items()
    if what == "value":
        items[1]["lidar_points"][1, 2, 0] = np.nextafter(np.float32(1), 2)
    elif what == "dtype":
        items[0]["pts"] = items[0]["pts"].astype(np.float64)
    elif what == "order":
        items[1] = dict(reversed(list(items[1].items())))
    elif what == "pixel":
        img = Image.new("RGB", (4, 4), (0, 0, 255))
        img.putpixel((3, 3), (0, 0, 254))
        items[1]["3dbox_bev_images"] = [img]
    elif what == "scalar":
        items[0]["fps"] = np.float64(2)
    elif what == "string":
        items[0]["scene"] = "scene-0002"
    elif what == "count":
        items = items[:1]
    return items


@pytest.mark.parametrize("what,ok", [
    (None, True), ("value", False), ("dtype", False), ("order", False),
    ("pixel", False), ("scalar", False), ("string", False),
    ("count", False),
])
def test_items_equal_gate(smoke, what, ok):
    """Items through the two filesystems must agree key for key, in order,
    and bit for bit: one ulp of one point, a dtype, one pixel fail."""
    if ok:
        smoke.check_items_equal(_changed(what), _items(), "data")
    else:
        with pytest.raises(SystemExit):
            smoke.check_items_equal(_changed(what), _items(), "data")


@pytest.mark.parametrize("over,ok", [
    ({}, True),
    ({"sd_loss": float("nan")}, False),
    ({"sd_loss": float("inf")}, False),
    ({"data_wait_s": None}, False),
    ({"step_s": None}, False),
    ({"sd_loss": None}, False),  # no loss logged
])
def test_cli_events_gate(smoke, over, ok):
    def event(step):
        e = {"step": step, "sd_loss": 0.5, "grad_norm": 2.0, "lr": 1e-4,
             "s_per_step": 1.2, "step_s": 1.2, "data_wait_s": 1e-4}
        if step == 2:
            e.update(over)
        return {k: v for k, v in e.items() if v is not None}

    events = [event(s) for s in (1, 2, 3)]
    if ok:
        smoke.check_cli_events(events, 3, "data")
    else:
        with pytest.raises(SystemExit):
            smoke.check_cli_events(events, 3, "data")
    with pytest.raises(SystemExit):  # a step missing
        smoke.check_cli_events(events[:2], 3, "data")
