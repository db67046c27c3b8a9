"""The port's weight-landing and evaluation CLIs on the CPU
(``--device cpu``), at tiny sizes.

- ``evaluate`` on ``configs/ctsd/ctsd_35_6views_video_synthetic.json``
  (1 batch), then again with ``--checkpoint`` after a 2-step train run:
  finite, logged, the checkpoint's weights used.
- ``preview`` over a preview dataset with a VAE landed by ``convert_cli``.
- ``convert_cli`` for every kind (bf16 for one): its file loads strictly
  into the port model.
- ``run_all``: in test_torch_run_all.py.
- The train CLI with ``--evaluation-steps``, ``--preview-steps``,
  ``--profile-steps`` and ``vae_checkpoint_path``.
- ``generation_example`` on ``examples/ctsd_generation_example.json``,
  with and without a landed checkpoint.
- ``perf/land_eval.frames_drill`` on small frames; ``--device cuda``
  raises without a card.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from opendwm_tpu_torch import checkpoint, convert_cli, evaluate
from opendwm_tpu_torch import generation_example, preview, run_all, train
from opendwm_tpu_torch.models.autoencoders import AutoencoderKL
from opendwm_tpu_torch.models.i3d import InceptionI3d
from opendwm_tpu_torch.models.inception import FIDInceptionV3
from opendwm_tpu_torch.models.mmdit import DiTCrossviewTemporal
from opendwm_tpu_torch.models.text_encoders import (
    CLIPTextEncoder,
    T5TextEncoder,
)
from opendwm_tpu_torch.models.unet import UNetCrossviewTemporal
from opendwm_tpu_torch.perf import land_eval

from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
SYNTHETIC = REPO / "configs/ctsd/ctsd_35_6views_video_synthetic.json"
EXAMPLE = REPO / "examples/ctsd_generation_example.json"


def _small_synthetic() -> dict:
    """The synthetic config cut as test_torch_train.py cuts it (2 blocks),
    batches of 2, one validation batch."""
    config = json.loads(SYNTHETIC.read_text())
    config["pipeline"]["model"].update(
        num_layers=2, dual_attention_layers=[0], crossview_block_layers=[0],
        temporal_block_layers=[1])
    config.update(batch_size=2, evaluation_batches=1)
    return config


def _events(out: Path) -> list:
    return [json.loads(line) for line in
            (out / "log" / "events.jsonl").read_text().splitlines()]


def test_evaluate_cli_and_checkpoint(tmp_path, capsys):
    out = tmp_path / "out"
    argv = ["-c", str(SYNTHETIC), "-o", str(out), "--device", "cpu",
            "--max-batches", "1"]
    first = evaluate.main(evaluate.create_parser().parse_args(argv))
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed.keys() == first.keys() == {"evaluation/fid_proxy"}
    assert np.isfinite(first["evaluation/fid_proxy"])
    assert _events(out) == [{"step": 0, **printed}]

    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(_small_synthetic()))
    train.main(train.create_parser().parse_args(
        ["-c", str(cfg), "-o", str(out), "--device", "cpu", "--max-steps",
         "2"]))
    argv = ["-c", str(cfg), "-o", str(out), "--device", "cpu",
            "--max-batches", "1"]
    fresh = evaluate.main(evaluate.create_parser().parse_args(argv))
    trained = evaluate.main(evaluate.create_parser().parse_args(
        argv + ["--checkpoint", "2"]))
    assert trained != fresh  # the checkpoint's weights, the same draws
    assert np.isfinite(trained["evaluation/fid_proxy"])
    assert _events(out)[-1]["step"] == 2


@pytest.fixture(scope="module")
def landed_vae(tmp_path_factory) -> Path:
    return land_eval.land_tiny_vae(tmp_path_factory.mktemp("vae"))


def test_preview_cli_with_a_landed_vae(tmp_path, landed_vae):
    config = land_eval.with_vae(_small_synthetic(), land_eval.TINY_VAE,
                                landed_vae)
    config["preview_dataset"] = dict(config["validation_dataset"], size=4)
    config["preview_collate_fn"] = config["validation_collate_fn"]
    config["batch_size"] = 2
    config["prompt_rewriting"] = {"mode": "add", "text": "at night"}
    cfg = land_eval.write_config(config, tmp_path / "cfg.json")
    paths = preview.main(preview.create_parser().parse_args(
        ["-c", str(cfg), "-o", str(tmp_path / "out"), "--device", "cpu",
         "--max-batches", "2"]))
    assert paths == [str(tmp_path / "out" / "preview" / f"{i}.gif")
                     for i in range(2)]
    from PIL import Image

    with Image.open(paths[0]) as im:
        # ground truth, box rasters and generation of 2 views, 64 x 64
        assert im.size == (2 * 64, 3 * 64) and im.n_frames == 2


def _convert_sources():
    torch.manual_seed(0)
    dit = DiTCrossviewTemporal(**run_all.DRY_DIT)
    unet = UNetCrossviewTemporal(**run_all.DRY_UNET, cross_attention_dim=32,
                                 enable_crossview=False,
                                 enable_temporal=False)
    return {
        "ctsd_dit": (dit, land_eval.reference_state_dict("ctsd_dit", dit),
                     ["--num-layers", "2"]),
        "ctsd_unet": (unet, land_eval.sd21_state_dict(unet.state_dict()),
                      []),
        "vae": (AutoencoderKL(block_out_channels=(16, 32)), None, []),
        "clip": (CLIPTextEncoder(**run_all.DRY_CLIP), None, []),
        "t5": (T5TextEncoder(**run_all.DRY_T5), None, []),
        "i3d": (InceptionI3d(), None, []),
        "fid_inception": (FIDInceptionV3(), None, []),
    }


@pytest.mark.parametrize("kind", sorted(convert_cli.CONVERTERS))
def test_convert_cli_every_kind(tmp_path, kind):
    model, sd, extra = _convert_sources()[kind]
    if sd is None:
        sd = land_eval.reference_state_dict(kind, model)
    if kind == "ctsd_unet":
        assert any(".resnets.0.conv1." in k for k in sd)  # SD2.1-era keys
    src = tmp_path / ("src.safetensors" if kind in ("clip", "i3d")
                      else "src.pth")
    if src.suffix == ".safetensors":
        from opendwm_tpu_torch.torch_import import write_safetensors

        write_safetensors(str(src), sd)
    else:
        torch.save(sd, src)
    dtype = ["--dtype", "bf16"] if kind == "t5" else []
    out = tmp_path / "out.pt"
    convert_cli.main(["--kind", kind, "--input", str(src), "--output",
                      str(out)] + extra + dtype)
    state = checkpoint.load_model_only(str(out))
    want = model.state_dict()
    assert state.keys() == want.keys()
    for k, v in want.items():
        got = state[k]
        assert got.dtype == (torch.bfloat16 if dtype else v.dtype), k
        assert torch.equal(got, v.to(got.dtype)), k
    model.load_state_dict(state, strict=True)


def test_train_cli_evaluates_previews_and_profiles(tmp_path, landed_vae):
    config = land_eval.with_vae(_small_synthetic(), land_eval.TINY_VAE,
                                landed_vae)
    cfg = land_eval.write_config(config, tmp_path / "cfg.json")
    out = tmp_path / "out"
    train.main(train.create_parser().parse_args(
        ["-c", str(cfg), "-o", str(out), "--device", "cpu", "--max-steps",
         "2", "--log-steps", "1", "--evaluation-steps", "2",
         "--preview-steps", "2", "--profile-steps", "1:1"]))
    events = _events(out)
    evals = [(e["step"], e["evaluation/fid_proxy"]) for e in events
             if "evaluation/fid_proxy" in e]
    assert [s for s, _ in evals] == [2]
    assert all(np.isfinite(v) and v > 0 for _, v in evals)
    assert [e["step"] for e in events if "profile_written" in e] == [2]
    assert sorted(p.name for p in (out / "preview").iterdir()) == ["2.gif"]
    traces = list((out / "profile").glob("steps_1_2.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
    assert train.parse_profile_steps("4:0") == (4, 1)
    assert train.parse_profile_steps("4") == (4, 3)
    assert train.parse_profile_steps(None) == (-1, 0)


def test_generation_example(tmp_path):
    import argparse

    def run(config, out):
        return generation_example.main(argparse.Namespace(
            config_path=str(config), output_path=str(out), device="cpu"))

    path = run(EXAMPLE, tmp_path / "a")
    assert path == str(tmp_path / "a" / "generation.gif")
    config = json.loads(EXAMPLE.read_text())
    model_cfg = {k: v for k, v in config["pipeline"]["model"].items()
                 if k != "_class_name"}
    torch.manual_seed(5)
    dit = DiTCrossviewTemporal(**model_cfg)
    torch.save(land_eval.reference_state_dict("ctsd_dit", dit),
               tmp_path / "ctsd.pth")
    convert_cli.main(["--kind", "ctsd_dit", "--input",
                      str(tmp_path / "ctsd.pth"), "--output",
                      str(tmp_path / "ctsd.pt"), "--num-layers", "2"])
    config["checkpoint_path"] = str(tmp_path / "ctsd.pt")
    (tmp_path / "cfg.json").write_text(json.dumps(config))
    other = run(tmp_path / "cfg.json", tmp_path / "b")
    from PIL import Image

    with Image.open(path) as a, Image.open(other) as b:
        # no VAE in the example: its 6 views of 8 x 8 latents, channels 0-2
        assert a.size == b.size == (6 * 8, 8)
        assert not np.array_equal(np.asarray(a.convert("RGB")),
                                  np.asarray(b.convert("RGB")))


def test_frames_drill_separates_distinct_frames():
    g = torch.Generator().manual_seed(0)
    real = torch.rand(1, 6, 2, 32, 48, 3, generator=g) * 2 - 1
    fake = (torch.randn(real.shape, generator=g) * 0.3).clamp(-1, 1)
    out = land_eval.frames_drill(real, fake, torch.device("cpu"),
                                 fid_size=75, fvd_size=64)
    assert out["fid_images"] == 12 and out["fvd_clips"] == 2
    assert out["fid"] > 0 and out["fvd"] > 0


def test_frames_drill_refuses_a_zero_distance(monkeypatch):
    from opendwm_tpu_torch.metrics.frechet import FrechetPairedMetric

    monkeypatch.setattr(FrechetPairedMetric, "compute", lambda self: 0.0)
    frames = torch.zeros(1, 2, 1, 16, 16, 3)
    with pytest.raises(AssertionError, match="degenerate"):
        land_eval.frames_drill(frames, frames, torch.device("cpu"),
                               fid_size=75, fvd_size=16)


@pytest.mark.parametrize("module", [evaluate, preview, run_all])
def test_cuda_without_a_card_raises(tmp_path, module):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    if module is run_all:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_all.main(["--dry-run", "--output", str(tmp_path)])
        return
    args = module.create_parser().parse_args(
        ["-c", str(SYNTHETIC), "-o", str(tmp_path)])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(args)
