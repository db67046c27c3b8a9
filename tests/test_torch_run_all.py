"""The port's weight-landing command (``opendwm_tpu_torch/run_all.py``) on
the CPU (``--device cpu``).

- ``--dry-run``: tiny sources in the reference naming written from the
  port's own models, every entry ``verified``, the metrics drill done
  (FVD and FID above 0 on distinct inputs, the noise calibration above 3x
  both the generated distance and the same-distribution floor). The
  drill's Inception input is cut from 299² to 75², the net's smallest,
  which takes the dry run from ~55 s to ~15 s on 8 cores; the same code
  runs at 299² in ``chip_smoke.py``'s phase 24 drill
  (``perf/land_eval.frames_drill``).
- A directory with a source the port has no place for: that entry
  ``failed`` with the key named, the next one landed.
"""

import json
from pathlib import Path

import torch

from opendwm_tpu_torch import run_all
from opendwm_tpu_torch.models.autoencoders import AutoencoderKL
from opendwm_tpu_torch.models.text_encoders import CLIPTextEncoder

from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)


def test_run_all_dry_run_verifies_everything(tmp_path, monkeypatch):
    monkeypatch.setattr(run_all, "DRILL_FID_SIZE", 75)
    report = run_all.main(["--dry-run", "--output", str(tmp_path / "landed"),
                           "--device", "cpu"])
    saved = json.loads((tmp_path / "landed" / "WEIGHTS_PARITY.json")
                       .read_text())
    assert saved == json.loads(json.dumps(report))
    by_kind = {e["kind"]: e for e in report["entries"]}
    assert set(by_kind) == {"ctsd_dit", "ctsd_unet", "vae", "clip", "t5"}
    for kind, entry in by_kind.items():
        assert entry["status"] == "verified", (kind, entry)
        assert entry["check"]["finite"] and entry["n_params"] > 0
        assert entry["load_bytes"] > 0 and Path(entry["out_path"]).exists()
    drill = report["metrics_drill"]
    assert drill["status"] == "ok", drill
    for key in ("fvd_random_i3d", "fid_random_inception"):
        assert drill[key] > 0


def test_run_all_reports_a_failed_entry_and_goes_on(tmp_path):
    src = tmp_path / "w"
    torch.manual_seed(0)
    sd = AutoencoderKL(block_out_channels=(16, 32)).state_dict()
    (src / "base" / "vae").mkdir(parents=True)
    torch.save(dict(sd, stray=torch.zeros(1)),
               src / "base" / "vae" / "diffusion_pytorch_model.pth")
    (src / "base" / "text_encoder").mkdir()
    torch.save(run_all.hf_clip_state_dict(
        CLIPTextEncoder(**run_all.DRY_CLIP).state_dict()),
        src / "base" / "text_encoder" / "model.pth")
    report = run_all.main(["--weights-dir", str(src), "--output",
                           str(tmp_path / "o"), "--device", "cpu"])
    status = {e["kind"]: e["status"] for e in report["entries"]}
    assert status == {"vae": "failed", "clip": "verified"}
    assert "stray" in report["entries"][1]["error"]
