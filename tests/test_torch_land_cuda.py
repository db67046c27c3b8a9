"""Weight landing and the metrics on the card against the CPU.

Every test here needs an NVIDIA GPU and skips without one; the file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_land_cuda.py -q

- ``run_all.import_entry`` of the dry run's tiny DiT, UNet and VAE on the
  card: ``verified``, the golden forward within 1e-3 of the CPU's (fp32).
- The Fréchet state on the card equal to the CPU's within 1e-6 relative,
  the distance within 1e-5; the Chamfer distance (chunked) within 1e-5,
  exactly 0 for a cloud against itself; IoU and diff equal.
- ``land_eval.frames_drill`` on the card within 1e-3 of the CPU's.
- The full-width key sets are held on the CPU (meta device) in
  ``test_torch_import.py::test_full_width_key_sets``.
"""

import pytest
import torch

from opendwm_tpu_torch import run_all
from opendwm_tpu_torch.metrics import frechet, pc_metrics, voxel_metrics
from opendwm_tpu_torch.models.autoencoders import AutoencoderKL
from opendwm_tpu_torch.models.mmdit import DiTCrossviewTemporal
from opendwm_tpu_torch.models.unet import UNetCrossviewTemporal
from opendwm_tpu_torch.perf import land_eval

pytestmark = pytest.mark.cuda
TOL = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _sources():
    torch.manual_seed(0)
    return {
        "ctsd_dit": (DiTCrossviewTemporal(**run_all.DRY_DIT).state_dict(),
                     run_all.DRY_DIT),
        "ctsd_unet": (UNetCrossviewTemporal(
            **run_all.DRY_UNET, cross_attention_dim=32).state_dict(),
            run_all.DRY_UNET),
        "vae": (AutoencoderKL(block_out_channels=(32, 64)).state_dict(),
                None),
    }


@pytest.mark.parametrize("kind", ["ctsd_dit", "ctsd_unet", "vae"])
def test_imported_models_on_the_card_match_the_cpu(cuda, kind):
    sd, kwargs = _sources()[kind]
    outs = {}
    for dev in (torch.device("cpu"), cuda):
        entry, state, (_, _, out) = run_all.import_entry(
            kind, kind, sd, kwargs, dev)
        assert entry["status"] == "verified", entry
        outs[dev.type] = out.float().cpu()
    assert (outs["cuda"] - outs["cpu"]).abs().max().item() <= TOL


def test_metrics_on_the_card_match_the_cpu(cuda, monkeypatch):
    g = torch.Generator().manual_seed(0)
    real = torch.randn(300, 64, generator=g)
    fake = torch.randn(200, 64, generator=g) * 1.3 + 0.5
    m = frechet.FrechetDistance(64)
    states = {}
    for dev in ("cpu", "cuda"):
        s = m.init()
        s = m.update(s, real.to(dev), real=True)
        states[dev] = m.update(s, fake.to(dev), real=False)
    for part in ("real_sum", "real_cov_sum", "fake_sum", "fake_cov_sum"):
        a, b = (getattr(states[d], part).cpu().double() for d in ("cuda",
                                                                   "cpu"))
        assert ((a - b).norm() / b.norm()).item() <= 1e-6, part
    want = m.compute(states["cpu"])
    assert abs(m.compute(states["cuda"]) - want) / want <= 1e-5

    monkeypatch.setattr(pc_metrics, "CHUNK_ELEMS", 64 * 3000)
    pred = torch.rand(2500, 3, generator=g) * 100 - 50
    gt = torch.rand(3000, 3, generator=g) * 100 - 50
    mask = torch.rand(2500, generator=g) < 0.8
    want = float(pc_metrics.chamfer_distance(pred, gt, mask))
    got = float(pc_metrics.chamfer_distance(pred.to(cuda), gt.to(cuda),
                                            mask.to(cuda)))
    assert got == pytest.approx(want, rel=1e-5)
    assert float(pc_metrics.chamfer_distance(gt.to(cuda), gt.to(cuda))) == 0

    vox_a = torch.rand(2, 4, 8, 8, generator=g) < 0.3
    vox_b = torch.rand(2, 4, 8, 8, generator=g) < 0.4
    for cls in (voxel_metrics.VoxelIoU, voxel_metrics.VoxelDiff):
        cpu, card = cls(), cls()
        cpu.update(vox_a, vox_b)
        card.update(vox_a.to(cuda), vox_b.to(cuda))
        assert card.values == cpu.values


def test_frames_drill_on_the_card_matches_the_cpu(cuda):
    g = torch.Generator().manual_seed(1)
    real = torch.rand(1, 6, 2, 64, 96, 3, generator=g) * 2 - 1
    fake = (torch.randn(real.shape, generator=g) * 0.4).clamp(-1, 1)
    cpu = land_eval.frames_drill(real, fake, torch.device("cpu"),
                                 fid_size=75, fvd_size=64)
    card = land_eval.frames_drill(real, fake, cuda, fid_size=75, fvd_size=64)
    for key in ("fid", "fvd"):
        assert card[key] == pytest.approx(cpu[key], rel=TOL), key
