"""The depth loss's projection and the BEV world VAE on the card against
the CPU.

Every test here needs an NVIDIA GPU and skips without one; the file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_depth_cuda.py -q

- ``depth_loss.frustum_indices`` at ``chip_smoke.py`` phase 25's geometry
  (112 bins, 6 outward cameras, points half-way between bins included):
  bins, pixel indices and validity equal bit for bit; the loss of the
  same logits within 1e-5.
- The tiny ``BEVWorldVAE`` (``chip_smoke.BEV_TINY``) within 1e-4 of the
  CPU (fp32), the voxels equal.
"""

import copy
import importlib.util
from pathlib import Path

import pytest
import torch

from opendwm_tpu_torch.pipelines import depth_loss

pytestmark = pytest.mark.cuda
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _to(tree, dev):
    return {k: v.to(dev) for k, v in tree.items()}


def test_depth_bins_and_pixels_equal_the_cpu(cuda, smoke):
    g = torch.Generator().manual_seed(0)
    batch = {**smoke.depth_rig(6, 6, 448, 256),
             **smoke.depth_points(g, 6, 4096, 200)}
    shape = (1, 6, 6, 32, 56, 112)
    frustum = smoke.DEPTH_FRUSTUM
    ref = depth_loss.frustum_indices(shape, batch, frustum)
    out = depth_loss.frustum_indices(shape, _to(batch, cuda), frustum)
    for a, b in zip(out, ref):
        assert torch.equal(a.cpu(), b)
    half = ref[0][0, :, 0, :200]
    want = torch.round(torch.arange(200) % 100 + 0.5).long()
    assert torch.equal(half, want.expand_as(half))
    logits = torch.randn(shape, generator=g)
    loss = depth_loss.make_depth_loss(logits, batch, frustum).item()
    got = depth_loss.make_depth_loss(logits.to(cuda), _to(batch, cuda),
                                     frustum).item()
    assert abs(got - loss) <= 1e-5 * loss


def test_bev_world_vae_matches_the_cpu(cuda, smoke):
    torch.manual_seed(0)
    ref_model = smoke.build_bev(smoke.BEV_TINY)
    model = copy.deepcopy(ref_model).to(cuda)
    g = torch.Generator().manual_seed(1)
    inputs = smoke.bev_inputs(g, torch.device("cpu"), 2, 32, 32, 64, 6.0)
    noise = torch.randn(1, 4, 8, generator=g)
    with torch.no_grad():
        ref = ref_model(**inputs, noise=noise)
        out = model(**_to(inputs, cuda), noise=noise.to(cuda))
    assert torch.equal(out["voxels"].cpu(), ref["voxels"])
    for key in ("mean", "logvar", "voxel_logits", "density",
                "recon_images", "kl_loss"):
        gap = (out[key].cpu() - ref[key]).abs().max()
        assert gap <= 1e-4 * ref[key].abs().max(), key
