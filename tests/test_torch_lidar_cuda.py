"""LiDAR serving on the card against the CPU.

Every test here needs an NVIDIA GPU and skips without one; the file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_lidar_cuda.py -q

- Tiny MaskGIT pipelines, spatial and temporal (``perf/lidar_tiny.py``):
  the tokenizer's voxels bit for bit, its features, the transformer's
  logits and the decoder's within 1e-3; no kernel launches on this path.
- A tiny DiT with temporal ``rowwise`` branches (sequences of 144 tokens:
  K1) and a tiny ``LidarDiffusionPipeline.generate`` within 1e-3.
- The voxelizer at the configs' 40 x 640 x 640 grid equal to the CPU's
  bit for bit, on random points and on points within 3 ulps of every
  voxel boundary (where a product with the step's reciprocal moves a
  point by one voxel); the categorical step in chunks equal to one chunk
  on the card and picking the CPU's codes from the same noise; the
  quantizer's code search in chunks against one unchunked call and
  float64 scores, exact up to ties.
"""

import pytest
import torch

from opendwm_tpu_torch.models import vq_point_cloud as vq
from opendwm_tpu_torch.ops.voxelize import Voxelizer
from opendwm_tpu_torch.perf import lidar_tiny
from opendwm_tpu_torch.pipelines import lidar_maskgit
from opendwm_tpu_torch.pipelines.lidar_maskgit import sample_tokens

pytestmark = pytest.mark.cuda
TOL = 1e-3
GRID = dict(x_min=-50.0, x_max=50.0, y_min=-50.0, y_max=50.0, step=0.15625,
            z_min=-3.0, z_max=2.6, z_step=0.14)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("temporal", [False, True])
def test_tiny_maskgit_on_the_card(cuda, temporal):
    gaps = lidar_tiny.maskgit_gaps(cuda, temporal)
    assert gaps["voxels_equal"] and gaps["pipeline_ids_nonnegative"], gaps
    assert gaps["boundary_voxels_equal"], gaps
    for key in ("encoder_rel", "logits_rel", "decoder_rel"):
        assert gaps[key] <= TOL, gaps
    assert gaps["index_flip_gap"] <= lidar_tiny.TIE_TOL, gaps
    assert gaps["kernel_launches"] == 0


def test_tiny_lidar_dit_on_the_card(cuda):
    gaps = lidar_tiny.dit_gaps(cuda)
    for key in ("dit_rel", "reference_latents_rel", "latents_rel"):
        assert gaps[key] <= TOL, gaps
    assert gaps["dit_k1_launches"] > 0


def test_voxelizer_on_the_card(cuda):
    g = torch.Generator().manual_seed(0)
    pts = torch.rand(2, 32768, 3, generator=g) * 110 - 55
    pts[..., 2] = torch.rand(2, 32768, generator=g) * 8 - 4
    mask = torch.rand(2, 32768, generator=g) > 0.1
    vox = Voxelizer(**GRID)
    want = vox(pts, mask)
    got = vox(pts.to(cuda), mask.to(cuda))
    assert want.shape == (2, 40, 640, 640)
    assert torch.equal(got.cpu(), want)


def test_voxelizer_at_voxel_boundaries_on_the_card(cuda):
    gaps = lidar_tiny.boundary_gaps(cuda)
    assert gaps["boundary_reciprocal_flips"] > 0, gaps
    assert gaps["boundary_voxels_equal"], gaps


@pytest.mark.parametrize("cosine", [False, True])
def test_code_search_in_chunks_on_the_card(cuda, monkeypatch, cosine):
    g = torch.Generator().manual_seed(2)
    q = vq.VectorQuantizer(5000, 256, cosine_similarity=cosine)
    with torch.no_grad():
        q.embedding.normal_(0, 256 ** -0.5, generator=g)
    flat = torch.randn(6000, 256, generator=g) * 256 ** -0.5
    monkeypatch.setattr(vq, "QUANTIZER_CHUNK_ELEMS", 5000 * 1000)
    gaps = lidar_tiny.nearest_gaps(q.to(cuda), flat.to(cuda))
    assert gaps["chunks"] == 6
    assert gaps["chunk_flip_gap"] <= lidar_tiny.TIE_TOL, gaps
    assert gaps["shortfall_gap"] <= lidar_tiny.TIE_TOL, gaps


def test_sampling_on_the_card(cuda, monkeypatch):
    g = torch.Generator().manual_seed(1)
    logits = torch.randn(4, 50, 300, generator=g) * 3
    noise = -torch.log(-torch.log(torch.rand(2 * 50, 300, generator=g)))
    blank = torch.tensor([0, 7])
    kw = dict(guidance=3.0)
    want = sample_tokens(logits, lambda r0, r1: noise[r0:r1],
                         blank=blank, **kw)
    dnoise = noise.to(cuda)
    got = []
    for chunk in (lidar_maskgit.SAMPLE_CHUNK_ELEMS, 300 * 7):
        monkeypatch.setattr(lidar_maskgit, "SAMPLE_CHUNK_ELEMS", chunk)
        got.append(sample_tokens(logits.to(cuda),
                                 lambda r0, r1: dnoise[r0:r1],
                                 blank=blank.to(cuda), **kw))
    assert torch.equal(got[0][0], got[1][0])
    assert torch.equal(got[0][1], got[1][1])
    assert torch.equal(got[0][0].cpu(), want[0])
    torch.testing.assert_close(got[0][1].cpu(), want[1], rtol=1e-5,
                               atol=1e-7)
