"""LiDAR training and the LiDAR UNet on the card against the CPU.

Every test here needs an NVIDIA GPU and skips without one; the file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_lidar_train_cuda.py -q

The tiny paths of ``perf/lidar_train_tiny.py``, each within 1e-3 of the
CPU (losses, every gradient as one vector, the rendered depth, the
generated latents), the voxels bit for bit:

- a ``LidarCodebook`` step (DVGO render, reservoir, code ages) and a
  ``LidarVAE`` step: no kernel on these paths;
- a MaskGIT step with the extra embedding's perturbation;
- a LiDAR DiT step whose rowwise sequences of 144 tokens launch K1 and K2;
- the LiDAR UNet over a ``VAEPointCloud``: encode, a 2-step DDIM CFG
  generation (K7) and a train step (K7 and its backward).
"""

import pytest
import torch

from opendwm_tpu_torch.perf import lidar_train_tiny

pytestmark = pytest.mark.cuda
TOL = lidar_train_tiny.TOL


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def check(gaps: dict) -> None:
    for key, value in gaps.items():
        if key.endswith("_rel"):
            assert value <= TOL, (key, gaps)
        elif key.endswith("_equal"):
            assert value is True, (key, gaps)


@pytest.mark.parametrize("name", ["codebook_gaps", "vae_gaps",
                                  "maskgit_train_gaps"])
def test_tiny_tokenizer_and_maskgit_steps(cuda, name):
    gaps = getattr(lidar_train_tiny, name)(cuda)
    check(gaps)
    assert gaps.get("attention_kernels", 0) == 0


def test_tiny_lidar_dit_step(cuda):
    gaps = lidar_train_tiny.dit_train_gaps(cuda)
    check(gaps)
    assert gaps["k1_launches"] > 0 and gaps["k2_launches"] > 0


def test_tiny_lidar_unet(cuda):
    gaps = lidar_train_tiny.unet_gaps(cuda)
    check(gaps)
    assert gaps["voxels_equal_share"] >= 0.999
    assert gaps["serve_k7_launches"] > 0
    assert gaps["train_k7_launches"] > 0
    assert gaps["train_k7_backward_launches"] > 0
