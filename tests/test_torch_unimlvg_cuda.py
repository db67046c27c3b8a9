"""UniMLVG, the DiT's other branch types, MaskGWM and the temporal VAE on
the card against the CPU (``perf/unimlvg_tiny.py``).

Every test here needs an NVIDIA GPU and skips without one; the file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_unimlvg_cuda.py -q

- The tiny UniMLVG pipeline (explicit perspective and view modeling, the
  adapter, ``pred`` with 3 visible frames; a 136-token joint attention:
  K1): 2-step CFG inference and a 2-window rollout within 1e-3.
- Cross-view ``full``, ``fuse``, ``adj_fuse`` and temporal ``full``
  (sequences of 128 or 384 tokens: K7) within 1e-3, each launching K7.
- A masked DiT step (forward and every gradient) within 1e-3.
- The temporal VAE's encode and decode within 1e-4, causal on the card.
"""

import pytest
import torch

from opendwm_tpu_torch.perf import unimlvg_tiny

pytestmark = pytest.mark.cuda
TOL = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_tiny_unimlvg_on_the_card(cuda):
    gaps = unimlvg_tiny.unimlvg_gaps(cuda)
    assert gaps["inference_rel"] <= TOL and gaps["rollout_rel"] <= TOL, gaps
    assert gaps["inference_k1_launches"] > 0, gaps


@pytest.mark.parametrize("name", unimlvg_tiny.BRANCH_TYPES)
def test_branch_types_on_the_card(cuda, name):
    gaps = unimlvg_tiny.branch_gaps(cuda)
    assert gaps[f"{name}_rel"] <= TOL, gaps
    assert gaps[f"{name}_k7_launches"] > 0, gaps


def test_masked_step_on_the_card(cuda):
    gaps = unimlvg_tiny.masked_step_gaps(cuda)
    assert gaps["forward_rel"] <= TOL and gaps["grad_rel"] <= TOL, gaps
    assert gaps["forward_k1_launches"] > 0, gaps
    assert gaps["backward_k2_launches"] > 0, gaps


def test_temporal_vae_on_the_card(cuda):
    gaps = unimlvg_tiny.vae_gaps(cuda)
    for key in ("mean_rel", "logvar_rel", "decode_rel"):
        assert gaps[key] <= 1e-4, gaps
    assert gaps["causal_gap"] <= 1e-5, gaps
