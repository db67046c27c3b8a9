"""The FID and FVD feature nets (``models/inception.py``,
``models/i3d.py``) against the JAX package's, on the CPU in fp32.

A ``pt_inception``- and a TATS-named random state dict (drawn on the
port's own module names, BatchNorm statistics away from identity) goes
through the JAX converter and the flax forward, and through the port's
importer and forward: within 1e-4 in relative norm. I3D runs at (2, 10,
64, 64, 3), where "SAME" pads unevenly and the head's pool window is
clamped to the grid; the Inception at (2, 299, 299, 3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendwm_tpu.convert import torch_import as jti
from opendwm_tpu.models.i3d import InceptionI3d as JaxI3d
from opendwm_tpu.models.inception import FIDInceptionV3 as JaxInception
from opendwm_tpu_torch import torch_import as ti
from opendwm_tpu_torch.models.i3d import InceptionI3d, same_pads
from opendwm_tpu_torch.models.inception import FIDInceptionV3

from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

REL = 1e-4


def random_state(model, seed: int) -> dict:
    """The model's state dict drawn at random: He-scaled weights, BatchNorm
    scale ~1, shift and mean ~0.1, variance in [0.75, 1.25]; with the
    checkpoints' BatchNorm counters."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for name, t in model.state_dict().items():
        if name.endswith("running_var"):
            v = torch.rand(t.shape, generator=g) * 0.5 + 0.75
        elif name.endswith(("running_mean", ".bias")):
            v = torch.randn(t.shape, generator=g) * 0.1
        elif name.endswith("bn.weight"):
            v = 1 + torch.randn(t.shape, generator=g) * 0.1
        else:
            v = torch.randn(t.shape, generator=g) * (2.0 / t[0].numel()) ** 0.5
        sd[name] = v
        if name.endswith("bn.running_var"):
            sd[name.replace("running_var", "num_batches_tracked")] = \
                torch.tensor(0)
    return sd


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("port_cls,jax_cls,jax_convert,convert,shape", [
    (InceptionI3d, JaxI3d, jti.convert_i3d, ti.convert_i3d,
     (2, 10, 64, 64, 3)),
    (FIDInceptionV3, JaxInception, jti.convert_fid_inception,
     ti.convert_fid_inception, (2, 299, 299, 3)),
], ids=["i3d", "fid_inception"])
def test_feature_net_matches_jax(port_cls, jax_cls, jax_convert, convert,
                                 shape):
    sd = random_state(port_cls(), 0)
    x = np.random.default_rng(1).uniform(-1, 1, shape).astype(np.float32)
    ref = np.asarray(jax_cls().apply(
        jax_convert({k: v.numpy() for k, v in sd.items()}), jnp.asarray(x)))
    port = port_cls().eval()
    port.load_state_dict(convert(sd), strict=True)
    with torch.no_grad():
        out = port(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, 400 if port_cls is InceptionI3d
                                      else 2048)
    assert _rel(out, ref) <= REL


def test_same_pads_put_the_larger_half_last():
    # TF "SAME": 10 frames, kernel 7, stride 2 → 5 out, 5 padded, 2 + 3
    assert same_pads((10, 64, 64), (7, 7, 7), (2, 2, 2)) == \
        [2, 3, 2, 3, 2, 3]
    assert same_pads((5,), (3,), (2,)) == [1, 1]
    assert same_pads((4,), (2,), (2,)) == [0, 0]


def test_fid_inception_skips_the_logits_head_and_counters():
    sd = random_state(FIDInceptionV3(), 1)
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(1008, 2048), torch.zeros(1008)
    got = ti.convert_fid_inception(sd)
    assert not any(k.startswith("fc.") or "num_batches" in k for k in got)
    with pytest.raises(ValueError, match="no place"):
        ti.convert_fid_inception(dict(sd, **{"AuxLogits.conv0.weight":
                                             torch.zeros(1)}))
