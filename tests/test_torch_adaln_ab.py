"""The K3/K4 comparison on the card (``opendwm_tpu_torch/perf/adaln_ab.py``)
as far as it runs without one: its shapes are the smoke's. No kernel runs
here."""

import importlib.util
from pathlib import Path

from opendwm_tpu_torch.ops import fused_adaln
from opendwm_tpu_torch.perf import adaln_ab

REPO = Path(__file__).resolve().parents[1]


def test_shapes_are_the_smokes():
    """The d-1536 shapes are the CTSD-3.5 DiT's of ``chip_smoke.py``; the
    d-1024 shapes are the LiDAR DiT's serving and training shapes there."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    wide = [s for s in adaln_ab.SHAPES if s[2] == 1536]
    assert wide == list(smoke.ADALN_SHAPES[:4])
    assert [s for s in adaln_ab.SHAPES if s[2] == 1024] == \
        list(smoke.LIDAR_ADALN_SHAPES + smoke.LIDAR_TRAIN_ADALN_SHAPES)
    assert {s[2] for s in adaln_ab.SHAPES} == set(fused_adaln.RING_WIDTHS)

