"""The gates of ``chip_smoke.py`` that hold the Hopper attention kernels,
fed with made-up census and launch counts on the CPU: the SASS/ptxas
census of the forward and backward instances, and the rule that every
attention launch of a model path ran the Hopper body. Also the shape of
the backward's fp32 dQ workspace. No kernel runs here.
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
])
def test_model_paths_run_the_hopper_bodies(smoke, path, over, ok):
    """Every K1/K7 forward launch of the four model paths and every K2/K7
    backward launch of the two training paths must have run the Hopper
    body; one launch of an old body fails the run."""
    paths = {p: _counts() for p in ("serve", "train", "unet_serve",
                                    "unet_train")}
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
