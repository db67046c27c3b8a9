"""Every config of ``configs/`` through the port's registry
(``opendwm_tpu_torch.config.get_class``): all 47 resolve every
``_class_name`` (``get_class`` itself counted as resolved), the data stack
to the port's filesystems and readers, the metrics to the port's. And no
module of the port, nor ``chip_smoke.py``, imports the JAX package, JAX or
fsspec (nor pyarrow, PyAV or botocore, which the readers import when they
need them, nor transformers or safetensors) at import."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from opendwm_tpu_torch.config import get_class

REPO = Path(__file__).resolve().parents[1]
CONFIGS = sorted(REPO.glob("configs/**/*.json"))


def class_names(node, out):
    if isinstance(node, dict):
        if "_class_name" in node:
            out.add(node["_class_name"])
        for value in node.values():
            class_names(value, out)
    elif isinstance(node, list):
        for value in node:
            class_names(value, out)
    return out


def unresolved(path) -> set:
    missing = set()
    for name in class_names(json.loads(path.read_text()), set()) - \
            {"get_class"}:
        try:
            get_class(name)
        except KeyError:
            missing.add(name)
    return missing


@pytest.mark.parametrize("path", CONFIGS,
                         ids=[str(p.relative_to(REPO / "configs"))
                              for p in CONFIGS])
def test_config_resolves(path):
    missing = unresolved(path)
    assert not missing, missing


def test_scan_counts():
    assert len(CONFIGS) == 47
    left = {str(p.relative_to(REPO)): unresolved(p) for p in CONFIGS}
    left = {k: v for k, v in left.items() if v}
    assert left == {}
    assert sum("get_class" in class_names(json.loads(p.read_text()), set())
               for p in CONFIGS) == 26


def test_data_stack_resolves_to_the_port():
    names = set()
    for path in CONFIGS:
        names |= class_names(json.loads(path.read_text()), set())
    data = {n for n in names if n.startswith(("dwm.fs.", "dwm.datasets.",
                                              "fsspec."))
            or n == "ConcatMotionDataset"}
    assert len(data) >= 8, data
    for name in data:
        module = get_class(name).__module__
        assert module.startswith(("opendwm_tpu_torch.fs.",
                                  "opendwm_tpu_torch.datasets.")), name


FORBIDDEN = ("jax", "flax", "optax", "opendwm_tpu", "fsspec", "pyarrow", "av",
             "botocore", "transformers", "safetensors")


def test_port_and_smoke_import_no_jax_nor_fsspec():
    code = (
        "import importlib, pkgutil, sys\n"
        "import opendwm_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "'opendwm_tpu_torch.')]\n"
        "assert 'opendwm_tpu_torch.fs.czip' in names\n"
        "assert 'opendwm_tpu_torch.datasets.argoverse' in names\n"
        "assert 'opendwm_tpu_torch.run_all' in names\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN}]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=REPO)
