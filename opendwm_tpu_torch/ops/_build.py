"""Build a CUDA source of this package into a shared library and load it.

Route: ``nvcc -gencode arch=compute_90a,code=sm_90a -shared`` into a
plain-C shared library (no PyTorch headers, so a build takes seconds),
loaded with ``ctypes``. Libraries go to ``build/kernels/`` at the root of
the checkout (git-ignored), named by a hash of their source, so a changed
source is rebuilt and an unchanged one is reused. ``build_all`` runs one
nvcc per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"

# ptxas's report (registers, shared memory, spills) of each build, by name.
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _paths(source_name: str) -> tuple[Path, Path]:
    src = CSRC / source_name
    digest = hashlib.sha1(src.read_bytes()).hexdigest()[:12]
    return src, BUILD_DIR / f"lib{src.stem}_{digest}.so"


def build_all(source_names) -> None:
    """Compile every ``csrc/<name>`` not built yet for sm_90a, one nvcc
    process per source, all started together."""
    jobs = []
    for name in source_names:
        src, lib = _paths(name)
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [
            _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-o", str(tmp), str(src),
        ]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs.append((name, src, lib, tmp, proc))
    failed = []
    for name, src, lib, tmp, proc in jobs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {src}:\n{out}\n{err}")
            continue
        build_logs[name] = err
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))


def load_library(source_name: str) -> ctypes.CDLL:
    """Compile ``csrc/<source_name>`` for sm_90a (if not built yet) and load it."""
    build_all([source_name])
    return ctypes.CDLL(str(_paths(source_name)[1]))
