"""Build a CUDA source of this package into a shared library and load it.

Route: ``nvcc -gencode arch=compute_90a,code=sm_90a -shared`` into a
plain-C shared library (no PyTorch headers, so a build takes seconds),
loaded with ``ctypes``. Libraries go to ``build/kernels/`` at the root of
the checkout (git-ignored), named by a hash of their source and every
header of its directory, so a change to any of them is rebuilt and an
unchanged build is reused; ptxas's report of each build is kept beside its
library (``<library>.ptxas``). ``build_all`` runs one nvcc per source, all
at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"


def _tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    default = f"/usr/local/cuda/bin/{name}"
    if os.path.exists(default):
        return default
    raise RuntimeError(f"{name} not found: the CUDA kernels build only "
                       "where the CUDA toolkit is installed")


def _nvcc() -> str:
    return _tool("nvcc")


def _paths(source_name: str, csrc: Path | None = None) -> tuple[Path, Path]:
    """The source and its library: ``lib<stem>_<hash>.so`` with the hash
    over the source and every ``*.cuh`` beside it (a source may include
    any)."""
    src = (CSRC if csrc is None else Path(csrc)) / source_name
    h = hashlib.sha1(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    return src, BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:12]}.so"


def ptxas_log_path(lib: Path) -> Path:
    """Where ptxas's report of the build of ``lib`` is kept."""
    return lib.with_name(lib.name + ".ptxas")


def build_all(source_names, csrc: Path | None = None) -> None:
    """Compile every ``<csrc>/<name>`` (``csrc`` defaults to this package's
    ``csrc/``) not built yet for sm_90a, one nvcc process per source, all
    started together."""
    jobs = []
    for name in source_names:
        src, lib = _paths(name, csrc)
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
        ptxas_log_path(lib).write_text(err)  # before the library appears
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))


def library_path(source_name: str, csrc: Path | None = None) -> Path:
    """Where the build of ``source_name`` goes."""
    return _paths(source_name, csrc)[1]


def load_library(source_name: str, csrc: Path | None = None) -> ctypes.CDLL:
    """Compile ``<csrc>/<source_name>`` for sm_90a (if not built yet) and
    load it."""
    build_all([source_name], csrc)
    return ctypes.CDLL(str(library_path(source_name, csrc)))


def ptxas_log(lib: Path) -> str:
    """ptxas's report of the build of ``lib``, kept beside it."""
    return ptxas_log_path(lib).read_text()


def ptxas_report(lib: Path, name_part: str) -> dict[str, dict]:
    """Registers and spill bytes that ptxas reported for each function of
    the build of ``lib`` whose mangled name holds ``name_part``."""
    report: dict[str, dict] = {}
    current = None
    for line in ptxas_log(lib).splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )([\w$]+)", line)
        if m:
            current = m.group(1) if name_part in m.group(1) else None
            if current is not None:
                report.setdefault(current, {})
            continue
        if current is None:
            continue
        if m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line):
            report[current]["spill_bytes"] = int(m[1]) + int(m[2])
        if m := re.search(r"Used (\d+) registers", line):
            report[current]["registers"] = int(m[1])
    return report


SASS_OPCODES = ("HGMMA", "UTMALDG", "UTMASTG", "LDGSTS", "LDSM", "HMMA")


def sass_census(lib: Path, name_part: str) -> dict[str, dict[str, int]]:
    """Instructions of ``SASS_OPCODES`` in each function of the built
    library ``lib`` whose mangled name holds ``name_part``, counted in
    ``cuobjdump -sass``."""
    out = subprocess.run([_tool("cuobjdump"), "-sass", str(lib)],
                         capture_output=True, text=True, check=True).stdout
    census: dict[str, dict[str, int]] = {}
    current = None
    for line in out.splitlines():
        if m := re.search(r"Function : (\S+)", line):
            current = m[1] if name_part in m[1] else None
            if current is not None:
                census[current] = dict.fromkeys(SASS_OPCODES, 0)
            continue
        if current is not None:
            for op in SASS_OPCODES:
                if re.search(rf"\b{op}\b", line):
                    census[current][op] += 1
    return census
