"""ctypes bindings for the native data-plane library (``data_plane.cpp``),
the port's copy of ``opendwm_tpu/native``.

The library is compiled with ``g++`` at first use into ``build/native/``
at the root of the checkout (git-ignored), named by a hash of its source,
so a changed source is rebuilt and nothing is written beside the source.
Every entry point keeps its numpy fallback (host code, as in the JAX
package): ``use_native=None`` takes the library when it loads, ``False``
the fallback, ``True`` the library or an error. :func:`available` says
whether the library loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "data_plane.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    digest = hashlib.sha1(SRC.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libdata_plane_{digest}.so"


def _build(lib: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(SRC),
           "-lz", "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.CalledProcessError, FileNotFoundError,
            subprocess.TimeoutExpired):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, lib)  # atomic: a concurrent build never loads half a file
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = library_path()
        if not path.exists() and not _build(path):
            return None
        lib = ctypes.CDLL(str(path))
        lib.zip_scan_central_directory.restype = ctypes.c_int64
        lib.inflate_raw.restype = ctypes.c_int64
        lib.decode_lidar_bin.restype = ctypes.c_int64
        lib.voxelize_points.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _library(use_native: Optional[bool]) -> Optional[ctypes.CDLL]:
    if use_native is False:
        return None
    lib = _load()
    if lib is None and use_native:
        raise RuntimeError(f"the native data plane did not build from {SRC} "
                           "(g++ and zlib's headers are needed)")
    return lib


def _ptr(array: np.ndarray, ctype):
    return array.ctypes.data_as(ctypes.POINTER(ctype))


# ---------------------------------------------------------------------------
# Wrappers (native with numpy fallback)
# ---------------------------------------------------------------------------

def zip_scan_central_directory(
    data: bytes, use_native: Optional[bool] = None
) -> list[dict]:
    """Parse a ZIP central directory into entry metadata records."""
    lib = _library(use_native)
    if lib is None:
        import io
        import zipfile

        zf = zipfile.ZipFile(io.BytesIO(data))
        return [
            {
                "name": zi.filename,
                "header_offset": zi.header_offset,
                "compress_type": zi.compress_type,
                "compress_size": zi.compress_size,
                "file_size": zi.file_size,
            }
            for zi in zf.infolist()
            if not zi.is_dir()
        ]
    max_entries = max(64, data.count(b"PK\x01\x02"))
    header_offsets = np.zeros(max_entries, np.int64)
    compress_types = np.zeros(max_entries, np.int32)
    compress_sizes = np.zeros(max_entries, np.int64)
    file_sizes = np.zeros(max_entries, np.int64)
    name_lens = np.zeros(max_entries, np.int32)
    name_buf = np.zeros(1 << 22, np.uint8)
    buf = np.frombuffer(data, np.uint8)
    n = lib.zip_scan_central_directory(
        _ptr(buf, ctypes.c_uint8),
        ctypes.c_int64(len(data)), ctypes.c_int64(max_entries),
        _ptr(header_offsets, ctypes.c_int64),
        _ptr(compress_types, ctypes.c_int32),
        _ptr(compress_sizes, ctypes.c_int64),
        _ptr(file_sizes, ctypes.c_int64),
        _ptr(name_buf, ctypes.c_uint8),
        ctypes.c_int64(name_buf.size),
        _ptr(name_lens, ctypes.c_int32),
    )
    if n < 0:
        raise ValueError(f"zip scan failed ({n})")
    out = []
    pos = 0
    for i in range(n):
        ln = int(name_lens[i])
        name = bytes(name_buf[pos: pos + ln]).decode("utf-8")
        pos += ln
        if name.endswith("/"):
            continue
        out.append({
            "name": name,
            "header_offset": int(header_offsets[i]),
            "compress_type": int(compress_types[i]),
            "compress_size": int(compress_sizes[i]),
            "file_size": int(file_sizes[i]),
        })
    return out


def inflate_raw(data: bytes, out_size: int,
                use_native: Optional[bool] = None) -> bytes:
    """Raw-deflate ``data`` (a ZIP_DEFLATED member's payload) into at most
    ``out_size`` bytes."""
    lib = _library(use_native)
    if lib is None:
        import zlib

        return zlib.decompress(data, -15)
    src = np.frombuffer(data, np.uint8)
    dst = np.zeros(out_size, np.uint8)
    n = lib.inflate_raw(
        _ptr(src, ctypes.c_uint8), ctypes.c_int64(len(data)),
        _ptr(dst, ctypes.c_uint8), ctypes.c_int64(out_size),
    )
    if n < 0:
        raise ValueError("inflate failed")
    return bytes(dst[:n])


def decode_lidar_bin(
    raw: bytes,
    stride: int = 5,
    max_points: int = 32768,
    pc_range: Optional[tuple] = None,
    use_native: Optional[bool] = None,
) -> tuple[np.ndarray, np.ndarray]:
    """float32 records → ((max_points, 3) xyz, (max_points,) bool mask)."""
    lib = _library(use_native)
    if lib is None:
        pts = np.frombuffer(raw, np.float32).reshape(-1, stride)[:, :3]
        if pc_range is not None:
            lo = np.asarray(pc_range[:3])
            hi = np.asarray(pc_range[3:])
            keep = np.all((pts >= lo) & (pts <= hi), -1)
            pts = pts[keep]
        out = np.zeros((max_points, 3), np.float32)
        mask = np.zeros(max_points, bool)
        n = min(len(pts), max_points)
        out[:n] = pts[:n]
        mask[:n] = True
        return out, mask
    buf = np.frombuffer(raw, np.uint8)
    out = np.zeros((max_points, 3), np.float32)
    mask = np.zeros(max_points, np.uint8)
    r = pc_range or (0, 0, 0, 0, 0, 0)
    lib.decode_lidar_bin(
        _ptr(buf, ctypes.c_uint8),
        ctypes.c_int64(len(raw)), ctypes.c_int32(stride),
        ctypes.c_float(r[0]), ctypes.c_float(r[3]),
        ctypes.c_float(r[1]), ctypes.c_float(r[4]),
        ctypes.c_float(r[2]), ctypes.c_float(r[5]),
        ctypes.c_int32(1 if pc_range is not None else 0),
        ctypes.c_int64(max_points),
        _ptr(out, ctypes.c_float),
        _ptr(mask, ctypes.c_uint8),
    )
    return out, mask.astype(bool)


def voxelize_points_host(
    points: np.ndarray, mask: Optional[np.ndarray],
    x_min: float, y_min: float, z_min: float,
    step: float, z_step: float,
    depth: int, height: int, width: int,
    use_native: Optional[bool] = None,
) -> np.ndarray:
    """Floor-index occupancy of ``points`` (n, 3) in a (depth, height,
    width) grid (the native ``voxelize_points``)."""
    lib = _library(use_native)
    grid = np.zeros((depth, height, width), np.float32)
    if lib is None:
        pts = points if mask is None else points[mask]
        iw = np.floor((pts[:, 0] - x_min) / step).astype(int)
        ih = np.floor((pts[:, 1] - y_min) / step).astype(int)
        idp = np.floor((pts[:, 2] - z_min) / z_step).astype(int)
        keep = (
            (iw >= 0) & (iw < width) & (ih >= 0) & (ih < height)
            & (idp >= 0) & (idp < depth)
        )
        grid[idp[keep], ih[keep], iw[keep]] = 1.0
        return grid
    pts = np.ascontiguousarray(points, np.float32)
    m = (
        np.ascontiguousarray(mask, np.uint8)
        if mask is not None else None
    )
    lib.voxelize_points(
        _ptr(pts, ctypes.c_float),
        _ptr(m, ctypes.c_uint8) if m is not None else None,
        ctypes.c_int64(len(pts)),
        ctypes.c_float(x_min), ctypes.c_float(y_min), ctypes.c_float(z_min),
        ctypes.c_float(step), ctypes.c_float(z_step),
        ctypes.c_int64(depth), ctypes.c_int64(height),
        ctypes.c_int64(width),
        _ptr(grid, ctypes.c_float),
    )
    return grid
