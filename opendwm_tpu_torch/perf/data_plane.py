"""Checks and measurements of the host data plane (the filesystems, a
reader, the prefetch loader and the native library) on a nuScenes-format
archive, for ``chip_smoke.py``'s data phase and the tests.

- ``item_differences``: where two reader items differ, key by key and bit
  for bit (arrays by dtype, shape and bytes; PIL images by mode, size and
  pixels), as a list of messages (empty when equal);
- ``read_items``: a dataset's items, read from a pool of threads;
- ``items_per_s`` / ``loader_items_per_s``: a reader's items a second
  alone, and through ``PrefetchLoader`` at a number of workers;
- ``native_parity``: the native zip scan, inflate, LiDAR decode and
  voxelizer against their numpy fallbacks on an archive's bytes.
"""

from __future__ import annotations

import io
import time
import zipfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def _is_image(value) -> bool:
    return hasattr(value, "getbands") and hasattr(value, "size")


def item_differences(got, want, path: str = "item") -> list[str]:
    """Every place where ``got`` is not ``want`` bit for bit."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or list(got) != list(want):
            keys = list(got) if isinstance(got, dict) else type(got).__name__
            return [f"{path}: keys {keys} != {list(want)}"]
        return [d for k in want
                for d in item_differences(got[k], want[k], f"{path}[{k!r}]")]
    if isinstance(want, (list, tuple)):
        if type(got) is not type(want) or len(got) != len(want):
            return [f"{path}: {type(got).__name__} of "
                    f"{len(got) if hasattr(got, '__len__') else '?'} != "
                    f"{type(want).__name__} of {len(want)}"]
        return [d for i, (g, w) in enumerate(zip(got, want))
                for d in item_differences(g, w, f"{path}[{i}]")]
    if isinstance(want, np.ndarray):
        if not isinstance(got, np.ndarray) or got.dtype != want.dtype or \
                got.shape != want.shape:
            return [f"{path}: {getattr(got, 'dtype', type(got).__name__)} "
                    f"{getattr(got, 'shape', '')} != {want.dtype} "
                    f"{want.shape}"]
        if got.tobytes() != want.tobytes():
            return [f"{path}: values differ"]
        return []
    if _is_image(want):
        if not _is_image(got) or got.mode != want.mode or \
                got.size != want.size:
            return [f"{path}: image {getattr(got, 'mode', None)} "
                    f"{getattr(got, 'size', None)} != {want.mode} "
                    f"{want.size}"]
        if np.asarray(got).tobytes() != np.asarray(want).tobytes():
            return [f"{path}: pixels differ"]
        return []
    if type(got) is not type(want):
        return [f"{path}: {type(got).__name__} != {type(want).__name__}"]
    if isinstance(want, np.generic):
        same = got.tobytes() == want.tobytes()
    else:
        same = got == want or (got != got and want != want)
    return [] if same else [f"{path}: {got!r} != {want!r}"]


def read_items(dataset, indices, threads: int = 1) -> list:
    """``dataset[i]`` for each of ``indices``, fetched from ``threads``
    threads at once (in order)."""
    with ThreadPoolExecutor(threads) as pool:
        return list(pool.map(dataset.__getitem__, indices))


def items_per_s(dataset, indices) -> float:
    """Items a second of the reader alone, in one thread."""
    t0 = time.perf_counter()
    for i in indices:
        dataset[i]
    return len(indices) / (time.perf_counter() - t0)


def loader_items_per_s(dataset, batch_size: int, collate_fn, workers: int,
                       batches: int, seed: int = 0) -> float:
    """Items a second through a ``PrefetchLoader`` of ``workers`` threads,
    from the first batch asked for to the last received."""
    from opendwm_tpu_torch.datasets.loader import PrefetchLoader

    loader = PrefetchLoader(dataset, batch_size, collate_fn, seed=seed,
                            num_workers=workers)
    try:
        it = iter(loader)
        t0 = time.perf_counter()
        for _ in range(batches):
            next(it)
        return batches * batch_size / (time.perf_counter() - t0)
    finally:
        loader.close()


def native_parity(archive: bytes, pc_range, voxelizer=None) -> dict:
    """The native library against its fallbacks on ``archive`` (a zip's
    bytes): the central directory scan, the inflate of every deflated
    member, and the decode of every ``.bin`` sweep (5 floats a point)
    without and with ``pc_range``; with ``voxelizer`` (x_min, y_min,
    z_min, step, z_step, depth, height, width) the occupancy grid of the
    first sweep. Counts of members compared and of mismatches."""
    from opendwm_tpu_torch import native

    out = {"native": native.available(), "scan_equal": False,
           "inflated": 0, "inflate_mismatches": 0, "decoded": 0,
           "decode_mismatches": 0, "voxelize_equal": None}
    entries = native.zip_scan_central_directory(archive, use_native=True)
    out["scan_equal"] = entries == native.zip_scan_central_directory(
        archive, use_native=False)
    out["entries"] = len(entries)
    zf = zipfile.ZipFile(io.BytesIO(archive))
    first_sweep = None
    for zi in zf.infolist():
        if zi.compress_type == zipfile.ZIP_DEFLATED:
            start = zi.header_offset
            name_len, extra_len = np.frombuffer(
                archive[start + 26: start + 30], "<u2")
            data = start + 30 + int(name_len) + int(extra_len)
            raw = archive[data: data + zi.compress_size]
            got = native.inflate_raw(raw, zi.file_size, use_native=True)
            want = native.inflate_raw(raw, zi.file_size, use_native=False)
            out["inflated"] += 1
            out["inflate_mismatches"] += got != want
        if zi.filename.endswith(".bin"):
            raw = zf.read(zi)
            for rng in (None, pc_range):
                a = native.decode_lidar_bin(raw, 5, 32768, rng,
                                            use_native=True)
                b = native.decode_lidar_bin(raw, 5, 32768, rng,
                                            use_native=False)
                out["decoded"] += 1
                out["decode_mismatches"] += not all(
                    x.dtype == y.dtype and x.tobytes() == y.tobytes()
                    for x, y in zip(a, b))
            if first_sweep is None:
                first_sweep = a
    if voxelizer is not None and first_sweep is not None:
        points, mask = first_sweep
        grids = [native.voxelize_points_host(points, mask, *voxelizer,
                                             use_native=flag)
                 for flag in (True, False)]
        out["voxelize_equal"] = grids[0].tobytes() == grids[1].tobytes()
        out["voxels"] = int(grids[0].sum())
    return out
