"""Combined multi-TAR filesystem for uncompressed tars
(``opendwm_tpu/fs/ctar.py``; reference src/dwm/fs/ctar.py:9-121).

Member data is served as range views into the archives (uncompressed TAR
members are contiguous), with optional ``.info.json`` offset caches. Reads
go through one archive handle per thread (``czip.ArchiveReader``), so
threads never share a seek.
"""

from __future__ import annotations

import io
import tarfile
from typing import Optional

from opendwm_tpu_torch.config import register
from opendwm_tpu_torch.fs.base import FileSystem, LocalFileSystem
from opendwm_tpu_torch.fs.czip import (
    ArchiveReader,
    RangeReaderIO,
    load_cached_info,
    ls_index,
)


@register(
    "CombinedTarFileSystem", aliases=("dwm.fs.ctar.CombinedTarFileSystem",)
)
class CombinedTarFileSystem(FileSystem):
    protocol = "ctar"

    def __init__(
        self,
        fs: Optional[FileSystem] = None,
        paths: Optional[list[str]] = None,
        enable_cached_info: bool = False,
    ):
        self.fs = fs or LocalFileSystem()
        self.paths = paths or []
        self._index: dict[str, tuple[str, dict]] = {}
        self._readers = {
            archive: ArchiveReader(self.fs, archive) for archive in self.paths
        }
        for archive in self.paths:
            info = (load_cached_info(self.fs, archive)
                    if enable_cached_info else None)
            if info is not None:
                for name, meta in info.items():
                    self._index[name] = (archive, meta)
                continue
            with self.fs.open(archive, "rb") as f:
                for member in tarfile.open(fileobj=f, mode="r:"):
                    if member.isfile():
                        self._index[member.name] = (archive, {
                            "offset_data": member.offset_data,
                            "size": member.size,
                        })

    def ls(self, path, detail=True, **kwargs):
        return ls_index(self._index, path, detail, "size")

    def info(self, path, **kwargs):
        if path in self._index:
            return {
                "name": path, "type": "file",
                "size": self._index[path][1]["size"],
            }
        if self.ls(path, detail=False):
            return {"name": path, "type": "directory", "size": None}
        raise FileNotFoundError(path)

    def _open(self, path, mode="rb", **kwargs):
        if "r" not in mode:
            raise NotImplementedError("read-only filesystem")
        if path not in self._index:
            raise FileNotFoundError(path)
        archive, meta = self._index[path]
        start = meta["offset_data"]
        return io.BufferedReader(RangeReaderIO(
            self._readers[archive].read_at, start, start + meta["size"]))
