"""Combined multi-ZIP filesystem (``opendwm_tpu/fs/czip.py``).

Serves files from a set of ZIP archives as one namespace (reference
src/dwm/fs/czip.py:13-160): central directories are read once (optionally
from a precomputed ``.info.json`` offset cache so huge archives need no
directory scan), stored (uncompressed) members are served as range views
and deflated members are inflated in memory.

Every read goes through :class:`ArchiveReader`, one archive handle per
thread (and per process), so the bytes a member gives do not depend on how
many threads read the archive at once. The JAX package's filesystem shares
one handle between the threads of a process, and a seek by one thread
moves another's read.
"""

from __future__ import annotations

import io
import json
import os
import struct
import threading
import zipfile
import zlib
from typing import Optional

from opendwm_tpu_torch.config import register
from opendwm_tpu_torch.fs.base import FileSystem, LocalFileSystem


class ArchiveReader:
    """Positional reads of one archive through one handle per thread (and
    per process), so that no read moves another's position."""

    def __init__(self, fs, path: str):
        self.fs = fs
        self.path = path
        self._local = threading.local()

    def read_at(self, offset: int, size: int) -> bytes:
        """``size`` bytes from ``offset`` (fewer at the end of the file)."""
        handle = getattr(self._local, "handle", None)
        if handle is None or self._local.pid != os.getpid():
            handle = self._local.handle = self.fs.open(self.path, "rb")
            self._local.pid = os.getpid()
        handle.seek(offset)
        return handle.read(size)


class RangeReaderIO(io.RawIOBase):
    """Read-only view of a byte range of an archive (reference
    PartialReadableRawIO, src/dwm/common.py:9-64); ``read_at(offset, size)``
    reads the archive."""

    def __init__(self, read_at, start: int, end: int):
        super().__init__()
        self._read_at = read_at
        self._start = start
        self._end = end
        self._pos = 0

    def readable(self):
        return True

    def seekable(self):
        return True

    def seek(self, offset, whence=io.SEEK_SET):
        if whence == io.SEEK_SET:
            self._pos = offset
        elif whence == io.SEEK_CUR:
            self._pos += offset
        else:
            self._pos = (self._end - self._start) + offset
        return self._pos

    def tell(self):
        return self._pos

    def read(self, size=-1):
        remaining = (self._end - self._start) - self._pos
        if size is None or size < 0 or size > remaining:
            size = max(remaining, 0)
        if size == 0:
            return b""
        data = self._read_at(self._start + self._pos, size)
        self._pos += len(data)
        return data

    def readinto(self, b):  # BufferedReader's primitive
        data = self.read(len(b))
        b[: len(data)] = data
        return len(data)


def ls_index(index: dict, path: str, detail: bool, size_key: str) -> list:
    """``ls`` over the member names of a combined archive's index."""
    path = path.strip("/")
    entries = set()
    for name in index:
        if not path or name.startswith(path + "/"):
            rest = name[len(path) + 1 if path else 0:]
            first = rest.split("/")[0]
            entries.add((path + "/" + first if path else first, "/" in rest))
    out = []
    for name, is_dir in sorted(entries):
        if detail:
            out.append({
                "name": name,
                "type": "directory" if is_dir else "file",
                "size": None if is_dir else index[name][1][size_key],
            })
        else:
            out.append(name)
    return out


def load_cached_info(fs, archive: str) -> Optional[dict]:
    """The archive's ``.info.json`` offset cache, when it has one."""
    info_path = archive + ".info.json"
    if not fs.exists(info_path):
        return None
    with fs.open(info_path, "r") as f:
        return json.load(f)


@register(
    "CombinedZipFileSystem", aliases=("dwm.fs.czip.CombinedZipFileSystem",)
)
class CombinedZipFileSystem(FileSystem):
    protocol = "czip"

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
            else:
                self._scan_archive(archive)

    def _scan_archive(self, archive: str):
        """Index one archive's central directory: through the native
        scanner (``opendwm_tpu_torch.native``) when it builds, else
        zipfile."""
        try:
            from opendwm_tpu_torch import native

            if native.available():
                data = self.fs.cat_file(archive)
                for e in native.zip_scan_central_directory(data):
                    name = e.pop("name")
                    self._index[name] = (archive, e)
                return
        except Exception:
            pass  # fall back to the pure-Python scan
        with self.fs.open(archive, "rb") as f:
            zf = zipfile.ZipFile(f)
            for zi in zf.infolist():
                if zi.is_dir():
                    continue
                self._index[zi.filename] = (
                    archive,
                    {
                        "header_offset": zi.header_offset,
                        "compress_type": zi.compress_type,
                        "compress_size": zi.compress_size,
                        "file_size": zi.file_size,
                    },
                )

    def ls(self, path, detail=True, **kwargs):
        return ls_index(self._index, path, detail, "file_size")

    def exists(self, path, **kwargs):
        return path in self._index or bool(self.ls(path, detail=False))

    def info(self, path, **kwargs):
        if path in self._index:
            return {
                "name": path, "type": "file",
                "size": self._index[path][1]["file_size"],
            }
        if self.ls(path, detail=False):
            return {"name": path, "type": "directory", "size": None}
        raise FileNotFoundError(path)

    def _data_offset(self, reader: ArchiveReader, meta: dict) -> int:
        # Local file header: 30 bytes fixed + name len + extra len.
        header = reader.read_at(meta["header_offset"], 30)
        if header[:4] != b"PK\x03\x04":
            raise ValueError("bad local file header")
        name_len, extra_len = struct.unpack("<HH", header[26:30])
        return meta["header_offset"] + 30 + name_len + extra_len

    def _open(self, path, mode="rb", **kwargs):
        if "r" not in mode:
            raise NotImplementedError("read-only filesystem")
        if path not in self._index:
            raise FileNotFoundError(path)
        archive, meta = self._index[path]
        reader = self._readers[archive]
        data_start = self._data_offset(reader, meta)
        if meta["compress_type"] == zipfile.ZIP_STORED:
            return io.BufferedReader(RangeReaderIO(
                reader.read_at, data_start, data_start + meta["file_size"]))
        if meta["compress_type"] == zipfile.ZIP_DEFLATED:
            raw = reader.read_at(data_start, meta["compress_size"])
            return io.BytesIO(zlib.decompress(raw, -15))
        raise NotImplementedError(
            f"compression {meta['compress_type']} unsupported"
        )

    def make_info(self) -> dict:
        """Offset cache payload for ``.info.json`` files (reference
        tools/fs_make_info_json.py), by archive."""
        out: dict[str, dict] = {}
        for name, (archive, meta) in self._index.items():
            out.setdefault(archive, {})[name] = meta
        return out
