"""Path-prefix filesystem wrapper (``opendwm_tpu/fs/dirfs.py``; reference
src/dwm/fs/dirfs.py:5-181)."""

from __future__ import annotations

from typing import Optional

from opendwm_tpu_torch.config import register
from opendwm_tpu_torch.fs.base import FileSystem, LocalFileSystem


@register("DirFileSystem", aliases=("dwm.fs.dirfs.DirFileSystem",))
class DirFileSystem(FileSystem):
    """Every path is relative to ``path`` on the inner ``fs`` (the local
    files by default)."""

    protocol = "dir"

    def __init__(self, path: str, fs: Optional[FileSystem] = None):
        self.path = path.rstrip("/")
        self.fs = fs or LocalFileSystem()
        # the inner filesystem's own spelling of the root (the local one
        # lists a relative root under its absolute path)
        strip = getattr(self.fs, "_strip_protocol", None)
        self._roots = tuple(dict.fromkeys(
            (self.path, strip(self.path) if strip and self.path
             else self.path)))

    def _join(self, p: str) -> str:
        p = p.lstrip("/")
        return f"{self.path}/{p}" if p else self.path

    def _strip(self, p: str) -> str:
        for root in self._roots:
            if p == root or p.startswith(root.rstrip("/") + "/"):
                return p[len(root):].lstrip("/")
        return p

    def ls(self, path, detail=True, **kwargs):
        out = self.fs.ls(self._join(path), detail=detail, **kwargs)
        if detail:
            return [dict(i, name=self._strip(i["name"])) for i in out]
        return [self._strip(i) for i in out]

    def info(self, path, **kwargs):
        i = dict(self.fs.info(self._join(path), **kwargs))
        i["name"] = self._strip(i["name"])
        return i

    def exists(self, path, **kwargs):
        return self.fs.exists(self._join(path), **kwargs)

    def cat_file(self, path, **kwargs):
        return self.fs.cat_file(self._join(path), **kwargs)

    def _open(self, path, mode="rb", **kwargs):
        return self.fs.open(self._join(path), mode=mode, **kwargs)
