"""A small filesystem base class with the part of fsspec's interface that
the readers and the combined archives use, and a local filesystem on it.

The port cannot count on fsspec, so its filesystems derive from
:class:`FileSystem`: a subclass writes ``ls``, ``info`` and ``_open``
(binary reads), and gets ``open`` (text modes through ``TextIOWrapper``),
``cat_file``, ``exists``, ``isfile`` and ``find`` with fsspec's
semantics. An fsspec filesystem serves as the inner ``fs``
of the port's filesystems as well: they call only ``open``, ``cat_file``,
``exists``, ``ls`` and ``info`` on it.
"""

from __future__ import annotations

import io
import os

from opendwm_tpu_torch.config import register


class FileSystem:
    protocol = "abstract"
    root_marker = ""

    @classmethod
    def _strip_protocol(cls, path) -> str:
        path = os.fspath(path)
        protos = (cls.protocol,) if isinstance(cls.protocol, str) \
            else cls.protocol
        for protocol in protos:
            if path.startswith(protocol + "://"):
                path = path[len(protocol) + 3:]
        return path.rstrip("/") or cls.root_marker

    # -- to write in a subclass ----------------------------------------------

    def ls(self, path, detail=True, **kwargs):
        raise NotImplementedError

    def info(self, path, **kwargs) -> dict:
        raise NotImplementedError

    def _open(self, path, mode="rb", **kwargs):
        raise NotImplementedError

    # -- derived --------------------------------------------------------------

    def open(self, path, mode="rb", **kwargs):
        """A file object for ``path``; modes without ``b`` are text."""
        path = self._strip_protocol(path)
        if "b" not in mode:
            text_kwargs = {k: kwargs.pop(k) for k in
                           ("encoding", "errors", "newline") if k in kwargs}
            raw = self.open(path, mode.replace("t", "") + "b", **kwargs)
            return io.TextIOWrapper(raw, **text_kwargs)
        return self._open(path, mode=mode, **kwargs)

    def cat_file(self, path, **kwargs) -> bytes:
        with self.open(path, "rb", **kwargs) as f:
            return f.read()

    def exists(self, path, **kwargs) -> bool:
        try:
            self.info(path, **kwargs)
            return True
        except Exception:
            return False

    def isfile(self, path) -> bool:
        try:
            return self.info(path)["type"] == "file"
        except Exception:
            return False

    def find(self, path, **kwargs) -> list:
        """Every file below ``path`` (``path`` itself when it is a file),
        sorted by name, as fsspec's ``find``."""
        path = self._strip_protocol(path)
        out = set()

        def visit(directory):
            try:
                listing = self.ls(directory, detail=True, **kwargs)
            except OSError:
                return
            for info in listing:
                name = info["name"].rstrip("/")
                if info["type"] == "directory" and name != directory:
                    visit(name)
                else:
                    out.add(info["name"])

        visit(path)
        if not out and self.isfile(path):
            out.add(path)
        return sorted(out)


@register("LocalFileSystem",
          aliases=("fsspec.implementations.local.LocalFileSystem",))
class LocalFileSystem(FileSystem):
    """The host's files under absolute POSIX paths (fsspec's
    ``LocalFileSystem``, which ``configs/fs/local.json`` names)."""

    protocol = ("file", "local")
    root_marker = "/"

    @classmethod
    def _strip_protocol(cls, path) -> str:
        path = os.fspath(path)
        for protocol in cls.protocol:
            if path.startswith(protocol + "://"):
                path = path[len(protocol) + 3:]
                break
        path = os.path.abspath(os.path.expanduser(path))
        return path.rstrip("/") or cls.root_marker

    def info(self, path, **kwargs) -> dict:
        path = self._strip_protocol(path)
        st = os.stat(path)
        kind = "directory" if os.path.isdir(path) else \
            "file" if os.path.isfile(path) else "other"
        return {"name": path, "size": st.st_size, "type": kind,
                "mtime": st.st_mtime}

    def ls(self, path, detail=True, **kwargs):
        path = self._strip_protocol(path)
        if not os.path.isdir(path):
            infos = [self.info(path)]
        else:
            infos = [self.info(e.path) for e in
                     sorted(os.scandir(path), key=lambda e: e.name)]
        return infos if detail else [i["name"] for i in infos]

    def _open(self, path, mode="rb", **kwargs):
        return open(self._strip_protocol(path), mode)
