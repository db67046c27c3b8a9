"""Fork-safe S3 filesystem with HTTP Range reads
(``opendwm_tpu/fs/s3fs.py``).

Reference src/dwm/fs/s3fs.py:8-175 — botocore-backed, recreating the client
after fork (boto clients are not fork-safe) and reading byte ranges on
demand. botocore is imported when the filesystem is constructed, and its
absence raises a clear error there.
"""

from __future__ import annotations

import io
import os
from typing import Optional

from opendwm_tpu_torch.config import register
from opendwm_tpu_torch.fs.base import FileSystem


class S3File(io.RawIOBase):
    def __init__(self, fs: "ForkableS3FileSystem", bucket: str, key: str):
        super().__init__()
        self.fs = fs
        self.bucket = bucket
        self.key = key
        self._pos = 0
        self._size: Optional[int] = None

    def readable(self):
        return True

    def seekable(self):
        return True

    @property
    def size(self) -> int:
        if self._size is None:
            head = self.fs.client.head_object(
                Bucket=self.bucket, Key=self.key
            )
            self._size = head["ContentLength"]
        return self._size

    def seek(self, offset, whence=io.SEEK_SET):
        if whence == io.SEEK_SET:
            self._pos = offset
        elif whence == io.SEEK_CUR:
            self._pos += offset
        else:
            self._pos = self.size + offset
        return self._pos

    def tell(self):
        return self._pos

    def read(self, size=-1):
        if size == 0:
            return b""
        end = "" if size < 0 else self._pos + size - 1
        resp = self.fs.client.get_object(
            Bucket=self.bucket, Key=self.key,
            Range=f"bytes={self._pos}-{end}",
        )
        data = resp["Body"].read()
        self._pos += len(data)
        return data


@register(
    "ForkableS3FileSystem", aliases=("dwm.fs.s3fs.ForkableS3FileSystem",)
)
class ForkableS3FileSystem(FileSystem):
    protocol = "s3"

    def __init__(self, endpoint_url=None, retries: int = 8, **kwargs):
        try:
            import botocore  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "ForkableS3FileSystem requires botocore, which is not "
                "installed in this environment."
            ) from e
        super().__init__()
        self._client_kwargs = dict(kwargs)
        self._endpoint = endpoint_url
        self._retries = retries
        self._client = None
        self._client_pid = None

    @property
    def client(self):
        pid = os.getpid()
        if self._client is None or self._client_pid != pid:
            import botocore.config
            import botocore.session

            session = botocore.session.get_session()
            self._client = session.create_client(
                "s3",
                endpoint_url=self._endpoint,
                config=botocore.config.Config(
                    retries={"max_attempts": self._retries}
                ),
                **self._client_kwargs,
            )
            self._client_pid = pid
        return self._client

    @staticmethod
    def _split(path: str) -> tuple[str, str]:
        path = path.lstrip("/")
        bucket, _, key = path.partition("/")
        return bucket, key

    def ls(self, path, detail=True, **kwargs):
        bucket, prefix = self._split(path)
        paginator = self.client.get_paginator("list_objects_v2")
        out = []
        for page in paginator.paginate(
            Bucket=bucket, Prefix=prefix, Delimiter="/"
        ):
            for cp in page.get("CommonPrefixes", []):
                name = f"{bucket}/{cp['Prefix'].rstrip('/')}"
                out.append(
                    {"name": name, "type": "directory", "size": None}
                    if detail else name
                )
            for obj in page.get("Contents", []):
                name = f"{bucket}/{obj['Key']}"
                out.append(
                    {"name": name, "type": "file", "size": obj["Size"]}
                    if detail else name
                )
        return out

    def info(self, path, **kwargs):
        bucket, key = self._split(path)
        head = self.client.head_object(Bucket=bucket, Key=key)
        return {"name": path, "type": "file", "size": head["ContentLength"]}

    def _open(self, path, mode="rb", **kwargs):
        if "r" not in mode:
            raise NotImplementedError("read-only filesystem")
        bucket, key = self._split(path)
        return io.BufferedReader(S3File(self, bucket, key))
