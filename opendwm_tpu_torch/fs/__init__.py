"""Storage layer of the port: a local filesystem, a path-prefix wrapper,
combined ZIP and TAR archives and S3, all on ``fs.base.FileSystem``
(``opendwm_tpu/fs``, which builds on fsspec)."""

from opendwm_tpu_torch.fs.base import FileSystem, LocalFileSystem  # noqa: F401
from opendwm_tpu_torch.fs.ctar import CombinedTarFileSystem  # noqa: F401
from opendwm_tpu_torch.fs.czip import CombinedZipFileSystem  # noqa: F401
from opendwm_tpu_torch.fs.dirfs import DirFileSystem  # noqa: F401
from opendwm_tpu_torch.fs.s3fs import ForkableS3FileSystem  # noqa: F401
