"""The port's storage layer (``opendwm_tpu_torch/fs``) against the JAX
package's (``opendwm_tpu/fs``) on the JAX tests' own archives
(``tests/test_fs.py::archives``, ``tests/test_fs_preset_configs.py``):
the same bytes, listings, infos, finds and offset caches; every member
read correctly from 8 threads at once (the JAX package's handle is
shared between threads); an fsspec filesystem as the inner ``fs``; the
storage presets through the port's registry; S3 without botocore."""

import io
import json
import os
import tarfile
import threading
import zipfile
from concurrent.futures import ThreadPoolExecutor

import fsspec
import numpy as np
import pytest
from test_fs import archives  # noqa: F401  (the JAX test's fixture)
from test_fs_preset_configs import (  # noqa: F401
    FS_CONFIGS,
    HAS_BOTO,
    _collect_paths,
    _retarget_local,
    _uses_s3,
    fixture_root,
)

from opendwm_tpu import fs as jfs
from opendwm_tpu_torch import fs as pfs
from opendwm_tpu_torch.config import create_instance_from_config, get_class


def both(cls_name, *args, **kwargs):
    return getattr(pfs, cls_name)(*args, **kwargs), \
        getattr(jfs, cls_name)(*args, **kwargs)


@pytest.fixture(scope="module")
def zip_paths(archives):  # noqa: F811
    return [str(archives / "a.zip"), str(archives / "b.zip")]


@pytest.mark.parametrize("member", ["scene/0/img.bin", "scene/0/meta.txt",
                                    "scene/1/img.bin"])
def test_czip_reads_as_jax(zip_paths, member):
    port, ref = both("CombinedZipFileSystem", paths=zip_paths)
    assert port.cat_file(member) == ref.cat_file(member)
    with port.open(member) as f, ref.open(member) as g:
        assert f.read(3) == g.read(3)
        f.seek(1)
        g.seek(1)
        assert f.read() == g.read()


def test_czip_lists_and_infos_as_jax(zip_paths):
    port, ref = both("CombinedZipFileSystem", paths=zip_paths)
    for path in ("", "scene", "scene/0", "scene/0/meta.txt"):
        assert port.ls(path, detail=False) == ref.ls(path, detail=False)
        assert port.ls(path) == ref.ls(path)
        assert port.find(path) == ref.find(path)
        assert port.exists(path) == ref.exists(path)
        assert port.info(path) == ref.info(path)
    assert list(port._index) == list(ref._index)
    assert port.make_info() == ref.make_info()
    with pytest.raises(FileNotFoundError):
        port.open("missing")
    assert not port.exists("missing")


def test_czip_cached_info_roundtrip(archives, tmp_path):  # noqa: F811
    """The port's ``make_info`` written as ``.info.json`` serves the JAX
    filesystem and the port's alike (``enable_cached_info``)."""
    src = archives / "a.zip"
    zip_path = tmp_path / "a.zip"
    zip_path.write_bytes(src.read_bytes())
    info = pfs.CombinedZipFileSystem(paths=[str(zip_path)]).make_info()
    (tmp_path / "a.zip.info.json").write_text(
        json.dumps(info[str(zip_path)]))
    port, ref = both("CombinedZipFileSystem", paths=[str(zip_path)],
                     enable_cached_info=True)
    assert port._index == ref._index
    assert port.cat_file("scene/0/meta.txt") == b"hello"
    # the cache is read, not the archive: a member the cache names only
    info[str(zip_path)]["alias.txt"] = info[str(zip_path)]["scene/0/meta.txt"]
    (tmp_path / "a.zip.info.json").write_text(
        json.dumps(info[str(zip_path)]))
    cached = pfs.CombinedZipFileSystem(paths=[str(zip_path)],
                                       enable_cached_info=True)
    assert cached.cat_file("alias.txt") == b"hello"


def test_czip_scans_without_the_native_library(zip_paths, monkeypatch):
    from opendwm_tpu_torch import native

    with_native = pfs.CombinedZipFileSystem(paths=zip_paths)._index
    monkeypatch.setattr(native, "available", lambda: False)
    assert pfs.CombinedZipFileSystem(paths=zip_paths)._index == with_native


def test_ctar_as_jax(archives, tmp_path):  # noqa: F811
    path = str(archives / "c.tar")
    port, ref = both("CombinedTarFileSystem", paths=[path])
    assert port.cat_file("lidar/0.bin") == ref.cat_file("lidar/0.bin")
    for p in ("", "lidar", "lidar/0.bin"):
        assert port.ls(p) == ref.ls(p)
        assert port.info(p) == ref.info(p)
        assert port.find(p) == ref.find(p)
    assert list(port._index) == list(ref._index)
    (tmp_path / "c.tar.info.json").write_text(json.dumps(
        {name: meta for name, (_, meta) in port._index.items()}))
    local = tmp_path / "c.tar"
    local.write_bytes((archives / "c.tar").read_bytes())
    cached = pfs.CombinedTarFileSystem(paths=[str(local)],
                                       enable_cached_info=True)
    assert cached._index["lidar/0.bin"][1] == port._index["lidar/0.bin"][1]
    assert cached.cat_file("lidar/0.bin") == b"tar-member-payload"


def test_dirfs_as_jax(archives):  # noqa: F811
    root = str(archives)
    port, ref = both("DirFileSystem", root)
    assert port.cat_file("plain/x.txt") == ref.cat_file("plain/x.txt")
    assert port.exists("plain/x.txt") and not port.exists("plain/y.txt")
    for p in ("", "plain", "plain/x.txt"):
        assert sorted(port.ls(p, detail=False)) == \
            sorted(ref.ls(p, detail=False))
        assert port.find(p) == ref.find(p)
    assert port.info("plain/x.txt")["size"] == ref.info("plain/x.txt")["size"]
    with port.open("plain/x.txt", "r") as f:
        assert f.read() == "dirfs"


def test_dirfs_with_a_relative_root(archives, monkeypatch):  # noqa: F811
    monkeypatch.chdir(archives)
    port = pfs.DirFileSystem("plain")
    assert port.ls("", detail=False) == ["x.txt"]
    assert port.find("") == ["x.txt"]


def test_local_filesystem_as_fsspec(archives):  # noqa: F811
    port, ref = pfs.LocalFileSystem(), fsspec.filesystem("file")
    root = str(archives)
    assert port.find(root) == ref.find(root)
    assert sorted(port.ls(root, detail=False)) == \
        sorted(ref.ls(root, detail=False))
    member = os.path.join(root, "plain", "x.txt")
    assert port.cat_file(member) == ref.cat_file(member)
    assert port.info(member)["size"] == ref.info(member)["size"]
    assert port.info(member)["type"] == "file"
    assert port.exists(member) and not port.exists(member + "~")


def test_fsspec_filesystems_serve_as_the_inner_fs(archives):  # noqa: F811
    """fsspec's own local and dir filesystems under the port's archives."""
    inner = fsspec.filesystem("dir", path=str(archives))
    port = pfs.CombinedZipFileSystem(fs=inner, paths=["a.zip", "b.zip"])
    ref = jfs.CombinedZipFileSystem(fs=inner, paths=["a.zip", "b.zip"])
    for member in ref._index:
        assert port.cat_file(member) == ref.cat_file(member)
    tar = pfs.CombinedTarFileSystem(fs=fsspec.filesystem("file"),
                                    paths=[str(archives / "c.tar")])
    assert tar.cat_file("lidar/0.bin") == b"tar-member-payload"
    dirfs = pfs.DirFileSystem(str(archives), fs=fsspec.filesystem("file"))
    assert dirfs.cat_file("plain/x.txt") == b"dirfs"
    assert dirfs.find("plain") == ["plain/x.txt"]


# -- many threads on one archive ---------------------------------------------

@pytest.fixture(scope="module")
def many_members(tmp_path_factory):
    """64 stored zip members, 16 deflated ones and 64 tar members of
    distinct random bytes."""
    root = tmp_path_factory.mktemp("threads")
    rng = np.random.default_rng(0)
    stored = {f"s/{i:02d}.bin": rng.bytes(int(rng.integers(20_000, 60_000)))
              for i in range(64)}
    deflated = {f"d/{i:02d}.bin": bytes(rng.integers(0, 4, 50_000,
                                                     dtype=np.uint8))
                for i in range(16)}
    with zipfile.ZipFile(root / "s.zip", "w", zipfile.ZIP_STORED) as zf:
        for name, data in stored.items():
            zf.writestr(name, data)
    with zipfile.ZipFile(root / "d.zip", "w", zipfile.ZIP_DEFLATED) as zf:
        for name, data in deflated.items():
            zf.writestr(name, data)
    with tarfile.open(root / "t.tar", "w") as tf:
        for name, data in stored.items():
            ti = tarfile.TarInfo(name)
            ti.size = len(data)
            tf.addfile(ti, io.BytesIO(data))
    return root, stored, deflated


def read_from_threads(fs, members: dict, threads=8, rounds=3) -> int:
    """Members read wrong (or raising) when ``threads`` threads read every
    member ``rounds`` times, all at once."""
    start = threading.Barrier(threads)

    def worker(k):
        start.wait()
        bad = 0
        names = list(members)[k::threads] * rounds
        names += list(members)[::-1]  # and every member once more
        for name in names:
            try:
                with fs.open(name) as f:
                    head = f.read(17)
                    rest = f.read()
                bad += head + rest != members[name]
                bad += fs.cat_file(name) != members[name]
            except Exception:
                bad += 1
        return bad

    with ThreadPoolExecutor(threads) as pool:
        return sum(pool.map(worker, range(threads)))


@pytest.mark.parametrize("inner", ["local", "fsspec"])
def test_czip_reads_every_member_from_8_threads(many_members, inner):
    root, stored, deflated = many_members
    fs = None if inner == "local" else fsspec.filesystem("file")
    czip = pfs.CombinedZipFileSystem(
        fs=fs, paths=[str(root / "s.zip"), str(root / "d.zip")])
    assert read_from_threads(czip, {**stored, **deflated}) == 0


@pytest.mark.parametrize("inner", ["local", "fsspec"])
def test_ctar_reads_every_member_from_8_threads(many_members, inner):
    root, stored, _ = many_members
    fs = None if inner == "local" else fsspec.filesystem("file")
    ctar = pfs.CombinedTarFileSystem(fs=fs, paths=[str(root / "t.tar")])
    assert read_from_threads(ctar, stored) == 0


# -- the registry and the storage presets ------------------------------------

@pytest.mark.parametrize("name,alias", [
    ("CombinedZipFileSystem", "dwm.fs.czip.CombinedZipFileSystem"),
    ("CombinedTarFileSystem", "dwm.fs.ctar.CombinedTarFileSystem"),
    ("DirFileSystem", "dwm.fs.dirfs.DirFileSystem"),
    ("ForkableS3FileSystem", "dwm.fs.s3fs.ForkableS3FileSystem"),
    ("LocalFileSystem", "fsspec.implementations.local.LocalFileSystem"),
])
def test_filesystems_resolve(name, alias):
    cls = get_class(alias)
    assert cls is get_class(name) and cls.__name__ == name
    assert cls.__module__.startswith("opendwm_tpu_torch.fs")


@pytest.mark.parametrize(
    "path", FS_CONFIGS, ids=[os.path.basename(p) for p in FS_CONFIGS]
)
def test_fs_preset_through_the_port(path, fixture_root):  # noqa: F811
    root, members = fixture_root
    with open(path) as f:
        cfg = json.load(f)
    if _uses_s3(cfg) and not HAS_BOTO:
        with pytest.raises(ImportError, match="botocore"):
            create_instance_from_config(json.loads(json.dumps(cfg)))
        return
    local = json.loads(json.dumps(cfg))
    _retarget_local(local, root)
    fs = create_instance_from_config(local)
    assert type(fs).__module__.startswith("opendwm_tpu_torch.fs")
    rels = _collect_paths(cfg)
    if rels:
        with fs.open(members[rels[0]], "rb") as f:
            assert f.read() == f"payload:{rels[0]}".encode()
    elif local["_class_name"].endswith("LocalFileSystem"):
        with fs.open(os.path.join(root, "nuscenes", "sample.txt"), "rb") as f:
            assert f.read() == b"plain payload"
    else:
        with fs.open("nuscenes/sample.txt", "rb") as f:
            assert f.read() == b"plain payload"
