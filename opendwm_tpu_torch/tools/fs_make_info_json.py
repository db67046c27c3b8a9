"""Build ``.info.json`` offset caches for czip/ctar archives.

The port of ``opendwm_tpu/tools/fs_make_info_json.py``,
on the port's readers, filesystems and registry; host-side.

Reference src/dwm/tools/fs_make_info_json.py — precomputing central-directory
(or tar header) offsets lets dataloader workers open huge archives without a
directory scan.

    python -m opendwm_tpu_torch.tools.fs_make_info_json a.zip b.tar ...
"""

from __future__ import annotations

import argparse
import json
import tarfile

from opendwm_tpu_torch.fs import LocalFileSystem
from opendwm_tpu_torch.fs.czip import CombinedZipFileSystem


def make_zip_info(path: str, fs=None) -> dict:
    czfs = CombinedZipFileSystem(fs=fs, paths=[path])
    return czfs.make_info()[path]


def make_tar_info(path: str, fs=None) -> dict:
    fs = fs or LocalFileSystem()
    out = {}
    with fs.open(path, "rb") as f:
        tf = tarfile.open(fileobj=f, mode="r:")
        for member in tf:
            if member.isfile():
                out[member.name] = {
                    "offset_data": member.offset_data,
                    "size": member.size,
                }
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("archives", nargs="+")
    args = parser.parse_args(argv)
    for path in args.archives:
        if path.endswith(".zip"):
            info = make_zip_info(path)
        elif path.endswith(".tar"):
            info = make_tar_info(path)
        else:
            print(f"skip {path}: unknown archive type")
            continue
        out = path + ".info.json"
        with open(out, "w") as f:
            json.dump(info, f)
        print(f"wrote {out} ({len(info)} entries)")


if __name__ == "__main__":
    main()
