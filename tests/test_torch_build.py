"""The kernel build's library names (``opendwm_tpu_torch/ops/_build.py``).

A library is named by a hash of its source and every header beside it, so
that a change to either builds anew instead of loading a stale library.
``_paths`` only reads files, and ptxas's report is read back from the file
kept beside the library: no nvcc is needed.
"""

import pytest

from opendwm_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "kern.cu").write_text(
        '#include "body.cuh"\nint f() { return g(); }\n')
    (src / "body.cuh").write_text("inline int g() { return 1; }\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return src


def test_library_named_by_source_hash(csrc, tmp_path):
    src, lib = _build._paths("kern.cu")
    assert src == csrc / "kern.cu"
    assert lib.parent == tmp_path / "build"
    assert lib.name.startswith("libkern_") and lib.suffix == ".so"
    assert _build._paths("kern.cu") == (src, lib)  # pure: same files, same name
    (csrc / "kern.cu").write_text("int f() { return 2; }\n")
    assert _build._paths("kern.cu")[1] != lib


@pytest.mark.parametrize("edit", ["change", "add", "remove"])
def test_header_edit_renames_library(csrc, edit):
    before = _build.library_path("kern.cu")
    if edit == "change":
        (csrc / "body.cuh").write_text("inline int g() { return 3; }\n")
    elif edit == "add":
        (csrc / "extra.cuh").write_text("// another header\n")
    else:
        (csrc / "body.cuh").unlink()
    assert _build.library_path("kern.cu") != before


def test_source_dir_renames_library(csrc, tmp_path):
    plain = _build.library_path("kern.cu")
    other = tmp_path / "other"
    other.mkdir()
    (other / "kern.cu").write_text("int f() { return 4; }\n")
    assert _build.library_path("kern.cu", csrc=other) != plain
    # files that are neither the source nor a header leave the name alone
    (csrc / "notes.txt").write_text("not a header\n")
    assert _build.library_path("kern.cu") == plain


def test_ptxas_report_reads_registers_and_spills(csrc):
    lib = _build.library_path("kern.cu")
    assert _build.ptxas_log_path(lib).parent == lib.parent
    lib.parent.mkdir(parents=True)
    _build.ptxas_log_path(lib).write_text(
        "ptxas info    : Compiling entry function '_Z9fwd_sm90v' for "
        "'sm_90a'\n"
        "ptxas info    : Function properties for _Z9fwd_sm90v\n"
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 128 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_Z5otherv' for 'sm_90a'\n"
        "ptxas info    : Used 40 registers\n")
    assert _build.ptxas_report(lib, "fwd_sm90") == {
        "_Z9fwd_sm90v": {"spill_bytes": 12, "registers": 128}}


def test_sass_census_counts_bulk_copies(monkeypatch):
    """``sass_census`` counts each opcode of ``SASS_OPCODES`` by function in
    ``cuobjdump -sass``'s listing, the 1-D bulk copy (``UBLKCP``, both
    directions) of the AdaLN ring too, and skips the other functions; a
    library is listed once, however many censuses read it."""
    listing = (
        "\t\tFunction : _ZN12_GLOBAL__N_119adaln_stream_kernelIfLb0ELi1024EEEv\n"
        "        /*0a10*/  UBLKCP.S.G [UR8], [UR4], UR6 ;\n"
        "        /*0b20*/  UBLKCP.G.S [UR10], [UR12], UR14 ;\n"
        "        /*0c30*/  LDS.128 R4, [R2] ;\n"
        "\t\tFunction : _ZN12_GLOBAL__N_116adaln_any_kernelIfLb0EEEv\n"
        "        /*0010*/  LDG.E R4, desc[UR4][R2.64] ;\n")

    class Done:
        stdout = listing

    calls = []
    monkeypatch.setattr(_build, "_tool", lambda name: name)
    monkeypatch.setattr(_build.subprocess, "run",
                        lambda *a, **k: calls.append(a) or Done())
    _build.sass_listing.cache_clear()
    census = _build.sass_census("lib.so", "adaln_stream_kernel")
    assert _build.sass_census("lib.so", "adaln_any_kernel")
    assert len(calls) == 1  # one listing a library
    _build.sass_listing.cache_clear()
    name = "_ZN12_GLOBAL__N_119adaln_stream_kernelIfLb0ELi1024EEEv"
    assert list(census) == [name]
    assert census[name] == {**dict.fromkeys(_build.SASS_OPCODES, 0),
                            "UBLKCP": 2}
