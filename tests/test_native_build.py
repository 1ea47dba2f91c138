"""The native cores are built from source on the host that loads them; a
failed build never loads an existing binary (utils/native_build.py)."""
import ctypes
import logging
import os

import pytest

from sdvpcmdecoder_tpu.ops import stitch_native as sn
from sdvpcmdecoder_tpu.pipeline import ingest
from sdvpcmdecoder_tpu.utils import native_build


def _stale_pair(tmp_path, src_name, lib_name):
    """A source the compiler rejects, next to an OLDER binary."""
    src = tmp_path / src_name
    src.write_text("#error this source does not build\n")
    lib = tmp_path / lib_name
    lib.write_bytes(b"\x7fELF stale binary from another host")
    old = src.stat().st_mtime - 3600
    os.utime(lib, (old, old))
    return src, lib


@pytest.mark.parametrize("loader", ["stitch", "ingest"])
def test_failed_build_never_loads_stale_binary(tmp_path, monkeypatch,
                                               caplog, loader):
    if loader == "stitch":
        src, lib = _stale_pair(tmp_path, "stitchcore.cpp", "libsdvstitch.so")
        monkeypatch.setattr(sn, "_SRC", src)
        monkeypatch.setattr(sn, "_LIB", None)
        monkeypatch.setattr(sn, "_TRIED", False)
        monkeypatch.delenv("SDV_NO_NATIVE", raising=False)
        load = sn._load
    else:
        src, lib = _stale_pair(tmp_path, "loader.cpp", "libsdvloader.so")
        monkeypatch.setattr(ingest, "_LOADER_SRC", src)
        monkeypatch.setattr(ingest, "_NATIVE", None)
        monkeypatch.setattr(ingest, "_NATIVE_TRIED", False)
        load = ingest._native_lib
    opened = []
    real_cdll = ctypes.CDLL
    monkeypatch.setattr(ctypes, "CDLL",
                        lambda path, *a, **k: opened.append(str(path))
                        or real_cdll(path, *a, **k))
    with caplog.at_level(logging.WARNING):
        assert load() is None
    assert str(lib) not in opened
    assert "does not build" in caplog.text       # the compiler's message
    assert lib.read_bytes().startswith(b"\x7fELF stale")


def test_build_raises_with_compiler_message(tmp_path):
    src, lib = _stale_pair(tmp_path, "broken.cpp", "libbroken.so")
    with pytest.raises(native_build.BuildError, match="does not build"):
        native_build.build(src, lib.name, (["-O1"], ["-O0"]))
    assert not list(tmp_path.glob(".libbroken.*"))   # no temp left behind


def test_build_then_reuse_until_source_changes(tmp_path, monkeypatch):
    src = tmp_path / "k.cpp"
    src.write_text('extern "C" int k_value() { return 7; }\n')
    lib = native_build.build(src, "libk.so", (["-O1"],))
    assert ctypes.CDLL(str(lib)).k_value() == 7
    # Up to date: no compiler run at all.
    monkeypatch.setattr(native_build.subprocess, "run",
                        lambda *a, **k: pytest.fail("rebuilt needlessly"))
    assert native_build.build(src, "libk.so", (["-O1"],)) == lib
    monkeypatch.undo()
    # A newer source forces a rebuild.
    before = lib.read_bytes()
    src.write_text('extern "C" int k_value() { return 8; }\n')
    newer = lib.stat().st_mtime + 10
    os.utime(src, (newer, newer))
    assert native_build.build(src, "libk.so", (["-O1"],)) == lib
    assert lib.read_bytes() != before
