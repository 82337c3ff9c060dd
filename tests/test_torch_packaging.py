"""PyTorch port: what an installed ``repro_torch`` carries and where it builds
its kernels.

``pyproject.toml``'s package data must list every file of the package that
is not Python (the kernel sources, the headers they include, the
auditor's budgets): a wheel ships only what is listed, and an installed
port without its headers cannot build a kernel.  The build directory is the
package's ``_build/`` when that is writable, else a user cache directory;
a build that cannot make its directory raises, naming it.
"""
import fnmatch
import os
import pathlib

import pytest

try:
    import tomllib
except ModuleNotFoundError:              # Python < 3.11
    tomllib = pytest.importorskip("tomli")

from repro_torch.kernels import _build

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
SKIP_DIRS = {"_build", "__pycache__"}


def _package_globs():
    with open(ROOT / "pyproject.toml", "rb") as f:
        data = tomllib.load(f)
    return data["tool"]["setuptools"]["package-data"]["repro_torch"]


def _data_files():
    out = []
    for dirpath, dirnames, filenames in os.walk(PKG):
        dirnames[:] = [d for d in dirnames if d not in SKIP_DIRS]
        for name in filenames:
            if not name.endswith((".py", ".pyc")):
                out.append((pathlib.Path(dirpath) / name).relative_to(PKG)
                           .as_posix())
    return sorted(out)


def test_every_data_file_is_package_data():
    globs = _package_globs()
    files = _data_files()
    missing = [f for f in files
               if not any(fnmatch.fnmatchcase(f, g) for g in globs)]
    assert not missing, f"not in [tool.setuptools.package-data]: {missing}"
    # the files an installed port needs at run time are among them
    for need in ("csrc/butcher_combine.cuh", "csrc/attention_mask.cuh",
                 "csrc/wgmma_tf32.cuh", "analysis/budgets.json",
                 "csrc/flash_attention.cu"):
        assert need in files


@pytest.mark.parametrize("glob", _package_globs())
def test_every_package_glob_matches_a_file(glob):
    assert any(fnmatch.fnmatchcase(f, glob) for f in _data_files()), glob


def test_every_local_include_is_shipped():
    """Each ``#include "..."`` of a kernel source names a file in csrc/
    that the package data ships."""
    globs = _package_globs()
    for source in sorted(_build.CSRC.glob("*.cu*")):
        for name in _build._LOCAL_INCLUDE.findall(source.read_bytes()):
            rel = f"csrc/{name.decode()}"
            assert (PKG / rel).exists(), (source.name, rel)
            assert any(fnmatch.fnmatchcase(rel, g) for g in globs), rel


def test_build_dir_in_a_writable_package(monkeypatch):
    monkeypatch.setattr(_build.os, "access", lambda path, mode: True)
    assert _build.build_dir() == _build.BUILD_DIR


def test_build_dir_read_only_package_uses_the_user_cache(monkeypatch,
                                                         tmp_path):
    monkeypatch.setattr(_build.os, "access", lambda path, mode: False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    assert _build.build_dir() == tmp_path / "repro_torch" / "_build"
    monkeypatch.delenv("XDG_CACHE_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert _build.build_dir() == \
        tmp_path / "home" / ".cache" / "repro_torch" / "_build"


def test_unmakeable_build_dir_raises_naming_it(monkeypatch, tmp_path):
    """No fallback: a build that cannot make its directory raises before
    any compiler runs, and names the directory it could not make (here
    the user cache directory of a read-only package, under a file)."""
    blocker = tmp_path / "file"
    blocker.write_text("")
    monkeypatch.setattr(_build.os, "access", lambda path, mode: False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(blocker))
    with pytest.raises(RuntimeError, match="cannot make the kernel build "
                                           "directory") as e:
        _build._compile(_build.CSRC / "rmsnorm.cu")
    assert str(blocker / "repro_torch" / "_build") in str(e.value)
