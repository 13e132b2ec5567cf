"""The port's kernel build (``evox_tpu_torch/ops/_build.py``): a library's
name carries a hash of its source, of every shared header under ``csrc/``
and of the flags, so an edit to any of them builds a new library.  No
``nvcc`` needed: only the names are computed."""

import shutil

import pytest

from evox_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path):
    return shutil.copytree(_build.CSRC, tmp_path / "csrc")


def test_sources_are_listed_and_present():
    assert {"topk", "crowding"} <= set(_build.SOURCES)
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").is_file()
    assert (_build.CSRC / "radix_sort.cuh").is_file()


def test_library_path_is_that_of_the_package_sources(csrc):
    for name in _build.SOURCES:
        assert _build._library_path(name, csrc) == _build._library_path(name)


@pytest.mark.parametrize("name", ["topk", "crowding"])
def test_header_edit_changes_the_library_path(csrc, name):
    before = {n: _build._library_path(n, csrc) for n in _build.SOURCES}
    header = csrc / "radix_sort.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build._library_path(name, csrc) != before[name]
    # A new header counts too.
    after = _build._library_path(name, csrc)
    (csrc / "extra.h").write_text("#pragma once\n")
    assert _build._library_path(name, csrc) != after


def test_source_edit_changes_only_its_library(csrc):
    before = {n: _build._library_path(n, csrc) for n in _build.SOURCES}
    src = csrc / "topk.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build._library_path("topk", csrc) != before["topk"]
    assert _build._library_path("crowding", csrc) == before["crowding"]


def test_every_quoted_include_is_in_the_package_data():
    """An installed copy builds every kernel: each ``#include "..."`` of a
    source or header under ``csrc/`` names a file there that
    ``pyproject.toml``'s package data for the port matches."""
    import fnmatch
    import re
    import tomllib

    pyproject = tomllib.loads((_build._PKG.parent / "pyproject.toml").read_text())
    patterns = pyproject["tool"]["setuptools"]["package-data"]["evox_tpu_torch"]
    files = sorted([*_build.CSRC.glob("*.cu"), *_build.CSRC.glob("*.cuh"), *_build.CSRC.glob("*.h")])
    included = set()
    for f in files:
        assert any(fnmatch.fnmatch(f"csrc/{f.name}", p) for p in patterns), f.name
        included |= set(re.findall(r'^\s*#include\s+"([^"]+)"', f.read_text(), re.M))
    assert {"radix_sort.cuh", "philox.cuh"} <= included
    for name in included:
        assert (_build.CSRC / name).is_file(), name
        assert any(fnmatch.fnmatch(f"csrc/{name}", p) for p in patterns), name
