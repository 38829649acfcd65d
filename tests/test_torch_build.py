"""Library names of the port's CUDA build (``rollingdepth_torch.ops._build``).

A library's file name carries a hash of its ``csrc/<name>.cu`` source, of
every ``csrc/*.cuh`` header and of the nvcc flags, so an edit to any of
them builds a new library, and an untouched tree reuses the old one.  Only
paths are computed here: no nvcc, no card."""

import os

import pytest

from rollingdepth_torch.ops import _build


@pytest.fixture
def tree(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "kern.cu").write_text('#include "helpers.cuh"\nextern "C" int f() { return 0; }\n')
    (csrc / "helpers.cuh").write_text("// helpers, first version\n")
    monkeypatch.setattr(_build, "_CSRC", str(csrc))
    monkeypatch.setenv("ROLLINGDEPTH_TORCH_BUILD", str(tmp_path / "build"))
    return csrc


def test_untouched_tree_keeps_its_library(tree):
    path = _build._lib_path("kern")
    assert path == _build._lib_path("kern")
    assert path.startswith(str(tree.parent / "build")) and path.endswith(".so")


@pytest.mark.parametrize("edit", ["header", "new_header", "source", "flags"])
def test_edit_changes_the_library(tree, monkeypatch, edit):
    before = _build._lib_path("kern")
    if edit == "header":
        (tree / "helpers.cuh").write_text("// helpers, second version\n")
    elif edit == "new_header":
        (tree / "more.cuh").write_text("// another header\n")
    elif edit == "source":
        (tree / "kern.cu").write_text('#include "helpers.cuh"\nextern "C" int f() { return 1; }\n')
    else:
        monkeypatch.setattr(_build, "NVCC_FLAGS", [*_build.NVCC_FLAGS, "-lineinfo"])
    assert _build._lib_path("kern") != before


def test_files_other_than_sources_and_headers_do_not_count(tree):
    before = _build._lib_path("kern")
    (tree / "notes.txt").write_text("not compiled\n")
    assert _build._lib_path("kern") == before


def test_the_package_sources_hash():
    """The real tree: every source and the shared header are found."""
    paths = {name: _build._lib_path(name) for name in _build.SOURCES}
    assert len(set(paths.values())) == len(_build.SOURCES)


@pytest.mark.parametrize("name", ["flash_attn", "conv3x3", "group_norm", "coalign"])
def test_each_kernel_source_is_built(name):
    """The four kernel sources are in ``SOURCES`` (``build_all`` compiles
    each) and in the tree, each with a C entry point."""
    assert name in _build.SOURCES
    with open(os.path.join(_build._CSRC, name + ".cu")) as f:
        assert 'extern "C" int rd_' in f.read()
