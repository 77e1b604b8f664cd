"""ray_tpu_torch.ops._build: a kernel library's file name changes with every
file its source is built from, and with nothing else. Needs no nvcc: only
the hashing runs, on a copy of the kernel sources."""

import os
import shutil

import pytest

from ray_tpu_torch.ops import _build

KERNELS = ("flash_fwd", "flash_bwd")
HEADER = "attn_sm90.cuh"


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, copy)
    monkeypatch.setattr(_build, "CSRC_DIR", str(copy))
    return copy


def _paths():
    return {name: _build._lib_path(name) for name in KERNELS}


def test_sources_follow_includes_of_the_shared_header(csrc):
    for name in KERNELS:
        assert _build._sources(name) == [f"{name}.cu", HEADER]


def test_header_edit_changes_both_library_paths(csrc):
    before = _paths()
    assert _paths() == before  # stable for unchanged files
    header = csrc / HEADER
    header.write_text(header.read_text() + "\n// edited\n")
    after = _paths()
    for name in KERNELS:
        assert after[name] != before[name]
        assert os.path.dirname(after[name]) == _build.BUILD_DIR


def test_source_edit_changes_only_its_own_library_path(csrc):
    before = _paths()
    src = csrc / "flash_bwd.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    after = _paths()
    assert after["flash_bwd"] != before["flash_bwd"]
    assert after["flash_fwd"] == before["flash_fwd"]


def test_unrelated_files_leave_library_paths_alone(csrc):
    before = _paths()
    (csrc / "unused.cuh").write_text("// included by nothing\n")
    (csrc / "notes.txt").write_text("not a source\n")
    assert _paths() == before


def test_nested_header_is_followed(csrc):
    header = csrc / HEADER
    header.write_text(header.read_text() + '\n#include "nested.cuh"\n')
    (csrc / "nested.cuh").write_text("// v1\n")
    before = _paths()
    (csrc / "nested.cuh").write_text("// v2\n")
    after = _paths()
    assert all(after[name] != before[name] for name in KERNELS)
