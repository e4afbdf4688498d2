"""The build cache of the port's CUDA kernels (``ops/native.py``): a
library's path follows its source, every header of ``csrc/`` and the
compiler flags, so that an edited header is rebuilt rather than a stale
library loaded. No ``nvcc`` is needed: only the paths are computed."""

import pytest

from diffusiondepth_tpu_torch.ops import native


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text('#include "common.cuh"\nextern "C" int f() { return 1; }\n')
    (src / "common.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(native, "CSRC_DIR", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    return src


@pytest.mark.parametrize("edit", ["header", "source", "new_header", "flags"])
def test_lib_path_follows_sources_headers_and_flags(csrc, monkeypatch, edit):
    before = native._lib_path("k")
    assert before == native._lib_path("k")  # stable while nothing changes
    assert before.parent == native.BUILD_DIR and before.name.startswith("libk_")
    if edit == "header":
        (csrc / "common.cuh").write_text("#pragma once\n// edited\n")
    elif edit == "source":
        (csrc / "k.cu").write_text('#include "common.cuh"\nextern "C" int f() { return 2; }\n')
    elif edit == "new_header":
        (csrc / "other.cuh").write_text("#pragma once\n")
    else:
        monkeypatch.setattr(native, "NVCC_FLAGS", native.NVCC_FLAGS + ("-DX",))
    assert native._lib_path("k") != before


def test_lib_path_ignores_other_files(csrc):
    before = native._lib_path("k")
    (csrc / "notes.txt").write_text("not compiled")
    (csrc / "other.cu").write_text("// another kernel's source")
    assert native._lib_path("k") == before
