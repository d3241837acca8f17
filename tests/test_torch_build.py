"""The kernels' build (``repro_torch.kernels._build``): a library is named
by the hash of its source and of every shared ``csrc/*.cuh`` header, so an
edit to a header builds it anew.  Runs on the CPU: nothing is compiled."""
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa


def test_header_edit_renames_the_library(tmp_path):
    src = tmp_path / "kern.cu"
    src.write_text('#include "common.cuh"\nextern "C" int f() { return 0; }\n')
    header = tmp_path / "common.cuh"
    header.write_text("#pragma once\n")
    (tmp_path / "notes.txt").write_text("a")
    first = _build.library_path(src)
    assert first == _build.library_path(src)
    assert first.parent == _build.BUILD_DIR and first.name.startswith("libkern-")
    (tmp_path / "notes.txt").write_text("b")          # not a header: same library
    assert _build.library_path(src) == first
    header.write_text("#pragma once\n// edited\n")
    second = _build.library_path(src)
    assert second != first
    (tmp_path / "extra.cuh").write_text("")           # a new header counts too
    assert _build.library_path(src) not in (first, second)


def test_attention_sources_include_the_shared_header():
    header = _build.CSRC / "hopper.cuh"
    assert header.exists()
    for src in (fa.SRC, fa.BWD_SRC):
        assert '#include "hopper.cuh"' in src.read_text()
