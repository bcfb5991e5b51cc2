"""The kernel build's cache key, on the CPU (no nvcc is run).

``genrec_tpu_torch/kernels/build.py`` names each built library by a hash
of its source, the ``csrc`` headers that the source includes (directly or
through other headers) and the nvcc flags, so that an edited header
rebuilds every library that includes it and loads no stale one.
"""

import pytest

from genrec_tpu_torch.kernels import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A csrc directory of its own: k.cu includes a.cuh, which includes
    b.cuh; c.cuh is included by nothing."""
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n#include "a.cuh"\nint k;\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\nint a;\n')
    (tmp_path / "b.cuh").write_text("#pragma once\nint b;\n")
    (tmp_path / "c.cuh").write_text("#pragma once\nint c;\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    return tmp_path


def test_included_headers_follow_includes(csrc):
    assert build.included_headers(csrc / "k.cu") == [csrc / "a.cuh", csrc / "b.cuh"]


@pytest.mark.parametrize("edited,rebuilds", [
    ("k.cu", True),    # the source
    ("a.cuh", True),   # a header it includes
    ("b.cuh", True),   # a header reached through another header
    ("c.cuh", False),  # a header it does not include
])
def test_an_edit_changes_the_library_path_of_what_includes_it(csrc, edited, rebuilds):
    before = build.library_path("k")
    path = csrc / edited
    path.write_text(path.read_text() + "// edited\n")
    assert (build.library_path("k") != before) == rebuilds
    assert build.library_path("k").name.startswith("libk-")


def test_the_same_files_give_the_same_path(csrc):
    assert build.library_path("k") == build.library_path("k")


def test_the_fused_ce_source_includes_the_sm90_header():
    headers = build.included_headers(build.source_path("fused_ce"))
    assert [h.name for h in headers] == ["sm90.cuh"]
    assert all(h.parent == build.CSRC for h in headers)
