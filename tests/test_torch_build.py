"""rovaca_tpu_torch's nvcc build helper, without nvcc: the staleness rule.

A library is rebuilt when any file in csrc/ is newer than it, so an edit to
a shared header rebuilds every kernel that may include it.
"""

import os
import re

import pytest

from rovaca_tpu_torch.ops import build


def _touch(path, mtime):
    path.write_text("x")
    os.utime(path, (mtime, mtime))


@pytest.fixture
def tree(tmp_path):
    src = tmp_path / "csrc"
    src.mkdir()
    _touch(src / "kernel.cu", 1000)
    _touch(src / "shared.cuh", 1000)
    out = tmp_path / "libkernel.so"
    _touch(out, 2000)
    return src, out


def test_missing_library_is_stale(tree):
    src, out = tree
    out.unlink()
    assert build.is_stale(str(out), str(src))


def test_library_newer_than_every_source_is_fresh(tree):
    src, out = tree
    assert not build.is_stale(str(out), str(src))


@pytest.mark.parametrize("edited", ["kernel.cu", "shared.cuh",
                                    "other_kernel.cu"])
def test_any_newer_file_in_csrc_makes_it_stale(tree, edited):
    src, out = tree
    _touch(src / edited, 3000)
    assert build.is_stale(str(out), str(src))


def test_pairhmm_kernels_share_one_sweep():
    """Both PairHMM kernels include the shared header and call its sweep;
    neither carries a copy of the recurrence."""
    for name in ("pairhmm_indexed", "pairhmm_dense"):
        with open(os.path.join(build.CSRC, f"{name}.cu")) as f:
            text = f.read()
        assert '#include "pairhmm_forward.cuh"' in text
        assert "rovaca::pair_forward<RMAX>(" in text
        assert not re.search(r"__shfl_up_sync", text)
    assert os.path.exists(os.path.join(build.CSRC, "sw_banded.cu"))
