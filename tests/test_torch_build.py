"""The kernel build's cache key: a library is named by a hash of its source
and of the shared headers beside it, so an edited header is never served by
a stale build. Runs without nvcc: it only names targets."""

import shutil

import pytest

from hivedscheduler_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path):
    """A copy of the kernels' sources and headers."""
    return shutil.copytree(_build.CSRC, tmp_path / "csrc")


def test_sources_share_a_header():
    assert [h.name for h in sorted(_build.CSRC.glob("*.cuh"))] == ["hopper.cuh"]
    for src in _build.sources():
        assert '#include "hopper.cuh"' in src.read_text()


def test_copied_sources_keep_their_targets(csrc):
    for src in _build.sources():
        assert _build._target(csrc / src.name) == _build._target(src)


@pytest.mark.parametrize("name", ["flash_fwd.cu", "flash_bwd.cu"])
def test_editing_the_header_changes_the_target(csrc, name):
    before = _build._target(csrc / name)
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = _build._target(csrc / name)
    assert after != before
    assert after.parent == _build.BUILD_DIR and after.name.startswith(f"{name[:-3]}-")


@pytest.mark.parametrize("name", ["flash_fwd.cu", "flash_bwd.cu"])
def test_editing_the_source_changes_only_its_target(csrc, name):
    other = ({"flash_fwd.cu", "flash_bwd.cu"} - {name}).pop()
    before = {n: _build._target(csrc / n) for n in (name, other)}
    (csrc / name).write_text((csrc / name).read_text() + "\n// edited\n")
    assert _build._target(csrc / name) != before[name]
    assert _build._target(csrc / other) == before[other]


def test_a_new_header_changes_the_target(csrc):
    before = _build._target(csrc / "flash_fwd.cu")
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _build._target(csrc / "flash_fwd.cu") != before


def test_other_files_do_not_change_the_target(csrc):
    before = _build._target(csrc / "flash_fwd.cu")
    (csrc / "notes.txt").write_text("not a header")
    assert _build._target(csrc / "flash_fwd.cu") == before
