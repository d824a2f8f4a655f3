"""The kernel libraries' build paths (``ops/cuda_build.library_path``): a
library is rebuilt when one of its sources, or a header they include from
``csrc``, changes, and only then. Runs on the CPU: nothing is compiled."""

import torch_threads  # noqa: F401  (one torch thread a test worker)
import shutil

import pytest

from instarevive_tpu_torch.ops import cuda_build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of ``csrc`` that the build module reads instead of the package's."""
    copy = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC_DIR, copy)
    monkeypatch.setattr(cuda_build, "CSRC_DIR", copy)
    return copy


WGMMA_LIBRARIES = ("flash_attn_fwd", "flash_attn_bwd", "gn_conv", "swin_attention", "tf32_planes")  # the libraries that include hopper.cuh


def _paths():
    return {name: cuda_build.library_path(name, sources) for name, sources in cuda_build.LIBRARIES.items()}


def test_the_wgmma_libraries_include_the_hopper_header():
    includes = {name: cuda_build.headers(sources) for name, sources in cuda_build.LIBRARIES.items()}
    assert all(includes[name] == ["hopper.cuh"] for name in WGMMA_LIBRARIES)
    assert all(not found for name, found in includes.items() if name not in WGMMA_LIBRARIES)


def test_an_edited_header_moves_the_build_path_of_every_library_that_includes_it(csrc):
    before = _paths()
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// one more line\n")
    after = _paths()
    assert {name for name in before if before[name] != after[name]} == set(WGMMA_LIBRARIES)
    assert all(path.parent == cuda_build.BUILD_DIR for path in after.values())


def test_a_header_included_through_another_is_hashed_too(csrc):
    (csrc / "inner.cuh").write_text("#pragma once\n")
    header = csrc / "hopper.cuh"
    header.write_text('#include "inner.cuh"\n' + header.read_text())
    assert cuda_build.headers(cuda_build.LIBRARIES["gn_conv"]) == ["hopper.cuh", "inner.cuh"]
    before = _paths()
    (csrc / "inner.cuh").write_text("#pragma once\n// changed\n")
    after = _paths()
    assert {name for name in before if before[name] != after[name]} == set(WGMMA_LIBRARIES)


@pytest.mark.parametrize("library", sorted(cuda_build.LIBRARIES))
def test_an_edited_source_moves_only_its_own_build_path(csrc, library):
    before = _paths()
    for source in cuda_build.LIBRARIES[library]:
        path = csrc / source
        path.write_text(path.read_text() + "\n// one more line\n")
    after = _paths()
    assert {name for name in before if before[name] != after[name]} == {library}


def test_a_copy_of_the_sources_has_the_same_build_paths(tmp_path, monkeypatch):
    """The path hashes names and contents, not where csrc lies."""
    here = _paths()
    shutil.copytree(cuda_build.CSRC_DIR, tmp_path / "csrc")
    monkeypatch.setattr(cuda_build, "CSRC_DIR", tmp_path / "csrc")
    assert _paths() == here
