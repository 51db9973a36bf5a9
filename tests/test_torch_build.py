"""The kernels' build (``neuralsim_tpu_torch.kernels.build``): the library
name hashes each source with the headers it includes, so an edited shared
header rebuilds every kernel that includes it instead of loading a stale
library."""

import shutil

import pytest

from neuralsim_tpu_torch.kernels import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy)
    monkeypatch.setattr(build, "CSRC", copy)
    return copy


# the headers each source includes: the streaming core of the nets past
# the other cores, the tensor-core core of the bf16 kernels, which includes
# the shared FP32 core; the hash-grid march includes none of them
HEADERS = {"nerf_march": ["nerf_mlp_stream.cuh", "nerf_mlp_wgmma.cuh", "nerf_mlp.cuh"],
           "nerf_mlp": ["nerf_mlp_stream.cuh", "nerf_mlp_wgmma.cuh", "nerf_mlp.cuh"],
           "render_tile": ["nerf_mlp_stream.cuh", "nerf_mlp_wgmma.cuh", "nerf_mlp.cuh"],
           "ngp_march": []}


@pytest.mark.parametrize("name", build.SOURCES)
def test_every_source_includes_the_shared_core(name):
    assert [h.name for h in build.headers(build.CSRC / f"{name}.cu")] == HEADERS[name]


@pytest.mark.parametrize("name", build.SOURCES)
def test_editing_a_header_changes_the_library_path(csrc, name):
    before = build.library_path(name)
    assert build.library_path(name) == before              # deterministic
    (csrc / "unused.cuh").write_text("// included by no source\n")
    assert build.library_path(name) == before
    header = csrc / "nerf_mlp.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert (build.library_path(name) != before) == ("nerf_mlp.cuh" in HEADERS[name])


@pytest.mark.parametrize("name", build.SOURCES)
def test_editing_the_wgmma_core_rebuilds_only_its_kernels(csrc, name):
    before = build.library_path(name)
    header = csrc / "nerf_mlp_wgmma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    includes = "nerf_mlp_wgmma.cuh" in HEADERS[name]
    assert (build.library_path(name) != before) == includes


def test_nested_headers_are_followed(csrc):
    before = build.library_path("nerf_mlp")
    core = csrc / "nerf_mlp.cuh"
    core.write_text('#include "inner.cuh"\n' + core.read_text())
    (csrc / "inner.cuh").write_text("// v1\n")
    with_inner = build.library_path("nerf_mlp")
    (csrc / "inner.cuh").write_text("// v2\n")
    assert len({before, with_inner, build.library_path("nerf_mlp")}) == 3
    assert [h.name for h in build.headers(csrc / "nerf_mlp.cu")] == [
        "nerf_mlp_stream.cuh", "nerf_mlp_wgmma.cuh", "nerf_mlp.cuh", "inner.cuh"]


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(build.os.path, "exists", lambda p: False)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_all()
