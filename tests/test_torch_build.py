"""The kernel builder names each library by a digest of its source, the
shared headers and the flags: an edited shared header rebuilds every
kernel that includes it, an edited source rebuilds only its own kernel.
Generated kernels (the direct kernel, one per chain shape) are keyed by
their source and the shared headers alike.  The edits go to a temporary
copy of csrc/, never to the package."""
import shutil

import pytest

from presto_tpu_torch.exec.kernels import build
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    return csrc


def _paths():
    return {n: build.library_path(n) for n in build.SOURCES}


def test_every_source_is_built():
    assert sorted(p.stem for p in build.CSRC.glob("*.cu")) == \
        sorted(build.SOURCES)
    assert list(build.CSRC.glob("*.cuh")), "the shared header is missing"


def test_header_edit_changes_every_digest(csrc_copy):
    before = _paths()
    assert _paths() == before                    # stable for equal bytes
    header = csrc_copy / "scan_common.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = _paths()
    for name in build.SOURCES:
        assert after[name] != before[name], name


def test_source_edit_changes_only_its_digest(csrc_copy):
    before = _paths()
    src = csrc_copy / "scan_grouped.cu"
    src.write_bytes(src.read_bytes() + b"\n// edited\n")
    after = _paths()
    assert after["scan_grouped"] != before["scan_grouped"]
    assert after["window_scan"] == before["window_scan"]


def test_generated_key_follows_source_and_header(csrc_copy):
    src = '#include "scan_common.cuh"\nextern "C" __global__ void k() {}\n'
    key = build._hash_source(src)
    # the key a launch uses is this hash, kept per source for the process
    assert build.gen_key(src) == key == build._hash_source(src)
    assert build._hash_source(src + "// other\n") != key
    header = csrc_copy / "scan_common.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    assert build._hash_source(src) != key


def test_generated_modules_compile_for_sm_90a():
    assert "--gpu-architecture=sm_90a" in build.NVRTC_OPTIONS
    assert f"-I{build.CSRC}" in build.NVRTC_OPTIONS
    assert build.GEN_DIR.parent == build.BUILD_DIR
