"""The kernel build's staleness rule, without ``nvcc``: a library is rebuilt
when it is missing or older than its source or than any shared header
``csrc/*.cuh`` (here on a temporary copy of ``csrc/``, with a stand-in
for the built library)."""
import os
import shutil

import pytest

from repro_torch.kernels import build


@pytest.fixture
def copy(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    return csrc


def _age(path, seconds):
    t = path.stat().st_mtime - seconds
    os.utime(path, (t, t))


@pytest.mark.parametrize("name", ["flash_attention", "fused_mlp"])
def test_a_header_edit_marks_the_library_stale(copy, name):
    lib = build.CudaLibrary(name, lambda handle: None,
                            source=copy / f"{name}.cu")
    assert lib.stale()                     # nothing built yet
    lib.path.parent.mkdir(parents=True)
    lib.path.write_bytes(b"")              # stands in for the built .so
    for src in [lib.source, *copy.glob("*.cuh")]:
        _age(src, 60)
    assert not lib.stale()
    header = copy / "mma_bf16.cuh"
    assert header.exists()
    header.touch()                         # newer than the library
    assert lib.stale()


def test_a_source_edit_marks_the_library_stale(copy):
    lib = build.CudaLibrary("mamba2_ssd", lambda handle: None,
                            source=copy / "mamba2_ssd.cu")
    lib.path.parent.mkdir(parents=True)
    lib.path.write_bytes(b"")
    for src in [lib.source, *copy.glob("*.cuh")]:
        _age(src, 60)
    assert not lib.stale()
    lib.source.touch()
    assert lib.stale()


def test_the_kernels_that_include_the_header():
    """Both tensor-core kernels take their fragment helpers from the one
    shared header."""
    for name in ("flash_attention", "fused_mlp"):
        text = (build.CSRC / f"{name}.cu").read_text()
        assert '#include "mma_bf16.cuh"' in text
        assert "mma.sync.aligned" not in text   # only through the header
    header = (build.CSRC / "mma_bf16.cuh").read_text()
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in header
    assert "ldmatrix.sync.aligned.m8n8.x4.trans" in header
    assert "cp.async.cg.shared.global" in header


def test_a_variant_builds_the_same_source_with_its_flags(tmp_path,
                                                       monkeypatch):
    """A variant library (another name, extra ``nvcc`` flags) compiles the
    source it names into a library of its own; the package's libraries
    pass no extra flags."""
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    commands = []

    class FakeNvcc:
        returncode = 0

        def __init__(self, cmd, **kwargs):
            commands.append(cmd)
            out = cmd[cmd.index("-o") + 1]
            open(out, "wb").close()

        def communicate(self):
            return "", ""

    monkeypatch.setattr(build.subprocess, "Popen", FakeNvcc)
    from repro_torch.kernels import fused_mlp
    variant = build.CudaLibrary("fused_mlp_variant", lambda handle: None,
                                source=fused_mlp.LIBRARY.source,
                                flags=("-DSOME_MACRO",))
    build.build_libraries([fused_mlp.LIBRARY, variant])
    plain, varied = commands
    assert plain[-1] == varied[-1] == str(build.CSRC / "fused_mlp.cu")
    assert "-DSOME_MACRO" in varied and "-DSOME_MACRO" not in plain
    assert fused_mlp.LIBRARY.flags == ()
    assert variant.path == tmp_path / "libfused_mlp_variant.so"
    assert variant.path.exists() and fused_mlp.LIBRARY.path.exists()


def test_the_timing_probe_is_compiled_only_into_a_variant():
    """The fused MLP's probe bits (parts of the kernel switched off for
    timing) exist only under ``FUSED_MLP_PROBE``: the package's library
    exports no knob that changes its results."""
    text = (build.CSRC / "fused_mlp.cu").read_text()
    inside, guarded = False, []
    for line in text.splitlines():
        stripped = line.strip()
        if stripped.startswith("#ifdef FUSED_MLP_PROBE"):
            inside = True
        elif stripped.startswith(("#else", "#endif")):
            inside = False
        elif "probe" in stripped and not stripped.startswith("//"):
            guarded.append(inside)
    assert guarded and all(guarded)
