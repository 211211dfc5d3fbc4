"""The port's kernel build (``ops/_build.py``): a library is named by a
hash of its source, every shared header and the nvcc flags, so an edited
header is never served a stale library.  The engine's build
(``common/native_build.py``): its library is named by a hash of every
file of ``cpp/`` and of the compiler flags, and ``cpp/`` is a verbatim copy
of the JAX package's engine sources.  CPU only: nothing is compiled."""

import os
import shutil

import pytest

from horovod_tpu_torch.common import native_build
from horovod_tpu_torch.ops import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ENGINE_FILES = sorted(p.name for p in native_build.CPP_DIR.iterdir()
                       if p.suffix in (".cc", ".h") or p.name == "Makefile")


@pytest.fixture
def csrc(monkeypatch, tmp_path):
    """A copy of ``csrc/`` that ``_build`` reads in place of the real one."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


def test_every_kernel_source_is_found(csrc):
    assert set(_build.sources()) == {"conv_bn_stats", "flash_attention",
                                     "paged_attention", "rms_norm"}
    assert (csrc / "hopper.cuh").is_file()
    for name in ("conv_bn_stats", "flash_attention", "rms_norm"):
        assert '#include "hopper.cuh"' in (csrc / f"{name}.cu").read_text()


@pytest.mark.parametrize("name", ["conv_bn_stats", "flash_attention",
                                  "paged_attention", "rms_norm"])
def test_target_follows_the_shared_header(csrc, name):
    """Editing a header renames every library; editing one source renames
    its own library only; the same bytes give the same name."""
    src = _build.sources()[name]
    before = _build._target(src)
    assert before == _build._target(src)
    assert before.parent == _build.BUILD_DIR
    assert before.name.startswith(f"lib{name}-") and before.suffix == ".so"
    header = csrc / "hopper.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = _build._target(src)
    assert after != before
    other = next(p for n, p in _build.sources().items() if n != name)
    other.write_bytes(other.read_bytes() + b"\n// edited\n")
    assert _build._target(src) == after


def test_a_new_header_renames_the_libraries(csrc):
    src = _build.sources()["rms_norm"]
    before = _build._target(src)
    (csrc / "extra.cuh").write_text("// another shared header\n")
    assert _build._target(src) != before


@pytest.mark.parametrize("name", _ENGINE_FILES)
def test_engine_sources_are_a_verbatim_copy(name):
    with open(os.path.join(REPO, "horovod_tpu", "cpp", name), "rb") as f:
        want = f.read()
    assert (native_build.CPP_DIR / name).read_bytes() == want


@pytest.fixture
def cpp(tmp_path):
    copy = tmp_path / "cpp"
    shutil.copytree(native_build.CPP_DIR, copy)
    return copy


def test_engine_library_follows_every_source_and_flag(cpp, monkeypatch):
    """Any edited file of ``cpp/`` or any changed flag renames the engine
    library; the same bytes and flags give the same name."""
    assert len(_ENGINE_FILES) == 15
    before = native_build.lib_path(cpp)
    assert before == native_build.lib_path(cpp)
    assert before.parent == native_build.BUILD_DIR
    assert before.name.startswith("libhorovod_core-")
    assert before.suffix == ".so"
    seen = {before}
    for name in _ENGINE_FILES:
        src = cpp / name
        src.write_bytes(src.read_bytes() + b"\n")
        after = native_build.lib_path(cpp)
        assert after not in seen, name
        seen.add(after)
    for attr in ("CXXFLAGS", "LDFLAGS", "LDLIBS"):
        with monkeypatch.context() as m:
            m.setattr(native_build, attr,
                      getattr(native_build, attr) + ("-g",))
            after = native_build.lib_path(cpp)
        assert after not in seen, attr
        seen.add(after)
    assert native_build.lib_path(cpp) in seen
    assert "-Wl,-Bsymbolic" in native_build.LDFLAGS
    assert "-fno-gnu-unique" in native_build.CXXFLAGS
