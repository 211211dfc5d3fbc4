"""The port's kernel build (``ops/_build.py``): a library is named by a
hash of its source, every shared header and the nvcc flags, so an edited
header is never served a stale library.  CPU only: nothing is compiled."""

import shutil

import pytest

from horovod_tpu_torch.ops import _build


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
