"""The port stands alone: no module of ``horovod_tpu_torch`` and not
``chip_smoke.py`` imports JAX or anything of ``horovod_tpu``, and
``chip_smoke.py`` fails (and prints no result) without a GPU or without
the rest of the repository.

Subprocesses: this test process has JAX and the JAX package loaded
already (tests/conftest.py), so only a fresh interpreter can tell.
"""

import os
import re
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import horovod_tpu_torch
names = [m.name for m in pkgutil.walk_packages(horovod_tpu_torch.__path__,
                                               "horovod_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "horovod_tpu"))
print(len(names), bad)
assert not bad, bad
"""


def _env(**extra):
    env = dict(os.environ, **extra)
    env.pop("PYTHONPATH", None)
    return env


def test_port_and_chip_smoke_import_no_jax_and_no_jax_package():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 45, out.stdout


_TRAINING_MODULES = ["common.basics", "ops.collective_ops", "ops.compression",
                     "ops.fusion", "ops.mixed_precision", "ops.losses",
                     "ops.flash_attention", "ops.rms_norm", "frontend",
                     "examples.llama_packed_pretraining", "models.bert",
                     "parallel.mesh", "parallel.api",
                     "examples.bert_pretraining_fsdp", "ops.conv_bn_stats",
                     "experiments.conv_bn_spike", "models.resnet",
                     "models.convert", "bench", "common.native_build",
                     "runtime", "runtime.engine", "runtime.staging",
                     "runtime.mpi_ops", "runtime.eager"]
#: A call of PyTorch's own RMSNorm (``F.rms_norm``, ``torch.rms_norm``,
#: ``torch.nn.functional.rms_norm``): a library kernel, not the port's.
_LIBRARY_RMS_NORM = re.compile(r"\b(F|functional|torch)\.rms_norm\b")


def test_training_slice_imports_no_jax_and_finds_no_library_attention():
    """Each module of the training slice, imported alone in a fresh
    interpreter, loads no JAX; and no source of the port calls a
    library attention or RMSNorm kernel."""
    code = ("import importlib, sys\n"
            f"for m in {_TRAINING_MODULES!r}:\n"
            "    importlib.import_module('horovod_tpu_torch.' + m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'horovod_tpu'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    pkg = os.path.join(REPO, "horovod_tpu_torch")
    for root, _, files in os.walk(pkg):
        for name in files:
            if name.endswith((".py", ".cu")):
                with open(os.path.join(root, name)) as f:
                    text = f.read()
                assert "scaled_dot_product_attention" not in text, name
                assert not _LIBRARY_RMS_NORM.search(text), name
    assert _LIBRARY_RMS_NORM.search("y = F.rms_norm(x, (4096,))")


_ALONE = """
import sys, torch
from horovod_tpu_torch.common import native_build
lib = native_build.lib_path()
assert lib.is_file() and str(lib).startswith(sys.argv[1]), lib
stamp = lib.stat().st_mtime_ns
import horovod_tpu_torch as hvd
hvd.init(device="cpu")
x = torch.arange(6.0)
out = hvd.allreduce(x, name="alone")
assert torch.equal(out, x) and out.data_ptr() != x.data_ptr()
assert native_build.load()._name == str(lib)
hvd.shutdown()
assert lib.stat().st_mtime_ns == stamp
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "horovod_tpu"))
assert not bad, bad
print("alone ok")
"""


def test_engine_builds_and_runs_from_the_package_alone(tmp_path):
    """A copy of ``horovod_tpu_torch/`` with no ``horovod_tpu/`` beside it
    (and the library already built here, so nothing is compiled twice)
    loads its engine and runs ``init`` and an allreduce at size 1."""
    from horovod_tpu_torch.common import native_build

    native_build.build()
    shutil.copytree(os.path.join(REPO, "horovod_tpu_torch"),
                    tmp_path / "horovod_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "*.lock"))
    assert sorted(os.listdir(tmp_path)) == ["horovod_tpu_torch"]
    env = {k: v for k, v in _env().items()
           if not k.startswith(("HOROVOD_", "OMPI_", "PMI_"))}
    out = subprocess.run([sys.executable, "-c", _ALONE, str(tmp_path)],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "alone ok" in out.stdout


def test_chip_smoke_fails_without_gpu():
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=_env(CUDA_VISIBLE_DEVICES=""),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "CUDA" in out.stderr


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
