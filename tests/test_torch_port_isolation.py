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

#: The modules that import Keras or TensorFlow.  Both import an installed
#: JAX on their own (under any KERAS_BACKEND), so these are imported in an
#: interpreter where JAX is blocked (``_IMPORT_FRONTENDS``); every other
#: module is imported in the open walk below.
_KERAS_TF = ("horovod_tpu_torch.tf", "horovod_tpu_torch.keras.callbacks")

_IMPORT_ALL = """
import importlib, os, pkgutil, sys
import horovod_tpu_torch
SKIP = %r
names = []


def walk(path, prefix, load):
    for info in pkgutil.iter_modules(path, prefix):
        names.append(info.name)
        here = load and not any(info.name == s or info.name.startswith(s + ".")
                                for s in SKIP)
        if here:
            importlib.import_module(info.name)
        if info.ispkg:
            walk([os.path.join(info.module_finder.path,
                               info.name.rsplit(".", 1)[1])],
                 info.name + ".", here)


walk(horovod_tpu_torch.__path__, "horovod_tpu_torch.", True)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "horovod_tpu",
                                    "keras", "tensorflow"))
print(len(names), bad)
assert not bad, bad
""" % (_KERAS_TF,)


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
    assert n_modules >= 110, out.stdout


#: The Keras and TensorFlow frontends and their examples.
_FRONTEND_MODULES = ["keras", "keras.impl", "keras.callbacks", "tf",
                     "tf.compression", "tf.mpi_ops", "tf.keras",
                     "examples.keras_mnist", "examples.tf_mnist"]

_BLOCK = ("import sys\n"
          "for m in %r:\n"
          "    sys.modules[m] = None\n")


def test_keras_and_tf_frontends_import_with_jax_blocked():
    """The frontends import (with Keras and TensorFlow, whose own imports
    of JAX are optional) in an interpreter where ``jax``, ``jaxlib`` and
    ``flax`` cannot be imported, as on the card's machine; neither JAX nor
    the JAX package is loaded."""
    code = (_BLOCK % (("jax", "jaxlib", "flax"),)
            + "import importlib\n"
            f"for m in {_FRONTEND_MODULES!r}:\n"
            "    importlib.import_module('horovod_tpu_torch.' + m)\n"
            "import horovod_tpu_torch.keras as k, keras\n"
            "assert k.callbacks.MetricAverageCallback\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'horovod_tpu') "
            "and sys.modules[m] is not None)\n"
            "assert not bad, bad\n"
            "print(keras.backend.backend())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=_env(KERAS_BACKEND="torch",
                                  CUDA_VISIBLE_DEVICES="",
                                  TF_CPP_MIN_LOG_LEVEL="2"),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.split()[-1] == "torch", out.stdout


def test_keras_core_imports_without_keras_tf_or_jax():
    """``horovod_tpu_torch.keras`` and its ``impl`` (the core the card
    runs: averaging and broadcast of torch tensors) import with Keras,
    TensorFlow and JAX all absent; the callbacks then fail to import."""
    code = (_BLOCK % (("jax", "jaxlib", "flax", "keras", "tensorflow"),)
            + "import horovod_tpu_torch.keras as k\n"
            "from horovod_tpu_torch.keras.impl import average_tensors\n"
            "try:\n"
            "    k.callbacks\n"
            "except ImportError:\n"
            "    print('callbacks need keras')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "callbacks need keras" in out.stdout


#: An import of JAX, flax or the JAX package (``horovod_tpu``, not
#: ``horovod_tpu_torch``) at the start of a line.
_JAX_IMPORT = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|flax|horovod_tpu)\b(?!_)", re.M)


def test_no_port_source_imports_jax_flax_or_the_jax_package():
    sources = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "horovod_tpu_torch")):
        sources += [os.path.join(root, f) for f in files
                    if f.endswith(".py")]
    for path in sources:
        with open(path) as f:
            assert not _JAX_IMPORT.search(f.read()), path
    for line in ("import jax", "  from jax import numpy", "import flax.linen",
                 "from horovod_tpu.keras import impl", "import horovod_tpu"):
        assert _JAX_IMPORT.search(line), line
    for line in ("import horovod_tpu_torch", "from horovod_tpu_torch import x",
                 "import jaxtyping", "x = 'import jax'"):
        assert not _JAX_IMPORT.search(line), line


_TRAINING_MODULES = ["common.basics", "ops.collective_ops", "ops.compression",
                     "ops.fusion", "ops.mixed_precision", "ops.losses",
                     "ops.flash_attention", "ops.rms_norm", "frontend",
                     "examples.llama_packed_pretraining", "models.bert",
                     "parallel.mesh", "parallel.api",
                     "examples.bert_pretraining_fsdp", "ops.conv_bn_stats",
                     "experiments.conv_bn_spike", "models.resnet",
                     "models.convert", "bench", "common.native_build",
                     "runtime", "runtime.engine", "runtime.staging",
                     "runtime.mpi_ops", "runtime.eager", "torch_frontend",
                     "runtime.sharded", "runtime.fsdp", "elastic",
                     "elastic.state", "runtime.sparse",
                     "runtime.wire_policy", "runtime.moe",
                     "parallel.comm", "parallel.placement",
                     "parallel.ring_attention", "parallel.seq",
                     "parallel.pipeline", "parallel.dryrun", "ops.ragged",
                     "examples.llama_training_5d", "common.launch",
                     "models.mnist", "models.word2vec", "training",
                     "training.state", "training.callbacks",
                     "training.checkpoint", "training.estimator",
                     "examples.common", "examples.jax_mnist",
                     "examples.flax_mnist", "examples.flax_mnist_advanced",
                     "examples.jax_mnist_estimator", "examples.jax_word2vec",
                     "examples.jax_imagenet_resnet50",
                     "examples.torch_mnist",
                     "examples.torch_imagenet_resnet50",
                     "examples.torch_synthetic_benchmark"]
#: The serving slice, the router fleet and its launcher and benchmark.
_SERVE_MODULES = ["serve", "serve.engine", "serve.scheduler", "serve.server",
                  "serve.replica", "serve.router", "run", "bench_serve"]
#: The observability and tuning planes.
_OBSERVABILITY_MODULES = ["timeline", "monitor", "monitor.metrics",
                          "monitor.server", "monitor.postmortem",
                          "autotune", "autotune.search", "autotune.store",
                          "autotune.config", "autotune.tuner",
                          "serve.tuner"]
#: A call of PyTorch's own RMSNorm (``F.rms_norm``, ``torch.rms_norm``,
#: ``torch.nn.functional.rms_norm``): a library kernel, not the port's.
_LIBRARY_RMS_NORM = re.compile(r"\b(F|functional|torch)\.rms_norm\b")


def test_training_slice_imports_no_jax_and_finds_no_library_attention():
    """Each module of the training, serving and observability slices,
    imported in a fresh interpreter, loads no JAX; and no source of the
    port calls a library attention or RMSNorm kernel."""
    code = ("import importlib, sys\n"
            f"for m in {_TRAINING_MODULES + _SERVE_MODULES
                        + _OBSERVABILITY_MODULES!r}:\n"
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


#: The weight plane, elastic recovery and the training launcher.
_WEIGHT_PLANE_MODULES = ["checkpoint", "checkpoint.manifest",
                         "checkpoint.stats", "checkpoint.writer",
                         "checkpoint.loader", "checkpoint.frontend",
                         "checkpoint.elastic", "checkpoint.push",
                         "elastic.driver", "elastic.state", "run",
                         "serve.engine", "serve.scheduler", "serve.router"]


def test_weight_plane_imports_no_jax_no_jax_package_no_ml_dtypes():
    """The checkpoint plane, the elastic driver and the launcher, imported
    in a fresh interpreter, load neither JAX, nor the JAX package, nor
    ``ml_dtypes`` (the card's machine has none: bf16 goes through torch);
    and no source of the port or ``chip_smoke.py`` imports it."""
    code = ("import importlib, sys\n"
            f"for m in {_WEIGHT_PLANE_MODULES!r}:\n"
            "    importlib.import_module('horovod_tpu_torch.' + m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'horovod_tpu', 'ml_dtypes'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    sources = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "horovod_tpu_torch")):
        sources += [os.path.join(root, f) for f in files
                    if f.endswith(".py")]
    imports = re.compile(r"^\s*(import|from)\s+ml_dtypes\b", re.M)
    for path in sources:
        with open(path) as f:
            assert not imports.search(f.read()), path
    assert imports.search("x = 1\n    import ml_dtypes\n")


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


#: The engine bench, its gates' rank bodies and the control-plane harness.
_ENGINE_BENCH_MODULES = ["bench_engine", "bench_engine_workers",
                         "scale_harness"]


def test_engine_bench_imports_no_jax_and_its_scale_rank_no_torch():
    """The engine bench's modules, imported in a fresh
    interpreter, load neither JAX nor the JAX package (and reach no
    reference worker under ``tests/``); the control plane's rank script,
    run by its path, loads neither torch nor the package (64 of them share
    one host)."""
    code = ("import importlib, sys\n"
            f"for m in {_ENGINE_BENCH_MODULES!r}:\n"
            "    importlib.import_module('horovod_tpu_torch.' + m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'horovod_tpu', 'scale', 'bench_engine',"
            " 'fsdp_worker', 'sharded_worker', 'native_worker'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    probe = ("import runpy, sys\n"
             "runpy.run_path(%r, run_name='not_main')\n"
             "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
             "('torch', 'numpy', 'horovod_tpu_torch', 'jax', "
             "'horovod_tpu'))\n"
             "assert not bad, bad\n"
             % os.path.join(REPO, "horovod_tpu_torch", "scale_worker.py"))
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=60)
    assert out.returncode == 0, out.stdout + out.stderr


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
