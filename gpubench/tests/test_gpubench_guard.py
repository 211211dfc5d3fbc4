"""The whole-name check for JAX and the JAX package, and the
references' independence from the program."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from gpubench import guard, manifest

HERE = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("names,found", [
    (["horovod_tpu_torch", "horovod_tpu_torch.ops.fusion"], []),
    (["horovod_tpu"], ["horovod_tpu"]),
    (["horovod_tpu.jax", "numpy"], ["horovod_tpu"]),
    (["jax", "jax._src.core"], ["jax"]),
    (["jaxlib.xla_client"], ["jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["jaxtyping", "flaxy", "horovod_tpu_tools"], []),
])
def test_names_are_compared_whole(names, found):
    assert guard.forbidden_modules(names) == found


def test_a_run_loads_nothing_forbidden():
    # The harness, the program's families and the references, imported
    # and driven on the CPU as far as a model and a reference loss.
    code = (
        "import sys, torch\n"
        "from gpubench import run, guard\n"
        "from gpubench.tests.conftest import tiny_cell\n"
        "import horovod_tpu_torch as hvd\n"
        "hvd.init(device='cpu')\n"
        "for w in ('bert_base.pretrain_s512', 'resnet50.train_b256'):\n"
        "    cell = tiny_cell(w)\n"
        "    p = run.Program(cell, 3, 0, 1)\n"
        "    p.next()\n"
        "hvd.shutdown()\n"
        "print(guard.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    tops = {name.split(".")[0] for name in imports(path)}
    assert not tops & {"horovod_tpu_torch", "horovod_tpu", "jax", "flax"}
    assert not any(n.startswith("gpubench.families") for n in imports(path))


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_the_benchmark_never_imports_jax(path):
    tops = {name.split(".")[0] for name in imports(path)}
    assert not tops & guard.FORBIDDEN


def test_a_directory_with_the_benchmark_alone_finds_no_program(tmp_path):
    # BENCHMARK.json and the benchmark's files, without the program: the
    # harness's look for the program fails, so a run exits non-zero.
    import shutil

    shutil.copy(manifest.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = "from gpubench import run; print(run._program_here())"
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "False"
