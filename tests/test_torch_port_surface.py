"""The port's public surface against the reference's.

Every module of ``horovod_tpu`` that lists ``__all__`` has a counterpart
in ``horovod_tpu_torch`` (at the same path, or at the one
:data:`RENAMED` gives) that defines each of those names at its top level
(a ``def``, ``class``, assignment or import there), except the pinned
exceptions below, each with its reason.  Both sides are read as source
(``ast``): nothing of ``horovod_tpu`` is imported, and neither are Keras
or TensorFlow, which some of the port's frontends import.
"""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: Reference module -> the port's counterpart ("" is the package itself).
RENAMED = {
    # ``import horovod_tpu.jax as hvd`` reads ``import horovod_tpu_torch
    # as hvd``; so does the torch frontend's ``import horovod_tpu.torch``.
    "jax": "",
    "torch": "",
    "torch.compression": "ops.compression",
    "torch.mpi_ops": "",
    # The Keras-role training layer (fit, callbacks, checkpoints, the
    # Estimator) is the counterpart of the flax frontend.
    "flax": "training",
    "flax.callbacks": "training.callbacks",
    "flax.checkpoint": "training.checkpoint",
    "flax.estimator": "training.estimator",
}

#: Reference modules with no counterpart, and why.
NO_COUNTERPART = {
    "common.jax_compat": "shims between JAX releases; the port runs no JAX",
    "torch.bridge": "to_jax/from_jax: the port holds no JAX arrays",
    "version": "the port's version is horovod_tpu_torch.__version__",
}

#: (reference module, name) the port leaves out on purpose, and why.
PINNED = {
    ("common", "HorovodBasics"):
        "the port's basics is a module of functions, not a class",
    ("common.basics", "HorovodBasics"):
        "the port's basics is a module of functions, not a class",
    ("common.basics", "basics"):
        "the reference's singleton instance; the module is the port's",
    ("common.native_build", "ensure_native_lib"):
        "the port's engine build has its own names (native_build.build)",
    ("common.native_build", "native_lib_path"):
        "the port's engine build has its own names (native_build.build)",
    ("ops.mixed_precision", "master_weights"):
        "an optax transformation; the port's form is MasterWeights",
    ("ops.mixed_precision", "cast_compute"):
        "an optax-era cast of a param tree; the port casts with "
        "model.to(dtype)",
    ("torch", "bridge"): "the JAX bridge (see torch.bridge above)",
}


def _source(package: str, module: str) -> str:
    base = os.path.join(REPO, package, *module.split(".")) if module \
        else os.path.join(REPO, package)
    if os.path.isdir(base):
        return os.path.join(base, "__init__.py")
    return base + ".py"


def _reference_alls():
    """{reference module: its __all__}, every module that lists one."""
    out = {}
    root = os.path.join(REPO, "horovod_tpu")
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            rel = os.path.relpath(path, root)[:-3].replace(os.sep, ".")
            mod = rel[:-len("__init__")].rstrip(".") \
                if rel.endswith("__init__") else rel
            tree = ast.parse(open(path).read())
            for node in tree.body:
                if isinstance(node, ast.Assign) and any(
                        getattr(t, "id", None) == "__all__"
                        for t in node.targets):
                    out[mod] = list(ast.literal_eval(node.value))
    return out


def _defined(path: str) -> set:
    """The names ``path`` binds at its top level (inside top-level ``if``
    and ``try`` blocks too); a package's submodules besides."""
    names = set()
    if path.endswith("__init__.py"):
        here = os.path.dirname(path)
        names.update(f[:-3] if f.endswith(".py") else f
                     for f in os.listdir(here)
                     if f.endswith(".py") or os.path.exists(
                         os.path.join(here, f, "__init__.py")))

    def visit(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                names.add(node.name)
            elif isinstance(node, (ast.Import, ast.ImportFrom)):
                names.update((a.asname or a.name).split(".")[0]
                             for a in node.names)
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    names.update(n.id for n in ast.walk(t)
                                 if isinstance(n, ast.Name))
            elif isinstance(node, ast.If):
                visit(node.body)
                visit(node.orelse)
            elif isinstance(node, ast.Try):
                visit(node.body)
                for h in node.handlers:
                    visit(h.body)
                visit(node.orelse)
    visit(ast.parse(open(path).read()).body)
    return names


REFERENCE = _reference_alls()


@pytest.mark.parametrize("module", sorted(REFERENCE),
                         ids=lambda m: m or "horovod_tpu")
def test_port_defines_the_references_public_names(module):
    port = RENAMED.get(module, module)
    path = _source("horovod_tpu_torch", port)
    if module in NO_COUNTERPART:
        assert not os.path.exists(path), (
            f"{path} exists: take {module!r} out of NO_COUNTERPART")
        return
    assert os.path.exists(path), f"no counterpart of {module!r} at {path}"
    defined = _defined(path)
    missing = [n for n in REFERENCE[module]
               if n not in defined and (module, n) not in PINNED]
    assert not missing, (f"horovod_tpu_torch.{port or ''} lacks "
                         f"{missing} of horovod_tpu.{module}.__all__")


def test_pinned_exceptions_are_still_exceptions():
    """Each pin names a module and a name the reference still exports, and
    the port still lacks (a pin that no longer holds is taken out)."""
    for module, name in PINNED:
        assert name in REFERENCE[module], (module, name)
        port = RENAMED.get(module, module)
        assert name not in _defined(_source("horovod_tpu_torch", port)), \
            (module, name)
    for module in NO_COUNTERPART:
        assert os.path.exists(_source("horovod_tpu", module)), module
