"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

The port's counterpart of ``horovod_tpu/common/native_build.py``.  Each
source is compiled by ``nvcc`` for Hopper into a shared library with a
plain C interface and loaded with ``ctypes`` — no PyTorch headers, so a
build takes seconds, not minutes::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>-<hash>.so csrc/<name>.cu

Libraries land in ``horovod_tpu_torch/_build/`` (ignored by git), named by
a hash of the source, every shared header (``csrc/*.cuh``, which the
sources include) and the flags, so an edited source or header is never
served by a stale library.  ``ptxas``'s register/shared-memory report is
kept beside each library (``.log``).  A build failure raises with nvcc's
output; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = ["build", "load", "build_log", "sources", "BUILD_DIR"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def sources() -> Dict[str, Path]:
    """Kernel name -> source file, for every ``csrc/*.cu``."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin and PATH); the CUDA kernels of "
                       "horovod_tpu_torch are built with nvcc at first use")


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> float:
    """Compile the named kernels (default: all) that are not built yet,
    one ``nvcc`` per source, all started together.  Returns the wall
    seconds spent; raises ``RuntimeError`` if any build fails."""
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    t0 = time.monotonic()
    with _lock:
        todo = {}
        for name in names:
            if name not in srcs:
                raise KeyError(f"no kernel source csrc/{name}.cu")
            target = _target(srcs[name])
            if not target.is_file():
                todo[name] = target
        if not todo:
            return 0.0
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name, target in todo.items():
            tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(srcs[name])]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT),
                           tmp, target)
        failed = []
        for name, (proc, tmp, target) in procs.items():
            out, _ = proc.communicate()
            log = out.decode(errors="replace")
            if proc.returncode != 0:
                failed.append(f"csrc/{name}.cu (nvcc exit "
                              f"{proc.returncode}):\n{log}")
                tmp.unlink(missing_ok=True)
                continue
            target.with_suffix(".log").write_text(log)
            os.replace(tmp, target)
        if failed:
            raise RuntimeError("CUDA kernel build failed: " +
                               "\n".join(failed))
    return time.monotonic() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build([name])
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_target(sources()[name])))
            _loaded[name] = lib
    return lib


def build_log(name: str) -> str:
    """nvcc/ptxas output of the current build of kernel ``name``."""
    path = _target(sources()[name]).with_suffix(".log")
    return path.read_text() if path.is_file() else ""
