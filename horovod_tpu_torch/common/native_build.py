"""Build and load the eager native engine (``libhorovod_core``) at first use.

Counterpart of ``horovod_tpu/common/native_build.py``.  The engine's C++
sources are the port's own copy, ``horovod_tpu_torch/cpp/``; the library
lands in ``horovod_tpu_torch/_build/`` (ignored by git), named by a hash of
every file of ``cpp/`` and of the compiler flags, so an edited source is
never served by a stale library.  One ``g++`` per source runs at once, then
one link::

    g++ -O3 -fPIC -std=c++17 -pthread -fno-gnu-unique -c cpp/<name>.cc
    g++ -shared -pthread -Wl,-Bsymbolic -o _build/libhorovod_core-<hash>.so *.o -lrt

The Makefile's flags, plus two that keep this engine apart from the JAX
package's when both live in one process (its library is loaded with
``RTLD_GLOBAL``): ``-Wl,-Bsymbolic`` binds the library's references to its
own definitions, and ``-fno-gnu-unique`` keeps function-local statics out
of the process-wide unique-symbol table.  The library is loaded
``RTLD_LOCAL`` for the same reason.  A file lock covers ranks (and test
workers) that start together.  A failed build raises with the compiler's
output; there is no fallback.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

__all__ = ["CPP_DIR", "BUILD_DIR", "CXXFLAGS", "LDFLAGS", "lib_path",
           "build", "load"]

_PKG = Path(__file__).resolve().parent.parent
CPP_DIR = _PKG / "cpp"
BUILD_DIR = _PKG / "_build"
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra",
            "-Wno-unused-parameter", "-pthread", "-fno-gnu-unique")
LDFLAGS = ("-shared", "-pthread", "-Wl,-Bsymbolic")
LDLIBS = ("-lrt",)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler found (CXX, g++ or c++ on PATH); "
                           "the eager engine of horovod_tpu_torch is built "
                           "from horovod_tpu_torch/cpp at first use")
    return cxx


def lib_path(cpp_dir: Path = CPP_DIR) -> Path:
    """Where the library built from ``cpp_dir`` with these flags lives."""
    h = hashlib.sha256()
    for src in sorted(p for p in cpp_dir.iterdir() if p.is_file()
                      and (p.suffix in (".cc", ".h") or p.name == "Makefile")):
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    h.update(" ".join(CXXFLAGS + LDFLAGS + LDLIBS).encode())
    return BUILD_DIR / f"libhorovod_core-{h.hexdigest()[:16]}.so"


def _compile(target: Path) -> None:
    cxx = _cxx()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR,
                                     prefix="engine-") as tmp:
        objs, procs = [], []
        for src in sorted(CPP_DIR.glob("*.cc")):
            obj = Path(tmp) / f"{src.stem}.o"
            objs.append(str(obj))
            procs.append((src, subprocess.Popen(
                [cxx, *CXXFLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        failed = []
        for src, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"cpp/{src.name} ({cxx} exit "
                              f"{proc.returncode}):\n"
                              f"{out.decode(errors='replace')}")
        if failed:
            raise RuntimeError("eager engine build failed: " +
                               "\n".join(failed))
        tmp_lib = Path(tmp) / target.name
        link = subprocess.run([cxx, *LDFLAGS, "-o", str(tmp_lib), *objs,
                               *LDLIBS], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
        if link.returncode != 0:
            raise RuntimeError("eager engine link failed:\n" +
                               link.stdout.decode(errors="replace"))
        os.replace(tmp_lib, target)


def build() -> Path:
    """The engine library, compiled first if no library of these sources
    and flags exists.  Safe across processes: the first builds under a
    file lock, the others wait for it and load its library."""
    target = lib_path()
    if target.is_file():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libhorovod_core.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not target.is_file():
            _compile(target)
    return target


def load() -> ctypes.CDLL:
    """The process's engine library (built first if needed), loaded
    ``RTLD_LOCAL``; one per process."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()), mode=ctypes.RTLD_LOCAL)
        return _lib
