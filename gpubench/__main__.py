"""``python3 -m gpubench``: see ``gpubench/run.py``.

Before ``torch`` is imported, the interpreter's bytecode cache and every
build or kernel cache a library may use are pointed at fixed directories
inside the checkout, so that only a checkout's first run compiles them
(the program keeps its nvcc and g++ builds in ``horovod_tpu_torch/_build``
itself).  The ranks a run starts inherit them.
"""

import os
import sys
import time

from gpubench.clock import process_age

START = time.perf_counter() - process_age()
CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), ".gpubench_cache")
os.environ["PYTHONPYCACHEPREFIX"] = os.path.join(CACHE, "pycache")
os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = os.path.join(CACHE, sub)
sys.pycache_prefix = os.environ["PYTHONPYCACHEPREFIX"]
sys.dont_write_bytecode = False

if __name__ == "__main__":
    from gpubench.run import main

    sys.exit(main(start=START))
