"""The check that the run loaded nothing of JAX or of the JAX package.

Names are compared whole, by the part of each module's name before the
first dot: ``horovod_tpu_torch`` (the program) begins with
``horovod_tpu`` (the JAX package) and is not it.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "horovod_tpu"})


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """The forbidden top-level names among ``names`` (default: every
    module loaded in this process)."""
    names = list(sys.modules) if names is None else names
    return sorted({n.split(".")[0] for n in names} & FORBIDDEN)
