"""Shared helpers for the port's example scripts.

Counterpart of ``examples/common.py``'s ``example_args``: the same flags
and defaults, plus ``--device`` (the examples run on the CUDA device
unless given ``--device cpu``) and an explicit ``argv`` for callers that
drive an example's ``main`` in-process.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


def example_args(description: str, argv: Optional[Sequence[str]] = None,
                 **extra) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--epochs", type=int, default=extra.pop("epochs", 4))
    p.add_argument("--batch-size", type=int,
                   default=extra.pop("batch_size", 64))
    p.add_argument("--lr", type=float, default=extra.pop("lr", 0.01))
    p.add_argument("--smoke", action="store_true",
                   help="tiny shapes / few steps, for CI")
    p.add_argument("--device", default=None,
                   help="'cpu' to run on the CPU (default: the CUDA device)")
    for name, default in extra.items():
        arg = "--" + name.replace("_", "-")
        if isinstance(default, bool):
            p.add_argument(arg, action="store_true")
        else:
            p.add_argument(arg, type=type(default), default=default)
    return p.parse_args(argv)
