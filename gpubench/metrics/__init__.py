"""Metric readers, one module a metric, found by the metric's name.

``read(name, run)`` imports ``gpubench/metrics/<name>.py`` (``.`` and
``-`` in the name read as ``_``) and calls its ``read(run)``, which
returns the metric's value from a :class:`Run`, or None where the run
holds nothing to read; the harness then leaves the metric out of the
result line.  A later metric is a new file here and an entry in
``BENCHMARK.json``.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import List, Optional

from gpubench.trace import Trace


@dataclasses.dataclass
class Run:
    """What one run measured.  The window's fields come from the host
    clock and CUDA events; ``trace`` and the fields after it only from a
    ``--trace 1`` run's traced stretch of ``traced_steps`` steps."""
    chips: int
    steps: int                      # steps completed in the window
    samples_per_step: int           # over every rank
    window_s: float                 # ends with a synchronize()
    step_ms: List[float]            # rank 0's CUDA events, one a step
    peak_bytes: int                 # largest over the ranks
    setup_s: float                  # process start to the first step
    window_flops: float             # model FLOPs of the window's steps
    peak_flops: float               # of one chip
    trace: Optional[Trace] = None
    traced_steps: int = 0
    attention_bound_s: Optional[float] = None   # of the traced steps


def module_name(name: str) -> str:
    return "gpubench.metrics." + name.replace(".", "_").replace("-", "_")


def read(name: str, run: Run) -> Optional[float]:
    return importlib.import_module(module_name(name)).read(run)


def device_ms_per_step(run: Run, groups) -> Optional[float]:
    """Device ms a traced step in kernels of ``groups``, or None where no
    such kernel ran."""
    if run.trace is None:
        return None
    ops = run.trace.kernels(groups)
    if not ops:
        return None
    return sum(o.end - o.start for o in ops) / 1e3 / run.traced_steps
