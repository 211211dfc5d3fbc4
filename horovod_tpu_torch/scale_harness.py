"""Big-world control-plane harness: worlds of 4 to 64 engine ranks on one
host.

Counterpart of the reference's ``tests/scale/harness.py``.  It starts N
ranks of ``scale_worker.py`` (ctypes only, ~10 MB each) against the port's
own ``libhorovod_core`` (``common/native_build.py``), waits them out under
a hard timeout, and returns rank 0's measurements.  Synthetic host
grouping (``HOROVOD_SCALE_GROUPS=G``) makes the coordinator commit a
G-group topology from per-rank ``HOROVOD_HOST_KEY`` values, which is what
turns on hierarchical coordination without G machines.

The defaults keep a 64-rank world light and on the control plane: shm
off, one channel and one driver per edge, tiny payloads, 2 ms cycles and
a bounded failure detector.  The ranks move raw host bytes and no tensor,
so the harness runs the same on a machine with a GPU and without one.
``bench_engine.py``'s ``scale_sweep`` and ``--scale-gate`` use it.
"""

from __future__ import annotations

import json
import re
import sys
from pathlib import Path
from typing import Optional

from horovod_tpu_torch.common.launch import World

__all__ = ["WORKER", "ensure_lib", "run_world"]

WORKER = str(Path(__file__).resolve().parent / "scale_worker.py")

_STATS_RE = re.compile(r"SCALE_STATS (\{.*\})")
_RDV_RE = re.compile(r"SCALE_RDV_MS ([\d.]+)")
_PARITY_RE = re.compile(r"SCALE_PARITY ([0-9a-f]{16})")


def ensure_lib() -> str:
    """The path of the port's engine library, built first if needed."""
    from horovod_tpu_torch.common import native_build

    return str(native_build.build())


def run_world(n: int, *, groups: int = 1, steps: int = 50,
              scenario: str = "steady", hier: bool = True,
              payload_floats: int = 64, timeout: int = 240,
              extra_env: Optional[dict] = None) -> dict:
    """Run one world of ``n`` ranks (``common/launch.World``); returns
    ``{"stats": rank 0's SCALE_STATS dict or None, "rendezvous_ms":
    float, "parity": [each rank's hash]}``.  Raises ``RuntimeError`` with
    the rank's output if a rank fails or the world outlives ``timeout``."""
    env = {
        "HOROVOD_SCALE_LIB": ensure_lib(),
        "HOROVOD_SCALE_GROUPS": str(groups),
        "HOROVOD_SCALE_STEPS": str(steps),
        "HOROVOD_SCALE_PAYLOAD_FLOATS": str(payload_floats),
        "HOROVOD_HIERARCHICAL_COORDINATOR": "1" if hier else "0",
        "HOROVOD_SHM_DISABLE": "1",
        "HOROVOD_NUM_CHANNELS": "1",
        "HOROVOD_CYCLE_TIME": "2",
        "HOROVOD_FAULT_TIMEOUT_SEC": "30",
        "HOROVOD_CHANNEL_DRIVERS": "1",
    }
    env.update(extra_env or {})
    with World(n, [sys.executable, WORKER, scenario], env=env,
               drop=("JAX_PLATFORMS", "HOROVOD_FAULT_INJECT",
                     "HOROVOD_HOST_KEY")) as world:
        outs = world.wait(timeout)
    m = _STATS_RE.search(outs[0])
    rdv = _RDV_RE.search(outs[0])
    return {
        "stats": json.loads(m.group(1)) if m else None,
        "rendezvous_ms": float(rdv.group(1)) if rdv else None,
        "parity": [pm.group(1) for pm in map(_PARITY_RE.search, outs) if pm],
    }
