"""Checkpoint/weight-push counters (pure Python, engine-optional).

Counterpart of ``horovod_tpu/checkpoint/stats.py``.

Follows the ``_SPARSE_COUNT`` idiom from runtime.engine: module-level
counters bumped by the checkpoint plane, merged into
``NativeEngine.stats()`` (and so into the metrics endpoint and
``run --status``) — and readable directly via
:func:`checkpoint_stats` in engine-free worlds (world size 1, unit
tests).

``checkpoint_ns_*`` measure the OFF-step-path write latency (host-copy
hand-off to manifest-commit barrier) over a sliding window — the cost a
training step never sees, which is the async writer's whole point.
"""

from __future__ import annotations

import threading
from collections import deque

import numpy as np

__all__ = [
    "note_checkpoint", "note_checkpoint_restore", "note_weight_push",
    "checkpoint_stats",
]

_LOCK = threading.Lock()
_BYTES = 0
_RESTORES = 0
_PUSHES = 0
_LAST_STEP = -1
_LAST_RESTORE_STEP = -1
#: Sliding window of end-to-end shard-write+commit durations (ns).
_NS_WINDOW: deque = deque(maxlen=256)


def note_checkpoint(step: int, nbytes: int, ns: int) -> None:
    """One committed checkpoint on this rank: its step, this rank's
    shard bytes, and the off-step-path write duration."""
    global _BYTES, _LAST_STEP
    with _LOCK:
        _BYTES += int(nbytes)
        _LAST_STEP = max(_LAST_STEP, int(step))
        _NS_WINDOW.append(int(ns))


def note_checkpoint_restore(step: int) -> None:
    """One restore-from-manifest on this rank."""
    global _RESTORES, _LAST_RESTORE_STEP
    with _LOCK:
        _RESTORES += 1
        _LAST_RESTORE_STEP = int(step)


def note_weight_push(n: int = 1) -> None:
    """``n`` completed live trainer→serve weight pushes."""
    global _PUSHES
    with _LOCK:
        _PUSHES += int(n)


def _pct(window, q: float) -> int:
    if not window:
        return 0
    return int(np.percentile(np.asarray(window, dtype=np.int64), q))


def checkpoint_stats() -> dict:
    """The checkpoint plane's slice of ``stats()`` (cumulative counters
    plus current-value gauges; see engine.stats_delta for which keys are
    delta'd vs carried)."""
    with _LOCK:
        window = list(_NS_WINDOW)
        return {
            "checkpoint_bytes": _BYTES,
            "checkpoint_restores": _RESTORES,
            "weight_push_count": _PUSHES,
            "last_checkpoint_step": _LAST_STEP,
            "checkpoint_ns_p50": _pct(window, 50),
            "checkpoint_ns_p99": _pct(window, 99),
        }


def _reset_for_tests() -> None:
    global _BYTES, _RESTORES, _PUSHES, _LAST_STEP, _LAST_RESTORE_STEP
    with _LOCK:
        _BYTES = 0
        _RESTORES = 0
        _PUSHES = 0
        _LAST_STEP = -1
        _LAST_RESTORE_STEP = -1
        _NS_WINDOW.clear()
