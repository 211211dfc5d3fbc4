"""Autotune state persistence (``HOROVOD_AUTOTUNE_STATE_FILE``).

Counterpart of ``horovod_tpu/autotune/store.py``, in the same format: a
state file written by either package warm-starts the other.

One small JSON document holding the committed config and the probe's
wiring choices, so a relaunch warm-starts: the live knobs are re-applied
via one TUNE frame instead of re-running the search, and the
channels/drivers choice is injected into the env *before* the engine
wires its rings (those two knobs cannot change without re-wiring).
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Optional

__all__ = ["load_state", "save_state", "apply_wiring_warm_start"]

_VERSION = 1

#: Live-tunable knob names a committed config may carry.  For
#: ``algo_threshold`` 0 is a REAL value (small-tensor star path off),
#: for ``wire_dtype`` 0 is fp32 (the uncompressed default), and for
#: ``priority_bands`` 0 is bands-off — so the sanitizer below accepts
#: >= 0 for them while the others need > 0.  ``fusion_ladder_<b>``
#: (the per-band bucket sizes) round-trip by prefix.
LIVE_KNOBS = ("chunk_bytes", "fusion_threshold", "cycle_time_ms",
              "wave_width", "algo_threshold", "wire_dtype",
              "priority_bands")
_ZERO_OK_KNOBS = ("algo_threshold", "wire_dtype", "priority_bands")
_LADDER_PREFIX = "fusion_ladder_"


def _knob_ok(k: str) -> bool:
    if k in LIVE_KNOBS:
        return True
    if k.startswith(_LADDER_PREFIX):
        suffix = k[len(_LADDER_PREFIX):]
        return suffix.isdigit() and int(suffix) < 8
    return False
#: Wiring-time knobs the startup micro-probe may pin.
WIRING_KNOBS = {"num_channels": "HOROVOD_NUM_CHANNELS",
                "channel_drivers": "HOROVOD_CHANNEL_DRIVERS"}


def load_state(path: str) -> Optional[dict]:
    """Parse a state file; None when missing, corrupt, or from another
    format version (a bad file must degrade to a cold search, never
    crash init)."""
    if not path:
        return None
    try:
        with open(path, "r") as f:
            state = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(state, dict) or state.get("version") != _VERSION:
        return None
    committed = state.get("committed")
    if not isinstance(committed, dict):
        return None
    clean = {k: int(v) for k, v in committed.items()
             if _knob_ok(k) and isinstance(v, (int, float)) and
             (v > 0 or (v == 0 and k in _ZERO_OK_KNOBS))}
    if not clean:
        return None
    state["committed"] = clean
    # Sanitize wiring with the same discipline: a hand-edited entry like
    # "two" must degrade the wiring warm start, not crash init.
    wiring = state.get("wiring")
    state["wiring"] = {
        k: int(v) for k, v in wiring.items()
        if k in WIRING_KNOBS and isinstance(v, (int, float)) and v > 0
    } if isinstance(wiring, dict) else {}
    return state


def save_state(path: str, committed: dict, score: Optional[float],
               seed: int, wiring: Optional[dict] = None) -> None:
    """Atomic write (tmp + rename) so a relaunch racing a save never
    reads a torn file."""
    if not path:
        return
    state = {
        "version": _VERSION,
        "committed": {k: int(v) for k, v in committed.items()
                      if _knob_ok(k)},
        "score": score,
        "seed": int(seed),
    }
    if wiring:
        state["wiring"] = {k: int(v) for k, v in wiring.items()
                          if k in WIRING_KNOBS}
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(prefix=".autotune.", dir=d)
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(state, f, indent=1)
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass


def apply_wiring_warm_start(environ=os.environ) -> Optional[dict]:
    """Pre-init: inject the state file's probed channels/drivers into the
    env so the engine wires the committed fan-out straight away.  An
    explicit user env value always wins over the state file."""
    state = load_state(environ.get("HOROVOD_AUTOTUNE_STATE_FILE", ""))
    if state is None:
        return None
    wiring = state.get("wiring") or {}
    for knob, env_name in WIRING_KNOBS.items():
        value = wiring.get(knob)
        if value and not environ.get(env_name):
            environ[env_name] = str(int(value))
    return state
