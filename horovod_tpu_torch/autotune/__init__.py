"""Online autotuner: coordinator-driven knob search over the live data
plane (``HOROVOD_AUTOTUNE=1``; see docs/autotune.md).

Counterpart of ``horovod_tpu/autotune/``: the same search, state file and
knob table, driving the port's engine.  The tuned knobs (chunk, fusion
threshold, cycle time, wave width, algorithm crossover) regroup and
reschedule reductions: a changed grouping may move a sum by its rounding
against an untuned run, never between ranks, since every rank applies a
TUNE frame in the same cycle.  The wire dtype, which lowers precision,
joins the sweep only under ``HOROVOD_AUTOTUNE_WIRE=1``.

The engine's performance knobs are host- and workload-dependent — the
right ``CHUNK_BYTES``/``CYCLE_TIME``/wave width on a 2-core CI box and
on a multi-NIC production host differ by integer factors.  Horovod
itself shipped this subsystem one release after the version this repo
reproduces (the ``ParameterManager`` autotuner, Sergeev & Del Balso,
arXiv:1802.05799); here the search rides the engine's own cycle
counters and epoch-stamped control plane, so tuning is observation plus
between-cycle knob flips — numerics-neutral by the data plane's
bit-exactness guarantee.

Public surface:

* :class:`Autotuner` / :func:`get_tuner` — the rank-0 search thread
  (started automatically by ``hvd.init()`` under ``HOROVOD_AUTOTUNE=1``);
* :func:`startup_probe` — collective micro-probe for the two
  wiring-time knobs (``NUM_CHANNELS``/``CHANNEL_DRIVERS``), on torch
  tensors on the rank's device;
* :class:`CoordinateSearch` — the deterministic seeded schedule;
* :func:`resolved_config` / :func:`format_table` — the env -> default ->
  effective knob table behind ``python -m horovod_tpu_torch.run
  --print-config`` (the serve plane's rows included);
* :func:`load_state` / :func:`save_state` — the
  ``HOROVOD_AUTOTUNE_STATE_FILE`` warm-start format.
"""

from horovod_tpu_torch.autotune.config import (  # noqa: F401
    KNOBS,
    format_table,
    resolved_config,
)
from horovod_tpu_torch.autotune.search import CoordinateSearch, ladder  # noqa: F401
from horovod_tpu_torch.autotune.store import (  # noqa: F401
    apply_wiring_warm_start,
    load_state,
    save_state,
)
from horovod_tpu_torch.autotune.tuner import (  # noqa: F401
    Autotuner,
    default_space,
    get_tuner,
    start_autotuner,
    startup_probe,
    stop_autotuner,
)

__all__ = [
    "Autotuner", "CoordinateSearch", "KNOBS", "apply_wiring_warm_start",
    "default_space", "format_table", "get_tuner", "ladder", "load_state",
    "resolved_config", "save_state", "start_autotuner", "startup_probe",
    "stop_autotuner",
]
