"""The elastic retry driver: catch → re-init → rollback → resume.

Counterpart of ``horovod_tpu/elastic/driver.py``.  ``run_elastic(train_fn,
state)`` runs the training function until it finishes or a rank failure
surfaces as :class:`HorovodInternalError`; on failure the driver tears
the engine and the torch group down, waits out a capped exponential
backoff with seeded jitter, re-initialises (with the device and backend
of the process's first ``init``: two ranks sharing one card keep
``cuda:0`` and gloo), rolls the state back to its last commit, in place,
and re-enters ``train_fn``.  With ``HOROVOD_CHECKPOINT_DIR`` set, every
entry first lets ``maybe_restore`` load the newest complete checkpoint
when rank 0 lost progress; ``state.sync()`` then makes rank 0's state
authoritative.
"""

from __future__ import annotations

import os
import random
import sys
import time
from typing import Callable, Optional

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.elastic.state import ElasticState
from horovod_tpu_torch.runtime.engine import HorovodInternalError, flight_note

__all__ = ["run_elastic"]

#: Ceiling on any single backoff sleep, however many doublings happened.
_BACKOFF_CAP_SEC = 30.0


def _env_num(name: str, default, cast):
    value = os.environ.get(name)
    if value is None or value == "":
        return default
    return cast(value)


def _jittered(delay: float, attempt: int) -> float:
    """±25% jitter on a backoff delay, seeded from (worker id, attempt):
    decorrelated across ranks (no thundering-herd rendezvous), yet the
    same in every run of a process."""
    rng = random.Random(f"{os.environ.get('HOROVOD_RANK', '0')}:{attempt}")
    return delay * (0.75 + 0.5 * rng.random())


def run_elastic(train_fn: Callable[[ElasticState], object],
                state: ElasticState, *,
                max_retries: Optional[int] = None,
                backoff_sec: Optional[float] = None):
    """Run ``train_fn(state)`` with checkpoint-rollback recovery.

    ``train_fn`` loops on ``state`` (e.g. ``while state.step < N``), calls
    ``state.commit()`` at durable points and lets
    ``HorovodInternalError`` propagate; its return value is returned when
    it completes.  Retries are bounded by ``max_retries`` (default
    ``HOROVOD_ELASTIC_MAX_RETRIES``, 3), a budget that resets whenever a
    commit landed since the previous failure; the backoff starts at
    ``backoff_sec`` (default ``HOROVOD_ELASTIC_BACKOFF_SEC``, 1.0) and
    doubles per consecutive failure, capped at 30 s, jittered."""
    if max_retries is None:
        max_retries = _env_num("HOROVOD_ELASTIC_MAX_RETRIES", 3, int)
    if backoff_sec is None:
        backoff_sec = _env_num("HOROVOD_ELASTIC_BACKOFF_SEC", 1.0, float)

    retries = 0
    while True:
        commits_at_entry = None
        try:
            if not basics.is_initialized():
                basics.init(**basics.first_init_args())
                if retries > 0:
                    # Under HOROVOD_ELASTIC=1 the re-init may have
                    # committed a resized world: train_fn must re-read
                    # rank and size.
                    print(
                        "horovod_tpu elastic: re-entered the world at "
                        f"epoch={basics.epoch()} rank={basics.rank()} "
                        f"size={basics.size()}",
                        file=sys.stderr, flush=True)
            ckpt_dir = os.environ.get("HOROVOD_CHECKPOINT_DIR",
                                      "").strip()
            if ckpt_dir:
                from horovod_tpu_torch.checkpoint import maybe_restore

                restored = maybe_restore(state, ckpt_dir)
                if restored is not None:
                    print(
                        "horovod_tpu elastic: restored from checkpoint "
                        f"step {restored} ({ckpt_dir})",
                        file=sys.stderr, flush=True)
            state.sync()
            commits_at_entry = state.commit_count
            return train_fn(state)
        except HorovodInternalError as e:
            if commits_at_entry is not None \
                    and state.commit_count > commits_at_entry:
                retries = 0  # durable progress since the last failure
            retries += 1
            if retries > max_retries:
                print(
                    "horovod_tpu elastic: giving up after "
                    f"{max_retries} consecutive retries: {e}",
                    file=sys.stderr, flush=True)
                raise
            delay = _jittered(
                min(backoff_sec * (2 ** (retries - 1)), _BACKOFF_CAP_SEC),
                retries)
            print(
                f"horovod_tpu elastic: collective failure ({e}); "
                f"rolling back to the last commit and retrying in "
                f"{delay:.1f}s (attempt {retries}/{max_retries})",
                file=sys.stderr, flush=True)
            flight_note("elastic", f"failure retry={retries} "
                                   f"delay={delay:.3f}")
            try:
                basics.shutdown()
            except Exception:  # noqa: BLE001 -- teardown is best-effort
                pass
            state.restore()
            time.sleep(delay)
