"""Disk-restore hook for the elastic driver.

Counterpart of ``horovod_tpu/checkpoint/elastic.py``.  ``run_elastic``
calls :func:`maybe_restore` at every (re-)entry when
``HOROVOD_CHECKPOINT_DIR`` is set, BEFORE ``ElasticState.sync()``:

- rank 0 (the sync authority) compares its in-memory progress against
  the newest complete manifest and decides;
- the decision is agreed through a MAX-allreduce of the engine where
  only rank 0 contributes a nonzero value, so a fresh relaunch and a
  survivor take the same branch;
- on restore, EVERY rank loads the slots from disk (in place into its
  live tensors); the ``sync()`` after it broadcasts identical values.

Memory wins when it is ahead: survivors that committed past the last
durable checkpoint keep their state and ``sync()`` repairs the relaunched
rank.  Disk wins only when rank 0 itself lost progress (a full-fleet
relaunch, or rank 0 died).
"""

from __future__ import annotations

import numpy as np
import torch

from horovod_tpu_torch.checkpoint.loader import CheckpointLoader
from horovod_tpu_torch.checkpoint.manifest import latest_manifest
from horovod_tpu_torch.checkpoint.stats import note_checkpoint_restore
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.runtime.engine import flight_note

__all__ = ["maybe_restore"]


def _memory_step(state) -> int:
    """The state's own progress: an integer ``step`` slot, else 0."""
    step = getattr(state, "step", None)
    if isinstance(step, (bool, np.bool_)):
        return 0
    if isinstance(step, (int, np.integer)):
        return int(step)
    return 0


def maybe_restore(state, directory: str):
    """Restore ``state``'s slots from the newest complete checkpoint in
    ``directory`` if (and only if) it is ahead of rank 0's in-memory
    progress.  Collective when a world of more than one is up (every
    rank calls it together, as ``run_elastic`` does).  Returns the
    restored step, or ``None`` when memory won / no checkpoint exists."""
    found = latest_manifest(directory)
    disk_step = found[1] if found is not None else -1
    want = 1 if (found is not None
                 and disk_step > _memory_step(state)) else 0
    if basics.is_initialized() and basics.size() > 1:
        from horovod_tpu_torch.runtime.engine import get_engine

        # Only rank 0's vote counts (the sync() authority): the MAX over
        # {rank 0: want, others: 0} IS rank 0's decision.
        eng = get_engine()
        vote = torch.tensor([float(want if basics.rank() == 0 else 0)],
                            dtype=torch.float64)
        eng.synchronize(eng.enqueue_allreduce(
            vote, name="ckpt.restore.decide", red_op="max"))
        want = int(vote[0])
    if not want or found is None:
        return None
    loader = CheckpointLoader(directory, step=disk_step)
    try:
        for k in state._keys:
            setattr(state, k,
                    loader.restore_tree(getattr(state, k), k,
                                        missing="keep"))
        state.commit()
    finally:
        loader.close()
    note_checkpoint_restore(disk_step)
    flight_note("ckpt", f"restore step={disk_step} "
                        f"world={loader.world_size}->"
                        f"{basics.size() if basics.is_initialized() else 1}")
    return disk_step
