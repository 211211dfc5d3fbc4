"""The weight plane: crash-consistent sharded async checkpoints of CUDA
state, elastic resharding restore, and live trainer→serve weight push.

Counterpart of ``horovod_tpu/checkpoint/``, with the same manifest and
npz format and the same push frames, so checkpoints and pushes cross
between the packages.  Three legs over one vocabulary (replicated trees
+ flat sharded vectors under the engine's largest-first split):

- :class:`CheckpointWriter`: a per-rank async shard writer whose
  snapshot of CUDA leaves is a D2H copy into reused pinned buffers on a
  side stream (the compute stream waits on it), a MAX-allreduce commit
  barrier through the port's engine, and a rank-0 step-stamped manifest
  (writer.py; the ``ckpt-kill`` fault tears a shard write);
- :class:`CheckpointLoader`: reads a world-N manifest into a world-M
  process by reslicing the flat vectors through ``shard_bounds(n, M)``,
  restoring in place into live tensors (loader.py);
  :func:`maybe_restore` wires it into ``run_elastic``;
- :class:`WeightPusher`: live weight frames over the serve protocol,
  swapped into a replica's parameters between decode steps under a
  generation epoch (push.py; serve/scheduler.py applies them).
"""

from horovod_tpu_torch.checkpoint.loader import CheckpointLoader
from horovod_tpu_torch.checkpoint.manifest import (CheckpointError,
                                                   CheckpointIncompleteError,
                                                   latest_manifest)
from horovod_tpu_torch.checkpoint.stats import (checkpoint_stats,
                                                note_checkpoint,
                                                note_checkpoint_restore,
                                                note_weight_push)
from horovod_tpu_torch.checkpoint.writer import (CheckpointConfig,
                                                 CheckpointWriter,
                                                 parse_ckpt_kill)
from horovod_tpu_torch.checkpoint.elastic import maybe_restore
from horovod_tpu_torch.checkpoint.frontend import (jax_capture, jax_restore,
                                                   torch_capture,
                                                   torch_restore)
from horovod_tpu_torch.checkpoint.push import (WeightPusher, apply_leaves,
                                               decode_leaves, encode_leaves)

__all__ = [
    "CheckpointConfig", "CheckpointWriter", "CheckpointLoader",
    "CheckpointError", "CheckpointIncompleteError", "latest_manifest",
    "parse_ckpt_kill", "checkpoint_stats", "note_checkpoint",
    "note_checkpoint_restore", "note_weight_push", "maybe_restore",
    "jax_capture", "jax_restore", "torch_capture", "torch_restore",
    "WeightPusher", "encode_leaves", "decode_leaves", "apply_leaves",
]
