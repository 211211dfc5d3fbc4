"""Process-level helpers shared by the port's entry points: the process
identity and lifecycle (``basics``, the counterpart of
``horovod_tpu/common/``) and the device choice (``device``).

Not re-exported: the reference's ``HorovodBasics`` class and its
``basics`` instance; the port's ``basics`` is a module of the same
functions."""

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.basics import (epoch, fleet_stats, init,
                                             is_initialized, local_rank,
                                             local_size,
                                             mpi_threads_supported, rank,
                                             shutdown, size)
from horovod_tpu_torch.common.device import resolve_device

__all__ = ["basics", "init", "shutdown", "is_initialized", "rank", "size",
           "local_rank", "local_size", "epoch", "fleet_stats",
           "mpi_threads_supported", "resolve_device"]
