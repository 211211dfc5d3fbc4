"""Process identity and lifecycle: ``init``, ``shutdown``, ``rank``, ...

Counterpart of ``horovod_tpu/common/basics.py``.  Identity comes from the
launcher's environment, read in the reference's order: ``HOROVOD_RANK`` /
``HOROVOD_SIZE`` / ``HOROVOD_LOCAL_RANK`` / ``HOROVOD_LOCAL_SIZE``, then
the ``OMPI_COMM_WORLD_*`` and ``PMI_*`` names.  With none set, the world
is one process.  Queries raise before :func:`init`, as the reference's do.

:func:`init` brings up two communicators, at every size:

* the eager native engine (``libhorovod_core``, built from the port's own
  ``cpp/`` at first use by ``common/native_build.py``), as the reference's
  ``init`` does: its rank-0 coordinator listens on ``HOROVOD_COORDINATOR``
  (``host:port``), the reference's meaning of the variable.  It carries
  the eager collectives on named tensors, ``hvd.allreduce``,
  ``allgather``, ``broadcast``, ``reducescatter``, ``alltoall`` and their
  handles (``runtime/eager.py``, ``runtime/mpi_ops.py``);
* ``torch.distributed``'s default process group, NCCL when the process
  runs on the card and gloo on the CPU, the counterpart of the traced
  ``psum``: ``make_train_step``, ``DistributedOptimizer``,
  ``allreduce_gradients`` and ``broadcast_parameters`` reduce through it
  (``ops/collective_ops.py``).  It rendezvous at the coordinator's port
  + 64, where the reference puts its second rendezvous (JAX's); comm
  subsets of the reference take port + 1 + min(comm), below it.  A world
  of one without ``HOROVOD_COORDINATOR`` picks a free port.

A world of one needs no coordinator for the engine, whose collectives are
then identities.  The engine library fails loudly: a build or load error
raises with the compiler's or loader's text.
"""

from __future__ import annotations

import atexit
import os
import socket
import threading
from typing import Optional, Sequence, Union

import torch
import torch.distributed as dist

from horovod_tpu_torch.common.device import resolve_device

__all__ = ["init", "shutdown", "is_initialized", "rank", "size",
           "local_rank", "local_size", "device", "epoch",
           "mpi_threads_supported"]

#: The torch group's rendezvous port, relative to HOROVOD_COORDINATOR's.
TORCH_PORT_OFFSET = 64

# Env vars for rank discovery, in the reference's priority order.
_RANK_ENV = ("HOROVOD_RANK", "OMPI_COMM_WORLD_RANK", "PMI_RANK")
_SIZE_ENV = ("HOROVOD_SIZE", "OMPI_COMM_WORLD_SIZE", "PMI_SIZE")
_LOCAL_RANK_ENV = ("HOROVOD_LOCAL_RANK", "OMPI_COMM_WORLD_LOCAL_RANK")
_LOCAL_SIZE_ENV = ("HOROVOD_LOCAL_SIZE", "OMPI_COMM_WORLD_LOCAL_SIZE")

_lock = threading.Lock()
_state: dict = {}
_atexit_registered = False


def _env_int(names: Sequence[str]) -> Optional[int]:
    for name in names:
        value = os.environ.get(name)
        if value is not None and value != "":
            return int(value)
    return None


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _init_method(addr: str) -> str:
    """The torch group's rendezvous: the coordinator's host at its port
    + ``TORCH_PORT_OFFSET``, or a free local port without a coordinator."""
    if not addr:
        return f"tcp://127.0.0.1:{_free_port()}"
    host, _, port = addr.rpartition(":")
    return f"tcp://{host}:{int(port) + TORCH_PORT_OFFSET}"


def _start_engine(rank: int, size: int, local_rank: int, local_size: int,
                  addr: str):
    """Load the engine library and start it (``horovod_init``); raises
    with the engine's own error text."""
    from horovod_tpu_torch.runtime.engine import get_engine

    lib = get_engine().lib
    if lib.horovod_init(rank, size, local_rank, local_size,
                        addr.encode()) != 0:
        detail = lib.horovod_last_error().decode(errors="replace")
        raise RuntimeError("native horovod_init failed"
                           + (f": {detail}" if detail else ""))
    return lib


def init(device: Optional[Union[str, torch.device]] = None) -> None:
    """Read this process's identity and create the default process group.

    ``device=None`` means the CUDA device ``local_rank`` (NCCL) and raises
    without a GPU; ``device="cpu"`` runs on the CPU (gloo).  A second call
    is a no-op.
    """
    with _lock:
        if _state:
            return
        rank, size = _env_int(_RANK_ENV), _env_int(_SIZE_ENV)
        if (rank is None) != (size is None):
            raise ValueError(
                "half-specified identity: rank and size must be given "
                "together (HOROVOD_RANK/HOROVOD_SIZE style env vars); got "
                f"rank={rank!r}, size={size!r}")
        if rank is None:
            rank, size = 0, 1
        local_size = _env_int(_LOCAL_SIZE_ENV)
        if local_size is None:
            local_size = size      # N processes with no local info: one host
        local_rank = _env_int(_LOCAL_RANK_ENV)
        if local_rank is None:
            local_rank = rank % local_size
        if not (0 < size and 0 <= rank < size):
            raise ValueError(f"invalid identity: rank={rank}, size={size}")
        if not (0 < local_size <= size and 0 <= local_rank < local_size):
            raise ValueError(
                f"invalid local identity: local_rank={local_rank}, "
                f"local_size={local_size} (size={size})")

        dev = resolve_device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", local_rank if dev.index is None
                               or device is None else dev.index)
            torch.cuda.set_device(dev)
        addr = os.environ.get("HOROVOD_COORDINATOR", "")
        if size > 1 and not addr:
            raise ValueError(
                "a world of more than one process needs a rendezvous "
                "address: set HOROVOD_COORDINATOR=host:port")
        lib = _start_engine(rank, size, local_rank, local_size, addr)
        if os.environ.get("HOROVOD_ELASTIC", "") not in ("", "0"):
            # The coordinator may have re-formed the world: adopt the
            # committed identity.
            rank, size = int(lib.horovod_rank()), int(lib.horovod_size())
        try:
            dist.init_process_group(
                "nccl" if dev.type == "cuda" else "gloo",
                init_method=_init_method(addr), world_size=size, rank=rank)
        except BaseException:
            lib.horovod_shutdown()
            raise
        _state.update(rank=rank, size=size, local_rank=local_rank,
                      local_size=local_size, device=dev)
        global _atexit_registered
        if not _atexit_registered:
            atexit.register(shutdown)
            _atexit_registered = True


def shutdown() -> None:
    """Stop the engine and destroy the process group :func:`init`
    created; queries raise again until the next :func:`init`."""
    with _lock:
        if not _state:
            return
        from horovod_tpu_torch.runtime.engine import (get_engine,
                                                      reset_engine_naming)
        get_engine().lib.horovod_shutdown()
        reset_engine_naming()
        if dist.is_initialized():
            dist.destroy_process_group()
        _state.clear()


def is_initialized() -> bool:
    return bool(_state)


def _get(key: str):
    if not _state:
        # The reference's contract (CheckInitialized).
        raise ValueError("Horovod has not been initialized; use hvd.init().")
    return _state[key]


def rank() -> int:
    return _get("rank")


def size() -> int:
    return _get("size")


def local_rank() -> int:
    return _get("local_rank")


def local_size() -> int:
    return _get("local_size")


def device() -> torch.device:
    """The device :func:`init` bound this process to."""
    return _get("device")


def epoch() -> int:
    """The engine's committed membership epoch: bumped by every successful
    rendezvous commit; 0 before the first :func:`init`."""
    if not _state:
        return 0
    from horovod_tpu_torch.runtime.engine import get_engine
    return get_engine().epoch()


def mpi_threads_supported() -> bool:
    """There is no MPI; the engine's threading is unconditional (the
    reference's answer)."""
    _get("rank")
    return True
