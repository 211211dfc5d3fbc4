"""Process identity and lifecycle: ``init``, ``shutdown``, ``rank``, ...

Counterpart of ``horovod_tpu/common/basics.py``.  Identity comes from the
launcher's environment, read in the reference's order: ``HOROVOD_RANK`` /
``HOROVOD_SIZE`` / ``HOROVOD_LOCAL_RANK`` / ``HOROVOD_LOCAL_SIZE``, then
the ``OMPI_COMM_WORLD_*`` and ``PMI_*`` names.  With none set, the world
is one process.  Queries raise before :func:`init`, as the reference's do.

The communicator is ``torch.distributed``'s default process group: NCCL
when the process runs on the card, gloo on the CPU.  :func:`init` creates
it even for a world of one, so a step's allreduce really goes through
NCCL.  Its rendezvous address is ``HOROVOD_COORDINATOR`` (``host:port``);
a world of one without it picks a free port on localhost.  The
reference's eager native engine (``libhorovod_core.so``) is not ported:
every collective is a ``torch.distributed`` call
(``ops/collective_ops.py``).
"""

from __future__ import annotations

import os
import socket
import threading
from typing import Optional, Sequence, Union

import torch
import torch.distributed as dist

from horovod_tpu_torch.common.device import resolve_device

__all__ = ["init", "shutdown", "is_initialized", "rank", "size",
           "local_rank", "local_size", "device"]

# Env vars for rank discovery, in the reference's priority order.
_RANK_ENV = ("HOROVOD_RANK", "OMPI_COMM_WORLD_RANK", "PMI_RANK")
_SIZE_ENV = ("HOROVOD_SIZE", "OMPI_COMM_WORLD_SIZE", "PMI_SIZE")
_LOCAL_RANK_ENV = ("HOROVOD_LOCAL_RANK", "OMPI_COMM_WORLD_LOCAL_RANK")
_LOCAL_SIZE_ENV = ("HOROVOD_LOCAL_SIZE", "OMPI_COMM_WORLD_LOCAL_SIZE")

_lock = threading.Lock()
_state: dict = {}


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


def _init_method(size: int) -> str:
    addr = os.environ.get("HOROVOD_COORDINATOR", "")
    if not addr:
        if size > 1:
            raise ValueError(
                "a world of more than one process needs a rendezvous "
                "address: set HOROVOD_COORDINATOR=host:port")
        addr = f"127.0.0.1:{_free_port()}"
    return f"tcp://{addr}"


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
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=_init_method(size), world_size=size, rank=rank)
        _state.update(rank=rank, size=size, local_rank=local_rank,
                      local_size=local_size, device=dev)


def shutdown() -> None:
    """Destroy the process group :func:`init` created; queries raise
    again until the next :func:`init`."""
    with _lock:
        if _state and dist.is_initialized():
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
