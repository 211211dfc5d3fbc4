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

The observability and tuning planes start with the engine, as the
reference's do: under ``HOROVOD_AUTOTUNE`` the state file's wiring is put
into the env before the engine wires its rings, and rank 0 of a world of
more than one runs the online autotuner (``autotune/tuner.py``); with
``HOROVOD_METRICS_PORT`` set, rank 0 serves the metrics endpoint
(``monitor/server.py``: ``/metrics``, ``/json``, ``/fleet``).  A port
that cannot be bound disables the endpoint with a message; ``init`` goes
on.  :func:`shutdown` stops the endpoint, then the tuner, then the
engine.
"""

from __future__ import annotations

import atexit
import os
import sys
import threading
from typing import Optional, Sequence, Union

import torch
import torch.distributed as dist

from horovod_tpu_torch.common.device import resolve_device
from horovod_tpu_torch.common.launch import TORCH_PORT_OFFSET, free_port

__all__ = ["init", "shutdown", "is_initialized", "rank", "size",
           "local_rank", "local_size", "device", "num_chips",
           "local_devices", "epoch",
           "mpi_threads_supported", "first_init_args", "fleet_stats"]


# Env vars for rank discovery, in the reference's priority order.
_RANK_ENV = ("HOROVOD_RANK", "OMPI_COMM_WORLD_RANK", "PMI_RANK")
_SIZE_ENV = ("HOROVOD_SIZE", "OMPI_COMM_WORLD_SIZE", "PMI_SIZE")
_LOCAL_RANK_ENV = ("HOROVOD_LOCAL_RANK", "OMPI_COMM_WORLD_LOCAL_RANK")
_LOCAL_SIZE_ENV = ("HOROVOD_LOCAL_SIZE", "OMPI_COMM_WORLD_LOCAL_SIZE")

_lock = threading.Lock()
_state: dict = {}
#: ``device``/``backend`` of the process's first :func:`init`: what an
#: elastic re-init after a failure uses again.
_first_init: dict = {}
_atexit_registered = False
_shutdown_hooks: list = []


def on_shutdown(hook) -> None:
    """Call ``hook()`` at every :func:`shutdown`, after the process group
    is gone (a layer above that keeps state tied to the group resets it
    there)."""
    _shutdown_hooks.append(hook)


def _env_int(names: Sequence[str]) -> Optional[int]:
    for name in names:
        value = os.environ.get(name)
        if value is not None and value != "":
            return int(value)
    return None


def _group_store(addr: str, rank: int, size: int, epoch: int):
    """The torch group's rendezvous store: a TCPStore at the coordinator's
    host and port + ``TORCH_PORT_OFFSET`` (a free local port without a
    coordinator), hosted by rank 0 as torch's own ``tcp://`` rendezvous
    hosts it, its keys under the engine's committed membership epoch.  A
    TCPStore server is shared by every store of its port in a process, so
    after a re-init the survivor's server may still hold the previous
    incarnation's addresses; the epoch keeps the two apart."""
    if addr:
        host, _, port = addr.rpartition(":")
        host, port = host, int(port) + TORCH_PORT_OFFSET
    else:
        host, port = "127.0.0.1", free_port()
    store = dist.TCPStore(host, port, size, rank == 0, multi_tenant=True)
    return dist.PrefixStore(f"hvd.epoch{epoch}", store)


def _env_on(name: str) -> bool:
    return os.environ.get(name, "") not in ("", "0")


def _maybe_start_autotuner(rank: int, size: int) -> None:
    """Rank 0 of a world of more than one runs the online autotuner under
    ``HOROVOD_AUTOTUNE=1``, unless ``HOROVOD_AUTOTUNE_SUSPEND`` is set
    (``startup_probe`` sets it while it re-initialises)."""
    if rank != 0 or size <= 1 or not _env_on("HOROVOD_AUTOTUNE") \
            or _env_on("HOROVOD_AUTOTUNE_SUSPEND"):
        return
    from horovod_tpu_torch.autotune.tuner import start_autotuner
    from horovod_tpu_torch.runtime.engine import get_engine
    start_autotuner(get_engine())


def _maybe_start_monitor(rank: int) -> None:
    """Rank 0 serves the metrics endpoint on ``HOROVOD_METRICS_PORT``;
    unset or 0, no thread and no socket.  A bad or busy port disables the
    endpoint with a message and ``init`` goes on."""
    raw = os.environ.get("HOROVOD_METRICS_PORT", "")
    if rank != 0 or raw in ("", "0"):
        return
    try:
        port = int(raw)
    except ValueError:
        print(f"horovod_tpu_torch: bad HOROVOD_METRICS_PORT={raw!r}; "
              "metrics endpoint disabled", file=sys.stderr)
        return
    from horovod_tpu_torch.monitor.server import start_metrics_server
    from horovod_tpu_torch.runtime.engine import get_engine
    eng = get_engine()
    try:
        bound = start_metrics_server(port, eng.stats, eng.fleet_stats)
    except (OSError, RuntimeError) as exc:
        print(f"horovod_tpu_torch: metrics endpoint disabled: {exc}",
              file=sys.stderr)
        return
    print(f"horovod_tpu_torch: metrics endpoint on :{bound} "
          "(/metrics /json /fleet)", file=sys.stderr)


def _start_engine(rank: int, size: int, local_rank: int, local_size: int,
                  addr: str):
    """Load the engine library and start it (``horovod_init``); raises
    with the engine's own error text."""
    from horovod_tpu_torch.runtime.engine import get_engine

    lib = get_engine().lib
    if _env_on("HOROVOD_AUTOTUNE"):
        # The state file's probed channels and drivers must be in the env
        # before the engine wires its rings (a user's own values win).
        from horovod_tpu_torch.autotune.store import apply_wiring_warm_start
        apply_wiring_warm_start(os.environ)
    if lib.horovod_init(rank, size, local_rank, local_size,
                        addr.encode()) != 0:
        detail = lib.horovod_last_error().decode(errors="replace")
        raise RuntimeError("native horovod_init failed"
                           + (f": {detail}" if detail else ""))
    return lib


def init(device: Optional[Union[str, torch.device]] = None,
         backend: Optional[str] = None) -> None:
    """Read this process's identity and create the default process group.

    ``device=None`` means the CUDA device ``local_rank`` (NCCL) and raises
    without a GPU; ``device="cpu"`` runs on the CPU (gloo).  ``backend``
    overrides the group's backend: ``"gloo"`` on the card is how ranks
    that share one device (which NCCL refuses) run collectives, the
    families' through host memory (``parallel/comm.py``).  A second call
    is a no-op.
    """
    with _lock:
        if _state:
            return
        if not _first_init:
            _first_init.update(device=device, backend=backend)
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
                backend or ("nccl" if dev.type == "cuda" else "gloo"),
                store=_group_store(addr, rank, size,
                                   int(lib.horovod_epoch())),
                world_size=size, rank=rank)
        except BaseException:
            lib.horovod_shutdown()
            raise
        _state.update(rank=rank, size=size, local_rank=local_rank,
                      local_size=local_size, device=dev,
                      backend=dist.get_backend())
        _maybe_start_autotuner(rank, size)
        _maybe_start_monitor(rank)
        global _atexit_registered
        if not _atexit_registered:
            atexit.register(shutdown)
            _atexit_registered = True


def first_init_args() -> dict:
    """``{"device": ..., "backend": ...}`` as the process's first
    :func:`init` was given them (empty before it)."""
    return dict(_first_init)


def shutdown() -> None:
    """Stop the engine and destroy the process group :func:`init`
    created; queries raise again until the next :func:`init`.  After a
    peer's death (the engine aborted) an NCCL group's communicator is
    aborted first, so the teardown does not wait on the dead rank.  The
    metrics endpoint and the autotuner stop first: they read counters and
    queue TUNE frames, and must not race the engine's teardown."""
    if _env_on("HOROVOD_METRICS_PORT"):
        from horovod_tpu_torch.monitor.server import stop_metrics_server
        stop_metrics_server()
    if _env_on("HOROVOD_AUTOTUNE"):
        from horovod_tpu_torch.autotune.tuner import stop_autotuner
        stop_autotuner()
    with _lock:
        if not _state:
            return
        from horovod_tpu_torch.runtime.engine import (get_engine,
                                                      reset_engine_naming)
        eng = get_engine()
        aborted = bool(eng.abort_reason())
        eng.lib.horovod_shutdown()
        reset_engine_naming()
        if dist.is_initialized():
            abort = getattr(dist.distributed_c10d, "_abort_process_group",
                            None)
            if aborted and _state.get("backend") == "nccl" and abort:
                abort()
            else:
                dist.destroy_process_group()
        for hook in _shutdown_hooks:
            hook()
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


def num_chips() -> int:
    """Total number of cards across all processes: one card is one rank,
    so the world size (the reference counts its TPU chips, which a
    process may hold several of)."""
    return _get("size")


def local_devices() -> list:
    """The devices this process computes on: the one :func:`init`
    bound."""
    return [_get("device")]


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


def fleet_stats() -> dict:
    """Rank 0's fleet telemetry table (``{}`` on workers, with telemetry
    off, or before the first TELEM frame): see
    :meth:`horovod_tpu_torch.runtime.engine.NativeEngine.fleet_stats`.
    Readable after :func:`shutdown` too, for a postmortem scrape."""
    from horovod_tpu_torch.runtime.engine import get_engine
    return get_engine().fleet_stats()
