"""ZeRO-3/FSDP parameter plane: per-unit shards of the parameters.

Counterpart of ``horovod_tpu/runtime/fsdp.py``, on torch tensors on the
parameters' device instead of numpy.  The model is cut into units (a
layer, or a param group); each unit's parameters are flattened onto a
:class:`~horovod_tpu_torch.runtime.sharded.FlatSharder` window and each
rank keeps only its owned fp32 window:

* **forward**: :meth:`FsdpPlane.gather` allgathers a unit's shards just in
  time and enqueues the next ``prefetch`` units' allgathers at priority
  band 0 (``HOROVOD_FSDP_PREFETCH``, default 1);
* **backward**: :meth:`FsdpPlane.reduce_grads` enqueues a unit's gradient
  reducescatter the moment its gradients exist (priority band = unit
  index);
* **after use**: :meth:`FsdpPlane.free` drops the gathered full
  parameters; the owned shard stays, it is the parameter storage.

Bit-exactness rides the ZeRO-1 chain: an FSDP step equals the unsharded
flat step bit for bit.  Collectives are named ``fsdp.*``.  The plane's
counters (``fsdp_stats()``): ``fsdp_units``, ``fsdp_ag_prefetch_hits`` /
``_misses`` (the prefetched allgather had completed when the unit was
needed, or the gather blocked) and ``fsdp_param_bytes_resident`` /
``_peak`` (shards plus gathered units, counted from their sizes).

The checkpoint half, as the reference's: ``sharded_state`` hands the
writer each unit's owned window, ``restore`` reslices them at the current
world (``checkpoint/loader.py``).
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from horovod_tpu_torch.runtime import mpi_ops
from horovod_tpu_torch.runtime.engine import note_sharded_step
from horovod_tpu_torch.runtime.sharded import FlatSharder, ShardResizeError

__all__ = ["FsdpPlane", "FsdpUnit", "fsdp_default", "prefetch_default",
           "fsdp_stats", "reset_fsdp_stats", "ShardResizeError"]


def fsdp_default() -> bool:
    """The ``HOROVOD_FSDP`` env default for
    ``DistributedOptimizer(fsdp=None)`` (off unless set)."""
    raw = os.environ.get("HOROVOD_FSDP", "")
    return raw.strip() not in ("", "0", "false", "False")


def prefetch_default() -> int:
    """``HOROVOD_FSDP_PREFETCH``: how many units ahead a gather enqueues
    at band 0.  Default 1; 0 disables prefetch."""
    raw = os.environ.get("HOROVOD_FSDP_PREFETCH", "")
    try:
        return max(0, int(raw)) if raw.strip() else 1
    except ValueError:
        return 1


# The plane's counters, process-wide like the reference's: gauges (units,
# resident, peak) and cumulative hits and misses.
_STATS_LOCK = threading.Lock()
_STATS = dict(fsdp_units=0, fsdp_ag_prefetch_hits=0,
              fsdp_ag_prefetch_misses=0, fsdp_param_bytes_resident=0,
              fsdp_param_bytes_resident_peak=0)


def fsdp_stats() -> dict:
    with _STATS_LOCK:
        return dict(_STATS)


def reset_fsdp_stats() -> None:
    """Zero the plane counters (between plane lifetimes)."""
    with _STATS_LOCK:
        for k in _STATS:
            _STATS[k] = 0


def _note_units(delta: int) -> None:
    with _STATS_LOCK:
        _STATS["fsdp_units"] += delta


def _note_prefetch(hit: bool) -> None:
    with _STATS_LOCK:
        _STATS["fsdp_ag_prefetch_hits" if hit
               else "fsdp_ag_prefetch_misses"] += 1


def _note_resident(delta_bytes: int) -> None:
    with _STATS_LOCK:
        _STATS["fsdp_param_bytes_resident"] += int(delta_bytes)
        _STATS["fsdp_param_bytes_resident_peak"] = max(
            _STATS["fsdp_param_bytes_resident_peak"],
            _STATS["fsdp_param_bytes_resident"])


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class FsdpUnit:
    """One parameter unit: its leaves' shapes, its FlatSharder window and
    this rank's owned fp32 shard (updated in place)."""

    __slots__ = ("index", "name", "shapes", "n", "sharder", "shard")

    def __init__(self, index: int, name: str, shapes: List[tuple], n: int,
                 sharder: FlatSharder, shard: torch.Tensor):
        self.index = index
        self.name = name
        self.shapes = shapes
        self.n = n
        self.sharder = sharder
        self.shard = shard


class FsdpPlane:
    """Full parameter sharding over units.

    ``unit_params``: one list of tensors per unit.  Construction flattens
    each unit to fp32 on its tensors' device, anchors a window, and keeps
    only the owned shard.  Every rank builds the plane with the same unit
    boundaries (collective names follow program order).
    """

    _instances = 0

    def __init__(self, unit_params: Sequence[Sequence[torch.Tensor]], *,
                 name: str = "fsdp", prefetch: Optional[int] = None,
                 wire_dtype: Optional[str] = None, average: bool = True):
        if not unit_params:
            raise ValueError("FsdpPlane needs at least one unit")
        self.name = name
        self._wire_name = f"fsdp.{name}.{FsdpPlane._instances}"
        FsdpPlane._instances += 1
        self.prefetch = (prefetch_default() if prefetch is None
                         else max(0, int(prefetch)))
        self.wire_dtype = wire_dtype
        self.average = average
        self.units: List[FsdpUnit] = []
        self._full: Dict[int, torch.Tensor] = {}
        self._ag_handles: Dict[int, int] = {}
        self._rs_handles: Dict[int, Tuple[int, Optional[torch.Tensor]]] = {}
        self._steps = 0
        for i, tensors in enumerate(unit_params):
            shapes = [tuple(t.shape) for t in tensors]
            n = sum(t.numel() for t in tensors)
            if n == 0:
                raise ValueError(f"FSDP unit {i} has no parameters")
            sharder = FlatSharder(n, torch.float32,
                                  name=f"{self._wire_name}.u{i}")
            shard = FlatSharder.slice_flat(tensors, sharder.offset,
                                           sharder.count,
                                           torch.float32).clone()
            self.units.append(FsdpUnit(i, f"{name}.u{i}", shapes, n,
                                       sharder, shard))
            _note_resident(_nbytes(shard))
        _note_units(len(self.units))

    # -- geometry --

    @property
    def n_units(self) -> int:
        return len(self.units)

    @property
    def shard_bytes(self) -> int:
        return sum(_nbytes(u.shard) for u in self.units)

    def shard(self, i: int) -> torch.Tensor:
        """This rank's owned fp32 window of unit ``i``: the optimizer
        updates it in place, and the next gather serves the new bytes."""
        return self.units[i].shard

    # -- forward: just-in-time allgather and band-0 prefetch --

    def _enqueue_gather(self, i: int, priority: Optional[int]) -> int:
        u = self.units[i]
        u.sharder.check_world()
        return mpi_ops.allgather_async(
            u.shard, name=f"{self._wire_name}.u{i}.ag", priority=priority)

    def start_gather(self, i: int, *, priority: Optional[int] = 0) -> None:
        """Enqueue unit ``i``'s allgather (a pending or gathered unit is
        left alone); ``priority=0`` is the prefetch band."""
        if i < 0 or i >= len(self.units) or i in self._full \
                or i in self._ag_handles:
            return
        if self.units[i].sharder.size == 1:
            return
        self._ag_handles[i] = self._enqueue_gather(i, priority)

    def gather(self, i: int, *, direction: int = 1) -> List[torch.Tensor]:
        """Unit ``i``'s full parameters (views of one gathered flat
        tensor shaped like the originals), with the next ``prefetch``
        units in ``direction`` enqueued at band 0.  A pending gather that
        had completed counts as a prefetch hit; one that blocked, or was
        never enqueued, as a miss."""
        u = self.units[i]
        if i not in self._full:
            if u.sharder.size == 1:
                flat = u.shard.clone()
            else:
                handle = self._ag_handles.pop(i, None)
                if handle is None:
                    _note_prefetch(False)
                    handle = self._enqueue_gather(i, 0)
                else:
                    _note_prefetch(mpi_ops.poll(handle))
                flat = mpi_ops.synchronize(handle)
            self._full[i] = flat
            _note_resident(_nbytes(flat))
        for d in range(1, self.prefetch + 1):
            self.start_gather(i + direction * d, priority=0)
        return FlatSharder.unflatten(self._full[i], u.shapes)

    def free(self, i: int) -> None:
        """Drop unit ``i``'s gathered full parameters."""
        flat = self._full.pop(i, None)
        if flat is not None:
            _note_resident(-_nbytes(flat))

    # -- backward: a unit's reducescatter the moment its grads land --

    def reduce_grads(self, i: int, grads: Sequence[torch.Tensor], *,
                     priority: Optional[int] = None) -> None:
        """Enqueue unit ``i``'s gradient reducescatter now; ``priority``
        defaults to the unit index (earlier units are needed first by the
        next forward).  :meth:`wait_grads` claims the result."""
        if i in self._rs_handles:
            raise RuntimeError(f"unit {i} already has a gradient reduction "
                               "in flight (wait_grads it first)")
        u = self.units[i]
        u.sharder.check_world()
        flat = FlatSharder.flatten(grads, torch.float32)
        if flat.numel() != u.n:
            raise ValueError(f"unit {i}: flat gradient length "
                             f"{flat.numel()} != {u.n}")
        if u.sharder.size == 1:
            self._rs_handles[i] = (-1, flat[u.sharder.offset:u.sharder.offset
                                            + u.sharder.count].clone())
            return
        handle = mpi_ops.reducescatter_async(
            flat, name=f"{self._wire_name}.u{i}.rs", average=self.average,
            wire_dtype=self.wire_dtype,
            priority=i if priority is None else priority)
        self._rs_handles[i] = (handle, None)

    def wait_grads(self, i: int) -> torch.Tensor:
        """Unit ``i``'s reduced gradient shard, averaged by participants.
        A ``StepSkipped`` re-raises after the handle is cleaned up."""
        entry = self._rs_handles.pop(i, None)
        if entry is None:
            raise RuntimeError(f"unit {i} has no gradient reduction in "
                               "flight (reduce_grads it first)")
        handle, local = entry
        if handle == -1:
            return local
        return mpi_ops.synchronize(handle)

    def drain(self) -> Dict[int, BaseException]:
        """Drain every in-flight handle (gradient reducescatters and
        prefetched allgathers), never abandoning one; returns ``{unit:
        error}`` for the reductions that failed."""
        errs: Dict[int, BaseException] = {}
        for i in sorted(self._rs_handles):
            handle, _ = self._rs_handles.pop(i)
            if handle == -1:
                continue
            try:
                mpi_ops.synchronize(handle)
            except Exception as e:  # noqa: BLE001 -- reported per unit
                errs[i] = e
        for i in sorted(self._ag_handles):
            handle = self._ag_handles.pop(i)
            try:
                flat = mpi_ops.synchronize(handle)
            except Exception as e:  # noqa: BLE001 -- reported per unit
                errs[i] = e
            else:
                self._full[i] = flat
                _note_resident(_nbytes(flat))
        return errs

    def step(self) -> None:
        """Mark a completed FSDP step (the shared ``sharded_steps``
        counter); nothing may be left in flight."""
        if self._rs_handles:
            raise RuntimeError(
                f"FSDP step completed with gradient reductions still in "
                f"flight for units {sorted(self._rs_handles)}")
        self._steps += 1
        note_sharded_step()

    def sharded_state(self) -> Dict[str, Tuple[torch.Tensor, int]]:
        """``{name: (owned_shard, n)}`` for ``CheckpointWriter.save(...,
        sharded=...)``: each rank writes its owned windows (tensors on
        their device; the writer's snapshot copies them), and the
        manifest's bounds let a restore at ANY world size reassemble
        them."""
        return {f"fsdp.{self.name}.u{u.index}": (u.shard, u.n)
                for u in self.units}

    def restore(self, loader) -> None:
        """Load every unit's owned window, at this world's bounds, from a
        checkpoint written at any world size, in place; drops the
        gathered units."""
        from horovod_tpu_torch.checkpoint.loader import as_tensor

        for u in self.units:
            name = f"fsdp.{self.name}.u{u.index}"
            got = loader.my_flat_shard(name, u.sharder.rank, u.sharder.size)
            if got.size != u.shard.numel():
                raise ShardResizeError(
                    f"restored window for unit {u.index} has "
                    f"{got.size} elements, expected {u.shard.numel()}")
            with torch.no_grad():
                u.shard.copy_(as_tensor(got, torch.float32,
                                        bf16=loader.flat_is_bf16(name)))
        for i in range(self.n_units):
            self.free(i)
