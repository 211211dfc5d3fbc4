"""Eager collectives across processes: the surface of ``hvd.allreduce``,
``grouped_allreduce``, ``allgather``, ``broadcast``, ``reducescatter`` and
``alltoall`` on tensors.

Counterpart of ``horovod_tpu/runtime/eager.py`` and of the eager half of
``horovod_tpu/jax/__init__.py`` (its axis shims for ``reducescatter`` and
``alltoall``): the enqueue -> negotiate -> execute pipeline of the native
engine, whose rank-0 coordinator agrees on an identically ordered, fused
batch of named collectives each cycle and runs them as ring collectives
between the host processes.  Tensors may be CPU or CUDA tensors; results
come back on the input's device (``runtime/mpi_ops.py`` stages them).

At ``size() == 1`` every collective is an identity that returns a new
tensor, with the compression's casts still applied.  Averaging is a sum on
the wire and a divide on return; MIN, MAX and PRODUCT ride the wire.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.ops.collective_ops import (Average, Max, Min,
                                                  Product, Sum)
from horovod_tpu_torch.ops.compression import Compression
from horovod_tpu_torch.runtime import engine_or_none as _engine
from horovod_tpu_torch.runtime import mpi_ops

__all__ = ["allreduce", "grouped_allreduce", "allgather", "broadcast",
           "reducescatter", "alltoall"]

#: ReduceOp -> the engine's wire op.
_WIRE_OPS = {Sum: "sum", Average: "sum", Min: "min", Max: "max",
             Product: "prod"}


def _resolve_op(op, average):
    if average is not None:
        return Average if average else Sum
    if op not in _WIRE_OPS:
        raise NotImplementedError(
            "eager cross-process reductions support "
            f"SUM/AVERAGE/MIN/MAX/PRODUCT, got {op}")
    return op


def _engine_wire(compression) -> Optional[str]:
    """A wire compressor's engine wire dtype ("int8", ...), else None: the
    wire family compresses in the engine, not by casting the tensor."""
    wd = getattr(compression, "engine_wire_dtype", None)
    return wd if wd in ("fp16", "bf16", "int8", "fp8") else None


def _identity(t: torch.Tensor) -> torch.Tensor:
    return t.detach().clone()


def allreduce(tensor: torch.Tensor, *, op=Average, average=None,
              compression=Compression.none, name: Optional[str] = None,
              priority: Optional[int] = None) -> torch.Tensor:
    """Reduce ``tensor`` across processes; ``name`` pairs the call across
    ranks (auto-named in program order by default); ``priority`` (0 = most
    urgent) orders responses under HOROVOD_PRIORITY_BANDS."""
    op = _resolve_op(op, average)
    wire, ctx = compression.compress(tensor)
    if _engine() is None:
        return compression.decompress(_identity(wire), ctx)
    out = mpi_ops.synchronize(mpi_ops.allreduce_async(
        wire, op is Average, name, red_op=_WIRE_OPS[op],
        wire_dtype=_engine_wire(compression), priority=priority))
    return compression.decompress(out, ctx)


def grouped_allreduce(tensors: Sequence[torch.Tensor], *, op=Average,
                      average=None, compression=Compression.none,
                      name: Optional[str] = None,
                      priorities: Optional[Sequence[int]] = None):
    """Allreduce many tensors, enqueued together so that the coordinator
    fuses them into few ring collectives.  ``priorities``: one per
    tensor."""
    op = _resolve_op(op, average)
    if priorities is not None and len(priorities) != len(tensors):
        raise ValueError(
            f"{len(tensors)} tensors but {len(priorities)} priorities")
    pairs = [compression.compress(t) for t in tensors]
    if _engine() is None:
        return [compression.decompress(_identity(w), c) for w, c in pairs]
    wd = _engine_wire(compression)
    handles = mpi_ops.grouped_allreduce_async(
        [w for w, _ in pairs], op is Average, name, red_op=_WIRE_OPS[op],
        wire_dtypes=None if wd is None else [wd] * len(pairs),
        priorities=priorities)
    return [compression.decompress(out, c)
            for out, (_, c) in zip(mpi_ops._drain(handles), pairs)]


def allgather(tensor: torch.Tensor, *, name: Optional[str] = None
              ) -> torch.Tensor:
    """Concatenate every rank's tensor along dim 0 (counts may differ)."""
    if _engine() is None:
        return _identity(tensor)
    return mpi_ops.synchronize(mpi_ops.allgather_async(tensor, name))


def broadcast(tensor: torch.Tensor, root_rank: int = 0, *,
              name: Optional[str] = None) -> torch.Tensor:
    """Every rank receives root's value."""
    mpi_ops._check_root(root_rank)
    if _engine() is None:
        return _identity(tensor)
    return mpi_ops.synchronize(mpi_ops.broadcast_async(tensor, root_rank,
                                                       name))


def reducescatter(tensor: torch.Tensor, *, op=Sum, average=None,
                  scatter_axis: int = 0, tiled: bool = True,
                  name: Optional[str] = None) -> torch.Tensor:
    """Reduce across processes and keep this rank's part of
    ``scatter_axis`` (rows split as evenly as possible, earlier ranks take
    the remainder).  ``tiled=False`` removes the scattered axis, whose
    length must then equal ``size()`` (``lax.psum_scatter``'s rule)."""
    op = _resolve_op(op, average)
    n = basics.size()
    if not tiled and tensor.shape[scatter_axis] != n:
        raise ValueError(
            f"tiled=False requires dim {scatter_axis} (length "
            f"{tensor.shape[scatter_axis]}) to equal size() ({n}), like "
            "lax.psum_scatter")
    if _engine() is None:
        out = _identity(tensor)
    else:
        moved = torch.movedim(tensor, scatter_axis, 0)
        out = torch.movedim(mpi_ops.synchronize(mpi_ops.reducescatter_async(
            moved, name, red_op=_WIRE_OPS[op], average=op is Average)),
            0, scatter_axis)
    return out if tiled else out.squeeze(scatter_axis)


def alltoall(tensor: torch.Tensor, *, split_axis: int = 0,
             concat_axis: int = 0, name: Optional[str] = None, splits=None,
             wire_dtype: Optional[str] = None,
             priority: Optional[int] = None) -> torch.Tensor:
    """Split ``tensor`` into ``size()`` blocks along ``split_axis``; block i
    goes to rank i; the received blocks concatenate along
    ``concat_axis``.  ``splits`` (dim 0 only) sends ``splits[d]`` rows to
    rank d."""
    if _engine() is None:
        return _identity(tensor)
    if splits is not None and (split_axis != 0 or concat_axis != 0):
        raise NotImplementedError(
            "variable splits address dim-0 rows; use split_axis=0, "
            "concat_axis=0")
    if split_axis == 0 and concat_axis == 0:
        return mpi_ops.synchronize(mpi_ops.alltoall_async(
            tensor, name, splits=splits, wire_dtype=wire_dtype,
            priority=priority))
    moved = torch.movedim(tensor, split_axis, 0)
    z = mpi_ops.synchronize(mpi_ops.alltoall_async(moved, name))
    blocks = [torch.movedim(b, 0, split_axis)
              for b in torch.chunk(z, basics.size(), dim=0)]
    return torch.cat(blocks, dim=concat_axis)
