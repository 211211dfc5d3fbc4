"""Collectives over the default process group: allreduce.

Counterpart of ``horovod_tpu/ops/collective_ops.py``.  The reference's
collectives are XLA ops over a named mesh axis inside ``jit``; here there
is no mesh, and the default ``torch.distributed`` group (``hvd.init()``)
is the data axis.  ``make_train_step``, ``DistributedOptimizer`` and
``allreduce_gradients`` reduce through it (``frontend.py``); the eager
collectives on named tensors, ``hvd.allreduce`` and the rest, are the
native engine's (``runtime/eager.py``).

``Average`` is the reference's ``pmean``: NCCL's AVG where the backend
has it, else (gloo) SUM followed by a division by the world size.
``Product`` has no NCCL-and-gloo op in common; it gathers and multiplies,
as the reference does, which is exact for every dtype.
"""

from __future__ import annotations

import enum
from typing import Optional

import torch
import torch.distributed as dist

from horovod_tpu_torch.ops.compression import Compression

__all__ = ["ReduceOp", "Sum", "Average", "Min", "Max", "Product",
           "allreduce", "allreduce_"]


class ReduceOp(enum.Enum):
    SUM = "sum"
    AVERAGE = "average"
    MIN = "min"
    MAX = "max"
    PRODUCT = "product"


Sum = ReduceOp.SUM
Average = ReduceOp.AVERAGE
Min = ReduceOp.MIN
Max = ReduceOp.MAX
Product = ReduceOp.PRODUCT

_DIST_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MIN: dist.ReduceOp.MIN,
             ReduceOp.MAX: dist.ReduceOp.MAX}


def allreduce_(tensor: torch.Tensor, op: ReduceOp = Average) -> torch.Tensor:
    """Reduce ``tensor`` in place across the default group; returns it."""
    if op is ReduceOp.AVERAGE:
        if dist.get_backend() == "nccl":
            dist.all_reduce(tensor, op=dist.ReduceOp.AVG)
        else:
            dist.all_reduce(tensor, op=dist.ReduceOp.SUM)
            tensor.div_(dist.get_world_size())
    elif op is ReduceOp.PRODUCT:
        parts = [torch.empty_like(tensor)
                 for _ in range(dist.get_world_size())]
        dist.all_gather(parts, tensor)
        tensor.copy_(torch.stack(parts).prod(dim=0))
    elif op in _DIST_OPS:
        dist.all_reduce(tensor, op=_DIST_OPS[op])
    else:
        raise ValueError(f"unknown op {op}")
    return tensor


def allreduce(tensor: torch.Tensor, *, op: ReduceOp = Average,
              compression=Compression.none,
              average: Optional[bool] = None) -> torch.Tensor:
    """Allreduce ``tensor`` over the default group.  ``average=`` keeps the
    reference signature; ``compression`` casts to the wire dtype for the
    reduction only."""
    if average is not None:
        op = Average if average else Sum
    wire, ctx = compression.compress(tensor)
    if wire is tensor:
        wire = tensor.clone()
    return compression.decompress(allreduce_(wire, op), ctx)

