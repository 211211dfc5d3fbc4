"""ZeRO-1 core: the flat-vector partitioner both frontends' sharded
optimizers ride (Rajbhandari et al., "ZeRO", stage 1).

Counterpart of ``horovod_tpu/runtime/sharded.py``, on torch tensors on
any device instead of numpy.  With N data-parallel ranks every rank keeps
the optimizer state and fp32 master weights of its own shard of ONE flat
vector of the parameters, split with the engine's largest-first dim-0
convention (the split the coordinator commits for ``reducescatter``):

    reducescatter(flat grads)          # this rank's shard of the sum
    local update of the owned shard    # elementwise optimizer math
    allgather(updated shard)           # every rank leaves with all of it

Bit-exactness: the flat vector is 1-D, so ``reducescatter(g)[rank]`` is
bit for bit ``allreduce(g)`` sliced to the owned shard; an elementwise
optimizer computes on the shard the bytes it would compute on the whole
vector, and the allgather moves bytes verbatim.  A sharded step is
therefore bit-identical to the unsharded flat step.

The vectors stay on the parameters' device: the eager collectives stage a
CUDA tensor through pinned host memory behind its ready event
(``runtime/staging.py``) and return the result on that device, so no
gradient or parameter is converted to numpy.

Resize semantics, as the reference's: the split is a function of (flat
length, world size), anchored at construction with the membership epoch.
A same-size epoch bump re-anchors; a change of size raises
:class:`ShardResizeError`.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.runtime import mpi_ops
from horovod_tpu_torch.runtime.engine import note_sharded_step

__all__ = ["shard_bounds", "my_shard", "ShardResizeError", "FlatSharder",
           "sharded_default"]


class ShardResizeError(RuntimeError):
    """The world size changed under a sharded optimizer: the shard layout
    (and with it the ownership of optimizer state) is no longer the one
    the state was built for.  Rebuild the optimizer for the new world."""


def sharded_default() -> bool:
    """The ``HOROVOD_SHARDED`` env default for
    ``DistributedOptimizer(sharded=None)`` (off unless set)."""
    raw = os.environ.get("HOROVOD_SHARDED", "")
    return raw.strip() not in ("", "0", "false", "False")


def shard_bounds(n: int, size: int) -> List[Tuple[int, int]]:
    """Per-rank ``(offset, count)`` of a flat length-``n`` vector under the
    engine's largest-first split: ``n // size`` each, the first ``n %
    size`` ranks one more (the coordinator's reducescatter geometry)."""
    bounds = []
    off = 0
    for r in range(size):
        cnt = n // size + (1 if r < n % size else 0)
        bounds.append((off, cnt))
        off += cnt
    return bounds


def my_shard(n: int, rank: int, size: int) -> Tuple[int, int]:
    """This rank's ``(offset, count)`` of the flat vector."""
    return shard_bounds(n, size)[rank]


def _world() -> Tuple[int, int, int]:
    """(size, rank, epoch) of the committed world; (1, 0, 0) before
    ``hvd.init()``."""
    if not basics.is_initialized():
        return 1, 0, 0
    return basics.size(), basics.rank(), basics.epoch()


class FlatSharder:
    """Flat-vector partitioner and the reducescatter/allgather halves of
    a ZeRO step.

    Owns the world anchor (epoch, size, flat length, shard bounds) and the
    wire ops, not the optimizer math: :meth:`step` takes a
    ``local_update(shard_grads) -> shard_updates`` callback.  ``name``
    namespaces the collectives (``<name>.rs.grads``, ``sharded.ag.<name>``);
    a per-process construction counter keeps two sharders apart, and the
    names agree across ranks because construction follows program order.
    """

    _instances = 0

    def __init__(self, n: int, dtype: torch.dtype = torch.float32, *,
                 name: str = "zero"):
        self.n = int(n)
        self.dtype = dtype
        self.name = f"{name}.{FlatSharder._instances}"
        FlatSharder._instances += 1
        self.size, self.rank, self.epoch = _world()
        self.offset, self.count = my_shard(self.n, self.rank, self.size)
        self._steps = 0

    def check_world(self) -> None:
        """Re-anchor on a same-size epoch bump (the layout is unchanged);
        raise :class:`ShardResizeError` when the world size moved."""
        size, _, epoch = _world()
        if size != self.size:
            raise ShardResizeError(
                f"sharded optimizer '{self.name}' was built for world "
                f"size {self.size} (epoch {self.epoch}) but the committed "
                f"world is now size {size} (epoch {epoch}); the shard "
                "layout changed, so per-rank optimizer state no longer "
                "matches its owner. Rebuild the optimizer for the new "
                "world.")
        self.epoch = epoch

    # -- the step halves --

    def reduce_grads(self, flat_grads: torch.Tensor, *,
                     average: bool = True,
                     wire_dtype: Optional[str] = None) -> torch.Tensor:
        """This rank's shard of the gradient reduction: one engine
        reducescatter of the flat vector (half an allreduce's bytes),
        averaged by the committed participant count.  Returns the shard
        (``count`` values) on the input's device."""
        self.check_world()
        flat = flat_grads.reshape(-1).to(self.dtype)
        if flat.numel() != self.n:
            raise ValueError(f"flat gradient length {flat.numel()} != "
                             f"sharder length {self.n}")
        if self.size == 1:
            return flat[self.offset:self.offset + self.count].clone()
        # A stable name: the response cache negotiates steady-state steps
        # through a slot bit.
        return mpi_ops.synchronize(mpi_ops.reducescatter_async(
            flat, name=f"{self.name}.rs.grads", average=average,
            wire_dtype=wire_dtype))

    def gather_updates(self, shard_updates: torch.Tensor) -> torch.Tensor:
        """Allgather every rank's shard back into the full flat vector
        (named ``sharded.ag.*``)."""
        upd = shard_updates.reshape(-1)
        if upd.numel() != self.count:
            raise ValueError(f"shard update length {upd.numel()} != owned "
                             f"shard {self.count}")
        if self.size == 1:
            return upd
        return mpi_ops.synchronize(mpi_ops.allgather_async(
            upd, name=f"sharded.ag.{self.name}"))

    def step(self, flat_grads: torch.Tensor,
             local_update: Callable[[torch.Tensor], torch.Tensor], *,
             average: bool = True,
             wire_dtype: Optional[str] = None) -> torch.Tensor:
        """One ZeRO step over the flat vector: reducescatter,
        ``local_update`` on the owned shard, allgather.  Returns the full
        flat update vector."""
        shard_g = self.reduce_grads(flat_grads, average=average,
                                    wire_dtype=wire_dtype)
        full = self.gather_updates(local_update(shard_g).to(self.dtype))
        self._steps += 1
        note_sharded_step()
        return full

    # -- flat <-> list-of-tensors helpers --

    @staticmethod
    def flatten(tensors: Sequence[torch.Tensor], dtype: torch.dtype
                ) -> torch.Tensor:
        """Concatenate tensors (row-major raveled) into one flat vector of
        ``dtype`` on their device."""
        if not tensors:
            return torch.zeros(0, dtype=dtype)
        return torch.cat([t.detach().reshape(-1).to(dtype)
                          for t in tensors])

    @staticmethod
    def slice_flat(tensors: Sequence[torch.Tensor], offset: int,
                   count: int, dtype: torch.dtype) -> torch.Tensor:
        """The ``[offset, offset + count)`` window of the virtual
        concatenation of ``tensors``, converting only the tensors that
        overlap it (never a full flat copy of the model)."""
        parts, pos = [], 0
        end = offset + count
        for t in tensors:
            n = t.numel()
            lo, hi = max(offset, pos), min(end, pos + n)
            if lo < hi:
                parts.append(t.detach().reshape(-1)[lo - pos:hi - pos]
                             .to(dtype))
            pos += n
        if not parts:
            dev = tensors[0].device if tensors else None
            return torch.zeros(0, dtype=dtype, device=dev)
        if len(parts) == 1:
            return parts[0].contiguous()
        return torch.cat(parts)

    @staticmethod
    def unflatten(flat: torch.Tensor, shapes: Sequence[tuple]
                  ) -> List[torch.Tensor]:
        """Split the flat vector back into views of ``shapes``."""
        outs, off = [], 0
        for shp in shapes:
            cnt = 1
            for d in shp:
                cnt *= int(d)
            outs.append(flat[off:off + cnt].view(shp))
            off += cnt
        return outs
