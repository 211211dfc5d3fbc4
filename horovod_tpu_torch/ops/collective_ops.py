"""The device plane: collectives over named mesh axes, inside the step.

Counterpart of ``horovod_tpu/ops/collective_ops.py``.  The reference's
collectives are single XLA ops over a named mesh axis inside a jitted
``shard_map`` program; here each is one or two ``torch.distributed``
collectives on the process group of that axis (NCCL on the card, gloo on
the CPU; a gloo group stages CUDA tensors through the host), through
``parallel/comm.py``'s transport, whose ``stats`` count every call.  The
result is on the input's device, in the input's dtype, except where the
reference's is not: ``Average`` of an integer tensor is fp32 (JAX's true
division).

Two communicators, as in the reference: these functions are the device
plane, which ``hvd.allreduce``, ``grouped_allreduce``, ``allgather``,
``broadcast``, ``reducescatter`` and ``alltoall`` take while a step built
by ``make_train_step`` or ``make_parallel_train_step`` runs the user's
loss function (:func:`in_step`; the reference's traced branch).  Outside
a step those names are the native engine's eager collectives on named
tensors (``runtime/eager.py``), as before.

``axis_name`` is a mesh axis name or a tuple of them (taken together,
the first outermost), resolved on the mesh in use (``parallel/mesh.py``:
``use_mesh``, ``default_mesh``); with no mesh set, ``"data"`` is the
default process group.  Axes of size 1 drop out, and over an axis of
size 1 every function returns its input's value.

Sums run in rank order (``comm.sum_in_order``), in fp32 for a half
type, rounded once: the reference's ``psum`` on the CPU, bit for bit,
whatever the backend's own allreduce would do.  ``Average`` is that sum
divided by the axis size (``pmean``).  ``Min`` and ``Max`` are the
group's own reductions.  ``Product`` gathers and multiplies, as the
reference does, which is exact for integers.

Every function is differentiable, with the backward that ``jax.grad``
gives the reference's function inside ``make_train_step``'s
``shard_map(check_vma=False)``: a sum's cotangents are summed over the
axis (``psum`` transposes to ``psum``, so ``Average``'s are summed and
divided); ``allgather``'s are reduce-scattered and ``reducescatter``'s
gathered; ``alltoall``'s go back with the axes swapped; ``broadcast``'s
are summed on the root and zero elsewhere (the transpose of the masked
``psum``); ``Product``'s are the gather's transpose of the product's.
``Min`` and ``Max`` have none, as ``pmin`` and ``pmax`` have none: their
backward raises.
"""

from __future__ import annotations

import contextlib
import enum
import threading
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from horovod_tpu_torch.ops.compression import Compression
from horovod_tpu_torch.parallel import comm
from horovod_tpu_torch.parallel import mesh as _mesh

__all__ = ["ReduceOp", "Sum", "Average", "Min", "Max", "Product",
           "allreduce", "allreduce_", "grouped_allreduce", "allgather",
           "broadcast", "reducescatter", "alltoall", "axis_rank",
           "axis_size", "in_step", "step_axis"]


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

_INTS = (torch.uint8, torch.int8, torch.int16, torch.int32, torch.int64)

_DIST_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MIN: dist.ReduceOp.MIN,
             ReduceOp.MAX: dist.ReduceOp.MAX}

# ---------------------------------------------------------------------------
# the step's context
# ---------------------------------------------------------------------------

_step = threading.local()


@contextlib.contextmanager
def in_step(axis_name):
    """While a step runs the user's loss function: the frontend's
    collectives take the device plane, over ``axis_name`` (the step's data
    axes) unless given another."""
    prev = getattr(_step, "axis", None)
    _step.axis = axis_name
    try:
        yield
    finally:
        _step.axis = prev


def step_axis():
    """The running step's data axes, or None outside a step."""
    return getattr(_step, "axis", None)


def _axis(axis_name) -> comm._Axis:
    """``axis_name`` (a name, a tuple of names, or a ``comm`` axis) as one
    axis of the mesh in use."""
    if isinstance(axis_name, comm._Axis):
        return axis_name
    names = ((axis_name,) if isinstance(axis_name, str)
             else tuple(axis_name))
    mesh = _mesh.current_mesh()
    if mesh is None and names == (_mesh.AXIS_DATA,):
        return comm.world_axis()
    mesh = mesh if mesh is not None else _mesh.default_mesh()
    sizes = _mesh.axis_sizes(mesh)
    for a in names:
        if a not in sizes:
            raise ValueError(f"mesh has no axis {a!r} (axes "
                             f"{tuple(sizes)})")
    names = tuple(a for a in names if sizes[a] > 1)
    if not names:
        return comm._Axis(None, 0, 1)
    if len(names) == 1:
        return comm.axis_group(mesh, names[0])
    return comm.axes_group(mesh, names)


def axis_rank(axis_name) -> int:
    """This rank's index along ``axis_name``."""
    return _axis(axis_name).index


def axis_size(axis_name) -> int:
    return _axis(axis_name).size


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

class _NoGrad(torch.autograd.Function):
    """Identity forward; backward raises, as ``jax.grad`` does through a
    primitive without a differentiation rule."""

    @staticmethod
    def forward(ctx, x, out, prim):
        ctx.prim = prim
        return out

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            f"Differentiation rule for '{ctx.prim}' not implemented")


def _extremum(x: torch.Tensor, axis: comm._Axis, op: ReduceOp):
    out = comm.allreduce(x.detach(), axis, _DIST_OPS[op])
    if not x.requires_grad:
        return out
    return _NoGrad.apply(x, out, "pmin" if op is Min else "pmax")


def _product(x: torch.Tensor, axis: comm._Axis) -> torch.Tensor:
    parts = comm.gather_shards(x.unsqueeze(0), axis, 0)
    if x.dtype in (torch.float16, torch.bfloat16):
        return parts.float().prod(0).to(x.dtype)
    return parts.prod(0, dtype=x.dtype)


def _reduce(x: torch.Tensor, axis: comm._Axis, op: ReduceOp) -> torch.Tensor:
    if op is Sum:
        return comm.sum_in_order(x, axis)
    if op is Average:
        return comm.sum_in_order(x, axis) / axis.size
    if op in (Min, Max):
        return _extremum(x, axis, op)
    if op is Product:
        return _product(x, axis)
    raise ValueError(f"unknown op {op}")


def allreduce(tensor: torch.Tensor, *, axis_name="data",
              op: ReduceOp = Average, compression=Compression.none,
              average: Optional[bool] = None) -> torch.Tensor:
    """Allreduce ``tensor`` over ``axis_name``.  ``average=`` keeps the
    reference signature; ``compression`` casts to the wire dtype for the
    reduction only."""
    if average is not None:
        op = Average if average else Sum
    wire, ctx = compression.compress(tensor)
    return compression.decompress(_reduce(wire, _axis(axis_name), op), ctx)


def allreduce_(tensor: torch.Tensor, op: ReduceOp = Average) -> torch.Tensor:
    """Reduce ``tensor`` in place across the default group with the
    group's own allreduce (no autograd; the gradient path of
    ``DistributedOptimizer``); returns it."""
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


def grouped_allreduce(tensors: Sequence[torch.Tensor], *, axis_name="data",
                      op: ReduceOp = Average,
                      compression=Compression.none) -> List[torch.Tensor]:
    """Allreduce a list of tensors, one collective per fused same-dtype
    bucket (``ops/fusion.py``, ``HOROVOD_FUSION_THRESHOLD``)."""
    from horovod_tpu_torch.ops.fusion import fuse_apply

    axis = _axis(axis_name)

    def _fn(buf):
        return allreduce(buf, axis_name=axis, op=op, compression=compression)

    return fuse_apply(list(tensors), _fn)


# ---------------------------------------------------------------------------
# data movement
# ---------------------------------------------------------------------------

def allgather(tensor: torch.Tensor, *, axis_name="data",
              axis: int = 0) -> torch.Tensor:
    """Every rank's ``tensor`` concatenated along ``axis`` in rank order
    (tiled; every rank's shape must be the same)."""
    return comm.gather_shards(tensor, _axis(axis_name), axis % tensor.dim())


def broadcast(tensor: torch.Tensor, root_rank: int = 0, *,
              axis_name="data") -> torch.Tensor:
    """Every rank receives ``root_rank``'s ``tensor`` (its index on the
    axis).  Float, complex and integer dtypes, as the reference's.  Its
    masked ``psum`` turns a root's ``-0.0`` into ``0.0`` and gives zeros
    for a root off the axis; this sends the root's bits and raises for
    such a root (``ROADMAP.md`` Queue C, C24 and C25)."""
    dt = tensor.dtype
    if not (dt.is_floating_point or dt.is_complex or dt in _INTS):
        raise TypeError(f"broadcast: unsupported dtype {dt}")
    axis = _axis(axis_name)
    if not 0 <= root_rank < axis.size:
        raise ValueError(f"root_rank {root_rank} is not on an axis of "
                         f"size {axis.size}")
    return comm.broadcast_from(tensor, axis, root_rank)


def reducescatter(tensor: torch.Tensor, *, axis_name="data",
                  op: ReduceOp = Sum, scatter_axis: int = 0,
                  tiled: bool = True) -> torch.Tensor:
    """The ranks' ``tensor`` summed (``Average``: divided by the axis
    size), this rank's chunk of ``scatter_axis``, which the axis size must
    divide; ``tiled=False`` needs it equal to the axis size and removes
    it (``lax.psum_scatter``).  Sum and Average only: the reference sums
    for any other op (``ROADMAP.md`` Queue C, C25)."""
    if op not in (Sum, Average):
        raise ValueError(f"reducescatter supports Sum and Average, not {op}")
    axis = _axis(axis_name)
    dim = scatter_axis % tensor.dim()
    if not tiled and tensor.shape[dim] != axis.size:
        raise ValueError(
            f"tiled=False requires dim {dim} (length {tensor.shape[dim]}) "
            f"to equal the axis size ({axis.size}), like lax.psum_scatter")
    if tensor.shape[dim] % axis.size:
        raise ValueError(f"reducescatter: dimension {dim} of "
                         f"{tuple(tensor.shape)} does not split into "
                         f"{axis.size}")
    out = comm.reduce_scatter(tensor, axis, dim)
    if op is Average:
        out = out / axis.size
    return out if tiled else out.squeeze(dim)


def alltoall(tensor: torch.Tensor, *, axis_name="seq", split_axis: int = 0,
             concat_axis: int = 0) -> torch.Tensor:
    """Chunk ``j`` of ``split_axis`` goes to rank ``j``; what arrives is
    concatenated along ``concat_axis`` in rank order
    (``lax.all_to_all(tiled=True)``)."""
    return comm.all_to_all(tensor, _axis(axis_name),
                           split_axis % tensor.dim(),
                           concat_axis % tensor.dim())
