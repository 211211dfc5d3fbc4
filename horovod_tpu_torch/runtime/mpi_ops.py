"""Eager collectives on tensors: async handles, in-place variants, autograd.

Counterpart of ``horovod_tpu/torch/mpi_ops.py``: the reference's torch
surface, ``allreduce[_async][_]``, ``grouped_allreduce[_async]``,
``allgather[_async]``, ``broadcast[_async][_]``, ``reducescatter[_async]``
and ``alltoall[_async]``, ``poll``/``synchronize`` on the engine's int64
handles, and the autograd Functions whose backward passes are themselves
collectives.  The difference: a tensor may live on the card.  A CUDA
tensor is staged through pinned host memory behind a ready event
(``runtime/staging.py``), and its result comes back on its own device, on
the caller's current stream, at :func:`synchronize`.  A CPU tensor goes to
the engine as it is (in-place variants) or as a contiguous copy.

Averages are a sum on the wire and a divide on the result's device after
the bytes return: a true divide in the tensor's dtype for floats (by a
divisor tensor on that device, so CPU and CUDA results agree bit for bit),
a floor divide for integers; the divisor is the number of ranks the
response reduced (``participants``), not ``size()``.  At ``size() == 1``
every collective is an identity with the same handle API.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence

import torch

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.runtime import engine_or_none as _engine
from horovod_tpu_torch.runtime import staging

__all__ = ["allreduce", "allreduce_async", "allreduce_", "allreduce_async_",
           "grouped_allreduce", "grouped_allreduce_async", "allgather",
           "allgather_async", "broadcast", "broadcast_async", "broadcast_",
           "broadcast_async_", "reducescatter", "reducescatter_async",
           "alltoall", "alltoall_async", "poll", "synchronize"]


@dataclasses.dataclass
class _Pending:
    """What :func:`synchronize` needs of an enqueued collective."""

    host: torch.Tensor              # the buffer the engine was given
    device: torch.device            # where the result goes
    lease: Optional[torch.Tensor]   # pinned pool buffer under ``host``
    target: Optional[torch.Tensor]  # in-place variants: the caller's tensor
    average: bool


_handle_lock = threading.Lock()
_handle_map: Dict[int, _Pending] = {}
# Results of the size-1 fast path, under negative handles (the engine's
# are >= 0).
_local_results: Dict[int, torch.Tensor] = {}
_next_local = [-1]


def _local_handle(result: torch.Tensor) -> int:
    with _handle_lock:
        h = _next_local[0]
        _next_local[0] -= 1
        _local_results[h] = result
    return h


def average_(t: torch.Tensor, n: int) -> torch.Tensor:
    """Divide ``t`` in place by ``n`` ranks: a true divide in its dtype for
    floats, a floor divide for integers.  The divisor is a tensor on
    ``t``'s device: CUDA turns a divide by a host scalar into a multiply
    by its reciprocal, which can differ in the last bit."""
    if t.is_floating_point():
        return t.div_(torch.full((), n, dtype=t.dtype, device=t.device))
    return t.floor_divide_(n)


# Engine ops that write their result into the enqueued buffer.
_IN_PLACE_KINDS = ("allreduce", "broadcast")


def _enqueue_many(kind: str, tensors: Sequence[torch.Tensor], *,
                  inplace: bool = False, average: bool = False,
                  names: Optional[Sequence[Optional[str]]] = None,
                  **kwargs) -> List[int]:
    """Enqueue one ``kind`` collective per tensor (CUDA tensors staged as
    one batch: one ready event and one wait per device); returns their
    handles.  ``kwargs`` go to the engine's ``enqueue_<kind>``, with
    ``priorities``/``wire_dtypes`` given per tensor."""
    eng = _engine()
    srcs = [t.detach() for t in tensors]
    if eng is None:
        return [_local_handle(t if inplace else s.contiguous().clone())
                for t, s in zip(tensors, srcs)]
    if inplace:
        for s in srcs:
            if not s.is_contiguous():
                raise ValueError("in-place collectives need a contiguous "
                                 "tensor")
    on_card = [i for i, s in enumerate(srcs) if s.device.type == "cuda"]
    staged = dict(zip(on_card, staging.to_host([srcs[i] for i in on_card])))
    per_tensor = {"priority": kwargs.pop("priorities", None),
                  "wire_dtype": kwargs.pop("wire_dtypes", None)}
    enqueue = getattr(eng, f"enqueue_{kind}")
    handles: List[int] = []
    try:
        for i, s in enumerate(srcs):
            if i in staged:
                host, lease = staged.pop(i)
            elif inplace:
                host, lease = s, None
            elif kind in _IN_PLACE_KINDS:
                host = s.clone(memory_format=torch.contiguous_format)
                lease = None
            else:
                host, lease = s.contiguous(), None
            extra = {k: v[i] for k, v in per_tensor.items() if v is not None}
            try:
                h = enqueue(host, name=None if names is None else names[i],
                            **kwargs, **extra)
            except BaseException:
                if lease is not None:
                    staging.pool().give(lease)
                raise
            with _handle_lock:
                _handle_map[h] = _Pending(host, s.device, lease,
                                          tensors[i] if inplace else None,
                                          average)
            handles.append(h)
    except BaseException:
        for host, lease in staged.values():
            staging.pool().give(lease)
        for h in handles:           # never leave a name in flight
            try:
                synchronize(h)
            except Exception:  # noqa: BLE001 -- the first error is raised
                pass
        raise
    return handles


def _enqueue(kind: str, tensor: torch.Tensor, name: Optional[str], **kw
             ) -> int:
    return _enqueue_many(kind, [tensor], names=[name], **kw)[0]


def poll(handle: int) -> bool:
    """True once the collective behind ``handle`` has completed."""
    if handle < 0:
        return True
    from horovod_tpu_torch.runtime.engine import get_engine
    return get_engine().poll(handle)


def synchronize(handle: int) -> torch.Tensor:
    """Wait for the collective and return its result, on the device of the
    tensor it was given (a CUDA result is copied on the caller's current
    stream)."""
    if handle < 0:
        with _handle_lock:
            return _local_results.pop(handle)
    from horovod_tpu_torch.runtime.engine import get_engine
    with _handle_lock:
        rec = _handle_map.pop(handle)
    on_card = rec.device.type == "cuda"
    leases = []

    def alloc(shape, dtype):
        if not on_card:
            return torch.empty(shape, dtype=dtype)
        view, lease = staging.host_buffer(shape, dtype)
        leases.append(lease)
        return view

    info: dict = {}
    try:
        out = get_engine().synchronize(handle, info, alloc=alloc)
    except BaseException:
        for lease in leases + [rec.lease]:
            if lease is not None:
                staging.pool().give(lease)
        raise
    dest = None if rec.target is None else rec.target.detach()
    if on_card:
        if out is rec.host:
            out = staging.to_device(out, rec.lease, rec.device, out=dest)
        else:
            staging.pool().give(rec.lease)
            out = staging.to_device(out, leases[0], rec.device)
    if rec.average:
        average_(out, info.get("participants") or basics.size())
    return out if rec.target is None else rec.target


def _drain(handles: Sequence[int]) -> List[torch.Tensor]:
    """Synchronize every handle, then raise the first error, if any."""
    outs, first_err = [], None
    for h in handles:
        try:
            outs.append(synchronize(h))
        except Exception as e:  # noqa: BLE001 -- raised after the batch
            first_err = first_err or e
            outs.append(None)
    if first_err is not None:
        raise first_err
    return outs


# ---------------------------------------------------------------------------
# allreduce
# ---------------------------------------------------------------------------

def allreduce_async_(tensor: torch.Tensor, average: bool = True,
                     name: Optional[str] = None,
                     wire_dtype: Optional[str] = None,
                     priority: Optional[int] = None,
                     wire_advisory: bool = False) -> int:
    """In-place async sum or average over all processes.  ``wire_dtype``
    (fp32/fp16/bf16/int8/fp8) sets this tensor's wire format (fp32
    payloads only); ``priority`` (0 = most urgent) orders responses under
    HOROVOD_PRIORITY_BANDS."""
    return _enqueue("allreduce", tensor, name, inplace=True, average=average,
                    wire_dtype=wire_dtype, priority=priority,
                    wire_advisory=wire_advisory)


def allreduce_async(tensor: torch.Tensor, average: bool = True,
                    name: Optional[str] = None, *, red_op: str = "sum",
                    wire_dtype: Optional[str] = None,
                    priority: Optional[int] = None) -> int:
    """Out-of-place async allreduce (``red_op``: sum/min/max/prod; an
    average divides a sum)."""
    return _enqueue("allreduce", tensor, name, average=average,
                    red_op=red_op, wire_dtype=wire_dtype, priority=priority)


def allreduce_(tensor: torch.Tensor, average: bool = True,
               name: Optional[str] = None) -> torch.Tensor:
    return synchronize(allreduce_async_(tensor, average, name))


class _HorovodAllreduce(torch.autograd.Function):
    """The gradient of an allreduce is an allreduce."""

    @staticmethod
    def forward(ctx, tensor, average, name):
        ctx.average = average
        return synchronize(allreduce_async(tensor, average, name))

    @staticmethod
    def backward(ctx, grad_output):
        return synchronize(allreduce_async(grad_output, ctx.average)), \
            None, None


def allreduce(tensor: torch.Tensor, average: bool = True,
              name: Optional[str] = None, compression=None) -> torch.Tensor:
    """Out-of-place, differentiable allreduce."""
    from horovod_tpu_torch.ops.compression import Compression

    compression = compression or Compression.none
    wire, cctx = compression.compress(tensor)
    return compression.decompress(_HorovodAllreduce.apply(wire, average,
                                                          name), cctx)


def grouped_allreduce_async(tensors: Sequence[torch.Tensor],
                            average: bool = True,
                            name: Optional[str] = None, **kwargs
                            ) -> List[int]:
    """Allreduce many tensors in one burst: enqueued together, the
    coordinator negotiates them in one cycle and fuses same-dtype batches
    into single ring collectives.  One handle per tensor."""
    names = [None if name is None else f"{name}.{i}"
             for i in range(len(tensors))]
    return _enqueue_many("allreduce", tensors, average=average, names=names,
                         **kwargs)


def grouped_allreduce(tensors: Sequence[torch.Tensor], average: bool = True,
                      name: Optional[str] = None) -> List[torch.Tensor]:
    return _drain(grouped_allreduce_async(tensors, average, name))


# ---------------------------------------------------------------------------
# allgather
# ---------------------------------------------------------------------------

def allgather_async(tensor: torch.Tensor, name: Optional[str] = None,
                    priority: Optional[int] = None) -> int:
    """Concatenate every rank's tensor along dim 0 (counts may differ)."""
    src = tensor.detach()
    if src.dim() == 0:
        src = src.reshape(1)
    return _enqueue("allgather", src, name, priority=priority)


class _HorovodAllgather(torch.autograd.Function):
    """Backward: sum-allreduce the full gradient and keep this rank's rows
    at their true offset (each rank's dim 0 is itself gathered)."""

    @staticmethod
    def forward(ctx, tensor, name):
        ctx.dim0 = tensor.shape[0] if tensor.dim() > 0 else 1
        return synchronize(allgather_async(tensor, name))

    @staticmethod
    def backward(ctx, grad_output):
        # The sizes' gather shares a negotiation cycle with the grad's
        # allreduce.
        h_sizes = allgather_async(torch.tensor([ctx.dim0], dtype=torch.int64))
        grad = synchronize(allreduce_async(grad_output, average=False))
        sizes = synchronize(h_sizes)
        offset = int(sizes[:basics.rank()].sum().item())
        return grad.narrow(0, offset, ctx.dim0), None


def allgather(tensor: torch.Tensor, name: Optional[str] = None
              ) -> torch.Tensor:
    """Differentiable allgather, ragged dim 0 included."""
    return _HorovodAllgather.apply(tensor, name)


# ---------------------------------------------------------------------------
# broadcast
# ---------------------------------------------------------------------------

def _check_root(root_rank: int) -> None:
    if root_rank < 0 or root_rank >= basics.size():
        raise ValueError(f"root_rank {root_rank} out of range for size "
                         f"{basics.size()}")


def broadcast_async_(tensor: torch.Tensor, root_rank: int,
                     name: Optional[str] = None) -> int:
    _check_root(root_rank)
    return _enqueue("broadcast", tensor, name, inplace=True,
                    root_rank=root_rank)


def broadcast_async(tensor: torch.Tensor, root_rank: int,
                    name: Optional[str] = None) -> int:
    _check_root(root_rank)
    return _enqueue("broadcast", tensor, name, root_rank=root_rank)


def broadcast_(tensor: torch.Tensor, root_rank: int,
               name: Optional[str] = None) -> torch.Tensor:
    return synchronize(broadcast_async_(tensor, root_rank, name))


class _HorovodBroadcast(torch.autograd.Function):
    """Backward: allreduce the gradients; non-root ranks contribute, then
    zero theirs."""

    @staticmethod
    def forward(ctx, tensor, root_rank, name):
        ctx.root_rank = root_rank
        return synchronize(broadcast_async(tensor, root_rank, name))

    @staticmethod
    def backward(ctx, grad_output):
        grad = synchronize(allreduce_async(grad_output, average=False))
        if basics.rank() != ctx.root_rank:
            grad = grad * 0
        return grad, None, None


def broadcast(tensor: torch.Tensor, root_rank: int,
              name: Optional[str] = None) -> torch.Tensor:
    return _HorovodBroadcast.apply(tensor, root_rank, name)


# ---------------------------------------------------------------------------
# reducescatter / alltoall
# ---------------------------------------------------------------------------

def reducescatter_async(tensor: torch.Tensor, name: Optional[str] = None,
                        *, red_op: str = "sum", average: bool = False,
                        wire_dtype: Optional[str] = None) -> int:
    """Reduce across ranks, keep this rank's dim-0 rows (split as evenly as
    possible, earlier ranks take the remainder)."""
    return _enqueue("reducescatter", tensor, name, average=average,
                    red_op=red_op, wire_dtype=wire_dtype)


class _HorovodReducescatter(torch.autograd.Function):
    """Backward of a sum-reducescatter: allgather of the rows' grads."""

    @staticmethod
    def forward(ctx, tensor, name):
        return synchronize(reducescatter_async(tensor, name))

    @staticmethod
    def backward(ctx, grad_output):
        return synchronize(allgather_async(grad_output)), None


def reducescatter(tensor: torch.Tensor, name: Optional[str] = None
                  ) -> torch.Tensor:
    return _HorovodReducescatter.apply(tensor, name)


def alltoall_async(tensor: torch.Tensor, name: Optional[str] = None, *,
                   splits=None, wire_dtype: Optional[str] = None,
                   priority: Optional[int] = None) -> int:
    """Exchange dim-0 blocks: output block i came from rank i.  With
    ``splits=None`` the blocks are equal; ``splits=[n_0, ..]`` sends
    ``n_d`` rows to rank d."""
    return _enqueue("alltoall", tensor, name, splits=splits,
                    wire_dtype=wire_dtype, priority=priority)


class _HorovodAlltoall(torch.autograd.Function):
    """The adjoint of a block permutation is the inverse permutation:
    another alltoall, routed by this rank's receive counts."""

    @staticmethod
    def forward(ctx, tensor, name, splits, recv_splits):
        ctx.recv_splits = recv_splits
        return synchronize(alltoall_async(tensor, name, splits=splits))

    @staticmethod
    def backward(ctx, grad_output):
        return (synchronize(alltoall_async(grad_output,
                                           splits=ctx.recv_splits)),
                None, None, None)


def alltoall(tensor: torch.Tensor, name: Optional[str] = None, *,
             splits=None, recv_splits=None) -> torch.Tensor:
    """Differentiable alltoall.  With ``splits``, pass ``recv_splits``
    (this rank's per-source receive counts) for the backward."""
    if splits is not None and recv_splits is None:
        raise ValueError(
            "variable-split alltoall needs recv_splits for its backward "
            "(this rank's recv counts: the committed matrix column)")
    return _HorovodAlltoall.apply(tensor, name, splits, recv_splits)
