"""The training half of the frontend: gradient reduction, the
distributed optimizer, broadcasts and ``make_train_step``.

Counterpart of the training half of ``horovod_tpu/jax/__init__.py``,
re-exported from ``horovod_tpu_torch`` so that ``import
horovod_tpu_torch as hvd`` reads like ``import horovod_tpu.jax as hvd``.
There is no mesh: the default process group (``hvd.init()``) is the data
axis, and each rank passes its own shard of the batch.

The reference's optimizer is an optax transformation inside a jitted
step; here it wraps a ``torch.optim`` optimizer (or
``ops.mixed_precision.MasterWeights``) and reduces the gradients in
place, in fused same-dtype buckets, in the gradients' own dtype (bf16
for a bf16 model: the JAX step reduces before ``master_weights``
upcasts).
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional

import torch
import torch.nn as nn

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.ops.collective_ops import Average, allreduce, allreduce_
from horovod_tpu_torch.ops.compression import Compression
from horovod_tpu_torch.ops.fusion import FusionPlan, fuse_apply, plan_fusion

__all__ = ["allreduce_gradients", "DistributedOptimizer",
           "broadcast_parameters", "broadcast_optimizer_state",
           "make_train_step"]


def _grads_of(items: Iterable) -> List[torch.Tensor]:
    """Gradients to reduce: ``.grad`` of parameters, or the tensors
    themselves."""
    out = []
    for t in items:
        if isinstance(t, nn.Parameter):
            if t.grad is not None:
                out.append(t.grad)
        else:
            out.append(t)
    return out


def _reduce_(grads: List[torch.Tensor], op, compression,
             plan: FusionPlan) -> None:
    def reduce(buf):
        wire, ctx = compression.compress(buf)
        return compression.decompress(allreduce_(wire, op), ctx)

    for g, r in zip(grads, fuse_apply(grads, reduce, plan=plan)):
        if r is not g:
            g.copy_(r)


def allreduce_gradients(params_or_grads, *, op=Average,
                        compression=Compression.none,
                        fusion_threshold_bytes: Optional[int] = None
                        ) -> List[torch.Tensor]:
    """Reduce gradients across the default group, IN PLACE: the ``.grad``
    of each parameter given (or each tensor given), in fused same-dtype
    buckets of at most ``fusion_threshold_bytes`` (default
    ``HOROVOD_FUSION_THRESHOLD``), one collective per bucket.  Returns
    the reduced gradients."""
    grads = _grads_of(params_or_grads)
    _reduce_(grads, op, compression,
             plan_fusion(grads, fusion_threshold_bytes))
    return grads


class DistributedOptimizer:
    """Wrap a ``torch.optim`` optimizer (or ``MasterWeights``) so that
    ``step()`` averages the gradients across the default group, then
    steps the inner optimizer.  ``reduce_gradients=False`` keeps only the
    step.  ``last_plan`` is the fusion plan of the last reduction.

    ``sharded=`` (ZeRO-1), ``fsdp=`` and ``local_sgd_steps > 1`` of the
    reference are not ported yet and raise.
    """

    def __init__(self, optimizer, *, op=Average,
                 compression=Compression.none,
                 fusion_threshold_bytes: Optional[int] = None,
                 reduce_gradients: bool = True, sharded=None, fsdp=None,
                 local_sgd_steps=None):
        for name, value, later in (
                ("sharded", sharded, "ZeRO-1 over the eager engine"),
                ("fsdp", fsdp, "FSDP units over the eager engine")):
            if value:
                raise NotImplementedError(
                    f"DistributedOptimizer({name}=True): {later} is not "
                    "ported yet (ROADMAP.md Queue A)")
        if local_sgd_steps is not None and int(local_sgd_steps) > 1:
            raise NotImplementedError(
                "DistributedOptimizer(local_sgd_steps>1): local SGD is not "
                "ported yet (ROADMAP.md Queue A)")
        self.inner = optimizer
        self._op = op
        self._compression = compression
        self._threshold = fusion_threshold_bytes
        self._reduce = reduce_gradients
        self.last_plan: Optional[FusionPlan] = None

    @property
    def state(self):
        return self.inner.state

    def grad_params(self) -> List[nn.Parameter]:
        """The parameters whose ``.grad`` the backward fills."""
        params = getattr(self.inner, "model_params", None)
        if params is None:
            params = [p for g in self.inner.param_groups
                      for p in g["params"]]
        return params

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.inner.zero_grad(set_to_none=set_to_none)

    def synchronize(self) -> None:
        """Reduce the gradients now (``step`` calls it)."""
        grads = _grads_of(self.grad_params())
        self.last_plan = plan_fusion(grads, self._threshold)
        _reduce_(grads, self._op, self._compression, self.last_plan)

    def step(self) -> None:
        if self._reduce:
            self.synchronize()
        self.inner.step()


def _broadcast_(tensors: List[torch.Tensor], root_rank: int) -> None:
    """Broadcast ``tensors`` in place from ``root_rank``, fused per dtype.
    Tensors off the communication device (an optimizer's CPU step count
    under NCCL) travel through a copy on it."""
    if not tensors:
        return
    dev = basics.device() if basics.is_initialized() else tensors[0].device
    staged = [t.detach().to(dev) for t in tensors]

    def bcast(buf):
        torch.distributed.broadcast(buf, src=root_rank)
        return buf

    with torch.no_grad():
        for t, r in zip(tensors, fuse_apply(staged, bcast)):
            if r is not t:
                t.copy_(r)


def broadcast_parameters(params, root_rank: int = 0):
    """Make every rank's parameters equal root's, in place.  ``params``:
    a module, a state dict, ``named_parameters()`` pairs, or tensors.
    Returns ``params``."""
    if isinstance(params, nn.Module):
        tensors = list(params.state_dict().values())
    elif isinstance(params, dict):
        tensors = list(params.values())
    else:
        tensors = [t[1] if isinstance(t, tuple) else t for t in params]
    _broadcast_([t for t in tensors if isinstance(t, torch.Tensor)],
                root_rank)
    return params


def broadcast_optimizer_state(optimizer, root_rank: int = 0):
    """Make every rank's optimizer state equal root's, in place: every
    tensor of its per-parameter state and, for ``MasterWeights`` (inside
    a ``DistributedOptimizer`` or not), the fp32 masters, from which the
    model's parameters are then re-derived.  State not created yet (a
    ``torch.optim`` optimizer before its first step) has nothing to
    send."""
    inner = optimizer.inner if isinstance(optimizer, DistributedOptimizer) \
        else optimizer
    tensors = []
    masters = getattr(inner, "masters", None)
    if masters is not None:
        tensors.extend(masters)
    for param_state in inner.state.values():
        tensors.extend(v for v in param_state.values()
                       if isinstance(v, torch.Tensor))
    _broadcast_(tensors, root_rank)
    if masters is not None:
        with torch.no_grad():
            for p, m in zip(inner.model_params, masters):
                if m is not p:
                    p.copy_(m)
    return optimizer


def make_train_step(model: nn.Module, loss_fn: Callable, optimizer
                    ) -> Callable:
    """``step(batch) -> loss``: zero-grad, ``loss_fn(model, batch)``,
    backward, ``optimizer.step()`` (gradients averaged across ranks), and
    the loss averaged across ranks (a 0-dim fp32 tensor).

    Each rank passes its own shard of the global batch.  ``optimizer``
    may be a plain optimizer (it is wrapped in :class:`DistributedOptimizer`).
    The step runs on the device ``hvd.init()`` bound (the card, unless it
    was given ``device="cpu"``), so it raises before ``hvd.init()``; the
    model must be there already.

    The model's floating-point buffers (BatchNorm's running statistics),
    where it has any, are averaged across ranks after each step, in
    place, in fused same-dtype buckets — the reference's ``has_aux`` step,
    which averages its non-differentiated ``aux_state`` over the data
    axes.  Integer buffers are left alone.
    """
    dev = basics.device()
    on = {p.device.type for p in model.parameters()}
    if on != {dev.type}:
        raise ValueError(f"make_train_step runs on {dev}, but the model's "
                         f"parameters are on {sorted(on)}")
    if not isinstance(optimizer, DistributedOptimizer):
        optimizer = DistributedOptimizer(optimizer)
    buffers = [b for b in model.buffers() if b.is_floating_point()]
    plan = plan_fusion(buffers) if buffers else None

    def step(batch) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch)
        loss.backward()
        optimizer.step()
        if buffers:
            with torch.no_grad():
                _reduce_(buffers, Average, Compression.none, plan)
        return allreduce(loss.detach().float(), op=Average)

    return step
