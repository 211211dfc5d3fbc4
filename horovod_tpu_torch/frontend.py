"""The frontend: the context-dispatching collectives, gradient
reduction, the distributed optimizer, broadcasts and ``make_train_step``.

Counterpart of ``horovod_tpu/jax/__init__.py``, re-exported from
``horovod_tpu_torch`` so that ``import horovod_tpu_torch as hvd`` reads
like ``import horovod_tpu.jax as hvd``.  There is no mesh: the default
process group (``hvd.init()``) is the data axis, and each rank passes its
own shard of the batch.

``allreduce``, ``grouped_allreduce``, ``allgather``, ``broadcast``,
``reducescatter`` and ``alltoall`` dispatch as the reference's do on a
traced value: called while a step of :func:`make_train_step` or
``parallel.api.make_parallel_train_step`` runs the user's loss function,
they are the device plane (``ops/collective_ops.py``), differentiable,
over ``axis_name`` (default: the step's data axes); called anywhere
else, the native engine's eager collectives (``runtime/eager.py``), with
the engine's options (``name=``, ``priority=``, ``splits=``, ...) and
``axis_name`` ignored, as the reference ignores it on concrete values.

The reference's optimizer is an optax transformation inside a jitted
step; here it wraps a ``torch.optim`` optimizer (or
``ops.mixed_precision.MasterWeights``) and reduces the gradients in
place, in fused same-dtype buckets, in the gradients' own dtype (bf16
for a bf16 model: the JAX step reduces before ``master_weights``
upcasts).  Its ``sharded=``, ``fsdp=`` and ``local_sgd_steps=`` rungs
run through the eager engine on the classes of the hook-form frontend,
``torch_frontend.py``, the counterpart of the reference's torch
frontend.  So do ``compression=Compression.topk(r)`` and the wire policy
(``wire_policy=`` or ``HOROVOD_WIRE_POLICY=1``), as the reference's
concrete-gradient host path does: one engine collective per gradient
leaf, named ``"grad" + <leaf path>`` (``grad[i]`` for the i-th of a list,
``grad['a']['w']`` for the parameter named ``a.w``).
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional

import torch
import torch.nn as nn

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.ops import collective_ops as _cops
from horovod_tpu_torch.ops.collective_ops import Average, Sum, allreduce_
from horovod_tpu_torch.ops.compression import Compression, TopKCompressor
from horovod_tpu_torch.ops.fusion import FusionPlan, fuse_apply, plan_fusion
from horovod_tpu_torch.parallel import comm
from horovod_tpu_torch.runtime import eager
from horovod_tpu_torch.runtime import wire_policy as _wp

__all__ = ["allreduce", "grouped_allreduce", "allgather", "broadcast",
           "reducescatter", "alltoall", "allreduce_gradients",
           "DistributedOptimizer", "broadcast_parameters",
           "broadcast_optimizer_state", "make_train_step"]


# ---------------------------------------------------------------------------
# Collectives (context-dispatching wrappers)
# ---------------------------------------------------------------------------

def _step_axis(axis_name):
    """The axis of a device-plane call (``axis_name``, or the step's data
    axes), or None outside a step."""
    step = _cops.step_axis()
    if step is None:
        return None
    return step if axis_name is None else axis_name


def allreduce(tensor, *, axis_name=None, op=Average, average=None,
              compression=Compression.none, name=None, priority=None):
    """Allreduce.  Inside a step: the device plane over ``axis_name``.
    Elsewhere: the engine's eager allreduce (an identity at ``size() ==
    1``); ``priority`` (0 = most urgent) orders responses under
    HOROVOD_PRIORITY_BANDS."""
    axis = _step_axis(axis_name)
    if axis is not None:
        return _cops.allreduce(tensor, axis_name=axis, op=op,
                               average=average, compression=compression)
    return eager.allreduce(tensor, op=op, average=average,
                           compression=compression, name=name,
                           priority=priority)


def grouped_allreduce(tensors, *, axis_name=None, op=Average,
                      compression=Compression.none, name=None, **engine_kw):
    """Allreduce a list of tensors.  Inside a step: one device-plane
    collective per fused bucket.  Elsewhere: the engine's, with its
    options (``average``, ``priorities``, ``wire_dtypes``, ...)."""
    axis = _step_axis(axis_name)
    if axis is not None:
        if engine_kw.get("average") is not None:
            op = Average if engine_kw["average"] else Sum
        return _cops.grouped_allreduce(tensors, axis_name=axis, op=op,
                                       compression=compression)
    return eager.grouped_allreduce(tensors, op=op, compression=compression,
                                   name=name, **engine_kw)


def allgather(tensor, *, axis_name=None, axis=0, name=None):
    """Inside a step: the device plane's tiled allgather along ``axis``.
    Elsewhere: the engine's, along dim 0 (counts may differ)."""
    step = _step_axis(axis_name)
    if step is not None:
        return _cops.allgather(tensor, axis_name=step, axis=axis)
    return eager.allgather(tensor, name=name)


def broadcast(tensor, root_rank=0, *, axis_name=None, name=None):
    axis = _step_axis(axis_name)
    if axis is not None:
        return _cops.broadcast(tensor, root_rank, axis_name=axis)
    return eager.broadcast(tensor, root_rank=root_rank, name=name)


def reducescatter(tensor, *, axis_name=None, op=Sum, average=None,
                  scatter_axis=0, tiled=True, name=None):
    """Inside a step: the device plane's reduce-scatter over
    ``axis_name``.  Elsewhere: the engine's, axis-general (rows split as
    evenly as possible)."""
    axis = _step_axis(axis_name)
    if axis is not None:
        if average is not None:
            op = Average if average else Sum
        return _cops.reducescatter(tensor, axis_name=axis, op=op,
                                   scatter_axis=scatter_axis, tiled=tiled)
    return eager.reducescatter(tensor, op=op, average=average,
                               scatter_axis=scatter_axis, tiled=tiled,
                               name=name)


def alltoall(tensor, *, axis_name=None, split_axis=0, concat_axis=0,
             name=None, splits=None, **engine_kw):
    """All-to-all.  Inside a step: the device plane's, equal blocks.
    Elsewhere: the engine's; ``splits`` (dim 0 only) sends variable row
    counts, which only the engine can."""
    axis = _step_axis(axis_name)
    if axis is not None:
        if splits is not None:
            raise NotImplementedError(
                "variable splits are eager-only (the output shape is "
                "data-dependent; XLA all_to_all exchanges equal blocks)")
        return _cops.alltoall(tensor, axis_name=axis, split_axis=split_axis,
                              concat_axis=concat_axis)
    return eager.alltoall(tensor, split_axis=split_axis,
                          concat_axis=concat_axis, name=name, splits=splits,
                          **engine_kw)



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


def _engine_route(compression, wire_policy):
    """The wire policy in force (explicit, or the env's), and whether the
    reduction goes through the eager engine leaf by leaf."""
    if wire_policy is None and _wp.policy_enabled():
        wire_policy = _wp.default_policy()
    return wire_policy, (isinstance(compression, TopKCompressor)
                         or wire_policy is not None)


def _engine_reduce_(grads: List[torch.Tensor], names: List[str], op,
                    compression, wire_policy) -> None:
    """The reference's concrete-leaf host path, in place: top-k leaf by
    leaf (per-leaf residuals keyed by ``names``), or one grouped allreduce
    with priorities in registration order and the policy's advisory wire
    per leaf."""
    if isinstance(compression, TopKCompressor):
        outs = [eager.allreduce(g, op=op, compression=compression, name=n)
                for g, n in zip(grads, names)]
    else:
        wires = (None if wire_policy is None
                 else wire_policy.observe_and_choose_many(names, grads))
        outs = eager.grouped_allreduce(
            grads, op=op, compression=compression, name="grad",
            priorities=list(range(len(grads))), wire_dtypes=wires,
            wire_advisory=True)
    with torch.no_grad():
        for g, out in zip(grads, outs):
            g.copy_(out)


def _leaf_path(name: str) -> str:
    """``grad`` + the JAX tree path of the parameter named ``name``."""
    return "grad" + "".join(f"['{part}']" for part in name.split("."))


def allreduce_gradients(params_or_grads, *, op=Average,
                        compression=Compression.none,
                        fusion_threshold_bytes: Optional[int] = None,
                        wire_policy: Optional[_wp.WirePolicy] = None
                        ) -> List[torch.Tensor]:
    """Reduce gradients across ranks, IN PLACE: the ``.grad`` of each
    parameter given (or each tensor given).  By default over the default
    group, in fused same-dtype buckets of at most
    ``fusion_threshold_bytes`` (default ``HOROVOD_FUSION_THRESHOLD``), one
    collective per bucket.  With ``Compression.topk(r)`` or a wire policy
    (``wire_policy``, or ``HOROVOD_WIRE_POLICY=1``), through the eager
    engine, the i-th gradient named ``grad[i]``.  Returns the reduced
    gradients."""
    grads = _grads_of(params_or_grads)
    wire_policy, engine = _engine_route(compression, wire_policy)
    if engine:
        _engine_reduce_(grads, [f"grad[{i}]" for i in range(len(grads))],
                        op, compression, wire_policy)
        return grads
    _reduce_(grads, op, compression,
             plan_fusion(grads, fusion_threshold_bytes))
    return grads


class DistributedOptimizer:
    """Wrap a ``torch.optim`` optimizer (or ``MasterWeights``) so that
    ``step()`` averages the gradients across the default group, then
    steps the inner optimizer.  ``reduce_gradients=False`` keeps only the
    step.  ``last_plan`` is the fusion plan of the last reduction.

    The reference's other rungs run through the eager engine, on the same
    classes as the hook-form frontend (``torch_frontend.py``):

    * ``sharded=True`` (default ``HOROVOD_SHARDED``): ZeRO-1, the inner
      optimizer wrapped in ``torch_frontend._ShardedOptimizer``;
    * ``fsdp=True`` (default ``HOROVOD_FSDP``): FSDP units, wrapped in
      ``torch_frontend._FsdpOptimizer``.  The units are the top-level
      names of ``named_parameters`` (the part before the first ``.``),
      sorted as the reference's param-tree keys, or ``fsdp_units=[[name
      prefixes], ...]`` (each top-level name exactly once); without
      ``named_parameters``, one unit per param group.  Gathers prefetch
      ``fsdp_prefetch`` units (default ``HOROVOD_FSDP_PREFETCH``);
    * ``local_sgd_steps=H`` (default ``HOROVOD_LOCAL_SGD_STEPS``): no
      per-step reduction; ``elastic.LocalSGD`` syncs the model every ``H``
      steps after the inner step.

    They keep the JAX frontend's refusals: fsdp with sharded, either with
    local SGD or with ``reduce_gradients=False``, and any op but Sum or
    Average.  With none of them, gradients go over ``torch.distributed``
    as before, unless ``compression=Compression.topk(r)`` or the wire
    policy (``HOROVOD_WIRE_POLICY=1``) sends them through the engine, as
    :func:`allreduce_gradients` does, named by ``named_parameters`` where
    given.
    """

    def __init__(self, optimizer, *, op=Average,
                 compression=Compression.none,
                 fusion_threshold_bytes: Optional[int] = None,
                 reduce_gradients: bool = True, sharded=None, fsdp=None,
                 fsdp_units=None, fsdp_prefetch=None, local_sgd_steps=None,
                 named_parameters=None):
        from horovod_tpu_torch.elastic.state import (LocalSGD,
                                                     default_local_sgd_steps)
        from horovod_tpu_torch.runtime.fsdp import fsdp_default
        from horovod_tpu_torch.runtime.sharded import sharded_default

        self.inner = optimizer
        self._op = op
        self._compression = compression
        self._threshold = fusion_threshold_bytes
        self._reduce = reduce_gradients
        self.last_plan: Optional[FusionPlan] = None
        self._local_sgd_steps = (default_local_sgd_steps()
                                 if local_sgd_steps is None
                                 else max(1, int(local_sgd_steps)))
        sharded = sharded_default() if sharded is None else bool(sharded)
        fsdp = fsdp_default() if fsdp is None else bool(fsdp)
        if fsdp and sharded:
            raise ValueError(
                "fsdp=True and sharded=True are mutually exclusive: "
                "FSDP subsumes the ZeRO-1 step (pick one rung of the "
                "ladder; see docs/zero.md)")
        if (sharded or fsdp) and self._local_sgd_steps > 1:
            raise ValueError(
                "sharded/fsdp and local_sgd_steps>1 are mutually "
                "exclusive: local SGD skips the per-step reduction the "
                "sharded step is built around")
        if (sharded or fsdp) and not reduce_gradients:
            raise ValueError(
                "sharded/fsdp requires reduce_gradients=True: the ZeRO "
                "step IS the reduction (reducescatter -> shard update "
                "-> allgather); without it the shard-sized state cannot "
                "apply and ranks would silently diverge")
        if (sharded or fsdp) and op not in (Average, Sum):
            raise ValueError(
                "sharded/fsdp reduces gradients with SUM/AVERAGE only")
        self._named = (None if named_parameters is None
                       else list(named_parameters))
        #: ``fsdp=True``: a parallel step that takes this wrapper
        #: (``parallel/pipeline.py``) shards the optimizer state over its
        #: mesh's ``fsdp`` axis, as the reference's reads ``_fsdp``.
        self._fsdp = fsdp
        self._zero = None
        #: Builds the FSDP rung at its first use (:attr:`zero`), so a
        #: parallel step that takes the inner optimizer never pays for
        #: its plane (:meth:`release_inner` drops it unbuilt).
        self._make_zero = None
        if sharded:
            from horovod_tpu_torch.torch_frontend import _ShardedOptimizer
            self._zero = _ShardedOptimizer(optimizer, compression,
                                           average=op is Average)
        elif fsdp:
            from horovod_tpu_torch.torch_frontend import (
                _FsdpOptimizer, _refuse_master_weights, _refuse_topk_scatter)
            _refuse_master_weights("fsdp=True", optimizer)
            _refuse_topk_scatter("fsdp=True", compression)
            regrouped = _regroup(optimizer, _fsdp_units(
                optimizer, self._named, fsdp_units))
            self._make_zero = lambda: _FsdpOptimizer(
                regrouped, compression, fsdp_prefetch, average=op is Average)
        #: The periodic-sync policy (None when H <= 1).
        self.local_sgd = (LocalSGD(self._local_sgd_steps,
                                   compression=compression)
                          if self._local_sgd_steps > 1 else None)

    @property
    def zero(self):
        """The sharded rung (ZeRO-1 or FSDP) that steps, or None; the FSDP
        rung is built here at its first use."""
        if self._make_zero is not None:
            self._zero, self._make_zero = self._make_zero(), None
        return self._zero

    @property
    def state(self):
        return (self.zero or self.inner).state

    def release_inner(self):
        """The inner optimizer, for a parallel step that reduces the
        gradients and steps it itself.  An FSDP rung not yet built never
        is; one already used holds the state, so it is refused."""
        if self._fsdp and self._zero is not None:
            raise ValueError(
                "a parallel step takes the inner optimizer of "
                "DistributedOptimizer(fsdp=True), whose FSDP rung has been "
                "used already and holds the state; pass the wrapper to the "
                "parallel step before any eager step")
        self._make_zero = None
        return self.inner

    def grad_params(self) -> List[nn.Parameter]:
        """The parameters whose ``.grad`` the backward fills."""
        params = getattr(self.inner, "model_params", None)
        if params is None:
            params = [p for g in self.inner.param_groups
                      for p in g["params"]]
        return params

    def zero_grad(self, set_to_none: bool = True) -> None:
        (self.zero or self.inner).zero_grad(set_to_none=set_to_none)

    def synchronize(self) -> None:
        """Reduce the gradients now (``step`` calls it)."""
        policy, engine = _engine_route(self._compression, None)
        if engine:
            names = ({id(p): _leaf_path(n) for n, p in self._named}
                     if self._named is not None else {})
            params = [p for p in self.grad_params() if p.grad is not None]
            _engine_reduce_([p.grad for p in params],
                            [names.get(id(p), f"grad[{i}]")
                             for i, p in enumerate(params)],
                            self._op, self._compression, policy)
            return
        grads = _grads_of(self.grad_params())
        self.last_plan = plan_fusion(grads, self._threshold)
        _reduce_(grads, self._op, self._compression, self.last_plan)

    def _named_params(self):
        names = ({id(p): n for n, p in self._named}
                 if self._named is not None else {})
        params = self.grad_params()
        named = [(names.get(id(p), f"localsgd.p{i}"), p)
                 for i, p in enumerate(params)]
        masters = getattr(self.inner, "masters", None)
        if masters is not None:
            named = [(n, m) for (n, _), m in zip(named, masters)]
        return named

    def step(self) -> None:
        if self.zero is not None:
            self.zero.step()
            return
        if self.local_sgd is not None:
            from horovod_tpu_torch.torch_frontend import local_sgd_step
            local_sgd_step(self.local_sgd, self._named_params(),
                           self.inner.step,
                           getattr(self.inner, "rederive", None))
            return
        if self._reduce:
            self.synchronize()
        self.inner.step()


def _fsdp_units(optimizer, named, fsdp_units) -> List[List[nn.Parameter]]:
    """FSDP unit boundaries, as the reference's ``_fsdp_unit_groups``:
    one unit per top-level name (sorted), or the explicit groups of
    ``fsdp_units``; one per param group without names."""
    if named is None:
        if fsdp_units is not None:
            raise ValueError("fsdp_units grouping needs named_parameters")
        return [list(g["params"]) for g in optimizer.param_groups]
    spans: dict = {}
    for name, p in named:
        spans.setdefault(name.split(".")[0], []).append(p)
    keys = sorted(spans)
    if fsdp_units is None:
        return [spans[k] for k in keys]
    groups, seen = [], set()
    for group in fsdp_units:
        params = []
        for k in group:
            if k not in spans:
                raise ValueError(f"fsdp_units names unknown top-level key "
                                 f"{k!r} (have {keys})")
            if k in seen:
                raise ValueError(f"fsdp_units lists key {k!r} twice")
            seen.add(k)
            params.extend(spans[k])
        if params:
            groups.append(params)
    missing = [k for k in keys if k not in seen]
    if missing:
        raise ValueError(f"fsdp_units must cover every top-level key; "
                         f"missing {missing}")
    return groups


def _regroup(optimizer, units):
    """An optimizer of ``optimizer``'s class with one param group per
    unit, each with the hyperparameters of the group its parameters came
    from (a unit may not span groups)."""
    group_of = {id(p): gi for gi, g in enumerate(optimizer.param_groups)
                for p in g["params"]}
    groups = []
    for unit in units:
        src = {group_of.get(id(p)) for p in unit}
        if len(src) != 1 or None in src:
            raise ValueError("an FSDP unit must take its parameters from "
                             "one param group of the optimizer")
        defaults = {k: v for k, v in
                    optimizer.param_groups[src.pop()].items()
                    if k != "params"}
        groups.append({**defaults, "params": unit})
    return type(optimizer)(groups)


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

    While ``loss_fn`` runs, ``hvd.allreduce`` and the other collectives
    are the device plane over every rank (the reference's traced branch);
    their backward runs in ``loss.backward()``.
    """
    if getattr(model, "placement", None) is not None:
        raise ValueError("make_train_step averages over every rank; a model "
                         "placed over tensor, expert or fsdp axes steps "
                         "with parallel.api.make_parallel_train_step")
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
        with _cops.in_step(comm.world_axis()):
            loss = loss_fn(model, batch)
        loss.backward()
        optimizer.step()
        if buffers:
            with torch.no_grad():
                _reduce_(buffers, Average, Compression.none, plan)
        return allreduce_(loss.detach().float().clone(), Average)

    return step
