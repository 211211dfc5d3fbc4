"""The hook-driven torch frontend: ``DistributedOptimizer``'s four rungs
and the engine-driven broadcasts.

Counterpart of ``horovod_tpu/torch/__init__.py`` (the reference's torch
frontend), exported as ``hvd.torch_frontend``.  The port has two
frontends, and this is the second:

* ``hvd.DistributedOptimizer`` (``frontend.py``) has the JAX frontend's
  form: it reduces the gradients in ``step()``, over
  ``torch.distributed``;
* ``torch_frontend.DistributedOptimizer`` has the reference torch
  frontend's form: a hook on each parameter's gradient enqueues that
  gradient's allreduce through the eager engine while the backward is
  still running, and ``step()`` waits for them.

The factory returns one of four rungs, as the reference's does:

* the hook mixin (a subclass of the user's optimizer class, so
  ``isinstance`` holds and checkpoints load), with ``named_parameters``
  as rendezvous names, priorities from registration order,
  ``backward_passes_per_step``, sparse gradients as allgathers (or dense
  with ``sparse_as_dense``), the force-allreduce contract and its layout
  probe, top-k sparse reductions with error feedback
  (``compression=Compression.topk(r)``, ``runtime/sparse.py``) and the
  statistics-driven wire policy (``HOROVOD_WIRE_POLICY=1``,
  ``runtime/wire_policy.py``);
* ``local_sgd_steps=H``: the same mixin, stepping locally and syncing the
  model every ``H`` steps (``elastic.LocalSGD``);
* ``sharded=True``: :class:`_ShardedOptimizer`, ZeRO-1 over
  ``runtime/sharded.py``;
* ``fsdp=True``: :class:`_FsdpOptimizer`, one FSDP unit per param group
  over ``runtime/fsdp.py``.

The JAX-form ``frontend.DistributedOptimizer`` reaches the last three
through the same classes.  Everything stays on the parameters' device:
flat fp32 vectors, master shards and inner-optimizer state live there,
and the engine stages CUDA tensors through pinned memory behind their
ready event (``runtime/staging.py``); no gradient or parameter goes
through numpy.  The reference goes through numpy because its torch ran on
the host.

Mixed precision: the hook mixin takes a ``torch.optim.Optimizer`` or the
port's ``ops.mixed_precision.MasterWeights`` (the hooks sit on its
``model_params``, bf16 gradients are reduced in bf16, and
``MasterWeights.step()`` upcasts them).  The sharded and FSDP rungs keep
the reference's own scheme: a bf16 model, fp32 master shards and an fp32
reduction.

Top-k gradients wait for ``synchronize()``, which reduces them one by one
in name order (each is two blocking allgathers, and the hooks' order may
differ across ranks); a bf16 gradient is reduced in fp32 and written back
in bf16 (the reference's hook form calls ``.numpy()`` on it and fails:
ROADMAP.md Queue C).  Under the wire policy, a leaf whose wire depends on
its statistics also waits for ``synchronize()``: the statistics of all
such leaves are read back with one copy, then each is enqueued with its
advisory wire.  Every other leaf is enqueued from its hook.
"""

from __future__ import annotations

import collections
import weakref

import torch

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.ops.compression import Compression
from horovod_tpu_torch.ops.mixed_precision import MasterWeights
from horovod_tpu_torch.runtime.mpi_ops import (_probe_allreduce_async_,
                                               allgather_async,
                                               allreduce_async_,
                                               broadcast_async_, synchronize)

__all__ = ["DistributedOptimizer", "broadcast_parameters",
           "broadcast_optimizer_state"]

#: Engine wire formats the sharded rungs hand to the reducescatter.
_RS_WIRES = ("fp16", "bf16", "int8", "fp8")


def _is_topk(compression) -> bool:
    return type(compression).__name__ == "TopKCompressor"


def _rs_wire(compression):
    wire = getattr(compression, "engine_wire_dtype", None)
    return wire if wire in _RS_WIRES else None


def _refuse_topk_scatter(which: str, compression) -> None:
    if _is_topk(compression):
        raise ValueError(
            f"{which} reduces gradients with reducescatter; the top-k "
            "sparse path has no scatter half — use a wire compressor "
            "(Compression.wire_bf16 etc.) instead")


def local_sgd_step(policy, named, inner_step, rederive=None):
    """One local-SGD step of ``named`` (``[(name, tensor)]``): anchor the
    cadence with the pre-step model, take the local ``inner_step()``, then
    ``policy.maybe_sync``; on a sync, copy the outer model back in place
    and call ``rederive()`` (MasterWeights: the model from its masters).
    Returns what ``inner_step`` returned."""
    if not policy._anchored:
        policy.begin({n: p.detach() for n, p in named})
    out = inner_step()
    tree = {n: p.detach() for n, p in named}
    synced = policy.maybe_sync(tree)
    if synced is not tree:
        with torch.no_grad():
            for n, p in named:
                p.copy_(synced[n])
        if rederive is not None:
            rederive()
    return out


class _DistributedOptimizer(torch.optim.Optimizer):
    """The hook mixin, combined at run time with the user's optimizer
    class (or ``MasterWeights``), as the reference's (torch/__init__.py
    :72-420)."""

    def __init__(self, params, named_parameters=None,
                 compression=Compression.none, backward_passes_per_step=1,
                 sparse_as_dense=False, local_sgd_steps=None):
        super(self.__class__, self).__init__(params)
        self._hvd_setup(named_parameters, compression,
                        backward_passes_per_step, sparse_as_dense,
                        local_sgd_steps)

    def _hvd_setup(self, named_parameters, compression,
                   backward_passes_per_step, sparse_as_dense,
                   local_sgd_steps):
        from horovod_tpu_torch.elastic.state import (LocalSGD,
                                                     default_local_sgd_steps)
        from horovod_tpu_torch.runtime import wire_policy

        self._compression = compression
        self._bpps = backward_passes_per_step
        self._sparse_as_dense = sparse_as_dense
        # H <= 1 keeps the per-step gradient allreduce.
        self._local_sgd_steps = (default_local_sgd_steps()
                                 if local_sgd_steps is None
                                 else max(1, int(local_sgd_steps)))
        # With top-k, LocalSGD ships the model's delta sparsely.
        self._local_sgd = (LocalSGD(self._local_sgd_steps,
                                    compression=compression)
                           if self._local_sgd_steps > 1 else None)
        # HOROVOD_WIRE_POLICY=1: int8 for large smooth fp32 gradients, fp32
        # for norm and bias leaves, stamped advisory.
        self._wire_policy = (wire_policy.default_policy()
                             if wire_policy.policy_enabled() else None)
        if named_parameters is not None:
            named_parameters = list(named_parameters)
        else:
            # One running counter across param groups: per-group
            # numbering would give two groups the same name.
            named_parameters = [
                (f"allreduce.noname.{i}", v)
                for i, v in enumerate(
                    v for param_group in self.param_groups
                    for v in param_group["params"])]
        all_params = {id(v) for group in self.param_groups
                      for v in group["params"]}
        named_ids = {id(v) for _, v in named_parameters}
        if len(named_parameters) != len(named_ids):
            raise ValueError("named_parameters contains duplicate parameters")
        unnamed = all_params - named_ids
        if unnamed and len(named_parameters) > 0 and named_ids != all_params:
            raise ValueError(
                f"named_parameters covers {len(named_ids)} parameters but "
                f"the optimizer has {len(all_params)}; provide names for "
                "all")
        self._param_names = {id(v): k for k, v in named_parameters}
        # Registration order is the scheduling priority (0 = front layer,
        # needed first by the next forward).
        self._param_priority = {id(v): i for i, (_k, v)
                                in enumerate(named_parameters)}
        self._handles: dict = {}
        self._grad_accs = []
        # id(param) -> sparse_dim of params that produced a sparse
        # gradient: the force-allreduce keeps them on the sparse gathers.
        self._sparse_params: dict = {}
        self._passes_left = collections.defaultdict(lambda: self._bpps)
        self._register_hooks()

    # -- the hook pipeline --

    def _register_hooks(self):
        for group in self.param_groups:
            for p in group["params"]:
                if p.requires_grad:
                    self._grad_accs.append(
                        p.register_post_accumulate_grad_hook(
                            self._make_hook()))

    def _make_hook(self):
        # Weakly: a tensor's hooks are invisible to Python's cycle
        # collector, so a hook holding its optimizer would keep the
        # optimizer, its state and every parameter alive after the caller
        # dropped them.
        owner = weakref.ref(self)

        def hook(p):
            self = owner()
            if self is None or self._local_sgd_steps > 1:
                return          # local phase: step() syncs the model
            self._passes_left[id(p)] -= 1
            if self._passes_left[id(p)] == 0:
                self._handles[p] = self._allreduce_grad_async(p)
                self._passes_left[id(p)] = self._bpps
        return hook

    def _allreduce_grad_async(self, p):
        name = self._param_names.get(id(p))
        if p.grad.is_sparse:
            if not self._sparse_as_dense:
                self._sparse_params[id(p)] = p.grad.sparse_dim()
                return self._sparse_allgather_async(p, name)
            p.grad = p.grad.to_dense()
        if _is_topk(self._compression) and p.grad.is_floating_point():
            # Reduced in synchronize(), in name order.
            return ("topk", p)
        # Engine-wire compression (Compression.wire_*): the tensor stays
        # as it is; the engine quantizes on the ring.
        wire = getattr(self._compression, "engine_wire_dtype", None)
        advisory = False
        policy = self._wire_policy
        if policy is not None and name is not None and \
                p.grad.is_floating_point():
            if policy.needs_statistics(p.grad):
                return ("policy", p)    # decided in synchronize()
            chosen = policy.observe_and_choose(name, p.grad)
            if chosen is not None:
                wire, advisory = chosen, True
        return self._enqueue_grad(p, name, wire, advisory)

    def _enqueue_grad(self, p, name, wire, advisory):
        tensor_compressed, ctx = self._compression.compress(p.grad.data)
        priority = self._param_priority.get(id(p))
        if tensor_compressed.data_ptr() != p.grad.data.data_ptr():
            tensor_compressed = tensor_compressed.contiguous()
        # Uncompressed: the reduction lands in .grad itself.
        handle = allreduce_async_(tensor_compressed, average=True,
                                  name=name, wire_dtype=wire,
                                  priority=priority, wire_advisory=advisory)
        return handle, tensor_compressed, ctx

    def _enqueue_policy_leaves(self):
        """The wire policy's deferred leaves: their statistics read back
        with one copy, then each enqueued with its decision (advisory)."""
        deferred = [p for p, e in self._handles.items() if e[0] == "policy"]
        if not deferred:
            return
        names = [self._param_names[id(p)] for p in deferred]
        wires = self._wire_policy.observe_and_choose_many(
            names, [p.grad for p in deferred])
        default = getattr(self._compression, "engine_wire_dtype", None)
        for p, name, wire in zip(deferred, names, wires):
            self._handles[p] = self._enqueue_grad(
                p, name, default if wire is None else wire, wire is not None)

    def _reduce_topk(self, params):
        """One top-k sparse allreduce per parameter, in name order, each
        written back into ``.grad`` in its dtype."""
        from horovod_tpu_torch.runtime.sparse import sparse_allreduce_topk

        def topk_name(p):
            name = self._param_names.get(id(p))
            if not name:
                # An id-derived name would differ across ranks, and the
                # allgathers would never meet.
                raise ValueError(
                    "top-k compression requires every parameter to have a "
                    "cross-rank-stable name (pass named_parameters=...)")
            return name

        for p in sorted(params, key=topk_name):
            out = sparse_allreduce_topk(
                p.grad, name=topk_name(p), ratio=self._compression.ratio,
                error_feedback=self._compression.error_feedback,
                average=True)
            p.grad.copy_(out)

    def _sparse_allgather_async(self, p, name):
        """Sparse aggregation: allgather of the indices and of the values,
        summed by index on apply (``_finish_sparse``)."""
        g = p.grad.coalesce()
        idx = g.indices().t().contiguous()   # nnz x sparse_dim, int64
        vals = g.values().contiguous()       # nnz x dense dims
        h_idx = allgather_async(idx, name=f"{name}.idx" if name else None)
        h_val = allgather_async(vals, name=f"{name}.vals" if name else None)
        return ("sparse", h_idx, h_val)

    def _zero_sparse_grad(self, p, sd):
        return torch.sparse_coo_tensor(
            torch.zeros((sd, 0), dtype=torch.int64, device=p.device),
            p.data.new_zeros((0,) + p.shape[sd:]), size=p.shape)

    def _finish_sparse(self, p, h_idx, h_val):
        idx_all = synchronize(h_idx)
        val_all = synchronize(h_val)
        # coalesce() sums duplicate indices across ranks; the divide gives
        # the dense path's average.
        p.grad = torch.sparse_coo_tensor(
            idx_all.t(), val_all / basics.size(), size=p.shape,
            dtype=val_all.dtype).coalesce()

    def synchronize(self):
        """Finish every gradient reduction into ``.grad``.  Parameters
        whose hook never fired are reduced too (zeros), so ranks cannot
        deadlock: a parameter that ever produced a sparse gradient joins
        the sparse gathers with zero entries; one of unknown layout goes
        out as a layout probe, which completes as a dense allreduce unless
        peers gather it sparsely, and then joins their gathers.  Every
        handle is drained before the first ``StepSkipped`` re-raises."""
        from horovod_tpu_torch.runtime.engine import (SparseGradRetry,
                                                      StepSkipped)

        topk_mode = _is_topk(self._compression)
        for group in self.param_groups:
            for p in group["params"]:
                if p.requires_grad and p not in self._handles:
                    if p.grad is None:
                        sd = self._sparse_params.get(id(p))
                        if sd is not None:
                            p.grad = self._zero_sparse_grad(p, sd)
                        else:
                            p.grad = p.data.new_zeros(p.shape)
                            # No probe under top-k: peers' '.topk_idx' and
                            # '.topk_val' gathers could not meet it; the
                            # zero gradient ships top-k of its residual.
                            if not self._sparse_as_dense and not topk_mode:
                                self._handles[p] = self._probe_grad_async(p)
                                continue
                    self._handles[p] = self._allreduce_grad_async(p)
        self._enqueue_policy_leaves()
        first_skip = None
        topk_params = []
        for p, entry in self._handles.items():
            if entry[0] == "topk":
                topk_params.append(p)
            elif entry[0] == "sparse":
                _, h_idx, h_val = entry
                self._finish_sparse(p, h_idx, h_val)
            elif entry[0] == "probe":
                _, handle, tensor_compressed, ctx = entry
                try:
                    self._write_grad(p, synchronize(handle), ctx)
                except SparseGradRetry as retry:
                    self._sparse_params[id(p)] = retry.sparse_dim
                    p.grad = self._zero_sparse_grad(p, retry.sparse_dim)
                    _, h_idx, h_val = self._sparse_allgather_async(
                        p, self._param_names.get(id(p)))
                    self._finish_sparse(p, h_idx, h_val)
                except StepSkipped as skip:
                    first_skip = first_skip or skip
            else:
                handle, tensor_compressed, ctx = entry
                try:
                    output = synchronize(handle)
                except StepSkipped as skip:
                    first_skip = first_skip or skip
                    continue        # .grad keeps the local gradient
                self._write_grad(p, output, ctx)
        if topk_params:
            self._reduce_topk(topk_params)
        self._handles.clear()
        if first_skip is not None:
            raise first_skip

    def _write_grad(self, p, output, ctx):
        """The reduced gradient into ``.grad``.  Uncompressed, the
        reduction already landed there; a compressed one is decompressed
        and copied in.  (The reference's ``p.grad.data.set_(...)`` rebinds
        an alias of ``.grad``, so its compressed reductions never reach
        ``.grad``: ROADMAP.md Queue C.)"""
        out = self._compression.decompress(output, ctx)
        if out.data_ptr() != p.grad.data_ptr():
            p.grad.copy_(out)

    def _probe_grad_async(self, p):
        """Layout probe for a param with no gradient and no recorded
        layout: the dense path's name and compression, flagged on the
        wire so a sparse/dense conflict resolves instead of stalling."""
        name = self._param_names.get(id(p))
        tensor_compressed, ctx = self._compression.compress(p.grad.data)
        handle = _probe_allreduce_async_(tensor_compressed.contiguous(),
                                         name)
        return ("probe", handle, tensor_compressed, ctx)

    def _named_params(self):
        """``[(name, tensor)]`` the local-SGD policy syncs: the
        parameters, or MasterWeights' fp32 masters in their place."""
        named = []
        for group in self.param_groups:
            for p in group["params"]:
                name = self._param_names.get(id(p))
                named.append((name or f"localsgd.p{len(named)}", p))
        masters = getattr(self, "masters", None)
        if masters is not None:
            named = [(n, m) for (n, _), m in zip(named, masters)]
        return named

    def step(self, closure=None):
        inner = super(self.__class__, self).step
        if self._local_sgd_steps > 1:
            rederive = getattr(self, "rederive", None)
            return local_sgd_step(self._local_sgd, self._named_params(),
                                  lambda: inner(closure), rederive)
        self.synchronize()
        return inner(closure)


class _ShardedOptimizer:
    """ZeRO-1 (``DistributedOptimizer(sharded=True)``), per param group:
    a flat fp32 master shard on the parameters' device, ONE inner
    optimizer of the user's class over all shards, and

        reducescatter(flat fp32 grads) -> inner step() -> allgather

    then the gathered masters are cast into the parameters.  A bf16 model
    keeps fp32 master shards and an fp32 reduction.  For an fp32 model
    with an elementwise inner optimizer the step is bit-identical to the
    unsharded flat step.  Build LR schedulers on :attr:`shard_optimizer`;
    ``param_groups`` is its groups."""

    def __init__(self, optimizer, compression=Compression.none, *,
                 average: bool = True):
        from horovod_tpu_torch.runtime.sharded import FlatSharder

        _refuse_master_weights("sharded=True", optimizer)
        _refuse_topk_scatter("sharded=True", compression)
        self._wire = _rs_wire(compression)
        self._average = average
        self._groups = []
        shard_groups = []
        for gi, group in enumerate(optimizer.param_groups):
            params = list(group["params"])
            numels = [p.numel() for p in params]
            sharder = FlatSharder(sum(numels), torch.float32,
                                  name=f"zero.torch.g{gi}")
            # The fp32 master shard: the only full-precision copy of this
            # slice in the world.
            with torch.no_grad():
                master = FlatSharder.slice_flat(
                    params, sharder.offset, sharder.count,
                    torch.float32).clone()
            self._groups.append({"params": params,
                                 "shapes": [tuple(p.shape) for p in params],
                                 "numels": numels, "sharder": sharder,
                                 "master": master})
            defaults = {k: v for k, v in group.items() if k != "params"}
            shard_groups.append({**defaults, "params": [master]})
        # One inner optimizer over every group's shard: group
        # hyperparameters ride through, one .step() covers the model.
        self._shard_opt = type(optimizer)(shard_groups)
        self.param_groups = self._shard_opt.param_groups

    @property
    def sharder(self):
        """Group 0's partitioner (``sharders`` has every group's)."""
        return self._groups[0]["sharder"] if self._groups else None

    @property
    def sharders(self):
        return [g["sharder"] for g in self._groups]

    @property
    def shard_optimizer(self):
        """The inner ``torch.optim.Optimizer`` over the fp32 master
        shards: the handle to give LR schedulers."""
        return self._shard_opt

    @property
    def state(self):
        return self._shard_opt.state

    def state_bytes(self) -> int:
        """Bytes of this rank's master shards and optimizer state."""
        total = sum(g["master"].numel() * g["master"].element_size()
                    for g in self._groups)
        return total + _tensor_state_bytes(self._shard_opt)

    def zero_grad(self, set_to_none: bool = True):
        _zero_grads([p for g in self._groups for p in g["params"]],
                    set_to_none)

    def step(self, closure=None):
        from horovod_tpu_torch.runtime.engine import note_sharded_step

        loss = closure() if closure is not None else None
        # Phase 1: every group's reduction lands on its master's .grad
        # before one inner step covers every group.
        for g in self._groups:
            flat_g = _flat_grads(g["params"])
            g["master"].grad = g["sharder"].reduce_grads(
                flat_g, average=self._average, wire_dtype=self._wire)
        self._shard_opt.step()
        # Phase 2: ship each group's updated master shard (lossless) and
        # copy it into the parameters.
        for g in self._groups:
            g["master"].grad = None
            full = g["sharder"].gather_updates(g["master"].detach())
            _copy_flat_into(full, g["params"], g["shapes"])
        note_sharded_step()
        return loss

    def state_dict(self):
        """Shard-local state (each rank saves its own shards), with each
        group's geometry, so a reload at another world size fails."""
        return {
            "shard_opt": self._shard_opt.state_dict(),
            "groups": [{"master": g["master"].detach().cpu(),
                        "shard": _shard_meta(g["sharder"])}
                       for g in self._groups]}

    def load_state_dict(self, sd):
        from horovod_tpu_torch.runtime.sharded import ShardResizeError

        # The single-group format of the reference's first sharded
        # optimizer carried a top-level master/shard.
        groups_sd = sd.get("groups")
        if groups_sd is None and "master" in sd:
            groups_sd = [{"master": sd["master"],
                          "shard": sd.get("shard", {})}]
        if groups_sd is None or len(groups_sd) != len(self._groups):
            raise ShardResizeError(
                "sharded checkpoint holds "
                f"{0 if groups_sd is None else len(groups_sd)} param "
                f"group(s) but this optimizer has {len(self._groups)}; "
                "the group layout must match the checkpoint's "
                "(docs/zero.md)")
        for gi, (g, gsd) in enumerate(zip(self._groups, groups_sd)):
            meta, sh = gsd.get("shard", {}), g["sharder"]
            if _meta_differs(meta, sh):
                raise ShardResizeError(
                    f"sharded checkpoint group {gi} was written for "
                    f"shard {meta.get('offset')}+{meta.get('count')} of "
                    f"{meta.get('n')} at world size {meta.get('size')}, "
                    f"but this optimizer owns {sh.offset}+{sh.count} of "
                    f"{sh.n} at size {sh.size}; restore at the original "
                    "world size or rebuild from a full checkpoint "
                    "(docs/zero.md)")
        self._shard_opt.load_state_dict(sd["shard_opt"])
        with torch.no_grad():
            for g, gsd in zip(self._groups, groups_sd):
                g["master"].copy_(gsd["master"].to(torch.float32))


class _FsdpOptimizer:
    """ZeRO-3/FSDP (``DistributedOptimizer(fsdp=True)``): each param group
    is a unit of an :class:`~horovod_tpu_torch.runtime.fsdp.FsdpPlane`,
    and the backward drives the wire.  Gradient hooks count a unit's
    outstanding leaves; when the last one lands, the unit's fp32 flat
    gradient reducescatters at once (priority band = group index) and the
    unit's ``.grad`` tensors are freed.  ``step()`` reduces units whose
    hooks did not all fire (zeros for the missing leaves), drains the
    reductions onto the fp32 master shards (the masters ARE the plane's
    shards: the inner update writes through), takes one inner step over
    all shards, and ships every unit back through the plane's band-0
    gather pipeline into the parameters.  fp32 models with an elementwise
    inner optimizer step bit-identically to the unsharded anchor."""

    def __init__(self, optimizer, compression=Compression.none,
                 prefetch=None, *, average: bool = True):
        from horovod_tpu_torch.runtime.fsdp import FsdpPlane

        _refuse_master_weights("fsdp=True", optimizer)
        _refuse_topk_scatter("fsdp=True", compression)
        self._groups = []
        for group in optimizer.param_groups:
            params = list(group["params"])
            if not params:
                raise ValueError(
                    "fsdp=True: every param group must be non-empty "
                    "(each group is one FSDP unit)")
            self._groups.append({
                "params": params,
                "shapes": [tuple(p.shape) for p in params],
                "numels": [p.numel() for p in params],
                "defaults": {k: v for k, v in group.items()
                             if k != "params"}})
        #: The parameter plane: unit = param group, shards fp32.
        self.plane = FsdpPlane([g["params"] for g in self._groups],
                               name="torch", prefetch=prefetch,
                               wire_dtype=_rs_wire(compression),
                               average=average)
        shard_groups = []
        for gi, g in enumerate(self._groups):
            # Write-through: the master IS the plane's shard tensor.
            g["master"] = self.plane.shard(gi)
            shard_groups.append({**g["defaults"], "params": [g["master"]]})
        self._shard_opt = type(optimizer)(shard_groups)
        self.param_groups = self._shard_opt.param_groups
        self._pending = [0] * len(self._groups)
        self._enqueued = [False] * len(self._groups)
        self._grad_accs = []
        for gi, g in enumerate(self._groups):
            for p in g["params"]:
                if p.requires_grad:
                    self._pending[gi] += 1
                    self._grad_accs.append(
                        p.register_post_accumulate_grad_hook(
                            self._make_hook(gi)))
        self._hook_total = list(self._pending)

    def _make_hook(self, gi):
        owner = weakref.ref(self)      # as the hook mixin's

        def hook(p):
            self = owner()
            if self is None:
                return
            self._pending[gi] -= 1
            if self._pending[gi] == 0:
                self._reduce_unit(gi)
        return hook

    def _reduce_unit(self, gi):
        g = self._groups[gi]
        grads = []
        for p in g["params"]:
            gr = p.grad
            if gr is None:
                gr = torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device)
            elif gr.is_sparse:
                gr = gr.to_dense()      # the flat RS has no sparse path
            grads.append(gr)
        self.plane.reduce_grads(gi, grads)
        # The gradient is on the wire: free it before the next unit's
        # backward allocates, so gradient memory stays one unit deep.
        for p in g["params"]:
            p.grad = None
        self._enqueued[gi] = True

    @property
    def shard_optimizer(self):
        return self._shard_opt

    @property
    def state(self):
        return self._shard_opt.state

    @property
    def sharders(self):
        return [u.sharder for u in self.plane.units]

    def state_bytes(self) -> int:
        """Bytes of this rank's master shards and optimizer state."""
        return self.plane.shard_bytes + _tensor_state_bytes(self._shard_opt)

    def zero_grad(self, set_to_none: bool = True):
        _zero_grads([p for g in self._groups for p in g["params"]],
                    set_to_none)

    def step(self, closure=None):
        loss = closure() if closure is not None else None
        # Units whose hooks did not all fire: reduce now, zeros for the
        # missing leaves (the schedule must match on every rank).
        for gi in range(len(self._groups)):
            if not self._enqueued[gi]:
                self._reduce_unit(gi)
        try:
            for gi, g in enumerate(self._groups):
                g["master"].grad = self.plane.wait_grads(gi)
        except BaseException:
            self.plane.drain()      # never strand a later unit's handle
            self._reset_step()
            raise
        self._shard_opt.step()
        for g in self._groups:
            g["master"].grad = None
        for gi in range(len(self._groups)):
            self.plane.start_gather(gi, priority=0)
        for gi, g in enumerate(self._groups):
            fulls = self.plane.gather(gi)
            with torch.no_grad():
                for p, full in zip(g["params"], fulls):
                    p.copy_(full)
            self.plane.free(gi)
        self._reset_step()
        self.plane.step()
        return loss

    def _reset_step(self):
        self._pending = list(self._hook_total)
        self._enqueued = [False] * len(self._groups)

    def state_dict(self):
        return {
            "shard_opt": self._shard_opt.state_dict(),
            "groups": [{"master": g["master"].detach().clone().cpu(),
                        "shard": _shard_meta(u.sharder)}
                       for g, u in zip(self._groups, self.plane.units)]}

    def load_state_dict(self, sd):
        from horovod_tpu_torch.runtime.sharded import ShardResizeError

        groups_sd = sd.get("groups")
        if groups_sd is None or len(groups_sd) != len(self._groups):
            raise ShardResizeError(
                "fsdp checkpoint holds "
                f"{0 if groups_sd is None else len(groups_sd)} "
                f"unit(s) but this optimizer has {len(self._groups)}")
        for gi, (u, gsd) in enumerate(zip(self.plane.units, groups_sd)):
            meta, sh = gsd.get("shard", {}), u.sharder
            if _meta_differs(meta, sh):
                raise ShardResizeError(
                    f"fsdp checkpoint unit {gi} was written for shard "
                    f"{meta.get('offset')}+{meta.get('count')} of "
                    f"{meta.get('n')} at world size {meta.get('size')}, "
                    f"but this optimizer owns {sh.offset}+{sh.count} of "
                    f"{sh.n} at size {sh.size}; restore through the "
                    "CheckpointLoader's resharding reader instead "
                    "(docs/zero.md)")
        self._shard_opt.load_state_dict(sd["shard_opt"])
        with torch.no_grad():
            for g, gsd in zip(self._groups, groups_sd):
                g["master"].copy_(gsd["master"].to(torch.float32))


# -- helpers of the sharded rungs --

def _refuse_master_weights(which: str, optimizer) -> None:
    if isinstance(optimizer, MasterWeights):
        raise TypeError(
            f"{which} keeps its own fp32 master shards: pass the "
            "torch.optim optimizer over the model's parameters, not "
            "MasterWeights")


def _flat_grads(params) -> torch.Tensor:
    """The fp32 flat gradient of ``params`` on their device (zeros where
    a parameter has no gradient; sparse gradients densified)."""
    parts = []
    for p in params:
        g = p.grad
        if g is None:
            parts.append(torch.zeros(p.numel(), dtype=torch.float32,
                                     device=p.device))
            continue
        if g.is_sparse:
            g = g.to_dense()        # the flat RS has no sparse path
        parts.append(g.detach().reshape(-1).to(torch.float32))
    if not parts:
        return torch.zeros(0, dtype=torch.float32)
    return torch.cat(parts)


def _copy_flat_into(full, params, shapes) -> None:
    with torch.no_grad():
        off = 0
        for p, shape in zip(params, shapes):
            n = p.numel()
            p.copy_(full[off:off + n].view(shape))
            off += n


def _zero_grads(params, set_to_none: bool) -> None:
    for p in params:
        if set_to_none:
            p.grad = None
        elif p.grad is not None:
            p.grad.detach_()
            p.grad.zero_()


def _tensor_state_bytes(optimizer) -> int:
    return sum(v.numel() * v.element_size()
               for st in optimizer.state.values() for v in st.values()
               if torch.is_tensor(v))


def _shard_meta(sharder) -> dict:
    return {"offset": sharder.offset, "count": sharder.count,
            "n": sharder.n, "size": sharder.size}


def _meta_differs(meta: dict, sh) -> bool:
    return (meta.get("n") != sh.n or meta.get("size") != sh.size
            or meta.get("offset") != sh.offset)


def DistributedOptimizer(optimizer, named_parameters=None,
                         compression=Compression.none,
                         backward_passes_per_step=1, sparse_as_dense=False,
                         local_sgd_steps=None, sharded=None, fsdp=None,
                         fsdp_prefetch=None):
    """Wrap a torch optimizer (or ``MasterWeights``) so gradients are
    averaged across ranks during ``backward()`` (the reference's factory,
    torch/__init__.py:884-966).

    Sparse gradients go as allgathers of indices and values and stay
    sparse in ``.grad``; ``sparse_as_dense=True`` densifies them first.
    ``local_sgd_steps=H`` (default ``HOROVOD_LOCAL_SGD_STEPS``, 1) steps
    locally and syncs the model every ``H`` steps.  ``sharded=True``
    (default ``HOROVOD_SHARDED``) returns the ZeRO-1
    :class:`_ShardedOptimizer`; ``fsdp=True`` (default ``HOROVOD_FSDP``)
    the :class:`_FsdpOptimizer`, whose gathers prefetch ``fsdp_prefetch``
    units (default ``HOROVOD_FSDP_PREFETCH``)."""
    from horovod_tpu_torch.runtime.fsdp import fsdp_default
    from horovod_tpu_torch.runtime.sharded import sharded_default

    if sharded is None:
        sharded = sharded_default()
    if fsdp is None:
        fsdp = fsdp_default()
    if fsdp and sharded:
        raise ValueError(
            "fsdp=True and sharded=True are mutually exclusive: FSDP "
            "subsumes the ZeRO-1 step (pick one rung of the ladder; see "
            "docs/zero.md)")
    if sharded or fsdp:
        from horovod_tpu_torch.elastic.state import default_local_sgd_steps

        which = "fsdp=True" if fsdp else "sharded=True"
        # The env default too: a requested cadence is never dropped.
        resolved_h = (default_local_sgd_steps() if local_sgd_steps is None
                      else max(1, int(local_sgd_steps)))
        if resolved_h > 1:
            raise ValueError(
                f"{which} and local_sgd_steps>1 are mutually exclusive: "
                "local SGD skips the per-step reduction the sharded step "
                "is built around")
        if int(backward_passes_per_step) != 1:
            raise ValueError(
                f"{which} does not support backward_passes_per_step"
                f"={backward_passes_per_step}: the flat reduce-scatter "
                "fires on every step(). Accumulate gradients in the "
                "training loop (call step() every Nth backward) instead")
        # named_parameters is accepted and unused (the flat
        # reducescatter needs no per-tensor names).
        if fsdp:
            return _FsdpOptimizer(optimizer, compression=compression,
                                  prefetch=fsdp_prefetch)
        return _ShardedOptimizer(optimizer, compression=compression)
    cls = type(optimizer.__class__.__name__, (optimizer.__class__,),
               dict(_DistributedOptimizer.__dict__))
    if isinstance(optimizer, MasterWeights):
        # The mixin over the caller's MasterWeights: its masters and
        # inner optimizer are kept; the hooks sit on model_params.
        obj = cls.__new__(cls)
        obj.__dict__.update(optimizer.__dict__)
        obj._hvd_setup(named_parameters, compression,
                       backward_passes_per_step, sparse_as_dense,
                       local_sgd_steps)
        return obj
    return cls(optimizer.param_groups, named_parameters, compression,
               backward_passes_per_step, sparse_as_dense, local_sgd_steps)


def broadcast_parameters(params, root_rank: int = 0):
    """Broadcast a state dict or ``(name, tensor)`` pairs from root to
    every rank, in place, through the engine on the tensors' device
    (reference torch/__init__.py:969)."""
    if isinstance(params, dict):
        items = sorted(params.items())
    else:
        items = list(params)
    handles = []
    for name, p in items:
        if p is None or not torch.is_tensor(p):
            continue
        handles.append(broadcast_async_(p, root_rank, name=f"bcastp.{name}"))
    for h in handles:
        synchronize(h)


def broadcast_optimizer_state(optimizer, root_rank: int = 0):
    """Broadcast optimizer state (momenta and the like) from root.  State
    not created yet is first made by a local zero-gradient step that
    leaves the parameters as they were; scalar entries travel as tensors
    and come back as their Python types (reference torch/__init__.py
    :990-1065).  For ``MasterWeights`` (alone or under the mixin) the fp32
    masters go too, and the model is re-derived from them."""
    if isinstance(optimizer, torch.optim.LBFGS):
        raise ValueError("cannot broadcast torch.optim.LBFGS state")
    if isinstance(optimizer, MasterWeights):
        broadcast_parameters([(f"master.{i}", m) for i, m in
                              enumerate(optimizer.masters)], root_rank)
        broadcast_optimizer_state(optimizer.inner, root_rank)
        optimizer.rederive()
        return
    state_dict = optimizer.state_dict()
    if len(state_dict["state"]) == 0:
        for group in optimizer.param_groups:
            for p in group["params"]:
                if p.requires_grad and p.grad is None:
                    p.grad = p.data.new_zeros(p.shape)
        # The dummy step stays LOCAL (bypassing the mixin's collectives)
        # and leaves the parameters untouched.
        saved = [p.detach().clone() for group in optimizer.param_groups
                 for p in group["params"]]
        if hasattr(optimizer, "_allreduce_grad_async"):
            type(optimizer).__mro__[1].step(optimizer)
        else:
            optimizer.step()
        it = iter(saved)
        with torch.no_grad():
            for group in optimizer.param_groups:
                for p in group["params"]:
                    p.copy_(next(it))
        state_dict = optimizer.state_dict()

    callbacks = {}
    occurrences = collections.defaultdict(int)
    params_to_bcast = []

    def _name(base):
        occurrences[base] += 1
        return f"{base}.{occurrences[base]}"

    def _tensorize(value, dict_key, base, holder):
        """Scalars travel as tensors; a callback restores the Python type
        into ``holder[dict_key]``."""
        if torch.is_tensor(value):
            params_to_bcast.append((_name(base), value))
            return
        if isinstance(value, bool):
            t, cast = torch.tensor(int(value)), (lambda x: bool(x.item()))
        elif isinstance(value, int):
            t, cast = torch.tensor(value), (lambda x: int(x.item()))
        elif isinstance(value, float):
            t = torch.tensor(value, dtype=torch.float64)
            cast = (lambda x: float(x.item()))
        else:
            return          # None, str: assumed the same on every rank
        name = _name(base)
        params_to_bcast.append((name, t))
        callbacks[name] = (holder, dict_key, t, cast)

    for gi, group in enumerate(state_dict["param_groups"]):
        for key, value in sorted(group.items()):
            if key != "params":
                _tensorize(value, key, f"group.{gi}.{key}", group)
    for pid, pstate in sorted(state_dict["state"].items(),
                              key=lambda kv: str(kv[0])):
        for key, value in sorted(pstate.items()):
            _tensorize(value, key, f"state.{pid}.{key}", pstate)

    broadcast_parameters(params_to_bcast, root_rank)
    for name, (holder, dict_key, t, cast) in callbacks.items():
        holder[dict_key] = cast(t)
    optimizer.load_state_dict(state_dict)
