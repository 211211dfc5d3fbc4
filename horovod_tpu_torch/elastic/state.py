"""Commit/restore/sync of training state (``ElasticState``) and the
local-SGD policy (``LocalSGD``) with its env default.

Counterpart of ``horovod_tpu/elastic/state.py``.  Slots hold trees of
torch tensors on any device, numpy arrays and Python numbers, walked by
:func:`_walk` in the reference's order with its separators (every
checkpoint and push path depends on them).

* ``ElasticState.commit`` takes host copies of the slots: a CUDA tensor
  through the checkpoint writer's snapshot (pinned buffers, a side
  stream behind an event of the compute stream), a CPU tensor or numpy
  array as a copy.  ``restore`` copies them back IN PLACE into the live
  tensors (a parameter is never rebound), and ``sync`` broadcasts every
  leaf from the root through the eager engine, keeping Python scalar
  types as the reference does.
* ``LocalSGD``: the outer sync is one grouped allreduce of the tensors as
  they are, through the eager engine, so a CUDA model is staged through
  pinned memory behind its ready event (``runtime/staging.py``) and
  comes back on its device.  With ``compression=Compression.topk(r)`` it
  is one top-k sparse allreduce of each float leaf's delta from the
  anchor instead (``runtime/sparse.py``), on the leaf's device.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.runtime import mpi_ops
from horovod_tpu_torch.runtime.engine import StepSkipped, note_local_sgd_sync

__all__ = ["ElasticState", "LocalSGD", "default_local_sgd_steps"]


def _walk(obj, path, visit):
    """Rebuild a tree, calling ``visit(path, leaf)`` on every tensor,
    array or number leaf (other leaves pass through untouched).  Dict
    keys traverse in sorted order, so cross-rank collective names meet;
    paths are the reference's (``<path>.<key>``, ``<path>.<index>``)."""
    if isinstance(obj, dict):
        return {k: _walk(obj[k], f"{path}.{k}", visit)
                for k in sorted(obj, key=str)}
    if isinstance(obj, tuple):
        vals = [_walk(v, f"{path}.{i}", visit) for i, v in enumerate(obj)]
        if hasattr(obj, "_fields"):
            return type(obj)(*vals)
        return tuple(vals)
    if isinstance(obj, list):
        return [_walk(v, f"{path}.{i}", visit) for i, v in enumerate(obj)]
    if isinstance(obj, (torch.Tensor, bool, int, float)):
        return visit(path, obj)
    if isinstance(obj, (np.ndarray, np.generic)) and obj.dtype != object:
        return visit(path, obj)
    return obj


def _leaves(tree, prefix: str) -> dict:
    """``{path: leaf}`` of every leaf :func:`_walk` visits."""
    out: dict = {}
    _walk(tree, prefix, lambda path, leaf: out.__setitem__(path, leaf))
    return out


def _scalar_like(leaf, val):
    """``val`` (a 0-d host value) as the type of scalar ``leaf``, as the
    reference's ``sync`` keeps it: Python bool/int/float stay Python."""
    if isinstance(leaf, bool):
        return bool(val)
    if isinstance(leaf, int):
        return int(val)
    if isinstance(leaf, float):
        return float(val)
    return val


class ElasticState:
    """Named training-state slots with commit/rollback semantics.

    >>> state = ElasticState(params=dict(model.named_parameters()),
    ...                      opt=opt_state, step=0)
    >>> state.step += 1
    >>> state.commit()          # durable point: rollback target
    >>> state.restore()         # back to the last commit, in place
    >>> state.sync()            # adopt rank 0's values everywhere

    The constructor takes the initial snapshot, so ``restore()`` is always
    well-defined.  Slots are plain attributes between calls; only the
    names given at construction are tracked.  ``last_sync_size`` /
    ``last_sync_epoch`` record the world each sync committed into.
    """

    def __init__(self, **slots):
        if not slots:
            raise ValueError("ElasticState needs at least one named slot")
        self._keys = sorted(slots)
        for k, v in slots.items():
            setattr(self, k, v)
        self._commit_count = 0
        self._snapshot: dict = {}
        self._devices: dict = {}
        self._buffers: dict = {}
        self.last_sync_size: int | None = None
        self.last_sync_epoch: int | None = None
        self.commit()

    @property
    def commit_count(self) -> int:
        """Monotonic count of commits (incl. the constructor's and each
        ``sync()``'s): :func:`run_elastic` uses it to detect progress
        between failures and reset its retry budget."""
        return self._commit_count

    def commit(self) -> None:
        """Snapshot every slot to host memory; the new rollback target.
        Returns once the copies have landed."""
        from horovod_tpu_torch.checkpoint.writer import snapshot_tree

        trees = {k: getattr(self, k) for k in self._keys}
        self._devices = {
            path: leaf.device for k in self._keys
            for path, leaf in _leaves(trees[k], k).items()
            if isinstance(leaf, torch.Tensor)}
        host, done = snapshot_tree(trees, self._buffers)
        if done is not None:
            done.synchronize()
        self._snapshot = host
        self._commit_count += 1

    def restore(self) -> None:
        """Roll every slot back to the last commit: each live tensor at a
        committed path (same shape and dtype) is overwritten in place;
        scalars, arrays and anything whose structure changed since the
        commit are rebuilt from the snapshot (tensors on their committed
        device)."""
        for k in self._keys:
            saved = _leaves(self._snapshot[k], k)
            live = getattr(self, k)
            live_leaves = _leaves(live, k)
            same = live_leaves.keys() == saved.keys() and all(
                not isinstance(t, torch.Tensor)
                or (isinstance(saved[p], torch.Tensor)
                    and t.shape == saved[p].shape
                    and t.dtype == saved[p].dtype)
                for p, t in live_leaves.items())

            def back(path, leaf, same=same, saved=saved):
                host = saved[path] if same else leaf
                if isinstance(host, torch.Tensor):
                    if same and isinstance(leaf, torch.Tensor):
                        with torch.no_grad():
                            leaf.copy_(host)
                        return leaf
                    return host.to(self._devices.get(path, "cpu"),
                                   copy=True)
                if isinstance(host, np.ndarray):
                    return np.array(host, copy=True)
                return host

            src = live if same else self._snapshot[k]
            setattr(self, k, _walk(src, k, back))

    def sync(self, root_rank: int = 0) -> None:
        """Broadcast every slot from ``root_rank`` and commit the result.

        Collective: every rank calls it at the same point.  Every leaf's
        broadcast is enqueued before any is drained (one batch for the
        engine); a tensor is overwritten in place on its device, a scalar
        keeps its Python type, an array its dtype."""
        if basics.is_initialized() and basics.size() > 1:
            paths, bufs = [], []

            def enqueue(path, leaf):
                if isinstance(leaf, torch.Tensor) and leaf.is_contiguous():
                    buf = leaf.detach()
                    buf = buf.reshape(1) if buf.dim() == 0 else buf
                else:
                    arr = np.asarray(leaf.detach().cpu() if isinstance(
                        leaf, torch.Tensor) else leaf)
                    buf = torch.from_numpy(np.ascontiguousarray(
                        arr.reshape(1) if arr.ndim == 0 else arr).copy())
                paths.append(path)
                bufs.append(buf)
                return leaf

            for k in self._keys:
                _walk(getattr(self, k), k, enqueue)
            handles = mpi_ops._enqueue_many(
                "broadcast", bufs, inplace=True, root_rank=root_rank,
                names=[f"elastic.sync.{p}" for p in paths])
            outs = dict(zip(paths, mpi_ops._drain(handles)))

            def adopt(path, leaf):
                out = outs[path]
                if isinstance(leaf, torch.Tensor):
                    if out.data_ptr() != leaf.data_ptr():
                        with torch.no_grad():
                            leaf.copy_(out.reshape(leaf.shape))
                    return leaf
                arr = out.numpy()
                if np.asarray(leaf).ndim == 0:
                    return _scalar_like(leaf, arr.reshape(())[()])
                return arr.reshape(np.asarray(leaf).shape)

            for k in self._keys:
                setattr(self, k, _walk(getattr(self, k), k, adopt))
        self.last_sync_size = basics.size() if basics.is_initialized() else 1
        self.last_sync_epoch = basics.epoch()
        self.commit()


def default_local_sgd_steps() -> int:
    """The ``HOROVOD_LOCAL_SGD_STEPS`` env default (H local steps per
    outer sync; 1 = fully synchronous)."""
    raw = os.environ.get("HOROVOD_LOCAL_SGD_STEPS", "")
    try:
        v = int(raw) if raw else 1
    except ValueError:
        v = 1
    return max(1, v)


class LocalSGD:
    """Periodic sync (local SGD, DiLoCo): ``H`` purely local optimizer
    steps, then one outer allreduce of the model.

    Each rank ships its current model ``P_r`` and adopts the participants'
    average, which over an agreed anchor is the delta-average outer step
    ``anchor + avg(P_r - anchor)`` but needs no anchor values: a rank
    whose anchor was perturbed lands on the consensus at its next
    successful sync.  The anchor is a cadence and epoch marker.

    * **Epoch re-anchor.**  The anchor is stamped with the membership
      epoch; when the epoch moved, the next :meth:`maybe_sync` re-anchors
      to the current model instead of syncing a dead incarnation's delta.
    * **StepSkipped.**  A sync that left this rank out (a backup-worker
      partial commit) keeps the local model, re-anchors to it, and is not
      counted.

    * **Top-k** (``compression=Compression.topk(r)``).  The sync ships
      each float leaf's delta ``P_r - anchor`` as its ``k`` largest
      entries, with error-feedback residuals of its own (keyed
      ``local_sgd.delta.<path>``, epoch-stamped), and rebuilds
      ``anchor + avg(delta)``; so in this mode the anchor keeps the
      values (a detached copy on the leaf's device), the sync runs at a
      world of one too, and non-float leaves stay local.
    """

    def __init__(self, local_sgd_steps: int | None = None,
                 compression=None):
        # Duck-typed, as the reference's: any spec named TopKCompressor
        # with a ratio.
        self._topk = compression if (
            type(compression).__name__ == "TopKCompressor"
            and hasattr(compression, "ratio")) else None
        self._anchor_values = None
        self.steps = max(1, int(local_sgd_steps)
                         if local_sgd_steps is not None
                         else default_local_sgd_steps())
        self._local_steps = 0
        self._anchored = False
        self._anchor_epoch: int | None = None
        #: Completed outer syncs (mirror of the engine's cumulative
        #: ``local_sgd_syncs``).
        self.sync_count = 0

    @staticmethod
    def _epoch() -> int:
        return basics.epoch() if basics.is_initialized() else 0

    def begin(self, params=None) -> None:
        """Anchor the outer model: call once before the first local step.
        ``params`` is stored only in top-k mode, where the sync ships
        deltas from it; there a value-less ``begin()`` defers anchoring to
        the next :meth:`maybe_sync`."""
        self._anchor_epoch = self._epoch()
        self._local_steps = 0
        if self._topk is not None:
            if params is None:
                self._anchored = False
                self._anchor_values = None
                return
            self._anchor_values = _walk(
                params, "p", lambda _, leaf: leaf.detach().clone()
                if isinstance(leaf, torch.Tensor) else leaf)
        self._anchored = True

    def reset(self) -> None:
        """Drop the anchor; the next :meth:`maybe_sync` re-anchors without
        syncing."""
        self._anchored = False
        self._anchor_epoch = None
        self._anchor_values = None
        self._local_steps = 0

    def maybe_sync(self, params):
        """Count one completed local step; on the ``H``-th, allreduce the
        model and return the synced tree, otherwise ``params`` itself (the
        same object: callers tell a sync by identity)."""
        if not self._anchored or self._anchor_epoch != self._epoch():
            self.begin(params)
            return params
        self._local_steps += 1
        if self._local_steps < self.steps:
            return params
        if self._topk is not None:
            return self._sync_topk(params)
        if not basics.is_initialized() or basics.size() == 1:
            # A world of one: the sync is an identity, the cadence holds.
            self.begin(params)
            self.sync_count += 1
            note_local_sgd_sync()
            return params

        paths, sends = [], []

        def collect(path, leaf):
            t = leaf.detach() if isinstance(leaf, torch.Tensor) \
                else torch.tensor(leaf)
            paths.append(path)
            sends.append(t.reshape(1) if t.dim() == 0 else t)
            return leaf

        _walk(params, "p", collect)
        # Every leaf enqueued before any is drained: the engine fuses the
        # burst; the average divides by the participants.
        handles = mpi_ops._enqueue_many(
            "allreduce", sends, average=True,
            names=[f"local_sgd.sync.{p}" for p in paths])
        try:
            outs = iter(mpi_ops._drain(handles))
        except StepSkipped:
            # Left out of the outer sync: keep the local model; the next
            # successful sync heals it (the average is anchor-free).
            self.begin(params)
            return params

        def adopt(path, leaf):
            new = next(outs)
            if isinstance(leaf, torch.Tensor):
                return new.reshape(leaf.shape).to(leaf.dtype)
            return type(leaf)(new.reshape(()).item())

        synced = _walk(params, "p", adopt)
        self.begin(synced)
        self.sync_count += 1
        note_local_sgd_sync()
        return synced

    def _sync_topk(self, params):
        """The outer sync over the top-k sparse path: per float leaf, top-k
        of ``P_r - anchor`` with residuals keyed
        ``local_sgd.delta.<path>``, rebuilt as ``anchor + avg``, in the
        leaf's dtype.  Leaf by leaf (two allgathers each)."""
        from horovod_tpu_torch.runtime.sparse import sparse_allreduce_topk

        anchors: dict = {}
        _walk(self._anchor_values, "p",
              lambda path, leaf: anchors.__setitem__(path, leaf))

        def sync_leaf(path, leaf):
            anchor = anchors.get(path)
            t = leaf if isinstance(leaf, torch.Tensor) else (
                torch.tensor(leaf, dtype=torch.float64)
                if isinstance(leaf, float) else None)
            a = anchor if isinstance(anchor, torch.Tensor) else (
                torch.tensor(anchor, dtype=torch.float64)
                if isinstance(anchor, float) else None)
            if (t is None or a is None or not t.is_floating_point()
                    or a.shape != t.shape):
                # Non-float slots, and structure drift (the next re-anchor
                # repairs it), stay local.
                return leaf
            anchor32 = a.to(device=t.device, dtype=torch.float32)
            avg = sparse_allreduce_topk(
                t.detach().to(torch.float32) - anchor32,
                name=f"local_sgd.delta.{path}", ratio=self._topk.ratio,
                error_feedback=getattr(self._topk, "error_feedback", True),
                average=True)
            new = (anchor32 + avg).to(t.dtype)
            return new if isinstance(leaf, torch.Tensor) else float(new)

        synced = _walk(params, "p", sync_leaf)
        self.begin(synced)
        self.sync_count += 1
        note_local_sgd_sync()
        return synced
