"""Crash-consistent sharded async checkpoint writer, for CUDA state.

Counterpart of ``horovod_tpu/checkpoint/writer.py``, with the same files,
manifest, barrier and retention.  Each rank snapshots its state on the
calling thread and writes it from a writer thread:

1. serializes this rank's shard to ``step-<S>/shard-<r>-of-<N>.npz.tmp``
   (in two halves, between which the ``ckpt-kill`` fault fires) and
   renames it into place;
2. joins a MAX-allreduce barrier (``ckpt.commit.s<S>``) through the
   port's engine, where every rank contributes its failure flag;
3. rank 0 writes the step-stamped manifest, tmp+rename (the commit
   point);
4. applies retention (``HOROVOD_CHECKPOINT_KEEP``), deleting a stale
   manifest BEFORE its shard directory.

The snapshot of CUDA state (:func:`snapshot_tree`): every CUDA leaf is
copied into a pinned host buffer that is reused from save to save (a
second set is made only when a save comes while the writer still reads
the first), on a side stream that waits on an event recorded on the
compute stream.  Before ``save()`` returns, the compute stream waits on the
copies' completion event: an ``optimizer.step`` queued next writes
params, masters and moments in place, and must not race the copy.  A CPU
leaf is copied at once.  The writer thread waits on the completion event
before it reads the buffers.

The on-disk dtypes: every array is one numpy reads without ``ml_dtypes``.
A bf16 tensor is written as fp32 (exact) and restored by a cast back
(bitwise); the loader maps a ``|V2`` leaf written by the JAX package's
bf16 arrays through ``uint16`` to ``torch.bfloat16``.
"""

from __future__ import annotations

import io
import json
import os
import shutil
import signal
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from horovod_tpu_torch.checkpoint import manifest as mf
from horovod_tpu_torch.checkpoint.stats import note_checkpoint
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.elastic.state import _walk
from horovod_tpu_torch.runtime.engine import HorovodInternalError, flight_note

__all__ = ["CheckpointConfig", "CheckpointWriter", "parse_ckpt_kill",
           "snapshot_tree"]


def _int_env(raw: Optional[str], default: int) -> int:
    try:
        return int(raw) if raw not in (None, "") else default
    except ValueError:
        return default


class CheckpointConfig:
    """The ``HOROVOD_CHECKPOINT_*`` knobs (lenient-parsed, as the rest of
    the env surface)."""

    def __init__(self, directory: Optional[str] = None,
                 interval_steps: Optional[int] = None,
                 keep: Optional[int] = None, environ=os.environ):
        env_dir = environ.get("HOROVOD_CHECKPOINT_DIR", "").strip()
        self.directory = directory if directory is not None else (
            env_dir or None)
        self.interval_steps = max(1, interval_steps if interval_steps
                                  is not None else _int_env(
                                      environ.get(
                                          "HOROVOD_CHECKPOINT_INTERVAL_STEPS"),
                                      50))
        self.keep = max(1, keep if keep is not None else _int_env(
            environ.get("HOROVOD_CHECKPOINT_KEEP"), 2))

    @property
    def enabled(self) -> bool:
        return bool(self.directory)


# -- ckpt-kill fault schedule (the Python-owned kind of HOROVOD_FAULT_INJECT) --

_CKPT_KILL_FIRED = False


def _strict_int(tok: str) -> Optional[int]:
    """The whole token must be a (signed) decimal integer, else the entry
    is a typo and is ignored (the engine parser's rule)."""
    tok = tok.strip()
    if not tok:
        return None
    body = tok[1:] if tok[0] in "+-" else tok
    if not body.isdigit():
        return None
    return int(tok)


def parse_ckpt_kill(raw: Optional[str], rank: int) -> Optional[int]:
    """First ``<rank>:<step>:ckpt-kill`` entry of the shared
    ``HOROVOD_FAULT_INJECT`` schedule matching ``rank``; returns the arm
    step (``-2`` for ``*`` = first checkpoint) or ``None``."""
    if not raw:
        return None
    for token in raw.split(","):
        fields = token.split(":")
        if len(fields) < 3:
            continue
        frank = _strict_int(fields[0])
        if frank is None or frank != rank:
            continue
        step_tok = fields[1].strip()
        fstep = -2 if step_tok == "*" else _strict_int(step_tok)
        if fstep is None:
            continue
        if fields[2].strip() == "ckpt-kill":
            return fstep
    return None


def _maybe_fire_ckpt_kill(arm_step: Optional[int], step: int,
                          partial_file) -> None:
    """SIGKILL this process mid-shard-write, once: called after the tmp
    file holds the first half of the serialization (fsynced, so the torn
    bytes are really on disk)."""
    global _CKPT_KILL_FIRED
    if arm_step is None or _CKPT_KILL_FIRED:
        return
    if arm_step != -2 and step < arm_step:
        return
    _CKPT_KILL_FIRED = True
    partial_file.flush()
    os.fsync(partial_file.fileno())
    print(f"[hvd] FAULT INJECT: ckpt-kill at step {step} "
          "(SIGKILL mid-shard-write)", flush=True)
    os.kill(os.getpid(), signal.SIGKILL)


# -- the snapshot codec --

_SIDE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def _side_stream(dev: torch.device):
    stream = _SIDE_STREAMS.get(dev)
    if stream is None:
        stream = _SIDE_STREAMS[dev] = torch.cuda.Stream(dev)
    return stream


class _Copies:
    """The D2H copies of one snapshot: ``done`` (one event per device)
    and the copy time between ``start`` and ``done`` events."""

    def __init__(self, events):
        self.events = events     # [(start, done)]

    def synchronize(self) -> None:
        for _, done in self.events:
            done.synchronize()

    def elapsed_ms(self) -> float:
        """Device time of the copies (after :meth:`synchronize`)."""
        return sum(start.elapsed_time(done) for start, done in self.events)


def snapshot_tree(trees: dict, buffers: dict) -> Tuple[dict, Optional[_Copies]]:
    """Host copies of ``{slot: tree}``: every CUDA tensor leaf into the
    pinned buffer ``buffers[path]`` (made or remade when its shape or
    dtype changed), every CPU tensor and numpy leaf as a copy, numbers as
    they are.  The CUDA copies run on a side stream behind an event of the
    current stream, and the current stream waits on their completion;
    returns ``(host trees, copies)``, ``copies`` None without a CUDA leaf.
    Read a host buffer only after ``copies.synchronize()``."""
    pairs: Dict[torch.device, list] = {}

    def visit(path, leaf):
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach()
            if t.device.type != "cuda":
                return t.clone()
            buf = buffers.get(path)
            if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                buf = buffers[path] = torch.empty(t.shape, dtype=t.dtype,
                                                  pin_memory=True)
            pairs.setdefault(t.device, []).append((buf, t))
            return buf
        return _host_copy(leaf)

    host = {k: _walk(v, k, visit) for k, v in trees.items()}
    if not pairs:
        return host, None
    events = []
    for dev, todo in pairs.items():
        compute = torch.cuda.current_stream(dev)
        side = _side_stream(dev)
        ready = torch.cuda.Event()
        ready.record(compute)
        side.wait_event(ready)
        start = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(side):
            start.record(side)
            for buf, t in todo:
                buf.copy_(t, non_blocking=True)
            done.record(side)
        # The next in-place update on the compute stream waits for the
        # copies.
        compute.wait_event(done)
        events.append((start, done))
    return host, _Copies(events)


def _host_copy(leaf):
    """A non-tensor leaf as the reference's ``_host_copy`` keeps it: a
    number that is a Python number (``np.float64`` included) as it is,
    any other array or numpy scalar as a copied array."""
    if isinstance(leaf, (bool, int, float, complex)):
        return leaf
    return np.array(np.asarray(leaf), copy=True)


def _host_array(leaf):
    """A host leaf of a snapshot as what goes into the npz: a tensor as a
    numpy array of its dtype (bf16 as fp32, exact), anything else through
    ``np.asarray`` as the reference does."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return np.asarray(leaf)


class CheckpointWriter:
    """Async double-buffered per-rank shard writer + rank-0 committer.

    >>> w = CheckpointWriter(directory)         # or env-configured
    >>> w.maybe_save(step, state, sharded)      # interval-gated
    >>> w.wait()                                # drain (tests/shutdown)
    >>> w.close()

    ``save()`` is collective only in the sense that every rank must
    eventually save the same step (the commit barrier rendezvous); the
    call itself returns once the snapshot's copies are queued.
    Latest-wins: a save arriving while the writer is busy replaces any
    queued snapshot.  ``last_stall_ms`` is the last ``save()``'s time on
    the calling thread; ``last_snapshot_ms`` the device time of its D2H
    copies; ``last_write_ms`` the last committed write's serialize +
    write + fsync + barrier + manifest time, split in ``last_phases``
    (ms: ``serialize``, ``write``, ``fsync``, ``barrier``, ``manifest``).
    """

    def __init__(self, directory: Optional[str] = None, *,
                 interval_steps: Optional[int] = None,
                 keep: Optional[int] = None,
                 meta: Optional[dict] = None):
        self.config = CheckpointConfig(directory, interval_steps, keep)
        if not self.config.enabled:
            raise ValueError(
                "CheckpointWriter needs a directory (argument or "
                "HOROVOD_CHECKPOINT_DIR)")
        self.rank = basics.rank() if basics.is_initialized() else 0
        self.size = basics.size() if basics.is_initialized() else 1
        self.meta = dict(meta or {})
        self.last_committed_step = -1
        self.last_error: Optional[BaseException] = None
        self.last_stall_ms = 0.0
        self.last_snapshot_ms = 0.0
        self.last_write_ms = 0.0
        self.last_phases: Dict[str, float] = {}
        self.last_bytes = 0
        self._kill_step = parse_ckpt_kill(
            os.environ.get("HOROVOD_FAULT_INJECT"), self.rank)
        os.makedirs(self.config.directory, exist_ok=True)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._pending: Optional[tuple] = None
        self._busy = False
        self._closed = False
        # Two sets of pinned buffers: the writer reads one while the next
        # save fills the other.
        self._buffers = ({}, {})
        self._reading: Optional[int] = None
        self._thread = threading.Thread(
            target=self._run, name=f"ckpt-writer-r{self.rank}", daemon=True)
        self._thread.start()

    # -- producer side (training thread) --

    def maybe_save(self, step: int, state, sharded=None) -> bool:
        """Interval-gated :meth:`save` (every ``interval_steps``-th
        step, counting from step ``interval_steps``)."""
        if step <= 0 or step % self.config.interval_steps != 0:
            return False
        self.save(step, state, sharded)
        return True

    def save(self, step: int, state, sharded=None) -> None:
        """Snapshot now, write async.  ``sharded`` maps a name to
        ``(local_shard, n)``: this rank's window of a flat length-``n``
        vector (a tensor on any device, or an array).

        A stored writer-thread failure is shed here, not raised (a peer
        that died mid-write fails the barrier on the survivors only, and
        the next commit barrier must still meet); ``wait()`` re-raises."""
        t0 = time.perf_counter()
        self.last_error = None
        slots = self._slots_of(state)
        with self._cv:
            if self._closed:
                raise RuntimeError("CheckpointWriter is closed")
            # Drop a queued snapshot: its buffers are the ones to refill.
            # Otherwise the second set only while the writer reads the
            # first: saves that do not overlap reuse one set.
            if self._pending is not None:
                slot = self._pending[4]
                self._pending = None
            else:
                slot = 0 if self._reading != 0 else 1
        flat = {f"\0sh.{name}": shard
                for name, (shard, _) in (sharded or {}).items()}
        host, copies = snapshot_tree(dict(slots, **flat),
                                     self._buffers[slot])
        snap = {k: host[k] for k in slots}
        sh = {name: (host[f"\0sh.{name}"], int(n))
              for name, (_, n) in (sharded or {}).items()}
        with self._cv:
            self._pending = (int(step), snap, sh, copies, slot)
            self._cv.notify_all()
        self.last_stall_ms = (time.perf_counter() - t0) * 1e3

    def wait(self, timeout: Optional[float] = None) -> None:
        """Block until the writer is idle with nothing queued; re-raise
        a writer-thread failure."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while self._pending is not None or self._busy:
                rem = None if deadline is None else deadline - time.monotonic()
                if rem is not None and rem <= 0:
                    raise TimeoutError("checkpoint writer did not drain")
                self._cv.wait(rem)
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err

    def close(self, *, drain: bool = True) -> None:
        if drain and self._thread.is_alive():
            try:
                self.wait(timeout=120)
            except TimeoutError:
                pass
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=10)

    @staticmethod
    def _slots_of(state) -> dict:
        if hasattr(state, "_keys"):  # ElasticState duck type
            return {k: getattr(state, k) for k in state._keys}
        if not isinstance(state, dict):
            raise TypeError(
                "state must be a dict of named slots or an ElasticState")
        return dict(state)

    # -- writer thread --

    def _run(self) -> None:
        while True:
            with self._cv:
                while self._pending is None and not self._closed:
                    self._cv.wait()
                if self._pending is None and self._closed:
                    return
                step, snap, sh, copies, slot = self._pending
                self._pending = None
                self._busy = True
                self._reading = slot
            try:
                if copies is not None:
                    copies.synchronize()
                    self.last_snapshot_ms = copies.elapsed_ms()
                self._write_and_commit(step, snap, sh)
            except BaseException as e:  # noqa: BLE001 -- surfaced on wait()
                self.last_error = e
            finally:
                with self._cv:
                    self._busy = False
                    self._reading = None
                    self._cv.notify_all()

    def _write_and_commit(self, step: int, snap: dict, sh: dict) -> None:
        t0 = time.monotonic_ns()
        self._phases: Dict[str, float] = {}
        if basics.is_initialized():
            # Re-read the identity per attempt: an elastic re-rendezvous
            # may have resized the world since the writer was built.
            self.rank, self.size = basics.rank(), basics.size()
        flight_note("ckpt", f"begin step={step} world={self.size}")
        failed = 0
        nbytes = 0
        sharded_meta, replicated_paths = [], []
        try:
            nbytes, sharded_meta, replicated_paths = self._write_shard(
                step, snap, sh)
        except Exception as e:  # noqa: BLE001 -- reported via the barrier
            failed = 1
            self.last_error = e
        eng = _engine()
        if eng is not None:
            # The commit barrier: MAX over every rank's failure flag.  A
            # rank that died mid-write never enqueues: the collective
            # aborts, no manifest, the previous checkpoint stays durable.
            t = time.perf_counter()
            flag = torch.tensor([float(failed)], dtype=torch.float64)
            eng.synchronize(eng.enqueue_allreduce(
                flag, name=f"ckpt.commit.s{step}", red_op="max"))
            failed = int(flag[0])
            self._phases["barrier"] = (time.perf_counter() - t) * 1e3
        if failed:
            raise HorovodInternalError(
                f"checkpoint step {step}: a rank failed to write its "
                "shard; commit aborted (previous checkpoint remains "
                "durable)")
        if self.rank == 0:
            t = time.perf_counter()
            self._commit_manifest(step, sharded_meta, replicated_paths)
            self._phases["manifest"] = (time.perf_counter() - t) * 1e3
        self.last_committed_step = step
        ns = time.monotonic_ns() - t0
        self.last_write_ms = ns / 1e6
        self.last_phases = self._phases
        self.last_bytes = nbytes
        note_checkpoint(step, nbytes, ns)
        flight_note("ckpt", f"commit step={step} bytes={nbytes} "
                            f"world={self.size}")
        if self.rank == 0:
            self._apply_retention()

    def _write_shard(self, step: int, snap: dict, sh: dict):
        """Serialize this rank's npz (tmp+rename).  Returns (bytes,
        sharded manifest entries, replicated path list)."""
        from horovod_tpu_torch.runtime.sharded import shard_bounds

        directory = self.config.directory
        os.makedirs(mf.shard_dir(directory, step), exist_ok=True)
        arrays: Dict[str, np.ndarray] = {}
        sharded_meta = []
        for i, (name, (shard, n)) in enumerate(sorted(sh.items())):
            arr = _host_array(shard).ravel()
            bounds = shard_bounds(n, self.size)
            _, cnt = bounds[self.rank]
            if arr.size != cnt:
                raise ValueError(
                    f"sharded entry '{name}': local shard has "
                    f"{arr.size} elements but rank {self.rank}/"
                    f"{self.size} owns {cnt} of n={n}")
            key = f"sh.{i}"
            arrays[key] = arr
            sharded_meta.append({
                "name": name, "n": n, "dtype": str(arr.dtype),
                "key": key, "bounds": [list(b) for b in bounds],
            })
        replicated_paths = []
        if self.rank == 0:
            skip = set(sh)

            def collect(path, leaf):
                if path not in skip:
                    arrays[f"rep.{len(replicated_paths)}"] = _host_array(leaf)
                    replicated_paths.append(path)
                return leaf

            for k in sorted(snap):
                _walk(snap[k], k, collect)
        t = time.perf_counter()
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        payload = buf.getbuffer()
        t1 = time.perf_counter()
        final = mf.shard_file(directory, step, self.rank, self.size)
        tmp = final + ".tmp"
        with open(tmp, "wb") as f:
            # Two-phase write: the injected ckpt-kill fires between the
            # halves, leaving a real torn tmp file on disk.
            half = max(1, len(payload) // 2)
            f.write(payload[:half])
            _maybe_fire_ckpt_kill(self._kill_step, step, f)
            f.write(payload[half:])
            f.flush()
            t2 = time.perf_counter()
            os.fsync(f.fileno())
        os.replace(tmp, final)
        self._phases.update(serialize=(t1 - t) * 1e3, write=(t2 - t1) * 1e3,
                            fsync=(time.perf_counter() - t2) * 1e3)
        return len(payload), sharded_meta, replicated_paths

    def _commit_manifest(self, step: int, sharded_meta,
                         replicated_paths) -> None:
        directory = self.config.directory
        eng = _engine()
        shards = []
        for r in range(self.size):
            path = mf.shard_file(directory, step, r, self.size)
            shards.append({
                "file": os.path.relpath(path, directory),
                "rank": r,
                "bytes": os.path.getsize(path),
            })
        man = {
            "format": mf.FORMAT_VERSION,
            "step": int(step),
            "epoch": int(eng.epoch()) if eng is not None else 0,
            "world_size": self.size,
            "meta": self.meta,
            "shards": shards,
            "sharded": sharded_meta,
            "replicated": {"paths": replicated_paths, "file_rank": 0},
        }
        final = mf.manifest_path(directory, step)
        tmp = final + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(man, f, indent=1, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)

    def _apply_retention(self) -> None:
        """Keep the newest ``keep`` committed checkpoints: the manifest
        goes first (the set stops being advertised), then its shards."""
        directory = self.config.directory
        steps = mf.list_manifest_steps(directory)
        for step in steps[:-self.config.keep] if len(steps) > \
                self.config.keep else []:
            try:
                os.unlink(mf.manifest_path(directory, step))
            except OSError:
                pass
            shutil.rmtree(mf.shard_dir(directory, step),
                          ignore_errors=True)


def _engine():
    """The port's engine when a world of more than one is up, else None."""
    if not basics.is_initialized():
        return None
    from horovod_tpu_torch.runtime import engine_or_none

    return engine_or_none()
