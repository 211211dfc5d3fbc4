"""Staging of CUDA tensors through pinned host memory for the eager engine.

The engine (``runtime/engine.py``) reduces host buffers from its own
background thread, whenever the coordinator commits the response.  A CUDA
tensor therefore crosses to the host before it is enqueued, and its result
crosses back when the caller synchronizes.  Upstream Horovod does the same
with its ready events and device guard; the JAX package has no CUDA, so
this module has no counterpart there.

* **Ready event.**  An event recorded on the caller's current stream marks
  the point where every kernel that writes the tensor has been queued; the
  side stream waits on it, copies the tensor into a pinned buffer, and the
  host waits on that copy before the enqueue.  The engine never reads a
  buffer the card is still writing.
* **Device guard.**  Every copy runs under ``torch.cuda.device(t.device)``,
  on that device's streams, whatever the current device is.
* **Result.**  The host-to-device copy goes onto the caller's current
  stream of the result's device, so later work on that stream is ordered
  after it; the pinned buffer returns to the pool only once an event
  recorded behind that copy has completed.
* **Pool.**  ``cudaHostAlloc`` is slow, so pinned buffers are kept, keyed
  by their size in bytes; :func:`stats` counts allocations and reuses.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Sequence, Tuple

import torch

__all__ = ["PinnedPool", "pool", "to_host", "host_buffer", "to_device",
           "stats"]


class PinnedPool:
    """Pinned host buffers (``uint8``) keyed by size in bytes."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._free: Dict[int, List[torch.Tensor]] = {}
        # (event, buffer): a buffer a host-to-device copy may still read.
        self._pending: List[Tuple[torch.cuda.Event, torch.Tensor]] = []
        self._streams: Dict[int, torch.cuda.Stream] = {}
        # (start, end, bytes) of host-to-device copies not yet summed.
        self._h2d: List[Tuple[torch.cuda.Event, torch.cuda.Event, int]] = []
        self.counters = dict(pinned_allocs=0, pinned_alloc_bytes=0,
                             pinned_reuses=0, d2h_copies=0, d2h_bytes=0,
                             d2h_ms=0.0, h2d_copies=0, h2d_bytes=0,
                             h2d_ms=0.0)

    def stream(self, device: torch.device) -> torch.cuda.Stream:
        """The side stream of ``device`` that device-to-host copies run on."""
        with self._lock:
            s = self._streams.get(device.index)
            if s is None:
                s = self._streams[device.index] = torch.cuda.Stream(device)
            return s

    def _reclaim(self) -> None:
        keep = []
        for ev, buf in self._pending:
            if ev.query():
                self._free.setdefault(buf.numel(), []).append(buf)
            else:
                keep.append((ev, buf))
        self._pending = keep
        left = []
        for start, end, nbytes in self._h2d:
            if end.query():
                self.counters["h2d_ms"] += start.elapsed_time(end)
            else:
                left.append((start, end, nbytes))
        self._h2d = left

    def take(self, nbytes: int) -> torch.Tensor:
        """A pinned ``uint8`` buffer of ``nbytes``, reused where one is
        free."""
        with self._lock:
            self._reclaim()
            free = self._free.get(nbytes)
            if free:
                self.counters["pinned_reuses"] += 1
                return free.pop()
            self.counters["pinned_allocs"] += 1
            self.counters["pinned_alloc_bytes"] += nbytes
        return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)

    def give(self, buf: torch.Tensor, event=None) -> None:
        """Return ``buf``; with ``event``, once the event has completed."""
        with self._lock:
            if event is None:
                self._free.setdefault(buf.numel(), []).append(buf)
            else:
                self._pending.append((event, buf))

    def note_h2d(self, start, end, nbytes: int) -> None:
        with self._lock:
            self.counters["h2d_copies"] += 1
            self.counters["h2d_bytes"] += nbytes
            self._h2d.append((start, end, nbytes))

    def note_d2h(self, ms: float, nbytes: int) -> None:
        with self._lock:
            self.counters["d2h_copies"] += 1
            self.counters["d2h_bytes"] += nbytes
            self.counters["d2h_ms"] += ms

    def stats(self) -> dict:
        """The counters, with every finished copy's time summed in (waits
        for the copies still in flight)."""
        with self._lock:
            for _, end, _ in self._h2d:
                end.synchronize()
            self._reclaim()
            return dict(self.counters)


_pool = PinnedPool()


def pool() -> PinnedPool:
    """The process's pinned pool."""
    return _pool


def _view(buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    nbytes = like.numel() * like.element_size()
    return buf[:nbytes].view(like.dtype).view(like.shape)


def host_buffer(shape, dtype: torch.dtype) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """(view, lease): an uninitialized pinned tensor of ``shape`` and
    ``dtype`` for a result bound for the card, and the pool buffer under
    it (return it with :func:`to_device`)."""
    like = torch.empty(shape, dtype=dtype, device="meta")
    buf = _pool.take(max(like.numel() * like.element_size(), 1))
    return _view(buf, like), buf


def to_host(tensors: Sequence[torch.Tensor]
            ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """(host view, lease) of each CUDA tensor: pinned copies taken behind
    a ready event on each tensor's current stream, recorded after every
    tensor of the batch is made contiguous, under its device's guard;
    returns once every copy has landed."""
    # Every gather that ``.contiguous()`` queues on the caller's stream
    # comes before the device's ready event, so the side stream never
    # reads a source that is still being written.
    srcs = []
    for t in tensors:
        with torch.cuda.device(t.device):
            srcs.append(t.detach().contiguous())
    done = {}
    out = []
    for src in srcs:
        dev = src.device
        with torch.cuda.device(dev):
            view, buf = host_buffer(src.shape, src.dtype)
            if dev.index not in done:
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(dev))
                side = _pool.stream(dev)
                side.wait_event(ready)
                start = torch.cuda.Event(enable_timing=True)
                start.record(side)
                done[dev.index] = [side, start, 0]
            side = done[dev.index][0]
            with torch.cuda.stream(side):
                view.copy_(src, non_blocking=True)
            src.record_stream(side)
            done[dev.index][2] += view.numel() * view.element_size()
        out.append((view, buf))
    for index, (side, start, nbytes) in done.items():
        with torch.cuda.device(index):
            end = torch.cuda.Event(enable_timing=True)
            end.record(side)
            end.synchronize()
            _pool.note_d2h(start.elapsed_time(end), nbytes)
    return out


def to_device(host: torch.Tensor, lease: torch.Tensor,
              device: torch.device, out: torch.Tensor = None
              ) -> torch.Tensor:
    """Copy ``host`` into ``out`` (default: a new tensor on ``device``) on
    the caller's current stream of ``device``; ``lease`` returns to the
    pool behind the copy."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        if out is None:
            out = torch.empty(host.shape, dtype=host.dtype, device=device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        out.copy_(host, non_blocking=True)
        end.record(stream)
    _pool.note_h2d(start, end, host.numel() * host.element_size())
    _pool.give(lease, end)
    return out


def stats() -> dict:
    """The pinned pool's and the copies' counters."""
    return _pool.stats()
