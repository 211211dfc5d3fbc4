"""A device trace reduced to what the per-layer readers need.

:func:`from_chrome` takes ``torch.profiler``'s Chrome trace (CUPTI): the
device's operations (kernels, copies and fills) and the host's ranges (its
CUDA runtime and driver calls, and operator and ``record_function`` ranges
where the host was traced too), in microseconds on one clock.  Busy time
is the union of the device's intervals, so operations that overlap on two
streams (NCCL beside compute) count once.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, Iterable, List, Sequence, Tuple

from gpubench.flops import kernel_group

#: Chrome-trace categories of device operations and of host ranges.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
#: The label of an idle gap in which the host was in no traced range: it
#: was running Python and ATen between two CUDA calls.
BETWEEN_CALLS = "host between CUDA calls"

Interval = Tuple[float, float]


@dataclasses.dataclass(frozen=True)
class Op:
    name: str
    start: float            # microseconds
    end: float
    kind: str               # a DEVICE_CATS or HOST_CATS entry

    @property
    def group(self) -> str:
        return kernel_group(self.name) if self.kind == "kernel" else "other"


@dataclasses.dataclass
class Trace:
    device: List[Op]
    host: List[Op]

    def span(self) -> Interval:
        """From the first device operation's start to the last one's end."""
        return (min(o.start for o in self.device),
                max(o.end for o in self.device))

    def busy_us(self) -> float:
        return length(union((o.start, o.end) for o in self.device))

    def window_us(self) -> float:
        a, b = self.span()
        return b - a

    def kernels(self, groups: Sequence[str] = None) -> List[Op]:
        return [o for o in self.device if o.kind == "kernel"
                and (groups is None or o.group in groups)]


def from_chrome(data: dict) -> Trace:
    events = data["traceEvents"] if isinstance(data, dict) else data
    device, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        op = Op(e.get("name", ""), float(e["ts"]),
                float(e["ts"]) + float(e["dur"]), cat)
        if cat in DEVICE_CATS:
            device.append(op)
        elif cat in HOST_CATS:
            host.append(op)
    if not device:
        raise ValueError("the trace holds no device operation: the "
                         "profiler saw no kernel on the card")
    device.sort(key=lambda o: o.start)
    host.sort(key=lambda o: o.start)
    return Trace(device, host)


def union(intervals: Iterable[Interval]) -> List[Interval]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def length(merged: Sequence[Interval]) -> float:
    return sum(b - a for a, b in merged)


def overlap(x: Sequence[Interval], y: Sequence[Interval]) -> float:
    """Length of the intersection of two merged interval lists."""
    i = j = 0
    total = 0.0
    while i < len(x) and j < len(y):
        a, b = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        if a < b:
            total += b - a
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_gaps(trace: Trace) -> List[Interval]:
    """The intervals inside the span in which no device operation runs."""
    busy = union((o.start, o.end) for o in trace.device)
    return [(busy[k][1], busy[k + 1][0]) for k in range(len(busy) - 1)]


def host_activity(host: Sequence[Op], times: Sequence[float]) -> List[str]:
    """For each time, the innermost host range open then (the shortest of
    those that contain it), or :data:`BETWEEN_CALLS` where none is: one
    sweep over ``host`` (sorted by start) with a heap of the open
    ranges."""
    labels = [BETWEEN_CALLS] * len(times)
    heap: List[Tuple[float, int]] = []
    i = 0
    for k in sorted(range(len(times)), key=times.__getitem__):
        t = times[k]
        while i < len(host) and host[i].start <= t:
            heapq.heappush(heap, (host[i].end - host[i].start, i))
            i += 1
        while heap and host[heap[0][1]].end < t:
            heapq.heappop(heap)
        if heap:
            labels[k] = host[heap[0][1]].name
    return labels


def breakdown(trace: Trace, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time (summed by name) and the
    idle time summed by what the host was doing at each gap's middle, in
    seconds, ``top`` of each."""
    by_op: Dict[str, float] = {}
    for o in trace.device:
        by_op[o.name[:120]] = by_op.get(o.name[:120], 0.0) + o.end - o.start
    gaps = idle_gaps(trace)
    by_host: Dict[str, float] = {}
    for (a, b), label in zip(gaps, host_activity(
            trace.host, [(a + b) / 2 for a, b in gaps])):
        by_host[label[:120]] = by_host.get(label[:120], 0.0) + b - a

    def ranked(d):
        return [[k, v / 1e6] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": ranked(by_op), "idle_gaps": ranked(by_host)}
