"""Cross-rank merged timeline: ``python -m horovod_tpu_torch.timeline merge``.

Counterpart of ``horovod_tpu/timeline.py`` (the port keeps its own copy).
The engine's C++ writes the traces (``cpp/timeline.cc``): a span per
tensor from negotiation to execution, the autotuner's ``TUNE_TRIAL`` /
``TUNE_COMMIT`` markers, nothing of the Python side (the CUDA staging of a
device tensor is timed by CUDA events, not traced here).

Per-rank Chrome traces (HOROVOD_TIMELINE on rank 0, plus
``<path>.rank<r>`` per worker under HOROVOD_TIMELINE_ALL_RANKS=1) each
carry a ``horovod_meta`` header with the writer's rank, its monotonic
base (the trace's ts=0 instant) and the rendezvous-estimated clock
offset to rank 0.  ``merge`` puts every file's events on ONE rank-0-
aligned time axis::

    rank0_mono_us(event) = ts + mono_base_us + clock_offset_us

remaps pids into disjoint per-rank bands (track labels become
``r<rank>/<tensor>``), and keeps the cross-rank flow ids intact — rank
0's NEGOTIATE commit emits the flow source ("s"), every rank's
execution span the sink ("f"), with the SAME ``"<name>#<epoch>#<n>"``
id, so chrome://tracing (or Perfetto) draws arrows from the
negotiation to each rank's execution.

Usage::

    python -m horovod_tpu_torch.timeline merge tl.json tl.json.rank1 -o merged.json
    python -m horovod_tpu_torch.timeline merge 'tl.json*' -o merged.json
"""

from __future__ import annotations

import argparse
import glob
import json
import sys
from typing import List, Optional, Tuple

__all__ = ["load_trace", "merge_traces", "check_flows", "main"]

#: pid band per input file — tensors per rank stay comfortably below it.
_PID_BAND = 100000


def load_trace(path: str) -> List[dict]:
    """Lenient Chrome-trace reader: accepts the terminated (valid JSON)
    form, the streaming unterminated form (trailing comma, no ``]`` —
    what a crashed or still-running writer leaves), and a rotated file."""
    with open(path, encoding="utf-8", errors="replace") as fh:
        text = fh.read()
    try:
        return json.loads(text)
    except ValueError:
        pass
    events = []
    for line in text.splitlines():
        line = line.strip().rstrip(",")
        if not line.startswith("{"):
            continue
        try:
            events.append(json.loads(line))
        except ValueError:
            continue  # a torn final line from a crash
    return events


def _meta(events: List[dict]) -> Tuple[int, int, int]:
    """(rank, mono_base_us, clock_offset_us) from the horovod_meta
    header; zeros when absent (pre-offset trace: merge still works, the
    tracks just share one unaligned axis)."""
    for e in events:
        if e.get("name") == "horovod_meta" and e.get("ph") == "M":
            a = e.get("args", {})
            return (int(a.get("rank", 0)), int(a.get("mono_base_us", 0)),
                    int(a.get("clock_offset_us", 0)))
    return (0, 0, 0)


def merge_traces(paths: List[str]) -> List[dict]:
    """Merge per-rank traces into one event list on rank 0's clock.

    Offsets shift every file's ts to rank-0 monotonic time, then the
    whole merged axis is rebased so the earliest event sits at ts=0 —
    after alignment no span crosses zero (asserted by the tests)."""
    loaded = []
    for path in paths:
        events = load_trace(path)
        rank, base_us, off_us = _meta(events)
        loaded.append((path, rank, base_us + off_us, events))
    # Distinct pid bands per file, ordered by rank for stable display.
    loaded.sort(key=lambda t: (t[1], t[0]))
    shifts = []
    for _, _, shift, events in loaded:
        ts = [e["ts"] for e in events if "ts" in e]
        if ts:
            shifts.append(shift + min(ts))
    t0 = min(shifts) if shifts else 0
    merged: List[dict] = []
    for idx, (_, rank, shift, events) in enumerate(loaded):
        band = idx * _PID_BAND
        for e in events:
            e = dict(e)
            if e.get("name") == "horovod_meta":
                # Keep one meta per file for provenance, band-tagged.
                e.setdefault("args", {})["pid_band"] = band
            if "ts" in e:
                e["ts"] = e["ts"] + shift - t0
            if "pid" in e:
                e["pid"] = e["pid"] + band
            if (e.get("name") == "process_name" and e.get("ph") == "M"
                    and "args" in e):
                e["args"] = dict(e["args"])
                e["args"]["name"] = f"r{rank}/{e['args'].get('name', '')}"
            merged.append(e)
    merged.sort(key=lambda e: (e.get("ts", -1), e.get("pid", 0)))
    return merged


def check_flows(events: List[dict]) -> Tuple[int, int, List[str]]:
    """(flow sources, flow sinks, sink ids with NO matching source) —
    the merged-trace join the observability tests assert on."""
    sources = {e.get("id") for e in events if e.get("ph") == "s"}
    sinks = [e for e in events if e.get("ph") == "f"]
    unresolved = sorted({str(e.get("id")) for e in sinks
                         if e.get("id") not in sources})
    return (len(sources), len(sinks), unresolved)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.timeline",
        description="Timeline tools (docs/timeline.md): merge the "
                    "engine's per-rank Chrome traces.")
    sub = parser.add_subparsers(dest="cmd", required=True)
    m = sub.add_parser("merge", help="merge per-rank traces into one "
                                     "rank-0-aligned Chrome trace")
    m.add_argument("inputs", nargs="+",
                   help="per-rank timeline files (globs ok): the "
                        "HOROVOD_TIMELINE path + its .rank<r> siblings")
    m.add_argument("-o", "--output", default="merged_timeline.json")
    args = parser.parse_args(argv)

    paths: List[str] = []
    for pattern in args.inputs:
        hits = sorted(glob.glob(pattern))
        paths.extend(hits if hits else [pattern])
    # De-dup while keeping order (a glob often re-matches explicit args).
    seen = set()
    paths = [p for p in paths if not (p in seen or seen.add(p))]
    merged = merge_traces(paths)
    with open(args.output, "w", encoding="utf-8") as fh:
        json.dump(merged, fh)
    nsrc, nsink, unresolved = check_flows(merged)
    print(f"merged {len(paths)} trace(s), {len(merged)} events -> "
          f"{args.output} (flows: {nsrc} sources, {nsink} sinks"
          + (f", {len(unresolved)} UNRESOLVED: {unresolved[:5]}"
             if unresolved else "") + ")")
    return 0 if not unresolved else 2


if __name__ == "__main__":
    sys.exit(main())
