"""Flight-recorder post-mortem: cross-correlate per-rank dumps.

Counterpart of ``horovod_tpu/monitor/postmortem.py``.  The dumps are the
engine's (``cpp/flightrec.cc``); the Python planes add their events
through ``runtime.engine.flight_note`` (checkpoint begin, commit and
restore; elastic recoveries).

Usage::

    python -m horovod_tpu_torch.monitor.postmortem <HOROVOD_FLIGHT_RECORDER_DIR>
    python -m horovod_tpu_torch.monitor.postmortem dir/ --tail 80

Each surviving rank dumps ``flightrec.rank<r>.json`` on abort,
stall-warning escalation, and fatal signals (a crashed culprit leaves no
dump — its absence is itself evidence).  This tool merges the per-rank
event rings onto rank 0's clock (each dump carries the rendezvous
clock offset), votes a CULPRIT out of the abort verdicts, reports every
rank's last committed control cycle, and prints the merged tail so the
cycles LEADING INTO the failure are readable in one place.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
from typing import Dict, List, Optional, Tuple

__all__ = ["load_dumps", "analyze", "format_report", "main"]


def load_dumps(path: str) -> Dict[int, dict]:
    """dir (or a glob of dump files) → {rank: dump dict}."""
    if os.path.isdir(path):
        files = sorted(glob.glob(os.path.join(path, "flightrec.rank*.json")))
    else:
        files = sorted(glob.glob(path))
    dumps: Dict[int, dict] = {}
    for f in files:
        try:
            with open(f, encoding="utf-8", errors="replace") as fh:
                d = json.load(fh)
        except (OSError, ValueError) as exc:
            print(f"postmortem: skipping unreadable dump {f}: {exc}",
                  file=sys.stderr)
            continue
        dumps[int(d.get("rank", -1))] = d
    return dumps


_RANK_RE = re.compile(r"(?:rank|culprit=)\s*(\d+)")


def analyze(dumps: Dict[int, dict], world_size: Optional[int] = None) -> dict:
    """The cross-rank verdict: culprit vote, per-rank last cycles, the
    fleet's last fully-committed cycle, and the aligned merged events."""
    votes: Dict[int, int] = {}
    verdicts: List[str] = []
    last_cycle: Dict[int, int] = {}
    # Link-heal history per rank: (suspects, healed, escalated).  A world
    # that "flapped then died" reads differently from one that just died —
    # suspect/healed events before the abort say the link was unstable
    # long before the fatal failure.
    link_events: Dict[int, Dict[str, int]] = {}
    # Checkpoint history per rank, from the weight plane's begin/commit/
    # restore notes: the "died at step S, last durable step C" readout.
    ckpt_events: Dict[int, Dict[str, int]] = {}
    ckpt_step_re = re.compile(r"step=(\d+)")
    merged: List[Tuple[int, int, dict]] = []  # (aligned_ns, rank, event)
    for rank, d in sorted(dumps.items()):
        offset = int(d.get("clock_offset_ns", 0))
        for e in d.get("events", []):
            merged.append((int(e.get("mono_ns", 0)) + offset, rank, e))
            if e.get("kind") == "cycle":
                last_cycle[rank] = max(last_cycle.get(rank, 0),
                                       int(e.get("cycle", 0)))
            if e.get("kind") == "link":
                text = e.get("text", "")
                lk = link_events.setdefault(
                    rank, {"suspect": 0, "healed": 0, "escalate": 0})
                for key in lk:
                    if text.startswith(key):
                        lk[key] += 1
            if e.get("kind") == "ckpt":
                text = e.get("text", "")
                m = ckpt_step_re.search(text)
                if m:
                    s = int(m.group(1))
                    ck = ckpt_events.setdefault(
                        rank, {"last_attempt": -1, "last_durable": -1,
                               "restores": 0})
                    if text.startswith("commit"):
                        ck["last_durable"] = max(ck["last_durable"], s)
                        ck["last_attempt"] = max(ck["last_attempt"], s)
                    elif text.startswith("begin"):
                        ck["last_attempt"] = max(ck["last_attempt"], s)
                    elif text.startswith("restore"):
                        ck["restores"] += 1
            if e.get("kind") == "abort":
                text = e.get("text", "")
                verdicts.append(f"rank {rank}: {text}")
                m = _RANK_RE.search(text)
                if m:
                    c = int(m.group(1))
                    if c != rank:  # a verdict never blames its reporter
                        votes[c] = votes.get(c, 0) + 1
        reason = d.get("reason", "")
        if reason:
            m = _RANK_RE.search(reason)
            if m and int(m.group(1)) != rank:
                votes[int(m.group(1))] = votes.get(int(m.group(1)), 0) + 1
    merged.sort(key=lambda t: (t[0], t[1]))
    culprit = max(votes, key=votes.get) if votes else None
    # A rank missing from the dumps while every survivor aborted is the
    # classic crashed-culprit signature; corroborate the vote with it.
    missing = []
    if world_size:
        missing = [r for r in range(world_size) if r not in dumps]
        if culprit is None and len(missing) == 1:
            culprit = missing[0]
    return {
        "ranks": sorted(dumps.keys()),
        "missing_ranks": missing,
        "culprit": culprit,
        "votes": votes,
        "verdicts": verdicts,
        "last_cycle": last_cycle,
        # The last cycle EVERY reporting rank committed: the fleet's
        # last consistent control-plane state — the divergence point is
        # right after it.
        "last_committed_cycle": min(last_cycle.values()) if last_cycle
        else 0,
        "link_events": link_events,
        "ckpt_events": ckpt_events,
        "merged": merged,
    }


def format_report(result: dict, tail: int = 60) -> str:
    lines = [f"flight-recorder post-mortem: {len(result['ranks'])} dump(s) "
             f"from rank(s) {result['ranks']}"]
    if result["missing_ranks"]:
        lines.append(f"no dump from rank(s) {result['missing_ranks']} — "
                     "a crashed process leaves none (evidence, not error)")
    if result["culprit"] is not None:
        nvotes = result["votes"].get(result["culprit"], 0)
        lines.append(
            f"verdict: rank {result['culprit']} is the culprit "
            f"({nvotes} abort verdict(s) name it"
            + (", and it left no dump)" if result["culprit"]
               in result["missing_ranks"] else ")"))
    else:
        lines.append("verdict: no culprit named (no abort verdicts in "
                     "the dumps — stall escalation or manual dump?)")
    for v in result["verdicts"][:8]:
        lines.append(f"  verdict · {v}")
    link = result.get("link_events") or {}
    if link:
        healed = sum(v["healed"] for v in link.values())
        escal = sum(v["escalate"] for v in link.values())
        per_link = ", ".join(
            f"rank {r}: {v['suspect']} suspect / {v['healed']} healed / "
            f"{v['escalate']} escalated" for r, v in sorted(link.items()))
        lines.append(
            ("link health: the world FLAPPED before it died — " if healed
             else "link health: ") + per_link +
            ("; the fatal failure followed earlier healed blips"
             if healed and (escal or result["culprit"] is not None)
             else ""))
    ckpt = result.get("ckpt_events") or {}
    if ckpt:
        durable = max((v["last_durable"] for v in ckpt.values()),
                      default=-1)
        attempt = max((v["last_attempt"] for v in ckpt.values()),
                      default=-1)
        if durable >= 0:
            died = (f"died at step {attempt}" if attempt > durable
                    else f"died at or after step {durable}")
            lines.append(
                f"checkpoint: {died}, last durable step {durable} — a "
                f"relaunch resumes from {durable}; work after it is "
                "recomputed, never torn")
        elif attempt >= 0:
            lines.append(
                f"checkpoint: died at step {attempt} with NO durable "
                "commit — the write began but the commit barrier never "
                "passed (previous manifest, if any, stays authoritative)")
        restores = sum(v["restores"] for v in ckpt.values())
        if restores:
            lines.append(f"checkpoint: {restores} restore(s) recorded "
                         "before the failure (an earlier incarnation "
                         "already recovered once)")
    per = ", ".join(f"rank {r}={c}" for r, c in
                    sorted(result["last_cycle"].items()))
    lines.append(
        f"last committed control cycle: {result['last_committed_cycle']} "
        f"fleet-wide ({per}); divergence begins after it")
    lines.append(f"merged tail (aligned to rank 0's clock, last {tail} "
                 "events):")
    events = result["merged"][-tail:]
    t0 = events[0][0] if events else 0
    for t, rank, e in events:
        lines.append(
            f"  +{(t - t0) / 1e6:10.3f}ms rank {rank} cycle "
            f"{e.get('cycle', 0):>5} {e.get('kind', '?'):<8} "
            f"{e.get('text', '')}")
    return "\n".join(lines)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.monitor.postmortem",
        description="Cross-correlate per-rank flight-recorder dumps and "
                    "name the divergence point.")
    parser.add_argument("path", help="HOROVOD_FLIGHT_RECORDER_DIR (or a "
                                     "glob of flightrec.rank*.json files)")
    parser.add_argument("--world-size", type=int, default=None,
                        help="expected world size (missing dumps then "
                             "corroborate the culprit vote)")
    parser.add_argument("--tail", type=int, default=60,
                        help="merged events to print (default 60)")
    args = parser.parse_args(argv)
    dumps = load_dumps(args.path)
    if not dumps:
        print(f"postmortem: no flightrec.rank*.json dumps under "
              f"{args.path}", file=sys.stderr)
        return 1
    result = analyze(dumps, world_size=args.world_size)
    try:
        print(format_report(result, tail=args.tail))
    except BrokenPipeError:
        return 0  # `... | head` closed the pipe; the report was served
    return 0


if __name__ == "__main__":
    sys.exit(main())
