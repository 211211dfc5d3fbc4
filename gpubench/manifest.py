"""``BENCHMARK.json`` and the files its names lead to.

A workload names a configuration (``configs``' ``file``), a traffic mix
(``gpubench/traffic/<traffic>.json``) and, through its own name, the
limits of its check (``gpubench/limits/<workload>.json``).  Its metrics
are the ``end_to_end`` and ``per_layer`` entries that list it, or list no
workload at all.
"""

from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[str]
    per_layer: List[str]
    units: Dict[str, str]


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _listed(entry: dict, workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


def cell(manifest: dict, name: str, root: Path = ROOT) -> Cell:
    work = {w["name"]: w for w in manifest["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have "
                       f"{sorted(work)})")
    w = work[name]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    limits = json.loads((HERE / "limits" / f"{name}.json").read_text())
    return Cell(
        name=name, chips=int(w["chips"]),
        config=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads(
            (HERE / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=limits["limits"],
        end_to_end=[m["name"] for m in manifest["end_to_end"]
                    if _listed(m, name)],
        per_layer=[m["name"] for m in manifest["per_layer"]
                   if _listed(m, name)],
        units={m["name"]: m["unit"]
               for m in manifest["end_to_end"] + manifest["per_layer"]})


def problems(manifest: dict) -> List[str]:
    """Names, units and references of ``manifest`` that break the
    benchmark's rules (empty when it keeps them)."""
    out = []
    metrics = manifest["end_to_end"] + manifest["per_layer"]
    named = (manifest["configs"] + manifest["workloads"] + metrics)
    for entry in named:
        if not NAME.match(entry["name"]):
            out.append(f"bad name {entry['name']!r}")
    for w in manifest["workloads"]:
        for key in ("config", "traffic"):
            if not NAME.match(w[key]):
                out.append(f"bad {key} {w[key]!r} in {w['name']}")
    for c in manifest["configs"]:
        out += [f"bad reduced key {k!r}" for k in c["reduced"]
                if not NAME.match(k)]
    for m in metrics:
        if not UNIT.match(m["unit"]):
            out.append(f"bad unit {m['unit']!r} of {m['name']}")
        if m["better"] not in ("lower", "higher"):
            out.append(f"bad better of {m['name']}")
    for kind in ("configs", "workloads"):
        names = [e["name"] for e in manifest[kind]]
        if len(set(names)) != len(names):
            out.append(f"duplicate {kind} names")
    names = [m["name"] for m in metrics]
    if len(set(names)) != len(names):
        out.append("duplicate metric names")
    return out
