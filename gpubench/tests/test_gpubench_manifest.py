"""``BENCHMARK.json`` against the benchmark's rules, and every name in it
leading to its files."""

import importlib
import json
import math
import re
from pathlib import Path

import pytest

from gpubench import manifest, metrics

M = manifest.load()
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def test_names_and_units_keep_the_charset():
    assert manifest.problems(M) == []


@pytest.mark.parametrize("bad", ["has space", "slash/name", "a,b", "",
                                 "µs", "x" * 65])
def test_bad_names_are_found(bad):
    broken = json.loads(json.dumps(M))
    broken["workloads"][0]["name"] = bad
    assert manifest.problems(broken)


def test_bad_unit_is_found():
    broken = json.loads(json.dumps(M))
    broken["end_to_end"][0]["unit"] = "tokens per second"
    assert manifest.problems(broken)


def test_shape_of_the_file():
    assert set(M) == TOP
    assert len(json.dumps(M)) < 64 * 1024
    assert 1 <= M["run_seconds"] <= 51 and M["run_seconds"] == int(
        M["run_seconds"])
    for p in M["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
    assert len(M["command"]) <= 32
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in M["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in M["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    four = [w for w in M["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(M["workloads"]) // 4)
    assert all(w["chips"] in (1, 4) for w in M["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert all(len(w["why"]) <= 200 for w in M["workloads"])


def test_check_time_fits():
    cells, rs = 24, M["run_seconds"]
    assert (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("w", [w["name"] for w in M["workloads"]])
def test_every_name_leads_to_its_files(w):
    cell = manifest.cell(M, w)
    importlib.import_module(f"gpubench.families.{cell.config['family']}")
    importlib.import_module(f"gpubench.reference.{cell.config['reference']}")
    for name in cell.end_to_end + cell.per_layer:
        assert callable(importlib.import_module(
            metrics.module_name(name)).read)
    assert cell.limits and all(math.isfinite(v) for v in
                               cell.limits.values())
    assert "window_nonfinite" in cell.limits
    e2e = {m["name"] for m in M["end_to_end"]}
    assert e2e <= set(cell.end_to_end)
    assert cell.per_layer


def test_config_files_lie_under_paths():
    files = [c["file"] for c in M["configs"]]
    assert len(set(files)) == len(files)
    for f in files:
        assert any(f.startswith(p + "/") for p in M["paths"])
        assert (manifest.ROOT / f).is_file()


def test_per_layer_metrics_list_cells_that_report_what_they_move():
    work = {w["name"] for w in M["workloads"]}
    for m in M["per_layer"]:
        assert set(m.get("workloads", work)) <= work
