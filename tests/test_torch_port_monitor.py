"""Port parity: the observability plane (``horovod_tpu_torch/monitor/``,
the binding's ``stats_delta``/``fleet_stats``/``flight_dump``, the stall
inspector and the flight recorder).

* The renderers: ``render_prometheus``, ``render_json``,
  ``format_reference`` and ``format_status`` print, on the same stats,
  fleet and ``"serve"`` dicts, byte for byte what the JAX package's do;
  the metric tables are the reference's and ``TELEM_COUNTERS`` is in
  lockstep with the port's ``cpp/engine.cc``.
* Engine worlds of the port on CPU tensors (``torch_port_obs_worker.py``,
  one process a rank), the counterparts of ``tests/test_observability.py``:
  fleet totals equal the sum of per-rank ``stats()`` at 2 and 4 ranks,
  flat and hierarchical; telemetry off moves no telemetry byte and
  computes the same bits; ``stats()`` keys are a superset of the
  reference's and ``stats_delta`` equals a hand-taken difference; a live
  scrape of rank 0's endpoint and ``run --status`` / ``--raw``; stall
  warnings rate-limited, counted, mirrored and escalated once; after an
  injected death at 4 ranks, the port's postmortem and its CLI give the
  reference's verdict on the same dumps.
"""

import json
import os
import re
import subprocess
import sys
import time
import urllib.request

import pytest

from horovod_tpu.monitor import metrics as jax_metrics
from horovod_tpu.monitor import postmortem as jax_postmortem
from horovod_tpu.monitor import server as jax_server
from horovod_tpu_torch.common.launch import free_port
from horovod_tpu_torch.monitor import metrics, postmortem, server
from tests.torch_port_obs_worker import (REPO, SUM_KEYS, TELEM_ENV, parse,
                                         run_world, start_world, finish_world)


# ---------------------------------------------------------------------------
# the renderers against the reference's, on the same inputs
# ---------------------------------------------------------------------------

def _stats():
    """Every key the renderers read, with distinct values (a float gauge,
    a key no table lists, a config dict the renderers skip)."""
    out = {m.stats_key: 1000 + i for i, m in
           enumerate(metrics.STATS_METRICS)}
    out["alltoall_bus_bw_bytes_per_sec"] = 1.5e9
    out["moe_capacity_factor"] = 1.25
    out["not_in_any_table"] = 7
    out["config"] = {"telemetry_cycles": 1, "num_channels": 4}
    return out


def _fleet():
    counters = {name: 10 * (i + 1) for i, name in
                enumerate(metrics.TELEM_COUNTERS)}
    return {
        "ranks_reporting": 2, "world_size": 4, "hosts": 2, "epoch": 3,
        "telemetry_cycles": 1, "quorum_lag_ns_p50": 1200,
        "quorum_lag_ns_p99": 56000,
        "slowest": {"rank": 3, "step_time_ns_p99": 8_500_000},
        "totals": {k: 2 * v for k, v in counters.items()},
        "quorum_lag_by_rank": {"3": {"attributions": 5, "max_ns": 900},
                               "1": {"attributions": 2, "max_ns": 40}},
        "rows": [{"rank": 0, "host": 0, "nranks": 2, "counters": counters,
                  "step_time_ns_p50": 100, "step_time_ns_p99": 200},
                 {"rank": 2, "host": 1, "nranks": 2, "counters": counters,
                  "step_time_ns_p99": 8_500_000}]}


def _serve():
    out = {m.stats_key: 3 + i for i, m in enumerate(metrics.SERVE_METRICS)}
    out.update(replicas=2, replicas_alive=1, failed=0, rejoins=1,
               alive=True, model="tiny", tokens_per_sec=12.5)
    return out


_CASES = {"full": (_stats, _fleet, lambda: {"serve": _serve()}),
          "empty": (lambda: None, lambda: None, lambda: None),
          "stats_only": (_stats, lambda: {}, lambda: {"serve": {}}),
          "fleet_only": (lambda: {}, _fleet, lambda: None)}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_renderers_match_the_reference_byte_for_byte(case):
    stats, fleet, extra = (f() for f in _CASES[case])
    got = metrics.render_prometheus(stats, fleet, extra)
    assert got == jax_metrics.render_prometheus(stats, fleet, extra)
    assert json.dumps(metrics.render_json(stats, fleet, extra)) == \
        json.dumps(jax_metrics.render_json(stats, fleet, extra))
    payload = metrics.render_json(stats, fleet, extra)
    assert server.format_status(payload) == \
        jax_server.format_status(payload)
    if case == "full":
        assert "# TYPE horovod_stall_warnings_total counter" in got
        assert re.search(r'^horovod_fleet_data_bytes_tx\{rank="2",', got,
                         re.M)
        assert "\nhorovod_serve_replicas_alive 1\n" in got


def test_metric_tables_match_the_reference_and_the_engine():
    """The tables, the docs' reference table, and TELEM_COUNTERS against
    the port's own ``kTelemCounterNames`` (``cpp/engine.cc``; the wire
    carries positions)."""
    assert [tuple(m) for m in metrics.STATS_METRICS] == \
        [tuple(m) for m in jax_metrics.STATS_METRICS]
    assert [tuple(m) for m in metrics.SERVE_METRICS] == \
        [tuple(m) for m in jax_metrics.SERVE_METRICS]
    assert metrics.TELEM_COUNTERS == jax_metrics.TELEM_COUNTERS
    assert metrics.reference_rows() == jax_metrics.reference_rows()
    assert metrics.format_reference() == jax_metrics.format_reference()
    with open(os.path.join(REPO, "horovod_tpu_torch", "cpp",
                           "engine.cc")) as f:
        source = f.read()
    block = re.search(r"kTelemCounterNames\[TC_COUNT\]\s*=\s*\{(.*?)\};",
                      source, re.S).group(1)
    assert re.findall(r'"(\w+)"', block) == metrics.TELEM_COUNTERS


# ---------------------------------------------------------------------------
# engine worlds
# ---------------------------------------------------------------------------

def _assert_fleet_matches(stats, fleet, n):
    assert len(stats) == n and fleet, fleet
    for key in SUM_KEYS:
        want = sum(s[key] for s in stats)
        assert fleet["totals"][key] == want, (key, fleet["totals"][key],
                                              want)
        assert sum(r["counters"][key] for r in fleet["rows"]) == want, key


@pytest.mark.parametrize("n,hier", [(2, False), (4, False), (4, True)])
def test_fleet_totals_equal_the_per_rank_stats(n, hier):
    """Quiet fleet totals == Σ per-rank ``stats()``; hierarchical: two
    fake hosts, one row per host of 2 ranks.  At 2 ranks also: the port's
    ``stats()`` keys are a superset of the reference's (this process's
    JAX engine), ``stats_delta`` equals the hand-taken difference and
    carries the gauges, and the real payload renders as the reference
    renders it."""
    env = dict(TELEM_ENV)
    per_rank = None
    if hier:
        env["HOROVOD_HIERARCHICAL_COORDINATOR"] = "1"
        per_rank = lambda r: {"HOROVOD_HOST_KEY": f"fakehost{r // 2}"}  # noqa: E731
    results = run_world(n, "fleet_sums", env, per_rank)
    stats = parse(results, "OBS_STATS")
    fleet = parse(results, "OBS_FLEET")[0]
    _assert_fleet_matches(stats, fleet, n)
    if hier:
        assert fleet["ranks_reporting"] == 2
        assert sorted(r["nranks"] for r in fleet["rows"]) == [2, 2]
        return
    assert fleet["ranks_reporting"] == n
    assert sum(s["telem_bytes_tx"] for s in stats if s["rank"]) > 0
    if n != 2:
        return
    from horovod_tpu.runtime.engine import get_engine as jax_engine

    ref = jax_engine().stats()
    for s in stats:
        assert set(ref) <= set(s["keys"]), set(ref) - set(s["keys"])
        assert set(ref["config"]) <= set(s["config_keys"])
        for key, want in s["by_hand"].items():
            assert s["delta"][key] == want, key
        for key, now in s["current"].items():
            assert s["delta"][key] == now, key
        assert s["delta_config"]
        d = s["delta"]
        assert d["allreduce_bus_bw_bytes_per_sec"] == pytest.approx(
            d["allreduce_bytes"] * 2.0 * (n - 1) / n
            / (d["allreduce_ns"] / 1e9), rel=1e-12)
    full = parse(results, "OBS_FULL")[0]
    assert metrics.render_prometheus(full, fleet) == \
        jax_metrics.render_prometheus(full, fleet)
    payload = {"stats": full, "fleet": fleet}
    assert server.format_status(payload) == jax_server.format_status(payload)


def test_telemetry_off_moves_no_bytes_and_changes_no_bits(tmp_path):
    """``HOROVOD_TELEMETRY_CYCLES=0``: no telemetry byte, and the same
    result bits as telemetry on.  ``flight_dump`` on demand writes its
    file under ``HOROVOD_FLIGHT_RECORDER_DIR`` and returns False without
    one."""
    on = start_world(2, "parity", dict(
        TELEM_ENV, HOROVOD_FLIGHT_RECORDER_DIR=str(tmp_path)))
    off = start_world(2, "parity", dict(TELEM_ENV,
                                        HOROVOD_TELEMETRY_CYCLES="0"))
    ron = {r["rank"]: r for r in parse(finish_world(on), "OBS_PARITY")}
    roff = {r["rank"]: r for r in parse(finish_world(off), "OBS_PARITY")}
    for rank in (0, 1):
        assert ron[rank]["sum"] == roff[rank]["sum"]
        assert roff[rank]["telem_bytes_tx"] == 0
        assert roff[rank]["telemetry_cycles"] == 0
        assert ron[rank]["dumped"] and ron[rank]["flight_dumps"] == 1
        assert not roff[rank]["dumped"] and roff[rank]["flight_dumps"] == 0
        dump = json.loads((tmp_path / f"flightrec.rank{rank}.json")
                          .read_text())
        assert dump["reason"] == "parity check" and dump["rank"] == rank
    assert ron[1]["telem_bytes_tx"] > 0


def test_live_scrape_and_run_status_round_trip(tmp_path):
    """A 2-rank job holding after its workload: rank 0's ``/json`` and
    ``/metrics`` equal Σ per-rank ``stats()``, with the stall counter's
    TYPE line and the per-rank series; ``run --status`` and ``--raw``
    read the same endpoint."""
    mport = free_port()
    release = tmp_path / "release"
    procs = start_world(2, "scrape_hold",
                        dict(TELEM_ENV, OBS_RELEASE=str(release)),
                        lambda r: {"HOROVOD_METRICS_PORT": str(mport)}
                        if r == 0 else {})
    payload = prom = None
    try:
        deadline = time.time() + 60
        while time.time() < deadline:
            time.sleep(0.3)
            try:
                payload = server.query_status(f"127.0.0.1:{mport}", 3)
                if payload["fleet"].get("totals", {}).get("tensors", 0) \
                        >= 2 * 25:
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{mport}/metrics",
                            timeout=3) as resp:
                        prom = resp.read().decode()
                    break
            except (OSError, ValueError):
                continue
        assert prom is not None, "the endpoint never served a quiet fleet"
        cli = [sys.executable, "-m", "horovod_tpu_torch.run", "--status",
               f"127.0.0.1:{mport}"]
        env = dict(os.environ, PYTHONPATH=REPO)
        text = subprocess.run(cli, env=env, capture_output=True, text=True,
                              timeout=60)
        raw = subprocess.run(cli + ["--raw"], env=env, capture_output=True,
                             text=True, timeout=60)
    finally:
        release.write_text("done")
        results = finish_world(procs)
    stats = parse(results, "OBS_STATS")
    for key in SUM_KEYS:
        assert payload["fleet"]["totals"][key] == sum(s[key] for s in stats)
    m = re.search(r"^horovod_fleet_data_bytes_tx_total (\d+)$", prom, re.M)
    assert m and int(m.group(1)) == sum(s["data_bytes_tx"] for s in stats)
    assert "# TYPE horovod_stall_warnings_total counter" in prom
    assert re.search(r'^horovod_fleet_data_bytes_tx\{rank="1",', prom, re.M)
    assert text.returncode == 0, text.stderr
    assert "ranks reporting 2" in text.stdout and "row rank 1" in text.stdout
    assert raw.returncode == 0, raw.stderr
    got = json.loads(raw.stdout)
    for key in SUM_KEYS:
        assert got["fleet"]["totals"][key] == payload["fleet"]["totals"][key]


def test_stall_warnings_rate_limited_counted_mirrored_escalated(tmp_path):
    """The counterpart of ``tests/test_observability.py:301`` on the port:
    rank 1 withholds a tensor 3.6 s under ``HOROVOD_STALL_WARNING_SEC=1``;
    rank 0 warns 1-5 times, counts and mirrors each warning, and dumps
    once, with ``escalation`` in the reason."""
    results = run_world(2, "stall", dict(
        TELEM_ENV, HOROVOD_STALL_WARNING_SEC="1",
        HOROVOD_FLIGHT_RECORDER_DIR=str(tmp_path)), timeout=120)
    recs = {r["rank"]: r for r in parse(results, "OBS_STALL")}
    assert 1 <= recs[0]["stall_warnings"] <= 5, recs[0]
    assert recs[0]["flight_events"] > 0
    assert recs[0]["flight_dumps"] >= 1, "no escalation dump"
    assert results[0][1].count("stall.lonely") <= 5
    dump = json.loads((tmp_path / "flightrec.rank0.json").read_text())
    assert any(e["kind"] == "stall" and "stall.lonely" in e["text"]
               for e in dump["events"])
    assert "escalation" in dump["reason"]


def test_postmortem_after_an_injected_death_gives_the_references_verdict(
        tmp_path):
    """Rank 2 of 4 exits at its 7th enqueue: every survivor dumps; the
    port's ``analyze``/``format_report`` equal the reference's on the same
    dumps, name rank 2 and a last committed cycle >= 1, and the CLI
    prints the same report."""
    run_world(4, "fleet_sums", dict(
        TELEM_ENV, HOROVOD_FAULT_INJECT="2:7:exit",
        HOROVOD_FAULT_TIMEOUT_SEC="6",
        HOROVOD_FLIGHT_RECORDER_DIR=str(tmp_path)),
        expected_rc={0: 1, 1: 1, 2: 41, 3: 1})
    assert sorted(p.name for p in tmp_path.glob("flightrec.rank*.json")) \
        == ["flightrec.rank0.json", "flightrec.rank1.json",
            "flightrec.rank3.json"]
    dumps = postmortem.load_dumps(str(tmp_path))
    assert dumps == jax_postmortem.load_dumps(str(tmp_path))
    got = postmortem.analyze(dumps, world_size=4)
    want = jax_postmortem.analyze(dumps, world_size=4)
    assert got == want
    assert got["culprit"] == 2 and got["missing_ranks"] == [2]
    assert got["last_committed_cycle"] >= 1
    report = postmortem.format_report(got)
    assert report == jax_postmortem.format_report(want)
    assert "rank 2 is the culprit" in report
    cli = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.monitor.postmortem",
         str(tmp_path), "--world-size", "4"], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=60)
    assert cli.returncode == 0, cli.stderr
    assert cli.stdout == report + "\n"


@pytest.fixture
def world_of_one(monkeypatch):
    from horovod_tpu_torch.common import basics

    for name in (basics._RANK_ENV + basics._SIZE_ENV + basics._LOCAL_RANK_ENV
                 + basics._LOCAL_SIZE_ENV + ("HOROVOD_COORDINATOR",
                                             "HOROVOD_AUTOTUNE")):
        monkeypatch.delenv(name, raising=False)
    yield monkeypatch
    import horovod_tpu_torch as hvd
    hvd.shutdown()


def test_endpoint_starts_with_init_and_a_busy_port_only_disables_it(
        world_of_one, capfd):
    """``hvd.init`` on rank 0 serves the endpoint on
    ``HOROVOD_METRICS_PORT`` and ``shutdown`` stops it; a port already
    taken costs the endpoint, with a message, and ``init`` succeeds."""
    import socket

    import horovod_tpu_torch as hvd

    port = free_port()
    world_of_one.setenv("HOROVOD_METRICS_PORT", str(port))
    hvd.init(device="cpu")
    assert server.get_metrics_server() is not None
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                timeout=5) as resp:
        assert resp.read() == b"ok\n"
    assert server.query_status(f"127.0.0.1:{port}")["stats"]["tensors"] == 0
    hvd.shutdown()
    assert server.get_metrics_server() is None
    with socket.socket() as busy:
        busy.bind(("0.0.0.0", 0))
        busy.listen()
        world_of_one.setenv("HOROVOD_METRICS_PORT",
                            str(busy.getsockname()[1]))
        hvd.init(device="cpu")
        assert hvd.is_initialized()
        assert server.get_metrics_server() is None
        assert "metrics endpoint disabled" in capfd.readouterr().err
