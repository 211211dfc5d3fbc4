"""Worker bodies and world launcher for the port's observability and
tuning tests (``test_torch_port_monitor.py``, ``_timeline.py``,
``_autotune.py``).

The counterpart of ``tests/observability_worker.py`` and
``tests/autotune_worker.py`` on the port's engine and CPU tensors: run as
``python torch_port_obs_worker.py <scenario>`` once per rank, identity in
``HOROVOD_RANK``/``HOROVOD_SIZE``/``HOROVOD_COORDINATOR``.  Scenarios
print machine-readable ``OBS_*`` lines; the cross-rank assertions (fleet
totals against the sum of per-rank stats) live in the tests, which see
every rank's numbers, so no worker runs an extra collective that would
move the counters under test.  A worker imports no JAX (it checks).
"""

import hashlib
import json
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.abspath(__file__)

#: The counters the fleet-sum checks read: stable once the data plane is
#: quiet (idle heartbeats move negotiation bytes, never these).
SUM_KEYS = ("data_bytes_tx", "data_bytes_rx", "allreduce_bytes",
            "tensors", "responses")
#: Telemetry every cycle and a fast heartbeat: a quiet second is then
#: hundreds of chances for the TELEM deltas to reach rank 0.
TELEM_ENV = {"HOROVOD_TELEMETRY_CYCLES": "1", "HOROVOD_CYCLE_TIME": "2"}
_MIB = 262144                # fp32 values in 1 MiB


# ---------------------------------------------------------------------------
# the launcher (test side)
# ---------------------------------------------------------------------------

def start_world(n, scenario, extra_env=None, per_rank_env=None):
    """Start ``n`` ranks of ``scenario``; returns the processes."""
    from horovod_tpu_torch.common.launch import free_port

    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "OMPI_", "PMI_"))}
    env.pop("JAX_PLATFORMS", None)
    env.update(PYTHONPATH=REPO, HOROVOD_SIZE=str(n),
               HOROVOD_COORDINATOR=f"127.0.0.1:{free_port()}",
               HOROVOD_CYCLE_TIME="2")
    env.update(extra_env or {})
    procs = []
    for rank in range(n):
        renv = dict(env, HOROVOD_RANK=str(rank))
        if per_rank_env is not None:
            renv.update(per_rank_env(rank))
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, scenario], env=renv,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    return procs


def finish_world(procs, timeout=150, expected_rc=None):
    """Wait for every rank; returns [(stdout, stderr)] as text.  A rank
    whose exit code is not ``expected_rc.get(rank, 0)`` fails the test."""
    try:
        results = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    out = []
    for rank, (p, (so, se)) in enumerate(zip(procs, results)):
        so, se = so.decode(errors="replace"), se.decode(errors="replace")
        want = (expected_rc or {}).get(rank, 0)
        assert p.returncode == want, (
            f"rank {rank} exited {p.returncode}, expected {want}\n"
            f"stdout: {so[-3000:]}\nstderr: {se[-3000:]}")
        out.append((so, se))
    return out


def run_world(n, scenario, extra_env=None, per_rank_env=None, timeout=150,
              expected_rc=None):
    return finish_world(start_world(n, scenario, extra_env, per_rank_env),
                        timeout, expected_rc)


def parse(results, tag):
    """Every ``<tag> {json}`` line of every rank, in rank order."""
    out = []
    for stdout, _ in results:
        for line in stdout.splitlines():
            if line.startswith(tag + " "):
                out.append(json.loads(line[len(tag) + 1:]))
    return out


# ---------------------------------------------------------------------------
# the worker (rank side)
# ---------------------------------------------------------------------------

def _emit(tag, obj):
    print(f"{tag} {json.dumps(obj)}", flush=True)


def _allreduce(eng, t, name, red_op="sum"):
    return eng.synchronize(eng.enqueue_allreduce(t, name=name,
                                                 red_op=red_op))


def _workload(rank, size, eng, steps=24):
    for i in range(steps):
        n = 256 * (1 + i % 3)
        out = _allreduce(eng, torch.full((n,), float(rank + 1)),
                         f"obs.t{i % 4}")
        assert torch.all(out == size * (size + 1) / 2.0), out[0]


def _quiesce_and_print(eng, rank, before):
    """Barrier, then a quiet 1.2 s in which the TELEM deltas reach rank
    0's table; then this rank's counters, its stats keys, the delta since
    ``before`` beside the hand-taken difference, and (rank 0) the fleet
    table."""
    import horovod_tpu_torch as hvd

    _allreduce(eng, torch.zeros(4), "obs.barrier")
    time.sleep(1.2)
    s = eng.stats()
    d = eng.stats_delta(before)
    rec = {k: s[k] for k in SUM_KEYS}
    rec.update(rank=rank, telem_bytes_tx=s["telem_bytes_tx"],
               keys=sorted(s), config_keys=sorted(s["config"]),
               delta={k: d[k] for k in SUM_KEYS + (
                   "allreduce_ns", "allreduce_bus_bw_bytes_per_sec",
                   "num_channels", "step_time_ns_p50")},
               by_hand={k: s[k] - before.get(k, 0) for k in SUM_KEYS
                        + ("allreduce_ns",)},
               current={k: s[k] for k in ("num_channels",
                                          "step_time_ns_p50")},
               delta_config=d["config"] == s["config"])
    _emit("OBS_STATS", rec)
    if rank == 0:
        _emit("OBS_FULL", s)
        _emit("OBS_FLEET", hvd.fleet_stats())


def scenario_fleet_sums(rank, size, eng):
    before = eng.stats()
    _workload(rank, size, eng)
    _quiesce_and_print(eng, rank, before)


def scenario_scrape_hold(rank, size, eng):
    """As fleet_sums, then every rank holds (a live, idle job) until the
    test, done scraping rank 0's endpoint, creates ``OBS_RELEASE``."""
    scenario_fleet_sums(rank, size, eng)
    deadline = time.monotonic() + 120
    while not os.path.exists(os.environ["OBS_RELEASE"]):
        assert time.monotonic() < deadline, "never released"
        time.sleep(0.05)


def scenario_parity(rank, size, eng):
    """A fixed workload whose results are hashed: telemetry on and off
    must compute the same bits; ``telem_bytes_tx`` shows the off wire
    carries no telemetry."""
    h = hashlib.sha256()
    for i in range(16):
        x = torch.arange(512, dtype=torch.float32) * (rank + 1) + i
        h.update(_allreduce(eng, x, f"par.t{i % 4}").numpy().tobytes())
    for dt in (torch.int64, torch.float64):
        x = (torch.arange(33) + rank).to(dt)
        h.update(_allreduce(eng, x, f"par.{dt}").numpy().tobytes())
    s = eng.stats()
    # A dump on demand: True and a file with HOROVOD_FLIGHT_RECORDER_DIR,
    # False without one.
    dumped = eng.flight_dump("parity check")
    _emit("OBS_PARITY", {"rank": rank, "sum": h.hexdigest(),
                         "telem_bytes_tx": s["telem_bytes_tx"],
                         "telemetry_cycles":
                         s["config"]["telemetry_cycles"],
                         "dumped": dumped,
                         "flight_dumps": eng.stats()["flight_dumps"]})


def scenario_stall(rank, size, eng):
    """Rank 1 withholds ``stall.lonely`` for 3.6 s: the coordinator warns
    (at most once an interval), counts each warning, mirrors it into the
    flight recorder and, past twice the interval, dumps once."""
    if rank != 0:
        time.sleep(3.6)
    handle = eng.enqueue_allreduce(torch.ones(64), name="stall.lonely")
    if rank == 0:
        time.sleep(3.6)
    eng.synchronize(handle)
    s = eng.stats()
    _emit("OBS_STALL", {"rank": rank, "stall_warnings": s["stall_warnings"],
                        "flight_events": s["flight_events"],
                        "flight_dumps": s["flight_dumps"]})


def scenario_timeline_workload(rank, size, eng):
    """Allreduces (cached and fresh), a broadcast and a ragged allgather:
    enough spans and flows for the merged timeline's checks."""
    for i in range(18):
        _allreduce(eng, torch.full((128,), float(rank + 1)), f"tlw.t{i % 3}")
    eng.synchronize(eng.enqueue_broadcast(
        torch.arange(16, dtype=torch.float32) * (rank + 1), 0,
        name="tlw.bcast"))
    eng.synchronize(eng.enqueue_allgather(
        torch.full((rank + 1, 2), float(rank)), name="tlw.gather"))


def scenario_timeline_hook(rank, size, eng):
    """Three steps of the hook-form ``DistributedOptimizer`` on a small
    model: its gradients' allreduces, named after the parameters, are the
    engine's spans in the timeline."""
    from horovod_tpu_torch import torch_frontend

    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.Tanh(),
                                torch.nn.Linear(32, 4))
    torch_frontend.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = torch_frontend.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters())
    gen = torch.Generator().manual_seed(rank)
    for _ in range(3):
        opt.zero_grad()
        model(torch.randn(8, 16, generator=gen)).square().mean().backward()
        opt.step()
    digest = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    _emit("OBS_HOOK", {"rank": rank,
                       "names": [n for n, _ in model.named_parameters()],
                       "params": digest.tolist()})


def scenario_rotate(rank, size, eng):
    """A world of one drives the timeline past HOROVOD_TIMELINE_MAX_MB;
    the newest file must hold the last op."""
    assert size == 1
    for i in range(2600):
        _allreduce(eng, torch.ones(8), f"rotate.{'x' * 40}.{i % 7}")
    _allreduce(eng, torch.ones(8), "rotate.final.marker")


# -- the autotuner ------------------------------------------------------------

def _driven_loop(rank, eng, tuner, max_steps=5000, extra_done=None,
                 exact=True):
    """1 MiB allreduces until rank 0 says stop (its tuner committed, and
    ``extra_done()``); the verdict rides an engine broadcast, so every
    rank leaves on the same step.  Each result is checked: a trial that
    corrupted data fails here."""
    size = eng.size()
    expected = size * (size + 1) / 2.0
    keep, steps = 1, 0
    while keep:
        out = _allreduce(eng, torch.full((_MIB,), float(rank + 1)), "at.t")
        if exact:
            assert torch.all(out == expected), (steps, out[0])
        else:       # a compressed trial: int8's error, ~maxabs/127 a hop
            assert torch.allclose(out, torch.full_like(out, expected),
                                  atol=0.2 * size * size), (steps, out[0])
        steps += 1
        if rank == 0:
            done = (tuner is not None and tuner.converged
                    and (extra_done is None or extra_done()))
            keep = 0 if (done or steps >= max_steps) else 1
        flag = eng.synchronize(eng.enqueue_broadcast(
            torch.tensor([keep], dtype=torch.int8), 0, name="at.ctl"))
        keep = int(flag[0])
    return steps


def _tuner_record(tuner, eng):
    return {"planned": [list(p) for p in tuner.planned],
            "executed": [t["config"] for t in tuner.trace],
            "scores": [t["score"] for t in tuner.trace],
            "committed": tuner.committed, "converged": tuner.converged,
            "num_channels": eng.stats()["config"]["num_channels"],
            "priority_bands": eng.stats()["config"]["priority_bands"]}


def _committed_everywhere(rank, eng, committed):
    """Ship rank 0's committed knobs through the engine and compare them
    with this rank's ``stats()["config"]``."""
    keys = ("chunk_bytes", "fusion_threshold", "cycle_time_ms",
            "wave_width", "algo_threshold")
    payload = torch.zeros(len(keys), dtype=torch.int64)
    if rank == 0:
        payload = torch.tensor([committed.get(k, -1) for k in keys],
                               dtype=torch.int64)
    got = eng.synchronize(eng.enqueue_broadcast(payload, 0,
                                                name="at.committed"))
    cfg = eng.stats()["config"]
    return {k: [cfg[k], int(v)] for k, v in zip(keys, got) if int(v) >= 0}


def scenario_autotune_disabled(rank, size, eng):
    """HOROVOD_AUTOTUNE unset: no tuner thread, no TUNE frame anywhere, the
    env's config, integer collectives bitwise."""
    from horovod_tpu_torch.autotune import get_tuner

    assert get_tuner() is None, "a tuner started with autotune off"
    assert eng.stats()["tune_trials"] == 0
    for i in range(30):
        x = torch.arange(1024, dtype=torch.int64) + rank + i
        out = _allreduce(eng, x, f"off.{i}")
        want = size * torch.arange(1024, dtype=torch.int64) \
            + size * (size - 1) // 2 + size * i
        assert torch.equal(out, want), i
    s = eng.stats()
    _emit("AT_OFF", {"rank": rank, "tune_trials": s["tune_trials"],
                     "config": s["config"]})


def scenario_autotune_live(rank, size, eng):
    """The online search: rank 0's tuner runs its seeded schedule,
    commits, saves the state file (when one is named), and every rank
    holds the committed knobs."""
    from horovod_tpu_torch.autotune import get_tuner

    tuner = get_tuner() if rank == 0 else None
    if rank == 0:
        assert tuner is not None, "HOROVOD_AUTOTUNE=1 started no tuner"
    steps = _driven_loop(rank, eng, tuner)
    rec = {"rank": rank, "steps": steps}
    if rank == 0:
        rec.update(_tuner_record(tuner, eng))
    rec["config_vs_committed"] = _committed_everywhere(
        rank, eng, tuner.committed if rank == 0 else None)
    rec["tune_trials"] = eng.stats()["tune_trials"]
    _emit("AT_LIVE", rec)


def scenario_autotune_warm_restart(rank, size, eng):
    """A world started against the state file commits its config with no
    trial, and every rank holds it."""
    from horovod_tpu_torch.autotune import get_tuner, load_state

    state = load_state(os.environ["HOROVOD_AUTOTUNE_STATE_FILE"])
    assert state is not None
    tuner = get_tuner() if rank == 0 else None
    if rank == 0:
        assert tuner.wait_converged(30), "the warm start did not commit"

    def applied():
        cfg = eng.stats()["config"]
        return all(cfg[k] == v for k, v in state["committed"].items())

    _driven_loop(rank, eng, tuner, max_steps=500,
                 extra_done=applied if rank == 0 else None)
    cfg = eng.stats()["config"]
    _emit("AT_WARM", {"rank": rank, "state": state,
                      "trace": tuner.trace if rank == 0 else None,
                      "applied": applied(),
                      "num_channels": cfg["num_channels"]})


def scenario_autotune_epoch(rank, size, eng):
    """Converge, then shutdown + init in the same processes (a new
    membership epoch, as ``run_elastic`` and a resize take): the new
    tuner re-commits the config with no search."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.autotune import get_tuner

    tuner = get_tuner() if rank == 0 else None
    _driven_loop(rank, eng, tuner)
    committed = dict(tuner.committed) if rank == 0 else None
    trials = len(tuner.trace) if rank == 0 else 0
    epoch0, tt0 = hvd.epoch(), eng.stats()["tune_trials"]
    hvd.shutdown()
    hvd.init(device="cpu")
    t2 = get_tuner() if rank == 0 else None

    def reapplied():
        return t2 is not None and t2.converged and t2.trace == []

    _driven_loop(rank, eng, t2, max_steps=500,
                 extra_done=reapplied if rank == 0 else None)
    rec = {"rank": rank, "epoch": [epoch0, hvd.epoch()],
           "tune_trials": [tt0, eng.stats()["tune_trials"]],
           "stale_epoch_msgs": eng.stats()["stale_epoch_msgs"]}
    if rank == 0:
        rec.update(committed=[committed, t2.committed], trials=trials,
                   trace_after=t2.trace, tuner_epoch=t2.epoch)
    _emit("AT_EPOCH", rec)


def scenario_autotune_wire(rank, size, eng):
    """HOROVOD_AUTOTUNE_WIRE=1 with the sweep cut to ``wire_dtype``: fp32,
    fp16 and int8 are tried, scored, and one is committed; compressed
    trials really ran compressed."""
    from horovod_tpu_torch.autotune import get_tuner

    tuner = get_tuner() if rank == 0 else None
    _driven_loop(rank, eng, tuner, exact=False)
    s = eng.stats()
    compressed = _allreduce(
        eng, torch.tensor([s["wire_fp16_count"] + s["wire_int8_count"]],
                          dtype=torch.int64), "at.wsum")
    rec = {"rank": rank, "compressed": int(compressed[0])}
    if rank == 0:
        rec.update(_tuner_record(tuner, eng))
    _emit("AT_WIRE", rec)


def scenario_startup_probe(rank, size, eng):
    """``startup_probe`` over two wirings on CPU tensors: every rank gets
    rank 0's pick, the env carries it, and the re-wired world reduces
    right."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.autotune import startup_probe

    pick = startup_probe(candidates=[(1, 0), (2, 1)], nbytes=1 << 20,
                         iters=2)
    out = _allreduce(eng, torch.full((1000,), float(rank + 1)), "probe.after")
    _emit("AT_PROBE", {"rank": rank, "pick": pick,
                       "env": [os.environ.get("HOROVOD_NUM_CHANNELS"),
                               os.environ.get("HOROVOD_CHANNEL_DRIVERS")],
                       "num_channels": eng.stats()["config"]["num_channels"],
                       "suspend": os.environ.get("HOROVOD_AUTOTUNE_SUSPEND"),
                       "device": str(hvd.device()),
                       "ok": bool(torch.all(out == size * (size + 1) / 2))})


def main():
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.runtime.engine import get_engine

    scenario = sys.argv[1]
    hvd.init(device="cpu")
    rank, size = hvd.rank(), hvd.size()
    globals()[f"scenario_{scenario}"](rank, size, get_engine())
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "horovod_tpu"))
    assert not bad, bad
    hvd.shutdown()
    print(f"OBS_DONE rank={rank}", flush=True)


if __name__ == "__main__":
    main()
