"""Port parity: the multi-replica serving fleet on the CPU.

The port's ``python -m horovod_tpu_torch.run --serve --device cpu`` stack
(router process + replica subprocesses), driven over TCP on the
reference's ``FLEET_ENV`` geometry (``tests/test_serve_fleet.py``) in
fp32, mirroring that file's cases: two replicas serve and balance; a
replica death requeues every request it owed; a wedged replica is
probed, killed and requeued; a transient link reset heals without a
requeue; with no budget left and every replica dead, clients get a clean
error.  Every stream equals the port's offline ``generate`` over the
replicas' seeded weights, and that ``generate`` is itself held to JAX's
``jit(generate)`` over the same weights (``params_to_jax``).  Then
``bench_serve --gate`` and ``--prefix-gate`` on the CPU.

Each fleet runs in a process group of its own, under a hard timeout, and
is killed as a group in ``finally``.
"""

import functools
import json
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu.models.generation import generate as jax_generate
from horovod_tpu.serve.config import ServeConfig as JaxServeConfig
from horovod_tpu.serve.engine import build_model_config as jax_model_config
from horovod_tpu_torch import bench_serve
from horovod_tpu_torch.models.convert import params_to_jax
from horovod_tpu_torch.models.generation import generate
from horovod_tpu_torch.serve.config import ServeConfig
from horovod_tpu_torch.serve.engine import ModelRunner
from horovod_tpu_torch.serve.server import ServeClient

#: The reference's fleet geometry, in fp32 so the port's greedy streams
#: are token-identical to JAX's.
FLEET_ENV = {
    "HOROVOD_SERVE_BLOCK_SIZE": "4",
    "HOROVOD_SERVE_MAX_MODEL_LEN": "64",
    "HOROVOD_SERVE_MAX_BATCH": "4",
    "HOROVOD_SERVE_DTYPE": "float32",
}
FLEET_TIMEOUT = 120      # seconds a fleet's requests may take in all


@pytest.fixture(scope="module")
def offline():
    """``(prompt, n) -> tokens``: the port's offline ``generate`` over the
    weights every replica derives (param seed 0) at the serving cache
    length, each answer first held to JAX's ``jit(generate)`` over the
    same weights."""
    runner = ModelRunner(ServeConfig.from_env(FLEET_ENV), device="cpu")
    jcfg = jax_model_config(JaxServeConfig.from_env(FLEET_ENV))
    variables = params_to_jax(runner.model.state_dict(), runner.model_cfg)
    fns, done = {}, {}

    def gen(prompt, n):
        key = (tuple(prompt), n)
        if key in done:
            return done[key]
        ids = torch.tensor([prompt], dtype=torch.long)
        ours = generate(runner.model, ids, max_new_tokens=n,
                        cache_len=runner.cache_len)[0].numpy()
        if n not in fns:
            fns[n] = jax.jit(functools.partial(
                jax_generate, jcfg, max_new_tokens=n,
                cache_len=runner.cache_len))
        theirs = np.asarray(fns[n](variables, jnp.asarray(
            np.asarray(prompt, np.int32)[None])))[0]
        np.testing.assert_array_equal(ours, theirs)
        done[key] = ours
        return ours

    return gen


class _Fleet:
    """A port fleet on the CPU, in its own process group."""

    def __init__(self, replicas, restart=0, extra_env=None):
        self.proc, self.port, self.log = bench_serve.start_fleet(
            replicas, device="cpu", env=dict(FLEET_ENV, **(extra_env or {})),
            restart=restart, timeout=FLEET_TIMEOUT)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        bench_serve.kill_fleet(self.proc)

    def client(self):
        return ServeClient("127.0.0.1", self.port, timeout=FLEET_TIMEOUT)

    def stop(self, cli):
        """Shut the fleet down through the client; the router's exit
        code."""
        return bench_serve.stop_fleet(self.proc, cli, timeout=60)

    def tail(self):
        return "".join(self.log[-30:])


#: One prompt set for every fleet (the reference's draw of seed 11): the
#: offline references, and JAX's compiles (one per prompt length), are
#: shared across the tests.
_rng = np.random.default_rng(11)
PROMPTS = [_rng.integers(0, 512, int(_rng.integers(3, 12))).tolist()
           for _ in range(8)]
NEW_TOKENS = 20


def _run_jobs(cli, prompts, max_tokens):
    for i, prompt in enumerate(prompts):
        cli.start_generate(f"job{i}", prompt, max_tokens=max_tokens)
    return {f"job{i}": cli.collect(f"job{i}", timeout=FLEET_TIMEOUT)
            for i in range(len(prompts))}


def _check_streams(results, prompts, n, offline, log):
    """Every job done with exactly its offline tokens, and the token
    events since the last (re)start spell them; returns how many streams
    were requeued."""
    requeued = 0
    for i, prompt in enumerate(prompts):
        evs = results[f"job{i}"]
        assert evs[-1]["event"] == "done", f"job{i} dropped: {evs[-1]}\n{log}"
        assert len(evs[-1]["tokens"]) == n
        np.testing.assert_array_equal(np.asarray(evs[-1]["tokens"]),
                                      offline(prompt, n))
        tail = [e["token"] for e in evs if e["event"] == "token"][-n:]
        assert tail == evs[-1]["tokens"], f"job{i} stream gap"
        requeued += any(e["event"] == "requeued" for e in evs)
    return requeued


def test_two_replica_fleet_serves_and_balances(offline):
    """2 replicas, 8 concurrent requests: all complete with the offline
    tokens, both replicas take load, batching overlaps, clean exit."""
    with _Fleet(replicas=2) as fleet:
        cli = fleet.client()
        prompts = PROMPTS
        results = _run_jobs(cli, prompts, max_tokens=NEW_TOKENS)
        assert _check_streams(results, prompts, NEW_TOKENS, offline,
                              fleet.tail()) == 0
        stats = cli.stats()
        assert stats["router"]["completed"] == 8
        assert stats["router"]["requeued"] == 0
        per_replica = [r.get("scheduler", {}).get("requests_completed", 0)
                       for r in stats["replicas"]]
        assert all(n > 0 for n in per_replica), \
            f"load not balanced: {per_replica}"
        assert any(r.get("scheduler", {}).get("batch_occupancy", 0) > 1.0
                   for r in stats["replicas"])
        cli.ping()
        # A live weight push fans out to both replicas (an empty tree:
        # the epoch moves, the weights stay).
        ack = cli.push_weights([], epoch=1, timeout=60)
        assert ack["event"] == "weights_ack" and ack["epoch"] == 1
        assert sorted((r["replica"], r["applied"], r["epoch"])
                      for r in ack["replicas"]) == [(0, True, 1),
                                                    (1, True, 1)]
        stats = cli.stats()
        assert stats["router"]["weight_pushes"] == 1
        assert [r["scheduler"]["weight_epoch"]
                for r in stats["replicas"]] == [1, 1]
        assert fleet.stop(cli) == 0, fleet.tail()


def test_replica_death_requeues_all_requests(offline):
    """Replica 1 exits at its 4th decode step: every request it owed is
    requeued onto replica 0 and completes with the exact offline tokens;
    the supervisor relaunches it (restart budget spent)."""
    with _Fleet(replicas=2, restart=2,
                extra_env={"HOROVOD_FAULT_INJECT": "1:4:exit"}) as fleet:
        cli = fleet.client()
        prompts = PROMPTS
        results = _run_jobs(cli, prompts, max_tokens=NEW_TOKENS)
        requeued = _check_streams(results, prompts, NEW_TOKENS, offline,
                                  fleet.tail())
        assert requeued > 0, "fault fired but nothing requeued"
        stats = cli.stats()
        assert stats["router"]["completed"] == 8
        assert stats["router"]["requeued"] >= requeued
        assert stats["router"]["replica_deaths"] == 1
        assert stats["router"]["restarts_left"] < 2
        assert fleet.stop(cli) == 0, fleet.tail()


def test_wedged_replica_probed_killed_and_requeued(offline):
    """Replica 1's scheduler thread hangs at decode step 4 behind a live
    socket: the probe sees the stale heartbeat, kills it, and its
    requests complete on the survivor with the offline tokens."""
    with _Fleet(replicas=2, restart=2,
                extra_env={"HOROVOD_FAULT_INJECT": "1:4:hang",
                           "HOROVOD_SERVE_PROBE_SEC": "1",
                           "HOROVOD_SERVE_PROBE_DEADLINE_SEC": "4"}) \
            as fleet:
        cli = fleet.client()
        prompts = PROMPTS
        results = _run_jobs(cli, prompts, max_tokens=NEW_TOKENS)
        requeued = _check_streams(results, prompts, NEW_TOKENS, offline,
                                  fleet.tail())
        assert requeued > 0, "hang fired but nothing requeued\n" + \
            fleet.tail()
        stats = cli.stats()
        assert stats["router"]["completed"] == 8
        assert stats["router"]["wedged_kills"] >= 1, stats["router"]
        assert stats["router"]["replica_deaths"] >= 1, stats["router"]
        assert stats["router"]["restarts_left"] < 2, stats["router"]
        assert any("is wedged" in line for line in fleet.log), fleet.tail()
        assert fleet.stop(cli) == 0, fleet.tail()


def test_transient_link_reset_heals_without_requeue(offline):
    """Replica 1 resets its connections once at decode step 4 and keeps
    serving: the router reattaches to the parked session, the replayed
    events close the gap, and no stream is requeued."""
    with _Fleet(replicas=2, restart=2,
                extra_env={"HOROVOD_FAULT_INJECT": "1:4:conn-reset",
                           "HOROVOD_SERVE_LINK_RETRIES": "2"}) as fleet:
        cli = fleet.client()
        prompts = PROMPTS
        results = _run_jobs(cli, prompts, max_tokens=NEW_TOKENS)
        for i in range(len(prompts)):
            evs = results[f"job{i}"]
            streamed = [e["token"] for e in evs if e["event"] == "token"]
            assert streamed == evs[-1].get("tokens"), f"job{i} stream gap"
        assert _check_streams(results, prompts, NEW_TOKENS, offline,
                              fleet.tail()) == 0
        assert any("injected fault 'conn-reset'" in line
                   for line in fleet.log), fleet.tail()
        stats = cli.stats()
        assert stats["router"]["completed"] == 8
        assert stats["router"]["link_reconnects"] >= 1, stats["router"]
        assert stats["router"]["requeued"] == 0, stats["router"]
        assert stats["router"]["replica_deaths"] == 0, stats["router"]
        assert stats["router"]["restarts_left"] == 2, stats["router"]
        assert all(r["alive"] for r in stats["replicas"])
        assert fleet.stop(cli) == 0, fleet.tail()


def test_dead_fleet_without_budget_answers_with_a_clean_error():
    """The only replica exits at decode step 2 with no restart budget:
    every request it owed, and one sent afterwards, ends in an ``error``
    frame — never a hung client — and the router still shuts down
    cleanly."""
    with _Fleet(replicas=1, restart=0,
                extra_env={"HOROVOD_FAULT_INJECT": "0:2:exit"}) as fleet:
        cli = fleet.client()
        results = _run_jobs(cli, PROMPTS[:3], max_tokens=NEW_TOKENS)
        for rid, evs in results.items():
            assert evs[-1]["event"] == "error", (rid, evs[-1])
            assert "no restart budget left" in evs[-1]["error"]
        late = cli.generate("late", [1, 2, 3], max_tokens=4,
                            timeout=FLEET_TIMEOUT)
        assert late[-1]["event"] == "error", late
        stats = cli.stats()
        assert stats["router"]["failed"] == 4, stats["router"]
        assert not stats["replicas"][0]["alive"]
        assert fleet.stop(cli) == 0, fleet.tail()


def test_run_refuses_training_and_checkpoint_directories(tmp_path):
    """The launcher runs training commands (-np), and still refuses a
    checkpoint directory that holds no complete checkpoint; a fleet under
    ``HOROVOD_METRICS_PORT`` serves the router's ``"serve"`` mount on
    ``/json`` and as ``horovod_serve_*`` on ``/metrics``: the router's
    counters, the live replicas, and the replicas' pong-piggybacked
    scheduler counters."""
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "2", "--",
         sys.executable, "-c",
         "import os; print('id', os.environ['HOROVOD_RANK'], "
         "os.environ['HOROVOD_SIZE'], os.environ['HOROVOD_LOCAL_RANK'])"],
        cwd=bench_serve.REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert sorted(ln for ln in out.stdout.splitlines() if "id" in ln) == [
        "[0] id 0 2 0", "[1] id 1 2 1"]
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "--serve",
         "--serve-model", str(tmp_path), "--device", "cpu"],
        cwd=bench_serve.REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "checkpoint" in out.stderr
    assert "READY" not in out.stdout
    from horovod_tpu_torch.common.launch import free_port
    from horovod_tpu_torch.monitor.server import query_status

    mport = free_port()
    with _Fleet(replicas=1, extra_env={
            "HOROVOD_METRICS_PORT": str(mport),
            "HOROVOD_SERVE_PROBE_SEC": "0.5"}) as fleet:
        assert any(f"SERVE_METRICS_READY port={mport}" in line
                   for line in fleet.log), fleet.tail()
        cli = fleet.client()
        results = _run_jobs(cli, PROMPTS[:2], max_tokens=NEW_TOKENS)
        assert all(evs[-1]["event"] == "done" for evs in results.values())
        deadline, serve = time.time() + 60, {}
        while time.time() < deadline:
            serve = query_status(f"127.0.0.1:{mport}")["serve"]
            if serve.get("completed") == 2 and "prefix_misses" in serve:
                break
            time.sleep(0.2)
        router = cli.stats()["router"]
        assert serve["replicas"] == 1 and serve["replicas_alive"] == 1
        for key in ("completed", "requeued", "replica_deaths"):
            assert serve[key] == router[key], (key, serve, router)
        assert serve["prefix_misses"] > 0, serve
        with urllib.request.urlopen(f"http://127.0.0.1:{mport}/metrics",
                                    timeout=10) as resp:
            prom = resp.read().decode()
        assert "# TYPE horovod_serve_completed counter" in prom
        assert "\nhorovod_serve_completed 2\n" in prom
        assert "\nhorovod_serve_replicas_alive 1\n" in prom
        assert fleet.stop(cli) == 0, fleet.tail()


@pytest.mark.parametrize("gate", ["--gate", "--prefix-gate"])
def test_bench_serve_gates_pass_on_cpu(gate):
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.bench_serve", gate,
         "--device", "cpu"], cwd=bench_serve.REPO, capture_output=True,
        text=True, timeout=400, start_new_session=True)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    line = json.loads([ln for ln in out.stdout.splitlines()
                       if ln.startswith("{")][-1])
    assert line["device"] == "cpu"
    if gate == "--gate":
        push = line["weight_push"]
        assert push["pushes"] == 1 and push["acked"]
        assert push["replica_weight_epochs"] == [1, 1]
        assert set(push["stream_weight_epochs"]) <= {0, 1}
        assert line["completed"] == line["requests"] == 24
        assert line["clean_shutdown"]
    else:
        assert line["dup_exact_on"] and line["dup_exact_off"]
        assert line["prefix_hit_rate_on"] >= 0.5
