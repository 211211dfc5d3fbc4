"""Port parity: the training launcher (``python -m horovod_tpu_torch.run``).

The counterparts of ``tests/test_launcher.py:19-136`` on the port's
launcher and workers (CPU, gloo + engine): spawn and coordinate, failure
propagation, restart on failure, the exhausted budget, two launchers
forming one multi-host world, and failures attributed to the global rank.
Also the launcher's two query flags: ``--status`` (and ``--raw``) against
a live port job's metrics endpoint, and ``--print-config`` against the
reference's table.
"""

import json
import os
import subprocess
import sys
import time

import pytest

from horovod_tpu_torch.common.launch import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HOROVOD_")}
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = REPO
    return env


def _run(np_, body, *flags, timeout=120):
    return subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", str(np_),
         *flags, "--", sys.executable, "-c", body],
        cwd=REPO, env=_env(), capture_output=True, timeout=timeout)


def test_launcher_spawns_and_coordinates():
    p = _run(2, (
        "import horovod_tpu_torch as hvd\n"
        "import torch, sys\n"
        "hvd.init(device='cpu')\n"
        "out = hvd.allreduce(torch.ones(2), average=False)\n"
        "assert out[0].item() == 2.0\n"
        "print('rank', hvd.rank(), 'ok')\n"
        "hvd.shutdown()\n"
        "assert 'jax' not in sys.modules\n"))
    assert p.returncode == 0, p.stdout.decode() + p.stderr.decode()
    out = p.stdout.decode()
    assert "[0] rank 0 ok" in out and "[1] rank 1 ok" in out


def test_launcher_sets_the_reference_variables_and_nothing_more():
    p = _run(2, (
        "import os, json\n"
        "print(json.dumps({k: v for k, v in sorted(os.environ.items())"
        " if k.startswith('HOROVOD_')}))\n"), "--checkpoint-dir", "/ck",
        "--elastic")
    assert p.returncode == 0, p.stderr.decode()
    lines = sorted(p.stdout.decode().splitlines())
    assert len(lines) == 2
    import json

    got = [json.loads(ln.split("] ", 1)[1]) for ln in lines]
    coord = got[0]["HOROVOD_COORDINATOR"]
    for r, env in enumerate(got):
        assert env == {"HOROVOD_CHECKPOINT_DIR": "/ck",
                       "HOROVOD_COORDINATOR": coord,
                       "HOROVOD_ELASTIC": "1", "HOROVOD_LOCAL_RANK": str(r),
                       "HOROVOD_LOCAL_SIZE": "2", "HOROVOD_RANK": str(r),
                       "HOROVOD_SIZE": "2"}


def test_launcher_propagates_failure():
    p = _run(2, (
        "import os, sys\n"
        "sys.exit(3 if os.environ['HOROVOD_RANK'] == '1' else 0)\n"))
    assert p.returncode == 3
    assert b"terminating remaining" in p.stderr or p.returncode == 3


def test_launcher_restart_on_failure(tmp_path):
    """--restart-on-failure relaunches a dead worker with the same rank
    identity, and without the fault schedule."""
    mark = tmp_path / "died_once"
    body = (
        "import os, sys\n"
        f"mark = {str(mark)!r}\n"
        "if os.environ['HOROVOD_RANK'] == '1' and not os.path.exists(mark):\n"
        "    assert os.environ['HOROVOD_FAULT_INJECT'] == '1:3:exit'\n"
        "    open(mark, 'w').close()\n"
        "    sys.exit(9)\n"
        "assert 'HOROVOD_FAULT_INJECT' not in os.environ or "
        "os.environ['HOROVOD_RANK'] == '0'\n"
        "print('rank', os.environ['HOROVOD_RANK'], 'done')\n")
    env = dict(_env(), HOROVOD_FAULT_INJECT="1:3:exit")
    p = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "2",
         "--restart-on-failure", "1", "--", sys.executable, "-c", body],
        cwd=REPO, env=env, capture_output=True, timeout=120)
    assert p.returncode == 0, p.stdout.decode() + p.stderr.decode()
    assert b"relaunching (0 restarts left)" in p.stderr, p.stderr.decode()
    out = p.stdout.decode()
    assert "[0] rank 0 done" in out and "[1] rank 1 done" in out, out


def test_launcher_restart_budget_exhausted_propagates():
    p = _run(2, "import os, sys\n"
                "sys.exit(7 if os.environ['HOROVOD_RANK'] == '1' else 0)\n",
             "--restart-on-failure", "1")
    assert p.returncode == 7, p.stdout.decode() + p.stderr.decode()
    assert b"relaunching" in p.stderr, p.stderr.decode()


def _run_multihost(body, n_hosts=2, pph=2, timeout=180):
    """Two launcher invocations on localhost playing two hosts of one
    world: global ranks = host_index * pph + local_rank, rendezvous at the
    shared coordinator."""
    port = free_port()
    launchers = [subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", str(pph),
         "--host-index", str(host), "--hosts-total", str(n_hosts),
         "--coordinator", f"127.0.0.1:{port}", "--",
         sys.executable, "-c", body],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for host in range(n_hosts)]
    try:
        results = [p.communicate(timeout=timeout) for p in launchers]
    finally:
        for p in launchers:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return launchers, results


def test_launcher_multihost_two_worlds_rendezvous():
    launchers, results = _run_multihost(
        "import os\n"
        "import horovod_tpu_torch as hvd\n"
        "import torch\n"
        "hvd.init(device='cpu')\n"
        "assert hvd.size() == 4, hvd.size()\n"
        "assert hvd.local_size() == 2\n"
        "assert hvd.rank() == int(os.environ['HOROVOD_RANK'])\n"
        "assert hvd.rank() // 2 * 2 + hvd.local_rank() == hvd.rank()\n"
        "out = hvd.allreduce(torch.full((3,), float(hvd.rank() + 1)),"
        " average=False)\n"
        "assert out[0].item() == 10.0, out\n"
        "g = hvd.allgather(torch.tensor([[float(hvd.rank())]]))\n"
        "assert g.reshape(-1).tolist() == [0.0, 1.0, 2.0, 3.0], g\n"
        "print('rank', hvd.rank(), 'multihost ok')\n"
        "hvd.shutdown()\n")
    for host, (p, (out, err)) in enumerate(zip(launchers, results)):
        assert p.returncode == 0, f"host {host}: {out.decode()}\n{err.decode()}"
    combined = b"".join(out for out, _ in results).decode()
    for r in range(4):
        assert f"[{r}] rank {r} multihost ok" in combined, combined


def test_launcher_multihost_global_rank_error_attribution():
    launchers, results = _run_multihost(
        "import os, sys\n"
        "sys.exit(5 if os.environ['HOROVOD_RANK'] == '3' else 0)\n")
    assert launchers[1].returncode == 5
    assert b"rank 3 exited with code 5" in results[1][1], results[1][1]


#: A world of 2 that serves its metrics endpoint until the test drops a
#: release file (argv[1]).
_HOLD = (
    "import os, sys, time, torch\n"
    "import horovod_tpu_torch as hvd\n"
    "hvd.init(device='cpu')\n"
    "for i in range(12):\n"
    "    hvd.allreduce(torch.ones(256) * (hvd.rank() + 1), name=f'st.{i % 3}')\n"
    "deadline = time.time() + 90\n"
    "while not os.path.exists(sys.argv[1]) and time.time() < deadline:\n"
    "    time.sleep(0.1)\n"
    "hvd.shutdown()\n")


def _query(flags, timeout=60):
    return subprocess.run([sys.executable, "-m", "horovod_tpu_torch.run",
                           *flags], cwd=REPO, env=_env(),
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("flags", [["--status", "127.0.0.1:9"],
                                   ["--print-config"]])
def test_status_and_print_config_cite_item_6b(flags, tmp_path):
    """``--status``: a dead address exits 1 with the reference's message;
    against a live 2-rank port job (``HOROVOD_METRICS_PORT``, telemetry
    every cycle) the summary names both fleet rows and ``--raw`` prints
    the endpoint's JSON.  ``--print-config``: the reference's table for
    the same environment, but for the rows listed in
    ``_PORT_ROWS_DIFFER``."""
    if flags[0] == "--print-config":
        from horovod_tpu.autotune import format_table as jax_format_table

        env = dict(_env(), HOROVOD_CHUNK_BYTES="5000",
                   HOROVOD_SERVE_MAX_BATCH="6")
        p = subprocess.run([sys.executable, "-m", "horovod_tpu_torch.run",
                            *flags], cwd=REPO, env=env, capture_output=True,
                           text=True, timeout=60)
        assert p.returncode == 0, p.stderr
        assert p.stdout.splitlines() == _reference_table(
            jax_format_table(env))
        return
    p = _query(flags)
    assert p.returncode == 1
    assert "cannot reach metrics endpoint at 127.0.0.1:9" in p.stderr
    assert "is the job running with HOROVOD_METRICS_PORT set?" in p.stderr
    from horovod_tpu_torch.monitor.server import query_status

    mport = free_port()
    release = tmp_path / "release"
    env = dict(_env(), HOROVOD_METRICS_PORT=str(mport),
               HOROVOD_TELEMETRY_CYCLES="1", HOROVOD_CYCLE_TIME="2")
    job = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "2", "--",
         sys.executable, "-c", _HOLD, str(release)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        deadline, payload = time.time() + 90, None
        while time.time() < deadline:
            try:
                payload = query_status(f"127.0.0.1:{mport}", timeout=3)
                if payload["fleet"].get("totals", {}).get("tensors", 0) \
                        >= 2 * 12:
                    break
            except (OSError, ValueError):
                pass
            time.sleep(0.3)
        assert payload and payload["fleet"]["ranks_reporting"] == 2, payload
        text = _query(["--status", f"127.0.0.1:{mport}"])
        assert text.returncode == 0, text.stderr
        assert text.stdout.startswith("== horovod_tpu live job status ==")
        assert "ranks reporting 2" in text.stdout
        assert "row rank 1" in text.stdout
        raw = _query(["--status", f"127.0.0.1:{mport}", "--raw"])
        assert raw.returncode == 0, raw.stderr
        got = json.loads(raw.stdout)
        assert got["fleet"]["world_size"] == 2
        assert got["stats"]["config"]["telemetry_cycles"] == 1
        assert "stall_warnings" in got["stats"]
    finally:
        release.write_text("go")
        out, err = job.communicate(timeout=120)
    assert job.returncode == 0, out.decode() + err.decode()


#: Rows of ``--print-config`` where the port's table differs from the
#: reference's, and why: the three knobs whose help names a command give
#: the port's command (``python -m horovod_tpu_torch.<tool>``), and
#: ``HOROVOD_PAGED_ATTN_CHUNK`` tunes the port's plain CPU decode where
#: it tunes the JAX package's XLA stand-in (its help names what it tunes).
_PORT_ROWS_DIFFER = {"HOROVOD_METRICS_PORT": "command",
                     "HOROVOD_FLIGHT_RECORDER_DIR": "command",
                     "HOROVOD_TIMELINE_ALL_RANKS": "command",
                     "HOROVOD_PAGED_ATTN_CHUNK": "plain"}


def _reference_table(text):
    """The reference's ``format_table`` text with ``_PORT_ROWS_DIFFER``
    applied, as lines."""
    from tests.test_torch_port_autotune import CHUNK_DOC

    out = []
    for line in text.splitlines():
        knob = line.split(" ", 1)[0]
        kind = _PORT_ROWS_DIFFER.get(knob)
        if kind == "command":
            line = line.replace("horovod_tpu.", "horovod_tpu_torch.")
        if kind == "plain":
            line = line.replace(*CHUNK_DOC)
        out.append(line)
    return out


def test_launcher_requires_np_or_a_mode():
    p = subprocess.run([sys.executable, "-m", "horovod_tpu_torch.run"],
                       cwd=REPO, env=_env(), capture_output=True, text=True,
                       timeout=120)
    assert p.returncode == 2 and "-np" in p.stderr
    p = subprocess.run([sys.executable, "-m", "horovod_tpu_torch.run",
                        "-np", "2"], cwd=REPO, env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 2 and "no command" in p.stderr
