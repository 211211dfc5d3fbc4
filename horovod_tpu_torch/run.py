"""Process launcher: ``python -m horovod_tpu_torch.run -np N -- python train.py``.

Counterpart of ``horovod_tpu/run.py``.  Spawns N copies of the command
with ``HOROVOD_RANK`` / ``_SIZE`` / ``_LOCAL_RANK`` / ``_LOCAL_SIZE`` /
``_COORDINATOR`` set (a free coordinator port by default), streams their
output with rank prefixes, and propagates the first failure (terminating
the rest, as mpirun does).  A worker maps ``HOROVOD_LOCAL_RANK`` to
``cuda:<local_rank>`` unless its ``hvd.init(device=...)`` says otherwise
(two ranks sharing one card pass ``device="cuda:0"``, ``backend="gloo"``).

* Multi-host: run the launcher once per host with ``--hosts-total`` /
  ``--host-index`` / ``--coordinator host0:port``; ranks are numbered
  globally and rendezvous at host 0.
* ``--restart-on-failure N``: a supervisor that relaunches a dead worker
  (same rank, same env, ``HOROVOD_FAULT_INJECT`` scrubbed so an injected
  fault fires once) up to N times in all; pair it with workers built on
  :func:`horovod_tpu_torch.elastic.run_elastic`.
* ``--elastic``: sets ``HOROVOD_ELASTIC=1``, so the engine may re-form the
  world in place around the survivors, and abandons a dead non-zero
  worker once the budget is spent (the survivors shrink and continue).
* ``--checkpoint-dir DIR``: ``HOROVOD_CHECKPOINT_DIR`` for every worker;
  a relaunched or resized world resumes from the newest complete
  manifest.
* ``--serve``: the multi-replica serving fleet instead of a training
  command (``serve/router.py``); ``--serve-model`` is a LlamaConfig name
  or a checkpoint directory; every replica runs on ``--device``.

* ``--status HOST:PORT [--raw]``: query a live job's metrics endpoint
  (``HOROVOD_METRICS_PORT`` on rank 0, or on a serving router) and print
  its summary (``--raw``: the ``/json`` payload).
* ``--print-config``: the resolved knob table (env, default, effective),
  the engine's and the serve plane's.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time

from horovod_tpu_torch.common.launch import free_port

__all__ = ["main"]


def _stream(prefix: str, pipe, out):
    for line in iter(pipe.readline, b""):
        out.write(f"[{prefix}] ".encode() + line)
        out.flush()
    pipe.close()


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.run",
        description="Launch N coordinated worker processes.")
    parser.add_argument("-np", "--num-proc", type=int, default=None,
                        help="processes on this host")
    parser.add_argument("--coordinator", default=None,
                        help="host:port of rank 0's coordinator "
                             "(default: 127.0.0.1:<free port>)")
    parser.add_argument("--host-index", type=int, default=0,
                        help="this host's index (multi-host)")
    parser.add_argument("--procs-per-host", type=int, default=None,
                        help="ranks per host (default: -np)")
    parser.add_argument("--hosts-total", type=int, default=1)
    parser.add_argument("--restart-on-failure", type=int, default=0,
                        metavar="N",
                        help="supervisor mode: relaunch a worker (or, under "
                             "--serve, a replica) that exits non-zero, up "
                             "to N relaunches in all")
    parser.add_argument("--elastic", action="store_true",
                        help="in-place elastic membership: set "
                             "HOROVOD_ELASTIC=1 for every worker, abandon "
                             "a dead worker once the restart budget is "
                             "spent, let relaunched workers rejoin")
    parser.add_argument("--relaunch-delay-sec", type=float, default=0.0,
                        metavar="SEC",
                        help="supervisor mode: wait SEC before relaunching "
                             "a dead worker or replica")
    parser.add_argument("--status", default=None, metavar="HOST:PORT",
                        help="query a live job's metrics endpoint "
                             "(HOROVOD_METRICS_PORT on rank 0) and print "
                             "a summary")
    parser.add_argument("--raw", action="store_true",
                        help="with --status: print the raw /json payload")
    parser.add_argument("--print-config", action="store_true",
                        help="print the resolved knob table (env -> "
                             "default -> effective) and exit")
    parser.add_argument("--serve", action="store_true",
                        help="inference serving mode: start the "
                             "multi-replica router + replica fleet")
    parser.add_argument("--serve-port", type=int, default=8070,
                        help="router listen port under --serve "
                             "(0 = ephemeral, printed in the READY line)")
    parser.add_argument("--replicas", type=int, default=1,
                        help="serving replicas under --serve")
    parser.add_argument("--serve-model", default=None, metavar="NAME",
                        help="served model under --serve: a LlamaConfig "
                             "name OR a checkpoint directory (replicas "
                             "load the newest complete manifest's params; "
                             "default: HOROVOD_SERVE_MODEL or tiny)")
    parser.add_argument("--device", default="cuda",
                        help="the replicas' device under --serve: cuda "
                             "(default; a replica raises without a GPU) "
                             "or cpu")
    parser.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                        help="set HOROVOD_CHECKPOINT_DIR for every worker: "
                             "training built on run_elastic checkpoints "
                             "there and resumes from the newest complete "
                             "manifest")
    parser.add_argument("command", nargs=argparse.REMAINDER,
                        help="command to run (prefix with --)")
    return parser


def main(argv=None) -> int:
    parser = _parser()
    args = parser.parse_args(argv)
    if args.status:
        from horovod_tpu_torch.monitor.server import (format_status,
                                                      query_status)
        try:
            payload = query_status(args.status)
        except (OSError, ValueError) as exc:
            # ValueError: a malformed host:port, or a reply that is not
            # the endpoint's JSON.
            sys.stderr.write(
                f"cannot reach metrics endpoint at {args.status}: {exc}\n"
                "(is the job running with HOROVOD_METRICS_PORT set?)\n")
            return 1
        if args.raw:
            print(json.dumps(payload, indent=2, sort_keys=True))
        else:
            print(format_status(payload))
        return 0
    if args.print_config:
        from horovod_tpu_torch.autotune.config import format_table
        print(format_table())
        return 0
    if args.serve:
        from horovod_tpu_torch.serve.router import serve_main

        return serve_main(args)
    if args.num_proc is None:
        parser.error("the following arguments are required: -np/--num-proc")
    command = args.command
    if command and command[0] == "--":
        command = command[1:]
    if not command:
        parser.error("no command given")
    return _launch(args, command)


def _launch(args, command) -> int:
    pph = args.procs_per_host or args.num_proc
    world = pph * args.hosts_total
    coordinator = args.coordinator or f"127.0.0.1:{free_port()}"
    threads = []

    def spawn(local_rank: int, scrub_fault_inject: bool = False):
        rank = args.host_index * pph + local_rank
        env = dict(os.environ)
        env.update({
            "HOROVOD_RANK": str(rank),
            "HOROVOD_SIZE": str(world),
            "HOROVOD_LOCAL_RANK": str(local_rank),
            "HOROVOD_LOCAL_SIZE": str(pph),
            "HOROVOD_COORDINATOR": coordinator,
        })
        if args.elastic:
            # The env rank is a persistent worker id (a join candidacy);
            # the coordinator commits the actual (epoch, rank, size).
            env["HOROVOD_ELASTIC"] = "1"
        if args.checkpoint_dir:
            env["HOROVOD_CHECKPOINT_DIR"] = args.checkpoint_dir
        if scrub_fault_inject:
            # A relaunched incarnation must not re-fire the injected
            # fault at the same step, or the job would never converge.
            env.pop("HOROVOD_FAULT_INJECT", None)
        p = subprocess.Popen(command, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT)
        t = threading.Thread(target=_stream, args=(str(rank), p.stdout,
                                                   sys.stdout.buffer),
                             daemon=True)
        t.start()
        threads.append(t)
        return p

    procs = [spawn(local_rank) for local_rank in range(args.num_proc)]
    restarts_left = max(0, args.restart_on_failure)
    pending_respawn: dict = {}   # local index -> respawn due time
    exit_codes: dict = {}        # local index -> last exit code
    rc = 0
    try:
        remaining = set(range(len(procs)))
        while remaining or pending_respawn:
            if not remaining and pending_respawn:
                # Everyone else finished: no running world is left for a
                # delayed replacement to rejoin.
                sys.stderr.write(
                    "job finished before the delayed relaunch; "
                    "cancelling it\n")
                sys.stderr.flush()
                break
            now = time.time()
            for i in [i for i, due in pending_respawn.items() if due <= now]:
                del pending_respawn[i]
                procs[i] = spawn(i, scrub_fault_inject=True)
                remaining.add(i)
            for i in list(remaining):
                code = procs[i].poll()
                if code is None:
                    continue
                # The global rank, as the stream prefixes give it.
                rank = args.host_index * pph + i
                exit_codes[i] = code
                if code != 0 and restarts_left > 0:
                    restarts_left -= 1
                    sys.stderr.write(
                        f"rank {rank} exited with code {code}; "
                        f"relaunching ({restarts_left} restarts left)\n")
                    sys.stderr.flush()
                    if args.relaunch_delay_sec > 0:
                        remaining.discard(i)
                        pending_respawn[i] = now + args.relaunch_delay_sec
                    else:
                        procs[i] = spawn(i, scrub_fault_inject=True)
                    continue
                remaining.discard(i)
                if code != 0:
                    if args.elastic and rank != 0:
                        # In-place shrink: the survivors re-form the world
                        # without it (worker id 0 is the coordinator: its
                        # death still ends the job).
                        sys.stderr.write(
                            f"rank {rank} exited with code {code}; "
                            "abandoning it (elastic shrink — survivors "
                            "continue)\n")
                        sys.stderr.flush()
                        continue
                    if rc == 0:
                        rc = code
                        sys.stderr.write(
                            f"rank {rank} exited with "
                            f"code {code}; terminating remaining ranks\n")
                        for j in remaining:
                            procs[j].terminate()
            if remaining or pending_respawn:
                time.sleep(0.1)
    except KeyboardInterrupt:
        for p in procs:
            p.send_signal(signal.SIGINT)
        rc = 130
    if (args.elastic and rc == 0 and exit_codes
            and all(c != 0 for c in exit_codes.values())):
        # Elastic abandons single failures, but a job where no worker
        # exited cleanly still failed.
        rc = next(c for c in exit_codes.values() if c != 0)
    for t in threads:
        t.join(timeout=5)
    return rc


if __name__ == "__main__":
    sys.exit(main())
