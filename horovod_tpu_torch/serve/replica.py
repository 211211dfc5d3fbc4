"""One serving replica: model runner + scheduler + TCP endpoint.

``python -m horovod_tpu_torch.serve.replica --port P [--device cuda|cpu]``
builds the model from the serve env knobs (every port replica derives
identical weights from ``HOROVOD_SERVE_PARAM_SEED``, or loads them from
``HOROVOD_SERVE_CHECKPOINT``), starts the
continuous-batching scheduler on its own thread, and serves the
JSON-lines protocol.  Prints ``SERVE_REPLICA_READY port=<p> replica=<i>``
once accepting, after ``SERVE_REPLICA_ENGINE replica=<i> rank=<r>
size=<n>`` in an engine world, ``SERVE_REPLICA_WARMUP replica=<i>
programs=<n>`` when ``HOROVOD_SERVE_WARMUP`` is set, and
``SERVE_REPLICA_TIMES replica=<i> init_sec=<s> captures=<n>
capture_sec=<s>`` (model build, and the decode graphs captured so far
with their time).  The device
defaults to CUDA and the replica refuses to start without one unless
``--device cpu`` asks for the CPU.

Counterpart of ``horovod_tpu/serve/replica.py``.

Engine world: under ``HOROVOD_SERVE_ENGINE=1`` the replica calls the
port's ``hvd.init()`` so it IS an engine world (the launcher env decides
the world size).  The default keeps the replica engine-free.

Fault injection: the replica honors the engine's ``HOROVOD_FAULT_INJECT``
schedule format (``rank:step:kind[,...]``) with the *replica index*
(``HOROVOD_REPLICA_ID``) standing in for the rank and the scheduler's
decode-step counter for the step — ``exit`` hard-kills the process (exit
41, the engine's injected-exit code), ``hang`` wedges the scheduler
thread, ``conn-reset`` aborts every open connection ONCE (a transient
link loss: router sessions park and heal under
``HOROVOD_SERVE_LINK_RETRIES``; the process keeps serving).  The router's
supervisor scrubs the schedule on relaunch, so a fault fires once, not on
every incarnation.
"""

from __future__ import annotations

import argparse
import asyncio
import os
import sys
import threading
import time
from typing import Callable, Optional, Tuple

__all__ = ["main", "parse_fault_schedule"]

_FAULT_KINDS = ("exit", "hang", "conn-reset")


def parse_fault_schedule(raw: Optional[str],
                         replica_id: int) -> Optional[Tuple[int, str]]:
    """The engine's ``rank:step:kind`` comma schedule, applied to this
    replica index.  Returns (step, kind) or None; malformed entries are
    ignored (the engine parser's leniency)."""
    if not raw:
        return None
    for part in raw.split(","):
        bits = part.strip().split(":")
        if len(bits) != 3:
            continue
        try:
            rank, step = int(bits[0]), int(bits[1])
        except ValueError:
            continue
        if rank == replica_id and bits[2] in _FAULT_KINDS:
            return step, bits[2]
    return None


def _fault_hook(replica_id: int,
                server_cell=None) -> Optional[Callable[[int], None]]:
    """The scheduler's step hook that fires this replica's scheduled
    fault, or None when the schedule names none for it."""
    sched = parse_fault_schedule(os.environ.get("HOROVOD_FAULT_INJECT"),
                                 replica_id)
    if sched is None:
        return None
    fire_step, kind = sched
    fired = [False]

    def hook(step: int) -> None:
        if step < fire_step:
            return
        if kind == "conn-reset":
            # One-shot: a transient reset, not a dead link every step.
            # The hook runs on the scheduler thread; drop_connections
            # trampolines onto the server's event loop.
            if fired[0] or not server_cell:
                return
            fired[0] = True
            sys.stderr.write(f"[serve replica {replica_id}] injected "
                             f"fault 'conn-reset' at decode step "
                             f"{step}\n")
            sys.stderr.flush()
            server_cell[0].drop_connections()
            return
        sys.stderr.write(f"[serve replica {replica_id}] injected fault "
                         f"{kind!r} at decode step {step}\n")
        sys.stderr.flush()
        if kind == "exit":
            os._exit(41)
        time.sleep(3600)  # hang: wedge the scheduler thread

    return hook


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.serve.replica",
        description="One inference-serving replica (JSON lines over TCP).")
    parser.add_argument("--port", type=int, default=0,
                        help="listen port (0 = ephemeral; the bound port "
                             "is printed in the READY line)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--device", default=None,
                        help="cuda (default; raises without a GPU) or cpu")
    args = parser.parse_args(argv)

    from horovod_tpu_torch.serve.config import ServeConfig
    from horovod_tpu_torch.serve.engine import ModelRunner
    from horovod_tpu_torch.serve.scheduler import Scheduler
    from horovod_tpu_torch.serve.server import ReplicaServer

    replica_id = int(os.environ.get("HOROVOD_REPLICA_ID", "0"))
    cfg = ServeConfig.from_env()

    if os.environ.get("HOROVOD_SERVE_ENGINE") == "1":
        # The replica is an engine world: rendezvous with whatever ranks
        # the launcher spawned for it.
        import horovod_tpu_torch as hvd

        hvd.init(device=args.device)
        print(f"SERVE_REPLICA_ENGINE replica={replica_id} rank={hvd.rank()} "
              f"size={hvd.size()}", flush=True)

    t0 = time.perf_counter()
    runner = ModelRunner(cfg, device=args.device)
    init_sec = time.perf_counter() - t0
    if cfg.warmup_tokens:
        n = runner.warmup()
        print(f"SERVE_REPLICA_WARMUP replica={replica_id} programs={n}",
              flush=True)
    print(f"SERVE_REPLICA_TIMES replica={replica_id} "
          f"init_sec={init_sec:.3f} captures={runner.captures} "
          f"capture_sec={runner.capture_seconds:.3f}", flush=True)
    # The conn-reset fault needs the server, which is built inside the
    # loop AFTER the scheduler — hand the hook a late-bound cell.
    server_cell: list = []
    scheduler = Scheduler(runner, cfg,
                          step_hook=_fault_hook(replica_id, server_cell))
    sched_thread = threading.Thread(target=scheduler.run, daemon=True)
    sched_thread.start()

    async def amain() -> None:
        server = ReplicaServer(scheduler)
        server_cell.append(server)
        port = await server.start(args.host, args.port)
        print(f"SERVE_REPLICA_READY port={port} replica={replica_id}",
              flush=True)
        await server.serve_until_shutdown()

    asyncio.run(amain())
    scheduler.stop()
    sched_thread.join(timeout=10)
    return 0


if __name__ == "__main__":
    sys.exit(main())
