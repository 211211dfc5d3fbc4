"""One serving replica: model runner + scheduler + TCP endpoint.

``python -m horovod_tpu_torch.serve.replica --port P [--device cuda|cpu]``
builds the model from the serve env knobs (every port replica derives
identical weights from ``HOROVOD_SERVE_PARAM_SEED``), starts the
continuous-batching scheduler on its own thread, and serves the
JSON-lines protocol.  Prints ``SERVE_REPLICA_READY port=<p> replica=<i>``
once accepting (after ``SERVE_REPLICA_WARMUP replica=<i> programs=<n>``
when ``HOROVOD_SERVE_WARMUP`` is set).  The device defaults to CUDA and
the replica refuses to start without one unless ``--device cpu`` asks for
the CPU.

Counterpart of ``horovod_tpu/serve/replica.py``.  Not ported yet:
``HOROVOD_SERVE_ENGINE=1`` (the replica as an engine world) raises, and
the ``HOROVOD_FAULT_INJECT`` replica faults, which serve the router's
supervisor, come with the router.
"""

from __future__ import annotations

import argparse
import asyncio
import os
import sys
import threading

__all__ = ["main"]


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

    if os.environ.get("HOROVOD_SERVE_ENGINE") == "1":
        raise NotImplementedError(
            "HOROVOD_SERVE_ENGINE=1: the engine binding is not ported yet")

    from horovod_tpu_torch.serve.config import ServeConfig
    from horovod_tpu_torch.serve.engine import ModelRunner
    from horovod_tpu_torch.serve.scheduler import Scheduler
    from horovod_tpu_torch.serve.server import ReplicaServer

    replica_id = int(os.environ.get("HOROVOD_REPLICA_ID", "0"))
    cfg = ServeConfig.from_env()
    runner = ModelRunner(cfg, device=args.device)
    if cfg.warmup_tokens:
        n = runner.warmup()
        print(f"SERVE_REPLICA_WARMUP replica={replica_id} programs={n}",
              flush=True)
    scheduler = Scheduler(runner, cfg)
    sched_thread = threading.Thread(target=scheduler.run, daemon=True)
    sched_thread.start()

    async def amain() -> None:
        server = ReplicaServer(scheduler)
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
