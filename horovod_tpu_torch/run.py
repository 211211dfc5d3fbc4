"""Launcher of the port: ``python -m horovod_tpu_torch.run --serve``.

Counterpart of ``horovod_tpu/run.py``, its ``--serve`` mode only: a
router on ``--serve-port`` dispatching to ``--replicas`` replica
processes with continuous batching and a paged KV cache
(:mod:`horovod_tpu_torch.serve.router`); ``--restart-on-failure`` is the
fleet's relaunch budget on replica death.  Every replica runs on
``--device`` (``cuda`` by default, and then it refuses to start without a
GPU; ``cpu`` runs the fleet on the CPU).

Launching a training command (``-np N -- python train.py``) needs the
port's training launcher, which is not ported yet (ROADMAP.md Queue A
item 6), and raises.
"""

from __future__ import annotations

import argparse
import sys

__all__ = ["main"]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.run",
        description="Start the multi-replica serving fleet.")
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
                             "constructor name (default: HOROVOD_SERVE_MODEL "
                             "or tiny)")
    parser.add_argument("--restart-on-failure", type=int, default=0,
                        metavar="N",
                        help="relaunch a replica that exits non-zero, up "
                             "to N relaunches for the whole fleet")
    parser.add_argument("--relaunch-delay-sec", type=float, default=0.0,
                        metavar="SEC",
                        help="wait SEC before relaunching a dead replica")
    parser.add_argument("--device", default="cuda",
                        help="the replicas' device: cuda (default; a "
                             "replica raises without a GPU) or cpu")
    args, rest = parser.parse_known_args(argv)
    if not args.serve:
        raise NotImplementedError(
            "the port's launcher runs the serving fleet only (--serve); "
            "launching training processes is not ported yet (ROADMAP.md "
            "Queue A item 6)")
    if rest:
        parser.error(f"unrecognized arguments: {' '.join(rest)}")
    from horovod_tpu_torch.serve.router import serve_main

    return serve_main(args)


if __name__ == "__main__":
    sys.exit(main())
