"""A world of ``n`` rank processes on this host.

Each rank is started with the identity :func:`horovod_tpu_torch.init`
reads (``HOROVOD_RANK``, ``HOROVOD_SIZE``, ``HOROVOD_COORDINATOR``) and
without the caller's own ``HOROVOD_*``/``OMPI_*``/``PMI_*`` variables.
Its output goes to a file, so no rank blocks on a full pipe while another
is waited on, and :meth:`World.wait` polls the ranks together: the first
to fail ends the wait with its own output, not with its peers' hang.

    with World(2, [sys.executable, "-m", "my.script"]) as world:
        outputs = world.wait(timeout_s=240)
"""

from __future__ import annotations

import os
import random
import socket
import subprocess
import tempfile
import time
from typing import Dict, List, Optional, Sequence

__all__ = ["TORCH_PORT_OFFSET", "PORT_RANGE", "free_port", "World"]

#: The torch group's rendezvous sits this far above the coordinator's
#: port (``common/basics.py``).
TORCH_PORT_OFFSET = 64

#: The ports :func:`free_port` draws from: below both Linux's (32768 on)
#: and IANA's (49152 on) ephemeral ranges, so that no other process's
#: ``connect()`` or ``bind(0)`` is handed a port between its probe and
#: the rank that binds it (an engine world opens many such sockets).
PORT_RANGE = (20000, 32768 - TORCH_PORT_OFFSET)


def free_port() -> int:
    """A free local port of :data:`PORT_RANGE` whose +
    :data:`TORCH_PORT_OFFSET` is free too, drawn at random from the
    operating system's entropy (processes that seed ``random`` alike
    still draw apart)."""
    draw = random.SystemRandom()
    while True:
        port = draw.randrange(*PORT_RANGE)
        with socket.socket() as s, socket.socket() as t:
            try:
                s.bind(("127.0.0.1", port))
                t.bind(("127.0.0.1", port + TORCH_PORT_OFFSET))
            except OSError:
                continue
            return port


class World:
    """``n`` processes of ``argv``, rank ``r`` with ``HOROVOD_RANK=r``.

    ``env``: variables added to every rank's environment; ``drop``: the
    prefixes of the caller's variables the ranks do not inherit.  As a
    context manager, every rank still running at exit is killed."""

    def __init__(self, n: int, argv: Sequence[str], *,
                 env: Optional[Dict[str, str]] = None, cwd=None,
                 drop: Sequence[str] = ("HOROVOD_", "OMPI_", "PMI_")):
        base = {k: v for k, v in os.environ.items()
                if not k.startswith(tuple(drop))}
        base.update(env or {}, HOROVOD_SIZE=str(n),
                    HOROVOD_COORDINATOR=f"127.0.0.1:{free_port()}")
        self.logs = [tempfile.TemporaryFile("w+") for _ in range(n)]
        self.procs = [subprocess.Popen(
            list(argv), cwd=cwd, env=dict(base, HOROVOD_RANK=str(r)),
            stdout=log, stderr=subprocess.STDOUT, text=True)
            for r, log in enumerate(self.logs)]

    def output(self, r: int) -> str:
        self.logs[r].seek(0)
        return self.logs[r].read()

    def wait(self, timeout_s: float) -> List[str]:
        """Each rank's output once every rank has exited 0.  Raises
        ``RuntimeError`` (and kills the world) when a rank exits otherwise
        or the world outlives ``timeout_s``."""
        t0 = time.monotonic()
        try:
            while any(p.poll() is None for p in self.procs):
                for r, p in enumerate(self.procs):
                    if p.poll() not in (None, 0):
                        raise RuntimeError(
                            f"rank {r} exited {p.returncode}:\n"
                            + self.output(r)[-3000:])
                if time.monotonic() - t0 > timeout_s:
                    alive = [r for r, p in enumerate(self.procs)
                             if p.poll() is None]
                    raise RuntimeError(
                        f"ranks {alive} timed out after {timeout_s} s:\n"
                        + "\n".join(self.output(r)[-1500:]
                                    for r in range(len(self.procs))))
                time.sleep(0.1)
            for r, p in enumerate(self.procs):
                if p.returncode != 0:
                    raise RuntimeError(f"rank {r} exited {p.returncode}:\n"
                                       + self.output(r)[-3000:])
            return [self.output(r) for r in range(len(self.procs))]
        except BaseException:
            self.kill()
            raise

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def __enter__(self) -> "World":
        return self

    def __exit__(self, *exc) -> None:
        self.kill()
        for log in self.logs:
            log.close()
