"""Async request front-end: newline-delimited JSON over TCP.

Counterpart of ``horovod_tpu/serve/server.py``, speaking the same
frames, so a client of a JAX replica can talk to a port replica.

Requests (one JSON object per line)::

    {"op": "generate", "id": "r1", "prompt": [1,2,3], "max_tokens": 8,
     "temperature": 0.0, "seed": 0}
    {"op": "cancel", "id": "r1"}
    {"op": "stats"}
    {"op": "ping"}
    {"op": "weights", "epoch": 3, "frames": [...]}
    {"op": "shutdown"}

Streamed responses (interleaved across in-flight requests)::

    {"event": "token", "id": "r1", "token": 42, "index": 0}
    {"event": "done", "id": "r1", "tokens": [...], "preemptions": 0}
    {"event": "error", "id": "r1", "error": "..."}
    {"event": "cancelled", "id": "r1"}
    {"event": "stats", "stats": {...}}
    {"event": "pong", "sched_age_sec": 0.004,
     "counters": {"prefix_hits": 0, ...}}

Not ported yet, and answered with an error frame (``"id": null``): the
``weights`` push (it needs the checkpoint plane) and the router's
``hello`` session handshake (it comes with the router).  A client that
disconnects has its in-flight requests cancelled, so it cannot keep
burning pool blocks.

:class:`ServeClient` is a small blocking client (reader thread +
per-request queues) for tests and simple callers.
"""

from __future__ import annotations

import asyncio
import json
import socket
import threading
import time
from collections import deque
from typing import Callable, Dict, Optional

from horovod_tpu_torch.serve.scheduler import Request, Scheduler

__all__ = ["ReplicaServer", "ServeClient"]

_NOT_PORTED = {
    "weights": "weights push failed: live weight pushes are not ported "
               "yet (they come with the checkpoint plane)",
    "hello": "router sessions are not ported yet (they come with the "
             "router)",
}


class ReplicaServer:
    """Serves one Scheduler over asyncio TCP (JSON lines)."""

    def __init__(self, scheduler: Scheduler):
        self.scheduler = scheduler
        self._server: Optional[asyncio.AbstractServer] = None
        self.port: Optional[int] = None
        self._shutdown = asyncio.Event()
        self._conns: set = set()

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        self._server = await asyncio.start_server(self._handle, host, port,
                                                  limit=1 << 26)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def serve_until_shutdown(self) -> None:
        """Run until a ``shutdown`` frame (or :meth:`shutdown`)."""
        await self._shutdown.wait()
        self._server.close()
        await self._server.wait_closed()
        # Nudge lingering connections so their handler tasks can finish
        # before the loop goes away.
        for writer in list(self._conns):
            try:
                writer.close()
            except OSError:
                pass
        await asyncio.sleep(0)
        self.scheduler.stop()

    def shutdown(self) -> None:
        self._shutdown.set()

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        self._conns.add(writer)
        loop = asyncio.get_running_loop()
        outbox: asyncio.Queue = asyncio.Queue()
        live: set = set()

        def emit_threadsafe(rid: str) -> Callable[[dict], None]:
            def emit(ev: dict) -> None:
                if ev["event"] in ("done", "error", "cancelled"):
                    live.discard(rid)
                try:
                    loop.call_soon_threadsafe(outbox.put_nowait, ev)
                except RuntimeError:
                    # Loop already torn down (shutdown drain racing the
                    # scheduler thread) — the client saw EOF anyway.
                    pass
            return emit

        async def write_loop() -> None:
            while True:
                ev = await outbox.get()
                if ev is None:
                    break
                writer.write((json.dumps(ev) + "\n").encode())
                await writer.drain()

        wtask = asyncio.ensure_future(write_loop())
        try:
            while True:
                line = await reader.readline()
                if not line:
                    break
                try:
                    msg = json.loads(line)
                except json.JSONDecodeError:
                    outbox.put_nowait({"event": "error", "id": None,
                                       "error": "malformed frame"})
                    continue
                op = msg.get("op")
                if op == "generate":
                    rid = str(msg.get("id", ""))
                    try:
                        req = Request(
                            id=rid,
                            prompt=[int(t) for t in msg["prompt"]],
                            max_tokens=int(msg["max_tokens"]),
                            temperature=float(msg.get("temperature", 0.0)),
                            seed=int(msg.get("seed", 0)))
                    except (KeyError, TypeError, ValueError) as e:
                        outbox.put_nowait({"event": "error", "id": rid,
                                           "error": f"bad request: {e}"})
                        continue
                    live.add(rid)
                    self.scheduler.submit(req, emit_threadsafe(rid))
                elif op == "cancel":
                    self.scheduler.cancel(str(msg.get("id", "")))
                elif op == "stats":
                    outbox.put_nowait({"event": "stats",
                                       "stats": self.scheduler.stats()})
                elif op == "ping":
                    # The pong carries the scheduler heartbeat's age: the
                    # front-end answers even when the scheduler THREAD is
                    # wedged, so a probe must judge the scheduler, not the
                    # socket.
                    outbox.put_nowait({
                        "event": "pong",
                        "sched_age_sec": round(
                            time.monotonic() - self.scheduler.last_beat,
                            3),
                        "counters": self.scheduler.metrics_counters()})
                elif op in _NOT_PORTED:
                    outbox.put_nowait({"event": "error", "id": None,
                                       "error": _NOT_PORTED[op]})
                elif op == "shutdown":
                    outbox.put_nowait({"event": "bye"})
                    self.shutdown()
                    break
                else:
                    outbox.put_nowait({"event": "error", "id": None,
                                       "error": f"unknown op {op!r}"})
        except (ConnectionResetError, asyncio.IncompleteReadError):
            pass
        finally:
            # A vanished client must not keep burning pool blocks.
            for rid in list(live):
                self.scheduler.cancel(rid)
            outbox.put_nowait(None)
            try:
                await asyncio.wait_for(wtask, timeout=5)
            except (asyncio.TimeoutError, ConnectionResetError,
                    BrokenPipeError):
                wtask.cancel()
            self._conns.discard(writer)
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError, OSError):
                pass


class ServeClient:
    """Blocking JSON-lines client (tests / simple callers).

    A reader thread fans events out to per-request queues;
    :meth:`generate` blocks until the ``done`` frame and returns the
    full event list.  Concurrent generates from different threads are
    fine — the socket write side is lock-guarded.
    """

    def __init__(self, host: str, port: int, timeout: float = 120.0):
        self.timeout = timeout
        self._sock = socket.create_connection((host, port), timeout=timeout)
        # timeout bounds the CONNECT only.  An established connection
        # must tolerate arbitrary idle; left in place, the recv timeout
        # fires in the reader thread on an idle socket and falsely marks
        # the connection dead.  Deadlines are enforced per request in
        # collect()/_wait_plain() instead.
        self._sock.settimeout(None)
        self._file = self._sock.makefile("rb")
        self._wlock = threading.Lock()
        self._qlock = threading.Lock()
        self._queues: Dict[str, deque] = {}
        self._events: Dict[str, threading.Event] = {}
        self._plain: deque = deque()         # events with no request id
        self._plain_ev = threading.Event()
        self._dead = False
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()

    def _read_loop(self) -> None:
        try:
            for line in iter(self._file.readline, b""):
                ev = json.loads(line)
                # Client-side receive timestamp: what latency
                # measurements (TTFT) are taken from.
                ev["_recv_ts"] = time.monotonic()
                rid = ev.get("id")
                if rid is not None and rid in self._queues:
                    with self._qlock:
                        self._queues[rid].append(ev)
                        self._events[rid].set()
                else:
                    self._plain.append(ev)
                    self._plain_ev.set()
        except (OSError, ValueError):
            pass
        self._dead = True
        with self._qlock:
            for ev in self._events.values():
                ev.set()
        self._plain_ev.set()

    def _send(self, msg: dict) -> None:
        with self._wlock:
            self._sock.sendall((json.dumps(msg) + "\n").encode())

    def start_generate(self, rid: str, prompt, max_tokens: int,
                       temperature: float = 0.0, seed: int = 0) -> None:
        with self._qlock:
            self._queues[rid] = deque()
            self._events[rid] = threading.Event()
        self._send({"op": "generate", "id": rid, "prompt": list(prompt),
                    "max_tokens": max_tokens, "temperature": temperature,
                    "seed": seed})

    def collect(self, rid: str, timeout: Optional[float] = None) -> list:
        """Block until the request finishes; returns every event for it
        (token stream, then done/error/cancelled)."""
        deadline = time.monotonic() + (timeout or self.timeout)
        out = []
        while True:
            with self._qlock:
                q = self._queues[rid]
                ev = q.popleft() if q else None
                if not q:
                    self._events[rid].clear()
            if ev is not None:
                out.append(ev)
                if ev["event"] in ("done", "error", "cancelled"):
                    with self._qlock:
                        del self._queues[rid], self._events[rid]
                    return out
                continue
            if self._dead:
                raise ConnectionError("server connection lost")
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(f"request {rid} did not finish")
            self._events[rid].wait(timeout=min(remaining, 1.0))

    def generate(self, rid: str, prompt, max_tokens: int,
                 temperature: float = 0.0, seed: int = 0,
                 timeout: Optional[float] = None) -> list:
        self.start_generate(rid, prompt, max_tokens, temperature, seed)
        return self.collect(rid, timeout=timeout)

    def _plain_request(self, op: str, want_event: str,
                       timeout: float = 30.0) -> dict:
        self._send({"op": op})
        return self._wait_plain(want_event, timeout)

    def _wait_plain(self, want_event: str, timeout: float) -> dict:
        """The next id-less frame of kind ``want_event``; an id-less
        ``error`` frame in its place raises ``RuntimeError``."""
        deadline = time.monotonic() + timeout
        while True:
            while self._plain:
                ev = self._plain.popleft()
                if ev.get("event") == want_event:
                    return ev
                if ev.get("event") == "error":
                    raise RuntimeError(ev.get("error"))
            if self._dead:
                raise ConnectionError("server connection lost")
            if time.monotonic() > deadline:
                raise TimeoutError(f"no {want_event} reply")
            self._plain_ev.wait(timeout=0.5)
            self._plain_ev.clear()

    def stats(self) -> dict:
        return self._plain_request("stats", "stats")["stats"]

    def push_weights(self, frames: list, epoch: int,
                     timeout: float = 120.0) -> dict:
        """Push weight frames and wait for the ``weights_ack``.  A port
        replica answers with an error frame (not ported yet), raised
        here as ``RuntimeError``."""
        self._send({"op": "weights", "frames": list(frames),
                    "epoch": int(epoch)})
        return self._wait_plain("weights_ack", timeout)

    def ping(self) -> None:
        self._plain_request("ping", "pong")

    def shutdown(self) -> None:
        try:
            self._send({"op": "shutdown"})
        except OSError:
            pass

    def close(self) -> None:
        # shutdown() FIRST: the reader thread blocks in readinto()
        # holding the BufferedReader lock, and _file.close() takes that
        # same lock — without the wakeup (recv returns EOF) close would
        # deadlock against our own reader.
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._reader.join(timeout=10)
        # makefile() dup'd the fd: both must close or the server never
        # sees EOF (and never cancels this client's in-flight work).
        for closer in (self._file.close, self._sock.close):
            try:
                closer()
            except OSError:
                pass
