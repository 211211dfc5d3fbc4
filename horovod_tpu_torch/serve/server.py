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
    {"event": "requeued", "id": "r1"}   # via the router: the stream
                                        # restarts on a survivor
    {"event": "requeued", "id": "r1", "reason": "weights"}
    {"event": "weights_ack", "epoch": 3, "applied": true,
     "restarted": 2}

A ``weights`` push is decoded and parked by ``Scheduler.swap_weights``
(off the event loop: it blocks until the step boundary applies it); a
push that does not fit the model is answered with an error frame
(``"id": null``).  A plain client that disconnects has its in-flight
requests cancelled, so it cannot keep burning pool blocks.

Router sessions (link healing): a connection whose FIRST frame is
``{"op": "hello", "role": "router", "session": "<token>", "last_seq": N}``
gets durable stream state — a :class:`_RouterSession` owning the live
request set and a sequence-stamped event history.  On socket loss the
session PARKS (generation keeps running, events accumulate) for a grace
window instead of cancelling; the router reconnects, replays its token
in a new hello, and the replica re-sends exactly the events with
``seq > last_seq``.  A hello the replica cannot resume faithfully
(history aged out, or an unknown token with ``last_seq > 0``) answers
``resume: false`` so the router escalates to its kill/requeue path.

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

#: How long a parked router session survives without a reconnect before
#: its live requests are cancelled (pool blocks must not leak behind a
#: router that never comes back).  Above the router's whole retry
#: schedule (``resolve_link_retries`` attempts with sub-second backoff).
_PARK_GRACE_SEC = 15.0


class _RouterSession:
    """One router's durable stream state, surviving socket loss.

    ``seq`` stamps every stream event (token/done/error/cancelled) in
    emission order; ``history`` keeps the recent tail so a reconnecting
    router replays exactly the events it missed.  Control replies
    (stats/pong/hello_ack/bye) are connection-scoped and never recorded.
    """

    def __init__(self, token: str):
        self.token = token
        self.live: set = set()
        self.seq = 0
        self.history: deque = deque(maxlen=4096)
        #: the attached connection's queue; None while parked
        self.outbox: Optional[asyncio.Queue] = None
        self.park_handle: Optional[asyncio.TimerHandle] = None


def _request(msg: dict) -> Request:
    return Request(id=str(msg.get("id", "")),
                   prompt=[int(t) for t in msg["prompt"]],
                   max_tokens=int(msg["max_tokens"]),
                   temperature=float(msg.get("temperature", 0.0)),
                   seed=int(msg.get("seed", 0)))


class ReplicaServer:
    """Serves one Scheduler over asyncio TCP (JSON lines)."""

    def __init__(self, scheduler: Scheduler):
        self.scheduler = scheduler
        self._server: Optional[asyncio.AbstractServer] = None
        self.port: Optional[int] = None
        self._shutdown = asyncio.Event()
        self._conns: set = set()
        self._sessions: Dict[str, _RouterSession] = {}
        self._loop: Optional[asyncio.AbstractEventLoop] = None

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        self._loop = asyncio.get_running_loop()
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
        # Parked sessions must not outlive the server: their live
        # requests release pool blocks now, not at park expiry.
        for token in list(self._sessions):
            self._end_session(self._sessions[token])
        await asyncio.sleep(0)
        self.scheduler.stop()

    def shutdown(self) -> None:
        self._shutdown.set()

    def drop_connections(self) -> None:
        """Abort every open connection (fault injection: a transient link
        reset).  Router sessions park and heal; plain clients see the
        cancel-on-disconnect.  Threadsafe — callable from the scheduler
        thread's fault hook."""
        loop = self._loop
        if loop is None:
            return

        def _abort() -> None:
            for w in list(self._conns):
                try:
                    tr = w.transport
                    if tr is not None:
                        tr.abort()   # RST, not FIN: a real reset
                    else:
                        w.close()
                except (OSError, RuntimeError):
                    pass

        try:
            loop.call_soon_threadsafe(_abort)
        except RuntimeError:
            pass   # loop already gone — nothing left to drop

    # -- router sessions --

    def _end_session(self, sess: _RouterSession) -> None:
        """Forget the session and cancel whatever it still owns."""
        self._sessions.pop(sess.token, None)
        if sess.park_handle is not None:
            sess.park_handle.cancel()
            sess.park_handle = None
        for rid in list(sess.live):
            self.scheduler.cancel(rid)
        sess.live.clear()

    def _expire_session(self, token: str) -> None:
        sess = self._sessions.get(token)
        if sess is None or sess.outbox is not None:
            return   # reattached while the park timer was pending
        self._end_session(sess)

    def _session_emit(self, loop, sess: _RouterSession,
                      rid: str) -> Callable[[dict], None]:
        def emit(ev: dict) -> None:
            def push(ev=dict(ev)) -> None:
                if ev["event"] in ("done", "error", "cancelled"):
                    sess.live.discard(rid)
                sess.seq += 1
                ev["seq"] = sess.seq
                sess.history.append(ev)
                if sess.outbox is not None:
                    sess.outbox.put_nowait(ev)
            try:
                loop.call_soon_threadsafe(push)
            except RuntimeError:
                pass   # loop torn down mid-shutdown
        return emit

    # -- connections --

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        self._conns.add(writer)
        try:
            try:
                first = await reader.readline()
            except (ConnectionResetError, asyncio.IncompleteReadError):
                first = b""
            hello = None
            if first:
                try:
                    parsed = json.loads(first)
                    if isinstance(parsed, dict) \
                            and parsed.get("op") == "hello":
                        hello = parsed
                except json.JSONDecodeError:
                    pass
            if hello is not None:
                await self._handle_router(hello, reader, writer)
            else:
                await self._handle_plain(first, reader, writer)
        finally:
            self._conns.discard(writer)
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError, OSError):
                pass

    @staticmethod
    async def _write_loop(outbox: asyncio.Queue,
                          writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                ev = await outbox.get()
                if ev is None:
                    break
                writer.write((json.dumps(ev) + "\n").encode())
                await writer.drain()
        except (ConnectionResetError, BrokenPipeError, OSError):
            pass   # a session's events live on in its history

    async def _serve_ops(self, lines, outbox: asyncio.Queue,
                         submit: Callable[[Request], None]) -> bool:
        """Answer the frames of one connection until EOF or ``shutdown``;
        True when the connection asked for shutdown."""
        async for line in lines:
            try:
                msg = json.loads(line)
            except json.JSONDecodeError:
                outbox.put_nowait({"event": "error", "id": None,
                                   "error": "malformed frame"})
                continue
            op = msg.get("op")
            if op == "generate":
                try:
                    req = _request(msg)
                except (KeyError, TypeError, ValueError) as e:
                    outbox.put_nowait({"event": "error",
                                       "id": str(msg.get("id", "")),
                                       "error": f"bad request: {e}"})
                    continue
                submit(req)
            elif op == "cancel":
                self.scheduler.cancel(str(msg.get("id", "")))
            elif op == "stats":
                outbox.put_nowait({"event": "stats",
                                   "stats": self.scheduler.stats()})
            elif op == "ping":
                # The pong carries the scheduler heartbeat's age: the
                # front-end answers even when the scheduler THREAD is
                # wedged, so a probe must judge the scheduler, not the
                # socket (Router._probe_loop).
                outbox.put_nowait({
                    "event": "pong",
                    "sched_age_sec": round(
                        time.monotonic() - self.scheduler.last_beat, 3),
                    "counters": self.scheduler.metrics_counters()})
            elif op == "weights":
                # Decode + apply happen at the scheduler's step boundary;
                # swap_weights BLOCKS until installed, so it runs off the
                # event loop (pings keep being answered meanwhile).
                try:
                    ack = await asyncio.get_running_loop().run_in_executor(
                        None, self.scheduler.swap_weights,
                        int(msg.get("epoch", 0)), msg.get("frames") or [])
                    outbox.put_nowait({"event": "weights_ack", **ack})
                except (TimeoutError, ValueError, KeyError) as e:
                    outbox.put_nowait({"event": "error", "id": None,
                                       "error": f"weights push failed: {e}"})
            elif op == "shutdown":
                outbox.put_nowait({"event": "bye"})
                self.shutdown()
                return True
            elif op == "hello":
                pass   # a duplicate hello on a live link: ignore
            else:
                outbox.put_nowait({"event": "error", "id": None,
                                   "error": f"unknown op {op!r}"})
        return False

    @staticmethod
    async def _lines(reader: asyncio.StreamReader, first: bytes = b""):
        """The connection's frames, ``first`` (already read) leading."""
        if first:
            yield first
        try:
            while True:
                line = await reader.readline()
                if not line:
                    return
                yield line
        except (ConnectionResetError, asyncio.IncompleteReadError):
            return

    @staticmethod
    async def _close_outbox(outbox: asyncio.Queue,
                            wtask: asyncio.Future) -> None:
        outbox.put_nowait(None)
        try:
            await asyncio.wait_for(wtask, timeout=5)
        except (asyncio.TimeoutError, ConnectionResetError,
                BrokenPipeError):
            wtask.cancel()

    async def _handle_router(self, hello: dict,
                             reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter) -> None:
        loop = asyncio.get_running_loop()
        token = str(hello.get("session", ""))
        try:
            last_seq = int(hello.get("last_seq", 0) or 0)
        except (TypeError, ValueError):
            last_seq = 0
        sess = self._sessions.get(token)
        if sess is None and last_seq <= 0:
            sess = _RouterSession(token)
            self._sessions[token] = sess
        if sess is not None and sess.park_handle is not None:
            sess.park_handle.cancel()
            sess.park_handle = None
        # A session we no longer hold (park expired, or a restarted
        # replica), or one whose missed events aged out of the history,
        # cannot be made whole: refuse, so the router escalates.
        oldest = sess.history[0]["seq"] if sess is not None and \
            sess.history else (sess.seq + 1 if sess is not None else 0)
        if sess is None or (last_seq < sess.seq and oldest > last_seq + 1):
            if sess is not None:
                self._end_session(sess)
            try:
                writer.write((json.dumps(
                    {"event": "hello_ack", "session": token,
                     "resume": False}) + "\n").encode())
                await writer.drain()
            except (ConnectionResetError, BrokenPipeError, OSError):
                pass
            return
        outbox: asyncio.Queue = asyncio.Queue()
        sess.outbox = outbox
        # The ack carries the live set so the router re-sends generates
        # the replica never received (lost in flight during the reset);
        # the replay pushes exactly the unseen stream events, in order.
        outbox.put_nowait({"event": "hello_ack", "session": token,
                           "resume": True, "seq": sess.seq,
                           "live": sorted(sess.live)})
        for ev in sess.history:
            if ev["seq"] > last_seq:
                outbox.put_nowait(ev)
        wtask = asyncio.ensure_future(self._write_loop(outbox, writer))

        def submit(req: Request) -> None:
            sess.live.add(req.id)
            self.scheduler.submit(req, self._session_emit(loop, sess,
                                                          req.id))

        ended = False
        try:
            ended = await self._serve_ops(self._lines(reader), outbox,
                                          submit)
        finally:
            if sess.outbox is outbox:
                sess.outbox = None
            await self._close_outbox(outbox, wtask)
            if ended or self._shutdown.is_set():
                self._end_session(sess)
            elif sess.outbox is None and token in self._sessions:
                # Park: generation keeps running and events accumulate in
                # the history; the grace timer bounds how long a router
                # that never returns pins pool blocks.
                sess.park_handle = loop.call_later(
                    _PARK_GRACE_SEC, self._expire_session, token)

    async def _handle_plain(self, first: bytes,
                            reader: asyncio.StreamReader,
                            writer: asyncio.StreamWriter) -> None:
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

        def submit(req: Request) -> None:
            live.add(req.id)
            self.scheduler.submit(req, emit_threadsafe(req.id))

        wtask = asyncio.ensure_future(self._write_loop(outbox, writer))
        try:
            await self._serve_ops(self._lines(reader, first), outbox, submit)
        finally:
            # A vanished client must not keep burning pool blocks.
            for rid in list(live):
                self.scheduler.cancel(rid)
            await self._close_outbox(outbox, wtask)


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
        """Push weight frames and wait for the ``weights_ack`` (a replica's,
        or the router's with one entry per replica).  An error frame
        raises ``RuntimeError``."""
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
