"""Multi-replica routing: least-loaded dispatch + requeue-on-death.

Counterpart of ``horovod_tpu/serve/router.py``.  The router owns a fleet
of replicas (one ``horovod_tpu_torch.serve.replica`` process each, all on
the router's ``device``), speaks the same JSON-lines protocol to clients
on its front port, and forwards each ``generate`` to the live replica
with the fewest outstanding requests (index breaks ties).

Failure semantics, as the reference's:

* *shrink* — a replica death (connection loss or process exit) removes
  it from the routing set; every request it still owed is re-queued onto
  the survivors.  The client sees a ``requeued`` frame and the token
  stream restarts at index 0 — the ``done`` frame's ``tokens`` is always
  the complete output, so **no request is dropped**, only re-run
  (generation is deterministic per request: greedy, or seeded
  position-stable sampling).
* *wedge* — a replica whose scheduler thread hangs keeps answering pings
  with a stale heartbeat; the probe (``HOROVOD_SERVE_PROBE_SEC`` /
  ``_DEADLINE_SEC``) kills it, which routes it through the death path.
* *heal* — a transient socket loss first retries
  ``HOROVOD_SERVE_LINK_RETRIES`` reconnects into the replica's parked
  session, which replays the events the router missed.
* *rejoin* — the supervisor relaunches the dead replica (scrubbing
  ``HOROVOD_FAULT_INJECT``) up to the restart budget; once it prints
  READY and reconnects it rejoins the routing set.

With every replica down and no budget left, queued requests fail with a
clean error — the router never hangs a client.

Live weight pushes (``{"op": "weights", ...}``, from
``checkpoint.push.WeightPusher`` of either package) fan out to every live
replica; the router caches the latest frame and replays it to a
relaunched replica before that replica takes traffic, so a rejoin serves
the current pushed epoch, never boot-time weights (``weight_pushes``,
``weight_replays`` in the router's stats).

Observability: with ``HOROVOD_METRICS_PORT`` set, the router serves the
monitor plane's endpoint (``monitor/server.py``) and mounts its counters
as ``"serve"``: the router's own, ``replicas`` and ``replicas_alive``,
and the fleet-wide sum of each replica's latest scheduler counters (they
ride the probe pongs, so a scrape costs no round trip), as
``horovod_serve_*`` gauges on ``/metrics`` and key ``"serve"`` on
``/json``.  It prints ``SERVE_METRICS_READY port=P``.
"""

from __future__ import annotations

import asyncio
import json
import os
import re
import sys
import time
from collections import deque
from typing import Dict, List, Optional

from horovod_tpu_torch.serve.config import (resolve_link_retries,
                                            resolve_probe_knobs)

__all__ = ["Router", "serve_main"]

_READY_RE = re.compile(rb"SERVE_REPLICA_READY port=(\d+)")


async def _stop_process(proc: asyncio.subprocess.Process) -> None:
    """SIGTERM, then SIGKILL after 5 s."""
    try:
        proc.terminate()
        await asyncio.wait_for(proc.wait(), timeout=5)
    except ProcessLookupError:
        pass
    except asyncio.TimeoutError:
        proc.kill()
        await proc.wait()


class _Replica:
    def __init__(self, idx: int):
        self.idx = idx
        self.proc: Optional[asyncio.subprocess.Process] = None
        self.port: Optional[int] = None
        self.reader: Optional[asyncio.StreamReader] = None
        self.writer: Optional[asyncio.StreamWriter] = None
        self.pending: Dict[str, "_ClientConn"] = {}
        self.alive = False
        #: the replica's latest scheduler counters, piggybacked on pongs:
        #: summed into the /metrics "serve" mount
        self.metrics: Dict[str, int] = {}
        # Link healing (HOROVOD_SERVE_LINK_RETRIES): session token the
        # replica parks our stream state under across a socket loss,
        # the highest event seq we have PROCESSED (the replay cursor),
        # and whether a reconnect attempt is in flight (a healing
        # replica takes no new dispatches and no probe pings).
        self.session_token = ""
        self.last_seq = 0
        self.healing = False
        # Liveness probing (wedged-replica detection): when the last
        # HEALTHY pong — answered AND its scheduler heartbeat fresh —
        # was seen, reset on (re)spawn so a slow cold start is not
        # mistaken for a wedge.
        self.last_healthy = 0.0
        #: set by the supervisor once this replica can NEVER come back
        #: (clean exit, budget exhausted, or relaunch failed) — the
        #: router's queue-parking hope is "any replica not terminal".
        self.terminal = False
        self.stats_waiter: Optional[asyncio.Future] = None
        self.weights_waiter: Optional[asyncio.Future] = None
        # Serializes request/reply exchanges (stats, weight pushes):
        # concurrent clients must not clobber each other's waiter.
        self.stats_lock = asyncio.Lock()


class _ClientConn:
    _next_id = 0

    def __init__(self, writer: asyncio.StreamWriter):
        _ClientConn._next_id += 1
        self.cid = _ClientConn._next_id
        self.writer = writer
        self.outbox: asyncio.Queue = asyncio.Queue()
        self.live: Dict[str, str] = {}   # internal rid -> client rid

    def emit(self, ev: dict) -> None:
        self.outbox.put_nowait(ev)


class Router:
    def __init__(self, *, num_replicas: int, restart_budget: int = 0,
                 relaunch_delay: float = 0.0, host: str = "127.0.0.1",
                 port: int = 0, replica_env: Optional[dict] = None,
                 device: str = "cuda"):
        self.num_replicas = num_replicas
        #: the device every replica runs on (``--device`` of the replica)
        self.device = device
        self.restart_budget = restart_budget
        self.relaunch_delay = relaunch_delay
        self.host, self.port = host, port
        self.replica_env = dict(replica_env or {})
        self.replicas: List[_Replica] = [_Replica(i)
                                         for i in range(num_replicas)]
        self._reqs: Dict[str, dict] = {}    # internal rid -> request frame
        self._owners: Dict[str, _ClientConn] = {}
        self._queue: deque[str] = deque()   # awaiting a live replica
        self._restarts_left = restart_budget
        self._next_rid = 0
        self._shutdown = asyncio.Event()
        self._tasks: List[asyncio.Task] = []
        self.counters = {
            "dispatched": 0, "completed": 0, "requeued": 0,
            "replica_deaths": 0, "rejoins": 0, "failed": 0,
            "cancelled": 0, "wedged_kills": 0, "weight_pushes": 0,
            "weight_replays": 0, "link_reconnects": 0,
        }
        #: the latest weights frame pushed through the router, replayed
        #: to every relaunched replica BEFORE it takes load.
        self._last_push: Optional[dict] = None
        # Liveness probes for WEDGED (not dead) replicas: a replica whose
        # scheduler thread hangs keeps its socket open and its asyncio
        # front-end answering, so death detection alone never fires.  The
        # router pings every probe_sec; a replica with no HEALTHY pong —
        # answered, with a fresh scheduler heartbeat — inside
        # probe_deadline_sec is killed, which routes it through the
        # normal death path: in-flight requests requeue onto survivors
        # and the supervisor relaunches it under the restart budget
        # (fault schedule scrubbed).  probe_sec <= 0 disables.  Resolved
        # by serve.config.resolve_probe_knobs (the deadline default is
        # sized for in-phase first-use work: a kernel build, a capture).
        self.probe_sec, self.probe_deadline_sec = resolve_probe_knobs()
        # Control-link healing budget: a transient replica-socket failure
        # retries this many reconnects (the replica parks our session and
        # replays missed events) before the honest fallback — the
        # kill/requeue/relaunch death path.  0 disables: plain links.
        self.link_retries = resolve_link_retries()
        self._spawn_count = 0

    # -- replica lifecycle --

    async def _spawn(self, rep: _Replica, scrub_fault: bool) -> None:
        env = dict(os.environ)
        env.update(self.replica_env)
        env["HOROVOD_REPLICA_ID"] = str(rep.idx)
        # The replica must import this exact package even when the
        # launcher was started outside the repo or without installation.
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH",
                                                            "")
        if scrub_fault:
            # A relaunched incarnation must not re-fire the injected
            # fault (same contract as run.py --restart-on-failure).
            env.pop("HOROVOD_FAULT_INJECT", None)
        rep.proc = await asyncio.create_subprocess_exec(
            sys.executable, "-m", "horovod_tpu_torch.serve.replica",
            "--port", "0", "--device", self.device, env=env,
            stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.STDOUT)
        # Pump output; the READY line carries the ephemeral port.
        ready = asyncio.get_running_loop().create_future()

        async def pump(proc=rep.proc) -> None:
            async for line in proc.stdout:
                m = _READY_RE.search(line)
                if m and not ready.done():
                    ready.set_result(int(m.group(1)))
                sys.stdout.write(f"[replica {rep.idx}] "
                                 f"{line.decode(errors='replace')}")
                sys.stdout.flush()
            if not ready.done():
                ready.set_exception(
                    RuntimeError(f"replica {rep.idx} exited before READY"))

        self._tasks.append(asyncio.ensure_future(pump()))
        rep.port = await asyncio.wait_for(ready, timeout=300)
        for attempt in range(50):
            try:
                # The replica's own stream limit: a large frame must not
                # sever the connection at the 64 KiB readline default.
                rep.reader, rep.writer = await asyncio.open_connection(
                    "127.0.0.1", rep.port, limit=1 << 26)
                break
            except OSError:
                await asyncio.sleep(0.1)
        else:
            raise RuntimeError(f"cannot connect to replica {rep.idx}")
        rep.healing = False
        rep.last_seq = 0
        self._spawn_count += 1
        rep.session_token = f"r{rep.idx}.{self._spawn_count}"
        if self.link_retries > 0:
            # Open a durable session so a transient socket loss parks
            # our stream state replica-side instead of cancelling it.
            rep.writer.write((json.dumps(
                {"op": "hello", "role": "router",
                 "session": rep.session_token, "last_seq": 0})
                + "\n").encode())
            await rep.writer.drain()
        rep.alive = True
        rep.last_healthy = time.monotonic()
        self._tasks.append(asyncio.ensure_future(self._replica_reader(rep)))
        self._tasks.append(asyncio.ensure_future(self._supervise(rep)))

    async def _supervise(self, rep: _Replica) -> None:
        proc = rep.proc
        rc = await proc.wait()
        if self._shutdown.is_set():
            return
        self._on_replica_down(rep)
        if rc == 0 or self._restarts_left <= 0:
            rep.terminal = True
            self._fail_queue_if_hopeless()
            return
        self._restarts_left -= 1
        sys.stderr.write(
            f"replica {rep.idx} exited with code {rc}; relaunching "
            f"({self._restarts_left} restarts left)\n")
        sys.stderr.flush()
        if self.relaunch_delay > 0:
            await asyncio.sleep(self.relaunch_delay)
        try:
            await self._spawn(rep, scrub_fault=True)
        except (RuntimeError, OSError, asyncio.TimeoutError) as e:
            if not self._shutdown.is_set():   # not noise mid-teardown
                sys.stderr.write(f"replica {rep.idx} relaunch "
                                 f"failed: {e}\n")
                rep.terminal = True
                self._fail_queue_if_hopeless()
            return
        if self._last_push is not None:
            # The relaunched replica rebuilt boot-time weights (seed or
            # checkpoint): replay the latest pushed frame before it takes
            # load, so the whole fleet serves one weight epoch.
            ack = await self._push_weights_rep(rep, self._last_push)
            if ack is not None:
                self.counters["weight_replays"] += 1
            else:
                sys.stderr.write(
                    f"replica {rep.idx} rejoined but the weight replay "
                    f"failed; it may serve a stale epoch until the "
                    f"next push\n")
                sys.stderr.flush()
        self.counters["rejoins"] += 1
        self._drain_queue()

    def _fail_queue_if_hopeless(self) -> None:
        """Error out parked requests once no replica can ever serve them
        — the no-hang guarantee.  Hope is "some replica is not
        terminal": its supervisor has not yet concluded (it may still
        relaunch with remaining budget), or it is alive.  Leftover
        budget with every supervisor concluded is NOT hope — nothing
        will ever spend it (a clean rc-0 exit, budget exhaustion, or a
        failed relaunch ends a supervisor for good)."""
        if any(not r.terminal for r in self.replicas):
            return
        for rid in list(self._queue):
            self._queue.remove(rid)
            client = self._owners.get(rid)
            if client is not None:
                self.counters["failed"] += 1
                client.emit({"event": "error", "id": client.live.get(rid),
                             "error": "no live replica and no restart "
                                      "budget left"})
            self._forget(rid)

    def _on_replica_down(self, rep: _Replica) -> None:
        if not rep.alive:
            return
        rep.alive = False
        self.counters["replica_deaths"] += 1
        if rep.writer is not None:
            try:
                rep.writer.close()
            except OSError:
                pass
        if rep.stats_waiter is not None and not rep.stats_waiter.done():
            rep.stats_waiter.set_result(None)
        if rep.weights_waiter is not None \
                and not rep.weights_waiter.done():
            rep.weights_waiter.set_result(None)
        orphans = list(rep.pending)
        rep.pending.clear()
        for rid in orphans:
            client = self._owners.get(rid)
            if client is None:
                continue
            self.counters["requeued"] += 1
            client.emit({"event": "requeued", "id": client.live.get(rid)})
            self._dispatch(rid)

    async def _replica_reader(self, rep: _Replica) -> None:
        try:
            while True:
                line = await rep.reader.readline()
                if not line:
                    break
                ev = json.loads(line)
                seq = ev.pop("seq", None)
                if seq is not None:
                    # Replay cursor for link healing: the highest event
                    # we processed.  Popped so downstream client frames
                    # stay byte-identical to the sessionless protocol.
                    rep.last_seq = max(rep.last_seq, int(seq))
                if ev.get("event") == "hello_ack":
                    continue   # fresh-session ack (resume handled in
                               # _heal_link's inline exchange)
                if ev.get("event") == "stats":
                    if rep.stats_waiter is not None \
                            and not rep.stats_waiter.done():
                        rep.stats_waiter.set_result(ev["stats"])
                    continue
                if ev.get("event") == "weights_ack" or (
                        ev.get("event") == "error" and ev.get("id") is None
                        and str(ev.get("error", "")).startswith(
                            "weights push failed")):
                    if rep.weights_waiter is not None \
                            and not rep.weights_waiter.done():
                        rep.weights_waiter.set_result(ev)
                    continue
                if ev.get("event") == "pong":
                    # Healthy = the asyncio side answered AND the
                    # scheduler thread's heartbeat is FRESH — a wedged
                    # scheduler behind a live socket must not refresh
                    # the liveness clock.  Freshness is judged against a
                    # few probe intervals, NOT the kill deadline: a pong
                    # whose heartbeat is already deadline-old refreshing
                    # the clock would double the effective detection
                    # latency (stale clock only starts after the beat
                    # has been stale a whole deadline).  The deadline
                    # itself remains the grace for legitimately long
                    # single phases (a first-use kernel build or capture).
                    age = ev.get("sched_age_sec")
                    fresh = min(self.probe_deadline_sec,
                                max(2 * self.probe_sec, 5.0))
                    if age is None or age <= fresh:
                        rep.last_healthy = time.monotonic()
                    counters = ev.get("counters")
                    if isinstance(counters, dict):
                        rep.metrics = counters
                    continue
                rid = ev.get("id")
                client = self._owners.get(rid)
                if client is None:
                    continue   # cancelled/disconnected client
                ev["id"] = client.live.get(rid)
                if ev["event"] in ("done", "error", "cancelled"):
                    rep.pending.pop(rid, None)
                    self._forget(rid)
                    self.counters[{"done": "completed",
                                   "error": "failed",
                                   "cancelled": "cancelled"}
                                  [ev["event"]]] += 1
                client.emit(ev)
        except (ConnectionResetError, json.JSONDecodeError, OSError):
            pass
        await self._heal_or_down(rep)

    # -- link healing (HOROVOD_SERVE_LINK_RETRIES) --

    async def _heal_or_down(self, rep: _Replica) -> None:
        """A broken replica socket first tries a bounded reconnect (the
        replica parked our session and replays the events we missed);
        only when healing is off, the process is actually gone, or every
        attempt fails does it escalate to the battle-tested death path
        (requeue in-flight work + supervisor relaunch)."""
        if (self.link_retries <= 0 or self._shutdown.is_set()
                or rep.healing or not rep.alive
                or rep.proc is None or rep.proc.returncode is not None):
            self._on_replica_down(rep)
            return
        rep.healing = True
        try:
            for attempt in range(self.link_retries):
                await asyncio.sleep(0.2 * (attempt + 1))
                if (self._shutdown.is_set() or not rep.alive
                        or rep.proc.returncode is not None):
                    break   # real death: its path already ran/will run
                if await self._heal_link(rep):
                    rep.healing = False
                    self.counters["link_reconnects"] += 1
                    sys.stderr.write(
                        f"replica {rep.idx} control link healed "
                        f"(attempt {attempt + 1}/"
                        f"{self.link_retries})\n")
                    sys.stderr.flush()
                    self._tasks.append(asyncio.ensure_future(
                        self._replica_reader(rep)))
                    self._drain_queue()
                    return
        finally:
            rep.healing = False
        self._on_replica_down(rep)

    async def _heal_link(self, rep: _Replica) -> bool:
        """One reconnect + resume exchange.  True iff the replica
        accepted the resume — the new socket is installed and every
        pending generate it never received has been re-sent."""
        try:
            reader, writer = await asyncio.open_connection(
                "127.0.0.1", rep.port, limit=1 << 26)
        except OSError:
            return False
        try:
            writer.write((json.dumps(
                {"op": "hello", "role": "router",
                 "session": rep.session_token,
                 "last_seq": rep.last_seq}) + "\n").encode())
            await writer.drain()
            line = await asyncio.wait_for(reader.readline(), timeout=10)
            ack = json.loads(line) if line else {}
            if not (ack.get("event") == "hello_ack"
                    and ack.get("resume")):
                raise OSError("resume refused")
            rep.reader, rep.writer = reader, writer
            # Generates lost in flight during the reset: dispatched on
            # our books but absent from the replica's live set.
            seen = set(ack.get("live") or [])
            for rid in list(rep.pending):
                if rid in seen or rid not in self._reqs:
                    continue
                frame = dict(self._reqs[rid])
                frame["id"] = rid
                rep.writer.write((json.dumps(frame) + "\n").encode())
            await rep.writer.drain()
            return True
        except (OSError, asyncio.TimeoutError, json.JSONDecodeError,
                ValueError):
            try:
                writer.close()
            except OSError:
                pass
            return False

    # -- dispatch --

    def _forget(self, rid: str) -> None:
        self._reqs.pop(rid, None)
        client = self._owners.pop(rid, None)
        if client is not None:
            client.live.pop(rid, None)

    def _pick(self) -> Optional[_Replica]:
        # A healing replica is alive but its socket is mid-reconnect:
        # no new dispatches until the link is back (park in the queue —
        # _heal_or_down drains it either way).
        live = [r for r in self.replicas if r.alive and not r.healing]
        if not live:
            return None
        return min(live, key=lambda r: (len(r.pending), r.idx))

    def _dispatch(self, rid: str) -> None:
        rep = self._pick()
        if rep is None:
            # Park only while some replica is not terminal (its
            # supervisor may still relaunch it) — see
            # _fail_queue_if_hopeless.
            if any(not r.terminal for r in self.replicas):
                self._queue.append(rid)   # a rejoin may still come
            else:
                client = self._owners.get(rid)
                if client is not None:
                    self.counters["failed"] += 1
                    client.emit({"event": "error",
                                 "id": client.live.get(rid),
                                 "error": "no live replica and no restart "
                                          "budget left"})
                self._forget(rid)
            return
        frame = dict(self._reqs[rid])
        frame["id"] = rid
        rep.pending[rid] = self._owners[rid]
        try:
            rep.writer.write((json.dumps(frame) + "\n").encode())
        except (ConnectionResetError, OSError):
            self._on_replica_down(rep)

    def _drain_queue(self) -> None:
        pending = list(self._queue)
        self._queue.clear()
        for rid in pending:
            self._dispatch(rid)

    # -- live weight pushes --

    async def _push_weights_rep(self, rep: _Replica, frame: dict,
                                timeout: float = 90.0) -> Optional[dict]:
        """One replica's weights exchange: its ``weights_ack`` (or error
        frame); ``None`` on death or timeout (the death path owns the
        failure: its requests requeue and the cached frame replays on the
        relaunch).  A replica mid-link-heal is skipped the same way."""
        if not rep.alive or rep.healing:
            return None
        async with rep.stats_lock:
            rep.weights_waiter = asyncio.get_running_loop() \
                .create_future()
            try:
                rep.writer.write((json.dumps(frame) + "\n").encode())
                await rep.writer.drain()
                return await asyncio.wait_for(rep.weights_waiter,
                                              timeout=timeout)
            except (asyncio.TimeoutError, OSError):
                return None
            finally:
                rep.weights_waiter = None

    # -- liveness probes (wedged-replica detection) --

    async def _probe_loop(self) -> None:
        while not self._shutdown.is_set():
            await asyncio.sleep(self.probe_sec)
            if self._shutdown.is_set():
                return
            now = time.monotonic()
            for rep in self.replicas:
                if not rep.alive or rep.healing or rep.proc is None:
                    continue
                stale = now - rep.last_healthy
                if stale > self.probe_deadline_sec:
                    # Kill, don't just mark down: the process is alive
                    # but useless, and killing it routes everything
                    # through the one battle-tested failure path — the
                    # supervisor requeues its in-flight requests onto
                    # survivors and relaunches it under the restart
                    # budget with the fault schedule scrubbed.
                    self.counters["wedged_kills"] += 1
                    sys.stderr.write(
                        f"replica {rep.idx} is wedged (no healthy pong "
                        f"for {stale:.1f}s > "
                        f"{self.probe_deadline_sec:.1f}s deadline); "
                        f"killing it so its requests requeue\n")
                    sys.stderr.flush()
                    try:
                        rep.proc.kill()
                    except ProcessLookupError:
                        pass
                    continue
                try:
                    rep.writer.write(b'{"op": "ping"}\n')
                except (ConnectionResetError, OSError):
                    self._on_replica_down(rep)

    # -- client side --

    async def _handle_client(self, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter) -> None:
        client = _ClientConn(writer)

        async def write_loop() -> None:
            while True:
                ev = await client.outbox.get()
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
                    client.emit({"event": "error", "id": None,
                                 "error": "malformed frame"})
                    continue
                op = msg.get("op")
                if op == "generate":
                    self._next_rid += 1
                    rid = f"q{client.cid}.{self._next_rid}"
                    self._reqs[rid] = {k: msg[k] for k in
                                       ("prompt", "max_tokens")
                                       if k in msg}
                    self._reqs[rid]["op"] = "generate"
                    for k in ("temperature", "seed"):
                        if k in msg:
                            self._reqs[rid][k] = msg[k]
                    self._owners[rid] = client
                    client.live[rid] = str(msg.get("id", rid))
                    self.counters["dispatched"] += 1
                    self._dispatch(rid)
                elif op == "cancel":
                    want = str(msg.get("id", ""))
                    for rid, crid in list(client.live.items()):
                        if crid != want:
                            continue
                        for rep in self.replicas:
                            if rid in rep.pending and rep.alive:
                                rep.writer.write((json.dumps(
                                    {"op": "cancel", "id": rid})
                                    + "\n").encode())
                        if rid in self._queue:
                            self._queue.remove(rid)
                            client.emit({"event": "cancelled", "id": want})
                            self._forget(rid)
                elif op == "weights":
                    frame = {"op": "weights",
                             "frames": msg.get("frames") or [],
                             "epoch": int(msg.get("epoch", 0))}
                    # Cache FIRST: a replica that dies mid-push gets the
                    # frame replayed when it rejoins.
                    previous, self._last_push = self._last_push, frame
                    self.counters["weight_pushes"] += 1
                    acks = []
                    for rep in self.replicas:
                        ack = await self._push_weights_rep(rep, frame)
                        if ack is None:
                            continue
                        if ack.get("event") == "error":
                            # A push that does not fit the model: no
                            # replica applied it, none replays it.
                            self._last_push = previous
                            client.emit({"event": "error", "id": None,
                                         "error": ack.get("error")})
                            break
                        acks.append({
                            "replica": rep.idx,
                            "applied": ack.get("applied"),
                            "epoch": ack.get("epoch"),
                            "restarted": ack.get("restarted")})
                    else:
                        client.emit({"event": "weights_ack",
                                     "epoch": frame["epoch"],
                                     "replicas": acks})
                elif op == "stats":
                    client.emit({"event": "stats",
                                 "stats": await self._gather_stats()})
                elif op == "ping":
                    client.emit({"event": "pong"})
                elif op == "shutdown":
                    client.emit({"event": "bye"})
                    self._shutdown.set()
                    break
                else:
                    client.emit({"event": "error", "id": None,
                                 "error": f"unknown op {op!r}"})
        except (ConnectionResetError, asyncio.IncompleteReadError):
            pass
        finally:
            for rid in list(client.live):
                for rep in self.replicas:
                    if rid in rep.pending and rep.alive:
                        try:
                            rep.writer.write((json.dumps(
                                {"op": "cancel", "id": rid}) + "\n")
                                .encode())
                        except OSError:
                            pass
                        rep.pending.pop(rid, None)
                if rid in self._queue:
                    self._queue.remove(rid)
                self._forget(rid)
            client.outbox.put_nowait(None)
            try:
                await asyncio.wait_for(wtask, timeout=5)
            except (asyncio.TimeoutError, ConnectionResetError,
                    BrokenPipeError):
                wtask.cancel()
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError, OSError):
                pass

    async def _gather_stats(self) -> dict:
        out = {"router": dict(self.counters)}
        out["router"]["queue_depth"] = len(self._queue)
        out["router"]["restarts_left"] = self._restarts_left
        reps = []
        for rep in self.replicas:
            entry = {"replica": rep.idx, "alive": rep.alive,
                     "pending": len(rep.pending)}
            if rep.alive and not rep.healing:
                async with rep.stats_lock:
                    rep.stats_waiter = asyncio.get_running_loop() \
                        .create_future()
                    try:
                        rep.writer.write(b'{"op": "stats"}\n')
                        stats = await asyncio.wait_for(rep.stats_waiter,
                                                       timeout=10)
                        if stats is not None:
                            entry["scheduler"] = stats
                    except (asyncio.TimeoutError, OSError):
                        pass
                    finally:
                        rep.stats_waiter = None
            reps.append(entry)
        out["replicas"] = reps
        return out

    # -- entry --

    def router_stats(self) -> dict:
        """The ``"serve"`` mount: the router's counters, ``replicas`` and
        ``replicas_alive``, and each replica scheduler's latest counters
        summed over the fleet."""
        out = dict(self.counters)
        out["replicas"] = self.num_replicas
        out["replicas_alive"] = sum(1 for r in self.replicas if r.alive)
        totals: Dict[str, int] = {}
        for r in self.replicas:
            for k, v in r.metrics.items():
                if isinstance(v, (int, float)):
                    totals[k] = totals.get(k, 0) + v
        out.update(totals)
        return out

    def _mount_metrics(self) -> None:
        """Start the metrics endpoint on ``HOROVOD_METRICS_PORT`` and
        mount :meth:`router_stats` as ``"serve"``.  A port that cannot be
        bound costs the endpoint, with a message, not the fleet."""
        from horovod_tpu_torch.monitor.server import (get_metrics_server,
                                                      start_metrics_server)
        try:
            mport = start_metrics_server(
                int(os.environ["HOROVOD_METRICS_PORT"]), dict, dict)
        except (OSError, RuntimeError, ValueError) as exc:
            print(f"serve metrics endpoint disabled: {exc}", flush=True)
            return
        get_metrics_server().mount("serve", self.router_stats)
        print(f"SERVE_METRICS_READY port={mport}", flush=True)

    async def run(self) -> int:
        t0 = time.monotonic()
        try:
            await asyncio.gather(*[self._spawn(rep, scrub_fault=False)
                                   for rep in self.replicas])
        except BaseException:
            # Partial fleet startup must not leak the replicas that DID
            # launch (the gate checks for exactly this).
            for rep in self.replicas:
                if rep.proc is not None and rep.proc.returncode is None:
                    rep.proc.kill()
                    await rep.proc.wait()
            raise
        # limit: a weights push is one (large) JSON line from a client.
        server = await asyncio.start_server(self._handle_client, self.host,
                                            self.port, limit=1 << 26)
        if self.probe_sec > 0:
            self._tasks.append(asyncio.ensure_future(self._probe_loop()))
        port = server.sockets[0].getsockname()[1]
        if os.environ.get("HOROVOD_METRICS_PORT", "") not in ("", "0"):
            self._mount_metrics()
        print(f"SERVE_ROUTER_READY port={port} replicas="
              f"{self.num_replicas} startup_sec="
              f"{time.monotonic() - t0:.1f}", flush=True)
        await self._shutdown.wait()
        server.close()
        await server.wait_closed()
        # Clean teardown: a polite shutdown frame to every connected
        # replica; one still starting (a relaunch) got none and is
        # stopped at once, as is a replica that does not exit.
        polite = set()
        for rep in self.replicas:
            if rep.alive and rep.writer is not None:
                try:
                    rep.writer.write(b'{"op": "shutdown"}\n')
                    polite.add(rep.idx)
                except OSError:
                    pass
        for rep in self.replicas:
            if rep.proc is None or rep.proc.returncode is not None:
                continue
            if rep.idx in polite:
                try:
                    await asyncio.wait_for(rep.proc.wait(), timeout=10)
                    continue
                except asyncio.TimeoutError:
                    pass
            await _stop_process(rep.proc)
        for task in self._tasks:
            if not task.done():
                task.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        # A relaunch cancelled while starting may have left its process.
        for rep in self.replicas:
            if rep.proc is not None and rep.proc.returncode is None:
                await _stop_process(rep.proc)
        return 0


def serve_main(args) -> int:
    """The ``run.py --serve`` entry: router + replica fleet.

    ``--serve-model`` is EITHER a LlamaConfig constructor name
    (``llama3_8b``, ``tiny``, ...) or a checkpoint directory: a directory
    makes every replica load the newest complete checkpoint's params
    (``HOROVOD_SERVE_CHECKPOINT``); the model name rides the manifest's
    ``meta.model`` when the trainer recorded one.
    """
    replica_env = {}
    model_arg = getattr(args, "serve_model", None)
    if model_arg and os.path.isdir(model_arg):
        from horovod_tpu_torch.checkpoint import latest_manifest

        found = latest_manifest(model_arg)
        if found is None:
            sys.stderr.write(
                f"--serve-model {model_arg}: directory holds no "
                "complete checkpoint manifest\n")
            return 1
        manifest, step = found
        replica_env["HOROVOD_SERVE_CHECKPOINT"] = model_arg
        meta_model = (manifest.get("meta") or {}).get("model")
        if meta_model:
            replica_env["HOROVOD_SERVE_MODEL"] = str(meta_model)
        print(f"serving checkpoint step {step} from {model_arg}",
              flush=True)
    elif model_arg:
        replica_env["HOROVOD_SERVE_MODEL"] = model_arg
    router = Router(
        num_replicas=max(1, args.replicas),
        restart_budget=max(0, args.restart_on_failure),
        relaunch_delay=max(0.0, args.relaunch_delay_sec),
        port=args.serve_port,
        replica_env=replica_env,
        device=args.device)
    try:
        return asyncio.run(router.run())
    except KeyboardInterrupt:
        return 130
