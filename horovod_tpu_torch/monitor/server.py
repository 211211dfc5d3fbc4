"""Live metrics endpoint: Prometheus text + JSON over HTTP.

Counterpart of ``horovod_tpu/monitor/server.py``; the port's process has
its own singleton.

Rank 0 serves the fleet view of a running job on
``HOROVOD_METRICS_PORT`` (started by ``hvd.init`` when the port is set;
provably off when unset — no thread, no socket).  Same asyncio patterns
as ``serve/server.py``, but speaking just enough HTTP/1.1 for curl,
Prometheus scrapers and ``python -m horovod_tpu_torch.run --status``:

    GET /metrics   Prometheus text exposition (rank-0 stats + fleet table)
    GET /json      {"stats": ..., "fleet": ..., <mounted providers>}
    GET /fleet     the fleet table alone
    GET /healthz   200 "ok"

Additional stats providers mount on the same endpoint (the serve
plane's router mounts its replica stats as ``"serve"``); each provider
is a zero-arg callable returning a dict, called per request so the
response is always live.
"""

from __future__ import annotations

import asyncio
import json
import threading
from typing import Callable, Dict, Optional

from horovod_tpu_torch.monitor.metrics import render_json, render_prometheus

__all__ = ["MetricsServer", "start_metrics_server", "stop_metrics_server",
           "query_status", "format_status"]


class MetricsServer:
    """Tiny HTTP/1.1 server over asyncio streams, run in its own daemon
    thread (the engine's API threads must never block on a scrape)."""

    def __init__(self, port: int, host: str = "0.0.0.0",
                 stats_provider: Optional[Callable[[], dict]] = None,
                 fleet_provider: Optional[Callable[[], dict]] = None):
        self._host = host
        self._port_req = port
        self.port: Optional[int] = None
        self._stats = stats_provider
        self._fleet = fleet_provider
        self._extra: Dict[str, Callable[[], dict]] = {}
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        self._stop = None  # asyncio.Event, created on the loop

    def mount(self, name: str, provider: Callable[[], dict]) -> None:
        """Expose another stats dict on /json (key ``name``) and as
        ``horovod_<name>_*`` gauges on /metrics."""
        self._extra[name] = provider

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> int:
        """Start the serving thread; returns the bound port."""
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="horovod-metrics")
        self._thread.start()
        self._started.wait(timeout=10)
        if self.port is None:
            raise RuntimeError(
                f"metrics endpoint failed to bind {self._host}:"
                f"{self._port_req}")
        return self.port

    def stop(self) -> None:
        loop, stop = self._loop, self._stop
        if loop is not None and stop is not None:
            loop.call_soon_threadsafe(stop.set)
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _run(self) -> None:
        asyncio.run(self._serve())

    async def _serve(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._stop = asyncio.Event()
        try:
            server = await asyncio.start_server(self._handle, self._host,
                                                self._port_req)
        except OSError as exc:
            import sys

            print(f"horovod_tpu_torch: metrics endpoint bind failed: {exc}",
                  file=sys.stderr)
            self._started.set()
            return
        self.port = server.sockets[0].getsockname()[1]
        self._started.set()
        await self._stop.wait()
        server.close()
        await server.wait_closed()

    # -- request handling --------------------------------------------------

    def _gather(self):
        def safe(fn):
            try:
                return fn() if fn is not None else {}
            except Exception as exc:  # a dying engine must not 500 forever
                return {"error": str(exc)}

        stats = safe(self._stats)
        fleet = safe(self._fleet)
        extra = {name: safe(fn) for name, fn in self._extra.items()}
        return stats, fleet, extra

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            request = await asyncio.wait_for(reader.readline(), timeout=10)
            parts = request.decode(errors="replace").split()
            path = parts[1] if len(parts) >= 2 else "/"
            # Drain headers (ignored — no body on GET).
            while True:
                line = await asyncio.wait_for(reader.readline(), timeout=10)
                if line in (b"\r\n", b"\n", b""):
                    break
            status, ctype, body = self._route(path)
            payload = body.encode()
            writer.write(
                (f"HTTP/1.1 {status}\r\n"
                 f"Content-Type: {ctype}\r\n"
                 f"Content-Length: {len(payload)}\r\n"
                 "Connection: close\r\n\r\n").encode() + payload)
            await writer.drain()
        except (asyncio.TimeoutError, OSError, asyncio.IncompleteReadError):
            pass
        finally:
            try:
                writer.close()
            except OSError:
                pass

    def _route(self, path: str):
        path = path.split("?", 1)[0]
        if path == "/healthz":
            return "200 OK", "text/plain", "ok\n"
        if path == "/metrics":
            stats, fleet, extra = self._gather()
            return ("200 OK", "text/plain; version=0.0.4",
                    render_prometheus(stats, fleet, extra))
        if path in ("/json", "/"):
            stats, fleet, extra = self._gather()
            return ("200 OK", "application/json",
                    json.dumps(render_json(stats, fleet, extra)) + "\n")
        if path == "/fleet":
            _, fleet, _ = self._gather()
            return ("200 OK", "application/json",
                    json.dumps(fleet or {}) + "\n")
        return "404 Not Found", "text/plain", "not found\n"


# -- module-level singleton (hvd.init / hvd.shutdown lifecycle) ------------

_server: Optional[MetricsServer] = None
_server_lock = threading.Lock()


def start_metrics_server(port: int,
                         stats_provider: Callable[[], dict],
                         fleet_provider: Callable[[], dict]) -> int:
    """Start (or reuse) the process-wide metrics endpoint; returns the
    bound port.  Called by ``hvd.init`` on rank 0 when
    HOROVOD_METRICS_PORT is set."""
    global _server
    with _server_lock:
        if _server is not None:
            return _server.port or 0
        srv = MetricsServer(port, stats_provider=stats_provider,
                            fleet_provider=fleet_provider)
        bound = srv.start()
        _server = srv
        return bound


def get_metrics_server() -> Optional[MetricsServer]:
    return _server


def stop_metrics_server() -> None:
    global _server
    with _server_lock:
        if _server is not None:
            _server.stop()
            _server = None


# -- shell-side status client (`python -m horovod_tpu_torch.run --status`) ------

def query_status(addr: str, timeout: float = 5.0) -> dict:
    """GET http://<addr>/json from a live job's metrics endpoint."""
    import urllib.request

    if "://" not in addr:
        addr = f"http://{addr}"
    with urllib.request.urlopen(f"{addr}/json", timeout=timeout) as resp:
        return json.loads(resp.read().decode(errors="replace"))


def format_status(payload: dict) -> str:
    """Human summary of a /json payload for the --status CLI (the
    reference's text, heading included, so either package's ``--status``
    reads a job of the other alike)."""
    stats = payload.get("stats", {}) or {}
    fleet = payload.get("fleet", {}) or {}
    lines = ["== horovod_tpu live job status =="]
    cfg = stats.get("config", {}) or {}
    lines.append(
        f"epoch {fleet.get('epoch', '?')} · world {fleet.get('world_size', '?')}"
        f" · hosts {fleet.get('hosts', '?')} · ranks reporting "
        f"{fleet.get('ranks_reporting', 0)} · telemetry every "
        f"{fleet.get('telemetry_cycles', cfg.get('telemetry_cycles', '?'))}"
        " cycles")
    totals = fleet.get("totals", {}) or {}
    if totals:
        gib = 1024.0 ** 3
        lines.append(
            f"fleet: data_tx {totals.get('data_bytes_tx', 0) / gib:.3f} GiB"
            f" · allreduce {totals.get('allreduce_bytes', 0) / gib:.3f} GiB"
            f" · round_trips {totals.get('control_round_trips', 0)}"
            f" · cache_hits {totals.get('cache_hits', 0)}"
            f" · stall_warnings {totals.get('stall_warnings', 0)}"
            f" · backup_skips {totals.get('backup_skips', 0)}")
    slow = fleet.get("slowest", {}) or {}
    if slow.get("rank", -1) >= 0:
        lines.append(
            f"slowest rank: {slow['rank']} "
            f"(step p99 {slow.get('step_time_ns_p99', 0) / 1e6:.2f} ms); "
            f"fleet quorum lag p50/p99 "
            f"{fleet.get('quorum_lag_ns_p50', 0) / 1e6:.2f}/"
            f"{fleet.get('quorum_lag_ns_p99', 0) / 1e6:.2f} ms")
    lag_by_rank = fleet.get("quorum_lag_by_rank", {}) or {}
    for row in fleet.get("rows", []) or []:
        c = row.get("counters", {})
        attr = lag_by_rank.get(str(row.get("rank")), {})
        lines.append(
            f"  row rank {row.get('rank')} (host {row.get('host')}, "
            f"nranks {row.get('nranks')}): data_tx {c.get('data_bytes_tx', 0)}"
            f" · tensors {c.get('tensors', 0)}"
            f" · step p99 {row.get('step_time_ns_p99', 0) / 1e6:.2f} ms"
            f" · lag attributions {attr.get('attributions', 0)}")
    for name, values in payload.items():
        if name in ("stats", "fleet") or not isinstance(values, dict):
            continue
        keys = ", ".join(f"{k}={v}" for k, v in sorted(values.items())
                         if isinstance(v, (int, float)))
        if keys:
            lines.append(f"{name}: {keys}")
    return "\n".join(lines)
