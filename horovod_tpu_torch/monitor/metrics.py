"""Metric registry + Prometheus/JSON renderers for the live endpoint.

Counterpart of ``horovod_tpu/monitor/metrics.py``: the same metric names,
help strings and renderings byte for byte, so one scrape configuration
reads a job of either package.

One table drives everything: the ``/metrics`` Prometheus text, the
``/json`` payload shape, and the reference table in
docs/observability.md (regenerate with
``python -c "from horovod_tpu_torch.monitor.metrics import format_reference; print(format_reference())"``).

``TELEM_COUNTERS`` mirrors the port's engine's ``kTelemCounterNames``
(``horovod_tpu_torch/cpp/engine.h`` TelemCounter) — the TELEM wire carries positions, not
names, so the two lists must stay in lockstep.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

__all__ = [
    "TELEM_COUNTERS",
    "STATS_METRICS",
    "SERVE_METRICS",
    "render_prometheus",
    "render_json",
    "reference_rows",
    "format_reference",
]

#: Fleet-telemetry counter order — lockstep with cpp/engine.h
#: kTelemCounterNames (the wire carries positions).
TELEM_COUNTERS = [
    "data_bytes_tx", "data_bytes_rx",
    "allreduce_bytes", "reducescatter_bytes",
    "negotiation_bytes_tx", "negotiation_bytes_rx",
    "control_round_trips", "cache_hits",
    "cache_misses", "tensors",
    "responses", "cycles",
    "shm_bytes_tx", "compressed_bytes_tx",
    "wire_bytes_saved", "backup_skips",
    "stale_epoch_msgs", "stall_warnings",
    "priority_inversions", "alltoall_bytes",
    "moe_tokens_dropped",
]


class Metric(NamedTuple):
    stats_key: str   # key in eng.stats()
    prom: str        # Prometheus metric name
    kind: str        # "counter" | "gauge"
    help: str


#: Per-process metrics exported from ``stats()`` (rank 0's own view; the
#: fleet table below carries every rank's).
STATS_METRICS: List[Metric] = [
    Metric("cycles", "horovod_exec_cycles_total", "counter",
           "negotiation cycles that executed at least one response"),
    Metric("responses", "horovod_responses_executed_total", "counter",
           "responses executed (a fused batch counts once)"),
    Metric("tensors", "horovod_tensors_executed_total", "counter",
           "tensors executed"),
    Metric("cache_hits", "horovod_cache_hits_total", "counter",
           "enqueues negotiated via a cache-slot bit"),
    Metric("cache_misses", "horovod_cache_misses_total", "counter",
           "cacheable enqueues that took full negotiation"),
    Metric("cache_evictions", "horovod_cache_evictions_total", "counter",
           "cache slots dropped from this rank's replica"),
    Metric("negotiation_bytes_tx", "horovod_negotiation_bytes_tx_total",
           "counter", "control-frame bytes sent (incl. length prefix)"),
    Metric("negotiation_bytes_rx", "horovod_negotiation_bytes_rx_total",
           "counter", "control-frame bytes received"),
    Metric("control_round_trips", "horovod_control_round_trips_total",
           "counter", "negotiation round trips (idle heartbeats excluded)"),
    Metric("stale_epoch_msgs", "horovod_stale_epoch_msgs_total", "counter",
           "control frames dropped for a stale membership epoch"),
    Metric("assign_bytes_tx", "horovod_assign_bytes_tx_total", "counter",
           "rendezvous ASSIGN bytes sent by this coordinator"),
    Metric("data_bytes_tx", "horovod_data_bytes_tx_total", "counter",
           "data-plane payload bytes sent (all collectives/channels)"),
    Metric("data_bytes_rx", "horovod_data_bytes_rx_total", "counter",
           "data-plane payload bytes received"),
    Metric("allreduce_bytes", "horovod_allreduce_bytes_total", "counter",
           "ring-allreduce payload bytes"),
    Metric("reducescatter_bytes", "horovod_reducescatter_bytes_total",
           "counter", "reduce-scatter payload bytes"),
    Metric("shm_bytes_tx", "horovod_shm_bytes_tx_total", "counter",
           "payload bytes sent through shared-memory rings"),
    Metric("compressed_bytes_tx", "horovod_compressed_bytes_tx_total",
           "counter", "compressed-wire ring payload bytes sent"),
    Metric("wire_bytes_saved", "horovod_wire_bytes_saved_total", "counter",
           "buffer-level bytes saved by compressed wire formats"),
    Metric("backup_skips", "horovod_backup_skips_total", "counter",
           "backup-worker partial commits that left this rank out"),
    Metric("priority_inversions", "horovod_priority_inversions_total",
           "counter",
           "committed responses dispatched after a less-urgent response "
           "of the same cycle (0 by construction with "
           "HOROVOD_PRIORITY_BANDS on)"),
    Metric("alltoall_bytes", "horovod_alltoall_bytes_total", "counter",
           "alltoall payload bytes (variable-split block exchange; "
           "MoE dispatch/combine rides this)"),
    Metric("alltoall_ns", "horovod_alltoall_ns_total", "counter",
           "wall nanoseconds spent in alltoall exchanges"),
    Metric("alltoall_bus_bw_bytes_per_sec",
           "horovod_alltoall_bus_bw_bytes_per_sec", "gauge",
           "alltoall bus bandwidth ((N-1)/N * bytes / wall) over the "
           "stats window"),
    Metric("moe_tokens_dropped", "horovod_moe_tokens_dropped_total",
           "counter",
           "expert-capacity overflow tokens dropped by the MoE plane "
           "(receiver-side, deterministic in global token order)"),
    Metric("moe_dispatches", "horovod_moe_dispatches_total", "counter",
           "MoE dispatch/combine round trips completed by this process"),
    Metric("moe_capacity_factor", "horovod_moe_capacity_factor", "gauge",
           "capacity factor of the most recent MoE dispatch"),
    Metric("moe_experts", "horovod_moe_experts", "gauge",
           "expert count of the most recent MoE dispatch"),
    Metric("link_reconnects", "horovod_link_reconnects_total", "counter",
           "data-channel edges transparently re-established mid-collective "
           "(link self-healing, HOROVOD_LINK_RETRIES)"),
    Metric("link_heal_failures", "horovod_link_heal_failures_total",
           "counter",
           "link-heal suspects that exhausted the retry/deadline budget "
           "and escalated to the abort path"),
    Metric("local_sgd_syncs", "horovod_local_sgd_syncs_total", "counter",
           "outer local-SGD delta syncs completed"),
    Metric("sharded_steps", "horovod_sharded_steps_total", "counter",
           "ZeRO-1 sharded-optimizer steps completed"),
    Metric("stall_warnings", "horovod_stall_warnings_total", "counter",
           "stalled-tensor warnings emitted (rate-limited per tensor, "
           "mirrored into the flight recorder)"),
    Metric("telem_bytes_tx", "horovod_telem_bytes_tx_total", "counter",
           "bytes the TELEM piggyback added to control frames"),
    Metric("flight_events", "horovod_flight_events_total", "counter",
           "flight-recorder events recorded"),
    Metric("flight_dumps", "horovod_flight_dumps_total", "counter",
           "flight-recorder dumps written"),
    Metric("tune_trials", "horovod_tune_trials_total", "counter",
           "TUNE frames applied on this rank"),
    Metric("step_time_ns_p50", "horovod_step_time_ns_p50", "gauge",
           "allreduce completion latency p50 (sliding window)"),
    Metric("step_time_ns_p99", "horovod_step_time_ns_p99", "gauge",
           "allreduce completion latency p99"),
    Metric("coordinator_cycle_ns_p50", "horovod_coordinator_cycle_ns_p50",
           "gauge", "coordinator control-cycle wall time p50"),
    Metric("coordinator_cycle_ns_p99", "horovod_coordinator_cycle_ns_p99",
           "gauge", "coordinator control-cycle wall time p99"),
    Metric("quorum_lag_ns_p50", "horovod_quorum_lag_ns_p50", "gauge",
           "per-entry quorum lag p50 (last voter vs second-to-last)"),
    Metric("quorum_lag_ns_p99", "horovod_quorum_lag_ns_p99", "gauge",
           "per-entry quorum lag p99 — backup=auto's default instrument"),
    Metric("link_heal_ns_p50", "horovod_link_heal_ns_p50", "gauge",
           "link-heal suspect-to-healed duration p50 (sliding window)"),
    Metric("link_heal_ns_p99", "horovod_link_heal_ns_p99", "gauge",
           "link-heal suspect-to-healed duration p99"),
    Metric("clock_offset_ns", "horovod_clock_offset_ns", "gauge",
           "rendezvous-estimated monotonic clock offset to rank 0"),
    Metric("checkpoint_bytes", "horovod_checkpoint_bytes_total", "counter",
           "bytes written into committed checkpoint shards by this rank"),
    Metric("checkpoint_restores", "horovod_checkpoint_restores_total",
           "counter", "restores completed from a checkpoint manifest"),
    Metric("weight_push_count", "horovod_weight_push_count_total",
           "counter", "live trainer→serve weight pushes sent"),
    Metric("checkpoint_ns_p50", "horovod_checkpoint_ns_p50", "gauge",
           "off-path checkpoint write+commit wall time p50 "
           "(sliding window)"),
    Metric("checkpoint_ns_p99", "horovod_checkpoint_ns_p99", "gauge",
           "off-path checkpoint write+commit wall time p99"),
    Metric("last_checkpoint_step", "horovod_last_checkpoint_step", "gauge",
           "step of the last committed (durable) checkpoint manifest"),
]

#: Serve-plane counters mounted by the router as the ``"serve"``
#: provider (``horovod_serve_*``): its own fleet counters plus the
#: per-replica scheduler counters piggybacked on probe pongs and summed
#: fleet-wide.  Keys absent from this table still export as bare gauges
#: (the mount is schemaless by design); listing here adds HELP/TYPE rows
#: and a docs/observability.md entry.
SERVE_METRICS: List[Metric] = [
    Metric("completed", "horovod_serve_completed", "counter",
           "streams finished with a done event (router fleet view)"),
    Metric("requeued", "horovod_serve_requeued", "counter",
           "in-flight requests transparently requeued after a replica "
           "death"),
    Metric("replica_deaths", "horovod_serve_replica_deaths", "counter",
           "replica processes declared down by the router"),
    Metric("link_reconnects", "horovod_serve_link_reconnects", "counter",
           "router→replica links transparently healed in place "
           "(HOROVOD_SERVE_LINK_RETRIES; streams resume seq-exact, "
           "no requeue)"),
    Metric("weight_pushes", "horovod_serve_weight_pushes", "counter",
           "live trainer→serve weight swaps fanned out to the fleet"),
    Metric("prefix_hits", "horovod_serve_prefix_hits", "counter",
           "prompt KV blocks served from the content-hash prefix cache "
           "instead of being prefilled (summed over replicas)"),
    Metric("prefix_misses", "horovod_serve_prefix_misses", "counter",
           "shareable prompt blocks that missed the prefix cache and "
           "were prefilled"),
    Metric("prefix_evictions", "horovod_serve_prefix_evictions", "counter",
           "cached prefix blocks recycled under pool pressure (LRU) or "
           "a weight-epoch flush"),
    Metric("cow_forks", "horovod_serve_cow_forks", "counter",
           "copy-on-write forks where a sequence diverged from a "
           "shared cached prefix"),
    Metric("fused_attn_steps", "horovod_serve_fused_attn_steps", "counter",
           "decode steps executed by the fused paged-attention kernel "
           "(HOROVOD_SERVE_FUSED_ATTN)"),
    Metric("prefill_tokens_saved", "horovod_serve_prefill_tokens_saved",
           "counter",
           "prompt tokens whose prefill compute was skipped via prefix "
           "cache hits"),
]

_SERVE_HELP = {m.stats_key: m for m in SERVE_METRICS}


def render_prometheus(stats: Optional[dict], fleet: Optional[dict],
                      extra: Optional[Dict[str, dict]] = None) -> str:
    """Prometheus text exposition of rank 0's stats + the fleet table.

    ``extra`` maps a provider name (e.g. ``"serve"``) to a flat dict of
    numeric values, exported as ``horovod_<provider>_<key>`` gauges — the
    serve plane's router/replica stats mount through it."""
    lines: List[str] = []
    stats = stats or {}
    for m in STATS_METRICS:
        if m.stats_key not in stats:
            continue
        v = stats[m.stats_key]
        if not isinstance(v, (int, float)):
            continue
        lines.append(f"# HELP {m.prom} {m.help}")
        lines.append(f"# TYPE {m.prom} {m.kind}")
        lines.append(f"{m.prom} {v}")
    if fleet:
        lines.append("# HELP horovod_fleet_ranks_reporting fleet rows "
                     "(per rank, or per host under hierarchical "
                     "coordination)")
        lines.append("# TYPE horovod_fleet_ranks_reporting gauge")
        lines.append("horovod_fleet_ranks_reporting "
                     f"{fleet.get('ranks_reporting', 0)}")
        totals = fleet.get("totals", {})
        for name in TELEM_COUNTERS:
            if name not in totals:
                continue
            prom = f"horovod_fleet_{name}_total"
            lines.append(f"# HELP {prom} fleet-wide sum of per-rank "
                         f"{name} (TELEM aggregation)")
            lines.append(f"# TYPE {prom} counter")
            lines.append(f"{prom} {totals[name]}")
        for row in fleet.get("rows", []):
            labels = (f'rank="{row.get("rank", -1)}",'
                      f'host="{row.get("host", 0)}",'
                      f'nranks="{row.get("nranks", 1)}"')
            for name in TELEM_COUNTERS:
                v = row.get("counters", {}).get(name)
                if v is None:
                    continue
                lines.append(f"horovod_fleet_{name}{{{labels}}} {v}")
            for gauge in ("step_time_ns_p50", "step_time_ns_p99"):
                if gauge in row:
                    lines.append(
                        f"horovod_fleet_{gauge}{{{labels}}} {row[gauge]}")
        for rank, attr in sorted(
                (fleet.get("quorum_lag_by_rank", {}) or {}).items(),
                key=lambda kv: int(kv[0])):
            lines.append(
                f'horovod_fleet_quorum_lag_attributions{{rank="{rank}"}} '
                f"{attr.get('attributions', 0)}")
            lines.append(
                f'horovod_fleet_quorum_lag_max_ns{{rank="{rank}"}} '
                f"{attr.get('max_ns', 0)}")
        slow = fleet.get("slowest", {})
        if slow:
            lines.append("# HELP horovod_fleet_slowest_rank rank with the "
                         "worst step-time p99 across the fleet")
            lines.append("# TYPE horovod_fleet_slowest_rank gauge")
            lines.append(f"horovod_fleet_slowest_rank {slow.get('rank', -1)}")
        for key in ("quorum_lag_ns_p50", "quorum_lag_ns_p99"):
            if key in fleet:
                lines.append(f"horovod_fleet_{key} {fleet[key]}")
    for provider, values in (extra or {}).items():
        for key, v in sorted((values or {}).items()):
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            name = f"horovod_{provider}_{key}".replace(".", "_")
            reg = _SERVE_HELP.get(key) if provider == "serve" else None
            if reg is not None:
                lines.append(f"# HELP {reg.prom} {reg.help}")
                lines.append(f"# TYPE {reg.prom} {reg.kind}")
            else:
                lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {v}")
    return "\n".join(lines) + "\n"


def render_json(stats: Optional[dict], fleet: Optional[dict],
                extra: Optional[Dict[str, dict]] = None) -> dict:
    """The ``/json`` payload: raw stats + fleet table + mounted extras."""
    out = {"stats": stats or {}, "fleet": fleet or {}}
    for provider, values in (extra or {}).items():
        out[provider] = values or {}
    return out


def reference_rows() -> List[dict]:
    """Rows for the docs/observability.md metrics reference table —
    generated from the same registry the endpoint serves."""
    rows = [{"metric": m.prom, "kind": m.kind, "source": f"stats()['{m.stats_key}']",
             "help": m.help} for m in STATS_METRICS]
    for name in TELEM_COUNTERS:
        rows.append({
            "metric": f"horovod_fleet_{name}_total", "kind": "counter",
            "source": f"fleet_stats()['totals']['{name}']",
            "help": f"fleet-wide sum of per-rank {name} "
                    "(per-rank/per-host rows carry labels)",
        })
    rows.append({"metric": "horovod_fleet_slowest_rank", "kind": "gauge",
                 "source": "fleet_stats()['slowest']",
                 "help": "rank with the worst step-time p99"})
    rows.extend({
        "metric": m.prom, "kind": m.kind,
        "source": f"serve mount ['{m.stats_key}']", "help": m.help,
    } for m in SERVE_METRICS)
    return rows


def format_reference() -> str:
    """Markdown rendering of :func:`reference_rows` (docs generator)."""
    rows = reference_rows()
    lines = ["| metric | kind | source | description |",
             "|---|---|---|---|"]
    for r in rows:
        lines.append(f"| `{r['metric']}` | {r['kind']} | `{r['source']}` "
                     f"| {r['help']} |")
    return "\n".join(lines)
