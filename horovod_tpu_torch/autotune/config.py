"""The resolved engine knob table: env -> default -> effective.

Counterpart of ``horovod_tpu/autotune/config.py``.  One place that
mirrors the port's engine's env resolution (``cpp/engine.cc``
``Engine::Init``) so ``python -m horovod_tpu_torch.run --print-config`` and the
consolidated table in docs/performance.md can show the value the engine
would actually use — clamps, auto-from-cores defaults and all — without
starting a world.  ``stats()["config"]`` is the live counterpart: it
reports the values currently in force (post-autotune) from the running
engine itself.
"""

from __future__ import annotations

import os
from typing import Callable, List, NamedTuple, Optional

__all__ = ["KNOBS", "resolved_config", "format_table"]


def _cores() -> int:
    return os.cpu_count() or 1


def _clamp(v: int, lo: int, hi: int) -> int:
    return max(lo, min(hi, v))


class Knob(NamedTuple):
    env: str
    default: str                      # human-readable default
    resolve: Callable[[Optional[str]], str]  # raw env value -> effective
    doc: str


def _int_env(raw: Optional[str], dflt: int) -> int:
    if raw is None or raw == "":
        return dflt
    try:
        return int(raw)
    except ValueError:
        return dflt


def _num_channels(raw):
    v = _int_env(raw, 0)
    if v <= 0:
        v = min(4, max(1, _cores()))
    return str(_clamp(v, 1, 16))


def _channel_drivers(raw):
    v = _int_env(raw, 0)
    if v <= 0:
        v = max(1, _cores())
    return str(_clamp(v, 1, 16))


def _chunk_bytes(raw):
    v = max(4096, _int_env(raw, 1 << 20))
    return str(v & ~7)


def _wave_width(raw, environ=os.environ):
    v = _int_env(raw, 0)
    if v <= 0:
        return _num_channels(environ.get("HOROVOD_NUM_CHANNELS"))
    return str(_clamp(v, 1, 16))


def _sparse_topk(raw):
    # Mirrors runtime/sparse.default_topk_ratio exactly: float parse
    # with 0.01 fallback, clamped to [1e-6, 1.0].
    try:
        v = float(raw) if raw else 0.01
    except ValueError:
        v = 0.01
    return str(min(1.0, max(1e-6, v)))


def _moe_experts(raw):
    # Mirrors runtime/moe.moe_experts_default: lenient int parse,
    # default = world size (one expert per rank), clamped up to the
    # world size.  --print-config runs worldless, so the floor shows as
    # the symbolic default.
    try:
        n = int(raw) if raw and raw.strip() else 0
    except ValueError:
        n = 0
    return str(n) if n > 0 else "(world size)"


def _moe_capacity_factor(raw):
    # Mirrors runtime/moe.moe_capacity_factor_default exactly.
    try:
        return str(max(0.0, float(raw)) if raw and raw.strip() else 1.25)
    except ValueError:
        return "1.25"


def _moe_topk(raw):
    # Mirrors runtime/moe.moe_topk_default exactly.
    try:
        return str(max(1, int(raw)) if raw and raw.strip() else 2)
    except ValueError:
        return "2"


#: Every performance/robustness knob the engine reads, in the order the
#: docs table presents them.  Live-tunable knobs (autotune may rewrite
#: them at runtime) are marked in the doc string.
KNOBS: List[Knob] = [
    Knob("HOROVOD_NUM_CHANNELS", "auto: min(4, cores)", _num_channels,
         "socket pairs per ring edge (wiring-time; probed by "
         "autotune.startup_probe)"),
    Knob("HOROVOD_CHANNEL_DRIVERS", "auto: cores", _channel_drivers,
         "poll-loop threads driving the channel fan-out (wiring-time; "
         "probed by autotune.startup_probe)"),
    Knob("HOROVOD_CHUNK_BYTES", "1048576", _chunk_bytes,
         "ring pipeline chunk, 8-aligned (live-tunable)"),
    Knob("HOROVOD_FUSION_THRESHOLD", "67108864",
         lambda raw: str(_int_env(raw, 64 << 20)),
         "max fused allreduce batch bytes (live-tunable)"),
    Knob("HOROVOD_CYCLE_TIME", "5",
         lambda raw: str(max(1, _int_env(raw, 5))),
         "idle-heartbeat upper bound on a negotiation cycle, ms "
         "(live-tunable)"),
    Knob("HOROVOD_WAVE_WIDTH", "auto: num_channels", _wave_width,
         "concurrent responses per execution wave (live-tunable)"),
    Knob("HOROVOD_CACHE_CAPACITY", "1024",
         lambda raw: str(_clamp(max(0, _int_env(raw, 1024)), 0, 1 << 20)),
         "negotiation response-cache slots (0 disables)"),
    Knob("HOROVOD_SOCKET_BUF_BYTES", "0 (kernel default)",
         lambda raw: str(_int_env(raw, 0)),
         "SO_SNDBUF/SO_RCVBUF on ring data sockets"),
    Knob("HOROVOD_SOCKET_TIMEOUT_SEC", "120",
         lambda raw: str(_int_env(raw, 120)),
         "no-progress bound per transport op (0 disables)"),
    Knob("HOROVOD_CONTROL_PATIENCE_SEC", "max(600, size*30)",
         lambda raw: raw if raw else "max(600, size*30)",
         "idle allowance for control frames"),
    Knob("HOROVOD_FAULT_TIMEOUT_SEC", "0 (off)",
         lambda raw: str(_int_env(raw, 0)),
         "hard failure-detection bound (caps the two above)"),
    Knob("HOROVOD_LINK_RETRIES", "3",
         lambda raw: str(max(0, min(1000, _int_env(raw, 3)))),
         "link self-healing: reconnect attempts per suspect data-channel "
         "socket before escalating to the abort path (0 = heal off, "
         "fail-fast exactly as before; committed at rendezvous; see "
         "docs/elastic.md 'Link self-healing')"),
    Knob("HOROVOD_LINK_HEAL_TIMEOUT_MS", "10000",
         lambda raw: str(max(1, _int_env(raw, 10000))),
         "per-suspect heal deadline; clamped to 3/4 of the socket "
         "timeout so healing always finishes inside every other rank's "
         "no-progress patience (committed at rendezvous)"),
    Knob("HOROVOD_STALL_WARNING_SEC", "60",
         lambda raw: str(_int_env(raw, 60)),
         "stalled-tensor warning cadence"),
    Knob("HOROVOD_WIRE_DTYPE", "fp32",
         lambda raw: raw if raw in ("fp16", "bf16", "int8", "fp8")
         else "fp32",
         "wire format for fp32 allreduce payloads: fp32 is byte-exact; "
         "fp16/bf16 halve wire bytes (RNE), int8/fp8 quarter them with "
         "per-chunk scales (live-tunable; per-tensor override via "
         "wire_dtype=; see docs/performance.md 'Wire compression')"),
    Knob("HOROVOD_PRIORITY_BANDS", "0 (off)",
         lambda raw: str(_clamp(max(0, _int_env(raw, 0)), 0, 1 << 20)),
         "priority band WIDTH (band = priority / width): the coordinator "
         "orders each cycle's responses by (priority, name), fusion only "
         "merges within a band, and waves dispatch in band order — so "
         "front-layer gradients fly first (0 = off: legacy arrival "
         "ordering bit-for-bit; committed at rendezvous, live-tunable; "
         "docs/performance.md 'Priority scheduling & overlap')"),
    Knob("HOROVOD_FUSION_LADDER", "(unset: global threshold)",
         lambda raw: raw or "(unset: global threshold)",
         "per-band fusion thresholds 't0,t1,...' (band b fuses up to "
         "ladder[b] bytes; missing/zero entries fall back to "
         "HOROVOD_FUSION_THRESHOLD; autotuner-learnable via the "
         "fusion_ladder_<b> dims)"),
    Knob("HOROVOD_WIRE_POLICY", "0",
         lambda raw: str(1 if (raw or "") not in ("", "0") else 0),
         "statistics-driven per-tensor wire dtypes on the gradient "
         "paths: int8 for large embedding-shaped grads, fp32 for "
         "norm/bias leaves, stamped as ADVISORY overrides so per-rank "
         "stats can never split negotiation (runtime/wire_policy.py)"),
    Knob("HOROVOD_WIRE_POLICY_MIN_ELEMS", "65536",
         lambda raw: str(max(1, _int_env(raw, 65536))),
         "wire policy: leaves below this many elements (or 0/1-D) stay "
         "fp32"),
    Knob("HOROVOD_WIRE_POLICY_RATIO", "64.0",
         lambda raw: raw or "64.0",
         "wire policy: max rolling abs-max/rms dynamic range for the "
         "int8 wire (spiky leaves stay fp32)"),
    Knob("HOROVOD_WIRE_POLICY_WARMUP", "3",
         lambda raw: str(max(0, _int_env(raw, 3))),
         "wire policy: observed steps per leaf before compressing"),
    Knob("HOROVOD_SPARSE_TOPK", "0.01", _sparse_topk,
         "default top-k ratio for Compression.topk sparse allreduce "
         "(indices+values ride the allgather path; error-feedback "
         "residuals per gradient leaf, cleared per membership epoch)"),
    Knob("HOROVOD_TOPK_SEED", "0",
         lambda raw: str(_int_env(raw, 0)),
         "seeded tie-break for deterministic top-k selection"),
    Knob("HOROVOD_ALGO_THRESHOLD", "32768",
         lambda raw: str(max(0, _int_env(raw, 32 << 10))),
         "size-based algorithm crossover: allreduces at or under this "
         "many bytes take the latency star path over shm (0 disables; "
         "live-tunable)"),
    Knob("HOROVOD_SHM_DISABLE", "0",
         lambda raw: str(_int_env(raw, 0)),
         "1 = pure-TCP data plane (bit-identical; escape hatch for "
         "broken /dev/shm)"),
    Knob("HOROVOD_SHM_RING_BYTES", "2097152",
         lambda raw: str(max(1 << 16, _int_env(raw, 2 << 20))),
         "per-direction shm ring-buffer capacity"),
    Knob("HOROVOD_HOST_KEY", "(hostname#boot-id)",
         lambda raw: raw or "(hostname#boot-id)",
         "co-location grouping override for rendezvous (two-level "
         "hierarchy + shm edges form per host key)"),
    Knob("HOROVOD_HIERARCHICAL_COORDINATOR", "1",
         lambda raw: str(1 if _int_env(raw, 1) else 0),
         "per-host sub-coordinators aggregate readiness so rank 0 "
         "handles O(hosts) control frames per cycle (active on >1-group "
         "topologies; 0 restores the flat rank-0 star bit-for-bit; "
         "docs/scaling.md)"),
    Knob("HOROVOD_RENDEZVOUS_TIMEOUT_SEC", "120",
         lambda raw: str(max(5, _int_env(raw, 120))),
         "first-rendezvous / join-exchange deadline"),
    Knob("HOROVOD_BACKUP_WORKERS", "0",
         lambda raw: raw if (raw or "").strip() == "auto"
         else str(max(0, _int_env(raw, 0))),
         "backup-worker collectives: SUM allreduces commit at size-k "
         "voter readiness; skipped ranks get the clean StepSkipped "
         "status and averaging divides by participants (0 = fully "
         "synchronous; 'auto' arms k=1 from the step-time p99/p50 "
         "window ratio; docs/elastic.md 'Straggler tolerance')"),
    Knob("HOROVOD_BACKUP_AUTO_RATIO", "3.0",
         lambda raw: raw or "3.0",
         "steptime-rule arming threshold on the step_time_ns_p99/p50 "
         "window ratio (>=64 samples; reported in stats()['config'] as "
         "backup_auto/backup_armed)"),
    Knob("HOROVOD_BACKUP_AUTO_RULE", "quorum",
         lambda raw: raw if raw in ("quorum", "steptime") else "quorum",
         "backup=auto arming instrument: 'quorum' arms k=1 while the "
         "per-entry quorum-lag p50 exceeds the grace window (sees a "
         "straggling rank 0 too); 'steptime' keeps the legacy rank-0 "
         "completion-latency rule (docs/observability.md)"),
    Knob("HOROVOD_BACKUP_GRACE_MS", "50",
         lambda raw: str(max(0, _int_env(raw, 50))),
         "minimum pending age before a partial commit may skip a rank"),
    Knob("HOROVOD_SHARDED", "0",
         lambda raw: str(1 if (raw or "").strip() not in
                         ("", "0", "false", "False") else 0),
         "DistributedOptimizer(sharded=) default: ZeRO-1 sharded "
         "optimizer — reducescatter(grads), shard-local update, "
         "allgather(params); ~1/N optimizer memory per rank "
         "(docs/zero.md)"),
    Knob("HOROVOD_FSDP", "0",
         lambda raw: str(1 if (raw or "").strip() not in
                         ("", "0", "false", "False") else 0),
         "DistributedOptimizer(fsdp=) default: ZeRO-3/FSDP full "
         "parameter sharding — per-unit JIT allgather forward, async "
         "reducescatter backward, free-after-use; peak param residency "
         "~1/N + one gathered unit (docs/zero.md)"),
    Knob("HOROVOD_FSDP_PREFETCH", "1",
         lambda raw: str(max(0, _int_env(raw, 1))),
         "FSDP prefetch depth in units: each gather enqueues the next "
         "k allgathers at priority band 0 so the banded scheduler "
         "overlaps them with compute (0 disables — every gather "
         "blocks)"),
    Knob("HOROVOD_MOE_EXPERTS", "(world size)", _moe_experts,
         "global expert count for the MoE plane (runtime/moe.py): "
         "defaults to one expert per rank and is clamped up to the "
         "world size so every rank owns at least one expert; must "
         "divide evenly across ranks (docs/moe.md)"),
    Knob("HOROVOD_MOE_CAPACITY_FACTOR", "1.25", _moe_capacity_factor,
         "slack multiplier on the perfect-balance per-expert token "
         "budget: capacity = ceil(cf * topk * tokens / experts); "
         "overflow tokens drop deterministically in global token order "
         "(moe_tokens_dropped counter)"),
    Knob("HOROVOD_MOE_TOPK", "2", _moe_topk,
         "experts per token for top-k gating (stable tie-break toward "
         "the lower expert id; full-softmax gate weights)"),
    Knob("HOROVOD_LOCAL_SGD_STEPS", "1",
         lambda raw: str(max(1, _int_env(raw, 1))),
         "local-SGD periodic sync: H local steps per outer model-delta "
         "allreduce (1 = fully synchronous, byte-identical; "
         "DistributedOptimizer(local_sgd_steps=))"),
    Knob("HOROVOD_TELEMETRY_CYCLES", "50",
         lambda raw: str(max(0, _int_env(raw, 50))),
         "fleet telemetry cadence: every N negotiation cycles each rank "
         "piggybacks counter deltas on its control frame; rank 0 keeps "
         "the fleet table (hvd.fleet_stats(); 0 disables — frames are "
         "then byte-identical to the pre-telemetry wire)"),
    Knob("HOROVOD_METRICS_PORT", "(unset: off)",
         lambda raw: raw or "(unset: off)",
         "rank 0 serves Prometheus text on /metrics and JSON on /json "
         "over HTTP at this port; query live with `python -m "
         "horovod_tpu_torch.run --status host:port` (docs/observability.md)"),
    Knob("HOROVOD_FLIGHT_RECORDER_EVENTS", "256",
         lambda raw: str(max(0, min(1 << 16, _int_env(raw, 256)))),
         "in-memory ring of the last N control-plane events per rank "
         "(0 disables recording)"),
    Knob("HOROVOD_FLIGHT_RECORDER_DIR", "(unset: no dumps)",
         lambda raw: raw or "(unset: no dumps)",
         "flight-recorder dump sink: flightrec.rank<r>.json written on "
         "abort, stall-warning escalation and fatal signals; post-mortem "
         "via `python -m horovod_tpu_torch.monitor.postmortem <dir>`"),
    Knob("HOROVOD_TIMELINE_ALL_RANKS", "0",
         lambda raw: str(_int_env(raw, 0)),
         "1 = every rank writes HOROVOD_TIMELINE + '.rank<r>'; merge "
         "into one clock-aligned Chrome trace with `python -m "
         "horovod_tpu_torch.timeline merge` (docs/timeline.md)"),
    Knob("HOROVOD_TIMELINE_MAX_MB", "0 (unbounded)",
         lambda raw: str(max(0, _int_env(raw, 0))),
         "timeline rotation: past this size the file is terminated as "
         "valid JSON, kept as '<path>.old', and the newest events "
         "continue at the configured path"),
    Knob("HOROVOD_ELASTIC", "0", lambda raw: str(_int_env(raw, 0)),
         "in-place elastic membership"),
    Knob("HOROVOD_CHECKPOINT_DIR", "(unset: off)",
         lambda raw: raw or "(unset: off)",
         "crash-consistent sharded checkpoint directory: run_elastic "
         "trainers save async double-buffered shards there and resume "
         "from the newest complete manifest — across world resizes "
         "(docs/checkpointing.md; run.py --checkpoint-dir sets it)"),
    Knob("HOROVOD_CHECKPOINT_INTERVAL_STEPS", "50",
         lambda raw: str(max(1, _int_env(raw, 50))),
         "steps between interval-gated checkpoint saves "
         "(CheckpointWriter.maybe_save)"),
    Knob("HOROVOD_CHECKPOINT_KEEP", "2",
         lambda raw: str(max(1, _int_env(raw, 2))),
         "committed checkpoints retained; older manifests are deleted "
         "BEFORE their shard dirs so 'manifest => complete set' "
         "survives a crash mid-cleanup"),
    Knob("HOROVOD_AUTOTUNE", "0", lambda raw: str(_int_env(raw, 0)),
         "online knob search over the live data plane (docs/autotune.md)"),
    Knob("HOROVOD_AUTOTUNE_SEED", "0",
         lambda raw: str(_int_env(raw, 0)),
         "deterministic trial-schedule seed"),
    Knob("HOROVOD_AUTOTUNE_WINDOW_BYTES", "67108864",
         lambda raw: str(_int_env(raw, 64 << 20)),
         "allreduce bytes per scoring window"),
    Knob("HOROVOD_AUTOTUNE_MAX_TRIALS", "32",
         lambda raw: str(_int_env(raw, 32)),
         "hard cap on trials (search commits best-so-far at the cap)"),
    Knob("HOROVOD_AUTOTUNE_TRIAL_TIMEOUT_SEC", "30",
         lambda raw: str(_int_env(raw, 30)),
         "a trial whose window never fills is discarded after this"),
    Knob("HOROVOD_AUTOTUNE_STATE_FILE", "(unset)",
         lambda raw: raw or "(unset)",
         "warm-start file: a relaunch skips straight to the committed "
         "config"),
]


def resolved_config(environ=os.environ) -> List[dict]:
    """Rows of {env, set, default, effective, doc} for every knob —
    the engine table followed by the serve-plane knobs
    (``serve/config.py``), so ``--print-config`` is the one consolidated
    view."""
    rows = []
    for knob in KNOBS:
        raw = environ.get(knob.env)
        # The wave default depends on ANOTHER knob's resolution
        # (num_channels), so it alone needs the full environ.
        if knob.resolve is _wave_width:
            effective = _wave_width(raw, environ)
        else:
            effective = knob.resolve(raw)
        rows.append({
            "env": knob.env,
            "set": raw if raw is not None else "",
            "default": knob.default,
            "effective": effective,
            "doc": knob.doc,
        })
    from horovod_tpu_torch.serve.config import resolved_serve_config

    rows.extend(resolved_serve_config(environ))
    return rows


def format_table(environ=os.environ) -> str:
    """The --print-config rendering: one aligned row per knob."""
    rows = resolved_config(environ)
    w_env = max(len(r["env"]) for r in rows)
    w_set = max(len("env"), max(len(r["set"]) for r in rows))
    w_dflt = max(len("default"), max(len(r["default"]) for r in rows))
    w_eff = max(len("effective"), max(len(r["effective"]) for r in rows))
    lines = [f"{'knob':<{w_env}}  {'env':<{w_set}}  "
             f"{'default':<{w_dflt}}  {'effective':<{w_eff}}  description"]
    lines.append("-" * len(lines[0]))
    for r in rows:
        lines.append(
            f"{r['env']:<{w_env}}  {r['set']:<{w_set}}  "
            f"{r['default']:<{w_dflt}}  {r['effective']:<{w_eff}}  "
            f"{r['doc']}")
    return "\n".join(lines)
