"""Serve-plane knob resolution (env -> default -> effective).

The port's copy of ``horovod_tpu/serve/config.py``: the same env names,
defaults, clamps and derived defaults, so one environment configures a
JAX replica and a port replica alike.  Resolving starts nothing and
imports no framework.  A live replica's ``stats()["config"]`` reports
the values in force.

Knobs whose machinery is not ported yet still resolve here (so
``resolved_serve_config`` renders the full table), but the port refuses
them where they would act: ``HOROVOD_SERVE_CHECKPOINT`` in
``ModelRunner`` and ``HOROVOD_SERVE_AUTOTUNE`` in ``Scheduler``.
``HOROVOD_PAGED_ATTN_CHUNK`` tunes the JAX package's XLA stand-in for its
TPU kernel and has no counterpart here.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

__all__ = ["ServeConfig", "resolved_serve_config", "SERVE_KNOBS",
           "resolve_probe_knobs", "resolve_link_retries"]


def _int_env(environ, name: str, dflt: int) -> int:
    raw = environ.get(name)
    if raw is None or raw == "":
        return dflt
    try:
        return int(raw)
    except ValueError:
        return dflt


def _pow2_at_least(v: int, lo: int) -> int:
    out = lo
    while out < v:
        out *= 2
    return out


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """The resolved serving knobs, all clamped/derived.

    ``block_size`` is forced to a power of two so prompt padding buckets
    stay block-aligned; ``kv_blocks`` counts allocatable blocks PLUS the
    reserved trash block is added internally by the pool; ``max_batch``
    and ``prefill_waves`` are live-tunable (the serve autotuner may
    rewrite them between steps).
    """

    model: str = "tiny"
    dtype: str = ""                 # "" = the model config's own dtype
    param_seed: int = 0
    checkpoint: str = ""            # "" = seeded params, no checkpoint
    block_size: int = 16
    kv_blocks: int = 64
    max_model_len: int = 256
    max_batch: int = 8
    prefill_waves: int = 1
    fused_attn: int = 0
    prefix_cache: int = 1
    warmup_tokens: int = 0
    autotune: int = 0
    autotune_seed: int = 0
    autotune_window_steps: int = 32
    autotune_max_trials: int = 12

    @property
    def max_blocks_per_seq(self) -> int:
        return -(-self.max_model_len // self.block_size)

    @staticmethod
    def from_env(environ=os.environ) -> "ServeConfig":
        block = _pow2_at_least(
            max(1, _int_env(environ, "HOROVOD_SERVE_BLOCK_SIZE", 16)), 1)
        # Rounded UP to a block multiple so the engine's pinned physical
        # cache length IS max_model_len exactly — the documented
        # bit-reproducibility reference (docs/serving.md).
        max_len = max(block,
                      _int_env(environ, "HOROVOD_SERVE_MAX_MODEL_LEN", 256))
        max_len = block * (-(-max_len // block))
        # Default pool: enough for max_batch full-length sequences would
        # defeat admission-control testing; default to half that so the
        # pool is a real resource, overridable per deployment.
        max_batch = max(1, _int_env(environ, "HOROVOD_SERVE_MAX_BATCH", 8))
        blocks_dflt = max(
            2, (max_batch * (-(-max_len // block)) + 1) // 2)
        return ServeConfig(
            model=environ.get("HOROVOD_SERVE_MODEL", "tiny"),
            dtype=environ.get("HOROVOD_SERVE_DTYPE", ""),
            param_seed=_int_env(environ, "HOROVOD_SERVE_PARAM_SEED", 0),
            checkpoint=environ.get("HOROVOD_SERVE_CHECKPOINT", "").strip(),
            block_size=block,
            kv_blocks=max(1, _int_env(environ, "HOROVOD_SERVE_KV_BLOCKS",
                                      blocks_dflt)),
            max_model_len=max_len,
            max_batch=max_batch,
            prefill_waves=max(1, _int_env(environ,
                                          "HOROVOD_SERVE_PREFILL_WAVES", 1)),
            fused_attn=_int_env(environ, "HOROVOD_SERVE_FUSED_ATTN", 0),
            prefix_cache=_int_env(environ, "HOROVOD_SERVE_PREFIX_CACHE", 1),
            warmup_tokens=max(0, _int_env(environ, "HOROVOD_SERVE_WARMUP",
                                          0)),
            autotune=_int_env(environ, "HOROVOD_SERVE_AUTOTUNE", 0),
            autotune_seed=_int_env(environ, "HOROVOD_SERVE_AUTOTUNE_SEED",
                                   0),
            autotune_window_steps=max(
                4, _int_env(environ,
                            "HOROVOD_SERVE_AUTOTUNE_WINDOW_STEPS", 32)),
            autotune_max_trials=max(
                1, _int_env(environ,
                            "HOROVOD_SERVE_AUTOTUNE_MAX_TRIALS", 12)),
        )


#: (env, default-doc, doc) rows for the --print-config table; the
#: effective value is computed by resolving the whole ServeConfig so
#: derived defaults (kv_blocks from max_batch/max_model_len) are real.
SERVE_KNOBS = [
    ("HOROVOD_SERVE_MODEL", "tiny", "model",
     "served model config (LlamaConfig.<name>)"),
    ("HOROVOD_SERVE_DTYPE", "(model default)", "dtype",
     "activation/cache dtype override (float32|bfloat16)"),
    ("HOROVOD_SERVE_PARAM_SEED", "0", "param_seed",
     "deterministic parameter seed — every replica builds identical "
     "weights from it"),
    ("HOROVOD_SERVE_CHECKPOINT", "(unset: seeded params)", "checkpoint",
     "checkpoint directory: replicas load the newest complete "
     "manifest's params instead of seeding (run.py --serve-model "
     "<dir> sets it)"),
    ("HOROVOD_SERVE_BLOCK_SIZE", "16", "block_size",
     "paged KV-cache block size in tokens (forced to a power of two)"),
    ("HOROVOD_SERVE_KV_BLOCKS", "auto: max_batch*max_len/2", "kv_blocks",
     "allocatable KV blocks in the pool (admission control funds "
     "sequences from it)"),
    ("HOROVOD_SERVE_MAX_MODEL_LEN", "256", "max_model_len",
     "hard cap on prompt+generation length per sequence (rounded up to "
     "a block multiple; also the pinned physical cache length)"),
    ("HOROVOD_SERVE_MAX_BATCH", "8", "max_batch",
     "max concurrently decoding sequences (live-tunable)"),
    ("HOROVOD_SERVE_PREFILL_WAVES", "1", "prefill_waves",
     "admissions prefilled per scheduler step (live-tunable)"),
    ("HOROVOD_SERVE_FUSED_ATTN", "0", "fused_attn",
     "1 = fused paged-attention decode kernel (block-table reads, no "
     "gather; tolerance-equivalent); 0 = gather oracle, byte-identical "
     "to offline generate"),
    ("HOROVOD_SERVE_PREFIX_CACHE", "1", "prefix_cache",
     "content-hash prefix caching: shared prompt blocks are refcounted "
     "and copy-on-write forked; 0 restores per-request full prefill "
     "bit-for-bit"),
    ("HOROVOD_SERVE_WARMUP", "0", "warmup_tokens",
     "pre-compile decode + prefill programs up to this many prompt "
     "tokens before the replica reports READY, so jit compilation "
     "lands in startup instead of the first unlucky requests' latency "
     "(0 disables)"),
    ("HOROVOD_SERVE_AUTOTUNE", "0", "autotune",
     "serve-plane knob search scored on tokens/sec windows"),
    ("HOROVOD_SERVE_AUTOTUNE_SEED", "0", "autotune_seed",
     "deterministic serve trial-schedule seed"),
    ("HOROVOD_SERVE_AUTOTUNE_WINDOW_STEPS", "32", "autotune_window_steps",
     "scheduler steps per serve scoring window"),
    ("HOROVOD_SERVE_AUTOTUNE_MAX_TRIALS", "12", "autotune_max_trials",
     "hard cap on serve trials (commits best-so-far at the cap)"),
]


def resolved_serve_config(environ=os.environ) -> List[dict]:
    """Rows of {env, set, default, effective, doc} for every serve knob —
    the same row shape autotune/config.py renders."""
    cfg = ServeConfig.from_env(environ)
    rows = []
    for env, dflt, field, doc in SERVE_KNOBS:
        raw: Optional[str] = environ.get(env)
        rows.append({
            "env": env,
            "set": raw if raw is not None else "",
            "default": dflt,
            "effective": str(getattr(cfg, field)),
            "doc": doc,
        })
    # Router-side liveness-probe knobs (not ServeConfig fields): the
    # ONE resolver the router itself uses, so --print-config can never
    # drift from the live values.
    probe, deadline = resolve_probe_knobs(environ)
    rows.append({
        "env": "HOROVOD_SERVE_PROBE_SEC",
        "set": environ.get("HOROVOD_SERVE_PROBE_SEC") or "",
        "default": "5", "effective": str(probe),
        "doc": "router liveness-probe ping interval for WEDGED (not "
               "dead) replicas (<= 0 disables)"})
    rows.append({
        "env": "HOROVOD_SERVE_PROBE_DEADLINE_SEC",
        "set": environ.get("HOROVOD_SERVE_PROBE_DEADLINE_SEC") or "",
        "default": "max(60, 3*probe)", "effective": str(deadline),
        "doc": "no-healthy-pong bound: a replica whose scheduler "
               "heartbeat stays stale this long is killed so its "
               "requests requeue like the death path (keep it above "
               "the model's worst single-call time — first-request "
               "jit compiles run inside one scheduler phase)"})
    rows.append({
        "env": "HOROVOD_SERVE_LINK_RETRIES",
        "set": environ.get("HOROVOD_SERVE_LINK_RETRIES") or "",
        "default": "2", "effective": str(resolve_link_retries(environ)),
        "doc": "router->replica control-link reconnect attempts after a "
               "transient socket failure (the replica parks the session "
               "and replays missed events) before escalating to the "
               "kill/requeue/relaunch path; 0 disables healing"})
    return rows


def _float_env(environ, name: str, dflt: float) -> float:
    raw = environ.get(name)
    if raw is None or raw == "":
        return dflt
    try:
        return float(raw)
    except ValueError:
        return dflt


def resolve_probe_knobs(environ=os.environ):
    """(probe_interval_sec, probe_deadline_sec) for the router's
    wedged-replica liveness probes — shared by Router and the
    --print-config rows (one resolver, no drift; empty/garbled values
    fall back to defaults instead of crashing the serve plane).

    The deadline default is deliberately generous (60 s): the scheduler
    heartbeat is stamped per PHASE, and a first-request jit compile
    legitimately runs inside one phase — a deadline below the model's
    worst single-call time would kill a healthy, compiling fleet one
    replica at a time."""
    probe = _float_env(environ, "HOROVOD_SERVE_PROBE_SEC", 5.0)
    deadline = _float_env(environ, "HOROVOD_SERVE_PROBE_DEADLINE_SEC",
                          max(60.0, 3 * probe))
    return probe, deadline


def resolve_link_retries(environ=os.environ) -> int:
    """Router->replica control-link reconnect budget (PR 14 spirit:
    bounded healing before honest escalation).  Shared by Router and the
    --print-config row — one resolver, no drift."""
    return max(0, _int_env(environ, "HOROVOD_SERVE_LINK_RETRIES", 2))
