"""ctypes binding of the eager native engine (``libhorovod_core``).

Counterpart of ``horovod_tpu/runtime/engine.py``: the handle-based seam
between Python and the engine's background coordinator, which negotiates
named tensors across processes each cycle, fuses them and runs ring
collectives between the host processes.

* ``enqueue_*`` -> int handle (async);
* :meth:`NativeEngine.poll` / :meth:`NativeEngine.synchronize`;
* :meth:`NativeEngine.stats`, the engine's cumulative counters, and
  :meth:`NativeEngine.stats_delta`, their difference over a window;
* :meth:`NativeEngine.fleet_stats` (rank 0's fleet telemetry table),
  :meth:`NativeEngine.flight_dump` (the flight recorder on demand) and
  :meth:`NativeEngine.autotune_set` (a TUNE proposal, the autotuner's
  seam).

Buffers are contiguous CPU tensors (plain or pinned) handed over as raw
pointers (``data_ptr()``), so every dtype the engine takes, bf16 included,
needs no numpy dtype.  The engine reads and writes a buffer from its own
thread until the handle completes; the binding keeps a reference to each
buffer until then.  CUDA tensors are staged through pinned host memory by
``runtime/staging.py`` before they reach this module.
"""

from __future__ import annotations

import ctypes
import json
import os
import threading
from typing import Callable, Dict, Optional, Sequence

import torch

__all__ = ["NativeEngine", "HorovodInternalError", "StepSkipped",
           "SparseGradRetry", "WIRE_DTYPES", "dtype_code", "get_engine",
           "reset_engine_naming", "note_sharded_step",
           "note_local_sgd_sync", "note_sparse_allreduce",
           "note_moe_dispatch", "flight_note"]


class HorovodInternalError(RuntimeError):
    """A collective failed (cross-rank mismatch, shutdown, transport)."""


class StepSkipped(Exception):
    """A backup-worker partial commit (``HOROVOD_BACKUP_WORKERS``) left this
    rank out of a step's reduction; the world is healthy."""


class SparseGradRetry(Exception):
    """A layout-probe allreduce was told by the coordinator that peers
    gather this tensor sparsely: the caller re-enqueues zero-entry sparse
    gathers (``<name>.idx`` / ``<name>.vals``).  Raised only for handles
    made by :meth:`NativeEngine.enqueue_probe`."""

    def __init__(self, sparse_dim: int):
        super().__init__(f"retry sparsely (sparse_dim={sparse_dim})")
        self.sparse_dim = sparse_dim


_SPARSE_RETRY_PREFIX = "__sparse_retry__:"
_SKIPPED_STEP_PREFIX = "__skipped_step__"

#: DataType codes, as in ``cpp/common.h``.
_DTYPE_CODES = {torch.uint8: 0, torch.int8: 1, torch.int16: 3,
                torch.int32: 4, torch.int64: 5, torch.float16: 6,
                torch.float32: 7, torch.float64: 8, torch.bool: 9,
                torch.bfloat16: 10}
if hasattr(torch, "uint16"):
    _DTYPE_CODES[torch.uint16] = 2

_OP_ALLREDUCE, _OP_ALLGATHER, _OP_BROADCAST = 0, 1, 2
_OP_REDUCESCATTER, _OP_ALLTOALL = 3, 4

#: ReduceOp codes, as in ``cpp/message.h``.
_RED_OPS = {"sum": 0, "min": 1, "max": 2, "prod": 3}

#: WireDtype codes, as in ``cpp/common.h`` (fp32 = uncompressed).
WIRE_DTYPES = {"fp32": 0, "fp16": 1, "bf16": 2, "int8": 3, "fp8": 4}
_WIRE_NAMES = {v: k for k, v in WIRE_DTYPES.items()}

_I64, _INT, _PTR, _STR = (ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
                          ctypes.c_char_p)
_I64P = ctypes.POINTER(ctypes.c_int64)

#: (name, argtypes, restype) of every C function this binding calls.
_SIGNATURES = (
    ("horovod_init", [_INT, _INT, _INT, _INT, _STR], _INT),
    ("horovod_shutdown", [], None),
    ("horovod_is_initialized", [], _INT),
    ("horovod_rank", [], _INT),
    ("horovod_size", [], _INT),
    ("horovod_epoch", [], _I64),
    ("horovod_last_error", [], _STR),
    ("horovod_enqueue", [_INT, _STR, _INT, _INT, _I64P, _PTR, _INT, _INT],
     _I64),
    ("horovod_enqueue_wire",
     [_INT, _STR, _INT, _INT, _I64P, _PTR, _INT, _INT, _INT], _I64),
    ("horovod_enqueue_priority",
     [_INT, _STR, _INT, _INT, _I64P, _PTR, _INT, _INT, _INT, _INT, _INT],
     _I64),
    ("horovod_enqueue_alltoall",
     [_STR, _INT, _INT, _I64P, _PTR, _I64P, _INT, _INT, _INT, _INT], _I64),
    ("horovod_poll", [_I64], _INT),
    ("horovod_wait", [_I64], _INT),
    ("horovod_error_message", [_I64, _STR, _INT], None),
    ("horovod_result_ndim", [_I64], _I64),
    ("horovod_result_dim", [_I64, _INT], _I64),
    ("horovod_result_bytes", [_I64], _I64),
    ("horovod_copy_result", [_I64, _PTR, _I64], _INT),
    ("horovod_release_handle", [_I64], None),
    ("horovod_result_participants", [_I64], _I64),
    ("horovod_abort_reason", [_STR, _INT], None),
    ("horovod_enqueue_probe", [_STR, _INT, _INT, _I64P, _PTR], _I64),
    ("horovod_note_sharded_step", [], None),
    ("horovod_note_local_sgd_sync", [], None),
    ("horovod_note_moe_dispatch", [_I64], None),
    ("horovod_flight_note", [_STR, _STR], None),
    ("horovod_fleet_json", [_STR, _I64], _I64),
    ("horovod_flight_dump", [_STR], _INT),
    ("horovod_autotune_set",
     [_I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64P, _INT, _INT], _INT),
)

#: Counters and gauges read by :meth:`NativeEngine.stats` (int64
#: functions of no argument), under their ``stats()`` key: the reference's
#: keys and order.
_COUNTERS = {
    "cycles": "exec_cycles", "responses": "responses_executed",
    "tensors": "tensors_executed", "cache_hits": "cache_hits",
    "cache_misses": "cache_misses", "cache_evictions": "cache_evictions",
    "negotiation_bytes_tx": "negotiation_bytes_tx",
    "negotiation_bytes_rx": "negotiation_bytes_rx",
    "control_round_trips": "control_round_trips",
    "stale_epoch_msgs": "stale_epoch_msgs",
    "assign_bytes_tx": "assign_bytes_tx",
    "coordinator_cycle_ns_p50": "coordinator_cycle_ns_p50",
    "coordinator_cycle_ns_p99": "coordinator_cycle_ns_p99",
    "step_time_ns_p50": "step_time_ns_p50",
    "step_time_ns_p99": "step_time_ns_p99",
    "quorum_lag_ns_p50": "quorum_lag_ns_p50",
    "quorum_lag_ns_p99": "quorum_lag_ns_p99",
    "telem_bytes_tx": "telem_bytes_tx", "stall_warnings": "stall_warnings",
    "clock_offset_ns": "clock_offset_ns", "flight_events": "flight_events",
    "flight_dumps": "flight_dumps", "backup_skips": "backup_skips",
    "link_reconnects": "link_reconnects",
    "link_heal_failures": "link_heal_failures",
    "link_heal_ns_p50": "link_heal_ns_p50",
    "link_heal_ns_p99": "link_heal_ns_p99",
    "local_sgd_syncs": "local_sgd_syncs",
    "priority_inversions": "priority_inversions",
    "data_bytes_tx": "data_bytes_tx", "data_bytes_rx": "data_bytes_rx",
    "reduce_ns": "reduce_ns", "wire_ns": "wire_ns",
    "allreduce_bytes": "allreduce_bytes", "allreduce_ns": "allreduce_ns",
    "reducescatter_bytes": "reducescatter_bytes",
    "reducescatter_ns": "reducescatter_ns",
    "reducescatter_fallbacks": "reducescatter_fallbacks",
    "sharded_steps": "sharded_steps",
    "alltoall_bytes": "alltoall_bytes", "alltoall_ns": "alltoall_ns",
    "moe_tokens_dropped": "moe_tokens_dropped",
    "num_channels": "num_channels",
    "shm_bytes_tx": "shm_bytes_tx", "shm_bytes_rx": "shm_bytes_rx",
    "intra_host_bytes": "intra_host_bytes",
    "algo_small_count": "algo_small_count",
    "algo_ring_count": "algo_ring_count",
    "wire_bytes_saved": "wire_bytes_saved",
    "compressed_bytes_tx": "compressed_bytes_tx",
    "quantize_ns": "quantize_ns", "wire_fp16_count": "wire_fp16_count",
    "wire_bf16_count": "wire_bf16_count",
    "wire_int8_count": "wire_int8_count",
    "wire_fp8_count": "wire_fp8_count",
    "tune_trials": "tune_trials",
}
#: ``stats()["config"]``: the knobs in force (after autotuning), by the
#: function that reads each; the flags and names are converted below.
_CONFIG = {
    "num_channels": "num_channels", "channel_drivers": "channel_drivers",
    "chunk_bytes": "chunk_bytes", "fusion_threshold": "fusion_threshold",
    "cycle_time_ms": "cycle_time_ms", "wave_width": "wave_width",
    "cache_capacity": "cache_capacity",
    "socket_buf_bytes": "socket_buf_bytes", "shm_enabled": "shm_enabled",
    "algo_threshold": "algo_threshold",
    "hierarchical_coordinator": "hier_coordinator",
    "wire_dtype": "wire_dtype", "backup_workers": "backup_workers",
    "backup_auto": "backup_auto",
    "backup_auto_ratio": "backup_auto_ratio_milli",
    "backup_armed": "backup_armed", "backup_auto_rule": "backup_auto_rule",
    "link_retries": "link_retries",
    "link_heal_timeout_ms": "link_heal_timeout_ms",
    "priority_bands": "priority_bands",
    "telemetry_cycles": "telemetry_cycles",
}
_TOPOLOGY = ("topology_hosts", "topology_local_ranks")
#: Keys of :meth:`NativeEngine.stats` that are not cumulative counters:
#: :meth:`NativeEngine.stats_delta` carries their current value (the
#: sliding-window percentiles, the bus bandwidths it recomputes, gauges).
_NOT_CUMULATIVE = frozenset((
    "config", "num_channels", "topology", "allreduce_bus_bw_bytes_per_sec",
    "reducescatter_bus_bw_bytes_per_sec", "alltoall_bus_bw_bytes_per_sec",
    "moe_capacity_factor", "moe_experts", "coordinator_cycle_ns_p50",
    "coordinator_cycle_ns_p99", "step_time_ns_p50", "step_time_ns_p99",
    "quorum_lag_ns_p50", "quorum_lag_ns_p99", "clock_offset_ns",
    "checkpoint_ns_p50", "checkpoint_ns_p99", "last_checkpoint_step",
    "fsdp_units", "fsdp_param_bytes_resident",
    "fsdp_param_bytes_resident_peak"))
#: (kind, factor) of each bus bandwidth: factor·(N−1)/N · bytes / wall
#: (NCCL's busbw convention; the allreduce's ring moves twice).
_BUS_BW = (("allreduce", 2.0), ("reducescatter", 1.0), ("alltoall", 1.0))


def _bus_bw(counters: dict, size: int) -> dict:
    out = {}
    for kind, factor in _BUS_BW:
        ns = counters[f"{kind}_ns"]
        out[f"{kind}_bus_bw_bytes_per_sec"] = (
            counters[f"{kind}_bytes"] * factor * (size - 1) / size
            / (ns / 1e9) if ns > 0 and size > 1 else 0.0)
    return out


def dtype_code(dtype: torch.dtype) -> int:
    try:
        return _DTYPE_CODES[dtype]
    except KeyError:
        raise TypeError(f"unsupported dtype for native collectives: "
                        f"{dtype}") from None


def _check_buffer(buf: torch.Tensor) -> None:
    if buf.device.type != "cpu" or not buf.is_contiguous():
        raise ValueError("engine buffers are contiguous CPU tensors; got "
                         f"device={buf.device}, "
                         f"contiguous={buf.is_contiguous()}")


class NativeEngine:
    """Wraps the loaded engine library."""

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        for name, args, res in _SIGNATURES:
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
        for sym in (list(_COUNTERS.values()) + list(_CONFIG.values())
                    + list(_TOPOLOGY)):
            fn = getattr(lib, f"horovod_{sym}")
            fn.argtypes, fn.restype = [], _I64
        self._name_lock = threading.Lock()
        self._name_counters: Dict[str, int] = {}
        # Buffers the engine may still touch, by handle (the reference's
        # _handle_map keeps them alive the same way).
        self._inflight: Dict[int, torch.Tensor] = {}
        self._inflight_lock = threading.Lock()

    @property
    def lib(self) -> ctypes.CDLL:
        return self._lib

    # -- naming: auto names agree across ranks that enqueue in the same
    #    program order (the reference's op-name autogeneration) --

    def _auto_name(self, kind: str, name: Optional[str]) -> str:
        if name is not None:
            return name
        with self._name_lock:
            idx = self._name_counters.get(kind, 0)
            self._name_counters[kind] = idx + 1
        return f"{kind}.noname.{idx}"

    def reset_naming(self) -> None:
        """Restart the auto-name counters (an engine restarted by
        shutdown + init starts from an empty tensor table)."""
        with self._name_lock:
            self._name_counters.clear()
        with self._inflight_lock:
            self._inflight.clear()

    # -- lifecycle and fault state --

    def size(self) -> int:
        return int(self._lib.horovod_size())

    def epoch(self) -> int:
        return int(self._lib.horovod_epoch())

    def abort_reason(self) -> str:
        buf = ctypes.create_string_buffer(4096)
        self._lib.horovod_abort_reason(buf, len(buf))
        return buf.value.decode(errors="replace")

    def _not_running_error(self) -> HorovodInternalError:
        reason = self.abort_reason()
        if reason:
            return HorovodInternalError(f"engine aborted: {reason}")
        return HorovodInternalError(
            "engine is not running (init not called or already shut down)")

    # -- async enqueue --

    def _stamp_priorities(self) -> bool:
        """Priorities ride the wire only with priority bands on (or
        HOROVOD_PRIORITY_STAMP=1); otherwise the wire stays the
        pre-priority protocol byte for byte."""
        if os.environ.get("HOROVOD_PRIORITY_STAMP", "") not in ("", "0"):
            return True
        return int(self._lib.horovod_priority_bands()) > 0

    def _track(self, handle: int, name: str, buf: torch.Tensor) -> int:
        if handle == -1:
            raise HorovodInternalError(
                f"a collective named {name!r} is already in flight "
                "(duplicate name)")
        if handle < 0:
            raise self._not_running_error()
        with self._inflight_lock:
            self._inflight[handle] = buf
        return handle

    def _enqueue(self, op: int, buf: torch.Tensor, name: str,
                 root_rank: int = -1, red_op: str = "sum",
                 wire_dtype: Optional[str] = None,
                 priority: Optional[int] = None,
                 wire_advisory: bool = False) -> int:
        _check_buffer(buf)
        if wire_dtype is not None and wire_dtype not in WIRE_DTYPES:
            raise ValueError(f"unknown wire_dtype {wire_dtype!r} "
                             f"(want one of {sorted(WIRE_DTYPES)})")
        if priority is not None and not self._stamp_priorities():
            priority = None
        shape = (ctypes.c_int64 * buf.dim())(*buf.shape)
        common = (op, name.encode(), dtype_code(buf.dtype), buf.dim(), shape,
                  buf.data_ptr(), root_rank, _RED_OPS[red_op])
        if priority is not None or wire_advisory:
            handle = self._lib.horovod_enqueue_priority(
                *common, -1 if wire_dtype is None else WIRE_DTYPES[wire_dtype],
                1 if wire_advisory else 0,
                0 if priority is None else max(0, int(priority)))
        elif wire_dtype is not None:
            handle = self._lib.horovod_enqueue_wire(*common,
                                                    WIRE_DTYPES[wire_dtype])
        else:
            handle = self._lib.horovod_enqueue(*common)
        return self._track(handle, name, buf)

    def enqueue_allreduce(self, buf: torch.Tensor, name: Optional[str] = None,
                          red_op: str = "sum",
                          wire_dtype: Optional[str] = None,
                          priority: Optional[int] = None,
                          wire_advisory: bool = False) -> int:
        """In-place allreduce of ``buf`` (``red_op``: sum/min/max/prod).
        ``wire_dtype`` (fp32/fp16/bf16/int8/fp8) sets this tensor's wire
        format (fp32 payloads only; every rank must ask for the same);
        ``priority`` (0 = most urgent) orders responses under
        HOROVOD_PRIORITY_BANDS.  Returns the handle."""
        return self._enqueue(_OP_ALLREDUCE, buf,
                             self._auto_name("allreduce", name),
                             red_op=red_op, wire_dtype=wire_dtype,
                             priority=priority, wire_advisory=wire_advisory)

    def enqueue_allgather(self, buf: torch.Tensor, name: Optional[str] = None,
                          priority: Optional[int] = None) -> int:
        """Gather every rank's dim-0 rows (counts may differ)."""
        return self._enqueue(_OP_ALLGATHER, buf,
                             self._auto_name("allgather", name),
                             priority=priority)

    def enqueue_broadcast(self, buf: torch.Tensor, root_rank: int,
                          name: Optional[str] = None) -> int:
        """In-place broadcast of root's ``buf``."""
        return self._enqueue(_OP_BROADCAST, buf,
                             self._auto_name("broadcast", name),
                             root_rank=root_rank)

    def enqueue_reducescatter(self, buf: torch.Tensor,
                              name: Optional[str] = None,
                              red_op: str = "sum",
                              wire_dtype: Optional[str] = None,
                              priority: Optional[int] = None) -> int:
        """Reduce across ranks, keep this rank's dim-0 rows (split as
        evenly as possible, earlier ranks take the remainder)."""
        return self._enqueue(_OP_REDUCESCATTER, buf,
                             self._auto_name("reducescatter", name),
                             red_op=red_op, wire_dtype=wire_dtype,
                             priority=priority)

    def enqueue_alltoall(self, buf: torch.Tensor, name: Optional[str] = None,
                         splits: Optional[Sequence[int]] = None,
                         wire_dtype: Optional[str] = None,
                         priority: Optional[int] = None) -> int:
        """Exchange dim-0 blocks: output block i came from rank i.
        ``splits`` (one non-negative row count per rank, summing to dim 0)
        routes ``splits[d]`` rows to rank d; ``None`` splits dim 0
        equally."""
        name = self._auto_name("alltoall", name)
        if splits is None and wire_dtype is None and priority is None:
            return self._enqueue(_OP_ALLTOALL, buf, name)
        _check_buffer(buf)
        if wire_dtype is not None and wire_dtype not in WIRE_DTYPES:
            raise ValueError(f"unknown wire_dtype {wire_dtype!r} "
                             f"(want one of {sorted(WIRE_DTYPES)})")
        if priority is not None and not self._stamp_priorities():
            priority = None
        sp = [] if splits is None else [int(s) for s in splits]
        if sp:
            world = self.size()
            if len(sp) != world:
                raise ValueError(f"alltoall splits must have one entry per "
                                 f"rank ({world}); got {len(sp)}")
            if any(s < 0 for s in sp):
                raise ValueError("alltoall splits must be non-negative")
            rows = buf.shape[0] if buf.dim() > 0 else 0
            if sum(sp) != rows:
                raise ValueError(f"alltoall splits sum to {sum(sp)} but "
                                 f"dim 0 is {rows}")
        shape = (ctypes.c_int64 * buf.dim())(*buf.shape)
        csp = (ctypes.c_int64 * max(1, len(sp)))(*(sp or [0]))
        handle = self._lib.horovod_enqueue_alltoall(
            name.encode(), dtype_code(buf.dtype), buf.dim(), shape,
            buf.data_ptr(), csp, len(sp),
            -1 if wire_dtype is None else WIRE_DTYPES[wire_dtype], 0,
            0 if priority is None else max(0, int(priority)))
        return self._track(handle, name, buf)

    def enqueue_probe(self, buf: torch.Tensor, name: str) -> int:
        """Layout-probe allreduce (sum, in place) of placeholder zeros for
        a tensor with no local gradient.  Completes as a dense allreduce
        unless peers gather the tensor sparsely; then :meth:`synchronize`
        raises :class:`SparseGradRetry`."""
        _check_buffer(buf)
        shape = (ctypes.c_int64 * buf.dim())(*buf.shape)
        handle = self._lib.horovod_enqueue_probe(
            name.encode(), dtype_code(buf.dtype), buf.dim(), shape,
            buf.data_ptr())
        return self._track(handle, name, buf)

    # -- handles --

    def poll(self, handle: int) -> bool:
        """True once the collective finished (ok or error)."""
        return self._lib.horovod_poll(handle) != 0

    def synchronize(self, handle: int, info: Optional[dict] = None,
                    alloc: Callable[..., torch.Tensor] = torch.empty
                    ) -> torch.Tensor:
        """Wait; raise on error; return the result buffer.

        For allreduce and broadcast this is the enqueued buffer, updated in
        place; for allgather, reducescatter and alltoall a new tensor of the
        negotiated shape, made by ``alloc(shape, dtype=...)`` (a pinned
        buffer for a result bound for the card).  ``info`` receives
        ``participants``: how many ranks' data the response reduced, the
        divisor of an average.  Raises :class:`StepSkipped` when a
        backup-worker partial commit left this rank out, and
        :class:`SparseGradRetry` when a probe's peers gather sparsely.
        """
        status = self._lib.horovod_wait(handle)
        with self._inflight_lock:
            buf = self._inflight.pop(handle, None)
        try:
            if info is not None:
                info["participants"] = int(
                    self._lib.horovod_result_participants(handle))
            if status < 0:
                msg = ctypes.create_string_buffer(4096)
                self._lib.horovod_error_message(handle, msg, len(msg))
                text = msg.value.decode(errors="replace")
                if text.startswith(_SPARSE_RETRY_PREFIX):
                    raise SparseGradRetry(
                        int(text[len(_SPARSE_RETRY_PREFIX):]))
                if text.startswith(_SKIPPED_STEP_PREFIX):
                    raise StepSkipped(text)
                raise HorovodInternalError(text or "collective failed")
            ndim = self._lib.horovod_result_ndim(handle)
            if ndim > 0:       # a fresh out-of-place result was negotiated
                shape = tuple(self._lib.horovod_result_dim(handle, i)
                              for i in range(ndim))
                out = alloc(shape, dtype=buf.dtype)
                nbytes = out.numel() * out.element_size()
                if self._lib.horovod_copy_result(handle, out.data_ptr(),
                                                 nbytes) != 0:
                    raise HorovodInternalError("result copy failed")
                return out
            return buf
        finally:
            self._lib.horovod_release_handle(handle)

    # -- counters --

    def stats(self) -> dict:
        """Cumulative execution counters, under the reference's keys:
        negotiation ``cycles`` that executed work, ``responses`` (a fused
        batch counts once) and ``tensors``; the control plane (response
        cache, negotiation bytes, round trips, stale-epoch frames, the
        coordinator's cycle and quorum-lag percentiles); data-plane bytes
        (``data_bytes_*``, of which ``shm_bytes_*`` went through shared
        memory) and times; each collective's payload and wall time with
        its bus bandwidth (:data:`_BUS_BW`); wire-compression counters;
        the observability plane's (``telem_bytes_tx``, ``stall_warnings``,
        ``flight_events``, ``flight_dumps``, ``clock_offset_ns``) and link
        healing's; ``tune_trials``, the TUNE frames applied on this rank
        (0 with autotuning off); the Python-side planes' counters
        (``sparse_count``, the top-k sparse allreduces of
        ``runtime/sparse.py``; ``checkpoint_*`` and ``weight_push_count``;
        ``fsdp_*``; ``moe_*``); ``topology``; and ``config``, the knobs in
        force (after autotuning, not the env defaults)."""
        lib = self._lib
        out = {key: int(getattr(lib, f"horovod_{sym}")())
               for key, sym in _COUNTERS.items()}
        out.update(_bus_bw(out, self.size()))
        out["sparse_count"] = _SPARSE_COUNT
        from horovod_tpu_torch.checkpoint.stats import checkpoint_stats
        from horovod_tpu_torch.runtime.fsdp import fsdp_stats
        from horovod_tpu_torch.runtime.moe import moe_stats
        out.update(checkpoint_stats())
        out.update(fsdp_stats())
        out.update(moe_stats())
        out["topology"] = {"hosts": int(lib.horovod_topology_hosts()),
                           "local_ranks":
                           int(lib.horovod_topology_local_ranks())}
        config = {key: int(getattr(lib, f"horovod_{sym}")())
                  for key, sym in _CONFIG.items()}
        for flag in ("shm_enabled", "hierarchical_coordinator",
                     "backup_auto", "backup_armed"):
            config[flag] = bool(config[flag])
        config["wire_dtype"] = _WIRE_NAMES.get(config["wire_dtype"], "fp32")
        config["backup_auto_ratio"] = config["backup_auto_ratio"] / 1000.0
        config["backup_auto_rule"] = ("steptime" if config["backup_auto_rule"]
                                      else "quorum")
        out["config"] = config
        return out

    def stats_delta(self, since: dict) -> dict:
        """The counters' movement since an earlier :meth:`stats`: every
        cumulative counter as ``now - since`` (a key missing from
        ``since`` counts from 0), the keys of :data:`_NOT_CUMULATIVE` at
        their current value, and each bus bandwidth recomputed from the
        delta: the bandwidth of exactly the window between the two
        snapshots, what the autotuner scores a trial on."""
        delta = {}
        for key, value in self.stats().items():
            delta[key] = (value if key in _NOT_CUMULATIVE
                          else value - since.get(key, 0))
        delta.update(_bus_bw(delta, self.size()))
        return delta

    def fleet_stats(self) -> dict:
        """Rank 0's fleet telemetry table (``HOROVOD_TELEMETRY_CYCLES``):
        per-rank rows (per-host under hierarchical coordination), fleet
        totals, the slowest rank and quorum-lag percentiles; ``{}`` on a
        worker, with telemetry off, or before the first TELEM frame.  The
        rows carry counter deltas summed on the coordinator, so once the
        data plane is quiet the totals equal the sum of every rank's
        :meth:`stats`.  The table outlives :func:`shutdown` (a postmortem
        scrape can still read it)."""
        need = int(self._lib.horovod_fleet_json(None, 0))
        if need <= 2:           # "{}": nothing reported yet
            return {}
        buf = ctypes.create_string_buffer(need + 1)
        self._lib.horovod_fleet_json(buf, need + 1)
        return json.loads(buf.value.decode(errors="replace"))

    def flight_dump(self, reason: str = "manual dump") -> bool:
        """Write the flight recorder's ring to
        ``HOROVOD_FLIGHT_RECORDER_DIR/flightrec.rank<r>.json`` now (the
        engine also dumps on an abort, a stall warning's escalation and a
        fatal signal).  False when the recorder is off or has no
        directory."""
        return int(self._lib.horovod_flight_dump(reason.encode())) == 0

    def autotune_set(self, *, chunk_bytes: int = 0,
                     fusion_threshold: int = 0, cycle_time_ms: int = 0,
                     wave_width: int = 0, algo_threshold: int = -1,
                     wire_dtype: int = -1, priority_bands: int = -1,
                     fusion_ladder: Optional[Sequence[int]] = None,
                     commit: bool = False) -> bool:
        """Queue a TUNE proposal (the coordinator only): the engine sends
        it in the next cycle's epoch-stamped frame and every rank applies
        it between cycles.  A value <= 0 leaves its knob alone, except
        ``algo_threshold``, ``wire_dtype`` (a :data:`WIRE_DTYPES` code)
        and ``priority_bands``, where 0 is a value and < 0 leaves it.
        ``fusion_ladder[b] > 0`` sets priority band b's fusion threshold.
        ``commit`` marks the search's final frame.  False when the engine
        refused (not running, or not the coordinator)."""
        ladder = [int(v) for v in (fusion_ladder or [])]
        arr = (ctypes.c_int64 * max(1, len(ladder)))(*(ladder or [0]))
        return self._lib.horovod_autotune_set(
            int(chunk_bytes), int(fusion_threshold), int(cycle_time_ms),
            int(wave_width), int(algo_threshold), int(wire_dtype),
            int(priority_bands), arr, len(ladder), 1 if commit else 0) == 0


_engine: Optional[NativeEngine] = None
_engine_lock = threading.Lock()


def get_engine() -> NativeEngine:
    """The process-wide engine, bound to the library ``hvd.init()``
    loaded (``common/native_build.py``)."""
    global _engine
    with _engine_lock:
        if _engine is None:
            from horovod_tpu_torch.common import native_build
            _engine = NativeEngine(native_build.load())
        return _engine


def _note(symbol: str) -> None:
    eng = _engine
    if eng is not None:
        getattr(eng.lib, symbol)()


#: Completed top-k sparse allreduces (``runtime/sparse.py``): they ride
#: the engine's allgathers, which cannot tell them from any other, so the
#: count lives here.  Cumulative, like the engine's counters.
_SPARSE_COUNT = 0


def note_sparse_allreduce() -> None:
    """One completed top-k sparse allreduce: ``stats()["sparse_count"]``."""
    global _SPARSE_COUNT
    _SPARSE_COUNT += 1


def note_moe_dispatch(dropped: int) -> None:
    """One completed MoE dispatch round of ``runtime/moe.py`` with its
    capacity-dropped tokens: the engine's cumulative
    ``moe_tokens_dropped`` counter (no-op before an engine is loaded)."""
    eng = _engine
    if eng is not None:
        eng.lib.horovod_note_moe_dispatch(int(dropped))


def note_sharded_step() -> None:
    """One completed ZeRO step (reducescatter, shard update, allgather) of
    ``runtime/sharded.py`` or ``runtime/fsdp.py``: the engine's cumulative
    ``sharded_steps`` counter (no-op before an engine is loaded)."""
    _note("horovod_note_sharded_step")


def note_local_sgd_sync() -> None:
    """One completed outer sync of ``elastic.LocalSGD``: the engine's
    cumulative ``local_sgd_syncs`` counter (no-op before an engine is
    loaded)."""
    _note("horovod_note_local_sgd_sync")


def flight_note(kind: str, text: str) -> None:
    """Record a Python-plane event (a checkpoint begin, commit or restore,
    an elastic recovery) into the engine's flight recorder ring, beside
    its aborts and link events (no-op before an engine is loaded).
    ``kind`` is cut to 15 bytes and ``text`` to 160, as the ring's
    fields are."""
    eng = _engine
    if eng is not None:
        eng.lib.horovod_flight_note(str(kind).encode()[:15],
                                    str(text).encode()[:160])


def reset_engine_naming() -> None:
    """Restart the auto names of the engine, if one was made."""
    with _engine_lock:
        if _engine is not None:
            _engine.reset_naming()
