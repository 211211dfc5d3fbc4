"""ctypes binding of the eager native engine (``libhorovod_core``).

Counterpart of ``horovod_tpu/runtime/engine.py``: the handle-based seam
between Python and the engine's background coordinator, which negotiates
named tensors across processes each cycle, fuses them and runs ring
collectives between the host processes.

* ``enqueue_*`` -> int handle (async);
* :meth:`NativeEngine.poll` / :meth:`NativeEngine.synchronize`;
* :meth:`NativeEngine.stats`, the engine's cumulative counters.

Buffers are contiguous CPU tensors (plain or pinned) handed over as raw
pointers (``data_ptr()``), so every dtype the engine takes, bf16 included,
needs no numpy dtype.  The engine reads and writes a buffer from its own
thread until the handle completes; the binding keeps a reference to each
buffer until then.  CUDA tensors are staged through pinned host memory by
``runtime/staging.py`` before they reach this module.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Callable, Dict, Optional, Sequence

import torch

__all__ = ["NativeEngine", "HorovodInternalError", "StepSkipped",
           "WIRE_DTYPES", "dtype_code", "get_engine", "reset_engine_naming"]


class HorovodInternalError(RuntimeError):
    """A collective failed (cross-rank mismatch, shutdown, transport)."""


class StepSkipped(Exception):
    """A backup-worker partial commit (``HOROVOD_BACKUP_WORKERS``) left this
    rank out of a step's reduction; the world is healthy."""


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
)

#: Cumulative counters and knobs read by :meth:`NativeEngine.stats`
#: (int64 functions of no argument), under their ``stats()`` key.
_COUNTERS = {
    "cycles": "exec_cycles", "responses": "responses_executed",
    "tensors": "tensors_executed", "cache_hits": "cache_hits",
    "cache_misses": "cache_misses",
    "negotiation_bytes_tx": "negotiation_bytes_tx",
    "negotiation_bytes_rx": "negotiation_bytes_rx",
    "control_round_trips": "control_round_trips",
    "data_bytes_tx": "data_bytes_tx", "data_bytes_rx": "data_bytes_rx",
    "reduce_ns": "reduce_ns", "wire_ns": "wire_ns",
    "allreduce_bytes": "allreduce_bytes", "allreduce_ns": "allreduce_ns",
    "reducescatter_bytes": "reducescatter_bytes",
    "reducescatter_ns": "reducescatter_ns",
    "alltoall_bytes": "alltoall_bytes", "alltoall_ns": "alltoall_ns",
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
    "step_time_ns_p50": "step_time_ns_p50",
    "step_time_ns_p99": "step_time_ns_p99",
}
_CONFIG = ("num_channels", "chunk_bytes", "fusion_threshold",
           "cycle_time_ms", "wave_width", "shm_enabled", "algo_threshold",
           "wire_dtype", "priority_bands", "topology_hosts",
           "topology_local_ranks")


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
        for sym in list(_COUNTERS.values()) + list(_CONFIG):
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
        backup-worker partial commit left this rank out.
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
        """Cumulative execution counters: negotiation ``cycles`` that
        executed work, ``responses`` (a fused batch counts once) and
        ``tensors``; data-plane bytes (``data_bytes_*``, of which
        ``shm_bytes_*`` went through shared memory) and times; the ring
        allreduce's payload and wall time with its bus bandwidth
        2(N-1)/N · bytes / wall (NCCL's busbw convention); wire-compression
        counters; and ``config``, the knobs in force."""
        size = self.size()
        out = {key: int(getattr(self._lib, f"horovod_{sym}")())
               for key, sym in _COUNTERS.items()}
        for kind, factor in (("allreduce", 2.0), ("reducescatter", 1.0),
                             ("alltoall", 1.0)):
            ns = out[f"{kind}_ns"]
            out[f"{kind}_bus_bw_bytes_per_sec"] = (
                out[f"{kind}_bytes"] * factor * (size - 1) / size
                / (ns / 1e9) if ns > 0 and size > 1 else 0.0)
        config = {k: int(getattr(self._lib, f"horovod_{k}")())
                  for k in _CONFIG}
        config["shm_enabled"] = bool(config["shm_enabled"])
        config["wire_dtype"] = _WIRE_NAMES.get(config["wire_dtype"], "fp32")
        out["topology"] = {"hosts": config.pop("topology_hosts"),
                           "local_ranks": config.pop("topology_local_ranks")}
        out["config"] = config
        return out


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


def reset_engine_naming() -> None:
    """Restart the auto names of the engine, if one was made."""
    with _engine_lock:
        if _engine is not None:
            _engine.reset_naming()
