"""Import-light engine rank for the big-world control-plane harness.

Counterpart of the reference's ``tests/scale/scale_worker.py``, run by
``horovod_tpu_torch/scale_harness.py`` as a script by its path (never
imported as ``horovod_tpu_torch.scale_worker``: the package's own
``__init__`` imports torch).  It loads the port's ``libhorovod_core``
(built from ``horovod_tpu_torch/cpp`` by ``common/native_build.py``; its
path comes in ``HOROVOD_SCALE_LIB``) directly through ctypes, with no
numpy and no torch, so one rank costs ~10 MB and starts in milliseconds
and a 64-rank world fits one host.  These worlds carry raw host bytes and
no tensors: the control plane has no device part.

Synthetic host grouping comes from HOROVOD_SCALE_GROUPS: rank r adopts
HOROVOD_HOST_KEY ``scalehost<r // (size/groups)>`` before init, so the
coordinator commits a G-group topology (hierarchical coordination + per-host
sub-coordinators) without G machines.

Scenarios (argv[1]):

* ``steady`` — HOROVOD_SCALE_STEPS tiny fp32 allreduces after a warmup;
  rank 0 prints one ``SCALE_STATS {json}`` line with the rendezvous
  time, client step-latency percentiles, and the control-plane counter
  DELTAS over the measured steps (the deterministic quantities the scale
  gate compares across world sizes and coordinator modes).
* ``parity`` — a deterministic dtype/op corpus (fused bursts, min/max/
  prod, broadcast, allgather); every rank prints ``SCALE_PARITY <fnv>``
  over the concatenated result bytes, the same under hierarchical
  coordination on and off.

Identity via HOROVOD_RANK/HOROVOD_SIZE/HOROVOD_COORDINATOR.  The tensor
names and payloads are the reference's, so negotiation bytes compare.
"""

import ctypes
import json
import os
import sys
import time

_OP_ALLREDUCE, _OP_ALLGATHER, _OP_BROADCAST = 0, 1, 2
_F32, _F64, _I32, _I64 = 7, 8, 4, 5
_SUM, _MIN, _MAX, _PROD = 0, 1, 2, 3

_COUNTERS = (
    "negotiation_bytes_tx", "negotiation_bytes_rx", "control_round_trips",
    "cache_hits", "cache_misses", "assign_bytes_tx",
    "coordinator_cycle_ns_p50", "coordinator_cycle_ns_p99",
    "stale_epoch_msgs", "exec_cycles",
)


def _declare(lib):
    lib.horovod_init.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_char_p]
    lib.horovod_init.restype = ctypes.c_int
    lib.horovod_enqueue.argtypes = [
        ctypes.c_int, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int]
    lib.horovod_enqueue.restype = ctypes.c_int64
    lib.horovod_wait.argtypes = [ctypes.c_int64]
    lib.horovod_wait.restype = ctypes.c_int
    lib.horovod_error_message.argtypes = [ctypes.c_int64, ctypes.c_char_p,
                                          ctypes.c_int]
    lib.horovod_result_bytes.argtypes = [ctypes.c_int64]
    lib.horovod_result_bytes.restype = ctypes.c_int64
    lib.horovod_copy_result.argtypes = [ctypes.c_int64, ctypes.c_void_p,
                                        ctypes.c_int64]
    lib.horovod_copy_result.restype = ctypes.c_int
    lib.horovod_release_handle.argtypes = [ctypes.c_int64]
    lib.horovod_last_error.restype = ctypes.c_char_p
    lib.horovod_hier_coordinator.restype = ctypes.c_int64
    lib.horovod_topology_hosts.restype = ctypes.c_int64
    for sym in _COUNTERS:
        fn = getattr(lib, "horovod_" + sym)
        fn.argtypes = []
        fn.restype = ctypes.c_int64


def _snapshot(lib):
    return {k: int(getattr(lib, "horovod_" + k)()) for k in _COUNTERS}


def _sync(lib, handle, what):
    assert handle >= 0, (what, handle)
    status = lib.horovod_wait(handle)
    if status != 1:
        buf = ctypes.create_string_buffer(2048)
        lib.horovod_error_message(handle, buf, len(buf))
        raise RuntimeError(f"{what}: {buf.value.decode(errors='replace')}")
    return status


def _allreduce(lib, name, arr, dtype_code=_F32, red_op=_SUM):
    shape = (ctypes.c_int64 * 1)(len(arr))
    h = lib.horovod_enqueue(_OP_ALLREDUCE, name.encode(), dtype_code,
                            1, shape, ctypes.cast(arr, ctypes.c_void_p),
                            -1, red_op)
    _sync(lib, h, name)
    lib.horovod_release_handle(h)


def _fnv(h, data):
    for b in data:
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def scenario_steady(lib, rank, size):
    floats = int(os.environ.get("HOROVOD_SCALE_PAYLOAD_FLOATS", "64"))
    steps = int(os.environ.get("HOROVOD_SCALE_STEPS", "50"))
    warmup = 3
    buf = (ctypes.c_float * floats)()
    expected = size * (size + 1) / 2.0
    base = None
    lat_ms = []
    for step in range(warmup + steps):
        for i in range(floats):
            buf[i] = float(rank + 1)
        t0 = time.monotonic()
        _allreduce(lib, "scale.steady", buf)
        lat_ms.append((time.monotonic() - t0) * 1e3)
        assert abs(buf[0] - expected) < 1e-3, (step, buf[0], expected)
        if step == warmup - 1:
            base = _snapshot(lib)
            lat_ms.clear()
    end = _snapshot(lib)
    if rank != 0:
        return
    lat_ms.sort()
    delta = {k: end[k] - base[k] for k in
             ("negotiation_bytes_tx", "negotiation_bytes_rx",
              "control_round_trips", "cache_hits", "cache_misses",
              "stale_epoch_msgs")}
    rt = max(1, delta["control_round_trips"])
    print("SCALE_STATS " + json.dumps({
        "size": size,
        "steps": steps,
        "hier": int(lib.horovod_hier_coordinator()),
        "hosts": int(lib.horovod_topology_hosts()),
        "assign_bytes_tx": end["assign_bytes_tx"],
        "negotiation_bytes_per_cycle":
            (delta["negotiation_bytes_tx"] +
             delta["negotiation_bytes_rx"]) / rt,
        "coordinator_cycle_ns_p50": end["coordinator_cycle_ns_p50"],
        "coordinator_cycle_ns_p99": end["coordinator_cycle_ns_p99"],
        "step_ms_p50": lat_ms[len(lat_ms) // 2],
        "step_ms_p99": lat_ms[min(len(lat_ms) - 1,
                                  int(len(lat_ms) * 0.99))],
        **delta,
    }), flush=True)


def scenario_parity(lib, rank, size):
    digest = 0xCBF29CE484222325
    # Fused burst: 8 same-dtype tensors enqueued together.
    handles = []
    bufs = []
    for i in range(8):
        arr = (ctypes.c_float * (17 + i))(*([float(rank + i)] * (17 + i)))
        shape = (ctypes.c_int64 * 1)(len(arr))
        bufs.append(arr)
        handles.append(lib.horovod_enqueue(
            _OP_ALLREDUCE, f"par.fused.{i}".encode(), _F32, 1, shape,
            ctypes.cast(arr, ctypes.c_void_p), -1, _SUM))
    for i, h in enumerate(handles):
        _sync(lib, h, f"par.fused.{i}")
        lib.horovod_release_handle(h)
        digest = _fnv(digest, bytes(bufs[i]))
    # dtype/op corpus.
    corpus = [
        ("par.f32.sum", _F32, ctypes.c_float, _SUM, 1024),
        ("par.f32.min", _F32, ctypes.c_float, _MIN, 33),
        ("par.f32.max", _F32, ctypes.c_float, _MAX, 7),
        ("par.f32.prod", _F32, ctypes.c_float, _PROD, 5),
        ("par.f64.sum", _F64, ctypes.c_double, _SUM, 257),
        ("par.i32.sum", _I32, ctypes.c_int32, _SUM, 63),
        ("par.i64.max", _I64, ctypes.c_int64, _MAX, 9),
    ]
    for name, code, ctype, op, count in corpus:
        if ctype in (ctypes.c_int32, ctypes.c_int64):
            arr = (ctype * count)(*[(rank * 7 + i) % 13 for i in
                                    range(count)])
        else:
            arr = (ctype * count)(*[(rank + 1) * 0.5 + i * 0.25
                                    for i in range(count)])
        _allreduce(lib, name, arr, code, op)
        digest = _fnv(digest, bytes(arr))
    # Broadcast from the last rank (its values are deterministic).
    arr = (ctypes.c_float * 19)(*[float(rank * 3 + i) for i in range(19)])
    shape = (ctypes.c_int64 * 1)(19)
    h = lib.horovod_enqueue(_OP_BROADCAST, b"par.bcast", _F32, 1, shape,
                            ctypes.cast(arr, ctypes.c_void_p), size - 1,
                            _SUM)
    _sync(lib, h, "par.bcast")
    lib.horovod_release_handle(h)
    digest = _fnv(digest, bytes(arr))
    # Allgather with per-rank dim0.
    rows = rank % 3 + 1
    arr = (ctypes.c_float * rows)(*[float(rank + 1)] * rows)
    shape = (ctypes.c_int64 * 1)(rows)
    h = lib.horovod_enqueue(_OP_ALLGATHER, b"par.gather", _F32, 1, shape,
                            ctypes.cast(arr, ctypes.c_void_p), -1, _SUM)
    _sync(lib, h, "par.gather")
    nbytes = lib.horovod_result_bytes(h)
    out = (ctypes.c_uint8 * nbytes)()
    assert lib.horovod_copy_result(h, out, nbytes) == 0
    lib.horovod_release_handle(h)
    digest = _fnv(digest, bytes(out))
    # Steady steps on top so cached-slot negotiation is in the corpus too.
    buf = (ctypes.c_float * 64)()
    for step in range(5):
        for i in range(64):
            buf[i] = float(rank + 1)
        _allreduce(lib, "par.steady", buf)
        digest = _fnv(digest, bytes(buf))
    print(f"SCALE_PARITY {digest:016x}", flush=True)


def main():
    rank = int(os.environ["HOROVOD_RANK"])
    size = int(os.environ["HOROVOD_SIZE"])
    groups = int(os.environ.get("HOROVOD_SCALE_GROUPS", "1"))
    if groups > 1 and "HOROVOD_HOST_KEY" not in os.environ:
        per = max(1, size // groups)
        os.environ["HOROVOD_HOST_KEY"] = (
            f"scalehost{min(rank // per, groups - 1)}")
    scenario = sys.argv[1] if len(sys.argv) > 1 else "steady"
    lib = ctypes.CDLL(os.environ["HOROVOD_SCALE_LIB"])
    _declare(lib)
    t0 = time.monotonic()
    rc = lib.horovod_init(rank, size, 0, 1,
                          os.environ["HOROVOD_COORDINATOR"].encode())
    rdv_ms = (time.monotonic() - t0) * 1e3
    if rc != 0:
        raise RuntimeError(
            f"init failed: {lib.horovod_last_error().decode()}")
    if rank == 0:
        print(f"SCALE_RDV_MS {rdv_ms:.1f}", flush=True)
    try:
        {"steady": scenario_steady, "parity": scenario_parity}[scenario](
            lib, rank, size)
    finally:
        lib.horovod_shutdown()


if __name__ == "__main__":
    main()
