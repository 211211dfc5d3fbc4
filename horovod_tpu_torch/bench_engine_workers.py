"""Rank bodies of the engine bench's CI gates, on the port's engine.

The reference's gates start workers from its test suite
(``tests/sharded_worker.py``, ``reducescatter_worker.py``,
``fsdp_worker.py``, ``native_worker.py``, ``compression_worker.py``,
``priority_worker.py``, ``wire_policy_worker.py``).  The port carries its
own counterparts of the scenarios the gates and ``bench_engine.main``
read, here, on torch tensors on the run's device through the port's
``runtime/`` (staged through pinned memory when that device is the card):

    python -m horovod_tpu_torch.bench_engine_workers SCENARIO [--device cpu]

with the usual ``HOROVOD_RANK``/``SIZE``/``COORDINATOR`` identity (started
by ``bench_engine._run_ranks``; with no ``--device`` the rank runs on the
GPU and raises where there is none).  Scenarios: ``sharded_numpy``,
``rs_bytes``, ``fsdp_numpy``, ``fsdp_mem``, ``fsdp_overlap``,
``wire_parity``, ``compression``, ``bands_parity``, ``wire_policy``.
Each asserts its contract rank-side (bitwise compares and byte counters;
a failed assertion exits non-zero) and prints the line its gate reads.
The data are the reference workers' numpy draws, moved to the device.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

__all__ = ["SCENARIOS"]

#: The rank's device ("cpu" or "cuda:N"), set by :func:`main` from
#: ``--device`` (none given: the GPU, as ``bench_engine.device_name``
#: resolves it).
_DEVICE = None


def _t(arr) -> torch.Tensor:
    """A numpy array's values on the run's device."""
    return torch.from_numpy(np.ascontiguousarray(arr)).to(_DEVICE)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two tensors hold the same dtype, shape and bytes."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    return torch.equal(a.detach().cpu().contiguous().view(torch.uint8),
                       b.detach().cpu().contiguous().view(torch.uint8))


def _allreduce(x, name, **kw):
    from horovod_tpu_torch.runtime import mpi_ops

    kw.setdefault("average", False)
    return mpi_ops.synchronize(mpi_ops.allreduce_async(x, name=name, **kw))


# ---------------------------------------------------------------------------
# ZeRO-1 (the reference's tests/sharded_worker.py, scenario numpy)
# ---------------------------------------------------------------------------

#: Prime: uneven shards on every world size, and above the engine's
#: small-tensor threshold (32 KB), so the ring path runs.
SHARDED_ELEMS = 65537
SHARDED_STEPS = 6
LR, MOM = np.float32(0.05), np.float32(0.9)


def _sharded_grads(step, rank, n):
    rng = np.random.default_rng(100 * step + rank)
    return rng.standard_normal(n).astype(np.float32)


def _sgd_momentum(params, grads, vel):
    """Elementwise SGD with momentum in fp32, shared by the sharded and
    unsharded runs: a bit difference can only come from the wire."""
    vel2 = float(MOM) * vel + grads
    return params - float(LR) * vel2, vel2


def sharded_numpy(hvd, eng):
    """A ZeRO step (reducescatter, shard update, allgather) is bitwise
    the unsharded flat step after every step; the velocity state is ~1/N;
    the reduce-scatter moves 0.40-0.55x the allreduce's bytes and the
    full step <= 1.15x."""
    from horovod_tpu_torch.runtime.sharded import FlatSharder, my_shard

    rank, size = hvd.rank(), hvd.size()
    n = SHARDED_ELEMS
    sharder = FlatSharder(n, name="w.numpy")
    off, cnt = sharder.offset, sharder.count
    assert (off, cnt) == my_shard(n, rank, size)
    rng = np.random.default_rng(42)
    p_sharded = _t(rng.standard_normal(n).astype(np.float32))
    p_ref = p_sharded.clone()
    vel_shard = torch.zeros(cnt, device=_DEVICE)
    vel_full = torch.zeros(n, device=_DEVICE)
    s0 = eng.stats()
    rs_total = step_total = 0
    for step in range(SHARDED_STEPS):
        g = _t(_sharded_grads(step, rank, n))
        before = eng.stats_delta(s0)["data_bytes_tx"]
        g_ref = _allreduce(g, "w.ref.ar", average=True)
        ar_tx = eng.stats_delta(s0)["data_bytes_tx"] - before
        p_ref, vel_full = _sgd_momentum(p_ref, g_ref, vel_full)
        before = eng.stats_delta(s0)["data_bytes_tx"]
        shard_g = sharder.reduce_grads(g, average=True)
        rs_tx = eng.stats_delta(s0)["data_bytes_tx"] - before
        new_shard, vel_shard = _sgd_momentum(p_sharded[off:off + cnt],
                                             shard_g, vel_shard)
        p_sharded = sharder.gather_updates(new_shard)
        step_tx = eng.stats_delta(s0)["data_bytes_tx"] - before
        rs_total += rs_tx
        step_total += step_tx
        assert _same_bits(p_sharded, p_ref), (
            f"step {step}: sharded params != unsharded flat params (max "
            f"diff {float((p_sharded - p_ref).abs().max())})")
        if size > 1:
            assert 0.40 * ar_tx <= rs_tx <= 0.55 * ar_tx, (step, rs_tx,
                                                           ar_tx)
            assert step_tx <= 1.15 * ar_tx, (step, step_tx, ar_tx)
    ratio = vel_shard.numel() / vel_full.numel()
    assert ratio <= 1.0 / size + 0.01, (ratio, size)
    st = eng.stats_delta(s0)
    assert st["reducescatter_fallbacks"] == 0, st
    assert st["reducescatter_bytes"] == SHARDED_STEPS * n * 4, st
    full = sharder.step(_t(_sharded_grads(99, rank, n)), lambda sg: sg,
                        average=True)
    assert full.shape == (n,)
    assert eng.stats_delta(s0)["sharded_steps"] == 1
    print(f"SHARDED_NUMPY_OK rank={rank} rs_ratio="
          f"{rs_total / max(1, step_total):.3f}", flush=True)


def rs_bytes(hvd, eng):
    """An aligned flat-ring reducescatter moves (N-1)/N of the bytes per
    rank, half the allreduce's: the ratio in [0.40, 0.55], on the byte
    counters (the reference's ``reducescatter_worker.py bytes``)."""
    rank = hvd.rank()
    n = 1 << 20
    rng = np.random.default_rng(99 * 1000 + rank)
    x = _t((rng.standard_normal(n) * 0.5 + 1.5).astype(np.float32))
    from horovod_tpu_torch.runtime import mpi_ops

    s0 = eng.stats()
    _allreduce(x, "bytes.ar")
    mid = eng.stats_delta(s0)
    mpi_ops.synchronize(mpi_ops.reducescatter_async(x, name="bytes.rs"))
    end = eng.stats_delta(s0)
    ar_tx = mid["data_bytes_tx"]
    rs_tx = end["data_bytes_tx"] - ar_tx
    assert ar_tx > 0 and rs_tx > 0, (ar_tx, rs_tx)
    ratio = rs_tx / ar_tx
    assert 0.40 <= ratio <= 0.55, (
        f"reducescatter wire bytes ratio {ratio:.3f} outside [0.40,0.55] "
        f"(rs_tx={rs_tx}, ar_tx={ar_tx})")
    assert end["reducescatter_bytes"] == n * 4, end["reducescatter_bytes"]
    assert end["reducescatter_fallbacks"] == 0, end
    print(f"RS_BYTES_OK rank={rank} ratio={ratio:.3f}", flush=True)


# ---------------------------------------------------------------------------
# FSDP (the reference's tests/fsdp_worker.py, scenarios numpy, mem,
# overlap)
# ---------------------------------------------------------------------------

#: Prime-ish unit sizes, every one above the small-tensor threshold.
UNIT_SIZES = [65537, 32771, 16411, 12289, 10007, 9001]
FSDP_STEPS = 4
#: The memory leg's many near-equal units: peak = owned 1/N + one
#: gathered unit.
MEM_UNIT_SIZES = [9001, 9013, 9029, 9041, 9059, 9067, 9091, 9103,
                  9109, 9127, 9133, 9137, 9151, 9157, 9161, 9173]


def _fsdp_grads(step, rank, n, salt=0):
    rng = np.random.default_rng(9000 * salt + 100 * step + rank)
    return rng.standard_normal(n).astype(np.float32)


def _init_units(seed=7, sizes=UNIT_SIZES):
    rng = np.random.default_rng(seed)
    return [_t(rng.standard_normal(n).astype(np.float32)) for n in sizes]


def _total_param_bytes(plane) -> int:
    return sum(u.n for u in plane.units) * 4


def fsdp_numpy(hvd, eng):
    """Per-unit RS -> shard update -> AG is bitwise the unsharded flat
    step after every step; the grads-RS bytes 0.40-0.55x the allreduce's;
    peak residency the owned shards plus a few gathered units; every cold
    gather a hit or a miss; no priority inversion."""
    from horovod_tpu_torch.runtime.fsdp import FsdpPlane

    rank, size = hvd.rank(), hvd.size()
    units = _init_units()
    refs = [u.clone() for u in units]
    plane = FsdpPlane([[u] for u in units], name="w")
    del units
    n_units = plane.n_units
    vel_sh = [torch.zeros(plane.units[i].sharder.count, device=_DEVICE)
              for i in range(n_units)]
    vel_ref = [torch.zeros(n, device=_DEVICE) for n in UNIT_SIZES]
    s0 = eng.stats()
    rs_total = ar_total = 0
    for step in range(FSDP_STEPS):
        for i in range(n_units):
            assert _same_bits(plane.gather(i)[0], refs[i]), (step, i)
            plane.free(i)
        gs = [_t(_fsdp_grads(step, rank, n, salt=i))
              for i, n in enumerate(UNIT_SIZES)]
        before = eng.stats_delta(s0)["data_bytes_tx"]
        for i in reversed(range(n_units)):
            plane.reduce_grads(i, [gs[i]])
        for i in range(n_units):
            shard_g = plane.wait_grads(i)
            u = plane.units[i]
            new, vel_sh[i] = _sgd_momentum(u.shard, shard_g, vel_sh[i])
            u.shard.copy_(new)
        rs_total += eng.stats_delta(s0)["data_bytes_tx"] - before
        plane.step()
        before = eng.stats_delta(s0)["data_bytes_tx"]
        for i in range(n_units):
            g_ref = _allreduce(gs[i], f"w.ref.{i}", average=True)
            refs[i], vel_ref[i] = _sgd_momentum(refs[i], g_ref, vel_ref[i])
        ar_total += eng.stats_delta(s0)["data_bytes_tx"] - before
        for i in range(n_units):
            got = plane.gather(i)[0]
            assert _same_bits(got, refs[i]), (
                f"step {step} unit {i}: fsdp params != unsharded (max "
                f"diff {float((got - refs[i]).abs().max())})")
            plane.free(i)
    st = eng.stats_delta(s0)
    total = _total_param_bytes(plane)
    if size > 1:
        assert 0.40 * ar_total <= rs_total <= 0.55 * ar_total, (
            rs_total, ar_total)
        peak_allow = (total / size
                      + (plane.prefetch + 2) * max(UNIT_SIZES) * 4)
        assert st["fsdp_param_bytes_resident_peak"] <= peak_allow, (
            st["fsdp_param_bytes_resident_peak"], peak_allow)
    assert st["fsdp_units"] == n_units, st
    gathers = st["fsdp_ag_prefetch_hits"] + st["fsdp_ag_prefetch_misses"]
    assert gathers == FSDP_STEPS * 2 * n_units, (gathers, st)
    assert st["priority_inversions"] == 0, st["priority_inversions"]
    assert st["sharded_steps"] == FSDP_STEPS, st
    print(f"FSDP_NUMPY_OK rank={rank} "
          f"peak={st['fsdp_param_bytes_resident_peak']} total={total} "
          f"hits={st['fsdp_ag_prefetch_hits']}", flush=True)


def fsdp_mem(hvd, eng):
    """Real steps over 16 units; prints the residency counter's peak
    against the model's bytes (the gate's instrument, never RSS)."""
    from horovod_tpu_torch.runtime.fsdp import FsdpPlane

    rank = hvd.rank()
    plane = FsdpPlane([[u] for u in _init_units(seed=11,
                                                sizes=MEM_UNIT_SIZES)],
                      name="mem")
    for step in range(2):
        for i in range(plane.n_units):
            plane.gather(i)
            plane.free(i)
        for i in reversed(range(plane.n_units)):
            plane.reduce_grads(
                i, [_t(_fsdp_grads(step, rank, MEM_UNIT_SIZES[i], salt=i))])
        for i in range(plane.n_units):
            plane.units[i].shard.sub_(float(LR) * plane.wait_grads(i))
        plane.step()
    st = eng.stats()
    assert st["priority_inversions"] == 0, st["priority_inversions"]
    print(f"FSDP_MEM rank={rank} "
          f"peak={st['fsdp_param_bytes_resident_peak']} "
          f"total={_total_param_bytes(plane)}", flush=True)


def fsdp_overlap(hvd, eng):
    """Two planes over identical units, prefetch 1 and 0, walked
    alternately in the same process (so placement and drift hit both):
    each walk's wall with per-unit compute, best of the rounds and every
    round, and the inversion and hit counters."""
    from horovod_tpu_torch.runtime.fsdp import FsdpPlane

    rank = hvd.rank()
    sizes = [40009] * 10
    plane_on = FsdpPlane([[u] for u in _init_units(seed=13, sizes=sizes)],
                         name="ovp", prefetch=1)
    plane_off = FsdpPlane([[u] for u in _init_units(seed=13, sizes=sizes)],
                          name="ovn", prefetch=0)
    rounds = int(os.environ.get("FSDP_OVERLAP_ROUNDS", "7"))
    work = int(os.environ.get("FSDP_OVERLAP_WORK", "48"))
    acc = 0.0

    def walk(plane):
        nonlocal acc
        t0 = time.perf_counter()
        for i in range(plane.n_units):
            w = plane.gather(i)[0]
            for _ in range(work):  # the compute the prefetch hides behind
                acc += float(torch.tanh(w).sum())
            plane.free(i)
        return (time.perf_counter() - t0) * 1e3

    walk(plane_on)
    walk(plane_off)
    rows = {"on": [], "off": []}
    for round_ in range(rounds):
        # Alternate which plane walks first.
        order = ("on", "off") if round_ % 2 == 0 else ("off", "on")
        for label in order:
            rows[label].append(walk(plane_on if label == "on"
                                    else plane_off))
    st = eng.stats()
    assert st["priority_inversions"] == 0, st["priority_inversions"]
    on_all = ",".join(f"{v:.3f}" for v in rows["on"])
    off_all = ",".join(f"{v:.3f}" for v in rows["off"])
    print(f"FSDP_OVERLAP rank={rank} on_ms={min(rows['on']):.3f} "
          f"off_ms={min(rows['off']):.3f} "
          f"inversions={st['priority_inversions']} "
          f"hits={st['fsdp_ag_prefetch_hits']} "
          f"misses={st['fsdp_ag_prefetch_misses']} "
          f"on_all={on_all} off_all={off_all} acc={acc:.3f}", flush=True)


# ---------------------------------------------------------------------------
# fp32-wire parity (the reference's tests/native_worker.py, wire_parity)
# ---------------------------------------------------------------------------

def _parity_cases(rank):
    """Per-rank payloads over every dtype the engine carries, odd and
    prime counts (empty channel slices), and buffers large enough to shard
    across the channel fan-out."""
    rng = np.random.default_rng(1000 + rank)
    dtypes = [torch.float32, torch.float64, torch.int32, torch.int64,
              torch.uint8, torch.int8, torch.uint16, torch.int16,
              torch.float16, torch.bfloat16]
    ops = ["sum", "min", "max"]
    cases = []
    for d, dt in enumerate(dtypes):
        for n in (1, 3, 7, 13, 61):
            src = (rng.standard_normal(n) if dt.is_floating_point
                   else rng.integers(0, 7, n))
            cases.append((_t(src).to(dt), ops[(d + n) % 3]))
    cases.append((_t(rng.integers(1, 3, 17)).to(torch.float32), "prod"))
    cases.append((_t(rng.integers(1, 3, 5)).to(torch.int64), "prod"))
    cases.append((_t(rng.integers(0, 2, 97) > 0), "sum"))   # bool or
    cases.append((_t(rng.integers(0, 2, 11) > 0), "min"))   # bool and
    cases.append((_t(rng.standard_normal(1 << 20)).to(torch.float32),
                  "sum"))
    cases.append((_t(rng.standard_normal(1 << 19)).to(torch.float16),
                  "sum"))
    cases.append((_t(rng.standard_normal(1 << 19)).to(torch.bfloat16),
                  "sum"))
    cases.append((_t(rng.integers(0, 100, 200003)).to(torch.int32), "sum"))
    return cases


def _parity_run(cases, tag):
    from horovod_tpu_torch.runtime import mpi_ops

    outs = [_allreduce(arr, f"par.{tag}.{i}", red_op=op)
            for i, (arr, op) in enumerate(cases)]
    # A fused burst: same dtype back to back.
    handles = [mpi_ops.allreduce_async(cases[0][0].to(torch.float32) + i,
                                       average=False,
                                       name=f"par.{tag}.fused.{i}")
               for i in range(9)]
    outs.extend(mpi_ops.synchronize(h) for h in handles)
    return outs


def wire_parity(hvd, eng):
    """The fp32-wire default: HOROVOD_WIRE_DTYPE unset, =fp32, and a
    per-tensor ``wire_dtype="fp32"`` give bitwise the same results over
    the parity corpus."""
    from horovod_tpu_torch.bench_engine import _reinit

    cases = _parity_cases(hvd.rank())
    base = _parity_run(cases, "wdef")
    s = eng.stats()
    assert s["config"]["wire_dtype"] == "fp32", s["config"]
    assert s["wire_fp16_count"] == 0 and s["wire_int8_count"] == 0, s
    assert s["compressed_bytes_tx"] == 0, s
    os.environ["HOROVOD_WIRE_DTYPE"] = "fp32"
    _reinit(hvd)
    explicit = _parity_run(cases, "wfp32")
    override = [_allreduce(arr, f"wovr.{i}", red_op=op, wire_dtype="fp32")
                for i, (arr, op) in enumerate(cases)]
    for i, (a, b) in enumerate(zip(base, explicit)):
        assert _same_bits(a, b), (
            f"case {i}: HOROVOD_WIRE_DTYPE=fp32 differs from default "
            f"(dtype {a.dtype})")
    for i, (a, c) in enumerate(zip(base, override)):
        assert _same_bits(a, c), (
            f"case {i}: wire_dtype='fp32' override differs from default")
    print(f"WIRE_PARITY_OK rank={hvd.rank()} cases={len(base)}", flush=True)


# ---------------------------------------------------------------------------
# compression convergence (the reference's tests/compression_worker.py)
# ---------------------------------------------------------------------------

DIM = 256
SAMPLES_PER_RANK = 256
CONV_STEPS = int(os.environ.get("HOROVOD_CONV_STEPS", "250"))
CONV_LR = 0.05


def _regression_shard(rank: int):
    rng = np.random.default_rng(1234)
    w_true = rng.standard_normal(DIM).astype(np.float32)
    rng_r = np.random.default_rng(77 + rank)
    X = rng_r.standard_normal((SAMPLES_PER_RANK, DIM)).astype(np.float32)
    y = X @ w_true + 0.01 * rng_r.standard_normal(
        SAMPLES_PER_RANK).astype(np.float32)
    return _t(X), _t(y.astype(np.float32))


def _regression_loss(w, shards):
    num, den = 0.0, 0
    for X, y in shards:
        r = X @ w - y
        num += float(r @ r)
        den += len(y)
    return num / den


def _train_compressed(mode, rank, shards):
    from horovod_tpu_torch.runtime import sparse

    X, y = shards[rank]
    w = torch.zeros(DIM, device=_DEVICE)
    m = len(y)
    for step in range(CONV_STEPS):
        grad = (2.0 / m) * (X.T @ (X @ w - y))
        name = f"conv.{mode}.g"
        if mode in ("fp32", "int8"):
            g = _allreduce(grad, f"{name}.{step}", average=True,
                           wire_dtype="int8" if mode == "int8" else None)
        else:
            g = sparse.sparse_allreduce_topk(
                grad, name=name, ratio=0.01,
                error_feedback=mode == "topk", average=True)
        w -= CONV_LR * g
    return w


def compression(hvd, eng):
    """int8 wire and top-k(1%) with error feedback converge within pinned
    bounds of the fp32 run; top-k without feedback is measurably worse."""
    from horovod_tpu_torch.runtime import sparse

    rank, size = hvd.rank(), hvd.size()
    shards = [_regression_shard(r) for r in range(size)]
    losses = {}
    for mode in ("fp32", "int8", "topk", "nofb"):
        sparse.reset_residuals()
        losses[mode] = _regression_loss(
            _train_compressed(mode, rank, shards), shards)
    if rank == 0:
        print("LOSSES " + " ".join(f"{m}={v:.6f}"
                                   for m, v in losses.items()), flush=True)
    init = _regression_loss(torch.zeros(DIM, device=_DEVICE), shards)
    assert losses["fp32"] < 0.05, losses
    assert losses["int8"] <= losses["fp32"] * 3.0 + 0.02, losses
    assert losses["topk"] <= 12.0, losses
    assert losses["topk"] <= init / 20.0, (losses, init)
    assert losses["nofb"] >= losses["topk"] * 1.5, losses
    assert losses["nofb"] >= losses["topk"] + 0.02, losses
    print(f"worker rank={rank} OK", flush=True)


# ---------------------------------------------------------------------------
# priority bands parity (the reference's tests/priority_worker.py,
# bands_parity)
# ---------------------------------------------------------------------------

def bands_parity(hvd, eng):
    """The same per-rank corpus under bands=1 and bands=0 (re-init
    between) gives bitwise the same results: ordering changes when
    responses dispatch, never what they compute."""
    from horovod_tpu_torch.bench_engine import _reinit
    from horovod_tpu_torch.runtime import mpi_ops

    rank = hvd.rank()

    def corpus(tag):
        rng = np.random.default_rng(17 + rank)
        outs = []
        for s in range(3):
            handles = [mpi_ops.allreduce_async(
                _t(rng.standard_normal(97 + 31 * j).astype(np.float32)),
                average=False, name=f"bp.{tag}.{s}.{j}", priority=5 - j)
                for j in range(6)]
            outs.extend(mpi_ops.synchronize(h) for h in handles)
            outs.append(mpi_ops.synchronize(mpi_ops.allgather_async(
                torch.full((rank + 1, 2), float(rank), device=_DEVICE),
                name=f"bp.{tag}.{s}.ag")))
        return outs

    assert eng.stats()["config"]["priority_bands"] == 1
    on = corpus("on")
    assert eng.stats()["priority_inversions"] == 0
    os.environ["HOROVOD_PRIORITY_BANDS"] = "0"
    _reinit(hvd)
    assert eng.stats()["config"]["priority_bands"] == 0
    off = corpus("off")
    for i, (a, b) in enumerate(zip(on, off)):
        assert _same_bits(a, b), f"case {i}: bands=1 differs from bands=0"
    print(f"BANDS_PARITY_OK rank={rank}", flush=True)


# ---------------------------------------------------------------------------
# wire policy (the reference's tests/wire_policy_worker.py)
# ---------------------------------------------------------------------------

OUT = 256
POLICY_SAMPLES = 128
POLICY_STEPS = int(os.environ.get("HOROVOD_CONV_STEPS", "120"))


def _policy_shard(rank: int):
    rng = np.random.default_rng(4321)
    w_true = (rng.standard_normal((DIM, OUT)) / np.sqrt(DIM)).astype(
        np.float32)
    b_true = rng.standard_normal(OUT).astype(np.float32)
    rng_r = np.random.default_rng(99 + rank)
    X = rng_r.standard_normal((POLICY_SAMPLES, DIM)).astype(np.float32)
    y = (X @ w_true + b_true
         + 0.01 * rng_r.standard_normal((POLICY_SAMPLES, OUT))).astype(
        np.float32)
    return _t(X), _t(y)


def _policy_loss(w, b, shards):
    num, den = 0.0, 0
    for X, y in shards:
        r = X @ w + b - y
        num += float((r * r).sum())
        den += r.numel()
    return num / den


def _train_policy(mode, rank, shards):
    from horovod_tpu_torch.runtime import mpi_ops
    from horovod_tpu_torch.runtime.wire_policy import WirePolicy

    X, y = shards[rank]
    w = torch.zeros((DIM, OUT), device=_DEVICE)
    b = torch.zeros(OUT, device=_DEVICE)
    m = len(y)
    policy = WirePolicy() if mode == "policy" else None
    for _ in range(POLICY_STEPS):
        r = X @ w + b - y
        gw = (2.0 / m) * (X.T @ r)
        gb = (2.0 / m) * r.sum(dim=0)
        wires = [None, None]
        if policy is not None:
            wires = [policy.observe_and_choose("wp.gw", gw),
                     policy.observe_and_choose("wp.gb", gb)]
        handles = [mpi_ops.allreduce_async_(
            g.clone(), True, name=f"wp.{mode}.{leaf}", wire_dtype=wire,
            wire_advisory=wire is not None)
            for g, leaf, wire in ((gw, "gw", wires[0]),
                                  (gb, "gb", wires[1]))]
        outs = [mpi_ops.synchronize(h) for h in handles]
        w -= CONV_LR * outs[0]
        b -= CONV_LR * outs[1]
    if policy is not None:
        assert policy.decisions.get("wp.gw") == "int8", policy.decisions
        assert policy.decisions.get("wp.gb") == "fp32", policy.decisions
    return w, b


def wire_policy(hvd, eng):
    """The statistics-driven wire policy cuts ``data_bytes_tx`` to <=
    0.60x of the fp32 run's at fp32-parity convergence."""
    rank, size = hvd.rank(), hvd.size()
    shards = [_policy_shard(r) for r in range(size)]
    losses, tx = {}, {}
    for mode in ("fp32", "policy"):
        before = eng.stats()
        w, b = _train_policy(mode, rank, shards)
        tx[mode] = eng.stats_delta(before)["data_bytes_tx"]
        losses[mode] = _policy_loss(w, b, shards)
    ratio = tx["policy"] / max(1, tx["fp32"])
    if rank == 0:
        print(f"WIRE_POLICY fp32_tx={tx['fp32']} policy_tx={tx['policy']} "
              f"ratio={ratio:.3f} "
              + " ".join(f"loss_{m}={v:.6f}" for m, v in losses.items()),
              flush=True)
    assert ratio <= 0.60, (ratio, tx)
    assert losses["fp32"] < 0.05, losses
    assert losses["policy"] <= losses["fp32"] * 3.0 + 0.02, losses
    assert eng.stats()["wire_int8_count"] > 0
    print(f"worker rank={rank} OK", flush=True)


SCENARIOS = {
    "sharded_numpy": sharded_numpy, "rs_bytes": rs_bytes,
    "fsdp_numpy": fsdp_numpy, "fsdp_mem": fsdp_mem,
    "fsdp_overlap": fsdp_overlap, "wire_parity": wire_parity,
    "compression": compression, "bands_parity": bands_parity,
    "wire_policy": wire_policy,
}


def main(argv=None) -> None:
    global _DEVICE
    from horovod_tpu_torch import bench_engine

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("scenario", choices=sorted(SCENARIOS))
    parser.add_argument("--device", default=None,
                        help="cpu to run on the CPU (default: the GPU)")
    args = parser.parse_args(argv)
    _DEVICE = bench_engine._DEVICE = bench_engine.device_name(args.device)
    hvd, eng = bench_engine._engine_setup()
    SCENARIOS[args.scenario](hvd, eng)
    hvd.shutdown()


if __name__ == "__main__":
    sys.exit(main())
