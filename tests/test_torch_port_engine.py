"""Port parity: the eager native engine and its collectives.

The port's engine (``horovod_tpu_torch/cpp``, built by
``common/native_build.py``, bound by ``runtime/engine.py``) and its eager
ops on CPU tensors against the JAX package's, on the same seeded numpy
inputs:

* (i) ``hvd.allreduce`` / ``grouped_allreduce`` / ``allgather`` /
  ``broadcast`` / ``reducescatter`` / ``alltoall`` at 2 and 4 ranks against
  ``horovod_tpu.jax``'s eager ops: bitwise for fp32 Sum and Average at one
  ``HOROVOD_FUSION_THRESHOLD`` (small, so that the grouped tensors split
  into several fused responses; the worlds compared fused them alike),
  for Min, Max, Product, int32 Sum and
  Average and bf16 Average; reducescatter over ``scatter_axis`` 1 and
  ``tiled=False``; alltoall with uneven ``splits``; ``wire_int8`` and
  ``wire_bf16`` within ``tests/test_compression.py``'s envelopes;
* (ii) the handle API (``*_async``, ``poll``, ``synchronize``, in-place
  variants) and the autograd Functions at 2 ranks against
  ``horovod_tpu.torch``, the reference's own torch frontend: outputs and
  gradients bitwise;
* (iii) identity from ``HOROVOD_RANK``/``SIZE``/``LOCAL_RANK``/
  ``LOCAL_SIZE`` (the env of ``tests/test_basics.py``), ``epoch`` and the
  queries that raise before ``init``;
* the port's engine and the JAX package's, loaded in one process, stay
  apart.

Each world is this file run as a script once per rank (``_rank_main``),
identity from the env and rendezvous at ``HOROVOD_COORDINATOR``, as a user
launches ranks.  Reference and port run in separate processes, each with
its own engine library; a port process imports no JAX (it checks).  Only
the worker of the JAX side imports JAX, so this module does not at its
top.
"""

import ctypes
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FUSION_THRESHOLD = "1024"
#: tests/test_compression.py's envelopes (native_worker wire_values):
#: max |out - exact| / max |exact|.
WIRE_TOL = {"int8": 4e-2, "bf16": 2e-2}
#: Pairs of worlds run until one pair's grouped calls fused alike.
FUSE_ATTEMPTS = 4


def _splits(rank, size):
    """Rows rank ``rank`` sends to each rank: uneven, some of them 0."""
    return [(rank + 2 * d) % 3 for d in range(size)]


def _inputs(rank, size):
    """This rank's inputs (numpy, seeded by rank)."""
    rng = np.random.default_rng(100 + rank)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"ar": f(33, 7), "group": [f(64, 5), f(300), f(3, 4, 5), f(1),
                                     f(257)],
            "mm": f(17), "i32": rng.integers(-50, 50, 13).astype(np.int32),
            "bf16": f(40), "rs1": f(3, 2 * size + 1), "rs0": f(size, 6),
            "a2a": f(sum(_splits(rank, size)), 3), "ag": f(rank + 1, 4),
            "bc": f(5, 2), "wire": 3 * f(4096)}


def _ops_program(hvd, arr, to_np, rank, size, Compression, responses):
    """The eager ops of (i), the same calls on either side: ``arr`` makes
    a framework tensor of a numpy array (``bf16=True``: in bfloat16),
    ``to_np`` reads one back, ``responses()`` is the engine's count of
    responses executed.  Also returns ``grouped_responses``: the fused
    responses each grouped call took."""
    x = _inputs(rank, size)
    out = {}
    out["ar_sum"] = hvd.allreduce(arr(x["ar"]), op=hvd.Sum, name="ar_sum")
    out["ar_avg"] = hvd.allreduce(arr(x["ar"]), op=hvd.Average,
                                  name="ar_avg")
    fused = [responses()]
    for i, g in enumerate(hvd.grouped_allreduce(
            [arr(t) for t in x["group"]], op=hvd.Average, name="grp")):
        out[f"grouped_avg.{i}"] = g
    fused.append(responses())
    for i, g in enumerate(hvd.grouped_allreduce(
            [arr(t) for t in x["group"]], op=hvd.Sum)):
        out[f"grouped_sum.{i}"] = g
    fused.append(responses())
    for op in ("Min", "Max", "Product"):
        out[f"ar_{op}"] = hvd.allreduce(arr(x["mm"]), op=getattr(hvd, op),
                                        name=f"ar_{op}")
    out["i32_avg"] = hvd.allreduce(arr(x["i32"]), op=hvd.Average,
                                   name="i32_avg")
    out["i32_sum"] = hvd.allreduce(arr(x["i32"]), op=hvd.Sum, name="i32_sum")
    out["bf16_avg"] = hvd.allreduce(arr(x["bf16"], bf16=True),
                                    op=hvd.Average, name="bf16_avg")
    out["rs_axis1"] = hvd.reducescatter(arr(x["rs1"]), scatter_axis=1,
                                        name="rs_axis1")
    out["rs_untiled"] = hvd.reducescatter(arr(x["rs0"]), tiled=False,
                                          name="rs_untiled")
    out["a2a_splits"] = hvd.alltoall(arr(x["a2a"]), name="a2a",
                                     splits=_splits(rank, size))
    out["ag_ragged"] = hvd.allgather(arr(x["ag"]), name="ag")
    out["bc_root1"] = hvd.broadcast(arr(x["bc"]), root_rank=1, name="bc")
    for wd in WIRE_TOL:
        out[f"wire_{wd}"] = hvd.allreduce(
            arr(x["wire"]), op=hvd.Average, name=f"wire_{wd}",
            compression=getattr(Compression, f"wire_{wd}"))
    out = {k: to_np(v) for k, v in out.items()}
    out["grouped_responses"] = np.diff(fused)
    return out


def _handles_program(m, rank, size):
    """The handle API and the autograd Functions of (ii) on module ``m``
    (``horovod_tpu.torch`` or the port's ``runtime.mpi_ops``)."""
    rng = np.random.default_rng(200 + rank)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))

    out = {}
    x = t(6, 5)
    h = m.allreduce_async(x, True, "h.ar")
    deadline = time.monotonic() + 60
    while not m.poll(h):
        assert time.monotonic() < deadline, "allreduce never completed"
        time.sleep(0.001)
    out["h.ar"] = m.synchronize(h)
    y = x.clone()
    res = m.synchronize(m.allreduce_async_(y, False, "h.ar_"))
    assert res.data_ptr() == y.data_ptr()
    out["h.ar_"] = y
    for i, g in enumerate([m.synchronize(h) for h in
                           m.grouped_allreduce_async([x, 2 * x, x[0]], True,
                                                     "h.grp")]):
        out[f"h.grp.{i}"] = g
    out["h.i64"] = m.synchronize(m.allreduce_async(
        torch.from_numpy(rng.integers(-99, 99, 11)), True, "h.i64"))
    out["h.bf16"] = m.synchronize(m.allreduce_async(
        t(9).bfloat16(), True, "h.bf16")).float()
    out["h.ag"] = m.synchronize(m.allgather_async(t(rank + 1, 3), "h.ag"))
    b = t(4, 2)
    m.synchronize(m.broadcast_async_(b, 1, "h.bc_"))
    out["h.bc_"] = b
    out["h.bc"] = m.synchronize(m.broadcast_async(t(3), 0, "h.bc"))
    out["h.rs"] = m.synchronize(m.reducescatter_async(t(5, 3), "h.rs"))
    out["h.a2a"] = m.synchronize(m.alltoall_async(
        t(sum(_splits(rank, size)), 2), "h.a2a", splits=_splits(rank, size)))
    recv = [_splits(j, size)[rank] for j in range(size)]
    cases = {
        "allreduce": (t(4, 3), lambda v: m.allreduce(v, True, "g.ar")),
        "allreduce_sum": (t(4, 3), lambda v: m.allreduce(v, False)),
        "allgather": (t(rank + 2, 3), lambda v: m.allgather(v, "g.ag")),
        "broadcast": (t(4, 3), lambda v: m.broadcast(v, 1, "g.bc")),
        "reducescatter": (t(7, 2), lambda v: m.reducescatter(v, "g.rs")),
        "alltoall": (t(sum(_splits(rank, size)), 2),
                     lambda v: m.alltoall(v, "g.a2a",
                                          splits=_splits(rank, size),
                                          recv_splits=recv)),
    }
    for name, (v, fn) in cases.items():
        v.requires_grad_()
        y = fn(v)
        w = torch.from_numpy(rng.standard_normal(tuple(y.shape)).astype(
            np.float32))
        (y * w).sum().backward()
        out[f"fwd.{name}"] = y.detach()
        out[f"grad.{name}"] = v.grad
    return {k: v.detach().numpy() for k, v in out.items()}


def _rank_main(mode: str, dst: str) -> None:
    """One rank: ``python tests/test_torch_port_engine.py MODE OUT.npz``.

    ``port_ops`` / ``jax_ops`` run (i) on the port / the JAX package;
    ``port_handles`` / ``ref_handles`` run (ii) on the port /
    ``horovod_tpu.torch``.  Port modes also record this rank's identity and
    the engine's counters, and check that no JAX module was loaded."""
    if mode == "jax_ops":
        import jax
        jax.config.update("jax_platforms", "cpu")
        import jax.numpy as jnp
        import horovod_tpu.jax as hvd
        from horovod_tpu.ops.compression import Compression
        from horovod_tpu.runtime.engine import get_engine

        hvd.init()

        def arr(a, bf16=False):
            return jnp.asarray(a, jnp.bfloat16 if bf16 else a.dtype)

        def to_np(v):
            v = np.asarray(v)
            return v.astype(np.float32) if v.dtype.name == "bfloat16" else v

        out = _ops_program(hvd, arr, to_np, hvd.rank(), hvd.size(),
                           Compression,
                           lambda: get_engine().stats()["responses"])
        out["epoch"] = np.array(hvd.epoch())
    elif mode == "ref_handles":
        import horovod_tpu.torch as m

        m.init()
        out = _handles_program(m, m.rank(), m.size())
    else:
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.runtime import mpi_ops
        from horovod_tpu_torch.runtime.engine import get_engine

        with pytest.raises(ValueError, match="not been initialized"):
            hvd.rank()
        hvd.init(device="cpu")
        if mode == "port_ops":
            out = _ops_program(
                hvd, lambda a, bf16=False: torch.from_numpy(a).to(
                    torch.bfloat16 if bf16 else torch.from_numpy(a).dtype),
                lambda v: v.float().numpy() if v.dtype == torch.bfloat16
                else v.numpy(), hvd.rank(), hvd.size(), hvd.Compression,
                lambda: get_engine().stats()["responses"])
        else:
            out = _handles_program(mpi_ops, hvd.rank(), hvd.size())
        stats = get_engine().stats()
        out["identity"] = np.array([hvd.rank(), hvd.size(), hvd.local_rank(),
                                    hvd.local_size(),
                                    int(hvd.mpi_threads_supported())])
        out["epoch"] = np.array(hvd.epoch())
        out["stats"] = np.array([stats["responses"], stats["tensors"],
                                 stats["wire_int8_count"],
                                 stats["wire_bf16_count"]])
        bad = sorted(k for k in sys.modules
                     if k.split(".")[0] in ("jax", "jaxlib", "horovod_tpu"))
        assert not bad, bad
    np.savez(dst, **out)
    if mode == "ref_handles":
        m.shutdown()
    elif mode != "jax_ops":
        hvd.shutdown()
        with pytest.raises(ValueError, match="not been initialized"):
            hvd.size()


def _free_port():
    from horovod_tpu_torch.common.launch import free_port

    return free_port()


def _start_world(mode, n, tmp_path, local_size=None):
    """Start ``n`` ranks of ``mode``; returns (procs, output paths)."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "OMPI_", "PMI_"))}
    env.update(PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               HOROVOD_FUSION_THRESHOLD=FUSION_THRESHOLD,
               HOROVOD_COORDINATOR=f"127.0.0.1:{_free_port()}")
    local_size = local_size or n
    outs = [tmp_path / f"{mode}{n}.{r}.npz" for r in range(n)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, str(outs[r])],
        env=dict(env, HOROVOD_RANK=str(r), HOROVOD_SIZE=str(n),
                 HOROVOD_LOCAL_RANK=str(r % local_size),
                 HOROVOD_LOCAL_SIZE=str(local_size)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(n)]
    return procs, outs


def _finish(world, timeout=150):
    procs, outs = world
    try:
        for p in procs:
            log, _ = p.communicate(timeout=timeout)
            assert p.returncode == 0, log.decode(errors="replace")[-4000:]
    finally:
        for p in procs:
            p.kill()
    return [dict(np.load(o)) for o in outs]


def _fused_alike(got, want):
    return all(g["grouped_responses"].tolist()
               == w["grouped_responses"].tolist() for g, w in zip(got, want))


@pytest.mark.parametrize("n", [2, 4])
def test_eager_ops_match_the_jax_package_bitwise(n, tmp_path):
    """(i) and (iii): the same seeded inputs through both packages'
    eager ops, each world of ``n`` ranks in its own processes.

    Both engines (one C++ source) wake their cycle at a call's first
    enqueue, so a grouped call's tensors may reach the coordinator in two
    cycles and fuse into other responses; at 4 ranks a tensor's offset in
    its fused buffer decides the order its ring adds the ranks' values,
    so the bits follow the fusion.  Only a pair of worlds whose grouped
    calls fused alike computes the same sums: up to ``FUSE_ATTEMPTS``
    pairs run until one does, and that pair is held bitwise on every
    key."""
    for _ in range(FUSE_ATTEMPTS):
        port = _start_world("port_ops", n, tmp_path, local_size=n // 2)
        ref = _start_world("jax_ops", n, tmp_path, local_size=n // 2)
        got, want = _finish(port), _finish(ref)
        if _fused_alike(got, want):
            break
    assert _fused_alike(got, want), [
        (g["grouped_responses"].tolist(), w["grouped_responses"].tolist())
        for g, w in zip(got, want)]
    for r in range(n):
        assert got[r]["identity"].tolist() == [r, n, r % (n // 2), n // 2, 1]
        assert int(got[r]["epoch"]) == int(want[r]["epoch"]) >= 1
        _, _, n_int8, n_bf16 = got[r]["stats"].tolist()
        assert n_int8 == 1 and n_bf16 == 1
        for key, w in want[r].items():
            if key == "epoch" or key.startswith("wire_"):
                continue
            g = got[r][key]
            assert g.dtype == w.dtype and g.shape == w.shape, key
            assert g.tobytes() == w.tobytes(), (r, key)
    inputs = [_inputs(r, n) for r in range(n)]
    exact = np.mean([x["wire"] for x in inputs], axis=0)
    for r in range(n):
        for wd, tol in WIRE_TOL.items():
            for side in (got[r], want[r]):
                err = np.abs(side[f"wire_{wd}"] - exact).max() \
                    / np.abs(exact).max()
                assert err < tol, (wd, err)
    # The ops' meaning, once, on the host: sums, the floor average, the
    # reduced columns this rank keeps, the rows routed to it.
    total = np.sum([x["ar"] for x in inputs], axis=0, dtype=np.float64)
    np.testing.assert_allclose(got[0]["ar_sum"], total, rtol=1e-5, atol=1e-5)
    i32 = np.sum([x["i32"] for x in inputs], axis=0)
    assert got[1]["i32_avg"].tolist() == (i32 // n).tolist()
    cols = np.array_split(np.arange(2 * n + 1), n)[1]
    np.testing.assert_allclose(
        got[1]["rs_axis1"], np.sum([x["rs1"] for x in inputs], 0)[:, cols],
        rtol=1e-5, atol=1e-5)
    rows = [x["a2a"][sum(_splits(j, n)[:1]):sum(_splits(j, n)[:2])]
            for j, x in enumerate(inputs)]
    np.testing.assert_array_equal(got[1]["a2a_splits"], np.concatenate(rows))
    np.testing.assert_array_equal(got[0]["bc_root1"], inputs[1]["bc"])


def test_handles_and_autograd_match_the_reference_torch_frontend(tmp_path):
    """(ii): handles, in-place variants and gradients against
    ``horovod_tpu.torch`` at 2 ranks, bitwise."""
    port = _start_world("port_handles", 2, tmp_path)
    ref = _start_world("ref_handles", 2, tmp_path)
    got, want = _finish(port), _finish(ref)
    for r in range(2):
        assert set(want[r]) <= set(got[r])
        for key, w in want[r].items():
            g = got[r][key]
            assert g.dtype == w.dtype and g.shape == w.shape, key
            assert g.tobytes() == w.tobytes(), (r, key)
    # Non-root ranks' broadcast gradient is zero; the gathered gradient
    # keeps each rank's own rows.
    assert not got[0]["grad.broadcast"].any()
    assert got[1]["grad.broadcast"].any()
    assert got[1]["grad.allgather"].shape == (3, 3)


@pytest.fixture
def clean_env(monkeypatch):
    from horovod_tpu_torch.common import basics

    for name in (basics._RANK_ENV + basics._SIZE_ENV + basics._LOCAL_RANK_ENV
                 + basics._LOCAL_SIZE_ENV + ("HOROVOD_COORDINATOR",)):
        monkeypatch.delenv(name, raising=False)
    yield monkeypatch
    import horovod_tpu_torch as hvd
    hvd.shutdown()


def test_queries_raise_before_init_and_the_engine_starts_at_size_one(
        clean_env):
    """(iii) in this process: the queries raise before ``init``; ``init``
    starts the engine at size 1, whose collectives are identities that
    return new tensors; ``shutdown`` stops it."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.runtime.engine import get_engine

    for query in (hvd.rank, hvd.size, hvd.local_rank, hvd.local_size,
                  hvd.mpi_threads_supported):
        with pytest.raises(ValueError, match="not been initialized"):
            query()
    assert hvd.epoch() == 0
    hvd.init(device="cpu")
    lib = get_engine().lib
    assert lib.horovod_is_initialized() == 1 and lib.horovod_size() == 1
    assert hvd.mpi_threads_supported() is True
    x = torch.arange(6, dtype=torch.int64).reshape(2, 3)
    for out in (hvd.allreduce(x), hvd.allgather(x), hvd.broadcast(x, 0),
                hvd.alltoall(x), hvd.reducescatter(x),
                hvd.synchronize(hvd.allreduce_async(x))):
        assert torch.equal(out, x) and out.data_ptr() != x.data_ptr()
    assert hvd.reducescatter(x[:1], tiled=False).shape == (3,)
    assert hvd.poll(hvd.allgather_async(x))
    hvd.shutdown()
    assert lib.horovod_is_initialized() == 0


def test_two_engines_in_one_process_stay_apart(clean_env):
    """The JAX package's engine, loaded by this test process
    (tests/conftest.py) with ``RTLD_GLOBAL``, and the port's, loaded
    ``RTLD_LOCAL`` and linked ``-Bsymbolic``: work enqueued on the port's
    engine moves only its counters, and stopping it leaves the other
    running."""
    import horovod_tpu
    import horovod_tpu_torch as hvd
    from horovod_tpu.common.basics import basics as ref_basics
    from horovod_tpu_torch.runtime.engine import get_engine

    assert horovod_tpu.is_initialized()
    ref = ref_basics.native_lib
    ref.horovod_exec_cycles.restype = ctypes.c_int64
    hvd.init(device="cpu")
    eng = get_engine()
    assert eng.lib._handle != ref._handle
    ref_before, port_before = ref.horovod_exec_cycles(), \
        eng.stats()["cycles"]
    buf = torch.ones(8)
    eng.synchronize(eng.enqueue_allreduce(buf, name="apart"))
    assert eng.stats()["cycles"] > port_before
    assert ref.horovod_exec_cycles() == ref_before
    hvd.shutdown()
    assert eng.lib.horovod_is_initialized() == 0
    assert ref.horovod_is_initialized() == 1


if __name__ == "__main__":
    _rank_main(sys.argv[1], sys.argv[2])
