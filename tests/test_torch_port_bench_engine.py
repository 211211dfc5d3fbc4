"""Port parity: the engine bench, ``python -m horovod_tpu_torch.bench_engine``.

The port's deterministic counters are held bitwise against the
reference's own workers, started as ranks of the root ``bench_engine.py``
(``--wire-sweep-worker``, ``--sharded-bytes-worker``) and of its
``tests/scale`` harness, on the same bytes: the wire byte ratios, the
sharded step's bytes, the star/ring counts of the algorithm sweep and the
control plane's negotiation bytes per cycle, hierarchical and flat.  The
reference's ``main()`` keys and dispatch flags are read from its source,
never imported.  One 2-rank sweep point runs end to end; the bench's merge
into ``horovod_tpu_torch.bench`` is held on its own.

Every world is 2 ranks (4 light ranks for the control plane) on the CPU;
the fixture runs them four at a time.  The reference's star/ring counts
come from a rank body of this file (``python <this file> algo_ref``) that
makes the reference worker's calls and reads the counters its line
leaves out.
"""

import ast
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_BENCH = os.path.join(REPO, "bench_engine.py")
PORT_BENCH = os.path.join(REPO, "horovod_tpu_torch", "bench_engine.py")

#: The three payload sizes of the star/ring count comparison.
ALGO_REF_SIZES = [("256B", 256), ("4KB", 4 << 10), ("32KB", 32 << 10)]
#: A 25 ms cycle puts every rank's enqueue of a step in one negotiation
#: cycle, so the control plane's round trips equal the steps and its bytes
#: per cycle are exact (at the default 2 ms, a step split over two cycles
#: now and then moves the figure in both packages).
SCALE_ENV = {"HOROVOD_CYCLE_TIME": "25"}
WIRE_BYTES = 1 << 20


def _algo_ref_rank() -> None:
    """The reference's algorithm-sweep worker's calls on its own engine,
    with the counters its line leaves out."""
    sys.path.insert(0, REPO)
    from horovod_tpu.common.basics import basics
    from horovod_tpu.runtime.engine import get_engine

    basics.init()
    eng = get_engine()
    for label, nbytes in ALGO_REF_SIZES:
        row = []
        for threshold in (str(1 << 20), "0"):
            os.environ["HOROVOD_ALGO_THRESHOLD"] = threshold
            basics.shutdown()
            basics.init()
            s0 = eng.stats()
            x = np.ones(max(1, nbytes // 4), dtype=np.float32)
            for _ in range(3):
                eng.allreduce(x.copy(), name="as.w")
            for _ in range(60):
                eng.synchronize(eng.enqueue_allreduce(x.copy(), name="as.t"))
            d = eng.stats_delta(s0)
            row += [d["algo_small_count"], d["algo_ring_count"]]
        if basics.rank() == 0:
            print(f"ALGO_COUNTS {label} " + " ".join(map(str, row)),
                  flush=True)
    basics.shutdown()


def _counts(out):
    return {label: tuple(int(v) for v in vals.split())
            for label, vals in re.findall(r"ALGO_COUNTS (\S+) ([\d ]+)",
                                          out)}


@pytest.fixture(scope="module")
def worlds():
    """Every world of the file, four at a time: {name: rank 0's output
    (the control plane's: run_world's result)}."""
    from horovod_tpu_torch import bench_engine as be
    from horovod_tpu_torch import scale_harness

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from scale import harness as ref_harness

    be._DEVICE = "cpu"
    ref = [sys.executable, REF_BENCH]
    jobs = {}
    for wd in ("fp32", "fp16", "int8"):
        env = {"BENCH_SWEEP_BYTES": str(WIRE_BYTES), "BENCH_WIRE_DTYPE": wd}
        jobs[f"port_wire_{wd}"] = (2, be._worker("--wire-sweep-worker"), env)
        jobs[f"ref_wire_{wd}"] = (2, ref + ["--wire-sweep-worker"], env)
    jobs["port_sharded"] = (2, be._worker("--sharded-bytes-worker"), {})
    jobs["ref_sharded"] = (2, ref + ["--sharded-bytes-worker"], {})
    jobs["port_algo"] = (2, be._worker("--algo-sweep-worker"), {})
    jobs["ref_algo"] = (2, [sys.executable, os.path.abspath(__file__),
                            "algo_ref"], {})

    def run(name):
        if name.startswith(("port_scale", "ref_scale")):
            harness = scale_harness if name.startswith("port") else \
                ref_harness
            return harness.run_world(4, groups=2, steps=20,
                                     hier=name.endswith("hier"),
                                     timeout=120, extra_env=SCALE_ENV)
        if name == "port_point":
            return be.sweep_point(2, "--sweep-worker",
                                  r"SWEEP_BUS_MB_S ([\d.]+)",
                                  {"BENCH_SWEEP_BYTES": str(64 << 10)})
        n, argv, env = jobs[name]
        return be._run_ranks(n, argv, timeout=150, extra_env=env)

    names = list(jobs) + ["port_scale_hier", "port_scale_flat",
                          "ref_scale_hier", "ref_scale_flat", "port_point"]
    with ThreadPoolExecutor(4) as pool:
        return dict(zip(names, pool.map(run, names)))


def _wire_tx(out):
    m = re.search(r"WIRE_SWEEP_BUS_MB_S ([\d.]+) TX (\d+)", out)
    assert m, out
    assert float(m.group(1)) > 0
    return int(m.group(2))


def test_wire_byte_ratios_equal_the_reference_bitwise(worlds):
    from horovod_tpu_torch.bench_engine import wire_ratios

    tx = {side: {wd: {"2": {"1MB": _wire_tx(worlds[f"{side}_wire_{wd}"])},
                      "4": {}}
                 for wd in ("fp32", "fp16", "int8")}
          for side in ("port", "ref")}
    assert tx["port"] == tx["ref"]
    for wd, want in (("fp16", 0.5), ("int8", 0.25)):
        got = wire_ratios(tx["port"], wd)
        assert got == wire_ratios(tx["ref"], wd)
        assert got["2"]["1MB"] == pytest.approx(want, abs=0.01), got


def test_sharded_step_bytes_equal_the_reference_bitwise(worlds):
    pat = r"SHARDED_BYTES ar_tx (\d+) rs_tx (\d+) ag_tx (\d+)"
    port = re.search(pat, worlds["port_sharded"]).groups()
    assert port == re.search(pat, worlds["ref_sharded"]).groups()
    ar_tx, rs_tx, ag_tx = map(int, port)
    assert rs_tx == ag_tx == ar_tx // 2 > 0


def test_algo_sweep_counts_equal_the_reference(worlds):
    port, ref = _counts(worlds["port_algo"]), _counts(worlds["ref_algo"])
    assert sorted(ref) == sorted(label for label, _ in ALGO_REF_SIZES)
    for label in ref:
        assert port[label] == ref[label], label
        # Star path under the high threshold, ring under 0: 63 calls each.
        assert ref[label] == (63, 0, 0, 63), ref[label]
    assert len(re.findall(r"ALGO_SWEEP \S+ [\d.]+ [\d.]+",
                          worlds["port_algo"])) == 4


@pytest.mark.parametrize("mode", ["hier", "flat"])
def test_negotiation_bytes_per_cycle_equal_the_reference(worlds, mode):
    port = worlds[f"port_scale_{mode}"]["stats"]
    ref = worlds[f"ref_scale_{mode}"]["stats"]
    for key in ("negotiation_bytes_per_cycle", "hier", "hosts",
                "negotiation_bytes_tx", "negotiation_bytes_rx",
                "control_round_trips"):
        assert port[key] == ref[key], (key, port, ref)
    assert port["hier"] == (1 if mode == "hier" else 0)
    assert port["hosts"] == 2 and port["control_round_trips"] == 20


def test_one_sweep_point_end_to_end(worlds):
    m = worlds["port_point"]
    assert m is not None and float(m.group(1)) > 0, m


def _result_keys(path):
    """The keys ``main()`` writes into ``result`` (source text of each
    subscript; f-strings as written) and those of the scale sweep's rows,
    read from the module's source."""
    tree = ast.parse(open(path).read())
    keys, rows = {"'metric'"}, set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Subscript) and isinstance(node.ctx,
                                                           ast.Store)
                and isinstance(node.value, ast.Name)
                and node.value.id == "result"):
            keys.add(ast.unparse(node.slice))
        if isinstance(node, ast.FunctionDef) and node.name == "_scale_sweep":
            rows |= {k.value for d in ast.walk(node)
                     if isinstance(d, ast.Dict) for k in d.keys
                     if isinstance(k, ast.Constant)}
    return keys, rows


def test_main_writes_the_reference_keys():
    ref_keys, ref_rows = _result_keys(REF_BENCH)
    port_keys, port_rows = _result_keys(PORT_BENCH)
    assert len(ref_keys) == 37 and len(ref_rows) == 8
    assert port_keys == ref_keys, ref_keys ^ port_keys
    assert port_rows == ref_rows, ref_rows ^ port_rows


def test_cli_takes_every_flag_of_the_reference_dispatch(monkeypatch):
    from horovod_tpu_torch import bench_engine as be

    src = open(REF_BENCH).read()
    block = src[src.index('if __name__ == "__main__":'):]
    flags = re.findall(r'"(--[\w-]+)" in sys\.argv', block)
    assert len(flags) == 23
    assert [f for f, _ in be.DISPATCH] == flags
    for flag, fn in be.DISPATCH:
        assert be.parse([flag, "--device", "cpu"]) == ("cpu", fn)
    assert be.parse(["--device", "cpu"]) == ("cpu", be.main)
    # No --device on a machine without CUDA: raises, naming --device cpu.
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        be.parse([])


def test_python_callers_and_worker_ranks_resolve_the_gpu(monkeypatch):
    """With no device given, the module's public functions and the
    workers' ranks resolve the GPU as the command line does: without
    CUDA they raise, naming --device cpu, before any rank starts."""
    from horovod_tpu_torch import bench_engine as be
    from horovod_tpu_torch import bench_engine_workers as bew
    from horovod_tpu_torch.common import launch

    started = []
    monkeypatch.setattr(launch, "World",
                        lambda *a, **kw: started.append(a))
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    monkeypatch.setattr(be, "_DEVICE", None)
    for call in (be.main, be.gate, be.fsdp_gate,
                 lambda: be.sweep_point(2, "--sweep-worker", r"x", {})):
        with pytest.raises(RuntimeError, match="--device cpu"):
            call()
    with pytest.raises(RuntimeError, match="--device cpu"):
        bew.main(["sharded_numpy"])
    assert started == [] and be._DEVICE is None
    monkeypatch.setattr("torch.cuda.is_available", lambda: True)
    monkeypatch.setattr("torch.cuda.current_device", lambda: 0)
    assert be._worker("--sweep-worker")[-2:] == ["--device", "cuda:0"]
    assert be._test_worker("rs_bytes")[-2:] == ["--device", "cuda:0"]


def test_free_port_skips_ports_whose_torch_port_would_overflow(monkeypatch):
    """A probe port within TORCH_PORT_OFFSET of 65535 has no torch port
    above it; the engine bench's hundreds of worlds drew one on the card
    (``OverflowError: bind(): port must be 0-65535``).  Ports are now
    drawn below the ephemeral ranges, the torch port included, and a
    port whose torch port is taken is skipped."""
    from horovod_tpu_torch.common import launch

    lo, hi = launch.PORT_RANGE
    assert 1024 < lo < hi and hi + launch.TORCH_PORT_OFFSET <= 32768
    handed = iter([25000, 26000])
    bound = []

    class FakeSocket:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            pass

        def bind(self, addr):
            bound.append(addr[1])
            if addr[1] == 25000 + launch.TORCH_PORT_OFFSET:
                raise OSError("address already in use")

    monkeypatch.setattr(launch.socket, "socket", FakeSocket)
    monkeypatch.setattr(launch.random.SystemRandom, "randrange",
                        lambda self, a, b: next(handed))
    assert launch.free_port() == 26000
    assert bound == [25000, 25064, 26000, 26064]
    monkeypatch.undo()
    ports = {launch.free_port() for _ in range(20)}
    assert all(lo <= p < hi for p in ports) and len(ports) > 10


def test_bench_merges_the_engine_line_under_engine_keys(monkeypatch):
    from horovod_tpu_torch import bench

    seen = {}

    def fake_run(argv, **kw):
        seen["argv"], seen["timeout"] = argv, kw["timeout"]
        line = json.dumps({"metric": "engine_data_plane",
                           "allreduce_small_latency_ms": {"2": 0.5}})
        return subprocess.CompletedProcess(argv, 0, "staging ...\n" + line,
                                           "")

    monkeypatch.setattr(bench.subprocess, "run", fake_run)
    assert bench.engine_result("cpu") == {
        "engine_allreduce_small_latency_ms": {"2": 0.5}}
    assert seen["argv"][1:] == ["-m", "horovod_tpu_torch.bench_engine",
                                "--device", "cpu"]
    assert seen["timeout"] == bench.ENGINE_BENCH_TIMEOUT_S

    def failing_run(argv, **kw):
        raise subprocess.TimeoutExpired(argv, kw["timeout"])

    monkeypatch.setattr(bench.subprocess, "run", failing_run)
    err = bench.engine_result("cuda")
    assert list(err) == ["engine_bench_error"]
    assert err["engine_bench_error"].startswith("TimeoutExpired")


if __name__ == "__main__":
    if sys.argv[1] == "algo_ref":
        _algo_ref_rank()
