"""The trace reduction and each metric reader on synthetic traces."""

import pytest

from gpubench import metrics, trace
from gpubench.flops import PEAK_BF16_FLOPS


def ev(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


# Two traced steps on a 100 us stretch: compute 0-40 and 50-90 on one
# stream, an NCCL kernel 30-60 on another (overlapping compute 30-40 and
# 50-60: 10 us exposed), the optimizer 90-95, a copy 95-100, and the
# host's ranges.
EVENTS = [ev("nvjet_gemm", 0, 40), ev("vectorized_elementwise_kernel", 50, 40),
          ev("ncclDevKernel_AllReduce", 30, 30),
          ev("multi_tensor_apply_kernel", 90, 5),
          ev("Memcpy DtoD", 95, 5, "gpu_memcpy"),
          ev("gpubench.step", 0, 200, "user_annotation"),
          ev("aten::cat", 35, 30, "cpu_op"),
          ev("cudaLaunchKernel", 36, 2, "cuda_runtime"),
          ev("ignored", 0, 1, "python_function"),
          {"ph": "i", "name": "instant", "ts": 3}]
TRACE = trace.from_chrome({"traceEvents": EVENTS})


def run(**kw):
    base = dict(chips=1, steps=10, samples_per_step=32, window_s=2.0,
                step_ms=[100.0 + i for i in range(10)], peak_bytes=2 ** 31,
                setup_s=12.5, window_flops=1e15, peak_flops=PEAK_BF16_FLOPS,
                trace=TRACE, traced_steps=2)
    base.update(kw)
    return metrics.Run(**base)


def test_union_counts_overlap_once():
    assert TRACE.busy_us() == 100.0
    assert TRACE.window_us() == 100.0
    assert trace.union([(0, 2), (1, 3), (5, 6)]) == [(0, 3), (5, 6)]
    assert trace.overlap([(0, 3), (5, 6)], [(2, 5.5)]) == 1.5


def test_idle_share_uses_the_union():
    gappy = trace.from_chrome({"traceEvents": [
        ev("a", 0, 10), ev("b", 5, 10), ev("c", 30, 10),
        ev("h", 0, 40, "cpu_op"), ev("inner", 16, 2, "cpu_op")]})
    got = metrics.read("idle_share", run(trace=gappy))
    assert got == pytest.approx(100 * 15 / 40)   # busy 0-15 and 30-40
    assert trace.idle_gaps(gappy) == [(15, 30)]
    # The gap's middle (22.5) lies in "h" only ("inner" ends at 18).
    assert trace.breakdown(gappy)["idle_gaps"] == [["h", 15e-6]]


def test_host_activity_takes_the_innermost_range():
    ops = [trace.Op("outer", 0, 100, "cpu_op"),
           trace.Op("inner", 10, 20, "cpu_op"),
           trace.Op("later", 50, 60, "cpu_op")]
    assert trace.host_activity(ops, [15, 30, 55, 200]) == \
        ["inner", "outer", "later", trace.BETWEEN_CALLS]


def test_allreduce_readers():
    assert metrics.read("allreduce_ms", run()) == pytest.approx(0.015)
    assert metrics.read("allreduce_exposed_ms", run()) == \
        pytest.approx(0.005)


def test_group_readers():
    assert metrics.read("optimizer_ms", run()) == pytest.approx(0.0025)
    assert metrics.read("elementwise_ms", run()) == pytest.approx(0.02)


def test_readers_without_their_kernels_return_nothing():
    bare = trace.from_chrome({"traceEvents": [ev("nvjet", 0, 5)]})
    for name in ("allreduce_ms", "allreduce_exposed_ms", "optimizer_ms",
                 "elementwise_ms", "flash_roofline"):
        assert metrics.read(name, run(trace=bare)) is None
    for name in ("idle_share", "optimizer_ms", "flash_roofline"):
        assert metrics.read(name, run(trace=None)) is None


def test_flash_roofline():
    tr = trace.from_chrome({"traceEvents": [
        ev("void fwd_bf16<64, 1>", 0, 100), ev("bwd_dq_bf16", 100, 100),
        ev("bwd_dkv_bf16", 200, 200)]})
    got = metrics.read("flash_roofline", run(trace=tr,
                                             attention_bound_s=100e-6))
    assert got == pytest.approx(25.0)


def test_window_readers():
    r = run()
    assert metrics.read("samples_per_s", r) == pytest.approx(160.0)
    assert metrics.read("peak_mem_gib", r) == pytest.approx(2.0)
    assert metrics.read("setup_s", r) == 12.5
    assert metrics.read("step_ms_p90", r) == pytest.approx(108.1)
    assert metrics.read("mfu", run(chips=4)) == \
        pytest.approx(100 * 1e15 / 2.0 / (PEAK_BF16_FLOPS * 4))


def test_a_trace_without_device_work_is_refused():
    with pytest.raises(ValueError):
        trace.from_chrome({"traceEvents": [ev("aten::mm", 0, 1, "cpu_op")]})
