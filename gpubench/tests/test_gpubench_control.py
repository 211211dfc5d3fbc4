"""The check's control and planted faults must come out not correct.

On the CPU at a test's size, each drives a whole run (set-up, window,
reference, judgment) with ``run.run_rank``, skipping only the harness's
look for a card: sound, ``correct`` is true; with the timed path broken
underneath (the optimizer's step skipped, half of each rank's rows left
out, the exchange between ranks left out) it is false; and the control,
the reference computed in bfloat16 in the program's place, fails the
limits.  The limits here are set from this size's own readings (program
below, control and faults above); the cells' limits and the chip's
readings are in ``limits/`` and ``PERF.md``.  The ``cuda`` tests repeat
the control and a sound run at the cells' own sizes on the card.
"""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from gpubench import calibrate, compare, manifest
from gpubench import run as harness
from gpubench.tests.conftest import tiny_cell

#: Tiny-size readings on the CPU (4-5 seeds): BERT program loss <= 1e-4,
#: grad <= 0.0034, change <= 0.013; control change >= 0.86; half batch grad
#: >= 0.47.  ResNet (the numbers its cell compares) program grad median
#: <= 0.011, change median <= 0.0103, stats <= 0.0039; control stats
#: >= 0.50; half batch grad median >= 0.30, change median >= 0.29.
TINY_LIMITS = {
    "bert": {"grad_gap": 0.05, "change_gap": 0.1, "window_nonfinite": 0},
    "resnet": {"grad_gap_median": 0.1, "change_gap_median": 0.1,
               "stats_gap": 0.05, "window_nonfinite": 0}}
WORKLOADS = ["bert_base.pretrain_s512", "resnet50.train_b256"]


def cell_for(workload):
    cell = tiny_cell(workload)
    cell.limits = TINY_LIMITS[cell.config["family"]]
    return cell


def whole_run(cell, seed=2 ** 31 + 5):
    return harness.run_rank(cell, seed, 0.3, False, 0, 1, "cpu",
                            time.perf_counter())


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_is_correct(workload):
    assert whole_run(cell_for(workload))["correct"] is True


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_planted_fault_is_not_correct(workload, fault, monkeypatch):
    calibrate.plant(fault, monkeypatch.setattr)
    result = whole_run(cell_for(workload))
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct(workload):
    cell = cell_for(workload)
    line, = calibrate.readings(cell, [11], "control", 0, 1, "cpu")
    found = {k: {"value": line[k]} for k in cell.limits if k in line}
    found["window_nonfinite"] = {"value": 0.0}
    assert compare.judge(found, cell.limits)[0] is False, line


WORKER = """
import json, os, time
from gpubench.tests.test_gpubench_control import cell_for
from gpubench import calibrate, run
fault = os.environ["GPUBENCH_TEST_FAULT"]
if fault:
    calibrate.plant(fault)
res = run.run_rank(cell_for("bert_base.pretrain_s512"), 9, 0.3, False,
                   int(os.environ["HOROVOD_RANK"]), 2, "cpu", time.perf_counter())
if res is not None:
    print("RESULT", json.dumps(res))
"""


@pytest.mark.parametrize("fault,correct", [("", True), ("no_exchange", False)])
def test_exchange_left_out_is_not_correct(fault, correct):
    port = harness.free_port()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HOROVOD_")}
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER], cwd=manifest.ROOT,
        env={**env, **harness.rank_env(2, port, r),
             "GPUBENCH_TEST_FAULT": fault},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = [p.communicate(timeout=900) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs[0][1][-3000:]
    result = json.loads(outs[0][0].split("RESULT", 1)[1])
    assert result["correct"] is correct, result["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_the_cells_limits_on_the_card(workload, cuda_device):
    cell = manifest.cell(manifest.load(), workload)
    line, = calibrate.readings(cell, [2 ** 31 + 17], "control", 0, 1, "cuda")
    found = {k: {"value": line[k]} for k in cell.limits if k in line}
    found["window_nonfinite"] = {"value": 0.0}
    assert compare.judge(found, cell.limits)[0] is False, line


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_program_meets_the_cells_limits_on_the_card(workload, cuda_device):
    cell = manifest.cell(manifest.load(), workload)
    line, = calibrate.readings(cell, [2 ** 31 + 19], "program", 0, 1, "cuda")
    found = {k: {"value": line[k]} for k in cell.limits if k in line}
    found["window_nonfinite"] = {"value": 0.0}
    assert compare.judge(found, cell.limits)[0] is True, line
