"""The plain references on small seeded cases: their update rules against
``torch.optim``, their steps against the port's at fp32 on the CPU (one
rank, and two gloo ranks for the data-parallel average)."""

import json
import os
import subprocess
import sys

import pytest
import torch

from gpubench import calibrate, manifest, weights
from gpubench import run as harness
from gpubench.families import bert
from gpubench.reference import bert_base, optim, train
from gpubench.tests.conftest import tiny_cell

#: fp32 on both sides: only the order of operations differs.  The first
#: step's numbers agree to rounding; three steps of SGD through the tiny
#: ResNet's BatchNorm (64 values a channel in its last stage) amplify it.
FP32_GAP = {"loss_gap": 1e-5, "grad_gap": 1e-5, "change_gap": 1e-3,
            "stats_gap": 1e-3}


@pytest.mark.parametrize("spec", [
    {"name": "adamw", "lr": 1e-2, "betas": [0.9, 0.999], "eps": 1e-8,
     "weight_decay": 1e-2},
    {"name": "sgd", "lr_per_rank": 0.05, "momentum": 0.9}])
def test_update_rules_match_torch_optim(spec):
    from gpubench import optimizers

    gen = torch.Generator().manual_seed(0)
    p0 = [torch.randn(5, 3, generator=gen), torch.randn(7, generator=gen)]
    mine = [p.clone() for p in p0]
    theirs = [torch.nn.Parameter(p.clone()) for p in p0]
    opt = optimizers.make(spec, theirs, world=2)
    state = optim.init(spec, mine)
    for t in range(1, 4):
        grads = [torch.randn(p.shape, generator=gen) for p in p0]
        for p, g in zip(theirs, grads):
            p.grad = g.clone()
        opt.step()
        optim.step(spec, mine, grads, state, t, world=2)
    for a, b in zip(mine, theirs):
        torch.testing.assert_close(a, b.detach(), rtol=1e-6, atol=1e-7)


def fp32_cell(workload):
    cell = tiny_cell(workload)
    cell.config["training"]["compute_dtype"] = "float32"
    return cell


@pytest.mark.parametrize("workload", ["bert_base.pretrain_s512",
                                      "resnet50.train_b256"])
def test_reference_follows_the_port_at_fp32(workload):
    line, = calibrate.readings(fp32_cell(workload), [7], "program", 0, 1,
                               "cpu")
    for name, gap in FP32_GAP.items():
        assert line.get(name, 0.0) < gap, (name, line)


def test_a_world_of_identical_ranks_is_one_rank():
    cell = tiny_cell("bert_base.pretrain_s512")
    cfg = cell.config
    start = weights.make(bert_base.param_specs(cfg), 3, "cpu")

    def block(s, r):
        return bert.block(cfg, cell.traffic, 3, s, 0, "cpu")
    one = train.follow(bert_base, cfg, start, block, 1, 3, torch.float32)
    two = train.follow(bert_base, cfg, start, block, 2, 3, torch.float32)
    assert two["losses"] == pytest.approx(one["losses"], rel=1e-6)
    for n in one["change"]:
        torch.testing.assert_close(two["change"][n], one["change"][n],
                                   rtol=1e-5, atol=1e-7)


WORKER = """
import json, os
from gpubench.tests.test_gpubench_reference import fp32_cell
from gpubench import calibrate
cell = fp32_cell("bert_base.pretrain_s512")
lines = calibrate.readings(cell, [5], "program",
                           int(os.environ["HOROVOD_RANK"]), 2, "cpu")
if lines is not None:
    print("LINES", json.dumps(lines))
"""


def test_reference_averages_ranks_as_the_port_does():
    port = harness.free_port()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HOROVOD_")}
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER], cwd=manifest.ROOT,
        env={**env, **harness.rank_env(2, port, r)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = [p.communicate(timeout=900) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs[0][1][-3000:]
    line, = json.loads(outs[0][0].split("LINES", 1)[1])
    for name in ("loss_gap", "grad_gap", "change_gap"):
        assert line[name] < FP32_GAP[name], (name, line)
