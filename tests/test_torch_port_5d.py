"""The port's flagship example and dry run:
``horovod_tpu_torch/examples/llama_training_5d.py --smoke --device cpu``
for each strategy (``gspmd`` dense and with ``--experts 4``, ``seq``,
``pipeline``; a world of one, and ``gspmd`` with ``--tensor 2`` on two
gloo ranks), and ``parallel/dryrun.dryrun_multichip(4)``, the counterpart
of ``__graft_entry__.dryrun_multichip``: one step of each family (MoE
data x fsdp x tensor x expert, data x seq ring, pipe x data) on four gloo
ranks, every loss finite and equal on every rank.  Every run started at
once, each with its own timeout.
"""

import contextlib
import math
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = {
    "gspmd": (1, ["--strategy", "gspmd"]),
    "gspmd_experts": (1, ["--strategy", "gspmd", "--experts", "4"]),
    "seq": (1, ["--strategy", "seq"]),
    "pipeline": (1, ["--strategy", "pipeline"]),
    "gspmd_tensor2": (2, ["--strategy", "gspmd", "--tensor", "2"]),
}
TIMEOUT_S = 300


@pytest.fixture(scope="module")
def outputs():
    """Every example run and the dry run, started together: {name: each
    rank's output, or the error}; "dryrun": the per-rank losses, or the
    error."""
    sys.path.insert(0, REPO)
    from horovod_tpu_torch.common.launch import World
    from horovod_tpu_torch.parallel.dryrun import dryrun_multichip

    drop = ("HOROVOD_", "OMPI_", "PMI_", "JAX_", "XLA_")
    worlds = {name: World(n, [sys.executable, "-m",
                              "horovod_tpu_torch.examples.llama_training_5d",
                              "--smoke", "--device", "cpu", *flags],
                          env=dict(PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
                          cwd=REPO, drop=drop)
              for name, (n, flags) in RUNS.items()}
    out = {}
    with contextlib.ExitStack() as stack:
        for world in worlds.values():
            stack.enter_context(world)
        threads = os.environ.get("OMP_NUM_THREADS")
        os.environ["OMP_NUM_THREADS"] = "1"      # the ranks' own setting
        try:
            out["dryrun"] = dryrun_multichip(4, device="cpu",
                                             timeout_s=TIMEOUT_S)
        except RuntimeError as e:
            out["dryrun"] = e
        finally:
            if threads is None:
                del os.environ["OMP_NUM_THREADS"]
            else:
                os.environ["OMP_NUM_THREADS"] = threads
        for name, world in worlds.items():
            try:
                out[name] = world.wait(TIMEOUT_S)
            except RuntimeError as e:
                out[name] = e
    return out


@pytest.mark.parametrize("name", list(RUNS))
def test_example_smoke_runs_on_the_cpu(outputs, name):
    ranks = outputs[name]
    assert not isinstance(ranks, Exception), str(ranks)[-3000:]
    for text in ranks:
        assert "done" in text
    losses = [float(line.split("loss=")[1]) for line in ranks[0].split(
        "\n") if line.startswith("step ")]
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)
    for text in ranks[1:]:
        assert "step 0:" not in text          # rank 0 reports


def test_dryrun_multichip_on_four_gloo_ranks(outputs):
    dry = outputs["dryrun"]
    assert not isinstance(dry, Exception), str(dry)[-3000:]
    assert len(dry) == 4
    assert set(dry[0]) == {"gspmd", "seq", "pipeline"}
    assert all(math.isfinite(v) for v in dry[0].values())
    assert all(r == dry[0] for r in dry)
