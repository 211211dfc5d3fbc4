"""The port's nine example counterparts (``horovod_tpu_torch/examples/``).

* each runs its ``--smoke --device cpu`` in-process (``main(argv)`` after
  ``hvd.init(device="cpu")``) and prints ``done``; without a GPU and
  without ``--device cpu`` each raises instead of running on the CPU;
* both ResNet-50 examples resume: the JAX form in-process, the hook form
  at size 2 through ``python -m horovod_tpu_torch.run -np 2``, as the
  reference's ``test_torch_resnet50_example_resumes_two_process``;
* ``flax_mnist_advanced`` on two gloo CPU ranks (this file run as a
  script twice, :func:`_rank_main`) ends with the same parameters on both
  ranks: its gradients are averaged, where the reference example steps a
  plain ``TrainState`` and its ranks drift apart after the first
  broadcast (ROADMAP.md Queue C).
"""

import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

EXAMPLES = ["jax_mnist", "flax_mnist", "flax_mnist_advanced",
            "jax_mnist_estimator", "jax_word2vec", "jax_imagenet_resnet50",
            "torch_mnist", "torch_imagenet_resnet50",
            "torch_synthetic_benchmark"]


def _example(name):
    return importlib.import_module(f"horovod_tpu_torch.examples.{name}")


def _clean_env(monkeypatch):
    from horovod_tpu_torch.common import basics

    for name in basics._RANK_ENV + basics._SIZE_ENV + \
            basics._LOCAL_RANK_ENV + basics._LOCAL_SIZE_ENV + \
            ("HOROVOD_COORDINATOR",):
        monkeypatch.delenv(name, raising=False)


@pytest.fixture
def cpu_world(monkeypatch):
    """A world of one on the CPU, computing on one thread: the tier-1 run
    puts several test processes on the machine's cores, and torch's
    default of a thread a core then slows the examples' bf16 ResNet-50
    steps a hundredfold (its CPU convolutions wait on each other's
    threads); one thread each keeps them near their time alone."""
    import horovod_tpu_torch as hvd

    _clean_env(monkeypatch)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    hvd.init(device="cpu")
    yield
    hvd.shutdown()
    torch.set_num_threads(threads)


def _dirs(name, tmp_path):
    flag = {"jax_mnist": "--checkpoint-dir",
            "flax_mnist_advanced": "--checkpoint-dir",
            "jax_mnist_estimator": "--model-dir",
            "jax_imagenet_resnet50": "--checkpoint-dir",
            "torch_imagenet_resnet50": "--checkpoint-dir"}.get(name)
    return [flag, str(tmp_path / "ckpt")] if flag else []


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_smoke_prints_done(name, cpu_world, tmp_path, capsys):
    out = _example(name).main(["--smoke", "--device", "cpu"]
                              + _dirs(name, tmp_path))
    assert isinstance(out, dict)
    assert capsys.readouterr().out.strip().splitlines()[-1] == "done"


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_without_gpu_raises(name, monkeypatch, tmp_path):
    """No GPU here and no ``--device cpu``: ``hvd.init`` refuses before
    anything runs."""
    import horovod_tpu_torch as hvd

    _clean_env(monkeypatch)
    assert not torch.cuda.is_available() and not hvd.is_initialized()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example(name).main(["--smoke"] + _dirs(name, tmp_path))
    assert not hvd.is_initialized()


def test_jax_form_resnet50_resumes(cpu_world, tmp_path, capsys):
    """The first run writes ``checkpoint-0.pt``; the second finds it on
    rank 0, says so, and starts at epoch 1 with the saved weights."""
    from horovod_tpu_torch import training

    main = _example("jax_imagenet_resnet50").main
    argv = ["--smoke", "--device", "cpu", "--checkpoint-dir",
            str(tmp_path)]
    first = main(argv)
    assert first["start_epoch"] == 0 and len(first["logs"]) == 1
    assert np.isfinite(first["logs"][0]["loss"])
    assert training.latest_checkpoint(str(tmp_path))[1] == 0
    capsys.readouterr()
    second = main(argv + ["--epochs", "2"])
    out = capsys.readouterr().out
    assert "resuming from epoch 1" in out and out.rstrip().endswith("done")
    assert second["start_epoch"] == 1


def _launch(n, argv, timeout=300):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "OMPI_", "PMI_", "JAX_",
                                "XLA_"))}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", str(n),
         "--"] + argv, cwd=REPO, env=env, capture_output=True, text=True,
        timeout=timeout)


def test_hook_form_resnet50_resumes_two_process(tmp_path):
    """Two ranks: the first run trains epoch 1 and rank 0 writes
    ``checkpoint-1.pt``; the second run's rank 0 finds it, every rank
    agrees on the broadcast resume epoch, and epoch 2 is trained."""
    argv = [sys.executable, "-m",
            "horovod_tpu_torch.examples.torch_imagenet_resnet50", "--smoke",
            "--device", "cpu", "--checkpoint-dir", str(tmp_path)]
    first = _launch(2, argv)
    assert first.returncode == 0, first.stdout + first.stderr
    assert first.stdout.count("done") == 2
    assert "epoch 1: train_loss=" in first.stdout
    assert os.path.exists(tmp_path / "checkpoint-1.pt")
    second = _launch(2, argv)
    assert second.returncode == 0, second.stdout + second.stderr
    assert "resuming from epoch 1" in second.stdout
    assert "epoch 2: train_loss=" in second.stdout
    assert second.stdout.count("done") == 2


def _rank_main(dst: str) -> None:
    """One rank of ``flax_mnist_advanced --smoke --device cpu``: ``python
    tests/test_torch_port_examples.py OUT.npz`` (identity from
    HOROVOD_RANK / HOROVOD_SIZE); OUT holds the final parameters and the
    epoch logs."""
    import horovod_tpu_torch as hvd

    out = _example("flax_mnist_advanced").main(["--smoke", "--device",
                                                "cpu"])
    model = out["state"].model
    np.savez(dst, loss=out["logs"][-1]["loss"], lr=out["lr"],
             **{"p." + k: v.detach().numpy()
                for k, v in model.state_dict().items()})
    hvd.shutdown()


def test_flax_mnist_advanced_two_ranks_stay_equal(tmp_path):
    """Each rank trains on its own half of the data; the averaged
    gradients keep the two ranks' parameters bitwise equal, the logged
    loss is the ranks' average, and the warmup (n = 2, one epoch of 4
    batches) has ramped lr · n = 0.02 to 0.02 · (1 + 3/4) / 2 at its
    last batch."""
    from horovod_tpu_torch.common.launch import World

    with World(2, [sys.executable, os.path.abspath(__file__),
                   str(tmp_path / "out{}.npz")],
               env=dict(PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
               drop=("HOROVOD_", "OMPI_", "PMI_", "JAX_", "XLA_")) as world:
        world.wait(timeout_s=240)
    res = [np.load(tmp_path / f"out{r}.npz") for r in range(2)]
    names = [k for k in res[0].files if k.startswith("p.")]
    assert names
    for k in names:
        np.testing.assert_array_equal(res[0][k], res[1][k], err_msg=k)
    assert float(res[0]["loss"]) == float(res[1]["loss"])
    assert float(res[0]["lr"]) == pytest.approx(0.02 * (1 + 3 / 4) / 2)


if __name__ == "__main__":
    _rank_main(sys.argv[1].format(os.environ["HOROVOD_RANK"]))
