"""Port parity: the bench step and ``python -m horovod_tpu_torch.bench``.

The bench step (``horovod_tpu_torch.bench.make_step_and_state``: SGD
with momentum at 0.01 · size, ``make_train_step`` (which averages the running statistics),
the fp32 log-softmax NLL) over 3 steps of fp32 ResNet-50 (B 2 a rank,
64 x 64) against the reference's own ``bench.py`` ``_make_step_and_state``
(``horovod_tpu.jax.make_train_step(..., has_aux=True)``), on the same
weights (the reference's ``init``, converted) and the same numpy data: at
one rank against a 1-device mesh, and on two gloo ranks (this file run as
a script twice, :func:`_rank_main`) against a 2-device mesh — each rank
normalises with its own rows' statistics, as each device of the
reference's shard_map does, and the running statistics are averaged
after the step as the reference averages its ``batch_stats``.  Then the
entry point's ``--smoke --device cpu`` JSON line.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bench as jax_bench
import horovod_tpu.jax as jhvd
import horovod_tpu_torch as hvd
from horovod_tpu.models.resnet import ResNet50 as JaxResNet50
from horovod_tpu_torch import bench as port_bench
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.models.convert import (init_params, params_from_jax,
                                              params_to_jax)
from horovod_tpu_torch.models.resnet import ResNetConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = ResNetConfig.resnet50(dtype=torch.float32)
B, S, STEPS = 2, 64, 3


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _close_to_max(got, want, rel, name="", floor=0.0):
    """max |got − want| <= rel · max |want| + floor, as numpy arrays."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err, top = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= rel * top + floor, \
        f"{name}: max |d| {err} vs {rel} x {top} + {floor}"


@pytest.fixture
def cpu_world(monkeypatch):
    for name in basics._RANK_ENV + basics._SIZE_ENV + \
            basics._LOCAL_RANK_ENV + basics._LOCAL_SIZE_ENV + \
            ("HOROVOD_COORDINATOR",):
        monkeypatch.delenv(name, raising=False)
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def _reference_run(n_dev):
    """The reference bench's step (fp32 ResNet-50, B per device, S): the
    starting state dict, and after STEPS steps the losses and the final
    {"params", "batch_stats"}."""
    mesh = jhvd.data_parallel_mesh(devices=jax.devices()[:n_dev])
    step, state, data = jax_bench._make_step_and_state(
        JaxResNet50(dtype=jnp.float32), mesh, B, S, n_dev)
    start = params_from_jax(jax.device_get(
        {"params": state[0], "batch_stats": state[2]}), CFG, "cpu")
    losses = []
    for _ in range(STEPS):
        *state, loss = step(*state, data)
        losses.append(float(loss))
    final = jax.device_get({"params": state[0], "batch_stats": state[2]})
    return start, np.array(losses), final


def _assert_state_close(got_state, want, start):
    """Each parameter's update over the steps within 3 % of its tensor's
    largest update plus 2.4e-7 (two fp32 ulps at 1, where the BatchNorm
    scales sit and an update of 1e-7 is the resolution), and each running
    statistic within 1e-5 of its tensor's largest.  Three steps from the
    same weights: the two frameworks' fp32 gradients differ in their last
    bits (each framework's own fp32 run differs from its fp64 one by
    more: test_torch_port_resnet.py), and where a ReLU's input lands
    within rounding of zero one element's gradient switches; at B 2 a
    rank, through 53 BatchNorms, that moved one element of a BatchNorm
    scale by 2.6e-5, 0.9 % of that tensor's largest update (two ranks;
    one rank: 1.5e-8)."""
    got = params_to_jax(got_state, CFG)
    w, s0 = _flat(want), _flat(params_to_jax(start, CFG))
    for k, v in _flat(got).items():
        if "batch_stats" in k:
            _close_to_max(v, w[k], 1e-5, k)
        else:
            _close_to_max(v - s0[k], w[k] - s0[k], 3e-2, k, floor=2.4e-7)


def _rank_main(src: str, dst: str) -> None:
    """One gloo rank: ``python tests/test_torch_port_resnet_bench.py IN.npz
    OUT.npz``.  IN holds rank 0's starting state (``w.<name>``); other
    ranks start from other seeded weights, which the bench's
    ``broadcast_parameters`` must replace.  OUT holds the step losses and
    this rank's final state (``final.<name>``)."""
    hvd.init(device="cpu")
    data = np.load(src)
    if hvd.rank() == 0:
        state = {k[2:]: torch.from_numpy(data[k]) for k in data.files
                 if k.startswith("w.")}
    else:
        state = init_params(CFG, 1000 + hvd.rank(), "cpu")
    step, model, _, batch = port_bench.make_step_and_state(
        CFG, B, S, state=state)
    out = {"losses": np.array([float(step(batch)) for _ in range(STEPS)])}
    out.update({"final." + k: v.numpy()
                for k, v in model.state_dict().items()})
    np.savez(dst, **out)
    hvd.shutdown()


def test_bench_step_one_rank_matches_the_reference(cpu_world):
    """Loss rtol 1e-5 over 3 steps; params and running statistics close
    (:func:`_assert_state_close`); the running statistics moved."""
    start, want_losses, final = _reference_run(1)
    start0 = {k: v.clone() for k, v in start.items()}
    mean0 = start0["blocks.0.norms.0.mean"]
    step, model, opt, batch = port_bench.make_step_and_state(
        CFG, B, S, state=start)
    assert batch[0].shape == (B, S, S, 3) and batch[1].shape == (B,)
    losses = np.array([float(step(batch)) for _ in range(STEPS)])
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    _assert_state_close(model.state_dict(), final, start0)
    assert not torch.equal(model.blocks[0].norms[0].mean, mean0)
    assert isinstance(opt.inner, torch.optim.SGD)
    assert opt.inner.defaults["lr"] == pytest.approx(0.01)


def test_bench_step_two_gloo_ranks_match_the_two_device_mesh(tmp_path):
    """Each rank steps its 2 rows of the global batch of 4, normalising
    with its own rows' statistics; gradients, loss and running statistics
    averaged: the 2-device reference's losses (rtol 1e-5) and state
    (:func:`_assert_state_close`), the two ranks bitwise equal."""
    start, want_losses, final = _reference_run(2)
    np.savez(tmp_path / "in.npz",
             **{"w." + k: v.numpy() for k, v in start.items()})
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "OMPI_", "PMI_"))}
    env["PYTHONPATH"] = REPO
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__),
         str(tmp_path / "in.npz"), str(tmp_path / f"out{r}.npz")],
        env=dict(env, HOROVOD_RANK=str(r), HOROVOD_SIZE="2",
                 HOROVOD_COORDINATOR=f"127.0.0.1:{port}"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(2)]
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out.decode(errors="replace")[-3000:]
    res = [np.load(tmp_path / f"out{r}.npz") for r in range(2)]
    np.testing.assert_array_equal(res[0]["losses"], res[1]["losses"])
    for name in start:
        np.testing.assert_array_equal(res[1]["final." + name],
                                      res[0]["final." + name], err_msg=name)
    np.testing.assert_allclose(res[0]["losses"], want_losses, rtol=1e-5)
    _assert_state_close({k: torch.from_numpy(res[0]["final." + k])
                         for k in start}, final, start)


def test_bench_smoke_prints_its_json_line():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "OMPI_", "PMI_"))}
    env["PYTHONPATH"] = REPO
    # The engine bench's sweeps and 64-rank worlds take tens of minutes;
    # its merge is held on its own (test_torch_port_bench_engine.py).
    env["HOROVOD_SKIP_ENGINE_BENCH"] = "1"
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.bench", "--smoke",
         "--device", "cpu"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["metric"] == "resnet50_train_images_per_sec_cpu_smoke"
    assert line["value"] > 0 and line["mfu"] is None
    assert len(line["step_ms_spread"]) == 3
    assert not any(k.startswith("engine_") for k in line), sorted(line)
    assert line["model_tflops_per_step"] == round(
        port_bench.model_flops_per_step(ResNetConfig.resnet50(), 32, 8)
        / 1e12, 3)
    assert port_bench.model_flops_per_step(ResNetConfig.resnet50(), 224,
                                           256) == pytest.approx(6.28e12,
                                                                 rel=1e-3)


if __name__ == "__main__":
    _rank_main(sys.argv[1], sys.argv[2])
