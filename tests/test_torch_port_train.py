"""Port parity: the data-parallel training step.

The port's ``make_train_step`` (tiny Llama in fp32, flash attention's
plain path, softmax_cross_entropy, DistributedOptimizer) against the JAX
package's ``make_train_step`` with ``flash_attention_fn`` on the same
weights (``params_from_jax``) and the same numpy-seeded token batch:

* fusion buckets: ``plan_fusion`` groups the same shapes and dtypes into
  the same buckets as the reference's;
* one rank against a 1-device mesh, 3 steps: SGD with momentum holds the
  trajectory tight (params within 1e-5: only summation orders differ).
  AdamW under master weights is held by the loss (rtol 1e-5) and by the
  params within 2 x lr: Adam's first steps divide each gradient by its
  own magnitude, so a near-zero gradient whose last bits differ between
  the frameworks moves its parameter by up to lr either way;
* two gloo ranks (this file run as a script twice, as a user launches
  ranks: identity from HOROVOD_RANK / HOROVOD_SIZE, rendezvous at
  HOROVOD_COORDINATOR; each steps its half of the batch) against a
  2-device mesh, after ``broadcast_parameters`` has made rank 1's weights
  rank 0's; then ``broadcast_optimizer_state`` makes rank 1's momentum
  rank 0's.  A rank drives the port alone: :func:`_rank_main` uses nothing
  of the JAX package.
"""

import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import horovod_tpu.jax as jhvd
import horovod_tpu_torch as hvd
from horovod_tpu.models import LlamaConfig as JaxLlamaConfig
from horovod_tpu.models import LlamaModel as JaxLlamaModel
from horovod_tpu.ops import fusion as jfusion
from horovod_tpu.ops.flash_attention import \
    flash_attention_fn as jax_flash_fn
from horovod_tpu.ops.losses import softmax_cross_entropy as jax_xent
from horovod_tpu.ops.mixed_precision import master_weights
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.models.convert import (init_params, params_from_jax,
                                              params_to_jax)
from horovod_tpu_torch.models.llama import LlamaConfig, LlamaModel
from horovod_tpu_torch.ops import fusion
from horovod_tpu_torch.ops.flash_attention import flash_attention_fn
from horovod_tpu_torch.ops.losses import softmax_cross_entropy
from horovod_tpu_torch.ops.mixed_precision import MasterWeights

TINY_FP32 = dataclasses.replace(LlamaConfig.tiny(), dtype=torch.float32,
                                logits_dtype=torch.float32)
JCFG = dataclasses.replace(JaxLlamaConfig.tiny(), dtype=jnp.float32,
                           logits_dtype=jnp.float32)
B, S, STEPS = 4, 24, 3


def lm_loss(model, tokens):
    logits = model(tokens[:, :-1])
    return softmax_cross_entropy(logits, tokens[:, 1:])


def _rank_main(src: str, dst: str) -> None:
    """One gloo rank: ``python tests/test_torch_port_train.py IN.npz
    OUT.npz``.

    IN holds the global batch ``tokens`` [B, S + 1], ``lr``, ``steps`` and
    rank 0's starting weights (``w.<name>``); other ranks start from other
    seeded weights, which ``broadcast_parameters`` must replace.  OUT holds
    this rank's weights after the broadcast (``bcast.<name>``), after the
    steps (``final.<name>``), the step losses, and the momentum buffers
    after ``broadcast_optimizer_state`` (rank 1 scrambles its own first).
    """
    hvd.init(device="cpu")
    rank, size = hvd.rank(), hvd.size()
    data = np.load(src)
    if rank == 0:
        state = {k[2:]: torch.from_numpy(data[k]) for k in data.files
                 if k.startswith("w.")}
    else:
        state = init_params(TINY_FP32, 1000 + rank, "cpu")
    model = LlamaModel.from_state_dict(TINY_FP32, state,
                                       attention_fn=flash_attention_fn)
    hvd.broadcast_parameters(model)
    out = {"bcast." + k: v.detach().numpy().copy()
           for k, v in model.state_dict().items()}
    opt = hvd.DistributedOptimizer(torch.optim.SGD(
        model.parameters(), lr=float(data["lr"]), momentum=0.9))
    step = hvd.make_train_step(model, lm_loss, opt)
    tokens = torch.from_numpy(data["tokens"]).long()
    n = tokens.shape[0] // size
    shard = tokens[rank * n:(rank + 1) * n]
    out["losses"] = np.array([float(step(shard))
                              for _ in range(int(data["steps"]))])
    out.update({"final." + k: v.detach().numpy()
                for k, v in model.state_dict().items()})
    # Momentum buffers: rank 1 scrambles its own, then takes root's.
    bufs = [opt.state[p]["momentum_buffer"] for p in model.parameters()]
    if rank == 1:
        for b in bufs:
            b.mul_(-3.0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    out["momentum"] = np.concatenate([b.reshape(-1).numpy() for b in bufs])
    np.savez(dst, **out)
    hvd.shutdown()


def _tokens(seed=0):
    return np.random.default_rng(seed).integers(
        0, JCFG.vocab_size, (B, S + 1)).astype(np.int32)


def _jax_variables():
    return JaxLlamaModel(JCFG).init(jax.random.key(3),
                                    jnp.zeros((1, S), jnp.int32))


def _jax_train(variables, tokens, opt, n_dev):
    model = JaxLlamaModel(JCFG, attention_fn=jax_flash_fn)

    def loss_fn(params, batch):
        logits = model.apply(params, batch[:, :-1])
        return jax_xent(logits, batch[:, 1:])

    mesh = jhvd.data_parallel_mesh(devices=jax.devices()[:n_dev])
    dopt = jhvd.DistributedOptimizer(opt)
    step = jhvd.make_train_step(loss_fn, dopt, mesh, donate=False)
    params, state = variables, dopt.init(variables)
    losses = []
    for _ in range(STEPS):
        params, state, loss = step(params, state, jnp.asarray(tokens))
        losses.append(float(loss))
    return params, np.array(losses)


def _assert_params_close(got_state, jax_params, atol):
    want = params_to_jax(
        params_from_jax(jax_params, TINY_FP32, "cpu"), TINY_FP32)["params"]
    got = params_to_jax(got_state, TINY_FP32)["params"]
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    for path, w in flat_w:
        np.testing.assert_allclose(flat_g[path], w, rtol=0, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.fixture
def cpu_world(monkeypatch):
    for name in basics._RANK_ENV + basics._SIZE_ENV + \
            basics._LOCAL_RANK_ENV + basics._LOCAL_SIZE_ENV + \
            ("HOROVOD_COORDINATOR",):
        monkeypatch.delenv(name, raising=False)
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


SHAPES = [((512, 64), "float32"), ((64,), "float32"), ((128, 64), "bfloat16"),
          ((64, 64), "float32"), ((7,), "int32"), ((64, 128), "bfloat16"),
          ((3, 5, 7), "float32"), ((1,), "bfloat16")]


@pytest.mark.parametrize("threshold", [None, 0, 1, 20000, 40000])
def test_fusion_plan_matches_jax(threshold):
    jleaves = [jnp.zeros(s, getattr(jnp, d)) for s, d in SHAPES]
    tleaves = [torch.zeros(s, dtype=getattr(torch, d)) for s, d in SHAPES]
    want = jfusion.plan_fusion(jleaves, threshold)
    got = fusion.plan_fusion(tleaves, threshold)
    assert [(b.indices, b.sizes, b.shapes) for b in got.buckets] == \
        [(b.indices, b.sizes, b.shapes) for b in want.buckets]
    assert [str(b.dtype).replace("torch.", "") for b in got.buckets] == \
        [np.dtype(b.dtype).name for b in want.buckets]
    out = fusion.fuse_apply(tleaves, lambda t: t + 1, threshold)
    assert all(torch.equal(o, t + 1) for o, t in zip(out, tleaves))


@pytest.mark.parametrize("kind", ["sgd_momentum", "adamw_master_weights"])
def test_one_rank_trajectory_matches_jax(kind, cpu_world):
    variables, tokens = _jax_variables(), _tokens()
    if kind == "sgd_momentum":
        lr = 0.05
        jopt = optax.sgd(lr, momentum=0.9)
    else:
        lr = 1e-2
        jopt = master_weights(optax.adamw(lr, b1=0.9, b2=0.999, eps=1e-8,
                                          weight_decay=1e-4))
    jparams, jlosses = _jax_train(variables, tokens, jopt, n_dev=1)

    model = LlamaModel.from_state_dict(
        TINY_FP32, params_from_jax(variables, TINY_FP32, "cpu"),
        attention_fn=flash_attention_fn)
    if kind == "sgd_momentum":
        opt = torch.optim.SGD(model.parameters(), lr=lr, momentum=0.9)
    else:
        opt = MasterWeights(model.parameters(), torch.optim.AdamW, lr=lr,
                            betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
    dopt = hvd.DistributedOptimizer(opt)
    step = hvd.make_train_step(model, lm_loss, dopt)
    losses = np.array([float(step(torch.from_numpy(tokens).long()))
                       for _ in range(STEPS)])

    assert losses[-1] < losses[0]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    _assert_params_close(model.state_dict(), jparams,
                         1e-5 if kind == "sgd_momentum" else 2 * lr)
    plan = dopt.last_plan
    assert sum(len(b.indices) for b in plan.buckets) == \
        len(list(model.parameters()))


def test_two_gloo_ranks_match_jax_two_device_mesh(tmp_path):
    variables, tokens = _jax_variables(), _tokens(seed=1)
    lr = 0.05
    jparams, jlosses = _jax_train(variables, tokens,
                                  optax.sgd(lr, momentum=0.9), n_dev=2)
    start = params_from_jax(variables, TINY_FP32, "cpu")
    np.savez(tmp_path / "in.npz", tokens=tokens, lr=lr, steps=STEPS,
             **{"w." + k: v.numpy() for k, v in start.items()})
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "OMPI_", "PMI_"))}
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__),
         str(tmp_path / "in.npz"), str(tmp_path / f"out{r}.npz")],
        env=dict(env, HOROVOD_RANK=str(r), HOROVOD_SIZE="2",
                 HOROVOD_COORDINATOR=f"127.0.0.1:{port}"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(2)]
    for p in procs:
        out, _ = p.communicate(timeout=240)
        assert p.returncode == 0, out.decode(errors="replace")[-3000:]
    res = [np.load(tmp_path / f"out{r}.npz") for r in range(2)]
    for name in start:
        np.testing.assert_array_equal(res[1]["bcast." + name],
                                      start[name].numpy(), err_msg=name)
        np.testing.assert_array_equal(res[1]["final." + name],
                                      res[0]["final." + name], err_msg=name)
    np.testing.assert_array_equal(res[0]["losses"], res[1]["losses"])
    np.testing.assert_array_equal(res[1]["momentum"], res[0]["momentum"])
    np.testing.assert_allclose(res[0]["losses"], jlosses, rtol=1e-5)
    _assert_params_close({k: torch.from_numpy(res[0]["final." + k])
                          for k in start}, jparams, 1e-5)


if __name__ == "__main__":
    _rank_main(sys.argv[1], sys.argv[2])
