"""Port parity: packed-sequence pretraining.

The port's ``examples/llama_packed_pretraining.py`` pieces —
``make_packed_batch``, ``packed_lm_loss`` (flash attention with
``segment_ids``, the loss masked at document boundaries) and
``make_train_step`` over a ``fused_rmsnorm=True`` model — against the
reference example: its ``make_packed_batch`` draws and its ``loss_fn``
(examples/llama_packed_pretraining.py:69-87) under the JAX
``make_train_step`` on a 1-device mesh, on the same weights
(``params_from_jax``) and the same packed batch.  LlamaConfig.tiny() in
fp32, S 128, mean document 40, 3 steps: SGD with momentum holds the loss
at rtol 1e-5 and the params at 1e-5; AdamW under master weights holds
the loss at rtol 1e-5 and the params within 2 x lr (ROADMAP Queue C).
"""

import dataclasses
import importlib.util
import os
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
from horovod_tpu.ops.flash_attention import flash_attention as jax_flash
from horovod_tpu.ops.losses import softmax_cross_entropy as jax_xent
from horovod_tpu.ops.mixed_precision import master_weights
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.examples import llama_packed_pretraining as packed
from horovod_tpu_torch.models.convert import params_from_jax, params_to_jax
from horovod_tpu_torch.models.llama import LlamaConfig, LlamaModel
from horovod_tpu_torch.ops import flash_attention as tfa
from horovod_tpu_torch.ops import rms_norm as trn
from horovod_tpu_torch.ops.mixed_precision import MasterWeights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TCFG = dataclasses.replace(LlamaConfig.tiny(), dtype=torch.float32,
                           logits_dtype=torch.float32, fused_rmsnorm=True)
JCFG = dataclasses.replace(JaxLlamaConfig.tiny(), dtype=jnp.float32,
                           logits_dtype=jnp.float32)
B, S, STEPS, MEAN_DOC = 2, 128, 3, 40


def _reference_example():
    """The JAX package's example module, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        "reference_llama_packed_pretraining",
        os.path.join(REPO, "examples", "llama_packed_pretraining.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_train(variables, tokens, seg, opt):
    """The reference example's loss_fn under the JAX make_train_step."""

    def loss_fn(params, batch):
        toks, seg_ids = batch
        model = JaxLlamaModel(
            JCFG, attention_fn=lambda q, k, v, *a: jax_flash(
                q, k, v, causal=True, segment_ids=seg_ids))
        logits = model.apply(params, toks[:, :-1])
        valid = jnp.concatenate(
            [seg_ids[:, 1:] == seg_ids[:, :-1],
             jnp.zeros((toks.shape[0], 1), bool)], axis=1)
        return jax_xent(logits, toks[:, 1:], where=valid)

    mesh = jhvd.data_parallel_mesh(devices=jax.devices()[:1])
    dopt = jhvd.DistributedOptimizer(opt)
    step = jhvd.make_train_step(loss_fn, dopt, mesh, donate=False)
    params, state = variables, dopt.init(variables)
    losses = []
    for _ in range(STEPS):
        params, state, loss = step(params, state, (jnp.asarray(tokens),
                                                   jnp.asarray(seg)))
        losses.append(float(loss))
    return params, np.array(losses)


@pytest.fixture
def cpu_world(monkeypatch):
    for name in basics._RANK_ENV + basics._SIZE_ENV + \
            basics._LOCAL_RANK_ENV + basics._LOCAL_SIZE_ENV + \
            ("HOROVOD_COORDINATOR",):
        monkeypatch.delenv(name, raising=False)
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def test_make_packed_batch_equals_the_reference():
    ref = _reference_example()
    for seed, (batch, seq, mean) in enumerate([(2, 128, 40), (3, 300, 7.5)]):
        jt, js = ref.make_packed_batch(np.random.default_rng(seed), 512,
                                       batch, seq, mean)
        tt, ts = packed.make_packed_batch(np.random.default_rng(seed), 512,
                                          batch, seq, mean)
        assert tt.dtype == torch.int64 and ts.dtype == torch.int32
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("kind", ["sgd_momentum", "adamw_master_weights"])
def test_packed_training_matches_the_reference_example(kind, cpu_world):
    tokens, seg = packed.make_packed_batch(np.random.default_rng(0),
                                           JCFG.vocab_size, B, S, MEAN_DOC)
    assert len(np.unique(seg.numpy()[0])) > 1      # really packed
    variables = JaxLlamaModel(JCFG).init(jax.random.key(4),
                                         jnp.zeros((1, S), jnp.int32))
    if kind == "sgd_momentum":
        lr = 0.05
        jopt = optax.sgd(lr, momentum=0.9)
    else:
        lr = 1e-2
        jopt = master_weights(optax.adamw(lr, b1=0.9, b2=0.999, eps=1e-8,
                                          weight_decay=1e-4))
    jparams, jlosses = _jax_train(variables, tokens.numpy().astype(np.int32),
                                  seg.numpy(), jopt)

    model = LlamaModel.from_state_dict(TCFG, params_from_jax(variables, TCFG,
                                                             "cpu"))
    if kind == "sgd_momentum":
        opt = torch.optim.SGD(model.parameters(), lr=lr, momentum=0.9)
    else:
        opt = MasterWeights(model.parameters(), torch.optim.AdamW, lr=lr,
                            betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
    step = hvd.make_train_step(model, packed.packed_lm_loss,
                               hvd.DistributedOptimizer(opt))
    tfa.reset_launches()
    trn.reset_launches()
    losses = np.array([float(step((tokens, seg))) for _ in range(STEPS)])

    assert losses[-1] < losses[0]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    # Every layer's attention took the segment path; every norm the op.
    assert tfa.plain_calls == dict.fromkeys(tfa.plain_calls,
                                            TCFG.num_layers * STEPS)
    assert trn.plain_calls == dict.fromkeys(
        trn.plain_calls, (2 * TCFG.num_layers + 1) * STEPS)
    want = params_to_jax(params_from_jax(jparams, TCFG, "cpu"),
                         TCFG)["params"]
    got = dict(jax.tree_util.tree_leaves_with_path(
        params_to_jax(model.state_dict(), TCFG)["params"]))
    atol = 1e-5 if kind == "sgd_momentum" else 2 * lr
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        np.testing.assert_allclose(got[path], w, rtol=0, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


def test_example_smoke_runs_on_the_cpu():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "OMPI_", "PMI_"))}
    env["PYTHONPATH"] = REPO
    out = subprocess.run(
        [sys.executable, "-m",
         "horovod_tpu_torch.examples.llama_packed_pretraining", "--smoke",
         "--device", "cpu"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "packed pretraining done" in out.stdout
