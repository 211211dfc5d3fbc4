"""Port parity: the training sugar (``horovod_tpu_torch/training/``)
against the JAX package's ``horovod_tpu.flax``.

* the learning rate of every batch under staircase, smooth and warmup
  schedules (the warmup's n patched to 4 on both sides), equal to the
  reference's float32 values within 1e-6;
* momentum correction: ``momentum_buffer`` against ``_scale_momentum``'s
  trace after three steps, within 1e-5 of the largest;
* ``fit`` with the callback stack on the same MLP and batches: every
  parameter within 1e-5 of the reference's largest update, the epoch
  logs within 1e-5;
* the warning for an optimizer without momentum, once;
* the learning rate through the port's optimizer wrappers;
* per-epoch checkpoints (save, latest, resume, restore-and-broadcast)
  and the sharded round trip over the weight plane;
* the Estimator's train, evaluate and warm start, against the
  reference's Estimator on the same weights and batches (metrics within
  1e-5), mirroring ``tests/test_flax_frontend.py``;
* ``num_chips``/``local_devices`` and the top-level names of
  ``horovod_tpu.jax``.
"""

import os
import warnings

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
import optax
from flax.training.train_state import TrainState as FlaxTrainState

import horovod_tpu.flax as jhvdk
import horovod_tpu.jax as jhvd
import horovod_tpu_torch as hvd
from horovod_tpu.flax.callbacks import _scale_momentum as jax_scale_momentum
from horovod_tpu.models import MnistMLP as JaxMLP
from horovod_tpu_torch import training as hvdk
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.models import MnistMLP
from horovod_tpu_torch.models.convert import params_from_jax, params_to_jax
from horovod_tpu_torch.models.mnist import MnistConfig
from horovod_tpu_torch.ops.mixed_precision import MasterWeights
from horovod_tpu_torch.training.callbacks import _scale_momentum
from horovod_tpu_torch.training.checkpoint import (latest_sharded,
                                                   restore_sharded,
                                                   save_sharded)

HIDDEN = 16
CFG = MnistConfig("mlp", hidden=HIDDEN, dtype=torch.float32)


@pytest.fixture
def cpu_world(monkeypatch):
    for name in basics._RANK_ENV + basics._SIZE_ENV + \
            basics._LOCAL_RANK_ENV + basics._LOCAL_SIZE_ENV + \
            ("HOROVOD_COORDINATOR",):
        monkeypatch.delenv(name, raising=False)
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def _jax_model(seed=0):
    model = JaxMLP(dtype=jnp.float32, hidden=HIDDEN)
    params = model.init(jax.random.key(seed),
                        jnp.zeros((2, 28, 28, 1)))["params"]
    return model, params


def _port_model(params):
    return MnistMLP.from_state_dict(
        params_from_jax(jax.device_get(params), CFG, "cpu"), hidden=HIDDEN,
        dtype=torch.float32)


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float64)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _port_params(model):
    return _flat(params_to_jax(model.state_dict(), CFG)["params"])


def _data(n=4, batch=8, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((batch, 28, 28, 1), dtype=np.float32),
             rng.integers(0, 10, batch).astype(np.int32)) for _ in range(n)]


def _jax_state(params, lr=0.1, momentum=0.9):
    model = JaxMLP(dtype=jnp.float32, hidden=HIDDEN)
    tx = optax.inject_hyperparams(optax.sgd)(learning_rate=lr,
                                             momentum=momentum)
    return FlaxTrainState.create(apply_fn=model.apply, params=params, tx=tx)


def _jax_step(state, batch):
    x, y = (jnp.asarray(a) for a in batch)

    def loss_fn(params):
        logp = jax.nn.log_softmax(state.apply_fn({"params": params}, x))
        return -jnp.mean(jnp.take_along_axis(logp, y[:, None], -1))

    loss, grads = jax.value_and_grad(loss_fn)(state.params)
    return state.apply_gradients(grads=grads), {"loss": loss}


def _nll(model, batch):
    x, y = batch
    return F.nll_loss(F.log_softmax(model(x), -1), y)


def _port_state(params, lr=0.1, momentum=0.9, opt_cls=None):
    model = _port_model(params)
    inner = (opt_cls or (lambda p: torch.optim.SGD(
        p, lr=lr, momentum=momentum)))(model.parameters())
    opt = hvd.DistributedOptimizer(inner)
    return hvdk.TrainState(model, opt)


def _port_train_step(state):
    step = hvd.make_train_step(state.model, _nll, state.optimizer)

    def train_step(state, batch):
        loss = step((torch.from_numpy(batch[0]),
                     torch.from_numpy(batch[1]).long()))
        state.step += 1
        return state, {"loss": loss}

    return train_step


# ---------------------------------------------------------------------------
# learning-rate schedules and momentum correction
# ---------------------------------------------------------------------------

_SCHEDULES = {
    "staircase": lambda m: [m.LearningRateScheduleCallback(
        0.1, lambda e: 0.5 ** e, start_epoch=1)],
    "smooth": lambda m: [m.LearningRateScheduleCallback(
        0.1, lambda e: 1.0 / (1.0 + e), staircase=False,
        steps_per_epoch=4)],
    "warmup": lambda m: [m.LearningRateWarmupCallback(
        0.1, warmup_epochs=2, steps_per_epoch=4)],
    "warmup_then_staircase": lambda m: [
        m.LearningRateWarmupCallback(0.1, warmup_epochs=2,
                                     steps_per_epoch=4),
        m.LearningRateScheduleCallback(
            0.1, start_epoch=2, multiplier=lambda e: 10.0 ** -(e // 3))],
}


@pytest.mark.parametrize("name", sorted(_SCHEDULES))
def test_lr_per_batch_matches_the_reference(name, cpu_world, monkeypatch):
    """The lr every batch sees over 5 epochs of 4 batches, with n = 4 on
    both sides (each package's ``num_chips`` patched)."""
    monkeypatch.setattr(jhvd, "num_chips", lambda: 4)
    monkeypatch.setattr(basics, "num_chips", lambda: 4)
    _, params = _jax_model()
    jax_seen, port_seen = [], []

    def jax_step(state, batch):
        jax_seen.append(jhvdk.get_learning_rate(state.opt_state))
        return state, {}

    def port_step(state, batch):
        port_seen.append(hvdk.get_learning_rate(state.optimizer))
        return state, {}

    jhvdk.fit(_jax_state(params), range(4), epochs=5, train_step=jax_step,
              callbacks=_SCHEDULES[name](jhvdk), verbose=False)
    hvdk.fit(_port_state(params), range(4), epochs=5, train_step=port_step,
             callbacks=_SCHEDULES[name](hvdk), verbose=False)
    assert len(port_seen) == 20 and len(set(port_seen)) > 1
    np.testing.assert_allclose(port_seen, jax_seen, rtol=1e-6)


def test_momentum_correction_matches_scale_momentum(cpu_world):
    """After three steps from the same weights, scaling by 0.5 gives
    torch's ``momentum_buffer`` the reference's trace, within 1e-5 of
    the largest element of each."""
    _, params = _jax_model()
    jstate, pstate = _jax_state(params), _port_state(params)
    step = _port_train_step(pstate)
    for batch in _data(3):
        jstate, _ = _jax_step(jstate, batch)
        step(pstate, batch)
    scaled, found = jax_scale_momentum(jstate.opt_state, 0.5)
    assert found and _scale_momentum(pstate.optimizer, 0.5)
    traces = {}

    def visit(s):
        if isinstance(s, optax.TraceState):
            traces.update(_flat(s.trace))
        elif hasattr(s, "inner_state"):
            visit(s.inner_state)
        elif isinstance(s, tuple):
            for item in s:
                visit(item)

    visit(scaled)
    opt = pstate.optimizer.inner
    bufs = {n: opt.state[p]["momentum_buffer"]
            for n, p in pstate.model.named_parameters()}
    got = _flat(params_to_jax(bufs, CFG)["params"])
    assert sorted(got) == sorted(traces)
    for k, want in traces.items():
        err = np.abs(got[k] - want).max()
        assert err <= 1e-5 * np.abs(want).max(), k


def test_fit_with_callbacks_matches_the_reference(cpu_world, monkeypatch,
                                                  capsys):
    """``fit`` with the broadcast, metric-average, warmup (n = 4) and
    staircase callbacks (momentum correction on) over 4 epochs of 4
    batches: each parameter within 1e-5 of the largest update of its
    tensor in the reference's run, the epoch losses within 1e-5, and the
    rank-0 epoch lines printed."""
    monkeypatch.setattr(jhvd, "num_chips", lambda: 4)
    monkeypatch.setattr(basics, "num_chips", lambda: 4)
    _, params = _jax_model()
    data = _data(4)

    def stack(m):
        return [m.BroadcastGlobalVariablesCallback(0),
                m.MetricAverageCallback(),
                m.LearningRateWarmupCallback(0.1, warmup_epochs=2,
                                             steps_per_epoch=4),
                m.LearningRateScheduleCallback(
                    0.1, start_epoch=2, multiplier=lambda e: 0.5 ** e)]

    def recorder(m, into):
        class Record(m.Callback):
            def on_epoch_end(self, epoch, state, logs):
                into.append(logs["loss"])
                return state
        return Record()

    jlogs, plogs = [], []
    jstate = jhvdk.fit(_jax_state(params), data, epochs=4,
                       train_step=jax.jit(_jax_step),
                       callbacks=stack(jhvdk) + [recorder(jhvdk, jlogs)],
                       verbose=False)
    pstate = _port_state(params)
    pstate = hvdk.fit(pstate, data, epochs=4,
                      train_step=_port_train_step(pstate),
                      callbacks=stack(hvdk) + [recorder(hvdk, plogs)],
                      verbose=True)
    out = capsys.readouterr().out
    assert "Epoch 4/4: loss=" in out and pstate.step == 16
    np.testing.assert_allclose(plogs, jlogs, rtol=1e-5)
    start, want = _flat(params), _flat(jstate.params)
    for k, got in _port_params(pstate.model).items():
        moved = np.abs(want[k] - start[k]).max()
        assert np.abs(got - want[k]).max() <= 1e-5 * moved, k


def test_momentum_correction_warns_once_for_adaptive(cpu_world):
    _, params = _jax_model()
    state = _port_state(params, opt_cls=lambda p: torch.optim.Adam(
        p, lr=0.1))
    cb = hvdk.LearningRateScheduleCallback(0.1, lambda e: 0.5 ** e)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        hvdk.fit(state, _data(2), epochs=3,
                 train_step=_port_train_step(state), callbacks=[cb],
                 verbose=False)
    msgs = [str(w.message) for w in caught]
    assert sum("no SGD momentum trace" in m for m in msgs) == 1


def test_learning_rate_through_the_wrappers(cpu_world):
    """The lr is found under the JAX-form ``DistributedOptimizer`` (its
    inner optimizer, or its ZeRO rung), ``MasterWeights`` and the hook
    form; an object without one raises."""
    from horovod_tpu_torch import torch_frontend

    _, params = _jax_model()
    model = _port_model(params)
    bf16 = torch.nn.Linear(4, 4, dtype=torch.bfloat16)
    cases = [
        torch.optim.SGD(model.parameters(), lr=0.1),
        hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                 lr=0.1)),
        hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                 lr=0.1), sharded=True),
        hvd.DistributedOptimizer(MasterWeights(bf16.parameters(),
                                               torch.optim.SGD, lr=0.1)),
        torch_frontend.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=model.named_parameters()),
        torch_frontend.DistributedOptimizer(
            MasterWeights(bf16.parameters(), torch.optim.SGD, lr=0.1)),
    ]
    for opt in cases:
        assert hvdk.get_learning_rate(opt) == pytest.approx(0.1)
        hvdk.set_learning_rate(opt, 0.02)
        assert hvdk.get_learning_rate(opt) == pytest.approx(0.02)
    zero = cases[2].zero
    assert zero.param_groups[0]["lr"] == pytest.approx(0.02)
    assert cases[3].inner.inner.param_groups[0]["lr"] == pytest.approx(0.02)
    with pytest.raises(ValueError, match="no mutable learning rate"):
        hvdk.get_learning_rate(object())


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _assert_states_equal(a, b):
    for (ka, va), (kb, vb) in zip(a.model.state_dict().items(),
                                  b.model.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka
    oa, ob = a.optimizer.inner, b.optimizer.inner
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(oa.state[pa]["momentum_buffer"],
                           ob.state[pb]["momentum_buffer"])
    assert a.step == b.step


def test_checkpoint_save_load_resume(cpu_world, tmp_path):
    """Save after 2 epochs, restore into fresh state: the model, the
    momentum buffers and the step come back, and the resume epoch is the
    next one; the newest of several checkpoints wins; an empty directory
    starts at 0 and leaves the target alone."""
    _, params = _jax_model()
    state = _port_state(params)
    state = hvdk.fit(state, _data(2), epochs=2,
                     train_step=_port_train_step(state), verbose=False)
    assert hvdk.save_checkpoint(str(tmp_path), state, 0).endswith(
        "checkpoint-0.pt")
    path = hvdk.save_checkpoint(str(tmp_path), state, epoch=1)
    assert os.path.basename(path) == "checkpoint-1.pt"
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    assert hvdk.latest_checkpoint(str(tmp_path)) == (path, 1)
    assert hvdk.resume_epoch(str(tmp_path)) == 2

    fresh = _port_state(params)
    restored, start_epoch = hvdk.restore_and_broadcast(str(tmp_path), fresh)
    assert start_epoch == 2 and restored is fresh
    _assert_states_equal(state, restored)

    untouched = _port_state(params)
    same, epoch0 = hvdk.restore_and_broadcast(str(tmp_path / "none"),
                                              untouched)
    assert epoch0 == 0 and same is untouched and untouched.step == 0
    assert hvdk.latest_checkpoint(str(tmp_path / "none")) is None

    # A module, and a nest of tensors.
    module = _port_model(params)
    hvdk.load_checkpoint(hvdk.save_checkpoint(str(tmp_path / "m"),
                                              state.model, 0), module)
    for a, b in zip(module.parameters(), state.model.parameters()):
        assert torch.equal(a, b)
    tree = {"w": torch.arange(4.0), "meta": {"n": 3, "v": [torch.ones(2)]}}
    target = {"w": torch.zeros(4), "meta": {"n": 0, "v": [torch.zeros(2)]}}
    w = target["w"]
    got = hvdk.load_checkpoint(
        hvdk.save_checkpoint(str(tmp_path / "t"), tree, 5), target)
    assert got["w"] is w and torch.equal(w, tree["w"])
    assert got["meta"]["n"] == 3 and torch.equal(got["meta"]["v"][0],
                                                 torch.ones(2))


def test_checkpoint_of_master_weights(cpu_world, tmp_path):
    """A ``MasterWeights`` optimizer's masters and inner state travel, and
    the model is re-derived from the masters."""
    torch.manual_seed(0)
    model = torch.nn.Linear(8, 4, dtype=torch.bfloat16)
    opt = hvd.DistributedOptimizer(MasterWeights(
        model.parameters(), torch.optim.SGD, lr=0.1, momentum=0.9))
    step = hvd.make_train_step(
        model, lambda m, x: m(x).float().square().mean(), opt)
    for _ in range(2):
        step(torch.randn(3, 8, dtype=torch.bfloat16))
    hvdk.save_checkpoint(str(tmp_path), hvdk.TrainState(model, opt, 2), 0)
    other = torch.nn.Linear(8, 4, dtype=torch.bfloat16)
    oopt = hvd.DistributedOptimizer(MasterWeights(
        other.parameters(), torch.optim.SGD, lr=0.1, momentum=0.9))
    state, epoch = hvdk.restore_and_broadcast(
        str(tmp_path), hvdk.TrainState(other, oopt))
    assert epoch == 1 and state.step == 2
    for a, b in zip(opt.inner.masters, oopt.inner.masters):
        assert torch.equal(a, b)
    for a, b in zip(model.parameters(), other.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(opt.inner.masters, oopt.inner.masters):
        assert torch.equal(opt.inner.inner.state[a]["momentum_buffer"],
                           oopt.inner.inner.state[b]["momentum_buffer"])


@pytest.mark.parametrize("sharded", [False, True])
def test_sharded_round_trip(cpu_world, tmp_path, sharded):
    """``save_sharded`` / ``restore_sharded`` over the weight plane: a
    train state (plain, or ZeRO-1 with its flat master and momentum
    shards) and a nest of tensors come back exactly into fresh targets;
    the newest ``sharded-{step}`` wins; nothing saved gives None."""
    _, params = _jax_model()

    def make():
        model = _port_model(params)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
            sharded=sharded)
        return hvdk.TrainState(model, opt)

    state = make()
    step = _port_train_step(state)
    for batch in _data(3):
        step(state, batch)
    assert restore_sharded(str(tmp_path), state) == (state, None)
    save_sharded(str(tmp_path), state, 1)
    path = save_sharded(str(tmp_path), state, 3)
    assert os.path.basename(path) == "sharded-3"
    assert latest_sharded(str(tmp_path)) == (path, 3)
    fresh = make()
    got, at = restore_sharded(str(tmp_path), fresh)
    assert at == 3 and got is fresh and fresh.step == 3
    for a, b in zip(state.model.parameters(), fresh.model.parameters()):
        assert torch.equal(a, b)
    src, dst = state.optimizer.state, fresh.optimizer.state
    assert len(src) == len(dst) > 0
    for a, b in zip(src.values(), dst.values()):
        assert torch.equal(a["momentum_buffer"], b["momentum_buffer"])

    tree = {"a": torch.arange(6.0).reshape(2, 3), "b": [torch.ones(2)]}
    save_sharded(str(tmp_path / "tree"), tree, 0)
    target = {"a": torch.zeros(2, 3), "b": [torch.zeros(2)]}
    out, at = restore_sharded(str(tmp_path / "tree"), target)
    assert at == 0 and torch.equal(out["a"], tree["a"])
    assert torch.equal(out["b"][0], tree["b"][0])


# ---------------------------------------------------------------------------
# the Estimator
# ---------------------------------------------------------------------------

def test_estimator_train_evaluate_resume(cpu_world, tmp_path):
    """On the reference's weights and batches, ``train_and_evaluate`` over
    3 epochs gives the reference Estimator's metrics within 1e-5 and the
    loss drops; a second Estimator over the same ``model_dir``
    warm-starts at epoch 3 with the same eval metrics (1e-6) and trains
    nothing for ``epochs`` <= 3; without a ``model_dir`` it trains end to
    end."""
    jmodel, params = _jax_model()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, 64).astype(np.int32)

    def jax_loss(p, batch):
        bx, by = batch
        logits = jmodel.apply(p, bx)
        logp = jax.nn.log_softmax(logits)
        loss = -jnp.mean(jnp.take_along_axis(logp, by[:, None], -1))
        acc = jnp.mean((jnp.argmax(logits, -1) == by).astype(jnp.float32))
        return loss, {"loss": loss, "accuracy": acc}

    def jax_input():
        for i in range(4):
            yield (jnp.asarray(x[i * 16:(i + 1) * 16]),
                   jnp.asarray(y[i * 16:(i + 1) * 16]))

    jest = jhvdk.Estimator(jax_loss,
                           init_fn=lambda r: {"params": params},
                           optimizer=optax.sgd(0.1), model_dir=None)
    want_first = jest.evaluate(jax_input)
    want = jest.train_and_evaluate(jax_input, jax_input, epochs=3)

    def loss_fn(model, batch):
        bx, by = batch
        logits = model(bx)
        loss = F.nll_loss(F.log_softmax(logits, -1), by)
        acc = (logits.argmax(-1) == by).float().mean()
        return loss, {"loss": loss, "accuracy": acc}

    def input_fn():
        for i in range(4):
            yield (torch.from_numpy(x[i * 16:(i + 1) * 16]),
                   torch.from_numpy(y[i * 16:(i + 1) * 16]).long())

    def make(model_dir):
        return hvdk.Estimator(
            loss_fn, init_fn=lambda gen: _port_model(params),
            optimizer=lambda p: torch.optim.SGD(p, lr=0.1),
            model_dir=model_dir)

    est = make(str(tmp_path))
    first = est.evaluate(input_fn)
    assert first == pytest.approx(want_first, rel=1e-5)
    metrics = est.train_and_evaluate(input_fn, input_fn, epochs=3)
    assert set(metrics) == {"loss", "accuracy"}
    assert metrics["loss"] < first["loss"]
    assert metrics == pytest.approx(want, rel=1e-5)

    est2 = make(str(tmp_path))
    assert est2.start_epoch == 3
    again = est2.evaluate(input_fn)
    assert again == pytest.approx(metrics, rel=1e-6, abs=1e-6)
    est2.train(input_fn, epochs=2)
    assert est2.start_epoch == 3
    assert est2.train_and_evaluate(input_fn, input_fn, epochs=3) == \
        pytest.approx(metrics, rel=1e-6, abs=1e-6)

    est3 = make(None)
    est3.train(input_fn, epochs=1)
    assert est3.start_epoch == 1


def test_estimator_init_fn_gets_a_seeded_generator(cpu_world):
    seen = []

    def init_fn(gen):
        seen.append(gen)
        return MnistMLP(hidden=HIDDEN, dtype=torch.float32, generator=gen,
                        device="cpu")

    def loss_fn(model, batch):
        return model(batch).sum(), {}

    a = hvdk.Estimator(loss_fn, init_fn, lambda p: torch.optim.SGD(p, 0.1),
                       seed=7)
    b = hvdk.Estimator(loss_fn, init_fn, lambda p: torch.optim.SGD(p, 0.1),
                       seed=7)
    assert isinstance(seen[0], torch.Generator)
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(pa, pb)


# ---------------------------------------------------------------------------
# top-level names
# ---------------------------------------------------------------------------

def test_num_chips_local_devices_and_the_reference_names(cpu_world):
    assert hvd.num_chips() == hvd.size() == 1
    assert hvd.local_devices() == [torch.device("cpu")]
    missing = sorted(set(jhvd.__all__) - set(dir(hvd)))
    assert not missing, missing
    assert {"num_chips", "local_devices"} <= set(hvd.__all__)
    assert set(jhvdk.__all__) <= set(hvdk.__all__)


def test_queries_raise_before_init(monkeypatch):
    monkeypatch.setattr(basics, "_state", {})
    with pytest.raises(ValueError, match="not been initialized"):
        hvd.num_chips()
    with pytest.raises(ValueError, match="not been initialized"):
        hvd.local_devices()
