"""The Keras-role training layer: ``fit``, callbacks, checkpoints and the
Estimator.

Counterpart of ``horovod_tpu/flax/`` (the reference's ``horovod/keras``):
optimizer wrapping, the four callbacks, rank-0 checkpoints with
broadcast-on-resume, metric averaging and the Estimator harness.  The
port calls it ``training`` because a torch package named ``flax`` would
mislead; each module's docstring names its counterpart.  Keras's
``model.fit`` is :func:`fit`, a callback-orchestrated epoch loop over a
user-supplied train step; :class:`TrainState` (model, optimizer, step)
plays the role of flax's ``TrainState``.

Typical use::

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import training as hvdk

    hvd.init()
    opt = hvd.DistributedOptimizer(torch.optim.SGD(
        model.parameters(), lr=0.01 * hvd.num_chips(), momentum=0.9))
    step = hvd.make_train_step(model, loss_fn, opt)
    state = hvdk.TrainState(model, opt)

    def train_step(state, batch):
        loss = step(batch)
        state.step += 1
        return state, {"loss": loss}

    hvdk.fit(state, data_fn, epochs=90, steps_per_epoch=spe,
             train_step=train_step,
             callbacks=[hvdk.BroadcastGlobalVariablesCallback(0),
                        hvdk.MetricAverageCallback(),
                        hvdk.LearningRateWarmupCallback(
                            0.01 * hvd.num_chips(), 5,
                            steps_per_epoch=spe)])
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

from horovod_tpu_torch.common.basics import (init, is_initialized,
                                             local_rank, local_size, rank,
                                             shutdown, size)
from horovod_tpu_torch.training import callbacks
from horovod_tpu_torch.training.callbacks import (
    BroadcastGlobalVariablesCallback, Callback, LearningRateScheduleCallback,
    LearningRateWarmupCallback, MetricAverageCallback, get_learning_rate,
    set_learning_rate)
from horovod_tpu_torch.training.state import TrainState
from horovod_tpu_torch.training.checkpoint import (latest_checkpoint,
                                                   load_checkpoint,
                                                   restore_and_broadcast,
                                                   resume_epoch,
                                                   save_checkpoint)
from horovod_tpu_torch.training.estimator import Estimator

__all__ = [
    "init", "shutdown", "is_initialized", "rank", "size", "local_rank",
    "local_size",
    "callbacks", "Callback",
    "BroadcastGlobalVariablesCallback", "MetricAverageCallback",
    "LearningRateScheduleCallback", "LearningRateWarmupCallback",
    "get_learning_rate", "set_learning_rate",
    "save_checkpoint", "load_checkpoint", "latest_checkpoint",
    "resume_epoch", "restore_and_broadcast",
    "Estimator", "TrainState",
    "fit",
]


def fit(state: TrainState, data_fn, *, epochs: int, train_step: Callable,
        steps_per_epoch: Optional[int] = None,
        callbacks: Sequence[Callback] = (),
        initial_epoch: int = 0, verbose: Optional[bool] = None
        ) -> TrainState:
    """Callback-orchestrated training loop (the ``model.fit`` role).

    ``data_fn(epoch) -> iterable of batches`` (or a re-iterable passed
    directly); ``train_step(state, batch) -> (state, logs)`` is the user's
    step.  Callbacks receive the hooks in Keras order.  The epoch's logs
    are the means of the steps' logs; rank 0 prints them when
    ``verbose`` (default: rank 0 only).
    """
    if verbose is None:
        verbose = rank() == 0

    cbs = list(callbacks)
    for cb in cbs:
        state = cb.on_train_begin(state)
    for epoch in range(initial_epoch, epochs):
        for cb in cbs:
            state = cb.on_epoch_begin(epoch, state)
        batches = data_fn(epoch) if callable(data_fn) else data_fn
        logs: dict = {}
        n_batches = 0
        for batch_idx, batch in enumerate(batches):
            if steps_per_epoch is not None and batch_idx >= steps_per_epoch:
                break
            for cb in cbs:
                state = cb.on_batch_begin(epoch, batch_idx, state)
            state, step_logs = train_step(state, batch)
            n_batches += 1
            for k, v in dict(step_logs).items():
                logs[k] = logs.get(k, 0.0) + float(v)
            for cb in cbs:
                state = cb.on_batch_end(epoch, batch_idx, state, step_logs)
        logs = {k: v / max(n_batches, 1) for k, v in logs.items()}
        for cb in cbs:
            state = cb.on_epoch_end(epoch, state, logs)
        if verbose:
            rendered = ", ".join(f"{k}={v:.4f}" for k, v in logs.items())
            print(f"Epoch {epoch + 1}/{epochs}: {rendered}", flush=True)
    for cb in cbs:
        state = cb.on_train_end(state)
    return state
