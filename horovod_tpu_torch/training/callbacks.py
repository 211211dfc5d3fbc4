"""Training callbacks: the Keras callback stack for torch training loops.

Counterpart of ``horovod_tpu/flax/callbacks.py`` (the reference's
``horovod/keras/callbacks.py``): ``BroadcastGlobalVariablesCallback``,
``MetricAverageCallback``, ``LearningRateScheduleCallback`` (staircase or
smooth, with momentum correction) and ``LearningRateWarmupCallback``
(Goyal et al. linear warmup).  They plug into
:func:`horovod_tpu_torch.training.fit` with the reference's six hooks and
signatures: each hook takes the :class:`~horovod_tpu_torch.training.
TrainState` and returns it (here the same object, updated in place).

Learning-rate control is the optimizer's ``param_groups[i]["lr"]`` (the
torch counterpart of ``optax.inject_hyperparams``), reached through the
port's wrappers: the JAX-form ``DistributedOptimizer`` (its ZeRO rung
``.zero`` or its ``.inner``), ``MasterWeights`` (``.inner``) and the hook
form (a subclass of the user's optimizer).  Momentum correction scales
each ``optimizer.state[p]["momentum_buffer"]`` by new_lr/old_lr, as the
reference rescales optax's SGD trace (``TraceState.trace`` is torch's
``momentum_buffer``).
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch

from horovod_tpu_torch.common import basics

__all__ = [
    "Callback",
    "BroadcastGlobalVariablesCallback",
    "MetricAverageCallback",
    "LearningRateScheduleCallback",
    "LearningRateWarmupCallback",
    "get_learning_rate",
    "set_learning_rate",
]


class Callback:
    """Hook protocol for :func:`horovod_tpu_torch.training.fit`.  Every
    hook receives the train state and returns it."""

    def on_train_begin(self, state):
        return state

    def on_epoch_begin(self, epoch: int, state):
        return state

    def on_batch_begin(self, epoch: int, batch: int, state):
        return state

    def on_batch_end(self, epoch: int, batch: int, state, logs: dict):
        return state

    def on_epoch_end(self, epoch: int, state, logs: dict):
        return state

    def on_train_end(self, state):
        return state


# ---------------------------------------------------------------------------
# Learning-rate plumbing (param_groups)
# ---------------------------------------------------------------------------

def _lr_optimizer(optimizer):
    """The optimizer whose ``param_groups`` carry ``lr``, under the port's
    wrappers (``.zero``, ``.inner``)."""
    opt = optimizer
    while opt is not None:
        if getattr(opt, "zero", None) is not None:
            opt = opt.zero
        groups = getattr(opt, "param_groups", None)
        if groups and all("lr" in g for g in groups):
            return opt
        opt = getattr(opt, "inner", None)
    raise ValueError(
        "optimizer carries no mutable learning rate: wrap a torch.optim "
        "optimizer (its param_groups' 'lr'), e.g. "
        "torch.optim.SGD(params, lr=0.01)")


def get_learning_rate(optimizer) -> float:
    return float(_lr_optimizer(optimizer).param_groups[0]["lr"])


def set_learning_rate(optimizer, lr: float):
    """Set every param group's ``lr``; returns ``optimizer``."""
    for group in _lr_optimizer(optimizer).param_groups:
        group["lr"] = lr
    return optimizer


def _scale_momentum(optimizer, factor: float) -> bool:
    """Momentum correction: scale every SGD ``momentum_buffer`` by
    ``factor`` (new_lr/old_lr), in place.  Returns whether the optimizer
    has SGD momentum: a buffer, or a group with ``momentum`` > 0 whose
    buffers are not made yet (zeros in optax's trace: scaling them is a
    no-op).  Adaptive optimizers (Adam, Adagrad, ...) have none."""
    opt = _lr_optimizer(optimizer)
    found = any(g.get("momentum", 0) for g in opt.param_groups)
    with torch.no_grad():
        for group in opt.param_groups:
            for p in group["params"]:
                buf = opt.state.get(p, {}).get("momentum_buffer")
                if isinstance(buf, torch.Tensor):
                    buf.mul_(factor)
                    found = True
    return found


# ---------------------------------------------------------------------------
# Callbacks
# ---------------------------------------------------------------------------

class BroadcastGlobalVariablesCallback(Callback):
    """Make the model's parameters and buffers and the optimizer state
    equal ``root_rank``'s at train start (``frontend.broadcast_parameters``
    and ``broadcast_optimizer_state``, over the default group)."""

    def __init__(self, root_rank: int = 0):
        self.root_rank = root_rank

    def on_train_begin(self, state):
        from horovod_tpu_torch import frontend

        frontend.broadcast_parameters(state.model, self.root_rank)
        frontend.broadcast_optimizer_state(state.optimizer, self.root_rank)
        return state


class MetricAverageCallback(Callback):
    """Average the epoch's metrics over all processes before they are
    reported: one eager ``hvd.allreduce`` each, named ``metric.{key}``."""

    def on_epoch_end(self, epoch: int, state, logs: dict):
        from horovod_tpu_torch.runtime import eager

        for key in list(logs.keys()):
            value = logs[key]
            if isinstance(value, (int, float, torch.Tensor)):
                logs[key] = float(eager.allreduce(
                    torch.as_tensor(value, dtype=torch.float32).detach()
                    .cpu(), name=f"metric.{key}"))
        return state


class LearningRateScheduleCallback(Callback):
    """Epoch-windowed LR multiplier, staircase or per-batch smooth, with
    momentum correction.

    ``multiplier``: constant or ``f(epoch) -> factor`` applied to
    ``initial_lr``.  With ``staircase=False``, ``epoch`` is fractional
    (epoch + batch/steps_per_epoch) and the lr updates every batch.
    """

    def __init__(self, initial_lr: float, multiplier, start_epoch: int = 0,
                 end_epoch: Optional[int] = None, staircase: bool = True,
                 momentum_correction: bool = True,
                 steps_per_epoch: Optional[int] = None):
        self.initial_lr = initial_lr
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        self.staircase = staircase
        self.momentum_correction = momentum_correction
        self.steps_per_epoch = steps_per_epoch
        if callable(multiplier):
            self.multiplier = multiplier
        else:
            self.multiplier = lambda epoch: multiplier
        self._last_lr: Optional[float] = None
        self._warned_no_momentum = False

    def _in_window(self, epoch: int) -> bool:
        if epoch < self.start_epoch:
            return False
        return self.end_epoch is None or epoch < self.end_epoch

    def _apply(self, state, epoch: float):
        lr = self.initial_lr * self.multiplier(epoch)
        old = self._last_lr
        set_learning_rate(state.optimizer, lr)
        if self.momentum_correction and old is not None and old > 0 \
                and lr != old:
            found = _scale_momentum(state.optimizer, lr / old)
            if not found and not self._warned_no_momentum:
                self._warned_no_momentum = True
                warnings.warn(
                    "momentum_correction=True but the optimizer state "
                    "carries no SGD momentum trace (adaptive optimizers "
                    "like adam need no correction) — correction is a "
                    "no-op; pass momentum_correction=False to silence",
                    stacklevel=2)
        self._last_lr = lr
        return state

    def on_epoch_begin(self, epoch: int, state):
        if self.staircase and self._in_window(epoch):
            return self._apply(state, epoch)
        return state

    def on_batch_begin(self, epoch: int, batch: int, state):
        if not self.staircase and self._in_window(epoch):
            if self.steps_per_epoch is None:
                raise ValueError(
                    "staircase=False requires steps_per_epoch")
            return self._apply(state, epoch + batch / self.steps_per_epoch)
        return state


class LearningRateWarmupCallback(LearningRateScheduleCallback):
    """Linear warmup from lr/n to lr over ``warmup_epochs`` (Goyal et al.),
    n = max(``num_chips()``, ``size()``) (1 before ``hvd.init()``): each
    process's lr ramps so the size-scaled rate arrives after warmup
    instead of at step 0."""

    def __init__(self, initial_lr: float, warmup_epochs: int = 5,
                 momentum_correction: bool = True,
                 steps_per_epoch: Optional[int] = None,
                 verbose: bool = False):
        self.warmup_epochs = warmup_epochs
        self.verbose = verbose
        n = (max(basics.num_chips(), basics.size())
             if basics.is_initialized() else 1)

        def multiplier(epoch: float) -> float:
            if epoch >= warmup_epochs:
                return 1.0
            # epoch/warmup linear ramp from 1/n to 1.
            return 1.0 / n * (epoch * (n - 1) / warmup_epochs + 1)

        super().__init__(initial_lr, multiplier, start_epoch=0,
                         end_epoch=warmup_epochs + 1, staircase=False,
                         momentum_correction=momentum_correction,
                         steps_per_epoch=steps_per_epoch)

    def on_epoch_end(self, epoch: int, state, logs: dict):
        if self.verbose and epoch < self.warmup_epochs \
                and self._last_lr is not None:
            print(f"Epoch {epoch + 1}: finished gradual learning rate "
                  f"warmup to {self._last_lr:.6g}.")
        return state
