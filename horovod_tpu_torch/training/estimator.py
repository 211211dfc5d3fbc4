"""Estimator-role train/eval harness.

Counterpart of ``horovod_tpu/flax/estimator.py`` (the reference's
``tensorflow_mnist_estimator.py`` workflow): a ``model_fn`` giving loss
and metrics, an ``input_fn`` giving batches, per-epoch checkpoints in a
``model_dir`` with automatic warm start, a train/evaluate cycle, and the
Horovod recipe built in: gradients averaged by ``hvd.DistributedOptimizer``
through ``hvd.make_train_step``, the initial or restored state made equal
on every rank, checkpoints written by rank 0 only, and evaluation metrics
allreduce-averaged across ranks.

Torch signatures: ``loss_fn(model, batch) -> (loss, metrics)``,
``init_fn(generator) -> nn.Module`` (a ``torch.Generator`` seeded with
``seed`` on ``hvd.device()``), ``optimizer(params) -> torch optimizer``.
Batches are moved to ``hvd.device()`` as they arrive.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import torch

from horovod_tpu_torch.common import basics

__all__ = ["Estimator"]


def _to(batch, dev: torch.device):
    if isinstance(batch, torch.Tensor):
        return batch.to(dev, non_blocking=True)
    if isinstance(batch, (list, tuple)):
        return type(batch)(_to(b, dev) for b in batch)
    if isinstance(batch, dict):
        return {k: _to(v, dev) for k, v in batch.items()}
    return batch


class Estimator:
    """Train/evaluate harness with a ``model_dir`` lifecycle.

    Parameters
    ----------
    loss_fn: ``loss_fn(model, batch) -> (loss, metrics_dict)``, the
        ``model_fn`` role; metrics are scalar tensors or numbers.
    init_fn: ``init_fn(generator) -> nn.Module`` on ``hvd.device()``.
    optimizer: ``optimizer(params) -> torch.optim.Optimizer`` (wrapped in
        ``hvd.DistributedOptimizer``).
    model_dir: checkpoint directory; None disables checkpointing.
    """

    def __init__(self, loss_fn: Callable, init_fn: Callable,
                 optimizer: Callable, model_dir: Optional[str] = None, *,
                 seed: int = 0):
        from horovod_tpu_torch.frontend import (DistributedOptimizer,
                                                make_train_step)

        self.loss_fn = loss_fn
        self.model_dir = model_dir
        self.device = basics.device()
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        self.model = init_fn(gen)
        self.optimizer = DistributedOptimizer(
            optimizer(self.model.parameters()))
        self._train_step = make_train_step(
            self.model, lambda model, batch: loss_fn(model, batch)[0],
            self.optimizer)
        self._step_count = 0
        self._restore_or_broadcast()

    @property
    def start_epoch(self) -> int:
        """The epoch the next :meth:`train` starts at: the restored
        checkpoint's next epoch, then the last trained-to epoch."""
        return self._start_epoch

    # -- lifecycle ---------------------------------------------------------

    def _state(self):
        from horovod_tpu_torch.training.state import TrainState

        return TrainState(self.model, self.optimizer, self._step_count)

    def _restore_or_broadcast(self) -> None:
        """Warm-start from ``model_dir`` if a checkpoint exists (estimator
        semantics), else make the fresh state rank 0's (the
        BroadcastGlobalVariablesHook role)."""
        from horovod_tpu_torch.frontend import (broadcast_optimizer_state,
                                                broadcast_parameters)
        from horovod_tpu_torch.training import checkpoint as ckpt

        self._start_epoch = 0
        if self.model_dir:
            state, self._start_epoch = ckpt.restore_and_broadcast(
                self.model_dir, self._state())
            self._step_count = state.step
        if self._start_epoch == 0:
            broadcast_parameters(self.model, root_rank=0)
            broadcast_optimizer_state(self.optimizer, root_rank=0)

    def _save(self, epoch: int) -> None:
        if not self.model_dir:
            return
        from horovod_tpu_torch.training import checkpoint as ckpt

        ckpt.save_checkpoint(self.model_dir, self._state(), epoch)

    # -- estimator surface -------------------------------------------------

    def train(self, input_fn: Callable[[], Iterable], *,
              epochs: int = 1, steps_per_epoch: Optional[int] = None):
        """Run training epochs over ``input_fn()`` batches; checkpoint per
        epoch on rank 0.  Resumes from the last checkpoint epoch."""
        last_loss = None
        for epoch in range(self._start_epoch, epochs):
            self.model.train()
            n = 0
            for batch in input_fn():
                if steps_per_epoch is not None and n >= steps_per_epoch:
                    break
                last_loss = self._train_step(_to(batch, self.device))
                self._step_count += 1
                n += 1
            self._save(epoch)
            if basics.rank() == 0 and last_loss is not None:
                print(f"estimator epoch {epoch + 1}/{epochs}: "
                      f"loss={float(last_loss):.4f}", flush=True)
        # Never roll the resume point backwards: train(epochs=k) with
        # k <= the restored epoch runs zero steps and must not make a
        # later train() re-train (and overwrite) finished epochs.
        self._start_epoch = max(self._start_epoch, epochs)
        return self

    def evaluate(self, input_fn: Callable[[], Iterable], *,
                 steps: Optional[int] = None) -> dict:
        """Average ``loss_fn``'s metrics over ``input_fn()`` batches, then
        allreduce-average them across ranks (the reference's final
        ``hvd.allreduce`` of the eval score)."""
        from horovod_tpu_torch.runtime import eager

        self.model.eval()
        totals: dict = {}
        n = 0
        with torch.no_grad():
            for batch in input_fn():
                if steps is not None and n >= steps:
                    break
                _, metrics = self.loss_fn(self.model, _to(batch,
                                                          self.device))
                for k, v in metrics.items():
                    totals[k] = totals.get(k, 0.0) + float(v)
                n += 1
        means = {k: v / max(n, 1) for k, v in totals.items()}
        return {k: float(eager.allreduce(torch.tensor([v]),
                                         name=f"eval.{k}")[0])
                for k, v in means.items()}

    def train_and_evaluate(self, train_input_fn: Callable,
                           eval_input_fn: Callable, *, epochs: int = 1,
                           steps_per_epoch: Optional[int] = None,
                           eval_steps: Optional[int] = None) -> dict:
        """The ``tf.estimator.train_and_evaluate`` role: evaluate after
        each training epoch; returns the final metrics."""
        metrics: Optional[dict] = None
        for epoch in range(self._start_epoch, epochs):
            self.train(train_input_fn, epochs=epoch + 1,
                       steps_per_epoch=steps_per_epoch)
            metrics = self.evaluate(eval_input_fn, steps=eval_steps)
            if basics.rank() == 0:
                rendered = ", ".join(
                    f"{k}={v:.4f}" for k, v in metrics.items())
                print(f"estimator eval after epoch {epoch + 1}: {rendered}",
                      flush=True)
        if metrics is None:
            # Already trained to >= epochs (resumed run): still report.
            metrics = self.evaluate(eval_input_fn, steps=eval_steps)
        return metrics
