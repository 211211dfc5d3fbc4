"""MNIST with the full callback stack: the Keras-role workload.

Counterpart of ``examples/flax_mnist_advanced.py`` (the reference's
``keras_mnist_advanced.py``): the broadcast callback, metric averaging,
the LR warmup, a rank-0 checkpoint, driven by ``training.fit``.

One difference is deliberate.  The JAX example steps a plain flax
``TrainState``, so at more than one process its ranks broadcast once and
then diverge; the reference Horovod's ``keras_mnist_advanced.py`` wraps
its optimizer.  This one steps through ``hvd.make_train_step`` with
``hvd.DistributedOptimizer``, so the gradients are averaged and the ranks
stay equal (ROADMAP.md Queue C).

    python -m horovod_tpu_torch.examples.flax_mnist_advanced [--smoke] \\
        [--device cpu] [--checkpoint-dir D]

Runs on the CUDA device unless given ``--device cpu``.  ``main(argv)``
returns ``{"logs": [per-epoch averaged logs], "lr": the final lr,
"state": the TrainState}``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["main"]


def main(argv=None) -> dict:
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import training as hvdk
    from horovod_tpu_torch.examples.common import (example_args,
                                                   record_logs,
                                                   shard_for_rank,
                                                   synthetic_mnist)
    from horovod_tpu_torch.models import MnistConvNet

    args = example_args("MNIST (full callback stack)", argv,
                        checkpoint_dir="")
    hvd.init(device=args.device)
    dev, n = hvd.device(), hvd.num_chips()

    images, labels = synthetic_mnist(512 if args.smoke else 4096)
    images, labels = shard_for_rank((images, labels), hvd.rank(), hvd.size())
    X = torch.from_numpy(images).to(dev)
    Y = torch.from_numpy(labels).long().to(dev)

    model = MnistConvNet(dtype=torch.float32, device=dev)
    # The LR lives in param_groups, where the schedule callbacks set it.
    opt = hvd.DistributedOptimizer(torch.optim.SGD(
        model.parameters(), lr=args.lr * n, momentum=0.9))
    state = hvdk.TrainState(model, opt)
    accuracy = {}

    def loss_fn(model, batch):
        x, y = batch
        logits = model(x)
        accuracy["value"] = (logits.argmax(-1) == y).float().mean().detach()
        return F.nll_loss(F.log_softmax(logits, -1), y)

    step = hvd.make_train_step(model, loss_fn, opt)

    def train_step(state, batch):
        loss = step(batch)
        state.step += 1
        return state, {"loss": loss, "accuracy": accuracy["value"]}

    batch = args.batch_size
    steps = max(len(X) // batch, 1)

    def data_fn(epoch):
        perm = torch.from_numpy(
            np.random.default_rng(epoch).permutation(len(X))).to(dev)
        for i in range(steps):
            idx = perm[i * batch:(i + 1) * batch]
            yield X[idx], Y[idx]

    epochs = 1 if args.smoke else args.epochs
    record = record_logs()
    callbacks = [
        hvdk.BroadcastGlobalVariablesCallback(0),
        hvdk.MetricAverageCallback(),
        hvdk.LearningRateWarmupCallback(initial_lr=args.lr * n,
                                        warmup_epochs=min(3, epochs),
                                        steps_per_epoch=steps, verbose=True),
        record,
    ]
    state = hvdk.fit(state, data_fn, epochs=epochs, train_step=train_step,
                     steps_per_epoch=steps, callbacks=callbacks)

    if args.checkpoint_dir and hvd.rank() == 0:
        hvdk.save_checkpoint(args.checkpoint_dir, state, epochs - 1)
    print("done", flush=True)
    return {"logs": record.logs, "lr": hvdk.get_learning_rate(opt),
            "state": state}


if __name__ == "__main__":
    main()
