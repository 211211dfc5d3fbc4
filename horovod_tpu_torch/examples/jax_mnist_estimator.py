"""MNIST with the Estimator harness: the train_and_evaluate workflow.

Counterpart of ``examples/jax_mnist_estimator.py`` (the reference's
``tensorflow_mnist_estimator.py``): a ``model_fn`` giving loss and eval
metrics, ``hvd.DistributedOptimizer`` inside, warm start from
``--model-dir``, rank-0 checkpoints, the initial state broadcast, a final
evaluate.

    python -m horovod_tpu_torch.examples.jax_mnist_estimator [--smoke] \\
        [--device cpu] [--model-dir D]

Runs on the CUDA device unless given ``--device cpu``.  ``main(argv)``
returns ``{"metrics": the final eval metrics, "start_epoch": the epoch
the Estimator resumed at}``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["main"]


def main(argv=None) -> dict:
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.examples.common import (example_args,
                                                   shard_for_rank,
                                                   synthetic_mnist)
    from horovod_tpu_torch.models import MnistConvNet
    from horovod_tpu_torch.training import Estimator

    args = example_args("MNIST estimator", argv, model_dir="")
    hvd.init(device=args.device)
    n = hvd.num_chips()

    images, labels = synthetic_mnist(512 if args.smoke else 4096)
    images, labels = shard_for_rank((images, labels), hvd.rank(), hvd.size())
    split = max(len(images) // 5, args.batch_size)
    eval_images, eval_labels = images[:split], labels[:split]
    images, labels = images[split:], labels[split:]

    def loss_fn(model, batch):
        x, y = batch
        logits = model(x)
        loss = F.nll_loss(F.log_softmax(logits, -1), y)
        accuracy = (logits.argmax(-1) == y).float().mean()
        return loss, {"loss": loss.detach(), "accuracy": accuracy}

    est = Estimator(
        loss_fn,
        init_fn=lambda gen: MnistConvNet(dtype=torch.float32, generator=gen,
                                         device=hvd.device()),
        optimizer=lambda params: torch.optim.SGD(params, lr=args.lr * n,
                                                 momentum=0.9),
        model_dir=args.model_dir or None,
    )
    start_epoch = est.start_epoch

    batch = args.batch_size

    def batches(x, y):
        X, Y = torch.from_numpy(x), torch.from_numpy(y).long()

        def input_fn():
            for i in range(max(len(X) // batch, 1)):
                yield X[i * batch:(i + 1) * batch], Y[i * batch:(i + 1) * batch]
        return input_fn

    epochs = 1 if args.smoke else args.epochs
    metrics = est.train_and_evaluate(
        batches(images, labels), batches(eval_images, eval_labels),
        epochs=epochs)
    if hvd.rank() == 0:
        print(f"final accuracy: {metrics['accuracy']:.3f}", flush=True)
    print("done", flush=True)
    return {"metrics": metrics, "start_epoch": start_epoch}


if __name__ == "__main__":
    main()
