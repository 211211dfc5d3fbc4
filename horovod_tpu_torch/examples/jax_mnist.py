"""MNIST training through the JAX-form frontend: the hello-world workload.

Counterpart of ``examples/jax_mnist.py``: ``hvd.init()``, the LR scaled by
the number of cards, ``hvd.DistributedOptimizer`` (gradients averaged over
the default group), ``hvd.make_train_step``, the initial parameters
broadcast from rank 0, each rank on its 1/N shard of the data, the epoch
loss averaged with an eager ``hvd.allreduce``, and a rank-0 checkpoint.

    python -m horovod_tpu_torch.examples.jax_mnist [--smoke] \\
        [--device cpu] [--checkpoint-dir D]

Runs on the CUDA device unless given ``--device cpu``.  ``main(argv)``
may also be called in a process that ran ``hvd.init()`` already; it
returns ``{"losses": [epoch loss, ...]}``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["nll_loss", "main"]


def nll_loss(model, batch) -> torch.Tensor:
    """Mean negative log-likelihood of the fp32 log-softmax."""
    x, y = batch
    return F.nll_loss(F.log_softmax(model(x).float(), -1), y)


def main(argv=None) -> dict:
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.examples.common import (example_args,
                                                   shard_for_rank,
                                                   synthetic_mnist)
    from horovod_tpu_torch.models import MnistConvNet
    from horovod_tpu_torch.training import save_checkpoint

    args = example_args("MNIST (JAX form)", argv, checkpoint_dir="")
    hvd.init(device=args.device)
    dev, n = hvd.device(), hvd.num_chips()

    images, labels = synthetic_mnist(512 if args.smoke else 4096)
    # Each process trains on its 1/size shard of the data.
    images, labels = shard_for_rank((images, labels), hvd.rank(), hvd.size())
    X = torch.from_numpy(images).to(dev)
    Y = torch.from_numpy(labels).long().to(dev)

    model = MnistConvNet(dtype=torch.float32, device=dev)
    # LR scaled by the total number of cards.
    opt = hvd.DistributedOptimizer(torch.optim.SGD(
        model.parameters(), lr=args.lr * n, momentum=0.9))
    step = hvd.make_train_step(model, nll_loss, opt)
    hvd.broadcast_parameters(model, root_rank=0)

    epochs = 1 if args.smoke else args.epochs
    batch = args.batch_size
    steps = max(len(X) // batch, 1)
    losses = []
    for epoch in range(epochs):
        perm = torch.from_numpy(
            np.random.default_rng(epoch).permutation(len(X))).to(dev)
        epoch_loss = torch.zeros((), device=dev)
        for i in range(steps):
            idx = perm[i * batch:(i + 1) * batch]
            epoch_loss += step((X[idx], Y[idx]))
        avg = float(hvd.allreduce((epoch_loss / steps).cpu(),
                                  name="epoch_loss"))
        losses.append(avg)
        if hvd.rank() == 0:
            print(f"epoch {epoch + 1}: loss={avg:.4f}", flush=True)

    if args.checkpoint_dir and hvd.rank() == 0:
        save_checkpoint(args.checkpoint_dir, model, epochs - 1)
        print(f"checkpoint saved to {args.checkpoint_dir}", flush=True)
    print("done", flush=True)
    return {"losses": losses}


if __name__ == "__main__":
    main()
