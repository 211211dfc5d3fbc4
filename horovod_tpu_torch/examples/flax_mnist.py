"""The smallest integration: MNIST with the port, nothing else.

Counterpart of ``examples/flax_mnist.py`` (the reference's
``keras_mnist.py`` on-ramp): ``hvd.init()``, the LR scaled by the number
of cards, ``hvd.DistributedOptimizer``, the initial-state broadcast and
the epochs-divided-by-size convention.  ``flax_mnist_advanced.py`` has
the full callback stack.

    python -m horovod_tpu_torch.examples.flax_mnist [--smoke] \\
        [--device cpu]

Runs on the CUDA device unless given ``--device cpu``; ``main(argv)``
returns ``{"losses": [epoch loss, ...]}``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["main"]


def main(argv=None) -> dict:
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.examples.common import (example_args,
                                                   shard_for_rank,
                                                   synthetic_mnist)
    from horovod_tpu_torch.examples.jax_mnist import nll_loss
    from horovod_tpu_torch.models import MnistConvNet

    args = example_args("MNIST (minimal)", argv)
    hvd.init(device=args.device)
    dev = hvd.device()

    images, labels = synthetic_mnist(512 if args.smoke else 4096)
    # Each rank trains on its 1/N shard (DistributedSampler role).
    images, labels = shard_for_rank((images, labels), hvd.rank(), hvd.size())
    X = torch.from_numpy(images).to(dev)
    Y = torch.from_numpy(labels).long().to(dev)

    model = MnistConvNet(dtype=torch.float32, device=dev)
    # LR x size + gradient averaging: the whole Horovod recipe in two
    # lines.
    opt = hvd.DistributedOptimizer(torch.optim.SGD(
        model.parameters(), lr=args.lr * hvd.num_chips(), momentum=0.9))
    step = hvd.make_train_step(model, nll_loss, opt)
    hvd.broadcast_parameters(model, root_rank=0)

    batch = args.batch_size
    # Epochs scale down with world size (reference keras_mnist.py:25).
    epochs = max((1 if args.smoke else args.epochs) // hvd.size(), 1)
    out = []
    for epoch in range(epochs):
        perm = torch.from_numpy(
            np.random.default_rng(epoch).permutation(len(X))).to(dev)
        losses = [step((X[idx], Y[idx])) for idx in
                  (perm[i:i + batch]
                   for i in range(0, len(X) - batch + 1, batch))]
        avg = float(hvd.allreduce(torch.stack(losses).mean().cpu(),
                                  name="epoch_loss"))
        out.append(avg)
        if hvd.rank() == 0:
            print(f"epoch {epoch + 1}: loss={avg:.4f}", flush=True)
    print("done", flush=True)
    return {"losses": out}


if __name__ == "__main__":
    main()
