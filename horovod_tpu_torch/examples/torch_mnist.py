"""MNIST through the hook-form frontend (the reference torch frontend's).

Counterpart of ``examples/torch_mnist.py`` (the reference's
``pytorch_mnist.py``): per-rank data shards, ``broadcast_parameters`` and
``broadcast_optimizer_state``, ``torch_frontend.DistributedOptimizer``
with ``named_parameters`` (each gradient's allreduce enqueued on the
engine from its hook during the backward), and the epoch loss averaged
with an eager ``hvd.allreduce``.

    python -m horovod_tpu_torch.examples.torch_mnist [--smoke] \\
        [--device cpu]

Runs on the CUDA device unless given ``--device cpu``; ``main(argv)``
returns ``{"losses": [epoch loss, ...]}``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["Net", "main"]


class Net(nn.Module):
    """The reference example's convnet (two convs, two dense layers)."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(1, 10, kernel_size=5)
        self.conv2 = nn.Conv2d(10, 20, kernel_size=5)
        self.fc1 = nn.Linear(320, 50)
        self.fc2 = nn.Linear(50, 10)

    def forward(self, x):
        x = F.relu(F.max_pool2d(self.conv1(x), 2))
        x = F.relu(F.max_pool2d(self.conv2(x), 2))
        x = x.flatten(1)
        x = F.relu(self.fc1(x))
        return F.log_softmax(self.fc2(x), dim=1)


def main(argv=None) -> dict:
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import torch_frontend
    from horovod_tpu_torch.examples.common import (example_args, seeded,
                                                   shard_for_rank,
                                                   synthetic_mnist)

    args = example_args("MNIST (hook form)", argv)
    hvd.init(device=args.device)
    dev = hvd.device()
    gen = torch.Generator().manual_seed(42)

    images, labels = synthetic_mnist(512 if args.smoke else 4096)
    images, labels = shard_for_rank((images, labels), hvd.rank(), hvd.size())
    X = torch.from_numpy(images).permute(0, 3, 1, 2).contiguous().to(dev)
    Y = torch.from_numpy(labels).long().to(dev)

    model = seeded(Net, 42, dev)
    optimizer = torch_frontend.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=args.lr * hvd.size(),
                        momentum=0.5),
        named_parameters=model.named_parameters())
    torch_frontend.broadcast_parameters(model.state_dict(), root_rank=0)
    torch_frontend.broadcast_optimizer_state(optimizer, root_rank=0)

    epochs = 1 if args.smoke else args.epochs
    batch = args.batch_size
    out = []
    for epoch in range(epochs):
        perm = torch.randperm(len(X), generator=gen).to(dev)
        losses = []
        for i in range(0, len(X) - batch + 1, batch):
            idx = perm[i:i + batch]
            optimizer.zero_grad()
            loss = F.nll_loss(model(X[idx]), Y[idx])
            loss.backward()
            optimizer.step()
            losses.append(loss.detach())
        # Metric averaging via allreduce (reference pytorch_mnist.py:125).
        avg = float(hvd.allreduce(torch.stack(losses).mean().cpu(),
                                  name="epoch_loss"))
        out.append(avg)
        if hvd.rank() == 0:
            print(f"epoch {epoch + 1}: loss={avg:.4f}", flush=True)
    print("done", flush=True)
    return {"losses": out}


if __name__ == "__main__":
    main()
