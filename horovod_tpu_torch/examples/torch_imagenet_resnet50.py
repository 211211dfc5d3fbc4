"""ImageNet ResNet-50 through the hook-form frontend: the full torch
workload.

Counterpart of ``examples/torch_imagenet_resnet50.py`` (the reference's
``pytorch_imagenet_resnet50.py``): the resume epoch found on rank 0 and
broadcast, the parameters and optimizer state broadcast after a possible
rank-0 restore, per-batch gradual LR warmup to ``lr * size`` plus the
30/60/80 staircase, allreduce-averaged metrics, rank-0 checkpoints,
1/N sharding and a validation pass each epoch.  The model is a standard
ResNet-50 (bottleneck v1, ``nn.BatchNorm2d``) defined inline, as the
reference's is; the gradients go through
``torch_frontend.DistributedOptimizer``'s hooks and the engine.

    python -m horovod_tpu_torch.examples.torch_imagenet_resnet50 \\
        [--smoke] [--device cpu] [--checkpoint-dir D] [--epochs E] \\
        [--n-train N] [--n-val M]

``--n-train``/``--n-val`` (0: the reference's 4096 and 1024, 128 and 64
under ``--smoke``) cut the synthetic dataset.  Two ranks sharing one
card: ``python -m horovod_tpu_torch.run -np 2 -- python -m
horovod_tpu_torch.examples.torch_imagenet_resnet50 --device cuda:0``
(no torch.distributed collective runs here, only the engine's).
``main(argv)`` returns ``{"start_epoch", "logs": [per-epoch metrics]}``.
"""

from __future__ import annotations

import os

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["Bottleneck", "ResNet", "Metric", "main"]


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, width, stride=1):
        super().__init__()
        cout = width * self.expansion
        self.conv1 = nn.Conv2d(cin, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, cout, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(cout)
        self.down = None
        if stride != 1 or cin != cout:
            self.down = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride, bias=False),
                nn.BatchNorm2d(cout))

    def forward(self, x):
        r = x if self.down is None else self.down(x)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        return F.relu(self.bn3(self.conv3(x)) + r)


class ResNet(nn.Module):
    def __init__(self, stage_sizes=(3, 4, 6, 3), classes=1000):
        super().__init__()
        self.stem = nn.Sequential(
            nn.Conv2d(3, 64, 7, 2, 3, bias=False), nn.BatchNorm2d(64),
            nn.ReLU(), nn.MaxPool2d(3, 2, 1))
        stages, cin = [], 64
        for i, blocks in enumerate(stage_sizes):
            width = 64 * 2 ** i
            for j in range(blocks):
                stages.append(Bottleneck(
                    cin, width, stride=2 if i > 0 and j == 0 else 1))
                cin = width * Bottleneck.expansion
        self.stages = nn.Sequential(*stages)
        self.fc = nn.Linear(cin, classes)

    def forward(self, x):
        x = self.stages(self.stem(x))
        return self.fc(torch.flatten(F.adaptive_avg_pool2d(x, 1), 1))


class Metric:
    """Allreduce-averaged running metric: every update is averaged across
    ranks, so every worker reports the global value."""

    def __init__(self, name):
        self.name = name
        self.sum = 0.0
        self.n = 0

    def update(self, val):
        import horovod_tpu_torch as hvd

        self.sum += float(hvd.allreduce(val.detach().float(),
                                        name=self.name))
        self.n += 1

    @property
    def avg(self):
        return self.sum / self.n if self.n else 0.0


def main(argv=None) -> dict:
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import torch_frontend
    from horovod_tpu_torch.examples.common import (example_args, seeded,
                                                   shard_for_rank,
                                                   synthetic_imagenet)

    args = example_args(
        "ResNet-50 ImageNet (synthetic, hook form)", argv, epochs=4,
        batch_size=32, lr=0.0125,
        checkpoint_dir="./checkpoints-torch-resnet50", warmup_epochs=3,
        n_train=0, n_val=0)
    hvd.init(device=args.device)
    dev = hvd.device()
    gen = torch.Generator().manual_seed(42)

    ckpt_format = os.path.join(args.checkpoint_dir, "checkpoint-{epoch}.pt")

    image_size = 32 if args.smoke else 224
    n_train = args.n_train or (128 if args.smoke else 4096)
    n_val = args.n_val or (64 if args.smoke else 1024)
    images, labels = synthetic_imagenet(n_train, image_size)
    images, labels = shard_for_rank((images, labels), hvd.rank(), hvd.size())
    X = torch.from_numpy(images).permute(0, 3, 1, 2).contiguous().to(dev)
    Y = torch.from_numpy(labels).long().to(dev)
    val_images, val_labels = synthetic_imagenet(n_val, image_size, seed=99)
    val_images, val_labels = shard_for_rank(
        (val_images, val_labels), hvd.rank(), hvd.size())
    VX = torch.from_numpy(val_images).permute(0, 3, 1, 2).contiguous()\
        .to(dev)
    VY = torch.from_numpy(val_labels).long().to(dev)

    model = seeded(lambda: ResNet((1, 1, 1, 1) if args.smoke
                                  else (3, 4, 6, 3)), 42, dev)

    # The LR is scaled up to args.lr * size by the per-batch warmup.
    optimizer = torch_frontend.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=args.lr, momentum=0.9,
                        weight_decay=5e-5),
        named_parameters=model.named_parameters())

    # ---- resume: rank 0 owns the checkpoints; it finds the newest epoch
    # and broadcasts the decision to everyone.
    resume_from_epoch = 0
    if hvd.rank() == 0:
        for try_epoch in range(args.epochs, 0, -1):
            if os.path.exists(ckpt_format.format(epoch=try_epoch)):
                resume_from_epoch = try_epoch
                break
    resume_from_epoch = int(hvd.broadcast(
        torch.tensor(resume_from_epoch), root_rank=0,
        name="resume_from_epoch"))
    if resume_from_epoch > 0 and hvd.rank() == 0:
        ckpt = torch.load(ckpt_format.format(epoch=resume_from_epoch),
                          map_location=dev, weights_only=True)
        model.load_state_dict(ckpt["model"])
        optimizer.load_state_dict(ckpt["optimizer"])
        print(f"resuming from epoch {resume_from_epoch}", flush=True)

    # ---- initial state sync: after the (possible) rank-0 restore, the
    # broadcast covers both a fresh start and a resume.
    torch_frontend.broadcast_parameters(model.state_dict(), root_rank=0)
    torch_frontend.broadcast_optimizer_state(optimizer, root_rank=0)

    batch = args.batch_size
    # Steps derive from the GLOBAL dataset size, not this rank's shard
    # length: 1/N sharding leaves ranks with lengths differing by one, and
    # a rank running an extra step would enqueue collectives nobody joins.
    steps_per_epoch = max(n_train // hvd.size() // batch, 1)
    val_steps = max(n_val // hvd.size() // batch, 1)

    def adjust_learning_rate(epoch, batch_idx):
        """Per-batch warmup 1 -> size over warmup_epochs, then the
        30/60/80 staircase."""
        if epoch < args.warmup_epochs:
            e = epoch + float(batch_idx + 1) / steps_per_epoch
            adj = 1.0 / hvd.size() * (
                e * (hvd.size() - 1) / args.warmup_epochs + 1)
        elif epoch < 30:
            adj = 1.0
        elif epoch < 60:
            adj = 1e-1
        elif epoch < 80:
            adj = 1e-2
        else:
            adj = 1e-3
        for group in optimizer.param_groups:
            group["lr"] = args.lr * hvd.size() * adj

    def save_checkpoint(epoch):
        if hvd.rank() == 0:
            os.makedirs(args.checkpoint_dir, exist_ok=True)
            path = ckpt_format.format(epoch=epoch + 1)
            torch.save({"model": model.state_dict(),
                        "optimizer": optimizer.state_dict()}, path + ".tmp")
            os.replace(path + ".tmp", path)

    def accuracy(output, target):
        return (output.argmax(1) == target).float().mean()

    epochs = min(args.epochs, resume_from_epoch + 1) if args.smoke \
        else args.epochs
    logs = []
    for epoch in range(resume_from_epoch, epochs):
        model.train()
        train_loss, train_acc = Metric("train_loss"), Metric("train_acc")
        perm = torch.randperm(len(X), generator=gen).to(dev)
        for batch_idx in range(steps_per_epoch):
            adjust_learning_rate(epoch, batch_idx)
            idx = perm[batch_idx * batch:(batch_idx + 1) * batch]
            optimizer.zero_grad()
            output = model(X[idx])
            loss = F.cross_entropy(output, Y[idx])
            loss.backward()
            optimizer.step()
            train_loss.update(loss)
            train_acc.update(accuracy(output, Y[idx]))

        model.eval()
        val_loss, val_acc = Metric("val_loss"), Metric("val_acc")
        with torch.no_grad():
            for s in range(val_steps):
                i = min(s * batch, max(len(VX) - batch, 0))
                output = model(VX[i:i + batch])
                val_loss.update(F.cross_entropy(output, VY[i:i + batch]))
                val_acc.update(accuracy(output, VY[i:i + batch]))

        save_checkpoint(epoch)
        logs.append({"train_loss": train_loss.avg,
                     "train_acc": train_acc.avg, "val_loss": val_loss.avg,
                     "val_acc": val_acc.avg})
        if hvd.rank() == 0:
            print(f"epoch {epoch + 1}: train_loss={train_loss.avg:.4f} "
                  f"train_acc={train_acc.avg:.4f} "
                  f"val_loss={val_loss.avg:.4f} "
                  f"val_acc={val_acc.avg:.4f}", flush=True)
    print("done", flush=True)
    return {"start_epoch": resume_from_epoch, "logs": logs}


if __name__ == "__main__":
    main()
