"""ImageNet ResNet-50 through the JAX-form frontend and the training
sugar.

Counterpart of ``examples/jax_imagenet_resnet50.py`` (the reference's
``keras_imagenet_resnet50.py``): checkpoint/resume with the resume epoch
broadcast, the restored state broadcast, a ``--compression`` wire for the
gradient allreduce (bf16 by default), warmup + staircase LR schedule,
1/N data sharding, rank-0 per-epoch checkpoints and the eval score
allreduced.  The model is ``models/resnet.py``'s ResNet-50 at bf16 compute
(fp32 parameters), stepped by ``hvd.make_train_step`` (which averages its
BatchNorm running statistics) with nesterov SGD, on synthetic ImageNet.

    python -m horovod_tpu_torch.examples.jax_imagenet_resnet50 [--smoke] \\
        [--device cpu] [--checkpoint-dir D] [--epochs E] \\
        [--n-train N] [--n-val M]

``--n-train``/``--n-val`` (0: the reference's 4096 and 1024, 256 and 128
under ``--smoke``) cut the synthetic dataset.  Runs on the CUDA device
unless given ``--device cpu``.  ``main(argv)`` returns ``{"logs":
[per-epoch averaged logs], "val_acc": the allreduced eval accuracy,
"start_epoch": the epoch resumed at}``.
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
                                                   synthetic_imagenet)
    from horovod_tpu_torch.models.resnet import ResNet50

    args = example_args("ResNet-50 ImageNet (synthetic)", argv, epochs=8,
                        batch_size=64, lr=0.0125,
                        checkpoint_dir="./checkpoints-resnet50",
                        compression="bf16", warmup_epochs=3, n_train=0,
                        n_val=0)
    hvd.init(device=args.device)
    dev, n = hvd.device(), hvd.num_chips()

    image_size = 32 if args.smoke else 224
    n_train = args.n_train or (256 if args.smoke else 4096)
    n_val = args.n_val or (128 if args.smoke else 1024)
    images, labels = synthetic_imagenet(n_train, image_size)
    images, labels = shard_for_rank((images, labels), hvd.rank(), hvd.size())
    val_images, val_labels = synthetic_imagenet(n_val, image_size, seed=99)
    val_images, val_labels = shard_for_rank(
        (val_images, val_labels), hvd.rank(), hvd.size())
    X = torch.from_numpy(images).to(dev)
    Y = torch.from_numpy(labels).long().to(dev)

    model = ResNet50(device=dev, dtype=torch.bfloat16)
    compression = {"none": hvd.Compression.none,
                   "fp16": hvd.Compression.fp16,
                   "bf16": hvd.Compression.bf16}[args.compression]
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=args.lr * n, momentum=0.9,
                        nesterov=True), compression=compression)

    def loss_fn(model, batch):
        x, y = batch
        logits = model(x, train=True)
        return F.nll_loss(F.log_softmax(logits.float(), -1), y)

    step = hvd.make_train_step(model, loss_fn, opt)
    state = hvdk.TrainState(model, opt)

    def train_step(state, batch):
        loss = step(batch)
        state.step += 1
        return state, {"loss": loss}

    # ---- resume (reference keras_imagenet_resnet50.py:64-73, :102-104)
    state, start_epoch = hvdk.restore_and_broadcast(args.checkpoint_dir,
                                                    state)
    if start_epoch and hvd.rank() == 0:
        print(f"resuming from epoch {start_epoch}", flush=True)

    batch = args.batch_size
    steps = max(len(X) // batch, 1)

    def data_fn(epoch):
        perm = torch.from_numpy(
            np.random.default_rng(epoch).permutation(len(X))).to(dev)
        for i in range(steps):
            idx = perm[i * batch:(i + 1) * batch]
            yield X[idx], Y[idx]

    epochs = 1 if args.smoke else args.epochs

    class CheckpointCallback(hvdk.Callback):
        def on_epoch_end(self, epoch, state, logs):
            hvdk.save_checkpoint(args.checkpoint_dir, state, epoch)
            return state

    record = record_logs()
    callbacks = [
        hvdk.BroadcastGlobalVariablesCallback(0),
        hvdk.MetricAverageCallback(),
        hvdk.LearningRateWarmupCallback(
            initial_lr=args.lr * n, warmup_epochs=args.warmup_epochs,
            steps_per_epoch=steps, verbose=hvd.rank() == 0),
        hvdk.LearningRateScheduleCallback(
            initial_lr=args.lr * n, start_epoch=args.warmup_epochs,
            multiplier=lambda e: 10.0 ** -(e // 30)),  # /10 at 30, 60
        CheckpointCallback(),
        record,
    ]
    state = hvdk.fit(state, data_fn, epochs=epochs, train_step=train_step,
                     steps_per_epoch=steps, callbacks=callbacks,
                     initial_epoch=start_epoch)

    # ---- eval, the score allreduced across processes (reference :176)
    accs = []
    with torch.no_grad():
        for i in range(0, len(val_images) - batch + 1, batch):
            x = torch.from_numpy(val_images[i:i + batch]).to(dev)
            y = torch.from_numpy(val_labels[i:i + batch]).long().to(dev)
            accs.append((model(x, train=False).argmax(-1) == y)
                        .float().mean())
    local = float(torch.stack(accs).mean()) if accs else 0.0
    global_acc = float(hvd.allreduce(torch.tensor(local), name="eval_acc"))
    if hvd.rank() == 0:
        print(f"validation accuracy (all ranks): {global_acc:.4f}",
              flush=True)
    print("done", flush=True)
    return {"logs": record.logs, "val_acc": global_acc,
            "start_epoch": start_epoch}


if __name__ == "__main__":
    main()
