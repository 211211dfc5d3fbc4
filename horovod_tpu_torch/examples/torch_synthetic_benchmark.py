"""Synthetic throughput benchmark through the hook-form frontend.

Counterpart of ``examples/torch_synthetic_benchmark.py`` (the reference's
``pytorch_synthetic_benchmark.py``): a timed forward + backward + step
loop over one synthetic batch, img/s per device and in total with
±1.96σ over the timed iterations, the parameters broadcast at start, and
a ``--compression none|fp16|bf16`` wire for the gradients.  A small
convnet stands in for torchvision's ResNet-50, as in the reference.
Each timed iteration ends with the device synchronised.

    python -m horovod_tpu_torch.examples.torch_synthetic_benchmark \\
        [--smoke] [--device cpu] [--compression bf16]

Runs on the CUDA device unless given ``--device cpu``.  ``main(argv)``
returns ``{"img_sec_mean", "img_sec_conf", "img_secs"}`` (per device).
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn as nn

__all__ = ["main"]


def main(argv=None) -> dict:
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import torch_frontend
    from horovod_tpu_torch.examples.common import example_args, seeded

    args = example_args("synthetic benchmark (hook form)", argv,
                        batch_size=8, num_iters=3, num_batches_per_iter=4,
                        compression="none")
    hvd.init(device=args.device)
    dev = hvd.device()

    model = seeded(lambda: nn.Sequential(
        nn.Conv2d(3, 32, 3, stride=2, padding=1), nn.ReLU(),
        nn.Conv2d(32, 64, 3, stride=2, padding=1), nn.ReLU(),
        nn.AdaptiveAvgPool2d(1), nn.Flatten(), nn.Linear(64, 1000)), 1, dev)
    compression = {"none": hvd.Compression.none,
                   "fp16": hvd.Compression.fp16,
                   "bf16": hvd.Compression.bf16}[args.compression]
    optimizer = torch_frontend.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01 * hvd.size()),
        named_parameters=model.named_parameters(), compression=compression)
    torch_frontend.broadcast_parameters(model.state_dict(), root_rank=0)

    gen = torch.Generator().manual_seed(1)
    size = 32 if args.smoke else 96
    data = torch.randn(args.batch_size, 3, size, size, generator=gen).to(dev)
    target = torch.randint(0, 1000, (args.batch_size,),
                           generator=gen).to(dev)

    def benchmark_step():
        optimizer.zero_grad()
        loss = nn.functional.cross_entropy(model(data), target)
        loss.backward()
        optimizer.step()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    benchmark_step()  # warmup
    sync()
    img_secs = []
    for _ in range(1 if args.smoke else args.num_iters):
        t = time.perf_counter()
        for _ in range(args.num_batches_per_iter):
            benchmark_step()
        sync()
        img_secs.append(args.batch_size * args.num_batches_per_iter
                        / (time.perf_counter() - t))

    img_sec_mean = float(np.mean(img_secs))
    img_sec_conf = float(1.96 * np.std(img_secs))
    if hvd.rank() == 0:
        print(f"Img/sec per device: {img_sec_mean:.1f} +-{img_sec_conf:.1f}")
        print(f"Total img/sec on {hvd.size()} device(s): "
              f"{hvd.size() * img_sec_mean:.1f} "
              f"+-{hvd.size() * img_sec_conf:.1f}")
    print("done", flush=True)
    return {"img_sec_mean": img_sec_mean, "img_sec_conf": img_sec_conf,
            "img_secs": img_secs}


if __name__ == "__main__":
    main()
