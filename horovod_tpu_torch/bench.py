"""ResNet-50 synthetic training throughput and MFU on the GPU.

Counterpart of ``bench.py``'s headline metric (``_make_step_and_state``,
``_run_steps``, ``_time_step`` and the ResNet-50 part of ``main``): the
reference's images/sec methodology — a timed forward + backward + update
loop over a fixed synthetic ImageNet batch, images per second per device
— through the port's own train-step path: ``hvd.init()``, ResNet-50 in
bf16 (fp32 parameters), ``DistributedOptimizer(SGD(0.01 · n, momentum
0.9))`` and ``make_train_step`` (which also averages the running
statistics), with the fp32 log-softmax NLL loss.

    python -m horovod_tpu_torch.bench [--smoke] [--device cpu]

prints ONE JSON line: ``metric`` = ``resnet50_train_images_per_sec_per_gpu``
with its ``value``, ``vs_baseline`` (the reference's 103.55 images/s per
Pascal GPU, ``docs/benchmarks.md``), ``step_ms_median_of_3`` and
``step_ms_spread`` (the median of three timed segments), and
``model_tflops_per_step`` — the convolutions' and the head's FLOPs
(MAC = 2, forward + backward = 3 x forward; 6.3 TFLOP for a step of 256 x
224²) — with ``sustained_tflops`` and ``mfu`` over the H100's 989 TFLOP/s
of dense bf16, and the device's name.  Runs on the CUDA device unless
given ``--device cpu``; there the metric is named ``..._cpu_smoke`` and
carries no ``sustained_tflops`` or ``mfu`` (a CPU run gives no device
metric).

Not ported: the ``llama_*`` keys (``chip_smoke.py``'s ``train`` phase is
that step), ``scaling_efficiency_8dev``, and the ``engine_*`` /
``serve_*`` sub-benches.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["make_step_and_state", "loss_fn", "run_steps", "time_step",
           "model_flops_per_step", "main", "PEAK_BF16_FLOPS",
           "REFERENCE_IMG_PER_SEC_PER_DEVICE"]

#: docs/benchmarks.md:22-37: tf_cnn_benchmarks ResNet-101, 1656.82 images/s
#: on 16 Pascal GPUs — the reference's only published absolute throughput.
REFERENCE_IMG_PER_SEC_PER_DEVICE = 1656.82 / 16
#: NVIDIA H100 SXM, dense bf16 (data sheet).
PEAK_BF16_FLOPS = 989e12
#: ImageNet's classes: the reference draws its labels from [0, 1000).
LABELS = 1000


def loss_fn(model, batch) -> torch.Tensor:
    """The reference's loss: fp32 log-softmax, the mean NLL of the
    labels, with the batch statistics (``train=True``)."""
    images, labels = batch
    logp = F.log_softmax(model(images, train=True).float(), dim=-1)
    return -logp.gather(1, labels[:, None]).mean()


def make_step_and_state(cfg, batch_per_gpu: int, image_size: int, *,
                        state=None, seed: int = 0):
    """(step, model, optimizer, (images, labels)) on ``hvd.device()``.

    The data are the reference's numpy draws (``default_rng(0)``): a
    global batch of ``batch_per_gpu x size`` standard-normal fp32 images
    ``[B, S, S, 3]`` and labels in [0, 1000); this rank steps its own
    rows.  ``state``: a ``ResNet`` state dict (parameters and running
    statistics) to start from; default ``init_params(cfg, seed)``.  Rank
    0's weights are broadcast to every rank.  SGD with momentum 0.9 at
    lr 0.01 · size (no dampening, no weight decay: ``optax.sgd``'s
    step); ``make_train_step`` averages the gradients, the running
    statistics and the loss across ranks.
    """
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.convert import init_params
    from horovod_tpu_torch.models.resnet import ResNet

    dev, n, rank = hvd.device(), hvd.size(), hvd.rank()
    rng = np.random.default_rng(0)
    images = rng.standard_normal(
        (batch_per_gpu * n, image_size, image_size, 3), dtype=np.float32)
    labels = rng.integers(0, LABELS, batch_per_gpu * n)
    rows = slice(rank * batch_per_gpu, (rank + 1) * batch_per_gpu)
    batch = (torch.from_numpy(images[rows]).to(dev),
             torch.from_numpy(labels[rows]).to(dev))
    if state is None:
        state = init_params(cfg, seed, dev)
    model = ResNet.from_state_dict(
        cfg, {k: v.to(dev) for k, v in state.items()})
    hvd.broadcast_parameters(model)
    opt = hvd.DistributedOptimizer(torch.optim.SGD(
        model.parameters(), lr=0.01 * n, momentum=0.9))
    step = hvd.make_train_step(model, loss_fn, opt)
    return step, model, opt, batch


def run_steps(step, batch, n: int) -> float:
    """``n`` steps; the last loss read on the host (which waits for the
    device)."""
    for _ in range(n):
        loss = step(batch)
    return float(loss)


def time_step(step, batch, iters: int, warmup: int, repeats: int = 3
              ) -> Tuple[float, list]:
    """Median-of-``repeats`` timed segments of ``iters`` steps after
    ``warmup`` steps.  Returns ``(median seconds, [seconds, ...])``."""
    run_steps(step, batch, max(warmup, 1))
    dts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        run_steps(step, batch, iters)
        dts.append(time.perf_counter() - t0)
    return sorted(dts)[len(dts) // 2], dts


def model_flops_per_step(cfg, image_size: int, batch: int) -> int:
    """The model FLOPs of one training step: 2 per multiply-add of every
    convolution and of the head (ReLU, BatchNorm, pooling and the update
    are not counted), forward + backward = 3 x forward."""
    from horovod_tpu_torch.models.resnet import block_convs

    def out(size, stride):          # "SAME" and the stem's padding 3
        return -(-size // stride)

    size = out(image_size, 2)
    fwd = batch * size * size * 7 * 7 * 3 * cfg.width
    size = out(size, 2)             # max pool
    for _, cin, filters, stride in cfg.blocks():
        convs = block_convs(cfg.block, cin, filters, stride)
        main = convs[:3 if cfg.block == "bottleneck" else 2]
        s = size
        for ci, co, k, st in main:
            s = out(s, st)
            fwd += batch * s * s * k * k * ci * co
        for ci, co, k, st in convs[len(main):]:
            fwd += batch * out(size, st) ** 2 * k * k * ci * co
        size = s
    fwd += batch * cfg.features * cfg.num_classes
    return 3 * 2 * fwd


def main(argv=None) -> int:
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.resnet import ResNetConfig

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--smoke", action="store_true",
                        help="batch 8 of 32 x 32, 3 steps a segment")
    parser.add_argument("--device", default=None,
                        help="cpu to run on the CPU (default: the GPU)")
    args = parser.parse_args(argv)
    hvd.init(device=args.device)
    dev = hvd.device()
    on_gpu = dev.type == "cuda"
    if args.smoke:
        batch, image_size, iters, warmup = 8, 32, 3, 1
    else:
        batch, image_size, iters, warmup = 256, 224, 30, 10
    cfg = ResNetConfig.resnet50()
    step, _, _, data = make_step_and_state(cfg, batch, image_size)
    dt, dts = time_step(step, data, iters, warmup)
    per_gpu = batch * iters / dt
    flops = model_flops_per_step(cfg, image_size, batch)
    sustained = flops * iters / dt
    result = {
        "metric": "resnet50_train_images_per_sec_per_gpu" if on_gpu
                  else "resnet50_train_images_per_sec_cpu_smoke",
        "value": round(per_gpu, 2),
        "unit": "images/sec/gpu" if on_gpu else "images/sec",
        "vs_baseline": round(per_gpu / REFERENCE_IMG_PER_SEC_PER_DEVICE, 3),
        "step_ms_median_of_3": round(dt / iters * 1e3, 2),
        "step_ms_spread": [round(d / iters * 1e3, 2) for d in dts],
        "model_tflops_per_step": round(flops / 1e12, 3),
        "sustained_tflops": round(sustained / 1e12, 2) if on_gpu else None,
        "mfu": round(sustained / PEAK_BF16_FLOPS, 4) if on_gpu else None,
        "batch_per_gpu": batch, "image_size": image_size,
        "world_size": hvd.size(),
        "device": torch.cuda.get_device_name(dev) if on_gpu else "cpu",
    }
    hvd.shutdown()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
