"""ResNet-50 and Llama synthetic training throughput and MFU on the GPU.

Counterpart of ``bench.py``'s headline metric (``_make_step_and_state``,
``_run_steps``, ``_time_step`` and the ResNet-50 part of ``main``): the
reference's images/sec methodology — a timed forward + backward + update
loop over a fixed synthetic ImageNet batch, images per second per device
— through the port's own train-step path: ``hvd.init()``, ResNet-50 in
bf16 (fp32 parameters), ``DistributedOptimizer(SGD(0.01 · n, momentum
0.9))`` and ``make_train_step`` (which also averages the running
statistics), with the fp32 log-softmax NLL loss.

    python -m horovod_tpu_torch.bench [--model resnet50|llama] [--smoke]
                                      [--device cpu]

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

``--model llama`` is the reference's causal-LM benchmark (``bench.py``
``_llama_result``), :func:`llama_result`: training tokens per second per
GPU of a ~400M-parameter Llama (vocab 32000, hidden 1024, 16 layers, 8
heads of 128, 8 KV heads, FFN 4096; B 8 x S 2048 per GPU) with the flash
attention kernels and the chunked ``softmax_cross_entropy``, bf16-stored
parameters under ``DistributedOptimizer(MasterWeights(AdamW 3e-4))``, on
the fixed batch of ``default_rng(0)``; 3 warm-up steps, then the median of
three segments of 10 steps.  ``model_tflops_per_step`` is counted
analytically (:func:`llama_flops_per_step`, 32.9 TFLOP a step here),
where the reference asks XLA's cost analysis.  With ``--smoke`` it runs
``LlamaConfig.tiny()`` at B 1 x S 128, 2 steps a segment.  The default
run merges these keys into the ResNet line under ``llama_`` (and
``llama_error`` if the Llama run fails), as the reference's does.

The default run also merges the serving benchmark
(``horovod_tpu_torch.bench_serve``: open-loop Poisson load on a
2-replica fleet of the tiny model, on the same device) under ``serve_``
(``serve_bench_error`` if it fails; ``HOROVOD_SKIP_SERVE_BENCH=1`` skips
it), as the reference's does.

Not ported: ``scaling_efficiency_8dev`` and the ``engine_*``
(``bench_engine.py``) sub-bench.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["make_step_and_state", "loss_fn", "run_steps", "time_step",
           "model_flops_per_step", "llama_config", "llama_loss_fn",
           "make_llama_step", "llama_flops_per_step", "llama_result",
           "serve_result", "main", "PEAK_BF16_FLOPS",
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


def time_step(step, batch, iters: int, warmup: int, repeats: int = 3,
              losses: Optional[list] = None) -> Tuple[float, list]:
    """Median-of-``repeats`` timed segments of ``iters`` steps after
    ``warmup`` steps.  Returns ``(median seconds, [seconds, ...])``;
    ``losses`` receives the last loss of the warm-up and of each
    segment."""
    losses = [] if losses is None else losses
    losses.append(run_steps(step, batch, max(warmup, 1)))
    dts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        losses.append(run_steps(step, batch, iters))
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


# ---------------------------------------------------------------------------
# --model llama
# ---------------------------------------------------------------------------

#: AdamW at bench.py's ``optax.adamw(3e-4)`` defaults.
LLAMA_LR = 3e-4
LLAMA_ADAMW = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


def llama_config():
    """bench.py's Llama on the chip: head_dim 1024 / 8 = 128, the flash
    kernels' tile; ``fused_rmsnorm`` stays False, as in the reference."""
    from horovod_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(vocab_size=32000, hidden_size=1024, num_layers=16,
                       num_heads=8, num_kv_heads=8, intermediate_size=4096,
                       max_seq_len=2048)


def llama_loss_fn(model, tokens) -> torch.Tensor:
    """Next-token cross entropy (``lse - target logit``, never the [B, S,
    V] fp32 log-probabilities)."""
    from horovod_tpu_torch.ops.losses import softmax_cross_entropy

    return softmax_cross_entropy(model(tokens[:, :-1]), tokens[:, 1:])


def make_llama_step(cfg, batch_per_gpu: int, seq: int, *, state=None,
                    seed: int = 0):
    """(step, model, optimizer, tokens) on ``hvd.device()``.

    The tokens are the reference's draw, ``default_rng(0).integers(0, V,
    (B x size, S + 1), int32)``; this rank steps its own rows.  ``state``:
    a ``LlamaModel`` state dict to start from; default ``init_params(cfg,
    seed)`` (bf16 weights when ``cfg.dtype`` is bf16).  Rank 0's weights
    are broadcast; ``DistributedOptimizer(MasterWeights(AdamW 3e-4))``
    keeps fp32 masters; attention is ``flash_attention_fn``."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.convert import init_params
    from horovod_tpu_torch.models.llama import LlamaModel
    from horovod_tpu_torch.ops.flash_attention import flash_attention_fn
    from horovod_tpu_torch.ops.mixed_precision import MasterWeights

    dev, n, rank = hvd.device(), hvd.size(), hvd.rank()
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (batch_per_gpu * n, seq + 1),
                          dtype=np.int32)
    rows = slice(rank * batch_per_gpu, (rank + 1) * batch_per_gpu)
    batch = torch.from_numpy(tokens[rows]).long().to(dev)
    if state is None:
        state = init_params(cfg, seed, dev)
    model = LlamaModel.from_state_dict(
        cfg, {k: v.to(dev) for k, v in state.items()},
        attention_fn=flash_attention_fn)
    hvd.broadcast_parameters(model)
    opt = hvd.DistributedOptimizer(MasterWeights(
        model.parameters(), torch.optim.AdamW, lr=LLAMA_LR, **LLAMA_ADAMW))
    step = hvd.make_train_step(model, llama_loss_fn, opt)
    return step, model, opt, batch


def llama_flops_per_step(cfg, batch: int, seq: int,
                         pairs: Optional[int] = None) -> int:
    """The model FLOPs of one training step, counted analytically: 6 x
    (non-embedding parameters + lm_head) x tokens, plus 3 x the attention
    forward, two products of 2·D FLOPs per live (query, key) pair, head
    and layer.  ``pairs`` (per head and layer, summed over the batch)
    defaults to the causal count, ``batch x heads x seq² / 2``."""
    D, H = cfg.head_dim, cfg.hidden_size
    per_layer = (H * cfg.num_heads * D * 2 + H * cfg.num_kv_heads * D * 2
                 + 3 * H * cfg.intermediate_size + 2 * H)
    dense = cfg.num_layers * per_layer + H + cfg.vocab_size * H
    if pairs is None:
        pairs = batch * cfg.num_heads * seq * seq // 2
    return 6 * dense * batch * seq + 3 * cfg.num_layers * 4 * D * pairs


def llama_result(smoke: bool = False) -> dict:
    """Causal-LM training tokens/s per GPU (``hvd.init()`` first): the
    bench config on the card, ``LlamaConfig.tiny()`` at B 1 x S 128 with
    ``smoke``.  Besides the reference's keys, ``losses`` holds the last
    loss of the warm-up and of each timed segment."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.llama import LlamaConfig

    dev = hvd.device()
    on_gpu = dev.type == "cuda"
    if smoke:
        cfg, batch, seq, iters, warmup = LlamaConfig.tiny(), 1, 128, 2, 1
    else:
        cfg, batch, seq, iters, warmup = llama_config(), 8, 2048, 10, 3
    step, _, _, tokens = make_llama_step(cfg, batch, seq)
    losses: list = []
    dt, dts = time_step(step, tokens, iters, warmup, losses=losses)
    per_gpu = batch * seq * iters / dt
    flops = llama_flops_per_step(cfg, batch, seq)
    sustained = flops * iters / dt
    return {
        "metric": "llama_train_tokens_per_sec_per_gpu" if on_gpu
                  else "llama_train_tokens_per_sec_cpu_smoke",
        "value": round(per_gpu, 1),
        "unit": "tokens/sec/gpu" if on_gpu else "tokens/sec",
        "vs_baseline": None,      # the reference has no transformer baseline
        "step_ms_median_of_3": round(dt / iters * 1e3, 2),
        "step_ms_spread": [round(d / iters * 1e3, 2) for d in dts],
        "model_tflops_per_step": round(flops / 1e12, 3),
        "sustained_tflops": round(sustained / 1e12, 2) if on_gpu else None,
        "mfu": round(sustained / PEAK_BF16_FLOPS, 4) if on_gpu else None,
        "batch_per_gpu": batch, "seq": seq, "layers": cfg.num_layers,
        "warmup_steps": warmup, "steps": iters * 3, "losses": losses,
        "world_size": hvd.size(),
        "device": torch.cuda.get_device_name(dev) if on_gpu else "cpu",
    }


def resnet_result(smoke: bool = False) -> dict:
    """ResNet-50 training images/s per GPU (``hvd.init()`` first): B 256
    x 224² and 30 steps a segment on the card, B 8 x 32² and 3 with
    ``smoke``."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.resnet import ResNetConfig

    dev = hvd.device()
    on_gpu = dev.type == "cuda"
    if smoke:
        batch, image_size, iters, warmup = 8, 32, 3, 1
    else:
        batch, image_size, iters, warmup = 256, 224, 30, 10
    cfg = ResNetConfig.resnet50()
    step, _, _, data = make_step_and_state(cfg, batch, image_size)
    dt, dts = time_step(step, data, iters, warmup)
    per_gpu = batch * iters / dt
    flops = model_flops_per_step(cfg, image_size, batch)
    sustained = flops * iters / dt
    return {
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


def main(argv=None) -> int:
    import horovod_tpu_torch as hvd

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model", choices=["resnet50", "llama"],
                        default="resnet50",
                        help="resnet50 (default; the Llama keys ride along "
                             "under llama_) or llama alone")
    parser.add_argument("--smoke", action="store_true",
                        help="small shapes: ResNet B 8 of 32 x 32, "
                             "LlamaConfig.tiny() at B 1 x S 128")
    parser.add_argument("--device", default=None,
                        help="cpu to run on the CPU (default: the GPU)")
    args = parser.parse_args(argv)
    hvd.init(device=args.device)
    if args.model == "llama":
        result = llama_result(args.smoke)
    else:
        result = resnet_result(args.smoke)
        gc.collect()
        if hvd.device().type == "cuda":
            torch.cuda.empty_cache()
        # The reference keeps the ResNet line through a Llama failure.
        try:
            llama = llama_result(args.smoke)
            base = llama.pop("metric")
            for k, v in llama.items():
                if k not in ("unit", "vs_baseline"):
                    result[base if k == "value" else f"llama_{k}"] = v
        except Exception as e:  # noqa: BLE001 -- reported as llama_error
            result["llama_error"] = f"{type(e).__name__}: {e}"
    device = hvd.device().type
    hvd.shutdown()
    if args.model == "resnet50" and \
            os.environ.get("HOROVOD_SKIP_SERVE_BENCH") != "1":
        result.update(serve_result(device))
    print(json.dumps(result), flush=True)
    return 0


def serve_result(device: str) -> dict:
    """The serving benchmark's line under ``serve_`` keys, or
    ``serve_bench_error``."""
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "horovod_tpu_torch.bench_serve",
             "--device", device], capture_output=True, timeout=900,
            text=True)
        srv = json.loads(proc.stdout.strip().splitlines()[-1])
        return {f"serve_{k}": v for k, v in srv.items()
                if k not in ("metric", "router")}
    except (OSError, subprocess.SubprocessError, ValueError,
            IndexError) as e:
        return {"serve_bench_error": f"{type(e).__name__}: {e}"}


if __name__ == "__main__":
    sys.exit(main())
