"""The conv + BatchNorm-statistics spike on the GPU.

Counterpart of ``experiments/pallas_conv_bn_spike.py``, asking its
question on the card: does a kernel that keeps its BatchNorm statistics
on chip (``ops/conv_bn_stats.py``, ``csrc/conv_bn_stats.cu``) beat the
library 1x1 convolution plus the statistics, at ResNet-50's stage-2
bottleneck 1x1 shape (``x [256, 28, 28, 512] -> [256, 28, 28, 128]`` at
the bench's batch 256)?

Arms, each :data:`REPEATS` dependent iterations (each step's statistics
perturb the next step's weights by ``1e-12 · mean``, so no step can be
skipped or overlapped away) timed as one call on the host clock to a
synchronising read, the median of 3 calls after 2 warm-up calls:

* ``kernel``    — ``conv_bn_stats`` on ``x [N, K]``: the ``pallas`` arm;
* ``library``   — ``F.conv2d`` on channels-last bf16, then the fp32 mean
  and E[y²] − mean²: the ``xla`` arm.  ``F.conv2d`` returns bf16 (it has
  no fp32 output), so its statistics come from the rounded y, where the
  kernel's come from the fp32 y;
* ``conv_only`` — ``F.conv2d`` alone;
* ``check``     — the kernel against the ``library`` arm, with the spike's
  tolerances (mean 2e-2, the first two images' y 5e-2).

::

    python -m horovod_tpu_torch.experiments.conv_bn_spike \\
        [check|kernel|library|conv_only]

prints ``ARM <name> ms <t> tflops <r>`` (or ``correctness ok``).  Runs on
the card; raises without one.
"""

from __future__ import annotations

import sys
import time
from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

from horovod_tpu_torch.ops.conv_bn_stats import conv_bn_stats

__all__ = ["B", "H", "W", "K", "C", "N", "REPEATS", "make_inputs",
           "kernel_conv_stats", "library_conv_stats", "library_conv_only",
           "chain", "arms", "time_it", "check", "main"]

# Stage-2 bottleneck 1x1 shapes at the bench's batch 256:
# x: [256, 28, 28, 512] -> 1x1 conv -> [256, 28, 28, 128]
B, H, W, K, C = 256, 28, 28, 512, 128
N = B * H * W              # 200704 rows
REPEATS = 12               # chained iterations per timed call
FLOPS = 2.0 * N * K * C * REPEATS


def make_inputs(device, seed: int = 0):
    """(x2d [N, K], w2d [K, C]) bf16 on ``device``: x standard normal, w
    0.05 · standard normal, drawn with numpy from ``seed`` (in fp32, not
    the reference's fp64 draws)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((N, K), dtype=np.float32))
    w = 0.05 * rng.standard_normal((K, C), dtype=np.float32)
    return (x.to(device, torch.bfloat16),
            torch.from_numpy(w).to(device, torch.bfloat16))


def _nchw(x2d: torch.Tensor) -> torch.Tensor:
    """x [N, K] as the NCHW view of the NHWC batch: channels-last memory,
    no copy."""
    return x2d.view(B, H, W, -1).permute(0, 3, 1, 2)


def _oihw(w2d: torch.Tensor) -> torch.Tensor:
    """w [K, C] as the 1x1 conv weight [C, K, 1, 1]."""
    return w2d.t().reshape(w2d.shape[1], w2d.shape[0], 1, 1)


def kernel_conv_stats(x2d, w2d):
    """The ``pallas`` arm's step: (y [N, C], mean, var)."""
    return conv_bn_stats(x2d, w2d)


def library_conv_stats(x2d, w2d):
    """The ``xla`` arm's step: ``F.conv2d`` (channels-last bf16), then the
    fp32 mean and E[y²] − mean² over N, H, W; y as [B, C, H, W]
    (channels-last)."""
    y = F.conv2d(_nchw(x2d), _oihw(w2d))
    y32 = y.float()
    mean = y32.mean(dim=(0, 2, 3))
    return y, mean, (y32 * y32).mean(dim=(0, 2, 3)) - mean * mean


def library_conv_only(x2d, w2d):
    """The ``conv_only`` arm's step: ``F.conv2d`` alone."""
    return F.conv2d(_nchw(x2d), _oihw(w2d))


def chain(one_step: Callable, w: torch.Tensor):
    """:data:`REPEATS` dependent steps: each step's mean (for the
    conv-only arm, the first pixel's channels) perturbs the next step's
    weights by ``1e-12 · mean``.  Returns (the last w, each step's
    channel-0 sum of y)."""
    sums = []
    for _ in range(REPEATS):
        out = one_step(w)
        y, mean = out[:2] if isinstance(out, tuple) else (out, None)
        if mean is None:
            mean = (y[0] if y.dim() == 2 else y[0, :, 0, 0]).float()
        w = w + (1e-12 * mean)[None, :].to(w.dtype)
        sums.append(y[:, 0].float().sum())
    return w, torch.stack(sums)


def arms(x2d: torch.Tensor) -> Dict[str, Callable]:
    """Arm name -> ``fn(w) -> chain(...)`` over ``x2d``."""
    steps = {"kernel": kernel_conv_stats, "library": library_conv_stats,
             "conv_only": library_conv_only}
    return {name: (lambda w, s=step: chain(lambda v: s(x2d, v), w))
            for name, step in steps.items()}


def time_it(fn: Callable, *args, warmup: int = 2, reps: int = 3) -> float:
    """Median seconds of ``reps`` calls after ``warmup``, each call ending
    in a host read of its last output (which waits for the card)."""
    for _ in range(warmup):
        out = fn(*args)
    float(out[-1].sum())
    dts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        float(out[-1].sum())
        dts.append(time.perf_counter() - t0)
    return sorted(dts)[len(dts) // 2]


def check(x2d: torch.Tensor, w2d: torch.Tensor) -> None:
    """The kernel against the library arm, with the reference spike's
    tolerances: mean rtol = atol = 2e-2, the first two images' y 5e-2."""
    y_k, m_k, _ = kernel_conv_stats(x2d, w2d)
    y_l, m_l, _ = library_conv_stats(x2d, w2d)
    torch.testing.assert_close(m_k, m_l, rtol=2e-2, atol=2e-2)
    y_l = y_l.permute(0, 2, 3, 1).reshape(N, -1)
    rows = 2 * H * W
    torch.testing.assert_close(y_k[:rows].float(), y_l[:rows].float(),
                               rtol=5e-2, atol=5e-2)


def main(argv=None) -> int:
    from horovod_tpu_torch.common.device import resolve_device

    argv = sys.argv[1:] if argv is None else argv
    arm = argv[0] if argv else "check"
    if arm not in ("check", "kernel", "library", "conv_only"):
        raise SystemExit(f"unknown arm {arm!r}: check, kernel, library or "
                         "conv_only")
    dev = resolve_device(None)          # the card, or an exception
    x2d, w2d = make_inputs(dev)
    if arm == "check":
        check(x2d, w2d)
        print("correctness ok", flush=True)
        return 0
    dt = time_it(arms(x2d)[arm], w2d)
    print(f"ARM {arm} ms {dt * 1e3:.2f} tflops {FLOPS / dt / 1e12:.1f}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
