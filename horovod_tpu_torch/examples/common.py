"""Shared helpers for the port's example scripts.

Counterpart of ``examples/common.py``: ``example_args`` with the same
flags and defaults, plus ``--device`` (the examples run on the CUDA
device unless given ``--device cpu``) and an explicit ``argv`` for
callers that drive an example's ``main`` in-process; and the synthetic
datasets and the 1/N sharding, with the reference's numpy draws in its
order, so that for the same ``n`` and ``seed`` the arrays are bitwise
the reference's.  They stay numpy; the examples move batches to the
device.  Two helpers of the port's own: :func:`seeded` (a module's
default initialisation from a seed, without touching the global
generator) and :func:`record_logs` (a callback that keeps ``fit``'s
epoch logs, which ``main`` returns).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch


def example_args(description: str, argv: Optional[Sequence[str]] = None,
                 **extra) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--epochs", type=int, default=extra.pop("epochs", 4))
    p.add_argument("--batch-size", type=int,
                   default=extra.pop("batch_size", 64))
    p.add_argument("--lr", type=float, default=extra.pop("lr", 0.01))
    p.add_argument("--smoke", action="store_true",
                   help="tiny shapes / few steps, for CI")
    p.add_argument("--device", default=None,
                   help="'cpu' to run on the CPU (default: the CUDA device)")
    for name, default in extra.items():
        arg = "--" + name.replace("_", "-")
        if isinstance(default, bool):
            p.add_argument(arg, action="store_true")
        else:
            p.add_argument(arg, type=type(default), default=default)
    return p.parse_args(argv)


def synthetic_mnist(n: int = 2048, seed: int = 0):
    """Deterministic stand-in for MNIST: class-dependent blobs, so models
    actually learn.  ``(images [n, 28, 28, 1] float32, labels [n]
    int32)``."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, n)
    centers = rng.standard_normal((10, 28, 28, 1)).astype(np.float32)
    images = centers[labels] + 0.3 * rng.standard_normal(
        (n, 28, 28, 1)).astype(np.float32)
    return images.astype(np.float32), labels.astype(np.int32)


def synthetic_imagenet(n: int, size: int = 224, classes: int = 1000,
                       seed: int = 0):
    """``(images [n, size, size, 3] float32 NHWC, labels [n] int32)``."""
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((n, size, size, 3)).astype(np.float32)
    labels = rng.integers(0, classes, n).astype(np.int32)
    return images, labels


def shard_for_rank(arrays, rank: int, size: int):
    """1/N sampling per rank (the reference's DistributedSampler role):
    every ``size``-th row from ``rank``."""
    return tuple(a[rank::size] for a in arrays)


def seeded(build, seed: int, device) -> torch.nn.Module:
    """``build()``'s module with its default initialisation drawn from
    ``seed`` on the CPU (the global generator is left as it was), moved
    to ``device``."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build().to(device)


def record_logs():
    """A ``training.Callback`` that keeps each epoch's logs (after the
    callbacks before it, such as ``MetricAverageCallback``) in its
    ``logs`` list."""
    from horovod_tpu_torch.training import Callback

    class RecordLogs(Callback):
        def __init__(self):
            self.logs = []

        def on_epoch_end(self, epoch, state, logs):
            self.logs.append(dict(logs))
            return state

    return RecordLogs()
